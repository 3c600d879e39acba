"""Predictors: the port's counterpart of
``tensor2robot_tpu/predictors/predictors.py`` (AbstractPredictor,
StatelessServingFn, CheckpointPredictor, ExportedModelPredictor and
``poll_and_load_newest``).

A predictor owns the PREDICT chain preprocess -> network -> export outputs
on its device:

* :meth:`~AbstractPredictor.predict` takes numpy and returns numpy;
* :meth:`~AbstractPredictor.device_serving_fn` returns the chain as a
  callable over device tensors, so a caller (the device-resident CEM
  policy) can close a whole loop on the card around it without a host
  round trip;
* :meth:`~AbstractPredictor.stateless_serving_fn` returns the loaded
  model as an immutable :class:`StatelessServingFn` snapshot, ``fn(params,
  features)`` closing over no weights: the batching plane's seam
  (``serving/batching.py``). ``quantize='int8'`` or ``'fp8'`` returns its
  weight-only quantized twin (``quantize/``), which dequantizes inside
  each call.

:class:`CheckpointPredictor` builds the network from the model class and
loads weights from :meth:`~CheckpointPredictor.restore` (the newest
committed step of a trainer's ``<model_dir>/checkpoints``, its EMA in place
of the parameters, as eval reads them), :meth:`~CheckpointPredictor.
init_randomly` (a seeded ``torch.Generator`` and the JAX package's
initialisers), :meth:`~CheckpointPredictor.load_variables` (a JAX
variables tree as numpy, through ``utils/convert.py``) or
:meth:`~CheckpointPredictor.load_state_dict`. The network is built once, at
the first load; every later load copies the new weights into it
(``copy_``), so a serving function that a policy already holds serves the
new weights.

:class:`ExportedModelPredictor` polls a versioned export root
(``export/exporters.py``) and runs the version's ``torch.export`` program
without constructing the model: the loading side imports this package's
``ops`` (the custom ops the program holds: ``t2r::pool_fwd``,
``t2r::conv_s2d_fwd``, ``t2r::flash_fwd``, ``t2r::photometric``),
``export`` and ``specs``, and no model module. A version without the
program takes the model-class path.
"""

from __future__ import annotations

import abc
import collections
import hashlib
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch.export import exporters as exporters_lib
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.observability import metrics as metrics_lib
from tensor2robot_tpu_torch.ops import _dispatch as dispatch
from tensor2robot_tpu_torch.quantize import quantization as quantize_lib
from tensor2robot_tpu_torch.specs import SpecStruct, algebra
from tensor2robot_tpu_torch.specs import assets as assets_lib
from tensor2robot_tpu_torch.specs.dtypes import to_host_numpy
from tensor2robot_tpu_torch.train import checkpoints as ckpt_lib
from tensor2robot_tpu_torch.train import train_state
from tensor2robot_tpu_torch.utils import convert
from tensor2robot_tpu_torch.utils.concurrency import ReaderWriterLock


class StatelessServingFn(NamedTuple):
  """A predictor's compute core as a function of ``(params, features)``.

  ``fn(params, features) -> outputs`` takes two dicts of device tensors
  and closes over no weights, so one program serves any batch and a hot
  model swap hands over new ``params``. The tuple is immutable: a later
  ``restore()`` produces a new snapshot and never changes this one.
  ``program_key``: equal keys, the same compute program (only the weights
  differ), so a consumer's warmed buckets survive a weights-only swap.
  """

  fn: Callable
  params: Mapping[str, torch.Tensor]
  feature_spec: SpecStruct
  version: int  # the model version served (global step)
  program_key: Any


def _maybe_quantize_serving(serving: StatelessServingFn,
                            quantize: Optional[str]) -> StatelessServingFn:
  """The predictors' shared quantize hook: the snapshot itself for None
  or 'off', else its weight-only twin (``quantize.quantize_serving_fn``),
  quantized outside any predictor lock."""
  if quantize in (None, '', 'off'):
    return serving
  return quantize_lib.quantize_serving_fn(serving, mode=quantize)


class AbstractPredictor(abc.ABC):
  """The predictor surface policies consume."""

  @abc.abstractmethod
  def predict(self, features: Dict[str, np.ndarray]) -> Dict[str, Any]:
    ...

  @abc.abstractmethod
  def get_feature_specification(self) -> SpecStruct:
    ...

  def get_label_specification(self) -> Optional[SpecStruct]:
    return None

  @abc.abstractmethod
  def restore(self) -> bool:
    """Loads the newest available weights; returns success."""

  def init_randomly(self, generator: Optional[torch.Generator] = None
                    ) -> None:
    raise NotImplementedError

  def close(self) -> None:
    ...

  def assert_is_loaded(self) -> None:
    if not self.is_loaded:
      raise ValueError('The predictor has not been restored yet.')

  def device_serving_fn(self) -> Callable:
    """``fn(features) -> outputs`` over device tensors (see module doc)."""
    raise NotImplementedError(
        f'{type(self).__name__} does not expose a device serving fn.')

  def stateless_serving_fn(self, quantize: Optional[str] = None
                           ) -> StatelessServingFn:
    """The loaded model as a :class:`StatelessServingFn` snapshot. Raises
    for a predictor whose compute path is not a function of its params;
    the serving plane then batches whole ``predict()`` calls.
    ``quantize`` ('int8' / 'fp8') returns the weight-only quantized twin:
    the int8/fp8 payload with per-output-channel scales as params,
    dequantized inside each call, under ``('quant', mode, program_key)``.
    """
    raise NotImplementedError(
        f'{type(self).__name__} does not expose a stateless serving fn.')

  @property
  @abc.abstractmethod
  def is_loaded(self) -> bool:
    ...

  @property
  def model_version(self) -> int:
    return self.global_step

  @property
  @abc.abstractmethod
  def global_step(self) -> int:
    ...


class EagerServingFn:
  """``fn(params, features)`` over the model's own code: the PREDICT chain
  over a network whose parameters and buffers ARE ``params``
  (``load_state_dict(assign=True)``: no copy). One network is bound to
  each params dict it is called with, the two latest kept, so concurrent
  callers never swap tensors under one another."""

  _KEEP = 2

  def __init__(self, model):
    self._model = model
    self._lock = threading.Lock()
    self._bound = collections.OrderedDict()  # GUARDED_BY(self._lock)
    self._local = threading.local()

  def _chain(self, params) -> exporters_lib.ServingChain:
    with self._lock:
      entry = self._bound.get(id(params))
      if entry is None or entry[0] is not params:
        network = self._model.create_module().requires_grad_(False)
        network.load_state_dict(dict(params), strict=True, assign=True)
        entry = (params, exporters_lib.ServingChain(self._model, network,
                                                    inference=True))
        self._bound[id(params)] = entry
        while len(self._bound) > self._KEEP:
          self._bound.popitem(last=False)
      return entry[1]

  def __call__(self, params, features) -> Dict[str, torch.Tensor]:
    return self._chain(params)(features)

  def call_transient(self, params, features) -> Dict[str, torch.Tensor]:
    """``fn(params, features)`` over params that live for this call only
    (a quantized twin's dequantized weights): this thread's own network,
    its tensors reassigned each call (``assign=True``: no copy), so no
    network is built a call; they are let go when the call returns (the
    network moves to the meta device)."""
    chain = getattr(self._local, 'chain', None)
    if chain is None:
      network = self._model.create_module().requires_grad_(False)
      chain = exporters_lib.ServingChain(self._model, network, inference=True)
      self._local.chain = chain
    chain.network.load_state_dict(dict(params), strict=True, assign=True)
    try:
      return chain(features)
    finally:
      chain.network.to('meta')


class _ProgramFn:
  """``fn(params, features)`` over a loaded ``torch.export`` program, run
  under inference mode. The dicts are handed over in the key order the
  program was traced with (its inputs are matched by position)."""

  def __init__(self, program):
    self.program = program
    self._module = program.module()
    spec = program.call_spec.in_spec
    (params, features), _ = torch.utils._pytree.tree_unflatten(  # pylint: disable=protected-access
        list(range(spec.num_leaves)), spec)
    self._param_keys, self._feature_keys = list(params), list(features)

  def __call__(self, params, features) -> Dict[str, torch.Tensor]:
    with torch.inference_mode():
      return self._module({k: params[k] for k in self._param_keys},
                          {k: features[k] for k in self._feature_keys})


def _expand_to_spec_rank(features: Mapping[str, Any],
                         spec: SpecStruct) -> Dict[str, np.ndarray]:
  """Adds leading batch dims the caller omitted (a single example, or a
  single CEM sample, may come without its batch dim)."""
  out = {}
  for key, value in features.items():
    value = np.asarray(value)
    if key in spec:
      expected_rank = len(spec[key].shape) + 1
      while value.ndim < expected_rank:
        value = value[None]
    out[key] = value
  return out


class CheckpointPredictor(AbstractPredictor):
  """Model -> predictor on ``device`` (``'cuda'`` unless the caller asks
  for ``'cpu'``; a CUDA request with no card raises).

  ``restore()`` polls ``<model_dir>/checkpoints`` for the newest committed
  step until ``restore_timeout_secs`` have passed, and loads it.
  """

  def __init__(self, t2r_model, model_dir: str = '',
               restore_timeout_secs: float = 0.0, device='cuda'):
    self._model = t2r_model
    self._model_dir = model_dir
    self._restore_timeout_secs = restore_timeout_secs
    self._device = dispatch.resolve_device(device)
    self._chain: Optional[exporters_lib.ServingChain] = None
    self._eager_fn: Optional[EagerServingFn] = None
    self._stateless: Optional[StatelessServingFn] = None
    self._global_step = -1
    self._restored_step: Optional[int] = None
    self._feature_spec = algebra.filter_required_flat_tensor_spec(
        t2r_model.preprocessor.get_in_feature_specification(ModeKeys.PREDICT))

  @property
  def device(self) -> torch.device:
    return self._device

  def get_feature_specification(self) -> SpecStruct:
    return self._feature_spec

  def _publish(self, state_dict: Mapping[str, torch.Tensor],
               global_step: int) -> None:
    """Loads ``state_dict`` (every parameter and batch statistic) into the
    network, building it at the first load (see the module doc)."""
    if self._chain is None:
      network = self._model.create_module().to(self._device).eval()
      self._chain = exporters_lib.ServingChain(self._model, network,
                                               inference=True)
    self._chain.network.load_state_dict(
        {k: v.detach().float() for k, v in state_dict.items()}, strict=True)
    self._global_step = global_step
    self._stateless = None

  def init_randomly(self, generator: Optional[torch.Generator] = None
                    ) -> None:
    """Fresh weights from the model's initialisers, drawn on the CPU from
    ``generator`` (seeded runs give the same weights on every device)."""
    network = self._model.create_module()
    self._model.init_network(network, generator)
    self._publish(network.state_dict(), 0)

  def load_variables(self, variables: Mapping[str, Any],
                     global_step: int = 0) -> None:
    """Loads a JAX variables tree (numpy leaves, e.g. from
    ``jax.device_get(state.eval_variables)``)."""
    self._publish(convert.jax_variables_to_torch(variables), global_step)

  def load_state_dict(self, state_dict: Mapping[str, torch.Tensor],
                      global_step: int = 0) -> None:
    """Loads the network's ``state_dict`` (every parameter and batch
    statistic)."""
    self._publish(state_dict, global_step)

  def restore(self) -> bool:
    """Loads the newest committed step of ``<model_dir>/checkpoints`` (its
    EMA weights); True when loaded, or when nothing newer than the loaded
    step exists; False when no step appeared before the timeout."""
    ckpt_dir = os.path.join(self._model_dir, 'checkpoints')

    def committed():
      step = ckpt_lib.latest_checkpoint_step(ckpt_dir)
      return [] if step is None else [step]

    def load(step: int) -> bool:
      with ckpt_lib.CheckpointManager(ckpt_dir, async_save=False) as manager:
        step, payload = manager.restore(step=step)
      self._publish(train_state.eval_state_dict(payload),
                    int(payload['step']))
      self._restored_step = step
      return True

    return poll_and_load_newest(committed, self._restored_step,
                                self._restore_timeout_secs, load)

  def _to_device(self, features: Mapping[str, np.ndarray]):
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(self._device)
        for k, v in features.items()
    }

  def predict(self, features: Dict[str, np.ndarray]) -> Dict[str, Any]:
    self.assert_is_loaded()
    features = _expand_to_spec_rank(features, self._feature_spec)
    outputs = self._chain(self._to_device(features))
    return {k: to_host_numpy(v) for k, v in outputs.items()}

  def device_serving_fn(self) -> Callable:
    """The PREDICT chain over device tensors, under inference mode; the
    same object, over the same network, for the predictor's life (loads
    copy into it)."""
    self.assert_is_loaded()
    return self._chain

  def stateless_serving_fn(self, quantize: Optional[str] = None
                           ) -> StatelessServingFn:
    """The loaded weights under an :class:`EagerServingFn`;
    ``program_key`` is ``('eager_forward', id(network))``. The weights are
    copied once a load: a later load copies into the network's own
    tensors, and the snapshot must not change with them."""
    self.assert_is_loaded()
    if self._stateless is None:
      if self._eager_fn is None:
        self._eager_fn = EagerServingFn(self._model)
      params = {k: v.detach().clone()
                for k, v in self._chain.network.state_dict().items()}
      self._stateless = StatelessServingFn(
          fn=self._eager_fn, params=params, feature_spec=self._feature_spec,
          version=self._global_step,
          program_key=('eager_forward', id(self._chain.network)))
    return _maybe_quantize_serving(self._stateless, quantize)

  @property
  def network(self) -> torch.nn.Module:
    self.assert_is_loaded()
    return self._chain.network

  @property
  def is_loaded(self) -> bool:
    return self._chain is not None

  @property
  def global_step(self) -> int:
    return self._global_step


def poll_and_load_newest(list_dirs_fn: Callable[[], list], loaded_dir,
                         timeout: float, load_fn: Callable[[Any], bool]
                         ) -> bool:
  """The restore contract of predictors that poll a directory: scan with
  ``list_dirs_fn`` (oldest first), load the newest entry with ``load_fn``
  when it differs from ``loaded_dir``, and wait up to ``timeout`` seconds
  for a first entry."""
  deadline = time.time() + timeout
  while True:
    dirs = list_dirs_fn()
    if dirs:
      newest = dirs[-1]
      if newest != loaded_dir:
        return load_fn(newest)
      return True
    if time.time() >= deadline:
      return False
    time.sleep(1.0)


class ExportedModelPredictor(AbstractPredictor):
  """Polls a versioned export root and serves its newest committed version
  on ``device`` (``'cuda'`` unless the caller asks for ``'cpu'``).

  ``restore()`` (``poll_and_load_newest`` over ``committed_export_dirs``,
  waiting up to ``timeout`` seconds for a first version) reads the specs
  and the global step from the version's assets, its serving variables
  from ``state/``, and its ``torch.export`` program, moved to ``device``,
  without constructing the model. A version without the program takes the
  model-class path (``t2r_model``, else the class in ``export_meta.json``)
  through an :class:`EagerServingFn`.

  Program identity: identical program bytes skip the load; otherwise the
  program's fingerprint (``exporters.serving_program_fingerprint``) decides
  whether it is the loaded program, so a weights-only reload keeps the
  loaded program and swaps the params. A failed hot reload keeps the last
  good generation and counts ``predictor/load_fallbacks``. A reader-writer
  lock keeps a predict from mixing two generations: the load runs outside
  it and only the publication is exclusive.
  """

  def __init__(self,
               export_dir: str,
               t2r_model=None,
               timeout: float = 0.0,
               device='cuda'):
    self._export_root = export_dir
    self._model = t2r_model
    self._timeout = timeout
    self._device = dispatch.resolve_device(device)
    self._fn: Optional[Callable] = None  # GUARDED_BY(self._reload_lock)
    self._params: Optional[Dict[str, torch.Tensor]] = None  # GUARDED_BY(self._reload_lock)
    self._feature_spec: Optional[SpecStruct] = None  # GUARDED_BY(self._reload_lock)
    self._global_step = -1  # GUARDED_BY(self._reload_lock)
    self._loaded_dir: Optional[str] = None  # GUARDED_BY(self._reload_lock)
    self._digest: Optional[str] = None  # GUARDED_BY(self._reload_lock)
    self._raw_digest: Optional[str] = None  # GUARDED_BY(self._reload_lock)
    self._parse_fn = None  # GUARDED_BY(self._reload_lock)
    self._reload_lock = ReaderWriterLock()

  @property
  def device(self) -> torch.device:
    return self._device

  def get_feature_specification(self) -> SpecStruct:
    if self._feature_spec is None:
      raise ValueError('restore() must succeed before specs are available.')
    return self._feature_spec

  def restore(self) -> bool:
    """Loads the newest committed version; True when loaded (or when
    nothing newer than the loaded one exists, or a failed reload kept the
    last good one); False when none appeared before the timeout."""
    return poll_and_load_newest(
        lambda: exporters_lib.committed_export_dirs(self._export_root),
        self._loaded_dir, self._timeout, self._load_with_fallback)

  def _load_with_fallback(self, export_dir: str) -> bool:
    try:
      return self._load(export_dir)
    except Exception as e:  # pylint: disable=broad-except
      if not self.is_loaded:
        raise
      metrics_lib.counter('predictor/load_fallbacks').inc()
      logging.warning(
          'Hot reload of export %r failed (%r); continuing to serve the '
          'last-good model from %r (step %d).', export_dir, e,
          self._loaded_dir, self._global_step)
      return True

  def _load(self, export_dir: str) -> bool:
    feature_spec, _, global_step = assets_lib.load_specs_from_export_dir(
        export_dir)
    path = os.path.join(export_dir, exporters_lib.SERVING_FN_FILENAME)
    fn, digest, raw_digest = self._fn, None, None
    if os.path.exists(path):
      with open(path, 'rb') as f:
        data = f.read()
      raw_digest = hashlib.sha256(data).hexdigest()
      if isinstance(fn, _ProgramFn) and raw_digest == self._raw_digest:
        digest = self._digest
      else:
        program = exporters_lib.deserialize_serving_program(data,
                                                            self._device)
        digest = exporters_lib.serving_program_fingerprint(program)
        if not (isinstance(fn, _ProgramFn) and digest == self._digest):
          fn = _ProgramFn(program)
    elif not isinstance(fn, EagerServingFn):
      if self._model is None:
        self._model = exporters_lib.load_model_from_export_dir(export_dir)
      fn = EagerServingFn(self._model)
    params = exporters_lib.load_state_from_export_dir(export_dir,
                                                      self._device)
    feature_spec = algebra.filter_required_flat_tensor_spec(feature_spec)
    with self._reload_lock.write_locked():
      self._fn, self._params = fn, params
      self._digest, self._raw_digest = digest, raw_digest
      self._feature_spec = feature_spec
      self._global_step = global_step
      self._loaded_dir = export_dir
      self._parse_fn = None
    return True

  def _to_device(self, features: Mapping[str, np.ndarray]):
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(self._device)
        for k, v in features.items()
    }

  def _predict_locked(self, features) -> Dict[str, Any]:  # HOLDS(self._reload_lock)
    features = _expand_to_spec_rank(features, self._feature_spec)
    outputs = self._fn(self._params, self._to_device(features))
    return {k: to_host_numpy(v) for k, v in outputs.items()}

  def predict(self, features: Dict[str, np.ndarray]) -> Dict[str, Any]:
    self.assert_is_loaded()
    with self._reload_lock.read_locked():
      return self._predict_locked(features)

  def device_serving_fn(self) -> Callable:
    """``fn(features) -> outputs`` over device tensors, bound to the
    generation loaded now (a later restore() is seen by the next call)."""
    self.assert_is_loaded()
    with self._reload_lock.read_locked():
      fn, params = self._fn, self._params
    return lambda features: fn(params, features)

  def stateless_serving_fn(self, quantize: Optional[str] = None
                           ) -> StatelessServingFn:
    """``program_key`` is ``('torch_export', fingerprint)`` for a program,
    ``('eager_forward', id(fn))`` on the model-class path. The quantized
    twin wraps the loaded program unchanged (no re-export)."""
    self.assert_is_loaded()
    with self._reload_lock.read_locked():
      program_key = (('torch_export', self._digest)
                     if self._digest is not None
                     else ('eager_forward', id(self._fn)))
      serving = StatelessServingFn(
          fn=self._fn, params=self._params, feature_spec=self._feature_spec,
          version=self._global_step, program_key=program_key)
    return _maybe_quantize_serving(serving, quantize)

  def predict_example_bytes(self, serialized_examples) -> Dict[str, Any]:
    """Serialized tf.Examples -> outputs, parsed by the native parser
    (``data/native_io``) from the loaded version's own specs."""
    self.assert_is_loaded()
    with self._reload_lock.read_locked():
      if self._parse_fn is None:
        from tensor2robot_tpu_torch.data import native_io  # pylint: disable=import-outside-toplevel

        self._parse_fn = native_io.make_native_parse_fn(self._feature_spec)
      features, _ = self._parse_fn(list(serialized_examples))
      return self._predict_locked(
          {k: np.asarray(v) for k, v in features.items()})

  def warmup(self) -> int:
    """Replays the version's warmup requests, the serialized examples
    through :meth:`predict_example_bytes`, else the ``.npz`` ones through
    :meth:`predict`; returns the count."""
    self.assert_is_loaded()
    path = self._loaded_dir
    try:
      records = exporters_lib.read_warmup_examples(path)
    except FileNotFoundError:
      records = []
    for record in records:
      self.predict_example_bytes([record])
    if records:
      return len(records)
    try:
      arrays = np.load(os.path.join(path, assets_lib.EXTRA_ASSETS_DIRECTORY,
                                    exporters_lib.WARMUP_NPZ_FILENAME))
    except FileNotFoundError:
      return 0
    requests: Dict[str, Dict[str, np.ndarray]] = {}
    for key in arrays.files:
      feature_key, _, index = key.rpartition('/')
      requests.setdefault(index, {})[feature_key] = arrays[key]
    for request in requests.values():
      self.predict(request)
    return len(requests)

  @property
  def is_loaded(self) -> bool:
    return self._params is not None

  @property
  def model_path(self) -> Optional[str]:
    """The export version dir being served (None before restore)."""
    return self._loaded_dir

  @property
  def global_step(self) -> int:
    return self._global_step
