"""Model export: versioned serving artifacts and the best/latest exporters.

The port's counterpart of ``tensor2robot_tpu/export/exporters.py``. The
trainer writes timestamp-versioned export directories that a robot-side
predictor polls and hot-reloads. ``<export_root>/<version>/`` holds, in
the order :class:`ModelExporter` writes them:

1. ``state/state.pt``: the serving variables, the network's
   ``state_dict`` with the EMA in place of the parameters when averaging
   is on (``torch.save``, read back with ``weights_only=True``);
2. ``assets.extra/t2r_assets.pbtxt`` and its JSON twin: the feature and
   label specs and the global step (``specs/assets.py``);
3. ``serving_fn.pt2``: the self-contained serving program, preprocess ->
   network -> export outputs, as a ``torch.export`` program written by
   ``torch.export.save``. It takes ``(params, features)``, two flat dicts:
   the weights are inputs of the program, not constants, so ``state/``
   holds them once and weights-only versions carry the same program. The
   batch dimension is symbolic unless ``serving_batch_size`` pins it;
   every other dimension (a SNAIL episode's length, an image's size) is
   static. Every kernel a forward reaches is a custom op
   (``t2r::pool_fwd``, ``t2r::conv_s2d_fwd``, ``t2r::flash_fwd``,
   ``t2r::photometric``; ``ops/``), which dispatches by device where the
   program runs, so a program traced on the CPU launches the kernels on
   the card; a host that loads it imports ``tensor2robot_tpu_torch.ops``
   and not the model;
4. ``assets.extra/warmup_requests.npz`` and ``warmup_requests.tfexamples``
   (length-prefixed serialized tf.Examples, ``data/example_codec``);
5. ``export_meta.json``: the model class, the global step, whether the
   serving program was written (``self_contained_serving_fn``), its file
   name, its kernel nodes (``kernel_ops``: ``{op: count}`` over the
   ``t2r::`` ops) and the device that traced it;
6. ``export_commit.json``, last. The version is then published by an
   atomic ``os.replace`` and old versions are collected.

A failed program export degrades the version to the model-class path,
logs a warning and records ``self_contained_serving_fn: false``, as the
reference does. Not ported: the TF SavedModel of
``tensor2robot_tpu/export/savedmodel.py`` (a jax2tf artifact with no torch
counterpart); ``ModelExporter(saved_model=True)`` raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib
import io
import json
import logging
import os
import shutil
import struct
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

import tensor2robot_tpu_torch.ops  # pylint: disable=unused-import  # the t2r:: ops
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.observability import metrics as metrics_lib
from tensor2robot_tpu_torch.ops import _dispatch as dispatch
from tensor2robot_tpu_torch.specs import SpecStruct, algebra, numpy_gen
from tensor2robot_tpu_torch.specs import assets as assets_lib
from tensor2robot_tpu_torch.train import checkpoints as ckpt_lib

EXPORT_META_FILENAME = 'export_meta.json'
STATE_DIRNAME = 'state'
STATE_FILENAME = 'state.pt'
SERVING_FN_FILENAME = 'serving_fn.pt2'
WARMUP_NPZ_FILENAME = 'warmup_requests.npz'
WARMUP_EXAMPLES_FILENAME = 'warmup_requests.tfexamples'
# Written last into every version: a version without it is torn (a copy
# that died mid-flight) and hot-reloading predictors skip it.
EXPORT_COMMIT_FILENAME = 'export_commit.json'
# The exporter's position, in the export root: a restarted trainer skips
# what it already exported.
EXPORT_STATE_FILENAME = 'export_state.json'
# The batch a symbolic-batch program is traced at: a size-1 example would
# be specialised to 1.
_TRACE_BATCH = 2


def serving_feature_spec(model) -> SpecStruct:
  """The required host-side PREDICT feature specs: the serving program's
  inputs."""
  return algebra.filter_required_flat_tensor_spec(
      model.preprocessor.get_in_feature_specification(ModeKeys.PREDICT))


class ServingChain(nn.Module):
  """The PREDICT chain over one network: preprocess -> network -> export
  outputs, over a dict of device tensors; returns a plain dict.
  ``inference=True`` runs it under ``torch.inference_mode`` (serving); a
  trace runs it without."""

  def __init__(self, model, network: nn.Module, inference: bool = False):
    super().__init__()
    self._model = model
    self._preprocessor = model.preprocessor
    self._inference = inference
    self.network = network

  def forward(self, features) -> Dict[str, torch.Tensor]:
    with (torch.inference_mode() if self._inference else
          contextlib.nullcontext()):
      features_p, _ = self._preprocessor.preprocess(features, None,
                                                    ModeKeys.PREDICT)
      outputs = self._model.inference_network_fn(self.network, features_p,
                                                 None, ModeKeys.PREDICT)
      return dict(self._model.create_export_outputs_fn(features_p, outputs))


class ServingProgram(nn.Module):
  """``fn(params, features)``: the PREDICT chain with every parameter and
  buffer of the network taken from ``params`` (``functional_call``), so a
  trace holds them as inputs. It owns no tensor: the chain is kept out of
  its module tree."""

  def __init__(self, model):
    super().__init__()
    self._chain = (ServingChain(model, model.create_module()),)

  def forward(self, params: Mapping[str, torch.Tensor],
              features: Mapping[str, torch.Tensor]):
    chain = self._chain[0]
    return torch.func.functional_call(
        chain, {f'network.{k}': v for k, v in params.items()},
        (dict(features),), strict=True)


def build_serving_fn(model) -> ServingProgram:
  """The hermetic PREDICT chain as ``fn(params, features) -> outputs``
  over plain dicts of tensors (the reference's ``build_serving_fn``)."""
  return ServingProgram(model)


def export_serving_program(model, serving_params: Mapping[str, torch.Tensor],
                           batch_size: Optional[int] = None):
  """Traces the serving fn with ``torch.export`` on the device that holds
  ``serving_params``. ``batch_size=None`` exports a symbolic batch
  dimension ``b >= 1``; an int pins it. Returns the ``ExportedProgram``."""
  params = {k: v.detach() for k, v in serving_params.items()}
  device = next(iter(params.values())).device
  in_spec = serving_feature_spec(model)
  for key, spec in in_spec.items():
    if any(d is None for d in spec.shape):
      raise ValueError(f'Cannot export the dynamic feature {key!r}: {spec}')
  batch = _TRACE_BATCH if batch_size is None else int(batch_size)
  features = {key: torch.zeros((batch,) + tuple(spec.shape),
                               dtype=spec.dtype, device=device)
              for key, spec in in_spec.items()}
  dynamic = None
  if batch_size is None:
    b = torch.export.Dim('b', min=1)
    dynamic = ({k: None for k in params}, {k: {0: b} for k in features})
  with torch.no_grad():
    program = torch.export.export(build_serving_fn(model),
                                  (params, features), dynamic_shapes=dynamic)
  # The trace's example inputs hold the weights; dropped, so that
  # ``torch.export.save`` writes the program alone and ``state/`` holds the
  # weights once.
  program.example_inputs = None
  return program


def serialize_program(program) -> bytes:
  """An ``ExportedProgram`` written by ``torch.export.save``."""
  buffer = io.BytesIO()
  torch.export.save(program, buffer)
  return buffer.getvalue()


def deserialize_serving_program(data: bytes, device='cuda'):
  """The ``ExportedProgram`` of :func:`serialize_program`'s bytes, moved
  to ``device`` (``move_to_device_pass``; the card unless the caller asks
  for ``'cpu'``, and a CUDA request with no card raises). Needs only this
  package's ``ops`` (the custom ops), never the model."""
  from torch.export.passes import move_to_device_pass  # pylint: disable=import-outside-toplevel

  device = dispatch.resolve_device(device)
  program = torch.export.load(io.BytesIO(data))
  return move_to_device_pass(program, str(device))


def serving_program_fingerprint(program) -> str:
  """Digest of an ``ExportedProgram``'s PROGRAM: its calling convention and
  each node's op, target and arguments, without node metadata (stack
  traces, source locations) and without any weight. Equal fingerprints:
  the same compute program, only the weights may differ."""
  lines = [str(program.call_spec.in_spec), str(program.call_spec.out_spec)]
  for node in program.graph.nodes:
    lines.append(f'{node.op} {node.name} {node.target} {node.args!r} '
                 f'{node.kwargs!r}')
  return hashlib.sha256('\n'.join(lines).encode()).hexdigest()


def program_op_counts(program) -> Dict[str, int]:
  """{op target: count} over the program's ``call_function`` nodes."""
  counts: Dict[str, int] = {}
  for node in program.graph.nodes:
    if node.op == 'call_function':
      name = str(node.target)
      counts[name] = counts.get(name, 0) + 1
  return counts


def kernel_op_counts(program) -> Dict[str, int]:
  """{op target: count} over the program's kernel nodes, the ``t2r::``
  custom ops (``t2r.pool_fwd.default``, ``t2r.flash_fwd.default``, ...)."""
  return {name: count for name, count in program_op_counts(program).items()
          if name.startswith('t2r.')}


WARMUP_REQUESTS = 2  # one example each


def write_warmup_requests(export_dir: str, model) -> None:
  """Spec-shaped warmup inputs, :data:`WARMUP_REQUESTS` requests of one
  example, as an ``.npz`` of numpy feature dicts (keys
  ``<feature>/<request>``) and as length-prefixed serialized tf.Examples."""
  in_spec = serving_feature_spec(model)
  from tensor2robot_tpu_torch.data import example_codec  # pylint: disable=import-outside-toplevel

  assets_dir = os.path.join(export_dir, assets_lib.EXTRA_ASSETS_DIRECTORY)
  os.makedirs(assets_dir, exist_ok=True)
  arrays, records = {}, []
  for i in range(WARMUP_REQUESTS):
    features = numpy_gen.make_random_numpy(in_spec, batch_size=1, seed=i)
    for key, value in features.items():
      arrays[f'{key}/{i}'] = value
    records.append(example_codec.encode_example(
        in_spec, {k: np.asarray(v)[0] for k, v in features.items()}))
  np.savez(os.path.join(assets_dir, WARMUP_NPZ_FILENAME), **arrays)
  with open(os.path.join(assets_dir, WARMUP_EXAMPLES_FILENAME), 'wb') as f:
    for record in records:
      f.write(struct.pack('<Q', len(record)))
      f.write(record)


def read_warmup_examples(export_dir: str) -> List[bytes]:
  """The length-prefixed serialized warmup examples of a version."""
  path = os.path.join(export_dir, assets_lib.EXTRA_ASSETS_DIRECTORY,
                      WARMUP_EXAMPLES_FILENAME)
  records = []
  with open(path, 'rb') as f:
    while True:
      header = f.read(8)
      if len(header) < 8:
        break
      (length,) = struct.unpack('<Q', header)
      records.append(f.read(length))
  return records


def _numeric_version_dirs(export_root: str) -> List[str]:
  """Numeric child dirs, oldest first."""
  try:
    entries = os.listdir(export_root)
  except FileNotFoundError:
    return []
  return sorted((e for e in entries if e.isdigit() and
                 os.path.isdir(os.path.join(export_root, e))), key=int)


def valid_export_dirs(export_root: str) -> List[str]:
  """Versions whose assets, state and meta are all there, oldest first."""
  valid = []
  for version in _numeric_version_dirs(export_root):
    path = os.path.join(export_root, version)
    if (os.path.exists(os.path.join(path, assets_lib.EXTRA_ASSETS_DIRECTORY,
                                    assets_lib.T2R_ASSETS_FILENAME)) and
        os.path.exists(os.path.join(path, EXPORT_META_FILENAME)) and
        os.path.isdir(os.path.join(path, STATE_DIRNAME))):
      valid.append(path)
  return valid


# Torn versions already reported, so a poller counts and warns once each.
_reported_torn_exports: set = set()


def committed_export_dirs(export_root: str) -> List[str]:
  """The committed versions among the valid ones, oldest first.

  Once any version carries :data:`EXPORT_COMMIT_FILENAME`, a version
  without it is torn and skipped, counted once in
  ``export/uncommitted_skipped``; a root where no version has the marker
  predates it and stays fully visible.
  """
  dirs = valid_export_dirs(export_root)
  marked = [d for d in dirs
            if os.path.exists(os.path.join(d, EXPORT_COMMIT_FILENAME))]
  if not marked:
    return dirs
  torn = [d for d in dirs
          if d not in marked and d not in _reported_torn_exports]
  if torn:
    _reported_torn_exports.update(torn)
    metrics_lib.counter('export/uncommitted_skipped').inc(len(torn))
    logging.warning(
        'Ignoring %d export version(s) under %r without a commit marker '
        '(torn/partial export): %s', len(torn), export_root,
        [os.path.basename(d) for d in torn])
  return marked


def read_export_state(export_root: str) -> Dict[str, Any]:
  """The persisted exporter position, or {} (missing or corrupt file)."""
  try:
    with open(os.path.join(export_root, EXPORT_STATE_FILENAME)) as f:
      return dict(json.load(f))
  except (OSError, ValueError, TypeError):
    return {}


def write_export_state(export_root: str, **updates) -> None:
  """Merges ``updates`` into the persisted exporter state, atomically."""
  os.makedirs(export_root, exist_ok=True)
  state = read_export_state(export_root)
  state.update(updates)
  ckpt_lib.write_durably(
      os.path.join(export_root, EXPORT_STATE_FILENAME),
      lambda f: f.write(json.dumps(state, indent=2).encode()))


def gc_export_versions(export_root: str, keep: int = 5) -> None:
  """Keeps the ``keep`` newest versions (all of them when 0)."""
  if not keep:
    return
  for version in _numeric_version_dirs(export_root)[:-keep]:
    shutil.rmtree(os.path.join(export_root, version), ignore_errors=True)


@dataclasses.dataclass(frozen=True)
class ServingState:
  """One generation to export: its step and its eval state dict."""

  step: int
  variables: Mapping[str, torch.Tensor]

  def eval_state_dict(self) -> Dict[str, torch.Tensor]:
    return dict(self.variables)


def snapshot_serving_state(state) -> ServingState:
  """A copy of a train state's step and eval state dict on its device
  (training goes on updating the live tensors in place)."""
  return ServingState(int(state.step), {
      k: v.detach().clone() for k, v in state.eval_state_dict().items()})


class ModelExporter:
  """Writes one export version from a train state (anything with ``step``
  and ``eval_state_dict()``).

  ``serialize_serving=False`` leaves out the serving program and the
  warmup requests (predictors then take the model-class path);
  ``serving_batch_size`` pins the program's batch, None keeps it
  symbolic. The program is traced on the device that holds the state.
  """

  def __init__(self,
               keep: int = 5,
               serialize_serving: bool = True,
               serving_batch_size: Optional[int] = None,
               saved_model: bool = False):
    if saved_model:
      raise NotImplementedError(
          'saved_model=True: the TF SavedModel export is a jax2tf artifact '
          'with no torch counterpart and is not ported; the version carries '
          'the torch.export program instead.')
    self._keep = keep
    self._serialize_serving = serialize_serving
    self._serving_batch_size = serving_batch_size

  def export(self, model, state, export_root: str,
             version: Optional[int] = None) -> str:
    """Writes ``<export_root>/<version>`` and returns its path."""
    os.makedirs(export_root, exist_ok=True)
    if version is None:
      version = int(time.time() * 1e6)  # microseconds: unique and ordered
    final_dir = os.path.join(export_root, str(version))
    tmp_dir = os.path.join(export_root, f'.tmp_{version}')
    if os.path.exists(tmp_dir):
      shutil.rmtree(tmp_dir)
    os.makedirs(os.path.join(tmp_dir, STATE_DIRNAME))
    step = int(state.step)
    params = {k: v.detach() for k, v in state.eval_state_dict().items()}
    device = next(iter(params.values())).device

    # 1. The serving variables.
    host = ckpt_lib.to_host(params)
    ckpt_lib.write_durably(
        os.path.join(tmp_dir, STATE_DIRNAME, STATE_FILENAME),
        lambda f: torch.save(host, f))

    # 2. Specs and the global step.
    assets_lib.write_assets_to_export_dir(
        tmp_dir, model.get_feature_specification_for_packing(
            ModeKeys.PREDICT),
        model.get_label_specification_for_packing(ModeKeys.PREDICT),
        global_step=step)

    # 3. The serving program and the warmup requests.
    serving_fn_ok, kernel_ops = False, None
    if self._serialize_serving:
      try:
        program = export_serving_program(model, params,
                                         self._serving_batch_size)
        kernel_ops = kernel_op_counts(program)
        with open(os.path.join(tmp_dir, SERVING_FN_FILENAME), 'wb') as f:
          f.write(serialize_program(program))
        serving_fn_ok = True
      except Exception as e:  # pylint: disable=broad-except
        logging.warning(
            'Self-contained torch.export serving export FAILED for %s; the '
            'export degrades to the model-class fallback (predictors must '
            'import %s.%s). Recorded as self_contained_serving_fn=false in '
            'export_meta.json. Error: %r', type(model).__name__,
            type(model).__module__, type(model).__qualname__, e)
      try:
        write_warmup_requests(tmp_dir, model)
      except Exception as e:  # pylint: disable=broad-except
        logging.warning('Warmup request generation failed: %r', e)

    # 4. Reconstruction metadata.
    meta = {
        'model_class': f'{type(model).__module__}.{type(model).__qualname__}',
        'global_step': step,
        'self_contained_serving_fn': serving_fn_ok,
        'serving_fn': SERVING_FN_FILENAME if serving_fn_ok else None,
        'kernel_ops': kernel_ops,
        'trace_device': str(device),
        'torch_version': torch.__version__,
        'tf_saved_model': False,
    }
    with open(os.path.join(tmp_dir, EXPORT_META_FILENAME), 'w') as f:
      json.dump(meta, f, indent=2)

    # 5. The commit marker, last; then the atomic publish.
    ckpt_lib.write_durably(
        os.path.join(tmp_dir, EXPORT_COMMIT_FILENAME),
        lambda f: f.write(json.dumps({'global_step': step,
                                      'time': time.time()}).encode()))
    os.replace(tmp_dir, final_dir)
    gc_export_versions(export_root, keep=self._keep)
    return final_dir


def read_export_meta(export_dir: str) -> Dict[str, Any]:
  with open(os.path.join(export_dir, EXPORT_META_FILENAME)) as f:
    return json.load(f)


def load_model_from_export_dir(export_dir: str):
  """Rebuilds the model object recorded in ``export_meta.json`` with its
  default arguments (imports its module: the model-class path)."""
  module_name, _, class_name = read_export_meta(export_dir)[
      'model_class'].rpartition('.')
  return getattr(importlib.import_module(module_name), class_name)()


def load_state_from_export_dir(export_dir: str,
                               device='cpu') -> Dict[str, torch.Tensor]:
  """The serving variables of a version, on ``device``."""
  state = torch.load(os.path.join(export_dir, STATE_DIRNAME, STATE_FILENAME),
                     map_location='cpu', weights_only=True)
  return {k: v.to(device) for k, v in state.items()}


def load_serving_fn_from_export_dir(export_dir: str,
                                    device='cuda') -> Optional[Callable]:
  """The self-contained serving program as ``fn(params, features) ->
  outputs`` on ``device`` (the card unless the caller asks for ``'cpu'``;
  a CUDA request with no card raises), or None when the version has none.
  Needs only torch and this package's ``ops``."""
  device = dispatch.resolve_device(device)
  path = os.path.join(export_dir, SERVING_FN_FILENAME)
  if not os.path.exists(path):
    return None
  with open(path, 'rb') as f:
    return deserialize_serving_program(f.read(), device).module()


# ------------------------------------------------------------ eval exporters


def create_valid_result_smaller(metric_key: str = 'loss'):
  """Best = the smaller metric."""

  def compare(best: Optional[Dict], current: Dict) -> bool:
    if best is None or metric_key not in best:
      return True
    return current[metric_key] < best[metric_key]

  return compare


def create_valid_result_larger(metric_key: str):
  """Best = the larger metric."""

  def compare(best: Optional[Dict], current: Dict) -> bool:
    if best is None or metric_key not in best:
      return True
    return current[metric_key] > best[metric_key]

  return compare


def _should_skip_export(trainer, export_root: str) -> bool:
  """Skips a non-primary process, and a step at or below the persisted
  ``last_exported_step`` (a restarted run never re-exports;
  ``export/skipped_already_exported``)."""
  if not getattr(trainer, 'is_primary_process', True):
    return True
  last = read_export_state(export_root).get('last_exported_step')
  step = int(trainer.state.step) if trainer.state is not None else 0
  if last is not None and step <= int(last):
    metrics_lib.counter('export/skipped_already_exported').inc()
    logging.info('Skipping export of step %d under %r: step %d was already '
                 'exported before the restart.', step, export_root, last)
    return True
  return False


class LatestExporter:
  """Exports on every eval, keeping the ``keep`` newest versions; persists
  ``last_exported_step`` so a restart skips what it exported."""

  def __init__(self, name: str = 'latest_exporter_numpy', keep: int = 5,
               saved_model: bool = False):
    self.name = name
    self._exporter = ModelExporter(keep=keep, saved_model=saved_model)

  def export(self, trainer, metrics: Dict[str, float]) -> Optional[str]:
    del metrics
    export_root = os.path.join(trainer.config.model_dir, 'export', self.name)
    if _should_skip_export(trainer, export_root):
      return None
    path = self._exporter.export(trainer.model, trainer.state, export_root)
    write_export_state(export_root,
                       last_exported_step=int(trainer.state.step))
    return path


class BestExporter:
  """Exports only when the metric improves; the best metrics so far are
  persisted beside the versions, so a restarted run keeps the bar."""

  def __init__(self,
               name: str = 'best_exporter_numpy',
               compare_fn: Optional[Callable] = None,
               keep: int = 5,
               saved_model: bool = False):
    self.name = name
    self._compare_fn = compare_fn or create_valid_result_smaller('loss')
    self._exporter = ModelExporter(keep=keep, saved_model=saved_model)
    self._best_metrics: Optional[Dict[str, float]] = None

  def export(self, trainer, metrics: Dict[str, float]) -> Optional[str]:
    if not metrics or not getattr(trainer, 'is_primary_process', True):
      return None
    export_root = os.path.join(trainer.config.model_dir, 'export', self.name)
    if self._best_metrics is None:
      persisted = read_export_state(export_root).get('best_metrics')
      if isinstance(persisted, dict):
        self._best_metrics = {k: float(v) for k, v in persisted.items()}
    if not self._compare_fn(self._best_metrics, metrics):
      metrics_lib.counter('export/skipped_not_improved').inc()
      return None
    self._best_metrics = {k: float(v) for k, v in metrics.items()}
    path = self._exporter.export(trainer.model, trainer.state, export_root)
    write_export_state(export_root,
                       last_exported_step=int(trainer.state.step),
                       best_metrics=self._best_metrics)
    return path


def create_default_exporters(best_metric_key: str = 'loss',
                             compare_larger: bool = False,
                             keep: int = 5,
                             saved_model: bool = False):
  """The best + latest exporter pair, as ``create_exporters_fn(model)``."""

  def create_exporters_fn(model):
    del model
    compare = (create_valid_result_larger(best_metric_key) if compare_larger
               else create_valid_result_smaller(best_metric_key))
    return [
        BestExporter(compare_fn=compare, keep=keep, saved_model=saved_model),
        LatestExporter(keep=keep, saved_model=saved_model),
    ]

  return create_exporters_fn
