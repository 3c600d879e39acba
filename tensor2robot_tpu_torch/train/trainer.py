"""The trainer: the port's counterpart of
``tensor2robot_tpu/train/trainer.py``.

``Trainer(model, TrainerConfig(...)).train(batch_iter, eval_iter_fn)``
pulls (features, labels) batches of numpy arrays, as the JAX trainer does,
and runs one step per batch on ``device`` (the card unless the caller asks
for the CPU). A step follows the JAX step body with one microbatch:
preprocess the whole batch, forward in TRAIN mode (batch statistics update
in place), loss, backward, then the update, on one of two arms:

* stock: ``optimizer.step()``, then the EMA;
* fused (``fused_update=True`` and a tagged optimizer, see
  ``ops/fused_update.py``): one kernel pass a step runs the optimizer, the
  EMA and the guard's select, from a pointer table packed once per
  optimizer in which only the gradients' addresses change.

With ``nonfinite_mode`` ``'skip_update'`` or ``'raise'``, the step computes
:func:`all_finite` over the loss and the gradients on the device. The fused
arm hands that flag to the kernel, which writes nothing when it is False;
the stock arm reads it and does not step. Either way the host reads the
flag once (a one-byte copy), keeps the step and the optimizer's counts, and
restores the batch statistics and the generator (``train_state.snapshot``),
so a bad batch leaves the state as if it had never been drawn; the policy
(``train/resilience.py``) counts it, halts after ``nonfinite_halt_after``
consecutive bad steps, or raises at once. The JAX trainer reads its flag one
dispatch later; here ``'raise'`` raises at the bad step itself, with the
same state. With the guard off a step adds no synchronisation.

A step returns ``{'loss', 'q_mean'}``-style summaries as device tensors, so
it does not wait for the card; ``train`` reads them at log intervals and at
the end. Training stops at ``max_train_steps`` applied updates or when the
iterator runs out.

Checkpoints (``train/checkpoints.py``). With a ``model_dir`` the trainer
owns a ``CheckpointManager(<model_dir>/checkpoints)``: ``initialize``
restores the newest committed step into the live state
(``train_state.load_state_dict``), every crossed ``save_interval_steps``
saves (0 disables periodic saves), and the end of training forces a save.
On resume the batch pulled to build the state is not trained on, as in
the JAX trainer. A requested shutdown (``train/resilience.py``,
``handle_preemption``) forces a save at the next step boundary and raises
``PreemptedError``.

Eval. :meth:`Trainer.evaluate` runs ``model_eval_fn`` over ``eval_steps``
batches in EVAL mode with the EMA weights (``eval_state_dict``), as the
JAX package's ``eval_variables`` do, on one eval network built once and
loaded by ``copy_`` at each pass, so the training network, its batch
statistics and the fused plan's tensors are never touched. Each batch's
metrics stay on the device until one read per pass. ``train`` interleaves
a pass at every crossed ``eval_interval_steps``, and one at the end if
none ran.

Callbacks (:class:`TrainerCallback`) see ``begin``, ``after_step``,
``after_checkpoint``, ``after_eval`` and ``end``; ``train/callbacks.py``
has the stock ones.

:func:`train_eval_model` is the entry point: train only, train with
interleaved eval, or a continuous evaluator that follows the trainer's
committed steps (``eval_state.json`` records the last step it evaluated,
so a restarted evaluator skips it) from a backup copy that the trainer's
retention cannot delete. :func:`predict_from_model` streams predictions.

The upload (:class:`BatchUploader`). On the card, each host batch is
copied with ``non_blocking=True`` on one side ``torch.cuda.Stream``, which
records an event; the step's first launch waits on that event on the
compute stream. The next batch's upload is issued before the current
step's launches, exactly one batch ahead (``staged_batches``), so the copy
overlaps the step. A ring-buffer iterator (``data/engine.py``, pinned
slots) gets its slot back through ``release()`` only once the copy's event
has completed: a slot released earlier would be overwritten while the DMA
still reads it. On the CPU nothing is pinned and there is no side stream:
the batch's tensors pass straight through (they alias the host arrays, so
a ring slot is released after its step ran). Batches already on the card
pass through untouched. ``checkpoint_input_state`` saves the input
stream's position as that of the trained batches, the staged one not
counted (``train/input_state.py``).

Exporters (``export/exporters.py``): ``train_eval_model(
create_exporters_fn=...)`` runs each exporter with the final metrics after
training, and after each evaluated checkpoint of an eval-only job, as the
JAX trainer does.

Not ported yet, and raising rather than ignored: several steps a dispatch,
microbatch accumulation and device prefetch (ROADMAP queue 1 item 8) and
the distributed checkpoint protocol (item 10).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.ops import _dispatch as dispatch
from tensor2robot_tpu_torch.ops import fused_update as fused_lib
from tensor2robot_tpu_torch.specs import algebra
from tensor2robot_tpu_torch.train import checkpoints as ckpt_lib
from tensor2robot_tpu_torch.train import resilience
from tensor2robot_tpu_torch.train.train_state import (TrainState, apply_ema,
                                                      create_train_state,
                                                      load_state_dict,
                                                      restore, snapshot,
                                                      state_dict)

Batch = Tuple[Mapping[str, Any], Optional[Mapping[str, Any]]]
MetricDict = Dict[str, float]


def crossed_interval(interval: int, step_before: int, step_after: int) -> bool:
  """Whether the step counter crossed a multiple of ``interval`` (0
  disables): the one interval test of the loop and the callbacks."""
  return bool(interval) and (step_after // interval) > (step_before // interval)


class TrainerCallback:
  """The trainer's hook surface."""

  def begin(self, trainer: 'Trainer') -> None:
    ...

  def after_step(self, trainer: 'Trainer', step: int,
                 scalars: Mapping[str, Any]) -> None:
    ...

  def after_checkpoint(self, trainer: 'Trainer', step: int) -> None:
    ...

  def after_eval(self, trainer: 'Trainer', step: int,
                 metrics: MetricDict) -> None:
    ...

  def end(self, trainer: 'Trainer') -> None:
    ...


@dataclasses.dataclass
class TrainerConfig:
  """Run configuration (the subset of the JAX ``TrainerConfig`` the port
  honours, and the knobs it refuses)."""

  model_dir: str = ''
  max_train_steps: int = 1000
  eval_steps: int = 10          # batches per eval pass
  eval_interval_steps: int = 500  # train steps between eval passes
  save_interval_steps: int = 500  # 0: only the final save
  max_checkpoints_to_keep: Optional[int] = 5
  keep_checkpoint_period: Optional[int] = None
  log_interval_steps: int = 100
  seed: int = 0
  # The host copy of a save is synchronous; its write to disk runs on a
  # background thread (train/checkpoints.py).
  async_checkpoints: bool = True
  # Record the run topology in every commit marker and check it on
  # restore (a mismatch raises TopologyMismatchError).
  checkpoint_topology_check: bool = True
  # SIGTERM/SIGINT at a step boundary: force a checkpoint and raise
  # resilience.PreemptedError. An installed process-wide handler
  # (resilience.install_graceful_shutdown) is honoured either way.
  handle_preemption: bool = False
  # The fused optimizer/EMA/guard update (ops/fused_update.py): over a
  # tagged optimizer (models/optimizers.py: Adam, GradientDescent) the whole
  # update runs as one kernel pass per LEAVES_PER_LAUNCH parameters; an
  # untagged optimizer keeps the stock path (logged once).
  fused_update: bool = False
  # 'off' | 'skip_update' | 'raise' (train/resilience.NonFinitePolicy); a
  # skip run halts after nonfinite_halt_after consecutive bad steps.
  nonfinite_mode: str = 'off'
  nonfinite_halt_after: int = 10
  # Not ported yet; anything but these values raises in Trainer.
  steps_per_dispatch: int = 1          # ROADMAP queue 1 item 8
  grad_accum_microbatches: int = 1     # item 8
  prefetch_batches: Optional[int] = None  # item 8 (None or 0: no prefetch)
  distributed_coordination: Optional[bool] = None  # item 10 (True raises)
  checkpoint_sharded_payloads: str = 'auto'  # item 10 ('on' raises)
  checkpoint_async_commit: bool = False  # item 10


def _refuse_unported(config: TrainerConfig) -> None:
  knobs = (
      ('steps_per_dispatch', config.steps_per_dispatch != 1, 8),
      ('grad_accum_microbatches', config.grad_accum_microbatches != 1, 8),
      ('prefetch_batches', bool(config.prefetch_batches), 8),
      ('distributed_coordination', bool(config.distributed_coordination),
       10),
      ('checkpoint_sharded_payloads',
       config.checkpoint_sharded_payloads == 'on', 10),
      ('checkpoint_async_commit', config.checkpoint_async_commit, 10),
  )
  for name, asked, item in knobs:
    if asked:
      raise NotImplementedError(
          f'TrainerConfig.{name}={getattr(config, name)!r} is not ported '
          f'yet: ROADMAP.md queue 1 item {item}.')


class _Staged:
  """A batch uploaded, or being uploaded, ahead of its step."""

  __slots__ = ('features', 'labels', 'event', 'copies', 'release')

  def __init__(self, features, labels, event, copies, release):
    self.features, self.labels = features, labels
    self.event, self.copies, self.release = event, copies, release


class BatchUploader:
  """Moves host batches to the trainer's device (see the module doc).

  ``stage(batch, release)`` issues the upload and returns a handle;
  ``consume(handle)`` makes the compute stream wait for it and returns
  (features, labels) on the device; ``finish(handle)`` waits for the
  copy's end and then calls ``release`` (the iterator's ring-slot
  release, or None)."""

  def __init__(self, device: torch.device):
    if device.type == 'cuda' and device.index is None:
      device = torch.device('cuda', torch.cuda.current_device())
    self._device = device
    self._stream = (torch.cuda.Stream(device) if device.type == 'cuda'
                    else None)

  def _upload(self, tensors, copies):
    if tensors is None:
      return None
    out = {}
    for key, value in dict(tensors).items():
      if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.ascontiguousarray(value))
      if value.device != self._device:
        value = value.to(self._device, non_blocking=self._stream is not None)
        copies.append(value)
      out[key] = value
    return out

  def stage(self, batch: Batch,
            release: Optional[Callable[[], None]] = None) -> _Staged:
    features, labels = batch
    copies: List[torch.Tensor] = []
    if self._stream is None:
      return _Staged(self._upload(features, copies),
                     self._upload(labels, copies), None, copies, release)
    with torch.cuda.stream(self._stream):
      staged = _Staged(self._upload(features, copies),
                       self._upload(labels, copies), torch.cuda.Event(),
                       copies, release)
      staged.event.record(self._stream)
    return staged

  def consume(self, staged: _Staged):
    if staged.event is not None:
      current = torch.cuda.current_stream(self._device)
      current.wait_event(staged.event)
      for tensor in staged.copies:  # allocated on the side stream
        tensor.record_stream(current)
    return staged.features, staged.labels

  def finish(self, staged: _Staged) -> None:
    if staged.event is not None:
      staged.event.synchronize()
    if staged.release is not None:
      staged.release()
      staged.release = None


def all_finite(loss: torch.Tensor, grads) -> torch.Tensor:
  """Device-side guard flag: a one-element bool tensor, True when the loss
  and every floating gradient are finite. No host synchronisation.

  Two ``foreach`` norms over the gradients: a NaN anywhere makes the L1
  norm NaN, an infinity makes the max norm infinite (the L1 norm alone
  could overflow on large finite gradients; the max norm alone need not
  carry a NaN through every reduction order)."""
  grads = [g for g in grads if g is not None and g.is_floating_point()]
  checks = [torch.isfinite(loss.detach().float()).all().reshape(1)]
  if grads:
    l1 = torch.stack(torch._foreach_norm(grads, 1))  # pylint: disable=protected-access
    top = torch.stack(torch._foreach_norm(grads, float('inf')))  # pylint: disable=protected-access
    checks += [torch.isfinite(top).all().reshape(1),
               (~torch.isnan(l1)).all().reshape(1)]
  return torch.cat(checks).all().reshape(1)


class Trainer:
  """Owns the train state, its checkpoints and the eval network, and runs
  training steps on one device."""

  def __init__(self, model, config: TrainerConfig, device='cuda',
               callbacks: Sequence[TrainerCallback] = (),
               shutdown: Optional[resilience.GracefulShutdown] = None):
    _refuse_unported(config)
    self._nonfinite_policy = (
        resilience.NonFinitePolicy(config.nonfinite_mode,
                                   config.nonfinite_halt_after)
        if config.nonfinite_mode != 'off' else None)
    if shutdown is None and config.handle_preemption:
      shutdown = resilience.install_graceful_shutdown()
    self._shutdown = shutdown
    self._callbacks = list(callbacks)
    self._fused_plan: Optional[fused_lib.FusedPlan] = None
    self._model = model
    self._config = config
    self._device = dispatch.resolve_device(device)
    if hasattr(model, 'set_mesh'):
      # Mesh-aware models get the mesh the step runs over before any module
      # is built; the port's trainer runs on one device, so there is none.
      model.set_mesh(None)
    self._preprocessor = model.preprocessor
    self._uploader = BatchUploader(self._device)
    self._staged: Optional[_Staged] = None
    self._state: Optional[TrainState] = None
    self._eval_network: Optional[torch.nn.Module] = None
    self._dispatch_start_step = 0
    self._manager: Optional[ckpt_lib.CheckpointManager] = None
    if config.model_dir:
      topology = None
      if config.checkpoint_topology_check:
        topology = {'grad_accum_microbatches': config.grad_accum_microbatches,
                    'steps_per_dispatch': config.steps_per_dispatch,
                    'process_count': 1}
      self._manager = ckpt_lib.CheckpointManager(
          os.path.join(config.model_dir, 'checkpoints'),
          max_to_keep=config.max_checkpoints_to_keep,
          keep_period=config.keep_checkpoint_period,
          save_interval_steps=config.save_interval_steps,
          async_save=config.async_checkpoints,
          topology=topology)

  @property
  def model(self):
    return self._model

  @property
  def config(self) -> TrainerConfig:
    return self._config

  @property
  def state(self) -> Optional[TrainState]:
    return self._state

  @property
  def checkpoint_manager(self) -> Optional[ckpt_lib.CheckpointManager]:
    return self._manager

  @property
  def nonfinite_policy(self) -> Optional[resilience.NonFinitePolicy]:
    """The non-finite policy (None when ``nonfinite_mode='off'``)."""
    return self._nonfinite_policy

  @property
  def fused_plan(self) -> Optional[fused_lib.FusedPlan]:
    """The fused update's plan; None on the stock path."""
    return self._fused_plan

  @property
  def step(self) -> int:
    return 0 if self._state is None else self._state.step

  @property
  def staged_batches(self) -> int:
    """Batches pulled from the train iterator and uploaded, not yet
    trained: 1 while the next step's batch is staged, else 0."""
    return 0 if self._staged is None else 1

  @property
  def shutdown(self) -> Optional[resilience.GracefulShutdown]:
    """The shutdown handler the loop honours: the trainer's own, else the
    process-wide one, else None."""
    return (self._shutdown if self._shutdown is not None
            else resilience.active_shutdown())

  def crossed(self, interval: int, step: int) -> bool:
    """Whether the step that just reported ``step`` crossed a multiple of
    ``interval``: the interval test for callbacks."""
    return crossed_interval(interval, self._dispatch_start_step, step)

  def initialize(self, features, labels=None) -> TrainState:
    """Creates the train state (``features``, one host batch, is checked
    against the data contract) and restores the newest committed
    checkpoint into it."""
    del labels
    algebra.validate_and_pack(
        self._preprocessor.get_in_feature_specification(ModeKeys.TRAIN),
        dict(features), ignore_batch=True)
    generator = torch.Generator().manual_seed(self._config.seed)
    self._state = create_train_state(self._model, generator, self._device)
    self.restore_checkpoint()
    if self._config.fused_update:
      # plan_for logs the reason when it returns None (untagged optimizer or
      # unrecognised state).
      self._fused_plan = fused_lib.plan_for(
          self._state.optimizer,
          ema_decay=(self._model.avg_model_params_decay
                     if self._state.ema is not None else None))
    return self._state

  def restore_checkpoint(self, step: Optional[int] = None) -> Optional[int]:
    """Loads the newest committed step (or ``step``) into the live state;
    returns the step loaded, or None when there is none (or no
    ``model_dir``)."""
    if self._manager is None:
      return None
    restored = self._manager.restore(step)
    if restored is None:
      return None
    step, payload = restored
    load_state_dict(self._state, payload)
    logging.info('Restored checkpoint step %d from %s.', step,
                 self._manager.directory)
    return step

  def save_checkpoint(self, force: bool = False) -> None:
    """Saves the current state (see ``CheckpointManager.save``)."""
    if self._manager is None or self._state is None:
      return
    if self._manager.save(self.step, state_dict(self._state), force=force):
      for cb in self._callbacks:
        cb.after_checkpoint(self, self.step)

  def _train_step(self, staged: _Staged) -> Dict[str, torch.Tensor]:
    """One optimizer step on one staged batch; returns device scalars."""
    state = self._state
    model = self._model
    policy = self._nonfinite_policy
    before = snapshot(state) if policy is not None else None
    features, labels = self._uploader.consume(staged)
    features, labels = self._preprocessor.preprocess(
        features, labels, ModeKeys.TRAIN, state.generator)
    state.optimizer.zero_grad(set_to_none=True)
    outputs = model.inference_network_fn(state.network, features, labels,
                                         ModeKeys.TRAIN)
    loss, scalars = model.model_train_fn(features, labels, outputs,
                                         ModeKeys.TRAIN)
    loss.backward()
    ok = None
    if policy is not None:
      ok = all_finite(loss, [p.grad for p in state.network.parameters()])
    if self._fused_plan is not None:
      applied = fused_lib.apply_update(self._fused_plan, state.optimizer,
                                       state.ema_by_param(), ok)
    else:
      applied = ok is None or bool(ok)
      if applied:
        state.optimizer.step()
        apply_ema(state, model.avg_model_params_decay)
    if applied:
      state.step += 1
    else:
      restore(state, before)
    scalars = {k: v.detach() for k, v in scalars.items()}
    scalars['loss'] = loss.detach()
    if policy is not None:
      scalars['nonfinite_count'] = torch.tensor(0 if applied else 1)
      policy.observe(0 if applied else 1, state.step)
    return scalars

  def train(self,
            train_iter: Iterator[Batch],
            eval_iter_fn: Optional[Callable[[], Iterator[Batch]]] = None
            ) -> MetricDict:
    """Steps until ``max_train_steps`` updates are applied or the iterator
    runs out, with saves and interleaved eval (module doc); returns the
    last eval pass's metrics, else the last step's summaries."""
    config = self._config
    release = getattr(train_iter, 'release', None)
    if self._state is None:
      resuming = (self._manager is not None and
                  self._manager.latest_committed_step() is not None)
      probe = next(train_iter)
      self.initialize(probe[0])
      if not resuming:
        self._staged = self._uploader.stage(probe, release)
      elif release is not None:
        release()  # the probe only built the state
    for cb in self._callbacks:
      cb.begin(self)
    shutdown = self.shutdown
    scalars: Mapping[str, Any] = {}
    eval_metrics: MetricDict = {}
    while self._state.step < config.max_train_steps:
      if shutdown is not None and shutdown.requested:
        logging.warning('Graceful shutdown requested; checkpointing step %d '
                        'and raising PreemptedError (resumable).', self.step)
        self.save_checkpoint(force=True)
        if self._manager is not None:
          self._manager.wait_until_finished()
        self._drop_staged()
        for cb in self._callbacks:
          cb.end(self)
        raise resilience.PreemptedError(self.step)
      if self._staged is None:
        batch = next(train_iter, None)
        if batch is None:
          break
        self._staged = self._uploader.stage(batch, release)
      current, self._staged = self._staged, None
      if self._state.step + 1 < config.max_train_steps:
        batch = next(train_iter, None)  # uploads during this step
        if batch is not None:
          self._staged = self._uploader.stage(batch, release)
      before = self._state.step
      scalars = self._train_step(current)
      self._uploader.finish(current)
      step = self._state.step
      self._dispatch_start_step = before
      if crossed_interval(config.log_interval_steps, before, step):
        scalars = {k: float(v) for k, v in scalars.items()}
        logging.info('step %d: %s', step, scalars)
      for cb in self._callbacks:
        cb.after_step(self, step, scalars)
      if crossed_interval(config.save_interval_steps, before, step):
        self.save_checkpoint()
      if (eval_iter_fn is not None and config.eval_interval_steps and
          (crossed_interval(config.eval_interval_steps, before, step) or
           step >= config.max_train_steps)):
        eval_metrics = self.evaluate(eval_iter_fn())
    self.save_checkpoint(force=True)
    if self._manager is not None:
      self._manager.wait_until_finished()
    self._drop_staged()
    if eval_iter_fn is not None and not eval_metrics:
      eval_metrics = self.evaluate(eval_iter_fn())
    for cb in self._callbacks:
      cb.end(self)
    return eval_metrics or {k: float(v) for k, v in scalars.items()}

  def _drop_staged(self) -> None:
    """Lets go of a staged batch that will not be trained in this call
    (its ring slot goes back once its copy has ended)."""
    if self._staged is not None:
      self._uploader.finish(self._staged)
      self._staged = None

  def _eval_module(self) -> torch.nn.Module:
    """The eval network, built once, holding the state's
    ``eval_state_dict()`` (copied in at each call)."""
    if self._eval_network is None:
      self._eval_network = self._model.create_module().to(self._device)
    with torch.no_grad():
      self._eval_network.load_state_dict(self._state.eval_state_dict())
    return self._eval_network

  def evaluate(self, eval_iter: Iterator[Batch]) -> MetricDict:
    """``model_eval_fn`` over up to ``eval_steps`` batches with the EMA
    weights; the mean of each metric over the batches."""
    batches: List[Batch] = []
    if self._state is None:
      probe = next(eval_iter)
      self.initialize(probe[0])
      batches.append(probe)
    network = self._eval_module()
    model = self._model
    release = getattr(eval_iter, 'release', None)
    metric_batches = []
    for _ in range(self._config.eval_steps):
      batch = batches.pop() if batches else next(eval_iter, None)
      if batch is None:
        break
      staged = self._uploader.stage(batch, release)
      with torch.no_grad():
        features, labels = self._preprocessor.preprocess(
            *self._uploader.consume(staged), ModeKeys.EVAL)
        outputs = model.inference_network_fn(network, features, labels,
                                             ModeKeys.EVAL)
        metric_batches.append(
            model.model_eval_fn(features, labels, outputs))
      self._uploader.finish(staged)
    metrics = _mean_metrics(metric_batches)
    for cb in self._callbacks:
      cb.after_eval(self, self.step, metrics)
    return metrics

  def predict(self, features) -> Dict[str, np.ndarray]:
    """One PREDICT forward pass on numpy features with the EMA weights."""
    if self._state is None:
      self.initialize(features)
    network = self._eval_module()
    staged = self._uploader.stage((features, None))
    with torch.no_grad():
      features_p, _ = self._preprocessor.preprocess(
          self._uploader.consume(staged)[0], None, ModeKeys.PREDICT)
      outputs = self._model.inference_network_fn(network, features_p, None,
                                                  ModeKeys.PREDICT)
      outputs = self._model.create_export_outputs_fn(features_p, outputs)
    return {k: v.float().cpu().numpy() for k, v in outputs.items()}

  def close(self) -> None:
    """Waits for the pending checkpoint write and commits it."""
    if self._manager is not None:
      self._manager.close()


def _mean_metrics(metric_batches: List[Mapping[str, torch.Tensor]]
                  ) -> MetricDict:
  """The mean of each metric over the batches, read from the device once."""
  if not metric_batches:
    return {}
  keys = list(metric_batches[0])
  values = torch.stack([torch.stack([m[k].detach().float().reshape(())
                                     for k in keys])
                        for m in metric_batches]).cpu().numpy()
  return {k: float(np.mean(values[:, i])) for i, k in enumerate(keys)}


# ------------------------------------------------------------ entry points


EVAL_STATE_FILENAME = 'eval_state.json'


def _read_continuous_eval_state(model_dir: str) -> Optional[int]:
  """The last step the continuous evaluator finished, or None."""
  if not model_dir:
    return None
  try:
    with open(os.path.join(model_dir, EVAL_STATE_FILENAME)) as f:
      return int(json.load(f)['last_evaluated_step'])
  except (OSError, ValueError, KeyError, TypeError):
    return None


def _write_continuous_eval_state(model_dir: str, step: int) -> None:
  """Persists the evaluator's position atomically."""
  if not model_dir:
    return
  text = json.dumps({'last_evaluated_step': int(step)})
  ckpt_lib.write_durably(os.path.join(model_dir, EVAL_STATE_FILENAME),
                         lambda f: f.write(text.encode()))


def provide_input_generator_with_model_information(input_generator, model,
                                                   mode: str):
  """The spec handshake: the generator takes the preprocessor's in specs."""
  input_generator.set_specification_from_model(model, mode)
  return input_generator


def train_eval_model(model=None,
                     model_dir: str = '',
                     train_input_generator=None,
                     eval_input_generator=None,
                     max_train_steps: int = 1000,
                     eval_steps: int = 10,
                     eval_interval_steps: int = 500,
                     save_interval_steps: int = 500,
                     max_checkpoints_to_keep: Optional[int] = 5,
                     log_interval_steps: int = 100,
                     seed: int = 0,
                     callbacks: Sequence[TrainerCallback] = (),
                     create_exporters_fn=None,
                     use_continuous_eval: bool = False,
                     eval_timeout_secs: Optional[float] = 30.0,
                     steps_per_dispatch: int = 1,
                     checkpoint_input_state: bool = False,
                     nonfinite_mode: str = 'off',
                     nonfinite_halt_after: int = 10,
                     handle_preemption: bool = False,
                     device='cuda') -> MetricDict:
  """The trainer's entry point:

  * train and eval generators: training with interleaved eval;
  * a train generator only: a train-only job;
  * ``checkpoint_input_state``: the train generator's stream position is
    saved with each checkpoint and restored on resume
    (``train/input_state.py``); a generator without
    ``create_checkpointable_iterator`` raises ``ValueError``;
  * an eval generator only: evaluate the newest committed step once, or,
    with ``use_continuous_eval``, every new committed step until
    ``max_train_steps`` (or ``eval_timeout_secs`` without a new one).
    Each step is evaluated from a backup copy in the evaluator's own
    directory, and ``<model_dir>/eval_state.json`` keeps the last step
    evaluated, so a restarted evaluator skips it. A requested shutdown
    between steps raises ``PreemptedError``;
  * ``create_exporters_fn(model)`` returns exporters
    (``export.create_default_exporters()``), each run as
    ``exporter.export(trainer, metrics)`` after training and after each
    evaluated checkpoint of an eval-only job.
  """
  if model is None:
    raise ValueError('train_eval_model requires a model.')
  exporters = list(create_exporters_fn(model)) if create_exporters_fn else []
  config = TrainerConfig(
      model_dir=model_dir,
      max_train_steps=max_train_steps,
      eval_steps=eval_steps,
      eval_interval_steps=eval_interval_steps,
      save_interval_steps=save_interval_steps,
      max_checkpoints_to_keep=max_checkpoints_to_keep,
      log_interval_steps=log_interval_steps,
      seed=seed,
      steps_per_dispatch=steps_per_dispatch,
      nonfinite_mode=nonfinite_mode,
      nonfinite_halt_after=nonfinite_halt_after,
      handle_preemption=handle_preemption)
  if train_input_generator is not None:
    provide_input_generator_with_model_information(
        train_input_generator, model, ModeKeys.TRAIN)
  if eval_input_generator is not None:
    provide_input_generator_with_model_information(
        eval_input_generator, model, ModeKeys.EVAL)
  callbacks = list(callbacks)
  train_iter = None
  if train_input_generator is not None:
    if checkpoint_input_state:
      # The stream's position is saved with every checkpoint and restored
      # on resume (train/input_state.py); a generator that cannot say
      # where it is fails here instead of restarting its stream.
      from tensor2robot_tpu_torch.train.input_state import (  # pylint: disable=import-outside-toplevel
          InputStateCallback)

      if not hasattr(train_input_generator, 'create_checkpointable_iterator'):
        raise ValueError(
            'checkpoint_input_state=True needs a generator with '
            'create_checkpointable_iterator (e.g. NativeRecordInputGenerator); '
            f'got {type(train_input_generator).__name__}.')
      train_iter = train_input_generator.create_checkpointable_iterator(
          ModeKeys.TRAIN)
      callbacks.append(InputStateCallback(train_iter))
    else:
      train_iter = train_input_generator.create_iterator(ModeKeys.TRAIN)
  trainer = Trainer(model, config, device=device, callbacks=callbacks)
  preprocessor = model.preprocessor
  for kind, getter in (
      ('feature', preprocessor.get_in_feature_specification),
      ('label', preprocessor.get_in_label_specification)):
    spec = getter(ModeKeys.TRAIN)
    if spec is not None:
      logging.info('train %s specs:\n%s', kind,
                   '\n'.join(f'  {k}: {v}' for k, v in sorted(spec.items())))
  def run_exporters(metrics: MetricDict) -> None:
    for exporter in exporters:
      exporter.export(trainer, metrics)

  try:
    if train_input_generator is not None:
      eval_iter_fn = None
      if eval_input_generator is not None:
        eval_iter_fn = lambda: eval_input_generator.create_iterator(
            ModeKeys.EVAL)
      metrics = trainer.train(train_iter, eval_iter_fn)
      run_exporters(metrics)
      return metrics
    if eval_input_generator is None:
      raise ValueError('Need a train or eval input generator.')
    return _evaluate_checkpoints(trainer, eval_input_generator, model_dir,
                                 max_train_steps, eval_timeout_secs,
                                 use_continuous_eval, run_exporters)
  finally:
    trainer.close()
    close = getattr(train_iter, 'close', None)
    if close is not None:
      close()  # the engine's threads and ring slots


def _evaluate_checkpoints(trainer: Trainer, eval_input_generator,
                          model_dir: str, max_train_steps: int,
                          eval_timeout_secs: Optional[float],
                          use_continuous_eval: bool,
                          run_exporters: Callable[[MetricDict], None]
                          ) -> MetricDict:
  """The eval-only job of :func:`train_eval_model`."""
  metrics: MetricDict = {}
  ckpt_dir = os.path.join(model_dir, 'checkpoints')
  backup_dir = os.path.join(model_dir, ckpt_lib.EVAL_BACKUP_DIRNAME)
  last_evaluated: Optional[int] = None
  if use_continuous_eval:
    last_evaluated = _read_continuous_eval_state(model_dir)
    if last_evaluated is not None:
      logging.info('Continuous eval resuming: checkpoints up to step %d were '
                   'already evaluated.', last_evaluated)
  shutdown = trainer.shutdown
  for step in ckpt_lib.checkpoints_iterator(
      ckpt_dir, timeout=eval_timeout_secs,
      stop_after_step=max_train_steps if use_continuous_eval else None):
    if last_evaluated is not None and step <= last_evaluated:
      logging.info('Continuous eval: skipping step %d (already evaluated '
                   'before the restart).', step)
      continue
    if shutdown is not None and shutdown.requested:
      logging.warning('Graceful shutdown requested; continuous eval exiting '
                      'resumable after step %s.', last_evaluated)
      if use_continuous_eval and last_evaluated is not None:
        _write_continuous_eval_state(model_dir, last_evaluated)
      raise resilience.PreemptedError(last_evaluated or 0)
    backup = ckpt_lib.create_backup_checkpoint_for_eval(ckpt_dir, step,
                                                        backup_dir)
    if backup is None:
      logging.warning('Continuous eval: checkpoint %d disappeared before it '
                      'could be backed up; skipping its eval.', step)
      continue
    if trainer.state is None:
      features, _ = next(eval_input_generator.create_iterator(ModeKeys.EVAL))
      trainer.initialize(features)
    load_state_dict(trainer.state, ckpt_lib.restore_from_backup(backup))
    metrics = trainer.evaluate(
        eval_input_generator.create_iterator(ModeKeys.EVAL))
    run_exporters(metrics)
    last_evaluated = step
    if not use_continuous_eval:
      break
    _write_continuous_eval_state(model_dir, step)
  return metrics


def predict_from_model(model=None, input_generator=None, model_dir: str = '',
                       device='cuda'):
  """Streams predictions batch by batch, from the newest committed step of
  ``model_dir`` (fresh weights without one)."""
  if model is None or input_generator is None:
    raise ValueError('predict_from_model requires model and input generator.')
  trainer = Trainer(model, TrainerConfig(model_dir=model_dir,
                                         async_checkpoints=False),
                    device=device)
  provide_input_generator_with_model_information(input_generator, model,
                                                 ModeKeys.PREDICT)
  for features, _ in input_generator.create_iterator(ModeKeys.PREDICT):
    yield trainer.predict(features)
