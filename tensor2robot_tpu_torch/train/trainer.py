"""The trainer: the port's counterpart of
``tensor2robot_tpu/train/trainer.py``.

``Trainer(model, TrainerConfig(...)).train(batch_iter, eval_iter_fn)``
pulls (features, labels) batches of numpy arrays, as the JAX trainer does,
and runs them on ``device`` (the card unless the caller asks for the CPU).
A step follows the JAX step body: preprocess the whole batch, forward in
TRAIN mode (batch statistics, and under ``matmul_precision='fp8'`` the
amax windows, update in place), loss, backward (over
``grad_accum_microbatches`` slices of the batch, float32 gradients summed
and divided, batch norm seeing each slice), then the update, on one of two
arms:

* stock: the optimizer's step, then the EMA;
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
consecutive bad steps, or raises at once. With the guard off a step adds
no synchronisation.

K steps a dispatch (``steps_per_dispatch`` K > 1), the JAX trainer's
``lax.scan`` of K steps in one program. The loop groups K host batches
into one contiguous superbatch (:class:`_SuperbatchAssembler`; on a card
two pinned slots in turn), optionally assembled ahead on a thread
(:class:`_DevicePrefetcher`, ``prefetch_batches``), uploads it one group
ahead on a side stream (:class:`_GroupFeed`; with ``device_feed`` in one
copy) and runs K steps that read nothing back to the host
(``_device_step``):

* the preprocessor's random values are drawn on the host beforehand, in
  the order K single steps draw them (``host_draws``, one row of the same
  width a step), and handed over on the device (``DeviceDraws``: QT-Opt
  and Grasp2Vec crop by index arithmetic, Grasp2Vec flips by a select,
  the vrgripper and meta preprocessors crop-resize at device offsets and
  mix up with weights drawn on the host);
* the rates (learning rate, bias corrections) of the K counts the
  dispatch may reach are computed on the host from the schedule
  (``dispatch_rates``; an accumulating optimizer adds each call's divisor
  and apply flag) and selected on the device by the dispatch's applied
  count;
* the guard selects old against new on the device, JAX's ``where(ok,
  new, old)``, and a skipped step's draws and rates go to the next step,
  as the JAX step keys them off the applied step.

On the card a dispatch of the full group shape is ONE replay of a CUDA
graph captured at the layout's first group (``train/step_graph.py``: an
eager warm-up on a side stream, the state restored, then the capture);
its inputs are copied into the graph's own input buffer before each
replay. A group of another shape (a ragged tail) runs the same steps
eagerly, and so does every dispatch on the CPU. A failed capture or
replay raises. The loop counts dispatched steps and the state applied
ones; log, save and eval fire at the first dispatch boundary on or after
each multiple, callbacks see boundary steps only, and with the guard on
the applied count is read once a dispatch (the host generator then
repositions to the draws used) while the policy observes each dispatch's
count one dispatch behind, as the JAX trainer does: ``'raise'`` raises
after the next dispatch, with the state of the last good step.

A step returns ``{'loss', 'q_mean'}``-style summaries as device tensors, so
it does not wait for the card; ``train`` reads them at log intervals and at
the end. Training stops at ``max_train_steps`` (applied updates at K = 1,
dispatched steps at K > 1) or when the iterator runs out.

Each dispatch is timed by :class:`_DispatchBreakdown` (``step_breakdown``):
host wait, placement, dispatch, the device wait one dispatch behind and
the callbacks, merged into the summaries at log intervals, with the spans
``trainer/wait_batch``, ``trainer/dispatch`` and ``trainer/device_wait``
and a ``'dispatch'`` flight event a boundary (``observability/``).

Checkpoints (``train/checkpoints.py``). With a ``model_dir`` the trainer
owns a ``CheckpointManager(<model_dir>/checkpoints)``: ``initialize``
restores the newest committed step into the live state
(``train_state.load_state_dict``), every crossed ``save_interval_steps``
saves (0 disables periodic saves), and the end of training forces a save.
Every commit marker records ``steps_per_dispatch`` and
``grad_accum_microbatches``, and a run with others refuses the step
(``TopologyMismatchError``). On resume the batch pulled to build the state
is not trained on, as in the JAX trainer. A requested shutdown
(``train/resilience.py``, ``handle_preemption``) forces a save at the next
step or dispatch boundary and raises ``PreemptedError``.

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

The upload at K = 1 (:class:`BatchUploader`). On the card, each host batch
is copied with ``non_blocking=True`` on one side ``torch.cuda.Stream``,
which records an event; the step's first launch waits on that event on the
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

Not ported yet, and raising rather than ignored: the distributed
checkpoint protocol (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import json
import logging
import os
import queue
import threading
import time
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.observability import flight
from tensor2robot_tpu_torch.observability import metrics as metrics_lib
from tensor2robot_tpu_torch.observability import postmortem, tracing
from tensor2robot_tpu_torch.ops import _dispatch as dispatch
from tensor2robot_tpu_torch.ops import fused_update as fused_lib
from tensor2robot_tpu_torch.preprocessors.base import DeviceDraws
from tensor2robot_tpu_torch.quantize import fp8_training as fp8_lib
from tensor2robot_tpu_torch.specs import algebra
from tensor2robot_tpu_torch.train import checkpoints as ckpt_lib
from tensor2robot_tpu_torch.train import resilience
from tensor2robot_tpu_torch.train import step_graph
from tensor2robot_tpu_torch.train.train_state import (TrainState, apply_ema,
                                                      create_train_state,
                                                      device_select,
                                                      device_snapshot,
                                                      guarded_tensors,
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
  # Train steps in ONE dispatch (the JAX trainer's lax.scan of K single
  # steps; TPUEstimator's iterations_per_loop): the loop groups K host
  # batches and runs K optimizer steps a dispatch, on the card as one
  # captured CUDA graph replay (train/step_graph.py). Training is bitwise
  # the K single steps'. Logging, saves and eval fire at the first
  # dispatch boundary on or after each multiple; callbacks see boundary
  # steps only.
  steps_per_dispatch: int = 1
  # Host batches (K=1) or assembled K-batch groups (K>1) that a background
  # thread pulls ahead of the loop, in order, so training is bitwise the
  # same with or without it. None: resolved_prefetch_batches().
  prefetch_batches: Optional[int] = None
  # With steps_per_dispatch=K > 1: a dispatch's whole (features, labels)
  # group moves to the card in ONE side-stream copy of its contiguous
  # pinned superbatch (trainer/h2d/device_puts counts one a dispatch)
  # instead of one copy per leaf. Training is bitwise the same either way.
  device_feed: bool = False
  # Microbatch gradient accumulation: each host batch is preprocessed once,
  # split into M slices along the batch, and the float32 gradients of the
  # M forward/backward passes are summed and divided by M; one update, one
  # EMA step and one guard per batch. Batch norm sees each microbatch
  # ("ghost batch norm"), as in the JAX trainer. B % M must be 0.
  grad_accum_microbatches: int = 1
  # Dense/Conv contraction precision (quantize/fp8_training.py): None
  # leaves the model's own matmul_precision alone, 'bf16' forces it, 'fp8'
  # routes the contractions of a network that threads it through
  # delayed-amax float8 quantize-dequantize, with float32 master weights
  # and the amax windows as network buffers. Applied to the model before
  # the network is built; 'fp8' is gated on this build's fp8 dtypes.
  matmul_precision: Optional[str] = None
  # The per-dispatch step-time breakdown (_DispatchBreakdown): host wait,
  # placement, dispatch, the device wait one dispatch behind (which caps
  # the host's run-ahead at one dispatch) and callbacks, merged into the
  # summaries at log intervals. False keeps the counters only and adds no
  # wait.
  step_breakdown: bool = True
  # Not ported yet; anything but these values raises in Trainer.
  distributed_coordination: Optional[bool] = None  # item 10 (True raises)
  checkpoint_sharded_payloads: str = 'auto'  # item 10 ('on' raises)
  checkpoint_async_commit: bool = False  # item 10

  def resolved_prefetch_batches(self) -> int:
    """``prefetch_batches``, with None resolved as the JAX trainer resolves
    it at K > 1 (2 on a multi-core host, 0 on a single core, where the
    thread contends with the loop). At K = 1 None resolves to 0: the
    uploader already stages one batch ahead, and the stream position that
    input-state checkpoints save stays exact."""
    if self.prefetch_batches is not None:
      return int(self.prefetch_batches)
    if self.steps_per_dispatch <= 1:
      return 0
    return 0 if (os.cpu_count() or 1) <= 1 else 2


def _refuse_unported(config: TrainerConfig) -> None:
  knobs = (
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
  if config.steps_per_dispatch < 1:
    raise ValueError('steps_per_dispatch must be >= 1, got '
                     f'{config.steps_per_dispatch}.')
  if config.grad_accum_microbatches < 1:
    raise ValueError('grad_accum_microbatches must be >= 1, got '
                     f'{config.grad_accum_microbatches}.')


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


# ------------------------------------------------- K-step groups (K > 1)


def _host_leaves(batch: Batch) -> List[Tuple[str, str, np.ndarray]]:
  """(part, key, host array) of a batch's leaves, features then labels."""
  features, labels = batch
  leaves = []
  for part, tensors in (('features', features), ('labels', labels)):
    for key, value in dict(tensors or {}).items():
      if isinstance(value, torch.Tensor):
        if value.device.type != 'cpu':
          raise ValueError(
              f'steps_per_dispatch > 1 groups host batches; {part} {key!r} '
              f'lies on {value.device}.')
        value = value.numpy()
      leaves.append((part, key, np.asarray(value)))
  return leaves


def _signature(batch: Batch, leaves) -> tuple:
  """What must agree for batches to share a group: each leaf's part, key,
  dtype and shape, and whether the batch has labels."""
  return (batch[1] is not None,) + tuple(
      (part, key, value.dtype.str, value.shape) for part, key, value in leaves)


_ALIGN = 256


class _Layout:
  """Where each leaf of a group of ``k`` batches lies in one contiguous
  byte buffer: ``[k, *shape]`` per leaf, each at a 256-byte aligned
  offset, features then labels."""

  def __init__(self, signature: tuple, k: int):
    self.signature, self.k = signature, k
    self.has_labels = signature[0]
    self.entries = []
    offset = 0
    for part, key, dtype, shape in signature[1:]:
      dtype = np.dtype(dtype)
      full = (k,) + tuple(shape)
      nbytes = int(np.prod(full)) * dtype.itemsize
      self.entries.append((part, key, dtype, full, offset, nbytes))
      offset += -(-nbytes // _ALIGN) * _ALIGN
    self.nbytes = max(offset, _ALIGN)

  def host_views(self, buffer: torch.Tensor) -> List[np.ndarray]:
    raw = buffer.numpy()
    return [raw[offset:offset + nbytes].view(dtype).reshape(full)
            for _, _, dtype, full, offset, nbytes in self.entries]

  def views(self, buffer: torch.Tensor):
    """(features, labels) as tensor views of ``buffer`` (labels None when
    the batches had none)."""
    parts = {'features': {}, 'labels': {}}
    for part, key, dtype, full, offset, nbytes in self.entries:
      torch_dtype = torch.from_numpy(np.empty(0, dtype)).dtype
      parts[part][key] = buffer[offset:offset + nbytes].view(
          torch_dtype).view(full)
    return parts['features'], (parts['labels'] if self.has_labels else None)


class _Superbatch:
  """A group of ``layout.k`` host batches in one byte buffer (pinned on a
  card)."""

  __slots__ = ('layout', 'buffer')

  def __init__(self, layout: _Layout, buffer: torch.Tensor):
    self.layout, self.buffer = layout, buffer

  @property
  def k(self) -> int:
    return self.layout.k


class _SuperbatchAssembler:
  """Groups host batches into :class:`_Superbatch` es of up to ``k``.

  The counterpart of the JAX trainer's ``_SuperbatchAssembler``: each
  source batch is copied once, in place, into its slice of a
  preallocated contiguous buffer, and its source ring slot
  (``data/engine.py`` ``release()``) goes back right after its copy.
  Groups are clipped so the loop never passes ``max_steps``; a batch whose
  leaves differ from the open group's closes that group early and starts
  its own (a ragged tail trains as its own short group).

  With ``reuse`` (on a card) the full-size groups take turns in ``slots``
  pinned buffers: the consumer calls :meth:`release` once per delivered
  group after its upload has ended, freeing the oldest; assembly blocks
  while every slot is out. Other groups, and every group without
  ``reuse``, get a buffer of their own (pinned with ``pin``). ``rings``
  keeps the slots by group layout for the next assembler of the same
  trainer, so a ``train`` call does not pin its buffers anew.
  """

  def __init__(self, it: Iterator[Batch], k: int, start_step: int,
               max_steps: int, release: Optional[Callable[[], None]] = None,
               reuse: bool = False, pin: bool = False, slots: int = 2,
               rings: Optional[Dict[tuple, List[torch.Tensor]]] = None):
    self._it = iter(it)
    self._k = max(1, int(k))
    self._max_steps = max_steps
    self._emitted = start_step
    self._release_source = release
    self._reuse, self._pin, self._slots = reuse, pin, slots
    self._rings = {} if rings is None else rings
    self._free: 'queue.Queue' = queue.Queue()
    self._ring: List[torch.Tensor] = []
    self._ring_signature = None
    self._leases: 'collections.deque' = collections.deque()
    self._lock = threading.Lock()
    self.pulled = 0  # source batches taken from the iterator
    self._gen = self._generate()

  def abort(self) -> None:
    """Wakes an assembly that waits for a ring slot, which then raises:
    the loop is done with this assembler."""
    for _ in range(self._slots):
      self._free.put(-1)

  def release(self) -> None:
    """Frees the oldest delivered group's ring slot (if it holds one)."""
    with self._lock:
      if not self._leases:
        raise RuntimeError('release() without an outstanding superbatch')
      slot = self._leases.popleft()
    if slot is not None:
      self._free.put(slot)

  def _alloc(self, nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=self._pin)

  def _assemble(self, group) -> _Superbatch:
    signature = group[0][0]
    layout = _Layout(signature, len(group))
    slot = None
    if self._reuse and layout.k == self._k:
      if self._ring_signature is None:
        self._ring_signature = signature
        self._ring = self._rings.get(signature) or [
            self._alloc(layout.nbytes) for _ in range(self._slots)]
        self._rings[signature] = self._ring
        for i in range(len(self._ring)):
          self._free.put(i)
      if signature == self._ring_signature:
        slot = self._free.get()  # blocks while every slot is out
        if slot < 0:
          raise RuntimeError('the superbatch assembler was aborted')
    buffer = (self._ring[slot] if slot is not None
              else self._alloc(layout.nbytes))
    views = layout.host_views(buffer)
    for i, (_, leaves) in enumerate(group):
      for view, (_, _, value) in zip(views, leaves):
        np.copyto(view[i], value)
      if self._release_source is not None:
        self._release_source()  # its bytes now live in the superbatch
    with self._lock:
      self._leases.append(slot)
    return _Superbatch(layout, buffer)

  def _generate(self):
    group = []
    for batch in self._it:
      self.pulled += 1
      leaves = _host_leaves(batch)
      signature = _signature(batch, leaves)
      if group and signature != group[0][0]:
        yield self._assemble(group)
        self._emitted += len(group)
        group = []
        if self._emitted >= self._max_steps:
          return
      group.append((signature, leaves))
      if len(group) >= min(self._k, self._max_steps - self._emitted):
        yield self._assemble(group)
        self._emitted += len(group)
        group = []
        if self._emitted >= self._max_steps:
          return
    if group:
      yield self._assemble(group)

  def __iter__(self):
    return self

  def __next__(self) -> _Superbatch:
    return next(self._gen)


class _DevicePrefetcher:
  """Pulls items from an iterator on a background thread, up to ``depth``
  ahead, in order (host batches at K = 1, assembled superbatches at K > 1;
  the counterpart of the JAX trainer's ``_DevicePrefetcher`` with the
  placement on the loop thread, where the upload is issued on its side
  stream). A failure of the source is raised at the next ``next()``;
  :meth:`close` stops the thread."""

  _DONE = object()

  def __init__(self, it: Iterator[Any], depth: int):
    self._q: 'queue.Queue' = queue.Queue(maxsize=max(1, depth))
    self._err: Optional[BaseException] = None
    self._stop = threading.Event()
    self.pulled = 0
    self.delivered = 0
    scope = metrics_lib.scope('trainer/prefetch')
    self._starved = scope.counter('starvation')
    self._depth = scope.gauge('queue_depth')

    def worker():
      try:
        for item in it:
          if self._stop.is_set():
            return
          self.pulled += 1
          self._q.put(item)
      except BaseException as e:  # pylint: disable=broad-except
        self._err = e  # raised on the loop thread
      finally:
        self._q.put(self._DONE)

    self._thread = threading.Thread(target=worker, daemon=True,
                                    name='t2r-prefetch')
    self._thread.start()

  @property
  def pending(self) -> int:
    """Items pulled and not yet delivered."""
    return self.pulled - self.delivered

  def __iter__(self):
    return self

  def __next__(self):
    if self._err is not None:
      raise self._err
    try:
      item = self._q.get_nowait()
    except queue.Empty:
      self._starved.inc()
      item = self._q.get()
    self._depth.set(self._q.qsize())
    if item is self._DONE:
      if self._err is not None:
        raise self._err
      self._q.put(self._DONE)
      raise StopIteration
    self.delivered += 1
    return item

  def close(self, timeout: float = 10.0) -> None:
    self._stop.set()
    deadline = time.monotonic() + timeout
    while self._thread.is_alive() and time.monotonic() < deadline:
      try:
        self._q.get(timeout=0.025)
      except queue.Empty:
        pass
    if self._thread.is_alive():
      logging.warning('Prefetch thread did not exit within %.1fs (input '
                      'iterator blocked?); leaving the daemon thread.',
                      timeout)


class _StagedGroup:
  """A superbatch uploaded, or being uploaded, ahead of its dispatch."""

  __slots__ = ('superbatch', 'features', 'labels', 'landing', 'ready',
               'start')

  def __init__(self, superbatch, features, labels, landing, ready, start):
    self.superbatch, self.features, self.labels = superbatch, features, labels
    self.landing, self.ready, self.start = landing, ready, start

  @property
  def k(self) -> int:
    return self.superbatch.k

  @property
  def layout(self) -> _Layout:
    return self.superbatch.layout


class _Landing:
  """A device buffer that superbatches of one layout are uploaded into;
  ``free`` is the event after which the last dispatch that read it is
  done with it."""

  __slots__ = ('buffer', 'free')

  def __init__(self, buffer: torch.Tensor):
    self.buffer, self.free = buffer, None


class _GroupFeed:
  """Moves superbatches to the trainer's device.

  On the card each layout has two device landing buffers used in turn.
  ``stage`` issues the upload on a side stream, one group ahead, after the
  dispatch that last read that landing buffer: with ``device_feed`` the
  whole superbatch in ONE copy (``trainer/h2d/device_puts`` counts one),
  else one copy per leaf. The graph dispatch then copies the landing
  buffer into the graph's own input, which stays at one address (a
  landing buffer, not one graph per input slot: one capture, one memory
  pool, no replay order to keep, for one device-to-device copy a
  dispatch). On the CPU nothing is copied: the group's tensors are views
  of the host buffer, and ``device_feed`` still counts its one placement.
  """

  def __init__(self, device: torch.device, device_feed: bool):
    self._device = device
    self._device_feed = device_feed
    self._stream = (torch.cuda.Stream(device) if device.type == 'cuda'
                    else None)
    self._landing: Dict[tuple, List[Any]] = {}
    self._puts = metrics_lib.counter('trainer/h2d/device_puts')

  def stage(self, superbatch: _Superbatch) -> _StagedGroup:
    layout = superbatch.layout
    if self._stream is None:
      if self._device_feed:
        self._puts.inc()
      features, labels = layout.views(superbatch.buffer)
      return _StagedGroup(superbatch, features, labels, None, None, None)
    ring = self._landing.get(layout.signature + (layout.k,))
    if ring is None:
      ring = [0] + [_Landing(torch.empty(layout.nbytes, dtype=torch.uint8,
                                         device=self._device))
                    for _ in range(2)]
      self._landing[layout.signature + (layout.k,)] = ring
    ring[0] ^= 1
    landing = ring[1 + ring[0]]
    start, ready = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    with torch.cuda.stream(self._stream):
      if landing.free is not None:
        self._stream.wait_event(landing.free)
      start.record(self._stream)
      if self._device_feed:
        landing.buffer.copy_(superbatch.buffer, non_blocking=True)
        self._puts.inc()
      else:
        for dst, src in zip(_flat_views(layout, landing.buffer),
                            _flat_views(layout, superbatch.buffer)):
          dst.copy_(src, non_blocking=True)
      ready.record(self._stream)
    features, labels = layout.views(landing.buffer)
    return _StagedGroup(superbatch, features, labels, landing, ready, start)

  def consume(self, staged: _StagedGroup) -> None:
    """Makes the compute stream wait for the group's upload."""
    if staged.ready is not None:
      torch.cuda.current_stream(self._device).wait_event(staged.ready)

  def finish(self, staged: _StagedGroup,
             release: Optional[Callable[[], None]]) -> None:
    """After the group's dispatch was issued: its landing buffer is free
    once the compute stream passes this point; the host buffer goes back
    (``release``) once the upload has ended."""
    if staged.landing is not None:
      staged.landing.free = torch.cuda.Event()
      staged.landing.free.record(torch.cuda.current_stream(self._device))
      staged.ready.synchronize()
      staged.landing = None
    if release is not None:
      release()


class _InputTimer:
  """The ms a loop iteration spends pulling from the input and issuing
  uploads (the breakdown's wait and placement)."""

  __slots__ = ('wait_ms', 'place_ms')

  def __init__(self):
    self.wait_ms = self.place_ms = 0.0

  def pull(self, it):
    begin = time.perf_counter()
    item = next(it, None)
    self.wait_ms += 1e3 * (time.perf_counter() - begin)
    return item

  def place(self, stage, *args):
    begin = time.perf_counter()
    staged = stage(*args)
    self.place_ms += 1e3 * (time.perf_counter() - begin)
    return staged


def _flat_views(layout: _Layout, buffer: torch.Tensor) -> List[torch.Tensor]:
  return [buffer[offset:offset + nbytes]
          for _, _, _, _, offset, nbytes in layout.entries]


def _split_microbatches(tensors, m: int) -> List[Optional[Dict[str, Any]]]:
  """``m`` slices of each ``[B, ...]`` leaf along the batch; B % m != 0
  raises, naming the leaf."""
  if tensors is None:
    return [None] * m
  tensors = dict(tensors)
  for key, value in tensors.items():
    if value.shape[0] % m:
      raise ValueError(
          f'grad_accum_microbatches={m} does not divide the batch of '
          f'{key!r} ({value.shape[0]}).')
  return [{key: value[i * (value.shape[0] // m):
                      (i + 1) * (value.shape[0] // m)]
           for key, value in tensors.items()} for i in range(m)]


class _DispatchBreakdown:
  """Per-dispatch wall-time decomposition (``TrainerConfig.step_breakdown``),
  the JAX trainer's ``_DispatchBreakdown`` on the port's loops.

  A *boundary* is the instant after a dispatch's one-behind device wait.
  ``wall(i) = boundary(i) - boundary(i-1)`` splits exactly into:

  * ``callback_ms``: from the last boundary to the start of the wait:
    callbacks, logging, saves, interleaved eval;
  * ``host_wait_ms``: pulling the next batch or group from the input
    (span ``trainer/wait_batch``), the input-bound time;
  * ``placement_ms``: issuing its upload (the copy itself runs on the
    feed's side stream);
  * ``dispatch_ms``: the step's or the K-step dispatch's host work and
    enqueue (span ``trainer/dispatch``); a captured graph's relaunch
    waits there for the previous replay of the same graph;
  * ``device_step_ms``: blocked on the PREVIOUS dispatch's completion
    event after enqueueing this one (span ``trainer/device_wait``): the
    device time the host did not hide. One dispatch behind, so the card
    never drains; on the CPU the step ran before its call returned.

  Without ``enabled`` only the counters move (``trainer/dispatches``,
  ``trainer/steps``, ``trainer/examples``) and no wait is added. The
  first dispatch stays out of the windows (it builds and captures);
  :meth:`window_scalars` drains a log window into the scalars the
  callbacks publish. Each boundary is a ``'dispatch'`` flight event.
  """

  _KEYS = ('callback', 'wait', 'place', 'dispatch', 'device')

  def __init__(self, enabled: bool, device: torch.device):
    self.enabled = enabled
    self._cuda = device if device.type == 'cuda' else None
    self._pending: Optional[torch.cuda.Event] = None
    self._boundary: Optional[float] = None
    self._dispatches = metrics_lib.counter('trainer/dispatches')
    self._steps = metrics_lib.counter('trainer/steps')
    self._examples = metrics_lib.counter('trainer/examples')
    self._wall_hist = metrics_lib.histogram('trainer/step_wall_ms')
    self._place_hist = metrics_lib.histogram('trainer/placement_ms')
    self._callback_hist = metrics_lib.histogram('trainer/callback_ms')
    self._windows = metrics_lib.counter('trainer/breakdown_windows')
    self._skipped = metrics_lib.counter('resilience/nonfinite_skipped_steps')
    self._reset_window()

  def _reset_window(self) -> None:
    self._win = dict.fromkeys(self._KEYS, 0.0)
    self._win_wall = 0.0
    self._win_dispatches = self._win_steps = self._win_examples = 0
    self._win_skipped0 = self._skipped.value

  def device_wait(self) -> float:
    """Records this dispatch's completion event and waits for the
    previous one's; returns the ms waited."""
    if not self.enabled or self._cuda is None:
      return 0.0
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(self._cuda))
    previous, self._pending = self._pending, event
    if previous is None:
      return 0.0
    begin = time.perf_counter()
    with tracing.span('trainer/device_wait'):
      previous.synchronize()
    return 1e3 * (time.perf_counter() - begin)

  def record(self, start: float, wait_ms: float, place_ms: float,
             dispatch_ms: float, device_ms: float, boundary: float,
             step: int, steps: int, examples: int) -> None:
    """Closes one dispatch (``start``: the start of its wait)."""
    self._dispatches.inc()
    self._steps.inc(steps)
    self._examples.inc(examples)
    previous, self._boundary = self._boundary, boundary
    if flight.enabled():
      flight.event('dispatch', 'trainer/boundary',
                   f'step={step} wall_ms={(boundary - start) * 1e3:.3f}')
    if not self.enabled or previous is None:
      return
    callback_ms = (start - previous) * 1e3
    wall_ms = (boundary - previous) * 1e3
    self._place_hist.observe(place_ms)
    self._callback_hist.observe(callback_ms)
    self._wall_hist.observe(wall_ms)
    for key, value in zip(self._KEYS, (callback_ms, wait_ms, place_ms,
                                       dispatch_ms, device_ms)):
      self._win[key] += value
    self._win_wall += wall_ms
    self._win_dispatches += 1
    self._win_steps += steps
    self._win_examples += examples

  def window_scalars(self) -> Dict[str, float]:
    """Drains the log window into scalars (and ``trainer/`` gauges):
    examples/s, the input-bound share, goodput (examples whose update the
    guard skipped left out) and each part's ms a dispatch."""
    if not self.enabled or not self._win_dispatches:
      return {}
    n, wall_ms = self._win_dispatches, self._win_wall
    skipped = self._skipped.value - self._win_skipped0
    rate = self._win_examples / (wall_ms / 1e3) if wall_ms > 0 else 0.0
    out = {
        'examples_per_sec': rate,
        'input_bound_fraction': ((self._win['wait'] + self._win['place']) /
                                 wall_ms if wall_ms > 0 else 0.0),
        'goodput_examples_per_sec':
            rate * max(0.0, 1.0 - skipped / max(1, self._win_steps)),
        'breakdown/wall_ms': wall_ms / n,
        'breakdown/host_wait_ms': self._win['wait'] / n,
        'breakdown/placement_ms': self._win['place'] / n,
        'breakdown/dispatch_ms': self._win['dispatch'] / n,
        'breakdown/device_step_ms': self._win['device'] / n,
        'breakdown/callback_ms': self._win['callback'] / n,
    }
    for key, value in out.items():
      metrics_lib.gauge(f'trainer/{key}').set(value)
    self._windows.inc()
    postmortem.note_breakdown_window(out)
    self._reset_window()
    return out


def _batch_examples(tensors, dims: int = 1) -> int:
  """The examples a batch (``dims=1``) or a [k, B, ...] group (``dims=2``)
  holds: the product of its first leaf's leading sizes (0 without
  leaves)."""
  for value in dict(tensors or {}).values():
    return int(np.prod(np.shape(value)[:dims]))
  return 0


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
    if config.matmul_precision is not None:
      # Before any network is built: a network takes its precision at
      # construction.
      if hasattr(model, 'set_matmul_precision'):
        model.set_matmul_precision(config.matmul_precision)
      else:
        fp8_lib.require_fp8_support(config.matmul_precision)
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
    self._prefetcher: Optional[_DevicePrefetcher] = None
    # K > 1 (steps_per_dispatch): the group feed, the staged group, the
    # captured graphs and their static inputs, by group layout.
    self._k = config.steps_per_dispatch
    self._feed: Optional[_GroupFeed] = None
    self._staged_group: Optional[_StagedGroup] = None
    self._assembler: Optional[_SuperbatchAssembler] = None
    self._rings: Dict[tuple, List[torch.Tensor]] = {}
    self._grouped_trained = 0
    self._graphs: Dict[tuple, Any] = {}
    self._statics: Dict[tuple, Dict[str, Any]] = {}
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
    # Whether the manager's host staging has been allocated: after the
    # first update, when the optimizer's slots exist, so that no save pays
    # the page-locked allocation inside a step.
    self._staging_ready = self._manager is None

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
    """Batches pulled from the train iterator and not yet trained: at K=1,
    1 while the next step's batch is staged, plus those a prefetch thread
    holds; at K > 1, those in staged and assembled groups. A prefetch
    thread pulls while the loop runs, so with one the count is a moment's
    (as in the JAX trainer, exact input-state resumes want
    ``prefetch_batches=0``)."""
    if self._assembler is not None:
      return self._assembler.pulled - self._grouped_trained
    staged = 0 if self._staged is None else 1
    if self._prefetcher is not None:
      staged += self._prefetcher.pending
    return staged

  @property
  def captured_dispatches(self) -> Dict[tuple, Any]:
    """The captured K-step graphs (``train/step_graph.CapturedDispatch``),
    by group layout: their capture time and replay count."""
    return dict(self._graphs)

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

  def _prepare_staging(self) -> None:
    if not self._staging_ready:
      self._staging_ready = True
      self._manager.prepare(state_dict(self._state))

  def save_checkpoint(self, force: bool = False) -> None:
    """Saves the current state (see ``CheckpointManager.save``)."""
    if self._manager is None or self._state is None:
      return
    if self._manager.save(self.step, state_dict(self._state), force=force):
      for cb in self._callbacks:
        cb.after_checkpoint(self, self.step)

  def _forward_backward(self, features, labels):
    """Forward and backward of one preprocessed batch; returns (loss,
    summaries). With ``grad_accum_microbatches`` M > 1 the batch is split
    into M slices, each takes its own forward and backward (batch norm
    sees the slice), the float32 gradients accumulate in ``.grad`` and are
    divided by M, and the loss and summaries are the mean of the slices'
    (in float32), as the JAX trainer's accumulation."""
    state, model = self._state, self._model
    state.optimizer.zero_grad(set_to_none=True)
    m = self._config.grad_accum_microbatches
    if m == 1:
      outputs = model.inference_network_fn(state.network, features, labels,
                                           ModeKeys.TRAIN)
      loss, scalars = model.model_train_fn(features, labels, outputs,
                                           ModeKeys.TRAIN)
      loss.backward()
      return loss, scalars
    loss_sum, sums = None, {}
    for f, l in zip(_split_microbatches(features, m),
                    _split_microbatches(labels, m)):
      outputs = model.inference_network_fn(state.network, f, l,
                                           ModeKeys.TRAIN)
      loss, scalars = model.model_train_fn(f, l, outputs, ModeKeys.TRAIN)
      loss.backward()
      loss = loss.detach().float()
      loss_sum = loss if loss_sum is None else loss_sum + loss
      for key, value in scalars.items():
        value = value.detach().float()
        sums[key] = value if key not in sums else sums[key] + value
    grads = [p.grad for p in state.network.parameters() if p.grad is not None]
    if grads:
      torch._foreach_div_(grads, float(m))  # pylint: disable=protected-access
    return loss_sum / m, {key: value / m for key, value in sums.items()}

  def _train_step(self, staged: _Staged) -> Dict[str, torch.Tensor]:
    """One optimizer step on one staged batch; returns device scalars."""
    state = self._state
    model = self._model
    policy = self._nonfinite_policy
    before = snapshot(state) if policy is not None else None
    features, labels = self._uploader.consume(staged)
    features, labels = self._preprocessor.preprocess(
        features, labels, ModeKeys.TRAIN, state.generator)
    loss, scalars = self._forward_backward(features, labels)
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

  # ------------------------------------------------ K steps a dispatch

  def _device_step(self, features, labels, draws: DeviceDraws,
                   rates: torch.Tensor):
    """One optimizer step that reads nothing back to the host, so a CUDA
    graph can capture it: the preprocessor takes its random values from
    ``draws``, the optimizer its rates from ``rates`` (lr, c1, c2 on the
    device), and the guard selects old against new on the device
    (``train_state.device_select``; the fused kernel selects its own
    outputs). Returns (device summaries, the guard's flag or None)."""
    state = self._state
    guard = self._nonfinite_policy is not None
    fused = self._fused_plan is not None
    if guard:
      guarded = guarded_tensors(state, with_update=not fused)
      old = device_snapshot(guarded)
    features, labels = self._preprocessor.preprocess(
        features, labels, ModeKeys.TRAIN, draws)
    loss, scalars = self._forward_backward(features, labels)
    ok = None
    if guard:
      ok = all_finite(loss, [p.grad for p in state.network.parameters()])
    if fused:
      fused_lib.apply_update(self._fused_plan, state.optimizer,
                             state.ema_by_param(), ok, rates=rates)
    else:
      state.optimizer.device_step(rates)
      apply_ema(state, self._model.avg_model_params_decay)
    if guard:
      device_select(guarded, old, ok)
    scalars = {k: v.detach() for k, v in scalars.items()}
    scalars['loss'] = loss.detach()
    return scalars, ok

  def _k_steps(self, features, labels, draws: Optional[torch.Tensor],
               rates: torch.Tensor, slot: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
    """The dispatch program: ``rates.shape[0]`` device steps over the
    ``[k, B, ...]`` group. ``slot`` counts the updates applied in this
    dispatch; step j takes the draws and rates of row ``slot``, so a
    skipped step's draws go to the next one, as the JAX step keys its
    random numbers off the applied count. Returns the last step's
    summaries, the group's ``nonfinite_count`` (with the guard) and
    ``applied`` (``slot``)."""
    k = rates.shape[0]
    slot.zero_()
    bad = None
    scalars: Dict[str, torch.Tensor] = {}
    empty = torch.empty(0, dtype=torch.int64, device=rates.device)
    for j in range(k):
      row = slot.reshape(1)
      f = {key: value[j] for key, value in features.items()}
      l = (None if labels is None else
           {key: value[j] for key, value in labels.items()})
      step_draws = (empty if draws is None else
                    draws.index_select(0, row).reshape(-1))
      scalars, ok = self._device_step(
          f, l, DeviceDraws(step_draws),
          rates.index_select(0, row).reshape(-1))
      if ok is None:
        slot.add_(1)
      else:
        flag = ok.reshape(())
        slot.add_(flag.to(torch.int64))
        miss = (~flag).to(torch.int32)
        bad = miss if bad is None else bad + miss
    out = dict(scalars)
    if bad is not None:
      out['nonfinite_count'] = bad
    out['applied'] = slot
    return out

  def _dispatch_group(self, staged: _StagedGroup) -> Dict[str, torch.Tensor]:
    """K optimizer steps over one staged group (module doc): the host
    draws the group's random values and the rates of the counts it may
    reach, then the card replays the group's captured graph (a group of
    the full size) or the steps run eagerly (the CPU, a short group).
    With the guard on, the applied count is read back (the one read a
    dispatch) and the generator is set to the draws actually used."""
    state = self._state
    k = staged.k
    guard = self._nonfinite_policy is not None
    before = state.generator.get_state() if guard else None
    draws = [self._preprocessor.host_draws(state.generator) for _ in range(k)]
    draws = None if draws[0] is None else draws
    rates = state.optimizer.dispatch_rates(k)
    self._feed.consume(staged)
    if self._device.type == 'cuda' and k == self._k:
      out = self._replay(staged, draws, rates)
    else:
      out = self._k_steps(
          staged.features, staged.labels,
          None if draws is None else torch.tensor(
              draws, dtype=torch.int64, device=self._device),
          torch.tensor(rates, dtype=torch.float32, device=self._device),
          torch.zeros((), dtype=torch.int64, device=self._device))
    applied = k
    if guard:
      applied = int(out['applied'])
      if draws is not None and applied < k:
        state.generator.set_state(before)
        for _ in range(applied):
          self._preprocessor.host_draws(state.generator)
    state.step += applied
    state.optimizer.advance(applied)
    return out

  def _statics_for(self, staged: _StagedGroup, draws, rates):
    """The static inputs of the group layout's graph: the input buffer
    and its views, the draws, the rates and the slot counter, with two
    pinned host buffers that fill draws and rates in turn."""
    key = staged.layout.signature
    statics = self._statics.get(key)
    if statics is None:
      device = self._device
      layout = staged.layout
      buffer = torch.empty(layout.nbytes, dtype=torch.uint8, device=device)
      features, labels = layout.views(buffer)
      width = 0 if draws is None else len(draws[0])
      rate_width = len(rates[0])
      statics = dict(
          buffer=buffer, features=features, labels=labels,
          draws=(None if draws is None else torch.zeros(
              (self._k, width), dtype=torch.int64, device=device)),
          rates=torch.zeros((self._k, rate_width), dtype=torch.float32,
                            device=device),
          slot=torch.zeros((), dtype=torch.int64, device=device),
          host=[[torch.zeros((self._k, max(width, 1)), dtype=torch.int64,
                             pin_memory=True),
                 torch.zeros((self._k, rate_width), dtype=torch.float32,
                             pin_memory=True), None] for _ in range(2)],
          turn=0)
      self._statics[key] = statics
    return statics

  def _replay(self, staged: _StagedGroup, draws, rates
              ) -> Dict[str, torch.Tensor]:
    """Fills the layout's static inputs from the staged group and the
    host values, captures the graph at the layout's first group, and
    replays it."""
    statics = self._statics_for(staged, draws, rates)
    statics['buffer'].copy_(staged.landing.buffer)
    statics['turn'] ^= 1
    host_draws, host_rates, filled = statics['host'][statics['turn']]
    if filled is not None:
      filled.synchronize()  # its last copy to the card has ended
    host_rates.copy_(torch.tensor(rates, dtype=torch.float32))
    statics['rates'].copy_(host_rates, non_blocking=True)
    if draws is not None:
      host_draws.copy_(torch.tensor(draws, dtype=torch.int64))
      statics['draws'].copy_(host_draws, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    statics['host'][statics['turn']][2] = done
    key = staged.layout.signature
    captured = self._graphs.get(key)
    if captured is None:
      state = self._state
      program = functools.partial(
          self._k_steps, statics['features'], statics['labels'],
          statics['draws'], statics['rates'], statics['slot'])
      captured = step_graph.capture(
          program, guarded_tensors(state) + [statics['slot']], self._device)
      logging.info('Captured the %d-step dispatch in %.1f ms.', self._k,
                   captured.capture_ms)
      self._graphs[key] = captured
    return captured.replay()

  def _prepare_grouped(self) -> None:
    """Checks and sets up what K > 1 needs: an optimizer that steps from
    device rates, and its slots created up front (a captured step updates
    them in place and the warm-up before a capture restores them)."""
    optimizer = self._state.optimizer
    if not all(hasattr(optimizer, name) for name in (
        'dispatch_rates', 'device_step', 'advance', 'create_slots')):
      raise NotImplementedError(
          f'steps_per_dispatch={self._k} needs an optimizer that steps from '
          'rates on the device (models/optimizers.py); '
          f'{type(optimizer).__name__} does not.')
    optimizer.create_slots()
    if self._feed is None:
      self._feed = _GroupFeed(self._device, self._config.device_feed)

  def train(self,
            train_iter: Iterator[Batch],
            eval_iter_fn: Optional[Callable[[], Iterator[Batch]]] = None
            ) -> MetricDict:
    """Steps until ``max_train_steps`` updates are applied (at K > 1: steps
    dispatched, as the JAX loop counts) or the iterator runs out, with
    saves and interleaved eval (module doc); returns the last eval pass's
    metrics, else the last step's summaries."""
    config = self._config
    release = getattr(train_iter, 'release', None)
    first = None
    if self._state is None:
      resuming = (self._manager is not None and
                  self._manager.latest_committed_step() is not None)
      probe = next(train_iter)
      self.initialize(probe[0])
      if not resuming:
        first = probe
      elif release is not None:
        release()  # the probe only built the state
    if self._k > 1:
      return self._train_grouped(train_iter, eval_iter_fn, release, first)
    if first is not None:
      self._staged = self._uploader.stage(first, release)
    depth = config.resolved_prefetch_batches()
    if depth > 0:
      self._prefetcher = train_iter = _DevicePrefetcher(train_iter, depth)
    try:
      return self._train_single(train_iter, eval_iter_fn, release)
    finally:
      if self._prefetcher is not None:
        self._prefetcher.close()
        self._prefetcher = None

  def _preempt(self) -> None:
    """Forces a checkpoint at this boundary and raises PreemptedError."""
    logging.warning('Graceful shutdown requested; checkpointing step %d '
                    'and raising PreemptedError (resumable).', self.step)
    self.save_checkpoint(force=True)
    if self._manager is not None:
      self._manager.wait_until_finished()
    self._drop_staged()
    for cb in self._callbacks:
      cb.end(self)
    raise resilience.PreemptedError(self.step)

  def _finish_training(self, eval_iter_fn, scalars, eval_metrics
                       ) -> MetricDict:
    self.save_checkpoint(force=True)
    if self._manager is not None:
      self._manager.wait_until_finished()
    self._drop_staged()
    if eval_iter_fn is not None and not eval_metrics:
      eval_metrics = self.evaluate(eval_iter_fn())
    for cb in self._callbacks:
      cb.end(self)
    return eval_metrics or {k: float(v) for k, v in scalars.items()}

  def _train_single(self, train_iter, eval_iter_fn, release) -> MetricDict:
    """The K = 1 loop: one step a batch, the next batch uploaded during the
    step."""
    config = self._config
    for cb in self._callbacks:
      cb.begin(self)
    shutdown = self.shutdown
    breakdown = _DispatchBreakdown(config.step_breakdown, self._device)
    scalars: Mapping[str, Any] = {}
    eval_metrics: MetricDict = {}
    while self._state.step < config.max_train_steps:
      if shutdown is not None and shutdown.requested:
        self._preempt()
      start = time.perf_counter()
      timer = _InputTimer()
      with tracing.span('trainer/wait_batch'):
        if self._staged is None:
          batch = timer.pull(train_iter)
          if batch is None:
            break
          self._staged = timer.place(self._uploader.stage, batch, release)
        current, self._staged = self._staged, None
        if self._state.step + 1 < config.max_train_steps:
          batch = timer.pull(train_iter)  # uploads during this step
          if batch is not None:
            self._staged = timer.place(self._uploader.stage, batch, release)
      before = self._state.step
      dispatched = time.perf_counter()
      with tracing.span('trainer/dispatch'):
        scalars = self._train_step(current)
        self._uploader.finish(current)
      dispatch_ms = 1e3 * (time.perf_counter() - dispatched)
      device_ms = breakdown.device_wait()
      step = self._state.step
      breakdown.record(start, timer.wait_ms, timer.place_ms, dispatch_ms,
                       device_ms, time.perf_counter(), step, 1,
                       _batch_examples(current.features))
      self._prepare_staging()
      self._dispatch_start_step = before
      if crossed_interval(config.log_interval_steps, before, step):
        scalars = {k: float(v) for k, v in scalars.items()}
        scalars.update(breakdown.window_scalars())
        logging.info('step %d: %s', step, scalars)
      for cb in self._callbacks:
        cb.after_step(self, step, scalars)
      if crossed_interval(config.save_interval_steps, before, step):
        self.save_checkpoint()
      if (eval_iter_fn is not None and config.eval_interval_steps and
          (crossed_interval(config.eval_interval_steps, before, step) or
           step >= config.max_train_steps)):
        eval_metrics = self.evaluate(eval_iter_fn())
    return self._finish_training(eval_iter_fn, scalars, eval_metrics)

  def _train_grouped(self, train_iter, eval_iter_fn, release, first
                     ) -> MetricDict:
    """The K > 1 loop (``steps_per_dispatch``), the JAX loop's: K host
    batches grouped into a superbatch (``_SuperbatchAssembler``),
    optionally assembled ahead on a thread (``_DevicePrefetcher``),
    uploaded one group ahead (``_GroupFeed``) and trained as one dispatch
    (``_dispatch_group``). The loop counts dispatched steps, the state's
    step applied ones; intervals fire at the first boundary on or after
    each multiple, and the guard's count is observed one dispatch
    behind."""
    config = self._config
    self._prepare_grouped()
    on_card = self._device.type == 'cuda'
    host_iter = (itertools.chain([first], train_iter) if first is not None
                 else train_iter)
    host_step = self.step
    self._assembler = assembler = _SuperbatchAssembler(
        host_iter, self._k, host_step, config.max_train_steps,
        release=release, reuse=on_card, pin=on_card, rings=self._rings)
    self._grouped_trained = 0
    group_release = assembler.release
    groups: Iterator[_Superbatch] = assembler
    depth = config.resolved_prefetch_batches()
    prefetcher = None
    if depth > 0:
      prefetcher = groups = _DevicePrefetcher(assembler, depth)
    for cb in self._callbacks:
      cb.begin(self)
    shutdown = self.shutdown
    policy = self._nonfinite_policy
    pending: Optional[Tuple[torch.Tensor, int]] = None
    scalars: Mapping[str, Any] = {}
    eval_metrics: MetricDict = {}
    breakdown = _DispatchBreakdown(config.step_breakdown, self._device)
    try:
      while host_step < config.max_train_steps:
        if shutdown is not None and shutdown.requested:
          self._preempt()
        start = time.perf_counter()
        timer = _InputTimer()
        with tracing.span('trainer/wait_batch'):
          if self._staged_group is None:
            superbatch = timer.pull(groups)
            if superbatch is None:
              break
            self._staged_group = timer.place(self._feed.stage, superbatch)
          current, self._staged_group = self._staged_group, None
          if host_step + current.k < config.max_train_steps:
            superbatch = timer.pull(groups)  # uploads during this dispatch
            if superbatch is not None:
              self._staged_group = timer.place(self._feed.stage, superbatch)
        before = host_step
        dispatched = time.perf_counter()
        with tracing.span('trainer/dispatch'):
          out = self._dispatch_group(current)
          self._feed.finish(current, group_release)
        dispatch_ms = 1e3 * (time.perf_counter() - dispatched)
        device_ms = breakdown.device_wait()
        host_step += current.k
        breakdown.record(start, timer.wait_ms, timer.place_ms, dispatch_ms,
                         device_ms, time.perf_counter(), host_step,
                         current.k, _batch_examples(current.features, 2))
        self._prepare_staging()
        self._grouped_trained += current.k
        self._dispatch_start_step = before
        scalars = {k: v for k, v in out.items() if k != 'applied'}
        if policy is not None:
          previous, pending = pending, (scalars['nonfinite_count'],
                                        host_step)
          if previous is not None:
            policy.observe(int(previous[0]), previous[1])
        if crossed_interval(config.log_interval_steps, before, host_step):
          scalars = {k: float(v) for k, v in scalars.items()}
          scalars.update(breakdown.window_scalars())
          logging.info('step %d: %s', host_step, scalars)
        for cb in self._callbacks:
          cb.after_step(self, host_step, scalars)
        if crossed_interval(config.save_interval_steps, before, host_step):
          # A boundary is rarely a multiple of the interval: the crossing
          # decides, past the manager's own multiple test.
          self.save_checkpoint(force=True)
        if (eval_iter_fn is not None and config.eval_interval_steps and
            (crossed_interval(config.eval_interval_steps, before,
                              host_step) or
             host_step >= config.max_train_steps)):
          eval_metrics = self.evaluate(eval_iter_fn())
      if pending is not None:
        policy.observe(int(pending[0]), pending[1])
      return self._finish_training(eval_iter_fn, scalars, eval_metrics)
    finally:
      if self._staged_group is not None:  # a raise left a group staged
        self._feed.finish(self._staged_group, None)
        self._staged_group = None
      if prefetcher is not None:
        assembler.abort()  # a worker waiting for a ring slot stops
        prefetcher.close()
      self._assembler = None

  def _drop_staged(self) -> None:
    """Lets go of a staged batch or group that will not be trained in this
    call (its ring slot goes back once its copy has ended)."""
    if self._staged is not None:
      self._uploader.finish(self._staged)
      self._staged = None
    if self._staged_group is not None:
      self._feed.finish(self._staged_group, self._assembler.release)
      self._staged_group = None

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
                     prefetch_batches: Optional[int] = None,
                     device_feed: bool = False,
                     grad_accum_microbatches: int = 1,
                     step_breakdown: bool = True,
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
    evaluated checkpoint of an eval-only job;
  * ``steps_per_dispatch``, ``prefetch_batches``, ``device_feed``,
    ``grad_accum_microbatches`` and ``step_breakdown`` go to the
    :class:`TrainerConfig` fields of the same names.
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
      prefetch_batches=prefetch_batches,
      device_feed=device_feed,
      grad_accum_microbatches=grad_accum_microbatches,
      step_breakdown=step_breakdown,
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
