"""Checkpoints: the port's counterpart of
``tensor2robot_tpu/train/checkpoints.py``, for one process on one device.

Layout and commit protocol. Step ``s`` is written to
``<directory>/ckpt_<s>/state.pt`` with ``torch.save`` (a payload of
tensors, numbers, strings and containers, so ``torch.load(...,
weights_only=True)`` reads it back), in a temporary directory whose file
is flushed and fsynced before the directory is renamed into place. Its
``commit.json`` marker (the JAX schema: ``step``, ``time``, ``hosts``,
``topology``) is published last, by the same write-temp, fsync and
``os.replace``. Once any step of a directory
carries a marker, a step without one is TORN (a save cut off by a
preemption) and is invisible to :func:`latest_checkpoint_step`,
:func:`checkpoints_iterator` and :meth:`CheckpointManager.restore`; each
torn step is logged once. A directory with no marker at all predates the
protocol, and every step in it stays visible, as in the JAX package.

Saves. With ``async_save`` the manager makes one synchronous copy of the
payload to host memory, the only wait in the train loop, and writes the
file on a background thread; the marker is published once the write is
durable: at the next :meth:`CheckpointManager.save`, or at
:meth:`CheckpointManager.wait_until_finished` / :meth:`close`. The copy
lands in one staging buffer a dtype (:class:`HostStaging`: page-locked
when the payload is on a card, kept from save to save), every tensor a
contiguous view of it, so ``torch.save`` on the writer thread writes one
storage a dtype, each with the interpreter lock released, and pickles
the views' headers from reductions kept since the first save; the loop
pays the copy and little else.
Retention follows orbax's: the newest ``max_to_keep`` committed steps
survive, and so does every step that is a multiple of ``keep_period``.

Restore. The newest committed step is loaded; a payload that fails to
load (truncated by a preemption, corrupt) logs a warning that says it is
falling back and the next older committed step is tried; when every one
fails, :class:`RuntimeError` ('failed to restore') says so. A marker
whose topology (the semantic keys the port has: microbatches, steps per
dispatch, process count) differs from this run's raises
:class:`TopologyMismatchError` instead of a fallback.

The continuous evaluator's backup (:func:`create_backup_checkpoint_for_eval`,
:func:`restore_from_backup`) copies the step it evaluates out of the
trainer's reach, so the trainer's retention cannot delete it mid-eval.

Not ported here (ROADMAP queue 1 item 10): the multi-host acks, sharded
payloads, the resharding restore and the asynchronous multi-host commit.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import shutil
import threading
import time
import types
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

import torch

COMMIT_FILENAME = 'commit.json'
STATE_FILENAME = 'state.pt'
EVAL_BACKUP_DIRNAME = 'current_eval_checkpoint'

# (directory, step) pairs already reported as torn: the continuous evaluator
# scans every second, and a torn step is worth one warning.
_REPORTED_TORN: Set[Tuple[str, int]] = set()
_REPORTED_TORN_LOCK = threading.Lock()


class TopologyMismatchError(RuntimeError):
  """A checkpoint was saved under another run topology than this one's."""


def _step_dir(directory: str, step: int) -> str:
  return os.path.join(directory, f'ckpt_{int(step)}')


def commit_marker_path(directory: str, step: int) -> str:
  return os.path.join(_step_dir(directory, step), COMMIT_FILENAME)


def state_path(step_dir: str) -> str:
  return os.path.join(step_dir, STATE_FILENAME)


def write_durably(path: str, write) -> None:
  """``write(file)`` into a temporary file, fsynced, then renamed onto
  ``path``: a reader sees the whole file or none."""
  tmp = f'{path}.tmp{os.getpid()}'
  with open(tmp, 'wb') as f:
    write(f)
    f.flush()
    os.fsync(f.fileno())
  os.replace(tmp, path)


def read_commit_marker(directory: str, step: int) -> Optional[Dict[str, Any]]:
  """The commit marker of ``step``, or None if absent or unreadable."""
  try:
    with open(commit_marker_path(directory, step)) as f:
      return json.load(f)
  except (OSError, ValueError):
    return None


def write_commit_marker(directory: str, step: int,
                        topology: Optional[Dict[str, Any]] = None) -> str:
  """Publishes the commit marker of ``step`` atomically (one process: the
  hosts are ``[0]``)."""
  payload = {'step': int(step), 'time': time.time(), 'hosts': [0]}
  if topology is not None:
    payload['topology'] = dict(topology)
  path = commit_marker_path(directory, step)
  write_durably(path, lambda f: f.write(json.dumps(payload, indent=2)
                                        .encode()))
  return path


def _fs_steps(directory: str) -> List[int]:
  """Step numbers on disk, committed or not, ascending. Entries whose
  suffix is not a number (``ckpt_backup``, ``ckpt_7.tmpfoo``) are not
  steps."""
  try:
    names = os.listdir(directory)
  except FileNotFoundError:
    return []
  steps = []
  for name in names:
    if not name.startswith('ckpt_'):
      continue
    suffix = name.rsplit('_', 1)[-1]
    if suffix.isdigit():
      steps.append(int(suffix))
  return sorted(steps)


def _report_torn(directory: str, step: int, where: str) -> None:
  key = (os.path.abspath(directory), int(step))
  with _REPORTED_TORN_LOCK:
    if key in _REPORTED_TORN:
      return
    _REPORTED_TORN.add(key)
  logging.warning(
      'Checkpoint step %d under %r has no commit marker: a torn checkpoint '
      '(a save cut off by a preemption); skipping it in %s.', step,
      directory, where)


def _committed_steps(directory: str, steps: List[int],
                     where: str) -> Tuple[List[int], bool]:
  """(the visible steps of ``steps``, whether the protocol is active):
  with no marker anywhere every step is visible; otherwise only marked
  ones, and each unmarked one is reported once as torn."""
  marked = [s for s in steps
            if os.path.exists(commit_marker_path(directory, s))]
  if not marked:
    return steps, False
  for s in steps:
    if s not in marked:
      _report_torn(directory, s, where)
  return marked, True


def _check_topology(saved: Optional[Dict[str, Any]],
                   expected: Optional[Dict[str, Any]], directory: str,
                   step: int) -> None:
  """Raises :class:`TopologyMismatchError` when a key that both the
  checkpoint's recorded topology and this run's hold differs."""
  if not saved or not expected:
    return
  mismatches = {key: (saved[key], expected[key])
                for key in sorted(set(saved) & set(expected))
                if saved[key] != expected[key]}
  if not mismatches:
    return
  detail = '; '.join(f'{key}: checkpoint has {was!r}, this run has {now!r}'
                     for key, (was, now) in mismatches.items())
  raise TopologyMismatchError(
      f'Checkpoint step {step} under {directory!r} was saved with a '
      f'different topology than this run: {detail}. Restoring it would '
      'silently misinterpret the saved state. Either relaunch with the '
      'recorded topology, or, if the change is intentional, disable the '
      'check with TrainerConfig.checkpoint_topology_check=False / '
      'CheckpointManager(topology=None).')


def write_payload(path: str, payload,
                  pickle_module=pickle) -> Dict[str, float]:
  """``torch.save`` of ``payload`` straight to ``path`` (torch's native
  file writer, not a Python file object), then fsynced: a reader sees the
  whole file or none after the caller's rename. Returns its ms: the
  serialization and its writes (``serialize_ms``) and the fsync
  (``sync_ms``)."""
  start = time.perf_counter()
  torch.save(payload, path, pickle_module=pickle_module)
  written = time.perf_counter()
  fd = os.open(path, os.O_RDONLY)
  try:
    os.fsync(fd)
  finally:
    os.close(fd)
  return {'serialize_ms': (written - start) * 1e3,
          'sync_ms': (time.perf_counter() - written) * 1e3}


def load_payload(step_dir: str) -> Dict[str, Any]:
  """The payload of one step directory, on the CPU."""
  return torch.load(state_path(step_dir), map_location='cpu',
                    weights_only=True)


def to_host(payload):
  """A copy of ``payload`` with every tensor copied to host memory (a CPU
  tensor is copied too: training goes on updating it in place)."""
  if isinstance(payload, torch.Tensor):
    return payload.detach().to('cpu', copy=True)
  if isinstance(payload, dict):
    return {k: to_host(v) for k, v in payload.items()}
  if isinstance(payload, (list, tuple)):
    return type(payload)(to_host(v) for v in payload)
  return payload


class HostStaging:
  """Host copies of payloads in one buffer a dtype, reused from copy to
  copy while the payload's tensors keep their dtypes and shapes.

  :meth:`copy` returns the payload's structure with every tensor replaced
  by a contiguous view of its dtype's buffer holding its bytes. Buffers
  are page-locked when a tensor is on a CUDA card: its copy is then
  issued ``non_blocking`` and the call synchronizes once, after the last.
  The views of one copy stay valid until the next :meth:`copy`, and are
  the same objects from copy to copy, so :attr:`pickle_module` can hand
  ``torch.save`` each view's reduction (``Tensor.__reduce_ex__``'s own,
  kept from the first save) instead of recomputing it, and ask torch's
  ``persistent_id`` of storages alone: the writer's pickling of a payload
  of a thousand tensors then takes a fraction of the interpreter's time
  it took (the loop's time, while the loop runs Python), and the file is
  byte for byte the same."""

  def __init__(self):
    self._layout = None
    self._buffers: Dict[torch.dtype, torch.Tensor] = {}
    self._views: List[torch.Tensor] = []
    self._reductions: Dict[int, Any] = {}
    # id of each reduction's storage object -> its buffer's dtype.
    self._buffer_of: Dict[int, torch.dtype] = {}
    staging = self

    class Pickler(pickle.Pickler):

      def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # torch.save's subclass asks its persistent_id of every object;
        # only a storage has one, so the others skip the call, and the
        # views of one buffer share their buffer's (torch's answer is the
        # same for each: it names the whole storage).
        storage_id = self.persistent_id
        typed = torch.storage.TypedStorage
        buffer_of = staging._buffer_of  # pylint: disable=protected-access
        ids = {}

        def persistent_id(obj):
          if type(obj) is not typed:  # pylint: disable=unidiomatic-typecheck
            return None
          buffer = buffer_of.get(id(obj))
          if buffer is None:
            return storage_id(obj)
          if buffer not in ids:
            ids[buffer] = list(storage_id(obj))
          return tuple(ids[buffer])  # a new tuple, as torch's are

        pickle.Pickler.persistent_id.__set__(self, persistent_id)

      def reducer_override(self, obj):
        if type(obj) is torch.Tensor:  # pylint: disable=unidiomatic-typecheck
          reduction = staging._reductions.get(id(obj))  # pylint: disable=protected-access
          if reduction is not None:
            return reduction
        return NotImplemented

    # What torch.save reads of its pickle_module: a name and a Pickler.
    self.pickle_module = types.SimpleNamespace(__name__='pickle',
                                               Pickler=Pickler)

  @staticmethod
  def _tensors(payload, out: List[torch.Tensor]) -> None:
    if isinstance(payload, torch.Tensor):
      out.append(payload)
    elif isinstance(payload, dict):
      for value in payload.values():
        HostStaging._tensors(value, out)
    elif isinstance(payload, (list, tuple)):
      for value in payload:
        HostStaging._tensors(value, out)

  def _allocate(self, tensors: List[torch.Tensor], pin: bool) -> None:
    sizes: Dict[torch.dtype, int] = {}
    for t in tensors:
      sizes[t.dtype] = sizes.get(t.dtype, 0) + t.numel()
    self._buffers = {dtype: torch.empty(n, dtype=dtype, pin_memory=pin)
                     for dtype, n in sizes.items()}
    offsets = dict.fromkeys(self._buffers, 0)
    self._views = []
    for t in tensors:
      start = offsets[t.dtype]
      offsets[t.dtype] = start + t.numel()
      self._views.append(
          self._buffers[t.dtype][start:start + t.numel()].view(t.shape))
    self._reductions = {id(v): v.__reduce_ex__(2) for v in self._views}
    self._buffer_of = {id(r[1][0]): v.dtype
                       for v, r in zip(self._views,
                                       self._reductions.values())}

  def _prepare(self, payload) -> Tuple[List[torch.Tensor], bool]:
    tensors: List[torch.Tensor] = []
    self._tensors(payload, tensors)
    on_card = any(t.is_cuda for t in tensors)
    layout = (on_card, tuple((t.dtype, tuple(t.shape)) for t in tensors))
    if layout != self._layout:
      self._allocate(tensors, on_card and torch.cuda.is_available())
      self._layout = layout
    return tensors, on_card

  def prepare(self, payload) -> None:
    """Allocates the buffers for payloads shaped like ``payload`` (a
    page-locked allocation takes about half a second a GB), so that a
    later :meth:`copy` of such a payload pays only its copy."""
    self._prepare(payload)

  def copy(self, payload):
    tensors, on_card = self._prepare(payload)
    views = {}
    for t, view in zip(tensors, self._views):
      view.copy_(t.detach(), non_blocking=t.is_cuda)
      views[id(t)] = view
    if on_card:
      torch.cuda.synchronize()
    return self._rebuild(payload, views)

  @staticmethod
  def _rebuild(payload, views):
    if isinstance(payload, torch.Tensor):
      return views[id(payload)]
    if isinstance(payload, dict):
      return {k: HostStaging._rebuild(v, views) for k, v in payload.items()}
    if isinstance(payload, (list, tuple)):
      return type(payload)(HostStaging._rebuild(v, views) for v in payload)
    return payload


class CheckpointManager:
  """Saves, retains and restores the steps of one directory (see the
  module doc). ``topology`` is recorded in every marker and checked on
  restore (None: neither)."""

  def __init__(self,
               directory: str,
               max_to_keep: Optional[int] = 5,
               keep_period: Optional[int] = None,
               save_interval_steps: int = 1,
               async_save: bool = True,
               topology: Optional[Dict[str, Any]] = None):
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    self._directory = directory
    self._max_to_keep = max_to_keep
    self._keep_period = keep_period
    self._save_interval = max(1, int(save_interval_steps))
    self._async_save = async_save
    self._topology = dict(topology) if topology else None
    # The step whose payload is written (or being written) but has no
    # marker yet, and its writer thread and error.
    self._pending: Optional[int] = None
    self._writer: Optional[threading.Thread] = None
    self._write_error: Optional[BaseException] = None
    self._staging = HostStaging()
    # Milliseconds of the last save: the host copy (what the train loop
    # waits for), and on the writer thread the serialization with its
    # writes, the fsync and the whole write to durable.
    self.timings: Dict[str, float] = {}

  @property
  def directory(self) -> str:
    return self._directory

  # -------------------------------------------------------------- saves

  def _write(self, step: int, payload) -> None:
    """Writes the step into a temporary directory, which is not a step,
    and renames it into place once the payload is durable."""
    start = time.perf_counter()
    step_dir = _step_dir(self._directory, step)
    tmp = f'{step_dir}.tmp{os.getpid()}'
    try:
      shutil.rmtree(tmp, ignore_errors=True)
      os.makedirs(tmp)
      self.timings.update(write_payload(
          state_path(tmp), payload, self._staging.pickle_module))
      # Anything already there has no marker: a torn leftover of a run
      # that died at this step.
      shutil.rmtree(step_dir, ignore_errors=True)
      os.replace(tmp, step_dir)
    except BaseException as e:  # pylint: disable=broad-except
      self._write_error = e  # raised by the next save or wait
      return
    self.timings['write_ms'] = (time.perf_counter() - start) * 1e3

  def _finish_pending(self) -> None:
    """Waits for the pending write, then publishes its marker and runs
    retention; raises the write's error, leaving the step torn."""
    if self._writer is not None:
      self._writer.join()
      self._writer = None
    step, self._pending = self._pending, None
    error, self._write_error = self._write_error, None
    if error is not None:
      raise RuntimeError(
          f'checkpoint step {step} under {self._directory!r} failed to '
          'write; it stays uncommitted') from error
    if step is None:
      return
    write_commit_marker(self._directory, step, topology=self._topology)
    self._gc()

  def _gc(self) -> None:
    if self._max_to_keep is None:
      return
    committed, _ = _committed_steps(self._directory,
                                    _fs_steps(self._directory), 'retention')
    for step in committed[:-self._max_to_keep] if self._max_to_keep else (
        committed):
      if self._keep_period and step % self._keep_period == 0:
        continue
      shutil.rmtree(_step_dir(self._directory, step), ignore_errors=True)

  def save(self, step: int, payload, force: bool = False) -> bool:
    """Saves ``payload`` as ``step``; True when a save happened. Unless
    ``force``, only multiples of ``save_interval_steps`` are saved, and a
    step already committed or pending is not saved again."""
    step = int(step)
    if step == self._pending or read_commit_marker(self._directory,
                                                   step) is not None:
      return False
    if not force and step % self._save_interval:
      return False
    # The staging buffers hold the pending write's payload until it ends.
    self._finish_pending()
    start = time.perf_counter()
    host = self._staging.copy(payload)
    self.timings = {'copy_ms': (time.perf_counter() - start) * 1e3}
    self._pending = step
    if self._async_save:
      self._writer = threading.Thread(target=self._write, args=(step, host),
                                      name=f't2r-ckpt-{step}', daemon=True)
      self._writer.start()
    else:
      self._write(step, host)
      self._finish_pending()
    return True

  def prepare(self, payload) -> None:
    """Allocates the host staging for payloads shaped like ``payload``
    ahead of the first save (:meth:`HostStaging.prepare`)."""
    self._finish_pending()
    self._staging.prepare(payload)

  def wait_until_finished(self) -> None:
    """Blocks until the pending write is durable and committed."""
    self._finish_pending()

  def close(self) -> None:
    self._finish_pending()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()

  # ------------------------------------------------------------ restore

  def restore(self, step: Optional[int] = None,
              fallback_to_older: bool = True
              ) -> Optional[Tuple[int, Dict[str, Any]]]:
    """(step, payload) of the newest committed step, or of ``step``;
    None when there is none. See the module doc for the fallback and the
    topology check. An explicit ``step`` restores exactly that step or
    raises (a torn one included)."""
    if step is not None:
      step = int(step)
      _, protocol_active = _committed_steps(
          self._directory, _fs_steps(self._directory), 'restore')
      marker = read_commit_marker(self._directory, step)
      if protocol_active and marker is None:
        raise RuntimeError(
            f'checkpoint step {step} under {self._directory!r} has no '
            'commit marker (torn/uncommitted); refusing to restore it.')
      if marker is not None:
        _check_topology(marker.get('topology'), self._topology,
                       self._directory, step)
      return step, load_payload(_step_dir(self._directory, step))
    steps, _ = _committed_steps(self._directory, _fs_steps(self._directory),
                                'restore')
    if not steps:
      return None
    last_exc: Optional[BaseException] = None
    for i, s in enumerate(reversed(steps)):
      marker = read_commit_marker(self._directory, s)
      if marker is not None:
        # Every step of a directory comes from one job shape: an older
        # step would fail the same way, so this raises, not falls back.
        _check_topology(marker.get('topology'), self._topology,
                       self._directory, s)
      try:
        payload = load_payload(_step_dir(self._directory, s))
      except Exception as e:  # pylint: disable=broad-except
        last_exc = e
        if not fallback_to_older:
          raise
        logging.warning(
            'Checkpoint step %d failed to restore (%r); falling back to the '
            'next-older step.', s, e)
        continue
      if i:
        logging.warning(
            'Restored checkpoint step %d after %d newer step(s) failed to '
            'load (the latest was likely truncated by a preemption).', s, i)
      return s, payload
    raise RuntimeError(
        f'All {len(steps)} checkpoint(s) under {self._directory!r} failed '
        f'to restore; last error: {last_exc!r}') from last_exc

  # -------------------------------------------------------- bookkeeping

  def all_steps(self) -> List[int]:
    """Every step in the directory, committed or still being written:
    the steps whose companions (an input state) must be kept."""
    steps = set(_fs_steps(self._directory))
    if self._pending is not None:
      steps.add(self._pending)
    return sorted(steps)

  def latest_committed_step(self) -> Optional[int]:
    """The newest step :meth:`restore` would consider."""
    steps, _ = _committed_steps(self._directory, _fs_steps(self._directory),
                                'latest_committed_step')
    return steps[-1] if steps else None


def latest_checkpoint_step(directory: str) -> Optional[int]:
  """The newest COMMITTED step of ``directory`` (see the module doc), or
  None; stray ``ckpt_*`` entries that are not steps are skipped."""
  steps, _ = _committed_steps(directory, _fs_steps(directory),
                              'latest_checkpoint_step')
  return steps[-1] if steps else None


def checkpoints_iterator(directory: str,
                         min_interval_secs: float = 1.0,
                         timeout: Optional[float] = None,
                         stop_after_step: Optional[int] = None
                         ) -> Iterator[int]:
  """Yields each new newest committed step as it appears (the continuous
  evaluator's watch), until ``timeout`` seconds pass without one or a step
  reaches ``stop_after_step``."""
  last_seen = None
  deadline = None if timeout is None else time.time() + timeout
  while True:
    step = latest_checkpoint_step(directory)
    if step is not None and step != last_seen:
      last_seen = step
      deadline = None if timeout is None else time.time() + timeout
      yield step
      if stop_after_step is not None and step >= stop_after_step:
        return
      continue
    if deadline is not None and time.time() > deadline:
      return
    time.sleep(min_interval_secs)


def create_backup_checkpoint_for_eval(ckpt_dir: str,
                                      step: int,
                                      backup_dir: str,
                                      num_retries: int = 3
                                      ) -> Optional[str]:
  """Copies checkpoint ``step`` into the evaluator's own directory; the
  backed-up step directory, or None if the trainer's retention deleted the
  step before a complete copy was made.

  The source must still exist after the copy completes (a vanished source
  means the copy may be partial), else the copy is retried.
  """
  src = _step_dir(ckpt_dir, step)
  os.makedirs(backup_dir, exist_ok=True)
  final = _step_dir(backup_dir, step)
  if os.path.isdir(final):
    return final
  for _ in range(num_retries):
    if not os.path.isdir(src):
      return None
    tmp = os.path.join(backup_dir, f'.tmp_ckpt_{int(step)}')
    shutil.rmtree(tmp, ignore_errors=True)
    try:
      shutil.copytree(src, tmp)
    except (FileNotFoundError, shutil.Error):
      continue  # retention raced the copy
    if not os.path.isdir(src):
      shutil.rmtree(tmp, ignore_errors=True)
      continue
    # One step at a time in the backup directory.
    for name in os.listdir(backup_dir):
      if name.startswith('ckpt_'):
        shutil.rmtree(os.path.join(backup_dir, name), ignore_errors=True)
    os.replace(tmp, final)
    return final
  return None


def restore_from_backup(backup_step_dir: str) -> Dict[str, Any]:
  """The payload of a backed-up step directory."""
  return load_payload(os.path.abspath(backup_step_dir))
