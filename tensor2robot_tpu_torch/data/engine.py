"""Parallel host input engine: stage-overlapped, deterministic batching.

The port's counterpart of ``tensor2robot_tpu/data/engine.py``, without its
metrics and its mid-run re-autotune (ROADMAP queue 1 item 10).

Stages, each its own thread(s), joined by bounded queues:

  ticket issuer   ONE thread walks the interleaved, shuffled record stream
                  in its deterministic order and slices it into numbered
                  batch tickets ``(seq, [records])``. All ordering
                  authority lives here.
  workers (N)     each pulls a ticket and runs parse + image decode for
                  its WHOLE batch (the expensive work, mostly outside the
                  interpreter lock: C++ parse, zlib, libjpeg), concurrently
                  across DIFFERENT batches.
  reorder         delivers parsed batches strictly in ticket order, so the
                  stream is byte-identical to the serial path for ANY
                  worker count, and an error surfaces at exactly the batch
                  where the serial path would have raised it.

Delivery order is ticket order is record order, so the stream position is
the delivered batch count: what makes a resumable input state possible.

Backpressure: at most ``ring_depth`` tickets are outstanding. With
``reuse_buffers=True`` the ring is literal: each slot owns contiguous image
buffers (``parse_fn.make_image_buffers``, page-locked when the generator
pins them) that workers decode straight into, and a slot recycles only
after the consumer calls :meth:`release`, oldest first. Delivered image
arrays are VIEWS of slot buffers; release declares them dead. The trainer
releases a slot once its upload to the card has completed.

Sizing is core-aware: :func:`autotune` reads the cores available to the
process and collapses to the serial path on a single core.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue as queue_lib
import threading
import time
from typing import Any, Callable, Iterable, Iterator, List, Optional

# Workers beyond ~4 stop paying off: the decoders already fan one batch
# over threads.
_DEFAULT_MAX_WORKERS = 4


def available_cpus() -> int:
  """CPUs available to this process (affinity-aware; ``os.cpu_count``
  overstates them under taskset or in a container)."""
  try:
    return len(os.sched_getaffinity(0))
  except (AttributeError, OSError):
    return os.cpu_count() or 1


@dataclasses.dataclass(frozen=True)
class EngineDecision:
  """One autotune outcome."""

  num_workers: int
  ring_depth: int
  cpus: int
  reason: str

  @property
  def serial(self) -> bool:
    return self.num_workers == 0


def autotune(num_workers: Optional[int] = None,
             ring_depth: Optional[int] = None,
             cpus: Optional[int] = None) -> EngineDecision:
  """Core-aware worker and ring sizing; explicit arguments win.

  ``num_workers=None``: 0 (serial) on a single core, else ``min(cpus - 1,
  4)``. ``ring_depth`` defaults to twice the workers and is at least one
  more than them."""
  cpus = available_cpus() if cpus is None else int(cpus)
  if num_workers is not None:
    workers = max(0, int(num_workers))
    reason = f'explicit num_workers={workers}'
  elif cpus <= 1:
    workers = 0
    reason = ('single-core host: serial path (pipeline threads would '
              'contend with the train loop)')
  else:
    workers = min(cpus - 1, _DEFAULT_MAX_WORKERS)
    reason = f'{cpus} cpus: min(cpus - 1, {_DEFAULT_MAX_WORKERS})'
  if ring_depth is None:
    ring_depth = 2 * workers
  ring_depth = max(int(ring_depth), workers + 1) if workers else 0
  return EngineDecision(num_workers=workers, ring_depth=ring_depth,
                        cpus=cpus, reason=reason)


class _Failure:
  """A ticket whose production raised: delivered in order, then raised."""

  __slots__ = ('exc',)

  def __init__(self, exc: BaseException):
    self.exc = exc


class ParallelBatchEngine:
  """Ticket-ordered parallel read -> parse -> decode over a record stream.

  ``records``: the raw serialized-record iterator, consumed by ONE issuer
  thread, so its order is kept exactly. ``parse_fn(records) -> batch``
  runs in the workers and must be safe across DIFFERENT record lists.
  ``num_workers == 0`` is the serial inline loop with no threads: the
  reference every parallel configuration is held to byte for byte.

  Iteration yields one parsed batch per ``batch_size`` records; a final
  short batch is dropped (``drop_remainder``). ``delivered`` counts
  yielded batches from ``start_delivered`` on: the stream position.
  """

  _DONE = object()

  def __init__(self,
               records: Iterable[bytes],
               parse_fn: Callable[..., Any],
               batch_size: int,
               num_workers: int,
               ring_depth: Optional[int] = None,
               reuse_buffers: bool = False,
               lease_timeout: float = 30.0,
               start_delivered: int = 0):
    if batch_size <= 0:
      raise ValueError(f'batch_size must be positive, got {batch_size}')
    self._records = iter(records)
    self._parse_fn = parse_fn
    self._batch_size = int(batch_size)
    self._num_workers = max(0, int(num_workers))
    self._serial = self._num_workers == 0
    self.delivered = int(start_delivered)
    self._closed = False
    if self._serial:
      return
    if ring_depth is None:
      ring_depth = 2 * self._num_workers
    self._ring_depth = max(int(ring_depth), self._num_workers + 1)
    self._lease_cond = threading.Condition()
    self._lease_timeout = float(lease_timeout)
    # Outstanding-ticket bound: a permit per issued ticket, returned at
    # delivery, or in ring mode at the release that frees the slot.
    self._sem = threading.Semaphore(self._ring_depth)
    self._ticket_q: 'queue_lib.Queue' = queue_lib.Queue()
    self._cond = threading.Condition()
    self._results: dict = {}  # seq -> batch | _Failure
    self._next_seq = 0
    self._end_seq: Optional[int] = None  # first seq never produced
    self._stop = threading.Event()
    self._reuse = bool(reuse_buffers)
    self._free_slots: 'queue_lib.Queue' = queue_lib.Queue()
    self._slot_of: dict = {}  # seq -> slot id (ring mode)
    self._lease_order: List[int] = []  # delivered, not released, FIFO
    if self._reuse:
      make_buffers = getattr(parse_fn, 'make_image_buffers', None)
      if make_buffers is None:
        raise ValueError('reuse_buffers=True needs a parse_fn with '
                         'make_image_buffers')
      self._slots = [make_buffers(self._batch_size)
                     for _ in range(self._ring_depth)]
      for i in range(self._ring_depth):
        self._free_slots.put(i)
    self._threads = [threading.Thread(target=self._issue_tickets,
                                      daemon=True, name='t2r-engine-tickets')]
    for i in range(self._num_workers):
      self._threads.append(threading.Thread(
          target=self._worker, daemon=True, name=f't2r-engine-worker-{i}'))
    for t in self._threads:
      t.start()

  @property
  def num_workers(self) -> int:
    return self._num_workers

  @property
  def reuse_buffers(self) -> bool:
    return not self._serial and self._reuse

  # ------------------------------------------------------------- threads

  def _issue_tickets(self) -> None:
    """Slices the record stream into numbered tickets. A stream error
    takes the seq at which the serial path would have raised it."""
    seq = 0
    try:
      pending: List[bytes] = []
      for record in self._records:
        pending.append(record)
        if len(pending) < self._batch_size:
          continue
        while not self._sem.acquire(timeout=0.1):
          if self._stop.is_set():
            return
        if self._stop.is_set():
          return
        self._ticket_q.put((seq, pending))
        seq += 1
        pending = []
    except BaseException as e:  # pylint: disable=broad-except
      with self._cond:
        self._results[seq] = _Failure(e)
        self._end_seq = seq + 1
        self._cond.notify_all()
    else:
      with self._cond:
        self._end_seq = seq
        self._cond.notify_all()
    finally:
      self._ticket_q.put(self._DONE)

  def _worker(self) -> None:
    while True:
      item = self._ticket_q.get()
      if item is self._DONE:
        self._ticket_q.put(self._DONE)  # for the sibling workers
        return
      if self._stop.is_set():
        return
      seq, records = item
      slot = self._free_slots.get() if self._reuse else None
      try:
        if slot is None:
          batch = self._parse_fn(records)
        else:
          batch = self._parse_fn(records, image_out=self._slots[slot])
      except BaseException as e:  # pylint: disable=broad-except
        if slot is not None:
          self._free_slots.put(slot)
          slot = None
        batch = _Failure(e)
      with self._cond:
        self._results[seq] = batch
        if slot is not None:
          self._slot_of[seq] = slot
        self._cond.notify_all()

  # ------------------------------------------------------------ consumer

  def __iter__(self) -> Iterator[Any]:
    return self

  def __next__(self) -> Any:
    if self._serial:
      return self._serial_next()
    if self._reuse:
      # A full ring waits for a release from another thread; a ring that
      # nobody releases fails loudly instead of deadlocking.
      deadline = time.monotonic() + self._lease_timeout
      with self._lease_cond:
        while len(self._lease_order) >= self._ring_depth:
          remaining = deadline - time.monotonic()
          if remaining <= 0:
            raise RuntimeError(
                f'all {self._ring_depth} ring slots are leased (no '
                f'release() for {self._lease_timeout:.1f}s); call release() '
                'once per consumed batch before asking for the next one')
          self._lease_cond.wait(timeout=remaining)
    with self._cond:
      while (self._next_seq not in self._results and
             (self._end_seq is None or self._next_seq < self._end_seq)):
        self._cond.wait()
      if self._next_seq not in self._results:
        raise StopIteration
      seq = self._next_seq
      self._next_seq += 1
      result = self._results.pop(seq)
      slot = self._slot_of.pop(seq, None)
    if isinstance(result, _Failure):
      self.close()
      raise result.exc
    if slot is not None:
      with self._lease_cond:
        self._lease_order.append(slot)  # the permit stays with the slot
    else:
      self._sem.release()
    self.delivered += 1
    return result

  def _serial_next(self) -> Any:
    pending: List[bytes] = []
    for record in self._records:
      pending.append(record)
      if len(pending) >= self._batch_size:
        batch = self._parse_fn(pending)
        self.delivered += 1
        return batch
    raise StopIteration  # final short batch dropped

  def release(self) -> None:
    """Ring mode: declares the OLDEST leased batch's arrays dead; its slot
    goes back to the workers and will be overwritten. Call once per
    consumed batch, after its contents were copied. A no-op without
    ring buffers. Thread-safe."""
    if self._serial or not self._reuse:
      return
    with self._lease_cond:
      if not self._lease_order:
        return
      slot = self._lease_order.pop(0)
      self._lease_cond.notify_all()
    self._free_slots.put(slot)
    self._sem.release()

  # ------------------------------------------------------------ lifecycle

  def close(self, timeout: float = 5.0) -> None:
    """Stops the pipeline threads (idempotent)."""
    if self._serial or self._closed:
      self._closed = True
      return
    self._closed = True
    self._stop.set()
    with self._cond:
      if self._end_seq is None:
        self._end_seq = self._next_seq
      self._cond.notify_all()
    for _ in range(self._num_workers):
      self._ticket_q.put(self._DONE)
    if self._reuse:
      for _ in range(self._num_workers):
        self._free_slots.put(0)
    deadline = time.monotonic() + timeout
    for t in self._threads:
      t.join(max(0.0, deadline - time.monotonic()))
      if t.is_alive():
        logging.warning('Engine thread %s did not exit within %.1fs; '
                        'abandoning the daemon thread.', t.name, timeout)

  def __enter__(self) -> 'ParallelBatchEngine':
    return self

  def __exit__(self, *exc) -> None:
    self.close()

  def __del__(self):
    try:
      self.close(timeout=0.1)
    except Exception:  # pylint: disable=broad-except  # interpreter shutdown
      pass
