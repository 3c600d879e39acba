"""Flight recorder: a bounded ring of structured events (the port's
counterpart of ``tensor2robot_tpu/observability/flight.py``). Pure stdlib.

The ring holds the last N events of the process (coarse span exits,
hot swaps, router page and shed decisions, balancer ejections, SLO and
anomaly transitions, sampled request lifecycles), so a postmortem bundle
(``observability/postmortem.py``) can say what the process did in the
seconds before an incident. Its memory is bounded by construction: the
slot list is allocated once and overwritten in place, and a detail string
is cut to :data:`MAX_DETAIL_CHARS` when it is recorded.

An event is ``(time.time(), kind, name, detail)``: ``kind`` a coarse
subsystem tag (``'span' | 'swap' | 'request' | 'router' | 'balancer' |
'slo' | 'anomaly' | 'error' | ...``), ``name`` slash-scoped like a
metric, ``detail`` a short ``k=v`` string (``tools/postmortem.py`` parses
its ``dur_ms=`` and ``id=`` tokens). :func:`event` costs one enabled
check, one tuple and one locked slot store; :func:`events_many` records a
whole dispatch's events under one lock.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

from tensor2robot_tpu_torch.observability import metrics as metrics_lib

__all__ = [
    'FlightRecorder', 'recorder', 'event', 'events', 'events_many',
    'set_enabled', 'enabled', 'set_span_feed_min_ms', 'span_feed_min_ms',
    'note_span', 'MAX_DETAIL_CHARS', 'DEFAULT_CAPACITY',
]

DEFAULT_CAPACITY = 4096
MAX_DETAIL_CHARS = 256

# tracing.span exits at or above this many ms are mirrored into the ring;
# None disables the feed.
DEFAULT_SPAN_FEED_MIN_MS = 5.0


def _clip(detail: str) -> str:
  if len(detail) > MAX_DETAIL_CHARS:
    return detail[:MAX_DETAIL_CHARS - 1] + '…'
  return detail


class FlightRecorder:
  """Fixed-size, thread-safe ring of ``(time, kind, name, detail)``."""

  def __init__(self, capacity: int = DEFAULT_CAPACITY):
    if capacity < 1:
      raise ValueError(f'capacity must be >= 1, got {capacity}')
    self._capacity = int(capacity)
    self._lock = threading.Lock()
    self._slots: List[Optional[tuple]] = [None] * self._capacity  # GUARDED_BY(self._lock)
    self._next = 0  # GUARDED_BY(self._lock)
    self._recorded = 0  # GUARDED_BY(self._lock)

  @property
  def capacity(self) -> int:
    return self._capacity

  @property
  def recorded(self) -> int:
    """Events ever recorded (at or above capacity, overwrites began)."""
    with self._lock:
      return self._recorded

  def record(self, kind: str, name: str, detail: str = '',
             t: Optional[float] = None) -> None:
    """Stores one event, overwriting the oldest once the ring is full."""
    entry = (time.time() if t is None else t, kind, name, _clip(detail))
    with self._lock:
      self._slots[self._next] = entry
      self._next = (self._next + 1) % self._capacity
      self._recorded += 1

  def record_many(self, entries: Sequence[tuple]) -> None:
    """Stores ``(kind, name, detail[, t])`` tuples under one lock; entries
    without a time share *now*."""
    if not entries:
      return
    now = time.time()
    prepared = [(entry[3] if len(entry) > 3 else now, entry[0], entry[1],
                 _clip(entry[2])) for entry in entries]
    with self._lock:
      for entry in prepared:
        self._slots[self._next] = entry
        self._next = (self._next + 1) % self._capacity
      self._recorded += len(prepared)

  def events(self, last_secs: Optional[float] = None,
             kinds: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    """Events oldest to newest as JSON-ready dicts, optionally the last
    ``last_secs`` seconds and only ``kinds``."""
    with self._lock:
      if self._recorded >= self._capacity:
        raw = self._slots[self._next:] + self._slots[:self._next]
      else:
        raw = self._slots[:self._next]
    cutoff = None if last_secs is None else time.time() - last_secs
    out = []
    for entry in raw:
      if entry is None or (cutoff is not None and entry[0] < cutoff):
        continue
      t, kind, name, detail = entry
      if kinds is not None and kind not in kinds:
        continue
      out.append({'time': t, 'kind': kind, 'name': name, 'detail': detail})
    return out

  def clear(self) -> None:
    with self._lock:
      self._slots = [None] * self._capacity
      self._next = 0
      self._recorded = 0


_RECORDER = FlightRecorder()

# Plain module-global switches: a racing reader sees the old or the new
# value, both valid.
_enabled = True
_span_feed_min_ms: Optional[float] = DEFAULT_SPAN_FEED_MIN_MS

_EVENTS_COUNTER = metrics_lib.counter('flight/events')


def recorder() -> FlightRecorder:
  return _RECORDER


def set_enabled(on: bool) -> None:
  """Master switch; disabled, ``event()`` costs one global read."""
  global _enabled
  _enabled = bool(on)


def enabled() -> bool:
  return _enabled


def event(kind: str, name: str, detail: str = '') -> None:
  """Records one event into the process-global ring."""
  if not _enabled:
    return
  _RECORDER.record(kind, name, detail)
  _EVENTS_COUNTER.inc()


def events_many(entries: Sequence[tuple]) -> None:
  """Batched :func:`event`: ``(kind, name, detail[, t])`` tuples, one
  lock."""
  if not _enabled or not entries:
    return
  _RECORDER.record_many(entries)
  _EVENTS_COUNTER.inc(len(entries))


def set_span_feed_min_ms(min_ms: Optional[float]) -> None:
  """Spans at or above ``min_ms`` mirror into the ring; None disables."""
  global _span_feed_min_ms
  _span_feed_min_ms = None if min_ms is None else float(min_ms)


def span_feed_min_ms() -> Optional[float]:
  return _span_feed_min_ms


def note_span(name: str, t0: float, t1: float) -> None:
  """The ``tracing.span`` exit hook (``perf_counter`` endpoints): filtered
  on duration before any lock."""
  if not _enabled or _span_feed_min_ms is None:
    return
  dur_ms = (t1 - t0) * 1e3
  if dur_ms < _span_feed_min_ms:
    return
  _RECORDER.record('span', name, f'dur_ms={dur_ms:.3f}')
  _EVENTS_COUNTER.inc()


def events(last_secs: Optional[float] = None,
           kinds: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
  """Events of the process-global ring, oldest to newest."""
  return _RECORDER.events(last_secs=last_secs, kinds=kinds)
