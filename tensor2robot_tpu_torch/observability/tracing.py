"""Host-side span tracing and cross-process request tracing (the port's
counterpart of ``tensor2robot_tpu/observability/tracing.py``).

``with span('data/decode'):``

1. accumulates the span's wall time into the metrics registry (histogram
   ``'<name>_ms'``);
2. mirrors a span of at least ``flight.span_feed_min_ms`` into the flight
   ring;
3. while a capture is active (:func:`start_capture` / :func:`capture`),
   appends a Chrome-trace ``X`` event to a bounded buffer, written by
   :func:`dump_chrome_trace` (``chrome://tracing``, Perfetto,
   ``tools/trace_summary.py``);
4. while a ``torch.profiler`` session records, enters a
   ``torch.profiler.record_function`` under the span's name, so the host
   span lies on the profiler's timeline beside the CUDA kernels. Outside
   a session no ``RecordFunction`` is built: the probe is one call.

:func:`step_annotation` marks one dispatch the same way.

**Cross-process request tracing.** A request entering the fleet carries a
W3C ``traceparent`` context: a 32-hex trace id shared by every hop and the
16-hex span id of the hop that forwarded it (:class:`TraceContext`,
:func:`parse_traceparent` / :func:`format_traceparent`). Each process
records its finished spans (the balancer's proxy and attempts, the
server's ingress, the batcher's request, queued and dispatch spans) into a
bounded process-global :class:`SpanIndex`, served at ``GET /tracez``;
``tools/assemble_trace.py`` merges every process's spans of one trace into
one timeline. An untraced request records nothing.
"""

from __future__ import annotations

import binascii
import contextlib
import gzip
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Sequence

import torch

from tensor2robot_tpu_torch.observability import flight, metrics

__all__ = [
    'span', 'step_annotation', 'start_capture', 'stop_capture', 'capture',
    'capturing', 'chrome_trace', 'dump_chrome_trace',
    'TraceContext', 'parse_traceparent', 'format_traceparent',
    'mint_trace_id', 'mint_span_id', 'SpanIndex', 'span_index',
    'record_span', 'record_spans', 'spans', 'set_service', 'service',
    'tracez_document', 'TRACEPARENT_HEADER',
]

# perf_counter origin of the Chrome-trace timestamps (microseconds).
_EPOCH = time.perf_counter()

_lock = threading.Lock()
_events: Optional[List[dict]] = None  # None = capture off  # GUARDED_BY(_lock)
_events_cap = 0  # GUARDED_BY(_lock)
_dropped = 0  # GUARDED_BY(_lock)


def profiler_recording() -> bool:
  """Whether a ``torch.profiler`` (or autograd profiler) session is
  recording in this process."""
  return torch.autograd._profiler_enabled()  # pylint: disable=protected-access


class span:  # noqa: N801 - context manager used as a function
  """Times a host-side region under ``name`` (slash-scoped).

  A slotted class rather than a generator context manager, since it sits
  in per-dispatch hot paths. ``annotate=False`` skips the profiler
  annotation even while a session records.
  """

  __slots__ = ('_name', '_annotate', '_ann', '_t0')

  def __init__(self, name: str, annotate: bool = True):
    self._name = name
    self._annotate = annotate
    self._ann = None
    self._t0 = 0.0

  def __enter__(self) -> 'span':
    if self._annotate and profiler_recording():
      self._ann = torch.profiler.record_function(self._name)
      self._ann.__enter__()
    self._t0 = time.perf_counter()
    return self

  def __exit__(self, *exc) -> bool:
    t1 = time.perf_counter()
    if self._ann is not None:
      self._ann.__exit__(None, None, None)
      self._ann = None
    metrics.histogram(self._name + '_ms').observe((t1 - self._t0) * 1e3)
    flight.note_span(self._name, self._t0, t1)
    # ANALYSIS_OK(lock-discipline): racy fast-path probe;
    # _record_event re-checks under the lock.
    if _events is not None:
      _record_event(self._name, self._t0, t1)
    return False


def _record_event(name: str, t0: float, t1: float) -> None:
  global _dropped
  event = {'name': name, 'ph': 'X', 'ts': (t0 - _EPOCH) * 1e6,
           'dur': (t1 - t0) * 1e6, 'pid': os.getpid(),
           'tid': threading.get_ident()}
  with _lock:
    if _events is None:
      return
    dropped_now = len(_events) >= _events_cap
    if dropped_now:
      _dropped += 1
    else:
      _events.append(event)
  if dropped_now:
    metrics.counter('tracing/dropped_events').inc()


def start_capture(max_events: int = 200_000) -> None:
  """Begins buffering span events (bounded; overflow counts as dropped)."""
  global _events, _events_cap, _dropped
  with _lock:
    _events = []
    _events_cap = int(max_events)
    _dropped = 0


def stop_capture() -> List[dict]:
  """Stops buffering and returns the captured events."""
  global _events
  with _lock:
    events = _events or []
    _events = None
  return events


def capturing() -> bool:
  # ANALYSIS_OK(lock-discipline): advisory single-read probe.
  return _events is not None


@contextlib.contextmanager
def capture(max_events: int = 200_000) -> Iterator[List[dict]]:
  """``with capture() as events:``, ``events`` filled on exit."""
  start_capture(max_events)
  events: List[dict] = []
  try:
    yield events
  finally:
    events.extend(stop_capture())


def chrome_trace(events: Optional[List[dict]] = None) -> Dict[str, object]:
  """Wraps events as a Chrome-trace JSON object."""
  with _lock:
    if events is None:
      events = list(_events) if _events is not None else []
    dropped = _dropped
  return {
      'traceEvents': events,
      'displayTimeUnit': 'ms',
      'metadata': {
          'producer': 'tensor2robot_tpu_torch.observability.tracing',
          'dropped_events': dropped,
      },
  }


def dump_chrome_trace(path: str,
                      events: Optional[List[dict]] = None) -> str:
  """Writes a Chrome-trace JSON to ``path`` (gzipped for a ``.gz``
  suffix)."""
  trace = chrome_trace(events)
  dirname = os.path.dirname(path)
  if dirname:
    os.makedirs(dirname, exist_ok=True)
  opener = gzip.open if path.endswith('.gz') else open
  with opener(path, 'wt') as f:
    json.dump(trace, f)
  return path


def step_annotation(step: int, name: str = 'train'):
  """A ``record_function('<name>#<step>')`` marking one dispatch while a
  ``torch.profiler`` session records, else a null context."""
  if profiler_recording():
    return torch.profiler.record_function(f'{name}#{int(step)}')
  return contextlib.nullcontext()


# --------------------------------------------------- cross-process tracing


TRACEPARENT_HEADER = 'traceparent'

_TRACEPARENT_VERSION = '00'


class TraceContext(NamedTuple):
  """One hop's trace coordinates: the fleet-wide trace id and the span id
  of the hop that forwarded the request (the next span's parent)."""

  trace_id: str
  span_id: str

  def child(self) -> 'TraceContext':
    """A fresh context under the same trace (for the next hop)."""
    return TraceContext(self.trace_id, mint_span_id())


def mint_trace_id() -> str:
  return binascii.hexlify(os.urandom(16)).decode()


def mint_span_id() -> str:
  return binascii.hexlify(os.urandom(8)).decode()


def format_traceparent(ctx: TraceContext) -> str:
  """``00-<trace_id>-<span_id>-01`` (always sampled)."""
  return f'{_TRACEPARENT_VERSION}-{ctx.trace_id}-{ctx.span_id}-01'


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
  """A :class:`TraceContext` from a ``traceparent`` header, or None for a
  missing or malformed one (never an error: a bad client header must not
  fail the request). Any version with the same field layout parses."""
  if not header:
    return None
  parts = header.strip().split('-')
  if len(parts) < 3:
    return None
  trace_id, span_id = parts[1], parts[2]
  if len(trace_id) != 32 or len(span_id) != 16:
    return None
  try:
    int(trace_id, 16), int(span_id, 16)
  except ValueError:
    return None
  if trace_id == '0' * 32 or span_id == '0' * 16:
    return None
  return TraceContext(trace_id, span_id)


class SpanIndex:
  """Bounded ring of finished spans, queryable by trace or request id
  (the last N kept, as in the flight ring). A span is a JSON-ready dict:
  ``trace_id / span_id / parent_id / name / kind / start / end /
  request_id / detail / service``, with wall-clock ``start`` and ``end``.
  """

  def __init__(self, capacity: int = 4096):
    if capacity < 1:
      raise ValueError(f'capacity must be >= 1, got {capacity}')
    self._capacity = int(capacity)
    self._lock = threading.Lock()
    self._slots: List[Optional[dict]] = [None] * self._capacity  # GUARDED_BY(self._lock)
    self._next = 0  # GUARDED_BY(self._lock)
    self._recorded = 0  # GUARDED_BY(self._lock)

  @property
  def capacity(self) -> int:
    return self._capacity

  @property
  def recorded(self) -> int:
    with self._lock:
      return self._recorded

  def record(self, span_dict: dict) -> None:
    self.record_many([span_dict])

  def record_many(self, span_dicts: Sequence[dict]) -> None:
    """Records a dispatch's spans under one lock."""
    if not span_dicts:
      return
    with self._lock:
      for span_dict in span_dicts:
        self._slots[self._next] = span_dict
        self._next = (self._next + 1) % self._capacity
      self._recorded += len(span_dicts)

  def spans(self, trace_id: Optional[str] = None,
            request_id: Optional[str] = None,
            last_secs: Optional[float] = None) -> List[dict]:
    """Matching spans oldest to newest (copies)."""
    with self._lock:
      if self._recorded >= self._capacity:
        raw = self._slots[self._next:] + self._slots[:self._next]
      else:
        raw = self._slots[:self._next]
    cutoff = None if last_secs is None else time.time() - last_secs
    out = []
    for entry in raw:
      if entry is None:
        continue
      if trace_id is not None and entry.get('trace_id') != trace_id:
        continue
      if request_id is not None and entry.get('request_id') != request_id:
        continue
      if cutoff is not None and entry.get('end', 0.0) < cutoff:
        continue
      out.append(dict(entry))
    return out

  def clear(self) -> None:
    with self._lock:
      self._slots = [None] * self._capacity
      self._next = 0
      self._recorded = 0


_SPAN_INDEX = SpanIndex()

# This process's label in assembled timelines ('balancer-9000',
# 'replica-8001', ...).
_service = f'pid-{os.getpid()}'

_SPANS_COUNTER = metrics.counter('tracing/spans')


def span_index() -> SpanIndex:
  return _SPAN_INDEX


def set_service(name: str) -> None:
  """Labels this process's spans in assembled fleet timelines."""
  global _service
  _service = str(name)


def service() -> str:
  return _service


def record_span(name: str,
                kind: str,
                trace_id: str,
                span_id: str,
                parent_id: str,
                start: float,
                end: float,
                request_id: str = '',
                detail: str = '',
                service_label: Optional[str] = None) -> None:
  """Records one finished span into the process-global index."""
  _SPAN_INDEX.record({
      'trace_id': trace_id, 'span_id': span_id, 'parent_id': parent_id,
      'name': name, 'kind': kind, 'start': start, 'end': end,
      'request_id': request_id, 'detail': detail,
      'service': service_label if service_label is not None else _service,
  })
  _SPANS_COUNTER.inc()


def record_spans(span_dicts: Sequence[dict],
                 service_label: Optional[str] = None) -> None:
  """Batched :func:`record_span` (one ring lock); each dict carries the
  span fields, ``service`` filled where absent."""
  if not span_dicts:
    return
  label = service_label if service_label is not None else _service
  for span_dict in span_dicts:
    span_dict.setdefault('service', label)
  _SPAN_INDEX.record_many(span_dicts)
  _SPANS_COUNTER.inc(len(span_dicts))


def spans(trace_id: Optional[str] = None,
          request_id: Optional[str] = None,
          last_secs: Optional[float] = None) -> List[dict]:
  return _SPAN_INDEX.spans(trace_id=trace_id, request_id=request_id,
                           last_secs=last_secs)


def tracez_document(trace_id: Optional[str] = None,
                    request_id: Optional[str] = None,
                    probe_only: bool = False) -> Dict[str, Any]:
  """The ``GET /tracez`` reply: the service label, pid and wall clock
  (``now``, which ``tools/assemble_trace.py``'s clock-offset probe reads),
  and the matching spans unless ``probe_only``."""
  doc: Dict[str, Any] = {'kind': 'tracez', 'service': _service,
                         'pid': os.getpid(), 'now': time.time()}
  if not probe_only:
    doc['spans'] = _SPAN_INDEX.spans(trace_id=trace_id,
                                     request_id=request_id)
  return doc
