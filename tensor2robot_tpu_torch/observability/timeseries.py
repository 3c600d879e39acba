"""Metrics history: periodic registry snapshots in a bounded ring (the
port's counterpart of ``tensor2robot_tpu/observability/timeseries.py``).
Pure stdlib.

A daemon thread snapshots the whole registry every ``interval_secs``
into a fixed-size slot ring, so ``GET /metricsz?history=1``, a postmortem
bundle, the SLO engine and the anomaly watch can see how each metric moved
over the last minutes. The process-wide recorder starts through
:func:`maybe_start` (the serving server's ``timeseries_interval_secs``, or
the ``T2R_TIMESERIES_SECS`` environment variable).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional

from tensor2robot_tpu_torch.observability import metrics as metrics_lib

__all__ = [
    'TimeSeriesRecorder', 'maybe_start', 'global_recorder', 'stop_global',
    'history', 'ENV_VAR', 'DEFAULT_CAPACITY',
]

ENV_VAR = 'T2R_TIMESERIES_SECS'

# 120 slots at the 10 s default cadence: the last 20 minutes.
DEFAULT_CAPACITY = 120


class TimeSeriesRecorder:
  """Samples ``metrics.snapshot()`` into a fixed-size slot ring."""

  def __init__(self, interval_secs: float = 10.0,
               capacity: int = DEFAULT_CAPACITY):
    if interval_secs <= 0:
      raise ValueError(f'interval_secs must be > 0, got {interval_secs}')
    if capacity < 1:
      raise ValueError(f'capacity must be >= 1, got {capacity}')
    self.interval_secs = float(interval_secs)
    self._capacity = int(capacity)
    self._lock = threading.Lock()
    self._slots: List[Optional[tuple]] = [None] * self._capacity  # GUARDED_BY(self._lock)
    self._next = 0  # GUARDED_BY(self._lock)
    self._recorded = 0  # GUARDED_BY(self._lock)
    self._stop = threading.Event()
    self._thread: Optional[threading.Thread] = None

  @property
  def capacity(self) -> int:
    return self._capacity

  def sample(self) -> None:
    """Takes one snapshot now (the thread's tick; tests call it too)."""
    entry = (time.time(), metrics_lib.snapshot())  # outside the ring lock
    with self._lock:
      self._slots[self._next] = entry
      self._next = (self._next + 1) % self._capacity
      self._recorded += 1

  def history(self, last_secs: Optional[float] = None) -> Dict[str, object]:
    """The window as a JSON-ready document, samples oldest to newest."""
    with self._lock:
      if self._recorded >= self._capacity:
        raw = self._slots[self._next:] + self._slots[:self._next]
      else:
        raw = self._slots[:self._next]
    samples = [e for e in raw if e is not None]
    if last_secs is not None:
      cutoff = time.time() - last_secs
      samples = [e for e in samples if e[0] >= cutoff]
    return {
        'kind': 'metrics_timeseries',
        'interval_secs': self.interval_secs,
        'capacity': self._capacity,
        'samples': [{'time': t, 'metrics': snap} for t, snap in samples],
    }

  def start(self) -> 'TimeSeriesRecorder':
    if self._thread is not None:
      return self
    self._stop.clear()

    def run():
      while not self._stop.wait(self.interval_secs):
        try:
          self.sample()
        except Exception:  # pylint: disable=broad-except
          logging.exception('Time-series sample failed (non-fatal).')

    self._thread = threading.Thread(target=run, daemon=True,
                                    name='t2r-timeseries')
    self._thread.start()
    return self

  def stop(self) -> None:
    self._stop.set()
    if self._thread is not None:
      self._thread.join(timeout=5.0)
      self._thread = None

  def __enter__(self) -> 'TimeSeriesRecorder':
    return self.start()

  def __exit__(self, *exc) -> None:
    self.stop()


_GLOBAL: Optional[TimeSeriesRecorder] = None  # GUARDED_BY(_GLOBAL_LOCK)
_GLOBAL_LOCK = threading.Lock()


def global_recorder() -> Optional[TimeSeriesRecorder]:
  with _GLOBAL_LOCK:
    return _GLOBAL


def maybe_start(interval_secs: Optional[float] = None
                ) -> Optional[TimeSeriesRecorder]:
  """Starts the process-wide recorder if a cadence is configured
  (``interval_secs``, else ``T2R_TIMESERIES_SECS``; None or <= 0 leaves
  history off). First call wins: a later one returns the running recorder
  and logs a differing cadence. Never raises."""
  global _GLOBAL
  if interval_secs is None:
    env = os.environ.get(ENV_VAR, '').strip()
    if not env:
      return None
    try:
      interval_secs = float(env)
    except ValueError:
      logging.warning('Ignoring non-numeric %s=%r', ENV_VAR, env)
      return None
  if interval_secs <= 0:
    return None
  with _GLOBAL_LOCK:
    if _GLOBAL is not None:
      if interval_secs != _GLOBAL.interval_secs:
        logging.warning(
            'Metrics time-series already sampling every %.1fs; ignoring '
            'request for %.1fs.', _GLOBAL.interval_secs, interval_secs)
      return _GLOBAL
    _GLOBAL = TimeSeriesRecorder(interval_secs=interval_secs).start()
    return _GLOBAL


def stop_global() -> None:
  """Stops the process-wide recorder (tests, orderly shutdown)."""
  global _GLOBAL
  with _GLOBAL_LOCK:
    if _GLOBAL is not None:
      _GLOBAL.stop()
      _GLOBAL = None


def history(last_secs: Optional[float] = None) -> Dict[str, object]:
  """The global recorder's window, or an empty document when off."""
  rec = global_recorder()
  if rec is None:
    return {'kind': 'metrics_timeseries', 'interval_secs': None,
            'capacity': 0, 'samples': []}
  return rec.history(last_secs=last_secs)
