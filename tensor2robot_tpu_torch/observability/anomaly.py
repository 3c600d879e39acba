"""Anomaly watch: robust detectors over the metrics time-series ring (the
port's counterpart of ``tensor2robot_tpu/observability/anomaly.py``, with
the same detectors, specs and report). Pure stdlib.

A daemon watches selected series (request p99, queue depth, shed rate,
page-in time) and flags samples a robust baseline says do not belong.
Detection is median/MAD: a new value is anomalous when ``|v - median| >
k * scale`` with ``scale = max(1.4826 * MAD, rel_floor * |median|,
min_scale)``; the floors keep a near-constant series from flagging noise.
Anomalous values stay out of the baseline, so a sustained regression
keeps flagging, until ``rebaseline_after`` consecutive ones make the new
level the baseline (a regime change).

Each anomaly records a flight event (kind ``'anomaly'``), counts
``anomaly/flagged`` and, with ``postmortem_dir``, writes one rate-limited
live postmortem bundle.

Series specs are ``'<metric>[:<stat>]'``: a gauge's value; a counter's
``:rate`` between consecutive samples; a histogram's ``:p99`` / ``:p50`` /
``:mean`` / ``:rate`` over the window between consecutive samples (bucket
count deltas), not the lifetime distribution.
"""

from __future__ import annotations

import collections
import logging
import statistics
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from tensor2robot_tpu_torch.observability import flight
from tensor2robot_tpu_torch.observability import metrics as metrics_lib
from tensor2robot_tpu_torch.observability import timeseries

__all__ = [
    'RobustDetector', 'AnomalyWatch', 'parse_spec', 'series_value',
    'DEFAULT_SERVING_SPECS', 'DEFAULT_TRAINER_SPECS',
]

# MAD → stddev-equivalent scale for normal data.
_MAD_SCALE = 1.4826

DEFAULT_SERVING_SPECS: Tuple[str, ...] = (
    'serving/request_latency_ms:p99',
    'serving/queue_depth',
    'serving/shed_requests:rate',
    'serving/page_in_ms:p99',
)

DEFAULT_TRAINER_SPECS: Tuple[str, ...] = (
    'trainer/examples_per_sec',
    'trainer/breakdown/host_wait_ms',
)


def parse_spec(spec: str) -> Tuple[str, str]:
  """``'name[:stat]'`` → (metric name, stat); default stat ``value``."""
  name, sep, stat = spec.rpartition(':')
  if not sep:
    return spec, 'value'
  stat = stat.strip().lower()
  if stat not in ('value', 'rate', 'p50', 'p99', 'mean'):
    raise ValueError(f'unknown stat {stat!r} in spec {spec!r}')
  return name, stat


def _windowed_histogram(prev: Dict[str, Any], cur: Dict[str, Any],
                        stat: str, dt: float) -> Optional[float]:
  """A stat over the observations BETWEEN two histogram snapshots."""
  dcount = cur.get('count', 0) - prev.get('count', 0)
  if stat == 'rate':
    return dcount / dt if dt > 0 else None
  if dcount <= 0:
    return None
  if stat == 'mean':
    return (cur.get('sum', 0.0) - prev.get('sum', 0.0)) / dcount
  fraction = {'p50': 0.50, 'p99': 0.99}[stat]
  prev_buckets = prev.get('buckets') or {}
  deltas = []
  for exponent_str, count in (cur.get('buckets') or {}).items():
    delta = count - prev_buckets.get(exponent_str, 0)
    if delta > 0:
      deltas.append((int(exponent_str), delta))
  if not deltas:
    return None
  deltas.sort()
  target = fraction * sum(d for _, d in deltas)
  seen = 0
  for exponent, delta in deltas:
    seen += delta
    if seen >= target:
      return metrics_lib.Histogram.bucket_upper(exponent)
  return metrics_lib.Histogram.bucket_upper(deltas[-1][0])


def series_value(spec: Tuple[str, str],
                 prev_sample: Tuple[float, Dict[str, Any]],
                 cur_sample: Tuple[float, Dict[str, Any]]
                 ) -> Optional[float]:
  """The series value at ``cur_sample`` (None = no data this window)."""
  metric_name, stat = spec
  t0, prev_metrics = prev_sample
  t1, cur_metrics = cur_sample
  cur = cur_metrics.get(metric_name)
  if cur is None:
    return None
  if isinstance(cur, dict):
    prev = prev_metrics.get(metric_name)
    prev = prev if isinstance(prev, dict) else {}
    return _windowed_histogram(prev, cur, stat if stat != 'value' else 'p99',
                               max(t1 - t0, 1e-9))
  if isinstance(cur, bool):
    return None
  if stat == 'rate':
    prev = prev_metrics.get(metric_name)
    prev = prev if isinstance(prev, (int, float)) else 0
    return (float(cur) - float(prev)) / max(t1 - t0, 1e-9)
  return float(cur)


class RobustDetector:
  """Median/MAD outlier detector over one value series.

  Not thread-safe on its own; the owning :class:`AnomalyWatch` calls it
  from one place.
  """

  def __init__(self,
               k: float = 6.0,
               min_history: int = 6,
               window: int = 64,
               rel_floor: float = 0.10,
               min_scale: float = 1e-9,
               rebaseline_after: int = 5):
    if k <= 0:
      raise ValueError(f'k must be > 0, got {k}')
    if min_history < 3:
      raise ValueError(f'min_history must be >= 3, got {min_history}')
    self._k = float(k)
    self._min_history = int(min_history)
    self._values: collections.deque = collections.deque(maxlen=int(window))
    self._rel_floor = float(rel_floor)
    self._min_scale = float(min_scale)
    self._rebaseline_after = max(1, int(rebaseline_after))
    self._quarantine: List[float] = []
    self.anomalies = 0

  @property
  def history(self) -> int:
    return len(self._values)

  def observe(self, value: float) -> Optional[Dict[str, float]]:
    """Feeds one value; returns an anomaly record or None.

    Warmup values (fewer than ``min_history`` accepted samples) build
    the baseline and never flag.
    """
    value = float(value)
    if len(self._values) < self._min_history:
      self._values.append(value)
      return None
    baseline = list(self._values)
    med = statistics.median(baseline)
    mad = statistics.median(abs(v - med) for v in baseline)
    scale = max(_MAD_SCALE * mad, self._rel_floor * abs(med),
                self._min_scale)
    deviation = abs(value - med)
    if deviation <= self._k * scale:
      self._values.append(value)
      self._quarantine = []
      return None
    # Anomalous: keep it OUT of the baseline (a sustained regression
    # must keep flagging) until enough consecutive outliers prove a
    # regime change, at which point the new level becomes the baseline.
    self.anomalies += 1
    self._quarantine.append(value)
    if len(self._quarantine) >= self._rebaseline_after:
      self._values.extend(self._quarantine)
      self._quarantine = []
    return {
        'value': value,
        'baseline_median': med,
        'deviation': deviation,
        'threshold': self._k * scale,
    }


class AnomalyWatch:
  """Watches time-series specs; flags + escalates anomalies.

  ``recorder=None`` follows the process-global time-series recorder.
  :meth:`poll` consumes samples the watch has not seen yet (safe to
  call manually from tests or a trainer callback); :meth:`start` polls
  on a daemon thread at the recorder's cadence.
  """

  def __init__(self,
               specs: Sequence[str] = DEFAULT_SERVING_SPECS,
               recorder: Optional[timeseries.TimeSeriesRecorder] = None,
               postmortem_dir: Optional[str] = None,
               poll_interval_secs: Optional[float] = None,
               k: float = 6.0,
               min_history: int = 6,
               window: int = 64,
               rel_floor: float = 0.10,
               rebaseline_after: int = 5,
               register_report: bool = True):
    if not specs:
      raise ValueError('AnomalyWatch needs at least one series spec')
    self._specs = [parse_spec(s) for s in specs]
    self._spec_strings = tuple(specs)
    self._recorder = recorder
    self._postmortem_dir = postmortem_dir
    self._poll_interval = poll_interval_secs
    self._register_report = bool(register_report)
    self._lock = threading.Lock()
    self._detectors: Dict[str, RobustDetector] = {  # GUARDED_BY(self._lock)
        spec: RobustDetector(k=k, min_history=min_history, window=window,
                             rel_floor=rel_floor,
                             rebaseline_after=rebaseline_after)
        for spec in self._spec_strings
    }
    self._last_sample_time = 0.0  # GUARDED_BY(self._lock)
    self._prev_sample: Optional[tuple] = None  # GUARDED_BY(self._lock)
    self._recent: collections.deque = collections.deque(maxlen=32)  # GUARDED_BY(self._lock)
    self._stop = threading.Event()
    self._thread: Optional[threading.Thread] = None
    self._m_flagged = metrics_lib.counter('anomaly/flagged')
    self._m_polls = metrics_lib.counter('anomaly/polls')

  # -------------------------------------------------------------- detection

  def poll(self) -> List[Dict[str, Any]]:
    """Processes unseen time-series samples; returns new anomalies."""
    recorder = self._recorder or timeseries.global_recorder()
    if recorder is None:
      return []
    samples = [(s['time'], s['metrics'])
               for s in recorder.history().get('samples', [])]
    self._m_polls.inc()
    anomalies: List[Dict[str, Any]] = []
    with self._lock:
      fresh = [s for s in samples if s[0] > self._last_sample_time]
      for sample in fresh:
        prev = self._prev_sample
        self._prev_sample = sample
        self._last_sample_time = sample[0]
        if prev is None:
          continue
        for spec_string, spec in zip(self._spec_strings, self._specs):
          value = series_value(spec, prev, sample)
          if value is None:
            continue
          record = self._detectors[spec_string].observe(value)
          if record is not None:
            record = dict(record, series=spec_string, time=sample[0])
            self._recent.append(record)
            anomalies.append(record)
    for record in anomalies:
      self._escalate(record)
    return anomalies

  def _escalate(self, record: Dict[str, Any]) -> None:
    self._m_flagged.inc()
    series = record['series']
    detail = (f"value={record['value']:.4g} "
              f"median={record['baseline_median']:.4g} "
              f"threshold={record['threshold']:.4g}")
    flight.event('anomaly', f'anomaly/{series}', detail)
    logging.warning('Anomaly on %s: %s', series, detail)
    if self._postmortem_dir:
      from tensor2robot_tpu_torch.observability import postmortem

      # Reason keyed per series: concurrent incidents on different
      # signals each get a bundle; a persisting one coalesces under the
      # shared (dir, reason) rate limit.
      reason = 'anomaly_' + series.replace('/', '_').replace(':', '_')
      postmortem.dump(self._postmortem_dir, reason, live=True,
                      extra={'anomaly': record})

  # -------------------------------------------------------------- lifecycle

  def start(self) -> 'AnomalyWatch':
    if self._thread is not None:
      return self
    interval = self._poll_interval
    if interval is None:
      recorder = self._recorder or timeseries.global_recorder()
      interval = recorder.interval_secs if recorder is not None else 10.0
    self._stop.clear()

    def run():
      while not self._stop.wait(interval):
        try:
          self.poll()
        except Exception:  # pylint: disable=broad-except
          logging.exception('Anomaly poll failed (non-fatal).')

    self._thread = threading.Thread(target=run, daemon=True,
                                    name='t2r-anomaly')
    self._thread.start()
    if self._register_report:
      metrics_lib.register_report_provider('anomaly', self.report)
    return self

  def stop(self) -> None:
    self._stop.set()
    if self._thread is not None:
      self._thread.join(timeout=10.0)
      self._thread = None
      if self._register_report:
        metrics_lib.unregister_report_provider('anomaly')

  def __enter__(self) -> 'AnomalyWatch':
    return self.start()

  def __exit__(self, *exc) -> None:
    self.stop()

  # -------------------------------------------------------------- reporting

  def report(self) -> Dict[str, Any]:
    """The ``anomaly`` section of ``/metricsz``."""
    with self._lock:
      detectors = {
          spec: {'history': det.history, 'anomalies': det.anomalies}
          for spec, det in self._detectors.items()
      }
      recent = list(self._recent)
    return {
        'series': detectors,
        'recent': recent,
        'flagged': metrics_lib.counter('anomaly/flagged').value,
    }
