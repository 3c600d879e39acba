"""SLO engine: declarative objectives and multi-window burn-rate alerts
(the port's counterpart of ``tensor2robot_tpu/observability/slo.py``,
with the same objectives, windows, gauges and report). Pure stdlib.

Objectives are declared over registry metrics: **availability**, a
good/bad split over counters (the router's per-priority-class ``ok``
against ``shed`` + ``errors``), and **latency threshold**, the share of a
histogram's observations at or under a threshold, from its power-of-two
buckets. The engine evaluates them with the multi-window burn-rate rule
over the metrics time-series ring (``observability/timeseries.py``): for
each (fast, slow, threshold) window pair, the bad fraction over a window
divided by the error budget (1 - objective) is the burn rate, and an
alert fires only when both windows burn past the threshold.

Per-objective gauges (``slo/<name>/burn_fast|burn_slow|alerting|
budget_consumed``) land in ``/metricsz``; :meth:`SLOEngine.report` is the
``slo`` report section and the serving ``/statz``'s ``slo`` entry. An
alert transition records a flight event (kind ``'slo'``) and, with
``postmortem_dir``, one rate-limited live postmortem bundle.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

from tensor2robot_tpu_torch.observability import flight
from tensor2robot_tpu_torch.observability import metrics as metrics_lib
from tensor2robot_tpu_torch.observability import timeseries

__all__ = [
    'Objective', 'BurnWindow', 'SLOEngine', 'DEFAULT_WINDOWS',
    'derive_windows', 'serving_objectives', 'global_engine',
    'set_global_engine',
]


class BurnWindow(NamedTuple):
  """One multi-window alert rule: burn past ``threshold`` over BOTH the
  fast and the slow window → alert (the SRE-workbook pairing)."""

  fast_secs: float
  slow_secs: float
  threshold: float


# The timeseries cadence the classic pairs below were sized for; the
# workbook pairs are really SAMPLE-COUNT pairs ((6, 30) and (30, 120)
# samples), so other cadences scale through :func:`derive_windows`.
DEFAULT_WINDOW_CADENCE_SECS = 10.0

# The workbook's classic pairs, scaled to the 20-minute default ring
# (120 slots x 10 s): a 14.4x burn caught in ~1 min, a 6x burn in ~5.
DEFAULT_WINDOWS: Tuple[BurnWindow, ...] = (
    BurnWindow(60.0, 300.0, 14.4),
    BurnWindow(300.0, 1200.0, 6.0),
)


def derive_windows(interval_secs: float) -> Tuple[BurnWindow, ...]:
  """The classic burn pairs re-derived for a timeseries cadence.

  :data:`DEFAULT_WINDOWS` are sized for the 10 s cadence; at any
  other ``timeseries_interval_secs`` those spans cover the wrong
  number of ring samples (a 1 s cadence would burn a whole classic
  fast window in 60 samples of noise; a 60 s cadence would leave it
  with zero interior samples). Scaling by ``interval / 10`` keeps each
  window covering the same SAMPLE counts — fast windows of 6 and 30
  samples, slow windows of 30 and 120 — with the workbook thresholds
  unchanged (burn rate is cadence-free).
  """
  interval = float(interval_secs)
  if interval <= 0.0:
    raise ValueError(f'interval_secs must be > 0, got {interval_secs!r}')
  scale = interval / DEFAULT_WINDOW_CADENCE_SECS
  return tuple(
      BurnWindow(w.fast_secs * scale, w.slow_secs * scale, w.threshold)
      for w in DEFAULT_WINDOWS)


def _validate_windows(windows: Sequence[BurnWindow],
                      interval_secs: float) -> None:
  """Raises loudly when a window spans fewer than 2 ring samples: such
  a window can never hold two distinct samples, so its burn rate is
  permanently 0.0 and the objective silently never alerts."""
  for window in windows:
    shortest = min(window.fast_secs, window.slow_secs)
    if shortest < 2.0 * interval_secs:
      raise ValueError(
          f'burn window {window} spans {shortest / interval_secs:.2f} '
          f'samples at the {interval_secs}s timeseries cadence; every '
          'window needs >= 2 samples or its burn rate is identically '
          'zero. Derive windows from the cadence (derive_windows) or '
          'lengthen them.')


@dataclasses.dataclass(frozen=True)
class Objective:
  """One declarative SLO over registry metrics.

  Build with :meth:`availability` (good/bad counter names) or
  :meth:`latency` (histogram name + millisecond threshold); the
  ``objective`` is the target good fraction, so the error budget is
  ``1 - objective``.
  """

  name: str
  kind: str                                # 'availability' | 'latency'
  objective: float
  good: Tuple[str, ...] = ()               # availability: ok counters
  bad: Tuple[str, ...] = ()                # availability: shed/error ctrs
  histogram: str = ''                      # latency: histogram metric
  threshold_ms: float = 0.0                # latency: good iff <= this

  def __post_init__(self):
    if not self.name or any(c.isspace() for c in self.name):
      raise ValueError(f'objective name {self.name!r} must be a non-empty '
                       'whitespace-free identifier (it scopes metrics)')
    if not 0.0 < self.objective < 1.0:
      raise ValueError(f'objective must be in (0, 1), got '
                       f'{self.objective!r}')
    if self.kind not in ('availability', 'latency'):
      raise ValueError(f'unknown objective kind {self.kind!r}')

  @classmethod
  def availability(cls, name: str, good: Sequence[str],
                   bad: Sequence[str], objective: float = 0.999
                   ) -> 'Objective':
    return cls(name=name, kind='availability', objective=objective,
               good=tuple(good), bad=tuple(bad))

  @classmethod
  def latency(cls, name: str, histogram: str, threshold_ms: float,
              objective: float = 0.99) -> 'Objective':
    return cls(name=name, kind='latency', objective=objective,
               histogram=histogram, threshold_ms=float(threshold_ms))

  @property
  def error_budget(self) -> float:
    return 1.0 - self.objective


def serving_objectives(prefix: str = 'serving',
                       models: Sequence[str] = (),
                       interactive_objective: float = 0.999,
                       best_effort_objective: float = 0.9,
                       latency_threshold_ms: float = 512.0,
                       latency_objective: float = 0.99
                       ) -> List[Objective]:
  """The serving plane's default objective set.

  Per priority class: interactive availability (errors only — a shed
  interactive request would itself be a bug), best-effort availability
  (sheds + errors against a looser budget: shedding is the admission
  controller working, but a sustained shed storm still burns budget and
  deserves an alert), and an interactive latency threshold. ``models``
  adds a per-model latency objective over each model's own batcher
  scope (``<prefix>/model/<m>/request_latency_ms``).
  """
  objectives = [
      Objective.availability(
          'interactive_availability',
          good=[f'{prefix}/class/interactive/ok'],
          bad=[f'{prefix}/class/interactive/errors'],
          objective=interactive_objective),
      Objective.availability(
          'best_effort_availability',
          good=[f'{prefix}/class/best_effort/ok'],
          bad=[f'{prefix}/class/best_effort/shed',
               f'{prefix}/class/best_effort/errors'],
          objective=best_effort_objective),
      Objective.latency(
          'interactive_latency',
          histogram=f'{prefix}/class/interactive/latency_ms',
          threshold_ms=latency_threshold_ms,
          objective=latency_objective),
  ]
  for model in models:
    objectives.append(Objective.latency(
        f'model_{model}_latency',
        histogram=f'{prefix}/model/{model}/request_latency_ms',
        threshold_ms=latency_threshold_ms,
        objective=latency_objective))
  return objectives


def _counter_total(sample_metrics: Dict[str, Any],
                   names: Sequence[str]) -> float:
  total = 0.0
  for metric_name in names:
    value = sample_metrics.get(metric_name)
    if isinstance(value, (int, float)) and not isinstance(value, bool):
      total += value
  return total


def _latency_counts(sample_metrics: Dict[str, Any], histogram: str,
                    threshold_ms: float) -> Tuple[float, float]:
  """(good, total) observation counts at one time-series sample.

  Good = cumulative count of power-of-two buckets whose upper edge is
  ≤ ``threshold_ms`` (so the good fraction is conservative: a bucket
  straddling the threshold counts as bad — a 2x bucket cannot hide an
  order-of-magnitude regression, which is the resolution SLOs need).
  """
  snap = sample_metrics.get(histogram)
  if not isinstance(snap, dict):
    return 0.0, 0.0
  total = float(snap.get('count', 0))
  good = 0.0
  for exponent_str, count in (snap.get('buckets') or {}).items():
    try:
      upper = metrics_lib.Histogram.bucket_upper(int(exponent_str))
    except (TypeError, ValueError):
      continue
    if upper <= threshold_ms:
      good += count
  return good, total


def _good_bad_at(objective: Objective,
                 sample_metrics: Dict[str, Any]) -> Tuple[float, float]:
  if objective.kind == 'availability':
    return (_counter_total(sample_metrics, objective.good),
            _counter_total(sample_metrics, objective.bad))
  good, total = _latency_counts(sample_metrics, objective.histogram,
                                objective.threshold_ms)
  return good, max(0.0, total - good)


class SLOEngine:
  """Evaluates objectives against the time-series ring; alerts on burn.

  ``recorder=None`` follows the process-global recorder
  (``timeseries.maybe_start``); pass an explicit
  :class:`~tensor2robot_tpu_torch.observability.timeseries.TimeSeriesRecorder`
  to drive evaluation manually (tests, embedders). :meth:`evaluate` is
  safe to call from any thread; :meth:`start` runs it periodically on a
  daemon thread (cadence defaults to the recorder's sampling interval).
  """

  def __init__(self,
               objectives: Sequence[Objective],
               windows: Optional[Sequence[BurnWindow]] = None,
               recorder: Optional[timeseries.TimeSeriesRecorder] = None,
               postmortem_dir: Optional[str] = None,
               eval_interval_secs: Optional[float] = None,
               register_report: bool = True):
    if not objectives:
      raise ValueError('SLOEngine needs at least one objective')
    names = [o.name for o in objectives]
    if len(set(names)) != len(names):
      raise ValueError(f'duplicate objective names in {names}')
    self._objectives = tuple(objectives)
    if windows is None:
      # Derived from the configured timeseries cadence. Explicit windows
      # skip derivation but are still cadence-checked at start().
      source = recorder or timeseries.global_recorder()
      windows = derive_windows(
          source.interval_secs if source is not None
          else DEFAULT_WINDOW_CADENCE_SECS)
    self._windows = tuple(BurnWindow(*w) for w in windows)
    if not self._windows:
      raise ValueError('SLOEngine needs at least one burn window')
    self._recorder = recorder
    self._postmortem_dir = postmortem_dir
    self._eval_interval = eval_interval_secs
    self._register_report = bool(register_report)
    self._lock = threading.Lock()
    self._alerting: Dict[str, bool] = {o.name: False  # GUARDED_BY(self._lock)
                                       for o in self._objectives}
    self._last_status: List[Dict[str, Any]] = []  # GUARDED_BY(self._lock)
    self._evaluations = 0  # GUARDED_BY(self._lock)
    # Budget accounting anchors at engine start: consumed budget is
    # measured from the live registry against these baselines, not the
    # (shorter) ring window.
    self._start_counts: Dict[str, Tuple[float, float]] = {}
    start_snapshot = metrics_lib.snapshot()
    for objective in self._objectives:
      self._start_counts[objective.name] = _good_bad_at(
          objective, start_snapshot)
    self._stop = threading.Event()
    self._thread: Optional[threading.Thread] = None
    self._m_alerts = metrics_lib.counter('slo/alerts')
    self._gauges: Dict[str, Dict[str, metrics_lib.Gauge]] = {}
    for objective in self._objectives:
      name = objective.name
      s = metrics_lib.scope('slo/' + name)
      self._gauges[name] = {
          'burn_fast': s.gauge('burn_fast'),
          'burn_slow': s.gauge('burn_slow'),
          'alerting': s.gauge('alerting'),
          'budget_consumed': s.gauge('budget_consumed'),
      }

  # ------------------------------------------------------------- evaluation

  def _history_samples(self) -> List[Tuple[float, Dict[str, Any]]]:
    recorder = self._recorder or timeseries.global_recorder()
    if recorder is None:
      return []
    doc = recorder.history()
    return [(s['time'], s['metrics']) for s in doc.get('samples', [])]

  @staticmethod
  def _window_pair(samples, now: float, window_secs: float):
    """(old, new) samples spanning ~``window_secs`` ending at ``now``.

    The old edge is the newest sample at or before ``now - window``;
    when the ring does not reach back that far the window degrades to
    the oldest sample available (better an honest shorter window than
    no signal during warmup).
    """
    if len(samples) < 2:
      return None
    newest = samples[-1]
    cutoff = now - window_secs
    old = None
    for sample in samples:
      if sample[0] <= cutoff:
        old = sample
      else:
        break
    if old is None:
      old = samples[0]
    if old[0] >= newest[0]:
      return None
    return old, newest

  def _burn_rate(self, objective: Objective, samples, now: float,
                 window_secs: float) -> float:
    pair = self._window_pair(samples, now, window_secs)
    if pair is None:
      return 0.0
    (_, old_metrics), (_, new_metrics) = pair
    good0, bad0 = _good_bad_at(objective, old_metrics)
    good1, bad1 = _good_bad_at(objective, new_metrics)
    dgood = max(0.0, good1 - good0)
    dbad = max(0.0, bad1 - bad0)
    total = dgood + dbad
    if total <= 0.0:
      return 0.0
    return (dbad / total) / objective.error_budget

  def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
    """One evaluation pass; returns per-objective status documents.

    Publishes gauges, and on an alert TRANSITION (not while it holds)
    emits a flight event plus — with ``postmortem_dir`` — one
    rate-limited live forensics bundle.
    """
    now = time.time() if now is None else float(now)
    samples = self._history_samples()
    live = metrics_lib.snapshot()
    statuses: List[Dict[str, Any]] = []
    for objective in self._objectives:
      window_docs = []
      alerting = False
      worst = (0.0, 0.0)
      for window in self._windows:
        burn_fast = self._burn_rate(objective, samples, now,
                                    window.fast_secs)
        burn_slow = self._burn_rate(objective, samples, now,
                                    window.slow_secs)
        pair_alerting = (burn_fast >= window.threshold and
                         burn_slow >= window.threshold)
        alerting = alerting or pair_alerting
        worst = max(worst, (burn_fast, burn_slow))
        window_docs.append({
            'fast_secs': window.fast_secs,
            'slow_secs': window.slow_secs,
            'threshold': window.threshold,
            'burn_fast': round(burn_fast, 4),
            'burn_slow': round(burn_slow, 4),
            'alerting': pair_alerting,
        })
      good, bad = _good_bad_at(objective, live)
      good0, bad0 = self._start_counts[objective.name]
      dgood, dbad = max(0.0, good - good0), max(0.0, bad - bad0)
      total = dgood + dbad
      consumed = ((dbad / total) / objective.error_budget
                  if total > 0 else 0.0)
      gauges = self._gauges[objective.name]
      gauges['burn_fast'].set(worst[0])
      gauges['burn_slow'].set(worst[1])
      gauges['alerting'].set(1.0 if alerting else 0.0)
      gauges['budget_consumed'].set(consumed)
      status = {
          'name': objective.name,
          'kind': objective.kind,
          'objective': objective.objective,
          'error_budget': objective.error_budget,
          'windows': window_docs,
          'alerting': alerting,
          'budget_consumed': round(consumed, 4),
          'good': dgood,
          'bad': dbad,
      }
      if objective.kind == 'latency':
        status['threshold_ms'] = objective.threshold_ms
      statuses.append(status)
      self._note_transition(objective, status)
    with self._lock:
      self._last_status = statuses
      self._evaluations += 1
    return statuses

  def _note_transition(self, objective: Objective,
                       status: Dict[str, Any]) -> None:
    name = objective.name
    with self._lock:
      was = self._alerting[name]
      self._alerting[name] = status['alerting']
    if status['alerting'] and not was:
      self._m_alerts.inc()
      worst = max(status['windows'],
                  key=lambda w: min(w['burn_fast'], w['burn_slow']))
      detail = (f"objective={objective.objective} "
                f"burn_fast={worst['burn_fast']} "
                f"burn_slow={worst['burn_slow']} "
                f"threshold={worst['threshold']} "
                f"budget_consumed={status['budget_consumed']}")
      flight.event('slo', f'slo/{name}/burn_alert', detail)
      logging.warning('SLO %s burning: %s', name, detail)
      if self._postmortem_dir:
        from tensor2robot_tpu_torch.observability import postmortem

        postmortem.dump(self._postmortem_dir, f'slo_burn_{name}',
                        live=True, extra={'slo': status})
    elif was and not status['alerting']:
      flight.event('slo', f'slo/{name}/burn_clear',
                   f"budget_consumed={status['budget_consumed']}")

  # -------------------------------------------------------------- lifecycle

  def start(self) -> 'SLOEngine':
    if self._thread is not None:
      return self
    recorder = self._recorder or timeseries.global_recorder()
    if recorder is not None:
      # A periodically-driven engine whose windows cannot span 2 ring
      # samples would silently never alert; refuse to start that way.
      _validate_windows(self._windows, recorder.interval_secs)
    interval = self._eval_interval
    if interval is None:
      interval = recorder.interval_secs if recorder is not None else 10.0
    self._stop.clear()

    def run():
      while not self._stop.wait(interval):
        try:
          self.evaluate()
        except Exception:  # pylint: disable=broad-except
          logging.exception('SLO evaluation failed (non-fatal).')

    self._thread = threading.Thread(target=run, daemon=True,
                                    name='t2r-slo')
    self._thread.start()
    if self._register_report:
      metrics_lib.register_report_provider('slo', self.report)
    _maybe_adopt_global(self)
    return self

  def stop(self) -> None:
    self._stop.set()
    if self._thread is not None:
      self._thread.join(timeout=10.0)
      self._thread = None
      if self._register_report:
        metrics_lib.unregister_report_provider('slo')
    _maybe_release_global(self)

  def __enter__(self) -> 'SLOEngine':
    return self.start()

  def __exit__(self, *exc) -> None:
    self.stop()

  # -------------------------------------------------------------- reporting

  def report(self) -> Dict[str, Any]:
    """The ``slo`` section of ``/metricsz`` and the serving ``/statz``."""
    with self._lock:
      statuses = list(self._last_status)
      evaluations = self._evaluations
    return {
        'objectives': statuses,
        'evaluations': evaluations,
        'alerting': sorted(s['name'] for s in statuses if s['alerting']),
        'alerts': metrics_lib.counter('slo/alerts').value,
        'windows': [w._asdict() for w in self._windows],
    }


# Process-global engine (first started wins): the serving /statz handler
# embeds its report without the server having to own the engine.
_GLOBAL: Optional[SLOEngine] = None  # GUARDED_BY(_GLOBAL_LOCK)
_GLOBAL_LOCK = threading.Lock()


def _maybe_adopt_global(engine: SLOEngine) -> None:
  global _GLOBAL
  with _GLOBAL_LOCK:
    if _GLOBAL is None:
      _GLOBAL = engine


def _maybe_release_global(engine: SLOEngine) -> None:
  global _GLOBAL
  with _GLOBAL_LOCK:
    if _GLOBAL is engine:
      _GLOBAL = None


def global_engine() -> Optional[SLOEngine]:
  with _GLOBAL_LOCK:
    return _GLOBAL


def set_global_engine(engine: Optional[SLOEngine]) -> None:
  global _GLOBAL
  with _GLOBAL_LOCK:
    _GLOBAL = engine
