"""Process-global, thread-safe metrics registry: the port's counterpart of
``tensor2robot_tpu/observability/metrics.py``, with its contract and its
documents unchanged. Pure stdlib.

* :func:`counter`, :func:`gauge` and :func:`histogram` create or get a
  named metric in the process registry (flat slash-scoped names such as
  ``'serving/bucket_compiles'``); :func:`scope` prefixes a path segment.
* A :class:`Histogram` keeps exact count, sum, min and max and
  percentiles (p50, p90, p99) from power-of-two buckets, each the upper
  edge of its bucket clamped into the observed range. ``observe`` may
  attach one exemplar label per bucket (the latest: label, value, wall
  time); a snapshot carries the raw bucket counts, which windowed
  consumers (the SLO engine, the anomaly watch) difference.
* :func:`snapshot` reads every metric under a prefix, :func:`delta` the
  change since an earlier snapshot; :func:`report` adds the sections of
  :func:`register_report_provider`'s providers, :func:`dump_report`
  writes it as JSON. The Prometheus/OpenMetrics text exposition is
  ``metricsz.prom_exposition``.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = [
    'Counter', 'Gauge', 'Histogram', 'Registry', 'Scope', 'counter',
    'gauge', 'histogram', 'scope', 'snapshot', 'delta', 'report',
    'dump_report', 'reset', 'registry', 'register_report_provider',
    'unregister_report_provider',
]

_ZERO_BUCKET = -1075  # frexp exponent below every positive float


class Counter:
  """Monotonically increasing integer count."""

  kind = 'counter'

  def __init__(self, name: str):
    self.name = name
    self._lock = threading.Lock()
    self._value = 0  # GUARDED_BY(self._lock)

  def inc(self, n: int = 1) -> None:
    with self._lock:
      self._value += n

  @property
  def value(self) -> int:
    with self._lock:
      return self._value

  def snapshot(self):
    return self.value


class Gauge:
  """Last-written float value."""

  kind = 'gauge'

  def __init__(self, name: str):
    self.name = name
    self._lock = threading.Lock()
    self._value = 0.0  # GUARDED_BY(self._lock)

  def set(self, value: float) -> None:
    with self._lock:
      self._value = float(value)

  def add(self, value: float) -> None:
    with self._lock:
      self._value += float(value)

  @property
  def value(self) -> float:
    with self._lock:
      return self._value

  def snapshot(self):
    return self.value


class Histogram:
  """Streaming distribution: exact count, sum, min and max; percentiles
  from power-of-two buckets (``math.frexp``'s exponent: bucket e covers
  (2**(e-1), 2**e]; zero and negatives share one bucket), within 2x of the
  truth at any scale."""

  kind = 'histogram'

  def __init__(self, name: str):
    self.name = name
    self._lock = threading.Lock()
    self._count = 0  # GUARDED_BY(self._lock)
    self._sum = 0.0  # GUARDED_BY(self._lock)
    self._min = math.inf  # GUARDED_BY(self._lock)
    self._max = -math.inf  # GUARDED_BY(self._lock)
    self._buckets: Dict[int, int] = {}  # GUARDED_BY(self._lock)
    # exponent -> (label, observed value, wall time), the latest per bucket
    self._exemplars: Dict[int, tuple] = {}  # GUARDED_BY(self._lock)

  def observe(self, value: float, exemplar: Optional[str] = None) -> None:
    value = float(value)
    with self._lock:
      self._count += 1
      self._sum += value
      if value < self._min:
        self._min = value
      if value > self._max:
        self._max = value
      exponent = math.frexp(value)[1] if value > 0.0 else _ZERO_BUCKET
      self._buckets[exponent] = self._buckets.get(exponent, 0) + 1
      if exemplar is not None:
        self._exemplars[exponent] = (str(exemplar), value, time.time())

  @staticmethod
  def bucket_upper(exponent: int) -> float:
    """The inclusive upper edge of a frexp-exponent bucket."""
    return 0.0 if exponent == _ZERO_BUCKET else math.ldexp(1.0, exponent)

  def _percentile_locked(self, fraction: float) -> float:  # HOLDS(self._lock)
    if self._count == 0:
      return 0.0
    target = fraction * self._count
    seen = 0
    for exponent in sorted(self._buckets):
      seen += self._buckets[exponent]
      if seen >= target:
        return min(max(self.bucket_upper(exponent), self._min), self._max)
    return self._max

  @property
  def count(self) -> int:
    with self._lock:
      return self._count

  @property
  def mean(self) -> float:
    with self._lock:
      return self._sum / self._count if self._count else 0.0

  def bucket_counts(self) -> Dict[int, int]:
    """Raw ``{frexp exponent: count}`` (for exposition formats)."""
    with self._lock:
      return dict(self._buckets)

  def bucket_exemplars(self) -> Dict[int, tuple]:
    """``{frexp exponent: (label, value, wall_time)}``."""
    with self._lock:
      return dict(self._exemplars)

  def snapshot(self):
    with self._lock:
      if self._count == 0:
        return {'count': 0, 'sum': 0.0, 'min': 0.0, 'max': 0.0,
                'mean': 0.0, 'p50': 0.0, 'p90': 0.0, 'p99': 0.0}
      out = {
          'count': self._count, 'sum': self._sum, 'min': self._min,
          'max': self._max, 'mean': self._sum / self._count,
          'p50': self._percentile_locked(0.50),
          'p90': self._percentile_locked(0.90),
          'p99': self._percentile_locked(0.99),
          # String exponents: stable across a JSON round trip.
          'buckets': {str(e): c for e, c in sorted(self._buckets.items())},
      }
      if self._exemplars:
        out['exemplars'] = {repr(self.bucket_upper(e)): entry[0]
                            for e, entry in sorted(self._exemplars.items())}
      return out


class Registry:
  """Name -> metric map with typed create-or-get accessors; asking for an
  existing name with another type raises."""

  def __init__(self):
    self._lock = threading.Lock()
    self._metrics: Dict[str, object] = {}  # GUARDED_BY(self._lock)
    self._start_time = time.time()  # GUARDED_BY(self._lock)

  def _get(self, name: str, cls):
    with self._lock:
      metric = self._metrics.get(name)
      if metric is None:
        metric = self._metrics[name] = cls(name)
      elif not isinstance(metric, cls):
        raise TypeError(f'metric {name!r} already registered as '
                        f'{type(metric).__name__}, requested {cls.__name__}')
      return metric

  def counter(self, name: str) -> Counter:
    return self._get(name, Counter)

  def gauge(self, name: str) -> Gauge:
    return self._get(name, Gauge)

  def histogram(self, name: str) -> Histogram:
    return self._get(name, Histogram)

  def scope(self, prefix: str) -> 'Scope':
    return Scope(self, prefix)

  def names(self, prefix: str = '') -> List[str]:
    with self._lock:
      return sorted(n for n in self._metrics if n.startswith(prefix))

  def items(self, prefix: str = '') -> List:
    """Sorted ``(name, metric)`` pairs (the exposition formats read the
    metric objects' buckets)."""
    with self._lock:
      return sorted((n, m) for n, m in self._metrics.items()
                    if n.startswith(prefix))

  def snapshot(self, prefix: str = '') -> Dict[str, object]:
    """Counters as ints, gauges as floats, histograms as stats dicts."""
    with self._lock:
      metrics = [(n, m) for n, m in self._metrics.items()
                 if n.startswith(prefix)]
    return {name: metric.snapshot() for name, metric in sorted(metrics)}

  def delta(self, previous: Dict[str, object],
            prefix: str = '') -> Dict[str, object]:
    """The change since ``previous`` (an earlier :meth:`snapshot`):
    counters and histogram count/sum differenced (the mean recomputed over
    the window), gauges at their current value; a metric born after
    ``previous`` differences against zero."""
    out: Dict[str, object] = {}
    for name, value in self.snapshot(prefix).items():
      prev = previous.get(name)
      if isinstance(value, dict):
        pcount = prev.get('count', 0) if isinstance(prev, dict) else 0
        psum = prev.get('sum', 0.0) if isinstance(prev, dict) else 0.0
        dcount = value['count'] - pcount
        dsum = value['sum'] - psum
        out[name] = {'count': dcount, 'sum': dsum,
                     'mean': dsum / dcount if dcount else 0.0}
      elif isinstance(value, int):
        out[name] = value - (prev if isinstance(prev, int) else 0)
      else:
        out[name] = value
    return out

  def report(self) -> Dict[str, object]:
    """Every metric, the process's id and uptime, and one section per
    report provider (a provider that raises reports its error in-band)."""
    with self._lock:
      start_time = self._start_time
    out: Dict[str, object] = {
        'kind': 'metrics_report', 'pid': os.getpid(),
        'uptime_sec': round(time.time() - start_time, 3),
        'metrics': self.snapshot(),
    }
    with _providers_lock:
      providers = dict(_report_providers)
    for name, fn in providers.items():
      try:
        out[name] = fn()
      except Exception as e:  # pylint: disable=broad-except
        out[name] = {'error': repr(e)}
    return out

  def dump_report(self, path: str) -> str:
    """Writes :meth:`report` as JSON to ``path`` (directories created)."""
    dirname = os.path.dirname(path)
    if dirname:
      os.makedirs(dirname, exist_ok=True)
    with open(path, 'w') as f:
      json.dump(self.report(), f, indent=2, sort_keys=True)
      f.write('\n')
    return path

  def reset(self) -> None:
    """Drops every metric (tests only: live code holds metric handles)."""
    with self._lock:
      self._metrics.clear()
      self._start_time = time.time()


class Scope:
  """A prefixing view of a registry: ``scope('data').counter('x')`` is
  ``'data/x'``."""

  def __init__(self, registry_: Registry, prefix: str):
    self._registry = registry_
    self._prefix = prefix.rstrip('/') + '/'

  def counter(self, name: str) -> Counter:
    return self._registry.counter(self._prefix + name)

  def gauge(self, name: str) -> Gauge:
    return self._registry.gauge(self._prefix + name)

  def histogram(self, name: str) -> Histogram:
    return self._registry.histogram(self._prefix + name)

  def scope(self, prefix: str) -> 'Scope':
    return Scope(self._registry, self._prefix + prefix)

  def snapshot(self) -> Dict[str, object]:
    return self._registry.snapshot(self._prefix)


_report_providers: Dict[str, Callable[[], object]] = {}  # GUARDED_BY(_providers_lock)
_providers_lock = threading.Lock()


def register_report_provider(name: str, fn: Callable[[], object]) -> None:
  """Adds ``fn() -> dict`` as the section ``name`` of every ``report()``;
  a second registration under one name replaces the first."""
  if name in ('kind', 'pid', 'uptime_sec', 'metrics'):
    raise ValueError(f'report section name {name!r} is reserved')
  with _providers_lock:
    _report_providers[name] = fn


def unregister_report_provider(name: str) -> None:
  with _providers_lock:
    _report_providers.pop(name, None)


registry = Registry()


def counter(name: str) -> Counter:
  return registry.counter(name)


def gauge(name: str) -> Gauge:
  return registry.gauge(name)


def histogram(name: str) -> Histogram:
  return registry.histogram(name)


def scope(prefix: str) -> Scope:
  return registry.scope(prefix)


def snapshot(prefix: str = '') -> Dict[str, object]:
  return registry.snapshot(prefix)


def delta(previous: Dict[str, object], prefix: str = '') -> Dict[str, object]:
  return registry.delta(previous, prefix)


def report() -> Dict[str, object]:
  return registry.report()


def dump_report(path: str) -> str:
  return registry.dump_report(path)


def reset() -> None:
  registry.reset()
