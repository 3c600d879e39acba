"""Synthetic load for the serving plane, closed- and open-loop (the
port's counterpart of ``tensor2robot_tpu/serving/loadgen.py``, with the
same arrival process, reservoir and reports from the same seed).

* :func:`run_load`: N closed-loop clients, each waiting for its response
  before the next request (the robot control loop). It answers
  throughput questions.
* :func:`run_open_loop`: open-loop Poisson arrivals at a set rate,
  whatever the plane's responses. A request's latency runs from its
  scheduled arrival, so queueing delay and the generator's own scheduling
  lag land in the percentiles (no coordinated omission). Rates take burst
  multipliers and a piecewise trace (:func:`rate_multiplier`), and a
  ``best_effort_fraction`` of arrivals carry the ``best_effort`` class.

Latency samples are a fixed-capacity uniform reservoir (Algorithm R,
:class:`Reservoir`): bounded memory however long a run soaks, with count,
sum, min and max exact. :func:`serial_baseline` is one client's
back-to-back ``predict()`` rate, the denominator of a batching speedup.
"""

from __future__ import annotations

import http.client
import itertools
import json
import math
import random
import threading
import time
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence)

import numpy as np

from tensor2robot_tpu_torch.observability import tracing
from tensor2robot_tpu_torch.serving import batching as batching_lib

DEFAULT_RESERVOIR_SIZE = 8192


class ShedError(RuntimeError):
  """The plane refused this request (503: shed / overloaded / draining).

  Open-loop runs count sheds separately from errors — a shed is the
  admission controller WORKING, not the plane failing.
  ``retry_after_secs`` carries the plane's advertised ``Retry-After``
  (None when the 503 carried no hint); cooperative best-effort clients
  resubmit after that delay instead of treating the shed as terminal.
  """

  def __init__(self, message: str = '',
               retry_after_secs: Optional[float] = None):
    super().__init__(message)
    self.retry_after_secs = retry_after_secs


class Reservoir:
  """Fixed-capacity uniform sample of a value stream (Algorithm R).

  ``add`` is O(1) and thread-safe; ``seen``/``total``/``min``/``max``
  stay exact while the percentile estimates are computed over a uniform
  subsample of at most ``capacity`` values — bounded memory no matter
  how long the load run soaks.
  """

  def __init__(self, capacity: int = DEFAULT_RESERVOIR_SIZE, seed: int = 0):
    if capacity < 1:
      raise ValueError(f'capacity must be >= 1, got {capacity}')
    self._capacity = int(capacity)
    self._rng = random.Random(seed)
    self._lock = threading.Lock()
    self._samples: List[float] = []  # GUARDED_BY(self._lock)
    self._seen = 0  # GUARDED_BY(self._lock)
    self._sum = 0.0  # GUARDED_BY(self._lock)
    self._min = math.inf  # GUARDED_BY(self._lock)
    self._max = -math.inf  # GUARDED_BY(self._lock)

  @property
  def capacity(self) -> int:
    return self._capacity

  @property
  def seen(self) -> int:
    with self._lock:
      return self._seen

  def add(self, value: float) -> None:
    value = float(value)
    with self._lock:
      self._seen += 1
      self._sum += value
      if value < self._min:
        self._min = value
      if value > self._max:
        self._max = value
      if len(self._samples) < self._capacity:
        self._samples.append(value)
      else:
        j = self._rng.randrange(self._seen)
        if j < self._capacity:
          self._samples[j] = value

  def summary(self) -> Dict[str, float]:
    """count/mean/min/max exact; p50/p99 over the uniform subsample."""
    with self._lock:
      samples = sorted(self._samples)
      seen, total = self._seen, self._sum
      lo, hi = self._min, self._max
    if not seen:
      return {'count': 0, 'mean': 0.0, 'min': 0.0, 'max': 0.0,
              'p50': 0.0, 'p99': 0.0}
    return {
        'count': seen,
        'mean': total / seen,
        'min': lo,
        'max': hi,
        'p50': _percentile(samples, 0.50),
        'p99': _percentile(samples, 0.99),
    }

  def percentile(self, fraction: float) -> float:
    with self._lock:
      samples = sorted(self._samples)
    return _percentile(samples, fraction)


class LoadReport(NamedTuple):
  """One closed-loop load run, reduced."""

  clients: int
  requests: int
  errors: int
  duration_s: float
  actions_per_sec: float
  latency_ms_p50: float
  latency_ms_p99: float
  latency_ms_mean: float

  def as_dict(self) -> Dict[str, Any]:
    return {
        'clients': self.clients,
        'requests': self.requests,
        'errors': self.errors,
        'duration_s': round(self.duration_s, 3),
        'actions_per_sec': round(self.actions_per_sec, 2),
        'latency_ms_p50': round(self.latency_ms_p50, 2),
        'latency_ms_p99': round(self.latency_ms_p99, 2),
        'latency_ms_mean': round(self.latency_ms_mean, 2),
    }


def _percentile(sorted_values: Sequence[float], fraction: float) -> float:
  if not sorted_values:
    return 0.0
  index = min(len(sorted_values) - 1,
              max(0, int(round(fraction * (len(sorted_values) - 1)))))
  return sorted_values[index]


# ------------------------------------------------------------- submit shims


def inproc_submit_fn(batcher, timeout: float = 30.0) -> Callable:
  """submit(features) -> outputs against the in-process batcher."""

  def submit(features):
    return batcher.submit(features).result(timeout=timeout)

  return submit


def router_submit_fn(router, model_fn: Optional[Callable[[int], str]] = None,
                     timeout: float = 30.0) -> Callable:
  """Open-loop submit(index, features, priority) against a ModelRouter.

  ``model_fn(index)`` picks the target model per arrival (e.g.
  ``router.round_robin_models([...])``); None targets the default model.
  Admission sheds surface as :class:`ShedError`.
  """
  def submit(index, features, priority):
    model = model_fn(index) if model_fn is not None else None
    try:
      return router.submit(features, model=model,
                           priority=priority).result(timeout=timeout)
    except batching_lib.OverloadedError as e:
      raise ShedError(
          str(e),
          retry_after_secs=getattr(e, 'retry_after_secs', None)) from e

  return submit


def encode_request(features: Dict[str, Any]) -> bytes:
  """The JSON body of a predict request: ``{"features": {name: nested
  lists}}``."""
  return json.dumps({
      'features': {k: np.asarray(v).tolist() for k, v in features.items()}
  }).encode()


def http_submit_fn(host: str, port: int, timeout: float = 30.0,
                   trace_sample: float = 0.0) -> Callable:
  """Closed-loop submit(features) -> outputs over HTTP (keep-alive)."""
  open_submit = http_open_submit_fn(host, port, timeout=timeout,
                                    trace_sample=trace_sample)
  seq = itertools.count()

  def submit(features):
    return open_submit(next(seq), features, None)

  return submit


def http_open_submit_fn(host: str, port: int,
                        model_fn: Optional[Callable[[int], str]] = None,
                        timeout: float = 30.0,
                        trace_sample: float = 0.0) -> Callable:
  """Open-loop submit(index, features, priority) over HTTP.

  Per-thread keep-alive connections; named models route to
  ``/v1/models/<name>/predict`` and the priority class rides the
  ``X-Priority`` header (the balancer forwards both, plus
  ``X-Request-Id``). A 503 raises :class:`ShedError`.

  ``trace_sample`` mints a fresh ``traceparent`` context (trace id +
  root span id) on every Nth request — the loadgen is the fleet's trace
  ingress, so a sampled request's balancer hop, failed/succeeded
  backend attempts, and batcher lifecycle all record spans under ONE
  trace id, assemblable with ``tools/assemble_trace.py``.

  ``features`` may also be the request body already encoded (``bytes``,
  see :func:`encode_request`), so that a client sending one large frame
  over and over does not pay its JSON encoding on every request.
  """
  if not 0.0 <= float(trace_sample) <= 1.0:
    raise ValueError(f'trace_sample must be in [0, 1], got {trace_sample!r}')
  trace_every = (int(round(1.0 / trace_sample)) if trace_sample > 0 else 0)
  local = threading.local()

  def submit(index, features, priority):
    conn = getattr(local, 'conn', None)
    if conn is None:
      conn = http.client.HTTPConnection(host, port, timeout=timeout)
      local.conn = conn
    model = model_fn(index) if model_fn is not None else None
    path = (f'/v1/models/{model}/predict' if model else '/v1/predict')
    headers = {'Content-Type': 'application/json'}
    if priority:
      headers['X-Priority'] = priority
    if trace_every and index % trace_every == 0:
      headers[tracing.TRACEPARENT_HEADER] = tracing.format_traceparent(
          tracing.TraceContext(tracing.mint_trace_id(),
                               tracing.mint_span_id()))
    body = (features if isinstance(features, (bytes, bytearray))
            else encode_request(features))
    try:
      conn.request('POST', path, body=body, headers=headers)
      response = conn.getresponse()
      payload = json.loads(response.read())
    except Exception:
      local.conn = None  # drop the broken keep-alive connection
      raise
    if response.status == 503:
      retry_after = response.getheader('Retry-After')
      try:
        retry_after = float(retry_after) if retry_after else None
      except (TypeError, ValueError):
        retry_after = None
      raise ShedError(str(payload.get('error', payload)),
                      retry_after_secs=retry_after)
    if response.status != 200:
      raise RuntimeError(
          f'HTTP {response.status}: {payload.get("error", payload)}')
    return payload['outputs']

  return submit


# ------------------------------------------------------------- closed loop


def run_load(submit: Callable,
             features_fn: Callable[[int], Dict[str, np.ndarray]],
             num_clients: int,
             requests_per_client: Optional[int] = None,
             duration_secs: Optional[float] = None,
             examples_per_request: int = 1,
             warmup_requests: int = 1,
             reservoir_size: int = DEFAULT_RESERVOIR_SIZE) -> LoadReport:
  """Runs N closed-loop clients; returns the reduced report.

  ``features_fn(client_index)`` builds that client's request (so clients
  can send distinct payloads — correctness checks ride the same run).
  Bound the run with EITHER ``requests_per_client`` or ``duration_secs``.
  Latency storage is a bounded reservoir (``reservoir_size``), so long
  soaks hold constant memory.
  """
  if (requests_per_client is None) == (duration_secs is None):
    raise ValueError(
        'exactly one of requests_per_client / duration_secs required')
  latencies = Reservoir(reservoir_size)
  errors = [0] * num_clients
  stop_at: Optional[float] = None
  start_barrier = threading.Barrier(num_clients + 1)

  def client(index: int) -> None:
    features = features_fn(index)
    for _ in range(warmup_requests):
      try:
        submit(features)
      except Exception:  # pylint: disable=broad-except
        pass
    start_barrier.wait()
    sent = 0
    while True:
      if requests_per_client is not None and sent >= requests_per_client:
        return
      if stop_at is not None and time.monotonic() >= stop_at:
        return
      t0 = time.monotonic()
      try:
        submit(features)
        latencies.add(1e3 * (time.monotonic() - t0))
      except Exception:  # pylint: disable=broad-except
        errors[index] += 1
      sent += 1

  threads = [threading.Thread(target=client, args=(i,), daemon=True)
             for i in range(num_clients)]
  for thread in threads:
    thread.start()
  start_barrier.wait()  # all clients warmed: the timed window is steady
  t_start = time.monotonic()
  if duration_secs is not None:
    stop_at = t_start + duration_secs
  for thread in threads:
    thread.join()
  duration = max(time.monotonic() - t_start, 1e-9)

  stats = latencies.summary()
  total_requests = stats['count']
  return LoadReport(
      clients=num_clients,
      requests=total_requests,
      errors=sum(errors),
      duration_s=duration,
      actions_per_sec=total_requests * examples_per_request / duration,
      latency_ms_p50=stats['p50'],
      latency_ms_p99=stats['p99'],
      latency_ms_mean=stats['mean'],
  )


# --------------------------------------------------------------- open loop


def rate_multiplier(t: float,
                    duration_secs: float,
                    burst_factor: float = 1.0,
                    burst_period_secs: Optional[float] = None,
                    burst_duty: float = 0.2,
                    rate_trace: Optional[Sequence[float]] = None) -> float:
  """The arrival-rate multiplier at offset ``t``.

  ``rate_trace`` is the diurnal mode: a sequence of multipliers spread
  evenly across the run (e.g. a 24-entry trace models a day's shape in
  miniature). ``burst_factor`` multiplies the rate during the first
  ``burst_duty`` fraction of every ``burst_period_secs`` window —
  composable with the trace.
  """
  m = 1.0
  if rate_trace:
    index = min(len(rate_trace) - 1,
                int(t / max(duration_secs, 1e-9) * len(rate_trace)))
    m *= float(rate_trace[index])
  if burst_period_secs and burst_factor != 1.0:
    if (t % burst_period_secs) < burst_duty * burst_period_secs:
      m *= burst_factor
  return m


def poisson_arrivals(rate_rps: float,
                     duration_secs: float,
                     seed: int = 0,
                     burst_factor: float = 1.0,
                     burst_period_secs: Optional[float] = None,
                     burst_duty: float = 0.2,
                     rate_trace: Optional[Sequence[float]] = None
                     ) -> List[float]:
  """Arrival offsets in ``[0, duration_secs)`` from a (time-varying)
  Poisson process. Deterministic for a given seed."""
  if rate_rps <= 0:
    raise ValueError(f'rate_rps must be > 0, got {rate_rps}')
  rng = random.Random(seed)
  arrivals: List[float] = []
  t = 0.0
  while True:
    rate = rate_rps * rate_multiplier(
        t, duration_secs, burst_factor=burst_factor,
        burst_period_secs=burst_period_secs, burst_duty=burst_duty,
        rate_trace=rate_trace)
    if rate <= 0.0:
      # A zero-rate trace interval: step past it at base-rate
      # resolution WITHOUT emitting an arrival.
      t += 1.0 / rate_rps
      if t >= duration_secs:
        return arrivals
      continue
    t += rng.expovariate(rate)
    if t >= duration_secs:
      return arrivals
    arrivals.append(t)


class OpenLoopReport(NamedTuple):
  """One open-loop run, reduced. Latencies INCLUDE scheduling lag:
  every sample runs from the request's scheduled Poisson arrival, so
  overload shows up in the percentiles instead of silently stretching
  inter-arrival gaps (coordinated omission)."""

  offered_rps: float
  achieved_rps: float
  duration_s: float
  arrivals: int
  ok: int
  shed: int
  errors: int
  resubmitted: int
  latency_ms_p50: float
  latency_ms_p99: float
  latency_ms_mean: float
  latency_ms_max: float
  classes: Dict[str, Dict[str, Any]]

  def as_dict(self) -> Dict[str, Any]:
    return {
        'offered_rps': round(self.offered_rps, 2),
        'achieved_rps': round(self.achieved_rps, 2),
        'duration_s': round(self.duration_s, 3),
        'arrivals': self.arrivals,
        'ok': self.ok,
        'shed': self.shed,
        'errors': self.errors,
        'resubmitted': self.resubmitted,
        'latency_ms_p50': round(self.latency_ms_p50, 2),
        'latency_ms_p99': round(self.latency_ms_p99, 2),
        'latency_ms_mean': round(self.latency_ms_mean, 2),
        'latency_ms_max': round(self.latency_ms_max, 2),
        'classes': self.classes,
    }


def run_open_loop(submit: Callable,
                  features_fn: Callable[[int], Dict[str, np.ndarray]],
                  rate_rps: float,
                  duration_secs: float,
                  workers: int = 32,
                  seed: int = 0,
                  best_effort_fraction: float = 0.0,
                  burst_factor: float = 1.0,
                  burst_period_secs: Optional[float] = None,
                  burst_duty: float = 0.2,
                  rate_trace: Optional[Sequence[float]] = None,
                  reservoir_size: int = DEFAULT_RESERVOIR_SIZE,
                  warmup_requests: int = 1,
                  honor_retry_after: bool = True,
                  max_resubmits: int = 3) -> OpenLoopReport:
  """Open-loop Poisson load: ``submit(index, features, priority)``.

  Arrivals are scheduled ahead of time from the seeded Poisson process;
  ``workers`` threads consume them in order, sleeping until each
  request's scheduled instant (or sending immediately when already
  late — the lag then lands in that request's latency). ``submit``
  raising :class:`ShedError` counts as a shed, any other exception as an
  error. ``best_effort_fraction`` of arrivals carry the
  ``'best_effort'`` class, the rest ``'interactive'`` — per-class
  outcome counts and percentiles ride the report.

  ``honor_retry_after`` makes best-effort arrivals cooperative: a shed
  carrying the plane's advertised ``Retry-After`` delay resubmits after
  that delay (up to ``max_resubmits`` times, never past the end of the
  run) instead of counting a terminal shed. Resubmissions are counted
  separately (``resubmitted``) and an eventually-accepted request's
  latency still runs from its ORIGINAL scheduled arrival — the retry
  wait lands in the percentiles, not under the rug. Interactive
  arrivals never resubmit (a shed interactive request is itself a bug
  worth counting loudly).
  """
  if not 0.0 <= best_effort_fraction <= 1.0:
    raise ValueError(f'best_effort_fraction must be in [0, 1], got '
                     f'{best_effort_fraction!r}')
  arrivals = poisson_arrivals(
      rate_rps, duration_secs, seed=seed, burst_factor=burst_factor,
      burst_period_secs=burst_period_secs, burst_duty=burst_duty,
      rate_trace=rate_trace)
  class_rng = random.Random(seed + 1)
  priorities = ['best_effort' if class_rng.random() < best_effort_fraction
                else 'interactive' for _ in arrivals]
  class_names = sorted(set(priorities)) or ['interactive']

  overall = Reservoir(reservoir_size)
  per_class = {name: Reservoir(reservoir_size, seed=seed + 2)
               for name in class_names}
  counts_lock = threading.Lock()
  counts = {name: {'arrivals': 0, 'ok': 0, 'shed': 0, 'errors': 0,
                   'resubmitted': 0}
            for name in class_names}  # GUARDED_BY(counts_lock)
  next_index = itertools.count()

  for i in range(warmup_requests):
    try:
      submit(i, features_fn(i), 'interactive')
    except Exception:  # pylint: disable=broad-except
      pass

  t0 = time.monotonic()

  def worker() -> None:
    while True:
      i = next(next_index)
      if i >= len(arrivals):
        return
      scheduled = t0 + arrivals[i]
      now = time.monotonic()
      if now < scheduled:
        time.sleep(scheduled - now)
      priority = priorities[i]
      features = features_fn(i)
      resubmits = 0
      while True:
        outcome = 'ok'
        try:
          submit(i, features, priority)
        except ShedError as e:
          outcome = 'shed'
          delay = getattr(e, 'retry_after_secs', None)
          if (honor_retry_after and priority == 'best_effort'
              and delay is not None and resubmits < max_resubmits
              and (time.monotonic() - t0) + delay < duration_secs):
            # Cooperative client: reschedule after the advertised
            # delay instead of a terminal shed.
            resubmits += 1
            time.sleep(delay)
            continue
        except Exception:  # pylint: disable=broad-except
          outcome = 'errors'
        break
      latency_ms = 1e3 * (time.monotonic() - scheduled)
      if outcome == 'ok':
        overall.add(latency_ms)
        per_class[priority].add(latency_ms)
      with counts_lock:
        counts[priority]['arrivals'] += 1
        counts[priority][outcome] += 1
        counts[priority]['resubmitted'] += resubmits

  threads = [threading.Thread(target=worker, daemon=True)
             for _ in range(max(1, int(workers)))]
  for thread in threads:
    thread.start()
  for thread in threads:
    thread.join()
  wall = max(time.monotonic() - t0, 1e-9)

  stats = overall.summary()
  with counts_lock:
    totals = {k: sum(c[k] for c in counts.values())
              for k in ('ok', 'shed', 'errors', 'resubmitted')}
    classes = {}
    for name in class_names:
      cstats = per_class[name].summary()
      classes[name] = dict(
          counts[name],
          latency_ms_p50=round(cstats['p50'], 2),
          latency_ms_p99=round(cstats['p99'], 2),
      )
  return OpenLoopReport(
      offered_rps=len(arrivals) / max(duration_secs, 1e-9),
      achieved_rps=totals['ok'] / wall,
      duration_s=wall,
      arrivals=len(arrivals),
      ok=totals['ok'],
      shed=totals['shed'],
      errors=totals['errors'],
      resubmitted=totals['resubmitted'],
      latency_ms_p50=stats['p50'],
      latency_ms_p99=stats['p99'],
      latency_ms_mean=stats['mean'],
      latency_ms_max=stats['max'] if stats['count'] else 0.0,
      classes=classes,
  )


# ---------------------------------------------------------------- baseline


def serial_baseline(predictor,
                    features: Dict[str, np.ndarray],
                    duration_secs: float = 2.0,
                    warmup_requests: int = 3) -> float:
  """Single-client serial ``predict()`` throughput (actions/sec): the
  one-predictor-per-robot operating point cross-client batching is
  measured against."""
  for _ in range(warmup_requests):
    predictor.predict(features)
  count = 0
  t0 = time.monotonic()
  while time.monotonic() - t0 < duration_secs:
    predictor.predict(features)
    count += 1
  return count / max(time.monotonic() - t0, 1e-9)
