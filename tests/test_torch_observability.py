"""The port's observability plane on the CPU, held to the JAX package's.

One seeded sequence of counter, gauge and histogram updates, flight
events, spans and SLO observations is fed, under one injected clock
(``time.time`` and ``time.perf_counter`` patched), to both packages'
``metrics``, ``flight``, ``timeseries``, ``tracing``, ``slo``, ``anomaly``
and ``postmortem``. Bars: equal snapshots, deltas and reports; the same
burn rates and alert transitions; the same anomaly flags; byte-equal
Prometheus/OpenMetrics exposition; equal ``traceparent`` round trips,
malformed headers included; chrome traces, assembled cross-process traces
and postmortem bundles that ``tools/trace_summary.py``,
``tools/assemble_trace.py`` and ``tools/postmortem.py`` read as they read
the JAX package's. ``memory.device_memory_stats()`` is None on the CPU in
both. About 11 s alone (imports included).
"""

import itertools
import json
import time
import types

import numpy as np
import pytest

from tensor2robot_tpu.observability import anomaly as jax_anomaly
from tensor2robot_tpu.observability import flight as jax_flight
from tensor2robot_tpu.observability import memory as jax_memory
from tensor2robot_tpu.observability import metrics as jax_metrics
from tensor2robot_tpu.observability import metricsz as jax_metricsz
from tensor2robot_tpu.observability import postmortem as jax_postmortem
from tensor2robot_tpu.observability import slo as jax_slo
from tensor2robot_tpu.observability import timeseries as jax_timeseries
from tensor2robot_tpu.observability import tracing as jax_tracing
from tensor2robot_tpu_torch.observability import anomaly, flight, memory
from tensor2robot_tpu_torch.observability import metrics, metricsz
from tensor2robot_tpu_torch.observability import postmortem, slo
from tensor2robot_tpu_torch.observability import timeseries, tracing
from tools import assemble_trace
from tools import postmortem as postmortem_tool
from tools import trace_summary

JAX = types.SimpleNamespace(
    anomaly=jax_anomaly, flight=jax_flight, memory=jax_memory,
    metrics=jax_metrics, metricsz=jax_metricsz, postmortem=jax_postmortem,
    slo=jax_slo, timeseries=jax_timeseries, tracing=jax_tracing)
PORT = types.SimpleNamespace(
    anomaly=anomaly, flight=flight, memory=memory, metrics=metrics,
    metricsz=metricsz, postmortem=postmortem, slo=slo,
    timeseries=timeseries, tracing=tracing)
BOTH = (JAX, PORT)

_RUN = itertools.count()


class FakeClock:
  """``time.time`` and ``time.perf_counter`` of the test: moves only when
  told."""

  def __init__(self, t0=2.0e9):
    self.t0 = self.t = t0

  def rewind(self):
    """Back to the start, before the second package's run."""
    self.t = self.t0

  def __call__(self):
    return self.t

  def advance(self, seconds):
    self.t += seconds


@pytest.fixture
def clock(monkeypatch):
  fake = FakeClock()
  monkeypatch.setattr(time, 'time', fake)
  monkeypatch.setattr(time, 'perf_counter', fake)
  return fake


def _prefix(name):
  """A metric prefix no other run of this process used."""
  return f'obsparity{next(_RUN)}_{name}'


def _update_sequence(registry_like, prefix, seed, clock):
  """The seeded counter, gauge and histogram updates (with exemplars)."""
  rng = np.random.RandomState(seed)
  c = registry_like.counter(f'{prefix}/requests')
  g = registry_like.gauge(f'{prefix}/queue_depth')
  h = registry_like.histogram(f'{prefix}/latency_ms')
  z = registry_like.histogram(f'{prefix}/zeros')
  for i in range(200):
    c.inc(int(rng.randint(1, 4)))
    g.set(float(rng.randint(0, 50)))
    if i % 7 == 0:
      g.add(0.5)
    value = float(rng.lognormal(3.0, 1.2))
    h.observe(value, exemplar=f'req-{i}' if i % 3 == 0 else None)
    z.observe(0.0 if i % 2 else -float(i))
    clock.advance(0.01)


# --------------------------------------------------------------- metrics


def test_snapshots_deltas_and_reports_are_equal(clock, tmp_path):
  prefix = _prefix('metrics')
  snaps, deltas, dumps = [], [], []
  for pkg in BOTH:
    clock.rewind()
    registry = pkg.metrics.registry
    _update_sequence(registry, prefix, 0, clock)
    before = pkg.metrics.snapshot(prefix)
    _update_sequence(registry, prefix, 1, clock)
    pkg.metrics.counter(f'{prefix}/born_later').inc(5)
    snaps.append(pkg.metrics.snapshot(prefix))
    deltas.append(pkg.metrics.delta(before, prefix))
    path = pkg.metrics.dump_report(str(tmp_path / f'{len(dumps)}.json'))
    with open(path) as f:
      report = json.load(f)
    dumps.append({k: v for k, v in report['metrics'].items()
                  if k.startswith(prefix)})
  assert snaps[0] == snaps[1]
  assert deltas[0] == deltas[1]
  assert dumps[0] == dumps[1]
  hist = snaps[1][f'{prefix}/latency_ms']
  assert hist['exemplars'] and hist['buckets']
  assert deltas[1][f'{prefix}/born_later'] == 5
  assert snaps[1][f'{prefix}/zeros']['buckets'] == {'-1075': 400}


def test_prometheus_and_openmetrics_exposition_is_byte_equal(clock):
  texts = []
  for pkg in BOTH:
    clock.rewind()
    registry = pkg.metrics.Registry()
    _update_sequence(registry, 'serving', 3, clock)
    registry.counter('balancer/ejections').inc(2)
    registry.gauge('slo/x/burn_fast').set(float('inf'))
    texts.append(pkg.metricsz.prom_exposition(registry))
  assert texts[0] == texts[1]
  assert '# {trace_id="req-' in texts[1]
  assert 'serving_latency_ms_bucket{le="+Inf"} 200' in texts[1]
  assert 'slo_x_burn_fast +Inf' in texts[1]


def test_registry_type_collision_and_reserved_sections_raise():
  for pkg in BOTH:
    registry = pkg.metrics.Registry()
    registry.counter('a/b')
    with pytest.raises(TypeError):
      registry.gauge('a/b')
    with pytest.raises(ValueError):
      pkg.metrics.register_report_provider('metrics', dict)


# ---------------------------------------------------------------- flight


def test_flight_ring_overwrites_and_windows_alike(clock):
  results = []
  for pkg in BOTH:
    clock.rewind()
    ring = pkg.flight.FlightRecorder(capacity=8)
    rng = np.random.RandomState(5)
    for i in range(13):
      ring.record(('span', 'swap', 'router')[i % 3], f'n/{i}',
                  'x' * int(rng.randint(0, 400)))
      clock.advance(1.0)
    ring.record('error', 'n/long', 'y' * 1000)
    ring.record_many([('request', 'r/queued', 'id=1', clock() - 30.0),
                      ('request', 'r/assembled', 'id=1 batch=2')])
    results.append((ring.recorded, ring.events(),
                    ring.events(last_secs=4.5),
                    ring.events(kinds=['router', 'request'])))
  assert results[0] == results[1]
  assert results[1][0] == 16
  long = [e['detail'] for e in results[1][1] if e['name'] == 'n/long']
  assert len(long[0]) == 256 and long[0].endswith('…')


def test_span_feed_and_global_events(clock):
  prefix = _prefix('flight')
  got = []
  for pkg in BOTH:
    clock.rewind()
    pkg.flight.event('swap', f'{prefix}/model_swap', 'version=3')
    pkg.flight.events_many([('router', f'{prefix}/page_in', 'bytes=9'),
                            ('router', f'{prefix}/page_out', 'bytes=9')])
    with pkg.tracing.span(f'{prefix}/slow'):
      clock.advance(0.0125)
    with pkg.tracing.span(f'{prefix}/fast'):
      clock.advance(0.001)
    clock.advance(1.0)
    got.append([e for e in pkg.flight.events(last_secs=100.0)
                if e['name'].startswith(prefix)])
    got.append(pkg.metrics.snapshot(f'{prefix}/'))
  assert got[0] == got[2] and got[1] == got[3]
  assert [e['name'] for e in got[2]][-1] == f'{prefix}/slow'
  assert got[2][-1]['detail'] == 'dur_ms=12.500'


# ------------------------------------------------------------ timeseries


def test_timeseries_history_is_equal(clock):
  prefix = _prefix('ts')
  docs = []
  for pkg in BOTH:
    clock.rewind()
    recorder = pkg.timeseries.TimeSeriesRecorder(interval_secs=10.0,
                                                 capacity=5)
    for step in range(8):
      pkg.metrics.counter(f'{prefix}/steps').inc(step)
      recorder.sample()
      clock.advance(10.0)
    doc = recorder.history(last_secs=35.0)
    for sample in doc['samples']:
      sample['metrics'] = {k: v for k, v in sample['metrics'].items()
                           if k.startswith(prefix)}
    docs.append(doc)
  assert docs[0] == docs[1]
  assert len(docs[1]['samples']) == 3
  assert docs[1]['samples'][-1]['metrics'] == {f'{prefix}/steps': 28}


def test_timeseries_maybe_start_contract(monkeypatch):
  for pkg in BOTH:
    monkeypatch.delenv(pkg.timeseries.ENV_VAR, raising=False)
    assert pkg.timeseries.maybe_start(None) is None
    assert pkg.timeseries.maybe_start(0) is None
    monkeypatch.setenv(pkg.timeseries.ENV_VAR, 'often')
    assert pkg.timeseries.maybe_start(None) is None
    with pytest.raises(ValueError):
      pkg.timeseries.TimeSeriesRecorder(interval_secs=0)


# ------------------------------------------------------------------- SLO


def _slo_drive(pkg, prefix, clock):
  """An availability and a latency objective through a healthy stretch,
  a regression and a recovery; the statuses of every evaluation, the
  flight transitions and the report."""
  clock.rewind()
  recorder = pkg.timeseries.TimeSeriesRecorder(interval_secs=10.0)
  ok = pkg.metrics.counter(f'{prefix}/class/interactive/ok')
  bad = pkg.metrics.counter(f'{prefix}/class/interactive/errors')
  hist = pkg.metrics.histogram(f'{prefix}/class/interactive/latency_ms')
  objectives = [
      pkg.slo.Objective.availability(
          f'{prefix}_avail', good=[f'{prefix}/class/interactive/ok'],
          bad=[f'{prefix}/class/interactive/errors'], objective=0.9),
      pkg.slo.Objective.latency(
          f'{prefix}_latency', histogram=f'{prefix}/class/interactive/'
          'latency_ms', threshold_ms=64.0, objective=0.9),
  ]
  engine = pkg.slo.SLOEngine(
      objectives, windows=[pkg.slo.BurnWindow(30.0, 200.0, 2.0),
                           pkg.slo.BurnWindow(60.0, 400.0, 8.0)],
      recorder=recorder, register_report=False)
  alerts0 = pkg.metrics.counter('slo/alerts').value
  rng = np.random.RandomState(11)
  statuses = []
  for phase, (good_n, bad_n, slow_n) in enumerate(
      [(100, 0, 0)] * 3 + [(50, 50, 30)] * 2 + [(500, 0, 0)] * 3):
    ok.inc(good_n)
    bad.inc(bad_n)
    for _ in range(20):
      hist.observe(float(rng.uniform(1.0, 60.0)))
    for _ in range(slow_n):
      hist.observe(float(rng.uniform(100.0, 900.0)))
    recorder.sample()
    statuses.append(engine.evaluate(now=clock()))
    clock.advance(40.0 + phase)
  events = [e for e in pkg.flight.events(kinds=['slo'])
            if prefix in e['name']]
  report = engine.report()
  report['alerts'] -= alerts0
  return statuses, events, report


def test_slo_burn_rates_and_alert_transitions_are_equal(clock):
  prefix = _prefix('slo')
  jax_run, port_run = (_slo_drive(pkg, prefix, clock) for pkg in BOTH)
  for jax_part, port_part in zip(jax_run, port_run):
    assert jax_part == port_part
  statuses, events, report = port_run
  # Availability burns 5x / 2.5x in the regression's second sample;
  # latency (30 of 50 observations over 64 ms) from its first.
  assert [s[0]['alerting'] for s in statuses] == [
      False, False, False, False, True, False, False, False]
  assert [s[1]['alerting'] for s in statuses] == [
      False, False, False, True, True, False, False, False]
  assert statuses[4][0]['windows'][0]['burn_fast'] == 5.0
  assert [e['name'].split('/', 1)[1] for e in events] == [
      f'{prefix}_latency/burn_alert', f'{prefix}_avail/burn_alert',
      f'{prefix}_avail/burn_clear', f'{prefix}_latency/burn_clear']
  assert report['alerts'] == 2 and report['evaluations'] == 8


def test_slo_objective_sets_and_windows_are_equal():
  for interval in (1.0, 10.0, 60.0):
    assert (jax_slo.derive_windows(interval) ==
            slo.derive_windows(interval))
  sets = [[o.__dict__ for o in pkg.slo.serving_objectives(
      prefix='serving', models=['a', 'b'], latency_threshold_ms=128.0)]
          for pkg in BOTH]
  assert sets[0] == sets[1]
  for pkg in BOTH:
    with pytest.raises(ValueError):
      pkg.slo.Objective.availability('bad name', [], [])
    with pytest.raises(ValueError):
      pkg.slo.SLOEngine([pkg.slo.Objective.latency('x', 'h', 1.0)],
                        windows=[pkg.slo.BurnWindow(1.0, 1.0, 2.0)],
                        recorder=pkg.timeseries.TimeSeriesRecorder(
                            interval_secs=10.0),
                        register_report=False).start()
  assert slo.global_engine() is None


# --------------------------------------------------------------- anomaly


def _anomaly_drive(pkg, prefix, clock):
  clock.rewind()
  recorder = pkg.timeseries.TimeSeriesRecorder(interval_secs=5.0)
  hist = pkg.metrics.histogram(f'{prefix}/latency_ms')
  depth = pkg.metrics.gauge(f'{prefix}/queue_depth')
  shed = pkg.metrics.counter(f'{prefix}/shed')
  watch = pkg.anomaly.AnomalyWatch(
      specs=[f'{prefix}/latency_ms:p99', f'{prefix}/queue_depth',
             f'{prefix}/shed:rate', f'{prefix}/latency_ms:mean'],
      recorder=recorder, min_history=6, register_report=False)
  rng = np.random.RandomState(21)
  flags = []
  recorder.sample()
  for step in range(30):
    regressed = 14 <= step < 20
    for _ in range(5):
      hist.observe(float(rng.uniform(300.0, 320.0) if regressed
                         else rng.uniform(7.0, 12.0)))
    depth.set(float(rng.randint(3, 6) + (40 if step == 25 else 0)))
    shed.inc(2)
    clock.advance(5.0)
    recorder.sample()
    flags.append(watch.poll())
  events = [e for e in pkg.flight.events(kinds=['anomaly'])
            if prefix in e['name']]
  detector = pkg.anomaly.RobustDetector(k=6.0, min_history=5)
  series = [float(v) for v in np.random.RandomState(3).normal(10, 0.3, 60)]
  series[30:34] = [200.0] * 4
  detector_flags = [detector.observe(v) for v in series]
  report = watch.report()
  report.pop('flagged')
  return flags, events, detector_flags, report


def test_anomaly_flags_are_equal(clock):
  prefix = _prefix('anomaly')
  jax_run, port_run = (_anomaly_drive(pkg, prefix, clock) for pkg in BOTH)
  for jax_part, port_part in zip(jax_run, port_run):
    assert jax_part == port_part
  flags, events, detector_flags, _ = port_run
  flagged_at = [i for i, f in enumerate(flags) if f]
  assert flagged_at and flagged_at[0] == 14
  assert flagged_at == [14, 15, 16, 17, 18, 19, 25]
  assert {r['series'] for f in flags for r in f} == {
      f'{prefix}/latency_ms:p99', f'{prefix}/latency_ms:mean',
      f'{prefix}/queue_depth'}
  assert len(events) == sum(len(f) for f in flags)
  assert [i for i, f in enumerate(detector_flags) if f] == [30, 31, 32, 33]
  for pkg in BOTH:
    with pytest.raises(ValueError):
      pkg.anomaly.parse_spec('m:p42')
    assert pkg.anomaly.parse_spec('m') == ('m', 'value')


# --------------------------------------------------------------- tracing


TRACEPARENTS = [
    '00-' + 'a' * 32 + '-' + 'b' * 16 + '-01',
    ' 01-' + '0123456789abcdef' * 2 + '-' + 'fedcba9876543210' + '-00 ',
    '00-' + 'a' * 32 + '-' + 'b' * 16,
    '00-' + '0' * 32 + '-' + 'b' * 16 + '-01',
    '00-' + 'a' * 32 + '-' + '0' * 16 + '-01',
    '00-' + 'a' * 31 + '-' + 'b' * 16 + '-01',
    '00-' + 'g' * 32 + '-' + 'b' * 16 + '-01',
    '00-' + 'a' * 32 + '-' + 'b' * 15 + '-01',
    '00-' + 'a' * 32, 'garbage', '', None, '---',
]


def test_traceparent_round_trips_and_malformed_headers_match():
  for header in TRACEPARENTS:
    parsed = [pkg.tracing.parse_traceparent(header) for pkg in BOTH]
    assert (None if parsed[0] is None else tuple(parsed[0])) == (
        None if parsed[1] is None else tuple(parsed[1])), header
    if parsed[1] is not None:
      formatted = [pkg.tracing.format_traceparent(p)
                   for pkg, p in zip(BOTH, parsed)]
      assert formatted[0] == formatted[1]
      assert tracing.parse_traceparent(formatted[1]) == parsed[1]
  assert sum(tracing.parse_traceparent(h) is not None
             for h in TRACEPARENTS) == 3
  ctx = tracing.TraceContext(tracing.mint_trace_id(), tracing.mint_span_id())
  child = ctx.child()
  assert child.trace_id == ctx.trace_id and child.span_id != ctx.span_id
  assert len(ctx.trace_id) == 32 and len(ctx.span_id) == 16


def _record_fleet_spans(pkg, trace_id, clock, service):
  """A balancer proxy span, two attempts and a replica's request spans,
  with fixed ids, recorded under ``service``."""
  pkg.tracing.span_index().clear()
  t0 = clock()
  pkg.tracing.record_span('balancer/proxy', 'balancer', trace_id,
                          'p' * 16, 'c' * 16, t0, t0 + 0.05,
                          request_id='req-1', detail='status=200',
                          service_label=f'{service}-lb')
  pkg.tracing.record_spans([
      {'trace_id': trace_id, 'span_id': 'a' * 16, 'parent_id': 'p' * 16,
       'name': 'balancer/attempt', 'kind': 'balancer', 'start': t0 + 0.001,
       'end': t0 + 0.002, 'request_id': 'req-1',
       'detail': 'error=ConnectionRefusedError'},
      {'trace_id': trace_id, 'span_id': 'd' * 16, 'parent_id': 'p' * 16,
       'name': 'balancer/attempt', 'kind': 'balancer', 'start': t0 + 0.003,
       'end': t0 + 0.049, 'request_id': 'req-1', 'detail': 'status=200'},
      {'trace_id': trace_id, 'span_id': 'e' * 16, 'parent_id': 'd' * 16,
       'name': 'server/request', 'kind': 'server', 'start': t0 + 0.004,
       'end': t0 + 0.048, 'request_id': 'req-1', 'detail': 'status=200'},
      {'trace_id': 'f' * 32, 'span_id': '1' * 16, 'parent_id': '2' * 16,
       'name': 'other', 'kind': 'server', 'start': t0 - 900.0,
       'end': t0 - 899.0, 'request_id': 'req-2', 'detail': ''},
  ], service_label=service)


def test_span_index_tracez_and_assembled_traces_match(clock):
  trace_id = '3' * 32
  docs, assembled = [], []
  for pkg in BOTH:
    clock.rewind()
    previous = pkg.tracing.service()
    pkg.tracing.set_service('replica-1')
    try:
      _record_fleet_spans(pkg, trace_id, clock, 'replica-1')
      doc = pkg.tracing.tracez_document(trace_id=trace_id)
      docs.append((doc, pkg.tracing.tracez_document(probe_only=True),
                   pkg.tracing.spans(request_id='req-2'),
                   pkg.tracing.spans(last_secs=60.0)))
      processes = [{'endpoint': 'lb:1', 'service': 'lb', 'offset': 0.0,
                    'error_bound': 0.0, 'spans': doc['spans']},
                   {'endpoint': 'replica:2', 'service': 'replica',
                    'offset': 0.01, 'error_bound': 0.02,
                    'spans': doc['spans']}]
      assert assemble_trace.resolve_trace_id(processes, 'req-1') == trace_id
      assembled.append(assemble_trace.assemble(processes, trace_id))
    finally:
      pkg.tracing.span_index().clear()
      pkg.tracing.set_service(previous)
  assert docs[0] == docs[1]
  assert len(docs[1][0]['spans']) == 4 and len(docs[1][3]) == 4
  assert assembled[0] == assembled[1]
  assert not assemble_trace.causal_violations(assembled[1])
  assert 'balancer/attempt' in assemble_trace.render_text(assembled[1])


def test_span_index_ring_is_bounded_alike():
  for pkg in BOTH:
    index = pkg.tracing.SpanIndex(capacity=3)
    for i in range(5):
      index.record({'trace_id': 't', 'span_id': str(i), 'end': 0.0,
                    'request_id': f'r{i % 2}'})
    assert [s['span_id'] for s in index.spans()] == ['2', '3', '4']
    assert [s['span_id'] for s in index.spans(request_id='r0')] == ['2',
                                                                    '4']
    assert index.recorded == 5


def test_chrome_traces_read_alike_by_the_tools(clock, tmp_path):
  prefix = _prefix('chrome')
  rows, traces = [], []
  for n, pkg in enumerate(BOTH):
    clock.rewind()
    with pkg.tracing.capture(max_events=5) as events:
      for i in range(3):
        with pkg.tracing.span(f'{prefix}/step'):
          clock.advance(0.004)
          with pkg.tracing.span(f'{prefix}/step/decode'):
            clock.advance(0.001 * (i + 1))
          clock.advance(0.0005)
        clock.advance(0.0005)  # spans that touch would nest by rounding
      with pkg.tracing.span(f'{prefix}/overflow'):
        clock.advance(0.001)
    assert pkg.tracing.chrome_trace(events)['metadata']['dropped_events'] \
        == 2
    path = pkg.tracing.dump_chrome_trace(str(tmp_path / f'{n}.json.gz'),
                                         events)
    loaded = trace_summary.load_events(path)
    traces.append([(e['name'], round(e['dur'], 3)) for e in loaded])
    rows.append([{k: round(v, 6) if isinstance(v, float) else v
                  for k, v in row.items()}
                 for row in trace_summary.summarize(loaded)])
  assert traces[0] == traces[1]
  assert rows[0] == rows[1]
  assert {r['name']: r['count'] for r in rows[1]} == {
      f'{prefix}/step': 2, f'{prefix}/step/decode': 3}
  assert not tracing.capturing()
  with tracing.step_annotation(3):
    pass


# ------------------------------------------------------------ postmortem


def test_postmortem_bundles_render_alike(clock, tmp_path):
  prefix = _prefix('pm')
  summaries, texts = [], []
  for n, pkg in enumerate(BOTH):
    pkg.postmortem._reset_rate_limit_for_tests()  # pylint: disable=protected-access
    clock.rewind()
    clock.advance(3600.0)  # past every earlier event's window
    pkg.flight.event('checkpoint', f'{prefix}/commit', 'step=11')
    with pkg.tracing.span(f'{prefix}/slow_span'):
      clock.advance(0.02)
    pkg.postmortem.note_breakdown_window({'wall_ms': 12.0, 'host_ms': 3})
    directory = str(tmp_path / str(n))
    assert pkg.postmortem.dump(None, 'nowhere') is None
    path = pkg.postmortem.dump(directory, 'slo_burn_x', live=True,
                               error=RuntimeError('burning'),
                               extra={'slo': {'alerting': True}},
                               window_secs=60.0)
    assert path is not None
    # Rate-limited per (directory, reason).
    assert pkg.postmortem.dump(directory, 'slo_burn_x', live=True) is None
    assert pkg.postmortem.dump(directory, 'other', live=True) is not None
    bundle = postmortem_tool.load_bundle(postmortem_tool.find_bundle(path))
    summary = postmortem_tool.summarize(bundle)
    summary['timeline'] = [e for e in summary['timeline']
                           if prefix in e['name']]
    summary['slowest_spans'] = [s for s in summary['slowest_spans']
                                if prefix in s['name']]
    for key in ('pid', 'event_count', 'metric_deltas'):
      summary.pop(key)
    summaries.append(summary)
    texts.append(postmortem_tool.render(bundle, path))
    assert sorted(bundle) == sorted(
        ['kind', 'version', 'reason', 'live', 'exit_code', 'time', 'pid',
         'window_secs', 'error', 'topology', 'events', 'breakdown_windows',
         'timeseries', 'metrics_report', 'extra'])
  assert summaries[0] == summaries[1]
  assert summaries[1]['live'] is True
  assert summaries[1]['error'] == {'type': 'RuntimeError',
                                   'message': 'burning'}
  assert [s['name'] for s in summaries[1]['slowest_spans']] == [
      f'{prefix}/slow_span']
  assert all('live forensics bundle' in t for t in texts)


# ---------------------------------------------------------------- memory


def test_device_memory_stats_are_none_on_the_cpu():
  for pkg in BOTH:
    assert pkg.memory.device_memory_stats() is None
    assert pkg.memory.record_memory_gauges() == {}
  assert memory.device_memory_stats('cpu') is None
  before = metrics.counter('device/memory/page_event_samples').value
  assert memory.sample_page_event() == {}
  assert metrics.counter('device/memory/page_event_samples').value == (
      before + 1)
