"""The port's load generator on the CPU, held to the JAX package's.

``poisson_arrivals``, ``rate_multiplier`` and ``Reservoir`` give identical
arrivals and summaries from the same seed; ``run_open_loop`` assigns the
same priority classes from the same seed; open-loop latency includes the
scheduling lag; sheds count apart from errors, and a cooperative
best-effort client resubmits after ``Retry-After``. No test depends on the
host's speed beyond a service that sleeps. About 14 s alone (imports
included).
"""

import json
import time

import numpy as np
import pytest

from tensor2robot_tpu.serving import loadgen as jax_loadgen
from tensor2robot_tpu_torch.predictors import CheckpointPredictor
from tensor2robot_tpu_torch.serving import loadgen
from tensor2robot_tpu_torch.utils.mocks import MockT2RModel

ARRIVALS = [
    dict(rate_rps=100.0, duration_secs=2.0, seed=7),
    dict(rate_rps=50.0, duration_secs=2.0, seed=1, burst_factor=4.0,
         burst_period_secs=0.5, burst_duty=0.5),
    dict(rate_rps=100.0, duration_secs=2.0, seed=2, rate_trace=[0.1, 2.0]),
    dict(rate_rps=100.0, duration_secs=2.0, seed=2, rate_trace=[0.0, 1.0]),
    dict(rate_rps=3000.0, duration_secs=1.0, seed=9,
         rate_trace=[1.0, 0.5, 2.0, 0.0, 1.5]),
]


@pytest.mark.parametrize('kwargs', ARRIVALS)
def test_poisson_arrivals_are_identical(kwargs):
  want = jax_loadgen.poisson_arrivals(**kwargs)
  got = loadgen.poisson_arrivals(**kwargs)
  assert got == want
  assert got == sorted(got)
  assert all(0.0 <= t < kwargs['duration_secs'] for t in got)


def test_poisson_arrival_shapes():
  base = loadgen.poisson_arrivals(50.0, 2.0, seed=1)
  burst = loadgen.poisson_arrivals(50.0, 2.0, seed=1, burst_factor=4.0,
                                   burst_period_secs=0.5, burst_duty=0.5)
  assert len(burst) > 1.5 * len(base)
  quiet_first = loadgen.poisson_arrivals(100.0, 2.0, seed=2,
                                         rate_trace=[0.0, 1.0])
  assert quiet_first and all(t >= 1.0 for t in quiet_first)
  with pytest.raises(ValueError):
    loadgen.poisson_arrivals(0.0, 1.0)


def test_rate_multiplier_is_identical():
  for t in np.linspace(0.0, 3.0, 61):
    for kwargs in (dict(), dict(burst_factor=3.0, burst_period_secs=0.7,
                                burst_duty=0.3),
                   dict(rate_trace=[0.5, 1.0, 2.0, 0.0]),
                   dict(burst_factor=2.0, burst_period_secs=1.0,
                        rate_trace=[1.0, 3.0])):
      assert (loadgen.rate_multiplier(float(t), 3.0, **kwargs) ==
              jax_loadgen.rate_multiplier(float(t), 3.0, **kwargs))


@pytest.mark.parametrize('capacity,count', [(8, 4), (64, 100_000),
                                            (1000, 5000)])
def test_reservoir_summaries_are_identical(capacity, count):
  values = np.random.RandomState(capacity).lognormal(2.0, 1.0, count)
  reservoirs = [pkg.Reservoir(capacity=capacity, seed=3)
                for pkg in (jax_loadgen, loadgen)]
  for value in values:
    for reservoir in reservoirs:
      reservoir.add(float(value))
  want, got = (r.summary() for r in reservoirs)
  assert got == want
  assert got['count'] == count and len(reservoirs[1]._samples) == min(  # pylint: disable=protected-access
      capacity, count)
  assert got['max'] == float(values.max())
  assert (reservoirs[1].percentile(0.9) == reservoirs[0].percentile(0.9))


def test_empty_reservoir_and_report_documents():
  assert loadgen.Reservoir().summary() == jax_loadgen.Reservoir().summary()
  fields = dict(clients=2, requests=10, errors=0, duration_s=1.23456,
                actions_per_sec=8.111, latency_ms_p50=1.005,
                latency_ms_p99=2.0, latency_ms_mean=1.5)
  assert (loadgen.LoadReport(**fields).as_dict() ==
          jax_loadgen.LoadReport(**fields).as_dict())


def _classes_seen(pkg):
  seen = {}

  def submit(index, features, priority):
    del features
    seen[index] = priority
    return {}

  report = pkg.run_open_loop(submit, lambda i: {}, rate_rps=400.0,
                             duration_secs=0.25, workers=8, seed=4,
                             best_effort_fraction=0.3, warmup_requests=0)
  return seen, report


def test_open_loop_assigns_the_same_classes_from_the_seed():
  (jax_seen, jax_report), (seen, report) = (_classes_seen(pkg) for pkg in
                                            (jax_loadgen, loadgen))
  assert seen == jax_seen
  assert report.arrivals == jax_report.arrivals == len(seen)
  for name in ('interactive', 'best_effort'):
    assert (report.classes[name]['arrivals'] ==
            jax_report.classes[name]['arrivals'])
  assert set(report.as_dict()) == set(jax_report.as_dict())


def test_open_loop_latency_includes_scheduling_lag():
  """One worker and a 20 ms service at 10x its capacity: the latencies
  carry the backlog, not the service."""

  def submit(index, features, priority):
    del index, features, priority
    time.sleep(0.02)
    return {}

  report = loadgen.run_open_loop(
      submit, lambda i: {}, rate_rps=200.0, duration_secs=0.4,
      workers=1, seed=5, warmup_requests=0)
  assert report.arrivals > 30
  assert report.errors == 0 and report.shed == 0
  assert report.latency_ms_p99 > 100.0
  assert report.latency_ms_max >= report.latency_ms_p99


def test_open_loop_counts_sheds_apart_from_errors():
  calls = []

  def submit(index, features, priority):
    del features
    calls.append(priority)
    if priority == 'best_effort':
      raise loadgen.ShedError('shed')
    if index % 11 == 5:
      raise RuntimeError('dispatch failed')
    return {}

  report = loadgen.run_open_loop(
      submit, lambda i: {}, rate_rps=300.0, duration_secs=0.3,
      workers=4, seed=9, best_effort_fraction=0.5, warmup_requests=0)
  assert report.shed > 0 and report.errors > 0
  assert report.classes['best_effort']['shed'] == report.shed
  assert report.classes['best_effort']['errors'] == 0
  assert report.classes['interactive']['errors'] == report.errors
  assert report.ok + report.shed + report.errors == report.arrivals
  assert report.resubmitted == 0  # a shed without Retry-After is terminal


def test_best_effort_resubmits_after_retry_after():
  attempts = {}

  def submit(index, features, priority):
    del features
    attempts[index] = attempts.get(index, 0) + 1
    if priority == 'best_effort' and attempts[index] == 1:
      raise loadgen.ShedError('shed', retry_after_secs=0.01)
    return {}

  report = loadgen.run_open_loop(
      submit, lambda i: {}, rate_rps=200.0, duration_secs=0.5, workers=4,
      seed=2, best_effort_fraction=1.0, warmup_requests=0)
  assert report.resubmitted > 0
  assert report.ok + report.shed == report.arrivals
  assert report.ok >= report.resubmitted


def test_closed_loop_and_serial_baseline_over_the_batcher():
  from tensor2robot_tpu_torch.serving import DynamicBatcher  # pylint: disable=import-outside-toplevel
  import torch  # pylint: disable=import-outside-toplevel

  predictor = CheckpointPredictor(MockT2RModel(), device='cpu')
  predictor.init_randomly(torch.Generator().manual_seed(0))
  features = {'measured_position': np.full((1, 2), 0.3, np.float32)}
  with DynamicBatcher(predictor, max_batch=8,
                      batch_deadline_ms=1.0) as batcher:
    report = loadgen.run_load(loadgen.inproc_submit_fn(batcher),
                              lambda c: features, num_clients=4,
                              requests_per_client=5)
  assert report.requests == 20 and report.errors == 0
  assert report.actions_per_sec > 0
  with pytest.raises(ValueError):
    loadgen.run_load(lambda f: f, lambda c: features, num_clients=1)
  assert loadgen.serial_baseline(predictor, features,
                                 duration_secs=0.05) > 0


def test_http_submit_takes_encoded_bodies_names_and_priorities():
  import torch  # pylint: disable=import-outside-toplevel

  from tensor2robot_tpu_torch.serving import router, server  # pylint: disable=import-outside-toplevel

  predictors = {}
  for name, seed in (('a', 0), ('b', 1)):
    predictors[name] = CheckpointPredictor(MockT2RModel(), device='cpu')
    predictors[name].init_randomly(torch.Generator().manual_seed(seed))
  features = {'measured_position': np.full((1, 2), 0.4, np.float32)}
  body = loadgen.encode_request(features)
  assert json.loads(body) == {'features': {'measured_position': [[
      0.4000000059604645, 0.4000000059604645]]}}
  routed = router.ModelRouter(predictors, max_batch=4, batch_deadline_ms=1.0,
                              metrics_prefix='serving/loadgen_http',
                              register_report=False)
  with server.ServingServer(router=routed,
                            timeseries_interval_secs=0) as front:
    submit = loadgen.http_open_submit_fn(
        '127.0.0.1', front.port, model_fn=router.round_robin_models(
            ['a', 'b']))
    for index in range(4):
      got = submit(index, body if index % 2 else features, 'best_effort')
      want = predictors['ab'[index % 2]].predict(features)
      np.testing.assert_array_equal(
          np.asarray(got['a_predicted'], np.float32), want['a_predicted'])
    report = routed.report()
  assert report['classes']['best_effort']['ok'] == 4
  assert report['models']['b']['requests'] == 2
