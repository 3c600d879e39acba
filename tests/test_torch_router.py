"""The port's router and balancer on the CPU, and a subprocess drill of
the serving binaries.

* Router admission sheds best-effort before interactive, and LRU paging
  under a byte budget pages the same models in the same order as the JAX
  ``ModelRouter`` on the same request sequence (page events and shed
  counts compared, gated predictors for admission); no budget keeps every
  model resident; paging keeps the warmed buckets (``serving/
  bucket_compiles`` flat).
* The balancer: least-outstanding spread with ``X-Request-Id`` echoed,
  ejection, failover and readmission, the probed initial health,
  quarantine, and all backends down -> 503 with ``Retry-After``.
* One drill of ``run_serving`` x2 (one in router mode) behind
  ``run_balancer``, each a subprocess on the CPU: a SIGTERM'd replica
  drains and exits 0, no client request fails, and the replica restarted
  on its port is readmitted. The drill asserts only what must hold; it
  does not require the shed counter to move under bursts.

About 55 s alone (imports included), 25 s of it the drill's subprocesses.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch_serving_fixtures import one_thread  # an autouse fixture

from tensor2robot_tpu import quantize as jax_quant
from tensor2robot_tpu.observability import flight as jax_flight
from tensor2robot_tpu.predictors import AbstractPredictor as JaxAbstract
from tensor2robot_tpu.predictors import (
    CheckpointPredictor as JaxCheckpointPredictor)
from tensor2robot_tpu.serving import batching as jax_batching
from tensor2robot_tpu.serving import router as jax_router
from tensor2robot_tpu.specs import SpecStruct as JaxSpecStruct
from tensor2robot_tpu.specs import TensorSpec as JaxTensorSpec
from tensor2robot_tpu.utils.mocks import MockT2RModel as JaxMockT2RModel
from tensor2robot_tpu_torch.export import exporters
from tensor2robot_tpu_torch.observability import flight
from tensor2robot_tpu_torch.observability import metrics as metrics_lib
from tensor2robot_tpu_torch.predictors import (AbstractPredictor,
                                               CheckpointPredictor)
from tensor2robot_tpu_torch.serving import balancer as balancer_lib
from tensor2robot_tpu_torch.serving import batching, loadgen, router, server
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec
from tensor2robot_tpu_torch.utils.mocks import MockT2RModel

REPO = pathlib.Path(__file__).resolve().parents[1]

JAX = types.SimpleNamespace(batching=jax_batching, router=jax_router,
                            flight=jax_flight, Abstract=JaxAbstract,
                            SpecStruct=JaxSpecStruct,
                            TensorSpec=JaxTensorSpec)
PORT = types.SimpleNamespace(batching=batching, router=router, flight=flight,
                             Abstract=AbstractPredictor,
                             SpecStruct=SpecStruct, TensorSpec=TensorSpec)


def _gated(pkg, release):
  """A callable predictor whose dispatch waits on ``release``."""

  class Gated(pkg.Abstract):

    def predict(self, features):
      release.wait(timeout=30.0)
      return {'echo': np.asarray(features['x'])}

    def get_feature_specification(self):
      spec = pkg.SpecStruct()
      spec['x'] = pkg.TensorSpec(shape=(2,), dtype=np.float32, name='x')
      return spec

    def restore(self):
      return True

    @property
    def is_loaded(self):
      return True

    @property
    def global_step(self):
      return 1

  return Gated()


def _x(value=0.0):
  return {'x': np.full((1, 2), value, np.float32)}


def _features(value, n=1):
  return {'measured_position': np.full((n, 2), value, np.float32)}


def _loaded_predictor(seed=0, hidden_size=16):
  predictor = CheckpointPredictor(MockT2RModel(hidden_size=hidden_size),
                                  device='cpu')
  predictor.init_randomly(torch.Generator().manual_seed(seed))
  return predictor


def _jax_loaded_predictor():
  predictor = JaxCheckpointPredictor(JaxMockT2RModel(device_type='tpu'),
                                     model_dir='/nonexistent')
  predictor.init_randomly()
  return predictor


# --------------------------------------------------------------- admission


def _admission_run(pkg, prefix):
  """Outcomes of a fixed sequence against a held backlog: the priority
  class, and 'ok' / 'shed' / 'full' / 'bad' for each submit."""
  release = threading.Event()
  routed = pkg.router.ModelRouter(
      {'m': _gated(pkg, release)}, max_batch=1, batch_deadline_ms=1.0,
      max_queue=6, shed_queue_fraction=0.34, retry_after_secs=3.0,
      metrics_prefix=prefix, register_report=False)
  outcomes, futures = [], []
  sequence = (['interactive'] + ['best_effort'] * 2 + ['interactive'] * 3
              + ['best_effort', 'interactive', 'interactive',
                 'interactive', 'best_effort', 'platinum'])
  with routed:
    batcher = routed.batcher('m')
    try:
      for i, priority in enumerate(sequence):
        try:
          futures.append(routed.submit(_x(i), priority=priority))
          outcomes.append((priority, 'ok'))
        except pkg.batching.SheddedError as e:
          outcomes.append((priority, f'shed:{e.retry_after_secs}'))
        except pkg.batching.OverloadedError:
          outcomes.append((priority, 'full'))
        except pkg.batching.RequestError:
          outcomes.append((priority, 'bad'))
        if i == 0:  # the first request in flight, the rest queue
          deadline = time.monotonic() + 10.0
          while batcher.queue_depth and time.monotonic() < deadline:
            time.sleep(0.005)
          time.sleep(0.05)
    finally:
      release.set()
    for future in futures:
      future.result(30.0)
    report = routed.report()
  events = [e['detail'] for e in pkg.flight.events(kinds=['router'])
            if e['name'] == f'{prefix}/shed']
  classes = {name: {k: v for k, v in counts.items()
                    if not k.startswith('latency')}
             for name, counts in report['classes'].items()}
  return outcomes, classes, report['shed_requests'], events


def test_admission_sheds_best_effort_first_as_the_jax_router_does():
  jax_run = _admission_run(JAX, 'serving/adm_jax')
  port_run = _admission_run(PORT, 'serving/adm_port')
  assert port_run == jax_run
  outcomes, classes, shed, _ = port_run
  # shed_at = round(0.34 * 6) = 2 queued requests; the hard bound is 6.
  assert outcomes == [
      ('interactive', 'ok'), ('best_effort', 'ok'), ('best_effort', 'ok'),
      ('interactive', 'ok'), ('interactive', 'ok'), ('interactive', 'ok'),
      ('best_effort', 'shed:3.0'), ('interactive', 'ok'),
      ('interactive', 'full'), ('interactive', 'full'),
      ('best_effort', 'shed:3.0'), ('platinum', 'bad')]
  assert shed == 2 and classes['interactive']['shed'] == 0
  assert classes['interactive']['ok'] == 5
  assert classes['best_effort']['ok'] == 2


# ------------------------------------------------------------------ paging


def _param_bytes(pkg, predictor):
  params = predictor.stateless_serving_fn().params
  if pkg is JAX:
    return jax_quant.param_bytes(params)
  return sum(v.numel() * v.element_size() for v in params.values())


def _paging_run(pkg, prefix, predictors, budget_models):
  per_model = _param_bytes(pkg, predictors['m0'])
  budget = (None if budget_models is None
            else budget_models * per_model + per_model // 2)
  routed = pkg.router.ModelRouter(
      predictors, hbm_budget_bytes=budget, max_batch=4,
      batch_deadline_ms=1.0, metrics_prefix=prefix, register_report=False)
  resident, shapes = [], []
  with routed:
    resident.append(routed.resident_models())
    for i in range(12):
      model = f'm{(i * 5 + i // 4) % 3}'
      out = routed.submit(_features(0.1 * i, n=1 + i % 3),
                          model=model).result(30.0)
      shapes.append(out['a_predicted'].shape)
      resident.append(routed.resident_models())
    routed.set_hbm_budget(None if budget is None else per_model)
    resident.append(routed.resident_models())
    report = routed.report()
  events = [(e['name'].replace(prefix, ''), e['detail'].split(' ')[0])
            for e in pkg.flight.events(kinds=['router'])
            if e['name'].startswith(prefix + '/')
            and not e['name'].endswith('budget_resplit')]
  return (resident, shapes, events,
          (report['budget_overruns'], report['models_resident']))


@pytest.mark.parametrize('budget_models', [2, 1, None])
def test_lru_paging_order_matches_the_jax_router(budget_models):
  jax_run = _paging_run(JAX, f'serving/lru_jax{budget_models}',
                        {f'm{i}': _jax_loaded_predictor() for i in range(3)},
                        budget_models)
  compiles = metrics_lib.counter('serving/bucket_compiles')
  port_predictors = {f'm{i}': _loaded_predictor(seed=i) for i in range(3)}
  start = compiles.value
  port_run = _paging_run(PORT, f'serving/lru_port{budget_models}',
                         port_predictors, budget_models)
  assert port_run == jax_run
  resident, _, events, _ = port_run
  if budget_models is None:
    assert all(r == ['m0', 'm1', 'm2'] for r in resident) and not events
  else:
    assert all(len(r) == budget_models for r in resident[:-1])
    assert any(name.endswith('/page_in') for name, _ in events)
  # Three models' buckets (1, 2, 4) warmed once; paging never rebuilds.
  assert compiles.value - start == 9


def test_paged_models_answer_as_their_predictors():
  preds = {f'm{i}': _loaded_predictor(seed=i, hidden_size=8 * (i + 1))
           for i in range(3)}
  per_model = max(_param_bytes(PORT, p) for p in preds.values())
  with router.ModelRouter(preds, hbm_budget_bytes=per_model + 1,
                          max_batch=4, batch_deadline_ms=1.0,
                          metrics_prefix='serving/paged_answers',
                          register_report=False) as routed:
    for i in range(6):
      got = routed.submit(_features(0.3), model=f'm{i % 3}').result(30.0)
      want = preds[f'm{i % 3}'].predict(_features(0.3))
      np.testing.assert_array_equal(got['a_predicted'],
                                    want['a_predicted'])
    assert len(routed.resident_models()) == 1
    with pytest.raises(batching.RequestError):
      routed.submit(_features(0.1), model='nope')
  with pytest.raises(ValueError):
    router.ModelRouter({'a/b': preds['m0']})


# ---------------------------------------------------------------- balancer


def _replica(prefix, port=0, seed=0):
  return server.ServingServer(
      _loaded_predictor(seed=seed), port=port, max_batch=8,
      batch_deadline_ms=1.0, metrics_prefix=prefix, register_report=False,
      timeseries_interval_secs=0).start()


def _post(url_port, path, body, headers=None):
  import http.client  # pylint: disable=import-outside-toplevel

  conn = http.client.HTTPConnection('127.0.0.1', url_port, timeout=30)
  try:
    conn.request('POST', path, body=json.dumps(body).encode(),
                 headers=dict({'Content-Type': 'application/json'},
                              **(headers or {})))
    response = conn.getresponse()
    return (response.status, json.loads(response.read()),
            dict(response.getheaders()))
  finally:
    conn.close()


def test_least_outstanding_spreads_and_echoes_request_id():
  s1, s2 = _replica('serving/bal_r0'), _replica('serving/bal_r1')
  try:
    with balancer_lib.Balancer([('127.0.0.1', s1.port),
                                f'127.0.0.1:{s2.port}'],
                               register_report=False) as bal:
      status, body, headers = _post(
          bal.port, '/v1/predict',
          {'features': {'measured_position': [[0.1, 0.2]]}},
          {'X-Request-Id': 'fleet-7'})
      assert status == 200 and body['request_id'] == 'fleet-7'
      assert headers['X-Request-Id'] == 'fleet-7'
      status, _, headers = _post(bal.port, '/v1/bogus', {},
                                 {'X-Request-Id': 'fleet-8'})
      assert status == 404 and headers['X-Request-Id'] == 'fleet-8'
      status, body, headers = _post(bal.port, '/v1/predict',
                                    {'measured_position': [0.1, 0.2]})
      assert status == 200 and headers['X-Request-Id'].startswith('lb')
      report = loadgen.run_load(
          loadgen.http_submit_fn('127.0.0.1', bal.port),
          lambda i: _features(0.01 * (i + 1)), num_clients=8,
          requests_per_client=10)
      assert report.errors == 0
      statz = bal.report()
      assert statz['backends_healthy'] == 2
      assert all(b['proxied'] > 0 for b in statz['backends'])
  finally:
    s1.close()
    s2.close()


def test_ejection_failover_and_readmission():
  s1, s2 = _replica('serving/ej_r0'), _replica('serving/ej_r1')
  port2 = s2.port
  ejections = metrics_lib.counter('balancer/ejections')
  readmissions = metrics_lib.counter('balancer/readmissions')
  e0, r0 = ejections.value, readmissions.value
  try:
    with balancer_lib.Balancer(
        [('127.0.0.1', s1.port), ('127.0.0.1', port2)],
        health_interval_secs=0.1, eject_after=2, readmit_after=1,
        register_report=False) as bal:
      submit = loadgen.http_submit_fn('127.0.0.1', bal.port)
      submit(_features(0.1))
      s2.close()
      for i in range(20):  # transport failures fail over
        submit(_features(0.01 * (i + 1)))
      deadline = time.monotonic() + 10.0
      while bal.healthy_backend_count() > 1 and time.monotonic() < deadline:
        time.sleep(0.05)
      assert bal.healthy_backend_count() == 1 and ejections.value > e0
      s2 = _replica('serving/ej_r2', port=port2)
      assert balancer_lib.wait_healthy(bal, 2, timeout_secs=10.0)
      assert readmissions.value > r0
      for i in range(8):
        submit(_features(0.01 * (i + 1)))
      # A quarantined backend stays out however clean its probes.
      assert bal.quarantine(1, reason='test')
      time.sleep(0.3)
      assert bal.healthy_backend_count() == 1
      assert not bal.quarantine(0)  # the last healthy one: refused
      assert bal.readmit(1) and bal.healthy_backend_count() == 2
  finally:
    s1.close()
    s2.close()


def test_initial_health_is_probed_not_assumed():
  placeholder = _replica('serving/boot_r0')
  port = placeholder.port
  placeholder.close()
  with balancer_lib.Balancer([('127.0.0.1', port)],
                             health_interval_secs=0.1, readmit_after=1,
                             register_report=False) as bal:
    assert bal.healthy_backend_count() == 0
    replica = _replica('serving/boot_r1', port=port)
    try:
      assert balancer_lib.wait_healthy(bal, 1, timeout_secs=10.0)
      loadgen.http_submit_fn('127.0.0.1', bal.port)(_features(0.2))
    finally:
      replica.close()


def test_all_backends_down_is_503_with_retry_after():
  s1 = _replica('serving/down_r0')
  with balancer_lib.Balancer([('127.0.0.1', s1.port)],
                             health_interval_secs=0.1, eject_after=1,
                             register_report=False) as bal:
    s1.close()
    deadline = time.monotonic() + 10.0
    while bal.healthy_backend_count() and time.monotonic() < deadline:
      time.sleep(0.05)
    status, body, headers = _post(bal.port, '/v1/predict',
                                  {'measured_position': [0.1, 0.2]},
                                  {'X-Request-Id': 'doomed-1'})
    assert status == 503 and headers.get('Retry-After')
    assert headers['X-Request-Id'] == 'doomed-1' and 'error' in body
    with pytest.raises(loadgen.ShedError):
      loadgen.http_submit_fn('127.0.0.1', bal.port)(_features(0.2))


# ------------------------------------------------------------------ drill


def _spawn(args, log_path, children):
  """Starts a subprocess of this repo's code on the CPU (appended to
  ``children``)."""
  env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES='')
  log = open(log_path, 'a')  # pylint: disable=consider-using-with
  process = subprocess.Popen([sys.executable, '-m'] + args, cwd=REPO,
                             stdout=subprocess.PIPE, stderr=log, text=True,
                             env=env)
  process.log = log
  process.log_path = log_path
  children.append(process)
  return process


def _ready(process):
  """The ready document the process prints once it listens."""
  line = process.stdout.readline()
  if not line:
    process.wait(timeout=30)
    process.log.flush()
    raise AssertionError(
        f'exit {process.returncode}:\n'
        f'{pathlib.Path(process.log_path).read_text()[-3000:]}')
  return json.loads(line)


def _export_mock(root, seed):
  model = MockT2RModel()
  predictor = _loaded_predictor(seed=seed)
  return exporters.ModelExporter().export(
      model, exporters.ServingState(1, predictor.network.state_dict()),
      str(root), version=1)


def _statz(port):
  import urllib.request  # pylint: disable=import-outside-toplevel

  with urllib.request.urlopen(f'http://127.0.0.1:{port}/statz',
                              timeout=10) as response:
    return json.loads(response.read())


def _wait(predicate, seconds=30.0):
  deadline = time.monotonic() + seconds
  while time.monotonic() < deadline:
    if predicate():
      return True
    time.sleep(0.05)
  return predicate()


def test_serving_binaries_drain_fail_over_and_readmit(tmp_path):
  for name, seed in (('a', 1), ('b', 2)):
    _export_mock(tmp_path / name, seed)
  common = ['--device', 'cpu', '--max-batch', '4', '--batch-deadline-ms',
            '1', '--reload-interval-secs', '0', '--port']
  single = ['tensor2robot_tpu_torch.bin.run_serving', '--export_dir',
            str(tmp_path / 'a')] + common
  routed = ['tensor2robot_tpu_torch.bin.run_serving',
            '--model', f'a={tmp_path / "a"}', '--model',
            f'b={tmp_path / "b"}'] + common + ['0']
  children = []
  failures, done = [], []
  stop = threading.Event()
  try:
    first = _spawn(single + ['0'], tmp_path / 'r1.log', children)
    second = _spawn(routed, tmp_path / 'r2.log', children)
    port1, ready2 = _ready(first)['port'], _ready(second)
    lb_ready = _ready(_spawn(
        ['tensor2robot_tpu_torch.bin.run_balancer', '--backend',
         f'127.0.0.1:{port1}', '--backend', f'127.0.0.1:{ready2["port"]}',
         '--port', '0', '--health-interval-secs', '0.25', '--eject-after',
         '3'], tmp_path / 'lb.log', children))
    assert _statz(lb_ready['port'])['backends_healthy'] == 2
    submit = loadgen.http_submit_fn('127.0.0.1', lb_ready['port'])

    def client(c):
      while not stop.is_set():
        try:
          out = submit(_features(0.1 * c))
          assert len(out['a_predicted']) == 1
          done.append(c)
        except Exception as e:  # pylint: disable=broad-except
          failures.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(4)]
    for thread in threads:
      thread.start()
    assert _wait(lambda: len(done) > 20)
    first.send_signal(signal.SIGTERM)
    assert first.wait(timeout=60) == 0
    assert _wait(lambda: _statz(lb_ready['port'])['backends_healthy'] == 1)
    served = len(done)
    assert _wait(lambda: len(done) > served + 20)
    ready = _ready(_spawn(single + [str(port1)], tmp_path / 'r1.log',
                          children))
    assert ready['port'] == port1
    assert _wait(lambda: _statz(lb_ready['port'])['backends_healthy'] == 2)
    served = len(done)
    assert _wait(lambda: len(done) > served + 20)
    stop.set()
    for thread in threads:
      thread.join(timeout=30)
    statz = _statz(lb_ready['port'])
    assert statz['ejections'] >= 1 and statz['readmissions'] >= 1
    assert _statz(ready2['port'])['models_resident'] == ['a', 'b']
    assert not failures, failures[:3]
  finally:
    stop.set()
    for child in children:
      if child.poll() is None:
        child.kill()
      child.wait(timeout=30)
      child.log.close()
