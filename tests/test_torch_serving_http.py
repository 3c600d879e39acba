"""The port's HTTP front door on the CPU, held to the JAX package's.

The same request bodies go to the JAX ``ServingServer`` over a JAX export
and to the port's over the port's export of the same seeded variables
(the float32 tiny QT-Opt config of ``tests/torch_serving_fixtures.py``).
Bars: the same status codes, ``X-Request-Id`` and ``Retry-After`` headers
and JSON keys; ``q_predicted`` within the float32 serving band of
``tests/test_torch_exported_predictor.py`` (atol 1e-6); 400, 404, 503
(shed and queue full), 504 and 500 on the same malformed, unknown, shed,
timed-out and failing requests. On the port alone: a uint8 frame sent as
JSON lists reaches the program bit for bit (q over HTTP is bit for bit the
in-process predictor's), and float32 outputs round-trip exactly.

The batcher's hooks against the JAX batcher's, under one fake clock:
``on_done``, ``trace=`` (flight lifecycle events and ``/tracez`` spans),
the slow-request log, ``metrics_prefix`` and the report; a postmortem
bundle on a broken reload and on a broken export the predictor absorbed.
About 55 s alone (imports, two exports and a JAX bucket compile in the
fixture).
"""

import http.client
import json
import os
import shutil
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch_serving_fixtures import (  # one_thread: an autouse fixture
    mock_features, one_thread, paired_qtopt_exports,
    qtopt_features, trained_mock)

from tensor2robot_tpu.observability import flight as jax_flight
from tensor2robot_tpu.observability import tracing as jax_tracing
from tensor2robot_tpu.predictors import AbstractPredictor as JaxAbstract
from tensor2robot_tpu.predictors import (
    ExportedModelPredictor as JaxExportedModelPredictor)
from tensor2robot_tpu.serving import batching as jax_batching
from tensor2robot_tpu.serving import router as jax_router
from tensor2robot_tpu.serving import server as jax_server
from tensor2robot_tpu.specs import SpecStruct as JaxSpecStruct
from tensor2robot_tpu.specs import TensorSpec as JaxTensorSpec
from tensor2robot_tpu_torch.export import exporters
from tensor2robot_tpu_torch.observability import flight, postmortem, tracing
from tensor2robot_tpu_torch.predictors import (AbstractPredictor,
                                               CheckpointPredictor,
                                               ExportedModelPredictor)
from tensor2robot_tpu_torch.serving import batching, router, server
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec
from tensor2robot_tpu_torch.utils.mocks import MockT2RModel
from tools import postmortem as postmortem_tool

BAND = 1e-6
JAX = types.SimpleNamespace(batching=jax_batching, router=jax_router,
                            server=jax_server, flight=jax_flight,
                            tracing=jax_tracing, Abstract=JaxAbstract,
                            SpecStruct=JaxSpecStruct,
                            TensorSpec=JaxTensorSpec)
PORT = types.SimpleNamespace(batching=batching, router=router, server=server,
                             flight=flight, tracing=tracing,
                             Abstract=AbstractPredictor,
                             SpecStruct=SpecStruct, TensorSpec=TensorSpec)


def _call(port, method, path, body=b'', headers=None):
  """(status, headers, JSON body) of one request on a fresh connection."""
  conn = http.client.HTTPConnection('127.0.0.1', port, timeout=60)
  try:
    conn.request(method, path, body=body, headers=dict(headers or {}))
    response = conn.getresponse()
    payload = json.loads(response.read() or b'{}')
    return response.status, dict(response.getheaders()), payload
  finally:
    conn.close()


def _json(features):
  return json.dumps({k: np.asarray(v).tolist()
                     for k, v in features.items()}).encode()


@pytest.fixture(scope='module')
def planes(tmp_path_factory):
  """Both servers over one seeded variables tree, and the port's
  in-process exported predictor."""
  root = tmp_path_factory.mktemp('http_exports')
  _, eager, jax_root, port_root = paired_qtopt_exports(root)
  jax_predictor = JaxExportedModelPredictor(jax_root)
  assert jax_predictor.restore()
  port_predictor = ExportedModelPredictor(port_root, device='cpu')
  assert port_predictor.restore()
  kwargs = dict(max_batch=4, batch_deadline_ms=1.0, register_report=False,
                timeseries_interval_secs=0)
  servers = [
      jax_server.ServingServer(jax_predictor,
                               metrics_prefix='serving/http_jax', **kwargs),
      server.ServingServer(port_predictor, metrics_prefix='serving/http_port',
                           **kwargs),
      server.ServingServer(port_predictor,
                           metrics_prefix='serving/http_decoders', **kwargs)]
  for s in servers:
    s.start()
  # The third decodes every body in decoder processes.
  servers[2]._httpd.decoders.min_bytes = 0  # pylint: disable=protected-access
  yield types.SimpleNamespace(jax=servers[0], port=servers[1],
                              decoders=servers[2], eager=eager,
                              predictor=port_predictor)
  for s in servers:
    s.close()


def _features(seed, n, batch_dim=True):
  features = qtopt_features(seed, n)
  if not batch_dim:
    features = {k: v[0] for k, v in features.items()}
  return features


def _bodies():
  good = _features(3, 3)
  missing = {k: v for k, v in good.items() if k != 'action/world_vector'}
  wrong = dict(good, **{'state/image': good['state/image'][:, :8]})
  ragged = ('{"features": {"state/image": [[1, 2], [3]], '
            '"action/world_vector": [0, 0, 0], '
            '"action/vertical_rotation": [0, 0]}}').encode()
  return [
      ('single', '/v1/predict', {'X-Request-Id': 'h-1'},
       json.dumps({'features': {k: np.asarray(v).tolist() for k, v in
                                _features(1, 1, False).items()}}).encode()),
      ('batch', '/v1/predict', {'X-Request-Id': 'h-2'},
       json.dumps({'features': {k: v.tolist()
                                for k, v in good.items()}}).encode()),
      ('bare', '/v1/predict', {}, _json(_features(5, 2))),
      ('malformed_json', '/v1/predict', {'X-Request-Id': 'h-4'},
       b'{not json'),
      ('features_not_a_dict', '/v1/predict', {}, b'{"features": [1, 2]}'),
      ('empty', '/v1/predict', {'X-Request-Id': 'h-6'}, b'{}'),
      ('missing_feature', '/v1/predict', {'X-Request-Id': 'h-7'},
       _json(missing)),
      ('wrong_shape', '/v1/predict', {}, _json(wrong)),
      ('ragged', '/v1/predict', {'X-Request-Id': 'h-9'}, ragged),
      ('too_many', '/v1/predict', {}, _json(_features(6, 5))),
      ('unknown_path', '/v1/bogus', {'X-Request-Id': 'h-11'}, b'{}'),
      ('named_model', '/v1/models/other/predict', {'X-Request-Id': 'h-12'},
       _json(good)),
      ('best_effort', '/v1/predict', {'X-Priority': 'best_effort'},
       _json(good)),
      ('traced', '/v1/predict',
       {'X-Request-Id': 'h-14',
        'traceparent': '00-' + '4' * 32 + '-' + '5' * 16 + '-01'},
       _json(_features(7, 1))),
  ]


@pytest.mark.parametrize('name,path,headers,body', _bodies(),
                         ids=[b[0] for b in _bodies()])
def test_same_status_headers_and_keys(planes, name, path, headers, body):
  headers = dict(headers, **{'Content-Type': 'application/json'})
  jax_reply = _call(planes.jax.port, 'POST', path, body, headers)
  port_reply = _call(planes.port.port, 'POST', path, body, headers)
  assert port_reply[0] == jax_reply[0], (name, jax_reply[2], port_reply[2])
  for header in ('X-Request-Id', 'Retry-After', 'Content-Type'):
    assert (header in port_reply[1]) == (header in jax_reply[1]), header
  if 'X-Request-Id' in headers:
    assert port_reply[1]['X-Request-Id'] == headers['X-Request-Id']
  assert set(port_reply[2]) == set(jax_reply[2])
  if port_reply[0] == 200:
    assert port_reply[2]['request_id'] == port_reply[1]['X-Request-Id']
    assert port_reply[2]['model_version'] == jax_reply[2]['model_version']
    assert port_reply[2]['examples'] == jax_reply[2]['examples']
    np.testing.assert_allclose(
        np.asarray(port_reply[2]['outputs']['q_predicted']),
        np.asarray(jax_reply[2]['outputs']['q_predicted']), rtol=0,
        atol=BAND)
  expected = {'single': 200, 'batch': 200, 'bare': 200, 'traced': 200,
              'unknown_path': 404, 'named_model': 404}.get(name, 400)
  assert port_reply[0] == expected


@pytest.mark.parametrize('name,path,headers,body', _bodies(),
                         ids=[b[0] for b in _bodies()])
def test_decoder_processes_answer_as_the_serving_process(planes, name, path,
                                                         headers, body):
  headers = dict(headers, **{'Content-Type': 'application/json'})
  here = _call(planes.port.port, 'POST', path, body, headers)
  there = _call(planes.decoders.port, 'POST', path, body, headers)
  assert there[0] == here[0], (name, here[2], there[2])
  for header in ('X-Request-Id', 'Retry-After', 'Content-Type'):
    assert there[1].get(header, '-') == here[1].get(header, '-') or (
        header == 'X-Request-Id' and 'X-Request-Id' not in headers)
  if 'request_id' in here[2] and 'X-Request-Id' not in headers:
    here[2].pop('request_id')
    there[2].pop('request_id')
  # Outputs, versions and error messages alike, to the bit.
  assert there[2] == here[2]


def _decoder_processes(front):
  pool = front._httpd.decoders  # pylint: disable=protected-access
  with pool._cond:  # pylint: disable=protected-access
    return list(pool._idle)  # pylint: disable=protected-access


def test_a_dead_decoder_answers_500_and_the_next_body_starts_another(planes):
  body = _json(_features(10, 1))
  status, _, want = _call(planes.decoders.port, 'POST', '/v1/predict', body)
  assert status == 200
  for process in _decoder_processes(planes.decoders):
    process.kill()
    process.wait()
  status, headers, reply = _call(planes.decoders.port, 'POST', '/v1/predict',
                                 body, {'X-Request-Id': 'dead-1'})
  assert status == 500 and headers['X-Request-Id'] == 'dead-1'
  assert 'ended before it replied' in reply['error']
  status, _, got = _call(planes.decoders.port, 'POST', '/v1/predict', body)
  assert status == 200 and got['outputs'] == want['outputs']


def test_decoder_processes_stop_with_the_server():
  predictor = _loaded_predictor()
  front = server.ServingServer(predictor, metrics_prefix='serving/stops',
                               register_report=False,
                               timeseries_interval_secs=0).start()
  front._httpd.decoders.min_bytes = 0  # pylint: disable=protected-access
  try:
    statuses = [_call(front.port, 'POST', '/v1/predict',
                      b'{"measured_position": [[0.5, 0.25]]}')[0]
                for _ in range(3)]
    processes = _decoder_processes(front)
  finally:
    front.close()
  assert statuses == [200] * 3 and processes
  assert all(p.poll() is not None for p in processes)


def test_gets_answer_alike(planes):
  for path, code in (('/healthz', 200), ('/statz', 200), ('/tracez', 200),
                     ('/tracez?probe=1', 200), ('/nope', 404)):
    jax_reply = _call(planes.jax.port, 'GET', path)
    port_reply = _call(planes.port.port, 'GET', path)
    assert port_reply[0] == jax_reply[0] == code
    if path in ('/healthz', '/nope', '/tracez', '/tracez?probe=1'):
      assert set(port_reply[2]) == set(jax_reply[2])
  statz = _call(planes.port.port, 'GET', '/statz')[2]
  jax_statz = _call(planes.jax.port, 'GET', '/statz')[2]
  assert set(statz) == set(jax_statz)
  assert statz['requests'] > 0 and statz['slow_requests']
  assert _call(planes.port.port, 'GET', '/healthz')[2] == {
      'status': 'ok', 'model_version': 3}


def test_traced_request_records_ingress_and_batcher_spans(planes):
  trace_id = '6' * 32
  headers = {'X-Request-Id': 'traced-1',
             'traceparent': f'00-{trace_id}-{"7" * 16}-01'}
  status, _, _ = _call(planes.port.port, 'POST', '/v1/predict',
                       _json(_features(8, 1)), headers)
  assert status == 200
  doc = _call(planes.port.port, 'GET', f'/tracez?trace_id={trace_id}')[2]
  names = sorted(s['name'] for s in doc['spans'])
  assert names == ['server/request', 'serving/http_port/dispatch',
                   'serving/http_port/queued', 'serving/http_port/request']
  by_name = {s['name']: s for s in doc['spans']}
  assert by_name['server/request']['parent_id'] == '7' * 16
  assert (by_name['serving/http_port/request']['parent_id'] ==
          by_name['server/request']['span_id'])
  assert {s['service'] for s in doc['spans']} == {
      f'replica-{planes.port.port}'}
  assert {s['request_id'] for s in doc['spans']} == {'traced-1'}


def test_uint8_frames_and_float32_outputs_cross_the_wire_exactly(planes):
  features = _features(9, 4)
  status, _, body = _call(planes.port.port, 'POST', '/v1/predict',
                          _json(features))
  assert status == 200
  got = np.asarray(body['outputs']['q_predicted'], dtype=np.float32)
  want = planes.predictor.predict(features)['q_predicted']
  assert want.dtype == np.float32
  np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
  np.testing.assert_array_equal(
      want, planes.eager.predict(features)['q_predicted'])
  # The wire's int64 lists are cast back to the spec's uint8, value for
  # value.
  decoded = {k: np.asarray(v) for k, v in
             json.loads(_json(features)).items()}
  assert decoded['state/image'].dtype == np.int64
  validated = planes.port.batcher._validate(decoded)  # pylint: disable=protected-access
  assert validated['state/image'].dtype == np.uint8
  np.testing.assert_array_equal(validated['state/image'],
                                features['state/image'])


# ------------------------------------------------------- 503, 504 and 500


def _gated(pkg, release, fail=False, entered=None):
  """A callable predictor whose dispatch sets ``entered`` and waits on
  ``release`` (or raises): the deterministic way to hold a backlog."""

  class Gated(pkg.Abstract):

    def predict(self, features):
      if entered is not None:
        entered.set()
      release.wait(timeout=30.0)
      if fail:
        raise RuntimeError('device lost')
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


def _post_x(port, headers=None):
  return _call(port, 'POST', '/v1/predict',
               b'{"features": {"x": [[0.5, 0.25]]}}',
               dict({'Content-Type': 'application/json'}, **(headers or {})))


def _backlog(port, count, entered, plane_queue_depth, want_depth):
  """``count`` requests on threads, the first in the dispatch (``entered``)
  before the others are sent; returns (threads, replies) once the plane's
  queue holds ``want_depth``."""
  replies = []
  threads = [threading.Thread(target=lambda: replies.append(_post_x(port)),
                              daemon=True) for _ in range(count)]
  threads[0].start()
  assert entered.wait(timeout=20.0)
  for thread in threads[1:]:
    thread.start()
  deadline = time.monotonic() + 20.0
  while plane_queue_depth() < want_depth and time.monotonic() < deadline:
    time.sleep(0.01)
  assert plane_queue_depth() >= want_depth
  return threads, replies


def _overload_replies(pkg, prefix):
  """Statuses and headers of a best-effort shed, a queue-full refusal, a
  timeout and a dispatch failure, in that order."""
  out = []
  release, entered = threading.Event(), threading.Event()
  routed = pkg.router.ModelRouter(
      {'m': _gated(pkg, release, entered=entered)}, max_batch=1,
      batch_deadline_ms=1.0,
      max_queue=3, shed_queue_fraction=0.5, retry_after_secs=2.5,
      metrics_prefix=f'{prefix}/router', register_report=False)
  with pkg.server.ServingServer(router=routed,
                                timeseries_interval_secs=0) as front:
    try:
      threads, replies = _backlog(front.port, 4, entered,
                                  lambda: routed.batcher('m').queue_depth, 3)
      out.append(_post_x(front.port, {'X-Priority': 'best_effort',
                                      'X-Request-Id': 'shed-1'}))
      out.append(_post_x(front.port, {'X-Request-Id': 'full-1'}))
      out.append(_call(front.port, 'POST', '/v1/models/nope/predict',
                       b'{"features": {"x": [[0.5, 0.25]]}}'))
      out.append(_post_x(front.port, {'X-Priority': 'platinum'}))
    finally:
      release.set()
    for thread in threads:
      thread.join(timeout=30.0)
    assert [r[0] for r in replies] == [200] * 4
  slow = threading.Event()
  with pkg.server.ServingServer(
      _gated(pkg, slow), request_timeout_secs=0.2, max_batch=1,
      metrics_prefix=f'{prefix}/timeout', register_report=False,
      timeseries_interval_secs=0) as front:
    out.append(_post_x(front.port, {'X-Request-Id': 'late-1'}))
    slow.set()
  broken = threading.Event()
  broken.set()
  with pkg.server.ServingServer(
      _gated(pkg, broken, fail=True), max_batch=1,
      metrics_prefix=f'{prefix}/failing', register_report=False,
      timeseries_interval_secs=0) as front:
    out.append(_post_x(front.port, {'X-Request-Id': 'fail-1'}))
  return out


def test_shed_full_timeout_and_failure_answer_alike():
  jax_out = _overload_replies(JAX, 'serving/over_jax')
  port_out = _overload_replies(PORT, 'serving/over_port')
  assert [r[0] for r in port_out] == [r[0] for r in jax_out] == [
      503, 503, 400, 400, 504, 500]
  for (jax_status, jax_headers, jax_body), (status, headers, body) in zip(
      jax_out, port_out):
    assert headers.get('Retry-After') == jax_headers.get('Retry-After')
    assert headers.get('X-Request-Id') == jax_headers.get('X-Request-Id')
    assert set(body) == set(jax_body)
    del jax_status, status
  assert port_out[0][1]['Retry-After'] == '3' and port_out[0][2]['shed']
  assert port_out[1][1]['Retry-After'] == '1'


# ------------------------------------------------------- the batcher hooks


class _Clock:
  """The batchers' monotonic clock (injected into the JAX batcher, patched
  over time.monotonic for the port's), moved by the predictor."""

  def __init__(self):
    self.t = 100.0

  def __call__(self):
    return self.t


def _echo(pkg, clock):
  """A callable predictor that takes ``x[0, 0]`` ms of the injected clock
  (and fails for a negative one)."""

  class Echo(pkg.Abstract):

    def predict(self, features):
      x = np.asarray(features['x'])
      clock.t += float(abs(x[0, 0])) / 1e3
      if x[0, 0] < 0:
        raise RuntimeError('negative input')
      return {'echo': x * 2.0}

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
      return 4

  return Echo()


def _hooks_run(pkg, prefix, fake, **kwargs):
  done = []
  trace_id = '8' * 32
  batcher = pkg.batching.DynamicBatcher(
      _echo(pkg, fake), max_batch=1, batch_deadline_ms=1.0,
      request_trace_sample=0.25, metrics_prefix=prefix,
      register_report=False, **kwargs)
  outputs = []
  with batcher:
    for i, value in enumerate([3.0, 17.0, 5.0, -2.0, 40.0, 1.0, 9.0, 23.0]):
      trace = (pkg.tracing.TraceContext(trace_id, f'{i:016x}')
               if i % 3 == 0 else None)
      future = batcher.submit({'x': np.full((1, 2), value, np.float32)},
                              request_id=f'q-{i}', trace=trace,
                              on_done=lambda r: done.append(
                                  (r.request_id, r.error is not None, r.n,
                                   r.model_version)))
      try:
        outputs.append(future.result(timeout=30.0)['echo'].tolist())
      except pkg.batching.ServingError as e:
        outputs.append(type(e).__name__)
    report = batcher.report()
  report.pop('bucket_compiles')
  for entry in report['slow_requests']:
    entry.pop('time')
  events = [(e['kind'], e['name'], e['detail'])
            for e in pkg.flight.events(kinds=['request'])
            if e['name'].startswith(prefix + '/')]
  spans = sorted((s['name'], s['request_id'], s['detail'],
                  s['parent_id'] if s['name'].endswith('/request') else '')
                 for s in pkg.tracing.spans(trace_id=trace_id)
                 if s['name'].startswith(prefix + '/'))
  return outputs, done, report, events, spans


def test_batcher_hooks_match_the_jax_batcher(monkeypatch):
  clock = _Clock()
  jax_run = _hooks_run(JAX, 'serving/hooks_jax', clock, clock=clock)
  # The port's batcher reads time.monotonic itself.
  clock = _Clock()
  with monkeypatch.context() as patch:
    patch.setattr(time, 'monotonic', clock)
    port_run = _hooks_run(PORT, 'serving/hooks_port', clock)

  def rename(value):
    return json.loads(json.dumps(value).replace('hooks_jax', 'hooks_port'))

  for jax_part, port_part in zip(jax_run, port_run):
    assert rename(jax_part) == rename(port_part)
  outputs, done, report, events, spans = port_run
  assert outputs[3] == 'RequestError' and outputs[4] == [[80.0, 80.0]]
  assert [d[0] for d in done] == [f'q-{i}' for i in range(8)]
  assert [d[1] for d in done] == [False, False, False, True] + [False] * 4
  assert [e['request_id'] for e in report['slow_requests']] == [
      'q-4', 'q-7', 'q-1', 'q-6', 'q-2', 'q-0', 'q-3', 'q-5']
  assert report['slow_requests'][0]['latency_ms'] == pytest.approx(40.0)
  assert report['requests'] == 8 and report['request_errors'] == 1
  traced = {d.split()[0] for _, _, d in events}
  assert traced == {'id=q-0', 'id=q-3', 'id=q-6', 'id=q-7'}
  assert len(spans) == 9 and {s[1] for s in spans} == {'q-0', 'q-3', 'q-6'}


def test_router_scopes_its_batchers_by_prefix():
  release = threading.Event()
  release.set()
  routed = router.ModelRouter(
      {'a': _gated(PORT, release), 'b': _gated(PORT, release)},
      max_batch=2, batch_deadline_ms=1.0, metrics_prefix='serving/scoped',
      register_report=False)
  with routed:
    routed.submit({'x': np.zeros((1, 2), np.float32)}, model='b').result(30.0)
    assert routed.batcher('b').metrics_prefix == 'serving/scoped/model/b'
    report = routed.report()
  assert report['models']['b']['requests'] == 1
  assert report['models']['a']['requests'] == 0
  assert report['classes']['interactive']['ok'] == 1


# ------------------------------------------------------- incident bundles


def _loaded_predictor():
  predictor = CheckpointPredictor(MockT2RModel(), device='cpu')
  predictor.init_randomly(torch.Generator().manual_seed(0))
  return predictor


def test_postmortem_on_serving_broken_reload(tmp_path):
  postmortem._reset_rate_limit_for_tests()  # pylint: disable=protected-access
  predictor = _loaded_predictor()
  pm_dir = str(tmp_path / 'serving')
  with batching.DynamicBatcher(
      predictor, max_batch=4, batch_deadline_ms=1.0,
      request_trace_sample=1.0, postmortem_dir=pm_dir,
      metrics_prefix='serving/pm_reload', register_report=False) as plane:
    plane.submit(mock_features(0.1)).result(timeout=30.0)

    def broken_restore():
      raise RuntimeError('export root unreadable')

    predictor.restore = broken_restore
    assert not plane.maybe_reload()
    version = plane.model_version
    plane.submit(mock_features(0.2)).result(timeout=30.0)
    assert plane.model_version == version
    assert not plane.maybe_reload()  # coalesced into the same bundle
  (path,) = (tmp_path / 'serving' / 'postmortem').glob('*.json')
  bundle = postmortem_tool.load_bundle(str(path))
  assert bundle['reason'] == 'serving_reload_failure'
  assert bundle['error']['type'] == 'RuntimeError'
  kinds = {e['kind'] for e in bundle['events']}
  assert {'error', 'request'} <= kinds
  assert 'serving_reload_failure' in postmortem_tool.render(bundle,
                                                            str(path))


def test_postmortem_when_the_predictor_keeps_its_last_good(tmp_path):
  postmortem._reset_rate_limit_for_tests()  # pylint: disable=protected-access
  trainer, model = trained_mock(tmp_path)
  root = str(tmp_path / 'export')
  exporters.ModelExporter().export(model, trainer.state, root, version=1)
  predictor = ExportedModelPredictor(root, device='cpu')
  assert predictor.restore()
  pm_dir = str(tmp_path / 'pm')
  with batching.DynamicBatcher(
      predictor, max_batch=2, batch_deadline_ms=1.0, postmortem_dir=pm_dir,
      metrics_prefix='serving/pm_fallback', register_report=False) as plane:
    broken = os.path.join(root, '2')
    shutil.copytree(os.path.join(root, '1'), broken)
    with open(os.path.join(broken, 'state', exporters.STATE_FILENAME),
              'wb') as f:
      f.write(b'not a checkpoint')
    assert not plane.maybe_reload()
    out = plane.submit(mock_features(0.3, n=2)).result(timeout=30.0)
  assert out['a_predicted'].shape == (2,)
  (path,) = (tmp_path / 'pm' / 'postmortem').glob('*.json')
  bundle = json.loads(path.read_text())
  assert bundle['extra'] == {'model_version': 5, 'predictor_fallback': True}
  assert any(e['name'] == 'serving/pm_fallback/reload_fallback'
             for e in bundle['events'])


# ------------------------------------------------------- refusals


def test_unported_knobs_raise_naming_their_roadmap_items():
  predictor = _loaded_predictor()
  with pytest.raises(NotImplementedError, match='queue 1 item 6'):
    server.ServingServer(predictor, compilation_cache_dir='/tmp/cache')
  with pytest.raises(ValueError, match='exactly one'):
    server.ServingServer()
  with pytest.raises(ValueError):
    batching.DynamicBatcher(predictor, request_trace_sample=1.5)


@pytest.mark.parametrize('flags,match', [
    (['--compilation-cache-dir', '/tmp/cache'], 'queue 1 item 6'),
])
def test_serving_binary_refuses_unported_flags(tmp_path, flags, match):
  from tensor2robot_tpu_torch.bin import run_serving  # pylint: disable=import-outside-toplevel

  predictor = _loaded_predictor()
  root = str(tmp_path / 'export')
  exporters.ModelExporter().export(
      MockT2RModel(),
      exporters.ServingState(1, predictor.network.state_dict()), root)
  with pytest.raises(NotImplementedError, match=match):
    run_serving.main(['--export_dir', root, '--device', 'cpu', '--port',
                      '0'] + flags)
