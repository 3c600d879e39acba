"""The batching plane on the CPU: the cases of ``tests/test_serving.py``
that the port's ``serving/batching.py`` carries, by the same names where
they apply.

Bucket functions and padding; batch assembly (deadline and max-batch
splits, backpressure) driven on ``_assemble`` without a dispatcher; the
steady ``serving/bucket_compiles`` counter (the port's warmed buckets)
while the client count varies; batched outputs equal to serial predict,
on the mock model and on the tiny QT-Opt program; a hot swap under load
with no failed request; an idle plane adopting a staged swap; the program
key across weights-only exports; the predict/reload race and the
reader-writer lock; the drain under backpressure and the atomic
generation handoff; paging. The JAX suite's HTTP and metricsz cases are
in ``tests/test_torch_serving_http.py`` and
``tests/test_torch_observability.py``; the compilation cache is not
ported (an exported program has no compiled form to keep).
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch
from torch_serving_fixtures import (  # one_thread: an autouse fixture
    at_step, export_predictor, mock_features, one_thread, qtopt_features,
    qtopt_predictor, trained_mock)

from tensor2robot_tpu_torch.export import exporters
from tensor2robot_tpu_torch.observability import metrics as metrics_lib
from tensor2robot_tpu_torch.predictors import (AbstractPredictor,
                                               CheckpointPredictor,
                                               ExportedModelPredictor)
from tensor2robot_tpu_torch.serving import batching as batching_lib
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec
from tensor2robot_tpu_torch.utils.concurrency import ReaderWriterLock
from tensor2robot_tpu_torch.utils.mocks import MockT2RModel


def _loaded_checkpoint_predictor():
  predictor = CheckpointPredictor(MockT2RModel(), device='cpu')
  predictor.init_randomly(torch.Generator().manual_seed(0))
  return predictor


def _exported_mock(tmp_path, steps=5, **exporter_kwargs):
  """(trainer, model, root, exporter, predictor): version 1 of a trained
  mock, restored."""
  trainer, model = trained_mock(tmp_path, steps=steps)
  root = str(tmp_path / 'export')
  exporter = exporters.ModelExporter(**exporter_kwargs)
  exporter.export(model, trainer.state, root, version=1)
  predictor = ExportedModelPredictor(root, device='cpu')
  assert predictor.restore()
  return trainer, model, root, exporter, predictor


def _run_load(batcher, features_fn, num_clients, requests_per_client=None,
              duration_secs=None):
  """Closed-loop clients, each submitting and waiting in turn; returns
  (completed requests, [errors])."""
  errors, done = [], []
  stop = time.monotonic() + (duration_secs or 1e9)

  def client(c):
    i = 0
    while ((requests_per_client is None or i < requests_per_client) and
           time.monotonic() < stop):
      try:
        batcher.submit(features_fn(c * 1000 + i)).result(timeout=30.0)
        done.append(1)
      except Exception as e:  # pylint: disable=broad-except
        errors.append(repr(e))
      i += 1

  threads = [threading.Thread(target=client, args=(c,), daemon=True)
             for c in range(num_clients)]
  for thread in threads:
    thread.start()
  for thread in threads:
    thread.join(timeout=120.0)
  return len(done), errors


# --------------------------------------------------------------- unit: shapes


def test_default_buckets_powers_of_two():
  assert batching_lib.default_buckets(64) == (1, 2, 4, 8, 16, 32, 64)
  assert batching_lib.default_buckets(1) == (1,)
  assert batching_lib.default_buckets(48) == (1, 2, 4, 8, 16, 32, 48)
  with pytest.raises(ValueError):
    batching_lib.default_buckets(0)


def test_bucket_for_smallest_fit():
  buckets = (1, 2, 4, 8)
  assert [batching_lib.bucket_for(n, buckets) for n in (1, 2, 3, 5, 8)] == [
      1, 2, 4, 8, 8]
  with pytest.raises(ValueError):
    batching_lib.bucket_for(9, buckets)


def test_pad_to_bucket_repeats_last_example():
  feats = {'x': np.asarray([[1.0], [2.0], [3.0]], np.float32)}
  padded = batching_lib.pad_to_bucket(feats, 3, 8)
  assert padded['x'].shape == (8, 1)
  np.testing.assert_array_equal(padded['x'][3:], np.full((5, 1), 3.0))
  assert batching_lib.pad_to_bucket(feats, 3, 3)['x'] is feats['x']


# ------------------------------------------------------------ batch assembly


class TestAssembly:
  """Deadline against max-batch, driven on ``_assemble`` (no dispatcher
  thread), so the outcomes are deterministic."""

  def _batcher(self, **kwargs):
    return batching_lib.DynamicBatcher(predictor=None, **kwargs)

  def test_max_batch_splits_are_deterministic(self):
    b = self._batcher(max_batch=4, batch_deadline_ms=10_000.0)
    for _ in range(10):
      b.submit({'x': np.zeros((1, 2), np.float32)})
    t0 = time.monotonic()
    sizes = [sum(r.n for r in b._assemble()) for _ in range(2)]
    assert time.monotonic() - t0 < 1.0  # full batches do not wait
    assert sizes == [4, 4]
    b._deadline_s = 0.01
    assert [r.n for r in b._assemble()] == [1, 1]

  def test_deadline_flushes_partial_batch(self):
    b = self._batcher(max_batch=64, batch_deadline_ms=50.0)
    b.submit({'x': np.zeros((2, 2), np.float32)})
    t0 = time.monotonic()
    batch = b._assemble()
    elapsed = time.monotonic() - t0
    assert [r.n for r in batch] == [2]
    assert 0.02 <= elapsed < 1.0

  def test_late_request_joins_open_window(self):
    b = self._batcher(max_batch=64, batch_deadline_ms=300.0)
    b.submit({'x': np.zeros((1, 2), np.float32)})

    def late():
      time.sleep(0.05)
      b.submit({'x': np.zeros((3, 2), np.float32)})

    threading.Thread(target=late, daemon=True).start()
    assert sorted(r.n for r in b._assemble()) == [1, 3]

  def test_oversized_next_request_rolls_to_next_batch(self):
    b = self._batcher(max_batch=4, batch_deadline_ms=10_000.0)
    b.submit({'x': np.zeros((2, 2), np.float32)})
    b.submit({'x': np.zeros((3, 2), np.float32)})
    assert [r.n for r in b._assemble()] == [2]
    b._deadline_s = 0.01
    assert [r.n for r in b._assemble()] == [3]

  def test_submit_rejects_oversized_and_inconsistent(self):
    b = self._batcher(max_batch=4, batch_deadline_ms=1.0)
    with pytest.raises(batching_lib.RequestError):
      b.submit({'x': np.zeros((5, 2), np.float32)})
    with pytest.raises(batching_lib.RequestError):
      b.submit({'x': np.zeros((2, 2), np.float32),
                'y': np.zeros((3,), np.float32)})

  def test_queue_bound_backpressure(self):
    b = self._batcher(max_batch=4, batch_deadline_ms=1.0, max_queue=2)
    b.submit({'x': np.zeros((1, 2), np.float32)})
    b.submit({'x': np.zeros((1, 2), np.float32)})
    assert b.queue_depth == 2
    with pytest.raises(batching_lib.OverloadedError):
      b.submit({'x': np.zeros((1, 2), np.float32)})


# ------------------------------------------------- bucketed dispatch + swap


class TestBucketedDispatch:

  def test_zero_recompiles_while_client_count_varies(self):
    """Warm every bucket, then vary the clients 1 -> 12 -> 5 -> 1: the
    bucket counter stays at its warm-up value."""
    predictor = _loaded_checkpoint_predictor()
    compiles = metrics_lib.counter('serving/bucket_compiles')
    with batching_lib.DynamicBatcher(predictor, max_batch=16,
                                     batch_deadline_ms=0.5) as batcher:
      assert batcher.buckets == (1, 2, 4, 8, 16)
      warm = compiles.value
      for clients in (1, 12, 5, 1):
        done, errors = _run_load(batcher,
                                 lambda i: mock_features(0.01 * (i + 1)),
                                 clients, requests_per_client=8)
        assert not errors and done == 8 * clients
      assert compiles.value == warm
      assert batcher.report()['requests'] > 0

  def test_batched_outputs_match_serial_predict(self):
    predictor = _loaded_checkpoint_predictor()
    with batching_lib.DynamicBatcher(predictor, max_batch=8,
                                     batch_deadline_ms=5.0) as batcher:
      futures = {i: batcher.submit(mock_features(0.1 * i, n=1 + i % 3))
                 for i in range(6)}
      for i, future in futures.items():
        got = future.result(timeout=30.0)
        want = predictor.predict(mock_features(0.1 * i, n=1 + i % 3))
        np.testing.assert_array_equal(got['a_predicted'], want['a_predicted'])
        assert future.model_version == 0

  def test_batched_qtopt_program_matches_serial_predict(self, tmp_path):
    model, eager = qtopt_predictor()
    export_predictor(model, eager, tmp_path / 'export')
    predictor = ExportedModelPredictor(str(tmp_path / 'export'),
                                       device='cpu')
    assert predictor.restore()
    requests = [qtopt_features(i, 1 + i % 3) for i in range(5)]
    with batching_lib.DynamicBatcher(predictor, max_batch=8,
                                     batch_deadline_ms=20.0) as batcher:
      futures = [batcher.submit(r) for r in requests]
      for request, future in zip(requests, futures):
        np.testing.assert_array_equal(
            future.result(timeout=60.0)['q_predicted'],
            eager.predict(request)['q_predicted'])

  def test_single_example_requests_expand_batch_dim(self):
    predictor = _loaded_checkpoint_predictor()
    with batching_lib.DynamicBatcher(predictor, max_batch=4,
                                     batch_deadline_ms=1.0) as batcher:
      out = batcher.submit(
          {'measured_position': np.zeros((2,), np.float32)}).result(10.0)
      assert out['a_predicted'].shape == (1,)
      with pytest.raises(batching_lib.RequestError, match='missing'):
        batcher.submit({'other': np.zeros((1, 2), np.float32)})

  def test_callable_executor_fallback(self):
    """A predictor without a stateless core still gets cross-client
    batching through whole-batch predict()."""

    class _Callable(AbstractPredictor):

      calls = 0

      def predict(self, features):
        type(self).calls += 1
        return {'doubled': np.asarray(features['x']) * 2.0}

      def get_feature_specification(self):
        spec = SpecStruct()
        spec['x'] = TensorSpec(shape=(2,), dtype=np.float32, name='x')
        return spec

      def restore(self):
        return True

      @property
      def is_loaded(self):
        return True

      @property
      def global_step(self):
        return 3

    with batching_lib.DynamicBatcher(_Callable(), max_batch=8,
                                     batch_deadline_ms=20.0) as batcher:
      futures = [batcher.submit({'x': np.full((1, 2), i, np.float32)})
                 for i in range(4)]
      for i, future in enumerate(futures):
        np.testing.assert_array_equal(future.result(10.0)['doubled'],
                                      [[2.0 * i, 2.0 * i]])
      assert _Callable.calls < 4
      assert batcher.model_version == 3

  def test_dispatch_error_fails_the_batch_not_the_plane(self):
    predictor = _loaded_checkpoint_predictor()
    with batching_lib.DynamicBatcher(predictor, max_batch=4,
                                     batch_deadline_ms=1.0) as batcher:
      executor = batcher.current_executor()
      real = executor._fn

      def broken(params, features):
        raise RuntimeError('device fault')

      executor._fn = broken
      with pytest.raises(batching_lib.RequestError, match='device fault'):
        batcher.submit(mock_features(0.1)).result(10.0)
      executor._fn = real
      out = batcher.submit(mock_features(0.1)).result(10.0)
      assert out['a_predicted'].shape == (1,)
      assert batcher.report()['request_errors'] >= 1


class TestHotSwap:

  def test_swap_under_sustained_load_no_failed_requests(self, tmp_path):
    trainer, model, root, exporter, predictor = _exported_mock(tmp_path)
    swaps = metrics_lib.counter('serving/model_swaps')
    swaps0 = swaps.value
    compiles = metrics_lib.counter('serving/bucket_compiles')
    with batching_lib.DynamicBatcher(predictor, max_batch=8,
                                     batch_deadline_ms=1.0,
                                     reload_interval_secs=0.05) as batcher:
      assert batcher.model_version == 5
      warm = compiles.value
      result = {}

      def load():
        result['load'] = _run_load(batcher,
                                   lambda i: mock_features(0.01 * (i + 1)),
                                   num_clients=4, duration_secs=2.0)

      thread = threading.Thread(target=load, daemon=True)
      thread.start()
      time.sleep(0.4)
      exporter.export(model, at_step(trainer, 105), root, version=2)
      deadline = time.time() + 10.0
      while batcher.model_version != 105 and time.time() < deadline:
        time.sleep(0.05)
      assert batcher.model_version == 105
      thread.join(timeout=60.0)
      done, errors = result['load']
      assert done > 0 and not errors
      assert swaps.value >= swaps0 + 1
      # Same program, same param shapes: the warmed buckets carried over.
      assert compiles.value == warm

    # Torn and broken reloads on a batcher without the poller.
    with batching_lib.DynamicBatcher(predictor, max_batch=8,
                                     batch_deadline_ms=1.0) as batcher:
      assert batcher.model_version == 105
      torn = os.path.join(root, '3')
      shutil.copytree(os.path.join(root, '2'), torn)
      os.remove(os.path.join(torn, exporters.EXPORT_COMMIT_FILENAME))
      assert batcher.maybe_reload() is False
      assert batcher.model_version == 105
      broken = os.path.join(root, '4')
      shutil.copytree(os.path.join(root, '2'), broken)
      state_dir = os.path.join(broken, exporters.STATE_DIRNAME)
      shutil.rmtree(state_dir)
      os.makedirs(state_dir)
      fallbacks = metrics_lib.counter('predictor/load_fallbacks')
      fb0 = fallbacks.value
      assert batcher.maybe_reload() is False
      assert fallbacks.value == fb0 + 1
      assert batcher.model_version == 105
      out = batcher.submit(mock_features(0.5)).result(30.0)
      assert out['a_predicted'].shape == (1,)


def test_idle_plane_adopts_staged_swap_without_traffic(tmp_path):
  trainer, model, root, exporter, predictor = _exported_mock(tmp_path)
  with batching_lib.DynamicBatcher(predictor, max_batch=4,
                                   batch_deadline_ms=1.0,
                                   reload_interval_secs=0.05) as batcher:
    assert batcher.model_version == 5
    exporter.export(model, at_step(trainer, 105), root, version=2)
    deadline = time.time() + 20.0
    while batcher.model_version != 105 and time.time() < deadline:
      time.sleep(0.05)  # no submits: the plane is idle throughout
    assert batcher.model_version == 105
    out = batcher.submit(mock_features(0.4)).result(30.0)
    assert out['a_predicted'].shape == (1,)


def test_program_key_stable_across_weights_only_exports(tmp_path):
  trainer, model, root, exporter, predictor = _exported_mock(tmp_path,
                                                             steps=2)
  serving_v1 = predictor.stateless_serving_fn()
  exporter.export(model, at_step(trainer, 9), root, version=2)
  assert predictor.restore()
  serving_v2 = predictor.stateless_serving_fn()
  assert serving_v2.version == serving_v1.version + 7
  assert serving_v1.program_key == serving_v2.program_key
  assert serving_v1.program_key[0] == 'torch_export'
  assert serving_v1.params is not serving_v2.params
  executor = batching_lib.TorchBucketExecutor(serving_v1, (1, 2))
  executor.warm()
  assert executor.compatible_cache(serving_v2) == executor._compiled
  # Another program (the model-class path) gets no cache.
  eager = _loaded_checkpoint_predictor().stateless_serving_fn()
  assert executor.compatible_cache(eager) is None


def test_stateless_serving_fn_matches_predict():
  predictor = _loaded_checkpoint_predictor()
  serving = predictor.stateless_serving_fn()
  assert serving.version == 0
  batch = mock_features(0.25, n=3)
  out = serving.fn(serving.params,
                   {k: torch.from_numpy(v) for k, v in batch.items()})
  np.testing.assert_array_equal(out['a_predicted'].numpy(),
                                predictor.predict(batch)['a_predicted'])
  assert serving.program_key == predictor.stateless_serving_fn().program_key
  assert predictor.stateless_serving_fn() is serving
  # A load makes a new snapshot and leaves this one as it was.
  kept = {k: v.clone() for k, v in serving.params.items()}
  predictor.init_randomly(torch.Generator().manual_seed(1))
  fresh = predictor.stateless_serving_fn()
  assert fresh is not serving and fresh.program_key == serving.program_key
  assert all(torch.equal(serving.params[k], kept[k]) for k in kept)


def test_page_out_keeps_the_warmed_buckets(tmp_path):
  _, _, _, _, predictor = _exported_mock(tmp_path)
  compiles = metrics_lib.counter('serving/bucket_compiles')
  ins = metrics_lib.counter('serving/page_ins')
  with batching_lib.DynamicBatcher(predictor, max_batch=4,
                                   batch_deadline_ms=1.0) as batcher:
    warm = compiles.value
    want = batcher.submit(mock_features(0.3, n=2)).result(10.0)
    executor = batcher.current_executor()
    # The generation's own tensors are served: no copy until a page-out.
    params = predictor.stateless_serving_fn().params
    assert all(executor._device_params[k] is v for k, v in params.items())
    assert executor.resident and executor.page_out() == executor.param_bytes
    assert not executor.resident and executor.page_out() == 0
    page_ins = ins.value
    got = batcher.submit(mock_features(0.3, n=2)).result(10.0)  # auto page-in
    assert executor.resident and ins.value == page_ins + 1
    assert executor.page_in() is False
    np.testing.assert_array_equal(got['a_predicted'], want['a_predicted'])
    assert compiles.value == warm


# ------------------------------------------------ reload/predict race guard


class TestReloadPredictRace:

  @pytest.mark.parametrize('serialize_serving', [False, True])
  def test_hammer_predict_vs_hot_reload(self, tmp_path, serialize_serving):
    """4 predict threads hammer while the main thread hot-reloads through
    5 versions: no exceptions, no torn generations."""
    trainer, model, root, exporter, predictor = _exported_mock(
        tmp_path, steps=2, serialize_serving=serialize_serving)
    stop = threading.Event()
    failures = []

    def hammer():
      while not stop.is_set():
        try:
          out = predictor.predict(mock_features(0.3, n=2))
          if out['a_predicted'].shape != (2,):
            failures.append(f'bad shape {out["a_predicted"].shape}')
        except Exception as e:  # pylint: disable=broad-except
          failures.append(repr(e))

    threads = [threading.Thread(target=hammer, daemon=True)
               for _ in range(4)]
    for thread in threads:
      thread.start()
    for version in range(2, 7):
      exporter.export(model, at_step(trainer, 2 + version), root,
                      version=version)
      assert predictor.restore()
    stop.set()
    for thread in threads:
      thread.join(timeout=30.0)
    assert not failures, failures[:5]
    assert predictor.global_step == 8

  def test_reader_writer_lock_exclusion_and_writer_preference(self):
    lock = ReaderWriterLock()
    state = {'writers': 0, 'readers': 0}
    errors = []
    stop = threading.Event()

    def reader():
      while not stop.is_set():
        with lock.read_locked():
          state['readers'] += 1
          if state['writers']:
            errors.append('reader inside write section')
          state['readers'] -= 1

    threads = [threading.Thread(target=reader, daemon=True)
               for _ in range(4)]
    for thread in threads:
      thread.start()
    for _ in range(20):
      t0 = time.monotonic()
      with lock.write_locked():
        state['writers'] = 1
        if state['readers']:
          errors.append('writer overlapped readers')
        state['writers'] = 0
      assert time.monotonic() - t0 < 5.0  # no starvation
    stop.set()
    for thread in threads:
      thread.join(timeout=10.0)
    assert not errors, errors[:5]


class TestCloseDrainsBacklog:
  """``close()`` under backpressure (queue at its bound, the dispatch in
  flight stuck) completes every queued request before stopping."""

  class _Gated(AbstractPredictor):

    def __init__(self, release):
      self._release = release

    def predict(self, features):
      self._release.wait(timeout=30.0)
      return {'echo': np.asarray(features['x'])}

    def get_feature_specification(self):
      spec = SpecStruct()
      spec['x'] = TensorSpec(shape=(2,), dtype=np.float32, name='x')
      return spec

    def restore(self):
      return True

    @property
    def is_loaded(self):
      return True

    @property
    def global_step(self):
      return 1

  def test_close_completes_full_backlog_under_backpressure(self):
    release = threading.Event()
    batcher = batching_lib.DynamicBatcher(
        self._Gated(release), max_batch=2, batch_deadline_ms=1.0,
        max_queue=6)
    batcher.start()
    try:
      futures, overloaded = [], 0
      for i in range(12):
        try:
          futures.append(batcher.submit(
              {'x': np.full((1, 2), float(i), np.float32)}))
        except batching_lib.OverloadedError:
          overloaded += 1
      assert overloaded >= 1 and len(futures) >= 6
      assert batcher.queue_depth >= 6
      closer = threading.Thread(target=batcher.close, daemon=True)
      closer.start()
      time.sleep(0.2)
      assert closer.is_alive()
      with pytest.raises(batching_lib.OverloadedError):
        batcher.submit({'x': np.zeros((1, 2), np.float32)})
      release.set()
      closer.join(timeout=60.0)
      assert not closer.is_alive()
      for i, future in enumerate(futures):
        np.testing.assert_array_equal(future.result(timeout=1.0)['echo'],
                                      np.full((1, 2), float(i), np.float32))
    finally:
      release.set()
      batcher.close()


class TestModelHandoffAtomicity:
  """The reload -> dispatcher generation handoff is one critical
  section."""

  def _bare_batcher(self):
    return batching_lib.DynamicBatcher(predictor=object())

  def test_adopt_returns_staged_and_clears(self):
    batcher = self._bare_batcher()
    staged = object()
    with batcher._cond:
      batcher._pending_model = staged
    assert batcher._adopt_pending_model() is staged
    assert batcher._model is staged and batcher._pending_model is None
    assert batcher._adopt_pending_model() is None

  def test_no_staged_generation_is_ever_lost(self):
    batcher = self._bare_batcher()
    n_stage = 400
    adopted = []
    done = threading.Event()

    def reloader():
      for i in range(n_stage):
        with batcher._cond:
          batcher._pending_model = ('gen', i)
      done.set()

    def dispatcher():
      while not done.is_set() or batcher._pending_model is not None:
        model = batcher._adopt_pending_model()
        if model is not None:
          adopted.append(model)

    threads = [threading.Thread(target=reloader),
               threading.Thread(target=dispatcher)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(timeout=30)
      assert not t.is_alive()
    assert adopted and adopted[-1] == ('gen', n_stage - 1)
    indices = [i for _, i in adopted]
    assert indices == sorted(indices)
    assert batcher._model == ('gen', n_stage - 1)


def test_report_is_a_metrics_section():
  predictor = _loaded_checkpoint_predictor()
  with batching_lib.DynamicBatcher(predictor, max_batch=2,
                                   batch_deadline_ms=1.0) as batcher:
    batcher.submit(mock_features(0.2), request_id='req-7').result(10.0)
    section = metrics_lib.report()['serving']
    assert section['max_batch'] == 2 and section['requests'] >= 1
    assert 'req-7' in section['request_latency_exemplars'].values()
    assert any(e['request_id'] == 'req-7' for e in batcher.slow_requests())
  assert 'serving' not in metrics_lib.report()
