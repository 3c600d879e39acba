"""Weight-only int8/fp8 serving on the CPU: the port's ``quantize``
package against the JAX package's, and the parity gate of the serving
plane, case by case after ``tests/test_quantize.py``.

* Payloads and scales: on seeded weights of every >= 2-D layout the
  converters emit (a Linear ``[out, in]``, a Conv1d ``[out, in, k]``, an
  OIHW conv, the HWIO ``conv1_1.kernel`` QT-Opt keeps), int8 and fp8, the
  port's payload and scales are bit for bit the JAX ``quantize_array``
  outputs after the converter's transpose; and on whole seeded QT-Opt,
  SNAIL and Grasp2Vec variables trees, the JAX quantized payload and
  scales carried through ``utils/convert`` are the port's quantized
  ``state_dict`` bit for bit, with the same quantized leaf count and the
  same bytes.
* The quantized predictor (``CheckpointPredictor`` and
  ``ExportedModelPredictor``, int8 and fp8) lies within the serving bands
  of ``tests/test_torch_exported_predictor.py`` (float32 1e-6, bfloat16
  4e-3) of the JAX quantized twin (``tensor2robot_tpu.quantize.
  quantize_serving_fn`` on the JAX exported predictor) on the tiny QT-Opt
  config.
* The gate: a band below the measured error is refused
  (``quant_parity_rejects`` moves by 1) and serves full precision bit for
  bit; a preparation that raises counts ``quant_errors`` and serves full
  precision; the batcher, ``/statz``, the router and ``run_serving
  --quantize int8`` serve the twin; a reload poll never re-quantizes; a
  weights-only swap keeps the warmed buckets.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_weights import random_variables
from torch_serving_fixtures import (  # one_thread: an autouse fixture
    at_step, mock_features, one_thread, paired_qtopt_exports,
    paired_qtopt_variables, qtopt_features, trained_mock)

from tensor2robot_tpu import quantize as jax_quant
from tensor2robot_tpu.modes import ModeKeys as JaxModeKeys
from tensor2robot_tpu.predictors import (
    ExportedModelPredictor as JaxExportedModelPredictor)
from tensor2robot_tpu.research.grasp2vec import Grasp2VecModel as JaxGrasp2Vec
from tensor2robot_tpu.research.vrgripper import (
    VRGripperEnvSequentialModel as JaxSequential)
from tensor2robot_tpu_torch import quantize as quant_lib
from tensor2robot_tpu_torch.export import exporters
from tensor2robot_tpu_torch.observability import metrics as metrics_lib
from tensor2robot_tpu_torch.predictors import (AbstractPredictor,
                                               CheckpointPredictor,
                                               ExportedModelPredictor)
from tensor2robot_tpu_torch.serving import batching as batching_lib
from tensor2robot_tpu_torch.serving import router as router_lib
from tensor2robot_tpu_torch.serving import server as server_lib
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec
from tensor2robot_tpu_torch.utils import convert
from tensor2robot_tpu_torch.utils.mocks import MockT2RModel

REPO = pathlib.Path(__file__).resolve().parent.parent
BANDS = {'float32': 1e-6, 'bfloat16': 4e-3}
MODES = ('int8', 'fp8')
# layout: (flax shape, the converter's transform, the port's key)
LAYOUTS = {
    'linear': ((16, 8), convert._dense_to_linear, 'fc0.weight'),  # pylint: disable=protected-access
    'conv1d': ((2, 12, 8), convert._kernel_to_weight, 'tc1.xf.conv.weight'),  # pylint: disable=protected-access
    'oihw': ((3, 3, 4, 8), convert._hwio_to_oihw, 'conv2.conv.weight'),  # pylint: disable=protected-access
    'hwio_kernel': ((6, 6, 3, 64), lambda a: a, 'conv1_1.kernel'),
}


def _mock_predictor(hidden_size=64, seed=0):
  predictor = CheckpointPredictor(MockT2RModel(hidden_size=hidden_size),
                                  device='cpu')
  predictor.init_randomly(torch.Generator().manual_seed(seed))
  return predictor


def _sample_params(seed=0):
  generator = torch.Generator().manual_seed(seed)
  return {
      'dense_0.weight': torch.randn((8, 16), generator=generator),
      'dense_0.bias': torch.randn((8,), generator=generator),
      'conv.conv.weight': torch.randn((8, 4, 3, 3), generator=generator),
      'batch_norm.scale': torch.rand((8,), generator=generator) + 0.5,
      'batch_norm.mean': torch.randn((8,), generator=generator),
      'batch_norm.var': torch.rand((8,), generator=generator) + 0.1,
  }


def _bits(x):
  """An array's bit pattern (fp8 payloads compared as bytes)."""
  x = np.asarray(x)
  return x.view(np.uint8) if x.dtype.name.startswith('float8') else x


# ------------------------------------------------------------ core invariants


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_payload_and_scales_match_jax_bit_for_bit(layout, mode):
  shape, transform, key = LAYOUTS[layout]
  weight = np.random.RandomState(3).randn(*shape).astype(np.float32)
  weight[..., 1] = 0.0  # a dead output channel
  want = jax_quant.quantize_array(weight, mode)
  leaf = torch.from_numpy(np.ascontiguousarray(transform(weight)))
  got = quant_lib.quantize_array(leaf, mode,
                                 quant_lib.output_axis(key, leaf))
  assert got.qvalue.dtype == {'int8': torch.int8,
                              'fp8': torch.float8_e4m3fn}[mode]
  np.testing.assert_array_equal(
      got.qvalue.view(torch.uint8).numpy() if mode == 'fp8'
      else got.qvalue.numpy(),
      _bits(np.ascontiguousarray(transform(np.asarray(want.qvalue)))))
  np.testing.assert_array_equal(
      got.scale.numpy(), np.ascontiguousarray(transform(want.scale)))
  np.testing.assert_array_equal(
      quant_lib.dequantize_array(got).numpy(),
      np.ascontiguousarray(transform(jax_quant.dequantize_array(want))))


def test_per_channel_scale_shapes():
  qt = quant_lib.quantize_params(_sample_params(), 'int8')
  dense, conv = qt['dense_0.weight'], qt['conv.conv.weight']
  assert isinstance(dense, quant_lib.QuantizedTensor)
  assert dense.qvalue.dtype == torch.int8 and dense.qvalue.shape == (8, 16)
  assert dense.scale.shape == (8, 1)  # per output channel, axis 0
  assert conv.qvalue.shape == (8, 4, 3, 3)
  assert conv.scale.shape == (8, 1, 1, 1)
  assert conv.scale.dtype == torch.float32


def test_skip_list_leaves_untouched():
  params = _sample_params()
  qt = quant_lib.quantize_params(params, 'int8')
  for key in ('dense_0.bias', 'batch_norm.scale', 'batch_norm.mean',
              'batch_norm.var'):
    assert qt[key] is params[key]
  assert quant_lib.quantized_leaf_count(qt) == 2
  assert not quant_lib.should_quantize(
      'bn.scale', torch.ones((4, 4)))  # a skip part, whatever the rank
  assert not quant_lib.should_quantize(
      'step', torch.ones((4, 4), dtype=torch.int64))


def test_skip_patterns_extend_the_list():
  params = _sample_params()
  qt = quant_lib.quantize_params(params, 'int8', skip_patterns=('conv.',))
  assert qt['conv.conv.weight'] is params['conv.conv.weight']
  assert isinstance(qt['dense_0.weight'], quant_lib.QuantizedTensor)


def test_unknown_layout_raises():
  with pytest.raises(ValueError, match='output-channel axis'):
    quant_lib.quantize_params({'embedding.table': torch.ones((4, 4))})


def test_roundtrip_error_bounded_by_half_step():
  weight = _sample_params()['dense_0.weight']
  qt = quant_lib.quantize_array(weight, 'int8', 0)
  error = (quant_lib.dequantize_array(qt) - weight).abs()
  assert bool((error <= qt.scale / 2.0 + 1e-6).all())


def test_dead_channel_dequantizes_to_exact_zero():
  weight = torch.zeros((3, 4))
  weight[0] = torch.linspace(-1, 1, 4)
  qt = quant_lib.quantize_array(weight, 'int8', 0)
  assert bool((quant_lib.dequantize_array(qt)[1:] == 0).all())
  assert float(qt.scale[1, 0]) == 1.0


def test_unknown_mode_rejected():
  with pytest.raises(ValueError, match='unknown quantization mode'):
    quant_lib.quantize_params(_sample_params(), 'int4')
  with pytest.raises(ValueError):
    batching_lib.DynamicBatcher(predictor=None, quantize='int4')


def test_fp8_roundtrip():
  weight = _sample_params()['dense_0.weight']
  qt = quant_lib.quantize_array(weight, 'fp8', 0)
  assert qt.qvalue.dtype == torch.float8_e4m3fn
  amax = weight.abs().amax(dim=1, keepdim=True)
  # e4m3: 3 mantissa bits, a worst relative step of 2**-3.
  assert bool(((quant_lib.dequantize_array(qt) - weight).abs() <=
               0.125 * amax + 1e-6).all())


# --------------------------------------------- whole trees through convert


def _snail_variables():
  model = JaxSequential(episode_length=4, image_size=(48, 48),
                        device_type='cpu')
  spec = model.preprocessor.get_out_feature_specification(JaxModeKeys.TRAIN)
  example = {key: jnp.zeros((1,) + tuple(1 if d is None else d
                                         for d in value.shape), jnp.float32)
             for key, value in spec.items()}
  return random_variables(jax.eval_shape(lambda: model.init_variables(
      jax.random.PRNGKey(0), example)), seed=4)


def _grasp2vec_variables():
  model = JaxGrasp2Vec(scene_size=(64, 64), goal_size=(64, 64),
                       resnet_size=18, device_type='cpu')
  example = {key: jnp.zeros((1, 64, 64, 3), jnp.float32)
             for key in ('pregrasp_image', 'postgrasp_image', 'goal_image')}
  return random_variables(jax.eval_shape(lambda: model.init_variables(
      jax.random.PRNGKey(0), example)), seed=5)


TREES = {
    'qtopt': (lambda: paired_qtopt_variables(seed=2)[2],
              convert.jax_variables_to_torch),
    'snail': (_snail_variables, convert.snail_variables_to_torch),
    'grasp2vec': (_grasp2vec_variables,
                  convert.grasp2vec_variables_to_torch),
}


def _jax_part(tree, field):
  """The JAX quantized tree with each quantized leaf replaced by its
  payload (as float32, which holds int8 and e4m3 values exactly) or its
  scale."""
  return jax.tree_util.tree_map(
      lambda leaf: (np.asarray(getattr(leaf, field), np.float32)
                    if isinstance(leaf, jax_quant.QuantizedTensor) else leaf),
      tree, is_leaf=lambda x: isinstance(x, jax_quant.QuantizedTensor))


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('tree', sorted(TREES))
def test_converted_jax_payload_is_the_ports(tree, mode):
  variables_fn, to_torch = TREES[tree]
  variables = variables_fn()
  jax_tree = jax_quant.quantize_params(variables, mode)
  got = quant_lib.quantize_params(to_torch(variables), mode)
  assert (quant_lib.quantized_leaf_count(got) ==
          jax_quant.quantized_leaf_count(jax_tree) > 0)
  assert quant_lib.param_bytes(got) == jax_quant.param_bytes(jax_tree)
  assert (quant_lib.param_bytes(to_torch(variables)) ==
          jax_quant.param_bytes(variables))
  payload = to_torch(_jax_part(jax_tree, 'qvalue'))
  scales = to_torch(_jax_part(jax_tree, 'scale'))
  for key, leaf in got.items():
    if isinstance(leaf, quant_lib.QuantizedTensor):
      np.testing.assert_array_equal(leaf.qvalue.float().numpy(),
                                    payload[key].numpy(), err_msg=key)
      np.testing.assert_array_equal(leaf.scale.numpy(), scales[key].numpy(),
                                    err_msg=key)
    else:
      np.testing.assert_array_equal(leaf.numpy(), payload[key].numpy())


def test_int8_bytes_beat_f32_and_bf16_on_bench_model():
  """The compression on the 2048-hidden mock."""
  predictor = _mock_predictor(hidden_size=2048)
  serving = predictor.stateless_serving_fn()
  qserving = predictor.stateless_serving_fn(quantize='int8')
  f32_bytes = quant_lib.param_bytes(serving.params)
  bf16_bytes = quant_lib.cast_tree_bytes(serving.params, torch.bfloat16)
  int8_bytes = quant_lib.param_bytes(qserving.params)
  assert int8_bytes <= 0.27 * f32_bytes, (int8_bytes, f32_bytes)
  assert int8_bytes <= 0.52 * bf16_bytes, (int8_bytes, bf16_bytes)


# ------------------------------------------- the quantized predictor vs JAX


@pytest.fixture(scope='module', params=['float32', 'bfloat16'])
def paired(request, tmp_path_factory):
  root = tmp_path_factory.mktemp(f'quant_{request.param}')
  model, eager, jax_root, port_root = paired_qtopt_exports(
      root, bfloat16=request.param == 'bfloat16')
  jax_exported = JaxExportedModelPredictor(jax_root)
  assert jax_exported.restore()
  exported = ExportedModelPredictor(port_root, device='cpu')
  assert exported.restore()
  return request.param, model, {'checkpoint': eager,
                                'exported': exported}, jax_exported


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('kind', ['checkpoint', 'exported'])
def test_quantized_predictor_within_the_bands_of_the_jax_twin(paired, kind,
                                                             mode):
  dtype, _, predictors, jax_exported = paired
  twin = predictors[kind].stateless_serving_fn(quantize=mode)
  full = predictors[kind].stateless_serving_fn()
  assert twin.program_key == ('quant', mode, full.program_key)
  assert twin.version == full.version
  jax_twin = jax_exported.stateless_serving_fn(quantize=mode)
  features = qtopt_features(11, 6)
  want = np.asarray(jax.jit(jax_twin.fn)(jax_twin.params, features)[
      'q_predicted'], np.float32)
  with torch.inference_mode():
    got = twin.fn(twin.params, {k: torch.from_numpy(v)
                                for k, v in features.items()})['q_predicted']
  np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                             atol=BANDS[dtype])
  assert quant_lib.param_bytes(twin.params) == jax_quant.param_bytes(
      jax_twin.params)


def test_qtopt_parity_within_band(paired):
  _, _, predictors, _ = paired
  full = predictors['exported'].stateless_serving_fn()
  quant = predictors['exported'].stateless_serving_fn(quantize='int8')
  report = quant_lib.check_parity(full, quant, atol=0.05, rtol=0.05,
                                  calibration_batches=1,
                                  calibration_batch_size=2)
  assert report.ok, report.describe()
  assert 'q_predicted' in report.per_output


# ----------------------------------------------------------- parity + gating


class TestParityGate:

  def test_mock_model_parity_within_band(self):
    predictor = _mock_predictor()
    full = predictor.stateless_serving_fn()
    quant = predictor.stateless_serving_fn(quantize='int8')
    assert quant.program_key == ('quant', 'int8', full.program_key)
    assert quant.version == full.version
    report = quant_lib.check_parity(full, quant, atol=0.05, rtol=0.05)
    assert report.ok, report.describe()
    assert report.max_abs_err < 0.05
    assert 'a_predicted' in report.per_output

  def test_band_violation_rejects_and_serves_full_precision(self):
    """The zero band refuses the twin: full precision serves, bit for bit
    ``predict()``, and the reject is counted once."""
    predictor = _mock_predictor()
    rejects = metrics_lib.counter('serving/quant_parity_rejects')
    r0 = rejects.value
    with batching_lib.DynamicBatcher(
        predictor, max_batch=4, batch_deadline_ms=1.0, quantize='int8',
        quant_parity_atol=0.0, quant_parity_rtol=0.0) as batcher:
      out = batcher.submit(mock_features(0.4, n=2)).result(30.0)
      want = predictor.predict(mock_features(0.4, n=2))
      np.testing.assert_array_equal(out['a_predicted'], want['a_predicted'])
      report = batcher.report()
    assert rejects.value == r0 + 1
    assert report['quantize'] == 'int8'
    assert report['quantized_active'] is False
    assert report['quant_parity_max_abs_err'] > 0.0
    # The gauge is the full-precision dict actually served.
    assert report['param_bytes'] == report['quant_param_bytes_full']

  def test_preparation_error_serves_full_precision(self, monkeypatch):
    predictor = _mock_predictor()
    errors = metrics_lib.counter('serving/quant_errors')
    e0 = errors.value

    def fail(*args, **kwargs):
      raise RuntimeError('no quantization today')

    monkeypatch.setattr(quant_lib.quantization, 'quantize_serving_fn', fail)
    with batching_lib.DynamicBatcher(
        predictor, max_batch=4, batch_deadline_ms=1.0,
        quantize='fp8') as batcher:
      out = batcher.submit(mock_features(0.3)).result(30.0)
      np.testing.assert_array_equal(
          out['a_predicted'],
          predictor.predict(mock_features(0.3))['a_predicted'])
      assert batcher.report()['quantized_active'] is False
    assert errors.value == e0 + 1

  def test_quantized_batcher_within_band_end_to_end(self):
    predictor = _mock_predictor()
    with batching_lib.DynamicBatcher(
        predictor, max_batch=8, batch_deadline_ms=1.0,
        quantize='int8') as batcher:
      out = batcher.submit(mock_features(0.2, n=3)).result(30.0)
      want = predictor.predict(mock_features(0.2, n=3))
      # Within the serving band, not bit for bit.
      np.testing.assert_allclose(out['a_predicted'], want['a_predicted'],
                                 atol=0.05)
      assert not np.array_equal(out['a_predicted'], want['a_predicted'])
      report = batcher.report()
      executor = batcher.current_executor()
    assert report['quantized_active'] is True
    assert 0 < report['param_bytes'] < report['quant_param_bytes_full']
    assert 0.0 < report['quant_param_bytes_ratio'] < 0.45
    assert report['quant_parity_max_abs_err'] < 0.05
    assert executor.param_bytes == report['param_bytes']

  def test_statz_reports_quantization_block_over_http(self):
    predictor = _mock_predictor()
    rejects0 = metrics_lib.counter('serving/quant_parity_rejects').value
    with server_lib.ServingServer(
        predictor, max_batch=4, batch_deadline_ms=1.0,
        quantize='int8') as server:
      with urllib.request.urlopen(server.url + '/statz', timeout=30) as r:
        statz = json.loads(r.read())
    assert statz['quantize'] == 'int8'
    assert statz['quantized_active'] is True
    assert 0 < statz['param_bytes'] < statz['quant_param_bytes_full']
    assert 0.0 < statz['quant_param_bytes_ratio'] < 0.45
    assert statz['quant_parity_rejects'] == rejects0

  def test_fp8_serving_within_loosened_band(self):
    predictor = _mock_predictor()
    with batching_lib.DynamicBatcher(
        predictor, max_batch=4, batch_deadline_ms=1.0, quantize='fp8',
        quant_parity_atol=0.2, quant_parity_rtol=0.2) as batcher:
      out = batcher.submit(mock_features(0.3)).result(30.0)
      want = predictor.predict(mock_features(0.3))
      np.testing.assert_allclose(out['a_predicted'], want['a_predicted'],
                                 atol=0.2)
      assert batcher.report()['quantized_active'] is True


# ------------------------------------------- executor cache + zero rewarms


def _closed_loop(batcher, clients, requests):
  errors = []

  def client(c):
    for i in range(requests):
      try:
        batcher.submit(mock_features(0.01 * (c * 100 + i + 1))).result(30.0)
      except Exception as e:  # pylint: disable=broad-except
        errors.append(repr(e))

  threads = [threading.Thread(target=client, args=(c,), daemon=True)
             for c in range(clients)]
  for thread in threads:
    thread.start()
  for thread in threads:
    thread.join(timeout=120.0)
  return errors


def test_zero_recompiles_quantized_client_sweep():
  """Warm every bucket, then vary the clients 1 -> 12 -> 5 -> 1: the
  bucket counter stays where warm-up left it under the quantized twin."""
  predictor = _mock_predictor()
  compiles = metrics_lib.counter('serving/bucket_compiles')
  with batching_lib.DynamicBatcher(
      predictor, max_batch=16, batch_deadline_ms=0.5,
      quantize='int8') as batcher:
    assert batcher.report()['quantized_active'] is True
    warm = compiles.value
    for clients in (1, 12, 5, 1):
      assert not _closed_loop(batcher, clients, 8)
    assert compiles.value == warm


def test_quantized_cache_keys_separate_precision_variants():
  """Full precision and the twin never share warmed buckets; two twins of
  one program in one mode do (the weights-only swap)."""
  predictor = _mock_predictor()
  full = predictor.stateless_serving_fn()
  quant_a = predictor.stateless_serving_fn(quantize='int8')
  executor = batching_lib.TorchBucketExecutor(quant_a, (1, 2))
  executor.warm()
  quant_b = quant_lib.quantize_serving_fn(full, mode='int8')
  assert executor.compatible_cache(quant_b) == {1, 2}
  assert executor.compatible_cache(full) is None
  assert executor.compatible_cache(
      quant_lib.quantize_serving_fn(full, mode='fp8')) is None
  # Paging keeps the quantized payload.
  assert executor.page_out() == quant_lib.param_bytes(quant_a.params)
  assert executor.page_in()
  out = executor.execute(mock_features(0.5, n=2), 2)
  with torch.inference_mode():
    want = quant_a.fn(quant_a.params, {
        k: torch.from_numpy(v) for k, v in mock_features(0.5, n=2).items()})
  np.testing.assert_array_equal(out['a_predicted'],
                                want['a_predicted'].numpy())


def test_hot_swap_under_load_with_quantization(tmp_path, monkeypatch):
  """4 clients under load while version 2 is exported: no failed request,
  the swap lands, the weights-only swap keeps every warmed bucket, and the
  polls between versions never re-quantize."""
  trainer, model = trained_mock(tmp_path)
  root = str(tmp_path / 'export')
  exporter = exporters.ModelExporter()
  exporter.export(model, trainer.state, root, version=1)
  predictor = ExportedModelPredictor(root, device='cpu')
  assert predictor.restore()
  quantized = []

  def counted(serving, *args, fn=quant_lib.quantization.quantize_serving_fn,
              **kwargs):
    quantized.append(serving.version)
    return fn(serving, *args, **kwargs)

  monkeypatch.setattr(quant_lib.quantization, 'quantize_serving_fn', counted)
  compiles = metrics_lib.counter('serving/bucket_compiles')
  swaps = metrics_lib.counter('serving/model_swaps')
  swaps0 = swaps.value
  with batching_lib.DynamicBatcher(
      predictor, max_batch=8, batch_deadline_ms=1.0,
      reload_interval_secs=0.05, quantize='int8') as batcher:
    assert batcher.model_version == 5
    assert batcher.report()['quantized_active'] is True
    warm = compiles.value
    result = {}
    thread = threading.Thread(target=lambda: result.update(
        errors=_closed_loop(batcher, 4, 40)), daemon=True)
    thread.start()
    time.sleep(0.4)
    assert quantized == [5]  # polls of an unchanged root re-quantize nothing
    exporter.export(model, at_step(trainer, 105), root, version=2)
    deadline = time.time() + 10.0
    while batcher.model_version != 105 and time.time() < deadline:
      time.sleep(0.05)
    assert batcher.model_version == 105
    thread.join(timeout=60.0)
    assert not result['errors'], result['errors'][:3]
    assert swaps.value >= swaps0 + 1
    assert compiles.value == warm
    assert batcher.report()['quantized_active'] is True
    time.sleep(0.3)
  assert quantized == [5, 105]


def test_callable_predictor_ignores_quantize_mode():
  """A predictor without a stateless core batches whole predict() calls
  whatever the quantize knob says."""

  class _Callable(AbstractPredictor):

    def predict(self, features):
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
      return 1

  with batching_lib.DynamicBatcher(
      _Callable(), max_batch=4, batch_deadline_ms=1.0,
      quantize='int8') as batcher:
    out = batcher.submit({'x': np.full((1, 2), 3.0, np.float32)})
    np.testing.assert_array_equal(out.result(10.0)['doubled'], [[6.0, 6.0]])


def test_router_passes_the_quantize_knobs_to_every_model():
  predictors = {'a': _mock_predictor(seed=1), 'b': _mock_predictor(seed=2)}
  router = router_lib.ModelRouter(predictors, max_batch=4,
                                  batch_deadline_ms=1.0, quantize='int8',
                                  quant_parity_atol=0.1,
                                  quant_parity_rtol=0.1)
  with router:
    for name, predictor in predictors.items():
      out = router.submit(mock_features(0.6), model=name).result(30.0)
      np.testing.assert_allclose(
          out['a_predicted'],
          predictor.predict(mock_features(0.6))['a_predicted'], atol=0.1)
      report = router.batcher(name).report()
      assert report['quantize'] == 'int8' and report['quantized_active']


def test_serving_binary_quantize_int8_answers_a_request(tmp_path):
  """``run_serving --quantize int8`` in a process of its own answers a
  predict within the band and shows the quantization block in /statz."""
  predictor = _mock_predictor(seed=3)
  root = str(tmp_path / 'export')
  exporters.ModelExporter().export(
      MockT2RModel(hidden_size=64),
      exporters.ServingState(1, predictor.network.state_dict()), root)
  log = open(tmp_path / 'serving.log', 'w')  # pylint: disable=consider-using-with
  process = subprocess.Popen(
      [sys.executable, '-m', 'tensor2robot_tpu_torch.bin.run_serving',
       '--export_dir', root, '--device', 'cpu', '--port', '0',
       '--max-batch', '4', '--batch-deadline-ms', '1',
       '--reload-interval-secs', '0', '--quantize', 'int8',
       '--quant-parity-atol', '0.05', '--quant-parity-rtol', '0.05'],
      cwd=str(REPO), stdout=subprocess.PIPE, stderr=log, text=True,
      env=dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES=''))
  try:
    line = process.stdout.readline()
    assert line, (tmp_path / 'serving.log').read_text()[-3000:]
    port = json.loads(line)['port']
    request = urllib.request.Request(
        f'http://127.0.0.1:{port}/v1/predict',
        data=json.dumps({'measured_position': [[0.5, 0.25]]}).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(request, timeout=30) as response:
      got = json.loads(response.read())
    with urllib.request.urlopen(f'http://127.0.0.1:{port}/statz',
                                timeout=30) as response:
      statz = json.loads(response.read())
    want = predictor.predict(
        {'measured_position': np.array([[0.5, 0.25]], np.float32)})
    np.testing.assert_allclose(np.asarray(got['outputs']['a_predicted'],
                                          np.float32),
                               want['a_predicted'], atol=0.05)
    assert statz['quantize'] == 'int8' and statz['quantized_active'] is True
    assert 0.0 < statz['quant_param_bytes_ratio'] < 0.45
    process.send_signal(signal.SIGTERM)
    assert process.wait(timeout=60) == 0
  finally:
    if process.poll() is None:
      process.kill()
    process.wait(timeout=30)
    log.close()
