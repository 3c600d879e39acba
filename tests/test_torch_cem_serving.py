"""Port parity, end to end: predictor -> CEM serving against the JAX package.

Both packages serve the same seeded numpy weights (the JAX predictor's
variables are replaced by them; the port loads them through
``CheckpointPredictor.load_variables``) on the tiny QT-Opt config of
``tests/test_qtopt.py`` (96x112 frames, 80x80 crop, ``num_convs=(2, 2,
1)``) with ``kernel_policy='pool_conv'``: the JAX side runs its Pallas
kernels through the interpreter, the port its plain versions on the CPU.

The weights have std 1/sqrt(fan_in), so candidate actions score apart
(checked below); with a fresh critic's 0.01 init every candidate scores
within float32 epsilon of 0.5 and action equality would be a tie-break.

Tolerances: float32 ``q_predicted`` atol 1e-6; CEM actions and final
mean/stddev atol 1e-5 (the same elites, refit in float32 in another
order). The bfloat16 case (port ``device_type='gpu'`` against JAX
``device_type='tpu'``, both on the CPU) compares ``q_predicted`` at atol
4e-3, two bfloat16 ulps of a q in [0.25, 0.5): the two frameworks round
to bfloat16 at different points (torch adds a dense bias inside the
float32 accumulation, XLA after rounding the product).
"""

import jax
import numpy as np
import pytest
import torch
from torch_port_weights import random_variables

from tensor2robot_tpu.ops import _pallas_dispatch
from tensor2robot_tpu.policies import CEMPolicy as JaxCEMPolicy
from tensor2robot_tpu.predictors import (
    CheckpointPredictor as JaxCheckpointPredictor)
from tensor2robot_tpu.research.qtopt import (
    GraspingModelWrapper as JaxGraspingModelWrapper)
from tensor2robot_tpu_torch.policies import CEMPolicy
from tensor2robot_tpu_torch.predictors import CheckpointPredictor
from tensor2robot_tpu_torch.research.qtopt import GraspingModelWrapper

CONFIG = dict(input_shape=(96, 112, 3), target_shape=(80, 80),
              num_convs=(2, 2, 1), kernel_policy='pool_conv')
CEM = dict(action_size=5, cem_samples=16, cem_iters=3, num_elites=4)


def _serving_pair(jax_device_type, torch_device_type):
  jax_model = JaxGraspingModelWrapper(device_type=jax_device_type, **CONFIG)
  jax_predictor = JaxCheckpointPredictor(jax_model, model_dir='unused')
  with _pallas_dispatch.force_kernels(True):
    jax_predictor.init_randomly()
  variables = random_variables(jax.device_get(jax_predictor._variables),  # pylint: disable=protected-access
                               seed=1)
  jax_predictor._variables = variables  # pylint: disable=protected-access
  model = GraspingModelWrapper(device_type=torch_device_type, **CONFIG)
  predictor = CheckpointPredictor(model, device='cpu')
  predictor.load_variables(variables)
  return jax_model, jax_predictor, model, predictor


@pytest.fixture(scope='module')
def f32_pair():
  return _serving_pair('cpu', 'cpu')


@pytest.fixture(scope='module')
def state():
  return np.random.RandomState(0).randint(
      0, 256, CONFIG['input_shape']).astype(np.uint8)


def _q(model, predictor, state, samples):
  with _pallas_dispatch.force_kernels(True):
    return predictor.predict(
        model.pack_features(state, samples, 0))['q_predicted']


def test_predict_matches_jax_and_scores_are_distinct(f32_pair, state):
  jax_model, jax_predictor, model, predictor = f32_pair
  samples = np.random.RandomState(1).randn(16, 5).astype(np.float32)
  want = _q(jax_model, jax_predictor, state, samples)
  got = _q(model, predictor, state, samples)
  assert got.shape == (16,) and got.dtype == np.float32
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
  # Distinct scores: the closest pair is far wider than the tolerance.
  assert np.diff(np.sort(want)).min() > 1e-4


def test_device_serving_fn_matches_predict(f32_pair, state):
  _, _, model, predictor = f32_pair
  samples = np.random.RandomState(2).randn(8, 5).astype(np.float32)
  packed = model.pack_features(state, samples, 0)
  fn = predictor.device_serving_fn()
  got = fn({k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in packed.items()})['q_predicted']
  np.testing.assert_array_equal(got.numpy(),
                                predictor.predict(packed)['q_predicted'])


@pytest.mark.parametrize('seed', [5, 11])
def test_device_resident_cem_selects_jax_action(f32_pair, state, seed):
  jax_model, jax_predictor, model, predictor = f32_pair
  np.random.seed(seed)
  with _pallas_dispatch.force_kernels(True):
    want, want_debug = JaxCEMPolicy(
        t2r_model=jax_model, predictor=jax_predictor, device_resident=True,
        **CEM).get_cem_action_device(state, None, 0)
  np.random.seed(seed)
  got, debug = CEMPolicy(
      t2r_model=model, predictor=predictor, device_resident=True,
      **CEM).get_cem_action_device(state, None, 0)
  assert got.shape == (5,)
  np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
  for key in ('mean', 'stddev'):
    np.testing.assert_allclose(debug['final_params'][key],
                               np.asarray(want_debug['final_params'][key]),
                               rtol=0, atol=1e-5)
  assert abs(debug['q_predicted'] - want_debug['q_predicted']) < 1e-5


@pytest.mark.parametrize('seed', [5, 11])
def test_numpy_cem_selects_jax_action(f32_pair, state, seed):
  jax_model, jax_predictor, model, predictor = f32_pair
  np.random.seed(seed)
  with _pallas_dispatch.force_kernels(True):
    want = JaxCEMPolicy(t2r_model=jax_model, predictor=jax_predictor,
                        **CEM).SelectAction(state, None, 0)
  np.random.seed(seed)
  got = CEMPolicy(t2r_model=model, predictor=predictor,
                  **CEM).SelectAction(state, None, 0)
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
  # The device path draws the same np.random stream: same action.
  np.random.seed(seed)
  device = CEMPolicy(t2r_model=model, predictor=predictor,
                     device_resident=True, **CEM).SelectAction(state, None, 0)
  np.testing.assert_allclose(device, got, rtol=0, atol=1e-5)


def test_bfloat16_policy_predict_band(state):
  jax_model, jax_predictor, model, predictor = _serving_pair('tpu', 'gpu')
  assert model.compute_dtype == torch.bfloat16
  assert predictor.network.conv1_1.dtype == torch.bfloat16
  samples = np.random.RandomState(3).randn(16, 5).astype(np.float32)
  want = _q(jax_model, jax_predictor, state, samples)
  got = _q(model, predictor, state, samples)
  assert got.dtype == np.float32
  np.testing.assert_allclose(got, want, rtol=0, atol=4e-3)
