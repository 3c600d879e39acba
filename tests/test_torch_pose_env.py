"""Port parity: the pose_env models, and the first convergence gate.

* Forward: ``PoseEnvRegressionModel`` and ``PoseEnvContinuousMCModel`` of
  the port, with the JAX models' initial variables converted by
  ``utils/convert.pose_env_variables_to_torch``, give the JAX outputs on
  the same uint8 images within 2e-5 of the outputs' largest magnitude
  (float32; the convs' sums are reassociated).
* One training step on the same batch: the loss within 1e-5; under plain
  SGD (lr 0.1) each parameter's change, and under the default Adam (1e-4)
  each first moment, within 1e-3 of its largest magnitude (plus four
  float32 ulps of the parameter's magnitude for the change); the tower's
  final LayerNorm bias, which the spatial softmax is invariant to, has a
  gradient below 1e-6 in both.
* The 50-step check of ``tests/test_pose_env.py::
  test_regression_trains_on_records`` with its threshold formula, fed by
  the port's record generator.
* The convergence gate of ``tests/test_pose_env.py::
  test_regression_converges_to_recorded_baseline``: 800 steps on the
  checked-in records, generator seeds 7 and 8, eval ``pose_mse <=
  1.5e-3``. Its CPU time alone is given in ``CHANGES.md``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.models import optimizers as jax_optimizers
from tensor2robot_tpu.modes import ModeKeys as JaxModeKeys
from tensor2robot_tpu.research.pose_env import (
    PoseEnvContinuousMCModel as JaxCritic)
from tensor2robot_tpu.research.pose_env import (
    PoseEnvRegressionModel as JaxRegression)
from tensor2robot_tpu.train.trainer import Trainer as JaxTrainer
from tensor2robot_tpu.train.trainer import TrainerCallback as JaxCallback
from tensor2robot_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from tensor2robot_tpu_torch.data.input_generators import (
    DefaultRecordInputGenerator)
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.research.pose_env import (
    PoseEnvContinuousMCModel, PoseEnvRegressionModel)
from tensor2robot_tpu_torch.train import Trainer, TrainerConfig, train_eval_model
from tensor2robot_tpu_torch.utils import convert

TEST_DATA = os.path.join(os.path.dirname(__file__), 'test_data',
                         'pose_env_test_data.tfrecord')
BATCH = 4
MODELS = {'regression': (PoseEnvRegressionModel, JaxRegression),
          'critic': (PoseEnvContinuousMCModel, JaxCritic)}


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _batch(kind, seed=0):
  rng = np.random.RandomState(seed)
  features = {'state/image': rng.randint(0, 256, (BATCH, 64, 64, 3),
                                         dtype=np.uint8)}
  labels = {'reward': -rng.rand(BATCH, 1).astype(np.float32)}
  if kind == 'regression':
    labels['target_pose'] = rng.randn(BATCH, 2).astype(np.float32)
  else:
    features['action/pose'] = rng.randn(BATCH, 2).astype(np.float32)
  return features, labels


def _jax_variables(kind):
  model = MODELS[kind][1](device_type='cpu')
  features, _ = _batch(kind)
  features_p, _ = model.preprocessor.preprocess(
      dict(features), None, JaxModeKeys.PREDICT, None)
  return jax.device_get(model.init_variables(jax.random.PRNGKey(3),
                                             features_p))


def _assert_band(got, want, band, what, resolution=0.0):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  scale = float(np.abs(want).max())
  err = float(np.abs(got - want).max())
  assert err <= band * max(scale, 1e-12) + resolution, (what, err, scale)


@pytest.mark.parametrize('kind', sorted(MODELS))
def test_forward_matches_jax(kind):
  variables = _jax_variables(kind)
  port_cls, jax_cls = MODELS[kind]
  jax_model = jax_cls(device_type='cpu')
  model = port_cls(device_type='cpu')
  network = model.create_module()
  state_dict = convert.pose_env_variables_to_torch(variables)
  network.load_state_dict(state_dict, strict=True)
  features, _ = _batch(kind, seed=1)
  jax_features, _ = jax_model.preprocessor.preprocess(
      dict(features), None, JaxModeKeys.PREDICT, None)
  want, _ = jax_model.inference_network_fn(variables, jax_features, None,
                                           JaxModeKeys.PREDICT)
  port_features, _ = model.preprocessor.preprocess(
      {k: torch.from_numpy(v) for k, v in features.items()}, None,
      ModeKeys.PREDICT)
  with torch.no_grad():
    got = model.inference_network_fn(network, port_features, None,
                                      ModeKeys.PREDICT)
  assert set(got) == set(want)
  for key in want:
    _assert_band(got[key].numpy(), np.asarray(want[key]), 2e-5, key)


class _Snapshot(JaxCallback):

  def after_step(self, trainer, step, scalars):
    self.scalars = {k: float(v) for k, v in scalars.items()}
    self.params = jax.device_get(trainer.state.params)
    self.opt_state = jax.device_get(trainer.state.opt_state)


OPTIMIZERS = {  # (JAX factory, port factory); None: the default Adam
    'sgd': (lambda: jax_optimizers.create_gradient_descent_optimizer(0.1),
            lambda: optimizers.create_gradient_descent_optimizer(0.1)),
    'adam': (None, None),
}
# The tower's final LayerNorm bias feeds the spatial softmax, which is
# invariant to it: its gradient is float32 rounding noise.
INVARIANT = ('state_features.final_norm.bias',)


@pytest.mark.parametrize('optimizer', sorted(OPTIMIZERS))
@pytest.mark.parametrize('kind', sorted(MODELS))
def test_one_training_step_matches_jax(kind, optimizer):
  """SGD: each parameter's change (the gradient times 0.1). Adam: its
  first moment (the gradient times 0.1), since its first step divides
  each gradient by its own magnitude plus 1e-8 and turns gradients that
  are rounding noise (a relu at 0, an invariant bias) into steps of
  +-lr."""
  variables = _jax_variables(kind)
  port_cls, jax_cls = MODELS[kind]
  jax_optimizer, port_optimizer = OPTIMIZERS[optimizer]
  batch = _batch(kind, seed=2)
  jax_model = jax_cls(device_type='cpu', create_optimizer_fn=jax_optimizer,
                      init_from_checkpoint_fn=lambda p, s: (
                          variables['params'], s))
  snapshot = _Snapshot()
  JaxTrainer(jax_model, JaxTrainerConfig(
      model_dir='', max_train_steps=1, eval_interval_steps=0,
      log_interval_steps=0), callbacks=[snapshot]).train(iter([batch]), None)
  start = convert.pose_env_variables_to_torch(variables)
  model = port_cls(device_type='cpu', create_optimizer_fn=port_optimizer,
                   init_from_checkpoint_fn=lambda net: (
                       net.load_state_dict(start)))
  trainer = Trainer(model, TrainerConfig(max_train_steps=1,
                                         log_interval_steps=0), device='cpu')
  scalars = trainer.train(iter([batch]))
  np.testing.assert_allclose(scalars['loss'], snapshot.scalars['loss'],
                             rtol=0, atol=1e-5)
  network = trainer.state.network
  if optimizer == 'sgd':
    want = convert.pose_env_variables_to_torch({'params': snapshot.params})
    want = {k: v - start[k] for k, v in want.items()}
    got = {k: v - start[k] for k, v in network.state_dict().items()}
  else:
    _, mu, _ = convert._optax_parts(snapshot.opt_state)['adam']  # pylint: disable=protected-access
    want = convert.pose_env_variables_to_torch({'params': mu})
    state = trainer.state.optimizer.state
    got = {k: state[p]['mu'] for k, p in network.named_parameters()}
  assert set(got) == set(want)
  for name, value in want.items():
    if name in INVARIANT:
      assert float(value.abs().max()) < 1e-6, name
      assert float(got[name].abs().max()) < 1e-6, name
      continue
    ulps = 4 * np.finfo(np.float32).eps * float(start[name].abs().max())
    _assert_band(got[name].numpy(), value.numpy(), 1e-3, name,
                 resolution=ulps if optimizer == 'sgd' else 0.0)
    assert bool(value.abs().max() > 0), name


def _train_on_records(tmp_path, steps, seeds):
  model = PoseEnvRegressionModel(device_type='gpu')
  return train_eval_model(
      model=model, model_dir=str(tmp_path / 'm'),
      train_input_generator=DefaultRecordInputGenerator(
          file_patterns=TEST_DATA, batch_size=16, seed=seeds[0]),
      eval_input_generator=DefaultRecordInputGenerator(
          file_patterns=TEST_DATA, batch_size=16, seed=seeds[1]),
      max_train_steps=steps, eval_steps=4, eval_interval_steps=0,
      save_interval_steps=steps, log_interval_steps=0, device='cpu')


def test_regression_trains_on_records(tmp_path):
  """The 50-step check: within ~2 orders of magnitude of the recorded
  converged error, by ``tests/test_pose_env.py``'s threshold formula."""
  metrics = _train_on_records(tmp_path, 50, (0, 1))
  assert np.isfinite(metrics['pose_mse'])
  baseline = os.path.join(os.path.dirname(TEST_DATA), '..', '..',
                          'BASELINE.json')
  with open(baseline) as f:
    measured = json.load(f).get('measured', {}).get('pose_env_eval_mse')
  threshold = max(100 * measured, 0.2) if measured else 1.0
  assert metrics['pose_mse'] < threshold, metrics['pose_mse']


def test_regression_converges_to_recorded_baseline(tmp_path):
  """The convergence gate: 800 steps from the port's record feed, seeds 7
  (train) and 8 (eval), to an eval pose_mse of at most 1.5e-3."""
  metrics = _train_on_records(tmp_path, 800, (7, 8))
  assert metrics['pose_mse'] <= 1.5e-3, metrics['pose_mse']
