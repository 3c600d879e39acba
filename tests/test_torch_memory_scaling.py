"""Port parity: microbatch accumulation and activation recompute.

The port's counterparts of the JAX package's ``tests/test_memory_scaling.py``
(accumulation, its divisibility, its composition with K steps a dispatch,
the guard over accumulated gradients; remat's equivalence, parameter
trees and policy check), on the CPU:

* ``grad_accum_microbatches`` M on a model without batch norm equals the
  full batch (M=1) within the JAX test's float32 band (rtol 1e-6, atol
  1e-7 on parameters and EMA, 1e-5 relative on the loss: the sum of M
  microbatch means is reassociated), and the port's M=2 run matches the
  JAX trainer's M=2 run from the same seeded weights within the trainer
  parity band of ``tests/test_torch_train_eval.py`` (each parameter's
  change within 1e-3 of that change's largest magnitude plus four float32
  ulps; the loss 5e-5 absolute);
* a batch that M does not divide raises; K=2 x M=2 is bit for bit K=1 x
  M=2; on QT-Opt's critic, with batch norm ("ghost batch norm": each
  microbatch's statistics), the trainer's step is bit for bit the eager
  accumulation written out by hand;
* one NaN microbatch skips the whole batch's update (bit for bit a run
  that never drew it), and ``'raise'`` fires for it;
* ``remat_policy`` 'conv_towers' and 'full' train bit for bit as 'none' on
  a narrow Grasping44 (two steps: parameters, batch statistics moved once
  a step, EMA), and the port's remat step lies within the trainer parity
  band of the JAX package's remat step; ``state_dict`` keys are the same
  with and without remat; an unknown policy raises ``ValueError``.

About 20 s alone on the CPU.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_training import (BATCH, IMAGE, NUM_CONVS, _assert_band,
                                 _assert_change_band, _batches, _variables)
from torch import nn
from torch_port_weights import random_variables

from tensor2robot_tpu.layers import remat as jax_remat
from tensor2robot_tpu.models import optimizers as jax_optimizers
from tensor2robot_tpu.research.qtopt import GraspingModelWrapper as JaxWrapper
from tensor2robot_tpu.specs import SpecStruct as JaxSpecStruct
from tensor2robot_tpu.train.trainer import Trainer as JaxTrainer
from tensor2robot_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from tensor2robot_tpu.utils.mocks import MockT2RModel as JaxMockModel
from tensor2robot_tpu_torch.layers import remat
from tensor2robot_tpu_torch.layers.vision_layers import (Dense,
                                                         ImagesToFeaturesModel)
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.research.qtopt import (GraspingModelWrapper,
                                                   networks)
from tensor2robot_tpu_torch.train import Trainer, TrainerConfig, resilience
from tensor2robot_tpu_torch.utils import convert
from tensor2robot_tpu_torch.utils.mocks import MockT2RModel

# ------------------------------------------------------- a BN-free model


class _MLP(nn.Module):
  """Dense, relu, Dense, relu, Dense(1): no batch coupling."""

  def __init__(self):
    super().__init__()
    self.dense_0, self.dense_1, self.dense_2 = (Dense(2, 16), Dense(16, 16),
                                                Dense(16, 1))

  def init_weights(self, generator=None):
    for dense in (self.dense_0, self.dense_1, self.dense_2):
      dense.init_weights(generator)

  def forward(self, features):
    x = features['measured_position'].float()
    x = torch.relu(self.dense_0(x))
    x = torch.relu(self.dense_1(x))
    return {'a_predicted': self.dense_2(x).squeeze(-1)}


class NoBNModel(MockT2RModel):

  def create_module(self):
    return _MLP()


class _JaxMLP(fnn.Module):

  @fnn.compact
  def __call__(self, features, train: bool = False):
    del train
    x = features['measured_position'].astype(jnp.float32)
    x = fnn.relu(fnn.Dense(16)(x))
    x = fnn.relu(fnn.Dense(16)(x))
    return {'a_predicted': jnp.squeeze(fnn.Dense(1)(x), axis=-1)}


class JaxNoBNModel(JaxMockModel):

  def create_module(self):
    return _JaxMLP()


def point_batches(count, batch=8, seed=0):
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(count):
    points = rng.uniform(-1.0, 1.0, (batch, 2)).astype(np.float32)
    out.append(({'measured_position': points},
                {'valid_position': (points.sum(axis=1) > 0).astype(
                    np.float32)}))
  return out


def mlp_variables():
  shapes = jax.eval_shape(lambda: _JaxMLP().init(
      jax.random.PRNGKey(0), {'measured_position': jnp.zeros((1, 2))}))
  return random_variables(shapes, seed=5)


def load_mlp(network, variables):
  params = variables['params']
  with torch.no_grad():
    for i in range(3):
      dense = getattr(network, f'dense_{i}')
      dense.weight.copy_(torch.from_numpy(
          np.asarray(params[f'Dense_{i}']['kernel']).T.copy()))
      dense.bias.copy_(torch.from_numpy(
          np.asarray(params[f'Dense_{i}']['bias'])))


def fast_adam():
  return optimizers.create_adam_optimizer(1e-2)


def train_no_bn(m, batches, k=1, variables=None, **cfg):
  kwargs = {}
  if variables is not None:
    kwargs['init_from_checkpoint_fn'] = lambda net: load_mlp(net, variables)
  model = NoBNModel(device_type='cpu', create_optimizer_fn=fast_adam,
                    **kwargs)
  trainer = Trainer(model, TrainerConfig(
      max_train_steps=len(batches), log_interval_steps=0,
      eval_interval_steps=0, steps_per_dispatch=k,
      grad_accum_microbatches=m, **cfg), device='cpu')
  scalars = trainer.train(iter(batches))
  return trainer, scalars


def assert_params_close(a, b, rtol=1e-6, atol=1e-7):
  assert a.step == b.step
  for (name, x), y in zip(a.state.network.state_dict().items(),
                          b.state.network.state_dict().values()):
    np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=rtol, atol=atol,
                               err_msg=name)
  for name in a.state.ema or {}:
    np.testing.assert_allclose(a.state.ema[name].numpy(),
                               b.state.ema[name].numpy(), rtol=rtol,
                               atol=atol, err_msg=f'ema {name}')


def assert_bitwise(a, b):
  assert a.step == b.step
  for (name, x), y in zip(a.state.network.state_dict().items(),
                          b.state.network.state_dict().values()):
    assert torch.equal(x, y), name
  for name in a.state.ema or {}:
    assert torch.equal(a.state.ema[name], b.state.ema[name]), name
  sa, sb = a.state.optimizer.state_dict(), b.state.optimizer.state_dict()
  assert sa['param_groups'] == sb['param_groups']
  for index, slots in sa['state'].items():
    for slot, value in slots.items():
      assert torch.equal(value, sb['state'][index][slot]), (index, slot)
  assert torch.equal(a.state.generator.get_state(),
                     b.state.generator.get_state())


# --------------------------------------------------------- accumulation


@pytest.mark.parametrize('m', [2, 4])
def test_grad_accum_matches_full_batch_without_bn(m):
  batches = point_batches(6)
  full, full_scalars = train_no_bn(1, batches)
  accum, accum_scalars = train_no_bn(m, batches)
  assert_params_close(full, accum)
  np.testing.assert_allclose(full_scalars['loss'], accum_scalars['loss'],
                             rtol=1e-5)


def test_grad_accum_matches_the_jax_trainer():
  variables = mlp_variables()
  batches = point_batches(4)
  model = JaxNoBNModel(
      device_type='cpu',
      create_optimizer_fn=lambda: jax_optimizers.create_adam_optimizer(1e-2),
      init_from_checkpoint_fn=lambda params, state: (variables['params'],
                                                     state))
  jax_trainer = JaxTrainer(model, JaxTrainerConfig(
      model_dir='', max_train_steps=4, eval_interval_steps=0,
      log_interval_steps=0, prefetch_batches=0, auto_input_layouts=False,
      grad_accum_microbatches=2))
  jax_batches = []
  for features, labels in batches:
    f, l = JaxSpecStruct(), JaxSpecStruct()
    f['measured_position'] = features['measured_position']
    l['valid_position'] = labels['valid_position']
    jax_batches.append((f, l))
  want_scalars = jax_trainer.train(iter(jax_batches), None)
  port, scalars = train_no_bn(2, batches, variables=variables)
  assert port.step == int(jax_trainer.step) == 4
  np.testing.assert_allclose(scalars['loss'], float(want_scalars['loss']),
                             rtol=0, atol=5e-5)
  start = NoBNModel(device_type='cpu').create_module()
  load_mlp(start, variables)
  begin = start.state_dict()
  got = port.state.network.state_dict()
  params = jax.device_get(jax_trainer.state.params)
  for i in range(3):
    for leaf, want in (('weight', np.asarray(params[f'Dense_{i}']['kernel']).T),
                       ('bias', np.asarray(params[f'Dense_{i}']['bias']))):
      name = f'dense_{i}.{leaf}'
      _assert_change_band(got[name], torch.from_numpy(want.copy()),
                          begin[name], 1e-3, name)


def test_grad_accum_requires_a_divisible_batch():
  with pytest.raises(ValueError, match='does not divide the batch'):
    train_no_bn(3, point_batches(1))


def test_grad_accum_composes_with_steps_per_dispatch():
  batches = point_batches(8)
  single, _ = train_no_bn(2, batches)
  grouped, _ = train_no_bn(2, batches, k=2)
  assert_bitwise(single, grouped)
  full, _ = train_no_bn(1, batches)
  assert_params_close(full, grouped)


def _qtopt(**kwargs):
  return GraspingModelWrapper(device_type='cpu', input_shape=(88, 88, 3),
                              target_shape=(80, 80), num_convs=(2, 2, 1),
                              **kwargs)


def _qtopt_batches(count, seed=0, batch=4):
  rng = np.random.RandomState(seed)
  return [({'state/image': rng.randint(0, 256, (batch, 88, 88, 3)).astype(
      np.uint8),
            'action/world_vector': rng.randn(batch, 3).astype(np.float32),
            'action/vertical_rotation': rng.randn(batch, 2).astype(
                np.float32)},
           {'reward': rng.randint(0, 2, (batch, 1)).astype(np.float32)})
          for _ in range(count)]


def test_grad_accum_is_the_eager_accumulation_with_ghost_batch_norm():
  """One step of QT-Opt's critic at M=2 (batch norm in train mode) against
  the accumulation written out: preprocess the batch once, forward and
  backward each half, divide the summed float32 gradients by 2, step."""
  batch = _qtopt_batches(1)
  trainer = Trainer(_qtopt(), TrainerConfig(
      max_train_steps=1, log_interval_steps=0, grad_accum_microbatches=2),
                    device='cpu')
  trainer.train(iter(batch))

  model = _qtopt()
  reference = Trainer(model, TrainerConfig(max_train_steps=0), device='cpu')
  state = reference.initialize(batch[0][0])
  features, labels = model.preprocessor.preprocess(
      {k: torch.from_numpy(v) for k, v in batch[0][0].items()},
      {k: torch.from_numpy(v) for k, v in batch[0][1].items()},
      ModeKeys.TRAIN, state.generator)
  losses = []
  for half in (slice(0, 2), slice(2, 4)):
    f = {k: v[half] for k, v in features.items()}
    l = {k: v[half] for k, v in labels.items()}
    outputs = model.inference_network_fn(state.network, f, l, ModeKeys.TRAIN)
    loss, _ = model.model_train_fn(f, l, outputs, ModeKeys.TRAIN)
    loss.backward()
    losses.append(loss.detach())
  for p in state.network.parameters():
    p.grad.div_(2.0)
  state.optimizer.step()
  for (name, got), want in zip(trainer.state.network.state_dict().items(),
                               state.network.state_dict().values()):
    assert torch.equal(got, want), name


def test_nonfinite_skip_update_over_accumulated_grads():
  b = point_batches(4, seed=2)
  poisoned = list(b)
  f = b[1][0]['measured_position'].copy()
  f[5, 0] = np.nan  # one row of the second microbatch
  poisoned[1] = ({'measured_position': f}, b[1][1])
  run, _ = train_no_bn(2, poisoned, nonfinite_mode='skip_update')
  assert run.nonfinite_policy.bad_steps == 1 and run.step == 3
  clean, _ = train_no_bn(2, [b[0], b[2], b[3]], nonfinite_mode='skip_update')
  assert_bitwise(run, clean)


def test_nonfinite_raise_fires_for_a_single_bad_microbatch():
  b = point_batches(2, seed=3)
  f = b[0][0]['measured_position'].copy()
  f[1, 1] = np.inf
  with pytest.raises(resilience.NonFiniteError, match='policy=raise'):
    train_no_bn(2, [({'measured_position': f}, b[0][1]), b[1]],
                nonfinite_mode='raise')


# --------------------------------------------------------------- remat


@pytest.mark.parametrize('policy', ['conv_towers', 'full'])
def test_remat_training_is_bitwise_none(policy):
  batches = _qtopt_batches(2, seed=4)

  def run(name):
    trainer = Trainer(_qtopt(remat_policy=name), TrainerConfig(
        max_train_steps=2, log_interval_steps=0), device='cpu')
    return trainer, trainer.train(iter(batches))

  plain, plain_scalars = run('none')
  recomputed, scalars = run(policy)
  assert plain_scalars == scalars
  assert_bitwise(plain, recomputed)  # batch statistics included: moved once


def test_batch_statistics_move_once_under_recompute():
  network = networks.Grasping44(image_size=(80, 80), num_convs=(1, 1, 1),
                                remat_policy='full')
  network.init_weights(torch.Generator().manual_seed(0))
  network.train()
  updates = []
  real = remat.recomputing

  def spy():
    updates.append(real())
    return updates[-1]

  try:
    remat.recomputing = spy
    images = torch.rand(2, 80, 80, 3,
                        generator=torch.Generator().manual_seed(1))
    logits, _ = network(images, torch.rand(
        2, 5, generator=torch.Generator().manual_seed(2)))
    logits.sum().backward()
  finally:
    remat.recomputing = real
  # Every batch norm asked once in the forward (bn1, the three tower
  # blocks', the grasp embedding's and the two dense layers'); the three
  # tower blocks asked again in the backward's recompute and skipped.
  assert updates.count(False) == 1 + 3 + 3
  assert updates.count(True) == 3


def test_remat_step_matches_the_jax_remat_step():
  variables = _variables()
  jax_model = JaxWrapper(
      device_type='cpu', input_shape=IMAGE, target_shape=IMAGE[:2],
      num_convs=NUM_CONVS, remat_policy='conv_towers',
      init_from_checkpoint_fn=lambda params, state: (
          variables['params'], {'batch_stats': variables['batch_stats']}))
  jax_trainer = JaxTrainer(jax_model, JaxTrainerConfig(
      model_dir='', max_train_steps=1, eval_interval_steps=0,
      log_interval_steps=0))
  want_scalars = jax_trainer.train(iter(_batches(count=1)), None)
  model = GraspingModelWrapper(
      device_type='cpu', input_shape=IMAGE, target_shape=IMAGE[:2],
      num_convs=NUM_CONVS, kernel_policy='pool_conv',
      remat_policy='conv_towers',
      init_from_checkpoint_fn=lambda network: network.load_state_dict(
          convert.jax_variables_to_torch(variables)))
  trainer = Trainer(model, TrainerConfig(max_train_steps=1,
                                         log_interval_steps=0), device='cpu')
  scalars = trainer.train(iter(_batches(count=1)))
  assert BATCH == 4
  for key in ('loss', 'q_mean'):
    np.testing.assert_allclose(scalars[key], float(want_scalars[key]),
                               rtol=0, atol=5e-5, err_msg=key)
  start = convert.jax_variables_to_torch(variables)
  want = convert.jax_variables_to_torch(
      jax.device_get(dict(jax_trainer.state.variables)))
  got = trainer.state.network.state_dict()
  params = {name for name, _ in trainer.state.network.named_parameters()}
  for name in want:
    if name in params:
      _assert_change_band(got[name], want[name], start[name], 1e-3, name)
    else:
      _assert_band(got[name], want[name], 1e-5, name)


def test_state_dict_keys_are_the_same_with_and_without_remat():
  for policy in remat.REMAT_POLICIES:
    assert (list(networks.Grasping44(num_convs=(2, 2, 1),
                                     remat_policy=policy).state_dict()) ==
            list(networks.Grasping44(num_convs=(2, 2, 1)).state_dict()))
    assert (list(ImagesToFeaturesModel(remat_policy=policy).state_dict()) ==
            list(ImagesToFeaturesModel().state_dict()))


def test_invalid_remat_policy_raises():
  for validate in (remat.validate_remat_policy,
                   jax_remat.validate_remat_policy):
    with pytest.raises(ValueError, match='Unknown remat_policy'):
      validate('everything')
  with pytest.raises(ValueError, match='Unknown remat_policy'):
    GraspingModelWrapper(device_type='cpu', remat_policy='everything')
  assert remat.REMAT_POLICIES == jax_remat.REMAT_POLICIES
