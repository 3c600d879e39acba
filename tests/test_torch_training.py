"""Port parity: the QT-Opt training step against the JAX package.

Module level: the losses, the three optimizers of ``build_opt`` over three
steps against optax, the staircase schedule, the EMA, TRAIN preprocessing,
and Grasping44's gradients in train mode against ``jax.grad`` of the JAX
module (its Pallas pool and conv kernels interpreted on the CPU,
``force_kernels(True)``; the port runs the kernels' plain versions).

Slice level: the port's ``Trainer`` against the JAX ``Trainer`` after 1 and
3 steps, from the same seeded numpy weights (the port's through
``utils/convert.py``, handed to both as the warm-start hook) on the same
batches. ``input_shape == target_shape`` makes both random crops take
offset 0, so no random stream has to be shared. The JAX trainer runs its
``kernel_policy='none'`` arm (the arm its own kernels are held to by
``tests/test_kernels.py``); the port runs ``'pool_conv'``, i.e. its kernel
entries' plain versions, whose gradients the module tests above hold to the
JAX kernels.

All on the tiny config of ``tests/test_qtopt.py``: 80x80 images,
``num_convs=(2, 2, 1)``, float32, batch 4. Bands (float32; sums are
reassociated, and train-mode batch norm over a batch of 4 divides by small
variances, which amplifies that noise):

* losses and optax-formula optimizers: 1e-6 absolute on values of order 1;
* Grasping44 gradients: each leaf within 5e-4 of its largest magnitude
  (observed up to 1.2e-4);
* trainer: loss and q_mean 5e-5 absolute (observed up to 7e-6 by step 3);
  each parameter's change since the start within 1e-3 of that change's
  largest magnitude (observed up to 4.9e-4, on the grasp embedding's
  batch-norm bias) plus four float32 ulps of the parameter's magnitude,
  the resolution of a difference of float32 values (the change of a 1e-4
  learning rate is far below the parameters' own scale, so comparing the
  parameters themselves would hold almost nothing); the EMA, whose change at decay 0.9999 is below float32
  resolution for most elements, within 1e-6 of its largest magnitude;
  batch statistics 1e-5 of their largest magnitude.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_weights import random_variables

from tensor2robot_tpu.models import critic_model as jax_critic
from tensor2robot_tpu.modes import ModeKeys as JaxModeKeys
from tensor2robot_tpu.ops import _pallas_dispatch
from tensor2robot_tpu.research.qtopt import GraspingModelWrapper as JaxWrapper
from tensor2robot_tpu.research.qtopt import build_opt as jax_build_opt
from tensor2robot_tpu.research.qtopt import networks as jax_networks
from tensor2robot_tpu.train import train_state as jax_train_state
from tensor2robot_tpu.train.trainer import Trainer as JaxTrainer
from tensor2robot_tpu.train.trainer import TrainerCallback
from tensor2robot_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from tensor2robot_tpu_torch.data.input_generators import (
    DefaultRandomInputGenerator)
from tensor2robot_tpu_torch.models import critic_model, optimizers
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.predictors import CheckpointPredictor
from tensor2robot_tpu_torch.research.qtopt import (GraspingModelWrapper,
                                                   build_opt, networks)
from tensor2robot_tpu_torch.train import (Trainer, TrainerConfig, apply_ema,
                                          create_train_state,
                                          train_eval_model)
from tensor2robot_tpu_torch.utils import convert

IMAGE = (80, 80, 3)
NUM_CONVS = (2, 2, 1)
BATCH = 4
STEPS = 3


def _batches(seed=0, count=STEPS):
  rng = np.random.RandomState(seed)
  batches = []
  for _ in range(count):
    features = {
        'state/image': rng.randint(0, 256, (BATCH,) + IMAGE).astype(np.uint8),
        'action/world_vector': rng.randn(BATCH, 3).astype(np.float32),
        'action/vertical_rotation': rng.randn(BATCH, 2).astype(np.float32),
    }
    labels = {'reward': rng.randint(0, 2, (BATCH, 1)).astype(np.float32)}
    batches.append((features, labels))
  return batches


@functools.lru_cache(maxsize=None)
def _variables():
  """Seeded numpy variables of the tiny JAX Grasping44."""
  net = jax_networks.Grasping44(num_convs=NUM_CONVS)
  shapes = jax.eval_shape(lambda: net.init(
      jax.random.PRNGKey(0), jnp.zeros((1,) + IMAGE), jnp.zeros((1, 5))))
  return random_variables(shapes, seed=1)


def _assert_band(got, want, band, what, resolution=0.0):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  scale = float(np.abs(want).max())
  err = float(np.abs(got - want).max())
  assert err <= band * max(scale, 1e-12) + resolution, (what, err, scale)


def _assert_change_band(got, want, start, band, what):
  """(got - start) against (want - start) within ``band`` of the change's
  largest magnitude, plus four float32 ulps of the parameter's: the
  resolution of a difference of float32 values."""
  ulps = 4 * np.finfo(np.float32).eps * float(np.abs(want.numpy()).max())
  _assert_band((got - start).numpy(), (want - start).numpy(), band, what,
               resolution=ulps)


# ----------------------------------------------------------------- losses


@pytest.mark.parametrize('name', ['log_loss', 'mean_squared_error'])
def test_losses_match_jax(name):
  rng = np.random.RandomState(0)
  predictions = rng.rand(16).astype(np.float32)
  predictions[:2] = (0.0, 1.0)  # clipped by log_loss's epsilon
  targets = rng.randint(0, 2, 16).astype(np.float32)
  got = getattr(critic_model, name)(torch.from_numpy(predictions),
                                    torch.from_numpy(targets))
  want = getattr(jax_critic, name)(jnp.asarray(predictions),
                                   jnp.asarray(targets))
  assert got.dtype == torch.float32
  np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_critic_train_and_eval_fns_match_jax():
  rng = np.random.RandomState(3)
  q = rng.rand(8).astype(np.float32)
  reward = rng.randint(0, 2, (8, 1)).astype(np.float32)
  model = GraspingModelWrapper(device_type='cpu')
  jax_model = JaxWrapper(device_type='cpu')
  loss, scalars = model.model_train_fn(
      None, {'reward': torch.from_numpy(reward)},
      {'q_predicted': torch.from_numpy(q)}, ModeKeys.TRAIN)
  want_loss, want_scalars = jax_model.model_train_fn(
      None, {'reward': jnp.asarray(reward)}, {'q_predicted': jnp.asarray(q)},
      JaxModeKeys.TRAIN)
  np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
  np.testing.assert_allclose(float(scalars['q_mean']),
                             float(want_scalars['q_mean']), rtol=1e-6)
  metrics = model.model_eval_fn(None, {'reward': torch.from_numpy(reward)},
                                {'q_predicted': torch.from_numpy(q)})
  want = jax_model.model_eval_fn(None, {'reward': jnp.asarray(reward)},
                                 {'q_predicted': jnp.asarray(q)})
  assert set(metrics) == set(want)
  for key in want:
    np.testing.assert_allclose(float(metrics[key]), float(want[key]),
                               rtol=1e-6, err_msg=key)


# -------------------------------------------------------------- optimizers


# decay_steps = 32 / 32 * 1 = 1: the staircase halves the rate every step.
_FAST_DECAY = dict(examples_per_epoch=32, batch_size=32,
                   num_epochs_per_decay=1.0, learning_rate_decay_factor=0.5,
                   learning_rate=0.1)


@pytest.mark.parametrize('decay', ['default', 'fast'])
@pytest.mark.parametrize('name', ['momentum', 'rmsprop', 'adam'])
def test_build_opt_matches_optax_over_three_steps(name, decay):
  """Every step's parameters against optax's, the first included (where
  momentum SGD's trace starts from the gradient itself)."""
  hparams = {'optimizer': name}
  if decay == 'fast':
    hparams.update(_FAST_DECAY)
  rng = np.random.RandomState(1)
  init = {'w': rng.randn(4, 3).astype(np.float32),
          'b': rng.randn(3).astype(np.float32)}
  grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in init.items()}
           for _ in range(3)]
  params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in init.items()}
  optimizer = build_opt(hparams)(list(params.values()))
  tx = jax_build_opt(hparams)
  jax_params = {k: jnp.asarray(v) for k, v in init.items()}
  opt_state = tx.init(jax_params)
  for step_grads in grads:
    for key, param in params.items():
      param.grad = torch.from_numpy(step_grads[key])
    optimizer.step()
    updates, opt_state = tx.update(
        {k: jnp.asarray(v) for k, v in step_grads.items()}, opt_state,
        jax_params)
    jax_params = optax.apply_updates(jax_params, updates)
    for key, param in params.items():
      np.testing.assert_allclose(param.detach().numpy(),
                                 np.asarray(jax_params[key]), rtol=0,
                                 atol=1e-6, err_msg=f'{name} {key}')
  assert all(g['count'] == 3 for g in optimizer.param_groups)


def test_staircase_schedule_matches_optax():
  schedule = optimizers.exponential_decay(1e-4, 187500, 0.999, staircase=True)
  want = optax.exponential_decay(1e-4, 187500, 0.999, staircase=True)
  for count in (0, 1, 187499, 187500, 375001, 10**7):
    np.testing.assert_allclose(schedule(count), float(want(count)),
                               rtol=1e-6)
  assert schedule(187499) == 1e-4 and schedule(187500) < 1e-4


def test_qtopt_wrapper_builds_momentum_with_the_staircase():
  model = GraspingModelWrapper(device_type='cpu')
  optimizer = model.create_optimizer()([torch.nn.Parameter(torch.zeros(2))])
  assert isinstance(optimizer, optimizers.MomentumSGD)
  group = optimizer.param_groups[0]
  assert group['momentum'] == 0.9 and group['dampening'] == 0
  assert not group['nesterov']
  assert optimizer.schedule(187499) == 1e-4
  np.testing.assert_allclose(optimizer.schedule(187500), 0.999e-4)
  assert model.use_avg_model_params
  assert model.avg_model_params_decay == 0.9999
  # Without a factory the base model takes the JAX package's default, Adam.
  fallback = GraspingModelWrapper(device_type='cpu', create_optimizer_fn=None)
  assert isinstance(
      fallback.create_optimizer()([torch.nn.Parameter(torch.zeros(2))]),
      optimizers.Adam)


# --------------------------------------------------------------------- EMA


def test_apply_ema_matches_jax_and_starts_as_a_copy():
  model = GraspingModelWrapper(
      device_type='cpu', input_shape=IMAGE, target_shape=IMAGE[:2],
      num_convs=NUM_CONVS)
  state = create_train_state(model, torch.Generator().manual_seed(0), 'cpu')
  params = dict(state.network.named_parameters())
  assert set(state.ema) == set(params)
  for name, param in params.items():
    assert torch.equal(state.ema[name], param)
    assert state.ema[name].data_ptr() != param.data_ptr()
  before = {k: v.numpy().copy() for k, v in state.ema.items()}
  rng = np.random.RandomState(2)
  with torch.no_grad():
    for param in params.values():
      param.add_(torch.from_numpy(
          rng.randn(*param.shape).astype(np.float32)))
  apply_ema(state, 0.9)
  jax_state = jax_train_state.TrainState(
      step=0, params=None, model_state={}, opt_state=None,
      ema_params={k: jnp.asarray(v) for k, v in before.items()})
  want = jax_train_state.apply_ema(
      jax_state, {k: jnp.asarray(p.detach().numpy())
                  for k, p in params.items()}, 0.9)
  for name in params:
    np.testing.assert_allclose(state.ema[name].numpy(),
                               np.asarray(want[name]), rtol=0, atol=1e-6)


# -------------------------------------------------------- preprocessing


def test_train_preprocessing_matches_jax_when_the_crop_is_the_image():
  features, labels = _batches(count=1)[0]
  model = GraspingModelWrapper(device_type='cpu', input_shape=IMAGE,
                               target_shape=IMAGE[:2], num_convs=NUM_CONVS)
  got, got_labels = model.preprocessor.preprocess(
      {k: torch.from_numpy(v) for k, v in features.items()},
      {k: torch.from_numpy(v) for k, v in labels.items()}, ModeKeys.TRAIN,
      torch.Generator().manual_seed(0))
  jax_model = JaxWrapper(device_type='cpu', input_shape=IMAGE,
                         target_shape=IMAGE[:2], num_convs=NUM_CONVS)
  want, _ = jax_model.preprocessor.preprocess(
      features, labels, JaxModeKeys.TRAIN, jax.random.PRNGKey(0))
  for key in want:
    np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
  assert torch.equal(got_labels['reward'], torch.from_numpy(labels['reward']))


def test_full_width_train_preprocessing_is_a_random_window():
  model = GraspingModelWrapper(device_type='gpu')
  frames = np.random.RandomState(3).randint(0, 256, (2, 512, 640, 3),
                                            dtype=np.uint8)
  features = {'state/image': torch.from_numpy(frames),
              'action/world_vector': torch.zeros(2, 3),
              'action/vertical_rotation': torch.zeros(2, 2)}
  out, _ = model.preprocessor.preprocess(
      dict(features), None, ModeKeys.TRAIN, torch.Generator().manual_seed(4))
  image = out['state/image']
  assert image.shape == (2, 472, 472, 3) and image.dtype == torch.bfloat16
  # The crop draws its row offset, then its column offset, from the
  # generator; the same draws from the same seed name the window.
  generator = torch.Generator().manual_seed(4)
  oh = int(torch.randint(0, 512 - 472 + 1, (), generator=generator))
  ow = int(torch.randint(0, 640 - 472 + 1, (), generator=generator))
  window = torch.from_numpy(frames[:, oh:oh + 472, ow:ow + 472]).float()
  assert torch.equal(image, (window / 255.0).to(torch.bfloat16))


# -------------------------------------------------- Grasping44 gradients


def test_grasping44_train_gradients_match_jax():
  """log_loss gradients of the train-mode network, every parameter: the
  port's (plain kernel versions behind its autograd Functions) against
  jax.grad of the JAX module (Pallas kernels, interpreted). The JAX grads
  tree goes through the same converter as the weights."""
  variables = _variables()
  (features, labels), = _batches(seed=5, count=1)
  images = features['state/image'].astype(np.float32) / 255.0
  actions = np.concatenate([features['action/world_vector'],
                            features['action/vertical_rotation']], -1)
  rewards = labels['reward'][:, 0]

  jax_net = jax_networks.Grasping44(num_convs=NUM_CONVS,
                                    kernel_policy='pool_conv')

  def jax_loss(params):
    (_, ends), _ = jax_net.apply(
        {'params': params, 'batch_stats': variables['batch_stats']},
        jnp.asarray(images), jnp.asarray(actions), train=True,
        mutable=['batch_stats'])
    return jax_critic.log_loss(ends['predictions'], jnp.asarray(rewards))

  with _pallas_dispatch.force_kernels(True):
    want_loss, jax_grads = jax.jit(jax.value_and_grad(jax_loss))(
        variables['params'])
  want = convert.jax_variables_to_torch(
      {'params': jax.device_get(jax_grads)})

  net = networks.Grasping44(image_size=IMAGE[:2], num_convs=NUM_CONVS,
                            kernel_policy='pool_conv')
  net.load_state_dict(convert.jax_variables_to_torch(variables))
  net.train(True)
  _, ends = net(torch.from_numpy(images), torch.from_numpy(actions))
  loss = critic_model.log_loss(ends['predictions'], torch.from_numpy(rewards))
  loss.backward()
  np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
  params = dict(net.named_parameters())
  assert set(want) == set(params)
  for name, param in params.items():
    assert param.grad is not None, name
    assert bool(param.grad.abs().max() > 0), name
    _assert_band(param.grad.numpy(), want[name].numpy(), 5e-4, name)


# ----------------------------------------------------------------- trainer


class _Snapshots(TrainerCallback):

  def __init__(self):
    self.by_step = {}

  def after_step(self, trainer, step, scalars):
    state = trainer.state
    self.by_step[step] = (
        {k: float(v) for k, v in scalars.items()},
        jax.device_get(dict(state.variables)),
        jax.device_get(dict(state.eval_variables)))


@pytest.fixture(scope='module')
def jax_run():
  """The JAX trainer, STEPS steps, with a snapshot after each."""
  variables = _variables()
  model = JaxWrapper(
      device_type='cpu', input_shape=IMAGE, target_shape=IMAGE[:2],
      num_convs=NUM_CONVS,
      init_from_checkpoint_fn=lambda params, state: (
          variables['params'], {'batch_stats': variables['batch_stats']}))
  snapshots = _Snapshots()
  trainer = JaxTrainer(
      model, JaxTrainerConfig(model_dir='', max_train_steps=STEPS,
                              eval_interval_steps=0, log_interval_steps=0),
      callbacks=[snapshots])
  trainer.train(iter(_batches()), None)
  return snapshots.by_step


def _port_trainer(steps):
  variables = _variables()
  model = GraspingModelWrapper(
      device_type='cpu', input_shape=IMAGE, target_shape=IMAGE[:2],
      num_convs=NUM_CONVS, kernel_policy='pool_conv',
      init_from_checkpoint_fn=lambda network: network.load_state_dict(
          convert.jax_variables_to_torch(variables)))
  trainer = Trainer(model, TrainerConfig(max_train_steps=steps,
                                         log_interval_steps=0), device='cpu')
  scalars = trainer.train(iter(_batches()))
  return trainer, scalars


@pytest.mark.parametrize('steps', [1, STEPS])
def test_trainer_matches_jax(jax_run, steps):
  trainer, scalars = _port_trainer(steps)
  assert trainer.step == steps
  want_scalars, want_vars, want_eval = jax_run[steps]
  assert set(scalars) == {'loss', 'q_mean'}
  for key in scalars:
    np.testing.assert_allclose(scalars[key], want_scalars[key], rtol=0,
                               atol=5e-5, err_msg=key)
  start = convert.jax_variables_to_torch(_variables())
  want = convert.jax_variables_to_torch(want_vars)
  want_ema = convert.jax_variables_to_torch(want_eval)
  got = trainer.state.network.state_dict()
  got_ema = trainer.state.eval_state_dict()
  params = {name for name, _ in trainer.state.network.named_parameters()}
  assert set(got) == set(want)
  for name in want:
    if name in params:
      _assert_change_band(got[name], want[name], start[name], 1e-3, name)
      assert not torch.equal(got[name], start[name]), name
      _assert_band(got_ema[name], want_ema[name], 1e-6, f'ema {name}')
    else:  # batch statistics
      _assert_band(got[name], want[name], 1e-5, name)


def test_trainer_refuses_what_is_not_ported_yet():
  """Each knob the port does not honour yet raises, citing its ROADMAP
  queue 1 item, instead of being ignored; the dispatch knobs (queue 1 item
  8) are ported and taken."""
  model = GraspingModelWrapper(device_type='cpu')
  for knob in (dict(steps_per_dispatch=2), dict(grad_accum_microbatches=2),
               dict(prefetch_batches=2), dict(device_feed=True),
               dict(step_breakdown=False)):
    Trainer(model, TrainerConfig(**knob), device='cpu')
  for knob, item in ((dict(distributed_coordination=True), 10),
                     (dict(checkpoint_sharded_payloads='on'), 10),
                     (dict(checkpoint_async_commit=True), 10)):
    with pytest.raises(NotImplementedError, match=f'queue 1 item {item}'):
      Trainer(model, TrainerConfig(**knob), device='cpu')
  # Exporters are ported (queue 1 item 5): the knob is taken, and the call
  # goes on to the generator check.
  with pytest.raises(ValueError, match='Need a train or eval'):
    train_eval_model(model=model, device='cpu',
                     create_exporters_fn=lambda model: [])
  # checkpoint_input_state is ported; as in the JAX package, a generator
  # that cannot checkpoint its stream position is refused.
  with pytest.raises(ValueError, match='create_checkpointable_iterator'):
    train_eval_model(
        model=model, device='cpu', checkpoint_input_state=True,
        train_input_generator=DefaultRandomInputGenerator(batch_size=BATCH))


def test_trained_ema_weights_serve_through_the_predictor():
  trainer, _ = _port_trainer(2)
  model = trainer.model
  predictor = CheckpointPredictor(model, device='cpu')
  predictor.load_state_dict(trainer.state.eval_state_dict(), global_step=2)
  (features, _), = _batches(seed=9, count=1)
  q = predictor.predict(features)['q_predicted']
  assert q.shape == (BATCH,) and np.isfinite(q).all()
  network = model.create_module()
  network.load_state_dict(trainer.state.eval_state_dict())
  network.eval()
  with torch.no_grad():
    _, ends = network(
        torch.from_numpy(features['state/image']).float() / 255.0,
        torch.cat([torch.from_numpy(features['action/world_vector']),
                   torch.from_numpy(features['action/vertical_rotation'])],
                  -1))
  np.testing.assert_allclose(q, ends['predictions'].numpy(), rtol=0,
                             atol=1e-6)


def test_convert_maps_a_jax_grads_tree_onto_the_parameters():
  """Gradients share the params tree's paths: the weight converter maps a
  JAX grads tree onto exactly the port's parameters, shapes and all."""
  variables = _variables()
  grads = jax.tree_util.tree_map(np.ones_like, variables['params'])
  converted = convert.jax_variables_to_torch({'params': grads})
  net = networks.Grasping44(image_size=IMAGE[:2], num_convs=NUM_CONVS)
  params = dict(net.named_parameters())
  assert set(converted) == set(params)
  for name, param in params.items():
    assert converted[name].shape == param.shape, name
    assert bool((converted[name] == 1).all()), name
