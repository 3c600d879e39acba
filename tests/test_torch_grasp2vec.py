"""Port parity: Grasp2Vec (``research/grasp2vec``) against the JAX package.

* Losses: N-pairs (with and without the non-negativity constraint), the
  L2 and cosine arithmetic losses (a partial and an empty mask), the
  semi-hard triplet loss on a batch with semi-hard negatives and on one
  where only the fallback (hardest negative) applies, ``triplet_loss`` and
  ``keypoint_accuracy``, within ``LOSS_TOL`` (1e-6) relative, on the same
  seeded float32 inputs; the reference-name aliases.
* Preprocessor: given the offsets and flips that the JAX preprocessor
  drew from its key (recomputed from the key the way it splits it), the
  port's crops, scaling and flips are bit for bit the JAX ones, in TRAIN
  for several keys and in EVAL (the centre crop); the port draws them
  from the step's generator in the JAX order, with exclusive upper
  bounds (handed ``DeviceDraws`` at ``steps_per_dispatch`` > 1 it takes
  the same draws on the device: ``tests/test_torch_device_draws.py``).
* One train step at ResNet-18, 64 px, batch 2, float32: with the JAX
  variables converted by ``utils/convert.grasp2vec_variables_to_torch``,
  the loss within 1e-5 relative, every gradient and every new batch
  statistic within ``F32_BAND`` (2e-4) of its largest magnitude, the
  outputs' shapes and dtypes; under ``device_type='gpu'`` the towers run
  bfloat16 and the vectors stay float32.
* Eval: ``model_eval_fn`` within 1e-5, and ``get_softmax_response`` and
  ``heatmap_keypoints`` on the eval outputs within 1e-5 of their largest
  magnitude.
* The converter: the round trip onto both towers' ``state_dict``, an
  unmapped leaf raising, and a JAX Grasp2Vec ``TrainState`` (Adam)
  mapped by ``jax_train_state_to_torch`` and loaded into the port's
  train state.
* Warm start: ``create_resnet_init_from_checkpoint_fn`` restores the
  backbone and leaves ``film`` and ``final_dense`` fresh; the gin
  registrations; the port's ``train_grasp2vec.gin``.
* ``grad_accum_microbatches=2`` on the ResNet-18 mock of the JAX
  package's failing accumulation test (float32, momentum 1e-2, EMA),
  bit for bit the eager accumulation written out.
* The trainer on a model with no labels and two towers: trained from
  record shards, checkpointed, restored by ``CheckpointPredictor``, whose
  embeddings equal the trainer's network's in eval mode.
"""

import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.models import optimizers as jax_optimizers
from tensor2robot_tpu.modes import ModeKeys as JaxModeKeys
from tensor2robot_tpu.research.grasp2vec import Grasp2VecModel as JaxModel
from tensor2robot_tpu.research.grasp2vec import losses as jax_losses
from tensor2robot_tpu.research.grasp2vec import visualization as jax_vis
from tensor2robot_tpu.research.grasp2vec.grasp2vec_model import (
    Grasp2VecPreprocessor as JaxPreprocessor)
from tensor2robot_tpu_torch.config import gin_lite, registrations
from tensor2robot_tpu_torch.data import example_codec, records, shard_index
from tensor2robot_tpu_torch.data.input_generators import (
    DefaultRecordInputGenerator)
from tensor2robot_tpu_torch.layers import resnet
from tensor2robot_tpu_torch.models import optimizers, warm_start
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.predictors import CheckpointPredictor
from tensor2robot_tpu_torch.research.grasp2vec import (Grasp2VecModel,
                                                       Grasp2VecPreprocessor,
                                                       losses, visualization)
from tensor2robot_tpu_torch.research.grasp2vec.grasp2vec_model import (
    Augmentation)
from tensor2robot_tpu_torch.train import (Trainer, TrainerConfig,
                                          train_eval_model)
from tensor2robot_tpu_torch.train.train_state import (apply_ema,
                                                      load_state_dict)
from tensor2robot_tpu_torch.utils import convert
from torch_port_weights import random_variables

BATCH = 2
SIZE = 64
LOSS_TOL = 1e-6
F32_BAND = 2e-4
# The N-pairs loss reads pre - post, two near-equal embeddings of the same
# tower, so the float32 step is ill-conditioned: on these seeded inputs
# the two float32 losses differ by 2.1e-4 relative and layer-4 gradients
# of the scene tower by up to 19%, while with float64 towers the port and
# JAX agree within 1.3e-6 (loss) and 1.3e-6 (every gradient). The step's
# gradients are therefore held with float64 towers.
F32_LOSS_BAND = 1e-3
F64_TOWER_BAND = 1e-5
TINY_CROP = (0, 40, SIZE, 0, 168, SIZE)
GIN = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                   'tensor2robot_tpu_torch', 'research', 'grasp2vec',
                   'configs', 'train_grasp2vec.gin')
IMAGE_KEYS = ('pregrasp_image', 'postgrasp_image', 'goal_image')


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _close(got, want, what, band):
  got = np.asarray(got, np.float64)
  want = np.asarray(want, np.float64)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  scale = max(float(np.max(np.abs(want))), 1e-30)
  err = float(np.max(np.abs(got - want)))
  assert err <= band * scale, (what, err, scale)


# ---------------------------------------------------------------- losses


def _embeddings(seed, batch=6, dim=8):
  rng = np.random.RandomState(seed)
  return [rng.randn(batch, dim).astype(np.float32) for _ in range(3)]


def _both(fn_name, *args, **kwargs):
  got = getattr(losses, fn_name)(*[torch.from_numpy(a) for a in args],
                                 **kwargs)
  want = getattr(jax_losses, fn_name)(*[jnp.asarray(a) for a in args],
                                      **kwargs)
  return got, want


@pytest.mark.parametrize('non_negative', [False, True])
def test_npairs_loss(non_negative):
  got, want = _both('npairs_loss', *_embeddings(0),
                    non_negativity_constraint=non_negative)
  np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)


@pytest.mark.parametrize('name', ['l2_arithmetic_loss',
                                  'cosine_arithmetic_loss'])
@pytest.mark.parametrize('mask', [[1, 0, 1, 1, 0, 1], [0] * 6])
def test_arithmetic_losses(name, mask):
  mask = np.asarray(mask, np.int32)
  got, want = _both(name, *_embeddings(1), mask)
  np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL,
                             atol=1e-7)


def _triplet_inputs(fallback):
  rng = np.random.RandomState(2)
  labels = np.asarray([0, 0, 1, 1, 2, 2], np.int32)
  if fallback:
    # Positives far apart, negatives close: no negative lies farther than
    # its positive, so every pair takes the hardest (farthest) negative.
    centers = rng.randn(3, 4) * 0.01
    spread = np.asarray([[5.0, 0, 0, 0], [-5.0, 0, 0, 0]])
    emb = np.concatenate([centers[i] + spread for i in range(3)])
  else:
    emb = rng.randn(6, 4)
  return labels, emb.astype(np.float32)


@pytest.mark.parametrize('fallback', [False, True])
def test_triplet_semihard_loss(fallback):
  labels, emb = _triplet_inputs(fallback)
  got = losses.triplet_semihard_loss(torch.from_numpy(labels),
                                     torch.from_numpy(emb), margin=1.0)
  want = jax_losses.triplet_semihard_loss(jnp.asarray(labels),
                                          jnp.asarray(emb), margin=1.0)
  assert float(want) > 0
  np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)


def test_triplet_loss_and_aliases():
  got, want = _both('triplet_loss', *_embeddings(3))
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=LOSS_TOL,
                               atol=1e-7)
  assert losses.NPairsLoss is losses.npairs_loss
  assert losses.TripletLoss is losses.triplet_loss
  assert losses.L2ArithmeticLoss is losses.l2_arithmetic_loss
  assert losses.CosineArithmeticLoss is losses.cosine_arithmetic_loss
  assert losses.KeypointAccuracy is losses.keypoint_accuracy


def test_keypoint_accuracy():
  rng = np.random.RandomState(4)
  keypoints = rng.uniform(-1, 1, (8, 2)).astype(np.float32)
  labels = rng.randint(0, 4, (8,)).astype(np.int32)
  got = losses.keypoint_accuracy(torch.from_numpy(keypoints),
                                 torch.from_numpy(labels))
  want = jax_losses.keypoint_accuracy(jnp.asarray(keypoints),
                                      jnp.asarray(labels))
  for g, w in zip(got, want):
    np.testing.assert_allclose(float(g), float(w), rtol=LOSS_TOL)


# ----------------------------------------------------------- preprocessor


def _frames(seed, batch=BATCH):
  rng = np.random.RandomState(seed)
  return {key: rng.randint(0, 256, (batch, 512, 640, 3), dtype=np.uint8)
          for key in IMAGE_KEYS}


def _jax_draws(key):
  """The offsets and flips the JAX preprocessor draws from ``key``, split
  the way its ``_preprocess_fn`` splits it."""
  rngs = jax.random.split(key, 3)

  def offset(rng, crop):
    oh_rng, ow_rng = jax.random.split(rng)
    return (int(jax.random.randint(oh_rng, (), crop[0], max(crop[1],
                                                            crop[0] + 1))),
            int(jax.random.randint(ow_rng, (), crop[3], max(crop[4],
                                                            crop[3] + 1))))

  crop = (0, 40, 472, 0, 168, 472)
  flips = []
  for i in range(3):
    lr_rng, ud_rng = jax.random.split(jax.random.fold_in(rngs[2], i))
    flips.append((bool(jax.random.bernoulli(lr_rng)),
                  bool(jax.random.bernoulli(ud_rng))))
  return Augmentation(offset(rngs[0], crop), offset(rngs[1], crop),
                      tuple(flips))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_preprocessor_crops_and_flips_bit_for_bit(seed):
  frames = _frames(seed)
  key = jax.random.PRNGKey(seed)
  jax_pre = JaxModel(device_type='cpu').preprocessor
  want, _ = jax_pre.preprocess(dict(frames), None, JaxModeKeys.TRAIN, key)
  port = Grasp2VecModel(device_type='cpu').preprocessor
  draws = _jax_draws(key)
  got = port.augment({k: torch.from_numpy(v) for k, v in frames.items()},
                     draws)
  for name in IMAGE_KEYS:
    assert np.array_equal(got[name].numpy(), np.asarray(want[name])), name


def test_preprocessor_flip_coverage_and_eval_centre_crop():
  draws = [_jax_draws(jax.random.PRNGKey(seed)) for seed in range(3)]
  flips = {f for d in draws for f in d.flips}
  assert {f[0] for f in flips} == {True, False}
  assert {f[1] for f in flips} == {True, False}
  frames = _frames(7)
  jax_pre = JaxModel(device_type='cpu').preprocessor
  want, _ = jax_pre.preprocess(dict(frames), None, JaxModeKeys.EVAL, None)
  port = Grasp2VecModel(device_type='cpu').preprocessor
  got, _ = port.preprocess({k: torch.from_numpy(v) for k, v in
                            frames.items()}, None, ModeKeys.EVAL)
  for name in IMAGE_KEYS:
    assert np.array_equal(got[name].numpy(), np.asarray(want[name])), name


def test_preprocessor_draw_order_and_exclusive_bounds():
  pre = Grasp2VecPreprocessor(
      model_feature_specification_fn=Grasp2VecModel(
          device_type='cpu').get_feature_specification)
  draws = pre.draw_augmentation(torch.Generator().manual_seed(5),
                                ModeKeys.TRAIN)
  gen = torch.Generator().manual_seed(5)
  want = [int(torch.randint(lo, hi, (), generator=gen))
          for lo, hi in ((0, 40), (0, 168), (0, 40), (0, 168))]
  want += [bool(torch.randint(0, 2, (), generator=gen)) for _ in range(6)]
  assert list(draws.scene + draws.goal) == want[:4]
  assert [f for pair in draws.flips for f in pair] == want[4:]
  gen = torch.Generator().manual_seed(6)
  offsets = np.asarray([pre.draw_augmentation(gen, ModeKeys.TRAIN).scene
                        for _ in range(800)])
  assert offsets[:, 0].max() == 39 and offsets[:, 1].max() == 167
  assert offsets.min() == 0
  assert pre.draw_augmentation(None, ModeKeys.TRAIN) == Augmentation(
      (20, 84), (20, 84), ((False, False),) * 3)


# ------------------------------------------------------- the model's step


def _features(seed):
  rng = np.random.RandomState(seed)
  return {key: rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
          for key in IMAGE_KEYS}


class _JaxFloat64(JaxModel):
  """The JAX model with float64 towers (run under ``jax.enable_x64``)."""

  @property
  def compute_dtype(self):
    return jnp.float64


class _PortFloat64(Grasp2VecModel):
  """The port's model with float64 towers."""

  @property
  def compute_dtype(self):
    return torch.float64


def _jax_model(cls=JaxModel):
  return cls(scene_size=(SIZE, SIZE), goal_size=(SIZE, SIZE), resnet_size=18,
             device_type='cpu')


@functools.lru_cache(maxsize=None)
def _jax_variables():
  shapes = jax.eval_shape(lambda: _jax_model().init_variables(
      jax.random.PRNGKey(0), _features(0)))
  return random_variables(shapes, seed=3)


@functools.lru_cache(maxsize=None)
def _jax_step(float64):
  """One train step of the JAX model (loss, gradients, new batch
  statistics) with float32 or float64 towers and, with float32 towers,
  its eval outputs, metrics and visualizations, in one jitted call."""
  model = _jax_model(_JaxFloat64 if float64 else JaxModel)
  variables, features = _jax_variables(), _features(0)

  def loss_fn(params):
    v = dict(variables, params=params)
    outputs, new_v = model.inference_network_fn(v, features, None,
                                                JaxModeKeys.TRAIN)
    loss, _ = model.model_train_fn(features, None, outputs,
                                   JaxModeKeys.TRAIN)
    return loss, new_v['batch_stats']

  def run(variables):
    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables['params'])
    result = dict(loss=loss, stats=stats, grads=grads)
    if not float64:
      outputs, _ = model.inference_network_fn(variables, features, None,
                                              JaxModeKeys.EVAL)
      heatmap, response = jax_vis.get_softmax_response(
          outputs['goal_vector'], outputs['pre_spatial'])
      result.update(
          metrics=model.model_eval_fn(features, None, outputs),
          heatmap=heatmap, response=response,
          keypoints=jax_vis.heatmap_keypoints(outputs['goal_vector'],
                                              outputs['post_spatial']),
          outputs=dict(outputs))
    return result

  with jax.enable_x64(float64):
    return jax.device_get(jax.jit(run)(variables))


def _port_model(cls=Grasp2VecModel, **kwargs):
  return cls(scene_size=(SIZE, SIZE), goal_size=(SIZE, SIZE), resnet_size=18,
             device_type='cpu', **kwargs)


def _port_network(model, variables):
  network = model.create_module()
  network.load_state_dict(convert.grasp2vec_variables_to_torch(variables))
  return network


def _port_step(model):
  network = _port_network(model, _jax_variables())
  features = {k: torch.from_numpy(v) for k, v in _features(0).items()}
  outputs = model.inference_network_fn(network, features, None,
                                       ModeKeys.TRAIN)
  loss, scalars = model.model_train_fn(features, None, outputs,
                                       ModeKeys.TRAIN)
  assert set(scalars) == {'embed_loss'}
  loss.backward()
  return network, outputs, loss.detach()


def test_train_step_matches_jax_float64_towers():
  """The step with float64 towers (the pool kernels take float32 and
  bfloat16, so the stem pool is the stock one here; the 'pool' policy's
  float32 step is below)."""
  want = _jax_step(True)
  network, outputs, loss = _port_step(_port_model(_PortFloat64))
  assert outputs['pre_vector'].dtype == torch.float32
  assert outputs['pre_spatial'].dtype == torch.float64
  np.testing.assert_allclose(float(loss), float(want['loss']), rtol=1e-5)
  grads = convert.grasp2vec_variables_to_torch({'params': want['grads']})
  named = dict(network.named_parameters())
  assert set(named) == set(grads)
  for name, param in named.items():
    _close(param.grad, grads[name], name, F64_TOWER_BAND)
  stats = convert.grasp2vec_variables_to_torch({'batch_stats':
                                                want['stats']})
  buffers = dict(network.named_buffers())
  assert set(buffers) == set(stats)
  for name, value in stats.items():
    _close(buffers[name], value, name, F64_TOWER_BAND)


@pytest.mark.parametrize('policy', ['none', 'pool'])
def test_train_step_float32_forward_matches_jax(policy):
  """The float32 step as the model runs it: the outputs' shapes, the new
  batch statistics within ``F32_BAND`` and the loss within
  ``F32_LOSS_BAND``; its gradients are held in float64 above."""
  want = _jax_step(False)
  network, outputs, loss = _port_step(_port_model(kernel_policy=policy))
  assert outputs['pre_vector'].shape == (BATCH, 512)
  assert outputs['goal_spatial'].shape == (BATCH, 2, 2, 512)
  np.testing.assert_allclose(float(loss), float(want['loss']),
                             rtol=F32_LOSS_BAND)
  stats = convert.grasp2vec_variables_to_torch({'batch_stats':
                                                want['stats']})
  buffers = dict(network.named_buffers())
  for name, value in stats.items():
    _close(buffers[name], value, name, F32_BAND)
  assert all(torch.isfinite(p.grad).all() for p in network.parameters())


def test_eval_metrics_and_visualization_match_jax():
  want = _jax_step(False)
  model = _port_model()
  network = _port_network(model, _jax_variables())
  features = {k: torch.from_numpy(v) for k, v in _features(0).items()}
  with torch.no_grad():
    outputs = model.inference_network_fn(network, features, None,
                                         ModeKeys.EVAL)
    metrics = model.model_eval_fn(features, None, outputs)
    heatmap, response = visualization.get_softmax_response(
        outputs['goal_vector'], outputs['pre_spatial'])
    keypoints = visualization.heatmap_keypoints(outputs['goal_vector'],
                                                outputs['post_spatial'])
  for name, value in outputs.items():
    _close(value, want['outputs'][name], name, 1e-5)
  assert set(metrics) == set(want['metrics']) == {'embed_loss', 'loss'}
  for name, value in metrics.items():
    np.testing.assert_allclose(float(value), float(want['metrics'][name]),
                               rtol=F32_LOSS_BAND)
  _close(heatmap, want['heatmap'], 'heatmap', 1e-5)
  _close(response, want['response'], 'response', 1e-5)
  _close(keypoints, want['keypoints'], 'keypoints', 1e-5)
  assert heatmap.shape == (BATCH, 2, 2, 1) and keypoints.shape == (BATCH, 2)


def test_bf16_towers_keep_float32_vectors():
  model = Grasp2VecModel(scene_size=(48, 48), goal_size=(48, 48),
                         resnet_size=18, device_type='gpu')
  network = model.create_module()
  network.init_weights(torch.Generator().manual_seed(0))
  rng = np.random.RandomState(1)
  features = {k: torch.from_numpy(rng.rand(2, 48, 48, 3).astype(
      np.float32)).to(torch.bfloat16) for k in IMAGE_KEYS}
  outputs = model.inference_network_fn(network, features, None,
                                       ModeKeys.TRAIN)
  assert outputs['pre_vector'].dtype == torch.float32
  assert outputs['goal_vector'].dtype == torch.float32
  assert outputs['pre_spatial'].dtype == torch.bfloat16
  assert next(network.parameters()).dtype == torch.float32
  assert torch.isfinite(model.model_train_fn(features, None, outputs,
                                             ModeKeys.TRAIN)[0])


# -------------------------------------------------------------- converter


def test_converter_round_trip_and_unmapped_leaf():
  variables = _jax_variables()
  state = convert.grasp2vec_variables_to_torch(variables)
  network = _port_model().create_module()
  assert set(state) == set(network.state_dict())
  np.testing.assert_array_equal(
      state['goal.resnet.block_layer3_block1.conv2.weight'].numpy(),
      variables['params']['goal']['resnet']['block_layer3_block1']['conv2'][
          'kernel'].transpose(3, 2, 0, 1))
  np.testing.assert_array_equal(
      state['scene.resnet.bn0.var'].numpy(),
      variables['batch_stats']['scene']['resnet']['_BatchNorm_0'][
          'BatchNorm_0']['var'])
  bad = {'params': dict(variables['params'], other={'x': np.zeros(1)})}
  with pytest.raises(ValueError, match='Unmapped'):
    convert.grasp2vec_variables_to_torch(bad)
  with pytest.raises(ValueError, match='Unmapped'):
    convert.grasp2vec_variables_to_torch(
        {'params': {'resnet': variables['params']['scene']['resnet']}})


def _tiny_crop_model(cls, **kwargs):
  """The model at 64 px with the preprocessor's crop shrunk to match (the
  mock of the JAX package's accumulation test)."""

  class TinyCrop(JaxPreprocessor if cls is JaxModel else
                 Grasp2VecPreprocessor):

    def __init__(self, **kw):
      super().__init__(scene_crop=TINY_CROP, goal_crop=TINY_CROP, **kw)

  kwargs.setdefault('device_type', 'cpu')
  return cls(scene_size=(SIZE, SIZE), goal_size=(SIZE, SIZE),
             resnet_size=18, preprocessor_cls=TinyCrop, **kwargs)


def test_jax_train_state_converts_and_loads():
  """A JAX Grasp2Vec train state (the fields ``jax_train_state_to_torch``
  reads: step, params, batch statistics, EMA, and the default optimizer's
  optax Adam state with seeded moments) into the port's train state."""
  variables = _jax_variables()
  params = variables['params']
  tx = jax_optimizers.default_create_optimizer_fn()
  opt_state = tx.init(params)
  rng = np.random.RandomState(5)
  moment = lambda a: rng.randn(*np.shape(a)).astype(np.float32)  # pylint: disable=unnecessary-lambda-assignment
  adam_parts = [s for s in jax.tree_util.tree_leaves(
      opt_state, is_leaf=lambda x: hasattr(x, 'mu')) if hasattr(s, 'mu')]
  assert len(adam_parts) == 1, opt_state
  seeded = adam_parts[0]._replace(
      count=np.asarray(3, np.int32),
      mu=jax.tree_util.tree_map(moment, params),
      nu=jax.tree_util.tree_map(lambda a: np.abs(moment(a)), params))
  opt_state = jax.tree_util.tree_map(
      lambda x: seeded if x is adam_parts[0] else x, opt_state,
      is_leaf=lambda x: x is adam_parts[0])
  jax_state = types.SimpleNamespace(
      step=np.asarray(3), params=params,
      model_state={'batch_stats': variables['batch_stats']},
      ema_params=jax.tree_util.tree_map(lambda a: a + 1.0, params),
      opt_state=opt_state)
  model = _port_model(use_avg_model_params=True)
  trainer = Trainer(model, TrainerConfig(max_train_steps=0), device='cpu')
  state = trainer.initialize(
      {k: np.zeros((1, 512, 640, 3), np.uint8) for k in IMAGE_KEYS})
  payload = convert.jax_train_state_to_torch(
      jax_state, state, variables_to_torch=convert.grasp2vec_variables_to_torch)
  load_state_dict(state, payload)
  assert state.step == 3
  want = convert.grasp2vec_variables_to_torch(variables)
  for name, value in state.network.state_dict().items():
    assert torch.equal(value, want[name]), name
  mu = convert.grasp2vec_variables_to_torch({'params': seeded.mu})
  names = {id(p): n for n, p in state.network.named_parameters()}
  slots = state.optimizer.state_dict()['state']
  order = [names[id(p)] for g in state.optimizer.param_groups
           for p in g['params']]
  assert len(slots) == len(order) == len(mu)
  for index, name in enumerate(order):
    assert torch.equal(slots[index]['mu'], mu[name]), name
  assert all(g['count'] == 3 for g in state.optimizer.state_dict()[
      'param_groups'])
  ema = convert.grasp2vec_variables_to_torch(
      {'params': jax_state.ema_params})
  for name, value in state.ema.items():
    assert torch.equal(value, ema[name]), name


def test_predictor_widens_bf16_spatial_maps_to_float32():
  """Under the bfloat16 policy the towers' spatial maps are bfloat16,
  which numpy lacks: the predictor hands them out as float32, holding the
  same values."""
  model = _tiny_crop_model(Grasp2VecModel, device_type='gpu')
  network = model.create_module()
  network.init_weights(torch.Generator().manual_seed(0))
  predictor = CheckpointPredictor(model, device='cpu')
  predictor.load_state_dict(network.state_dict(), global_step=1)
  frames = _frames(3, batch=1)
  got = predictor.predict(frames)
  features, _ = model.preprocessor.preprocess(
      {k: torch.from_numpy(v) for k, v in frames.items()}, None,
      ModeKeys.PREDICT)
  with torch.no_grad():
    want = model.inference_network_fn(network, features, None,
                                      ModeKeys.PREDICT)
  assert want['pre_spatial'].dtype == torch.bfloat16
  for name, value in want.items():
    assert got[name].dtype == np.float32, name
    assert np.array_equal(got[name], value.float().numpy()), name


# ------------------------------------------------------------ warm start


def test_resnet_warm_start_restores_backbone_only(tmp_path):
  source = resnet.FilmResNet(resnet_size=18, num_classes=3, embedding_size=4)
  source.init_weights(torch.Generator().manual_seed(0))
  path = str(tmp_path / 'source.pt')
  torch.save(source.state_dict(), path)
  target = resnet.FilmResNet(resnet_size=18, num_classes=3, embedding_size=4)
  target.init_weights(torch.Generator().manual_seed(1))
  fresh = {k: v.clone() for k, v in target.state_dict().items()}
  warm_start.create_resnet_init_from_checkpoint_fn(path)(target)
  restored = 0
  for name, value in target.state_dict().items():
    if 'film' in name or 'final_dense' in name:
      assert torch.equal(value, fresh[name]), name
    else:
      assert torch.equal(value, source.state_dict()[name]), name
      restored += 1
  assert restored > 80
  full = resnet.FilmResNet(resnet_size=18, num_classes=3, embedding_size=4)
  warm_start.create_resnet_init_from_checkpoint_fn(
      path, restore_film=True, restore_head=True)(full)
  for name, value in full.state_dict().items():
    assert torch.equal(value, source.state_dict()[name]), name


def test_registrations_and_gin():
  registrations.register()
  try:
    gin_lite.parse_config_files_and_bindings([GIN], [])
    model = gin_lite.query_parameter('train_eval_model.model')
    assert gin_lite.query_parameter(
        'DefaultRecordInputGenerator.batch_size') == 16
    assert gin_lite.query_parameter('Grasp2VecModel.kernel_policy') == 'pool'
    assert 'steps_per_dispatch' not in open(GIN).read()
    assert model is not None
    assert gin_lite.get_configurable('Grasp2VecModel') is not None
    assert gin_lite.get_configurable(
        'create_resnet_init_from_checkpoint_fn') is not None
  finally:
    gin_lite.clear_config()


# --------------------------------------------------------- accumulation


def _frame_batches(count, seed=0, batch=4):
  return [(_frames(seed + i, batch=batch), None) for i in range(count)]


def test_grad_accum_is_the_eager_accumulation():
  """One step of the ResNet-18 mock at M=2 (float32, momentum 1e-2, EMA)
  against the accumulation written out: preprocess once, forward and
  backward each half, divide the summed gradients by 2, step, EMA."""

  def make():
    return _tiny_crop_model(
        Grasp2VecModel, use_avg_model_params=True,
        create_optimizer_fn=lambda: optimizers.create_momentum_optimizer(
            1e-2))

  batch = _frame_batches(1)
  trainer = Trainer(make(), TrainerConfig(
      max_train_steps=1, log_interval_steps=0, grad_accum_microbatches=2),
                    device='cpu')
  trainer.train(iter(batch))

  model = make()
  reference = Trainer(model, TrainerConfig(max_train_steps=0), device='cpu')
  state = reference.initialize(batch[0][0])
  features, _ = model.preprocessor.preprocess(
      {k: torch.from_numpy(v) for k, v in batch[0][0].items()}, None,
      ModeKeys.TRAIN, state.generator)
  for half in (slice(0, 2), slice(2, 4)):
    f = {k: v[half] for k, v in features.items()}
    outputs = model.inference_network_fn(state.network, f, None,
                                         ModeKeys.TRAIN)
    model.model_train_fn(f, None, outputs, ModeKeys.TRAIN)[0].backward()
  for p in state.network.parameters():
    p.grad.div_(2.0)
  state.optimizer.step()
  apply_ema(state, model.avg_model_params_decay)
  for (name, got), want in zip(trainer.state.network.state_dict().items(),
                               state.network.state_dict().values()):
    assert torch.equal(got, want), name
  for name in state.ema:
    assert torch.equal(trainer.state.ema[name], state.ema[name]), name


# ------------------------------------------ trainer, records, predictor


def _write_shards(root, count=2, per_shard=2):
  spec = dict(_tiny_crop_model(Grasp2VecModel).preprocessor
              .get_in_feature_specification(ModeKeys.TRAIN).items())
  rng = np.random.RandomState(9)
  paths = []
  for shard in range(count):
    path = str(root / f'g2v-{shard:05d}-of-{count:05d}.tfrecord')
    records.write_examples(path, [example_codec.encode_example(spec, {
        key: rng.randint(0, 256, (512, 640, 3), dtype=np.uint8)
        for key in IMAGE_KEYS}, png_level=1) for _ in range(per_shard)])
    shard_index.write_index(path)
    paths.append(path)
  return paths


def test_trains_from_records_and_serves_from_checkpoint(tmp_path):
  paths = _write_shards(tmp_path)
  model = _tiny_crop_model(Grasp2VecModel, kernel_policy='pool')
  generator = DefaultRecordInputGenerator(file_patterns=','.join(paths),
                                          batch_size=2, seed=0)
  model_dir = str(tmp_path / 'model')
  train_eval_model(model, train_input_generator=generator,
                   max_train_steps=2, model_dir=model_dir, device='cpu')
  predictor = CheckpointPredictor(model, model_dir=model_dir,
                                  device='cpu')
  assert predictor.restore()
  frames = _frames(11, batch=2)
  got = predictor.predict(frames)
  network = model.create_module()
  state = torch.load(os.path.join(
      model_dir, 'checkpoints', sorted(
          n for n in os.listdir(os.path.join(model_dir, 'checkpoints'))
          if n.startswith('ckpt_') and '.' not in n)[-1], 'state.pt'),
                     weights_only=True)
  network.load_state_dict(state['network'])
  features, _ = model.preprocessor.preprocess(
      {k: torch.from_numpy(v) for k, v in frames.items()}, None,
      ModeKeys.PREDICT)
  with torch.no_grad():
    want = model.inference_network_fn(network, features, None,
                                      ModeKeys.PREDICT)
  for name in ('pre_vector', 'goal_vector', 'post_spatial'):
    assert np.array_equal(np.asarray(got[name]), want[name].numpy()), name
