"""Port parity: ``layers/resnet.py`` against the JAX package's ResNet.

* ``FilmResNet`` v1 and v2, batch 2, each version with FiLM on one block
  kind and off on the other: the JAX variables converted by
  ``utils/convert.resnet_variables_to_torch`` give, in train mode, every
  endpoint, the new batch statistics and the gradients of every parameter
  and of the images, and in eval mode every endpoint, within a band of
  each tensor's largest magnitude: basic blocks (ResNet-18, 48 px) in
  float32 within ``F32_BAND`` under ``kernel_policy`` 'none' and 'pool'
  (the stem pool's plain version on the CPU); bottlenecks (ResNet-50,
  64 px) in float64 within ``F64_BAND`` (see the bands' comment), and
  their float32 forward under 'pool' bit for bit 'none'. The JAX side
  runs once per case, jitted, in a cached helper; its ``kernel_policy``
  does not change its numbers off the TPU.
* The bf16 overlapping pool backward (the stem's 3x3/s2 with (1, 1)
  padding): the plain version of the port's gather route is bit for bit
  XLA's ``select_and_scatter`` on the CPU, on maxima planted where four
  windows overlap: XLA's CPU backward also adds the routed cotangents in
  bfloat16 in ascending window order. A float32 sum rounded once differs
  from both, so the check can tell the two apart.
* The converter: an unmapped leaf raises; a ``final_dense`` / ``film``
  round trip; the initialiser's scale.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.layers import resnet as jax_resnet
from tensor2robot_tpu_torch.layers import resnet
from tensor2robot_tpu_torch.ops import pool
from tensor2robot_tpu_torch.utils import convert
from torch_port_weights import random_variables

BATCH = 2
EMBEDDING = 4
NUM_CLASSES = 5
IMAGE = {18: 48, 50: 64}
# Of each tensor's largest magnitude. Float32 for ResNet-18 (the convs'
# sums are reassociated). ResNet-50's train-mode gradients are held in
# float64: at 64-128 px and batch 2 the float32 image and conv gradients
# of both packages lie 1-8% from a float64 run (measured: JAX 4.8-8.4%,
# the port 0.5-4.6%), so float32 cannot tell a fault from rounding there.
F32_BAND = 2e-4
# Float64: the worst leaf measured is the stem conv's gradient, 2.9e-8
# (every other tensor under 1e-9).
F64_BAND = 1e-7
STEM = ((3, 3), (2, 2), ((1, 1), (1, 1)))


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _inputs(size):
  rng = np.random.RandomState(size)
  images = rng.rand(BATCH, IMAGE[size], IMAGE[size], 3).astype(np.float32)
  embedding = rng.randn(BATCH, EMBEDDING).astype(np.float32)
  cotangent = rng.randn(BATCH, NUM_CLASSES).astype(np.float32)
  return images, embedding, cotangent


@functools.lru_cache(maxsize=None)
def _jax_case(version, size, film, float64=False):
  """The JAX FilmResNet's variables, its train step (endpoints, new batch
  statistics, gradients of the parameters and the images of
  sum(cotangent * logits)) and its eval endpoints, in one jitted call, in
  float32 or (under ``jax.enable_x64``) float64."""
  module = jax_resnet.FilmResNet(resnet_size=size, num_classes=NUM_CLASSES,
                                 version=version)
  dtype = np.float64 if float64 else np.float32
  images, embedding, cotangent = (a.astype(dtype) for a in _inputs(size))
  shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), images,
                          embedding)
  variables = jax.tree_util.tree_map(
      lambda a: a.astype(dtype), random_variables(shapes, seed=size + version))
  emb = embedding if film else None

  def loss_fn(params, x):
    (out, endpoints), new_state = module.apply(
        {'params': params, 'batch_stats': variables['batch_stats']}, x, emb,
        train=True, mutable=['batch_stats'])
    return jnp.sum(out * cotangent), (endpoints, new_state)

  @jax.jit
  def run(variables, x):
    (_, (endpoints, new_state)), (dparams, dimages) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(variables['params'], x)
    _, eval_endpoints = module.apply(variables, x, emb, train=False)
    return dict(endpoints=endpoints, batch_stats=new_state['batch_stats'],
                dparams=dparams, dimages=dimages,
                eval_endpoints=eval_endpoints)

  with jax.enable_x64(float64):
    return variables, jax.device_get(run(variables, images))


def _close(got, want, what, band):
  got = np.asarray(got, np.float64)
  want = np.asarray(want, np.float64)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  scale = max(float(np.max(np.abs(want))), 1e-30)
  err = float(np.max(np.abs(got - want)))
  assert err <= band * scale, (what, err, scale)


def _check_against_jax(version, size, film, policy, band, float64=False):
  """Every endpoint in eval and train mode, the new batch statistics and
  the gradients of the parameters and the images, against the JAX case."""
  variables, want = _jax_case(version, size, film, float64)
  dtype = torch.float64 if float64 else torch.float32
  images, embedding, cotangent = (torch.from_numpy(a).to(dtype)
                                  for a in _inputs(size))
  network = resnet.FilmResNet(resnet_size=size, num_classes=NUM_CLASSES,
                              version=version, kernel_policy=policy,
                              embedding_size=EMBEDDING)
  network.load_state_dict(convert.resnet_variables_to_torch(variables))
  network.to(dtype)
  x = images.clone().requires_grad_(True)
  emb = embedding if film else None
  network.eval()
  with torch.no_grad():
    _, eval_endpoints = network(images, emb)
  for name, value in eval_endpoints.items():
    _close(value, want['eval_endpoints'][name], f'eval {name}', band)
  network.train()
  out, endpoints = network(x, emb)
  assert set(endpoints) == set(want['endpoints'])
  for name, value in endpoints.items():
    _close(value.detach(), want['endpoints'][name], name, band)
  (out * cotangent).sum().backward()
  _close(x.grad, want['dimages'], 'images', band)
  grads = convert.resnet_variables_to_torch({'params': want['dparams']})
  stats = convert.resnet_variables_to_torch(
      {'batch_stats': {'resnet': want['batch_stats']['resnet']}})
  checked = 0
  for name, param in network.named_parameters():
    if not film and name.startswith('film_generator'):
      assert param.grad is None
      continue
    _close(param.grad, grads[name], name, band)
    checked += 1
  assert checked == len(grads) - (0 if film else 8)
  buffers = dict(network.named_buffers())
  for name, value in stats.items():
    _close(buffers[name], value, name, band)


# Basic blocks in float32: each version, FiLM on in one and off in the other;
# the JAX side runs once per case, the port under both policies.
@pytest.mark.parametrize('version,film', [(1, True), (2, False)])
@pytest.mark.parametrize('policy', ['none', 'pool'])
def test_resnet18_matches_jax_float32(version, film, policy):
  _check_against_jax(version, 18, film, policy, F32_BAND)


@pytest.mark.parametrize('version,film', [(1, False), (2, True)])
def test_resnet50_matches_jax_float64(version, film):
  _check_against_jax(version, 50, film, 'none', F64_BAND, float64=True)


@pytest.mark.parametrize('version', [1, 2])
def test_resnet50_pool_policy_forward_is_bitwise_none(version):
  """The stem pool's plain kernel version against the stock pool, through
  the whole ResNet-50 forward in float32, at a quarter of the width (the
  backward of the plain version is held to XLA's in ResNet-18 and bit for
  bit below)."""
  images = torch.from_numpy(
      np.random.RandomState(version).rand(BATCH, 32, 32, 3).astype(
          np.float32))
  outs = []
  for policy in ('none', 'pool'):
    network = resnet.ResNet(resnet_size=50, num_classes=NUM_CLASSES,
                            num_filters=16, version=version,
                            kernel_policy=policy)
    network.init_weights(torch.Generator().manual_seed(version))
    network.train()
    with torch.no_grad():
      outs.append(network(images)[1])
  for name in outs[0]:
    assert torch.equal(outs[0][name], outs[1][name]), name


def test_bf16_overlapping_pool_backward_is_xla_bit_for_bit():
  rng = np.random.RandomState(0)
  x = rng.randn(2, 15, 15, 8).astype(np.float32)
  x[:, 1::2, 1::2, :] += 10.0  # maxima that up to four windows select
  xb = jnp.asarray(x, jnp.bfloat16)
  window, strides, pads = STEM
  out, vjp = jax.vjp(
      lambda a: nn.max_pool(a, window, strides=strides, padding=pads), xb)
  g = (rng.randn(*out.shape) * np.exp(2 * rng.randn(*out.shape))).astype(
      np.float32)
  want = np.asarray(vjp(jnp.asarray(g, jnp.bfloat16))[0].astype(jnp.float32))
  xt = torch.from_numpy(x).to(torch.bfloat16)
  pooled, slot = pool.plain_max_pool_argmax(xt, window, strides, pads)
  assert np.array_equal(pooled.float().numpy(),
                        np.asarray(out.astype(jnp.float32)))
  gt = torch.from_numpy(g).to(torch.bfloat16)
  got = pool.plain_max_pool_bwd(gt, slot, xt.shape, window, strides, pads)
  assert np.array_equal(got.float().numpy(), want)
  # Through the autograd Function, as the stem runs it.
  xr = xt.clone().requires_grad_(True)
  pool.max_pool_argmax(xr, window, strides, pads)[0].backward(gt)
  assert np.array_equal(xr.grad.float().numpy(), want)
  # Control: a float32 sum rounded once to bf16 differs.
  once = pool.plain_max_pool_bwd(gt.float(), slot, xt.shape, window, strides,
                                 pads).to(torch.bfloat16).float().numpy()
  assert not np.array_equal(once, want)


def test_converter_raises_on_unmapped_leaf():
  variables = _jax_case(2, 18, False, False)[0]
  bad = {'params': dict(variables['params'])}
  bad['params']['resnet'] = dict(bad['params']['resnet'])
  bad['params']['resnet']['extra'] = {'kernel': np.zeros((1, 1, 3, 3))}
  with pytest.raises(ValueError, match='Unmapped'):
    convert.resnet_variables_to_torch(bad)
  with pytest.raises(ValueError, match='Unmapped'):
    convert.resnet_variables_to_torch(
        {'fp8_stats': {'resnet': {'initial_conv': {'scale': np.ones(1)}}}})


def test_converter_layouts_and_strict_load():
  variables = _jax_case(1, 18, True, False)[0]
  state = convert.resnet_variables_to_torch(variables)
  params = variables['params']
  np.testing.assert_array_equal(
      state['resnet.initial_conv.weight'].numpy(),
      params['resnet']['initial_conv']['kernel'].transpose(3, 2, 0, 1))
  np.testing.assert_array_equal(
      state['resnet.final_dense.weight'].numpy(),
      params['resnet']['final_dense']['kernel'].T)
  np.testing.assert_array_equal(
      state['film_generator.film2.weight'].numpy(),
      params['film_generator']['film2']['kernel'].T)
  np.testing.assert_array_equal(
      state['resnet.block_layer2_block0.bn0.mean'].numpy(),
      variables['batch_stats']['resnet']['block_layer2_block0'][
          '_BatchNorm_0']['BatchNorm_0']['mean'])
  network = resnet.FilmResNet(resnet_size=18, num_classes=NUM_CLASSES,
                              version=1, embedding_size=EMBEDDING)
  assert set(network.state_dict()) == set(state)
  del state['resnet.bn0.var']
  with pytest.raises(RuntimeError, match='Missing'):
    network.load_state_dict(state)


def test_initialisers_follow_flax():
  network = resnet.ResNet(resnet_size=50, num_classes=NUM_CLASSES)
  network.init_weights(torch.Generator().manual_seed(0))
  weight = network.block_layer3_block0.conv2.weight.detach()
  fan_out = weight.shape[0] * weight.shape[2] * weight.shape[3]
  std = float(weight.std())
  # variance_scaling(2.0, 'fan_out', 'truncated_normal') has std
  # sqrt(2 / fan_out) after the truncation.
  assert abs(std / np.sqrt(2.0 / fan_out) - 1.0) < 0.02
  assert float(weight.abs().max()) <= 2 * np.sqrt(
      2.0 / fan_out) / .87962566103423978 + 1e-6
  assert torch.all(network.bn0.scale == 1) and torch.all(network.bn0.var == 1)
  dense = network.final_dense.weight
  assert abs(float(dense.detach().std()) * np.sqrt(dense.shape[1]) - 1.0) < 0.05
  assert torch.all(network.final_dense.bias == 0)


def test_channels_last_stem_and_endpoints():
  network = resnet.ResNet(resnet_size=18, kernel_policy='pool')
  network.init_weights(torch.Generator().manual_seed(0))
  network.train()
  copies = pool.MaxPoolArgmax.cotangent_copies
  x = torch.rand(2, 40, 40, 3, requires_grad=True)
  out, endpoints = network(x)
  out.sum().backward()
  # The pool reads and writes the convs' channels-last storage: the NHWC
  # endpoints are contiguous views, and its cotangent needs no copy.
  for name in ('initial_conv', 'initial_max_pool', 'block_layer1'):
    assert endpoints[name].is_contiguous(), name
  assert pool.MaxPoolArgmax.cotangent_copies == copies
  assert endpoints['initial_max_pool'].shape == (2, 10, 10, 64)
  assert out.shape == (2, 512)


def test_resnet_model_alias_and_film_checks():
  images = torch.zeros(1, 32, 32, 3)
  module, same = resnet.resnet_model(images, is_training=False,
                                     num_classes=3, resnet_size=18)
  assert module is same and not module.training
  assert module(images)[0].shape == (1, 3)
  with pytest.raises(ValueError, match='enabled_block_layers'):
    resnet.LinearFilmGenerator(4, [2, 2, 2, 2], [64, 128, 256, 512],
                               [True, False])
  generator = resnet.LinearFilmGenerator(4, [2, 2, 2, 2],
                                         [64, 128, 256, 512],
                                         [True, False, True, False])
  gammas = generator(torch.zeros(1, 4))
  assert gammas[1] == [None, None] and gammas[2][1].shape == (1, 512)
  with pytest.raises(ValueError, match='embedding_size'):
    resnet.FilmResNet(resnet_size=18)(images, torch.zeros(1, 4))
