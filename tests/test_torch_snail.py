"""Port parity: the SNAIL blocks and the vision tower against the flax modules.

Each case builds the flax module, draws seeded numpy variables of its
shapes (``torch_port_weights.random_variables``), carries them across with
``utils.convert.snail_variables_to_torch`` and feeds both the same seeded
numpy input. The flash path runs JAX's Pallas kernels in interpret mode
(``_flash_auto_ok`` forced on, as the JAX tests do) and the port's plain
versions. Bars: float32 values 2e-5 of the output's scale (sums are
reassociated), flash against the JAX kernels at the JAX suite's 2e-5,
input gradients 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_weights import random_variables

from tensor2robot_tpu.layers import snail as jax_snail
from tensor2robot_tpu.layers import vision_layers as jax_vision
from tensor2robot_tpu.layers.spatial_softmax import (
    spatial_softmax as jax_spatial_softmax)
from tensor2robot_tpu_torch.layers import snail, spatial_softmax, vision_layers
from tensor2robot_tpu_torch.utils import convert


def _input(shape, seed=0):
  return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _carry(flax_module, torch_module, x, seed=1, **kwargs):
  """Random flax variables for ``flax_module`` on ``x``, loaded into
  ``torch_module`` (strict)."""
  shapes = jax.eval_shape(
      lambda: flax_module.init(jax.random.PRNGKey(0), jnp.asarray(x),
                               **kwargs))
  variables = random_variables(shapes, seed=seed)
  torch_module.load_state_dict(convert.snail_variables_to_torch(variables),
                               strict=True)
  return variables


def _close(got, want, band=2e-5):
  want = np.asarray(want)
  scale = max(1.0, float(np.abs(want).max()))
  np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=band * scale)


@pytest.mark.parametrize('dilation', [1, 2, 8])
def test_causal_conv_matches_flax(dilation):
  x = _input((2, 16, 6))
  flax_conv = jax_snail.CausalConv(filters=5, dilation_rate=dilation)
  conv = snail.CausalConv(6, 5, dilation)
  variables = _carry(flax_conv, conv, x)
  want = flax_conv.apply(variables, jnp.asarray(x))
  got = conv(torch.from_numpy(x)).detach()
  assert got.shape == (2, 16, 5)
  _close(got, want)
  # Causal: the output at t never sees inputs after t.
  x2 = x.copy()
  x2[:, 9:] += 5.0
  got2 = conv(torch.from_numpy(x2)).detach()
  np.testing.assert_array_equal(got2[:, :9].numpy(), got[:, :9].numpy())


def test_dense_block_matches_flax():
  x = _input((2, 12, 6), seed=2)
  flax_block = jax_snail.DenseBlock(filters=4, dilation_rate=2)
  block = snail.DenseBlock(6, 4, 2)
  variables = _carry(flax_block, block, x)
  _close(block(torch.from_numpy(x)).detach(),
         flax_block.apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize('seq', [8, 12])
def test_tc_block_matches_flax(seq):
  """ceil(log2 T) dense blocks: 3 at T=8, 4 at T=12."""
  x = _input((2, seq, 6), seed=3)
  flax_block = jax_snail.TCBlock(sequence_length=seq, filters=4)
  block = snail.TCBlock(6, seq, 4)
  assert len(block.blocks) == int(np.ceil(np.log2(seq)))
  variables = _carry(flax_block, block, x)
  got = block(torch.from_numpy(x)).detach()
  assert got.shape[-1] == block.out_channels
  _close(got, flax_block.apply(variables, jnp.asarray(x)))


def test_causally_masked_softmax_matches_flax():
  logits = _input((2, 7, 7), seed=4)
  got = snail.causally_masked_softmax(torch.from_numpy(logits))
  want = jax_snail.causally_masked_softmax(jnp.asarray(logits))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize('path', ['dense', 'prob', 'flash'])
def test_attention_block_matches_flax(monkeypatch, path):
  """Dense (end points empty), dense with ``attn_prob``, and the flash
  path: key 64 and value 32 padded to one head dim of 64, q pre-scaled,
  read sliced to 32, as in the sequential model."""
  if path == 'flash':
    monkeypatch.setattr(jax_snail, '_flash_auto_ok', lambda: True)
    monkeypatch.setattr(snail, '_flash_auto_ok', lambda x: True)
  x = _input((2, 16, 10), seed=5)
  return_prob = path == 'prob'
  flax_block = jax_snail.AttentionBlock(key_size=64, value_size=32,
                                        return_prob=return_prob)
  block = snail.AttentionBlock(10, 64, 32, return_prob=return_prob)
  variables = _carry(flax_block, block, x)
  want, want_ends = flax_block.apply(variables, jnp.asarray(x))
  got, ends = block(torch.from_numpy(x))
  assert got.shape == (2, 16, 42)
  _close(got.detach(), want)
  assert set(ends) == set(want_ends)
  if return_prob:
    np.testing.assert_allclose(ends['attn_prob'].detach().numpy(),
                               np.asarray(want_ends['attn_prob']), atol=1e-6)


def test_attention_block_takes_the_flash_path_when_allowed(monkeypatch):
  calls = []
  real = snail.fa.flash_attention

  def spy(*args, **kwargs):
    calls.append(args[0].shape)
    return real(*args, **kwargs)

  monkeypatch.setattr(snail.fa, 'flash_attention', spy)
  block = snail.AttentionBlock(10, 64, 32)
  x = torch.from_numpy(_input((2, 16, 10)))
  block(x)
  assert not calls  # the auto gate is off for CPU tensors
  monkeypatch.setattr(snail, '_flash_auto_ok', lambda x: True)
  block(x)
  assert calls == [(2, 16, 1, 64)]
  block.use_flash = False
  block(x)
  assert len(calls) == 1
  with pytest.raises(ValueError, match='return_prob'):
    snail.AttentionBlock(10, 64, 32, return_prob=True, use_flash=True)(x)


@pytest.mark.parametrize('flash', [False, True], ids=['dense', 'flash'])
def test_multi_head_attention_block_matches_flax(monkeypatch, flash):
  """Forward and input gradients, 2 heads of 8."""
  if flash:
    monkeypatch.setattr(jax_snail, '_flash_auto_ok', lambda: True)
    monkeypatch.setattr(snail, '_flash_auto_ok', lambda x: True)
  x = _input((2, 16, 10), seed=6)
  ct = _input((2, 16, 26), seed=7)
  flax_block = jax_snail.MultiHeadAttentionBlock(num_heads=2, head_size=8)
  block = snail.MultiHeadAttentionBlock(10, 2, 8)
  variables = _carry(flax_block, block, x)

  def jax_loss(x):
    out, _ = flax_block.apply(variables, x)
    return jnp.sum(out * ct), out

  (_, want), want_grad = jax.value_and_grad(jax_loss, has_aux=True)(
      jnp.asarray(x))
  tx = torch.from_numpy(x).requires_grad_()
  got, ends = block(tx)
  (got * torch.from_numpy(ct)).sum().backward()
  assert ends == {}
  _close(got.detach(), want)
  np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_grad),
                             atol=5e-4)


@pytest.mark.parametrize('use_batch_norm', [False, True],
                         ids=['layer_norm', 'batch_norm'])
@pytest.mark.parametrize('film', [False, True], ids=['plain', 'film'])
def test_images_to_features_matches_flax(use_batch_norm, film):
  """The conv tower in train mode (batch statistics for BatchNorm), with
  and without FiLM; expected points and softmax maps."""
  images = np.random.RandomState(8).rand(3, 48, 48, 3).astype(np.float32)
  flax_tower = jax_vision.ImagesToFeaturesModel(use_batch_norm=use_batch_norm)
  tower = vision_layers.ImagesToFeaturesModel(use_batch_norm=use_batch_norm)
  params = None
  if film:
    params = 0.1 * _input((3, vision_layers.film_params_size(5)), seed=9)
  variables = _carry(flax_tower, tower, images,
                     film_output_params=None if params is None else
                     jnp.asarray(params))
  mutable = ['batch_stats'] if use_batch_norm else False
  result = flax_tower.apply(
      variables, jnp.asarray(images),
      film_output_params=None if params is None else jnp.asarray(params),
      train=True, mutable=mutable)
  (want_points, want_ends) = result[0] if use_batch_norm else result
  tower.train(True)
  points, ends = tower(torch.from_numpy(images),
                       None if params is None else torch.from_numpy(params))
  assert points.shape == (3, 64)
  _close(points.detach(), want_points)
  _close(ends['softmax'].detach(), want_ends['softmax'])
  if use_batch_norm:
    new_stats = convert.snail_variables_to_torch(
        {'batch_stats': result[1]['batch_stats']})
    state = tower.state_dict()
    for name, value in new_stats.items():
      np.testing.assert_allclose(state[name].numpy(), value.numpy(),
                                 atol=1e-6, err_msg=name)


def test_layer_norm_is_flax_not_torch_default():
  """flax's epsilon (1e-6) over the last axis, not torch's 1e-5."""
  tower = vision_layers.ImagesToFeaturesModel()
  assert tower.norm2.epsilon == 1e-6 and tower.norm2.scale is None
  assert tower.final_norm.scale is not None


def test_spatial_softmax_matches_jax():
  features = _input((2, 5, 7, 3), seed=10)
  points, maps = spatial_softmax.spatial_softmax(torch.from_numpy(features))
  want_points, want_maps = jax_spatial_softmax(jnp.asarray(features))
  np.testing.assert_allclose(points.numpy(), np.asarray(want_points),
                             atol=1e-6)
  np.testing.assert_allclose(maps.numpy(), np.asarray(want_maps), atol=1e-6)
  gumbel, _ = spatial_softmax.spatial_softmax(
      torch.from_numpy(features), spatial_gumbel_softmax=True,
      generator=torch.Generator().manual_seed(0))
  assert gumbel.shape == (2, 6) and bool((gumbel.abs() <= 1).all())


def test_film_modulation_and_params_match_flax():
  net, gamma, beta = _input((2, 3, 3, 4)), _input((2, 4), 1), _input((2, 4), 2)
  np.testing.assert_allclose(
      vision_layers.film_modulation(*map(torch.from_numpy,
                                         (net, gamma, beta))).numpy(),
      np.asarray(jax_vision.film_modulation(*map(jnp.asarray,
                                                 (net, gamma, beta)))),
      atol=1e-6)
  embedding = _input((2, 16), seed=3)
  flax_film = jax_vision.FILMParams()
  film = vision_layers.FILMParams(16)
  variables = _carry(flax_film, film, embedding)
  _close(film(torch.from_numpy(embedding)).detach(),
         flax_film.apply(variables, jnp.asarray(embedding)))
