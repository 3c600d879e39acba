"""Port parity: the space-to-depth first-layer conv against the JAX package.

The port's plain ``conv2d``, ``plain_conv2d_dw`` and ``plain_conv2d_dx``
(im2col in tap order + float32 matmuls; what a CPU tensor runs, and what
``chip_smoke.py`` holds the CUDA kernels against on the card) are compared
with the JAX Pallas kernels ``pallas_conv2d`` and its VJP (interpreted on
the CPU) and with ``reference_conv2d`` (``lax.conv_general_dilated``).

Bands: 1e-5 (rtol and atol) in float32, the JAX kernel's own bar, and for
dW and dx 1e-5 of the gradient's largest magnitude (dW sums batch*H*W
products, so its reassociation noise scales with it); in bfloat16 both
sides accumulate in float32 and round once, so they may differ by one
bfloat16 ulp where the float32 sums straddle a rounding boundary: rtol
2**-7.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tensor2robot_tpu.ops import _pallas_dispatch
from tensor2robot_tpu.ops import conv_s2d as jax_conv
from tensor2robot_tpu_torch.ops import conv_s2d as torch_conv

CASES = [
    # the QT-Opt conv1 geometry (6x6/s2 SAME, cin 3) at mock scale, full cout
    ((2, 48, 48, 3), (6, 6, 3, 64), (2, 2), 'SAME'),
    ((2, 29, 31, 3), (6, 6, 3, 8), (2, 2), 'SAME'),
    # explicit asymmetric pads, a 7x7 window
    ((1, 20, 20, 3), (7, 7, 3, 8), (2, 2), ((2, 3), (2, 3))),
    ((1, 17, 17, 2), (3, 3, 2, 8), (1, 1), 'SAME'),
    ((2, 15, 11, 3), (5, 3, 3, 8), (3, 2), 'VALID'),
]
IDS = ['conv1', 'conv1_odd', 'explicit_pads', 'stride1', 'valid']


def _inputs(xshape, wshape, seed=11):
  rng = np.random.RandomState(seed)
  return (rng.randn(*xshape).astype(np.float32),
          (rng.randn(*wshape) * 0.1).astype(np.float32))


@pytest.mark.parametrize('xshape,wshape,strides,padding', CASES, ids=IDS)
def test_plain_conv_float32_band_vs_jax(xshape, wshape, strides, padding):
  x, w = _inputs(xshape, wshape)
  pads = torch_conv.resolve_padding(padding, wshape[:2], strides, xshape[1:3])
  assert pads == jax_conv.resolve_padding(padding, wshape[:2], strides,
                                          xshape[1:3])
  got = torch_conv.conv2d(torch.from_numpy(x), torch.from_numpy(w), strides,
                          padding).numpy()
  jx, jw = jnp.asarray(x), jnp.asarray(w)
  kernel = np.asarray(jax_conv.pallas_conv2d(jx, jw, strides, pads))
  reference = np.asarray(jax_conv.reference_conv2d(jx, jw, strides, padding))
  np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(got, reference, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('xshape,wshape,strides,padding', CASES[:3],
                         ids=IDS[:3])
def test_plain_conv_bfloat16_band_vs_jax(xshape, wshape, strides, padding):
  x, w = _inputs(xshape, wshape, seed=5)
  x = x.astype(ml_dtypes.bfloat16)
  w = w.astype(ml_dtypes.bfloat16)
  pads = torch_conv.resolve_padding(padding, wshape[:2], strides, xshape[1:3])
  got = torch_conv.conv2d(
      torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16),
      torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16), strides,
      padding)
  assert got.dtype == torch.bfloat16
  kernel = jax_conv.pallas_conv2d(jnp.asarray(x), jnp.asarray(w), strides,
                                  pads)
  assert kernel.dtype == jnp.bfloat16
  np.testing.assert_allclose(got.float().numpy(),
                             np.asarray(kernel).astype(np.float32),
                             rtol=2**-7, atol=1e-6)


def test_reference_conv_matches_plain():
  """The stock F.conv2d form (kernel policy 'none') is in the same band."""
  x, w = _inputs((2, 29, 31, 3), (6, 6, 3, 8))
  tx, tw = torch.from_numpy(x), torch.from_numpy(w)
  np.testing.assert_allclose(
      torch_conv.reference_conv2d(tx, tw, (2, 2), 'SAME').numpy(),
      torch_conv.conv2d(tx, tw, (2, 2), 'SAME').numpy(),
      rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('use_bias', [False, True])
def test_space_to_depth_conv_keeps_nn_conv_param_tree(use_bias):
  """The module's parameters are flax nn.Conv's, by name and shape, and it
  computes nn.Conv's function on those parameters."""
  flax_conv = nn.Conv(8, (6, 6), strides=(2, 2), padding='SAME',
                      use_bias=use_bias,
                      kernel_init=nn.initializers.normal(0.1),
                      bias_init=nn.initializers.normal(0.1))
  x = np.random.RandomState(0).randn(2, 20, 22, 3).astype(np.float32)
  variables = flax_conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
  flax_params = jax.device_get(variables['params'])

  module = torch_conv.SpaceToDepthConv(3, 8, (6, 6), strides=(2, 2),
                                       padding='SAME', use_bias=use_bias)
  shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
  assert shapes == {k: tuple(v.shape) for k, v in flax_params.items()}
  module.load_state_dict(
      {k: torch.from_numpy(np.array(v)) for k, v in flax_params.items()})
  got = module(torch.from_numpy(x)).detach().numpy()
  want = np.asarray(flax_conv.apply(variables, jnp.asarray(x)))
  np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_jax_conv_gate_refuses_full_width_conv1():
  """Fault of the JAX package: its kernel gate budgets VMEM for the dx
  kernel even for a forward-only call, and at the full QT-Opt width that
  estimate (19.7 MB) exceeds its 10 MB budget, so conv1 of a 472x472 tower
  never takes the Pallas kernel. The port's kernel takes that shape."""
  xshape, wshape = (64, 472, 472, 3), (6, 6, 3, 64)
  assert not jax_conv.is_supported(xshape, wshape, (2, 2), 'SAME')
  assert jax_conv.is_supported((2, 80, 80, 3), wshape, (2, 2), 'SAME')
  assert torch_conv.is_supported(xshape, wshape, (2, 2), 'SAME',
                                 torch.bfloat16)


def test_unsupported_conv_raises():
  x = torch.zeros((1, 16, 16, 64))
  w = torch.zeros((3, 3, 64, 64))
  assert not torch_conv.is_supported(x.shape, w.shape, (1, 1), 'SAME')
  with pytest.raises(ValueError):
    torch_conv.conv2d(x, w, (1, 1), 'SAME')
  with pytest.raises(ValueError):
    torch_conv.conv2d(torch.zeros((1, 8, 8, 3)),
                      torch.zeros((3, 3, 3, 8), dtype=torch.bfloat16),
                      (1, 1), 'SAME')


def _assert_band(got, want, band=1e-5):
  scale = float(np.abs(want).max()) or 1.0
  np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=band)


@pytest.mark.parametrize('xshape,wshape,strides,padding', CASES, ids=IDS)
def test_plain_conv_grads_band_vs_jax(xshape, wshape, strides, padding):
  """plain dW and dx against jax.grad of the JAX kernel (its dW and dx
  kernels), and the autograd Function's gradients against both."""
  x, w = _inputs(xshape, wshape, seed=3)
  pads = torch_conv.resolve_padding(padding, wshape[:2], strides, xshape[1:3])
  tx = torch.from_numpy(x).requires_grad_()
  tw = torch.from_numpy(w).requires_grad_()
  out = torch_conv.conv2d(tx, tw, strides, padding)
  assert type(out.grad_fn).__name__ == 'Conv2dS2DBackward'
  g = np.random.RandomState(4).randn(*out.shape).astype(np.float32)
  tg = torch.from_numpy(g)
  out.backward(tg)
  with _pallas_dispatch.force_kernels(True):
    want_dx, want_dw = jax.grad(
        lambda a, b: jnp.sum(jax_conv.pallas_conv2d(a, b, strides, pads) * g),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
  want_dx, want_dw = np.asarray(want_dx), np.asarray(want_dw)
  dw = torch_conv.plain_conv2d_dw(torch.from_numpy(x), tg, wshape, strides,
                                  pads)
  dx = torch_conv.plain_conv2d_dx(tg, torch.from_numpy(w), xshape, strides,
                                  pads)
  for got, want in ((dw, want_dw), (dx, want_dx), (tw.grad, want_dw),
                    (tx.grad, want_dx)):
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _assert_band(got.numpy(), want)


def test_plain_dw_rounds_to_the_weights_dtype():
  """Under bfloat16 dW leaves the kernel in bfloat16: the float32 sum
  rounded once, as the JAX kernel casts to w.dtype; autograd then casts it
  into the float32 parameter's gradient."""
  x, w = _inputs((2, 29, 31, 3), (6, 6, 3, 8), seed=6)
  xb = torch.from_numpy(x).to(torch.bfloat16)
  param = torch.from_numpy(w).requires_grad_()
  out = torch_conv.conv2d(xb, param.to(torch.bfloat16), (2, 2), 'SAME')
  g = torch.from_numpy(
      np.random.RandomState(2).randn(*out.shape).astype(np.float32)).to(
          torch.bfloat16)
  out.backward(g)
  pads = torch_conv.resolve_padding('SAME', (6, 6), (2, 2), (29, 31))
  dw32 = torch_conv.plain_conv2d_dw(xb.float(), g.float(), w.shape, (2, 2),
                                    pads)
  dwb = torch_conv.plain_conv2d_dw(xb, g, w.shape, (2, 2), pads)
  assert dwb.dtype == torch.bfloat16
  assert torch.equal(dwb, dw32.to(torch.bfloat16))
  assert param.grad.dtype == torch.float32
  assert torch.equal(param.grad, dwb.float())


@pytest.mark.parametrize('input_grad', [False, True])
def test_backward_computes_dx_only_when_the_input_needs_it(monkeypatch,
                                                           input_grad):
  calls = []
  plain_dx = torch_conv.plain_conv2d_dx

  def counting_dx(*args):
    calls.append(1)
    return plain_dx(*args)

  monkeypatch.setattr(torch_conv, 'plain_conv2d_dx', counting_dx)
  x, w = _inputs((1, 20, 20, 3), (6, 6, 3, 8))
  tx = torch.from_numpy(x).requires_grad_(input_grad)
  tw = torch.from_numpy(w).requires_grad_()
  torch_conv.conv2d(tx, tw, (2, 2), 'SAME').sum().backward()
  assert len(calls) == int(input_grad)
  assert (tx.grad is not None) == input_grad
  assert tw.grad is not None
