"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips with a reason where no CUDA card is
visible. ``chip_smoke.py`` holds the kernels at the main path's shapes;
these tests cover the other geometries the wrappers accept (odd sizes,
VALID and explicit pads, overlapping windows, Cout that is not a multiple
of the kernel's 64-channel block, one and two input channels, partial
pixel tiles), for the forward kernels and for the backward ones (pool
routing: bitwise; conv dW and dx: the forward's bands, dW repeated bit for
bit), and the autograd Functions launching them. The file imports neither JAX nor the JAX package, and the
repository's ``tests/conftest.py`` does, so on a machine with a card run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from tensor2robot_tpu_torch.ops import conv_s2d, pool

pytestmark = pytest.mark.cuda

POOL_CASES = [
    ('pool1', (2, 236, 236, 8), (3, 3), (3, 3), 'SAME'),
    ('pool2', (2, 79, 79, 64), (3, 3), (3, 3), 'SAME'),
    ('pool3', (3, 27, 27, 16), (2, 2), (2, 2), 'SAME'),
    ('overlap_3x3_s2', (2, 23, 23, 8), (3, 3), (2, 2), 'SAME'),
    ('valid', (1, 10, 13, 5), (2, 3), (2, 3), 'VALID'),
    ('odd', (2, 11, 13, 3), (3, 2), (1, 2), 'SAME'),
    ('explicit_pads', (1, 9, 9, 7), (3, 3), (2, 2), ((2, 0), (1, 2))),
]
CONV_CASES = [
    ('conv1', (2, 48, 48, 3), (6, 6, 3, 64), (2, 2), 'SAME'),
    ('cout72', (1, 29, 31, 3), (6, 6, 3, 72), (2, 2), 'SAME'),
    ('explicit_pads', (1, 20, 20, 3), (7, 7, 3, 8), (2, 2), ((2, 3), (2, 3))),
    ('stride1_cin2', (1, 17, 17, 2), (3, 3, 2, 8), (1, 1), 'SAME'),
    ('valid_cin1', (2, 15, 11, 1), (5, 3, 1, 8), (3, 2), 'VALID'),
]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(name='device')
def _device():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card: the kernels build and run only there')
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return torch.device('cuda')


def _tied(shape, dtype, device, seed=0):
  generator = torch.Generator().manual_seed(seed)
  x = torch.randn(shape, generator=generator)
  x[..., 0] = torch.round(x[..., 0] * 2) / 2
  return x.to(device=device, dtype=dtype)


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('name,shape,window,strides,padding', POOL_CASES,
                         ids=[case[0] for case in POOL_CASES])
def test_pool_kernel_bitwise_vs_plain(device, name, shape, window, strides,
                                      padding, dtype):
  del name
  x = _tied(shape, dtype, device)
  pads = pool.resolve_padding(padding, window, strides, shape[1:3])
  before = pool.pool_fwd.launches
  got = pool.pool_fwd(x, window, strides, pads)
  want = pool.plain_max_pool_argmax(x, window, strides, pads)
  torch.cuda.synchronize()
  assert pool.pool_fwd.launches == before + 1
  assert got[0].dtype == dtype and got[1].dtype == torch.int32
  assert torch.equal(got[0], want[0])
  assert torch.equal(got[1], want[1])


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('name,xshape,wshape,strides,padding', CONV_CASES,
                         ids=[case[0] for case in CONV_CASES])
def test_conv_kernel_band_vs_plain(device, name, xshape, wshape, strides,
                                   padding, dtype):
  """float32: 1e-5, the JAX kernel's bar; bfloat16: one bfloat16 ulp
  (2**-7 relative), where the two float32 sums round to neighbours."""
  del name
  generator = torch.Generator().manual_seed(1)
  x = torch.randn(xshape, generator=generator).to(device=device, dtype=dtype)
  w = (0.1 * torch.randn(wshape, generator=generator)).to(device=device,
                                                          dtype=dtype)
  pads = conv_s2d.resolve_padding(padding, wshape[:2], strides, xshape[1:3])
  before = conv_s2d.conv_s2d_fwd.launches
  got = conv_s2d.conv_s2d_fwd(x, w, strides, pads)
  want = conv_s2d.plain_conv2d(x, w, strides, pads)
  torch.cuda.synchronize()
  assert conv_s2d.conv_s2d_fwd.launches == before + 1
  assert got.dtype == dtype and got.shape == want.shape
  band = 1e-5 if dtype == torch.float32 else 2.0**-7
  torch.testing.assert_close(got.float(), want.float(), rtol=band,
                             atol=band if dtype == torch.float32 else 1e-6)


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('name,shape,window,strides,padding', POOL_CASES,
                         ids=[case[0] for case in POOL_CASES])
def test_pool_bwd_kernel_bitwise_vs_plain(device, name, shape, window,
                                          strides, padding, dtype):
  del name
  x = _tied(shape, dtype, device)
  pads = pool.resolve_padding(padding, window, strides, shape[1:3])
  _, slot = pool.pool_fwd(x, window, strides, pads)
  g = _tied(tuple(slot.shape), dtype, device, seed=3)
  before = pool.pool_bwd.launches
  got = pool.pool_bwd(g, slot, shape, window, strides, pads)
  want = pool.plain_max_pool_bwd(g, slot, shape, window, strides, pads)
  torch.cuda.synchronize()
  assert pool.pool_bwd.launches == before + 1
  assert got.dtype == dtype and tuple(got.shape) == shape
  assert torch.equal(got, want)


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('name,xshape,wshape,strides,padding', CONV_CASES,
                         ids=[case[0] for case in CONV_CASES])
def test_conv_grad_kernels_band_vs_plain(device, name, xshape, wshape,
                                         strides, padding, dtype):
  """dW and dx in the forward's bands, relative to each gradient's largest
  magnitude; dW twice, bit for bit."""
  del name
  generator = torch.Generator().manual_seed(2)
  x = torch.randn(xshape, generator=generator).to(device=device, dtype=dtype)
  w = (0.1 * torch.randn(wshape, generator=generator)).to(device=device,
                                                          dtype=dtype)
  pads = conv_s2d.resolve_padding(padding, wshape[:2], strides, xshape[1:3])
  out_shape = conv_s2d.plain_conv2d(x, w, strides, pads).shape
  g = torch.randn(out_shape, generator=generator).to(device=device,
                                                     dtype=dtype)
  before = (conv_s2d.conv_s2d_dw.launches, conv_s2d.conv_s2d_dx.launches)
  dw = conv_s2d.conv_s2d_dw(x, g, wshape, strides, pads)
  dw_again = conv_s2d.conv_s2d_dw(x, g, wshape, strides, pads)
  dx = conv_s2d.conv_s2d_dx(g, w, xshape, strides, pads)
  want_dw = conv_s2d.plain_conv2d_dw(x, g, wshape, strides, pads)
  want_dx = conv_s2d.plain_conv2d_dx(g, w, xshape, strides, pads)
  torch.cuda.synchronize()
  assert (conv_s2d.conv_s2d_dw.launches,
          conv_s2d.conv_s2d_dx.launches) == (before[0] + 2, before[1] + 1)
  assert torch.equal(dw, dw_again)
  band = 1e-5 if dtype == torch.float32 else 2.0**-7
  for got, want in ((dw, want_dw), (dx, want_dx)):
    assert got.dtype == dtype and got.shape == want.shape
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float() / scale, want.float() / scale,
                               rtol=band, atol=band)


def test_autograd_functions_launch_the_backward_kernels(device):
  x = _tied((2, 12, 12, 8), torch.float32, device).requires_grad_()
  before = (pool.pool_fwd.launches, pool.pool_bwd.launches)
  pool.max_pool(x, (2, 2), (2, 2), 'SAME').sum().backward()
  assert (pool.pool_fwd.launches, pool.pool_bwd.launches) == (
      before[0] + 1, before[1] + 1)
  image = _tied((1, 20, 20, 3), torch.float32, device)
  kernel = _tied((6, 6, 3, 8), torch.float32, device).requires_grad_()
  counts = (conv_s2d.conv_s2d_dw.launches, conv_s2d.conv_s2d_dx.launches)
  conv_s2d.conv2d(image, kernel, (2, 2), 'SAME').sum().backward()
  assert (conv_s2d.conv_s2d_dw.launches,
          conv_s2d.conv_s2d_dx.launches) == (counts[0] + 1, counts[1])
  image.requires_grad_()
  conv_s2d.conv2d(image, kernel, (2, 2), 'SAME').sum().backward()
  assert conv_s2d.conv_s2d_dx.launches == counts[1] + 1
  assert image.grad is not None and kernel.grad is not None


def test_kernel_entries_launch_on_cuda_tensors(device):
  x = _tied((1, 12, 12, 8), torch.float32, device)
  before = pool.pool_fwd.launches
  out = pool.max_pool(x, (2, 2), (2, 2), 'SAME')
  assert pool.pool_fwd.launches == before + 1
  assert out.device.type == 'cuda'
  image = _tied((1, 20, 20, 3), torch.float32, device)
  kernel = _tied((6, 6, 3, 8), torch.float32, device)
  before = conv_s2d.conv_s2d_fwd.launches
  conv_s2d.conv2d(image, kernel, (2, 2), 'SAME')
  assert conv_s2d.conv_s2d_fwd.launches == before + 1


def test_wrappers_refuse_what_the_kernels_do_not_take(device):
  x = _tied((1, 8, 8, 8), torch.float32, device)
  with pytest.raises(ValueError, match='contiguous'):
    pool.pool_fwd(x.permute(0, 2, 1, 3), (2, 2), (2, 2), ((0, 0), (0, 0)))
  with pytest.raises(ValueError, match='unsupported'):
    pool.pool_fwd(x.half(), (2, 2), (2, 2), ((0, 0), (0, 0)))
  w = _tied((3, 3, 8, 4), torch.float32, device)
  with pytest.raises(ValueError, match='unsupported'):
    conv_s2d.conv_s2d_fwd(x, w.bfloat16(), (1, 1), ((1, 1), (1, 1)))
  with pytest.raises(ValueError, match='unsupported'):
    conv_s2d.conv_s2d_fwd(_tied((1, 8, 8, 16), torch.float32, device),
                          _tied((3, 3, 16, 4), torch.float32, device),
                          (1, 1), ((1, 1), (1, 1)))
  _, slot = pool.pool_fwd(x, (2, 2), (2, 2), ((0, 0), (0, 0)))
  g = _tied(tuple(slot.shape), torch.float32, device)
  with pytest.raises(ValueError, match='contiguous'):
    pool.pool_bwd(g.permute(0, 2, 1, 3), slot, x.shape, (2, 2), (2, 2),
                  ((0, 0), (0, 0)))
  with pytest.raises(ValueError, match='unsupported'):
    pool.pool_bwd(g, slot.long(), x.shape, (2, 2), (2, 2), ((0, 0), (0, 0)))
  image = _tied((1, 12, 12, 3), torch.float32, device)
  cot = _tied((1, 6, 6, 8), torch.float32, device)
  with pytest.raises(ValueError, match='unsupported'):
    conv_s2d.conv_s2d_dw(image, cot.bfloat16(), (3, 3, 3, 8), (2, 2),
                         ((1, 1), (1, 1)))
  with pytest.raises(ValueError, match='unsupported'):
    conv_s2d.conv_s2d_dx(cot, _tied((3, 3, 3, 8), torch.float32, device),
                         (1, 13, 12, 3), (2, 2), ((1, 1), (1, 1)))
  with pytest.raises(ValueError, match='CUDA'):
    conv_s2d.conv_s2d_dw(image.cpu(), cot, (3, 3, 3, 8), (2, 2),
                         ((1, 1), (1, 1)))
