"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips with a reason where no CUDA card is
visible. ``chip_smoke.py`` holds the kernels at the main path's shapes;
these tests cover the other geometries the wrappers accept (odd sizes,
VALID and explicit pads, overlapping windows, Cout that is not a multiple
of the kernel's 64-channel block, one, two and eight input channels, the
deepest patch of 512 taps, partial pixel tiles, strides 1 and 3), for the
forward kernels and for the backward ones (pool routing: bit for bit with
NaN, -0.0 and infinite cotangents, on the scatter route where windows do
not overlap, its vector and one-channel instantiations with templated and
runtime windows and its 64-bit offsets, on the gather route where they
do; conv dW and dx: the forward's bands; the conv forward, dW and dx
repeated bit for bit, bfloat16 on the tensor cores where dx_plan says so;
the C entries refuse a launch choice other than ``bwd_launch``'s and a dx
plan other than ``dx_plan``'s), the pool forward's vector and one-channel
instantiations with templated and runtime windows, its 64-bit offsets
past 2**31 elements and NaN and signed zeros at slot 0 (bitwise, NaN
payloads included), the flash attention forward, dq and dk/dv kernels
(the JAX suite's bars scaled to the largest magnitude, and the forward's
out within a relative L2 error, each kernel twice bit for bit, at ragged,
odd-head-dim and streamed-regime shapes, every head dim of the bfloat16
tensor-core routes, and unaligned operands, which take the CUDA-core
route; the gradients also within a relative L2 error; the C entries refuse
a plan other than ``fwd_plan``'s and ``bwd_plan``'s), the
autograd Functions launching them, the fused optimizer update in its 8
variants over leaves of every alignment, in one launch for 115 leaves and
two past the table's 512 (atol 1e-6 / rtol 1e-5, a False guard bitwise
untouched, twice bit for bit), the trainer's ``apply_update`` through its
packed table against the CPU over three steps, and the photometric pass
at 1 to 4 channels, aligned and not (float32 1e-6, bfloat16 one ulp,
twice bit for bit), and at QT-Opt's training images over 12 draws, where
a bfloat16 output past one ulp must be one whose float32 value cancels to
below 2**-13 and lie within one ulp plus 1e-6. The file imports
neither JAX nor the JAX package, and the repository's
``tests/conftest.py`` does, so on a machine with a card run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py
"""

import copy

import pytest
import torch

from tensor2robot_tpu_torch.ops import (_build, conv_s2d, fused_update,
                                        photometric, pool)
from tensor2robot_tpu_torch.ops import flash_attention as fa

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
    # 35,340 pixels: a ragged last 64-pixel tile, and more tiles than dW
    # has runs, so runs of 2 tiles with a ragged last run of 1.
    ('ragged_runs', (4, 186, 190, 3), (6, 6, 3, 64), (2, 2), 'SAME'),
    # float32 dW: 3 tiles a row, the last of 31 pixels, and 837 tiles in
    # runs of 2 with a ragged last run of 1.
    ('ragged_runs_f32', (3, 186, 190, 3), (6, 6, 3, 64), (2, 2), 'SAME'),
    # Cout not a multiple of 8 and an odd Cin*W: bf16 dW stages both the
    # cotangent and the patch element by element.
    ('cout5', (2, 13, 11, 3), (4, 4, 3, 5), (2, 2), 'SAME'),
    # The deepest patch the kernels take: K = 8*8*8 = 512, 32 k16 steps of
    # the tensor-core forward, Cout 24 (16-byte stores, a partial n8 set).
    ('k512', (1, 19, 21, 8), (8, 8, 8, 24), (2, 2), 'SAME'),
    # The tensor-core dx's other packings: one phase (stride 1) in one n8
    # tile; 9 phases two to an n8 tile, in 2 passes of 4 n8 tiles; 9
    # phases one to an n8 tile, in 3 passes.
    ('dx_stride1', (1, 17, 19, 2), (3, 3, 2, 16), (1, 1), 'SAME'),
    ('dx_stride3_cin3', (1, 40, 38, 3), (7, 7, 3, 32), (3, 3), 'SAME'),
    ('dx_stride3_cin8', (2, 31, 29, 8), (5, 5, 8, 16), (3, 3), 'SAME'),
]
DTYPES = [torch.float32, torch.bfloat16]
FLASH_CASES = [  # name, [B, T, H, D]
    ('long_horizon_heads', (2, 128, 2, 8)),
    ('sequential', (2, 80, 1, 64)),
    ('d32', (1, 256, 2, 32)),
    ('ragged_d128', (1, 200, 1, 128)),
    ('d24', (1, 96, 3, 24)),
    # The tensor-core routes in bfloat16, every instantiation (D = 16 to 128
    # in steps of 16; d32 above) and a ragged last q and K/V tile.
    ('ragged_1000', (2, 1000, 4, 64)),
    ('d16', (2, 256, 4, 16)),
    ('d48', (1, 512, 3, 48)),
    ('d128', (1, 512, 2, 128)),
    ('ragged_d80', (1, 328, 2, 80)),
    ('d96', (1, 384, 2, 96)),
    ('ragged_d112', (2, 136, 1, 112)),
]


@pytest.fixture(name='device')
def _device():
  """The card, with TF32 off for the test and both flags restored after
  it."""
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card: the kernels build and run only there')
  saved = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  try:
    yield torch.device('cuda')
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


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


def _same_bits(a, b):
  """Bitwise equality, NaN payloads included."""
  as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
  return a.dtype == b.dtype and torch.equal(a.view(as_int[a.dtype]),
                                            b.view(as_int[b.dtype]))


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('name,shape,window,strides,offset', [
    ('pool1_vector', (2, 236, 236, 64), (3, 3), (3, 3), 0),
    ('pool3_vector', (3, 27, 27, 16), (2, 2), (2, 2), 0),
    ('generic_vector', (2, 23, 23, 8), (3, 2), (2, 1), 0),
    ('pool1_unaligned', (2, 236, 236, 64), (3, 3), (3, 3), 1),
    ('pool3_c3', (3, 27, 27, 3), (2, 2), (2, 2), 0),
    ('generic_c5', (2, 23, 23, 5), (3, 2), (2, 1), 0),
], ids=str)
def test_pool_fwd_both_instantiations_bitwise(device, name, shape, window,
                                              strides, offset, dtype):
  """The vector (8 channels a thread) and scalar instantiations, with a
  templated and a runtime window, bitwise against the plain version; a
  storage offset that breaks 16-byte alignment takes the scalar one."""
  x = _tied(shape, dtype, device)
  if offset:
    buffer = torch.empty(x.numel() + offset, dtype=dtype, device=device)
    buffer[offset:].copy_(x.flatten())
    x = buffer[offset:].view(shape)
  pads = pool.resolve_padding('SAME', window, strides, shape[1:3])
  launch = pool.fwd_launch(shape, window, strides, pads,
                           aligned=x.data_ptr() % 16 == 0)
  assert launch['vec'] == (8 if 'vector' in name else 1)
  assert launch['templated'] == (not name.startswith('generic'))
  got = pool.pool_fwd(x, window, strides, pads)
  want = pool.plain_max_pool_argmax(x, window, strides, pads)
  torch.cuda.synchronize()
  assert _same_bits(got[0], want[0])
  assert torch.equal(got[1], want[1])


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
def test_pool_fwd_nan_and_signed_zeros_at_slot_0(device, dtype):
  """A NaN at slot 0 sticks; -0.0 at slot 0 beats +0.0 later and +0.0 at
  slot 0 beats -0.0 later (no max instruction decides), slot 0 each, in
  both instantiations."""
  for channels in (16, 3):
    x = torch.full((2, 6, 6, channels), -1.0, dtype=dtype, device=device)
    x[0, 0, 0] = float('nan')
    x[0, 0, 1] = 5.0
    x[0, 0, 2] = -0.0
    x[0, 1, 3] = 0.0
    x[1, 0, 0] = 0.0
    x[1, 1, 1] = -0.0
    got = pool.pool_fwd(x, (2, 2), (2, 2), ((0, 0), (0, 0)))
    want = pool.plain_max_pool_argmax(x, (2, 2), (2, 2), ((0, 0), (0, 0)))
    torch.cuda.synchronize()
    assert _same_bits(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(got[0][0, 0, 0].isnan().all())
    assert bool(torch.signbit(got[0][0, 0, 1]).all())
    assert not bool(torch.signbit(got[0][1, 0, 0]).any())
    assert int(got[1][:, 0, :2].abs().max()) == 0


def test_pool_fwd_past_2_31_elements(device):
  """[1, 8200, 8200, 32] bf16 (2.15e9 elements, 4.3 GB) takes the 64-bit
  instantiation and stays bitwise."""
  shape, window = (1, 8200, 8200, 32), (3, 3)
  generator = torch.Generator(device=device).manual_seed(3)
  x = torch.randn(shape, generator=generator, device=device,
                  dtype=torch.bfloat16)
  pads = pool.resolve_padding('SAME', window, window, shape[1:3])
  assert pool.fwd_launch(shape, window, window, pads)['wide'] == 1
  got = pool.pool_fwd(x, window, window, pads)
  want = pool.plain_max_pool_argmax(x, window, window, pads)
  torch.cuda.synchronize()
  assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('name,xshape,wshape,strides,padding', CONV_CASES,
                         ids=[case[0] for case in CONV_CASES])
def test_conv_kernel_band_vs_plain(device, name, xshape, wshape, strides,
                                   padding, dtype):
  """float32: 1e-5, the JAX kernel's bar; bfloat16: one bfloat16 ulp
  (2**-7 relative), where the two float32 sums round to neighbours. Each
  call runs twice, bit for bit; bfloat16 runs the tensor-core kernel,
  float32 the CUDA-core one."""
  del name
  generator = torch.Generator().manual_seed(1)
  x = torch.randn(xshape, generator=generator).to(device=device, dtype=dtype)
  w = (0.1 * torch.randn(wshape, generator=generator)).to(device=device,
                                                          dtype=dtype)
  pads = conv_s2d.resolve_padding(padding, wshape[:2], strides, xshape[1:3])
  before = (conv_s2d.conv_s2d_fwd.launches,
            conv_s2d.conv_s2d_fwd.tensor_core_launches)
  got = conv_s2d.conv_s2d_fwd(x, w, strides, pads)
  again = conv_s2d.conv_s2d_fwd(x, w, strides, pads)
  want = conv_s2d.plain_conv2d(x, w, strides, pads)
  torch.cuda.synchronize()
  assert (conv_s2d.conv_s2d_fwd.launches,
          conv_s2d.conv_s2d_fwd.tensor_core_launches) == (
              before[0] + 2, before[1] + (2 if dtype == torch.bfloat16 else 0))
  assert torch.equal(got, again)
  assert got.dtype == dtype and got.shape == want.shape
  band = 1e-5 if dtype == torch.float32 else 2.0**-7
  torch.testing.assert_close(got.float(), want.float(), rtol=band,
                             atol=band if dtype == torch.float32 else 1e-6)


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('name,shape,window,strides,padding', POOL_CASES,
                         ids=[case[0] for case in POOL_CASES])
def test_pool_bwd_kernel_bitwise_vs_plain(device, name, shape, window,
                                          strides, padding, dtype):
  """Bit for bit, with NaN, -0.0 and infinite cotangents planted: the
  scatter route where windows do not overlap (the VALID case with tails no
  window covers), the gather route where they do."""
  del name
  x = _tied(shape, dtype, device)
  pads = pool.resolve_padding(padding, window, strides, shape[1:3])
  _, slot = pool.pool_fwd(x, window, strides, pads)
  g = _tied(tuple(slot.shape), dtype, device, seed=3)
  g.view(-1)[::13] = float('nan')
  g.view(-1)[5::17] = -0.0
  g.view(-1)[7::19] = float('-inf')
  before = (pool.pool_bwd.launches, pool.pool_bwd.scatter_launches)
  got = pool.pool_bwd(g, slot, shape, window, strides, pads)
  want = pool.plain_max_pool_bwd(g, slot, shape, window, strides, pads)
  torch.cuda.synchronize()
  scatter = pool.bwd_launch(shape, window, strides, pads)['route'] == (
      pool.ROUTE_SCATTER)
  assert scatter == (tuple(window) == tuple(strides))
  assert (pool.pool_bwd.launches, pool.pool_bwd.scatter_launches) == (
      before[0] + 1, before[1] + scatter)
  assert got.dtype == dtype and tuple(got.shape) == shape
  assert _same_bits(got, want)


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('name,shape,window,offset', [
    ('pool1_vector', (2, 236, 236, 64), (3, 3), 0),
    ('pool3_vector', (3, 27, 27, 16), (2, 2), 0),
    ('runtime_vector', (2, 23, 23, 8), (3, 2), 0),
    ('pool1_unaligned', (2, 236, 236, 64), (3, 3), 1),
    ('pool3_c3', (3, 27, 27, 3), (2, 2), 0),
    ('runtime_c5', (2, 23, 23, 5), (3, 2), 0),
], ids=str)
def test_pool_bwd_scatter_instantiations_bitwise(device, name, shape, window,
                                                 offset, dtype):
  """The scatter route's vector and scalar instantiations, with a
  templated and a runtime window, bit for bit; a storage offset of the
  cotangent that breaks 16-byte alignment takes the scalar one."""
  x = _tied(shape, dtype, device)
  pads = pool.resolve_padding('SAME', window, window, shape[1:3])
  _, slot = pool.pool_fwd(x, window, window, pads)
  g = _tied(tuple(slot.shape), dtype, device, seed=4)
  g.view(-1)[::11] = -0.0
  if offset:
    buffer = torch.empty(g.numel() + offset, dtype=dtype, device=device)
    buffer[offset:].copy_(g.flatten())
    g = buffer[offset:].view(g.shape)
  launch = pool.bwd_launch(shape, window, window, pads,
                           aligned=g.data_ptr() % 16 == 0)
  assert launch['route'] == pool.ROUTE_SCATTER
  assert launch['vec'] == (8 if 'vector' in name else 1)
  assert launch['templated'] == (not name.startswith('runtime'))
  got = pool.pool_bwd(g, slot, shape, window, window, pads)
  want = pool.plain_max_pool_bwd(g, slot, shape, window, window, pads)
  torch.cuda.synchronize()
  assert _same_bits(got, want)


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('name,shape,window,strides,pads,offset', [
    ('stem_vector', (2, 236, 236, 64), (3, 3), (2, 2), ((1, 1), (1, 1)), 0),
    ('stem_ragged_vector', (3, 27, 37, 64), (3, 3), (2, 2), 'SAME', 0),
    ('stem_unaligned', (2, 41, 43, 64), (3, 3), (2, 2), 'SAME', 1),
    ('stem_c3', (2, 41, 43, 3), (3, 3), (2, 2), 'SAME', 0),
    ('runtime_vector', (2, 23, 29, 16), (3, 2), (1, 2), 'SAME', 0),
    ('runtime_c5', (2, 23, 29, 5), (5, 4), (2, 3), 'SAME', 0),
    ('runtime_c200', (2, 40, 40, 200), (5, 4), (2, 3), 'SAME', 0),
], ids=str)
def test_pool_bwd_gather_instantiations_bitwise(device, name, shape, window,
                                                strides, pads, offset,
                                                dtype):
  """The gather route's vector and scalar instantiations, with the
  templated 3x3/s2 window and runtime windows (tiles ragged in rows and
  columns, more channels than one span), bit for bit with NaN, -0.0 and
  infinite cotangents; a storage offset of the cotangent that breaks
  16-byte alignment takes the scalar one."""
  x = _tied(shape, dtype, device)
  pads = pool.resolve_padding(pads, window, strides, shape[1:3])
  _, slot = pool.pool_fwd(x, window, strides, pads)
  g = _tied(tuple(slot.shape), dtype, device, seed=6)
  g.view(-1)[::13] = float('nan')
  g.view(-1)[5::17] = -0.0
  g.view(-1)[7::19] = float('inf')
  if offset:
    buffer = torch.empty(g.numel() + offset, dtype=dtype, device=device)
    buffer[offset:].copy_(g.flatten())
    g = buffer[offset:].view(g.shape)
  launch = pool.bwd_launch(shape, window, strides, pads,
                           aligned=g.data_ptr() % 16 == 0, dtype=dtype)
  assert launch['route'] == pool.ROUTE_GATHER
  assert launch['vec'] == (8 if 'vector' in name or 'c200' in name else 1)
  assert launch['templated'] == name.startswith('stem')
  got = pool.pool_bwd(g, slot, shape, window, strides, pads)
  again = pool.pool_bwd(g, slot, shape, window, strides, pads)
  want = pool.plain_max_pool_bwd(g, slot, shape, window, strides, pads)
  torch.cuda.synchronize()
  assert _same_bits(got, want) and _same_bits(again, want)


def test_pool_bwd_past_2_31_elements(device):
  """dx of [1, 8200, 8200, 32] bf16 (2.15e9 elements) takes the scatter
  route's 64-bit instantiation and stays bit for bit."""
  shape, window = (1, 8200, 8200, 32), (3, 3)
  pads = pool.resolve_padding('SAME', window, window, shape[1:3])
  assert pool.bwd_launch(shape, window, window, pads)['wide'] == 1
  generator = torch.Generator(device=device).manual_seed(5)
  plan = pool._plan(shape, window, window, pads, torch.bfloat16)  # pylint: disable=protected-access
  out_shape = (1, plan['oh'], plan['ow'], 32)
  g = torch.randn(out_shape, generator=generator, device=device,
                  dtype=torch.bfloat16)
  slot = torch.randint(0, 9, out_shape, generator=generator, device=device,
                       dtype=torch.int32)
  got = pool.pool_bwd(g, slot, shape, window, window, pads)
  want = pool.plain_max_pool_bwd(g, slot, shape, window, window, pads)
  torch.cuda.synchronize()
  assert _same_bits(got, want)


def test_pool_bwd_entry_refuses_another_choice(device):
  """t2r_pool_bwd launches only the choice bwd_launch makes: another
  route, channels a thread or template returns cudaErrorInvalidValue and
  writes nothing."""
  lib = _build.load('pool', pool._SIGNATURES)  # pylint: disable=protected-access
  stream = torch.cuda.current_stream(device).cuda_stream
  for shape, window, strides in (((2, 24, 24, 8), (3, 3), (3, 3)),
                                 ((2, 23, 23, 8), (3, 3), (2, 2))):
    pads = pool.resolve_padding('SAME', window, strides, shape[1:3])
    x = _tied(shape, torch.float32, device)
    _, slot = pool.pool_fwd(x, window, strides, pads)
    g = _tied(tuple(slot.shape), torch.float32, device, seed=2)
    dx = torch.full(shape, 7.0, device=device)
    launch = pool.bwd_launch(shape, window, strides, pads)
    choice = (int(launch['route'] == pool.ROUTE_SCATTER), launch['vec'],
              launch['wide'], launch['templated'])
    p = pool._plan(shape, window, strides, pads, torch.float32)  # pylint: disable=protected-access
    for bad in ((1 - choice[0],) + choice[1:],
                (choice[0], 9 - choice[1]) + choice[2:],
                choice[:3] + (1 - choice[3],)):
      status = lib.t2r_pool_bwd(
          g.data_ptr(), slot.data_ptr(), dx.data_ptr(), 0, *shape, *window,
          *strides, pads[0][0], pads[1][0], p['oh'], p['ow'], *bad, stream)
      assert status == 1, (shape, bad, status)  # cudaErrorInvalidValue
    torch.cuda.synchronize()
    assert bool((dx == 7.0).all())


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('name,xshape,wshape,strides,padding', CONV_CASES,
                         ids=[case[0] for case in CONV_CASES])
def test_conv_grad_kernels_band_vs_plain(device, name, xshape, wshape,
                                         strides, padding, dtype):
  """dW and dx in the forward's bands, relative to each gradient's largest
  magnitude; dW twice, bit for bit. bfloat16 dW runs the tensor-core
  kernel, float32 dW the CUDA-core one."""
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
  tensor_core = (conv_s2d.conv_s2d_dw.tensor_core_launches,
                 conv_s2d.conv_s2d_dx.tensor_core_launches)
  dw = conv_s2d.conv_s2d_dw(x, g, wshape, strides, pads)
  dw_again = conv_s2d.conv_s2d_dw(x, g, wshape, strides, pads)
  dx = conv_s2d.conv_s2d_dx(g, w, xshape, strides, pads)
  dx_again = conv_s2d.conv_s2d_dx(g, w, xshape, strides, pads)
  want_dw = conv_s2d.plain_conv2d_dw(x, g, wshape, strides, pads)
  want_dx = conv_s2d.plain_conv2d_dx(g, w, xshape, strides, pads)
  torch.cuda.synchronize()
  assert (conv_s2d.conv_s2d_dw.launches,
          conv_s2d.conv_s2d_dx.launches) == (before[0] + 2, before[1] + 2)
  dx_route = conv_s2d.dx_plan(xshape, wshape, strides, pads, dtype)['route']
  assert (dx_route == conv_s2d.ROUTE_TENSOR_CORE) == (
      dtype == torch.bfloat16 and wshape[3] % 16 == 0)
  assert (conv_s2d.conv_s2d_dw.tensor_core_launches,
          conv_s2d.conv_s2d_dx.tensor_core_launches) == (
              tensor_core[0] + (2 if dtype == torch.bfloat16 else 0),
              tensor_core[1] + (
                  2 if dx_route == conv_s2d.ROUTE_TENSOR_CORE else 0))
  assert torch.equal(dw, dw_again)
  assert torch.equal(dx, dx_again)
  band = 1e-5 if dtype == torch.float32 else 2.0**-7
  for got, want in ((dw, want_dw), (dx, want_dx)):
    assert got.dtype == dtype and got.shape == want.shape
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float() / scale, want.float() / scale,
                               rtol=band, atol=band)


def test_conv_dx_entries_refuse_another_plan(device):
  """t2r_conv_s2d_dx_mma launches only dx_plan's plan (another tile
  count, grid or shared memory returns cudaErrorInvalidValue), and
  t2r_conv_s2d_dx refuses a bfloat16 problem the tensor cores take; dx is
  left unwritten."""
  lib = _build.load('conv_s2d', conv_s2d._SIGNATURES)  # pylint: disable=protected-access
  stream = torch.cuda.current_stream(device).cuda_stream
  xshape, wshape, strides = (2, 48, 48, 3), (6, 6, 3, 64), (2, 2)
  pads = conv_s2d.resolve_padding('SAME', wshape[:2], strides, xshape[1:3])
  g = _tied((2, 24, 24, 64), torch.bfloat16, device)
  w = _tied(wshape, torch.bfloat16, device)
  dx = torch.full(xshape, 7.0, dtype=torch.bfloat16, device=device)
  plan = conv_s2d.dx_plan(xshape, wshape, strides, pads, torch.bfloat16)
  assert plan['route'] == conv_s2d.ROUTE_TENSOR_CORE
  geometry = (*xshape, 6, 6, *strides, pads[0][0], pads[1][0], 24, 24, 64)
  good = (plan['num_tiles'], plan['grid'], plan['smem'])
  for i, delta in ((0, 1), (1, -1), (2, 16)):
    bad = list(good)
    bad[i] += delta
    status = lib.t2r_conv_s2d_dx_mma(g.data_ptr(), w.data_ptr(),
                                     dx.data_ptr(), *geometry, *bad, stream)
    assert status == 1, (i, bad, status)  # cudaErrorInvalidValue
  # The CUDA-core route's own plan for the problem, which is the same for
  # both dtypes: refused all the same in bfloat16.
  ffma = conv_s2d.dx_plan(xshape, wshape, strides, pads, torch.float32)
  status = lib.t2r_conv_s2d_dx(
      g.data_ptr(), w.data_ptr(), dx.data_ptr(), 1, *geometry,
      ffma['tile_rows'], ffma['lanes'], ffma['chunk'],
      int(ffma['templated']), ffma['grid'], ffma['smem'], stream)
  assert status == 1, status
  torch.cuda.synchronize()
  assert bool((dx == 7.0).all())


def test_conv_ffma_entries_refuse_another_plan(device):
  """t2r_conv_s2d_fwd and t2r_conv_s2d_dx launch only fwd_plan's and
  dx_plan's CUDA-core plans: any other pixel groups, templated flag, grid
  or shared memory (forward), tile rows, lanes, chunk, templated flag,
  grid or shared memory (dx) returns cudaErrorInvalidValue and leaves the
  output unwritten; the planners' own plans launch."""
  lib = _build.load('conv_s2d', conv_s2d._SIGNATURES)  # pylint: disable=protected-access
  stream = torch.cuda.current_stream(device).cuda_stream
  xshape, wshape, strides = (2, 48, 48, 3), (6, 6, 3, 64), (2, 2)
  pads = conv_s2d.resolve_padding('SAME', wshape[:2], strides, xshape[1:3])
  x = _tied(xshape, torch.float32, device)
  w = _tied(wshape, torch.float32, device)
  g = _tied((2, 24, 24, 64), torch.float32, device)
  geometry = (*xshape, 6, 6, *strides, pads[0][0], pads[1][0], 24, 24, 64)
  fwd = conv_s2d.fwd_plan(xshape, wshape, strides, pads, torch.float32)
  dxp = conv_s2d.dx_plan(xshape, wshape, strides, pads, torch.float32)
  out = torch.full((2, 24, 24, 64), 7.0, device=device)
  dx = torch.full(xshape, 7.0, device=device)
  good = (fwd['groups'], int(fwd['templated']), fwd['grid'], fwd['smem'])
  for i, delta in ((0, -8), (1, -1), (2, -1), (3, 16)):
    bad = list(good)
    bad[i] += delta
    status = lib.t2r_conv_s2d_fwd(x.data_ptr(), w.data_ptr(),
                                  out.data_ptr(), *geometry, *bad, stream)
    assert status == 1, (i, bad, status)  # cudaErrorInvalidValue
  good = (dxp['tile_rows'], dxp['lanes'], dxp['chunk'],
          int(dxp['templated']), dxp['grid'], dxp['smem'])
  for i, delta in ((0, -1), (1, -1), (2, 4), (3, -1), (4, -1), (5, 16)):
    bad = list(good)
    bad[i] += delta
    status = lib.t2r_conv_s2d_dx(g.data_ptr(), w.data_ptr(), dx.data_ptr(),
                                 0, *geometry, *bad, stream)
    assert status == 1, (i, bad, status)
  torch.cuda.synchronize()
  assert bool((out == 7.0).all()) and bool((dx == 7.0).all())
  assert lib.t2r_conv_s2d_fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                              *geometry, fwd['groups'], 1, fwd['grid'],
                              fwd['smem'], stream) == 0
  assert lib.t2r_conv_s2d_dx(g.data_ptr(), w.data_ptr(), dx.data_ptr(), 0,
                             *geometry, *good, stream) == 0
  torch.cuda.synchronize()
  torch.testing.assert_close(out, conv_s2d.plain_conv2d(x, w, strides, pads),
                             rtol=1e-5, atol=1e-5)


def test_conv_dw_ffma_entry_refuses_another_plan(device):
  """t2r_conv_s2d_dw launches only dw_plan's float32 plan: another run
  length, run count, tile pixels, templated flag or shared memory returns
  cudaErrorInvalidValue and leaves dW unwritten; the planner's own plan
  launches, within 1e-5 of the plain version."""
  lib = _build.load('conv_s2d', conv_s2d._SIGNATURES)  # pylint: disable=protected-access
  stream = torch.cuda.current_stream(device).cuda_stream
  xshape, wshape, strides = (2, 48, 70, 3), (6, 6, 3, 64), (2, 2)
  pads = conv_s2d.resolve_padding('SAME', wshape[:2], strides, xshape[1:3])
  x = _tied(xshape, torch.float32, device)
  g = _tied((2, 24, 35, 64), torch.float32, device)
  plan = conv_s2d.dw_plan(xshape, wshape, strides, pads, torch.float32)
  partial = torch.empty((plan['chunks'], 108, 64), device=device)
  dw = torch.full(wshape, 7.0, device=device)
  geometry = (*xshape, 6, 6, *strides, pads[0][0], pads[1][0], 24, 35, 64)
  good = (plan['tiles_per_chunk'], plan['chunks'], plan['tile_pixels'],
          int(plan['templated']), plan['smem'])
  for i, delta in ((0, 1), (1, -1), (2, -16), (3, -1), (4, 16)):
    bad = list(good)
    bad[i] += delta
    status = lib.t2r_conv_s2d_dw(x.data_ptr(), g.data_ptr(),
                                 partial.data_ptr(), dw.data_ptr(),
                                 *geometry, *bad, stream)
    assert status == 1, (i, bad, status)  # cudaErrorInvalidValue
  torch.cuda.synchronize()
  assert bool((dw == 7.0).all())
  assert lib.t2r_conv_s2d_dw(x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                             dw.data_ptr(), *geometry, *good, stream) == 0
  torch.cuda.synchronize()
  want = conv_s2d.plain_conv2d_dw(x, g, wshape, strides, pads)
  scale = float(want.abs().max())
  torch.testing.assert_close(dw / scale, want / scale, rtol=1e-5, atol=1e-5)


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


def _qkv(shape, dtype, device, seed):
  generator = torch.Generator().manual_seed(seed)
  return tuple(torch.randn(shape, generator=generator).to(device=device,
                                                          dtype=dtype)
               for _ in range(4))


def _plain_blocks(shape, dtype):
  """The plain versions' default blocks where ``_check`` takes them, else
  (T not a multiple of them) the largest multiple of 8 up to 256 that
  divides T."""
  t, d = shape[1], shape[3]
  if fa.is_supported(t, d, itemsize=dtype.itemsize):
    return None, None
  block = max(b for b in range(8, 257, 8) if t % b == 0)
  return block, block


# The forward's out and the gradients, relative L2 error: chip_smoke.py's
# FLASH_OUT_REL_L2 and FLASH_GRAD_REL_L2 (a fault that moves the rows deep
# in T, whose magnitude is far below the largest, by their own size passes
# the scaled bar).
FLASH_OUT_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
FLASH_GRAD_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


def _assert_flash_band(got, want, dtype, grad):
  """The JAX suite's bars (float32: out 2e-5, gradients 5e-4; bfloat16:
  3e-2), scaled to the largest magnitude when it exceeds 1; out also
  within FLASH_OUT_REL_L2, a gradient within FLASH_GRAD_REL_L2."""
  band = (5e-4 if grad else 2e-5) if dtype == torch.float32 else 3e-2
  want = want.float()
  scale = max(1.0, float(want.abs().max()))
  err = float((got.float() - want).abs().max())
  assert err <= band * scale, (err, band, scale)
  limit = (FLASH_GRAD_REL_L2 if grad else FLASH_OUT_REL_L2)[dtype]
  rel = float((got.float() - want).norm() / want.norm())
  assert rel <= limit, (rel, limit)


@pytest.mark.parametrize('streamed', [False, True], ids=['staged', 'streamed'])
@pytest.mark.parametrize('causal', [False, True], ids=['full', 'causal'])
@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('name,shape', FLASH_CASES,
                         ids=[case[0] for case in FLASH_CASES])
def test_flash_kernels_band_vs_plain(device, monkeypatch, name, shape, dtype,
                                     causal, streamed):
  """Forward (out and lse), dq and dk/dv against the plain versions; the
  streamed cases resolve the plain versions' blocks as the JAX package's
  streamed kernels do (the kernels tile the same way in both regimes), and
  a T that the default blocks do not divide takes blocks that do. Each
  kernel run twice agrees bit for bit."""
  del name
  if streamed:
    monkeypatch.setattr(fa, '_MAX_STAGED_KV_BYTES', 1)
  blocks = _plain_blocks(shape, dtype)
  q, k, v, do = _qkv(shape, dtype, device, seed=shape[1])
  before = (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches)
  out, lse = fa.flash_fwd(q, k, v, causal)
  out2, lse2 = fa.flash_fwd(q, k, v, causal)
  want_out, want_lse = fa.plain_flash_fwd(q, k, v, causal, *blocks)
  delta = fa.flash_delta(want_out, do)
  dq = fa.flash_dq(q, k, v, do, want_lse, delta, causal)
  dq2 = fa.flash_dq(q, k, v, do, want_lse, delta, causal)
  dk, dv = fa.flash_dkv(q, k, v, do, want_lse, delta, causal)
  dk2, dv2 = fa.flash_dkv(q, k, v, do, want_lse, delta, causal)
  want_dq = fa.plain_flash_dq(q, k, v, do, want_lse, delta, causal, *blocks)
  want_dk, want_dv = fa.plain_flash_dkv(q, k, v, do, want_lse, delta, causal,
                                        *blocks)
  torch.cuda.synchronize()
  assert (fa.flash_fwd.launches, fa.flash_dq.launches,
          fa.flash_dkv.launches) == (before[0] + 2, before[1] + 2,
                                     before[2] + 2)
  for a, b in ((out, out2), (lse, lse2), (dq, dq2), (dk, dk2), (dv, dv2)):
    assert torch.equal(a, b)
  assert out.dtype == dtype and lse.dtype == torch.float32
  assert lse.shape == (shape[0] * shape[2], 1, shape[1])
  _assert_flash_band(out, want_out, dtype, grad=False)
  scale = max(1.0, float(want_lse.abs().max()))
  assert float((lse - want_lse).abs().max()) <= 2e-5 * scale
  for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
    assert got.dtype == dtype and got.shape == want.shape
    _assert_flash_band(got, want, dtype, grad=True)


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
def test_flash_fwd_unaligned_operands_take_the_cuda_core_route(device, dtype):
  """q, k and v one element past a 16-byte boundary: the plan and the C
  entry both take the CUDA-core route with element loads, held to the
  plain version in the same band and bit for bit over two runs."""
  shape = (2, 96, 3, 64)
  n = 2 * 96 * 3 * 64
  q, k, v = (torch.randn(n + 1, generator=torch.Generator().manual_seed(s))
             .to(device=device, dtype=dtype)[1:].view(shape)
             for s in range(3))
  assert q.data_ptr() % 16 != 0
  plan = fa.fwd_plan(shape, dtype, True, aligned=False)
  assert plan['route'] == fa.ROUTE_CUDA_CORES
  out, lse = fa.flash_fwd(q, k, v, True)
  out2, lse2 = fa.flash_fwd(q, k, v, True)
  want_out, want_lse = fa.plain_flash_fwd(q, k, v, True)
  torch.cuda.synchronize()
  assert torch.equal(out, out2) and torch.equal(lse, lse2)
  _assert_flash_band(out, want_out, dtype, grad=False)
  scale = max(1.0, float(want_lse.abs().max()))
  assert float((lse - want_lse).abs().max()) <= 2e-5 * scale


def test_flash_fwd_entry_refuses_another_plan(device):
  """t2r_flash_fwd launches only the plan fwd_plan makes: the other route,
  or other q-tile rows, return cudaErrorInvalidValue and write nothing."""
  lib = _build.load('flash_attention', fa._SIGNATURES)  # pylint: disable=protected-access
  shape = (1, 256, 2, 64)
  stream = torch.cuda.current_stream(device).cuda_stream
  for dtype in DTYPES:
    q, k, v = _qkv(shape, dtype, device, seed=3)[:3]
    out = torch.full_like(q, 7.0)
    lse = torch.full((2, 1, 256), 7.0, device=device)
    plan = fa.fwd_plan(shape, dtype, True)
    route = fa._ROUTE_CODES[plan['route']]  # pylint: disable=protected-access
    for bad in ((1 - route, plan['rows']),
                (route, 16 if plan['rows'] != 16 else 32)):
      status = lib.t2r_flash_fwd(
          *(x.data_ptr() for x in (q, k, v, out, lse)),
          fa._DTYPE_CODES[dtype], *shape, 1, fa._scale(64), *bad, stream)  # pylint: disable=protected-access
      assert status == 1, (dtype, bad, status)  # cudaErrorInvalidValue
    torch.cuda.synchronize()
    assert bool((out == 7.0).all()) and bool((lse == 7.0).all())


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
def test_flash_bwd_unaligned_operands_take_the_cuda_core_route(device, dtype):
  """q, k, v and dO one element past a 16-byte boundary: dq and dk/dv take
  the CUDA-core route with element loads (bfloat16 at D = 64 included,
  which aligned takes the tensor cores), held to the plain versions in the
  same band and bit for bit over two runs."""
  shape = (2, 96, 3, 64)
  n = 2 * 96 * 3 * 64
  q, k, v, do = (torch.randn(n + 1,
                             generator=torch.Generator().manual_seed(s))
                 .to(device=device, dtype=dtype)[1:].view(shape)
                 for s in range(4))
  assert q.data_ptr() % 16 != 0
  for kernel in fa.BWD_KERNELS:
    plan = fa.bwd_plan(kernel, shape, dtype, True, aligned=False)
    assert plan['route'] == fa.ROUTE_CUDA_CORES
  want_out, lse = fa.plain_flash_fwd(q, k, v, True)
  delta = fa.flash_delta(want_out, do)
  got = (fa.flash_dq(q, k, v, do, lse, delta, True),
         *fa.flash_dkv(q, k, v, do, lse, delta, True))
  again = (fa.flash_dq(q, k, v, do, lse, delta, True),
           *fa.flash_dkv(q, k, v, do, lse, delta, True))
  want = (fa.plain_flash_dq(q, k, v, do, lse, delta, True),
          *fa.plain_flash_dkv(q, k, v, do, lse, delta, True))
  torch.cuda.synchronize()
  for g, a, w in zip(got, again, want):
    assert torch.equal(g, a)
    _assert_flash_band(g, w, dtype, grad=True)


def test_flash_bwd_entries_refuse_another_plan(device):
  """t2r_flash_dq and t2r_flash_dkv launch only the plan bwd_plan makes:
  the other route, or other tile rows, return cudaErrorInvalidValue and
  write nothing."""
  lib = _build.load('flash_attention_bwd', fa._BWD_SIGNATURES)  # pylint: disable=protected-access
  shape = (1, 256, 2, 64)
  stream = torch.cuda.current_stream(device).cuda_stream
  for dtype in DTYPES:
    q, k, v, do = _qkv(shape, dtype, device, seed=4)
    stats = [torch.zeros((2, 1, 256), device=device) for _ in range(2)]
    for kernel in fa.BWD_KERNELS:
      outs = [torch.full_like(q, 7.0)
              for _ in range(1 if kernel == 'dq' else 2)]
      plan = fa.bwd_plan(kernel, shape, dtype, True)
      route = fa._ROUTE_CODES[plan['route']]  # pylint: disable=protected-access
      for bad in ((1 - route, plan['rows']),
                  (route, 16 if plan['rows'] != 16 else 32)):
        status = getattr(lib, f't2r_flash_{kernel}')(
            *(x.data_ptr() for x in [q, k, v, do] + stats + outs),
            fa._DTYPE_CODES[dtype], *shape, 1, fa._scale(64), *bad, stream)  # pylint: disable=protected-access
        assert status == 1, (kernel, dtype, bad, status)  # InvalidValue
      torch.cuda.synchronize()
      assert all(bool((x == 7.0).all()) for x in outs)


def test_flash_autograd_launches_the_three_kernels(device):
  q, k, v, do = _qkv((2, 128, 2, 16), torch.float32, device, seed=7)
  q, k, v = (x.requires_grad_() for x in (q, k, v))
  before = (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches)
  out = fa.flash_attention(q, k, v, causal=True)
  out.backward(do)
  torch.cuda.synchronize()
  assert (fa.flash_fwd.launches, fa.flash_dq.launches,
          fa.flash_dkv.launches) == (before[0] + 1, before[1] + 1,
                                     before[2] + 1)
  for x in (q, k, v):
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


def test_flash_wrappers_refuse_what_the_kernels_do_not_take(device):
  q, k, v, do = _qkv((1, 64, 2, 16), torch.float32, device, seed=8)
  with pytest.raises(ValueError, match='contiguous'):
    fa.flash_fwd(q.transpose(1, 2), k, v)
  with pytest.raises(ValueError, match='float32 or bfloat16'):
    fa.flash_fwd(q.half(), k.half(), v.half())
  with pytest.raises(ValueError, match='must match'):
    fa.flash_fwd(q, k.bfloat16(), v)
  with pytest.raises(ValueError, match='CUDA'):
    fa.flash_fwd(q.cpu(), k.cpu(), v.cpu())
  _, lse = fa.flash_fwd(q, k, v)
  delta = fa.flash_delta(q, do)
  with pytest.raises(ValueError, match='statistics'):
    fa.flash_dq(q, k, v, do, lse[:, :, :32].contiguous(), delta)
  with pytest.raises(ValueError, match='head dim'):
    shape = (1, 64, 1, 136)
    fa.flash_fwd(*(torch.zeros(shape, device=device) for _ in range(3)))


# ------------------------------------------------------------ fused update

# Leaf shapes: one element, ragged tails, a conv weight, one leaf past a
# block, and 70 leaves in all (one launch of the pointer table).
UPDATE_SHAPES = ([(1,), (3,), (127,), (129,), (64, 3, 6, 6), (5000,)] +
                 [(17, 5)] * 64)


def _update_leaves(kind, with_ema, device, seed, offset=0,
                   shapes=UPDATE_SHAPES):
  """Seeded leaves; ``offset`` > 0 cuts each tensor out of a larger buffer
  at that element offset, so its pointer is not 16-byte aligned."""
  generator = torch.Generator().manual_seed(seed)

  def make(shape, positive=False):
    n = 1
    for size in shape:
      n *= size
    flat = torch.randn(n + offset, generator=generator)
    flat = flat.abs() * 1e-3 if positive else flat
    return flat.to(device)[offset:].view(shape)

  leaves = []
  for shape in shapes:
    adam = kind == 'adam'
    leaves.append(fused_update.Leaf(
        make(shape), make(shape), make(shape) if adam else None,
        make(shape, positive=True) if adam else None,
        make(shape) if with_ema else None))
  return leaves


def _clone_leaves(leaves, offset=0):
  """Copies that keep each tensor ``offset`` elements into its buffer."""

  def copy(t):
    if t is None:
      return None
    buffer = torch.empty(t.numel() + offset, device=t.device)
    out = buffer[offset:].view(t.shape)
    out.copy_(t)
    return out

  return [fused_update.Leaf(*(copy(t) for t in leaf)) for leaf in leaves]


UPDATE_ARGS = dict(lr=3e-3, c1=0.52, c2=0.0069, b1=0.9, b2=0.999, eps=1e-8)


@pytest.mark.parametrize('offset', [0, 1], ids=['aligned', 'unaligned'])
@pytest.mark.parametrize('guard', [False, True], ids=['noguard', 'guard'])
@pytest.mark.parametrize('with_ema', [False, True], ids=['noema', 'ema'])
@pytest.mark.parametrize('kind', ['adam', 'sgd'])
def test_fused_update_band_vs_plain(device, kind, with_ema, guard, offset):
  leaves = _update_leaves(kind, with_ema, device, seed=1, offset=offset)
  decay = 0.9 if with_ema else None
  ok = torch.tensor([True], device=device) if guard else None
  got, again, want = (_clone_leaves(leaves, offset) for _ in range(3))
  before = fused_update.fused_update.launches
  fused_update.fused_update(got, kind, decay=decay, ok=ok, **UPDATE_ARGS)
  fused_update.fused_update(again, kind, decay=decay, ok=ok, **UPDATE_ARGS)
  fused_update.plain_fused_update(want, kind, decay=decay, ok=ok,
                                  **UPDATE_ARGS)
  torch.cuda.synchronize()
  assert fused_update.fused_update.launches == before + 2  # 70 leaves: 1 each
  for a, b, w in zip(got, again, want):
    for x, y, z in zip(a, b, w):
      if x is None:
        continue
      assert torch.equal(x, y)
      torch.testing.assert_close(x, z, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize('kind', ['adam', 'sgd'])
def test_fused_update_false_guard_is_bitwise_untouched(device, kind):
  leaves = _update_leaves(kind, True, device, seed=2)
  got = _clone_leaves(leaves)
  fused_update.fused_update(got, kind, decay=0.9,
                            ok=torch.tensor([False], device=device),
                            **UPDATE_ARGS)
  torch.cuda.synchronize()
  for a, b in zip(got, leaves):
    for x, y in zip(a, b):
      assert x is None or torch.equal(x, y)


@pytest.mark.parametrize('leaves,launches', [(115, 1), (600, 2)])
def test_fused_update_launches_per_table(device, leaves, launches):
  """115 leaves (SNAIL long-horizon's count) take one launch; past
  LEAVES_PER_LAUNCH the table is cut into launches; both in the band."""
  shapes = [(64, 3, 6, 6), (129,)] + [(17, 5)] * (leaves - 2)
  start = _update_leaves('adam', True, device, seed=4, shapes=shapes)
  got, want = _clone_leaves(start), _clone_leaves(start)
  before = fused_update.fused_update.launches
  fused_update.fused_update(got, 'adam', decay=0.9, **UPDATE_ARGS)
  fused_update.plain_fused_update(want, 'adam', decay=0.9, **UPDATE_ARGS)
  torch.cuda.synchronize()
  assert fused_update.fused_update.launches == before + launches
  for a, w in zip(got, want):
    for x, z in zip(a, w):
      torch.testing.assert_close(x, z, atol=1e-6, rtol=1e-5)


def test_apply_update_through_the_packed_table(device):
  """The trainer's entry on the card: three Adam steps with the EMA under
  one validation (new gradients each step, one launch a step) against the
  same steps on the CPU's plain version; then moment tensors replaced as
  load_state_dict replaces them are validated and packed anew."""
  from tensor2robot_tpu_torch.models import optimizers

  generator = torch.Generator().manual_seed(5)
  shapes = [(64, 3, 6, 6), (129,), (1,)] + [(17, 5)] * 112
  values = [torch.randn(shape, generator=generator) for shape in shapes]
  grads = [[torch.randn(shape, generator=generator) for shape in shapes]
           for _ in range(3)]
  runs = []
  for where in ('cpu', device):
    params = [torch.nn.Parameter(v.to(where, copy=True)) for v in values]
    optimizer = optimizers.create_adam_optimizer(3e-3)(params)
    ema = {p: p.detach().clone() for p in params}
    plan = fused_update.plan_for(optimizer, ema_decay=0.9)
    before = fused_update.fused_update.launches
    kept = set()
    for step in grads:
      for p, g in zip(params, step):
        p.grad = g.to(where)
      assert fused_update.apply_update(plan, optimizer, dict(ema))
      kept.add(id(plan.prepared[0]))
    launches = fused_update.fused_update.launches - before
    runs.append((params, optimizer, ema, launches))
    if where != 'cpu':
      assert len(kept) == 1  # validated at the first step only
      prepared, operands = fused_update.prepare(plan, optimizer, ema)
      table = prepared.pack(operands)
      optimizer.load_state_dict(copy.deepcopy(optimizer.state_dict()))
      again, operands = fused_update.prepare(plan, optimizer, ema)
      assert again is not prepared
      repacked = again.pack(operands)
      assert repacked[0, 2] == optimizer.state[params[0]]['mu'].data_ptr()
      assert repacked[0, 2] != table[0, 2]
  (cpu, cpu_opt, cpu_ema, _), (card, card_opt, card_ema, launches) = runs
  assert launches == 3
  torch.cuda.synchronize()
  for a, b in zip(card, cpu):
    torch.testing.assert_close(a.detach().cpu(), b.detach(), atol=1e-6,
                               rtol=1e-5)
    torch.testing.assert_close(card_opt.state[a]['mu'].cpu(),
                               cpu_opt.state[b]['mu'], atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(card_ema[a].cpu(), cpu_ema[b], atol=1e-6,
                               rtol=1e-5)


def test_fused_update_refuses_mismatched_layouts(device):
  p = torch.zeros(8, 4, device=device)
  leaf = fused_update.Leaf(p, torch.zeros(4, 8, device=device).t())
  with pytest.raises(ValueError, match='strides'):
    fused_update.fused_update([leaf], 'sgd', decay=None, **UPDATE_ARGS)
  leaf = fused_update.Leaf(p, torch.zeros(8, 4, device=device).double())
  with pytest.raises(ValueError, match='float32'):
    fused_update.fused_update([leaf], 'sgd', decay=None, **UPDATE_ARGS)


# --------------------------------------------------------------- photometric

PHOTOMETRIC_CASES = [(2, 37, 29, 3), (3, 64, 48, 1), (2, 31, 17, 2),
                     (1, 100, 90, 4), (2, 5, 7, 3)]


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('shape', PHOTOMETRIC_CASES, ids=str)
def test_photometric_band_vs_plain(device, shape, dtype):
  generator = torch.Generator().manual_seed(shape[1])
  images = torch.rand(shape, generator=generator).to(device=device,
                                                     dtype=dtype)
  delta = (torch.rand(shape[0], generator=generator) - 0.5).to(device)
  factor = (torch.rand(shape[0], generator=generator) + 0.5).to(device)
  before = photometric.photometric.launches
  got = photometric.photometric(images, delta, factor)
  again = photometric.photometric(images, delta, factor)
  want = photometric.plain_brightness_contrast(images, delta, factor)
  torch.cuda.synchronize()
  assert photometric.photometric.launches == before + 2
  assert got.dtype == dtype and got.shape == shape
  assert torch.equal(got, again)
  err = (got.float() - want.float()).abs()
  if dtype == torch.float32:
    assert float(err.max()) <= 1e-6
  else:
    # One bfloat16 ulp at each value: 2**(e - 8) for want = m * 2**e.
    ulp = torch.ldexp(torch.ones_like(err), torch.frexp(want.float())[1] - 8)
    assert bool((err <= ulp).all())


def test_photometric_bf16_outside_one_ulp_only_where_float32_cancels(device):
  """At QT-Opt's training images, over 12 draws: every bfloat16 output
  meets chip_smoke.photometric_bf16_check's bars (the rounding of the
  float32 pass, bit for bit; that pass within the band derived from its
  float32 roundings and the means' difference; one bfloat16 ulp wherever
  that band is under half an ulp). Further than one ulp lie only outputs
  below 2**-13, where (x - mean) * factor + mean cancels and a bfloat16
  ulp is under the float32 roundings of the terms."""
  import chip_smoke  # pylint: disable=import-outside-toplevel
  shape = (32, 472, 472, 3)
  for seed in range(12):
    generator = torch.Generator(device=device).manual_seed(seed)
    images = torch.rand(shape, generator=generator, device=device).to(
        torch.bfloat16)
    delta = (torch.rand(32, generator=generator, device=device) - 0.5) * 0.25
    factor = torch.rand(32, generator=generator, device=device) + 0.5
    got = photometric.photometric(images, delta, factor)
    _, past, largest = chip_smoke.photometric_bf16_check(got, images, delta,
                                                         factor)
    assert past == 0 or largest < 2.0**-13, (seed, past, largest)


def test_photometric_fused_branch_launches_the_kernel(device):
  from tensor2robot_tpu_torch.preprocessors import image_transformations
  images = torch.rand((4, 40, 30, 3), device=device)
  before = photometric.photometric.launches
  out = image_transformations.apply_photometric_image_distortions(
      images, torch.Generator().manual_seed(0), random_brightness=True,
      random_contrast=True, use_fused_kernel=True)
  torch.cuda.synchronize()
  assert photometric.photometric.launches == before + 1
  stock = image_transformations.apply_photometric_image_distortions(
      images, torch.Generator().manual_seed(0), random_brightness=True,
      random_contrast=True)
  assert float((out - stock).abs().max()) <= 1e-6
