"""conv1's input-gradient planner and its two routes, on the CPU.

``conv_s2d.dx_plan`` decides, from the shapes, the dtype and the
operands' alignment, which kernel computes dx (``csrc/conv_s2d.cu``): the
tensor-core phase GEMM (``conv_dx_mma_kernel``: bfloat16, Cout % 16 == 0,
aligned, at most 16 phases, a block that fits shared memory) or the CUDA
cores (``conv_dx_ffma_kernel``: float32, and bfloat16 elsewhere), and for
each its tiles, halo, phase packing or columns, passes, grid and shared
memory. The C entries refuse any other plan, so these tests hold the
mirror to the source's constants and to the choices at conv1's training
shape and at the routes' edges, and that ``conv_s2d_dx`` calls the entry
of its route with the plan.

The kernel runs only on the card. ``emulate_dx_mma`` repeats its work tile
by tile from the plan: the staged cotangent rows with their halo
(zero outside g), the weights packed into n8 tiles (``phases_per_n8``
phases of ``cin_pad`` columns), each tap's shifted rows times its weights
in float32, the fragments' columns mapped back to (phase, input channel)
and the pixels to image positions, the dx rows held in shared memory at
their global alignment and copied out in head, 16-byte and tail units. It
must write every dx element exactly once and agree with
``plain_conv2d_dx`` and with the JAX package's ``_conv_dx_kernel``
(interpreted on the CPU) within 1e-5 of the largest magnitude, at strides
1, 2, 3 and (3, 2), odd sizes, explicit and VALID pads, Cin 1 to 8.

``emulate_dx_ffma`` does the same for the CUDA-core kernel: the per-pass
tables of weight offsets and columns ((phase, input channel) pairs of the
phases with taps, 12 a pass), each step's stage (the tile's cotangent rows
plus halo for ``chunk`` output channels, a pixel's channels contiguous as
in g, 16 bytes of padding after every 128, copied as the kernel's threads
do: 16 bytes a copy where g allows, else a channel a copy; and the pass's
weights as [tap][channel][column]; zero outside g and past the window,
NaN where nothing is copied), each lane's 4 phase columns read 4 channels
at a time in the kernel's order (chunk, quad, alpha, delta, channel), the
pass's columns gathered into the tile's dx in shared memory (phases
without a tap zeroed in the last pass) and copied out a row at a time.
"""

import contextlib
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.ops import _pallas_dispatch
from tensor2robot_tpu.ops import conv_s2d as jax_conv
from tensor2robot_tpu_torch.ops import _build, conv_s2d

CONV1_X, CONV1_W = (32, 472, 472, 3), (6, 6, 3, 64)


def _pads(xshape, wshape, strides, padding='SAME'):
  return conv_s2d.resolve_padding(padding, wshape[:2], strides, xshape[1:3])


def _constants():
  """{name: value} of the ``constexpr int`` constants of
  ``csrc/conv_s2d.cu``, each expression evaluated over those before it."""
  source = (_build.CSRC_DIR / 'conv_s2d.cu').read_text()
  values = {}
  for key, expr in re.findall(r'constexpr int (\w+) = ([^;]+);', source):
    values[key] = eval(expr, {}, dict(values))  # pylint: disable=eval-used
  return values


def test_mirror_holds_the_kernel_constants():
  c = _constants()
  # pylint: disable=protected-access
  assert (c['kDxRows'], c['kDxCols'], c['kDxStages']) == (
      conv_s2d._DX_ROWS, conv_s2d._DX_COLS, conv_s2d._DX_STAGES)
  assert c['kDxBlocksPerSm'] == conv_s2d._DX_BLOCKS_PER_SM
  assert c['kDxMaxPhases'] == conv_s2d._DX_MAX_PHASES
  assert c['kDxN8'] == conv_s2d._DX_N8 == 2
  assert c['kSms'] == conv_s2d._SMS
  assert c['kSmSharedBytes'] == conv_s2d._SM_SHARED_BYTES
  assert c['kBlockReservedBytes'] == conv_s2d._BLOCK_RESERVED_BYTES
  assert c['kMaxBlockSharedBytes'] == conv_s2d._MAX_SMEM_BYTES
  assert c['kMmaRowPad'] == conv_s2d._MMA_ROW_PAD
  # pylint: enable=protected-access
  # Two m16 tiles (rows w, w + 4) for each of the 4 warps.
  assert c['kDxRows'] == 2 * c['kMmaThreads'] // 32 and c['kDxCols'] == 16


def test_conv1_plan():
  """conv1's training dx: 4 phases of 3 x 3 taps, two phases an n8 tile
  (Cin 3 padded to 4), one pass; 14,400 tiles of 8 x 16 phase pixels over
  396 persistent blocks, three an SM at 76 KB each."""
  pads = _pads(CONV1_X, CONV1_W, (2, 2))
  plan = conv_s2d.dx_plan(CONV1_X, CONV1_W, (2, 2), pads, torch.bfloat16)
  assert plan == dict(
      route='tensor_core', tile_rows=8, tile_cols=16, halo=(2, 2), taps=9,
      phases=4, cin_pad=4, phases_per_n8=2, n8_tiles=2, passes=1,
      m_lo=1, n_lo=1, row_tiles=30, col_tiles=15, num_tiles=14400,
      grid=396, o_stride=104, smem=75968)
  assert 3 * (plan['smem'] + 1024) <= 233472 < 4 * (plan['smem'] + 1024)


@pytest.mark.parametrize(
    'name,xshape,wshape,strides,padding,dtype,aligned,want', [
    ('float32', CONV1_X, CONV1_W, (2, 2), 'SAME', torch.float32, True,
     'cuda_core'),
    ('cout72', (1, 29, 31, 3), (6, 6, 3, 72), (2, 2), 'SAME', torch.bfloat16,
     True, 'cuda_core'),
    ('cout8', (1, 17, 17, 2), (3, 3, 2, 8), (1, 1), 'SAME', torch.bfloat16,
     True, 'cuda_core'),
    ('unaligned', CONV1_X, CONV1_W, (2, 2), 'SAME', torch.bfloat16, False,
     'cuda_core'),
    # 25 phases: past the kernel's 16.
    ('stride5', (1, 40, 40, 3), (5, 5, 3, 16), (5, 5), 'SAME',
     torch.bfloat16, True, 'cuda_core'),
    # 256 taps of [8, 80] weight rows: 295 KB, past a block's shared memory.
    ('smem', (1, 32, 32, 1), (16, 16, 1, 64), (1, 1), 'SAME',
     torch.bfloat16, True, 'cuda_core'),
    # 2**31 tiles or more: the kernel's 32-bit tile index.
    ('wide', (5_000_000, 472, 472, 3), CONV1_W, (2, 2), 'SAME',
     torch.bfloat16, True, 'cuda_core'),
    ('stride1_cout16', (1, 17, 17, 2), (3, 3, 2, 16), (1, 1), 'SAME',
     torch.bfloat16, True, 'tensor_core'),
    ('stride3_cin8', (1, 20, 20, 8), (7, 7, 8, 16), (3, 3), 'SAME',
     torch.bfloat16, True, 'tensor_core'),
    ('stride4', (1, 33, 33, 1), (4, 4, 1, 32), (4, 4), 'SAME',
     torch.bfloat16, True, 'tensor_core'),
], ids=lambda v: v if isinstance(v, str) else None)
def test_route(name, xshape, wshape, strides, padding, dtype, aligned, want):
  del name
  pads = _pads(xshape, wshape, strides, padding)
  plan = conv_s2d.dx_plan(xshape, wshape, strides, pads, dtype,
                          aligned=aligned)
  assert plan['route'] == want
  if want == 'cuda_core':
    assert plan == conv_s2d._dx_ffma(  # pylint: disable=protected-access
        conv_s2d._plan(xshape, wshape, strides, pads, dtype, dtype),  # pylint: disable=protected-access
        xshape[0])
    assert plan['smem'] <= 233472 // 2 - 1024


@pytest.mark.parametrize('cin,cin_pad,per_n8', [(1, 1, 8), (2, 2, 4),
                                                (3, 4, 2), (4, 4, 2),
                                                (5, 8, 1), (8, 8, 1)])
@pytest.mark.parametrize('strides', [(1, 1), (2, 2), (3, 3), (3, 2), (4, 4)],
                         ids=str)
def test_phase_packing_covers_every_phase_once(cin, cin_pad, per_n8,
                                               strides):
  """The n8 tiles hold every (phase, input channel) column once; the
  passes of two tiles hold every n8 tile."""
  xshape, wshape = (1, 24, 24, cin), (6, 6, cin, 32)
  plan = conv_s2d.dx_plan(xshape, wshape, strides,
                          _pads(xshape, wshape, strides), torch.bfloat16)
  assert plan['route'] == 'tensor_core'
  assert (plan['cin_pad'], plan['phases_per_n8']) == (cin_pad, per_n8)
  phases = strides[0] * strides[1]
  columns = [(nt * per_n8 + n // cin_pad, n % cin_pad)
             for nt in range(plan['passes'] * 2)
             for n in range(8)]
  live = [col for col in columns if col[0] < phases and col[1] < cin]
  assert sorted(live) == [(p, c) for p in range(phases) for c in range(cin)]
  assert plan['n8_tiles'] == -(-phases // per_n8)
  assert (plan['passes'] - 1) * 2 < plan['n8_tiles'] <= plan['passes'] * 2


def test_plan_does_not_ask_the_device(monkeypatch):
  def refuse(*args, **kwargs):
    raise AssertionError('the dx plan asked the device')

  for fn in ('is_available', 'device_count', 'get_device_properties',
             'current_device'):
    monkeypatch.setattr(torch.cuda, fn, refuse)
  pads = _pads(CONV1_X, CONV1_W, (2, 2))
  assert conv_s2d.dx_plan(CONV1_X, CONV1_W, (2, 2), pads,
                          torch.bfloat16)['grid'] == 396


def test_refuses_an_undefined_problem():
  with pytest.raises(ValueError, match='unsupported'):
    conv_s2d.dx_plan((1, 8, 8, 16), (3, 3, 16, 16), (1, 1), ((1, 1), (1, 1)),
                     torch.bfloat16)


def emulate_dx_mma(g, w, xshape, strides, pads, plan):
  """dx as conv_dx_mma_kernel computes it, from its plan, in float32 (see
  the module docstring). Returns dx and how often each element was
  written."""
  _, h, wd, cin = xshape
  kh, kw, _, cout = w.shape
  sh, sw = strides
  (plh, _), (plw, _) = pads
  oh_, ow_ = g.shape[1:3]
  hr, hc = plan['halo']
  rows, cols = plan['tile_rows'], plan['tile_cols']
  cin_pad, per_n8 = plan['cin_pad'], plan['phases_per_n8']
  kn8 = conv_s2d._DX_N8  # pylint: disable=protected-access
  n8_alloc = plan['passes'] * kn8
  phases, o_stride = sh * sw, plan['o_stride']
  assert plan['taps'] == (hr + 1) * (hc + 1)
  # B: [tap][n8 tile][n][co].
  bmat = torch.zeros(plan['taps'], n8_alloc, 8, cout)
  for t in range(plan['taps']):
    alpha, beta = divmod(t, hc + 1)
    for nt in range(n8_alloc):
      for n in range(8):
        phase, ci = nt * per_n8 + n // cin_pad, n % cin_pad
        dy, dxx = phase // sw + alpha * sh, phase % sw + beta * sw
        if phase < phases and ci < cin and dy < kh and dxx < kw:
          bmat[t, nt, n] = w[dy, dxx, ci].float()
  dx = torch.zeros(int(np.prod(xshape)))
  writes = np.zeros(int(np.prod(xshape)), np.int32)
  i_idx = torch.arange(rows).view(rows, 1, 1)
  j_idx = torch.arange(cols).view(1, cols, 1)
  col = torch.arange(kn8 * 8).view(1, 1, -1)
  for tile in range(plan['num_tiles']):
    rest, ct = divmod(tile, plan['col_tiles'])
    b, rt = divmod(rest, plan['row_tiles'])
    m0, n0 = plan['m_lo'] + rt * rows, plan['n_lo'] + ct * cols
    staged = torch.zeros(rows + hr, cols + hc, cout)
    oh = torch.arange(m0 - hr, m0 + rows)
    ow = torch.arange(n0 - hc, n0 + cols)
    vr = (oh >= 0) & (oh < oh_)
    vc = (ow >= 0) & (ow < ow_)
    staged[vr.nonzero()[:, 0, None], vc.nonzero()[:, 0]] = g[
        b, oh[vr][:, None], ow[vc]].float()
    ih0, iw0 = m0 * sh - plh, n0 * sw - plw
    iw_lo = max(iw0, 0)
    o_s = torch.full(((rows * sh) * o_stride,), float('nan'))
    for pass_ in range(plan['passes']):
      acc = torch.zeros(rows, cols, kn8 * 8)
      for t in range(plan['taps']):
        alpha, beta = divmod(t, hc + 1)
        a = staged[hr - alpha:hr - alpha + rows, hc - beta:hc - beta + cols]
        wt = bmat[t, pass_ * kn8:(pass_ + 1) * kn8].reshape(kn8 * 8, cout)
        acc += (a.reshape(-1, cout) @ wt.t()).view(rows, cols, kn8 * 8)
      nt = pass_ * kn8 + col // 8
      phase = nt * per_n8 + (col % 8) // cin_pad
      ci = (col % 8) % cin_pad
      ph, pw = phase // sw, phase % sw
      r = i_idx * sh + ph
      ih = ih0 + r
      iw = (n0 + j_idx) * sw + pw - plw
      live = ((nt < plan['n8_tiles']) & (phase < phases) & (ci < cin) &
              (ih >= 0) & (ih < h) & (iw >= 0) & (iw < wd))
      shift = (((b * h + ih) * wd + iw_lo) * cin) % 8
      index = r * o_stride + shift + (iw - iw_lo) * cin + ci
      assert bool((index[live] < (r.expand(live.shape)[live] + 1) *
                   o_stride).all())
      o_s[index[live]] = acc.expand(live.shape)[live]
    # The copy-out: per dx row of the tile, head, 16-byte units, tail.
    length = (min(iw0 + cols * sw, wd) - iw_lo) * cin
    for r in range(rows * sh):
      ih = ih0 + r
      if not 0 <= ih < h:
        continue
      start = ((b * h + ih) * wd + iw_lo) * cin
      shift = start % 8
      head = min((8 - shift) % 8, length)
      vecs = (length - head) // 8
      if vecs:  # the 16-byte units start 16-byte aligned on both sides
        assert (start + head) % 8 == (r * o_stride + shift + head) % 8 == 0
      assert shift + length <= o_stride
      for k in range(length):
        dx[start + k] = o_s[r * o_stride + shift + k]
        writes[start + k] += 1
  return dx.view(xshape), writes.reshape(xshape)


# Small geometries: conv1's 6x6/s2 and odd sizes, stride 1 and 3, unequal
# strides, explicit and VALID pads, Cin 1, 2, 3, 5 and 8, Cout 16 to 64.
EMULATED = [
    ('conv1', (2, 30, 34, 3), (6, 6, 3, 64), (2, 2), 'SAME'),
    ('conv1_odd', (1, 29, 31, 3), (6, 6, 3, 32), (2, 2), 'SAME'),
    ('stride1', (1, 17, 19, 2), (3, 3, 2, 16), (1, 1), 'SAME'),
    ('stride3', (1, 22, 20, 3), (7, 7, 3, 16), (3, 3), 'SAME'),
    ('stride3x2', (1, 19, 23, 1), (5, 4, 1, 32), (3, 2), 'SAME'),
    ('explicit', (1, 20, 21, 5), (7, 7, 5, 16), (2, 2), ((2, 3), (3, 2))),
    ('valid_cin8', (2, 15, 13, 8), (5, 3, 8, 16), (2, 2), 'VALID'),
    ('stride4', (1, 18, 17, 3), (4, 4, 3, 16), (4, 4), 'SAME'),
]


@pytest.mark.parametrize('name,xshape,wshape,strides,padding', EMULATED,
                         ids=[case[0] for case in EMULATED])
def test_emulation_writes_once_and_matches_plain_and_jax(name, xshape, wshape,
                                                          strides, padding):
  del name
  pads = _pads(xshape, wshape, strides, padding)
  plan = conv_s2d.dx_plan(xshape, wshape, strides, pads, torch.bfloat16)
  assert plan['route'] == 'tensor_core'
  assert plan['grid'] <= plan['num_tiles']
  assert plan['smem'] <= 232448
  rng = np.random.RandomState(sum(xshape) + sum(wshape))
  w = (0.1 * rng.randn(*wshape)).astype(np.float32)
  oh = (xshape[1] + pads[0][0] + pads[0][1] - wshape[0]) // strides[0] + 1
  ow = (xshape[2] + pads[1][0] + pads[1][1] - wshape[1]) // strides[1] + 1
  g = rng.randn(xshape[0], oh, ow, wshape[3]).astype(np.float32)
  got, writes = emulate_dx_mma(torch.from_numpy(g), torch.from_numpy(w),
                               xshape, strides, pads, plan)
  assert (writes == 1).all()
  plain = conv_s2d.plain_conv2d_dx(torch.from_numpy(g), torch.from_numpy(w),
                                   xshape, strides, pads)
  jax_plan = jax_conv._plan(xshape, wshape, strides, pads)  # pylint: disable=protected-access
  with _pallas_dispatch.force_kernels(True):
    want = np.asarray(jax_conv._dx_call(  # pylint: disable=protected-access
        jnp.asarray(g), jnp.asarray(w), jax_plan, jnp.float32))
  for reference in (plain.numpy(), want):
    scale = float(np.abs(reference).max())
    np.testing.assert_allclose(got.numpy() / scale, reference / scale,
                               rtol=0, atol=1e-5)


def test_emulation_in_bfloat16_holds_the_card_band():
  """bfloat16 operands, float32 sums rounded once: within the card's bar
  (2**-7 relative plus 1e-5 of the largest magnitude) of the plain
  version at conv1's geometry."""
  xshape, wshape, strides = (1, 40, 36, 3), (6, 6, 3, 64), (2, 2)
  pads = _pads(xshape, wshape, strides)
  plan = conv_s2d.dx_plan(xshape, wshape, strides, pads, torch.bfloat16)
  gen = torch.Generator().manual_seed(3)
  w = (0.1 * torch.randn(wshape, generator=gen)).bfloat16()
  g = torch.randn((1, 20, 18, 64), generator=gen).bfloat16()
  got, _ = emulate_dx_mma(g, w, xshape, strides, pads, plan)
  want = conv_s2d.plain_conv2d_dx(g, w, xshape, strides, pads).float()
  got = got.bfloat16().float()
  err = (got - want).abs()
  assert bool((err <= 2.0**-7 * want.abs() + 1e-5 * want.abs().max()).all())


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32], ids=str)
def test_wrapper_calls_the_entry_point_of_its_route(monkeypatch, dtype):
  """conv_s2d_dx with the C library, the device checks and the stream
  replaced by stand-ins: the bfloat16 call goes to t2r_conv_s2d_dx_mma
  with the plan's tiles, grid and shared memory, the float32 call to
  t2r_conv_s2d_dx with its tile rows, lanes, chunk, templated flag, grid
  and shared memory, each with as many arguments as its ctypes binding,
  and the counters move."""
  calls = []

  def entry(name):
    def call(*args):
      calls.append((name, args))
      return 0
    return call

  lib = types.SimpleNamespace(**{name: entry(name)
                                 for name in conv_s2d._SIGNATURES})  # pylint: disable=protected-access
  monkeypatch.setattr(_build, 'load', lambda name, signatures: lib)
  monkeypatch.setattr(conv_s2d, '_cuda_operands', lambda *args: None)
  monkeypatch.setattr(torch.cuda, 'device',
                      lambda device: contextlib.nullcontext())
  monkeypatch.setattr(torch.cuda, 'current_stream',
                      lambda device: types.SimpleNamespace(cuda_stream=0))
  xshape, wshape = (4, 186, 190, 3), (6, 6, 3, 64)
  pads = _pads(xshape, wshape, (2, 2))
  g = torch.zeros((4, 93, 95, 64), dtype=dtype)
  w = torch.zeros(wshape, dtype=dtype)
  before = (conv_s2d.conv_s2d_dx.launches,
            conv_s2d.conv_s2d_dx.tensor_core_launches)
  dx = conv_s2d.conv_s2d_dx(g, w, xshape, (2, 2), pads)
  assert dx.shape == xshape and dx.dtype == dtype
  (name, args), = calls
  assert len(args) == len(conv_s2d._SIGNATURES[name])  # pylint: disable=protected-access
  aligned = g.data_ptr() % 16 == 0 and dx.data_ptr() % 16 == 0
  plan = conv_s2d.dx_plan(xshape, wshape, (2, 2), pads, dtype,
                          aligned=aligned)
  tensor_core = plan['route'] == 'tensor_core'
  assert tensor_core == (dtype == torch.bfloat16 and aligned)
  if tensor_core:
    assert name == 't2r_conv_s2d_dx_mma'
    assert args[3:16] == (4, 186, 190, 3, 6, 6, 2, 2, 2, 2, 93, 95, 64)
    assert args[-4:-1] == (plan['num_tiles'], plan['grid'], plan['smem'])
  else:
    assert name == 't2r_conv_s2d_dx'
    assert args[4:17] == (4, 186, 190, 3, 6, 6, 2, 2, 2, 2, 93, 95, 64)
    assert args[-7:-1] == (plan['tile_rows'], plan['lanes'], plan['chunk'],
                           int(plan['templated']), plan['grid'], plan['smem'])
  assert (conv_s2d.conv_s2d_dx.launches,
          conv_s2d.conv_s2d_dx.tensor_core_launches) == (
              before[0] + 1, before[1] + tensor_core)


def test_ffma_mirror_holds_the_kernel_constants():
  """The CUDA-core planner's numbers are conv_dx_ffma_kernel's: 4 phase
  columns a lane, 12 columns a pass, a phase row a warp up to 8, up to 8
  output channels a step, two stages, two blocks an SM within half an
  SM's shared memory; conv1's instantiation <3, 3, 4>, the generic
  <0, 0, 0>."""
  c = _constants()
  # pylint: disable=protected-access
  assert c['kDxfPix'] == conv_s2d._DXF_PIX == 4
  assert c['kDxfCols'] == conv_s2d._DXF_COLS == 12
  assert c['kDxfMaxWarps'] == conv_s2d._DXF_MAX_WARPS
  assert c['kDxfMaxChunk'] == conv_s2d._DXF_MAX_CHUNK == 8
  assert c['kDxfStages'] == conv_s2d._DXF_STAGES
  assert c['kDxfBlocksPerSm'] == conv_s2d._DXF_BLOCKS_PER_SM
  assert conv_s2d._DXF_SMEM_BUDGET == (
      c['kSmSharedBytes'] // c['kDxfBlocksPerSm'] - c['kBlockReservedBytes'])
  # pylint: enable=protected-access
  source = (_build.CSRC_DIR / 'conv_s2d.cu').read_text()
  assert ('kSmSharedBytes / kDxfBlocksPerSm - kBlockReservedBytes;'
          in source)
  assert ('p.templated = p.halo_r == 2 && p.halo_c == 2 && p.chunk == 4;'
          in source)
  assert 'launch_dx_ffma_as<T, 3, 3, 4>' in source
  assert 'launch_dx_ffma_as<T, 0, 0, 0>' in source


def test_ffma_conv1_plan():
  """conv1's float32 training dx: 2 x 2 live phases of 3 x 3 taps, their
  12 (phase, input channel) columns in one pass; tiles of 8 phase rows x
  128 phase columns, 4 output channels a step (16 steps a tile); two
  stages of 6,312 floats, the tile's 16 x 256 x 3 dx and the tables in
  100,224 bytes, two blocks an SM over 264 persistent blocks."""
  pads = _pads(CONV1_X, CONV1_W, (2, 2))
  plan = conv_s2d.dx_plan(CONV1_X, CONV1_W, (2, 2), pads, torch.float32)
  assert plan == dict(
      route='cuda_core', halo=(2, 2), taps=9, templated=True,
      live_phases=(2, 2), passes=1, tile_rows=8, lanes=32, chunk=4, cpad=4,
      chunks=16, slen=130, gls=588, g_floats=5880, stage_floats=6312,
      out_cols=256, m_lo=1, n_lo=1, row_tiles=30, col_tiles=2,
      num_tiles=1920, grid=264, smem=100224)
  # 130 pixels x 4 channels, 16 bytes after every 128; 10 staged rows and
  # the 9 taps' weights a stage.
  assert plan['gls'] == 130 * 4 + 4 * 17
  assert plan['smem'] == 4 * (2 * (10 * 588 + 9 * 4 * 12) + 16 * 256 * 3) + (
      4 * 12 * (9 + 3))
  assert 2 * (plan['smem'] + 1024) <= 233472


FFMA_SHAPES = [
    ('conv1', (2,) + CONV1_X[1:], CONV1_W, (2, 2), 'SAME'),
    ('odd', (4, 101, 97, 2), (5, 5, 2, 48), (3, 3), 'SAME'),
    ('stride1_cin1', (1, 17, 300, 1), (3, 3, 1, 8), (1, 1), 'SAME'),
    ('cin8_stride3', (2, 31, 29, 8), (5, 5, 8, 16), (3, 3), 'SAME'),
    ('cout5', (2, 13, 11, 3), (4, 4, 3, 5), (2, 2), 'SAME'),
    # A stride past the window: the phases without taps are zero.
    ('stride_past', (1, 23, 26, 2), (2, 3, 2, 16), (4, 5), 'VALID'),
    # A 16 x 16 window at stride 1: the halo and the 256 taps' weights
    # make the planner take fewer lanes, rows or channels a step.
    ('smem', (1, 32, 32, 1), (16, 16, 1, 64), (1, 1), 'SAME'),
]


@pytest.mark.parametrize('name,xshape,wshape,strides,padding', FFMA_SHAPES,
                         ids=[case[0] for case in FFMA_SHAPES])
def test_ffma_tiles_and_columns_cover_dx_once(name, xshape, wshape, strides,
                                              padding):
  """Every input pixel is one (phase, phase pixel) of one tile's live
  lane; the passes hold every live (phase, input channel) column once;
  the chunks every output channel; the block fits half an SM."""
  del name
  pads = _pads(xshape, wshape, strides, padding)
  plan = conv_s2d.dx_plan(xshape, wshape, strides, pads, torch.float32)
  _, h, w, cin = xshape
  kh, kw, _, cout = wshape
  sh, sw = strides
  (plh, _), (plw, _) = pads
  assert plan['route'] == 'cuda_core'
  assert plan['smem'] <= 233472 // 2 - 1024
  assert plan['grid'] <= plan['num_tiles']
  assert plan['live_phases'] == (min(sh, kh), min(sw, kw))
  live = [(ph, pw, ci) for ph in range(min(sh, kh))
          for pw in range(min(sw, kw)) for ci in range(cin)]
  columns = []
  for pass_ in range(plan['passes']):
    for c in range(12):
      phase, ci = divmod(pass_ * 12 + c, cin)
      if phase < len(live) // cin:
        columns.append((*divmod(phase, min(sw, kw)), ci))
  assert sorted(columns) == live
  assert (plan['chunks'] - 1) * plan['chunk'] < cout <= (
      plan['chunks'] * plan['chunk'])
  rest, ct = np.divmod(np.arange(plan['num_tiles']), plan['col_tiles'])
  b, rt = np.divmod(rest, plan['row_tiles'])
  m = (plan['m_lo'] + rt * plan['tile_rows'])[:, None, None, None] + (
      np.arange(plan['tile_rows'])[None, :, None, None])
  n = (plan['n_lo'] + ct * 4 * plan['lanes'])[:, None, None, None] + (
      np.arange(4 * plan['lanes'])[None, None, :, None])
  covered = np.zeros((xshape[0], h, w), np.int32)
  for ph in range(sh):
    for pw in range(sw):
      ih = np.broadcast_to(m * sh + ph - plh, np.broadcast(m, n).shape)
      iw = np.broadcast_to(n * sw + pw - plw, ih.shape)
      bb = np.broadcast_to(b[:, None, None, None], ih.shape)
      inside = (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
      np.add.at(covered, (bb[inside], ih[inside], iw[inside]), 1)
  assert (covered == 1).all()


def _padded(f):
  """Where float f of a staged cotangent row lies: 16 bytes of padding
  after every 128."""
  return f + 4 * (f // 32)


def emulate_dx_ffma(g, w, xshape, strides, pads, plan, vec_g=False):
  """dx as conv_dx_ffma_kernel computes it, from its plan, in float32 (see
  the module docstring); ``vec_g``: the 16-byte copies. Returns dx and how
  often each element was written."""
  b_, h, wd, cin = xshape
  kh, kw, _, cout = w.shape
  sh, sw = strides
  (plh, _), (plw, _) = pads
  oh_n, ow_n = g.shape[1:3]
  hr, hc = plan['halo']
  taps_c = hc + 1
  taps = (hr + 1) * taps_c
  lh, lw = plan['live_phases']
  passes, chunk, cpad = plan['passes'], plan['chunk'], plan['cpad']
  tr, lanes, slen, gls = (plan['tile_rows'], plan['lanes'], plan['slen'],
                          plan['gls'])
  out_cols = plan['out_cols']
  assert slen == 4 * lanes + hc and out_cols == 4 * lanes * sw
  assert cpad == max(chunk, 4) and gls % 4 == 0
  assert gls >= _padded(slen * cpad - 1) + 1
  assert plan['g_floats'] == (tr + hr) * gls
  assert plan['stage_floats'] == plan['g_floats'] + taps * chunk * 12
  wflat = w.reshape(-1).float()
  g = g.float()
  wtab = np.full((passes, taps, 12), -1, np.int64)
  ctab = np.zeros((passes, 12, 3), np.int64)
  for pass_ in range(passes):
    for c in range(12):
      phase, ci = divmod(pass_ * 12 + c, cin)
      ph, pw = divmod(phase, lw)
      ctab[pass_, c] = (ph, pw, ci if phase < lh * lw else -1)
      for tap in range(taps):
        alpha, beta = divmod(tap, taps_c)
        dy, dxx = ph + alpha * sh, pw + beta * sw
        if phase < lh * lw and dy < kh and dxx < kw:
          wtab[pass_, tap, c] = ((dy * kw + dxx) * cin + ci) * cout
  dx = torch.full(xshape, float('nan'))
  writes = np.zeros(xshape, np.int32)
  nthreads = 32 * tr
  width = 4 if vec_g else 1
  per = chunk // width
  rows_i = np.arange(tr)
  lane_i = np.arange(lanes)
  for tile in range(plan['num_tiles']):
    rest, ct = divmod(tile, plan['col_tiles'])
    b, rt = divmod(rest, plan['row_tiles'])
    m0 = plan['m_lo'] + rt * tr
    n0 = plan['n_lo'] + ct * 4 * lanes
    o_s = torch.full((tr * sh, out_cols, cin), float('nan'))
    for pass_ in range(passes):
      acc = torch.zeros(tr, lanes, 4, 12)
      for step in range(plan['chunks']):
        co0 = step * chunk
        stage = torch.full((plan['stage_floats'],), float('nan'))
        # Thread t copies unit t % per (width channels) of every
        # (nthreads / per)-th staged pixel from t // per.
        t = np.arange(nthreads)
        pix = (t // per)[:, None] + (nthreads // per) * np.arange(
            -(-(tr + hr) * slen // (nthreads // per)))
        own = ((t % per) * width)[:, None] + 0 * pix
        copied = pix < (tr + hr) * slen
        pix, own = pix[copied], own[copied]
        assert len(set(zip(pix.tolist(), own.tolist()))) == len(pix) == (
            (tr + hr) * slen * per)
        r, c = np.divmod(pix, slen)
        oh, ow = m0 - hr + r, n0 - hc + c
        ok = (oh >= 0) & (oh < oh_n) & (ow >= 0) & (ow < ow_n) & (
            co0 + own < cout)
        if vec_g:  # the 16 bytes lie wholly inside g's channels
          assert (co0 + own[ok] + 3 < cout).all()
        for e in range(width):
          vals = torch.zeros(len(pix))
          vals[torch.from_numpy(ok)] = g[b, oh[ok], ow[ok], co0 + own[ok] + e]
          stage[torch.from_numpy(r * gls + _padded(c * cpad + own + e))] = (
              vals)
        e = np.arange(taps * chunk * 12)
        col, rest_e = e % 12, e // 12
        cc_e, tap_e = rest_e % chunk, rest_e // chunk
        off = wtab[pass_, tap_e, col]
        ok = (off >= 0) & (co0 + cc_e < cout)
        vals = torch.zeros(len(e))
        vals[torch.from_numpy(ok)] = wflat[off[ok] + co0 + cc_e[ok]]
        stage[plan['g_floats'] + torch.from_numpy(e)] = vals
        gs, ws = stage[:plan['g_floats']], stage[plan['g_floats']:]
        for quad in range((chunk + 3) // 4):
          for alpha in range(hr + 1):
            row = (rows_i[:, None, None] + hr - alpha) * gls
            for d in range(taps_c):
              pixel = 4 * lane_i[None, :, None] + np.arange(4) + d
              for c in range(min(4, chunk - 4 * quad)):
                xv = gs[torch.from_numpy(
                    row + _padded(pixel * cpad + 4 * quad + c))]
                wp = ((alpha * taps_c + hc - d) * chunk + 4 * quad + c) * 12
                acc += xv[..., None] * ws[wp:wp + 12]
      for c in range(12):
        ph, pw, ci = ctab[pass_, c]
        if ci >= 0:
          for i in range(4):
            o_s[rows_i[:, None] * sh + ph,
                (4 * lane_i[None, :] + i) * sw + pw, ci] = acc[..., i, c]
    if sh > kh or sw > kw:
      for ph in range(sh):
        for pw in range(sw):
          if ph >= kh or pw >= kw:
            for i in range(4):
              o_s[rows_i[:, None] * sh + ph,
                  (4 * lane_i[None, :] + i) * sw + pw, :] = 0.0
    ih0, iw0 = m0 * sh - plh, n0 * sw - plw
    lo, hi = max(iw0, 0), min(iw0 + out_cols, wd)
    for r in range(tr * sh):
      if 0 <= ih0 + r < h and hi > lo:
        dx[b, ih0 + r, lo:hi] = o_s[r, lo - iw0:hi - iw0]
        writes[b, ih0 + r, lo:hi] += 1
  return dx, writes


# conv1 narrowed and its odd geometry, partial last tiles, explicit pads,
# Cin 1, 5 and 8, Cout 5, two passes, a stride past the window.
FFMA_EMULATED = [
    ('conv1', (2, 40, 36, 3), (6, 6, 3, 64), (2, 2), 'SAME', True),
    ('conv1_per_channel', (1, 14, 18, 3), (6, 6, 3, 64), (2, 2), 'SAME',
     False),
    ('conv1_ragged', (1, 6, 278, 3), (6, 6, 3, 16), (2, 2), 'SAME', True),
    ('odd', (1, 31, 29, 2), (5, 5, 2, 48), (3, 3), 'SAME', True),
    ('explicit_cin5', (1, 12, 13, 5), (7, 7, 5, 16), (2, 2),
     ((2, 3), (3, 2)), False),
    ('valid_cin8', (2, 15, 13, 8), (5, 3, 8, 16), (2, 2), 'VALID', True),
    ('stride1_cout5', (1, 17, 19, 1), (3, 3, 1, 5), (1, 1), 'SAME', False),
    ('stride_past', (1, 23, 26, 2), (2, 3, 2, 16), (4, 5), 'VALID', True),
]


@pytest.mark.parametrize('name,xshape,wshape,strides,padding,vec',
                         FFMA_EMULATED,
                         ids=[case[0] for case in FFMA_EMULATED])
def test_ffma_emulation_writes_once_and_matches_plain_and_jax(
    name, xshape, wshape, strides, padding, vec):
  del name
  pads = _pads(xshape, wshape, strides, padding)
  plan = conv_s2d.dx_plan(xshape, wshape, strides, pads, torch.float32)
  assert plan['route'] == 'cuda_core'
  rng = np.random.RandomState(sum(xshape) + sum(wshape))
  w = (0.1 * rng.randn(*wshape)).astype(np.float32)
  oh = (xshape[1] + pads[0][0] + pads[0][1] - wshape[0]) // strides[0] + 1
  ow = (xshape[2] + pads[1][0] + pads[1][1] - wshape[1]) // strides[1] + 1
  g = rng.randn(xshape[0], oh, ow, wshape[3]).astype(np.float32)
  got, writes = emulate_dx_ffma(torch.from_numpy(g), torch.from_numpy(w),
                                xshape, strides, pads, plan, vec)
  assert (writes == 1).all()
  references = [conv_s2d.plain_conv2d_dx(
      torch.from_numpy(g), torch.from_numpy(w), xshape, strides,
      pads).numpy()]
  # The JAX kernel takes Cout % 8 == 0 only.
  jax_plan = jax_conv._plan(xshape, wshape, strides, pads)  # pylint: disable=protected-access
  assert (jax_plan is None) == (wshape[3] % 8 != 0)
  if jax_plan is not None:
    with _pallas_dispatch.force_kernels(True):
      references.append(np.asarray(jax_conv._dx_call(  # pylint: disable=protected-access
          jnp.asarray(g), jnp.asarray(w), jax_plan, jnp.float32)))
  for reference in references:
    scale = float(np.abs(reference).max())
    np.testing.assert_allclose(got.numpy() / scale, reference / scale,
                               rtol=0, atol=1e-5)


def test_ffma_emulation_in_bfloat16_holds_the_card_band():
  """bfloat16 on the CUDA-core route (Cout 40, not a multiple of 16):
  bfloat16 operands, float32 sums rounded once, within the card's bar of
  the plain version."""
  xshape, wshape, strides = (1, 30, 26, 3), (6, 6, 3, 40), (2, 2)
  pads = _pads(xshape, wshape, strides)
  plan = conv_s2d.dx_plan(xshape, wshape, strides, pads, torch.bfloat16)
  assert plan['route'] == 'cuda_core' and plan['chunk'] == 8
  gen = torch.Generator().manual_seed(5)
  w = (0.1 * torch.randn(wshape, generator=gen)).bfloat16()
  g = torch.randn((1, 15, 13, 40), generator=gen).bfloat16()
  got, writes = emulate_dx_ffma(g, w, xshape, strides, pads, plan)
  assert (writes == 1).all()
  want = conv_s2d.plain_conv2d_dx(g, w, xshape, strides, pads).float()
  err = (got.bfloat16().float() - want).abs()
  assert bool((err <= 2.0**-7 * want.abs() + 1e-5 * want.abs().max()).all())
