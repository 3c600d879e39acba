"""conv1's forward planner and route, on the CPU.

``conv_s2d.fwd_plan`` decides, from the shapes and the dtype alone, how the
forward kernels run a problem: which kernel (bfloat16 on the tensor cores,
float32 on the CUDA cores), a block's shared memory and, on the tensor-core
route, the runs of 64-pixel tiles that the blocks own, the padded taps and
the 64-channel tiles; on the CUDA-core route (``conv_fwd_ffma_kernel``)
its tiles of output rows x 8-pixel groups, its stage rows, whether conv1's
templated instantiation runs and its persistent grid. The kernels run only
on the card; these tests hold what the host decides for them, at conv1's
serving and training shapes and at every shape of the card tests, that
the mirror holds the source's constants, and that ``conv_s2d_fwd`` calls
the C entry point of its route with the plan and its binding's argument
count.

``emulate_fwd_ffma`` repeats the float32 kernel's work tile by tile from
its plan: the channel tile's weights, each window row's stage rows (x's
span as it lies in memory from the tile's first input column, element 0
at that column's offset rounded down to 16 bytes, zero outside x, in
whole 16-byte units where x allows), each pixel group's pixels read at
the stride sw * Cin for each tap, the taps in the TPU kernel's order
(dy, dx, ci), the group's pixels stored once. It must write
every output once and agree with ``plain_conv2d`` and the JAX package's
``_conv_fwd_kernel`` (interpreted on the CPU) within 1e-5 of the largest
magnitude.
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
from test_torch_cuda_kernels import CONV_CASES

SHAPES = [('conv1_serve', (64, 472, 472, 3), (6, 6, 3, 64), (2, 2), 'SAME'),
          ('conv1_train', (32, 472, 472, 3), (6, 6, 3, 64), (2, 2), 'SAME')
          ] + CONV_CASES
IDS = [case[0] for case in SHAPES]
DTYPES = [torch.bfloat16, torch.float32]
MAX_SMEM = 232448  # dynamic shared memory a block may take on an H100


def _geometry(xshape, wshape, strides, padding):
  """Pads, output rows and columns, computed here from the conv's
  arithmetic, not from the planner."""
  pads = conv_s2d.resolve_padding(padding, wshape[:2], strides, xshape[1:3])
  (plh, phh), (plw, phw) = pads
  oh = (xshape[1] + plh + phh - wshape[0]) // strides[0] + 1
  ow = (xshape[2] + plw + phw - wshape[1]) // strides[1] + 1
  return pads, oh, ow


def test_the_card_cases_reach_the_deepest_patch():
  assert max(int(np.prod(w[:3])) for _, _, w, _, _ in CONV_CASES) == 512


@pytest.mark.parametrize('name,xshape,wshape,strides,padding', SHAPES,
                         ids=IDS)
def test_tensor_core_tiles_cover_every_output_once(name, xshape, wshape,
                                                   strides, padding):
  """Every (pixel, channel) of the output lies in exactly one block's run
  and channel tile, no launched block is empty, and the padded taps cover
  the patch with less than one k16 step to spare."""
  del name
  pads, oh, ow = _geometry(xshape, wshape, strides, padding)
  plan = conv_s2d.fwd_plan(xshape, wshape, strides, pads, torch.bfloat16)
  num_pixels, cout = xshape[0] * oh * ow, wshape[3]
  assert plan['num_pixels'] == num_pixels
  assert plan['num_tiles'] == -(-num_pixels // plan['tile_pixels'])
  k = int(np.prod(wshape[:3]))
  assert plan['k_pad'] % 16 == 0 and plan['k_pad'] - 16 < k <= plan['k_pad']
  assert plan['k_pad'] <= 512
  pixels = np.zeros(num_pixels, np.int32)
  tiles = plan['tiles_per_chunk']
  for chunk in range(plan['chunks']):
    first = chunk * tiles
    last = min(first + tiles, plan['num_tiles'])
    assert first < last
    pixels[first * plan['tile_pixels']:last * plan['tile_pixels']] += 1
  channels = np.zeros(cout, np.int32)
  for tile in range(plan['channel_tiles']):
    assert tile * 64 < cout
    channels[tile * 64:(tile + 1) * 64] += 1
  assert (pixels == 1).all() and (channels == 1).all()


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('name,xshape,wshape,strides,padding', SHAPES,
                         ids=IDS)
def test_shared_memory_fits_a_block(name, xshape, wshape, strides, padding,
                                    dtype):
  del name
  pads, _, _ = _geometry(xshape, wshape, strides, padding)
  plan = conv_s2d.fwd_plan(xshape, wshape, strides, pads, dtype)
  assert 0 < plan['smem'] <= MAX_SMEM
  assert conv_s2d.is_supported(xshape, wshape, strides, padding, dtype)


def test_conv1_plan_fills_one_wave_of_four_blocks_per_sm():
  """conv1's serving forward: 108 taps padded to 112, one channel tile,
  52,992 bytes a block (four fit an SM's 228 KB with 1 KB reserved each),
  106 tiles a run over 526 runs; training at batch 32 has 53 a run. The
  float32 forward: tiles of one output row x 128 pixels (16 groups of 8),
  two a row, the [108, 64] weights and three stages of one 784-float row
  in 37,056 bytes, conv1's templated instantiation, three blocks an SM
  over 396 persistent blocks."""
  pads, _, _ = _geometry((64, 472, 472, 3), (6, 6, 3, 64), (2, 2), 'SAME')
  serve = conv_s2d.fwd_plan((64, 472, 472, 3), (6, 6, 3, 64), (2, 2), pads,
                            torch.bfloat16)
  assert (serve['k_pad'], serve['channel_tiles']) == (112, 1)
  assert serve['smem'] == 52992 and 4 * (serve['smem'] + 1024) <= 233472
  assert (serve['num_tiles'], serve['tiles_per_chunk'], serve['chunks']) == (
      55696, 106, 526)
  train = conv_s2d.fwd_plan((32, 472, 472, 3), (6, 6, 3, 64), (2, 2), pads,
                            torch.bfloat16)
  assert (train['num_tiles'], train['tiles_per_chunk'], train['chunks']) == (
      27848, 53, 526)
  f32 = conv_s2d.fwd_plan((64, 472, 472, 3), (6, 6, 3, 64), (2, 2), pads,
                          torch.float32)
  assert f32 == dict(
      route='cuda_core', num_pixels=64 * 236 * 236, templated=True, channel_tiles=1, groups=16, groups_per_row=16,
      tile_rows=1, tile_cols=128, row_tiles=236, col_tiles=2,
      num_tiles=30208, cols=260, span=780, ls=784, stage_floats=784,
      grid=396, smem=37056)
  assert f32['smem'] == 4 * (108 * 64 + 3 * 784)
  assert 3 * (f32['smem'] + 1024) <= 233472


def test_deepest_patch_takes_one_block_per_sm():
  """K = 512: 32 k16 steps, 212,992 bytes, within a block's limit."""
  xshape, wshape = (1, 19, 21, 8), (8, 8, 8, 24)
  pads, _, _ = _geometry(xshape, wshape, (2, 2), 'SAME')
  plan = conv_s2d.fwd_plan(xshape, wshape, (2, 2), pads, torch.bfloat16)
  assert (plan['k_pad'], plan['channel_tiles'], plan['smem']) == (512, 1,
                                                                  212992)
  assert not conv_s2d.is_supported((1, 19, 21, 9), (8, 8, 9, 24), (2, 2),
                                   'SAME', torch.bfloat16)


def test_plan_does_not_ask_the_device(monkeypatch):
  """The plan depends on the shapes alone: planning with every device query
  raising gives the plan of a fixed run count."""

  def refuse(*args, **kwargs):
    raise AssertionError('the forward plan asked the device')

  for fn in ('is_available', 'device_count', 'get_device_properties',
             'current_device', 'get_device_capability'):
    monkeypatch.setattr(torch.cuda, fn, refuse)
  pads, _, _ = _geometry((64, 472, 472, 3), (6, 6, 3, 64), (2, 2), 'SAME')
  tiles = {torch.bfloat16: 55696, torch.float32: 30208}
  for dtype in DTYPES:
    plan = conv_s2d.fwd_plan((64, 472, 472, 3), (6, 6, 3, 64), (2, 2), pads,
                             dtype)
    assert plan['num_tiles'] == tiles[dtype]
  assert plan['route'] == conv_s2d.ROUTE_CUDA_CORE
  assert plan['grid'] == 132 * 3
  plan = conv_s2d.fwd_plan((64, 472, 472, 3), (6, 6, 3, 64), (2, 2), pads,
                           torch.bfloat16)
  assert plan['tiles_per_chunk'] == -(-plan['num_tiles'] // 528)


def test_is_supported_budgets_the_forward_for_its_dtype():
  """A 10x10 conv of 5 channels (K = 500) to 64: float32's dW budget
  (``_dw_smem``'s fixed rule: a [500, 64] accumulator, staging tiles and
  tables) is 279,408 bytes and the problem is refused; bfloat16 stages 512
  padded taps in 212,992 bytes and is taken."""
  args = ((1, 40, 40, 5), (10, 10, 5, 64), (2, 2), 'SAME')
  assert conv_s2d.is_supported(*args, torch.bfloat16)
  assert not conv_s2d.is_supported(*args, torch.float32)
  pads, _, _ = _geometry(*args[:2], args[2], args[3])
  assert conv_s2d.fwd_plan(*args[:3], pads, torch.bfloat16)['smem'] == 212992
  assert conv_s2d._dw_smem(500, 64, torch.float32) == 279408 > MAX_SMEM  # pylint: disable=protected-access
  with pytest.raises(ValueError, match='unsupported'):
    conv_s2d.fwd_plan(*args[:3], pads, torch.float32)


def test_route_follows_the_dtype():
  pads, _, _ = _geometry((2, 48, 48, 3), (6, 6, 3, 64), (2, 2), 'SAME')
  routes = {dtype: conv_s2d.fwd_plan((2, 48, 48, 3), (6, 6, 3, 64), (2, 2),
                                     pads, dtype)['route']
            for dtype in DTYPES}
  assert routes == {torch.bfloat16: conv_s2d.ROUTE_TENSOR_CORE,
                    torch.float32: conv_s2d.ROUTE_CUDA_CORE}


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
def test_wrapper_calls_the_entry_point_of_its_route(monkeypatch, dtype):
  """conv_s2d_fwd with the C library, the device checks and the stream
  replaced by stand-ins: the bfloat16 call goes to t2r_conv_s2d_fwd_mma
  with the planner's runs, padded taps and channel tiles, the float32 call
  to t2r_conv_s2d_fwd with the planner's pixel groups, templated flag,
  grid and shared memory, each with as many arguments as its ctypes
  binding, and the counters move."""
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
  xshape, wshape = (1, 29, 31, 3), (6, 6, 3, 72)
  pads, oh, ow = _geometry(xshape, wshape, (2, 2), 'SAME')
  x = torch.zeros(xshape, dtype=dtype)
  w = torch.zeros(wshape, dtype=dtype)
  before = (conv_s2d.conv_s2d_fwd.launches,
            conv_s2d.conv_s2d_fwd.tensor_core_launches)
  out = conv_s2d.conv_s2d_fwd(x, w, (2, 2), pads)
  assert out.shape == (1, oh, ow, 72) and out.dtype == dtype
  (name, args), = calls
  assert len(args) == len(conv_s2d._SIGNATURES[name])  # pylint: disable=protected-access
  assert args[3:16] == (1, 29, 31, 3, 6, 6, 2, 2, pads[0][0], pads[1][0],
                        oh, ow, 72)
  plan = conv_s2d.fwd_plan(xshape, wshape, (2, 2), pads, dtype)
  if dtype == torch.bfloat16:
    assert name == 't2r_conv_s2d_fwd_mma'
    assert args[-5:-1] == (plan['tiles_per_chunk'], plan['chunks'],
                           plan['k_pad'], plan['channel_tiles'])
    assert plan['channel_tiles'] == 2
  else:
    assert name == 't2r_conv_s2d_fwd'
    assert args[-5:-1] == (plan['groups'], 1, plan['grid'], plan['smem'])
    assert plan['templated']
  assert (conv_s2d.conv_s2d_fwd.launches,
          conv_s2d.conv_s2d_fwd.tensor_core_launches) == (
              before[0] + 1, before[1] + (dtype == torch.bfloat16))


def _constants():
  """{name: value} of the ``constexpr int`` constants of
  ``csrc/conv_s2d.cu``, each expression evaluated over those before it."""
  source = (_build.CSRC_DIR / 'conv_s2d.cu').read_text()
  values = {}
  for key, expr in re.findall(r'constexpr int (\w+) = ([^;]+);', source):
    values[key] = eval(expr, {}, dict(values))  # pylint: disable=eval-used
  return values


def test_ffma_mirror_holds_the_kernel_constants():
  """The float32 planner's numbers are conv_fwd_ffma_kernel's: 128
  threads, 16 groups of 8 lanes, 8 pixels a group, a lane 8 of the 64
  channels, three stages, three blocks an SM; conv1's instantiation is
  <3, 2, 6> and the generic one <0, 0, 0>."""
  c = _constants()
  # pylint: disable=protected-access
  assert c['kFfmaPix'] == conv_s2d._FFMA_PIX == 8
  assert c['kFfmaChannels'] == conv_s2d._FFMA_CHANNELS == 64
  assert c['kFfmaGroups'] == conv_s2d._FFMA_GROUPS == 16
  assert c['kFfmaStages'] == conv_s2d._FFMA_STAGES
  assert c['kFfmaBlocksPerSm'] == conv_s2d._FFMA_BLOCKS_PER_SM
  # pylint: enable=protected-access
  assert c['kFfmaThreads'] == c['kFfmaGroups'] * c['kFfmaChannelLanes']
  assert c['kFfmaChannelLanes'] * 8 == c['kFfmaChannels']
  source = (_build.CSRC_DIR / 'conv_s2d.cu').read_text()
  assert 'p.templated = Cin == 3 && sw == 2 && kw == 6;' in source
  assert 'launch_fwd_ffma_as<3, 2, 6>' in source
  assert 'launch_fwd_ffma_as<0, 0, 0>' in source


FFMA_SHAPES = SHAPES + [
    # Groups past a row's pixels: 3 groups a row, 5 rows a tile.
    ('narrow', (2, 40, 36, 3), (6, 6, 3, 64), (2, 2), 'SAME'),
    ('odd', (4, 101, 97, 2), (5, 5, 2, 48), (3, 3), 'SAME'),
    # A stride past the window, more columns than a tile.
    ('stride_past', (1, 23, 300, 2), (2, 3, 2, 16), (4, 5), 'VALID'),
    ('long_row', (1, 5, 1100, 1), (3, 9, 1, 4), (1, 1), 'SAME'),
    # 8 x 8 channels at stride 8: stage rows of 8 * 1024 floats, so the
    # planner takes 8 of the 16 groups.
    ('wide_stride', (1, 16, 2000, 8), (1, 8, 8, 64), (1, 8), 'VALID'),
]
FFMA_IDS = [case[0] for case in FFMA_SHAPES]


@pytest.mark.parametrize('name,xshape,wshape,strides,padding', FFMA_SHAPES,
                         ids=FFMA_IDS)
def test_ffma_tiles_cover_every_output_once(name, xshape, wshape, strides,
                                            padding):
  """Every output pixel lies in one tile and one live pixel group; every
  channel in one channel tile; the stage rows hold the span a row's
  pixels read with room for the 16-byte lead; the block fits."""
  del name
  pads, oh, ow = _geometry(xshape, wshape, strides, padding)
  plan = conv_s2d.fwd_plan(xshape, wshape, strides, pads, torch.float32)
  kh, kw, cin, cout = wshape
  lpr, rows = plan['groups_per_row'], plan['tile_rows']
  assert rows * lpr <= plan['groups'] <= 16 and plan['groups'] in (
      1, 2, 4, 8, 16)
  assert plan['cols'] == (8 * lpr - 1) * strides[1] + kw
  assert plan['span'] + 3 <= plan['ls'] and plan['ls'] % 4 == 0
  assert plan['smem'] == 4 * (kh * kw * cin * 64 + 3 * plan['stage_floats'])
  assert plan['smem'] <= MAX_SMEM
  assert plan['grid'] <= plan['num_tiles']
  rest, ct = np.divmod(np.arange(plan['num_tiles']), plan['col_tiles'])
  b, rt = np.divmod(rest, plan['row_tiles'])
  r, q = np.divmod(np.arange(rows * lpr), lpr)
  oh_ = (rt * rows)[:, None, None] + r[None, :, None] + 0 * np.arange(8)
  ow_ = (ct * 8 * lpr)[:, None, None] + (8 * q)[None, :, None] + np.arange(8)
  b = np.broadcast_to(b[:, None, None], ow_.shape)
  inside = (oh_ < oh) & (ow_ < ow)
  covered = np.zeros((xshape[0], oh, ow), np.int32)
  np.add.at(covered, (b[inside], oh_[inside], ow_[inside]), 1)
  assert (covered == 1).all()
  channels = np.zeros(cout, np.int32)
  for ct in range(plan['channel_tiles']):
    channels[ct * 64:(ct + 1) * 64] += 1
  assert (channels == 1).all()


def test_ffma_templated_only_at_conv1s_window():
  """conv1's instantiation knows Cin 3, sw 2 and kw 6 (2 phases of 3
  taps); every other window row takes the generic one."""
  for wshape, strides, want in (((6, 6, 3, 64), (2, 2), True),
                                ((4, 6, 3, 16), (1, 2), True),
                                ((5, 5, 3, 64), (2, 2), False),
                                ((6, 6, 2, 64), (2, 2), False),
                                ((6, 6, 3, 64), (3, 3), False)):
    xshape = (1, 30, 30, wshape[2])
    pads, _, _ = _geometry(xshape, wshape, strides, 'SAME')
    plan = conv_s2d.fwd_plan(xshape, wshape, strides, pads, torch.float32)
    assert plan['templated'] == want, (wshape, strides)


def emulate_fwd_ffma(x, w, strides, pads, plan, vec_in):
  """The float32 forward as conv_fwd_ffma_kernel computes it, from its
  plan, in float32 (see the module docstring); NaN marks what no copy
  wrote. Returns out and how often each element was written."""
  b_, h, wd, cin = x.shape
  kh, kw, _, cout = w.shape
  sh, sw = strides
  (plh, _), (plw, _) = pads
  oh_n = (h + sum(pads[0]) - kh) // sh + 1
  ow_n = (wd + sum(pads[1]) - kw) // sw + 1
  k = kh * kw * cin
  lpr, rows = plan['groups_per_row'], plan['tile_rows']
  span, ls, stride = plan['span'], plan['ls'], sw * cin
  xflat = x.float().reshape(b_, h, wd * cin)
  wmat = w.reshape(k, cout).float()
  out = torch.full((b_, oh_n, ow_n, cout), float('nan'))
  writes = np.zeros((b_, oh_n, ow_n, cout), np.int32)
  lr, lq = np.divmod(np.arange(rows * lpr), lpr)
  for ct in range(plan['channel_tiles']):
    co = ct * 64 + np.arange(64)
    w_s = torch.zeros(k, 64)
    w_s[:, co < cout] = wmat[:, co[co < cout]]
    for tile in range(plan['num_tiles']):
      rest, ctile = divmod(tile, plan['col_tiles'])
      b, rt = divmod(rest, plan['row_tiles'])
      oh0, ow0 = rt * rows, ctile * 8 * lpr
      lead = ((ow0 * sw - plw) * cin) % 4
      a0 = (ow0 * sw - plw) * cin - lead
      n = -(-(lead + span) // 4) * 4 if vec_in else lead + span
      assert n <= ls
      acc = torch.zeros(len(lr), 8, 64)
      for dy in range(kh):
        stage = torch.full((rows, ls), float('nan'))
        o = a0 + np.arange(n)
        for r in range(rows):
          ih = (oh0 + r) * sh - plh + dy
          ok = (o >= 0) & (o < wd * cin) & (0 <= ih < h) & (oh0 + r < oh_n)
          if vec_in:  # every 16-byte unit wholly inside or outside x
            units = ok.reshape(-1, 4)
            assert (units.all(1) | ~units.any(1)).all()
          stage[r, :n] = 0.0
          if ok.any():
            stage[r, :n][torch.from_numpy(ok)] = xflat[b, ih, o[ok]]
        stage = stage.reshape(-1)
        base = lr * ls + lead + 8 * lq * stride
        for dx in range(kw):  # the TPU kernel's tap order
          for ci in range(cin):
            xv = stage[torch.from_numpy(
                base[:, None] + dx * cin + ci + np.arange(8) * stride)]
            acc += xv[..., None] * w_s[(dy * kw + dx) * cin + ci]
      oh = oh0 + lr
      for i in range(8):
        ow = ow0 + 8 * lq + i
        sel = (oh < oh_n) & (ow < ow_n)
        for c in np.nonzero(co < cout)[0]:
          out[b, oh[sel], ow[sel], co[c]] = acc[torch.from_numpy(sel), i, c]
          np.add.at(writes, (b, oh[sel], ow[sel], co[c]), 1)
  return out, writes


# conv1 narrowed (a tile of 5 rows of 3 groups, a ragged last group), its
# odd geometry, a ragged last column tile, explicit pads and a stride past
# the window; vec: x's rows in whole 16-byte units (W * Cin % 4 == 0).
EMULATED = [
    ('conv1', (2, 40, 36, 3), (6, 6, 3, 64), (2, 2), 'SAME', True),
    ('conv1_unaligned', (1, 14, 18, 3), (6, 6, 3, 64), (2, 2), 'SAME',
     False),
    ('odd', (1, 31, 29, 2), (5, 5, 2, 48), (3, 3), 'SAME', False),
    ('ragged_tile', (1, 5, 276, 3), (6, 6, 3, 16), (2, 2), 'SAME', True),
    ('cout72', (1, 13, 15, 3), (6, 6, 3, 72), (2, 2), 'SAME', False),
    ('explicit', (1, 14, 12, 3), (7, 7, 3, 8), (2, 2), ((2, 3), (2, 3)),
     False),
    ('stride_past', (1, 23, 26, 2), (2, 3, 2, 16), (4, 5), 'VALID', True),
]


@pytest.mark.parametrize('name,xshape,wshape,strides,padding,vec', EMULATED,
                         ids=[case[0] for case in EMULATED])
def test_ffma_emulation_writes_once_and_matches_plain_and_jax(
    name, xshape, wshape, strides, padding, vec):
  del name
  pads, _, _ = _geometry(xshape, wshape, strides, padding)
  plan = conv_s2d.fwd_plan(xshape, wshape, strides, pads, torch.float32)
  rng = np.random.RandomState(sum(xshape) + sum(wshape))
  x = rng.randn(*xshape).astype(np.float32)
  w = (0.1 * rng.randn(*wshape)).astype(np.float32)
  got, writes = emulate_fwd_ffma(torch.from_numpy(x), torch.from_numpy(w),
                                 strides, pads, plan, vec)
  assert (writes == 1).all()
  plain = conv_s2d.plain_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                                strides, pads)
  jax_plan = jax_conv._plan(xshape, wshape, strides, pads)  # pylint: disable=protected-access
  with _pallas_dispatch.force_kernels(True):
    want = np.asarray(jax_conv._fwd_call(  # pylint: disable=protected-access
        jnp.asarray(x), jnp.asarray(w), jax_plan))
  for reference in (plain.numpy(), want):
    scale = float(np.abs(reference).max())
    np.testing.assert_allclose(got.numpy() / scale, reference / scale,
                               rtol=0, atol=1e-5)
