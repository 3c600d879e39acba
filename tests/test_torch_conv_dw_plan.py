"""conv1's dW planner and route, on the CPU.

``conv_s2d.dw_plan`` decides, from the shapes and the dtype alone, how the
dW kernels split a problem: which first pass runs (bfloat16 on the tensor
cores, float32 on the CUDA cores), the runs of tiles that the blocks own
and whose partials the second pass adds in order, the bfloat16 kernel's
output tiles and the float32 kernel's tap groups, row-segment tiles and
stages. The kernels run only on the card; these tests hold what the host
decides for them, at conv1's training shape and at every shape of the
card tests, that the mirror holds the source's constants, and that
``conv_s2d_dw`` calls the C entry point of its route with the plan and its
binding's argument count.

``emulate_dw_ffma`` repeats the float32 kernel's work from its plan: each
tile's stage rows (for every window row, x's span as it lies in memory
from the segment's first input column, element 0 at that column's offset
rounded down to 16 bytes, zero outside x and past the segment's last
window, in whole 16-byte units where x allows) and its cotangent; each tap
read at its offset in the stage plus the pixel's stride sw * Cin; each
(tap, channel) summed over the run's pixels in order, conv1's
instantiation running its segment up to a multiple of 4 pixels on zeros;
the runs' partials added in order. It must agree with ``plain_conv2d_dw``
and with the JAX package's ``_conv_dw_kernel`` (interpreted on the CPU)
within 1e-5 of the largest magnitude; with the JAX kernel wherever its
planner takes the problem (not at Cout 5) except the two ragged-run
cases, conv1's geometry at 26,505 and 35,340 pixels, which interpreting
would take about 3 s of the suite's time for a geometry the other conv1
cases hold.
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

SHAPES = [('conv1_train', (32, 472, 472, 3), (6, 6, 3, 64), (2, 2), 'SAME')
          ] + CONV_CASES
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


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('name,xshape,wshape,strides,padding', SHAPES,
                         ids=[case[0] for case in SHAPES])
def test_every_pixel_lies_in_exactly_one_run(name, xshape, wshape, strides,
                                             padding, dtype):
  """bfloat16 tiles are 64 consecutive pixels; float32 tiles are segments
  of up to ``tile_pixels`` pixels of one output row, ``segs`` a row, the
  last of a row ragged. Either way every pixel lies in one tile of one
  run, and no launched block is empty."""
  del name
  pads, oh, ow = _geometry(xshape, wshape, strides, padding)
  plan = conv_s2d.dw_plan(xshape, wshape, strides, pads, dtype)
  num_pixels = xshape[0] * oh * ow
  assert plan['num_pixels'] == num_pixels
  pix = plan['tile_pixels']
  if dtype == torch.bfloat16:
    assert plan['num_tiles'] == -(-num_pixels // pix)
    starts = np.arange(plan['num_tiles']) * pix
    lengths = np.minimum(pix, num_pixels - starts)
  else:
    assert plan['segs'] == -(-ow // pix)
    assert plan['num_tiles'] == xshape[0] * oh * plan['segs']
    row, seg = np.divmod(np.arange(plan['num_tiles']), plan['segs'])
    starts = row * ow + seg * pix
    lengths = np.minimum(pix, ow - seg * pix)
  seen = np.zeros(num_pixels, np.int32)
  tiles = plan['tiles_per_chunk']
  for chunk in range(plan['chunks']):
    first = chunk * tiles
    last = min(first + tiles, plan['num_tiles'])
    assert first < last  # no launched block is empty
    for start, length in zip(starts[first:last], lengths[first:last]):
      seen[start:start + length] += 1
  assert (seen == 1).all()


@pytest.mark.parametrize('name,xshape,wshape,strides,padding', SHAPES,
                         ids=[case[0] for case in SHAPES])
def test_tensor_core_tiles_cover_the_output_once(name, xshape, wshape,
                                                 strides, padding):
  del name
  pads, _, _ = _geometry(xshape, wshape, strides, padding)
  plan = conv_s2d.dw_plan(xshape, wshape, strides, pads, torch.bfloat16)
  k, cout = int(np.prod(wshape[:3])), wshape[3]
  assert plan['k_pad'] % 16 == 0 and plan['k_pad'] - 16 < k <= plan['k_pad']
  assert plan['cout_pad'] % 8 == 0
  assert plan['cout_pad'] - 8 < cout <= plan['cout_pad']
  taps = plan['tile_taps']
  assert taps % 16 == 0 and 16 <= taps <= 128
  assert plan['tap_tiles'] * taps >= plan['k_pad']
  covered = np.zeros((k, cout), np.int32)
  for y in range(plan['tap_tiles']):
    assert y * taps < k  # no tap tile is all padding
    for z in range(plan['channel_tiles']):
      assert z * 64 < cout
      covered[y * taps:(y + 1) * taps, z * 64:(z + 1) * 64] += 1
  assert (covered == 1).all()


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('name,xshape,wshape,strides,padding', SHAPES,
                         ids=[case[0] for case in SHAPES])
def test_shared_memory_fits_a_block(name, xshape, wshape, strides, padding,
                                    dtype):
  del name
  pads, _, _ = _geometry(xshape, wshape, strides, padding)
  plan = conv_s2d.dw_plan(xshape, wshape, strides, pads, dtype)
  assert plan['smem'] <= MAX_SMEM
  assert conv_s2d.is_supported(xshape, wshape, strides, padding, dtype)


def test_conv1_plan_fills_one_wave_of_four_blocks_per_sm():
  """conv1's training dW: 112 taps x 64 channels in one output tile, 50 KB
  a block (four fit an SM's 228 KB with 1 KB reserved each), 53 tiles a
  run over 526 runs. float32: 12 tap groups (6 window rows x 2 phases of
  3 taps x 3 channels) and 64 channels in one block of 96 threads, 8 tiles
  of up to 32 pixels a row, three stages of 6 rows of 208 floats and
  32 x 64 cotangents in 39.6 KB (four blocks an SM), 115 tiles a run over
  526 runs, conv1's templated instantiation."""
  pads, _, _ = _geometry((32, 472, 472, 3), (6, 6, 3, 64), (2, 2), 'SAME')
  bf16 = conv_s2d.dw_plan((32, 472, 472, 3), (6, 6, 3, 64), (2, 2), pads,
                          torch.bfloat16)
  assert (bf16['tile_taps'], bf16['tap_tiles'], bf16['channel_tiles']) == (
      112, 1, 1)
  assert bf16['smem'] == 50944 and 4 * (bf16['smem'] + 1024) <= 233472
  assert (bf16['num_tiles'], bf16['tiles_per_chunk'], bf16['chunks']) == (
      27848, 53, 526)
  f32 = conv_s2d.dw_plan((32, 472, 472, 3), (6, 6, 3, 64), (2, 2), pads,
                         torch.float32)
  assert (f32['groups'], f32['group_tiles'], f32['channel_tiles']) == (12, 1,
                                                                      1)
  assert (f32['tile_pixels'], f32['segs'], f32['ls'], f32['stage_floats']) == (
      32, 8, 208, 6 * 208 + 32 * 64)
  assert f32['smem'] == 39552 and 4 * (f32['smem'] + 1024) <= 233472
  assert (f32['num_tiles'], f32['tiles_per_chunk'], f32['chunks']) == (
      60416, 115, 526)
  assert f32['templated'] and f32['grid'] == (526, 1, 1)


def test_ragged_case_has_a_ragged_tile_and_run():
  """The card cases' ragged ones: for bfloat16 a ragged last 64-pixel tile
  and run; for float32 a ragged last segment of each row and a ragged
  last run."""
  wshape = (6, 6, 3, 64)
  for xshape, dtype in (((4, 186, 190, 3), torch.bfloat16),
                        ((3, 186, 190, 3), torch.float32)):
    pads, _, ow = _geometry(xshape, wshape, (2, 2), 'SAME')
    plan = conv_s2d.dw_plan(xshape, wshape, (2, 2), pads, dtype)
    ragged = (plan['num_pixels'] if dtype == torch.bfloat16 else ow)
    assert ragged % plan['tile_pixels'] != 0
    assert plan['num_tiles'] % plan['tiles_per_chunk'] != 0


def test_plan_does_not_ask_the_device(monkeypatch):
  """The split depends on the shapes alone: planning with every device
  query raising gives the plan of a fixed run count."""

  def refuse(*args, **kwargs):
    raise AssertionError('the dW plan asked the device')

  for fn in ('is_available', 'device_count', 'get_device_properties',
             'current_device'):
    monkeypatch.setattr(torch.cuda, fn, refuse)
  pads, _, _ = _geometry((32, 472, 472, 3), (6, 6, 3, 64), (2, 2), 'SAME')
  for dtype, runs in ((torch.bfloat16, 528), (torch.float32, 528)):
    plan = conv_s2d.dw_plan((32, 472, 472, 3), (6, 6, 3, 64), (2, 2), pads,
                            dtype)
    assert plan['tiles_per_chunk'] == -(-plan['num_tiles'] // runs)


def test_is_supported_budgets_dw_for_its_dtype():
  """A 10x10 conv with 128 channels: the forward fits, float32 dW's
  staging (267 KB) does not, bfloat16 dW's (50 KB) does."""
  args = ((1, 32, 32, 3), (10, 10, 3, 128), (2, 2), 'SAME')
  assert conv_s2d.is_supported(*args, torch.bfloat16)
  assert not conv_s2d.is_supported(*args, torch.float32)


def test_route_follows_the_dtype():
  pads, _, _ = _geometry((2, 48, 48, 3), (6, 6, 3, 64), (2, 2), 'SAME')
  routes = {dtype: conv_s2d.dw_plan((2, 48, 48, 3), (6, 6, 3, 64), (2, 2),
                                    pads, dtype)['route']
            for dtype in DTYPES}
  assert routes == {torch.bfloat16: conv_s2d.ROUTE_TENSOR_CORE,
                    torch.float32: conv_s2d.ROUTE_CUDA_CORE}


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
def test_wrapper_calls_the_entry_point_of_its_route(monkeypatch, dtype):
  """conv_s2d_dw with the C library, the device checks and the stream
  replaced by stand-ins: the bfloat16 call goes to t2r_conv_s2d_dw_mma,
  the float32 call to t2r_conv_s2d_dw, each with the planner's runs (and
  the bfloat16 call its output tiles, the float32 call its tile pixels,
  templated flag and shared memory) and with as many arguments as its
  ctypes binding, and the counters move."""
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
  pads, oh, ow = _geometry(xshape, wshape, (2, 2), 'SAME')
  x = torch.zeros(xshape, dtype=dtype)
  g = torch.zeros((4, oh, ow, 64), dtype=dtype)
  before = (conv_s2d.conv_s2d_dw.launches,
            conv_s2d.conv_s2d_dw.tensor_core_launches)
  dw = conv_s2d.conv_s2d_dw(x, g, wshape, (2, 2), pads)
  assert dw.shape == wshape and dw.dtype == dtype
  (name, args), = calls
  assert len(args) == len(conv_s2d._SIGNATURES[name])  # pylint: disable=protected-access
  plan = conv_s2d.dw_plan(xshape, wshape, (2, 2), pads, dtype)
  if dtype == torch.bfloat16:
    assert name == 't2r_conv_s2d_dw_mma'
    assert args[-6:-1] == (plan['tiles_per_chunk'], plan['chunks'],
                           plan['tile_taps'], plan['tap_tiles'],
                           plan['channel_tiles'])
  else:
    assert name == 't2r_conv_s2d_dw'
    assert args[-6:-1] == (plan['tiles_per_chunk'], plan['chunks'],
                           plan['tile_pixels'], int(plan['templated']),
                           plan['smem'])
  assert (conv_s2d.conv_s2d_dw.launches,
          conv_s2d.conv_s2d_dw.tensor_core_launches) == (
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
  """The float32 planner's numbers are conv_dw_ffma_kernel's: 12 tap
  groups of 8 lanes (96 threads), a lane 8 of the block's 64 channels, at
  most 9 taps a group and 32 pixels a tile, three stages, four blocks an
  SM; conv1's instantiation is <3, 2, 6> and the generic one <0, 0, 0>."""
  c = _constants()
  # pylint: disable=protected-access
  assert c['kDwfGroups'] == conv_s2d._DWF_GROUPS == 12
  assert c['kDwfLanes'] == 8
  assert c['kDwfChannels'] == conv_s2d._DWF_CHANNELS == 8 * c['kDwfLanes']
  assert c['kDwfTaps'] == conv_s2d._DWF_TAPS == 9
  assert c['kDwfPix'] == conv_s2d._DWF_PIX == 32
  assert c['kDwfStages'] == conv_s2d._DWF_STAGES
  assert c['kDwfBlocksPerSm'] == conv_s2d._DWF_BLOCKS_PER_SM == 4
  assert c['kDwfThreads'] == 96
  assert c['kSms'] == conv_s2d._SMS and c['kMaxBlockSharedBytes'] == (
      conv_s2d._MAX_SMEM_BYTES)
  # pylint: enable=protected-access
  source = (_build.CSRC_DIR / 'conv_s2d.cu').read_text()
  assert ('p.templated = Cin == 3 && sw == 2 && kw == 6 && p.pix % 4 == 0;'
          in source)
  assert 'launch_dw_ffma_as<3, 2, 6>' in source
  assert 'launch_dw_ffma_as<0, 0, 0>' in source
  assert 'conv_dw_partial_kernel' not in source


def _tap_groups(kh, kw, sw, cin):
  """The float32 kernel's tap groups, from its rule: for each window row
  dy and phase ph < min(sw, kw), the taps (m, ci) with dx = ph + m * sw <
  kw, in that order, 9 a group. Each group is a list of (dy, dx, ci)."""
  groups = []
  for dy in range(kh):
    for ph in range(min(sw, kw)):
      taps = [(dy, ph + m * sw, ci) for m in range(-(-(kw - ph) // sw))
              for ci in range(cin)]
      groups += [taps[i:i + 9] for i in range(0, len(taps), 9)]
  return groups


@pytest.mark.parametrize('name,xshape,wshape,strides,padding', SHAPES,
                         ids=[case[0] for case in SHAPES])
def test_ffma_threads_own_every_tap_and_channel_once(name, xshape, wshape,
                                                     strides, padding):
  """Every (tap, channel) of dW is owned by exactly one thread of one
  block of a run: block (j, y, z)'s thread t owns tap group y * 12 + t // 8
  and channels z * 64 + 4 * (t % 8) + (0..3, 32..35); a stage holds kh
  rows of x with room for the 16-byte lead, then 64 channels a pixel."""
  del name
  pads, _, _ = _geometry(xshape, wshape, strides, padding)
  plan = conv_s2d.dw_plan(xshape, wshape, strides, pads, torch.float32)
  kh, kw, cin, cout = wshape
  groups = _tap_groups(kh, kw, strides[1], cin)
  assert plan['groups'] == len(groups)
  assert plan['group_tiles'] == -(-len(groups) // 12)
  assert plan['channel_tiles'] == -(-cout // 64)
  assert plan['grid'] == (plan['chunks'], plan['group_tiles'],
                          plan['channel_tiles'])
  pix = plan['tile_pixels']
  assert plan['ls'] % 4 == 0 and plan['ls'] >= (
      ((pix - 1) * strides[1] + kw) * cin + 3)
  assert plan['stage_floats'] == kh * plan['ls'] + 64 * pix
  assert plan['smem'] == 3 * 4 * plan['stage_floats'] <= MAX_SMEM
  owned = np.zeros((kh, kw, cin, cout), np.int32)
  for y in range(plan['group_tiles']):
    for z in range(plan['channel_tiles']):
      for t in range(96):
        group = y * 12 + t // 8
        if group >= len(groups):
          continue
        channels = z * 64 + 4 * (t % 8) + np.array([0, 1, 2, 3, 32, 33, 34,
                                                     35])
        channels = channels[channels < cout]
        for dy, dx, ci in groups[group]:
          owned[dy, dx, ci, channels] += 1
  assert (owned == 1).all()


def emulate_dw_ffma(x, g, wshape, strides, pads, plan, vec_x):
  """dW as conv_dw_ffma_kernel computes it, from its plan, in float32 (see
  the module docstring); NaN marks what no copy wrote, and no read may
  find one. Returns dW as [kh, kw, Cin, Cout]."""
  b_, h, wd, cin = x.shape
  kh, kw, _, cout = wshape
  sh, sw = strides
  (plh, _), (plw, _) = pads
  oh_n, ow_n = g.shape[1:3]
  pix, ls, step = plan['tile_pixels'], plan['ls'], sw * cin
  taps = [tap for group in _tap_groups(kh, kw, sw, cin) for tap in group]
  rows_k = np.array([(dy * kw + dx) * cin + ci for dy, dx, ci in taps])
  offsets = np.array([dy * ls + dx * cin + ci for dy, dx, ci in taps])
  assert sorted(rows_k) == list(range(kh * kw * cin))
  tile = np.arange(plan['num_tiles'])
  row, seg = np.divmod(tile, plan['segs'])
  b, oh = np.divmod(row, oh_n)
  ow0 = seg * pix
  length = np.minimum(pix, ow_n - ow0)
  # conv1's instantiation runs its segment up to a multiple of 4 pixels.
  pixels = -(-length // 4) * 4 if plan['templated'] else length
  assert (pixels <= pix).all()
  iw0 = ow0 * sw - plw
  lead = (iw0 * cin) % 4
  a0 = iw0 * cin - lead
  n = lead + ((pixels - 1) * sw + kw) * cin
  count = -(-n // 4) * 4 if vec_x else n
  assert (count <= ls).all()
  end = np.minimum(wd * cin, iw0 * cin + ((length - 1) * sw + kw) * cin)
  xflat = x.reshape(b_, h, wd * cin)
  e = np.arange(ls)
  o = a0[:, None] + e
  stage = np.full((len(tile), kh, ls), np.nan, np.float32)
  for dy in range(kh):
    ih = oh * sh - plh + dy
    ok = ((ih >= 0) & (ih < h))[:, None] & (o >= 0) & (o < end[:, None])
    if vec_x:  # each 16-byte unit starts inside x's row or wholly outside
      units = (ok | (o >= end[:, None])).reshape(len(tile), -1, 4)
      assert ((units.all(2)) | ~(ok.reshape(len(tile), -1, 4).any(2))).all()
    vals = xflat[b[:, None], np.clip(ih, 0, h - 1)[:, None],
                 np.clip(o, 0, wd * cin - 1)]
    stage[:, dy] = np.where(e < count[:, None], np.where(ok, vals, 0), np.nan)
  stage = stage.reshape(len(tile), -1)
  ct = plan['channel_tiles']
  g_stage = np.full((len(tile), pix, 64 * ct), np.nan, np.float32)
  g_pad = np.zeros((b_, oh_n, ow_n + pix, 64 * ct), np.float32)
  g_pad[:, :, :ow_n, :cout] = g
  j = np.arange(pix)
  vals = g_pad[b[:, None], oh[:, None], ow0[:, None] + j]
  vals[j[None, :] >= length[:, None]] = 0
  g_stage[j[None, :] < pixels[:, None]] = vals[j[None, :] < pixels[:, None]]
  # patch[t, j, tap]: the value tap reads for pixel j of tile t.
  index = lead[:, None, None] + j[None, :, None] * step + offsets
  patch = np.take_along_axis(stage, index.reshape(len(tile), -1), 1).reshape(
      len(tile), pix, len(taps))
  read = j[None, :] < pixels[:, None]
  assert not np.isnan(patch[read]).any() and not np.isnan(g_stage[read]).any()
  runs, per = plan['chunks'], plan['tiles_per_chunk']
  acc = np.zeros((runs, len(taps), 64 * ct), np.float32)
  prod = np.empty_like(acc)
  for i in range(per):
    t = np.arange(runs) * per + i
    live = t < len(tile)
    t = np.minimum(t, len(tile) - 1)
    for jj in range(int(pixels.max())):
      # What a run does not read adds +0, which leaves its sums as they are.
      use = (live & read[t, jj]).astype(np.float32)
      np.multiply(np.nan_to_num(patch[t, jj] * use[:, None])[:, :, None],
                  np.nan_to_num(g_stage[t, jj])[:, None, :], out=prod)
      acc += prod
  dw = acc[0]
  for run in range(1, runs):
    dw = dw + acc[run]
  out = np.zeros((kh * kw * cin, cout), np.float32)
  out[rows_k] = dw[:, :cout]
  return out.reshape(wshape)


# conv1 at a cut size (two tiles a row, the last of 3 pixels, run to 4 on
# zeros; and x's rows not whole 16-byte units), then every card case.
EMULATED = [
    ('conv1_small', (2, 20, 70, 3), (6, 6, 3, 64), (2, 2), 'SAME', True),
    ('conv1_unaligned', (1, 14, 17, 3), (6, 6, 3, 64), (2, 2), 'SAME',
     False),
] + [(name, xshape, wshape, strides, padding,
      xshape[2] * xshape[3] % 4 == 0)
     for name, xshape, wshape, strides, padding in CONV_CASES]


@pytest.mark.parametrize('name,xshape,wshape,strides,padding,vec', EMULATED,
                         ids=[case[0] for case in EMULATED])
def test_ffma_emulation_matches_plain_and_jax(name, xshape, wshape, strides,
                                              padding, vec):
  pads, oh, ow = _geometry(xshape, wshape, strides, padding)
  plan = conv_s2d.dw_plan(xshape, wshape, strides, pads, torch.float32)
  rng = np.random.RandomState(sum(xshape) + sum(wshape))
  x = rng.rand(*xshape).astype(np.float32)
  g = rng.randn(xshape[0], oh, ow, wshape[3]).astype(np.float32)
  got = emulate_dw_ffma(x, g, wshape, strides, pads, plan, vec)
  references = [conv_s2d.plain_conv2d_dw(
      torch.from_numpy(x), torch.from_numpy(g), wshape, strides,
      pads).numpy()]
  jax_plan = jax_conv._plan(xshape, wshape, strides, pads)  # pylint: disable=protected-access
  assert (jax_plan is None) == (name == 'cout5')
  if jax_plan is not None and not name.startswith('ragged_runs'):
    with _pallas_dispatch.force_kernels(True):
      references.append(np.asarray(jax_conv._dw_call(  # pylint: disable=protected-access
          jnp.asarray(x), jnp.asarray(g), jax_plan, jnp.float32)))
  for reference in references:
    scale = float(np.abs(reference).max())
    np.testing.assert_allclose(got / scale, reference / scale, rtol=0,
                               atol=1e-5)
