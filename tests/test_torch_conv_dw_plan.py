"""conv1's dW planner and route, on the CPU.

``conv_s2d.dw_plan`` decides, from the shapes and the dtype alone, how the
dW kernels split a problem: which first pass runs (bfloat16 on the tensor
cores, float32 on the CUDA cores), the runs of 64-pixel tiles that the
blocks own and whose partials the second pass adds in order, and the
bfloat16 kernel's output tiles. The kernels run only on the card; these
tests hold what the host decides for them, at conv1's training shape and
at every shape of the card tests, and that ``conv_s2d_dw`` calls the C
entry point of its route with its binding's argument count.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

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
  del name
  pads, oh, ow = _geometry(xshape, wshape, strides, padding)
  plan = conv_s2d.dw_plan(xshape, wshape, strides, pads, dtype)
  num_pixels = xshape[0] * oh * ow
  assert plan['num_pixels'] == num_pixels
  assert plan['num_tiles'] == -(-num_pixels // plan['tile_pixels'])
  seen = np.zeros(num_pixels, np.int32)
  tiles = plan['tiles_per_chunk']
  for chunk in range(plan['chunks']):
    first = chunk * tiles
    last = min(first + tiles, plan['num_tiles'])
    assert first < last  # no launched block is empty
    seen[first * plan['tile_pixels']:last * plan['tile_pixels']] += 1
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
  run over 526 runs; float32 keeps its 393 runs of 71 tiles."""
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
  assert (f32['tiles_per_chunk'], f32['chunks'], f32['smem']) == (71, 393,
                                                                   74000)


def test_ragged_case_has_a_ragged_tile_and_run():
  xshape, wshape = (4, 186, 190, 3), (6, 6, 3, 64)
  pads, _, _ = _geometry(xshape, wshape, (2, 2), 'SAME')
  for dtype in DTYPES:
    plan = conv_s2d.dw_plan(xshape, wshape, (2, 2), pads, dtype)
    assert plan['num_pixels'] % plan['tile_pixels'] != 0
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
  for dtype, runs in ((torch.bfloat16, 528), (torch.float32, 396)):
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
  the bfloat16 call its output tiles) and with as many arguments as its
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
    assert args[-3:-1] == (plan['tiles_per_chunk'], plan['chunks'])
  assert (conv_s2d.conv_s2d_dw.launches,
          conv_s2d.conv_s2d_dw.tensor_core_launches) == (
              before[0] + 1, before[1] + (dtype == torch.bfloat16))
