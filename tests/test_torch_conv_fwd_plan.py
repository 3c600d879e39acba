"""conv1's forward planner and route, on the CPU.

``conv_s2d.fwd_plan`` decides, from the shapes and the dtype alone, how the
forward kernels run a problem: which kernel (bfloat16 on the tensor cores,
float32 on the CUDA cores), a block's shared memory and, on the tensor-core
route, the runs of 64-pixel tiles that the blocks own, the padded taps and
the 64-channel tiles. The kernels run only on the card; these tests hold
what the host decides for them, at conv1's serving and training shapes and
at every shape of the card tests, and that ``conv_s2d_fwd`` calls the C
entry point of its route with its binding's argument count.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

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
  106 tiles a run over 526 runs; training at batch 32 has 53 a run."""
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
  assert f32['smem'] == 4 * (108 * 64 + 108 * 64)
  assert 'chunks' not in f32


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
  for dtype in DTYPES:
    plan = conv_s2d.fwd_plan((64, 472, 472, 3), (6, 6, 3, 64), (2, 2), pads,
                             dtype)
    assert plan['num_tiles'] == 55696
  assert plan['route'] == conv_s2d.ROUTE_CUDA_CORE
  plan = conv_s2d.fwd_plan((64, 472, 472, 3), (6, 6, 3, 64), (2, 2), pads,
                           torch.bfloat16)
  assert plan['tiles_per_chunk'] == -(-plan['num_tiles'] // 528)


def test_is_supported_budgets_the_forward_for_its_dtype():
  """A 10x10 conv of 5 channels (K = 500) to 64: float32 needs 256,000
  bytes to stage its forward's weights and patch tile as float32 and is
  refused; bfloat16 stages 512 padded taps in 212,992 bytes and is taken."""
  args = ((1, 40, 40, 5), (10, 10, 5, 64), (2, 2), 'SAME')
  assert conv_s2d.is_supported(*args, torch.bfloat16)
  assert not conv_s2d.is_supported(*args, torch.float32)
  pads, _, _ = _geometry(*args[:2], args[2], args[3])
  assert conv_s2d.fwd_plan(*args[:3], pads, torch.bfloat16)['smem'] == 212992
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
  to t2r_conv_s2d_fwd, each with as many arguments as its ctypes binding,
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
  assert (conv_s2d.conv_s2d_fwd.launches,
          conv_s2d.conv_s2d_fwd.tensor_core_launches) == (
              before[0] + 1, before[1] + (dtype == torch.bfloat16))
