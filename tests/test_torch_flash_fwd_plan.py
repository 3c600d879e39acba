"""The flash-attention forward's plan and its tensor-core rounding, on the CPU.

``flash_attention.fwd_plan`` decides, from the shape, the dtype, the mask
and the operands' alignment alone, how ``flash_fwd`` runs a problem: the
route (bfloat16 with a head dim that is a multiple of 16 on the tensor
cores, the rest on the CUDA cores), the q-tile rows, warps, K/V stages, a
block's shared memory, the grid and the order of its q tiles. The kernels
run only on the card; these tests hold what the host decides for them, and
that ``flash_fwd`` passes the plan to its C entry point.

The tensor-core route rounds where the CUDA-core one does not: it multiplies
bf16 inputs exactly into float32 sums, scales the float32 scores (with
log2(e), so the softmax runs in base 2), and rounds p to bf16 before P·V
while l sums the float32 p. An emulation of those rounding points in plain
torch is held here to the JAX package's kernel (interpret mode) with the
bars the card check uses (out 3e-2, lse 2e-5, and out's relative L2
error), so the bands are known to hold for the design before the card runs
it. The emulation is a bound on the design's rounding, not a test of the
kernel, which only the card runs.
"""

import contextlib
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.ops import flash_attention as jax_fa
from tensor2robot_tpu_torch.ops import _build
from tensor2robot_tpu_torch.ops import flash_attention as fa

MAX_SMEM = 232448  # dynamic shared memory a block may take on an H100
DTYPES = [torch.float32, torch.bfloat16]
DIMS = list(range(8, 129, 8))
SEQUENTIAL = (8, 80, 1, 64)  # the SNAIL sequential model's attention
LONG_HORIZON = (2, 1024, 8, 8)


def _q_tile(plan, block, bh):
  """The q tile that block ``block`` of the plan's grid runs over ``bh``
  heads, as the plan's order states it (``fwd_q_tile`` in the kernel)."""
  rank = block // bh
  return plan['q_tiles'] - 1 - rank if plan['order'] == 'heaviest_first' \
      else rank


def _plans(shape):
  for dtype in DTYPES:
    for causal in (False, True):
      yield dtype, causal, fa.fwd_plan(shape, dtype, causal)


@pytest.mark.parametrize('d', DIMS)
def test_route_rule(d):
  """The tensor cores take bfloat16 with D % 16 == 0 and aligned operands;
  everything else, float32 always, runs on the CUDA cores."""
  for dtype, causal, plan in _plans((2, 256, 4, d)):
    mma = dtype == torch.bfloat16 and d % 16 == 0
    assert plan['route'] == (fa.ROUTE_MMA if mma else fa.ROUTE_CUDA_CORES)
    unaligned = fa.fwd_plan((2, 256, 4, d), dtype, causal, aligned=False)
    assert unaligned['route'] == fa.ROUTE_CUDA_CORES
    if mma:
      assert (plan['rows'], plan['warps']) == (64, 4)
    else:
      assert plan['rows'] in (16, 32, 64) and plan['warps'] == 8
    assert plan['stages'] == 2


@pytest.mark.parametrize('t', [8, 80, 1000, 1024, 4096, 33792])
@pytest.mark.parametrize('d', DIMS)
def test_shared_memory_fits_a_block(t, d):
  for _, _, plan in _plans((2, t, 4, d)):
    assert 0 < plan['smem'] <= MAX_SMEM, plan


@pytest.mark.parametrize('shape', [(2, 1000, 4, d) for d in DIMS] + [
    (1, 200, 1, 128), (3, 8, 5, 8), (1, 33792, 1, 64), SEQUENTIAL,
    LONG_HORIZON])
def test_ragged_t_is_covered_exactly_once(shape):
  """Every row of every head falls in exactly one block's q tile, also
  where T is not a multiple of the tile (the rows past T are never
  stored)."""
  b, t, h, _ = shape
  for _, _, plan in _plans(shape):
    blocks = plan['grid'][0]
    assert plan['grid'] == (blocks, 1, 1)
    assert blocks == plan['q_tiles'] * b * h
    seen = np.zeros((b * h, t), np.int64)
    for block in range(blocks):
      tile = _q_tile(plan, block, b * h)
      assert 0 <= tile < plan['q_tiles']
      rows = slice(tile * plan['rows'], min(t, (tile + 1) * plan['rows']))
      seen[block % (b * h), rows] += 1
    assert (seen == 1).all()
    assert (plan['q_tiles'] - 1) * plan['rows'] < t <= (
        plan['q_tiles'] * plan['rows'])


@pytest.mark.parametrize('shape', [(2, 1000, 4, d) for d in DIMS] + [
    (2, 4096, 8, 64), (1, 33792, 1, 64), SEQUENTIAL, LONG_HORIZON])
def test_causal_tiles_launch_heaviest_first(shape):
  """Under the causal mask the blocks launch in order of the key tiles
  their q tile sees, most first; without it, in ascending tile order."""
  b, t, h, _ = shape
  nk = -(-t // 64)
  for _, causal, plan in _plans(shape):
    tiles = [_q_tile(plan, block, b * h)
             for block in range(plan['grid'][0])]
    if not causal:
      assert tiles == sorted(tiles)
      continue
    work = [min(-(-(tile + 1) * plan['rows'] // 64), nk) for tile in tiles]
    assert work == sorted(work, reverse=True)
    assert tiles[0] == plan['q_tiles'] - 1


def test_sequential_shape_fills_more_blocks_than_one_per_64_rows():
  """At [8, 80, 1, 64] float32 the 64-row tiles gave 16 blocks for 132
  SMs; the plan takes 16-row tiles, 40 blocks."""
  plan = fa.fwd_plan(SEQUENTIAL, torch.float32, True)
  assert plan['route'] == fa.ROUTE_CUDA_CORES
  assert plan['grid'][0] > 16
  assert (plan['rows'], plan['grid'][0]) == (16, 40)


def test_plans_at_the_measured_shapes():
  """The SNAIL float32 shapes, bench.py's and the streamed bf16 shapes."""
  got = {shape: (p['route'], p['rows'], p['grid'][0]) for shape, p in (
      (LONG_HORIZON, fa.fwd_plan(LONG_HORIZON, torch.float32, True)),
      ((2, 4096, 8, 64), fa.fwd_plan((2, 4096, 8, 64), torch.bfloat16, True)),
      ((1, 33792, 1, 64), fa.fwd_plan((1, 33792, 1, 64), torch.bfloat16,
                                      True)),
      ((1, 2048, 2, 128), fa.fwd_plan((1, 2048, 2, 128), torch.bfloat16,
                                      True)))}
  assert got == {LONG_HORIZON: ('cuda_cores', 32, 512),
                 (2, 4096, 8, 64): ('mma', 64, 1024),
                 (1, 33792, 1, 64): ('mma', 64, 528),
                 (1, 2048, 2, 128): ('mma', 64, 64)}


@pytest.mark.parametrize('shape', [(2, 4096, 8, 64), (1, 33792, 1, 64)])
def test_tensor_cores_take_one_block_shape_under_either_mask(shape):
  """The tensor-core route has one block shape, 4 warps of 16 q rows, at
  every head dim, with and without the causal mask; only the tile order
  differs."""
  for d in (16, 64, 128):
    causal, full = (fa.fwd_plan(shape[:3] + (d,), torch.bfloat16, mask)
                    for mask in (True, False))
    assert causal['route'] == full['route'] == fa.ROUTE_MMA
    assert (causal['warps'], causal['rows']) == (full['warps'],
                                                 full['rows']) == (4, 64)
    assert causal['grid'] == full['grid']
    assert (causal['order'], full['order']) == ('heaviest_first', 'ascending')


@pytest.mark.parametrize('bad', [dict(d=4), dict(d=136), dict(d=12),
                                 dict(dtype=torch.float16)])
def test_plan_refuses_what_the_kernels_do_not_take(bad):
  shape = (1, 64, 2, bad.get('d', 16))
  with pytest.raises(ValueError, match='head dim'):
    fa.fwd_plan(shape, bad.get('dtype', torch.bfloat16), True)


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('causal', [False, True])
def test_wrapper_passes_the_plan_to_the_entry_point(monkeypatch, dtype,
                                                    causal):
  """flash_fwd with the C library, the device checks and the stream replaced
  by stand-ins: it calls t2r_flash_fwd with as many arguments as its
  binding, the plan's route code and rows just before the stream, and its
  counter moves."""
  calls = []

  def entry(name):
    def call(*args):
      calls.append((name, args))
      return 0
    return call

  lib = types.SimpleNamespace(**{name: entry(name)
                                 for name in fa._SIGNATURES})  # pylint: disable=protected-access
  monkeypatch.setattr(_build, 'load', lambda name, signatures: lib)
  monkeypatch.setattr(fa, '_require_qkv', lambda *args: None)
  monkeypatch.setattr(torch.cuda, 'device',
                      lambda device: contextlib.nullcontext())
  monkeypatch.setattr(torch.cuda, 'current_stream',
                      lambda device: types.SimpleNamespace(cuda_stream=0))
  shape = (2, 1000, 4, 64)
  q, k, v = (torch.zeros(shape, dtype=dtype) for _ in range(3))
  before = fa.flash_fwd.launches
  out, lse = fa.flash_fwd(q, k, v, causal)
  assert out.shape == shape and lse.shape == (8, 1, 1000)
  (name, args), = calls
  assert name == 't2r_flash_fwd'
  assert len(args) == len(fa._SIGNATURES[name])  # pylint: disable=protected-access
  plan = fa.fwd_plan(shape, dtype, causal)
  assert args[5:11] == (fa._DTYPE_CODES[dtype], 2, 1000, 4, 64, int(causal))  # pylint: disable=protected-access
  assert args[-3:-1] == ({'cuda_cores': 0, 'mma': 1}[plan['route']],
                         plan['rows'])
  assert fa.flash_fwd.launches == before + 1


def test_plan_mirrors_the_kernel_constants():
  """The planner's tile, stage, padding and SM numbers are the kernel's
  (in the header the forward and the backward share)."""
  source = ''.join((_build.CSRC_DIR / name).read_text() for name in (
      'flash_attention.cuh', 'flash_attention.cu'))
  values = {}
  for key, expr in re.findall(r'^constexpr int (\w+) = ([^;]+);', source,
                              re.MULTILINE):
    values[key] = eval(expr, {}, dict(values))  # pylint: disable=eval-used
  assert values['kTile'] == fa._KEY_ROWS == 64  # pylint: disable=protected-access
  assert values['kStages'] == fa._STAGES  # pylint: disable=protected-access
  assert values['kSms'] == fa._SMS  # pylint: disable=protected-access
  assert values['kBlocksPerSm'] == fa._BLOCKS_PER_SM  # pylint: disable=protected-access
  assert values['kMmaWarps'] == fa._MMA_WARPS  # pylint: disable=protected-access
  assert values['kMmaPad'] == fa._MMA_PAD  # pylint: disable=protected-access
  assert values['kCorePad'] == fa._CORE_PAD  # pylint: disable=protected-access
  assert values['kPStride'] == fa._P_STRIDE  # pylint: disable=protected-access
  assert values['kThreads'] == fa._CORE_THREADS  # pylint: disable=protected-access
  assert (values['kRouteCudaCores'], values['kRouteMma']) == (
      fa._ROUTE_CODES['cuda_cores'], fa._ROUTE_CODES['mma'])  # pylint: disable=protected-access


# ------------------------------------------- the tensor-core rounding points


def emulated_mma_fwd(q, k, v, causal):
  """The tensor-core route's function in plain torch at its rounding
  points: bf16 q, k, v; float32 q·kᵀ (bf16 products are exact in float32);
  the scale, times log2(e), on the float32 scores, so the online softmax
  over 64-key tiles runs in base 2 (p = 2^(s - m)); p rounded to bf16 for
  P·V while l sums the float32 p; lse = m·ln 2 + log l. Returns (out in
  bf16, lse float32 [B*H, 1, T]). It bounds what the design's rounding
  does to the bands; it runs none of the kernel's code."""
  b, t, h, d = q.shape
  qf, kf, vf = (x.float().permute(0, 2, 1, 3).reshape(b * h, t, d)
                for x in (q, k, v))
  scale_log2 = np.float32(1.0 / np.sqrt(d)) * np.float32(np.log2(np.e))
  m = torch.full((b * h, t, 1), -1e30)
  l = torch.zeros((b * h, t, 1))
  acc = torch.zeros((b * h, t, d))
  qpos = torch.arange(t)[:, None]
  for k0 in range(0, t, 64):
    kt, vt = kf[:, k0:k0 + 64], vf[:, k0:k0 + 64]
    s = torch.matmul(qf, kt.transpose(-1, -2)) * float(scale_log2)
    if causal:
      kpos = k0 + torch.arange(kt.shape[1])[None, :]
      s = torch.where(qpos >= kpos, s, torch.full_like(s, -1e30))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    m_sub = torch.clamp_min(m_new, -0.5e30)
    p = torch.exp2(s - m_sub)
    corr = torch.exp2(m - m_sub)
    l = l * corr + p.sum(dim=-1, keepdim=True)
    acc = acc * corr + torch.matmul(p.bfloat16().float(), vt)
    m = m_new
  l = torch.clamp_min(l, 1e-30)
  out = (acc / l).reshape(b, h, t, d).permute(0, 2, 1, 3).bfloat16()
  return out, (m * float(np.log(2.0)) + torch.log(l))[..., 0][:, None, :]


def _jax_reference(shape, causal):
  """Seeded bf16 inputs and the JAX kernel's (out as float32, lse)."""
  rng = np.random.RandomState(shape[1])
  q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
  want_out, res = jax_fa._flash_fwd(  # pylint: disable=protected-access
      *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal, None, None)
  return ((torch.from_numpy(a).bfloat16() for a in (q, k, v)),
          torch.from_numpy(np.array(want_out.astype(jnp.float32))),
          np.asarray(res[4]))


def _rel_l2(got, want):
  want = want.float()
  return float((got.float() - want).norm() / want.norm())


def _out_limit():
  import chip_smoke  # pylint: disable=import-outside-toplevel
  return chip_smoke.FLASH_OUT_REL_L2[torch.bfloat16]


@pytest.mark.parametrize('causal', [False, True], ids=['full', 'causal'])
@pytest.mark.parametrize('shape', [(1, 1024, 2, 64), (2, 256, 4, 16)])
def test_tensor_core_rounding_stays_in_the_bands(shape, causal):
  """The emulated route against the JAX kernel in interpret mode: out within
  3e-2 and lse within 2e-5, each scaled by the larger of 1 and the largest
  magnitude, as chip_smoke.py's flash_band holds the card, and out within
  its relative L2 limit."""
  qkv, want_out, want_lse = _jax_reference(shape, causal)
  got_out, got_lse = emulated_mma_fwd(*qkv, causal)
  assert got_out.dtype == torch.bfloat16
  assert tuple(got_lse.shape) == want_lse.shape
  out_err = float((got_out.float() - want_out).abs().max())
  lse_err = np.abs(got_lse.numpy() - want_lse).max()
  assert out_err <= 3e-2 * max(1.0, float(want_out.abs().max())), out_err
  assert lse_err <= 2e-5 * max(1.0, np.abs(want_lse).max()), lse_err
  assert _rel_l2(got_out, want_out) <= _out_limit()


@pytest.mark.parametrize('causal', [False, True], ids=['full', 'causal'])
@pytest.mark.parametrize('shape', [(1, 1024, 2, 64), (2, 256, 4, 16)])
def test_out_limit_fails_the_controls(shape, causal):
  """The relative L2 limit on out fails the two controls chip_smoke.py
  holds it to: the output rounded through float8_e4m3fn, and the design
  with V taken one 64-row tile early (a K/V ring stage read out of turn).
  Without the mask the float8 output passes flash_band's scaled bar: the
  limit is what catches an error of the size of a typical |out|."""
  qkv, want_out, _ = _jax_reference(shape, causal)
  q, k, v = qkv
  narrow = want_out.to(torch.float8_e4m3fn)
  shifted, _ = emulated_mma_fwd(q, k, torch.roll(v, 64, 1), causal)
  assert _rel_l2(narrow, want_out) > 2 * _out_limit()
  assert _rel_l2(shifted, want_out) > 2 * _out_limit()
  if not causal:
    bar = 3e-2 * max(1.0, float(want_out.abs().max()))
    assert float((narrow.float() - want_out).abs().max()) <= bar
