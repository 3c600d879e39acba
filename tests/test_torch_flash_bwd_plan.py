"""The flash-attention backward's plan and its tensor-core rounding, on the CPU.

``flash_attention.bwd_plan`` decides, from the kernel (``'dq'`` or
``'dkv'``), the shape, the dtype, the mask and the operands' alignment alone,
how ``flash_dq`` and ``flash_dkv`` run a problem: the route (the forward's
rule: bfloat16 with a head dim that is a multiple of 16 on the tensor cores,
the rest on the CUDA cores), the tile rows, warps, stages, a block's shared
memory, the grid and the order of its tiles. The kernels run only on the
card; these tests hold what the host decides for them, and that the
wrappers pass the plan to their C entry points.

The tensor-core route rounds where the JAX kernels do not: the JAX backward
keeps p and ds in float32, while the route rounds ds (and, for dk/dv, pᵀ) to
bf16 as the A fragments of its second products. An emulation of those
rounding points in plain torch is held here to the JAX package's kernels
(interpret mode) with the card check's bars (3e-2 of the largest magnitude,
and ``chip_smoke.FLASH_GRAD_REL_L2``), and the two controls the card check
uses must fail that limit. The emulation bounds the design's rounding; it
runs none of the kernel's code, which only the card runs.
"""

import contextlib
import functools
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
TWO_BLOCKS = 115712  # two blocks and their 1 KB reserves in an SM's 228 KB
DTYPES = [torch.float32, torch.bfloat16]
DIMS = list(range(8, 129, 8))
KERNELS = ['dq', 'dkv']
SEQUENTIAL = (8, 80, 1, 64)  # the SNAIL sequential model's attention
LONG_HORIZON = (2, 1024, 8, 8)
BENCH = (2, 4096, 8, 64)
STREAMED = (1, 33792, 1, 64)


def _plans(kernel, shape):
  for dtype in DTYPES:
    for causal in (False, True):
      yield dtype, causal, fa.bwd_plan(kernel, shape, dtype, causal)


def _tile(kernel, plan, block, bh):
  """The tile that block ``block`` of the plan's grid runs over ``bh``
  heads, as the plan's order states it (``fwd_q_tile`` in dq, key tile
  ``block // bh`` in dk/dv)."""
  rank = block // bh
  if kernel == 'dq' and plan['order'] == 'heaviest_first':
    return plan['tiles'] - 1 - rank
  return rank


def _work(kernel, tile, rows, t):
  """The 64-row tiles one block of ``rows``-row tile ``tile`` streams
  under the causal mask: key tiles up to the diagonal for dq, q tiles from
  the diagonal for dk/dv."""
  nt = -(-t // 64)
  if kernel == 'dq':
    return min(-(-(tile + 1) * rows // 64), nt)
  return nt - tile * rows // 64


@pytest.mark.parametrize('kernel', KERNELS)
@pytest.mark.parametrize('d', DIMS)
def test_route_rule(kernel, d):
  """The forward's rule: the tensor cores take bfloat16 with D % 16 == 0
  and aligned operands; everything else, float32 always, runs on the CUDA
  cores."""
  for dtype, causal, plan in _plans(kernel, (2, 256, 4, d)):
    mma = dtype == torch.bfloat16 and d % 16 == 0
    assert plan['route'] == (fa.ROUTE_MMA if mma else fa.ROUTE_CUDA_CORES)
    assert plan['route'] == fa.fwd_plan((2, 256, 4, d), dtype,
                                        causal)['route']
    unaligned = fa.bwd_plan(kernel, (2, 256, 4, d), dtype, causal,
                            aligned=False)
    assert unaligned['route'] == fa.ROUTE_CUDA_CORES
    if mma:
      assert (plan['rows'], plan['warps']) == (64, 4)
    else:
      assert plan['rows'] in (16, 32, 64) and plan['warps'] == 8
    assert plan['stages'] == 2


@pytest.mark.parametrize('kernel', KERNELS)
@pytest.mark.parametrize('t', [8, 80, 1000, 1024, 4096, 33792])
@pytest.mark.parametrize('d', DIMS)
def test_shared_memory_fits_a_block(kernel, t, d):
  """Every plan fits a block's 227 KB; 32- and 64-row CUDA-core tiles and
  every tensor-core plan let two blocks share an SM."""
  for _, _, plan in _plans(kernel, (2, t, 4, d)):
    assert 0 < plan['smem'] <= MAX_SMEM, plan
    if plan['route'] == fa.ROUTE_MMA or plan['rows'] > 16:
      assert plan['smem'] <= TWO_BLOCKS, plan


@pytest.mark.parametrize('kernel', KERNELS)
def test_dkv_at_d64_lets_two_blocks_share_an_sm(kernel):
  """At D = 64 the old dk/dv kernel took 131 KB (one block an SM); every
  plan that gives the grid two blocks an SM now keeps under half an SM."""
  for shape in (SEQUENTIAL, BENCH, (1, 17408, 1, 64), (2, 1000, 4, 64)):
    for dtype, _, plan in _plans(kernel, shape):
      assert plan['smem'] <= TWO_BLOCKS, (shape, dtype, plan)


@pytest.mark.parametrize('kernel', KERNELS)
@pytest.mark.parametrize('shape', [(2, 1000, 4, d) for d in DIMS] + [
    (1, 200, 1, 128), (3, 8, 5, 8), STREAMED, SEQUENTIAL, LONG_HORIZON])
def test_ragged_t_is_covered_exactly_once(kernel, shape):
  """Every row of every head falls in exactly one block's tile (q rows for
  dq, key rows for dk/dv), also where T is not a multiple of the tile."""
  b, t, h, _ = shape
  for _, _, plan in _plans(kernel, shape):
    blocks = plan['grid'][0]
    assert plan['grid'] == (blocks, 1, 1)
    assert blocks == plan['tiles'] * b * h
    seen = np.zeros((b * h, t), np.int64)
    for block in range(blocks):
      tile = _tile(kernel, plan, block, b * h)
      assert 0 <= tile < plan['tiles']
      rows = slice(tile * plan['rows'], min(t, (tile + 1) * plan['rows']))
      seen[block % (b * h), rows] += 1
    assert (seen == 1).all()
    assert (plan['tiles'] - 1) * plan['rows'] < t <= (
        plan['tiles'] * plan['rows'])


@pytest.mark.parametrize('kernel', KERNELS)
@pytest.mark.parametrize('shape', [(2, 1000, 4, d) for d in (8, 24, 64, 128)]
                         + [BENCH, STREAMED, SEQUENTIAL, LONG_HORIZON])
def test_causal_tiles_launch_heaviest_first(kernel, shape):
  """Under the causal mask the blocks launch in order of the 64-row tiles
  they stream, most first: dq's last q tile, dk/dv's first key tile.
  Without it, in ascending tile order."""
  b, t, h, _ = shape
  for _, causal, plan in _plans(kernel, shape):
    tiles = [_tile(kernel, plan, block, b * h)
             for block in range(plan['grid'][0])]
    if not causal:
      assert plan['order'] == 'ascending' and tiles == sorted(tiles)
      continue
    assert plan['order'] == 'heaviest_first'
    work = [_work(kernel, tile, plan['rows'], t) for tile in tiles]
    assert work == sorted(work, reverse=True)
    assert tiles[0] == (plan['tiles'] - 1 if kernel == 'dq' else 0)


def test_plans_at_the_timed_shapes():
  """Route, rows, blocks and shared memory at the SNAIL float32 shapes and
  at bench.py's and the streamed bf16 shapes: 16-row tiles (40 blocks, not
  the 16 of one block per 64 rows) at the sequential shape, 32-row tiles
  (512 blocks) at long-horizon."""
  got = {(kernel, shape): (p['route'], p['rows'], p['grid'][0], p['smem'])
         for kernel in KERNELS
         for shape, dtype in ((LONG_HORIZON, torch.float32),
                              (SEQUENTIAL, torch.float32),
                              (BENCH, torch.bfloat16),
                              (STREAMED, torch.bfloat16))
         for p in (fa.bwd_plan(kernel, shape, dtype, True),)}
  assert got == {
      ('dq', LONG_HORIZON): ('cuda_cores', 32, 512, 24064),
      ('dq', SEQUENTIAL): ('cuda_cores', 16, 40, 82688),
      ('dq', BENCH): ('mma', 64, 1024, 55296),
      ('dq', STREAMED): ('mma', 64, 528, 55296),
      ('dkv', LONG_HORIZON): ('cuda_cores', 32, 512, 33280),
      ('dkv', SEQUENTIAL): ('cuda_cores', 16, 40, 87808),
      ('dkv', BENCH): ('mma', 64, 1024, 56320),
      ('dkv', STREAMED): ('mma', 64, 528, 56320)}


@pytest.mark.parametrize('bad', [dict(d=4), dict(d=136), dict(d=12),
                                 dict(dtype=torch.float16)])
@pytest.mark.parametrize('kernel', KERNELS)
def test_plan_refuses_what_the_kernels_do_not_take(kernel, bad):
  shape = (1, 64, 2, bad.get('d', 16))
  with pytest.raises(ValueError, match='head dim'):
    fa.bwd_plan(kernel, shape, bad.get('dtype', torch.bfloat16), True)


def test_plan_refuses_another_kernel():
  with pytest.raises(ValueError, match='plans'):
    fa.bwd_plan('fwd', (1, 64, 2, 16), torch.bfloat16, True)


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('kernel', KERNELS)
def test_wrapper_passes_the_plan_to_the_entry_point(monkeypatch, kernel,
                                                    dtype, causal):
  """flash_dq / flash_dkv with the C library, the device checks and the
  stream replaced by stand-ins: each calls its entry point with as many
  arguments as its binding, the plan's route code and rows just before the
  stream, and its counter moves."""
  calls = []

  def entry(name):
    def call(*args):
      calls.append((name, args))
      return 0
    return call

  lib = types.SimpleNamespace(**{name: entry(name)
                                 for name in fa._BWD_SIGNATURES})  # pylint: disable=protected-access
  monkeypatch.setattr(_build, 'load', lambda name, signatures: lib)
  monkeypatch.setattr(fa, '_require_qkv', lambda *args: None)
  monkeypatch.setattr(fa, '_require_stats', lambda *args: None)
  monkeypatch.setattr(torch.cuda, 'device',
                      lambda device: contextlib.nullcontext())
  monkeypatch.setattr(torch.cuda, 'current_stream',
                      lambda device: types.SimpleNamespace(cuda_stream=0))
  shape = (2, 1000, 4, 64)
  q, k, v, do = (torch.zeros(shape, dtype=dtype) for _ in range(4))
  lse, delta = (torch.zeros((8, 1, 1000)) for _ in range(2))
  wrapper = getattr(fa, f'flash_{kernel}')
  before = wrapper.launches
  got = wrapper(q, k, v, do, lse, delta, causal)
  outputs = (got,) if kernel == 'dq' else got
  assert all(x.shape == shape and x.dtype == dtype for x in outputs)
  (name, args), = calls
  assert name == f't2r_flash_{kernel}'
  assert len(args) == len(fa._BWD_SIGNATURES[name])  # pylint: disable=protected-access
  pointers = 6 + len(outputs)
  plan = fa.bwd_plan(kernel, shape, dtype, causal)
  assert args[pointers:pointers + 6] == (fa._DTYPE_CODES[dtype], 2, 1000, 4,  # pylint: disable=protected-access
                                         64, int(causal))
  assert args[-3:-1] == ({'cuda_cores': 0, 'mma': 1}[plan['route']],
                         plan['rows'])
  assert wrapper.launches == before + 1


def test_plan_mirrors_the_kernel_constants():
  """The planner's two-block shared-memory budget and the backward's tile
  and padding numbers are the kernels' (the backward's source and the
  header it shares with the forward); each C entry of the backward takes
  the route code and rows just before the stream."""
  source = ''.join((_build.CSRC_DIR / name).read_text() for name in (
      'flash_attention.cuh', 'flash_attention_bwd.cu'))
  values = {}
  for key, expr in re.findall(r'^constexpr int (\w+) = ([^;]+);', source,
                              re.MULTILINE):
    values[key] = eval(expr, {}, dict(values))  # pylint: disable=eval-used
  assert values['kTwoBlockSmem'] == fa._TWO_BLOCK_SMEM == TWO_BLOCKS  # pylint: disable=protected-access
  assert values['kTile'] == fa._KEY_ROWS  # pylint: disable=protected-access
  assert values['kPStride'] == fa._P_STRIDE  # pylint: disable=protected-access
  assert values['kCorePad'] == fa._CORE_PAD  # pylint: disable=protected-access
  assert values['kMmaPad'] == fa._MMA_PAD  # pylint: disable=protected-access
  assert values['kMmaWarps'] == fa._MMA_WARPS  # pylint: disable=protected-access
  for name in ('t2r_flash_dq', 't2r_flash_dkv'):
    params = re.search(name + r'\(([^)]*)\)', source).group(1).split(',')
    assert [p.split()[-1] for p in params[-3:]] == ['route', 'rows',
                                                    'stream']


# ------------------------------------------- the tensor-core rounding points


def emulated_mma_bwd(q, k, v, do, causal, early=None):
  """The tensor-core route's dq, dk, dv in plain torch at its rounding
  points, from bf16 q, k, v, do: the forward's float32 lse and its output
  rounded to bf16 (the saved out), delta = rowsum(dO ⊙ out) in float32;
  float32 scores and dP (bf16 products are exact in float32); p =
  2^(s·scale·log2 e − lse·log2 e), 0 where masked; ds = p·(dP − delta) in
  float32; ds and p rounded to bf16 as the A operands of dQ = dS·K·scale,
  dK = dSᵀ·Q·scale and dV = Pᵀ·dO, summed in float32 and rounded to bf16.
  ``early`` ('q' or 'do') takes that operand one 64-row tile early in the
  backward's products (a ring stage read out of turn): a control. It bounds
  what the design's rounding does to the bands; it runs none of the
  kernels' code."""
  b, t, h, d = q.shape

  def fold(x):
    return x.float().permute(0, 2, 1, 3).reshape(b * h, t, d)

  def unfold(x):
    return x.reshape(b, h, t, d).permute(0, 2, 1, 3).bfloat16()

  qf, kf, vf, dof = (fold(x) for x in (q, k, v, do))
  scale = float(np.float32(1.0 / np.sqrt(d)))
  log2e = float(np.float32(np.log2(np.e)))
  scale_log2 = float(np.float32(scale) * np.float32(log2e))
  visible = torch.ones(t, t, dtype=torch.bool)
  if causal:
    visible = torch.tril(visible)
  s = torch.matmul(qf, kf.transpose(-1, -2))
  masked = torch.where(visible, s * scale, torch.full_like(s, -1e30))
  lse = torch.logsumexp(masked, dim=-1, keepdim=True)
  out = torch.matmul(torch.softmax(masked, dim=-1), vf).bfloat16().float()
  delta = (dof * out).sum(dim=-1, keepdim=True)
  if early == 'q':
    qf = torch.roll(qf, 64, 1)
    s = torch.matmul(qf, kf.transpose(-1, -2))
  elif early == 'do':
    dof = torch.roll(dof, 64, 1)
  p = torch.exp2(s * scale_log2 - lse * log2e)
  p = torch.where(visible, p, torch.zeros_like(p))
  ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
  p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
  return (unfold(torch.matmul(ds16, kf) * scale),
          unfold(torch.matmul(ds16.transpose(-1, -2), qf) * scale),
          unfold(torch.matmul(p16.transpose(-1, -2), dof)))


@functools.lru_cache(maxsize=None)
def _jax_reference(shape, causal):
  """Seeded bf16 inputs and the JAX kernels' (dq, dk, dv) as float32."""
  rng = np.random.RandomState(shape[1])
  arrays = [rng.randn(*shape).astype(np.float32) for _ in range(4)]
  q, k, v, g = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
  _, res = jax_fa._flash_fwd(q, k, v, causal, None, None)  # pylint: disable=protected-access
  want = jax_fa._flash_bwd(causal, None, None, res, g)  # pylint: disable=protected-access
  return (tuple(torch.from_numpy(a).bfloat16() for a in arrays),
          tuple(torch.from_numpy(np.array(x.astype(jnp.float32)))
                for x in want))


def _rel_l2(got, want):
  want = want.float()
  return float((got.float() - want).norm() / want.norm())


def _grad_limit():
  import chip_smoke  # pylint: disable=import-outside-toplevel
  return chip_smoke.FLASH_GRAD_REL_L2[torch.bfloat16]


@pytest.mark.parametrize('causal', [False, True], ids=['full', 'causal'])
@pytest.mark.parametrize('shape', [(1, 1024, 2, 64), (2, 256, 4, 16)])
def test_tensor_core_rounding_stays_in_the_bands(shape, causal):
  """The emulated route against the JAX kernels in interpret mode: dq, dk
  and dv within 3e-2 times the larger of 1 and the largest magnitude, as
  chip_smoke.py's flash_band holds the card, and within the gradient
  relative L2 limit."""
  inputs, want = _jax_reference(shape, causal)
  got = emulated_mma_bwd(*inputs, causal)
  for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
    assert g.dtype == torch.bfloat16 and g.shape == w.shape
    err = float((g.float() - w).abs().max())
    assert err <= 3e-2 * max(1.0, float(w.abs().max())), (name, err)
    assert _rel_l2(g, w) <= _grad_limit(), (name, _rel_l2(g, w))


@pytest.mark.parametrize('causal', [False, True], ids=['full', 'causal'])
@pytest.mark.parametrize('shape', [(1, 1024, 2, 64), (2, 256, 4, 16)])
def test_grad_limit_fails_the_controls(shape, causal):
  """The gradient relative L2 limit fails the controls chip_smoke.py holds
  it to, each by more than 2x: the gradients rounded through float8_e4m3fn,
  and the design with dO or Q taken one 64-row tile early."""
  inputs, want = _jax_reference(shape, causal)
  early_q = emulated_mma_bwd(*inputs, causal, early='q')
  early_do = emulated_mma_bwd(*inputs, causal, early='do')
  for i, w in enumerate(want):
    assert _rel_l2(w.to(torch.float8_e4m3fn), w) > 2 * _grad_limit()
    assert _rel_l2(early_q[i], w) > 2 * _grad_limit()
    assert _rel_l2(early_do[i], w) > 2 * _grad_limit()
