"""Flash attention: CUDA kernels for the card, plain versions for the CPU.

The port's counterpart of ``tensor2robot_tpu/ops/flash_attention.py``:
[B, T, H, D] attention with O(T·D) memory, the online-softmax forward and
the FlashAttention-2 backward (dq in a q-tile grid, dk/dv in a k-tile grid,
``delta = rowsum(dO ⊙ O)`` precomputed in plain torch).

* :func:`flash_attention` goes through the autograd Function
  :class:`FlashAttention` on every device. Its forward is the custom op
  ``t2r::flash_fwd`` (:func:`flash_fwd_op`), which dispatches on the
  tensors' device (``ops/_dispatch.py``): a CUDA tensor launches
  :func:`flash_fwd` (``csrc/flash_attention.cu``), a CPU tensor runs
  :func:`plain_flash_fwd`. As one op it is one node of an exported
  serving program. Its backward dispatches the same way with
  :func:`flash_dq` / :func:`flash_dkv` and their plain versions; it runs
  only in training.
* :func:`fwd_plan` and :func:`bwd_plan` choose the forward's and the
  backward kernels' route and launch from the shape, dtype and mask alone,
  as the C entries do (they refuse any other plan): bfloat16 with a head
  dim that is a multiple of 16 runs on the tensor cores (``mma.sync``),
  float32 and the other bfloat16 head dims on the CUDA cores, with tiles
  of 16 to 64 rows planned to fill the card.
* The plain versions transcribe the JAX package's staged kernels
  (``_fwd_kernel``, ``_dq_kernel``, ``_dkv_kernel``) block by block, with
  the blocks :func:`_resolve_blocks` picks and the same clamps. The
  streamed TPU kernels compute the same function in another order of
  grid steps; the CUDA kernels tile K/V through shared memory in every
  regime, so one kernel per function covers both.
* :func:`is_supported`, :func:`_check`, :func:`_use_streamed` and
  :func:`_resolve_blocks` keep the JAX package's thresholds and messages,
  with the 8-row block minimum the package applies off-TPU (the 128-row
  minimum was Mosaic's lane tile, which a CUDA kernel does not have).

Layout: the kernels read q, k, v and the cotangent through their
[B, T, H, D] strides (no head fold copy); the logsumexp is float32
[B*H, 1, T], as in the JAX package.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from tensor2robot_tpu_torch.ops import _build
from tensor2robot_tpu_torch.ops import _dispatch as dispatch

_NEG_INF = -1e30  # large-negative instead of -inf, as in the JAX kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The forward's library (csrc/flash_attention.cu) and the backward's
# (csrc/flash_attention_bwd.cu): pointers, dtype, B, T, H, D, causal, the
# scale, the plan's route code and rows, the stream.
_SIGNATURES = {
    't2r_flash_fwd': [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 +
                     [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p],
}
_BWD_SIGNATURES = {
    't2r_flash_dq': [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 +
                    [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    't2r_flash_dkv': [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 +
                     [ctypes.c_float] + [ctypes.c_int] * 2 +
                     [ctypes.c_void_p],
}

DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 512

# The JAX package's regime switch: whole-sequence K/V staging fits a TPU
# core's VMEM up to 2·t·d·itemsize ≤ 8 MB; past it the streamed kernels
# take over. Kept so the block defaults (and the function's summation
# order) resolve as in the JAX package.
_MAX_STAGED_KV_BYTES = 8 * 1024 * 1024
_STREAMED_BLOCK = 1024
_MIN_BLOCK = 8


def _use_streamed(t: int, d: int, itemsize: int = 2) -> bool:
  return 2 * t * d * itemsize > _MAX_STAGED_KV_BYTES


def _resolve_blocks(t: int, d: int, block_q: Optional[int],
                    block_k: Optional[int],
                    itemsize: int = 2) -> Tuple[int, int]:
  """Regime-dependent block defaults (None → auto)."""
  if block_q is None or block_k is None:
    if _use_streamed(t, d, itemsize):
      best = next((blk for blk in (_STREAMED_BLOCK, 512, 256, 128, 8)
                   if t % blk == 0), DEFAULT_BLOCK_Q)
      block_q = block_q if block_q is not None else best
      block_k = block_k if block_k is not None else best
    else:
      block_q = block_q if block_q is not None else DEFAULT_BLOCK_Q
      block_k = block_k if block_k is not None else DEFAULT_BLOCK_K
  return block_q, block_k


def is_supported(t: int, d: int, block_q: Optional[int] = None,
                 block_k: Optional[int] = None, itemsize: int = 2) -> bool:
  """Whether :func:`flash_attention` handles a [_, t, _, d] problem: head
  dim a multiple of 8 up to 128, ``t`` divisible by the resolved blocks,
  blocks multiples of 8. ``itemsize`` is the input's, so the regime (and
  with it the blocks) resolves as the call will."""
  block_q, block_k = _resolve_blocks(t, d, block_q, block_k, itemsize)
  bq, bk = min(block_q, t), min(block_k, t)
  return (0 < d <= 128 and d % 8 == 0 and
          t % bq == 0 and t % bk == 0 and
          bq % _MIN_BLOCK == 0 and bk % _MIN_BLOCK == 0)


def _check(q: torch.Tensor, block_q, block_k) -> Tuple[int, int]:
  _, t, _, d = q.shape
  if d > 128:
    raise ValueError(f'flash_attention requires head dim <= 128, got {d}')
  itemsize = q.dtype.itemsize
  block_q, block_k = _resolve_blocks(t, d, block_q, block_k, itemsize)
  bq, bk = min(block_q, t), min(block_k, t)
  if t % bq or t % bk:
    raise ValueError(
        f'sequence length {t} must be divisible by block sizes '
        f'({bq}, {bk}); pad the sequence.')
  if not is_supported(t, d, block_q, block_k, itemsize=itemsize):
    raise ValueError(
        f'flash_attention unsupported for T={t}, D={d} '
        f'(alignment; see is_supported).')
  return bq, bk


def _scale(d: int) -> float:
  return 1.0 / math.sqrt(d)


# ------------------------------------------------------ the forward's plan

ROUTE_MMA = 'mma'
ROUTE_CUDA_CORES = 'cuda_cores'
_ROUTE_CODES = {ROUTE_CUDA_CORES: 0, ROUTE_MMA: 1}
# csrc/flash_attention.cuh's constants: K/V tiles of 64 rows in a ring of 2
# stages; a grid aims at 2 blocks on each of an H100's 132 SMs; 4 warps (64
# q rows) a block on the tensor cores; shared rows padded by 16 bytes (8
# bf16 on the tensor-core route, 4 floats on the CUDA-core route, whose P
# rows hold 64 + 2 floats); 256 threads a block on the CUDA cores.
_KEY_ROWS = 64
_STAGES = 2
_SMS = 132
_BLOCKS_PER_SM = 2
_MMA_WARPS = 4
_MMA_PAD = 8
_CORE_PAD = 4
_P_STRIDE = _KEY_ROWS + 2
_CORE_THREADS = 256
# csrc/flash_attention_bwd.cu's kTwoBlockSmem: the backward's CUDA-core
# tiles of 32 or 64 rows need two blocks (each with its 1 KB reserve) to fit
# an H100 SM's 228 KB of shared memory.
_TWO_BLOCK_SMEM = 113 * 1024
BWD_KERNELS = ('dq', 'dkv')


def _cdiv(a: int, b: int) -> int:
  return -(-a // b)


def fwd_plan(shape, dtype: torch.dtype, causal: bool,
             aligned: bool = True) -> dict:
  """How :func:`flash_fwd` runs a [B, T, H, D] problem, from the shape, the
  dtype, the mask and whether q, k, v and out are 16-byte aligned: the
  choice ``fwd_route`` (``csrc/flash_attention.cuh``) and ``fwd_rows``
  (``csrc/flash_attention.cu``) make (the C entry refuses any other).

  Returns the ``route`` (``'mma'``: bfloat16 with D % 16 == 0 and aligned
  operands on the tensor cores; ``'cuda_cores'``: everything else), the
  q-tile ``rows`` (mma: 64, 4 warps of 16 rows; CUDA cores: the tallest
  of 64 and 32 rows that gives two blocks an SM, else 16), the ``warps``
  of a block, the ``stages`` of 64-row K/V tiles, a block's shared memory
  ``smem`` in bytes, the one-dimensional ``grid`` (q tiles times B*H,
  tile-major), the ``q_tiles`` and the tile ``order``
  (``'heaviest_first'`` under the causal mask: block i runs q tile
  ``q_tiles - 1 - i // (B*H)``; else ``'ascending'``, q tile
  ``i // (B*H)``). Raises for a problem the kernels do not take.
  """
  b, t, h, d = (int(x) for x in shape)
  if dtype not in _DTYPE_CODES or not (8 <= d <= 128 and d % 8 == 0):
    raise ValueError(f'flash_fwd takes float32 or bfloat16 with a head dim '
                     f'in 8..128, a multiple of 8; got {dtype}, D={d}.')
  bh = b * h
  want = _BLOCKS_PER_SM * _SMS
  if dtype == torch.bfloat16 and d % 16 == 0 and aligned:
    rows = 16 * _MMA_WARPS
    plan = dict(route=ROUTE_MMA, warps=_MMA_WARPS,
                smem=2 * (rows + 2 * _STAGES * _KEY_ROWS) * (d + _MMA_PAD))
  else:
    rows = next((r for r in (64, 32) if bh * _cdiv(t, r) >= want), 16)
    plan = dict(route=ROUTE_CUDA_CORES, warps=_CORE_THREADS // 32,
                smem=4 * ((rows + 2 * _STAGES * _KEY_ROWS) * (d + _CORE_PAD) +
                          rows * _P_STRIDE))
  q_tiles = _cdiv(t, rows)
  plan.update(rows=rows, stages=_STAGES, q_tiles=q_tiles,
              grid=(q_tiles * bh, 1, 1),
              order='heaviest_first' if causal else 'ascending')
  return plan


def _bwd_smem(kernel: str, route: str, d: int, rows: int) -> int:
  """``bwd_smem`` of ``csrc/flash_attention_bwd.cu``: a block's two
  operands (Q and dO for dq, K and V for dk/dv) and the two-stage ring of
  the streamed pair; in bf16 on the tensor cores, with the ring's lse and
  delta for dk/dv; in float32 on the CUDA cores, with dS (dq) or Pᵀ and
  dSᵀ (dk/dv) rows of 64 + 2 floats and the statistics."""
  dkv = kernel == 'dkv'
  operands = 2 * rows + 2 * _STAGES * _KEY_ROWS
  if route == ROUTE_MMA:
    return 2 * operands * (d + _MMA_PAD) + (
        4 * 2 * _STAGES * _KEY_ROWS if dkv else 0)
  stats = 2 * _STAGES * _KEY_ROWS if dkv else 2 * rows
  return 4 * (operands * (d + _CORE_PAD) + (2 if dkv else 1) * rows *
              _P_STRIDE + stats)


def bwd_plan(kernel: str, shape, dtype: torch.dtype, causal: bool,
             aligned: bool = True) -> dict:
  """How :func:`flash_dq` (``kernel='dq'``) or :func:`flash_dkv`
  (``'dkv'``) runs a [B, T, H, D] problem: the choice ``fwd_route`` and
  ``bwd_rows`` make in ``csrc/flash_attention_bwd.cu`` (the C entries
  refuse any other). ``aligned``: q, k, v, the cotangent and the outputs
  are 16-byte aligned.

  Returns the ``route`` (the forward's rule: ``'mma'`` for bfloat16 with
  D % 16 == 0 and aligned operands, else ``'cuda_cores'``), the tile
  ``rows`` (q rows for dq, key rows for dk/dv; mma: 64, 4 warps of 16
  rows; CUDA cores: the tallest of 64 and 32 rows that gives two blocks an
  SM and whose shared memory lets two blocks share one, else 16), the
  ``warps`` of a block, the ``stages`` of streamed 64-row tiles, a block's
  shared memory ``smem`` in bytes, the one-dimensional ``grid`` (tiles
  times B*H, tile-major), the ``tiles`` and their ``order``: without the
  mask ``'ascending'`` (block i runs tile ``i // (B*H)``); under it
  ``'heaviest_first'``, which for dq is the last q tile first (tile
  ``tiles - 1 - i // (B*H)``) and for dk/dv key tile 0 first, the one every
  q tile sees (tile ``i // (B*H)``). Raises for a problem the kernels do
  not take.
  """
  if kernel not in BWD_KERNELS:
    raise ValueError(f'bwd_plan plans {BWD_KERNELS}, got {kernel!r}.')
  b, t, h, d = (int(x) for x in shape)
  if dtype not in _DTYPE_CODES or not (8 <= d <= 128 and d % 8 == 0):
    raise ValueError(f'flash_{kernel} takes float32 or bfloat16 with a head '
                     f'dim in 8..128, a multiple of 8; got {dtype}, D={d}.')
  bh = b * h
  want = _BLOCKS_PER_SM * _SMS
  if dtype == torch.bfloat16 and d % 16 == 0 and aligned:
    route, rows, warps = ROUTE_MMA, 16 * _MMA_WARPS, _MMA_WARPS
  else:
    route, warps = ROUTE_CUDA_CORES, _CORE_THREADS // 32
    rows = next((r for r in (64, 32) if bh * _cdiv(t, r) >= want and
                 _bwd_smem(kernel, route, d, r) <= _TWO_BLOCK_SMEM), 16)
  tiles = _cdiv(t, rows)
  return dict(route=route, rows=rows, warps=warps, stages=_STAGES,
              smem=_bwd_smem(kernel, route, d, rows), tiles=tiles,
              grid=(tiles * bh, 1, 1),
              order='heaviest_first' if causal else 'ascending')


# ----------------------------------------------------- plain versions


def _fold(x: torch.Tensor) -> torch.Tensor:
  """[B, T, H, D] → float32 [B*H, T, D]."""
  b, t, h, d = x.shape
  return x.float().permute(0, 2, 1, 3).reshape(b * h, t, d)


def _unfold(x: torch.Tensor, b: int, h: int, dtype) -> torch.Tensor:
  bh, t, d = x.shape
  return x.reshape(b, h, t, d).permute(0, 2, 1, 3).to(dtype).contiguous()


def _scores(q, k, q0, k0, causal, scale=None):
  """Scaled (optional) masked q·kᵀ block scores, (q0, k0) the blocks'
  offsets: the JAX package's ``_scores``."""
  s = torch.matmul(q, k.transpose(-1, -2))
  if scale is not None:
    s = s * scale
  if causal:
    bq, bk = s.shape[-2:]
    qpos = q0 + torch.arange(bq, device=s.device)[:, None]
    kpos = k0 + torch.arange(bk, device=s.device)[None, :]
    s = torch.where(qpos >= kpos, s, torch.full_like(s, _NEG_INF))
  return s


def _online_softmax_step(s, m, l, acc, v):
  """One flash accumulator update from a block of scores."""
  m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
  # Rows with every key masked so far have m_new == _NEG_INF; clamp the
  # subtrahend so exp(_NEG_INF - m_new) stays 0 instead of exp(0) = 1.
  m_sub = torch.clamp_min(m_new, 0.5 * _NEG_INF)
  p = torch.exp(s - m_sub)
  corr = torch.exp(m - m_sub)
  l = l * corr + p.sum(dim=-1, keepdim=True)
  acc = acc * corr + torch.matmul(p, v)
  return m_new, l, acc


def _ds_block(s, lse, do, v, delta):
  """FlashAttention-2 backward core: (p, ds) from the saved logsumexp."""
  p = torch.exp(s - lse)
  dp = torch.matmul(do, v.transpose(-1, -2))
  return p, p * (dp - delta)


def plain_flash_fwd(q, k, v, causal: bool = False,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None):
  """The forward kernel's function in plain PyTorch, on any device.

  Returns (out [B, T, H, D] in q's dtype, lse float32 [B*H, 1, T]).
  """
  b, t, h, d = q.shape
  bq, bk = _check(q, block_q, block_k)
  scale = _scale(d)
  qf, kf, vf = _fold(q) * scale, _fold(k), _fold(v)
  nk = t // bk
  outs, lses = [], []
  for qb in range(t // bq):
    qblk = qf[:, qb * bq:(qb + 1) * bq]
    m = qblk.new_full((b * h, bq, 1), _NEG_INF)
    l = qblk.new_zeros((b * h, bq, 1))
    acc = qblk.new_zeros((b * h, bq, d))
    # Causal: only key blocks at/before this q block's diagonal contribute.
    nk_eff = min((qb * bq + bq + bk - 1) // bk, nk) if causal else nk
    for i in range(nk_eff):
      s = _scores(qblk, kf[:, i * bk:(i + 1) * bk], qb * bq, i * bk, causal)
      m, l, acc = _online_softmax_step(s, m, l, acc,
                                       vf[:, i * bk:(i + 1) * bk])
    l = torch.clamp_min(l, 1e-30)
    outs.append(acc / l)
    lses.append((m + torch.log(l))[..., 0])
  out = _unfold(torch.cat(outs, dim=1), b, h, q.dtype)
  return out, torch.cat(lses, dim=1)[:, None, :]


def plain_flash_dq(q, k, v, do, lse, delta, causal: bool = False,
                   block_q: Optional[int] = None,
                   block_k: Optional[int] = None):
  """The dq kernel's function in plain PyTorch: ``lse`` and ``delta`` are
  float32 [B*H, 1, T]; returns dq [B, T, H, D] in q's dtype."""
  b, t, h, d = q.shape
  bq, bk = _check(q, block_q, block_k)
  scale = _scale(d)
  qf, kf, vf, dof = _fold(q), _fold(k), _fold(v), _fold(do)
  lse, delta = lse[:, 0, :, None], delta[:, 0, :, None]
  nk = t // bk
  dqs = []
  for qb in range(t // bq):
    rows = slice(qb * bq, (qb + 1) * bq)
    dq = qf.new_zeros((b * h, bq, d))
    nk_eff = min((qb * bq + bq + bk - 1) // bk, nk) if causal else nk
    for i in range(nk_eff):
      kblk = kf[:, i * bk:(i + 1) * bk]
      s = _scores(qf[:, rows], kblk, qb * bq, i * bk, causal, scale)
      _, ds = _ds_block(s, lse[:, rows], dof[:, rows],
                        vf[:, i * bk:(i + 1) * bk], delta[:, rows])
      dq = dq + torch.matmul(ds, kblk)
    dqs.append(dq * scale)
  return _unfold(torch.cat(dqs, dim=1), b, h, q.dtype)


def plain_flash_dkv(q, k, v, do, lse, delta, causal: bool = False,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None):
  """The dk/dv kernel's function in plain PyTorch; returns (dk, dv)
  [B, T, H, D] in k's and v's dtypes."""
  b, t, h, d = q.shape
  bq, bk = _check(q, block_q, block_k)
  scale = _scale(d)
  qf, kf, vf, dof = _fold(q), _fold(k), _fold(v), _fold(do)
  lse, delta = lse[:, 0, :, None], delta[:, 0, :, None]
  nq = t // bq
  dks, dvs = [], []
  for kb in range(t // bk):
    keys = slice(kb * bk, (kb + 1) * bk)
    dk = kf.new_zeros((b * h, bk, d))
    dv = kf.new_zeros((b * h, bk, d))
    # Causal: only q blocks at/after this k block's diagonal contribute.
    start = (kb * bk) // bq if causal else 0
    for i in range(start, nq):
      rows = slice(i * bq, (i + 1) * bq)
      s = _scores(qf[:, rows], kf[:, keys], i * bq, kb * bk, causal, scale)
      p, ds = _ds_block(s, lse[:, rows], dof[:, rows], vf[:, keys],
                        delta[:, rows])
      dv = dv + torch.matmul(p.transpose(-1, -2), dof[:, rows])
      dk = dk + torch.matmul(ds.transpose(-1, -2), qf[:, rows])
    dks.append(dk * scale)
    dvs.append(dv)
  return (_unfold(torch.cat(dks, dim=1), b, h, k.dtype),
          _unfold(torch.cat(dvs, dim=1), b, h, v.dtype))


def flash_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
  """``rowsum(dO ⊙ O)`` in float32 as [B*H, 1, T], computed outside the
  kernels as the JAX package does."""
  b, t, h, _ = out.shape
  delta = (do.float() * out.float()).sum(dim=-1)  # [B, T, H]
  return delta.permute(0, 2, 1).reshape(b * h, 1, t).contiguous()


# ------------------------------------------------------- CUDA kernels


def _require_cuda(what: str, *tensors: torch.Tensor) -> None:
  device = tensors[0].device
  if device.type != 'cuda' or any(x.device != device for x in tensors):
    raise ValueError(
        f'{what} takes CUDA tensors on one device, got '
        f'{[str(x.device) for x in tensors]}.')
  if not all(x.is_contiguous() for x in tensors):
    raise ValueError(f'{what} takes contiguous tensors.')


def _require_qkv(what: str, q, k, v, *like) -> None:
  _require_cuda(what, q, k, v, *like)
  if q.dim() != 4 or q.dtype not in _DTYPE_CODES:
    raise ValueError(
        f'{what} takes [B, T, H, D] float32 or bfloat16 tensors, got '
        f'{tuple(q.shape)} {q.dtype}.')
  for x in (k, v) + like:
    if x.shape != q.shape or x.dtype != q.dtype:
      raise ValueError(
          f'{what}: every [B, T, H, D] operand must match q '
          f'{tuple(q.shape)} {q.dtype}, got {tuple(x.shape)} {x.dtype}.')
  d = q.shape[3]
  if not (8 <= d <= 128 and d % 8 == 0):
    raise ValueError(f'{what} takes a head dim in 8..128, a multiple of 8, '
                     f'got {d}.')


def _require_stats(what: str, q, *stats) -> None:
  b, t, h, _ = q.shape
  for x in stats:
    if (x.dtype != torch.float32 or tuple(x.shape) != (b * h, 1, t) or
        x.device != q.device or not x.is_contiguous()):
      raise ValueError(
          f'{what} takes contiguous float32 [B*H, 1, T] = {(b * h, 1, t)} '
          f'statistics on {q.device}, got {tuple(x.shape)} {x.dtype} on '
          f'{x.device}.')


def _launch(library: str, signatures, fn_name: str, what: str,
            q: torch.Tensor, causal: bool, pointers, plan) -> None:
  b, t, h, d = q.shape
  lib = _build.load(library, signatures)
  with torch.cuda.device(q.device):
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = getattr(lib, fn_name)(
        *(x.data_ptr() for x in pointers), _DTYPE_CODES[q.dtype], b, t, h, d,
        int(bool(causal)), _scale(d), *plan, stream)
  _build.check(lib, status, what)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
  """Launches the forward kernel (``csrc/flash_attention.cu``) on the
  current stream, on the route :func:`fwd_plan` chooses: bfloat16 with a
  head dim that is a multiple of 16 on the tensor cores, the rest on the
  CUDA cores. q, k, v: contiguous [B, T, H, D] float32 or bfloat16 on one
  CUDA device. Returns (out in q's dtype, lse float32 [B*H, 1, T]). Raises
  on any other input, and when the launch reports an error."""
  _require_qkv('flash_fwd', q, k, v)
  b, t, h, _ = q.shape
  out = torch.empty_like(q)
  lse = torch.empty((b * h, 1, t), dtype=torch.float32, device=q.device)
  plan = fwd_plan(q.shape, q.dtype, causal,
                  aligned=all(x.data_ptr() % 16 == 0 for x in (q, k, v, out)))
  _launch('flash_attention', _SIGNATURES, 't2r_flash_fwd', 'flash_fwd', q,
          causal, (q, k, v, out, lse),
          (_ROUTE_CODES[plan['route']], plan['rows']))
  flash_fwd.launches += 1
  return out, lse


flash_fwd.launches = 0


def _bwd_launch(kernel: str, q, causal: bool, inputs, outputs) -> None:
  plan = bwd_plan(kernel, q.shape, q.dtype, causal, aligned=all(
      x.data_ptr() % 16 == 0 for x in inputs[:4] + outputs))
  _launch('flash_attention_bwd', _BWD_SIGNATURES, f't2r_flash_{kernel}',
          f'flash_{kernel}', q, causal, inputs + outputs,
          (_ROUTE_CODES[plan['route']], plan['rows']))


def flash_dq(q, k, v, do, lse, delta, causal: bool = False) -> torch.Tensor:
  """Launches the dq kernel on the current stream, on the route
  :func:`bwd_plan` chooses: q, k, v, do as for :func:`flash_fwd`, ``lse``
  the forward's, ``delta`` from :func:`flash_delta`. Returns dq in q's
  dtype."""
  _require_qkv('flash_dq', q, k, v, do)
  _require_stats('flash_dq', q, lse, delta)
  dq = torch.empty_like(q)
  _bwd_launch('dq', q, causal, (q, k, v, do, lse, delta), (dq,))
  flash_dq.launches += 1
  return dq


flash_dq.launches = 0


def flash_dkv(q, k, v, do, lse, delta,
              causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
  """Launches the dk/dv kernel on the current stream, on the route
  :func:`bwd_plan` chooses (arguments as :func:`flash_dq`). Returns (dk,
  dv) in the inputs' dtype."""
  _require_qkv('flash_dkv', q, k, v, do)
  _require_stats('flash_dkv', q, lse, delta)
  dk = torch.empty_like(k)
  dv = torch.empty_like(v)
  _bwd_launch('dkv', q, causal, (q, k, v, do, lse, delta), (dk, dv))
  flash_dkv.launches += 1
  return dk, dv


flash_dkv.launches = 0


# ------------------------------------------------------ autograd + api


@torch.library.custom_op('t2r::flash_fwd', mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, block_q: Optional[int],
                 block_k: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
  """``torch.ops.t2r.flash_fwd``: (out, lse) of [B, T, H, D] q, k, v. A
  CUDA tensor launches :func:`flash_fwd` (the kernel tiles as
  :func:`fwd_plan` says; the blocks set only the plain version's), a CPU
  tensor runs :func:`plain_flash_fwd`; the gate is ``ops/_dispatch.py``'s.
  As one op, the forward is one node of an exported program, which
  dispatches by device where it runs."""
  q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
  _check(q, block_q, block_k)
  if dispatch.kernels_enabled(q):
    return flash_fwd(q, k, v, causal)
  out, lse = plain_flash_fwd(q, k, v, causal, block_q, block_k)
  return out, lse.contiguous()


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal, block_q, block_k):
  """The outputs' shapes alone (the batch may be symbolic): ``out`` like
  q, ``lse`` float32 [B*H, 1, T]."""
  del k, v, causal, block_q, block_k
  b, t, h, _ = q.shape
  return (torch.empty_like(q, memory_format=torch.contiguous_format),
          q.new_empty((b * h, 1, t), dtype=torch.float32))


class FlashAttention(torch.autograd.Function):
  """out = softmax(q·kᵀ/√D [+ causal mask])·v on [B, T, H, D], with the
  FlashAttention-2 backward.

  The forward (``torch.ops.t2r.flash_fwd``) saves q, k, v, out and the
  float32 logsumexp; the backward computes ``delta`` in plain torch, then
  dq and dk/dv. Each direction runs the kernels for CUDA tensors and the
  plain versions for CPU tensors.
  """

  @staticmethod
  def forward(ctx, q, k, v, causal, block_q, block_k):  # pylint: disable=arguments-differ
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out, lse = torch.ops.t2r.flash_fwd(q, k, v, causal, block_q, block_k)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.config = (causal, block_q, block_k)
    return out

  @staticmethod
  def backward(ctx, g):  # pylint: disable=arguments-differ
    q, k, v, out, lse = ctx.saved_tensors
    causal, block_q, block_k = ctx.config
    g = g.contiguous().to(q.dtype)
    delta = flash_delta(out, g)
    if dispatch.kernels_enabled(g):
      dq = flash_dq(q, k, v, g, lse, delta, causal)
      dk, dv = flash_dkv(q, k, v, g, lse, delta, causal)
    else:
      dq = plain_flash_dq(q, k, v, g, lse, delta, causal, block_q, block_k)
      dk, dv = plain_flash_dkv(q, k, v, g, lse, delta, causal, block_q,
                               block_k)
    return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
  """[B, T, H, D] attention, O(T·D) memory, through
  :class:`FlashAttention`. Same contract as
  ``parallel.sequence_parallel.reference_attention``. ``block_q`` /
  ``block_k`` default per regime (see :func:`_resolve_blocks`); they set
  the plain versions' blocks, while the kernels tile as :func:`fwd_plan`
  and :func:`bwd_plan` say in every regime."""
  return FlashAttention.apply(q, k, v, causal, block_q, block_k)
