"""Space-to-depth first-layer conv: CUDA kernels for the card, plain versions
for the CPU.

The port's counterpart of ``tensor2robot_tpu/ops/conv_s2d.py``. A
shallow-input conv (QT-Opt conv1: 6x6/s2, 3 -> 64 channels) is computed as
an im2col product of [pixels, kh*kw*Cin] patches with the [kh*kw*Cin,
Cout] weight matrix, in float32 accumulation, in the tap order (dy, dx,
cin). Its gradients are the patch matrix's transpose times the cotangent
(dW, rounded once to the weights' dtype) and the transposed conv of the
cotangent (dx).

Entry points take NHWC activations and HWIO weights, as the JAX package
does. :func:`conv2d` goes through the autograd Function
:class:`Conv2dS2D` on every device. A CUDA tensor launches
:func:`conv_s2d_fwd`, :func:`conv_s2d_dw` and :func:`conv_s2d_dx` (the
kernels in ``csrc/conv_s2d.cu``); a CPU tensor runs :func:`plain_conv2d`,
:func:`plain_conv2d_dw` and :func:`plain_conv2d_dx`. The forward is the
custom op ``torch.ops.t2r.conv_s2d_fwd`` (:func:`conv_s2d_fwd_op`), one
node of an exported program (``export/exporters.py``) that dispatches by
device where the program runs. The backward computes
dx only when the input needs a gradient. :func:`conv_s2d_fwd` and
:func:`conv_s2d_dw` take their route from the dtype (:func:`fwd_plan`,
:func:`dw_plan`): bfloat16 on the tensor cores, float32 on the CUDA cores;
:func:`conv_s2d_dx` from :func:`dx_plan`: bfloat16 with Cout % 16 == 0 and
aligned operands on the tensor cores (a phase GEMM), the rest on the CUDA
cores.
Results are banded, not bitwise, against a stock convolution
(reassociated sums): 1e-5 in float32.

:class:`SpaceToDepthConv` is the module form. Its parameter tree is that
of flax's ``nn.Conv``: a ``kernel`` of shape (kh, kw, cin, cout) and an
optional ``bias``, so weights move between the packages unchanged.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.ops import _build
from tensor2robot_tpu_torch.ops import _dispatch as dispatch
from tensor2robot_tpu_torch.ops.pool import (Pads, _pads_list, _pads_pairs,
                                             resolve_padding)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    't2r_conv_s2d_fwd': [ctypes.c_void_p] * 3 + [ctypes.c_int] * 17 +
                        [ctypes.c_void_p],
    't2r_conv_s2d_fwd_mma': [ctypes.c_void_p] * 3 + [ctypes.c_int] * 17 +
                            [ctypes.c_void_p],
    't2r_conv_s2d_dw': [ctypes.c_void_p] * 4 + [ctypes.c_int] * 18 +
                       [ctypes.c_void_p],
    't2r_conv_s2d_dw_mma': [ctypes.c_void_p] * 4 + [ctypes.c_int] * 18 +
                           [ctypes.c_void_p],
    't2r_conv_s2d_dx': [ctypes.c_void_p] * 3 + [ctypes.c_int] * 20 +
                       [ctypes.c_void_p],
    't2r_conv_s2d_dx_mma': [ctypes.c_void_p] * 3 + [ctypes.c_int] * 16 +
                           [ctypes.c_void_p],
}
# The patch depth kh*kw*Cin this form is for: a deep-Cin conv is already
# matmul-shaped and belongs to the stock convolution.
_MAX_CIN = 8
_MAX_PATCH_DEPTH = 512
# Dynamic shared memory per block on an H100, and the kernels' tile of
# output pixels (kPixels in csrc/conv_s2d.cu).
_MAX_SMEM_BYTES = 232448
_TILE_PIXELS = 64
# dW's first pass splits the output pixels into fixed runs of whole tiles,
# one block each, and its second pass adds the runs' float32 partials in
# order. The split depends on the shapes alone, never on the card, so dW
# repeats bit for bit. The most runs fill one wave of an H100's 132 SMs:
# both kernels run four blocks on an SM (bfloat16 on the tensor cores, 50
# KB of shared memory at conv1; float32 on the CUDA cores, 40 KB and its
# registers). :func:`dw_plan` makes the split for both kernels, and each C
# entry point checks it.
_DW_MMA_CHUNKS = 528
# The bfloat16 dW block (kMma* in csrc/conv_s2d.cu): an output tile of up
# to 128 taps x 64 channels; per stage a [64, taps + 8] patch tile and a
# [64, 64 + 8] cotangent tile in bfloat16 (rows padded by 16 bytes), two
# stages, then a 16-byte tap table entry per tap.
_MMA_MAX_TAPS = 128
_MMA_CHANNELS = 64
_MMA_STAGES = 2
_MMA_ROW_PAD = 8
# The bfloat16 forward (kFwd* in csrc/conv_s2d.cu): block (j, n) owns run j
# of 64-pixel tiles and channel tile n of 64 channels, with the taps padded
# to 16 (at most _MAX_PATCH_DEPTH); a [64, 64] output tile, then per stage
# a [64, k_pad] patch tile and once the [64, k_pad] weights, all bfloat16,
# and a 16-byte tap table entry per tap. Four blocks fit an SM at conv1
# (53 KB each), so the runs fill at most one wave of them. Every output
# element has one writer, so the split only balances the load.
_FWD_CHANNELS = 64
_FWD_STAGES = 2
_FWD_MMA_CHUNKS = 528
# The bfloat16 dx (kDx* in csrc/conv_s2d.cu): persistent blocks of 4 warps
# walk tiles of 8 x 16 phase pixels (all sh*sw phases at once), each with
# two stages of its cotangent rows plus a halo, the packed weights and the
# tile's dx rows in shared memory; at most three blocks an SM of an H100
# (132 SMs, 233,472 bytes of shared memory, 1,024 reserved a block), at
# most 16 phases, two n8 tiles a pass.
_DX_ROWS = 8
_DX_COLS = 16
_DX_STAGES = 2
_DX_BLOCKS_PER_SM = 3
_DX_MAX_PHASES = 16
_DX_N8 = 2
_SMS = 132
_SM_SHARED_BYTES = 233472
_BLOCK_RESERVED_BYTES = 1024
# The float32 forward and the CUDA-core dx (kFfma*, kDxf* in
# csrc/conv_s2d.cu). Forward: blocks of 128 threads over tiles of up to 16
# pixel groups x a 64-channel tile; a group is 8 lanes that share 8
# consecutive output pixels, a lane 8 of the 64 channels; three stages of
# one window row; three blocks an SM. dx: a phase row a warp, at most 8 a
# block, 4 phase columns a lane, 12 (phase, input channel) columns a
# pass, at most 8 output channels a step, two stages, two blocks an SM.
# conv1's geometry runs instantiations of both that know its taps at
# compile time (``templated``).
_FFMA_PIX = 8
_FFMA_CHANNELS = 64
_FFMA_GROUPS = 16
_FFMA_STAGES = 3
_FFMA_BLOCKS_PER_SM = 3
_DXF_PIX = 4
_DXF_COLS = 12
_DXF_MAX_WARPS = 8
_DXF_MAX_CHUNK = 8
_DXF_STAGES = 2
_DXF_BLOCKS_PER_SM = 2
_DXF_SMEM_BUDGET = (_SM_SHARED_BYTES // _DXF_BLOCKS_PER_SM -
                    _BLOCK_RESERVED_BYTES)
# The float32 dW (kDwf* in csrc/conv_s2d.cu): blocks of 12 tap groups x 8
# lanes; a group owns up to 9 taps of one window row and phase, a lane 8 of
# the block's 64 channels; tiles of up to 32 pixels of one output row,
# three stages of the tile's kh window rows of x and its cotangent; four
# blocks an SM.
_DWF_GROUPS = 12
_DWF_CHANNELS = 64
_DWF_TAPS = 9
_DWF_PIX = 32
_DWF_STAGES = 3
_DWF_BLOCKS_PER_SM = 4
ROUTE_TENSOR_CORE = 'tensor_core'
ROUTE_CUDA_CORE = 'cuda_core'


def _cdiv(a: int, b: int) -> int:
  return -(-a // b)


def _dw_mma_tiles(patch: int, cout: int) -> Tuple[int, int, int]:
  """The bfloat16 dW kernel's output tiles: (taps per tile, tap tiles,
  channel tiles). The taps, padded to 16, split into equal tiles of at most
  128; the channels into tiles of 64."""
  m16 = _cdiv(patch, 16)
  tap_tiles = _cdiv(m16, _MMA_MAX_TAPS // 16)
  return 16 * _cdiv(m16, tap_tiles), tap_tiles, _cdiv(cout, _MMA_CHANNELS)


def _dw_smem(patch: int, cout: int, dtype: torch.dtype) -> int:
  """The shared memory by which ``_plan`` budgets dW: a bfloat16 first-pass
  block's; for float32 a fixed rule, 4 * (Kp * Cp + 64 * (Kp + Cp)) + 1024
  + 12 * Kp bytes with the taps and channels rounded up to 4, which sets
  which problems (and so which models' convs) take the kernels. The
  float32 kernel's own tiles (:func:`_dw_ffma`) fit every problem under
  it."""
  if dtype == torch.bfloat16:
    taps = _dw_mma_tiles(patch, cout)[0]
    return 2 * _MMA_STAGES * _TILE_PIXELS * (
        taps + _MMA_ROW_PAD + _MMA_CHANNELS + _MMA_ROW_PAD) + 16 * taps
  kp, cp = _cdiv(patch, 4) * 4, _cdiv(cout, 4) * 4
  return 4 * (kp * cp + _TILE_PIXELS * (kp + cp)) + 16 * _TILE_PIXELS + 12 * kp


def _fwd_smem(patch: int) -> int:
  """Shared memory of a bfloat16 forward block (one 64-channel tile)."""
  k_pad = _cdiv(patch, 16) * 16
  return 2 * (_TILE_PIXELS * _FWD_CHANNELS + (
      _FWD_STAGES * _TILE_PIXELS + _FWD_CHANNELS) * k_pad) + 16 * k_pad


def _per_sm(smem: int, most: int) -> int:
  """Blocks of ``smem`` bytes an SM of an H100 holds, at most ``most``."""
  return min(most, _SM_SHARED_BYTES // (smem + _BLOCK_RESERVED_BYTES))


def _fwd_ffma(p: dict, batch: int) -> Optional[dict]:
  """The float32 forward's plan, as ``fwd_ffma_plan`` in
  ``csrc/conv_s2d.cu`` makes it (see :func:`fwd_plan`); None where the
  kernel does not take the problem."""
  cin, kw, sw, oh, ow = p['cin'], p['kw'], p['sw'], p['oh'], p['ow']
  groups = _FFMA_GROUPS
  while groups >= 1:
    lpr = min(groups, _cdiv(ow, _FFMA_PIX))
    rows = min(groups // lpr, oh)
    cols = (_FFMA_PIX * lpr - 1) * sw + kw
    # Up to 3 floats ahead of the span keep its copies 16-byte aligned.
    ls = _cdiv(cols * cin + 3, 4) * 4
    smem = 4 * (p['patch'] * _FFMA_CHANNELS + _FFMA_STAGES * rows * ls)
    if smem <= _MAX_SMEM_BYTES:
      break
    groups //= 2
  else:
    return None
  row_tiles, col_tiles = _cdiv(oh, rows), _cdiv(ow, _FFMA_PIX * lpr)
  num_tiles = batch * row_tiles * col_tiles
  return dict(route=ROUTE_CUDA_CORE, num_pixels=batch * oh * ow,
              templated=(cin, sw, kw) == (3, 2, 6),
              channel_tiles=_cdiv(p['cout'], _FFMA_CHANNELS), groups=groups,
              groups_per_row=lpr, tile_rows=rows, tile_cols=_FFMA_PIX * lpr,
              row_tiles=row_tiles, col_tiles=col_tiles, num_tiles=num_tiles,
              cols=cols, span=cols * cin, ls=ls, stage_floats=rows * ls,
              grid=min(num_tiles, _SMS * _per_sm(smem, _FFMA_BLOCKS_PER_SM)),
              smem=smem)


def _dw_groups_per_row(cin: int, kw: int, sw: int) -> int:
  """A window row's tap groups: each phase's taps, 9 a group."""
  return sum(_cdiv(cin * _cdiv(kw - ph, sw), _DWF_TAPS)
             for ph in range(min(sw, kw)))


def _dw_ffma(p: dict, batch: int) -> dict:
  """The float32 dW's plan, as ``dw_ffma_plan`` in ``csrc/conv_s2d.cu``
  makes it (see :func:`dw_plan`)."""
  cin, kh, kw, sw, oh, ow, cout = (p['cin'], p['kh'], p['kw'], p['sw'],
                                   p['oh'], p['ow'], p['cout'])
  groups = kh * _dw_groups_per_row(cin, kw, sw)
  group_tiles, channel_tiles = (_cdiv(groups, _DWF_GROUPS),
                                _cdiv(cout, _DWF_CHANNELS))
  pix = _DWF_PIX
  while True:
    # Up to 3 floats ahead of the span keep its copies 16-byte aligned.
    ls = _cdiv(((pix - 1) * sw + kw) * cin + 3, 4) * 4
    stage = kh * ls + pix * _DWF_CHANNELS
    smem = 4 * _DWF_STAGES * stage
    # One pixel a tile always fits: kh * kw * Cin <= 512.
    if smem <= _MAX_SMEM_BYTES or pix == 1:
      break
    pix //= 2
  segs = _cdiv(ow, pix)
  num_tiles = batch * oh * segs
  runs = max(1, _SMS * _per_sm(smem, _DWF_BLOCKS_PER_SM) //
             (group_tiles * channel_tiles))
  tiles_per_chunk = _cdiv(num_tiles, runs)
  chunks = _cdiv(num_tiles, tiles_per_chunk)
  return dict(route=ROUTE_CUDA_CORE, num_pixels=batch * oh * ow,
              tile_pixels=pix, segs=segs, num_tiles=num_tiles,
              tiles_per_chunk=tiles_per_chunk, chunks=chunks,
              templated=(cin, sw, kw) == (3, 2, 6) and pix % 4 == 0,
              groups=groups, group_tiles=group_tiles,
              channel_tiles=channel_tiles, ls=ls, stage_floats=stage,
              grid=(chunks, group_tiles, channel_tiles), smem=smem)


def _dx_ffma(p: dict, batch: int) -> Optional[dict]:
  """The CUDA-core dx's plan, as ``dx_ffma_plan`` in ``csrc/conv_s2d.cu``
  makes it (see :func:`dx_plan`); None where the kernel does not take the
  problem."""
  kh, kw, sh, sw, cin, cout = (p['kh'], p['kw'], p['sh'], p['sw'], p['cin'],
                               p['cout'])
  halo = (_cdiv(kh, sh) - 1, _cdiv(kw, sw) - 1)
  taps = (halo[0] + 1) * (halo[1] + 1)
  live = (min(sh, kh), min(sw, kw))
  passes = _cdiv(live[0] * live[1] * cin, _DXF_COLS)
  m_lo, n_lo = p['plh'] // sh, p['plw'] // sw
  rows = (p['plh'] + p['h'] - 1) // sh - m_lo + 1
  cols = (p['plw'] + p['w'] - 1) // sw - n_lo + 1
  tile_rows = min(_DXF_MAX_WARPS, rows)
  lanes = min(32, _cdiv(cols, _DXF_PIX))
  # Per pass and tap the weights' offset of each column; per column its
  # phase row, phase column and input channel.
  tables = 4 * passes * _DXF_COLS * (taps + 3)
  chosen = None
  while chosen is None:
    slen = _DXF_PIX * lanes + halo[1]
    out_floats = tile_rows * sh * _DXF_PIX * lanes * sw * cin
    for chunk in (_DXF_MAX_CHUNK >> i
                  for i in range(_DXF_MAX_CHUNK.bit_length())):
      if chunk > 1 and chunk // 2 >= cout:
        continue
      cpad = max(chunk, 4)
      # A staged row: slen pixels of cpad floats, 16 bytes of padding
      # after every 128 (padded_row in csrc/conv_s2d.cu).
      gls = slen * cpad + 4 * _cdiv(slen * cpad, 32)
      g_floats = (tile_rows + halo[0]) * gls
      stage = g_floats + taps * chunk * _DXF_COLS
      smem = 4 * (_DXF_STAGES * stage + out_floats) + tables
      if smem <= _DXF_SMEM_BUDGET:
        chosen = chunk, gls, g_floats, stage, smem
        break
    if chosen is None:
      if lanes > 1:
        lanes = _cdiv(lanes, 2)
      elif tile_rows > 1:
        tile_rows = _cdiv(tile_rows, 2)
      else:
        return None
  chunk, gls, g_floats, stage, smem = chosen
  row_tiles = _cdiv(rows, tile_rows)
  col_tiles = _cdiv(cols, _DXF_PIX * lanes)
  num_tiles = batch * row_tiles * col_tiles
  return dict(route=ROUTE_CUDA_CORE, halo=halo, taps=taps,
              templated=halo == (2, 2) and chunk == 4, live_phases=live,
              passes=passes, tile_rows=tile_rows, lanes=lanes, chunk=chunk,
              cpad=max(chunk, 4), chunks=_cdiv(cout, chunk), slen=slen,
              gls=gls, g_floats=g_floats,
              stage_floats=stage, out_cols=_DXF_PIX * lanes * sw, m_lo=m_lo,
              n_lo=n_lo, row_tiles=row_tiles, col_tiles=col_tiles,
              num_tiles=num_tiles,
              grid=min(num_tiles, _SMS * _per_sm(smem, _DXF_BLOCKS_PER_SM)),
              smem=smem)


def _plan(xshape, wshape, strides, pads, x_dtype, w_dtype) -> Optional[dict]:
  if len(xshape) != 4 or len(wshape) != 4:
    return None
  _, h, w, cin = xshape
  kh, kw, wcin, cout = wshape
  sh, sw = strides
  (plh, phh), (plw, phw) = pads
  patch = kh * kw * cin
  if wcin != cin or cin > _MAX_CIN or patch > _MAX_PATCH_DEPTH or cout < 1:
    return None
  if x_dtype != w_dtype or x_dtype not in _DTYPE_CODES:
    return None
  if min(sh, sw) < 1 or min(plh, phh, plw, phw) < 0:
    return None
  if max(plh, phh) >= kh or max(plw, phw) >= kw:
    return None
  oh = (h + plh + phh - kh) // sh + 1
  ow = (w + plw + phw - kw) // sw + 1
  if oh < 1 or ow < 1:
    return None
  # Shared memory of the bfloat16 forward and of dW's first pass for this
  # dtype; the CUDA-core forward and dx plan their own tiles to fit.
  smem = max(_fwd_smem(patch) if x_dtype == torch.bfloat16 else 0,
             _dw_smem(patch, cout, x_dtype))
  if smem > _MAX_SMEM_BYTES:
    return None
  p = dict(h=h, w=w, cin=cin, cout=cout, kh=kh, kw=kw, sh=sh, sw=sw,
           plh=plh, phh=phh, plw=plw, phw=phw, oh=oh, ow=ow, patch=patch)
  # Whether the CUDA-core kernels take it does not depend on the batch,
  # which may be symbolic here (an exported program's).
  if _dx_ffma(p, 1) is None or (x_dtype == torch.float32 and
                                _fwd_ffma(p, 1) is None):
    return None
  return p


def is_supported(xshape: Sequence[int], wshape: Sequence[int],
                 strides: Tuple[int, int],
                 padding: Union[str, Sequence[Tuple[int, int]]],
                 dtype: torch.dtype = torch.float32) -> bool:
  """Whether the kernel handles an NHWC/HWIO conv problem."""
  xshape = tuple(int(d) for d in xshape)
  if len(xshape) != 4:
    return False
  pads = resolve_padding(padding, tuple(wshape[:2]), tuple(strides),
                         xshape[1:3])
  return _plan(xshape, tuple(wshape), tuple(strides), pads, dtype,
               dtype) is not None


def fwd_plan(xshape: Sequence[int], wshape: Sequence[int],
             strides: Tuple[int, int], pads: Pads, dtype: torch.dtype) -> dict:
  """How :func:`conv_s2d_fwd` runs a problem, from the shapes and dtype
  alone, as the C planners decide it (each C entry refuses any other).

  The route: bfloat16 -> the tensor-core kernel, float32 -> the CUDA-core
  one. Both give the pixels (``num_pixels``), their tiles (``num_tiles``)
  and ``smem``, a block's shared memory in bytes. The tensor-core route
  also gives its 64-pixel tiles' runs (``chunks`` blocks of
  ``tiles_per_chunk`` tiles, the last one ragged), the taps padded to
  ``k_pad`` and the ``channel_tiles`` of 64 channels. The CUDA-core route
  (``fwd_ffma_plan``) gives its tiles of ``tile_rows`` output rows x
  ``tile_cols`` (8 x ``groups_per_row``) output columns of one image, of
  the block's 16 pixel groups ``groups`` in use, ``row_tiles`` x
  ``col_tiles`` an image; the ``channel_tiles`` of 64; whether Cin, sw
  and kw are conv1's (3, 2, 6), which runs an instantiation that knows
  them at compile time (``templated``); the
  ``cols`` input columns (``span`` floats) a tile row's window row reads,
  staged ``ls`` floats a row, ``stage_floats`` a stage; and the
  persistent ``grid`` (x; y is the channel tiles).
  Raises for a problem the kernels do not take."""
  p = _plan(tuple(xshape), tuple(wshape), tuple(strides), pads, dtype, dtype)
  if p is None:
    raise ValueError(
        f'conv_s2d forward unsupported for x {tuple(xshape)}, w '
        f'{tuple(wshape)}, dtype {dtype}, strides {strides}, pads {pads}.')
  return _fwd_split(p, int(xshape[0]), dtype)


def _fwd_split(p: dict, batch: int, dtype: torch.dtype) -> dict:
  """:func:`fwd_plan` of a problem that ``_plan`` has taken."""
  if dtype != torch.bfloat16:
    return _fwd_ffma(p, batch)
  num_pixels = batch * p['oh'] * p['ow']
  num_tiles = _cdiv(num_pixels, _TILE_PIXELS)
  tiles_per_chunk = _cdiv(num_tiles, _FWD_MMA_CHUNKS)
  return dict(route=ROUTE_TENSOR_CORE, num_pixels=num_pixels,
              tile_pixels=_TILE_PIXELS, num_tiles=num_tiles,
              smem=_fwd_smem(p['patch']),
              tiles_per_chunk=tiles_per_chunk,
              chunks=_cdiv(num_tiles, tiles_per_chunk),
              k_pad=_cdiv(p['patch'], 16) * 16,
              channel_tiles=_cdiv(p['cout'], _FWD_CHANNELS))


def dw_plan(xshape: Sequence[int], wshape: Sequence[int],
            strides: Tuple[int, int], pads: Pads, dtype: torch.dtype) -> dict:
  """How :func:`conv_s2d_dw` splits a problem, from the shapes and dtype
  alone, as the C planners decide it (each C entry refuses any other): the
  route (bfloat16 -> the tensor-core kernel, float32 -> the CUDA-core
  kernel), the pixels, their tiles of ``tile_pixels`` (``num_tiles``), the
  runs (``chunks`` blocks of ``tiles_per_chunk`` tiles, the last one
  ragged) and ``smem``, a block's shared memory in bytes.

  On the tensor-core route a tile is 64 consecutive pixels, and the plan
  also gives the output tiles (``tap_tiles`` of ``tile_taps`` taps x
  ``channel_tiles`` of 64 channels, with the taps padded to ``k_pad`` and
  the channels' MMA tiles to ``cout_pad``). On the CUDA-core route
  (``dw_ffma_plan``) a tile is a segment of up to ``tile_pixels`` pixels of
  one output row, ``segs`` a row; the taps fall into ``groups`` tap groups
  (a window row's phase, at most 9 taps a group), 12 a block over
  ``group_tiles``, the channels into ``channel_tiles`` of 64; a stage holds
  kh rows of ``ls`` floats of x and the tile's cotangent
  (``stage_floats`` in all); ``templated`` says whether Cin, sw and kw are
  conv1's (3, 2, 6), which runs an instantiation that knows them at
  compile time; ``grid`` is (runs, group tiles, channel tiles). Raises for
  a problem the kernels do not take."""
  p = _plan(tuple(xshape), tuple(wshape), tuple(strides), pads, dtype, dtype)
  if p is None:
    raise ValueError(
        f'conv_s2d dW unsupported for x {tuple(xshape)}, w {tuple(wshape)}, '
        f'dtype {dtype}, strides {strides}, pads {pads}.')
  return _dw_split(p, int(xshape[0]), dtype)


def _dw_split(p: dict, batch: int, dtype: torch.dtype) -> dict:
  """:func:`dw_plan` of a problem that ``_plan`` has taken."""
  if dtype != torch.bfloat16:
    return _dw_ffma(p, batch)
  num_pixels = batch * p['oh'] * p['ow']
  num_tiles = _cdiv(num_pixels, _TILE_PIXELS)
  tiles_per_chunk = _cdiv(num_tiles, _DW_MMA_CHUNKS)
  tile_taps, tap_tiles, channel_tiles = _dw_mma_tiles(p['patch'], p['cout'])
  return dict(route=ROUTE_TENSOR_CORE, num_pixels=num_pixels,
              tile_pixels=_TILE_PIXELS, num_tiles=num_tiles,
              tiles_per_chunk=tiles_per_chunk,
              chunks=_cdiv(num_tiles, tiles_per_chunk),
              smem=_dw_smem(p['patch'], p['cout'], dtype),
              tile_taps=tile_taps, tap_tiles=tap_tiles,
              channel_tiles=channel_tiles,
              k_pad=_cdiv(p['patch'], 16) * 16,
              cout_pad=_cdiv(p['cout'], 8) * 8)


def dx_plan(xshape: Sequence[int], wshape: Sequence[int],
            strides: Tuple[int, int], pads: Pads, dtype: torch.dtype,
            aligned: bool = True) -> dict:
  """How :func:`conv_s2d_dx` runs a problem, from the shapes, the dtype
  and whether g and dx are 16-byte aligned (``aligned``), as
  ``dx_mma_plan`` in ``csrc/conv_s2d.cu`` decides it (the C entries refuse
  any other).

  The ``route``: the tensor cores for bfloat16 with Cout % 16 == 0,
  aligned operands, at most 16 phases (sh*sw) and a block that fits
  shared memory; else the CUDA cores (float32 always, whose TF32 would
  leave the 1e-5 band). On the tensor-core route also: the tile of
  ``tile_rows`` x ``tile_cols`` phase pixels and its ``halo`` of cotangent
  rows and columns, the ``taps`` a phase reads, the ``phases``, ``cin_pad``
  (Cin rounded up to a power of two), ``phases_per_n8`` (phases packed in
  one n8 MMA tile), ``n8_tiles`` and ``passes`` (of two n8 tiles), the phase grid's first row and column (``m_lo``,
  ``n_lo``) and its ``row_tiles`` x ``col_tiles`` tiles an image,
  ``num_tiles``, the persistent ``grid``, ``o_stride`` (a dx row of the
  tile in shared memory) and ``smem``, a block's shared memory in bytes.

  On the CUDA-core route (``dx_ffma_plan``): the same ``halo``, ``taps``,
  phase grid origin and tiles, with tiles of ``tile_rows`` phase rows (a
  warp each) x 4 * ``lanes`` phase columns; whether a phase's taps (3 x
  3) and the channels a step (4) are conv1's, which runs an instantiation
  that knows them at compile time (``templated``); the ``live_phases``
  (phase
  rows and columns with a tap: min(sh, kh), min(sw, kw)), whose
  (phase, input channel) columns go 12 to each of the ``passes``; the
  output channels a step stages (``chunk``, held as ``cpad`` = max(chunk,
  4) floats a pixel) and the ``chunks``; a staged row's ``slen`` pixels
  in ``gls`` floats (16 bytes of padding after every 128), a stage's
  ``g_floats`` of cotangent and ``stage_floats`` in all; the tile's dx
  rows' ``out_cols`` pixels;
  ``grid`` and ``smem``. Raises for a problem the kernels do not take.
  """
  p = _plan(tuple(xshape), tuple(wshape), tuple(strides), pads, dtype, dtype)
  if p is None:
    raise ValueError(
        f'conv_s2d dx unsupported for x {tuple(xshape)}, w {tuple(wshape)}, '
        f'dtype {dtype}, strides {strides}, pads {pads}.')
  return _dx_split(p, int(xshape[0]), dtype, aligned)


def _dx_split(p: dict, batch: int, dtype: torch.dtype, aligned: bool) -> dict:
  """:func:`dx_plan` of a problem that ``_plan`` has taken."""
  cuda_core = _dx_ffma(p, batch)
  sh, sw, cin, cout = p['sh'], p['sw'], p['cin'], p['cout']
  phases = sh * sw
  if (dtype != torch.bfloat16 or not aligned or cout % 16 != 0 or
      phases > _DX_MAX_PHASES):
    return cuda_core
  halo = (_cdiv(p['kh'], sh) - 1, _cdiv(p['kw'], sw) - 1)
  taps = (halo[0] + 1) * (halo[1] + 1)
  cin_pad = 1 << (cin - 1).bit_length()
  per_n8 = 8 // cin_pad
  n8_tiles = _cdiv(phases, per_n8)
  passes = _cdiv(n8_tiles, _DX_N8)
  o_stride = _cdiv(_DX_COLS * sw * cin + 7, 8) * 8
  row_elems = cout + _MMA_ROW_PAD
  n8_alloc = passes * _DX_N8
  smem = 2 * (_DX_STAGES * (_DX_ROWS + halo[0]) * (_DX_COLS + halo[1]) *
              row_elems + taps * n8_alloc * 8 * row_elems +
              _DX_ROWS * sh * o_stride) + 4 * n8_alloc * 8
  if smem > _MAX_SMEM_BYTES:
    return cuda_core
  m_lo, n_lo = p['plh'] // sh, p['plw'] // sw
  rows = (p['plh'] + p['h'] - 1) // sh - m_lo + 1
  cols = (p['plw'] + p['w'] - 1) // sw - n_lo + 1
  row_tiles, col_tiles = _cdiv(rows, _DX_ROWS), _cdiv(cols, _DX_COLS)
  num_tiles = batch * row_tiles * col_tiles
  if num_tiles >= 2**31:
    return cuda_core
  per_sm = min(_DX_BLOCKS_PER_SM,
               _SM_SHARED_BYTES // (smem + _BLOCK_RESERVED_BYTES))
  return dict(route=ROUTE_TENSOR_CORE, tile_rows=_DX_ROWS,
              tile_cols=_DX_COLS, halo=halo, taps=taps, phases=phases,
              cin_pad=cin_pad, phases_per_n8=per_n8, n8_tiles=n8_tiles,
              passes=passes, m_lo=m_lo, n_lo=n_lo,
              row_tiles=row_tiles, col_tiles=col_tiles, num_tiles=num_tiles,
              grid=min(num_tiles, _SMS * per_sm), o_stride=o_stride,
              smem=smem)


def _require_plan(x, w, strides, pads) -> dict:
  plan = _plan(tuple(x.shape), tuple(w.shape), tuple(strides), pads, x.dtype,
               w.dtype)
  if plan is None:
    raise ValueError(
        f'conv_s2d unsupported for x {tuple(x.shape)} {x.dtype}, w '
        f'{tuple(w.shape)} {w.dtype}, strides {strides}, pads {pads}.')
  return plan


def conv_s2d_fwd(x: torch.Tensor, w: torch.Tensor, strides: Tuple[int, int],
                 pads: Pads) -> torch.Tensor:
  """Launches the forward kernel (``csrc/conv_s2d.cu``) on the current
  stream.

  ``x``: contiguous NHWC, ``w``: contiguous HWIO, both float32 or both
  bfloat16 on one CUDA device. Returns NHWC in the input dtype. The dtype
  picks the kernel (:func:`fwd_plan`): bfloat16 runs on the tensor cores
  (counted in ``tensor_core_launches`` too), float32 on the CUDA cores
  (``conv_fwd_ffma_kernel``).
  Raises on any other input, and when the launch reports an error.
  """
  _cuda_operands('conv_s2d_fwd', x, w)
  p = _require_plan(x, w, strides, pads)
  b = x.shape[0]
  plan = _fwd_split(p, b, x.dtype)
  out = torch.empty((b, p['oh'], p['ow'], p['cout']), dtype=x.dtype,
                    device=x.device)
  tensor_core = plan['route'] == ROUTE_TENSOR_CORE
  lib = _build.load('conv_s2d', _SIGNATURES)
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    operands = (x.data_ptr(), w.data_ptr(), out.data_ptr(), b, p['h'],
                p['w'], p['cin'], p['kh'], p['kw'], p['sh'], p['sw'],
                p['plh'], p['plw'], p['oh'], p['ow'], p['cout'])
    if tensor_core:
      status = lib.t2r_conv_s2d_fwd_mma(
          *operands, plan['tiles_per_chunk'], plan['chunks'], plan['k_pad'],
          plan['channel_tiles'], stream)
    else:
      status = lib.t2r_conv_s2d_fwd(*operands, plan['groups'],
                                    int(plan['templated']), plan['grid'],
                                    plan['smem'], stream)
  _build.check(lib, status, 'conv_s2d_fwd')
  conv_s2d_fwd.launches += 1
  conv_s2d_fwd.tensor_core_launches += tensor_core
  return out


conv_s2d_fwd.launches = 0
conv_s2d_fwd.tensor_core_launches = 0


def _patches(x: torch.Tensor, p: dict) -> torch.Tensor:
  """[pixels, kh*kw*Cin] im2col matrix of NHWC ``x``, taps (dy, dx, cin)."""
  sh, sw, oh, ow = p['sh'], p['sw'], p['oh'], p['ow']
  xp = F.pad(x, (0, 0, p['plw'], p['phw'], p['plh'], p['phh']))
  taps = [
      xp[:, dy:dy + (oh - 1) * sh + 1:sh, dx:dx + (ow - 1) * sw + 1:sw]
      for dy in range(p['kh']) for dx in range(p['kw'])
  ]
  return torch.cat(taps, dim=-1).reshape(-1, p['patch'])


def plain_conv2d(x: torch.Tensor, w: torch.Tensor, strides: Tuple[int, int],
                 pads: Pads) -> torch.Tensor:
  """The kernel's function in plain PyTorch, on any device: an explicit
  im2col in tap order (dy, dx, cin), then one float32 matmul."""
  p = _require_plan(x, w, strides, pads)
  out = _patches(x, p).float() @ w.reshape(p['patch'], p['cout']).float()
  return out.reshape(x.shape[0], p['oh'], p['ow'], p['cout']).to(x.dtype)


def _cuda_operands(what: str, *tensors: torch.Tensor) -> None:
  device = tensors[0].device
  if device.type != 'cuda' or any(t.device != device for t in tensors):
    raise ValueError(
        f'{what} takes CUDA tensors on one device, got '
        f'{[str(t.device) for t in tensors]}.')
  if not all(t.is_contiguous() for t in tensors):
    raise ValueError(f'{what} takes contiguous NHWC/HWIO tensors.')


def _require_grad_plan(what, xshape, wshape, gshape, strides, pads, dtype,
                       g_dtype) -> dict:
  plan = _plan(tuple(xshape), tuple(wshape), tuple(strides), pads, dtype,
               dtype)
  if (plan is None or g_dtype != dtype or tuple(gshape) != (
      xshape[0], plan['oh'], plan['ow'], plan['cout'])):
    raise ValueError(
        f'{what} unsupported for x {tuple(xshape)}, w {tuple(wshape)}, g '
        f'{tuple(gshape)} {g_dtype}, dtype {dtype}, strides {strides}, pads '
        f'{pads}.')
  return plan


def conv_s2d_dw(x: torch.Tensor, g: torch.Tensor, w_shape: Sequence[int],
                strides: Tuple[int, int], pads: Pads) -> torch.Tensor:
  """Launches the dW kernel (``csrc/conv_s2d.cu``) on the current stream.

  ``x``: contiguous NHWC input, ``g``: contiguous NHWC cotangent of the
  output, both float32 or both bfloat16 on one CUDA device. Returns dW of
  shape ``w_shape`` (HWIO) in their dtype: the float32 sum rounded once.
  The dtype picks the first pass (:func:`dw_plan`): bfloat16 runs on the
  tensor cores (counted in ``tensor_core_launches`` too), float32 on the
  CUDA cores (``conv_dw_ffma_kernel``). Raises on any other input, and
  when a launch reports an error.
  """
  _cuda_operands('conv_s2d_dw', x, g)
  p = _require_grad_plan('conv_s2d_dw', x.shape, w_shape, g.shape, strides,
                         pads, x.dtype, g.dtype)
  plan = _dw_split(p, x.shape[0], x.dtype)
  partial = torch.empty((plan['chunks'], p['patch'], p['cout']),
                        dtype=torch.float32, device=x.device)
  dw = torch.empty(tuple(w_shape), dtype=x.dtype, device=x.device)
  geometry = (x.shape[0], p['h'], p['w'], p['cin'], p['kh'], p['kw'],
              p['sh'], p['sw'], p['plh'], p['plw'], p['oh'], p['ow'],
              p['cout'])
  tensor_core = plan['route'] == ROUTE_TENSOR_CORE
  lib = _build.load('conv_s2d', _SIGNATURES)
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    operands = (x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                dw.data_ptr(), *geometry, plan['tiles_per_chunk'],
                plan['chunks'])
    if tensor_core:
      status = lib.t2r_conv_s2d_dw_mma(
          *operands, plan['tile_taps'], plan['tap_tiles'],
          plan['channel_tiles'], stream)
    else:
      status = lib.t2r_conv_s2d_dw(*operands, plan['tile_pixels'],
                                   int(plan['templated']), plan['smem'],
                                   stream)
  _build.check(lib, status, 'conv_s2d_dw')
  conv_s2d_dw.launches += 1
  conv_s2d_dw.tensor_core_launches += tensor_core
  return dw


conv_s2d_dw.launches = 0
conv_s2d_dw.tensor_core_launches = 0


def conv_s2d_dx(g: torch.Tensor, w: torch.Tensor, x_shape: Sequence[int],
                strides: Tuple[int, int], pads: Pads) -> torch.Tensor:
  """Launches the dx kernel (``csrc/conv_s2d.cu``) on the current stream.

  ``g``: contiguous NHWC cotangent of the output, ``w``: contiguous HWIO
  weights, both float32 or both bfloat16 on one CUDA device. Returns dx of
  shape ``x_shape`` (NHWC) in their dtype. :func:`dx_plan` picks the
  kernel: the tensor-core route (counted in ``tensor_core_launches`` too)
  or the CUDA-core one. Raises on any other input, and when the launch
  reports an error.
  """
  _cuda_operands('conv_s2d_dx', g, w)
  p = _require_grad_plan('conv_s2d_dx', x_shape, w.shape, g.shape, strides,
                         pads, w.dtype, g.dtype)
  dx = torch.empty(tuple(x_shape), dtype=w.dtype, device=w.device)
  plan = _dx_split(p, int(x_shape[0]), w.dtype,
                   g.data_ptr() % 16 == 0 and dx.data_ptr() % 16 == 0)
  tensor_core = plan['route'] == ROUTE_TENSOR_CORE
  lib = _build.load('conv_s2d', _SIGNATURES)
  with torch.cuda.device(w.device):
    stream = torch.cuda.current_stream(w.device).cuda_stream
    geometry = (x_shape[0], p['h'], p['w'], p['cin'], p['kh'], p['kw'],
                p['sh'], p['sw'], p['plh'], p['plw'], p['oh'], p['ow'],
                p['cout'])
    if tensor_core:
      status = lib.t2r_conv_s2d_dx_mma(
          g.data_ptr(), w.data_ptr(), dx.data_ptr(), *geometry,
          plan['num_tiles'], plan['grid'], plan['smem'], stream)
    else:
      status = lib.t2r_conv_s2d_dx(
          g.data_ptr(), w.data_ptr(), dx.data_ptr(), _DTYPE_CODES[w.dtype],
          *geometry, plan['tile_rows'], plan['lanes'], plan['chunk'],
          int(plan['templated']), plan['grid'], plan['smem'], stream)
  _build.check(lib, status, 'conv_s2d_dx')
  conv_s2d_dx.launches += 1
  conv_s2d_dx.tensor_core_launches += tensor_core
  return dx


conv_s2d_dx.launches = 0
conv_s2d_dx.tensor_core_launches = 0


def plain_conv2d_dw(x: torch.Tensor, g: torch.Tensor,
                    w_shape: Sequence[int], strides: Tuple[int, int],
                    pads: Pads) -> torch.Tensor:
  """dW in plain PyTorch, on any device: patchesᵀ · g in float32, rounded
  once to x's dtype, HWIO."""
  p = _require_grad_plan('conv2d dW', x.shape, w_shape, g.shape, strides,
                         pads, x.dtype, g.dtype)
  dw = _patches(x, p).float().t() @ g.reshape(-1, p['cout']).float()
  return dw.reshape(tuple(w_shape)).to(x.dtype)


def plain_conv2d_dx(g: torch.Tensor, w: torch.Tensor,
                    x_shape: Sequence[int], strides: Tuple[int, int],
                    pads: Pads) -> torch.Tensor:
  """dx in plain PyTorch, on any device: the patch gradient g · Wᵀ in
  float32, added back tap by tap into the padded input, cropped and
  rounded once to w's dtype."""
  p = _require_grad_plan('conv2d dx', x_shape, w.shape, g.shape, strides,
                         pads, w.dtype, g.dtype)
  sh, sw, oh, ow, cin = p['sh'], p['sw'], p['oh'], p['ow'], p['cin']
  dpatch = g.reshape(-1, p['cout']).float() @ w.reshape(
      p['patch'], p['cout']).float().t()
  dpatch = dpatch.reshape(x_shape[0], oh, ow, p['patch'])
  hp = max((oh - 1) * sh + p['kh'], p['plh'] + p['h'])
  wp = max((ow - 1) * sw + p['kw'], p['plw'] + p['w'])
  dxp = dpatch.new_zeros((x_shape[0], hp, wp, cin))
  for dy in range(p['kh']):
    for dx in range(p['kw']):
      k = (dy * p['kw'] + dx) * cin
      dxp[:, dy:dy + (oh - 1) * sh + 1:sh,
          dx:dx + (ow - 1) * sw + 1:sw] += dpatch[..., k:k + cin]
  dxp = dxp[:, p['plh']:p['plh'] + p['h'], p['plw']:p['plw'] + p['w']]
  return dxp.to(w.dtype)


@torch.library.custom_op('t2r::conv_s2d_fwd', mutates_args=())
def conv_s2d_fwd_op(x: torch.Tensor, w: torch.Tensor, strides: List[int],
                    pads: List[int]) -> torch.Tensor:
  """``torch.ops.t2r.conv_s2d_fwd``: NHWC x HWIO with ``pads`` (lo_h, hi_h,
  lo_w, hi_w), NHWC-contiguous out. A CUDA tensor launches
  :func:`conv_s2d_fwd` on contiguous copies of the operands (none is made
  where one already is), a CPU tensor runs :func:`plain_conv2d`; the gate
  is ``ops/_dispatch.py``'s. As one op, the conv is one node of an
  exported program (``torch.export``), which dispatches by device where
  it runs."""
  strides, pairs = tuple(strides), _pads_pairs(pads)
  if dispatch.kernels_enabled(x):
    return conv_s2d_fwd(x.contiguous(), w.contiguous(), strides, pairs)
  return plain_conv2d(x, w, strides, pairs).contiguous()


@conv_s2d_fwd_op.register_fake
def _conv_s2d_fwd_fake(x, w, strides, pads):
  """The output's shape from the geometry alone (the batch may be
  symbolic); no plan is made."""
  p = _require_plan(x, w, tuple(strides), _pads_pairs(pads))
  return x.new_empty((x.shape[0], p['oh'], p['ow'], p['cout']))


class Conv2dS2D(torch.autograd.Function):
  """NHWC x HWIO conv with explicit pads, differentiable in x and w.

  Each direction runs the kernel for a CUDA tensor and the plain version
  for a CPU tensor. The backward computes dW only when the weights need a
  gradient and dx only when the input does (the image at the bottom of a
  tower does not); both leave in the operands' dtype, so under bfloat16 dW
  is rounded to bfloat16 before autograd casts it into a float32
  parameter's gradient, as the JAX package does.
  """

  @staticmethod
  def forward(ctx, x, w, strides, pads):  # pylint: disable=arguments-differ
    out = torch.ops.t2r.conv_s2d_fwd(x, w, list(strides), _pads_list(pads))
    ctx.save_for_backward(x, w)
    ctx.geometry = (strides, pads)
    return out

  @staticmethod
  def backward(ctx, g):  # pylint: disable=arguments-differ
    x, w = ctx.saved_tensors
    strides, pads = ctx.geometry
    on_card = dispatch.kernels_enabled(g)
    if on_card:
      x, w, g = x.contiguous(), w.contiguous(), g.contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
      dx = (conv_s2d_dx if on_card else plain_conv2d_dx)(
          g, w, tuple(x.shape), strides, pads)
    if ctx.needs_input_grad[1]:
      dw = (conv_s2d_dw if on_card else plain_conv2d_dw)(
          x, g, tuple(w.shape), strides, pads)
    return dx, dw, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, strides: Tuple[int, int],
           padding: Union[str, Sequence[Tuple[int, int]]]) -> torch.Tensor:
  """NHWC x HWIO conv through :class:`Conv2dS2D`: the kernels on a CUDA
  tensor, the plain versions on a CPU tensor."""
  strides = tuple(strides)
  pads = resolve_padding(padding, tuple(w.shape[:2]), strides,
                         tuple(x.shape[1:3]))
  return Conv2dS2D.apply(x, w, strides, pads)


def reference_conv2d(x: torch.Tensor, w: torch.Tensor,
                     strides: Tuple[int, int],
                     padding: Union[str, Sequence[Tuple[int, int]]]
                     ) -> torch.Tensor:
  """The stock PyTorch form (``F.conv2d`` on NCHW views of NHWC x and HWIO
  w, explicit zero pads). Not a kernel path."""
  strides = tuple(strides)
  (plh, phh), (plw, phw) = resolve_padding(padding, tuple(w.shape[:2]),
                                           strides, tuple(x.shape[1:3]))
  xn = F.pad(x.permute(0, 3, 1, 2), (plw, phw, plh, phh))
  out = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=strides)
  return out.permute(0, 2, 3, 1)


class SpaceToDepthConv(nn.Module):
  """Conv module on NHWC activations with flax ``nn.Conv``'s parameters.

  ``kernel`` has shape (kh, kw, cin, features); ``bias`` is optional.
  ``dtype`` is the compute dtype (input, kernel and bias are cast to it, as
  flax's ``promote_dtype`` does); None promotes input and kernel.
  ``use_kernel=False`` computes with the stock convolution instead of the
  kernel entry (a tower whose kernel policy leaves conv1 off the kernel
  path); the parameters are the same either way.
  """

  def __init__(self,
               in_features: int,
               features: int,
               kernel_size: Tuple[int, int],
               strides: Tuple[int, int] = (1, 1),
               padding: Union[str, Sequence[Tuple[int, int]]] = 'SAME',
               use_bias: bool = True,
               dtype: Optional[torch.dtype] = None,
               use_kernel: bool = True):
    super().__init__()
    kh, kw = kernel_size
    self.strides = tuple(strides)
    self.padding = padding
    self.dtype = dtype
    self.use_kernel = use_kernel
    self.kernel = nn.Parameter(torch.zeros(kh, kw, in_features, features))
    if use_bias:
      self.bias = nn.Parameter(torch.zeros(features))
    else:
      self.register_parameter('bias', None)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dtype = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
    x, kernel = x.to(dtype), self.kernel.to(dtype)
    conv = conv2d if self.use_kernel else reference_conv2d
    y = conv(x, kernel, self.strides, self.padding)
    if self.bias is not None:
      y = y + self.bias.to(dtype)
    return y
