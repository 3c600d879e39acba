"""Argmax-slot max pool: CUDA kernels for the card, plain versions for the CPU.

The port's counterpart of ``tensor2robot_tpu/ops/pool.py``. The forward
emits, beside each pooled value, the int32 row-major *window slot* that
won it; the backward routes the cotangent back through those slots.
Semantics are bitwise those of the TPU kernels:

* padding contributes ``-inf`` and never wins against finite data;
* the maximum moves only on a strictly greater value, so ties keep the
  FIRST maximal slot in row-major window order;
* where windows overlap, an input element sums the cotangents of the
  windows that selected it in ascending (oh, ow) order, in the
  cotangent's dtype, from +0;
* where they do not (stride == window), an input element has at most one
  window, and its gradient is that window's cotangent, bit for bit (NaN
  payloads and -0.0 included), or +0.

Entry points take NHWC tensors, as the JAX package does.
:func:`max_pool_argmax` (and :func:`max_pool` on top of it) goes through
the autograd Function :class:`MaxPoolArgmax` on every device. Its forward
is the custom op ``torch.ops.t2r.pool_fwd`` (:func:`pool_fwd_op`), which
dispatches on the tensor's device (``ops/_dispatch.py``): a CUDA tensor
launches :func:`pool_fwd` (``csrc/pool.cu``), a CPU tensor runs
:func:`plain_max_pool_argmax`; as one op it is one node of an exported
program (``export/exporters.py``), and its fake version gives the shapes
for a symbolic batch. Its backward dispatches the same way between
:func:`pool_bwd` and :func:`plain_max_pool_bwd`. :func:`reference_max_pool`
is the stock ``F.max_pool2d`` form, used by towers whose kernel policy
leaves pools off the kernel path and as a yardstick; no kernel entry calls
it.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from tensor2robot_tpu_torch.ops import _build
from tensor2robot_tpu_torch.ops import _dispatch as dispatch

Pads = Tuple[Tuple[int, int], Tuple[int, int]]

# The forward kernel's launch constants (kFwdThreads, kFwdMaxGridY, kFwdVec
# and kNarrowIndexBits in csrc/pool.cu) and the windows it instantiates
# with all taps in flight (fixed_window there). The backward's scatter
# route shares them. Its gather route (kGather* there) runs blocks of 256
# threads over tiles of up to 8 phase-block columns x 64 channels (8
# channel groups), two stages of the tile's windows, three blocks an SM of
# an H100 (132 SMs, 233,472 bytes of shared memory, 1,024 reserved a
# block, 232,448 at most a block); the 3x3/s2 window has an instantiation
# of its own.
_FWD_THREADS = 128
_FWD_MAX_GRID_Y = 65535
_FWD_VEC = 8
_NARROW_INDEX_BITS = 31
_FWD_WINDOWS = ((3, 3), (2, 2))
_GATHER_THREADS = 256
_GATHER_GROUPS = 8
_GATHER_TILE_COLS = 8
_GATHER_STAGES = 2
_GATHER_BLOCKS_PER_SM = 3
_GATHER_MAX_GRID_Y = 65535
_GATHER_WINDOW = ((3, 3), (2, 2))
_SMS = 132
_SM_SHARED_BYTES = 233472
_BLOCK_RESERVED_BYTES = 1024
_MAX_BLOCK_SHARED_BYTES = 232448
ROUTE_SCATTER = 'scatter'
ROUTE_GATHER = 'gather'

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    't2r_pool_fwd': [ctypes.c_void_p] * 3 + [ctypes.c_int] * 16 +
                    [ctypes.c_void_p],
    't2r_pool_bwd': [ctypes.c_void_p] * 3 + [ctypes.c_int] * 17 +
                    [ctypes.c_void_p],
}


def resolve_padding(padding: Union[str, Sequence[Tuple[int, int]]],
                    window: Tuple[int, int],
                    strides: Tuple[int, int],
                    spatial: Tuple[int, int]) -> Pads:
  """'SAME'/'VALID'/explicit -> explicit ((lo, hi), (lo, hi)), the way XLA
  resolves them for a windowed reduction (SAME puts the odd pixel of
  padding at the high end)."""
  if isinstance(padding, str):
    mode = padding.upper()
    if mode == 'VALID':
      return ((0, 0), (0, 0))
    if mode != 'SAME':
      raise ValueError(f'Unknown pool padding {padding!r}')
    pads = []
    for size, k, s in zip(spatial, window, strides):
      out = -(-size // s)
      total = max((out - 1) * s + k - size, 0)
      pads.append((total // 2, total - total // 2))
    return tuple(pads)  # type: ignore[return-value]
  pads = tuple((int(lo), int(hi)) for lo, hi in padding)
  if len(pads) != 2:
    raise ValueError(f'Expected 2 spatial pad pairs, got {padding!r}')
  return pads  # type: ignore[return-value]


def _out_size(size: int, k: int, s: int, lo: int, hi: int) -> int:
  return (size + lo + hi - k) // s + 1


def _plan(shape, window, strides, pads, dtype) -> Optional[dict]:
  """The pool geometry, or None where the pool is undefined."""
  if len(shape) != 4:
    return None
  _, h, w, c = shape
  (kh, kw), (sh, sw) = window, strides
  (plh, phh), (plw, phw) = pads
  if min(kh, kw, sh, sw) < 1 or min(plh, phh, plw, phw) < 0:
    return None
  if max(plh, phh) >= kh or max(plw, phw) >= kw:
    # A window lying wholly in padding has no element to select.
    return None
  if dtype not in _DTYPE_CODES:
    return None
  oh = _out_size(h, kh, sh, plh, phh)
  ow = _out_size(w, kw, sw, plw, phw)
  if oh < 1 or ow < 1 or c < 1:
    return None
  return dict(h=h, w=w, c=c, kh=kh, kw=kw, sh=sh, sw=sw, plh=plh, phh=phh,
              plw=plw, phw=phw, oh=oh, ow=ow)


def _require_plan(x: torch.Tensor, window, strides, pads) -> dict:
  plan = _plan(tuple(x.shape), tuple(window), tuple(strides), pads, x.dtype)
  if plan is None:
    raise ValueError(
        f'max_pool unsupported for shape {tuple(x.shape)} dtype {x.dtype} '
        f'window {window} strides {strides} pads {pads}.')
  return plan


def fwd_launch(shape: Sequence[int], window: Tuple[int, int],
               strides: Tuple[int, int], pads: Pads,
               aligned: bool = True) -> dict:
  """The forward kernel's launch choice, as ``launch_fwd`` in
  ``csrc/pool.cu`` makes it (the C entry refuses any other).

  ``aligned``: whether the input, pooled and slot pointers are all 16-byte
  aligned. Returns ``vec`` (8 channels a thread in 16-byte accesses, or 1),
  ``wide`` (64-bit offsets, for tensors of 2**31 elements or more),
  ``templated`` (a window with its own instantiation, all taps in flight;
  else the runtime loop), the block's ``threads`` and the ``grid``
  (x over a row's (ow, channel group) pairs, y over the B*OH rows, striding
  past the cap). Raises where the pool is undefined.
  """
  b, h, w, c = (int(d) for d in shape)
  # The geometry is the same for both dtypes the kernel takes.
  plan = _plan((b, h, w, c), tuple(window), tuple(strides), pads,
               torch.float32)
  if plan is None:
    raise ValueError(f'max_pool unsupported for shape {tuple(shape)} window '
                     f'{window} strides {strides} pads {pads}.')
  oh, ow = plan['oh'], plan['ow']
  limit = 2**_NARROW_INDEX_BITS
  if b * oh >= limit or ow * c >= limit:
    raise ValueError(f'max_pool output rows {b * oh} or row width {ow * c} '
                     'past the kernel\'s 32-bit grid.')
  vec = _FWD_VEC if aligned and c % _FWD_VEC == 0 else 1
  cols = ow * (c // vec)
  return dict(
      vec=vec,
      wide=int(b * h * w * c >= limit or b * oh * ow * c >= limit),
      templated=int(tuple(window) in _FWD_WINDOWS),
      threads=_FWD_THREADS,
      grid=(-(-cols // _FWD_THREADS), min(b * oh, _FWD_MAX_GRID_Y)))


def _gather_tiles(b: int, h: int, w: int, c: int, window, strides, pads,
                  vec: int, itemsize: int) -> dict:
  """The gather route's tiles, as ``gather_plan`` in ``csrc/pool.cu``
  makes them (see :func:`bwd_launch`)."""
  (kh, kw), (sh, sw) = window, strides
  (plh, _), (plw, _) = pads
  groups = c // vec
  cgs = min(_GATHER_GROUPS, groups)
  hr, hc = -(-kh // sh) - 1, -(-kw // sw) - 1
  m_lo, n_lo = plh // sh, plw // sw
  rows = (plh + h - 1) // sh - m_lo + 1
  cols = (plw + w - 1) // sw - n_lo + 1
  tc = min(_GATHER_TILE_COLS, cols)
  tr = min(_GATHER_THREADS // cgs // tc, rows)
  budget = (_SM_SHARED_BYTES // _GATHER_BLOCKS_PER_SM -
            _BLOCK_RESERVED_BYTES)
  while True:
    elems = (tr + hr) * (tc + hc) * cgs * vec
    g_bytes = -(-elems * itemsize // 16) * 16
    stage = g_bytes + 4 * elems
    if _GATHER_STAGES * stage <= budget:
      break
    if tr > 1:
      tr = -(-tr // 2)
    elif tc > 1:
      tc = -(-tc // 2)
    else:
      break
  staged = _GATHER_STAGES * stage <= _MAX_BLOCK_SHARED_BYTES
  smem = _GATHER_STAGES * stage if staged else 0
  row_tiles, col_tiles = -(-rows // tr), -(-cols // tc)
  spans = -(-groups // cgs)
  grid_x = col_tiles * spans
  per_sm = min(_GATHER_BLOCKS_PER_SM,
               _SM_SHARED_BYTES // (smem + _BLOCK_RESERVED_BYTES))
  grid_y = min(max(1, _SMS * per_sm // grid_x), b * row_tiles,
               _GATHER_MAX_GRID_Y)
  return dict(tile=(tr, tc), halo=(hr, hc), groups_per_span=cgs,
              spans=spans, block_origin=(m_lo, n_lo), blocks=(rows, cols),
              tiles=(row_tiles, col_tiles), staged=int(staged),
              g_bytes=g_bytes if staged else 0,
              stage_bytes=stage if staged else 0, smem=smem,
              grid=(grid_x, grid_y))


def bwd_launch(shape: Sequence[int], window: Tuple[int, int],
               strides: Tuple[int, int], pads: Pads,
               aligned: bool = True,
               dtype: torch.dtype = torch.bfloat16) -> dict:
  """The backward kernel's launch choice, as ``launch_bwd`` in
  ``csrc/pool.cu`` makes it (the C entry refuses any other).

  ``shape`` is the pool's input (dx) shape; ``aligned``: whether the
  cotangent, slot and dx pointers are all 16-byte aligned; ``dtype``: the
  cotangent's (it sizes the gather route's stages). Returns the ``route``
  (``'scatter'`` where windows do not overlap, stride == window: a thread
  per window stores its kh*kw positions; else ``'gather'``), ``vec`` (8
  channels a thread in 16-byte accesses, or 1), ``wide`` (64-bit offsets,
  for tensors of 2**31 elements or more), ``templated`` (a window with its
  own instantiation: 3x3 and 2x2 on the scatter route, all stores
  unrolled; 3x3 at stride 2 on the gather route), the block's ``threads``
  and the ``grid``. On the scatter route the grid is the forward's (x over
  a window row's (ow, channel group) pairs, y over the B*OH window rows,
  striding past the cap).

  On the gather route the input pixels fall into sh x sw phase blocks,
  block (m, n) holding padded rows m*sh .. and columns n*sw ..; a block's
  pixels are covered only by windows (m - hr .. m, n - hc .. n), ``halo``
  = (hr, hc) = (ceil(kh/sh) - 1, ceil(kw/sw) - 1). A thread owns one
  block x ``vec`` channels; the image's ``blocks`` (rows, columns, from
  ``block_origin``) go in tiles of ``tile`` blocks (``tiles`` an image) x
  a span of ``groups_per_span`` channel groups (``spans`` of them). A
  stage holds a tile's windows with the halo: ``g_bytes`` of cotangent,
  then the int32 slots, ``stage_bytes`` in all, two stages, ``smem`` a
  block; ``staged`` is 0 where even a 1 x 1 tile would not fit a block
  (the windows are then read from device memory). The ``grid`` is (tile
  columns x spans, persistent blocks striding over the B x tile rows).
  Raises where the pool is undefined.
  """
  b, h, w, c = (int(d) for d in shape)
  plan = _plan((b, h, w, c), tuple(window), tuple(strides), pads,
               torch.float32)
  if plan is None:
    raise ValueError(f'max_pool backward unsupported for shape '
                     f'{tuple(shape)} window {window} strides {strides} '
                     f'pads {pads}.')
  oh, ow = plan['oh'], plan['ow']
  limit = 2**_NARROW_INDEX_BITS
  scatter = tuple(window) == tuple(strides)
  if scatter and (b * oh >= limit or ow * c >= limit):
    raise ValueError(f'max_pool backward window rows {b * oh} or row width '
                     f'{ow * c} past the kernel\'s 32-bit grid.')
  vec = _FWD_VEC if aligned and c % _FWD_VEC == 0 else 1
  launch = dict(
      route=ROUTE_SCATTER if scatter else ROUTE_GATHER, vec=vec,
      wide=int(b * h * w * c >= limit or b * oh * ow * c >= limit),
      templated=int(tuple(window) in _FWD_WINDOWS if scatter else
                    (tuple(window), tuple(strides)) == _GATHER_WINDOW))
  if scatter:
    cols = ow * (c // vec)
    launch.update(threads=_FWD_THREADS,
                  grid=(-(-cols // _FWD_THREADS), min(b * oh,
                                                      _FWD_MAX_GRID_Y)))
  else:
    launch.update(threads=_GATHER_THREADS,
                  **_gather_tiles(b, h, w, c, window, strides, pads, vec,
                                  dtype.itemsize))
  return launch


def _aligned(*tensors: torch.Tensor) -> bool:
  return all(t.data_ptr() % 16 == 0 for t in tensors)


def _cuda_input(x: torch.Tensor) -> None:
  """Raises unless ``x`` is a contiguous tensor on a CUDA device."""
  if x.device.type != 'cuda':
    raise ValueError(f'pool_fwd takes a CUDA tensor, got {x.device}.')
  if not x.is_contiguous():
    raise ValueError('pool_fwd takes a contiguous NHWC tensor.')


def pool_fwd(x: torch.Tensor, window: Tuple[int, int],
             strides: Tuple[int, int],
             pads: Pads) -> Tuple[torch.Tensor, torch.Tensor]:
  """Launches the CUDA kernel (``csrc/pool.cu``) on the current stream.

  ``x``: contiguous NHWC float32 or bfloat16 on a CUDA device. Returns
  (pooled in x's dtype, int32 slot), both [B, OH, OW, C]. The launch
  choice is :func:`fwd_launch`'s. Raises on any other input, and when the
  launch reports an error.
  """
  _cuda_input(x)
  p = _require_plan(x, window, strides, pads)
  b = x.shape[0]
  out = torch.empty((b, p['oh'], p['ow'], p['c']), dtype=x.dtype,
                    device=x.device)
  slot = torch.empty(out.shape, dtype=torch.int32, device=x.device)
  launch = fwd_launch(x.shape, window, strides, pads,
                      aligned=_aligned(x, out, slot))
  lib = _build.load('pool', _SIGNATURES)
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.t2r_pool_fwd(
        x.data_ptr(), out.data_ptr(), slot.data_ptr(), _DTYPE_CODES[x.dtype],
        b, p['h'], p['w'], p['c'], p['kh'], p['kw'], p['sh'], p['sw'],
        p['plh'], p['plw'], p['oh'], p['ow'], launch['vec'], launch['wide'],
        launch['templated'], stream)
  _build.check(lib, status, 'pool_fwd')
  pool_fwd.launches += 1
  return out, slot


pool_fwd.launches = 0


def plain_max_pool_argmax(x: torch.Tensor, window: Tuple[int, int],
                          strides: Tuple[int, int],
                          pads: Pads) -> Tuple[torch.Tensor, torch.Tensor]:
  """The kernel's function in plain PyTorch, on any device.

  Explicit ``-inf`` padding, then the window taps in row-major slot order
  with a strictly-greater update, so ties resolve to the first slot.
  """
  p = _require_plan(x, window, strides, pads)
  kh, kw, sh, sw = p['kh'], p['kw'], p['sh'], p['sw']
  oh, ow = p['oh'], p['ow']
  xp = F.pad(x, (0, 0, p['plw'], p['phw'], p['plh'], p['phh']),
             value=float('-inf'))
  best = slot = None
  for dy in range(kh):
    for dx in range(kw):
      vals = xp[:, dy:dy + (oh - 1) * sh + 1:sh, dx:dx + (ow - 1) * sw + 1:sw]
      if best is None:
        best = vals.clone()
        slot = torch.zeros(vals.shape, dtype=torch.int32, device=x.device)
        continue
      take = vals > best
      best = torch.where(take, vals, best)
      slot = torch.where(take, torch.full_like(slot, dy * kw + dx), slot)
  return best, slot


def _cuda_cotangent(g: torch.Tensor, slot: torch.Tensor) -> None:
  """Raises unless ``g`` and ``slot`` are contiguous tensors on one CUDA
  device."""
  if g.device.type != 'cuda' or slot.device != g.device:
    raise ValueError(
        f'pool_bwd takes CUDA tensors on one device, got {g.device} and '
        f'{slot.device}.')
  if not (g.is_contiguous() and slot.is_contiguous()):
    raise ValueError('pool_bwd takes a contiguous NHWC cotangent and slots.')


def pool_bwd(g: torch.Tensor, slot: torch.Tensor, x_shape: Sequence[int],
             window: Tuple[int, int], strides: Tuple[int, int],
             pads: Pads) -> torch.Tensor:
  """Launches the routing backward (``csrc/pool.cu``) on the current stream.

  ``g``: contiguous NHWC float32 or bfloat16 cotangent of the pooled
  output, ``slot``: the forward's contiguous int32 slots of the same shape,
  both on one CUDA device. Returns dx of shape ``x_shape`` in g's dtype.
  The launch choice is :func:`bwd_launch`'s; a launch on the scatter route
  is also counted in ``scatter_launches``. Raises on any other input, and
  when the launch reports an error.
  """
  _cuda_cotangent(g, slot)
  p = _plan(tuple(x_shape), tuple(window), tuple(strides), pads, g.dtype)
  b = int(x_shape[0])
  out_shape = (b, p['oh'], p['ow'], p['c']) if p else None
  if (p is None or tuple(g.shape) != out_shape or
      tuple(slot.shape) != out_shape or slot.dtype != torch.int32):
    raise ValueError(
        f'pool_bwd unsupported for g {tuple(g.shape)} {g.dtype}, slot '
        f'{tuple(slot.shape)} {slot.dtype}, x shape {tuple(x_shape)}, '
        f'window {window} strides {strides} pads {pads}.')
  dx = torch.empty(tuple(x_shape), dtype=g.dtype, device=g.device)
  launch = bwd_launch(x_shape, window, strides, pads,
                      aligned=_aligned(g, slot, dx), dtype=g.dtype)
  scatter = launch['route'] == ROUTE_SCATTER
  lib = _build.load('pool', _SIGNATURES)
  with torch.cuda.device(g.device):
    stream = torch.cuda.current_stream(g.device).cuda_stream
    status = lib.t2r_pool_bwd(
        g.data_ptr(), slot.data_ptr(), dx.data_ptr(), _DTYPE_CODES[g.dtype],
        b, p['h'], p['w'], p['c'], p['kh'], p['kw'], p['sh'], p['sw'],
        p['plh'], p['plw'], p['oh'], p['ow'], int(scatter), launch['vec'],
        launch['wide'], launch['templated'], stream)
  _build.check(lib, status, 'pool_bwd')
  pool_bwd.launches += 1
  pool_bwd.scatter_launches += scatter
  return dx


pool_bwd.launches = 0
pool_bwd.scatter_launches = 0


def plain_max_pool_bwd(g: torch.Tensor, slot: torch.Tensor,
                       x_shape: Sequence[int], window: Tuple[int, int],
                       strides: Tuple[int, int], pads: Pads) -> torch.Tensor:
  """The backward kernel's function in plain PyTorch, on any device.

  Each slot's routed cotangent (``g`` where the slot won, else 0) is added
  into the padded extent, from +0, at its stride and offset, slots in
  reverse row-major order, so the windows covering one element add in
  ascending (oh, ow) order, in g's dtype; then the padding is cropped off.
  Where windows do not overlap the routed cotangents are placed, not
  added, so an element is its window's ``g`` bit for bit or +0, as the
  TPU kernel's interleave branch has it.
  """
  p = _plan(tuple(x_shape), tuple(window), tuple(strides), pads, g.dtype)
  if p is None or tuple(g.shape[1:3]) != (p['oh'], p['ow']):
    raise ValueError(
        f'max_pool backward unsupported for g {tuple(g.shape)} {g.dtype}, '
        f'x shape {tuple(x_shape)}, window {window} strides {strides} '
        f'pads {pads}.')
  kh, kw, sh, sw = p['kh'], p['kw'], p['sh'], p['sw']
  oh, ow = p['oh'], p['ow']
  # The windows' extent in the padded input covers every padded element.
  acc = g.new_zeros((g.shape[0], oh * sh + kh - 1, ow * sw + kw - 1,
                     g.shape[3]))
  zero = g.new_zeros(())
  disjoint = (sh, sw) == (kh, kw)
  for dy in reversed(range(kh)):
    for dx in reversed(range(kw)):
      routed = torch.where(slot == dy * kw + dx, g, zero)
      view = acc[:, dy:dy + (oh - 1) * sh + 1:sh, dx:dx + (ow - 1) * sw + 1:sw]
      if disjoint:
        view.copy_(routed)
      else:
        view += routed
  return acc[:, p['plh']:p['plh'] + p['h'], p['plw']:p['plw'] + p['w']]


def _pads_list(pads: Pads) -> List[int]:
  (plh, phh), (plw, phw) = pads
  return [int(plh), int(phh), int(plw), int(phw)]


def _pads_pairs(pads: Sequence[int]) -> Pads:
  plh, phh, plw, phw = pads
  return ((plh, phh), (plw, phw))


@torch.library.custom_op('t2r::pool_fwd', mutates_args=())
def pool_fwd_op(x: torch.Tensor, window: List[int], strides: List[int],
                pads: List[int]) -> Tuple[torch.Tensor, torch.Tensor]:
  """``torch.ops.t2r.pool_fwd``: (pooled, slot) of NHWC ``x``, both
  NHWC-contiguous; ``pads`` is (lo_h, hi_h, lo_w, hi_w). A CUDA tensor
  launches :func:`pool_fwd` (copied to contiguous first where it is not), a
  CPU tensor runs :func:`plain_max_pool_argmax`; the gate is
  ``ops/_dispatch.py``'s. As one op, the pool is one node of an exported
  program (``torch.export``), which dispatches by device where it runs."""
  window, strides, pairs = tuple(window), tuple(strides), _pads_pairs(pads)
  if dispatch.kernels_enabled(x):
    return pool_fwd(x.contiguous(), window, strides, pairs)
  out, slot = plain_max_pool_argmax(x, window, strides, pairs)
  return out.contiguous(), slot.contiguous()


@pool_fwd_op.register_fake
def _pool_fwd_fake(x, window, strides, pads):
  """The outputs' shapes from the geometry alone (the batch may be
  symbolic); no launch choice is made."""
  p = _require_plan(x, tuple(window), tuple(strides), _pads_pairs(pads))
  shape = (x.shape[0], p['oh'], p['ow'], p['c'])
  return x.new_empty(shape), x.new_empty(shape, dtype=torch.int32)


class MaxPoolArgmax(torch.autograd.Function):
  """(pooled, slot) = max pool of NHWC ``x``, differentiable in ``x``.

  The forward (``torch.ops.t2r.pool_fwd``) saves the slots; the backward
  routes the pooled output's cotangent through them. Each direction runs
  the kernel for a CUDA tensor and the plain version for a CPU tensor.
  The slot output is not differentiable.

  A cotangent that arrives in another layout than NHWC-contiguous (the
  towers read pooled outputs through NCHW channels-last views, so a
  consumer may hand back an NCHW-contiguous gradient) is copied once
  before the kernel reads it; :attr:`cotangent_copies` counts those
  copies.
  """

  cotangent_copies = 0

  @staticmethod
  def forward(ctx, x, window, strides, pads):  # pylint: disable=arguments-differ
    out, slot = torch.ops.t2r.pool_fwd(x, list(window), list(strides),
                                       _pads_list(pads))
    ctx.save_for_backward(slot)
    ctx.geometry = (tuple(x.shape), window, strides, pads)
    ctx.mark_non_differentiable(slot)
    return out, slot

  @staticmethod
  def backward(ctx, g, g_slot):  # pylint: disable=arguments-differ
    del g_slot
    (slot,) = ctx.saved_tensors
    if not g.is_contiguous():
      g = g.contiguous()
      MaxPoolArgmax.cotangent_copies += 1
    if dispatch.kernels_enabled(g):
      dx = pool_bwd(g, slot, *ctx.geometry)
    else:
      dx = plain_max_pool_bwd(g, slot, *ctx.geometry)
    return dx, None, None, None


def max_pool_argmax(x: torch.Tensor, window: Tuple[int, int],
                    strides: Tuple[int, int],
                    pads: Pads) -> Tuple[torch.Tensor, torch.Tensor]:
  """(pooled, window-slot argmax) for NHWC ``x`` with explicit ``pads``,
  through :class:`MaxPoolArgmax`: the kernels on a CUDA tensor, the plain
  versions on a CPU tensor."""
  return MaxPoolArgmax.apply(x, tuple(window), tuple(strides),
                             tuple(tuple(p) for p in pads))


def max_pool(x: torch.Tensor, window_shape: Tuple[int, int],
             strides: Optional[Tuple[int, int]] = None,
             padding: Union[str, Sequence[Tuple[int, int]]] = 'VALID'
             ) -> torch.Tensor:
  """NHWC max pool through :func:`max_pool_argmax` (the kernel entry)."""
  window = tuple(window_shape)
  strides = tuple(strides or (1,) * len(window))
  pads = resolve_padding(padding, window, strides, tuple(x.shape[1:3]))
  return max_pool_argmax(x, window, strides, pads)[0]


def reference_max_pool(x: torch.Tensor, window_shape: Tuple[int, int],
                       strides: Optional[Tuple[int, int]] = None,
                       padding: Union[str, Sequence[Tuple[int, int]]] = 'VALID',
                       return_indices: bool = False):
  """The stock PyTorch form on NHWC ``x``: explicit ``-inf`` padding, then
  ``F.max_pool2d`` on the NCHW view. Not a kernel path."""
  window = tuple(window_shape)
  strides = tuple(strides or (1,) * len(window))
  (plh, phh), (plw, phw) = resolve_padding(padding, window, strides,
                                           tuple(x.shape[1:3]))
  xp = F.pad(x.permute(0, 3, 1, 2), (plw, phw, plh, phh),
             value=float('-inf'))
  result = F.max_pool2d(xp, window, strides, return_indices=return_indices)
  if return_indices:
    return result[0].permute(0, 2, 3, 1), result[1].permute(0, 2, 3, 1)
  return result.permute(0, 2, 3, 1)
