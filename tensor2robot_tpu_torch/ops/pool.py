"""Argmax-slot max pool: CUDA kernel for the card, plain version for the CPU.

The port's counterpart of ``tensor2robot_tpu/ops/pool.py`` (forward only;
the routing backward comes with the training slice). The forward emits,
beside each pooled value, the int32 row-major *window slot* that won it.
Semantics are bitwise those of the TPU kernel:

* padding contributes ``-inf`` and never wins against finite data;
* the maximum moves only on a strictly greater value, so ties keep the
  FIRST maximal slot in row-major window order.

Entry points take NHWC tensors, as the JAX package does.
:func:`max_pool_argmax` dispatches on the tensor's device
(``ops/_dispatch.py``): a CUDA tensor launches :func:`pool_fwd` (the
kernel in ``csrc/pool.cu``), a CPU tensor runs :func:`plain_max_pool_argmax`.
:func:`reference_max_pool` is the stock ``F.max_pool2d`` form, used by
towers whose kernel policy leaves pools off the kernel path and as a
yardstick; no kernel entry calls it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from tensor2robot_tpu_torch.ops import _build
from tensor2robot_tpu_torch.ops import _dispatch as dispatch

Pads = Tuple[Tuple[int, int], Tuple[int, int]]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    't2r_pool_fwd': [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 +
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


def pool_fwd(x: torch.Tensor, window: Tuple[int, int],
             strides: Tuple[int, int],
             pads: Pads) -> Tuple[torch.Tensor, torch.Tensor]:
  """Launches the CUDA kernel (``csrc/pool.cu``) on the current stream.

  ``x``: contiguous NHWC float32 or bfloat16 on a CUDA device. Returns
  (pooled in x's dtype, int32 slot), both [B, OH, OW, C]. Raises on any
  other input, and when the launch reports an error.
  """
  if x.device.type != 'cuda':
    raise ValueError(f'pool_fwd takes a CUDA tensor, got {x.device}.')
  if not x.is_contiguous():
    raise ValueError('pool_fwd takes a contiguous NHWC tensor.')
  p = _require_plan(x, window, strides, pads)
  b = x.shape[0]
  out = torch.empty((b, p['oh'], p['ow'], p['c']), dtype=x.dtype,
                    device=x.device)
  slot = torch.empty(out.shape, dtype=torch.int32, device=x.device)
  lib = _build.load('pool', _SIGNATURES)
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.t2r_pool_fwd(
        x.data_ptr(), out.data_ptr(), slot.data_ptr(), _DTYPE_CODES[x.dtype],
        b, p['h'], p['w'], p['c'], p['kh'], p['kw'], p['sh'], p['sw'],
        p['plh'], p['plw'], p['oh'], p['ow'], stream)
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


def max_pool_argmax(x: torch.Tensor, window: Tuple[int, int],
                    strides: Tuple[int, int],
                    pads: Pads) -> Tuple[torch.Tensor, torch.Tensor]:
  """(pooled, window-slot argmax) for NHWC ``x`` with explicit ``pads``:
  the kernel on a CUDA tensor, the plain version on a CPU tensor."""
  if dispatch.kernels_enabled(x):
    return pool_fwd(x, window, strides, pads)
  return plain_max_pool_argmax(x, window, strides, pads)


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
