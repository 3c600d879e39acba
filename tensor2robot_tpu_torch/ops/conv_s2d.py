"""Space-to-depth first-layer conv: CUDA kernel for the card, plain version
for the CPU.

The port's counterpart of ``tensor2robot_tpu/ops/conv_s2d.py`` (forward
only; dW and dx come with the training slice). A shallow-input conv
(QT-Opt conv1: 6x6/s2, 3 -> 64 channels) is computed as an im2col product
of [pixels, kh*kw*Cin] patches with the [kh*kw*Cin, Cout] weight matrix,
in float32 accumulation, in the tap order (dy, dx, cin).

Entry points take NHWC activations and HWIO weights, as the JAX package
does. :func:`conv2d` dispatches on the tensor's device
(``ops/_dispatch.py``): a CUDA tensor launches :func:`conv_s2d_fwd` (the
kernel in ``csrc/conv_s2d.cu``), a CPU tensor runs :func:`plain_conv2d`.
Results are banded, not bitwise, against a stock convolution
(reassociated sums): 1e-5 in float32.

:class:`SpaceToDepthConv` is the module form. Its parameter tree is that
of flax's ``nn.Conv``: a ``kernel`` of shape (kh, kw, cin, cout) and an
optional ``bias``, so weights move between the packages unchanged.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.ops import _build
from tensor2robot_tpu_torch.ops import _dispatch as dispatch
from tensor2robot_tpu_torch.ops.pool import Pads, resolve_padding

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    't2r_conv_s2d_fwd': [ctypes.c_void_p] * 3 + [ctypes.c_int] * 14 +
                        [ctypes.c_void_p],
}
# The patch depth kh*kw*Cin this form is for: a deep-Cin conv is already
# matmul-shaped and belongs to the stock convolution.
_MAX_CIN = 8
_MAX_PATCH_DEPTH = 512
# Dynamic shared memory per block on an H100, and the kernel's tile of
# output pixels (kPixels in csrc/conv_s2d.cu): the block stages the float32
# weight matrix and one [patch, pixels] patch matrix.
_MAX_SMEM_BYTES = 232448
_TILE_PIXELS = 64


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
  smem = 4 * ((patch * cout + 3) // 4 * 4 + patch * _TILE_PIXELS)
  if smem > _MAX_SMEM_BYTES:
    return None
  return dict(h=h, w=w, cin=cin, cout=cout, kh=kh, kw=kw, sh=sh, sw=sw,
              plh=plh, phh=phh, plw=plw, phw=phw, oh=oh, ow=ow, patch=patch)


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
  """Launches the CUDA kernel (``csrc/conv_s2d.cu``) on the current stream.

  ``x``: contiguous NHWC, ``w``: contiguous HWIO, both float32 or both
  bfloat16 on one CUDA device. Returns NHWC in the input dtype. Raises on
  any other input, and when the launch reports an error.
  """
  if x.device.type != 'cuda' or w.device != x.device:
    raise ValueError(
        f'conv_s2d_fwd takes CUDA tensors on one device, got {x.device} and '
        f'{w.device}.')
  if not (x.is_contiguous() and w.is_contiguous()):
    raise ValueError('conv_s2d_fwd takes contiguous NHWC x and HWIO w.')
  p = _require_plan(x, w, strides, pads)
  b = x.shape[0]
  out = torch.empty((b, p['oh'], p['ow'], p['cout']), dtype=x.dtype,
                    device=x.device)
  lib = _build.load('conv_s2d', _SIGNATURES)
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.t2r_conv_s2d_fwd(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), _DTYPE_CODES[x.dtype], b,
        p['h'], p['w'], p['cin'], p['kh'], p['kw'], p['sh'], p['sw'],
        p['plh'], p['plw'], p['oh'], p['ow'], p['cout'], stream)
  _build.check(lib, status, 'conv_s2d_fwd')
  conv_s2d_fwd.launches += 1
  return out


conv_s2d_fwd.launches = 0


def plain_conv2d(x: torch.Tensor, w: torch.Tensor, strides: Tuple[int, int],
                 pads: Pads) -> torch.Tensor:
  """The kernel's function in plain PyTorch, on any device: an explicit
  im2col in tap order (dy, dx, cin), then one float32 matmul."""
  p = _require_plan(x, w, strides, pads)
  sh, sw, oh, ow = p['sh'], p['sw'], p['oh'], p['ow']
  xp = F.pad(x, (0, 0, p['plw'], p['phw'], p['plh'], p['phh']))
  taps = [
      xp[:, dy:dy + (oh - 1) * sh + 1:sh, dx:dx + (ow - 1) * sw + 1:sw]
      for dy in range(p['kh']) for dx in range(p['kw'])
  ]
  patches = torch.cat(taps, dim=-1).reshape(-1, p['patch'])
  out = patches.float() @ w.reshape(p['patch'], p['cout']).float()
  return out.reshape(x.shape[0], oh, ow, p['cout']).to(x.dtype)


def conv2d(x: torch.Tensor, w: torch.Tensor, strides: Tuple[int, int],
           padding: Union[str, Sequence[Tuple[int, int]]]) -> torch.Tensor:
  """NHWC x HWIO conv through the kernel entry: the kernel on a CUDA
  tensor, the plain version on a CPU tensor."""
  strides = tuple(strides)
  pads = resolve_padding(padding, tuple(w.shape[:2]), strides,
                         tuple(x.shape[1:3]))
  if dispatch.kernels_enabled(x):
    return conv_s2d_fwd(x.contiguous(), w.contiguous(), strides, pads)
  return plain_conv2d(x, w, strides, pads)


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
