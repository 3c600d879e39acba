"""Fused photometric pass: a CUDA kernel for the card, a plain version for
the CPU.

The port's counterpart of ``tensor2robot_tpu/ops/photometric.py``: per
image, brightness shift, contrast about the per-channel spatial mean, clip
to [0, 1], over ``[B, H, W, C]`` images, computed in float32 and written in
the input's dtype (float32 or bfloat16).

* :func:`fused_brightness_contrast` is the custom op ``t2r::photometric``
  (:func:`photometric_op`), which dispatches on the images' device
  (``ops/_dispatch.py``): a CUDA tensor launches :func:`photometric`
  (``csrc/photometric.cu``: a per-slice sum kernel, then an apply kernel,
  counted as one launch of the pass), a CPU tensor runs
  :func:`plain_brightness_contrast`. As one op, the pass is one node of an
  exported program.
* :func:`random_brightness_contrast` draws each image's brightness shift,
  then its contrast factor, from a ``torch.Generator`` with the shapes and
  in the order of the stock chain
  (``preprocessors.image_transformations.apply_photometric_image_distortions``),
  so that the fused and the stock branch agree on one generator.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from tensor2robot_tpu_torch.ops import _build
from tensor2robot_tpu_torch.ops import _dispatch as dispatch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    't2r_photometric': [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 +
                       [ctypes.c_void_p],
}
# A block's stride (192 threads x 4 elements): a multiple of every channel
# count the kernel takes, so each thread keeps its channels over a slice.
_UNIT = 768
_SLICE = 16 * _UNIT  # elements per block at most
MAX_CHANNELS = 4


def uniform(generator: Optional[torch.Generator], shape: Sequence[int],
            low: float, high: float, device) -> torch.Tensor:
  """Uniform [low, high) draws from ``generator`` (on the generator's
  device), moved to ``device``."""
  u = torch.rand(tuple(shape), generator=generator,
                 device=generator.device if generator is not None else 'cpu')
  return (u * (high - low) + low).to(device)


def _geometry(shape) -> Tuple[int, int, int, int]:
  """(pixels, channels, slice, slices) of [B, H, W, C] images: slices of a
  multiple of 768 elements cover each image's H*W*C elements."""
  _, h, w, c = shape
  elements = h * w * c
  slice_ = min(_SLICE, -(-elements // _UNIT) * _UNIT)
  return h * w, c, slice_, -(-elements // slice_)


def _check(images: torch.Tensor, delta: torch.Tensor,
           factor: torch.Tensor) -> None:
  if images.dim() != 4 or images.shape[0] < 1 or images.numel() == 0:
    raise ValueError(
        f'photometric takes [B, H, W, C] images, got {tuple(images.shape)}.')
  if images.dtype not in _DTYPE_CODES:
    raise ValueError(f'photometric takes float32 or bfloat16 images, got '
                     f'{images.dtype}.')
  batch = images.shape[0]
  if delta.numel() != batch or factor.numel() != batch:
    raise ValueError(
        f'photometric takes one brightness delta and one contrast factor per '
        f'image: {batch} images, {delta.numel()} and {factor.numel()}.')


def photometric(images: torch.Tensor, delta: torch.Tensor,
                factor: torch.Tensor) -> torch.Tensor:
  """Launches the CUDA pass (``csrc/photometric.cu``, two kernels) on the
  current stream.

  ``images``: contiguous [B, H, W, C] float32 or bfloat16 on a CUDA device,
  C from 1 to 4; ``delta``, ``factor``: B values each. Returns the distorted
  images in the input's dtype. Raises on any other input, and when a launch
  reports an error.
  """
  if images.device.type != 'cuda':
    raise ValueError(f'photometric takes a CUDA tensor, got {images.device}.')
  _check(images, delta, factor)
  if not images.is_contiguous():
    raise ValueError('photometric takes contiguous NHWC images.')
  batch = images.shape[0]
  pixels, channels, slice_, slices = _geometry(images.shape)
  if channels > MAX_CHANNELS:
    raise ValueError(f'photometric takes 1 to {MAX_CHANNELS} channels, got '
                     f'{channels}.')
  delta = delta.to(device=images.device, dtype=torch.float32).reshape(
      batch).contiguous()
  factor = factor.to(device=images.device, dtype=torch.float32).reshape(
      batch).contiguous()
  partials = torch.empty((batch, slices, channels), dtype=torch.float32,
                         device=images.device)
  out = torch.empty_like(images)
  lib = _build.load('photometric', _SIGNATURES)
  with torch.cuda.device(images.device):
    stream = torch.cuda.current_stream(images.device).cuda_stream
    status = lib.t2r_photometric(
        images.data_ptr(), delta.data_ptr(), factor.data_ptr(),
        partials.data_ptr(), out.data_ptr(), _DTYPE_CODES[images.dtype],
        batch, pixels, channels, slice_, slices, stream)
  _build.check(lib, status, 'photometric')
  photometric.launches += 1
  return out


photometric.launches = 0


def plain_brightness_contrast(images: torch.Tensor, delta: torch.Tensor,
                              factor: torch.Tensor) -> torch.Tensor:
  """The kernel's function in plain PyTorch, on any device: ``x = image +
  delta`` in float32, the per-channel mean over H and W, ``(x - mean) *
  factor + mean``, clip to [0, 1], cast back to the input's dtype."""
  _check(images, delta, factor)
  shape = (images.shape[0], 1, 1, 1)
  x = images.float() + delta.to(images.device, torch.float32).reshape(shape)
  mean = x.mean(dim=(1, 2), keepdim=True)
  out = (x - mean) * factor.to(images.device, torch.float32).reshape(
      shape) + mean
  return torch.clamp(out, 0.0, 1.0).to(images.dtype)


@torch.library.custom_op('t2r::photometric', mutates_args=())
def photometric_op(images: torch.Tensor, delta: torch.Tensor,
                   factor: torch.Tensor) -> torch.Tensor:
  """``torch.ops.t2r.photometric``: the distorted [B, H, W, C] images. A
  CUDA tensor launches :func:`photometric` (copied to contiguous first
  where it is not), a CPU tensor runs :func:`plain_brightness_contrast`;
  the gate is ``ops/_dispatch.py``'s."""
  if dispatch.kernels_enabled(images):
    return photometric(images.contiguous(), delta, factor)
  return plain_brightness_contrast(images, delta, factor).contiguous()


@photometric_op.register_fake
def _photometric_fake(images, delta, factor):
  """The output's shape alone (the batch may be symbolic)."""
  _check(images, delta, factor)
  return torch.empty_like(images, memory_format=torch.contiguous_format)


def _photometric_setup_context(ctx, inputs, output):
  del output
  ctx.save_for_backward(*inputs)


def _photometric_backward(ctx, g):
  """The plain version's vector-Jacobian product: the pass is applied to
  inputs that need no gradient in training (a preprocessor's images), so
  its backward has no kernel."""
  _, vjp = torch.func.vjp(plain_brightness_contrast, *ctx.saved_tensors)
  return vjp(g)


photometric_op.register_autograd(_photometric_backward,
                                 setup_context=_photometric_setup_context)


def fused_brightness_contrast(images: torch.Tensor, delta: torch.Tensor,
                              factor: torch.Tensor) -> torch.Tensor:
  """Brightness + contrast + clip over [B, H, W, C] images with per-image
  ``delta`` and ``factor``, through ``torch.ops.t2r.photometric``: the
  kernel for a CUDA tensor, the plain version for a CPU tensor."""
  return torch.ops.t2r.photometric(images, delta, factor)


def random_brightness_contrast(images: torch.Tensor,
                               generator: Optional[torch.Generator] = None,
                               max_delta_brightness: float = 0.125,
                               lower_contrast: float = 0.5,
                               upper_contrast: float = 1.5) -> torch.Tensor:
  """Draws per-image parameters and applies the fused pass.

  The draws are the stock chain's: brightness ``(B, 1, 1, 1)`` in
  [-max_delta, max_delta), then contrast ``(B, 1, 1, 1)`` in [lower,
  upper), from ``generator``. So on one generator this equals
  ``apply_photometric_image_distortions(random_brightness=True,
  random_contrast=True)`` within float32 rounding of the mean.
  """
  shape = (images.shape[0], 1, 1, 1)
  delta = uniform(generator, shape, -max_delta_brightness,
                  max_delta_brightness, images.device)
  factor = uniform(generator, shape, lower_contrast, upper_contrast,
                   images.device)
  return fused_brightness_contrast(images, delta, factor)
