"""Device-side image transformations on torch tensors.

The port's counterpart of
``tensor2robot_tpu/preprocessors/image_transformations.py``: the crops and
the photometric distortion chain. Images are ``[batch, H, W, C]`` (crops
also take uint8; the photometric chain takes float images in [0, 1]). A
crop is a view, so it costs no copy until the next op reads it.

Randomness comes from an explicit ``torch.Generator`` where the JAX
package takes a key. The two give different numbers from one seed, so a
test that needs both packages to agree injects the crop offsets
(``offsets=``) or leaves the distortions off. A step inside a captured
CUDA graph cannot draw on the host: it crops, or crops and resizes, at
offsets drawn beforehand and handed over on the device
(:func:`crop_at_device_offsets`, :func:`crop_resize_at_device_offsets`).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch._subclasses import fake_tensor

from tensor2robot_tpu_torch.ops import photometric
from tensor2robot_tpu_torch.preprocessors.base import DeviceDraws


def _check_crop(input_shape, target_shape) -> None:
  if len(target_shape) != 2:
    raise ValueError(f'target_shape must be (h, w), got {target_shape}')
  if target_shape[0] > input_shape[-3] or target_shape[1] > input_shape[-2]:
    raise ValueError(
        f'Crop {target_shape} larger than image {tuple(input_shape[-3:-1])}')


def random_crop_offsets(generator: Optional[torch.Generator],
                        image_shape: Sequence[int],
                        target_shape: Sequence[int]) -> Tuple[int, int]:
  """The (row, column) offsets of one random crop, drawn on the host from
  ``generator`` (a CPU generator): the row first, then the column."""
  _check_crop(image_shape, target_shape)
  h, w = image_shape[-3], image_shape[-2]
  oh = int(torch.randint(0, h - int(target_shape[0]) + 1, (),
                         generator=generator))
  ow = int(torch.randint(0, w - int(target_shape[1]) + 1, (),
                         generator=generator))
  return oh, ow


def random_crop_images(images: torch.Tensor,
                       target_shape: Sequence[int],
                       generator: Optional[torch.Generator] = None,
                       offsets: Optional[Tuple[int, int]] = None
                       ) -> torch.Tensor:
  """Random spatial crop with ONE offset shared across the batch.

  The offsets (row, column) are drawn on the host from ``generator``
  (:func:`random_crop_offsets`), so the crop itself is a view with no
  device round trip; ``offsets`` injects them instead, and must lie in
  range.
  """
  _check_crop(images.shape, target_shape)
  th, tw = int(target_shape[0]), int(target_shape[1])
  h, w = images.shape[-3], images.shape[-2]
  if offsets is None:
    oh, ow = random_crop_offsets(generator, images.shape, target_shape)
  else:
    oh, ow = (int(o) for o in offsets)
    if not (0 <= oh <= h - th and 0 <= ow <= w - tw):
      raise ValueError(
          f'Crop offsets {offsets} out of range for a {target_shape} crop '
          f'of {(h, w)}')
  return images[..., oh:oh + th, ow:ow + tw, :]


def crop_at_device_offsets(images: torch.Tensor,
                           target_shape: Sequence[int],
                           offsets: torch.Tensor) -> torch.Tensor:
  """The crop of :func:`random_crop_images` at offsets that lie on the
  images' device: ``offsets`` is an int64 tensor (row, column), in range
  (they come from :func:`random_crop_offsets`). One gather by index
  arithmetic (the JAX package's crop is XLA's ``dynamic_slice``), so no
  value is read back to the host and a captured CUDA graph takes new
  offsets at each replay. The same elements as the view, in a contiguous
  tensor."""
  _check_crop(images.shape, target_shape)
  th, tw = int(target_shape[0]), int(target_shape[1])
  offsets = offsets.to(images.device)
  rows = offsets[0] + torch.arange(th, device=images.device)
  cols = offsets[1] + torch.arange(tw, device=images.device)
  return images[..., rows[:, None], cols[None, :], :]


def center_crop_images(images: torch.Tensor,
                       target_shape: Sequence[int]) -> torch.Tensor:
  """Deterministic center crop (eval-time counterpart of random crop)."""
  _check_crop(images.shape, target_shape)
  th, tw = int(target_shape[0]), int(target_shape[1])
  h, w = images.shape[-3], images.shape[-2]
  oh, ow = (h - th) // 2, (w - tw) // 2
  return images[..., oh:oh + th, ow:ow + tw, :]


@functools.lru_cache(maxsize=None)
def resize_weights(input_size: int, output_size: int) -> np.ndarray:
  """[output_size, input_size] float32 weights of ``jax.image.resize(...,
  method='bilinear')`` along one axis: the rows of resizing an identity.

  The triangle kernel is widened by the inverse scale on a downscale
  (antialiasing), each output's weights are normalised to sum to 1, and
  outputs whose sample point falls outside the input get none; computed
  in float32 as ``jax.image.scale.compute_weight_mat`` computes it.
  ``F.interpolate`` does not antialias this way, so it is not used.
  """
  if input_size == output_size:
    return np.eye(output_size, dtype=np.float32)
  f32 = np.float32
  inv_scale = f32(1.0 / (output_size / input_size))
  kernel_scale = max(inv_scale, f32(1.0))
  # XLA contracts (i + 0.5) * inv_scale - 0.5 into one fused multiply-add
  # (one rounding): the float64 product of two float32 values is exact.
  sample_f = ((np.arange(output_size, dtype=f32) + f32(0.5)).astype(
      np.float64) * np.float64(inv_scale) - 0.5).astype(f32)
  x = np.abs(sample_f[None, :] - np.arange(input_size, dtype=f32)[:, None]
            ) * (f32(1.0) / kernel_scale)
  weights = np.maximum(f32(0.0), f32(1.0) - x)
  total = weights.sum(axis=0, keepdims=True, dtype=f32)
  weights = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                     weights / np.where(total != 0, total, f32(1.0)),
                     f32(0.0))
  inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
  return np.ascontiguousarray(
      np.where(inside[None, :], weights, f32(0.0)).T.astype(f32))


@functools.lru_cache(maxsize=None)
def _device_resize_weights(input_size: int, output_size: int,
                           device: torch.device) -> torch.Tensor:
  """:func:`resize_weights` as a tensor on ``device``, copied there once: a
  captured CUDA graph may not copy from the host, and a step need not."""
  return torch.from_numpy(resize_weights(input_size, output_size)).to(device)


def _resize_crop(crop: torch.Tensor, crop_shape: Sequence[int],
                 target_shape: Sequence[int]) -> torch.Tensor:
  """The two contractions of :func:`crop_resize_images` over a crop
  window, made a contiguous float32 tensor first, so that a view and a
  gathered copy of the same window give the same bits."""
  # Under a trace (``torch.export``) the weights are constants of that
  # program alone: the cache keeps only real tensors.
  weights = (_device_resize_weights.__wrapped__ if fake_tensor.is_fake(crop)
             else _device_resize_weights)
  a_h = weights(int(crop_shape[0]), int(target_shape[0]), crop.device)
  a_w = weights(int(crop_shape[1]), int(target_shape[1]), crop.device)
  x = crop.float().contiguous()
  x = torch.einsum('iy,byxc->bixc', a_h, x)
  return torch.einsum('jx,bixc->bijc', a_w, x)


def crop_resize_images(offset_y: int, offset_x: int, images: torch.Tensor,
                       crop_shape: Sequence[int],
                       target_shape: Sequence[int]) -> torch.Tensor:
  """Bilinear ``resize(crop(images, offset, crop_shape), target_shape)``
  as two contractions with per-axis weight matrices (:func:`resize_weights`):
  an H pass, then a W pass, over the crop.

  The JAX package pads its matrices to the full image and rolls them by
  the offset; contracting the cropped window with the unpadded matrices
  sums the same non-zero terms. Input may be uint8; the output is
  float32 in the input's units (divide by 255 afterwards).
  """
  _check_crop(images.shape, crop_shape)
  ch, cw = int(crop_shape[0]), int(crop_shape[1])
  h, w = images.shape[-3], images.shape[-2]
  oy, ox = int(offset_y), int(offset_x)
  if not (0 <= oy <= h - ch and 0 <= ox <= w - cw):
    raise ValueError(
        f'Crop offsets {(oy, ox)} out of range for a {crop_shape} crop of '
        f'{(h, w)}')
  return _resize_crop(images[..., oy:oy + ch, ox:ox + cw, :], crop_shape,
                      target_shape)


def crop_resize_at_device_offsets(images: torch.Tensor,
                                  crop_shape: Sequence[int],
                                  target_shape: Sequence[int],
                                  offsets: torch.Tensor) -> torch.Tensor:
  """:func:`crop_resize_images` at offsets that lie on the images' device
  (an int64 tensor (row, column), in range): the window gathered as
  :func:`crop_at_device_offsets` gathers it, then the same contractions
  with the same matrices, which depend on the crop and target sizes and
  never on the offset. So the result is bit for bit the host-offset one,
  and no value is read back to the host."""
  return _resize_crop(crop_at_device_offsets(images, crop_shape, offsets),
                      crop_shape, target_shape)


# ------------------------------------------------------------- color space


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
  """Vectorized RGB->HSV on [..., 3] tensors in [0, 1]."""
  r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
  max_c = rgb.amax(dim=-1)
  min_c = rgb.amin(dim=-1)
  delta = max_c - min_c
  safe = torch.where(delta == 0, torch.ones_like(delta), delta)
  hue = torch.where(
      max_c == r, (g - b) / safe % 6.0,
      torch.where(max_c == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
  hue = torch.where(delta == 0, torch.zeros_like(hue), hue / 6.0)
  sat = torch.where(max_c == 0, torch.zeros_like(delta),
                    delta / torch.where(max_c == 0, torch.ones_like(max_c),
                                        max_c))
  return torch.stack([hue, sat, max_c], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
  """Vectorized HSV->RGB on [..., 3] tensors in [0, 1]."""
  h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
  h6 = h * 6.0
  k = torch.stack([(5.0 + h6) % 6.0, (3.0 + h6) % 6.0, (1.0 + h6) % 6.0],
                  dim=-1)
  t = torch.minimum(k, torch.clamp(4.0 - k, max=1.0))
  t = torch.clamp(t, 0.0, 1.0)
  return v[..., None] * (1.0 - s[..., None] * t)


# ------------------------------------------------------ photometric chain


def adjust_brightness(images, delta):
  return images + delta


def adjust_saturation(images, factor):
  hsv = rgb_to_hsv(torch.clamp(images, 0.0, 1.0))
  hsv = torch.cat([hsv[..., :1], hsv[..., 1:2] * factor[..., None],
                   hsv[..., 2:]], dim=-1)
  return hsv_to_rgb(torch.clamp(hsv, 0.0, 1.0))


def adjust_hue(images, delta):
  hsv = rgb_to_hsv(torch.clamp(images, 0.0, 1.0))
  hsv = torch.cat([(hsv[..., :1] + delta[..., None]) % 1.0, hsv[..., 1:]],
                  dim=-1)
  return hsv_to_rgb(hsv)


def adjust_contrast(images, factor):
  mean = images.mean(dim=(-3, -2), keepdim=True)
  return (images - mean) * factor + mean


def apply_photometric_image_distortions(
    images: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    random_brightness: bool = False,
    max_delta_brightness: float = 0.125,
    random_saturation: bool = False,
    lower_saturation: float = 0.5,
    upper_saturation: float = 1.5,
    random_hue: bool = False,
    max_delta_hue: float = 0.2,
    random_contrast: bool = False,
    lower_contrast: float = 0.5,
    upper_contrast: float = 1.5,
    random_noise_level: float = 0.0,
    random_noise_apply_probability: float = 0.5,
    use_fused_kernel: bool = False,
) -> torch.Tensor:
  """Per-image random photometric distortion chain, then a clip to [0, 1].

  The options are the JAX function's; ``generator`` takes the place of its
  key. Each enabled distortion draws independent per-image parameters from
  ``generator`` (on the generator's device, then moved to the images'),
  in the JAX chain's order: brightness, saturation, hue, contrast, noise.
  With every distortion off (the default) only the clip runs, also under
  ``DeviceDraws`` (a K-step dispatch); a distortion under ``DeviceDraws``
  raises, since its per-image draws are not taken beforehand yet.

  ``use_fused_kernel`` routes the brightness+contrast-only case (no
  saturation, hue or noise) to the fused pass of ``ops/photometric.py``:
  its CUDA kernel for images on the card, its plain version on the CPU, as
  the images' device decides (the JAX package also requires a TPU there).
  The fused branch draws brightness ``(B, 1, 1, 1)`` and then contrast
  ``(B, 1, 1, 1)`` from ``generator``, as this chain does, so both branches
  give the same images on the same generator up to float32 rounding of the
  mean; it writes the input's dtype. The JAX package's two branches split
  their key differently and cannot agree so.
  """
  if isinstance(generator, DeviceDraws) and (
      random_brightness or random_saturation or random_hue or
      random_contrast or random_noise_level):
    raise NotImplementedError(
        'The photometric distortions draw per image within the step; at '
        'steps_per_dispatch > 1 they are not ported yet: ROADMAP.md queue 1 '
        'item 12.')
  if (use_fused_kernel and random_brightness and random_contrast and
      not random_saturation and not random_hue and not random_noise_level):
    return photometric.random_brightness_contrast(
        images, generator, max_delta_brightness=max_delta_brightness,
        lower_contrast=lower_contrast, upper_contrast=upper_contrast)
  batch, device = images.shape[0], images.device
  draw = photometric.uniform
  if random_brightness:
    delta = draw(generator, (batch, 1, 1, 1), -max_delta_brightness,
                 max_delta_brightness, device)
    images = adjust_brightness(images, delta)
  if random_saturation:
    factor = draw(generator, (batch, 1, 1), lower_saturation,
                  upper_saturation, device)
    images = adjust_saturation(images, factor)
  if random_hue:
    delta = draw(generator, (batch, 1, 1), -max_delta_hue, max_delta_hue,
                 device)
    images = adjust_hue(images, delta)
  if random_contrast:
    factor = draw(generator, (batch, 1, 1, 1), lower_contrast,
                  upper_contrast, device)
    images = adjust_contrast(images, factor)
  if random_noise_level:
    noise = torch.randn(
        images.shape, generator=generator,
        device=generator.device if generator is not None else 'cpu'
    ).to(device) * random_noise_level
    apply = draw(generator, (batch, 1, 1, 1), 0.0, 1.0,
                 device) < random_noise_apply_probability
    images = torch.where(apply, images + noise, images)
  return torch.clamp(images, 0.0, 1.0)
