"""Device-side image crops on torch tensors.

The port's counterpart of the crops in
``tensor2robot_tpu/preprocessors/image_transformations.py``. Images are
``[batch, H, W, C]`` (uint8 or float); a crop is a view, so it costs no
copy until the next op reads it. The photometric chain is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def _check_crop(input_shape, target_shape) -> None:
  if len(target_shape) != 2:
    raise ValueError(f'target_shape must be (h, w), got {target_shape}')
  if target_shape[0] > input_shape[-3] or target_shape[1] > input_shape[-2]:
    raise ValueError(
        f'Crop {target_shape} larger than image {tuple(input_shape[-3:-1])}')


def random_crop_images(images: torch.Tensor,
                       target_shape: Sequence[int],
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
  """Random spatial crop with ONE offset shared across the batch.

  The offsets are drawn on the host from ``generator`` (a CPU generator),
  so the crop itself is a view with no device round trip.
  """
  _check_crop(images.shape, target_shape)
  th, tw = int(target_shape[0]), int(target_shape[1])
  h, w = images.shape[-3], images.shape[-2]
  oh = int(torch.randint(0, h - th + 1, (), generator=generator))
  ow = int(torch.randint(0, w - tw + 1, (), generator=generator))
  return images[..., oh:oh + th, ow:ow + tw, :]


def center_crop_images(images: torch.Tensor,
                       target_shape: Sequence[int]) -> torch.Tensor:
  """Deterministic center crop (eval-time counterpart of random crop)."""
  _check_crop(images.shape, target_shape)
  th, tw = int(target_shape[0]), int(target_shape[1])
  h, w = images.shape[-3], images.shape[-2]
  oh, ow = (h - th) // 2, (w - tw) // 2
  return images[..., oh:oh + th, ow:ow + tw, :]
