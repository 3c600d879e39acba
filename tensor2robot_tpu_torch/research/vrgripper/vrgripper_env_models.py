"""VRGripper episode preprocessing.

The port's counterpart of :class:`DefaultVRGripperPreprocessor` in
``tensor2robot_tpu/research/vrgripper/vrgripper_env_models.py``: 220×300
uint8 episode frames → one crop offset per batch (random in TRAIN, centred
otherwise) → resize to the model's image size, with the crop folded into
the resize matrices (``crop_resize_images``) → float32 / 255, and optional
mixup. At ``steps_per_dispatch`` > 1 the draws are taken beforehand
(``host_draws``) and the crop runs at device offsets. The regression and
domain-adaptive models of that module are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.preprocessors import image_transformations
from tensor2robot_tpu_torch.preprocessors.base import (AbstractPreprocessor,
                                                     DeviceDraws)
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec, algebra


class DefaultVRGripperPreprocessor(AbstractPreprocessor):
  """Episode image preprocessing.

  TRAIN with a generator draws the crop's row offset, then its column
  offset, from it (the JAX package draws them from its key, so the two
  give different offsets); ``crop_offsets=(row, col)`` injects them
  instead. Mixup (``mixup_alpha > 0``) draws its Beta(α, α) weight from a
  numpy generator seeded from the generator.

  Handed :class:`DeviceDraws` (from :meth:`host_draws`) it crops at the
  drawn offsets on the device and mixes with the drawn weights, bit for
  bit what the same draws give from the generator.
  """

  def __init__(self,
               src_img_res: Tuple[int, int] = (220, 300),
               crop_size: Tuple[int, int] = (200, 280),
               mixup_alpha: float = 0.0,
               crop_offsets: Optional[Tuple[int, int]] = None,
               **kwargs):
    super().__init__(**kwargs)
    self._src_img_res = tuple(src_img_res)
    self._crop_size = tuple(crop_size)
    self._mixup_alpha = mixup_alpha
    self._crop_offsets = crop_offsets

  def get_in_feature_specification(self, mode: str) -> SpecStruct:
    feature_spec = algebra.flatten_spec_structure(
        self._model_feature_specification_fn(mode)).copy()
    if mode != ModeKeys.PREDICT and 'original_image' in feature_spec:
      del feature_spec['original_image']
    if 'image' in feature_spec:
      shape = list(feature_spec['image'].shape)
      shape[-3:-1] = self._src_img_res
      feature_spec['image'] = TensorSpec.from_spec(
          feature_spec['image'], shape=tuple(shape), dtype=np.uint8)
    return feature_spec

  def get_in_label_specification(self, mode: str):
    return self.model_label_specification(mode)

  def get_out_feature_specification(self, mode: str) -> SpecStruct:
    return self.model_feature_specification(mode)

  def get_out_label_specification(self, mode: str):
    return self.model_label_specification(mode)

  def _mixup_weights(self, generator: torch.Generator) -> Tuple[float, float]:
    """(λ, 1 − λ) in float64: a seed drawn from ``generator``, then
    Beta(α, α) from a numpy generator of that seed."""
    seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
    lmbda = float(np.random.RandomState(seed).beta(self._mixup_alpha,
                                                   self._mixup_alpha))
    return lmbda, 1 - lmbda

  def host_draws(self, generator: torch.Generator) -> Optional[List[int]]:
    """What one TRAIN preprocess draws, in its order: the crop's row and
    column offsets (none under ``crop_offsets``), then with mixup λ and
    1 − λ, computed on the host as the step computes them and carried as
    the bits of their float32 roundings (the step multiplies by them in
    float32). None when it draws nothing."""
    if 'image' not in self.get_in_feature_specification(ModeKeys.TRAIN):
      return None
    draws = []
    if self._crop_offsets is None:
      draws += self._offsets(*self._src_img_res, True, generator)
    if self._mixup_alpha > 0.0:
      draws += [int(np.float32(w).view(np.int32))
                for w in self._mixup_weights(generator)]
    return draws or None

  def _offsets(self, h: int, w: int, training_crop: bool, generator):
    ch, cw = self._crop_size
    if self._crop_offsets is not None:
      return self._crop_offsets
    if training_crop:
      oh = int(torch.randint(0, h - ch + 1, (), generator=generator))
      ow = int(torch.randint(0, w - cw + 1, (), generator=generator))
      return oh, ow
    return (h - ch) // 2, (w - cw) // 2

  def _crop(self, merged, target_hw, training_crop: bool, generator):
    """The crop of the [N, H, W, C] frames, resized to ``target_hw``, as
    float32 in [0, 1]: at the device offsets of ``DeviceDraws``, else at
    host offsets."""
    ch, cw = self._crop_size
    if isinstance(generator, DeviceDraws) and self._crop_offsets is None:
      offsets = generator.values[:2]
      if target_hw != self._crop_size:
        return image_transformations.crop_resize_at_device_offsets(
            merged, self._crop_size, target_hw, offsets) / 255.0
      return image_transformations.crop_at_device_offsets(
          merged, self._crop_size, offsets).float() / 255.0
    oh, ow = self._offsets(merged.shape[-3], merged.shape[-2],
                          training_crop, generator)
    if target_hw != self._crop_size:
      return image_transformations.crop_resize_images(
          oh, ow, merged, self._crop_size, target_hw) / 255.0
    return merged[:, oh:oh + ch, ow:ow + cw].float() / 255.0

  def _preprocess_fn(self, features, labels, mode, generator):
    if 'image' in features:
      image = features['image']
      lead_shape = tuple(image.shape[:-3])
      merged = image.reshape((-1,) + tuple(image.shape[-3:]))
      training_crop = mode == ModeKeys.TRAIN and generator is not None
      target_hw = tuple(
          self.get_out_feature_specification(mode)['image'].shape[-3:-1])
      cropped = self._crop(merged, target_hw, training_crop, generator)
      features['original_image'] = features['image']
      features['image'] = cropped.reshape(lead_shape + cropped.shape[1:])

      if (self._mixup_alpha > 0.0 and labels is not None and
          mode == ModeKeys.TRAIN and generator is not None):
        if isinstance(generator, DeviceDraws):
          start = 0 if self._crop_offsets is not None else 2
          lmbda, rest = generator.values[start:start + 2].to(
              torch.int32).view(torch.float32).unbind(0)
        else:
          lmbda, rest = self._mixup_weights(generator)
        for collection in (features, labels):
          for key, x in list(collection.items()):
            if x.is_floating_point():
              collection[key] = lmbda * x + rest * torch.flip(x, [0])
    return features, labels
