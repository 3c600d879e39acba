"""Grasp2Vec model: arithmetic-consistent scene and goal embeddings.

The port's counterpart of ``tensor2robot_tpu/research/grasp2vec/
grasp2vec_model.py``: the pregrasp and postgrasp images share the scene
tower (one batch of 2B), the goal image has its own, and training holds
``pregrasp - postgrasp ~ goal`` with N-pairs (or triplet) loss. The model
has no labels.

* :class:`Grasp2VecPreprocessor`: 512x640 uint8 frames -> crops scaled to
  float32 [0, 1] on the device. TRAIN draws from the step's generator,
  in the JAX preprocessor's order: one (row, column) crop offset for the
  pregrasp and postgrasp images together, then one for the goal, each
  with an exclusive upper bound as ``jax.random.randint`` has; then a
  left-right and an up-down flip per image key (pregrasp, postgrasp,
  goal), each flipping the whole batch. EVAL and PREDICT (or TRAIN with
  no generator) take the centre crop and no flips. At
  ``steps_per_dispatch`` > 1 the same ten values are drawn beforehand
  (``host_draws``) and the crops and flips are taken on the device.
* :class:`Grasp2VecModel`: the two :class:`networks.Embedding` towers in
  one module (``scene`` and ``goal``, the halves of the flax tree, see
  ``utils/convert.grasp2vec_variables_to_torch``).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch.layers import remat
from tensor2robot_tpu_torch.models.base import AbstractT2RModel, set_mode
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.preprocessors import image_transformations
from tensor2robot_tpu_torch.preprocessors.base import (
    DeviceDraws, SpecTransformationPreprocessor)
from tensor2robot_tpu_torch.research.grasp2vec import losses, networks
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec

RAW_SHAPE = (512, 640, 3)
# (min_offset_height, max_offset_height, target_height,
#  min_offset_width, max_offset_width, target_width)
DEFAULT_CROP = (0, 40, 472, 0, 168, 472)


def crop_offsets(generator: Optional[torch.Generator], crop: Sequence[int],
                 mode: str) -> Tuple[int, int]:
  """The (row, column) offset of one crop window: drawn from
  ``generator`` in TRAIN, the row first, each in [min, max) (the upper
  bound at least min + 1); the centre ((min + max) // 2) otherwise."""
  min_oh, max_oh, _, min_ow, max_ow, _ = crop
  if mode == ModeKeys.TRAIN and generator is not None:
    oh = int(torch.randint(min_oh, max(max_oh, min_oh + 1), (),
                           generator=generator))
    ow = int(torch.randint(min_ow, max(max_ow, min_ow + 1), (),
                           generator=generator))
    return oh, ow
  return (min_oh + max_oh) // 2, (min_ow + max_ow) // 2


def crop_images(images: Sequence[torch.Tensor], crop: Sequence[int],
                offsets) -> List[torch.Tensor]:
  """The crop window at (row, column) ``offsets`` of every NHWC image
  batch in ``images``: views for host offsets, gathered copies for an
  int64 tensor of device offsets (the same elements)."""
  _, _, target_h, _, _, target_w = crop
  if isinstance(offsets, torch.Tensor):
    return [image_transformations.crop_at_device_offsets(
        img, (target_h, target_w), offsets) for img in images]
  oh, ow = offsets
  return [img[:, oh:oh + target_h, ow:ow + target_w, :] for img in images]


def maybe_crop_images(generator: Optional[torch.Generator],
                      images: Sequence[torch.Tensor], crop: Sequence[int],
                      mode: str) -> List[torch.Tensor]:
  """One crop window, random in TRAIN and the centre otherwise
  (:func:`crop_offsets`), applied to every image batch in ``images``."""
  return crop_images(images, crop, crop_offsets(generator, crop, mode))


class Augmentation(NamedTuple):
  """One preprocess's draws: the scene's and the goal's (row, column) crop
  offsets and a (left-right, up-down) flip pair per image key. On the
  device (:meth:`Grasp2VecPreprocessor.device_augmentation`) each offset
  pair is an int64 tensor and each flip a boolean tensor."""
  scene: Tuple[int, int]
  goal: Tuple[int, int]
  flips: Tuple[Tuple[bool, bool], ...]


def _flip(image: torch.Tensor, flip, dim: int) -> torch.Tensor:
  """``image`` flipped along ``dim`` where ``flip`` holds: a host bool, or
  a boolean device tensor (a select, so nothing is read back)."""
  if isinstance(flip, torch.Tensor):
    return torch.where(flip, torch.flip(image, dims=(dim,)), image)
  return torch.flip(image, dims=(dim,)) if flip else image


class Grasp2VecPreprocessor(SpecTransformationPreprocessor):
  """512x640 uint8 frames -> cropped float32 [0, 1] with random flips
  (see module docstring)."""

  IMAGE_KEYS = ('pregrasp_image', 'postgrasp_image', 'goal_image')

  def __init__(self, scene_crop=DEFAULT_CROP, goal_crop=DEFAULT_CROP,
               **kwargs):
    self._scene_crop = tuple(scene_crop)
    self._goal_crop = tuple(goal_crop)
    super().__init__(**kwargs)

  def _transform_in_feature_specification(self, spec_struct, mode):
    for name in self.IMAGE_KEYS:
      self.update_spec(spec_struct, name, shape=RAW_SHAPE, dtype=np.uint8,
                       data_format='JPEG')
    return spec_struct

  def draw_augmentation(self, generator: Optional[torch.Generator],
                        mode: str) -> Augmentation:
    """What one preprocess draws, in the order it draws it: the scene's
    crop offset, the goal's, then (left-right, up-down) flips per image
    key; the centre crops and no flips outside TRAIN or without a
    generator."""
    scene = crop_offsets(generator, self._scene_crop, mode)
    goal = crop_offsets(generator, self._goal_crop, mode)
    flips = ((False, False),) * len(self.IMAGE_KEYS)
    if mode == ModeKeys.TRAIN and generator is not None:
      flips = tuple(
          tuple(bool(torch.randint(0, 2, (), generator=generator))
                for _ in range(2)) for _ in self.IMAGE_KEYS)
    return Augmentation(scene, goal, flips)

  def host_draws(self, generator: torch.Generator) -> List[int]:
    """The ten integers of :meth:`draw_augmentation` in TRAIN, in its
    order: the scene's (row, column), the goal's, then the (left-right,
    up-down) flips of each image key as 0 or 1."""
    augmentation = self.draw_augmentation(generator, ModeKeys.TRAIN)
    return list(augmentation.scene + augmentation.goal) + [
        int(flip) for pair in augmentation.flips for flip in pair]

  def device_augmentation(self, values: torch.Tensor) -> Augmentation:
    """The :class:`Augmentation` of the :meth:`host_draws` values on the
    device."""
    flips = values[4:].reshape(-1, 2) != 0
    return Augmentation(values[0:2], values[2:4],
                        tuple((pair[0], pair[1]) for pair in flips))

  def augment(self, features, augmentation: Augmentation):
    """Crops, scales to float32 [0, 1] and flips the three images."""
    features['pregrasp_image'], features['postgrasp_image'] = crop_images(
        [features['pregrasp_image'], features['postgrasp_image']],
        self._scene_crop, augmentation.scene)
    features['goal_image'] = crop_images(
        [features['goal_image']], self._goal_crop, augmentation.goal)[0]
    for name, (flip_lr, flip_ud) in zip(self.IMAGE_KEYS, augmentation.flips):
      image = features[name].to(torch.float32) / 255.0
      features[name] = _flip(_flip(image, flip_lr, 2), flip_ud, 1)
    return features

  def _preprocess_fn(self, features, labels, mode, generator):
    if isinstance(generator, DeviceDraws):
      augmentation = self.device_augmentation(generator.values)
    else:
      augmentation = self.draw_augmentation(generator, mode)
    return self.augment(features, augmentation), labels


class _Grasp2VecNet(nn.Module):
  """The scene and goal towers."""

  def __init__(self, **tower):
    super().__init__()
    self.scene = networks.Embedding(**tower)
    self.goal = networks.Embedding(**tower)

  def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
    self.scene.init_weights(generator)
    self.goal.init_weights(generator)


class Grasp2VecModel(AbstractT2RModel):
  """Embedding-arithmetic model over two ResNet towers.

  ``remat_policy`` makes each residual block of both towers a recompute
  region (``layers/remat.py``); ``kernel_policy='pool'`` sends the stem
  pools through the pool kernels.
  """

  def __init__(self,
               scene_size: Tuple[int, int] = (472, 472),
               goal_size: Tuple[int, int] = (472, 472),
               embedding_loss_fn: Callable = losses.npairs_loss,
               resnet_size: int = 50,
               remat_policy: str = 'none',
               **kwargs):
    self._scene_size = tuple(scene_size)
    self._goal_size = tuple(goal_size)
    self._embedding_loss_fn = embedding_loss_fn
    self._resnet_size = resnet_size
    self.remat_policy = remat.validate_remat_policy(remat_policy)
    super().__init__(**kwargs)

  @property
  def default_preprocessor_cls(self):
    return Grasp2VecPreprocessor

  def get_feature_specification(self, mode: str) -> SpecStruct:
    del mode
    spec = SpecStruct()
    spec['pregrasp_image'] = TensorSpec(
        shape=self._scene_size + (3,), dtype=np.float32, name='image',
        data_format='JPEG')
    spec['postgrasp_image'] = TensorSpec(
        shape=self._scene_size + (3,), dtype=np.float32,
        name='postgrasp_image', data_format='JPEG')
    spec['goal_image'] = TensorSpec(
        shape=self._goal_size + (3,), dtype=np.float32, name='present_image',
        data_format='JPEG')
    return spec

  def get_label_specification(self, mode: str) -> SpecStruct:
    del mode
    return SpecStruct()  # unsupervised

  def create_module(self) -> nn.Module:
    """The towers compute in ``compute_dtype``; their embedding vectors
    come back float32 and the loss stays float32."""
    return _Grasp2VecNet(resnet_size=self._resnet_size,
                         dtype=self.compute_dtype,
                         remat_policy=self.remat_policy,
                         kernel_policy=self.kernel_policy)

  def inference_network_fn(self, network, features, labels, mode,
                           generator: Optional[torch.Generator] = None):
    del labels, generator
    features, _ = self.validated_features(features, mode)
    set_mode(network, mode)
    dtype = self.compute_dtype
    scene_images = torch.cat(
        [features['pregrasp_image'], features['postgrasp_image']],
        dim=0).to(dtype)
    scene_v, scene_s = network.scene(scene_images)
    goal_v, goal_s = network.goal(features['goal_image'].to(dtype))
    # Split at the pregrasp batch (the views ``torch.chunk`` gives), so
    # that a trace keeps the batch symbolic.
    n = features['pregrasp_image'].shape[0]
    pre_v, post_v = scene_v[:n], scene_v[n:]
    pre_s, post_s = scene_s[:n], scene_s[n:]
    outputs = SpecStruct()
    outputs['pre_vector'] = pre_v
    outputs['post_vector'] = post_v
    outputs['pre_spatial'] = pre_s
    outputs['post_spatial'] = post_s
    outputs['goal_vector'] = goal_v
    outputs['goal_spatial'] = goal_s
    return outputs

  def model_train_fn(self, features, labels, inference_outputs, mode):
    del features, labels, mode
    embed_loss = self._embedding_loss_fn(
        inference_outputs['pre_vector'].float(),
        inference_outputs['goal_vector'].float(),
        inference_outputs['post_vector'].float())
    if isinstance(embed_loss, tuple):  # triplet: (loss, pairs, labels)
      embed_loss = embed_loss[0]
    return embed_loss, {'embed_loss': embed_loss}

  def model_eval_fn(self, features, labels, inference_outputs):
    loss, scalars = self.model_train_fn(features, labels, inference_outputs,
                                        ModeKeys.EVAL)
    metrics = dict(scalars)
    metrics['loss'] = loss
    return metrics
