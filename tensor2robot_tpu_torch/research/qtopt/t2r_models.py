"""QT-Opt T2R model: the port's counterpart of
``tensor2robot_tpu/research/qtopt/t2r_models.py``.

* :class:`DefaultGrasping44ImagePreprocessor`: the 512x640 uint8 frame is
  cropped to 472x472 and scaled to float32 [0, 1] on the device. TRAIN
  takes a random crop (one offset per batch) and then the photometric
  distortion chain, which at its defaults only clips to [0, 1];
  PREDICT/EVAL take the center crop.
* :class:`GraspingModelWrapper`: the critic over Grasping44 with the JAX
  wrapper's state/action specs, log loss, QT-Opt's momentum optimizer and
  parameter averaging (``optimizer_builder``), ``remat_policy`` (recompute
  of the conv tower blocks, ``layers/remat.py``), ``grasp_params``,
  ``inference_network_fn`` (TRAIN mode updates the batch statistics in
  place) and ``pack_features``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tensor2robot_tpu_torch.layers import remat
from tensor2robot_tpu_torch.models import critic_model
from tensor2robot_tpu_torch.models.base import set_mode
from tensor2robot_tpu_torch.models.critic_model import log_loss
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.preprocessors import image_transformations
from tensor2robot_tpu_torch.preprocessors.base import (
    DeviceDraws, SpecTransformationPreprocessor)
from tensor2robot_tpu_torch.research.qtopt import networks, optimizer_builder
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec

INPUT_SHAPE = (512, 640, 3)
TARGET_SHAPE = (472, 472)


class DefaultGrasping44ImagePreprocessor(SpecTransformationPreprocessor):
  """Crop + scale (+ distortions in TRAIN) of the grasp image.

  TRAIN draws from the ``generator`` that ``preprocess`` threads in: the
  crop offsets first, then the distortions' parameters. Handed
  :class:`DeviceDraws` instead (a step inside a CUDA graph), it crops at
  those offsets, the two that :meth:`host_draws` drew.
  """

  def __init__(self, input_shape=INPUT_SHAPE, target_shape=TARGET_SHAPE,
               **kwargs):
    super().__init__(**kwargs)
    self._input_shape = tuple(input_shape)
    self._target_shape = tuple(target_shape)

  def _transform_in_feature_specification(self, spec_struct, mode):
    self.update_spec(spec_struct, 'state/image', shape=self._input_shape,
                     dtype=np.uint8, data_format='JPEG')
    return spec_struct

  def host_draws(self, generator):
    return list(image_transformations.random_crop_offsets(
        generator, self._input_shape, self._target_shape))

  def _preprocess_fn(self, features, labels, mode, generator):
    image = features['state/image']
    if mode == ModeKeys.TRAIN and isinstance(generator, DeviceDraws):
      image = image_transformations.crop_at_device_offsets(
          image, self._target_shape, generator.values[:2])
      image = image.to(torch.float32) / 255.0
      image = image_transformations.apply_photometric_image_distortions(
          image, generator)
    elif mode == ModeKeys.TRAIN:
      image = image_transformations.random_crop_images(
          image, self._target_shape, generator)
      image = image.to(torch.float32) / 255.0
      image = image_transformations.apply_photometric_image_distortions(
          image, generator)
    else:
      image = image_transformations.center_crop_images(
          image, self._target_shape)
      image = image.to(torch.float32) / 255.0
    features['state/image'] = image
    return features, labels


class GraspingModelWrapper(critic_model.CriticModel):
  """Critic over Grasping44 with QT-Opt's training hyperparameters."""

  def __init__(self,
               loss_function=log_loss,
               learning_rate: float = 1e-4,
               model_weights_averaging: float = 0.9999,
               momentum: float = 0.9,
               use_avg_model_params: bool = True,
               learning_rate_decay_factor: float = 0.999,
               input_shape=INPUT_SHAPE,
               target_shape=TARGET_SHAPE,
               num_convs=(6, 6, 3),
               remat_policy: str = 'none',
               **kwargs):
    self.hparams = optimizer_builder.default_hparams()
    self.hparams.update(
        learning_rate=learning_rate,
        model_weights_averaging=model_weights_averaging,
        momentum=momentum,
        learning_rate_decay_factor=learning_rate_decay_factor,
        use_avg_model_params=use_avg_model_params)
    self._input_shape = tuple(input_shape)
    self._target_shape = tuple(target_shape)
    self._num_convs = tuple(num_convs)
    # Recompute of the conv tower blocks in the backward (layers/remat.py).
    self.remat_policy = remat.validate_remat_policy(remat_policy)
    kwargs.setdefault('create_optimizer_fn',
                      lambda: optimizer_builder.build_opt(self.hparams))
    super().__init__(
        loss_function=loss_function,
        use_avg_model_params=use_avg_model_params,
        avg_model_params_decay=model_weights_averaging,
        **kwargs)

  @property
  def default_preprocessor_cls(self):
    input_shape, target_shape = self._input_shape, self._target_shape

    class _Preprocessor(DefaultGrasping44ImagePreprocessor):

      def __init__(self, **kwargs):
        super().__init__(input_shape=input_shape, target_shape=target_shape,
                         **kwargs)

    return _Preprocessor

  def create_module(self) -> networks.Grasping44:
    action_size = sum(
        int(np.prod(spec.shape))
        for spec in self.get_action_specification().values())
    return networks.Grasping44(
        image_size=self._target_shape, grasp_param_size=action_size,
        num_convs=self._num_convs, dtype=self.compute_dtype,
        kernel_policy=self.kernel_policy, remat_policy=self.remat_policy)

  def get_state_specification(self) -> SpecStruct:
    spec = SpecStruct()
    spec['image'] = TensorSpec(
        shape=self._target_shape + (3,), dtype=np.float32,
        name='state/image', data_format='JPEG')
    return spec

  def get_action_specification(self) -> SpecStruct:
    spec = SpecStruct()
    spec['world_vector'] = TensorSpec(shape=(3,), dtype=np.float32,
                                      name='world_vector')
    spec['vertical_rotation'] = TensorSpec(shape=(2,), dtype=np.float32,
                                           name='vertical_rotation')
    return spec

  def get_label_specification(self, mode: str) -> SpecStruct:
    del mode
    spec = SpecStruct()
    spec['reward'] = TensorSpec(shape=(1,), dtype=np.float32,
                                name='grasp_success')
    return spec

  def grasp_params(self, features) -> torch.Tensor:
    """Concatenates the action blocks, keeping the incoming dtype (the
    dtype policy delivers bfloat16 on an accelerator)."""
    return torch.cat([features['action/world_vector'],
                      features['action/vertical_rotation']], dim=-1)

  def inference_network_fn(self, network, features, labels, mode,
                           generator: Optional[torch.Generator] = None):
    del labels, generator
    features, _ = self.validated_features(features, mode)
    set_mode(network, mode)
    _, end_points = network(features['state/image'],
                            self.grasp_params(features))
    outputs = SpecStruct()
    outputs['q_predicted'] = end_points['predictions']
    return outputs

  def pack_features(self, state, context, timestep) -> SpecStruct:
    """One image + a CEM action batch [num_samples, 5]."""
    del timestep
    actions = np.asarray(context, np.float32)
    num_samples = actions.shape[0]
    packed = SpecStruct()
    obs = np.asarray(state)
    packed['state/image'] = np.broadcast_to(
        obs, (num_samples,) + obs.shape).copy()
    packed['action/world_vector'] = actions[:, :3]
    packed['action/vertical_rotation'] = actions[:, 3:5]
    return packed
