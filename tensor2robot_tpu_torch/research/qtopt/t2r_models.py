"""QT-Opt T2R model, PREDICT subset: the port's counterpart of
``tensor2robot_tpu/research/qtopt/t2r_models.py``.

* :class:`DefaultGrasping44ImagePreprocessor`: the 512x640 uint8 frame is
  center-cropped to 472x472 and scaled to float32 [0, 1] on the device
  (PREDICT/EVAL). TRAIN takes a random crop; its photometric distortions
  are not ported yet and TRAIN raises rather than skip them.
* :class:`GraspingModelWrapper`: the critic over Grasping44, with the
  state/action specs, ``grasp_params``, ``inference_network_fn`` and
  ``pack_features`` of the JAX wrapper.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tensor2robot_tpu_torch.models import critic_model
from tensor2robot_tpu_torch.models.base import set_mode
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.preprocessors import image_transformations
from tensor2robot_tpu_torch.preprocessors.base import (
    SpecTransformationPreprocessor)
from tensor2robot_tpu_torch.research.qtopt import networks
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec

INPUT_SHAPE = (512, 640, 3)
TARGET_SHAPE = (472, 472)


class DefaultGrasping44ImagePreprocessor(SpecTransformationPreprocessor):
  """Crop + scale of the grasp image."""

  def __init__(self, input_shape=INPUT_SHAPE, target_shape=TARGET_SHAPE,
               **kwargs):
    super().__init__(**kwargs)
    self._input_shape = tuple(input_shape)
    self._target_shape = tuple(target_shape)

  def _transform_in_feature_specification(self, spec_struct, mode):
    self.update_spec(spec_struct, 'state/image', shape=self._input_shape,
                     dtype=np.uint8, data_format='JPEG')
    return spec_struct

  def _preprocess_fn(self, features, labels, mode, generator):
    image = features['state/image']
    if mode == ModeKeys.TRAIN:
      raise NotImplementedError(
          'TRAIN preprocessing applies photometric distortions, which are '
          'not ported yet.')
    image = image_transformations.center_crop_images(image,
                                                     self._target_shape)
    features['state/image'] = image.to(torch.float32) / 255.0
    return features, labels


class GraspingModelWrapper(critic_model.CriticModel):
  """Critic over Grasping44 (PREDICT subset of the JAX wrapper)."""

  def __init__(self,
               input_shape=INPUT_SHAPE,
               target_shape=TARGET_SHAPE,
               num_convs=(6, 6, 3),
               **kwargs):
    self._input_shape = tuple(input_shape)
    self._target_shape = tuple(target_shape)
    self._num_convs = tuple(num_convs)
    super().__init__(**kwargs)

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
        kernel_policy=self.kernel_policy)

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
