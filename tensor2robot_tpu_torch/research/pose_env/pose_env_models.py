"""Pose-env models: the port's counterpart of
``tensor2robot_tpu/research/pose_env/pose_env_models.py``.

* :class:`PoseEnvRegressionModel`: the conv tower with a spatial-softmax
  head (``layers/vision_layers.ImagesToFeaturesModel``) -> the pose MLP
  (``ImageFeaturesToPoseModel``); the loss is the reward-weighted MSE of
  the JAX model (exponentiated, max-shifted weights).
* :class:`PoseEnvContinuousMCModel`: a critic over (image, pose action):
  three SAME 3x3 convs with LayerNorm, the action's embedding added to
  every position, two Dense(100) layers and a q head.

Both read 64x64x3 uint8 images (JPEG or PNG on disk) and scale them to
float32 [0, 1] on the device (``_Uint8ToFloatPreprocessor``). Parameter
names follow the flax trees (``utils/convert.pose_env_variables_to_torch``
maps them): the tower under ``state_features``, the MLP under
``pose_model`` (flax's ``ImageFeaturesToPoseModel_0``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers.normalization import LayerNorm
from tensor2robot_tpu_torch.layers.vision_layers import (
    Dense, ImageFeaturesToPoseModel, ImagesToFeaturesModel, lecun_normal_,
    promoted)
from tensor2robot_tpu_torch.models import critic_model, regression_model
from tensor2robot_tpu_torch.models.base import set_mode
from tensor2robot_tpu_torch.preprocessors.base import AbstractPreprocessor
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec, algebra

IMAGE_SHAPE = (64, 64, 3)


class _Uint8ToFloatPreprocessor(AbstractPreprocessor):
  """uint8 images on disk -> float32 [0, 1] on the device: the in-spec
  re-types ``state/image`` to uint8 (JPEG), the transform divides by 255."""

  IMAGE_KEYS = ('state/image',)

  def get_in_feature_specification(self, mode: str) -> SpecStruct:
    spec = algebra.flatten_spec_structure(
        self._model_feature_specification_fn(mode)).copy()
    for key in self.IMAGE_KEYS:
      if key in spec:
        spec[key] = TensorSpec.from_spec(spec[key], dtype=torch.uint8,
                                         data_format='JPEG')
    return spec

  def get_in_label_specification(self, mode: str):
    return self.model_label_specification(mode)

  def get_out_feature_specification(self, mode: str) -> SpecStruct:
    return self.model_feature_specification(mode)

  def get_out_label_specification(self, mode: str):
    return self.model_label_specification(mode)

  def _preprocess_fn(self, features, labels, mode, generator):
    del mode, generator
    for key in self.IMAGE_KEYS:
      if key in features:
        features[key] = features[key].to(torch.float32) / 255.0
    return features, labels


class _RegressionNet(nn.Module):
  """Vision tower + pose MLP."""

  def __init__(self, action_size: int = 2):
    super().__init__()
    self.state_features = ImagesToFeaturesModel()
    self.pose_model = ImageFeaturesToPoseModel(in_features=64,
                                               num_outputs=action_size)

  def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
    self.state_features.init_weights(generator)
    self.pose_model.init_weights(generator)

  def forward(self, features):
    image = features['state/image'].to(torch.float32)
    feature_points, _ = self.state_features(image)
    estimated_pose, _ = self.pose_model(feature_points)
    return {'inference_output': estimated_pose,
            'state_features': feature_points}


class PoseEnvRegressionModel(regression_model.RegressionModel):
  """Vision -> pose regression."""

  def __init__(self, action_size: int = 2, **kwargs):
    super().__init__(**kwargs)
    self._action_size = action_size

  @property
  def action_size(self) -> int:
    return self._action_size

  @property
  def default_preprocessor_cls(self):
    return _Uint8ToFloatPreprocessor

  def create_module(self) -> nn.Module:
    return _RegressionNet(action_size=self._action_size)

  def get_feature_specification(self, mode: str) -> SpecStruct:
    del mode
    spec = SpecStruct()
    spec['state/image'] = TensorSpec(shape=IMAGE_SHAPE, dtype=torch.float32,
                                     name='state/image', data_format='JPEG')
    return spec

  def get_label_specification(self, mode: str) -> SpecStruct:
    del mode
    spec = SpecStruct()
    spec['target_pose'] = TensorSpec(shape=(self._action_size,),
                                     dtype=torch.float32, name='target_pose')
    spec['reward'] = TensorSpec(shape=(1,), dtype=torch.float32,
                                name='reward')
    return spec

  def model_train_fn(self, features, labels, inference_outputs, mode):
    """The JAX model's reward-weighted MSE: per-example MSE weighted by
    exp(reward - max(reward)) (max held constant), normalised by the
    weights' sum. The raw pose_env rewards are negative distances, so the
    exponentiated weights keep the objective a proper weighted MSE."""
    del features, mode
    prediction = inference_outputs['inference_output'].float()
    target = labels['target_pose'].float()
    rewards = labels['reward'].float()
    per_example = torch.mean(torch.square(prediction - target), dim=-1,
                             keepdim=True)
    weights = torch.exp(rewards - torch.max(rewards).detach())
    loss = torch.sum(per_example * weights) / torch.clamp_min(
        torch.sum(weights), 1e-12)
    return loss, {}

  def model_eval_fn(self, features, labels, inference_outputs):
    prediction = inference_outputs['inference_output'].float()
    target = labels['target_pose'].float()
    loss, _ = self.model_train_fn(features, labels, inference_outputs, 'eval')
    return {'loss': loss,
            'pose_mse': torch.mean(torch.square(prediction - target))}

  def pack_features(self, state, context, timestep) -> SpecStruct:
    del context, timestep
    packed = SpecStruct()
    packed['state/image'] = np.expand_dims(state, 0)
    return packed


class _SameConv(nn.Module):
  """flax ``nn.Conv`` with SAME padding, stride 1, odd kernel: an OIHW
  ``weight`` (lecun normal) and a ``bias`` (zeros)."""

  def __init__(self, in_channels: int, features: int, kernel: int = 3):
    super().__init__()
    self.weight = nn.Parameter(
        torch.zeros(features, in_channels, kernel, kernel))
    self.bias = nn.Parameter(torch.zeros(features))

  def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
    _, cin, kh, kw = self.weight.shape
    lecun_normal_(self.weight, cin * kh * kw, generator)
    nn.init.zeros_(self.bias)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = promoted(x, self.weight)
    return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                    padding=self.weight.shape[-1] // 2)


class _CriticNet(nn.Module):
  """Conv features + the broadcast action embedding -> q."""

  def __init__(self, channels: int = 32, action_size: int = 2):
    super().__init__()
    height, width, in_channels = IMAGE_SHAPE
    for i in range(3):
      self.add_module(f'conv{i}', _SameConv(in_channels if i == 0
                                            else channels, channels))
      self.add_module(f'norm{i}', LayerNorm(channels))
    self.action_fc = Dense(action_size, channels)
    self.fc0 = Dense(height * width * channels, 100)
    self.fc1 = Dense(100, 100)
    self.q_head = Dense(100, 1)

  def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
    with torch.no_grad():
      for module in self.modules():
        if isinstance(module, (_SameConv, Dense)):
          module.init_weights(generator)
        elif isinstance(module, LayerNorm):
          module.scale.fill_(1.0)
          module.bias.zero_()

  def forward(self, features):
    image = features['state/image'].to(torch.float32)
    action = features['action/pose'].to(torch.float32)
    net = image.permute(0, 3, 1, 2)  # NCHW view of the NHWC storage
    for i in range(3):
      net = getattr(self, f'conv{i}')(net)
      net = F.relu(getattr(self, f'norm{i}')(net, feature_dim=1))
    net = net + self.action_fc(action)[:, :, None, None]
    net = net.permute(0, 2, 3, 1).reshape(net.shape[0], -1)  # flax's order
    net = F.relu(self.fc0(net))
    net = F.relu(self.fc1(net))
    return {'q_predicted': self.q_head(net).squeeze(1)}


class PoseEnvContinuousMCModel(critic_model.CriticModel):
  """Continuous Monte-Carlo critic for the pose env."""

  @property
  def default_preprocessor_cls(self):
    return _Uint8ToFloatPreprocessor

  def create_module(self) -> nn.Module:
    return _CriticNet()

  def get_state_specification(self) -> SpecStruct:
    spec = SpecStruct()
    spec['image'] = TensorSpec(shape=IMAGE_SHAPE, dtype=torch.float32,
                               name='state/image', data_format='JPEG')
    return spec

  def get_action_specification(self) -> SpecStruct:
    spec = SpecStruct()
    spec['pose'] = TensorSpec(shape=(2,), dtype=torch.float32, name='pose')
    return spec

  def get_label_specification(self, mode: str) -> SpecStruct:
    del mode
    spec = SpecStruct()
    spec['reward'] = TensorSpec(shape=(1,), dtype=torch.float32,
                                name='reward')
    return spec

  def inference_network_fn(self, network, features, labels, mode):
    del labels
    features, _ = self.validated_features(features, mode)
    set_mode(network, mode)
    return SpecStruct(network(features))

  def pack_features(self, state, context, timestep) -> SpecStruct:
    """One observation tiled against the CEM's batch of actions."""
    del timestep
    actions = np.asarray(context, np.float32)
    obs = np.asarray(state)
    packed = SpecStruct()
    packed['state/image'] = np.broadcast_to(
        obs, (actions.shape[0],) + obs.shape).copy()
    packed['action/pose'] = actions
    return packed
