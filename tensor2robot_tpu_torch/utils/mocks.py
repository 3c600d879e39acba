"""Mock model and input generator: the port's counterpart of
``tensor2robot_tpu/utils/mocks.py``.

``MockT2RModel`` is a 3-layer MLP with batch norm that classifies the
linearly separable 2-D points of ``MockInputGenerator`` (label: x0 + x1 >
0). Training it end to end exercises specs, preprocessing, the trainer,
checkpoints, eval and prediction without a robot.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch.data.input_generators import (
    AbstractInputGenerator)
from tensor2robot_tpu_torch.layers.normalization import BatchNorm
from tensor2robot_tpu_torch.layers.vision_layers import Dense
from tensor2robot_tpu_torch.models.base import DEVICE_TYPE_GPU
from tensor2robot_tpu_torch.models.classification_model import (
    ClassificationModel)
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec


class MockMLP(nn.Module):
  """Dense, flax BatchNorm (momentum 0.9), relu, Dense, relu, Dense(1)."""

  def __init__(self, hidden_size: int = 16):
    super().__init__()
    self.dense_0 = Dense(2, hidden_size)
    self.batch_norm = BatchNorm(hidden_size, use_scale=True, momentum=0.9,
                                epsilon=1e-5)
    self.dense_1 = Dense(hidden_size, hidden_size)
    self.dense_2 = Dense(hidden_size, 1)

  def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
    for dense in (self.dense_0, self.dense_1, self.dense_2):
      dense.init_weights(generator)

  def forward(self, features):
    x = features['measured_position'].float()
    x = torch.relu(self.batch_norm(self.dense_0(x), -1))
    x = torch.relu(self.dense_1(x))
    return {'a_predicted': self.dense_2(x).squeeze(-1)}


class MockT2RModel(ClassificationModel):
  """Binary classifier over 2-D points; the smoke-test model."""

  def __init__(self, device_type: str = DEVICE_TYPE_GPU,
               hidden_size: int = 16, **kwargs):
    super().__init__(device_type=device_type, **kwargs)
    self._hidden_size = hidden_size

  def create_module(self) -> MockMLP:
    return MockMLP(self._hidden_size)

  def get_feature_specification(self, mode: str) -> SpecStruct:
    del mode
    spec = SpecStruct()
    spec['measured_position'] = TensorSpec(
        shape=(2,), dtype=np.float32, name='measured_position')
    return spec

  def get_label_specification(self, mode: str) -> SpecStruct:
    del mode
    spec = SpecStruct()
    spec['valid_position'] = TensorSpec(shape=(), dtype=np.float32,
                                        name='valid_position')
    return spec


class MockInputGenerator(AbstractInputGenerator):
  """Linearly separable 2-D points in [-1, 1): label = x0 + x1 > 0; seed 0
  for TRAIN, 1 otherwise."""

  def _create_iterator(self, mode, batch_size):
    rng = np.random.RandomState(0 if mode == ModeKeys.TRAIN else 1)

    def gen():
      while True:
        points = rng.uniform(-1.0, 1.0, size=(batch_size, 2)).astype(
            np.float32)
        features = SpecStruct()
        features['measured_position'] = points
        labels = SpecStruct()
        labels['valid_position'] = (points.sum(axis=1) > 0).astype(
            np.float32)
        yield features, labels

    return gen()
