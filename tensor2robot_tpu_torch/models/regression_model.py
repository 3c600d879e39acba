"""Regression model base: the port's counterpart of
``tensor2robot_tpu/models/regression_model.py``.

A subclass supplies ``create_module()``, a network whose output dict holds
``inference_output``; the loss is the mean squared error against the one
label (``_regression_target``), in float32, and eval reports the loss and
the mean absolute error. Serving exposes ``inference_output``.
"""

from __future__ import annotations

import torch

from tensor2robot_tpu_torch.models.base import AbstractT2RModel, set_mode
from tensor2robot_tpu_torch.specs import SpecStruct


class RegressionModel(AbstractT2RModel):
  """Regression over spec-declared features -> ``inference_output``."""

  def inference_network_fn(self, network, features, labels, mode):
    del labels
    features, _ = self.validated_features(features, mode)
    set_mode(network, mode)
    return SpecStruct(network(features))

  def _regression_target(self, labels) -> torch.Tensor:
    """The label tensor to regress; override for several labels."""
    if hasattr(labels, 'keys'):
      keys = list(labels.keys())
      if len(keys) != 1:
        raise ValueError(
            f'Override _regression_target for multi-label specs: {keys}')
      return labels[keys[0]]
    return labels

  def model_train_fn(self, features, labels, inference_outputs, mode):
    del features, mode
    prediction = inference_outputs['inference_output'].float()
    target = self._regression_target(labels).float()
    return torch.mean(torch.square(prediction - target)), {}

  def model_eval_fn(self, features, labels, inference_outputs):
    del features
    prediction = inference_outputs['inference_output'].float()
    target = self._regression_target(labels).float()
    return {
        'loss': torch.mean(torch.square(prediction - target)),
        'mean_absolute_error': torch.mean(torch.abs(prediction - target)),
    }

  def create_export_outputs_fn(self, features, inference_outputs):
    outputs = SpecStruct()
    outputs['inference_output'] = inference_outputs['inference_output']
    return outputs
