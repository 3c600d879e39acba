"""Classification model base: the port's counterpart of
``tensor2robot_tpu/models/classification_model.py``.

A subclass supplies ``create_module()``, a network whose output dict holds
the ``a_predicted`` logits; the loss is the mean sigmoid cross entropy and
eval reports loss, accuracy, precision, recall and the mean squared error
of the probabilities. Serving exposes the probabilities.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tensor2robot_tpu_torch.models.base import AbstractT2RModel, set_mode
from tensor2robot_tpu_torch.specs import SpecStruct


def sigmoid_log_loss(logits: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
  """Mean sigmoid cross entropy on logits, in float32."""
  return F.binary_cross_entropy_with_logits(logits.float(), labels.float())


class ClassificationModel(AbstractT2RModel):
  """Binary classifier over spec-declared features."""

  loss_fn = staticmethod(sigmoid_log_loss)

  def inference_network_fn(self, network, features, labels, mode):
    del labels
    features, _ = self.validated_features(features, mode)
    set_mode(network, mode)
    return SpecStruct(network(features))

  def _classification_target(self, labels) -> torch.Tensor:
    """The label tensor holding {0, 1} targets; override for other specs."""
    if hasattr(labels, 'keys'):
      keys = list(labels.keys())
      if len(keys) != 1:
        raise ValueError(
            f'Override _classification_target for multi-label specs: {keys}')
      return labels[keys[0]]
    return labels

  def model_train_fn(self, features, labels, inference_outputs, mode):
    del features, mode
    loss = self.loss_fn(inference_outputs['a_predicted'],
                        self._classification_target(labels))
    return loss, {}

  def model_eval_fn(self, features, labels, inference_outputs):
    del features
    logits = inference_outputs['a_predicted'].float()
    target = self._classification_target(labels).float()
    prob = torch.sigmoid(logits)
    predicted = (prob > 0.5).float()
    tp = torch.sum(predicted * target)
    return {
        'loss': self.loss_fn(logits, target),
        'accuracy': torch.mean((predicted == target).float()),
        'precision': tp / torch.clamp_min(torch.sum(predicted), 1.0),
        'recall': tp / torch.clamp_min(torch.sum(target), 1.0),
        'mean_squared_error': torch.mean(torch.square(prob - target)),
    }

  def create_export_outputs_fn(self, features, inference_outputs):
    outputs = SpecStruct()
    outputs['a_predicted'] = torch.sigmoid(
        inference_outputs['a_predicted'].float())
    return outputs
