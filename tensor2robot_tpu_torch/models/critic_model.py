"""Critic (Q-function) model base: the port's counterpart of
``tensor2robot_tpu/models/critic_model.py``.

Declares separate *state* and *action* specs; the network maps (state,
action) -> ``q_predicted``. Training regresses the reward with
``loss_function`` (mean squared error by default; QT-Opt takes
:func:`log_loss`). At PREDICT time a CEM policy evaluates one state
against a batch of candidate actions: :meth:`pack_features` tiles the
state across the candidates on the host (the numpy path), and the
device-resident policy packs the same layout on the card.
"""

from __future__ import annotations

import abc

import numpy as np
import torch

from tensor2robot_tpu_torch.models.base import AbstractT2RModel
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec, algebra


def log_loss(predictions: torch.Tensor, targets: torch.Tensor,
             epsilon: float = 1e-7) -> torch.Tensor:
  """tf.losses.log_loss semantics: binary cross-entropy on probabilities,
  in float32."""
  predictions = torch.clamp(predictions.float(), epsilon, 1.0 - epsilon)
  targets = targets.float()
  return -torch.mean(targets * torch.log(predictions) +
                     (1.0 - targets) * torch.log(1.0 - predictions))


def mean_squared_error(predictions: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
  return torch.mean(torch.square(predictions.float() - targets.float()))


class CriticModel(AbstractT2RModel):
  """Q(s, a) critic with split state/action specs.

  ``loss_function(predictions, targets)`` defaults to mean squared error;
  QT-Opt swaps in :func:`log_loss`.
  """

  def __init__(self, loss_function=mean_squared_error, **kwargs):
    super().__init__(**kwargs)
    self._loss_function = loss_function

  @abc.abstractmethod
  def get_state_specification(self) -> SpecStruct:
    ...

  @abc.abstractmethod
  def get_action_specification(self) -> SpecStruct:
    ...

  def get_feature_specification(self, mode: str) -> SpecStruct:
    """state/... + action/... merged."""
    del mode
    spec = SpecStruct()
    for key, value in algebra.flatten_spec_structure(
        self.get_state_specification()).items():
      spec[f'state/{key}'] = value
    for key, value in algebra.flatten_spec_structure(
        self.get_action_specification()).items():
      spec[f'action/{key}'] = value
    return spec

  def get_label_specification(self, mode: str) -> SpecStruct:
    del mode
    spec = SpecStruct()
    spec['reward'] = TensorSpec(shape=(1,), dtype=torch.float32,
                                name='reward')
    return spec

  def q_predicted(self, inference_outputs) -> torch.Tensor:
    return inference_outputs['q_predicted']

  def model_train_fn(self, features, labels, inference_outputs, mode):
    del features, mode
    q = self.q_predicted(inference_outputs)
    reward = labels['reward'].float().reshape(q.shape)
    loss = self._loss_function(q, reward)
    return loss, {'q_mean': q.float().mean()}

  def model_eval_fn(self, features, labels, inference_outputs):
    del features
    q = self.q_predicted(inference_outputs).float()
    reward = labels['reward'].float().reshape(q.shape)
    return {
        'loss': self._loss_function(q, reward),
        'q_mean': q.mean(),
        'td_abs_error': (q - reward).abs().mean(),
    }

  def create_export_outputs_fn(self, features, inference_outputs):
    outputs = SpecStruct()
    outputs['q_predicted'] = self.q_predicted(inference_outputs)
    return outputs

  def pack_features(self, state, context, timestep) -> SpecStruct:
    """Packs one env state + a batch of candidate actions for CEM.

    ``context`` carries the candidate actions (numpy [num_samples, adim]);
    the state is tiled across the candidate batch.
    """
    del timestep
    packed = SpecStruct()
    state_spec = algebra.flatten_spec_structure(self.get_state_specification())
    action_spec = algebra.flatten_spec_structure(
        self.get_action_specification())
    actions = context
    if hasattr(actions, 'keys'):
      action_items = {k: np.asarray(v) for k, v in actions.items()}
    else:
      keys = list(action_spec.keys())
      if len(keys) != 1:
        raise ValueError('Single-array actions need a single action spec.')
      action_items = {keys[0]: np.asarray(actions)}
    num_samples = next(iter(action_items.values())).shape[0]
    state_items = (
        {k: np.asarray(v) for k, v in state.items()}
        if hasattr(state, 'keys') else
        {list(state_spec.keys())[0]: np.asarray(state)})
    for key in state_spec:
      value = state_items[key]
      packed[f'state/{key}'] = np.broadcast_to(value,
                                               (num_samples,) + value.shape)
    for key in action_spec:
      packed[f'action/{key}'] = action_items[key]
    return packed
