"""Predictors: the port's counterpart of
``tensor2robot_tpu/predictors/predictors.py`` (AbstractPredictor and
CheckpointPredictor).

A predictor owns the network on its device and runs the PREDICT chain
preprocess -> network -> export outputs:

* :meth:`CheckpointPredictor.predict` takes numpy and returns numpy;
* :meth:`CheckpointPredictor.device_serving_fn` returns the same chain as
  a callable over device tensors, so a caller (the device-resident CEM
  policy) can close a whole loop on the card around it without a host
  round trip;
* weights come from :meth:`init_randomly` (a seeded ``torch.Generator``
  and the JAX package's initialisers) or :meth:`load_variables` (a JAX
  variables tree as numpy, through ``utils/convert.py``). Restoring a
  trainer checkpoint arrives with the checkpoint slice of the port.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.ops import _dispatch as dispatch
from tensor2robot_tpu_torch.specs import SpecStruct, algebra
from tensor2robot_tpu_torch.utils import convert


class AbstractPredictor(abc.ABC):
  """The predictor surface policies consume."""

  @abc.abstractmethod
  def predict(self, features: Dict[str, np.ndarray]) -> Dict[str, Any]:
    ...

  @abc.abstractmethod
  def get_feature_specification(self) -> SpecStruct:
    ...

  def get_label_specification(self) -> Optional[SpecStruct]:
    return None

  @abc.abstractmethod
  def restore(self) -> bool:
    """Loads the newest available weights; returns success."""

  def init_randomly(self, generator: Optional[torch.Generator] = None
                    ) -> None:
    raise NotImplementedError

  def close(self) -> None:
    ...

  def assert_is_loaded(self) -> None:
    if not self.is_loaded:
      raise ValueError('The predictor has not been restored yet.')

  def device_serving_fn(self) -> Callable:
    """``fn(features) -> outputs`` over device tensors (see module doc)."""
    raise NotImplementedError(
        f'{type(self).__name__} does not expose a device serving fn.')

  @property
  @abc.abstractmethod
  def is_loaded(self) -> bool:
    ...

  @property
  @abc.abstractmethod
  def global_step(self) -> int:
    ...


class _Forward:
  """The PREDICT chain over one network: preprocess -> network -> export
  outputs, on device tensors, with autograd off."""

  def __init__(self, model, network: torch.nn.Module):
    self._model = model
    self._preprocessor = model.preprocessor
    self.network = network

  def __call__(self, features) -> Dict[str, torch.Tensor]:
    with torch.inference_mode():
      features_p, _ = self._preprocessor.preprocess(
          features, None, ModeKeys.PREDICT)
      outputs = self._model.inference_network_fn(
          self.network, features_p, None, ModeKeys.PREDICT)
      return dict(self._model.create_export_outputs_fn(features_p, outputs))


def _expand_to_spec_rank(features: Mapping[str, Any],
                         spec: SpecStruct) -> Dict[str, np.ndarray]:
  """Adds leading batch dims the caller omitted (a single example, or a
  single CEM sample, may come without its batch dim)."""
  out = {}
  for key, value in features.items():
    value = np.asarray(value)
    if key in spec:
      expected_rank = len(spec[key].shape) + 1
      while value.ndim < expected_rank:
        value = value[None]
    out[key] = value
  return out


class CheckpointPredictor(AbstractPredictor):
  """Model -> predictor on ``device`` (``'cuda'`` unless the caller asks
  for ``'cpu'``; a CUDA request with no card raises)."""

  def __init__(self, t2r_model, model_dir: str = '',
               restore_timeout_secs: float = 0.0, device='cuda'):
    self._model = t2r_model
    self._model_dir = model_dir
    self._restore_timeout_secs = restore_timeout_secs
    self._device = dispatch.resolve_device(device)
    self._forward: Optional[_Forward] = None
    self._global_step = -1
    self._feature_spec = algebra.filter_required_flat_tensor_spec(
        t2r_model.preprocessor.get_in_feature_specification(ModeKeys.PREDICT))

  @property
  def device(self) -> torch.device:
    return self._device

  def get_feature_specification(self) -> SpecStruct:
    return self._feature_spec

  def _publish(self, network: torch.nn.Module, global_step: int) -> None:
    network = network.to(self._device).eval()
    self._forward = _Forward(self._model, network)
    self._global_step = global_step

  def init_randomly(self, generator: Optional[torch.Generator] = None
                    ) -> None:
    """Fresh weights from the model's initialisers, drawn on the CPU from
    ``generator`` (seeded runs give the same weights on every device)."""
    network = self._model.create_module()
    self._model.init_network(network, generator)
    self._publish(network, 0)

  def load_variables(self, variables: Mapping[str, Any],
                     global_step: int = 0) -> None:
    """Loads a JAX variables tree (numpy leaves, e.g. from
    ``jax.device_get(state.eval_variables)``)."""
    network = self._model.create_module()
    network.load_state_dict(convert.jax_variables_to_torch(variables),
                            strict=True)
    self._publish(network, global_step)

  def restore(self) -> bool:
    raise NotImplementedError(
        'Restoring trainer checkpoints arrives with the checkpoint slice of '
        'the port; use load_variables() or init_randomly().')

  def _to_device(self, features: Mapping[str, np.ndarray]):
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(self._device)
        for k, v in features.items()
    }

  def predict(self, features: Dict[str, np.ndarray]) -> Dict[str, Any]:
    self.assert_is_loaded()
    features = _expand_to_spec_rank(features, self._feature_spec)
    outputs = self._forward(self._to_device(features))
    return {k: v.cpu().numpy() for k, v in outputs.items()}

  def device_serving_fn(self) -> Callable:
    """The PREDICT chain over device tensors; the same object until new
    weights are published."""
    self.assert_is_loaded()
    return self._forward

  @property
  def network(self) -> torch.nn.Module:
    self.assert_is_loaded()
    return self._forward.network

  @property
  def is_loaded(self) -> bool:
    return self._forward is not None

  @property
  def global_step(self) -> int:
    return self._global_step
