"""Model protocol, PREDICT subset: the port's counterpart of
``tensor2robot_tpu/models/base.py``.

* ``get_feature_specification(mode)`` / ``get_label_specification(mode)``
  declare the device-side data contract (post-preprocessing).
* ``preprocessor`` pairs the model with its preprocessor, wrapped in the
  bfloat16 :class:`DtypePolicyPreprocessor` on an accelerator.
* ``create_module()`` builds the network as an ``nn.Module`` that owns its
  weights; ``inference_network_fn(network, features, labels, mode)`` runs
  it. Train mode updates stateful buffers (batch-norm statistics) in place
  on the module, the PyTorch idiom for what the JAX package returns as
  updated variables.
* ``create_export_outputs_fn`` and ``pack_features`` keep their roles
  (serving outputs; a policy's state/action packing).
"""

from __future__ import annotations

import abc
from typing import Any, Optional, Tuple, Type

import torch
from torch import nn

from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.ops import _dispatch as dispatch
from tensor2robot_tpu_torch.preprocessors import (AbstractPreprocessor,
                                                  DtypePolicyPreprocessor,
                                                  NoOpPreprocessor)
from tensor2robot_tpu_torch.specs import SpecStruct, algebra

DEVICE_TYPE_CPU = 'cpu'
DEVICE_TYPE_GPU = 'gpu'
DEVICE_TYPES = (DEVICE_TYPE_CPU, DEVICE_TYPE_GPU)


class ModelInterface(abc.ABC):
  """Minimal surface the predictors rely on."""

  @property
  @abc.abstractmethod
  def preprocessor(self) -> AbstractPreprocessor:
    ...

  @abc.abstractmethod
  def get_feature_specification(self, mode: str) -> SpecStruct:
    """Device-side (post-preprocessing) feature specs."""

  @abc.abstractmethod
  def get_label_specification(self, mode: str) -> Optional[SpecStruct]:
    """Device-side (post-preprocessing) label specs."""


class AbstractT2RModel(ModelInterface):
  """Base model: spec declaration + the network and its serving outputs.

  * ``preprocessor_cls``: preprocessor type paired with this model.
  * ``device_type``: ``'cpu' | 'gpu'``, the dtype policy of the network,
    independent of the torch device it runs on. ``'gpu'`` takes the policy
    the JAX package applies on a TPU: bfloat16 activations (the
    preprocessor casts float32 features to bfloat16 at the device
    boundary), float32 batch-norm statistics and float32 logits. ``'cpu'``
    computes in float32 throughout.
  * ``kernel_policy``: ``'none' | 'pool' | 'pool_conv'``, which kernel
    families the network routes through its kernel entries
    (``ops/_dispatch.py``). The parameters are the same under every policy.
  """

  def __init__(self,
               preprocessor_cls: Optional[Type[AbstractPreprocessor]] = None,
               device_type: str = DEVICE_TYPE_GPU,
               kernel_policy: str = 'none'):
    if device_type not in DEVICE_TYPES:
      raise ValueError(
          f'Unknown device_type {device_type!r}; expected one of '
          f'{DEVICE_TYPES}.')
    self._preprocessor_cls = preprocessor_cls
    self._device_type = device_type
    self._kernel_policy = dispatch.validate_kernel_policy(kernel_policy)

  @property
  def device_type(self) -> str:
    return self._device_type

  @property
  def kernel_policy(self) -> str:
    return self._kernel_policy

  @property
  def compute_dtype(self) -> torch.dtype:
    """Activation dtype of the network (parameters stay float32):
    bfloat16 for ``device_type='gpu'``, float32 for ``'cpu'``."""
    return torch.bfloat16 if self._device_type == DEVICE_TYPE_GPU else (
        torch.float32)

  @property
  def default_preprocessor_cls(self) -> Type[AbstractPreprocessor]:
    return NoOpPreprocessor

  @property
  def preprocessor(self) -> AbstractPreprocessor:
    preprocessor_cls = self._preprocessor_cls or self.default_preprocessor_cls
    preprocessor = preprocessor_cls(
        model_feature_specification_fn=self.get_feature_specification,
        model_label_specification_fn=self.get_label_specification)
    if self._device_type == DEVICE_TYPE_GPU:
      preprocessor = DtypePolicyPreprocessor(preprocessor)
    return preprocessor

  @abc.abstractmethod
  def create_module(self) -> nn.Module:
    """The network, with float32 parameters on the CPU."""

  def init_network(self, network: nn.Module,
                   generator: Optional[torch.Generator] = None) -> None:
    """Fills ``network``'s parameters with their initial values."""
    network.init_weights(generator)

  @abc.abstractmethod
  def inference_network_fn(self, network: nn.Module, features: SpecStruct,
                           labels: Optional[SpecStruct],
                           mode: str) -> SpecStruct:
    """Forward pass; returns the predictions."""

  def create_export_outputs_fn(self, features: SpecStruct,
                               inference_outputs: SpecStruct) -> SpecStruct:
    """Outputs exposed by serving; default: all predictions."""
    del features
    return inference_outputs

  def validated_features(self, features, mode: str,
                         labels=None) -> Tuple[SpecStruct, Any]:
    """validate_and_pack against the preprocessor's out specs: on an
    accelerator those are the model specs with the bfloat16 policy applied
    and optionals stripped, exactly what arrives on the device."""
    preprocessor = self.preprocessor
    features = algebra.validate_and_pack(
        preprocessor.get_out_feature_specification(mode), features,
        ignore_batch=True)
    label_spec = preprocessor.get_out_label_specification(mode)
    if labels is not None and label_spec is not None:
      labels = algebra.validate_and_pack(label_spec, labels, ignore_batch=True)
    return features, labels

  def pack_features(self, state, context, timestep) -> SpecStruct:
    """Packs a policy's (state, context, timestep) into model features."""
    raise NotImplementedError(
        f'{type(self).__name__} does not implement pack_features.')


def set_mode(network: nn.Module, mode: str) -> None:
  """Train-mode batch norm for TRAIN, running statistics otherwise."""
  network.train(mode == ModeKeys.TRAIN)
