"""Model protocol: the port's counterpart of
``tensor2robot_tpu/models/base.py`` (PREDICT and the TRAIN surface).

* ``get_feature_specification(mode)`` / ``get_label_specification(mode)``
  declare the device-side data contract (post-preprocessing).
* ``preprocessor`` pairs the model with its preprocessor, wrapped in the
  bfloat16 :class:`DtypePolicyPreprocessor` on an accelerator.
* ``create_module()`` builds the network as an ``nn.Module`` that owns its
  weights; ``inference_network_fn(network, features, labels, mode)`` runs
  it. Train mode updates stateful buffers (batch-norm statistics) in place
  on the module, the PyTorch idiom for what the JAX package returns as
  updated variables.
* ``model_train_fn(features, labels, inference_outputs, mode)`` returns
  (scalar loss, scalar summaries); ``create_optimizer()`` builds the
  optimizer factory that the train state applies to the network's
  parameters; ``use_avg_model_params`` keeps an exponential moving average
  of the parameters (``avg_model_params_decay``) for eval and export.
* ``create_export_outputs_fn`` and ``pack_features`` keep their roles
  (serving outputs; a policy's state/action packing).
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Dict, Optional, Tuple, Type

import torch
from torch import nn

from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.ops import _dispatch as dispatch
from tensor2robot_tpu_torch.preprocessors import (AbstractPreprocessor,
                                                  DtypePolicyPreprocessor,
                                                  NoOpPreprocessor)
from tensor2robot_tpu_torch.quantize import fp8_training as fp8_lib
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

  def get_feature_specification_for_packing(self, mode: str) -> SpecStruct:
    """Host-side (pre-preprocessing) feature specs: what a policy packs
    and what an export's assets declare."""
    return self.preprocessor.get_in_feature_specification(mode)

  def get_label_specification_for_packing(
      self, mode: str) -> Optional[SpecStruct]:
    return self.preprocessor.get_in_label_specification(mode)


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
  * ``create_optimizer_fn``: zero-argument factory returning an optimizer
    factory ``fn(params) -> torch.optim.Optimizer`` (see
    ``models/optimizers.py``); None takes Adam at 1e-4, the JAX
    package's default.
  * ``use_avg_model_params`` / ``avg_model_params_decay``: keep an
    exponential moving average of the parameters in the train state.
  * ``init_from_checkpoint_fn``: ``fn(network) -> None``, run on the freshly
    initialised network before the optimizer and the average are built
    (the warm-start hook; it loads weights into the module in place).
  * ``matmul_precision``: ``'bf16' | 'fp8'``, the contraction precision of
    the Dense/Conv layers of networks that thread it
    (``quantize/fp8_training.py``): ``'fp8'`` runs them through
    delayed-amax-scaled float8 quantize-dequantize, with float32 master
    weights. ``TrainerConfig.matmul_precision`` overrides it
    (:meth:`set_matmul_precision`) before the network is built.
  """

  def __init__(self,
               preprocessor_cls: Optional[Type[AbstractPreprocessor]] = None,
               create_optimizer_fn: Optional[Callable[[], Any]] = None,
               device_type: str = DEVICE_TYPE_GPU,
               use_avg_model_params: bool = False,
               avg_model_params_decay: float = 0.9999,
               init_from_checkpoint_fn: Optional[Callable[[nn.Module],
                                                          None]] = None,
               kernel_policy: str = 'none',
               matmul_precision: str = 'bf16'):
    if device_type not in DEVICE_TYPES:
      raise ValueError(
          f'Unknown device_type {device_type!r}; expected one of '
          f'{DEVICE_TYPES}.')
    self._preprocessor_cls = preprocessor_cls
    self._create_optimizer_fn = create_optimizer_fn
    self._device_type = device_type
    self.use_avg_model_params = use_avg_model_params
    self.avg_model_params_decay = avg_model_params_decay
    self.init_from_checkpoint_fn = init_from_checkpoint_fn
    self._kernel_policy = dispatch.validate_kernel_policy(kernel_policy)
    self._matmul_precision = fp8_lib.validate_matmul_precision(
        matmul_precision)

  @property
  def device_type(self) -> str:
    return self._device_type

  @property
  def kernel_policy(self) -> str:
    return self._kernel_policy

  @property
  def matmul_precision(self) -> str:
    """Dense/Conv contraction precision ('bf16' | 'fp8')."""
    return self._matmul_precision

  def set_matmul_precision(self, precision: str) -> None:
    """The trainer's override (``TrainerConfig.matmul_precision``), validated
    and gated on this build's fp8 dtypes. Must run before
    :meth:`create_module`: a network takes the precision at construction."""
    self._matmul_precision = fp8_lib.require_fp8_support(precision)

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

  @abc.abstractmethod
  def model_train_fn(self, features: SpecStruct,
                     labels: Optional[SpecStruct],
                     inference_outputs: SpecStruct,
                     mode: str) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (scalar loss, scalar summaries) for one batch."""

  def model_eval_fn(self, features: SpecStruct,
                    labels: Optional[SpecStruct],
                    inference_outputs: SpecStruct) -> Dict[str, torch.Tensor]:
    """Per-batch eval metrics, which the trainer averages over the eval
    batches; by default the train summaries and the loss in EVAL mode."""
    loss, scalars = self.model_train_fn(features, labels, inference_outputs,
                                        ModeKeys.EVAL)
    metrics = dict(scalars)
    metrics['loss'] = loss
    return metrics

  def create_optimizer(self) -> Callable:
    """The optimizer factory ``fn(params) -> torch.optim.Optimizer``."""
    if self._create_optimizer_fn is not None:
      return self._create_optimizer_fn()
    from tensor2robot_tpu_torch.models import optimizers

    return optimizers.default_create_optimizer_fn()

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
