"""Preprocessor contract: 4 spec getters + a transform on tensors.

The port's counterpart of ``tensor2robot_tpu/preprocessors/base.py``. The
spec contract is unchanged:

* ``get_in_*_specification(mode)``: what arrives from the data layer;
* ``get_out_*_specification(mode)``: what the model consumes;
* ``preprocess`` = validate+pack(in) -> ``_preprocess_fn`` ->
  validate+pack(out).

``_preprocess_fn`` works on torch tensors on whatever device they lie on,
so crops and casts run on the card next to the model. Randomness is
explicit: a ``torch.Generator`` is threaded in.
"""

from __future__ import annotations

import abc
from typing import Callable, Optional, Tuple

from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec, algebra

SpecGetter = Callable[[str], SpecStruct]


class AbstractPreprocessor(abc.ABC):
  """Base preprocessor; subclasses define specs and the transform."""

  def __init__(self,
               model_feature_specification_fn: Optional[SpecGetter] = None,
               model_label_specification_fn: Optional[SpecGetter] = None):
    self._model_feature_specification_fn = model_feature_specification_fn
    self._model_label_specification_fn = model_label_specification_fn

  def model_feature_specification(self, mode: str) -> Optional[SpecStruct]:
    if self._model_feature_specification_fn is None:
      return None
    return algebra.flatten_spec_structure(
        self._model_feature_specification_fn(mode))

  def model_label_specification(self, mode: str) -> Optional[SpecStruct]:
    if self._model_label_specification_fn is None:
      return None
    spec = self._model_label_specification_fn(mode)
    return None if spec is None else algebra.flatten_spec_structure(spec)

  @abc.abstractmethod
  def get_in_feature_specification(self, mode: str) -> SpecStruct:
    ...

  @abc.abstractmethod
  def get_in_label_specification(self, mode: str) -> Optional[SpecStruct]:
    ...

  @abc.abstractmethod
  def get_out_feature_specification(self, mode: str) -> SpecStruct:
    ...

  @abc.abstractmethod
  def get_out_label_specification(self, mode: str) -> Optional[SpecStruct]:
    ...

  def _preprocess_fn(self, features: SpecStruct,
                     labels: Optional[SpecStruct], mode: str,
                     generator) -> Tuple[SpecStruct, Optional[SpecStruct]]:
    """Transform on tensors; default is identity."""
    del mode, generator
    return features, labels

  def preprocess(self,
                 features,
                 labels,
                 mode: str,
                 generator=None) -> Tuple[SpecStruct, Optional[SpecStruct]]:
    """Validated preprocess (validation reads shapes and dtypes only)."""
    features = algebra.validate_and_pack(
        self.get_in_feature_specification(mode), features, ignore_batch=True)
    in_label_spec = self.get_in_label_specification(mode)
    if labels is not None and in_label_spec is not None:
      labels = algebra.validate_and_pack(
          in_label_spec, labels, ignore_batch=True)
    elif in_label_spec is None:
      labels = None
    features, labels = self._preprocess_fn(features, labels, mode, generator)
    features = algebra.validate_and_pack(
        self.get_out_feature_specification(mode), features,
        ignore_batch=True)
    out_label_spec = self.get_out_label_specification(mode)
    if labels is not None and out_label_spec is not None:
      labels = algebra.validate_and_pack(
          out_label_spec, labels, ignore_batch=True)
    return features, labels

  __call__ = preprocess


class NoOpPreprocessor(AbstractPreprocessor):
  """Identity: in specs == out specs == model specs."""

  def get_in_feature_specification(self, mode):
    return self.model_feature_specification(mode)

  def get_in_label_specification(self, mode):
    return self.model_label_specification(mode)

  def get_out_feature_specification(self, mode):
    return self.model_feature_specification(mode)

  def get_out_label_specification(self, mode):
    return self.model_label_specification(mode)


class SpecTransformationPreprocessor(NoOpPreprocessor):
  """Convenience base: mutate copies of the model specs per direction.

  Override ``_transform_in_feature_specification`` (etc.) to derive the
  data contract from the model contract, e.g. declare that a float32
  image the model wants arrives as a uint8-encoded JPEG.
  """

  def update_spec(self, spec_struct: SpecStruct, key: str,
                  **overrides) -> None:
    """In-place override of one spec in a (copied) struct."""
    spec_struct[key] = TensorSpec.from_spec(spec_struct[key], **overrides)

  def _transform_in_feature_specification(self, spec: SpecStruct,
                                          mode: str) -> SpecStruct:
    del mode
    return spec

  def _transform_in_label_specification(
      self, spec: Optional[SpecStruct], mode: str) -> Optional[SpecStruct]:
    del mode
    return spec

  def _transform_out_feature_specification(self, spec: SpecStruct,
                                           mode: str) -> SpecStruct:
    del mode
    return spec

  def _transform_out_label_specification(
      self, spec: Optional[SpecStruct], mode: str) -> Optional[SpecStruct]:
    del mode
    return spec

  def get_in_feature_specification(self, mode):
    return self._transform_in_feature_specification(
        self.model_feature_specification(mode).copy(), mode)

  def get_in_label_specification(self, mode):
    spec = self.model_label_specification(mode)
    return self._transform_in_label_specification(
        None if spec is None else spec.copy(), mode)

  def get_out_feature_specification(self, mode):
    return self._transform_out_feature_specification(
        self.model_feature_specification(mode).copy(), mode)

  def get_out_label_specification(self, mode):
    spec = self.model_label_specification(mode)
    return self._transform_out_label_specification(
        None if spec is None else spec.copy(), mode)
