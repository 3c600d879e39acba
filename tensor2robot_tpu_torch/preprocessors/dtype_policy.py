"""Device dtype-policy preprocessor: the host/device bfloat16 boundary.

The port's counterpart of ``tensor2robot_tpu/preprocessors/dtype_policy.py``.
On the way in, specs the device wants in bfloat16 are declared float32 to
the host pipeline; on the way out, optional specs are stripped and float32
tensors are cast to bfloat16 on the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

from tensor2robot_tpu_torch.preprocessors.base import AbstractPreprocessor
from tensor2robot_tpu_torch.specs import SpecStruct, algebra, dtypes


class DtypePolicyPreprocessor(AbstractPreprocessor):
  """Wraps a base preprocessor with the bfloat16 in/out policy."""

  def __init__(self, preprocessor: AbstractPreprocessor):
    super().__init__()
    self._preprocessor = preprocessor

  @property
  def wrapped(self) -> AbstractPreprocessor:
    return self._preprocessor

  def get_in_feature_specification(self, mode):
    return dtypes.cast_bfloat16_to_float32(
        self._preprocessor.get_in_feature_specification(mode))

  def get_in_label_specification(self, mode):
    spec = self._preprocessor.get_in_label_specification(mode)
    return None if spec is None else dtypes.cast_bfloat16_to_float32(spec)

  def get_out_feature_specification(self, mode):
    return dtypes.cast_float32_to_bfloat16(
        algebra.filter_required_flat_tensor_spec(
            algebra.flatten_spec_structure(
                self._preprocessor.get_out_feature_specification(mode))))

  def get_out_label_specification(self, mode):
    spec = self._preprocessor.get_out_label_specification(mode)
    if spec is None:
      return None
    return dtypes.cast_float32_to_bfloat16(
        algebra.filter_required_flat_tensor_spec(
            algebra.flatten_spec_structure(spec)))

  def _preprocess_fn(self, features, labels, mode,
                     generator) -> Tuple[SpecStruct, Optional[SpecStruct]]:
    features, labels = self._preprocessor._preprocess_fn(  # pylint: disable=protected-access
        features, labels, mode, generator)

    def apply_policy(tensors, out_spec):
      if tensors is None or out_spec is None:
        return None if out_spec is None else tensors
      flat = algebra.flatten_spec_structure(tensors)
      kept = SpecStruct((k, v) for k, v in flat.items() if k in out_spec)
      return dtypes.cast_arrays_to_spec_dtypes(out_spec, kept)

    return (apply_policy(features, self.get_out_feature_specification(mode)),
            apply_policy(labels, self.get_out_label_specification(mode)))
