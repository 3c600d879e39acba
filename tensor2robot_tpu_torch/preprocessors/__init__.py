"""Preprocessors: the spec contract between data and model."""

from tensor2robot_tpu_torch.preprocessors.base import (
    AbstractPreprocessor, NoOpPreprocessor, SpecTransformationPreprocessor)
from tensor2robot_tpu_torch.preprocessors.dtype_policy import (
    DtypePolicyPreprocessor)

__all__ = [
    'AbstractPreprocessor', 'DtypePolicyPreprocessor', 'NoOpPreprocessor',
    'SpecTransformationPreprocessor',
]
