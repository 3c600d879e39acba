"""Spec-driven numpy data generation.

The port's counterpart of ``tensor2robot_tpu/specs/numpy_gen.py``, limited
to :func:`make_random_numpy`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tensor2robot_tpu_torch.specs.algebra import flatten_spec_structure
from tensor2robot_tpu_torch.specs.spec_struct import SpecStruct
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec, to_numpy_dtype

_DEFAULT_SEQUENCE_LENGTH = 3


def _concrete_shape(spec: TensorSpec, batch_size: Optional[int],
                    sequence_length: int) -> tuple:
  shape = tuple(1 if d is None else d for d in spec.shape)
  if spec.is_sequence and not spec.is_extracted:
    shape = (sequence_length,) + shape
  if batch_size is not None and batch_size != -1:
    shape = (batch_size,) + shape
  return shape


def make_random_numpy(spec_structure,
                      batch_size: int = 2,
                      sequence_length: int = _DEFAULT_SEQUENCE_LENGTH,
                      seed: Optional[int] = None) -> SpecStruct:
  """Random numpy arrays shaped like the spec structure.

  Float dtypes get uniform [0, 1); bools uniform {0, 1}; uint8 uniform
  [0, 255]; other ints [0, 10). Raises for bfloat16 specs (numpy has no
  bfloat16): generate host data from the float32 in-specs.
  """
  rng = np.random.default_rng(seed)
  out = SpecStruct()
  for key, value in flatten_spec_structure(spec_structure).items():
    spec = TensorSpec.to_spec(value)
    dtype = to_numpy_dtype(spec.dtype)
    shape = _concrete_shape(spec, batch_size, sequence_length)
    if dtype == np.bool_:
      out[key] = rng.integers(0, 2, size=shape).astype(np.bool_)
    elif np.issubdtype(dtype, np.integer):
      high = 256 if dtype == np.uint8 else 10
      out[key] = rng.integers(0, high, size=shape).astype(dtype)
    else:
      out[key] = rng.random(size=shape).astype(dtype)
  return out
