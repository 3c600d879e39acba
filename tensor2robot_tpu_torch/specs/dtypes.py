"""Dtype policy at the spec level: the bfloat16 mechanism.

The port's counterpart of ``tensor2robot_tpu/specs/dtypes.py``. The host
pipeline produces float32/uint8 numpy; the device entry casts per spec to
bfloat16 (:func:`cast_arrays_to_spec_dtypes`). bfloat16 is
``torch.bfloat16`` throughout, so the round trip float32 -> bfloat16 ->
float32 of a spec structure is exact and never degrades silently.
"""

from __future__ import annotations

import numpy as np
import torch

from tensor2robot_tpu_torch.specs.algebra import flatten_spec_structure
from tensor2robot_tpu_torch.specs.spec_struct import SpecStruct
from tensor2robot_tpu_torch.specs.tensor_spec import (TensorSpec, as_dtype,
                                                      bfloat16, to_numpy_dtype)


def replace_dtype(spec_structure, from_dtype, to_dtype) -> SpecStruct:
  """Copy of the spec structure with from_dtype specs re-typed to to_dtype."""
  from_dtype = as_dtype(from_dtype)
  to_dtype = as_dtype(to_dtype)
  out = SpecStruct()
  for key, value in flatten_spec_structure(spec_structure).items():
    spec = TensorSpec.to_spec(value)
    if spec.dtype == from_dtype:
      spec = TensorSpec.from_spec(spec, dtype=to_dtype)
    out[key] = spec
  return out


def cast_float32_to_bfloat16(spec_structure) -> SpecStruct:
  return replace_dtype(spec_structure, torch.float32, bfloat16)


def cast_bfloat16_to_float32(spec_structure) -> SpecStruct:
  return replace_dtype(spec_structure, bfloat16, torch.float32)


def cast_arrays_to_spec_dtypes(spec_structure, tensors) -> SpecStruct:
  """Casts each tensor to the dtype its spec declares.

  Torch tensors are cast on their own device. A numpy array whose spec is
  bfloat16 becomes a CPU torch tensor, since numpy cannot hold bfloat16;
  other numpy arrays stay numpy.
  """
  flat_spec = flatten_spec_structure(spec_structure)
  out = SpecStruct()
  for key, tensor in flatten_spec_structure(tensors).items():
    spec = flat_spec.get(key)
    if not isinstance(spec, TensorSpec) or as_dtype(tensor.dtype) == spec.dtype:
      out[key] = tensor
    elif isinstance(tensor, torch.Tensor):
      out[key] = tensor.to(spec.dtype)
    elif spec.dtype == bfloat16:
      out[key] = torch.from_numpy(np.ascontiguousarray(tensor)).to(bfloat16)
    else:
      out[key] = np.asarray(tensor).astype(to_numpy_dtype(spec.dtype))
  return out
