"""Tensor specs: declarations, structures, algebra and dtype policy."""

from tensor2robot_tpu_torch.specs import algebra, dtypes
from tensor2robot_tpu_torch.specs.algebra import (
    filter_required_flat_tensor_spec, flatten_spec_structure,
    validate_and_pack)
from tensor2robot_tpu_torch.specs.dtypes import (
    cast_arrays_to_spec_dtypes, cast_bfloat16_to_float32,
    cast_float32_to_bfloat16)
from tensor2robot_tpu_torch.specs.numpy_gen import (make_constant_numpy,
                                                    make_random_numpy)
from tensor2robot_tpu_torch.specs.spec_struct import SpecStruct
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec, bfloat16

__all__ = [
    'SpecStruct', 'TensorSpec', 'algebra', 'bfloat16',
    'cast_arrays_to_spec_dtypes', 'cast_bfloat16_to_float32',
    'cast_float32_to_bfloat16', 'dtypes', 'filter_required_flat_tensor_spec',
    'flatten_spec_structure', 'make_constant_numpy', 'make_random_numpy',
    'validate_and_pack',
]
