"""Port specs: bfloat16 survives every dtype-policy round trip.

The JAX package's ``TensorSpec`` would turn bfloat16 into float32 where
``ml_dtypes`` is missing; the port represents bfloat16 as
``torch.bfloat16`` and never substitutes another dtype. The port's specs
are also compared with the JAX package's on the QT-Opt model.
"""

import numpy as np
import pytest
import torch

from tensor2robot_tpu.modes import ModeKeys as JaxModeKeys
from tensor2robot_tpu.research.qtopt import (
    GraspingModelWrapper as JaxGraspingModelWrapper)
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.research.qtopt import GraspingModelWrapper
from tensor2robot_tpu_torch.specs import (SpecStruct, TensorSpec, algebra,
                                          dtypes, make_random_numpy)
from tensor2robot_tpu_torch.specs.tensor_spec import dtype_name


def test_bfloat16_is_its_own_dtype():
  for name in ('bfloat16', torch.bfloat16):
    spec = TensorSpec(shape=(2,), dtype=name)
    assert spec.dtype is torch.bfloat16
    assert TensorSpec.from_spec(spec, shape=(3,)).dtype is torch.bfloat16
  assert TensorSpec((2,), np.float32).dtype is torch.float32
  assert TensorSpec((2,), np.uint8).dtype is torch.uint8


def test_bfloat16_round_trip_through_policy_casts():
  spec = SpecStruct()
  spec['a'] = TensorSpec((3,), np.float32, name='a')
  spec['b/c'] = TensorSpec((4,), np.uint8, name='c')
  down = dtypes.cast_float32_to_bfloat16(spec)
  assert down['a'].dtype is torch.bfloat16
  assert down['b/c'].dtype is torch.uint8
  up = dtypes.cast_bfloat16_to_float32(down)
  assert up == spec
  arrays = dtypes.cast_arrays_to_spec_dtypes(
      down, {'a': np.ones((2, 3), np.float32),
             'b/c': np.ones((2, 4), np.uint8)})
  assert arrays['a'].dtype == torch.bfloat16
  assert arrays['b/c'].dtype == np.uint8
  algebra.assert_equal(down, arrays, ignore_batch=True)


def test_numpy_generation_refuses_bfloat16():
  with pytest.raises(TypeError, match='bfloat16'):
    make_random_numpy({'a': TensorSpec((2,), 'bfloat16')})
  out = make_random_numpy({'img': TensorSpec((2, 2, 3), np.uint8)}, seed=0)
  assert out['img'].dtype == np.uint8 and out['img'].shape == (2, 2, 2, 3)


@pytest.mark.parametrize('device_type,jax_device_type',
                         [('gpu', 'tpu'), ('cpu', 'cpu')])
def test_qtopt_specs_match_jax(device_type, jax_device_type):
  model = GraspingModelWrapper(device_type=device_type)
  jax_model = JaxGraspingModelWrapper(device_type=jax_device_type)
  for getter in ('get_in_feature_specification',
                 'get_out_feature_specification'):
    got = getattr(model.preprocessor, getter)(ModeKeys.PREDICT)
    want = getattr(jax_model.preprocessor, getter)(JaxModeKeys.PREDICT)
    assert list(got) == list(want)
    for key in got:
      assert got[key].shape == want[key].shape, key
      assert dtype_name(got[key].dtype) == want[key].dtype.name, key
      assert got[key].name == want[key].name, key
