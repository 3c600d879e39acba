"""Spec algebra: flatten / pack / validate / filter.

The port's counterpart of ``tensor2robot_tpu/specs/algebra.py``, limited
to what the serving path calls. Semantics are the same:

* flattening joins paths with '/' and drops ``None`` leaves;
* packing matches the flat path keys of the expected spec;
* validation checks dtype and shape per dimension with ``None`` as a
  wildcard, tolerates missing optional specs, and can ignore the leading
  batch dim.
"""

from __future__ import annotations

from collections import abc as collections_abc

import numpy as np

from tensor2robot_tpu_torch.specs.spec_struct import SpecStruct
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec

_SEP = '/'


def _is_namedtuple(value) -> bool:
  return isinstance(value, tuple) and hasattr(value, '_fields')


def _is_leaf(value) -> bool:
  if value is None or isinstance(value, TensorSpec):
    return True
  if isinstance(value, (SpecStruct, collections_abc.Mapping)):
    return False
  return not (_is_namedtuple(value) or isinstance(value, (list, tuple)))


def assert_valid_spec_structure(spec_or_tensors) -> None:
  """Raises ValueError if any leaf is not spec/tensor-like/None."""
  for key, value in _iter_flat(spec_or_tensors, filter_none=False):
    if value is None or isinstance(value, TensorSpec):
      continue
    if hasattr(value, 'dtype') and hasattr(value, 'shape'):
      continue
    if isinstance(value, (np.ndarray, np.generic, bytes, str, int, float)):
      continue
    raise ValueError(
        f'Invalid spec structure leaf at {key!r}: {type(value)}')


def _iter_flat(structure, prefix: str = '', filter_none: bool = True):
  """Yields ('/'-joined path, leaf) pairs depth-first."""
  if isinstance(structure, SpecStruct):
    for key, value in structure.items():
      if filter_none and value is None:
        continue
      yield prefix + key, value
    return
  if _is_namedtuple(structure):
    items = zip(structure._fields, structure)
  elif isinstance(structure, collections_abc.Mapping):
    items = structure.items()
  elif isinstance(structure, (list, tuple)):
    items = ((str(i), v) for i, v in enumerate(structure))
  else:
    if not (filter_none and structure is None):
      yield prefix.rstrip(_SEP), structure
    return
  for key, value in items:
    if _is_leaf(value):
      if filter_none and value is None:
        continue
      yield prefix + str(key), value
    else:
      yield from _iter_flat(value, prefix + str(key) + _SEP, filter_none)


def is_flat_spec_or_tensors_structure(spec_or_tensors) -> bool:
  """True if the structure is already a flat path->leaf mapping."""
  if isinstance(spec_or_tensors, SpecStruct):
    return True
  if not isinstance(spec_or_tensors, collections_abc.Mapping):
    return False
  return all(_is_leaf(v) for v in spec_or_tensors.values())


def flatten_spec_structure(spec_or_tensors,
                           filter_none: bool = True) -> SpecStruct:
  """Flattens any supported hierarchy into a SpecStruct of joined paths."""
  assert_valid_spec_structure(spec_or_tensors)
  return SpecStruct(_iter_flat(spec_or_tensors, filter_none=filter_none))


def pack_flat_sequence_to_spec_structure(spec_structure,
                                         flat_sequence) -> SpecStruct:
  """Packs a flat path->tensor mapping into the expected spec hierarchy.

  Optional specs with no matching tensor are dropped; required specs with
  no matching tensor raise.
  """
  assert_valid_spec_structure(spec_structure)
  expected_flat = flatten_spec_structure(spec_structure, filter_none=False)
  if not is_flat_spec_or_tensors_structure(flat_sequence):
    flat_sequence = flatten_spec_structure(flat_sequence)
  flat = dict(flat_sequence.items())

  packed = SpecStruct()
  for key, spec in sorted(expected_flat.items()):
    if key in flat:
      packed[key] = flat[key]
      continue
    if spec is None or getattr(spec, 'is_optional', False):
      continue
    raise ValueError(
        f'The required spec {key!r} ({spec}) is not available; provided keys: '
        f'{sorted(flat)}')
  return packed


def maybe_ignore_batch(spec_or_tensors, ignore_batch: bool = False):
  """Strips the leading (batch) dim from every spec/tensor's shape."""
  if not ignore_batch:
    return spec_or_tensors

  def strip(value):
    if value is None:
      return None
    spec = TensorSpec.to_spec(value)
    if not spec.shape:
      raise ValueError(f'Cannot ignore batch dim of scalar spec {spec}.')
    return TensorSpec.from_spec(spec, shape=spec.shape[1:])

  flat = flatten_spec_structure(spec_or_tensors, filter_none=False)
  return SpecStruct((k, strip(v)) for k, v in flat.to_dict().items())


def assert_equal_spec_or_tensor(expected_spec_or_tensor,
                                actual_spec_or_tensor) -> None:
  """Checks dtype and per-dim shape (None = wildcard) of a single leaf."""
  expected = TensorSpec.to_spec(expected_spec_or_tensor)
  actual = TensorSpec.to_spec(actual_spec_or_tensor)
  if expected.is_sequence and actual.is_extracted:
    actual = TensorSpec.from_spec(actual, shape=actual.shape[1:])
  if expected.dtype != actual.dtype:
    raise ValueError(
        f'dtype mismatch: expected {expected.dtype} got {actual.dtype}\n'
        f' expected: {expected}\n actual: {actual}')
  if len(expected.shape) != len(actual.shape):
    raise ValueError(
        f'rank mismatch: expected {expected.shape} got {actual.shape}\n'
        f' expected: {expected}\n actual: {actual}')
  for expected_dim, actual_dim in zip(expected.shape, actual.shape):
    if expected_dim is None or actual_dim is None:
      continue
    if expected_dim != actual_dim:
      raise ValueError(
          f'shape mismatch: expected {expected.shape} got {actual.shape}')


def assert_equal(expected_tensors_or_spec,
                 actual_tensors_or_spec,
                 ignore_batch: bool = False) -> None:
  """Asserts both structures have identical keys, dtypes and shapes."""
  actual = maybe_ignore_batch(actual_tensors_or_spec, ignore_batch)
  expected_flat = flatten_spec_structure(expected_tensors_or_spec)
  actual_flat = flatten_spec_structure(actual)
  if set(expected_flat.keys()) != set(actual_flat.keys()):
    missing = set(expected_flat) - set(actual_flat)
    extra = set(actual_flat) - set(expected_flat)
    raise ValueError(
        f'Structure mismatch; missing: {sorted(missing)}, '
        f'unexpected: {sorted(extra)}')
  for key in expected_flat:
    assert_equal_spec_or_tensor(expected_flat[key], actual_flat[key])


def assert_required(expected_spec,
                    actual_tensors_or_spec,
                    ignore_batch: bool = False) -> None:
  """Asserts all required expected specs are fulfilled by the actual data."""
  flat_actual = flatten_spec_structure(actual_tensors_or_spec)
  packed = pack_flat_sequence_to_spec_structure(expected_spec, flat_actual)
  flat_packed = flatten_spec_structure(packed)
  expected_flat = flatten_spec_structure(expected_spec)
  expected_subset = SpecStruct(
      (k, v) for k, v in expected_flat.items() if k in flat_packed)
  assert_equal(expected_subset, flat_packed, ignore_batch)


def validate_and_pack(expected_spec,
                      actual_tensors_or_spec,
                      ignore_batch: bool = False) -> SpecStruct:
  """Validates required specs then packs the data into the spec hierarchy."""
  if not is_flat_spec_or_tensors_structure(actual_tensors_or_spec):
    actual_tensors_or_spec = flatten_spec_structure(actual_tensors_or_spec)
  assert_required(expected_spec, actual_tensors_or_spec, ignore_batch)
  return pack_flat_sequence_to_spec_structure(expected_spec,
                                              actual_tensors_or_spec)


def filter_required_flat_tensor_spec(flat_tensor_spec) -> SpecStruct:
  """Subset containing only non-optional specs."""
  if not is_flat_spec_or_tensors_structure(flat_tensor_spec):
    raise ValueError(f'Expected a flat structure, got {flat_tensor_spec!r}')
  return SpecStruct(
      (k, v) for k, v in flat_tensor_spec.items()
      if not getattr(v, 'is_optional', False))
