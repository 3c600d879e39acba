"""TensorSpec: the typed declaration of a single tensor.

The port's counterpart of ``tensor2robot_tpu/specs/tensor_spec.py``. A spec
is a frozen, hashable dataclass. Its dtype is canonicalised to a
``torch.dtype``: numpy arrays, torch tensors and dtype names all map onto
the same value, so a spec validates numpy batches on the host and torch
tensors on the device alike.

bfloat16 is ``torch.bfloat16`` and nothing else. numpy has no bfloat16
without an extension package, so a spec never falls back to float32 when
one is missing: a bfloat16 spec stays bfloat16 through every copy and
dtype-policy round trip (``specs/dtypes.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch

bfloat16 = torch.bfloat16

DTypeLike = Any
ShapeLike = Union[Sequence[Optional[int]], int, None]

_IMAGE_FORMATS = ('JPEG', 'PNG')


def as_dtype(dtype: DTypeLike) -> torch.dtype:
  """Canonicalises torch/numpy/string dtypes to a ``torch.dtype``."""
  if dtype is None:
    raise ValueError('dtype must not be None')
  if isinstance(dtype, torch.dtype):
    return dtype
  name = dtype if isinstance(dtype, str) else getattr(dtype, 'name', None)
  if name == 'bfloat16':
    return bfloat16
  np_dtype = np.dtype(dtype)
  return torch.from_numpy(np.empty((0,), np_dtype)).dtype


def dtype_name(dtype: DTypeLike) -> str:
  return str(as_dtype(dtype)).replace('torch.', '')


def to_numpy_dtype(dtype: DTypeLike) -> np.dtype:
  """The numpy dtype of a spec dtype; raises for bfloat16, which numpy
  cannot hold."""
  dtype = as_dtype(dtype)
  if dtype == bfloat16:
    raise TypeError('numpy has no bfloat16; bfloat16 data lives in torch '
                    'tensors only.')
  return torch.empty((0,), dtype=dtype).numpy().dtype


def _canonical_shape(shape: ShapeLike) -> Tuple[Optional[int], ...]:
  if shape is None:
    return ()
  if isinstance(shape, (int, np.integer)):
    return (int(shape),)
  out = []
  for dim in shape:
    if dim is None:
      out.append(None)
      continue
    d = int(dim)
    out.append(None if d < 0 else d)
  return tuple(out)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
  """A frozen declaration of one tensor's shape, dtype and data semantics."""

  shape: Tuple[Optional[int], ...]
  dtype: torch.dtype
  name: Optional[str] = None
  is_optional: bool = False
  is_sequence: bool = False
  is_extracted: bool = False
  data_format: Optional[str] = None
  dataset_key: str = ''
  varlen_default_value: Optional[float] = None

  def __init__(self,
               shape: ShapeLike,
               dtype: DTypeLike,
               name: Optional[str] = None,
               is_optional: Optional[bool] = None,
               is_sequence: Optional[bool] = None,
               is_extracted: Optional[bool] = None,
               data_format: Optional[str] = None,
               dataset_key: Optional[str] = None,
               varlen_default_value: Optional[float] = None):
    object.__setattr__(self, 'shape', _canonical_shape(shape))
    object.__setattr__(self, 'dtype', as_dtype(dtype))
    object.__setattr__(self, 'name', name)
    object.__setattr__(self, 'is_optional', bool(is_optional))
    object.__setattr__(self, 'is_sequence', bool(is_sequence))
    object.__setattr__(self, 'is_extracted', bool(is_extracted))
    if data_format is not None:
      data_format = data_format.upper()
      if data_format not in _IMAGE_FORMATS:
        raise ValueError(
            f'data_format must be one of {_IMAGE_FORMATS}, got {data_format}')
    object.__setattr__(self, 'data_format', data_format)
    object.__setattr__(self, 'dataset_key', dataset_key or '')
    if varlen_default_value is not None:
      varlen_default_value = float(varlen_default_value)
    object.__setattr__(self, 'varlen_default_value', varlen_default_value)

  @classmethod
  def from_spec(cls,
                spec: 'TensorSpec',
                shape: ShapeLike = None,
                dtype: DTypeLike = None,
                name: Optional[str] = None,
                batch_size: int = -1,
                **overrides) -> 'TensorSpec':
    """Copy of ``spec`` with optional overrides.

    ``batch_size``: ``-1`` leaves the shape alone, ``None`` prepends a
    dynamic batch dim, ``N > 0`` prepends a fixed batch dim.
    """
    kwargs = dict(
        shape=spec.shape if shape is None else _canonical_shape(shape),
        dtype=spec.dtype if dtype is None else as_dtype(dtype),
        name=spec.name if name is None else name,
        is_optional=spec.is_optional,
        is_sequence=spec.is_sequence,
        is_extracted=spec.is_extracted,
        data_format=spec.data_format,
        dataset_key=spec.dataset_key,
        varlen_default_value=spec.varlen_default_value,
    )
    kwargs.update(overrides)
    if batch_size is None:
      kwargs['shape'] = (None,) + tuple(kwargs['shape'])
    elif batch_size != -1:
      kwargs['shape'] = (int(batch_size),) + tuple(kwargs['shape'])
    return cls(**kwargs)

  @classmethod
  def from_array(cls, array, name: Optional[str] = None) -> 'TensorSpec':
    """Spec extracted from a concrete numpy array or torch tensor. A
    symbolic dim (a tensor traced by ``torch.export`` with a dynamic batch)
    becomes a dynamic one (None), so validating a traced batch never fixes
    its size."""
    dtype = getattr(array, 'dtype', None)
    if dtype is None:
      array = np.asarray(array)
      dtype = array.dtype
    shape = tuple(None if isinstance(d, torch.SymInt) else int(d)
                  for d in array.shape)
    return cls(shape=shape, dtype=dtype, name=name, is_extracted=True)

  @classmethod
  def to_spec(cls, instance) -> 'TensorSpec':
    """Normalises a spec or a concrete array to a TensorSpec."""
    if isinstance(instance, TensorSpec):
      return instance
    return cls.from_array(instance)

  # ------------------------------------------------------------ serialization

  def to_proto_fields(self) -> dict:
    """The fields of the ``ExtendedTensorSpec`` message
    (``tensor2robot_tpu/proto/t2r.proto``) that proto3 would write, in
    field order: -1 for a dynamic dim, the dtype by its numpy name, flags
    only when set, the varlen default with its presence flag."""
    fields = {'shape': [-1 if d is None else d for d in self.shape],
              'dtype': dtype_name(self.dtype)}
    if self.name:
      fields['name'] = self.name
    for field in ('is_optional', 'is_extracted'):
      if getattr(self, field):
        fields[field] = True
    if self.data_format:
      fields['data_format'] = self.data_format
    if self.dataset_key:
      fields['dataset_key'] = self.dataset_key
    if self.varlen_default_value is not None:
      fields['varlen_default_value'] = self.varlen_default_value
      fields['has_varlen_default_value'] = True
    if self.is_sequence:
      fields['is_sequence'] = True
    return fields

  @classmethod
  def from_proto_fields(cls, fields: dict) -> 'TensorSpec':
    """The spec of an ``ExtendedTensorSpec``'s fields (absent = default)."""
    return cls(
        shape=tuple(None if d < 0 else d for d in fields.get('shape', ())),
        dtype=fields.get('dtype') or 'float32',
        name=fields.get('name') or None,
        is_optional=fields.get('is_optional', False),
        is_sequence=fields.get('is_sequence', False),
        is_extracted=fields.get('is_extracted', False),
        data_format=fields.get('data_format') or None,
        dataset_key=fields.get('dataset_key') or None,
        varlen_default_value=(fields.get('varlen_default_value', 0.0)
                              if fields.get('has_varlen_default_value')
                              else None))

  def to_json_dict(self) -> dict:
    """The JAX package's JSON form (``t2r_assets.json``)."""
    d = {'shape': [-1 if s is None else s for s in self.shape],
         'dtype': dtype_name(self.dtype)}
    if self.name is not None:
      d['name'] = self.name
    for field in ('is_optional', 'is_sequence', 'is_extracted'):
      if getattr(self, field):
        d[field] = True
    if self.data_format is not None:
      d['data_format'] = self.data_format
    if self.dataset_key:
      d['dataset_key'] = self.dataset_key
    if self.varlen_default_value is not None:
      d['varlen_default_value'] = self.varlen_default_value
    return d

  @classmethod
  def from_json_dict(cls, d: dict) -> 'TensorSpec':
    return cls(
        shape=tuple(None if s < 0 else s for s in d['shape']),
        dtype=d['dtype'],
        name=d.get('name'),
        is_optional=d.get('is_optional', False),
        is_sequence=d.get('is_sequence', False),
        is_extracted=d.get('is_extracted', False),
        data_format=d.get('data_format'),
        dataset_key=d.get('dataset_key'),
        varlen_default_value=d.get('varlen_default_value'))

  def __eq__(self, other) -> bool:
    if not isinstance(other, TensorSpec):
      return NotImplemented
    return (self.shape == other.shape and self.dtype == other.dtype and
            self.name == other.name and
            self.is_optional == other.is_optional and
            self.is_sequence == other.is_sequence and
            self.data_format == other.data_format and
            self.dataset_key == other.dataset_key and
            self.varlen_default_value == other.varlen_default_value)

  def __hash__(self):
    return hash((self.shape, self.dtype, self.name, self.is_optional,
                 self.is_sequence, self.data_format, self.dataset_key))

  def __repr__(self):
    parts = [f'shape={self.shape}', f'dtype={dtype_name(self.dtype)}']
    if self.name:
      parts.append(f'name={self.name!r}')
    for field in ('is_optional', 'is_sequence', 'is_extracted'):
      if getattr(self, field):
        parts.append(f'{field}=True')
    if self.data_format:
      parts.append(f'data_format={self.data_format!r}')
    if self.dataset_key:
      parts.append(f'dataset_key={self.dataset_key!r}')
    if self.varlen_default_value is not None:
      parts.append(f'varlen_default_value={self.varlen_default_value}')
    return f'TensorSpec({", ".join(parts)})'

