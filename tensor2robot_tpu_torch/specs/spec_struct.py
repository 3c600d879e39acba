"""SpecStruct: a container that is simultaneously flat and hierarchical.

The port's counterpart of ``tensor2robot_tpu/specs/spec_struct.py``. The
same value can be addressed two ways:

* **flat**: ``struct['train/images']``, the canonical '/'-joined path;
* **hierarchical**: ``struct.train.images``; intermediate nodes are live
  views that share storage with the root.

Leaves may be :class:`TensorSpec`, numpy arrays, torch tensors or ``None``
(an absent optional tensor). Assigning a Mapping expands it into child
paths.
"""

from __future__ import annotations

import collections
from collections import abc as collections_abc
from typing import Any, Iterator

import numpy as np

from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec

_SEP = '/'


def _is_valid_leaf(value: Any) -> bool:
  if value is None or isinstance(value, (TensorSpec, np.ndarray, np.generic)):
    return True
  if hasattr(value, 'dtype') and hasattr(value, 'shape'):
    return True
  return isinstance(value, (bytes, str, int, float))


class SpecStruct(collections_abc.MutableMapping):
  """Ordered flat path->leaf mapping with live hierarchical views."""

  __slots__ = ('_store', '_prefix')

  def __init__(self, *args, **kwargs):
    object.__setattr__(self, '_store', collections.OrderedDict())
    object.__setattr__(self, '_prefix', '')
    if args:
      if len(args) > 1:
        raise TypeError('SpecStruct accepts at most one positional argument.')
      initial = args[0]
      if isinstance(initial, collections_abc.Mapping):
        initial = initial.items()
      for key, value in initial:
        self[key] = value
    for key, value in kwargs.items():
      self[key] = value

  def __reduce__(self):
    return (type(self), (list(self.items()),))

  @classmethod
  def _view(cls, store: collections.OrderedDict, prefix: str) -> 'SpecStruct':
    view = cls.__new__(cls)
    object.__setattr__(view, '_store', store)
    object.__setattr__(view, '_prefix', prefix)
    return view

  def _full(self, key: str) -> str:
    if not isinstance(key, str):
      raise TypeError(f'SpecStruct keys must be str, got {type(key)}')
    key = key.strip(_SEP)
    if not key:
      raise KeyError('Empty key')
    return self._prefix + key

  def _is_subtree(self, full: str) -> bool:
    probe = full + _SEP
    return any(k.startswith(probe) for k in self._store)

  def __getitem__(self, key: str):
    full = self._full(key)
    if full in self._store:
      return self._store[full]
    if self._is_subtree(full):
      return SpecStruct._view(self._store, full + _SEP)
    raise KeyError(key)

  def __setitem__(self, key: str, value) -> None:
    full = self._full(key)
    if isinstance(value, SpecStruct):
      value = dict(value.items())
    if isinstance(value, collections_abc.Mapping):
      if not value:
        raise ValueError(f'Cannot assign an empty mapping to {key!r}.')
      if full in self._store:
        del self._store[full]
      for sub_key, sub_value in value.items():
        self[key + _SEP + sub_key] = sub_value
      return
    if not _is_valid_leaf(value):
      raise ValueError(
          f'Invalid leaf for SpecStruct[{key!r}]: {type(value)}. Expected '
          'TensorSpec, ndarray, torch tensor, tensor-like, or None.')
    if self._is_subtree(full):
      raise ValueError(
          f'Cannot assign a leaf to {key!r}: it is an existing subtree.')
    parts = full.split(_SEP)
    for i in range(1, len(parts)):
      ancestor = _SEP.join(parts[:i])
      if ancestor in self._store:
        raise ValueError(
            f'Cannot assign {key!r}: ancestor {ancestor!r} is an existing '
            'leaf.')
    self._store[full] = value

  def __delitem__(self, key: str) -> None:
    full = self._full(key)
    if full in self._store:
      del self._store[full]
      return
    subtree_keys = [k for k in self._store if k.startswith(full + _SEP)]
    if not subtree_keys:
      raise KeyError(key)
    for k in subtree_keys:
      del self._store[k]

  def __iter__(self) -> Iterator[str]:
    if not self._prefix:
      yield from list(self._store)
      return
    n = len(self._prefix)
    for k in list(self._store):
      if k.startswith(self._prefix):
        yield k[n:]

  def __len__(self) -> int:
    return sum(1 for _ in self)

  def __contains__(self, key) -> bool:
    try:
      full = self._full(key)
    except (TypeError, KeyError):
      return False
    return full in self._store or self._is_subtree(full)

  def __getattr__(self, name: str):
    if name.startswith('_'):
      raise AttributeError(name)
    try:
      return self[name]
    except KeyError:
      raise AttributeError(
          f'SpecStruct has no child {name!r}; children: {list(self)[:20]}')

  def __setattr__(self, name: str, value) -> None:
    if name.startswith('_'):
      object.__setattr__(self, name, value)
    else:
      self[name] = value

  def __delattr__(self, name: str) -> None:
    if name.startswith('_'):
      object.__delattr__(self, name)
    else:
      del self[name]

  def to_dict(self) -> collections.OrderedDict:
    """Plain flat OrderedDict of path -> leaf (relative to this view)."""
    return collections.OrderedDict(self.items())

  def copy(self) -> 'SpecStruct':
    return SpecStruct(self.items())

  def __eq__(self, other) -> bool:
    if not isinstance(other, collections_abc.Mapping):
      return NotImplemented
    if set(self.keys()) != set(other.keys()):
      return False
    for key, value in self.items():
      other_value = other[key]
      if isinstance(value, TensorSpec) or isinstance(other_value, TensorSpec):
        if value != other_value:
          return False
      elif not np.array_equal(np.asarray(value), np.asarray(other_value)):
        return False
    return True

  def __repr__(self) -> str:
    items = ', '.join(f'{k!r}: {v!r}' for k, v in self.items())
    return f'SpecStruct({{{items}}})'


TensorSpecStruct = SpecStruct
