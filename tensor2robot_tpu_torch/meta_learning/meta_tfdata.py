"""Meta-batch utilities: merge and split the [num_tasks, num_samples] dims.

The port's counterpart of ``tensor2robot_tpu/meta_learning/
meta_tfdata.py``: ``flatten_batch_examples``, ``unflatten_batch_examples``,
``multi_batch_apply`` and ``split_train_val``, over torch tensors (numpy
arrays take the same reshapes and slices). Task-grouped record reading is
``data/input_generators.TaskGroupedRecordInputGenerator``.
"""

from __future__ import annotations

from typing import Callable

from tensor2robot_tpu_torch.specs import SpecStruct, algebra


def _map_leaves(fn, structure):
  if structure is None:
    return None
  out = SpecStruct()
  for key, value in algebra.flatten_spec_structure(structure).items():
    out[key] = fn(value)
  return out


def flatten_batch_examples(tensor_collection):
  """[num_tasks, num_samples, ...] → [num_tasks*num_samples, ...]."""

  def flatten(value):
    shape = tuple(value.shape)
    return value.reshape((shape[0] * shape[1],) + shape[2:])

  return _map_leaves(flatten, tensor_collection)


def unflatten_batch_examples(tensor_collection, num_samples_per_task: int):
  """[num_tasks*num_samples, ...] → [num_tasks, num_samples, ...]."""

  def unflatten(value):
    return value.reshape((-1, num_samples_per_task) + tuple(value.shape[1:]))

  return _map_leaves(unflatten, tensor_collection)


def _tree_map(fn, tree):
  if isinstance(tree, dict):
    return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
  if isinstance(tree, (list, tuple)):
    return type(tree)(_tree_map(fn, v) for v in tree)
  return fn(tree)


def multi_batch_apply(fn: Callable, num_batch_dims: int, *args, **kwargs):
  """Applies ``fn`` (one batch dim) over ``num_batch_dims`` leading dims:
  every array leaf of ``args`` with that many dims has them merged into
  one, ``fn`` runs, and its array outputs are split back."""
  lead_shape = None

  def merge(value):
    nonlocal lead_shape
    if hasattr(value, 'shape') and len(value.shape) >= num_batch_dims:
      lead_shape = tuple(value.shape[:num_batch_dims])
      return value.reshape((-1,) + tuple(value.shape[num_batch_dims:]))
    return value

  result = fn(*_tree_map(merge, list(args)), **kwargs)
  if lead_shape is None:
    return result

  def split(value):
    if hasattr(value, 'shape'):
      return value.reshape(lead_shape + tuple(value.shape[1:]))
    return value

  return _tree_map(split, result)


def split_train_val(tensors, num_train_samples_per_task: int):
  """Splits the samples dim into (train, val)."""
  return (_map_leaves(lambda v: v[:, :num_train_samples_per_task], tensors),
          _map_leaves(lambda v: v[:, num_train_samples_per_task:], tensors))
