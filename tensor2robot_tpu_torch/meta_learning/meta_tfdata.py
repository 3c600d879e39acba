"""Meta-batch utilities: merge and split the [num_tasks, num_samples] dims.

The port's counterpart of ``flatten_batch_examples`` and
``unflatten_batch_examples`` in ``tensor2robot_tpu/meta_learning/
meta_tfdata.py``; ``multi_batch_apply`` and ``split_train_val`` are not
ported yet (the MAML path, ROADMAP.md queue 1 item 9).
"""

from __future__ import annotations

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
