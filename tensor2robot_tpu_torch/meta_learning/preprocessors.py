"""Meta-learning preprocessors: condition/inference spec transforms.

The port's counterpart of ``tensor2robot_tpu/meta_learning/preprocessors.py``:

* :func:`create_maml_feature_spec` — base specs → ``condition/{features,
  labels}`` + ``inference/features`` with ``condition_features`` /
  ``condition_labels`` / ``inference_features`` name prefixes (the on-disk
  contract), each with a dynamic samples dim;
* :func:`create_maml_label_spec` — the ``meta_labels`` prefix;
* :class:`MAMLPreprocessorV2` — runs a base preprocessor over the
  flattened task×sample batch;
* :func:`create_metaexample_spec`, :func:`stack_intra_task_episodes` and
  :class:`FixedLenMetaExamplePreprocessor` — K condition + M inference
  episodes from one MetaExample record (``<prefix>_ep<i>/<name>``
  columns), stacked into per-task tensors.

The JAX package hands the condition and the inference episodes the same
random key, so both draw the same crop offsets. Here the generator's state
is saved before the condition call and restored for the inference call,
which gives the same pairing. At ``steps_per_dispatch`` > 1 the base
preprocessor's draws are taken once (``host_draws``) and both calls take
the same ``DeviceDraws``.
"""

from __future__ import annotations

import torch

from tensor2robot_tpu_torch.meta_learning import meta_tfdata
from tensor2robot_tpu_torch.preprocessors.base import AbstractPreprocessor
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec, algebra


def create_maml_feature_spec(feature_spec, label_spec) -> SpecStruct:
  """Base specs → meta feature spec; every spec gains a dynamic leading
  samples dim (meta batches are [num_tasks, num_samples, ...])."""
  meta = SpecStruct()
  for key, spec in algebra.copy_tensorspec(
      feature_spec, prefix='condition_features', batch_size=None).items():
    meta[f'condition/features/{key}'] = spec
  for key, spec in algebra.copy_tensorspec(
      label_spec, prefix='condition_labels', batch_size=None).items():
    meta[f'condition/labels/{key}'] = spec
  for key, spec in algebra.copy_tensorspec(
      feature_spec, prefix='inference_features', batch_size=None).items():
    meta[f'inference/features/{key}'] = spec
  return meta


def create_maml_label_spec(label_spec) -> SpecStruct:
  """Base label spec → meta label spec."""
  return algebra.copy_tensorspec(
      label_spec, prefix='meta_labels', batch_size=None)


class MAMLPreprocessorV2(AbstractPreprocessor):
  """Wraps a base preprocessor over the task×sample meta batch: the base
  preprocessor sees the flattened [num_tasks*num_samples, ...] batch and
  its outputs are unflattened back."""

  def __init__(self, base_preprocessor: AbstractPreprocessor, **kwargs):
    super().__init__(**kwargs)
    self._base_preprocessor = base_preprocessor

  @property
  def base_preprocessor(self) -> AbstractPreprocessor:
    return self._base_preprocessor

  def get_in_feature_specification(self, mode):
    return create_maml_feature_spec(
        self._base_preprocessor.get_in_feature_specification(mode),
        self._base_preprocessor.get_in_label_specification(mode))

  def get_in_label_specification(self, mode):
    return create_maml_label_spec(
        self._base_preprocessor.get_in_label_specification(mode))

  def get_out_feature_specification(self, mode):
    return create_maml_feature_spec(
        self._base_preprocessor.get_out_feature_specification(mode),
        self._base_preprocessor.get_out_label_specification(mode))

  def get_out_label_specification(self, mode):
    return create_maml_label_spec(
        self._base_preprocessor.get_out_label_specification(mode))

  def host_draws(self, generator: torch.Generator):
    """The base preprocessor's draws, taken once: the condition and the
    inference call replay the same generator state, so they take the same
    ``DeviceDraws``."""
    return self._base_preprocessor.host_draws(generator)

  def _subtree(self, features, prefix: str) -> SpecStruct:
    out = SpecStruct()
    for key, value in features.items():
      if key.startswith(prefix + '/'):
        out[key[len(prefix) + 1:]] = value
    return out

  def _preprocess_fn(self, features, labels, mode, generator):
    condition_features = self._subtree(features, 'condition/features')
    condition_labels = self._subtree(features, 'condition/labels')
    inference_features = self._subtree(features, 'inference/features')

    num_condition = next(iter(condition_features.values())).shape[1]
    num_inference = next(iter(inference_features.values())).shape[1]

    flat_cond_f = meta_tfdata.flatten_batch_examples(condition_features)
    flat_cond_l = meta_tfdata.flatten_batch_examples(condition_labels)
    flat_inf_f = meta_tfdata.flatten_batch_examples(inference_features)
    flat_labels = (None if labels is None else
                   meta_tfdata.flatten_batch_examples(labels))

    state = (generator.get_state() if isinstance(generator, torch.Generator)
             else None)
    flat_cond_f, flat_cond_l = self._base_preprocessor._preprocess_fn(  # pylint: disable=protected-access
        flat_cond_f, flat_cond_l, mode, generator)
    if state is not None:
      generator.set_state(state)  # the same draws as the condition call
    flat_inf_f, flat_labels = self._base_preprocessor._preprocess_fn(  # pylint: disable=protected-access
        flat_inf_f, flat_labels, mode, generator)

    out = SpecStruct()
    for key, value in meta_tfdata.unflatten_batch_examples(
        flat_cond_f, num_condition).items():
      out[f'condition/features/{key}'] = value
    for key, value in meta_tfdata.unflatten_batch_examples(
        flat_cond_l, num_condition).items():
      out[f'condition/labels/{key}'] = value
    for key, value in meta_tfdata.unflatten_batch_examples(
        flat_inf_f, num_inference).items():
      out[f'inference/features/{key}'] = value
    if flat_labels is not None:
      labels = meta_tfdata.unflatten_batch_examples(flat_labels,
                                                    num_inference)
    return out, labels


def create_metaexample_spec(model_spec, num_samples_per_task: int,
                            prefix: str) -> SpecStruct:
  """Spec → per-episode MetaExample spec: each ``key`` expands to
  ``key/i`` with on-disk name ``<prefix>_ep<i>/<name>``."""
  model_spec = algebra.flatten_spec_structure(model_spec)
  meta_example_spec = SpecStruct()
  for key in model_spec.keys():
    for i in range(num_samples_per_task):
      spec = model_spec[key]
      name = spec.name or key.split('/')[-1]
      meta_example_spec[f'{key}/{i}'] = TensorSpec.from_spec(
          spec, name=f'{prefix}_ep{i}/{name}')
  return meta_example_spec


def stack_intra_task_episodes(in_tensors, num_samples_per_task: int):
  """Stacks ``key/i`` episode tensors → [B, num_samples, ...] per key."""
  out_tensors = SpecStruct()
  key_set = sorted({'/'.join(k.split('/')[:-1]) for k in in_tensors.keys()})
  for key in key_set:
    data = [in_tensors[f'{key}/{i}'] for i in range(num_samples_per_task)]
    out_tensors[key] = torch.stack(data, dim=1)
  return out_tensors


class FixedLenMetaExamplePreprocessor(MAMLPreprocessorV2):
  """Parses K condition + M inference episodes from one MetaExample record."""

  def __init__(self,
               base_preprocessor: AbstractPreprocessor,
               num_condition_samples_per_task: int = 1,
               num_inference_samples_per_task: int = 1,
               **kwargs):
    self._num_condition_samples_per_task = num_condition_samples_per_task
    self._num_inference_samples_per_task = num_inference_samples_per_task
    super().__init__(base_preprocessor, **kwargs)

  @property
  def num_condition_samples_per_task(self) -> int:
    return self._num_condition_samples_per_task

  @property
  def num_inference_samples_per_task(self) -> int:
    return self._num_inference_samples_per_task

  def get_in_feature_specification(self, mode):
    base = self._base_preprocessor
    condition_spec = SpecStruct()
    for key, spec in algebra.flatten_spec_structure(
        base.get_in_feature_specification(mode)).items():
      condition_spec[f'features/{key}'] = spec
    cond_labels = base.get_in_label_specification(mode)
    if cond_labels is not None:
      for key, spec in algebra.flatten_spec_structure(cond_labels).items():
        condition_spec[f'labels/{key}'] = spec
    inference_spec = SpecStruct()
    for key, spec in algebra.flatten_spec_structure(
        base.get_in_feature_specification(mode)).items():
      inference_spec[f'features/{key}'] = spec

    feature_spec = SpecStruct()
    for key, spec in create_metaexample_spec(
        condition_spec, self._num_condition_samples_per_task,
        'condition').items():
      feature_spec[f'condition/{key}'] = spec
    for key, spec in create_metaexample_spec(
        inference_spec, self._num_inference_samples_per_task,
        'inference').items():
      feature_spec[f'inference/{key}'] = spec
    return feature_spec

  def get_in_label_specification(self, mode):
    label_spec = self._base_preprocessor.get_in_label_specification(mode)
    if label_spec is None:
      return None
    return create_metaexample_spec(
        label_spec, self._num_inference_samples_per_task, 'inference')

  def _preprocess_fn(self, features, labels, mode, generator):
    stacked = SpecStruct()
    for key, value in stack_intra_task_episodes(
        self._subtree(features, 'condition'),
        self._num_condition_samples_per_task).items():
      stacked[f'condition/{key}'] = value
    for key, value in stack_intra_task_episodes(
        self._subtree(features, 'inference'),
        self._num_inference_samples_per_task).items():
      stacked[f'inference/{key}'] = value
    out_labels = labels
    if labels is not None:
      out_labels = stack_intra_task_episodes(
          labels, self._num_inference_samples_per_task)
    return super()._preprocess_fn(stacked, out_labels, mode, generator)
