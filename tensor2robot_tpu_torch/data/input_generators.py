"""Input generators: the port's counterpart of the synthetic part of
``tensor2robot_tpu/data/input_generators.py``.

A generator holds the *in* specs (what the host pipeline produces), which
it takes from a model's preprocessor through
:meth:`AbstractInputGenerator.set_specification_from_model`, and yields
packed numpy (features, labels) batches, which the trainer moves to its
device. The record readers are ROADMAP queue 1 item 4.
"""

from __future__ import annotations

import abc
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from tensor2robot_tpu_torch.specs import SpecStruct, algebra, numpy_gen

Batch = Tuple[SpecStruct, Optional[SpecStruct]]


class AbstractInputGenerator(abc.ABC):
  """Holds in specs and produces an iterator of packed numpy batches."""

  def __init__(self, batch_size: int = 32):
    self._batch_size = batch_size
    self._feature_spec: Optional[SpecStruct] = None
    self._label_spec: Optional[SpecStruct] = None

  def set_specification(self, feature_spec: SpecStruct,
                        label_spec: Optional[SpecStruct]) -> None:
    self._feature_spec = algebra.flatten_spec_structure(feature_spec)
    self._label_spec = (None if label_spec is None else
                        algebra.flatten_spec_structure(label_spec))

  def set_specification_from_model(self, model, mode: str) -> None:
    """Takes the preprocessor's *in* specs: the host data contract."""
    preprocessor = model.preprocessor
    self.set_specification(
        preprocessor.get_in_feature_specification(mode),
        preprocessor.get_in_label_specification(mode))

  def create_iterator(self, mode: str,
                      batch_size: Optional[int] = None) -> Iterator[Batch]:
    if self._feature_spec is None:
      raise ValueError(
          'Input generator has no specs; call set_specification(_from_model) '
          'first.')
    return self._create_iterator(mode, batch_size or self._batch_size)

  @abc.abstractmethod
  def _create_iterator(self, mode: str, batch_size: int) -> Iterator[Batch]:
    ...


class GeneratorInputGenerator(AbstractInputGenerator):
  """Batches of the (features, labels) examples that a python generator
  yields (unbatched, spec-shaped), restarted when it runs out; sequence
  features are padded or clipped to ``sequence_length``."""

  def __init__(self,
               generator_fn: Callable[[], Iterator],
               sequence_length: Optional[int] = None,
               batch_size: int = 32):
    super().__init__(batch_size)
    self._generator_fn = generator_fn
    self._sequence_length = sequence_length

  def _fit_sequence(self, array: np.ndarray, spec) -> np.ndarray:
    if (self._sequence_length is None or
        not getattr(spec, 'is_sequence', False)):
      return array
    length = array.shape[0]
    if length >= self._sequence_length:
      return array[:self._sequence_length]
    padding = np.zeros((self._sequence_length - length,) + array.shape[1:],
                       dtype=array.dtype)
    return np.concatenate([array, padding], axis=0)

  def _stack(self, batches, spec) -> Optional[SpecStruct]:
    if spec is None:
      return None
    out = SpecStruct()
    for key in batches[0]:
      out[key] = np.stack([self._fit_sequence(np.asarray(b[key]),
                                              spec.get(key))
                           for b in batches])
    return algebra.validate_and_pack(spec, out, ignore_batch=True)

  def _create_iterator(self, mode, batch_size):
    def iterate():
      source = self._generator_fn()
      while True:
        features, labels = [], []
        for _ in range(batch_size):
          try:
            example = next(source)
          except StopIteration:
            source = self._generator_fn()
            example = next(source)
          features.append(algebra.flatten_spec_structure(example[0]))
          labels.append(algebra.flatten_spec_structure(example[1]))
        yield (self._stack(features, self._feature_spec),
               self._stack(labels, self._label_spec))

    return iterate()


class _SyntheticInputGenerator(AbstractInputGenerator):
  """Synthetic batches: batch ``i`` draws its features with seed ``2i`` and
  its labels with seed ``2i + 1``, as the JAX package's generators do."""

  def __init__(self, sequence_length: int = 3, batch_size: int = 32):
    super().__init__(batch_size)
    self._sequence_length = sequence_length

  def _make_batch(self, spec, batch_size, seed):
    raise NotImplementedError

  def _create_iterator(self, mode, batch_size):
    def iterate():
      seed = 0
      while True:
        features = self._make_batch(self._feature_spec, batch_size, seed)
        labels = (None if self._label_spec is None else
                  self._make_batch(self._label_spec, batch_size, seed + 1))
        seed += 2
        yield features, labels

    return iterate()


class DefaultRandomInputGenerator(_SyntheticInputGenerator):
  """Random spec-conformant batches (``specs.make_random_numpy``)."""

  def _make_batch(self, spec, batch_size, seed):
    return algebra.validate_and_pack(
        spec,
        numpy_gen.make_random_numpy(spec, batch_size=batch_size,
                                    sequence_length=self._sequence_length,
                                    seed=seed),
        ignore_batch=True)


class DefaultConstantInputGenerator(_SyntheticInputGenerator):
  """Constant spec-conformant batches."""

  def __init__(self, constant_value: float, **kwargs):
    super().__init__(**kwargs)
    self._constant_value = constant_value

  def _make_batch(self, spec, batch_size, seed):
    return algebra.validate_and_pack(
        spec,
        numpy_gen.make_constant_numpy(spec, self._constant_value,
                                      batch_size=batch_size,
                                      sequence_length=self._sequence_length),
        ignore_batch=True)
