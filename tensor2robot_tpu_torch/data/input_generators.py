"""Input generators: the port's counterpart of
``tensor2robot_tpu/data/input_generators.py``.

A generator holds the *in* specs (what the host pipeline produces), which
it takes from a model's preprocessor through
:meth:`AbstractInputGenerator.set_specification_from_model`, and yields
packed numpy (features, labels) batches, which the trainer moves to its
device.

Record generators read TFRecord shards of tf.Examples with the port's C++
reader and parser (``data/native_io.py``), decode images
(``data/image_codec.py``) and batch in the parallel engine
(``data/engine.py``): :class:`NativeRecordInputGenerator`, and
:class:`DefaultRecordInputGenerator` with the JAX package's constructor
over the same stream. Their iterators expose ``release()``, which the
trainer calls once a batch's upload has ended. Not ported yet (ROADMAP
queue 1 item 4): follow mode, the fractional and multi-eval generators,
the task-grouped (meta-learning) generator and SequenceExample specs.
"""

from __future__ import annotations

import abc
import itertools
import json
import logging
import os
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.data import engine as engine_lib
from tensor2robot_tpu_torch.data import (native_io, records, seek_resume,
                                         shard_index)
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.specs import SpecStruct, algebra, numpy_gen

Batch = Tuple[SpecStruct, Optional[SpecStruct]]


class AbstractInputGenerator(abc.ABC):
  """Holds in specs and produces an iterator of packed numpy batches."""

  def __init__(self, batch_size: int = 32):
    self._batch_size = batch_size
    self._feature_spec: Optional[SpecStruct] = None
    self._label_spec: Optional[SpecStruct] = None

  @property
  def batch_size(self) -> int:
    return self._batch_size

  @property
  def feature_spec(self) -> Optional[SpecStruct]:
    return self._feature_spec

  @property
  def label_spec(self) -> Optional[SpecStruct]:
    return self._label_spec

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


# ---------------------------------------------------------------- records


class NativeRecordInputGenerator(AbstractInputGenerator):
  """TFRecord input on the port's C++ reader and parser, without TF.

  The stream: the files of ``file_patterns`` (sorted per pattern) read by
  the interleave reader (``cycle_length`` slots, one record a slot in
  turn), then in TRAIN mode a shuffle buffer of ``shuffle_buffer_size``
  drawn by ``numpy.random.RandomState(seed)``, repeated epoch after epoch;
  in other modes one unshuffled pass. Batches of ``batch_size`` records
  (a final short batch dropped) are parsed and decoded by the engine's
  ``engine_workers`` threads (None: core-aware autotune, 0: serial), each
  decoding its images on ``decode_workers`` threads. The stream is a
  function of (files, seed, batch size) alone, for any worker count: bit
  for bit the JAX package's ``NativeRecordInputGenerator``.

  ``reuse_batch_buffers``: the engine decodes images into a ring of
  preallocated slots, page-locked when a CUDA card is visible, and the
  consumer calls the iterator's ``release()`` once per batch after copying
  it; the trainer does so when the batch's upload has ended
  (``train/trainer.py``).

  :meth:`create_checkpointable_iterator` saves and restores the stream
  position with the model's checkpoints (``train/input_state.py``).
  """

  def __init__(self,
               file_patterns: str,
               batch_size: int = 32,
               shuffle_buffer_size: int = 1000,
               cycle_length: int = 16,
               queue_capacity: int = 64,
               decode_workers: int = 8,
               seed: Optional[int] = None,
               engine_workers: Optional[int] = None,
               engine_ring_depth: Optional[int] = None,
               reuse_batch_buffers: bool = False):
    super().__init__(batch_size)
    if not file_patterns:
      raise ValueError('Provide file_patterns.')
    self._file_patterns = file_patterns
    self._shuffle_buffer_size = shuffle_buffer_size
    self._cycle_length = cycle_length
    self._queue_capacity = queue_capacity
    self._decode_workers = decode_workers
    self._seed = seed
    self._engine_workers = engine_workers
    self._engine_ring_depth = engine_ring_depth
    self._reuse_batch_buffers = reuse_batch_buffers
    # The engine decision of the newest iterator (workers and ring).
    self.last_decision: Optional[engine_lib.EngineDecision] = None

  def _stream_config(self, mode: str) -> Tuple[int, bool]:
    """(cycle length, whether the stream repeats) of ``mode``."""
    return self._cycle_length, mode == ModeKeys.TRAIN

  def _resolved_filenames(self):
    data_format, filenames = records.get_data_format_and_filenames(
        self._file_patterns)
    if data_format != 'tfrecord':
      raise ValueError(f'The record reader reads tfrecord, got {data_format}')
    return filenames

  def _records(self, mode: str, resume=None) -> Iterator[bytes]:
    """Raw serialized examples: forever in a repeating mode, else one
    pass. ``resume`` (a ``seek_resume.ResumePlan``) starts mid-epoch: the
    partial epoch runs through per-slot readers seeked by the shard index
    (the interleave reader's order), full epochs through the interleave
    reader."""
    filenames = self._resolved_filenames()
    cycle_length, repeat = self._stream_config(mode)
    if resume is not None:
      if not repeat and resume.epoch > 0:
        return
      indexes = resume.indexes or {}
      for _, record in seek_resume.iter_epoch_from(
          resume.layout, resume.files, resume.within_epoch,
          lambda path, ordinal: records.open_at(path, ordinal,
                                                index=indexes.get(path))):
        yield record
      if not repeat:
        return
    while True:
      with native_io.NativeInterleaveReader(
          filenames, cycle_length=cycle_length,
          queue_capacity=self._queue_capacity) as reader:
        yield from reader
      if not repeat:
        return

  @property
  def pin_memory(self) -> bool:
    """Whether the ring's slots are page-locked: with a ring, on a host
    with a CUDA card."""
    return self._reuse_batch_buffers and torch.cuda.is_available()

  def _create_iterator(self, mode, batch_size):
    return self._build_batches(mode, batch_size)

  def _build_batches(self, mode, batch_size, skip_batches: int = 0,
                     resume=None, start_delivered: Optional[int] = None):
    """The ONE batch pipeline: interleaved read -> seeded shuffle ->
    engine. ``skip_batches`` replays the stream past the records of the
    first N batches without parsing them (the O(position) restore);
    ``resume`` is the O(1) restore: the shuffle buffer refilled by indexed
    reads, the rng advanced, the raw stream seeked mid-epoch."""
    parse_fn = native_io.make_native_parse_fn(
        self._feature_spec, self._label_spec,
        decode_workers=self._decode_workers, pin_memory=self.pin_memory)
    shuffling = mode == ModeKeys.TRAIN and self._shuffle_buffer_size > 1

    def stream():
      if not shuffling:
        yield from self._records(mode, resume=resume)
        return
      if resume is None:
        rng = np.random.RandomState(self._seed)
        buf = []
      else:
        rng, buf = resume.rng, list(resume.buffer)
      for record in self._records(mode, resume=resume):
        if len(buf) < self._shuffle_buffer_size:
          buf.append(record)
          continue
        i = rng.randint(len(buf))
        yield buf[i]
        buf[i] = record
      while buf:
        yield buf.pop(rng.randint(len(buf)))

    raw = stream()
    if skip_batches:
      raw = itertools.islice(raw, skip_batches * batch_size, None)
    decision = engine_lib.autotune(self._engine_workers,
                                   self._engine_ring_depth)
    self.last_decision = decision
    return engine_lib.ParallelBatchEngine(
        raw, parse_fn, batch_size, num_workers=decision.num_workers,
        ring_depth=decision.ring_depth,
        reuse_buffers=self._reuse_batch_buffers,
        start_delivered=skip_batches if start_delivered is None
        else start_delivered)

  def create_checkpointable_iterator(
      self, mode: str, batch_size: Optional[int] = None
  ) -> '_CheckpointableEngineIterator':
    """An engine-fed iterator whose stream position saves and restores:
    by a seek when every shard's index sidecar is valid (built here on
    first use), else by a replay of the stream, the same bytes either way.
    Needs a ``seed`` when shuffling."""
    if self._feature_spec is None:
      raise ValueError(
          'Input generator has no specs; call set_specification(_from_model) '
          'first.')
    if (mode == ModeKeys.TRAIN and self._shuffle_buffer_size > 1 and
        self._seed is None):
      raise ValueError(
          'create_checkpointable_iterator needs a seed when shuffling: an '
          'unseeded shuffle cannot be replayed bit for bit on resume.')
    return _CheckpointableEngineIterator(self, mode,
                                         batch_size or self._batch_size)

  def _indexes(self) -> Dict[str, shard_index.ShardIndex]:
    """A valid index for every shard that can be indexed (loaded, or
    built and written best-effort)."""
    indexes = {}
    for path in self._resolved_filenames():
      try:
        indexes[path] = shard_index.ensure_index(path)
      except (OSError, shard_index.IndexError_) as e:
        logging.warning('Cannot index shard %r (%s); a deep-position resume '
                        'will replay.', path, e)
    return indexes


class _SeekUnavailable(Exception):
  """Why a seek restore degraded to the replay."""


class _CheckpointableEngineIterator:
  """Stream-position tracking over the engine pipeline.

  ``save(path_prefix, pending=0)`` writes the position as JSON: the
  delivered batch count less ``pending``, the batches delivered but not
  trained (the trainer's staged batch), so a resume continues at the
  first untrained batch. ``restore`` rebuilds the engine at a saved
  position. ``release()`` passes the ring-slot release to the engine.
  """

  def __init__(self, generator: NativeRecordInputGenerator, mode: str,
               batch_size: int):
    self._generator = generator
    self._mode = mode
    self._batch_size = batch_size
    self._delivered = 0
    self._indexes = generator._indexes()  # pylint: disable=protected-access
    self._engine = generator._build_batches(mode, batch_size)  # pylint: disable=protected-access

  @property
  def delivered(self) -> int:
    return self._delivered

  def __iter__(self):
    return self

  def __next__(self):
    batch = next(self._engine)
    self._delivered += 1
    return batch

  def release(self) -> None:
    self._engine.release()

  def _stream_fingerprint(self) -> dict:
    gen = self._generator
    filenames = gen._resolved_filenames()  # pylint: disable=protected-access
    counts, seekable, reason = [], True, None
    for path in filenames:
      index = self._indexes.get(path)
      if index is None:
        seekable, reason = False, f'no index for {path}'
        break
      try:
        shard_index.validate_index(index, path)
      except shard_index.StaleIndexError as e:
        seekable, reason = False, str(e)
        break
      counts.append(index.record_count)
    return {'version': 2, 'seekable': seekable, 'reason': reason,
            'files': filenames, 'record_counts': counts if seekable else None,
            **self._config()}

  def _config(self) -> dict:
    gen = self._generator
    cycle_length, _ = gen._stream_config(self._mode)  # pylint: disable=protected-access
    return {'seed': gen._seed,  # pylint: disable=protected-access
            'shuffle_buffer_size': gen._shuffle_buffer_size,  # pylint: disable=protected-access
            'cycle_length': cycle_length}

  def save(self, path_prefix: str, pending: int = 0) -> str:
    path = path_prefix + '.json'
    if os.path.dirname(path):
      os.makedirs(os.path.dirname(path), exist_ok=True)
    position = self._delivered - int(pending)
    if position < 0:
      raise ValueError(f'{pending} pending batches of {self._delivered} '
                       'delivered')
    state = {'batches_delivered': position, 'batch_size': self._batch_size,
             'mode': self._mode, 'stream': self._stream_fingerprint()}
    with open(path, 'w') as f:
      json.dump(state, f)
    return path

  def _seek_plan(self, state):
    gen = self._generator
    stream = state.get('stream') or {}
    if not stream.get('seekable'):
      raise _SeekUnavailable(stream.get('reason') or
                             'the state has no seekable stream block')
    filenames = gen._resolved_filenames()  # pylint: disable=protected-access
    config = {'files': filenames, **self._config()}
    for key, value in config.items():
      if stream.get(key) != value:
        raise _SeekUnavailable(f'stream config changed since save: {key} was '
                               f'{stream.get(key)!r}, now {value!r}')
    indexes = {}
    for path, saved_count in zip(filenames, stream['record_counts']):
      try:
        index = shard_index.load_index(path)
      except FileNotFoundError as e:
        raise _SeekUnavailable(f'missing shard index: {path}') from e
      except (OSError, shard_index.IndexError_) as e:
        raise _SeekUnavailable(f'unusable shard index: {e}') from e
      if index.record_count != saved_count:
        raise _SeekUnavailable(f'{path}: {index.record_count} records now vs '
                               f'{saved_count} at save time')
      indexes[path] = index
    plan = seek_resume.plan_resume(
        files=filenames, counts=stream['record_counts'],
        cycle_length=config['cycle_length'], seed=config['seed'],
        shuffle_buffer_size=config['shuffle_buffer_size'],
        records_emitted=int(state['batches_delivered']) * self._batch_size,
        shuffled=(self._mode == ModeKeys.TRAIN and
                  config['shuffle_buffer_size'] > 1),
        fetch=lambda path, ords: records.read_records_at(
            path, ords, index=indexes[path]))
    plan.indexes = indexes
    return plan

  def restore(self, path_prefix: str, allow_seek: bool = True) -> str:
    """Rebuilds the pipeline at the saved position; returns 'seek' or
    'replay', the way it got there (``allow_seek=False`` forces the
    replay)."""
    with open(path_prefix + '.json') as f:
      state = json.load(f)
    if state.get('batch_size') != self._batch_size:
      raise ValueError(
          f'Input state was saved with batch_size={state.get("batch_size")}, '
          f'but this iterator uses {self._batch_size}; the stream positions '
          'are incompatible.')
    plan = None
    if allow_seek:
      try:
        plan = self._seek_plan(state)
      except _SeekUnavailable as e:
        logging.warning('Seek resume unavailable (%s); replaying %d batches.',
                        e, int(state['batches_delivered']))
    delivered = int(state['batches_delivered'])
    self._engine.close()
    self._delivered = delivered
    gen = self._generator
    if plan is not None:
      self._engine = gen._build_batches(  # pylint: disable=protected-access
          self._mode, self._batch_size, resume=plan,
          start_delivered=delivered)
      return 'seek'
    self._engine = gen._build_batches(  # pylint: disable=protected-access
        self._mode, self._batch_size, skip_batches=delivered)
    return 'replay'

  def close(self) -> None:
    self._engine.close()


class DefaultRecordInputGenerator(NativeRecordInputGenerator):
  """The JAX package's ``DefaultRecordInputGenerator`` constructor over the
  port's native record stream.

  ``parallel_shards`` is the interleave's cycle length in TRAIN mode.
  Other modes read the files one after another, unshuffled, and repeat,
  as the JAX generator's tf.data pipeline does (``list_files`` unshuffled,
  cycle length 1, ``repeat()``), so eval batches are the JAX generator's.
  The TRAIN stream is NOT tf.data's: its files interleave round-robin and
  its shuffle is a ``numpy.random.RandomState(seed)`` buffer, so it is a
  function of (files, seed, batch size) and its position saves and
  restores. ``dataset_map`` (multi-dataset specs, ROADMAP queue 1 item 4)
  and ``error_budget`` (item 10) are not ported yet and raise.
  """

  def __init__(self,
               file_patterns: Optional[str] = None,
               dataset_map: Optional[Dict[str, str]] = None,
               batch_size: int = 32,
               shuffle_buffer_size: int = 1000,
               parallel_shards: int = 10,
               seed: Optional[int] = None,
               error_budget: Optional[int] = None,
               **kwargs):
    if not file_patterns and not dataset_map:
      raise ValueError('Provide file_patterns or dataset_map.')
    if file_patterns and dataset_map:
      raise ValueError('file_patterns and dataset_map are mutually '
                       'exclusive.')
    if dataset_map:
      raise NotImplementedError('dataset_map: multi-dataset record input is '
                                'not ported yet: ROADMAP.md queue 1 item 4.')
    if error_budget is not None:
      raise NotImplementedError('error_budget: data error budgets are not '
                                'ported yet: ROADMAP.md queue 1 item 10.')
    super().__init__(file_patterns, batch_size=batch_size,
                     shuffle_buffer_size=shuffle_buffer_size,
                     cycle_length=parallel_shards, seed=seed, **kwargs)

  def _stream_config(self, mode: str) -> Tuple[int, bool]:
    if mode == ModeKeys.TRAIN:
      return self._cycle_length, True
    return 1, True
