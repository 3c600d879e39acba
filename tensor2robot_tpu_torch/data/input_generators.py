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
over the same stream (one file set, or a ``dataset_map`` of streams
zipped per example), :class:`FractionalRecordInputGenerator` and
:class:`MultiEvalRecordInputGenerator`. Their iterators expose
``release()``, which the trainer calls once a batch's upload has ended.
:class:`TaskGroupedRecordInputGenerator` groups per-task files into the
meta-learning layout. Not ported yet (ROADMAP queue 1 item 4): follow
mode.
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

  def _streams(self) -> Dict[str, str]:
    """``{dataset_key: file patterns}``: '' for the single stream."""
    if isinstance(self._file_patterns, dict):
      return dict(self._file_patterns)
    return {'': self._file_patterns}

  def _resolved_filenames(self, patterns: Optional[str] = None):
    """The files of ``patterns``; of every stream by default."""
    filenames = []
    for pattern in ([patterns] if patterns is not None else
                    [p for _, p in sorted(self._streams().items())]):
      data_format, files = records.get_data_format_and_filenames(pattern)
      if data_format != 'tfrecord':
        raise ValueError(
            f'The record reader reads tfrecord, got {data_format}')
      filenames.extend(files)
    return filenames

  def _records(self, mode: str, resume=None,
               patterns: Optional[str] = None) -> Iterator[bytes]:
    """Raw serialized examples of one stream (``patterns``, the single
    stream's by default): forever in a repeating mode, else one pass.
    ``resume`` (a ``seek_resume.ResumePlan``) starts mid-epoch: the
    partial epoch runs through per-slot readers seeked by the shard index
    (the interleave reader's order), full epochs through the interleave
    reader."""
    filenames = self._resolved_filenames(
        self._file_patterns if patterns is None else patterns)
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

    def stream(patterns=None):
      if not shuffling:
        yield from self._records(mode, resume=resume, patterns=patterns)
        return
      if resume is None:
        rng = np.random.RandomState(self._seed)
        buf = []
      else:
        rng, buf = resume.rng, list(resume.buffer)
      for record in self._records(mode, resume=resume, patterns=patterns):
        if len(buf) < self._shuffle_buffer_size:
          buf.append(record)
          continue
        i = rng.randint(len(buf))
        yield buf[i]
        buf[i] = record
      while buf:
        yield buf.pop(rng.randint(len(buf)))

    streams = self._streams()
    if list(streams) == ['']:
      raw = stream()
    else:
      # Each dataset's stream read and shuffled on its own, then zipped
      # example by example: batches of the zip are the zip of the
      # streams' batches, as the JAX pipeline zips them.
      keys = sorted(streams)
      raw = (dict(zip(keys, examples)) for examples in
             zip(*(stream(streams[key]) for key in keys)))
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
    if list(gen._streams()) != ['']:  # pylint: disable=protected-access
      seekable, reason = False, 'zipped dataset streams resume by replay'
    for path in filenames if seekable else ():
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
  ``dataset_map`` ({dataset_key: file patterns}) reads each dataset's
  files as one such stream and zips the streams example by example; a
  spec whose ``dataset_key`` names a dataset is parsed from that stream
  under its own name, as ``pipeline.make_dataset`` zips and parses them.
  The TRAIN stream is NOT tf.data's: its files interleave round-robin and
  its shuffle is a ``numpy.random.RandomState(seed)`` buffer (one a
  dataset), so it is a function of (files, seed, batch size) and its
  position saves and restores (by a replay for zipped streams).
  ``error_budget`` (ROADMAP queue 1 item 10) is not ported yet and
  raises.
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
    if error_budget is not None:
      raise NotImplementedError('error_budget: data error budgets are not '
                                'ported yet: ROADMAP.md queue 1 item 10.')
    super().__init__(dict(dataset_map) if dataset_map else file_patterns,
                     batch_size=batch_size,
                     shuffle_buffer_size=shuffle_buffer_size,
                     cycle_length=parallel_shards, seed=seed, **kwargs)

  def _stream_config(self, mode: str) -> Tuple[int, bool]:
    if mode == ModeKeys.TRAIN:
      return self._cycle_length, True
    return 1, True


class FractionalRecordInputGenerator(DefaultRecordInputGenerator):
  """Data-ablation input: only the first ``file_fraction`` of the files
  (at least one), as the JAX package's generator keeps them. A
  ``dataset_map`` is read whole."""

  def __init__(self, file_fraction: float = 1.0, **kwargs):
    super().__init__(**kwargs)
    if not 0.0 < file_fraction <= 1.0:
      raise ValueError(f'file_fraction must be in (0, 1], got {file_fraction}')
    if isinstance(self._file_patterns, str):
      data_format, filenames = records.get_data_format_and_filenames(
          self._file_patterns)
      n = max(1, int(file_fraction * len(filenames)))
      self._file_patterns = ','.join(
          f'{data_format}:{f}' for f in filenames[:n])


MULTI_EVAL_ENV = 'T2R_MULTI_EVAL_NAME'


class MultiEvalRecordInputGenerator(DefaultRecordInputGenerator):
  """The eval dataset of ``eval_dataset_map`` named by
  ``multi_eval_name``, else by the ``T2R_MULTI_EVAL_NAME`` environment
  variable, else by ``multi_eval_name`` in the ``TF_CONFIG`` JSON (the
  reference's drop-in route)."""

  def __init__(self, eval_dataset_map: Dict[str, str],
               multi_eval_name: Optional[str] = None, **kwargs):
    multi_eval_name = multi_eval_name or os.environ.get(MULTI_EVAL_ENV)
    if not multi_eval_name:
      tf_config = json.loads(os.environ.get('TF_CONFIG', '{}'))
      multi_eval_name = tf_config.get('multi_eval_name')
    if not multi_eval_name:
      raise ValueError('MultiEvalRecordInputGenerator needs multi_eval_name.')
    if multi_eval_name not in eval_dataset_map:
      raise ValueError(
          f'Unknown eval dataset {multi_eval_name!r}; available: '
          f'{sorted(eval_dataset_map)}')
    super().__init__(file_patterns=eval_dataset_map[multi_eval_name],
                     **kwargs)
    self.multi_eval_name = multi_eval_name


def interleave(inputs: Iterator, open_element: Callable[[object], Iterator],
               cycle_length: int, block_length: int = 1) -> Iterator:
  """tf.data's sequential ``interleave``: ``cycle_length`` slots, each
  filled with ``open_element(input)`` when the turn reaches it empty,
  ``block_length`` items a turn; an element that ends frees its slot and
  passes the turn on. Raises when a full cycle of new elements yields
  nothing (tf.data would loop forever on a repeated input)."""
  slots: list = [None] * cycle_length
  index = block = opened = 0
  ended = False
  barren = 0  # elements opened in a row that ended without an item
  fresh = [False] * cycle_length
  while not ended or opened:
    if slots[index] is not None:
      try:
        item = next(slots[index])
      except StopIteration:
        if fresh[index]:
          barren += 1
          if barren > cycle_length:
            raise ValueError('interleave: every element is empty')
        slots[index], fresh[index] = None, False
        opened -= 1
        block, index = 0, (index + 1) % cycle_length
        continue
      barren, fresh[index] = 0, False
      block += 1
      if block == block_length:
        block, index = 0, (index + 1) % cycle_length
      yield item
    elif not ended:
      try:
        slots[index] = iter(open_element(next(inputs)))
        fresh[index] = True
        opened += 1
      except StopIteration:
        ended = True
    else:
      block, index = 0, (index + 1) % cycle_length


class TaskGroupedRecordInputGenerator(AbstractInputGenerator):
  """Per-task record files in the meta-learning batch layout.

  Each file holds one task's examples under the base model's specs (the
  wrapped preprocessor's, unwrapped through ``base_preprocessor``). A meta
  batch holds ``batch_size`` tasks, each a group of
  ``num_train_samples_per_task`` condition and ``num_val_samples_per_task``
  inference examples of one file:

  * ``condition/features/*``, ``condition/labels/*``: [tasks, num_train, ...]
  * ``inference/features/*``: [tasks, num_val, ...]
  * labels: the inference examples' labels, [tasks, num_val, ...]

  The group stream is the JAX package's ``pipeline.make_task_grouped_dataset``
  (tasks interleaved with block length 1, ``interleave_cycle_length`` or
  one slot a task). Outside TRAIN it is the same stream: the files in
  order, repeated, each drained in groups of consecutive examples (a
  short tail dropped). In TRAIN each epoch visits the files in a seeded
  permutation and a visit takes one group from a shuffle buffer of
  ``max(shuffle_buffer_size, group size)`` over the repeated file, drawn
  by ``numpy.random.RandomState(seed + visit)``: not tf.data's draws.
  Records parse on the port's C++ parser, a meta batch at a time.
  """

  def __init__(self,
               file_patterns: str,
               num_train_samples_per_task: int = 4,
               num_val_samples_per_task: int = 4,
               shuffle_buffer_size: int = 50,
               interleave_cycle_length: Optional[int] = None,
               batch_size: int = 4,
               seed: Optional[int] = None,
               decode_workers: int = 8):
    super().__init__(batch_size)
    self._file_patterns = file_patterns
    self._num_train = num_train_samples_per_task
    self._num_val = num_val_samples_per_task
    self._shuffle_buffer_size = shuffle_buffer_size
    self._interleave_cycle_length = interleave_cycle_length
    self._seed = seed
    self._decode_workers = decode_workers
    self._base_feature_spec: Optional[SpecStruct] = None
    self._base_label_spec: Optional[SpecStruct] = None

  def set_specification_from_model(self, model, mode: str) -> None:
    """Takes the BASE specs (the on-disk record contract) from the wrapped
    preprocessor; this generator assembles the meta layout."""
    super().set_specification_from_model(model, mode)
    preprocessor = model.preprocessor
    while hasattr(preprocessor, 'base_preprocessor'):
      preprocessor = preprocessor.base_preprocessor
    self._base_feature_spec = algebra.flatten_spec_structure(
        preprocessor.get_in_feature_specification(mode))
    label_spec = preprocessor.get_in_label_specification(mode)
    self._base_label_spec = (None if label_spec is None else
                             algebra.flatten_spec_structure(label_spec))

  def _groups(self, mode: str, filenames) -> Iterator[list]:
    """Groups of ``num_train + num_val`` raw records, one task each."""
    samples = self._num_train + self._num_val
    training = mode == ModeKeys.TRAIN
    rng = np.random.RandomState(self._seed)

    def files():
      while True:
        yield from (rng.permutation(filenames).tolist() if training
                    else filenames)

    visits = itertools.count()

    def per_task(path):
      if not training:
        return _chunks(native_io.read_records(path), samples)
      visit = next(visits)
      draw = np.random.RandomState(
          None if self._seed is None else self._seed + visit)
      return [_shuffled_take(path, max(self._shuffle_buffer_size, samples),
                             samples, draw)]

    return interleave(files(), per_task,
                      self._interleave_cycle_length or len(filenames))

  def _create_iterator(self, mode, batch_size):
    if self._base_feature_spec is None:
      raise ValueError(
          'TaskGroupedRecordInputGenerator needs base specs; call '
          'set_specification_from_model first.')
    data_format, filenames = records.get_data_format_and_filenames(
        self._file_patterns)
    if data_format != 'tfrecord':
      raise ValueError(f'The record reader reads tfrecord, got {data_format}')
    parse_fn = native_io.make_native_parse_fn(
        self._base_feature_spec, self._base_label_spec,
        decode_workers=self._decode_workers)
    num_train = self._num_train
    samples = num_train + self._num_val

    def iterate():
      groups = self._groups(mode, filenames)
      while True:
        batch = list(itertools.islice(groups, batch_size))
        if len(batch) < batch_size:
          return
        features, labels = parse_fn([r for group in batch for r in group])

        def tasks(value):
          return value.reshape((batch_size, samples) + tuple(value.shape[1:]))

        meta = SpecStruct()
        for key, value in features.items():
          value = tasks(value)
          meta[f'condition/features/{key}'] = value[:, :num_train]
          meta[f'inference/features/{key}'] = value[:, num_train:]
        meta_labels = None
        if labels is not None:
          meta_labels = SpecStruct()
          for key, value in labels.items():
            value = tasks(value)
            meta[f'condition/labels/{key}'] = value[:, :num_train]
            meta_labels[key] = value[:, num_train:]
        yield meta, meta_labels

    return iterate()


def _chunks(items: list, size: int) -> Iterator[list]:
  """Consecutive groups of ``size`` items, a short tail dropped."""
  for start in range(0, len(items) - size + 1, size):
    yield items[start:start + size]


def _shuffled_take(path: str, buffer_size: int, count: int,
                   rng: np.random.RandomState) -> list:
  """``count`` records drawn by a shuffle buffer of ``buffer_size`` over
  the records of ``path`` repeated."""
  records_ = native_io.read_records(path)
  if not records_:
    raise ValueError(f'{path} holds no records')
  source = itertools.cycle(records_)
  buf = list(itertools.islice(source, buffer_size))
  out = []
  for _ in range(count):
    i = rng.randint(len(buf))
    out.append(buf[i])
    buf[i] = next(source)
  return out
