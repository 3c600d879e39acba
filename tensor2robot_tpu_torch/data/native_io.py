"""TFRecord IO and tf.Example parsing on the port's C++ library.

The port's counterpart of ``tensor2robot_tpu/data/native_io.py``, without
its metrics, tracing and error budgets (ROADMAP queue 1 item 10). The
record format is TFRecord's (``data/records.py``), so files interchange
with ``tf.io`` and with the JAX package. The library builds at first use
(``native/__init__.py``) and a failed build raises: there is no other
reader behind it. Its plain versions: ``records.iter_records_plain``
(framing and CRCs) and ``example_codec.parse_batch`` (the wire parser).

* :class:`NativeRecordWriter`, :class:`NativeRecordReader` (with ``seek``
  to a record boundary from a shard index), :class:`NativeInterleaveReader`
  (``cycle_length`` slots, slot ``s`` reading files ``s, s+C, ...``,
  round-robin one record a slot: the stream order that
  ``data/seek_resume.py`` inverts);
* :class:`NativeExampleParser`, the spec-driven batch parser
  (tf.Example and tf.SequenceExample);
* :func:`make_native_parse_fn`, ``parse_fn(records) -> (features,
  labels)`` with image decode (``data/image_codec.py``) and the ring-slot
  protocol of ``data/engine.py``: ``parse_fn.make_image_buffers(batch)``
  and ``parse_fn(records, image_out=buffers)``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from tensor2robot_tpu_torch import native
from tensor2robot_tpu_torch.data import example_codec
from tensor2robot_tpu_torch.specs.tensor_spec import to_numpy_dtype


def masked_crc32c(data: bytes) -> int:
  return native.record_io().t2r_masked_crc32c(data, len(data))


class NativeRecordWriter:
  """Appends TFRecord-framed records to a file."""

  def __init__(self, path: str, append: bool = False):
    self._lib = native.record_io()
    self._h = self._lib.t2r_writer_open(path.encode(),
                                        b'a' if append else b'w')
    if not self._h:
      raise IOError(f'cannot open {path!r} for writing')

  def write(self, serialized: bytes) -> None:
    if self._lib.t2r_writer_write(self._h, serialized, len(serialized)):
      raise IOError('short write')

  def flush(self) -> None:
    self._lib.t2r_writer_flush(self._h)

  def close(self) -> None:
    if self._h:
      if self._lib.t2r_writer_close(self._h):
        self._h = None
        raise IOError('close failed')
      self._h = None

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


class NativeRecordReader:
  """Sequential reader with CRC verification; a corrupt or truncated
  record raises ``IOError`` (the records before it were yielded)."""

  def __init__(self, path: str, verify_crc: bool = True,
               start_offset: int = 0):
    self._lib = native.record_io()
    self._path = path
    self._h = self._lib.t2r_reader_open(path.encode(), int(verify_crc))
    if not self._h:
      raise IOError(f'cannot open {path!r}')
    if start_offset:
      self.seek(start_offset)

  def seek(self, offset: int) -> None:
    """Moves to an absolute byte offset, a record boundary from a shard
    index; a mid-record offset fails on the next read, never silently."""
    if self._lib.t2r_reader_seek(self._h, int(offset)):
      raise IOError(f'seek to offset {offset} failed in {self._path!r}: '
                    f'{self._lib.t2r_reader_error(self._h).decode()}')

  def read_next(self) -> Optional[bytes]:
    """One record, or None at the end of the file."""
    buf = ctypes.POINTER(ctypes.c_uint8)()
    n = self._lib.t2r_reader_next(self._h, ctypes.byref(buf))
    if n == -1:
      return None
    if n == -2:
      raise IOError(f'record read failed in {self._path!r}: '
                    f'{self._lib.t2r_reader_error(self._h).decode()}')
    return ctypes.string_at(buf, n)

  def __iter__(self) -> Iterator[bytes]:
    while True:
      record = self.read_next()
      if record is None:
        return
      yield record

  def close(self) -> None:
    if self._h:
      self._lib.t2r_reader_close(self._h)
      self._h = None

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


class NativeInterleaveReader:
  """Round-robin (block_length=1) reader over many files: ``cycle_length``
  prefetch threads in C++ (slot ``s`` owns files ``s, s+C, s+2C, ...``)
  keep bounded queues full, so the consumer never waits on the disk."""

  def __init__(self, paths: Sequence[str], cycle_length: int = 16,
               queue_capacity: int = 64, verify_crc: bool = True):
    if not paths:
      raise ValueError('need at least one path')
    self._lib = native.record_io()
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    self._h = self._lib.t2r_interleave_open(
        arr, len(paths), cycle_length, queue_capacity, int(verify_crc))
    if not self._h:
      raise IOError('cannot open interleave reader')

  def __iter__(self) -> Iterator[bytes]:
    buf = ctypes.POINTER(ctypes.c_uint8)()
    while True:
      n = self._lib.t2r_interleave_next(self._h, ctypes.byref(buf))
      if n == -1:
        return
      if n == -2:
        raise IOError('interleave read failed: '
                      f'{self._lib.t2r_interleave_error(self._h).decode()}')
      yield ctypes.string_at(buf, n)

  def close(self) -> None:
    if self._h:
      self._lib.t2r_interleave_close(self._h)
      self._h = None

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


def read_records(path: str) -> List[bytes]:
  """Every record of one file."""
  with NativeRecordReader(path) as reader:
    return list(reader)


def iter_records_from(path: str, offset: int = 0,
                      verify_crc: bool = True) -> Iterator[bytes]:
  """Sequential records from a byte offset (a record boundary from a
  shard index); the reader closes when the generator finishes."""
  reader = NativeRecordReader(path, verify_crc=verify_crc,
                              start_offset=offset)
  try:
    yield from reader
  finally:
    reader.close()


# ------------------------------------------------------- example parsing


class NativeExampleParser:
  """Spec-driven tf.Example / tf.SequenceExample batch parser on the C++
  wire decoder.

  ``named_specs``: ``(output key, on-disk name, spec)`` triples
  (``example_codec.named_specs``). ``parse_batch`` returns the same as
  ``example_codec.parse_batch``, its plain version: numeric features as
  ``[B, *spec.shape]`` arrays, image features as ``B * count`` encoded
  images, each a ``memoryview`` into its record (no copy), and a sequence
  feature's steps padded to the batch's longest list with its
  ``<output key>_length``. With sequence specs a first C++ pass counts
  every record's steps, so the buffers are sized before the parse.
  """

  def __init__(self, named_specs):
    self._lib = native.record_io()
    self._fields = []
    keys, kinds, lens, req, varlen, sequence = [], [], [], [], [], []
    for out_key, name, spec in named_specs:
      kind, count = example_codec.feature_kind(spec)
      pad = spec.varlen_default_value
      self._fields.append((out_key, spec, kind, count))
      keys.append(name.encode())
      kinds.append(kind)
      lens.append(count)
      req.append(int(pad is None and not spec.is_optional))
      varlen.append(int(pad is not None))
      sequence.append(int(spec.is_sequence))
    self._sequence = [f for f in self._fields if f[1].is_sequence]
    n = len(keys)
    self._h = self._lib.t2r_parser_create(
        (ctypes.c_char_p * n)(*keys), (ctypes.c_int * n)(*kinds),
        (ctypes.c_int64 * n)(*lens), (ctypes.c_int * n)(*req),
        (ctypes.c_int * n)(*varlen), (ctypes.c_int * n)(*sequence), n)

  def _error(self) -> str:
    return self._lib.t2r_parser_error(self._h).decode()

  def parse_batch(self, records: Sequence[bytes]):
    batch = len(records)
    recs = (ctypes.c_char_p * batch)(*records)
    lens = (ctypes.c_uint64 * batch)(*[len(r) for r in records])
    lengths = np.zeros((batch, len(self._sequence)), np.int64)
    if self._sequence:
      if self._lib.t2r_parser_sequence_lengths(
          self._h, recs, lens, batch,
          lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))):
        raise ValueError(f'example parse failed: {self._error()}')
      steps = (lengths.max(axis=0) if batch else
               np.zeros(len(self._sequence), np.int64))
      self._lib.t2r_parser_set_steps(
          self._h, steps.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
      longest = dict(zip((f[0] for f in self._sequence), steps.tolist()))
    buffers = []
    outs = (ctypes.c_void_p * len(self._fields))()
    for i, (key, spec, kind, count) in enumerate(self._fields):
      pad = spec.varlen_default_value
      rows = batch * longest[key] if spec.is_sequence else batch
      if kind == example_codec.KIND_BYTES:
        buf = np.full((rows, count, 2), -1, np.int64)
      elif kind == example_codec.KIND_FLOAT:
        buf = np.full((rows, count), pad or 0.0, np.float32)
      else:
        buf = np.full((rows, count), int(pad or 0), np.int64)
      buffers.append(buf)
      outs[i] = buf.ctypes.data_as(ctypes.c_void_p)
    if self._lib.t2r_parser_parse_batch(self._h, recs, lens, batch, outs):
      raise ValueError(f'example parse failed: {self._error()}')
    out = {}
    for (key, spec, kind, count), buf in zip(self._fields, buffers):
      if kind == example_codec.KIND_BYTES:
        per = buf.shape[0] * count // batch if batch else 0
        out[key] = [memoryview(records[j // per])[start:start + length]
                    if start >= 0 else b''
                    for j, (start, length) in enumerate(
                        buf.reshape(-1, 2).tolist())]
      elif spec.is_sequence:
        out[key] = example_codec.as_spec_array(buf, spec, batch,
                                               (longest[key],))
      else:
        out[key] = example_codec.as_spec_array(buf, spec, batch)
    for j, (key, _, _, _) in enumerate(self._sequence):
      out[key + '_length'] = lengths[:, j].copy()
    return out

  def close(self) -> None:
    if self._h:
      self._lib.t2r_parser_destroy(self._h)
      self._h = None

  def __del__(self):
    try:
      self.close()
    except Exception:  # pylint: disable=broad-except  # interpreter shutdown
      pass


def make_native_parse_fn(feature_spec, label_spec=None,
                         decode_workers: int = 8,
                         pin_memory: bool = False) -> Callable:
  """``parse_fn(records, image_out=None) -> (features, labels)``: the C++
  wire parser, then image decode on ``decode_workers`` threads
  (``example_codec.make_parse_fn``: records of one stream, or of zipped
  dataset streams).

  Safe to call concurrently on different record batches (the engine's
  workers do): each calling thread gets its own parsers, whose only
  cross-call state is their error text and step counts.
  ``parse_fn.make_image_buffers(batch_size)`` allocates one ring slot, a
  contiguous decode buffer per image feature of a fixed shape ([B, H, W,
  C], or [B, T, H, W, C] for an episode's frames; a sequence's images are
  sized by each batch and decode into buffers of their own), in
  page-locked memory with ``pin_memory`` (the trainer uploads such a slot
  without a staging copy).
  """
  tls = threading.local()

  def parser(dataset_key, named):
    parsers = getattr(tls, 'parsers', None)
    if parsers is None:
      parsers = tls.parsers = {}
    if dataset_key not in parsers:
      parsers[dataset_key] = NativeExampleParser(named)
    return parsers[dataset_key].parse_batch

  parse_fn = example_codec.make_parse_fn(
      feature_spec, label_spec, parser_factory=parser,
      decode_workers=decode_workers)
  for key, named in parse_fn.plans.items():
    parser(key, named)  # validates the specs once

  def make_image_buffers(batch_size: int):
    buffers = {}
    for named in parse_fn.plans.values():
      for out_key, _, spec in named:
        if not example_codec.is_encoded_image(spec) or spec.is_sequence:
          continue
        shape = (batch_size,) + tuple(spec.shape)
        if pin_memory:
          buffers[out_key] = torch.empty(shape, dtype=spec.dtype,
                                         pin_memory=True).numpy()
        else:
          buffers[out_key] = np.empty(shape, to_numpy_dtype(spec.dtype))
    return buffers

  parse_fn.make_image_buffers = make_image_buffers
  return parse_fn
