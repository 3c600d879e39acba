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
* :class:`NativeExampleParser`, the spec-driven batch parser;
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
from tensor2robot_tpu_torch.specs import algebra
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
  """Spec-driven tf.Example batch parser on the C++ wire decoder.

  ``named_specs``: ``(output key, on-disk name, spec)`` triples
  (``example_codec.named_specs``). ``parse_batch`` returns the same as
  ``example_codec.parse_batch``, its plain version: numeric features as
  ``[B, *spec.shape]`` arrays, image features as one encoded image each,
  a ``memoryview`` into its record (no copy).
  """

  def __init__(self, named_specs):
    self._lib = native.record_io()
    self._fields = []
    keys, kinds, lens, req, varlen = [], [], [], [], []
    for out_key, name, spec in named_specs:
      kind, flat = example_codec.feature_kind(spec)
      pad = spec.varlen_default_value
      self._fields.append((out_key, spec, kind, flat))
      keys.append(name.encode())
      kinds.append(kind)
      lens.append(flat)
      req.append(int(pad is None and not spec.is_optional))
      varlen.append(int(pad is not None))
    n = len(keys)
    self._h = self._lib.t2r_parser_create(
        (ctypes.c_char_p * n)(*keys), (ctypes.c_int * n)(*kinds),
        (ctypes.c_int64 * n)(*lens), (ctypes.c_int * n)(*req),
        (ctypes.c_int * n)(*varlen), n)

  def parse_batch(self, records: Sequence[bytes]):
    batch = len(records)
    recs = (ctypes.c_char_p * batch)(*records)
    lens = (ctypes.c_uint64 * batch)(*[len(r) for r in records])
    buffers = []
    outs = (ctypes.c_void_p * len(self._fields))()
    for i, (_, spec, kind, flat) in enumerate(self._fields):
      pad = spec.varlen_default_value
      if kind == example_codec.KIND_BYTES:
        buf = np.full((batch, flat, 2), -1, np.int64)
      elif kind == example_codec.KIND_FLOAT:
        buf = np.full((batch, flat), pad or 0.0, np.float32)
      else:
        buf = np.full((batch, flat), int(pad or 0), np.int64)
      buffers.append(buf)
      outs[i] = buf.ctypes.data_as(ctypes.c_void_p)
    if self._lib.t2r_parser_parse_batch(self._h, recs, lens, batch, outs):
      raise ValueError('example parse failed: '
                       f'{self._lib.t2r_parser_error(self._h).decode()}')
    out = {}
    for (key, spec, kind, _), buf in zip(self._fields, buffers):
      if kind == example_codec.KIND_BYTES:
        out[key] = [memoryview(records[b])[start:start + length]
                    if start >= 0 else b''
                    for b, (start, length) in enumerate(buf[:, 0].tolist())]
      else:
        out[key] = example_codec.as_spec_array(buf, spec, batch)
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
  wire parser, then image decode on ``decode_workers`` threads.

  Safe to call concurrently on different record batches (the engine's
  workers do): each calling thread gets its own parser, whose only
  cross-call state is its error text. ``parse_fn.make_image_buffers(
  batch_size)`` allocates one ring slot, a contiguous decode buffer per
  image feature, in page-locked memory with ``pin_memory`` (the trainer
  uploads such a slot without a staging copy). Sequence, multi-dataset
  and multi-image specs raise (``example_codec.feature_kind``).
  """
  named = example_codec.named_specs(feature_spec, label_spec)
  flat_f = algebra.flatten_spec_structure(feature_spec)
  flat_l = (None if label_spec is None else
            algebra.flatten_spec_structure(label_spec))
  tls = threading.local()
  tls.parser = NativeExampleParser(named)  # validates the specs once

  def parse_fn(records, image_out=None):
    parser = getattr(tls, 'parser', None)
    if parser is None:
      parser = tls.parser = NativeExampleParser(named)
    parsed = parser.parse_batch(list(records))
    feats, labels = example_codec.decode_values(
        named, parsed, image_out=image_out, decode_workers=decode_workers)
    features = algebra.pack_flat_sequence_to_spec_structure(flat_f, feats)
    if flat_l is None:
      return features, None
    return features, algebra.pack_flat_sequence_to_spec_structure(
        flat_l, labels)

  def make_image_buffers(batch_size: int):
    buffers = {}
    for out_key, _, spec in named:
      if example_codec.is_encoded_image(spec):
        shape = (batch_size,) + tuple(spec.shape)
        if pin_memory:
          buffers[out_key] = torch.empty(shape, dtype=spec.dtype,
                                         pin_memory=True).numpy()
        else:
          buffers[out_key] = np.empty(shape, to_numpy_dtype(spec.dtype))
    return buffers

  parse_fn.make_image_buffers = make_image_buffers
  return parse_fn
