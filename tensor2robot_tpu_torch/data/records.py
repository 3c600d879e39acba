"""Record files: formats, file patterns, writers and readers, without TF.

The port's counterpart of ``tensor2robot_tpu/data/records.py``. TFRecord
is the one format; its framing (``native/record_io.cpp``) is

    uint64 length | uint32 masked_crc32c(length) | payload |
    uint32 masked_crc32c(payload)

Writers and readers run on the C++ library (``data/native_io.py``);
:func:`iter_records_plain` is its plain version, the same framing and both
CRC checks in Python over ``open()``. Shards written here are read by
``tf.data.TFRecordDataset`` and by the JAX package, and the other way
round.
"""

from __future__ import annotations

import glob as glob_lib
import os
import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

from tensor2robot_tpu_torch.data import native_io, shard_index

DATA_FORMATS = ('tfrecord',)


def infer_data_format(file_patterns: str) -> str:
  """The data format of a 'format:pattern' or bare pattern string."""
  if ':' in file_patterns:
    prefix = file_patterns.split(':', 1)[0]
    if prefix in DATA_FORMATS:
      return prefix
  for data_format in DATA_FORMATS:
    if data_format in os.path.basename(file_patterns):
      return data_format
  raise ValueError(
      f'Cannot infer data format from {file_patterns!r}; known formats: '
      f'{sorted(DATA_FORMATS)}. Prefix the pattern with "<format>:".')


def get_data_format_and_filenames(
    file_patterns: Union[str, Sequence[str]]) -> Tuple[str, List[str]]:
  """Resolves comma-separated glob patterns to (format, filenames), each
  pattern's matches sorted, as the JAX package does."""
  if isinstance(file_patterns, str):
    patterns = [p for p in file_patterns.split(',') if p]
  else:
    patterns = list(file_patterns)
  data_format = None
  filenames: List[str] = []
  for pattern in patterns:
    if ':' in pattern and pattern.split(':', 1)[0] in DATA_FORMATS:
      fmt, pattern = pattern.split(':', 1)
    else:
      fmt = infer_data_format(pattern)
    if data_format is None:
      data_format = fmt
    elif data_format != fmt:
      raise ValueError(
          f'Mixed data formats in patterns: {data_format} vs {fmt}')
    matches = sorted(glob_lib.glob(pattern))
    filenames.extend(matches if matches else [pattern])
  if data_format is None:
    raise ValueError(f'No file patterns provided: {file_patterns!r}')
  return data_format, filenames


def iter_records_plain(path: str, offset: int = 0) -> Iterator[bytes]:
  """The C++ reader's plain version: TFRecord framing with both masked
  CRC32C checks, in Python. Raises ``IOError`` on a truncated or corrupt
  record (records before it were yielded)."""
  with open(path, 'rb') as f:
    f.seek(offset)
    pos = offset
    while True:
      header = f.read(12)
      if not header:
        return
      if len(header) != 12:
        raise IOError(f'{path}: truncated record header at offset {pos}')
      length, length_crc = struct.unpack('<QI', header)
      if shard_index.masked_crc32c(header[:8]) != length_crc:
        raise IOError(f'{path}: corrupted record length (crc mismatch) at '
                      f'offset {pos}')
      if length > (1 << 30):
        raise IOError(f'{path}: implausible record length at offset {pos}')
      payload = f.read(length)
      footer = f.read(4)
      if len(payload) != length:
        raise IOError(f'{path}: truncated record payload at offset {pos}')
      if len(footer) != 4:
        raise IOError(f'{path}: truncated record footer at offset {pos}')
      if shard_index.masked_crc32c(payload) != struct.unpack('<I', footer)[0]:
        raise IOError(f'{path}: corrupted record payload (crc mismatch) at '
                      f'offset {pos}')
      pos += 16 + length
      yield payload


def verify_tfrecord_file(path: str) -> bool:
  """Whether every record of a TFRecord file reads back intact (framing
  and CRCs, on the C++ reader). A missing file counts as corrupt."""
  try:
    with native_io.NativeRecordReader(path) as reader:
      for _ in reader:
        pass
    return True
  except (IOError, OSError, ValueError):
    return False


def open_at(path: str, record_ordinal: int,
            index: Optional[shard_index.ShardIndex] = None,
            verify_crc: bool = True) -> Iterator[bytes]:
  """Sequential records of ``path`` from ``record_ordinal`` on: the shard
  index maps the ordinal to a byte offset and the reader seeks there.
  Without ``index`` the sidecar is loaded and validated (raises
  ``shard_index.StaleIndexError`` when the shard changed)."""
  if index is None:
    index = shard_index.load_index(path)
  if record_ordinal == index.record_count:
    return iter(())
  return native_io.iter_records_from(path, index.offset_of(record_ordinal),
                                     verify_crc)


def read_records_at(path: str, ordinals: Sequence[int],
                    index: Optional[shard_index.ShardIndex] = None
                    ) -> Dict[int, bytes]:
  """Indexed point reads, ``{ordinal: payload}``, through one open and a
  seek per record: the shuffle-buffer refill of a seek resume."""
  if index is None:
    index = shard_index.load_index(path)
  out: Dict[int, bytes] = {}
  with native_io.NativeRecordReader(path) as reader:
    for ordinal in sorted(set(ordinals)):
      reader.seek(index.offset_of(ordinal))
      record = reader.read_next()
      if record is None:
        raise IOError(f'{path}: unexpected EOF at indexed record {ordinal}')
      out[ordinal] = record
  return out


class RecordWriter:
  """TFRecord writer on the C++ library; ``shard``/``num_shards`` name the
  file ``<path>-%05d-of-%05d``."""

  def __init__(self, path: str, shard: Optional[int] = None,
               num_shards: Optional[int] = None):
    if shard is not None and num_shards:
      path = f'{path}-{shard:05d}-of-{num_shards:05d}'
    self._path = path
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    self._writer = native_io.NativeRecordWriter(path)

  @property
  def path(self) -> str:
    return self._path

  def write(self, serialized: bytes) -> None:
    self._writer.write(serialized)

  def flush(self) -> None:
    self._writer.flush()

  def close(self) -> None:
    self._writer.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


def write_examples(path: str, serialized_examples: Sequence[bytes]) -> str:
  """Writes serialized examples to one TFRecord file; returns the path."""
  with RecordWriter(path) as writer:
    for example in serialized_examples:
      writer.write(example)
  return path
