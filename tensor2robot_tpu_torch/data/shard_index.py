"""Seekable shard index: per-record byte offsets for TFRecord shards.

The port's copy of ``tensor2robot_tpu/data/shard_index.py`` (the same
sidecar bytes), without its metrics counters (ROADMAP queue 1 item 10).
The TFRecord wire format fixes every record's byte offset (each record
occupies ``12 + payload + 4`` bytes), so a compact sidecar turns a
deep-position resume into a seek:

    <shard>.idx = magic | record_count | offsets[count] | footer | crc

All integers little-endian. The footer pins the SHARD the index
describes (its size plus CRC32 samples of its head and tail), so a
rewritten, truncated or appended shard makes its index STALE and a
resume degrades loudly to the replay path instead of serving a wrong
stream. Validation is O(1) in the shard size (one stat, two bounded
reads). Standard library only.
"""

from __future__ import annotations

import logging
import os
import struct
import zlib
from typing import BinaryIO, Iterator, List, Optional, Sequence, Tuple

INDEX_SUFFIX = '.idx'
_MAGIC = b'T2RIDX01'
_FOOTER = struct.Struct('<QII')  # shard_size, head_crc, tail_crc
_COUNT = struct.Struct('<Q')
_INDEX_CRC = struct.Struct('<I')
# Head/tail CRC sample size: big enough that an in-place rewrite is
# caught with near certainty, small enough that validation stays O(1).
_CRC_SAMPLE_BYTES = 65536

_HEADER_BYTES = 12  # u64 length + u32 masked_crc(length)
_FOOTER_BYTES = 4   # u32 masked_crc(payload)


class IndexError_(Exception):
  """Raised for malformed shards/indexes (name avoids builtins clash)."""


class StaleIndexError(IndexError_):
  """The shard changed since its index was written."""


class ShardIndex:
  """Parsed sidecar: per-record byte offsets plus the shard fingerprint."""

  __slots__ = ('path', 'offsets', 'shard_size', 'head_crc', 'tail_crc')

  def __init__(self, path: str, offsets: Sequence[int], shard_size: int,
               head_crc: int, tail_crc: int):
    self.path = path
    self.offsets = list(offsets)
    self.shard_size = int(shard_size)
    self.head_crc = int(head_crc)
    self.tail_crc = int(tail_crc)

  @property
  def record_count(self) -> int:
    return len(self.offsets)

  def offset_of(self, ordinal: int) -> int:
    """Byte offset of record ``ordinal``'s header start."""
    if not 0 <= ordinal < len(self.offsets):
      raise IndexError_(
          f'record ordinal {ordinal} out of range for {self.path!r} '
          f'({len(self.offsets)} records)')
    return self.offsets[ordinal]


def index_path_for(shard_path: str) -> str:
  return shard_path + INDEX_SUFFIX


def _sample_crcs(f: BinaryIO, size: int) -> Tuple[int, int]:
  """CRC32 of the shard's first and last ``_CRC_SAMPLE_BYTES`` bytes."""
  n = min(size, _CRC_SAMPLE_BYTES)
  f.seek(0)
  head = zlib.crc32(f.read(n))
  f.seek(max(0, size - n))
  tail = zlib.crc32(f.read(n))
  return head & 0xffffffff, tail & 0xffffffff


def scan_record_offsets(shard_path: str) -> Tuple[List[int], int]:
  """Walks the TFRecord framing, returning (offsets, shard_size).

  Header-only walk: reads each 12-byte length header and SEEKS over the
  payload, so building an index costs one small read per record, not one
  pass over the bytes. Raises :class:`IndexError_` on truncation or an
  implausible length (the CRC fields are not verified here; the readers
  do that).
  """
  offsets: List[int] = []
  with open(shard_path, 'rb') as f:
    size = os.fstat(f.fileno()).st_size
    pos = 0
    while pos < size:
      header = f.read(_HEADER_BYTES)
      if not header:
        break
      if len(header) != _HEADER_BYTES:
        raise IndexError_(
            f'{shard_path}: truncated record header at offset {pos}')
      (length,) = struct.unpack('<Q', header[:8])
      if length > (1 << 30):
        raise IndexError_(
            f'{shard_path}: implausible record length {length} at '
            f'offset {pos} (corrupt framing?)')
      end = pos + _HEADER_BYTES + length + _FOOTER_BYTES
      if end > size:
        raise IndexError_(
            f'{shard_path}: truncated record payload/footer at offset '
            f'{pos} (record ends at {end}, shard is {size} bytes)')
      offsets.append(pos)
      f.seek(end)
      pos = end
  return offsets, size


def build_index(shard_path: str) -> ShardIndex:
  """Scans a shard and returns its in-memory index (no sidecar write)."""
  offsets, size = scan_record_offsets(shard_path)
  with open(shard_path, 'rb') as f:
    head_crc, tail_crc = _sample_crcs(f, size)
  return ShardIndex(shard_path, offsets, size, head_crc, tail_crc)


def serialize_index(index: ShardIndex) -> bytes:
  body = b''.join([
      _MAGIC,
      _COUNT.pack(index.record_count),
      struct.pack(f'<{index.record_count}Q', *index.offsets),
      _FOOTER.pack(index.shard_size, index.head_crc, index.tail_crc),
  ])
  return body + _INDEX_CRC.pack(zlib.crc32(body) & 0xffffffff)


def parse_index(shard_path: str, blob: bytes) -> ShardIndex:
  """Parses a sidecar blob; raises :class:`IndexError_` when malformed."""
  min_len = len(_MAGIC) + _COUNT.size + _FOOTER.size + _INDEX_CRC.size
  if len(blob) < min_len or not blob.startswith(_MAGIC):
    raise IndexError_(f'{index_path_for(shard_path)}: not a shard index')
  body, (crc,) = blob[:-_INDEX_CRC.size], _INDEX_CRC.unpack(
      blob[-_INDEX_CRC.size:])
  if zlib.crc32(body) & 0xffffffff != crc:
    raise IndexError_(
        f'{index_path_for(shard_path)}: index checksum mismatch '
        f'(truncated or corrupt sidecar)')
  (count,) = _COUNT.unpack_from(body, len(_MAGIC))
  offsets_off = len(_MAGIC) + _COUNT.size
  expect = offsets_off + 8 * count + _FOOTER.size
  if len(body) != expect:
    raise IndexError_(
        f'{index_path_for(shard_path)}: index length {len(body)} does '
        f'not match record count {count}')
  offsets = list(struct.unpack_from(f'<{count}Q', body, offsets_off))
  shard_size, head_crc, tail_crc = _FOOTER.unpack_from(
      body, offsets_off + 8 * count)
  return ShardIndex(shard_path, offsets, shard_size, head_crc, tail_crc)


def write_index(shard_path: str, index: Optional[ShardIndex] = None,
                index_path: Optional[str] = None) -> str:
  """Builds (if needed) and atomically writes the sidecar; returns path."""
  index = index or build_index(shard_path)
  index_path = index_path or index_path_for(shard_path)
  tmp = index_path + f'.tmp{os.getpid()}'
  with open(tmp, 'wb') as f:
    f.write(serialize_index(index))
  os.replace(tmp, index_path)  # atomic: readers never see partials
  return index_path


def validate_index(index: ShardIndex, shard_path: str) -> None:
  """Raises :class:`StaleIndexError` unless the shard still matches.

  O(1) in the shard size: one stat plus two bounded sample reads. The
  staleness rule — size, head-CRC, and tail-CRC must all match — catches
  truncation, appends, and rewrites; it is deliberately NOT a full-file
  CRC, which would make deep resume O(file) again.
  """
  try:
    size = os.path.getsize(shard_path)
  except OSError as e:
    raise StaleIndexError(f'{shard_path}: unreadable ({e})') from e
  if size != index.shard_size:
    raise StaleIndexError(
        f'{shard_path}: size {size} != indexed {index.shard_size} '
        f'(shard truncated/appended since indexing)')
  with open(shard_path, 'rb') as f:
    head_crc, tail_crc = _sample_crcs(f, size)
  if (head_crc, tail_crc) != (index.head_crc, index.tail_crc):
    raise StaleIndexError(
        f'{shard_path}: head/tail checksum mismatch (shard rewritten '
        f'since indexing)')


def load_index(shard_path: str, validate: bool = True) -> ShardIndex:
  """Loads + validates the sidecar. Raises ``FileNotFoundError`` when the
  sidecar is missing, :class:`IndexError_` when unparseable,
  :class:`StaleIndexError` when the shard changed."""
  with open(index_path_for(shard_path), 'rb') as f:
    blob = f.read()
  index = parse_index(shard_path, blob)
  if validate:
    validate_index(index, shard_path)
  return index


def ensure_index(shard_path: str) -> ShardIndex:
  """Loads a valid sidecar or (re)builds it, writing best-effort.

  The opportunistic path: called when a resumable stream is created, so
  the first run over a corpus leaves sidecars behind and every later
  restore seeks. A read-only data directory only costs the write — the
  in-memory index still serves this process.
  """
  try:
    return load_index(shard_path)
  except FileNotFoundError:
    pass
  except StaleIndexError:
    logging.warning('Shard index for %r is stale; rebuilding.', shard_path)
  except IndexError_:
    logging.warning('Shard index for %r is corrupt; rebuilding.',
                    shard_path)
  index = build_index(shard_path)
  try:
    write_index(shard_path, index)
  except OSError as e:
    logging.warning(
        'Could not write shard index sidecar for %r (%s); keeping the '
        'in-memory index for this process only.', shard_path, e)
  return index


def iter_records_from(shard_path: str, offset: int = 0,
                      verify_crc: bool = False) -> Iterator[bytes]:
  """Pure-Python TFRecord reader from a byte offset: framing only, and
  the payload CRC32C (:func:`masked_crc32c`) with ``verify_crc``.
  ``data/records.py`` has the full plain reader (both CRCs)."""
  with open(shard_path, 'rb') as f:
    f.seek(offset)
    pos = offset
    while True:
      header = f.read(_HEADER_BYTES)
      if not header:
        return
      if len(header) != _HEADER_BYTES:
        raise IndexError_(
            f'{shard_path}: truncated record header at offset {pos}')
      (length,) = struct.unpack('<Q', header[:8])
      if length > (1 << 30):
        raise IndexError_(
            f'{shard_path}: implausible record length at offset {pos}')
      payload = f.read(length)
      footer = f.read(_FOOTER_BYTES)
      if len(payload) != length or len(footer) != _FOOTER_BYTES:
        raise IndexError_(
            f'{shard_path}: truncated record at offset {pos}')
      if verify_crc:
        (want,) = struct.unpack('<I', footer)
        if masked_crc32c(payload) != want:
          raise IndexError_(
              f'{shard_path}: payload crc mismatch at offset {pos}')
      pos += _HEADER_BYTES + length + _FOOTER_BYTES
      yield payload


# Pure-Python CRC32C (Castagnoli), table-driven: the plain version of the
# C++ reader's CRC.
_CRC32C_TABLE: List[int] = []


def _crc32c_table() -> List[int]:
  if not _CRC32C_TABLE:
    poly = 0x82f63b78
    for i in range(256):
      crc = i
      for _ in range(8):
        crc = (crc >> 1) ^ (poly if crc & 1 else 0)
      _CRC32C_TABLE.append(crc)
  return _CRC32C_TABLE


def masked_crc32c(data: bytes) -> int:
  """TFRecord's masked CRC32C, matching ``native_io.masked_crc32c``."""
  table = _crc32c_table()
  crc = 0xffffffff
  for b in data:
    crc = (crc >> 8) ^ table[(crc ^ b) & 0xff]
  crc ^= 0xffffffff
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8 & 0xffffffff
