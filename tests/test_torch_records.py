"""Port parity: TFRecord files, CRCs, shard indexes and the interleave
order against the JAX package and TensorFlow.

* The C++ writer and reader (``native_io``), the plain Python reader
  (``records.iter_records_plain``) and the JAX package's ``native_io`` /
  ``records`` / ``shard_index`` give the same bytes and the same masked
  CRC32C; a port-written file is byte for byte a JAX-written one.
* Port-written shards read back through the JAX reader and through
  ``tf.data.TFRecordDataset``; TF- and JAX-written shards read back
  through the port.
* A flipped byte (payload or length), a truncated payload, footer or
  header is detected by every port reader.
* Shard-index sidecars are identical to the JAX ones, load either way,
  and go stale when the shard changes; seeks and point reads give the
  sequential stream's records.
* The interleave reader's order is the JAX reader's and the closed form
  of ``seek_resume.InterleaveLayout``; ``plan_resume`` equals the JAX one.
* No port module imports TensorFlow, or PIL at module scope, and a failed
  native build raises.
"""

import ast
import os
import pathlib
import struct

import numpy as np
import pytest

from tensor2robot_tpu.data import native_io as jax_native_io
from tensor2robot_tpu.data import records as jax_records
from tensor2robot_tpu.data import seek_resume as jax_seek_resume
from tensor2robot_tpu.data import shard_index as jax_shard_index
import tensor2robot_tpu_torch
from tensor2robot_tpu_torch import native
from tensor2robot_tpu_torch.data import (native_io, records, seek_resume,
                                         shard_index)

PACKAGE = pathlib.Path(tensor2robot_tpu_torch.__file__).resolve().parent


def _payloads(seed=0, count=24):
  rng = np.random.RandomState(seed)
  sizes = [0, 1, 7, 8, 9, 4096] + list(rng.randint(0, 3000, count - 6))
  return [rng.randint(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]


@pytest.fixture(scope='module')
def shard(tmp_path_factory):
  path = str(tmp_path_factory.mktemp('records') / 'a.tfrecord')
  payloads = _payloads()
  records.write_examples(path, payloads)
  return path, payloads


def test_masked_crc_matches_jax_and_plain():
  for payload in _payloads(seed=3):
    want = jax_native_io.masked_crc32c(payload)
    assert native_io.masked_crc32c(payload) == want
    assert shard_index.masked_crc32c(payload) == want
    assert jax_shard_index.masked_crc32c(payload) == want


def test_port_file_is_byte_for_byte_the_jax_file(tmp_path, shard):
  path, payloads = shard
  jax_path = str(tmp_path / 'jax.tfrecord')
  with jax_records.RecordWriter(jax_path) as writer:
    for payload in payloads:
      writer.write(payload)
  assert pathlib.Path(path).read_bytes() == pathlib.Path(jax_path).read_bytes()
  # The framing, field by field, for the first record.
  blob = pathlib.Path(path).read_bytes()
  length, length_crc = struct.unpack_from('<QI', blob)
  assert length == len(payloads[0]) and length_crc == (
      shard_index.masked_crc32c(blob[:8]))


@pytest.mark.parametrize('reader', ['native', 'plain', 'interleave',
                                    'jax_native', 'tf'])
def test_port_shard_reads_back(shard, reader):
  path, payloads = shard
  if reader == 'native':
    got = native_io.read_records(path)
  elif reader == 'plain':
    got = list(records.iter_records_plain(path))
  elif reader == 'interleave':
    with native_io.NativeInterleaveReader([path]) as it:
      got = list(it)
  elif reader == 'jax_native':
    got = jax_native_io.read_records(path)
  else:
    import tensorflow as tf
    got = [r.numpy() for r in tf.data.TFRecordDataset([path])]
  assert got == payloads


@pytest.mark.parametrize('writer', ['tf', 'jax'])
def test_foreign_shard_reads_in_the_port(tmp_path, writer):
  payloads = _payloads(seed=5)
  path = str(tmp_path / f'{writer}.tfrecord')
  if writer == 'tf':
    import tensorflow as tf
    with tf.io.TFRecordWriter(path) as w:
      for payload in payloads:
        w.write(payload)
  else:
    jax_records.write_examples(path, payloads)
  assert native_io.read_records(path) == payloads
  assert list(records.iter_records_plain(path)) == payloads
  assert records.verify_tfrecord_file(path)


def _damaged(tmp_path, shard, how):
  path, payloads = shard
  blob = bytearray(pathlib.Path(path).read_bytes())
  first = 12 + len(payloads[0]) + 4  # the second record starts here
  if how == 'payload':
    blob[first + 12 + 3] ^= 0x40  # a byte of record 1's payload
  elif how == 'length':
    blob[first] ^= 0x01  # record 1's length field
  elif how == 'footer':
    blob = blob[:-2]
  elif how == 'payload_cut':
    blob = blob[:len(blob) - 4 - len(payloads[-1]) // 2]
  else:  # a header cut short
    blob += b'\x05\x00\x00'
  damaged = str(tmp_path / f'{how}.tfrecord')
  pathlib.Path(damaged).write_bytes(bytes(blob))
  return damaged


@pytest.mark.parametrize('how', ['payload', 'length', 'footer',
                                 'payload_cut', 'header_cut'])
def test_corruption_and_truncation_are_detected(tmp_path, shard, how):
  damaged = _damaged(tmp_path, shard, how)
  with pytest.raises(IOError):
    native_io.read_records(damaged)
  with pytest.raises(IOError):
    list(records.iter_records_plain(damaged))
  with pytest.raises(IOError):
    with native_io.NativeInterleaveReader([damaged]) as it:
      list(it)
  assert not records.verify_tfrecord_file(damaged)
  assert not jax_records.verify_tfrecord_file(damaged)


def test_missing_file_is_not_a_valid_file(tmp_path):
  assert not records.verify_tfrecord_file(str(tmp_path / 'none.tfrecord'))
  with pytest.raises(IOError):
    native_io.NativeRecordReader(str(tmp_path / 'none.tfrecord'))


def test_shard_index_sidecars_are_identical(tmp_path, shard):
  path, payloads = shard
  port_idx = shard_index.write_index(path, index_path=str(tmp_path / 'p.idx'))
  jax_idx = jax_shard_index.write_index(path,
                                        index_path=str(tmp_path / 'j.idx'))
  assert (pathlib.Path(port_idx).read_bytes() ==
          pathlib.Path(jax_idx).read_bytes())
  offsets, size = shard_index.scan_record_offsets(path)
  assert (offsets, size) == jax_shard_index.scan_record_offsets(path)
  # Each side loads the other's sidecar.
  port_view = shard_index.parse_index(path, pathlib.Path(jax_idx).read_bytes())
  jax_view = jax_shard_index.parse_index(path,
                                         pathlib.Path(port_idx).read_bytes())
  assert port_view.offsets == jax_view.offsets == offsets
  index = shard_index.ensure_index(path)
  assert index.offsets == offsets
  for ordinal in (0, 5, len(payloads) - 1):
    assert list(records.open_at(path, ordinal)) == payloads[ordinal:]
    assert list(records.iter_records_plain(path, offsets[ordinal])) == (
        payloads[ordinal:])
  assert list(records.open_at(path, len(payloads))) == []
  assert records.read_records_at(path, [7, 2, 7, 11]) == {
      i: payloads[i] for i in (2, 7, 11)}


def test_stale_sidecar_is_refused(tmp_path):
  path = str(tmp_path / 's.tfrecord')
  records.write_examples(path, _payloads(seed=2, count=8))
  shard_index.write_index(path)
  with native_io.NativeRecordWriter(path, append=True) as writer:
    writer.write(b'one more')
  with pytest.raises(shard_index.StaleIndexError):
    shard_index.load_index(path)
  with pytest.raises(jax_shard_index.StaleIndexError):
    jax_shard_index.load_index(path)
  assert shard_index.ensure_index(path).record_count == 9


def _shards(tmp_path, counts):
  paths = []
  for i, count in enumerate(counts):
    path = str(tmp_path / f's{i}.tfrecord')
    records.write_examples(path, [f'{i}:{j}'.encode() for j in range(count)])
    paths.append(path)
  return paths


@pytest.mark.parametrize('cycle_length', [1, 2, 16])
def test_interleave_order_matches_jax_and_the_layout(tmp_path, cycle_length):
  counts = [5, 3, 0, 7, 2]
  paths = _shards(tmp_path, counts)
  with native_io.NativeInterleaveReader(paths, cycle_length=cycle_length,
                                        queue_capacity=2) as it:
    got = list(it)
  with jax_native_io.NativeInterleaveReader(
      paths, cycle_length=cycle_length) as it:
    assert got == list(it)
  layout = seek_resume.InterleaveLayout(counts, cycle_length)
  want = [f'{f}:{o}'.encode() for f, o in
          (layout.record_at(p) for p in range(layout.total))]
  assert got == want


def test_plan_resume_matches_jax(tmp_path):
  counts = [9, 4, 6]
  paths = _shards(tmp_path, counts)
  for path in paths:
    shard_index.write_index(path)

  def fetch(path, ordinals):
    return records.read_records_at(path, ordinals)

  for emitted in (0, 5, 19, 40):
    got = seek_resume.plan_resume(paths, counts, 2, 3, 6, emitted, True,
                                  fetch)
    want = jax_seek_resume.plan_resume(paths, counts, 2, 3, 6, emitted, True,
                                       fetch)
    assert got.buffer == want.buffer
    assert (got.epoch, got.within_epoch, got.records_local) == (
        want.epoch, want.within_epoch, want.records_local)
    assert np.array_equal(got.rng.get_state()[1], want.rng.get_state()[1])


def _module_scope_imports(path):
  tree = ast.parse(path.read_text())
  for node in tree.body:
    if isinstance(node, ast.Import):
      yield from (alias.name for alias in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module:
      yield node.module


def test_port_imports_no_tensorflow_and_pil_only_lazily():
  sources = sorted(PACKAGE.rglob('*.py')) + [PACKAGE.parent / 'chip_smoke.py']
  for path in sources:
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
      names = []
      if isinstance(node, ast.Import):
        names = [alias.name for alias in node.names]
      elif isinstance(node, ast.ImportFrom) and node.module:
        names = [node.module]
      assert not [n for n in names if n.split('.')[0] == 'tensorflow'], path
    assert not [n for n in _module_scope_imports(path)
                if n.split('.')[0] == 'PIL'], path


def test_failed_native_build_raises(tmp_path, monkeypatch):
  (tmp_path / 'broken.cpp').write_text('this is not C++\n')
  monkeypatch.setattr(native, 'SRC_DIR', tmp_path)
  monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'build')
  with pytest.raises(RuntimeError, match='building broken.cpp failed'):
    native.build('broken')
  assert not list((tmp_path / 'build').glob('*.so'))


def test_native_library_is_built_into_the_build_directory():
  native.record_io()
  path = native.library_path('record_io')
  assert path.exists() and path.parent == native.BUILD_DIR
  assert path.parent.parts[-2:] == ('build', 'native')
  assert os.path.commonpath([path, PACKAGE.parent]) == str(PACKAGE.parent)
