"""Port parity: SequenceExamples, episode image lists and the spec helpers.

* SequenceExamples written by either package's encoder decode in the
  other package bit for bit: context features, sequence features of
  ragged lengths (0 included) padded with zeros to the batch's longest
  list, PNG image steps, and every ``<key>_length``. The port's C++ parser
  is bit for bit its plain version on the same records, and both raise
  where TensorFlow's ``parse_sequence_example`` raises (a missing feature
  list, a step of the wrong length).
* An episode's frames ([T, H, W, C] encoded-image specs, a BytesList of
  T blobs) decode as the JAX codec decodes them, empty blobs as zeros; a
  count other than T raises naming the feature.
* ``specs.algebra``'s record-feed helpers are the JAX package's.
"""

import numpy as np
import pytest
import torch

from tensor2robot_tpu.data import example_codec as jax_codec
from tensor2robot_tpu.specs import SpecStruct as JaxSpecStruct
from tensor2robot_tpu.specs import TensorSpec as JaxTensorSpec
from tensor2robot_tpu.specs import algebra as jax_algebra
from tensor2robot_tpu_torch.data import example_codec, native_io
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec, algebra

LENGTHS = (2, 0, 3, 1)


def _tf():
  import tensorflow as tf
  return tf


def _spec_rows():
  """(path, shape, dtype, kwargs) of a spec structure with context and
  sequence features, images among both."""
  return [
      ('ctx/pose', (3,), np.float32, dict(name='pose')),
      ('ctx/count', (2,), np.int64, dict(name='count')),
      ('ctx/frame', (6, 5, 3), np.uint8, dict(name='frame',
                                              data_format='PNG')),
      ('seq/action', (2,), np.float32, dict(name='action',
                                            is_sequence=True)),
      ('seq/flag', (1,), np.int64, dict(name='flag', is_sequence=True)),
      ('seq/image', (4, 6, 3), np.uint8, dict(name='image',
                                              is_sequence=True,
                                              data_format='PNG')),
  ]


def _specs(kind):
  struct, spec = (SpecStruct, TensorSpec) if kind == 'port' else (
      JaxSpecStruct, JaxTensorSpec)
  out = struct()
  for path, shape, dtype, kwargs in _spec_rows():
    out[path] = spec(shape, dtype, **kwargs)
  return out


def _values(rng, length):
  return {
      'ctx/pose': rng.randn(3).astype(np.float32),
      'ctx/count': rng.randint(-9, 9, 2).astype(np.int64),
      'ctx/frame': rng.randint(0, 256, (6, 5, 3), dtype=np.uint8),
      'seq/action': rng.randn(length, 2).astype(np.float32),
      'seq/flag': rng.randint(-3, 3, (length, 1)).astype(np.int64),
      'seq/image': rng.randint(0, 256, (length, 4, 6, 3), dtype=np.uint8),
  }


def _numpy(struct):
  return {k: np.asarray(v) for k, v in struct.items()}


def _expected(values):
  """What a parse of ``values`` must give: sequences padded with zeros to
  the longest, and the lengths."""
  longest = max(LENGTHS)
  want = {}
  for key in values[0]:
    if key.startswith('seq/'):
      rows = []
      for v in values:
        pad = np.zeros((longest - len(v[key]),) + v[key].shape[1:],
                       v[key].dtype)
        rows.append(np.concatenate([v[key], pad]))
      want[key] = np.stack(rows)
      want[key + '_length'] = np.asarray([len(v[key]) for v in values],
                                         np.int64)
    else:
      want[key] = np.stack([v[key] for v in values])
  return want


def _assert_same(got, want):
  assert sorted(got) == sorted(want)
  for key in want:
    assert got[key].dtype == want[key].dtype, key
    assert got[key].shape == want[key].shape, key
    assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_sequence_examples_cross_decode_bit_for_bit(writer):
  rng = np.random.RandomState(7)
  values = [_values(rng, n) for n in LENGTHS]
  if writer == 'port':
    records = [example_codec.encode_example(_specs('port'), v)
               for v in values]
  else:
    records = [jax_codec.encode_example(_specs('jax'), v) for v in values]
  want = _expected(values)
  tf = _tf()
  jax_parsed = jax_codec.make_parse_fn(_specs('jax'))(tf.constant(records))
  _assert_same(_numpy(jax_parsed), want)
  plain, _ = example_codec.make_plain_parse_fn(_specs('port'))(records)
  _assert_same(_numpy(plain), want)
  native, _ = native_io.make_native_parse_fn(_specs('port'))(records)
  _assert_same(_numpy(native), want)


def test_native_parser_is_the_plain_parser_on_sequences():
  rng = np.random.RandomState(3)
  spec = _specs('port')
  records = [example_codec.encode_example(spec, _values(rng, n))
             for n in LENGTHS]
  named = example_codec.named_specs(spec)
  plain = example_codec.parse_batch(records, named)
  native = native_io.NativeExampleParser(named).parse_batch(records)
  assert sorted(plain) == sorted(native)
  assert 'f/seq/image_length' in plain
  for key, value in plain.items():
    if isinstance(value, list):
      assert len(value) == len(native[key]), key
      assert [bytes(v) for v in value] == [bytes(v) for v in native[key]]
    else:
      assert value.dtype == native[key].dtype, key
      assert np.array_equal(value, native[key]), key
  # Every list empty: [B, 0, ...] and zero lengths.
  empty = [example_codec.encode_example(spec, _values(rng, 0))
           for _ in range(2)]
  for parsed in (example_codec.parse_batch(empty, named),
                 native_io.NativeExampleParser(named).parse_batch(empty)):
    assert parsed['f/seq/action'].shape == (2, 0, 2)
    assert parsed['f/seq/image'] == []
    assert parsed['f/seq/flag_length'].tolist() == [0, 0]


def test_sequence_parse_errors_in_both_parsers_and_tf():
  spec = SpecStruct()
  spec['s'] = TensorSpec((2,), np.float32, name='s', is_sequence=True)
  named = example_codec.named_specs(spec)
  kind = example_codec.KIND_FLOAT
  missing = example_codec.encode_features({'c': (kind, [1.0])}, {})
  plain_example = example_codec.encode_features({'c': (kind, [1.0])})
  short = example_codec.encode_features({}, {'s': (kind, [[1.0, 2.0],
                                                           [3.0]])})
  tf = _tf()
  for records, match in (([missing], 's: feature list missing'),
                         ([plain_example], 's: feature list missing'),
                         ([short], 's: step 1 has 1 values, expected 2')):
    with pytest.raises(ValueError, match=match):
      example_codec.parse_batch(records, named)
    with pytest.raises(ValueError, match=match):
      native_io.NativeExampleParser(named).parse_batch(records)
    with pytest.raises(tf.errors.InvalidArgumentError):
      jax_spec = JaxSpecStruct()
      jax_spec['s'] = JaxTensorSpec((2,), np.float32, name='s',
                                    is_sequence=True)
      jax_codec.make_parse_fn(jax_spec)(tf.constant(records))


def _episode_spec(kind, frames=3):
  struct, spec = (SpecStruct, TensorSpec) if kind == 'port' else (
      JaxSpecStruct, JaxTensorSpec)
  out = struct()
  out['episode/image'] = spec((frames, 22, 30, 3), np.uint8,
                              name='condition_ep0/image0',
                              data_format='JPEG')
  out['episode/pose'] = spec((frames, 14), np.float32,
                             name='condition_ep0/world_pose_gripper')
  return out


def test_episode_image_lists_decode_as_the_jax_codec_with_empty_blobs():
  rng = np.random.RandomState(11)
  frames = rng.randint(0, 256, (2, 3, 22, 30, 3), dtype=np.uint8)
  poses = rng.randn(2, 3, 14).astype(np.float32)
  records = []
  for b in range(2):
    blobs = [example_codec.image_codec.encode_png(f) for f in frames[b]]
    if b == 1:
      blobs[1] = b''  # a missing frame: zeros in both packages
      frames[1, 1] = 0
    records.append(example_codec.encode_features({
        'condition_ep0/image0': (example_codec.KIND_BYTES, blobs),
        'condition_ep0/world_pose_gripper': (example_codec.KIND_FLOAT,
                                             poses[b].reshape(-1))}))
  tf = _tf()
  jax_parsed = _numpy(jax_codec.make_parse_fn(_episode_spec('jax'))(
      tf.constant(records)))
  for parse_fn in (example_codec.make_plain_parse_fn(_episode_spec('port')),
                   native_io.make_native_parse_fn(_episode_spec('port'))):
    got, _ = parse_fn(records)
    _assert_same(_numpy(got), jax_parsed)
    assert np.array_equal(got['episode/image'], frames)
  # The port's own encoder writes T blobs; a count other than T raises.
  port_records = [example_codec.encode_example(
      _episode_spec('port'), {'episode/image': frames[b],
                              'episode/pose': poses[b]}) for b in range(2)]
  got, _ = native_io.make_native_parse_fn(_episode_spec('port'))(
      port_records)
  assert np.array_equal(got['episode/image'], frames)
  named = example_codec.named_specs(_episode_spec('port', frames=4))
  for parse in (lambda r: example_codec.parse_batch(r, named),
                native_io.NativeExampleParser(named).parse_batch):
    with pytest.raises(ValueError,
                       match='condition_ep0/image0: expected 4 values, got 3'):
      parse(port_records)


def test_episode_frames_decode_into_the_ring_slot():
  rng = np.random.RandomState(5)
  frames = rng.randint(0, 256, (3, 3, 22, 30, 3), dtype=np.uint8)
  poses = rng.randn(3, 3, 14).astype(np.float32)
  spec = _episode_spec('port')
  records = [example_codec.encode_example(
      spec, {'episode/image': frames[b], 'episode/pose': poses[b]})
             for b in range(3)]
  parse_fn = native_io.make_native_parse_fn(spec, decode_workers=4)
  slot = parse_fn.make_image_buffers(3)
  assert slot['f/episode/image'].shape == (3, 3, 22, 30, 3)
  got, _ = parse_fn(records, image_out=slot)
  assert np.shares_memory(got['episode/image'], slot['f/episode/image'])
  assert np.array_equal(got['episode/image'], frames)


def test_algebra_helpers_match_the_jax_package():
  port, jax = _specs('port'), _specs('jax')
  port['ctx/pose'] = TensorSpec((3,), np.float32, name='pose',
                                dataset_key='d1')
  jax['ctx/pose'] = JaxTensorSpec((3,), np.float32, name='pose',
                                  dataset_key='d1')

  def rows(struct):
    return [(k, tuple(v.shape), np.dtype(str(v.dtype).replace('torch.', '')
                                          ).name, v.name, v.dataset_key,
             v.is_sequence) for k, v in struct.items()]

  assert rows(algebra.add_sequence_length_specs(port)) == rows(
      jax_algebra.add_sequence_length_specs(jax))
  for key in ('', 'd1', 'd2'):
    assert rows(algebra.filter_spec_structure_by_dataset(port, key)) == rows(
        jax_algebra.filter_spec_structure_by_dataset(jax, key))
  assert list(algebra.spec_names(port)) == list(jax_algebra.spec_names(jax))
  clash = SpecStruct()
  clash['a'] = TensorSpec((1,), np.float32, name='x')
  clash['b'] = TensorSpec((2,), np.float32, name='x')
  with pytest.raises(ValueError, match='Duplicate spec name'):
    algebra.spec_names(clash)
  varlen = TensorSpec((4, 2), np.float32, varlen_default_value=-1.0)
  jax_varlen = JaxTensorSpec((4, 2), np.float32, varlen_default_value=-1.0)
  for n in (1, 4, 6):
    array = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    got = algebra.pad_or_clip_to_spec_shape(array, varlen)
    assert np.array_equal(got, jax_algebra.pad_or_clip_to_spec_shape(
        array, jax_varlen))
    assert got.shape == (4, 2)
  fixed = TensorSpec((4,), torch.float32)
  assert algebra.pad_or_clip_to_spec_shape(np.ones(2), fixed).shape == (2,)
