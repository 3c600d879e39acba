"""Port parity: the tf.Example wire decoder and encoder, and image decode.

* Every record of ``tests/test_data/pose_env_test_data.tfrecord``: the
  port's plain decoder (``example_codec.parse_batch``) and its C++ parser
  (``native_io.NativeExampleParser``) give bit for bit what TensorFlow's
  ``parse_example`` gives under the JAX codec's feature map
  (``example_codec.spec_struct_to_feature_maps``): the numeric features,
  also as ``make_parse_fn`` returns them, and the encoded image bytes. The decoded images are bit for bit
  TF's ``decode_jpeg(dct_method='INTEGER_ACCURATE')``, PIL's decode and
  the JAX native parse fn's. (TF's ``decode_image`` takes libjpeg's
  INTEGER_FAST DCT and differs from all three by a few levels; the JAX
  package's native path, which the port copies, takes ISLOW.)
* Examples the port encodes parse in TensorFlow to their inputs: fixed
  float and int64 features (negative and bool values), a varlen feature
  padded and one clipped, and a PNG image; a missing optional feature
  parses to zeros as in the JAX native parser; a missing required feature
  raises in TF, the plain decoder and the C++ parser alike.
* PNG decode is bit for bit PIL's over all five row filters and gray, RGB
  and RGBA, with channels forced as PIL's ``convert`` forces them; its C++
  row unfilter is bit for bit a plain Python loop, and a filter byte
  outside 0-4 raises; the
  JPEG route (the C++ libjpeg decoder, and the PIL route) is bit for bit
  PIL's; empty bytes decode to zeros; other bytes raise.
"""

import io
import os
import zlib

import numpy as np
import pytest
import torch

from tensor2robot_tpu.data import example_codec as jax_codec
from tensor2robot_tpu.data import native_io as jax_native_io
from tensor2robot_tpu.modes import ModeKeys as JaxModeKeys
from tensor2robot_tpu.research.pose_env import (
    PoseEnvRegressionModel as JaxPoseModel)
from tensor2robot_tpu.specs import TensorSpec as JaxTensorSpec
from tensor2robot_tpu_torch import native
from tensor2robot_tpu_torch.data import example_codec, image_codec, native_io
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.research.pose_env import PoseEnvRegressionModel
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec

TEST_DATA = os.path.join(os.path.dirname(__file__), 'test_data',
                         'pose_env_test_data.tfrecord')


def _tf():
  import tensorflow as tf
  return tf


def _pil(data):
  import PIL.Image
  return PIL.Image.open(io.BytesIO(data))


def _pose_specs():
  model = PoseEnvRegressionModel(device_type='cpu')
  pre = model.preprocessor
  return (pre.get_in_feature_specification(ModeKeys.TRAIN),
          pre.get_in_label_specification(ModeKeys.TRAIN))


@pytest.fixture(scope='module')
def pose_records():
  return native_io.read_records(TEST_DATA)


@pytest.fixture(scope='module')
def tf_parsed(pose_records):
  """TF's parse of every pose_env record through the JAX codec's feature
  map (``spec_struct_to_feature_maps``: what ``make_parse_fn`` hands to
  ``tf.io.parse_example``), images left encoded; and the labels of
  ``make_parse_fn`` itself."""
  from tensor2robot_tpu.specs import SpecStruct as JaxSpecStruct
  model = JaxPoseModel(device_type='cpu')
  pre = model.preprocessor
  feature_spec = pre.get_in_feature_specification(JaxModeKeys.TRAIN)
  label_spec = pre.get_in_label_specification(JaxModeKeys.TRAIN)
  both = JaxSpecStruct(list(feature_spec.items()) + list(label_spec.items()))
  context, sequence, _ = jax_codec.spec_struct_to_feature_maps(both)
  assert not sequence
  tf = _tf()
  raw = tf.io.parse_example(tf.constant(pose_records), context)
  _, labels = jax_codec.make_parse_fn(feature_spec, label_spec)(
      tf.constant(pose_records))
  return ({k: np.asarray(v) for k, v in raw.items()},
          {k: np.asarray(v) for k, v in labels.items()})


@pytest.mark.parametrize('parser', ['plain', 'native'])
def test_pose_env_records_parse_as_tf_parses_them(pose_records, tf_parsed,
                                                   parser):
  named = example_codec.named_specs(*_pose_specs())
  if parser == 'plain':
    parsed = example_codec.parse_batch(pose_records, named)
  else:
    parsed = native_io.NativeExampleParser(named).parse_batch(pose_records)
  raw, want_labels = tf_parsed
  assert len(pose_records) == 100
  assert parsed['f/state/image'] == list(raw['state/image'])
  for key in ('target_pose', 'reward'):
    got = parsed[f'l/{key}']
    assert got.dtype == want_labels[key].dtype == raw[key].dtype == np.float32
    assert np.array_equal(got.view(np.int32), want_labels[key].view(np.int32))
    assert np.array_equal(got.view(np.int32), raw[key].view(np.int32))


def test_pose_env_images_decode_as_tf_accurate_pil_and_jax(pose_records):
  feature_spec, label_spec = _pose_specs()
  features, labels = native_io.make_native_parse_fn(
      feature_spec, label_spec, decode_workers=2)(pose_records)
  plain_features, plain_labels = example_codec.make_plain_parse_fn(
      feature_spec, label_spec)(pose_records)
  images = features['state/image']
  assert images.shape == (100, 64, 64, 3) and images.dtype == np.uint8
  assert np.array_equal(plain_features['state/image'], images)
  for key in labels:
    assert np.array_equal(plain_labels[key], labels[key])
  raw = example_codec.parse_batch(
      pose_records, example_codec.named_specs(feature_spec))['f/state/image']
  tf = _tf()
  accurate = np.stack([tf.io.decode_jpeg(
      r, channels=3, dct_method='INTEGER_ACCURATE').numpy() for r in raw])
  assert np.array_equal(images, accurate)
  assert np.array_equal(images, np.stack([np.asarray(_pil(r)) for r in raw]))
  jax_model = JaxPoseModel(device_type='cpu')
  jax_parse = jax_native_io.make_native_parse_fn(
      jax_model.preprocessor.get_in_feature_specification(JaxModeKeys.TRAIN),
      jax_model.preprocessor.get_in_label_specification(JaxModeKeys.TRAIN),
      decode_workers=0)
  jax_features, jax_labels = jax_parse(pose_records)
  assert np.array_equal(np.asarray(jax_features['state/image']), images)
  for key in labels:
    assert np.array_equal(np.asarray(jax_labels[key]), labels[key])


def _codec_specs():
  spec = SpecStruct()
  spec['a/fixed'] = TensorSpec((2, 3), torch.float32, name='fixed')
  spec['a/ints'] = TensorSpec((4,), torch.int64, name='ints')
  spec['a/flag'] = TensorSpec((1,), torch.bool, name='flag')
  spec['pad'] = TensorSpec((5,), torch.float32, name='pad',
                           varlen_default_value=-1.0)
  spec['clip'] = TensorSpec((2,), torch.float32, name='clip',
                            varlen_default_value=7)
  spec['maybe'] = TensorSpec((3,), torch.float32, name='maybe',
                             is_optional=True)
  spec['image'] = TensorSpec((6, 5, 3), torch.uint8, name='image',
                             data_format='PNG')
  return spec


def _jax_codec_specs(spec):
  out = {}
  for key, s in spec.items():
    dtype = {torch.float32: np.float32, torch.int64: np.int64,
             torch.bool: np.int64, torch.uint8: np.uint8}[s.dtype]
    out[key] = JaxTensorSpec(shape=s.shape, dtype=dtype, name=s.name,
                             is_optional=s.is_optional,
                             data_format=s.data_format,
                             varlen_default_value=s.varlen_default_value)
  return out


def _codec_values(rng):
  return {
      'a/fixed': rng.randn(2, 3).astype(np.float32),
      'a/ints': np.array([-3, 0, 2**40, -(2**62)], np.int64),
      'a/flag': np.array([True]),
      'pad': rng.randn(3).astype(np.float32),
      'clip': np.array([4, -5, 6], np.float32),
      'image': rng.randint(0, 256, (6, 5, 3), dtype=np.uint8),
  }


def test_port_encoded_examples_parse_in_tf_to_their_inputs():
  spec = _codec_specs()
  rng = np.random.RandomState(0)
  values = [_codec_values(rng) for _ in range(3)]
  serialized = [example_codec.encode_example(spec, v) for v in values]
  from tensor2robot_tpu.specs import SpecStruct as JaxSpecStruct
  jax_specs = _jax_codec_specs(spec)
  # TF's FixedLenFeature has no default, so its parse leaves the missing
  # optional feature out of the spec; the JAX native parser takes it all.
  tf_out = jax_codec.make_parse_fn(JaxSpecStruct(
      {k: v for k, v in jax_specs.items() if k != 'maybe'}))(
          _tf().constant(serialized))
  tf_out = {k: np.asarray(v) for k, v in tf_out.items()}
  jax_native = jax_native_io.make_native_parse_fn(
      JaxSpecStruct(jax_specs), decode_workers=0)(serialized)[0]
  jax_native = {k: np.asarray(v) for k, v in jax_native.items()}
  plain = example_codec.make_plain_parse_fn(spec)(serialized)[0]
  native = native_io.make_native_parse_fn(spec, decode_workers=0)(
      serialized)[0]
  for b, value in enumerate(values):
    assert np.array_equal(tf_out['a/fixed'][b], value['a/fixed'])
    assert np.array_equal(tf_out['a/ints'][b], value['a/ints'])
    assert tf_out['a/flag'][b, 0] == 1
    assert np.array_equal(tf_out['pad'][b], np.concatenate(
        [value['pad'], [-1.0, -1.0]]).astype(np.float32))
    assert np.array_equal(tf_out['clip'][b], value['clip'][:2])
    assert np.array_equal(tf_out['image'][b], value['image'])
  for got in (plain, native):
    assert not got['maybe'].any() and got['maybe'].shape == (3, 3)
    assert np.array_equal(got['maybe'], jax_native['maybe'])
    assert got['a/flag'].dtype == np.bool_ and got['a/flag'].all()
    for key in ('a/fixed', 'a/ints', 'pad', 'clip', 'image'):
      assert np.array_equal(got[key], tf_out[key]), key
      assert np.array_equal(got[key], jax_native[key]), key
      assert got[key].dtype == tf_out[key].dtype, key


def test_missing_required_feature_raises_everywhere():
  spec = _codec_specs()
  value = _codec_values(np.random.RandomState(1))
  partial = dict(value)
  del partial['a/fixed']
  without = SpecStruct((k, s) for k, s in spec.items() if k != 'a/fixed')
  serialized = [example_codec.encode_example(without, partial)]
  with pytest.raises(ValueError, match='Missing value for required'):
    example_codec.encode_example(spec, partial)
  with pytest.raises(ValueError, match='fixed: required feature missing'):
    example_codec.parse_batch(serialized, example_codec.named_specs(spec))
  with pytest.raises(ValueError, match='fixed: required feature missing'):
    native_io.NativeExampleParser(
        example_codec.named_specs(spec)).parse_batch(serialized)
  from tensor2robot_tpu.specs import SpecStruct as JaxSpecStruct
  tf = _tf()
  with pytest.raises(tf.errors.InvalidArgumentError):
    jax_codec.make_parse_fn(JaxSpecStruct(_jax_codec_specs(spec)))(
        tf.constant(serialized))


def test_wrong_length_and_malformed_examples_raise_in_both_parsers():
  spec = SpecStruct()
  spec['x'] = TensorSpec((3,), torch.float32, name='x')
  named = example_codec.named_specs(spec)
  short = example_codec.encode_features(
      {'x': (example_codec.KIND_FLOAT, [1.0, 2.0])})
  broken = short[:-3]
  for records, match in (([short], 'expected 3 values, got 2'),
                         ([short[:5] + b'\xff'], 'malformed'),
                         ([broken], 'malformed')):
    with pytest.raises(ValueError, match=match):
      example_codec.parse_batch(records, named)
    with pytest.raises(ValueError, match=match):
      native_io.NativeExampleParser(named).parse_batch(records)


def test_sequence_specs_are_refused():
  # Sequence specs are decoded (tests/test_torch_sequence_example.py); what
  # neither package reads is refused: a sequence spec with a varlen
  # default, a sequence image of more than [H, W, C], and a spec routed to
  # a dataset on the single stream.
  spec = SpecStruct()
  spec['s'] = TensorSpec((3,), torch.float32, name='s', is_sequence=True,
                         varlen_default_value=0.0)
  with pytest.raises(ValueError, match='no varlen_default_value'):
    example_codec.named_specs(spec)
  spec = SpecStruct()
  spec['s'] = TensorSpec((2, 8, 8, 3), np.uint8, name='s', is_sequence=True,
                         data_format='PNG')
  with pytest.raises(ValueError, match='outside a sequence'):
    example_codec.named_specs(spec)
  spec = SpecStruct()
  spec['s'] = TensorSpec((3,), torch.float32, name='s', dataset_key='d')
  with pytest.raises(ValueError, match='dataset_map'):
    example_codec.named_specs(spec)


def _pil_array(data, channels=None):
  img = _pil(data)
  if channels == 3 and img.mode != 'RGB':
    img = img.convert('RGB')
  elif channels == 1 and img.mode != 'L':
    img = img.convert('L')
  arr = np.asarray(img)
  return arr[..., None] if arr.ndim == 2 else arr


@pytest.mark.parametrize('channels', [1, 3, 4], ids=['gray', 'rgb', 'rgba'])
@pytest.mark.parametrize('filters', [0, 1, 2, 3, 4, (0, 1, 2, 3, 4)],
                         ids=['none', 'sub', 'up', 'average', 'paeth',
                              'mixed'])
def test_png_decode_is_pil_bit_for_bit(channels, filters):
  rng = np.random.RandomState(channels * 7 + hash(str(filters)) % 97)
  smooth = np.add.outer(np.arange(19), np.arange(23))[..., None] * (
      np.arange(1, channels + 1))
  image = ((smooth + rng.randint(0, 9, (19, 23, channels))) % 256).astype(
      np.uint8)
  data = image_codec.encode_png(image, filters=filters)
  assert np.array_equal(_pil_array(data), image)
  assert np.array_equal(image_codec.decode_png(data), image)
  for want in (1, 3):
    got = image_codec.decode_image(data, (19, 23, want))
    assert np.array_equal(got, _pil_array(data, want)), want


def _unfilter_plain(rows, bpp):
  """The plain version of the C++ ``t2r_png_unfilter``: PNG 1.2's row
  filters undone byte by byte in Python."""
  height, stride = rows.shape[0], rows.shape[1] - 1
  out = bytearray(height * stride)
  for r in range(height):
    kind = int(rows[r, 0])
    for i in range(stride):
      at = r * stride + i
      left = out[at - bpp] if i >= bpp else 0
      up = out[at - stride] if r else 0
      upleft = out[at - stride - bpp] if r and i >= bpp else 0
      if kind == 0:
        pred = 0
      elif kind == 1:
        pred = left
      elif kind == 2:
        pred = up
      elif kind == 3:
        pred = (left + up) >> 1
      else:
        p = left + up - upleft
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
        pred = left if pa <= pb and pa <= pc else (up if pb <= pc
                                                   else upleft)
      out[at] = (int(rows[r, 1 + i]) + pred) & 0xff
  return np.frombuffer(bytes(out), np.uint8).reshape(height, stride)


@pytest.mark.parametrize('bpp', [1, 3, 4])
@pytest.mark.parametrize('filters', [1, 2, 3, 4, (0, 4, 3, 1, 2, 4)],
                         ids=['sub', 'up', 'average', 'paeth', 'mixed'])
def test_native_png_unfilter_is_the_plain_version(bpp, filters):
  """The C++ unfilter against the Python loop, bit for bit, over random
  filtered bytes (every wrap-around of the modulo-256 sums)."""
  rng = np.random.RandomState(bpp * 11 + len(str(filters)))
  height, stride = 9, 13 * bpp
  rows = rng.randint(0, 256, (height, stride + 1)).astype(np.uint8)
  rows[:, 0] = np.resize(np.asarray(filters, np.uint8), height)
  got = np.empty((height, stride), np.uint8)
  assert native.record_io().t2r_png_unfilter(
      rows.ctypes.data, got.ctypes.data, height, stride, bpp) == 0
  np.testing.assert_array_equal(got, _unfilter_plain(rows, bpp))


def test_png_unknown_row_filter_raises():
  data = bytearray(image_codec.encode_png(np.zeros((3, 4, 3), np.uint8),
                                          filters=(0, 1, 2)))
  # Rewrite the IDAT with a filter byte of 5 on the last row.
  rows = np.zeros((3, 13), np.uint8)
  rows[:, 0] = (0, 1, 5)
  idat = image_codec._chunk(b'IDAT', zlib.compress(rows.tobytes()))  # pylint: disable=protected-access
  start = data.index(b'IDAT') - 4
  end = data.index(b'IEND') - 4
  data[start:end] = idat
  with pytest.raises(ValueError, match='row filter 5 does not exist'):
    image_codec.decode_png(bytes(data))


@pytest.mark.parametrize('mode', ['L', 'RGB', 'RGBA'])
def test_pil_written_png_decodes_as_pil(mode):
  import PIL.Image
  rng = np.random.RandomState(3)
  size = {'L': 1, 'RGB': 3, 'RGBA': 4}[mode]
  base = (np.add.outer(np.arange(30), 3 * np.arange(40)) % 256)
  image = np.stack([base] * size, -1).astype(np.uint8)
  image[4:9, 5:30] = rng.randint(0, 256, (5, 25, size))
  buf = io.BytesIO()
  PIL.Image.fromarray(image[..., 0] if size == 1 else image, mode).save(
      buf, format='PNG')
  for want in (1, 3):
    got = image_codec.decode_image(buf.getvalue(), (30, 40, want))
    assert np.array_equal(got, _pil_array(buf.getvalue(), want))


def _jpegs(count, shape, seed):
  import PIL.Image
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(count):
    arr = rng.randint(0, 256, shape, dtype=np.uint8)
    buf = io.BytesIO()
    PIL.Image.fromarray(arr if shape[-1] == 3 else arr[..., 0]).save(
        buf, format='JPEG', quality=90)
    out.append(buf.getvalue())
  return out


@pytest.mark.parametrize('route', ['libjpeg', 'pil'])
@pytest.mark.parametrize('channels', [1, 3])
def test_jpeg_routes_are_pil_bit_for_bit(monkeypatch, route, channels):
  if route == 'pil':
    monkeypatch.setattr(image_codec, 'jpeg_route', lambda: 'pil')
  else:
    assert image_codec.jpeg_route() == 'libjpeg'
  raws = _jpegs(5, (16, 24, channels), seed=channels)
  raws.insert(2, b'')
  out = image_codec.decode_image_batch(raws, (16, 24, channels), workers=2)
  assert not out[2].any()
  for i, raw in enumerate(raws):
    if raw:
      assert np.array_equal(out[i], _pil_array(raw, channels)), i
  # Into a caller's buffer (a ring slot), mixed with a PNG.
  raws[4] = image_codec.encode_png(out[4])
  slot = np.full((6, 16, 24, channels), 7, np.uint8)
  image_codec.decode_image_batch(raws, (16, 24, channels), out=slot)
  assert np.array_equal(slot, out)


def test_undecodable_images_raise(monkeypatch):
  with pytest.raises(ValueError, match='neither PNG nor JPEG'):
    image_codec.decode_image_batch([b'GIF89a....'], (4, 4, 3), key='img')
  jpeg = _jpegs(1, (8, 8, 3), seed=4)[0]
  with pytest.raises(ValueError, match='spec'):
    image_codec.decode_image_batch([jpeg], (8, 9, 3), key='img')
  with pytest.raises(ValueError, match='spec declares'):
    image_codec.decode_image_batch([image_codec.encode_png(
        np.zeros((8, 8, 3), np.uint8))], (8, 9, 3), key='img')
  monkeypatch.setattr(image_codec, 'jpeg_route', lambda: 'none')
  with pytest.raises(RuntimeError, match='neither'):
    image_codec.decode_image_batch([jpeg], (8, 8, 3), key='img')
