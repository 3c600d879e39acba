"""tf.Example on the wire: the port's own encoder and decoder, without TF.

The port's counterpart of the context-feature part of
``tensor2robot_tpu/data/example_codec.py``, which goes through
TensorFlow's protobuf. The schema, as protobuf field numbers:

    Example  {1: Features}
    Features {1: map<string, Feature>}   (entries {1: key, 2: value})
    Feature  {1: BytesList {1: bytes*},
              2: FloatList {1: float* (packed, or one fixed32 each)},
              3: Int64List {1: int64* (packed varints, or one each)}}

:func:`parse_batch` is the plain version of the C++ parser
(``native/record_io.cpp``, ``data/native_io.NativeExampleParser``): the
same spec-driven output, the same pad and clip of varlen features, the
same errors for a missing required feature or a fixed feature of the wrong
length. :func:`encode_example` writes examples that ``tf.io.parse_example``
and the JAX package read back as their inputs: FloatList and Int64List
packed, map entries sorted by key, images as PNG
(``data/image_codec.py``).

Features are addressed by spec *name* on disk and re-keyed to spec
*paths*. SequenceExample feature lists are not decoded yet (ROADMAP queue
1 item 4): a sequence spec raises.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.data import image_codec
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec, algebra
from tensor2robot_tpu_torch.specs.tensor_spec import (bfloat16, dtype_name,
                                                      to_numpy_dtype)

KIND_FLOAT, KIND_INT64, KIND_BYTES = 0, 1, 2
_FLOAT_NAMES = ('float32', 'float64', 'bfloat16', 'float16')
_UNSUPPORTED = ('SequenceExample feature lists are not decoded yet '
                '(ROADMAP.md queue 1 item 4)')


def is_encoded_image(spec: TensorSpec) -> bool:
  return spec.data_format is not None


def feature_kind(spec: TensorSpec) -> Tuple[int, int]:
  """(wire kind, values per example) of a context spec; a bytes feature's
  count is its number of encoded blobs (one)."""
  if spec.is_sequence:
    raise NotImplementedError(f'{_UNSUPPORTED}: {spec}')
  if is_encoded_image(spec):
    if len(spec.shape) > 3:
      raise NotImplementedError(
          f'a list of encoded images per example is not decoded yet '
          f'(ROADMAP.md queue 1 item 4): {spec}')
    return KIND_BYTES, 1
  flat = int(np.prod(spec.shape, dtype=np.int64))
  if dtype_name(spec.dtype) in _FLOAT_NAMES:
    return KIND_FLOAT, flat
  if spec.dtype.is_floating_point or spec.dtype.is_complex:
    raise ValueError(f'Cannot hold {spec} in a tf.Example.')
  return KIND_INT64, flat


def named_specs(feature_spec, label_spec=None):
  """``(output key, on-disk name, spec)`` of every feature (``f/`` keys)
  and label (``l/`` keys), the order of the flat spec structures."""
  named = []
  for prefix, spec_struct in (('f/', feature_spec), ('l/', label_spec)):
    if spec_struct is None:
      continue
    for key, spec in algebra.flatten_spec_structure(spec_struct).items():
      if spec.dataset_key:
        raise NotImplementedError(
            f'multi-dataset specs are not read yet (ROADMAP.md queue 1 item '
            f'4): {key}')
      feature_kind(spec)
      named.append((prefix + key, spec.name or key.split('/')[-1], spec))
  return named


# ------------------------------------------------------------------ wire


def _varint(buf: bytes, pos: int, end: int) -> Tuple[int, int]:
  value, shift = 0, 0
  while pos < end and shift < 64:
    b = buf[pos]
    pos += 1
    value |= (b & 0x7f) << shift
    if not b & 0x80:
      return value & 0xffffffffffffffff, pos
    shift += 7
  raise ValueError('malformed varint')


def _fields(buf: bytes, pos: int, end: int):
  """(field, wire type, value) of one message: a varint's value, or
  ``(start, end)`` of a length-delimited or fixed-width payload."""
  while pos < end:
    tag, pos = _varint(buf, pos, end)
    field, wire = tag >> 3, tag & 7
    if wire == 0:
      value, pos = _varint(buf, pos, end)
    elif wire == 2:
      n, pos = _varint(buf, pos, end)
      if end - pos < n:
        raise ValueError('truncated length-delimited field')
      value, pos = (pos, pos + n), pos + n
    elif wire in (1, 5):
      n = 8 if wire == 1 else 4
      if end - pos < n:
        raise ValueError('truncated fixed-width field')
      value, pos = (pos, pos + n), pos + n
    else:
      raise ValueError(f'unsupported wire type {wire}')
    yield field, wire, value


def _signed(v: int) -> int:
  return v - (1 << 64) if v >> 63 else v


def _feature_values(buf: bytes, start: int, end: int, kind: int,
                    key: str) -> list:
  """The values of one Feature message of ``kind``: floats, ints, or
  ``(offset, length)`` spans of bytes. Other lists are skipped, as the
  C++ parser skips them."""
  values = []
  want = {KIND_BYTES: 1, KIND_FLOAT: 2, KIND_INT64: 3}[kind]
  what = {KIND_BYTES: 'BytesList', KIND_FLOAT: 'FloatList',
          KIND_INT64: 'Int64List'}[kind]
  try:
    for field, wire, value in _fields(buf, start, end):
      if field != want or wire != 2:
        continue
      try:
        for f2, w2, v2 in _fields(buf, *value):
          if f2 != 1:
            continue
          if kind == KIND_FLOAT and w2 == 2:
            s, e = v2
            n = (e - s) // 4
            values.extend(struct.unpack_from(f'<{n}f', buf, s))
          elif kind == KIND_FLOAT and w2 == 5:
            values.append(struct.unpack_from('<f', buf, v2[0])[0])
          elif kind == KIND_INT64 and w2 == 2:
            s, e = v2
            while s < e:
              v, s = _varint(buf, s, e)
              values.append(_signed(v))
          elif kind == KIND_INT64 and w2 == 0:
            values.append(_signed(v2))
          elif kind == KIND_BYTES and w2 == 2:
            values.append((v2[0], v2[1] - v2[0]))
      except ValueError as e:
        raise ValueError(f'{key}: malformed {what}') from e
  except ValueError as e:
    if str(e).startswith(f'{key}:'):
      raise
    raise ValueError(f'{key}: malformed Feature') from e
  return values


def decode_example(serialized: bytes,
                   kinds: Dict[str, int]) -> Dict[str, list]:
  """``{name: values}`` of the features of one serialized tf.Example that
  ``kinds`` ({name: wire kind}) asks for; a later map entry of the same
  name replaces an earlier one."""
  buf = bytes(serialized)
  out: Dict[str, list] = {}
  try:
    for field, wire, value in _fields(buf, 0, len(buf)):
      if field != 1 or wire != 2:
        continue
      for f1, w1, entry in _fields(buf, *value):
        if f1 != 1 or w1 != 2:
          continue
        key, feature = None, None
        for f2, w2, v2 in _fields(buf, *entry):
          if f2 == 1 and w2 == 2:
            key = buf[v2[0]:v2[1]].decode('utf-8', 'surrogateescape')
          elif f2 == 2 and w2 == 2:
            feature = v2
        if key in kinds and feature is not None:
          out[key] = _feature_values(buf, *feature, kinds[key], key)
  except ValueError as e:
    if any(str(e).startswith(f'{k}:') for k in kinds):
      raise
    raise ValueError('malformed Example') from e
  return out


def parse_batch(records: Sequence[bytes], named) -> Dict[str, object]:
  """The C++ parser's plain version: ``{output key: value}`` for a batch,
  numeric features as numpy ``[B, *spec.shape]`` (varlen ones padded with
  ``varlen_default_value`` or clipped), bytes features as one ``bytes``
  per example (``b''`` when absent)."""
  kinds = {}
  fields = []
  for out_key, name, spec in named:
    kind, flat = feature_kind(spec)
    kinds[name] = kind
    fields.append((out_key, name, spec, kind, flat))
  batch = len(records)
  out: Dict[str, object] = {}
  buffers = {}
  for out_key, name, spec, kind, flat in fields:
    pad = spec.varlen_default_value
    if kind == KIND_BYTES:
      buffers[out_key] = [b''] * batch
    elif kind == KIND_FLOAT:
      buffers[out_key] = np.full((batch, flat), pad or 0.0, np.float32)
    else:
      buffers[out_key] = np.full((batch, flat), int(pad or 0), np.int64)
  for b, record in enumerate(records):
    try:
      decoded = decode_example(record, kinds)
    except ValueError as e:
      if 'malformed Example' in str(e):
        raise ValueError(f'malformed Example at batch index {b}') from e
      raise
    for out_key, name, spec, kind, flat in fields:
      required = spec.varlen_default_value is None and not spec.is_optional
      values = decoded.get(name)
      if values is None:
        if required:
          raise ValueError(f'{name}: required feature missing')
        continue
      if not values and required:
        raise ValueError(f'{name}: required feature empty/missing')
      if (spec.varlen_default_value is None and values and
          len(values) != flat):
        raise ValueError(f'{name}: expected {flat} values, got '
                         f'{len(values)}')
      values = values[:flat]
      if kind == KIND_BYTES:
        if values:
          offset, length = values[0]
          buffers[out_key][b] = bytes(record[offset:offset + length])
      else:
        buffers[out_key][b, :len(values)] = values
  for out_key, name, spec, kind, flat in fields:
    value = buffers[out_key]
    out[out_key] = value if kind == KIND_BYTES else as_spec_array(
        value, spec, batch)
  return out


def as_spec_array(flat: np.ndarray, spec: TensorSpec, batch: int):
  """A parsed [B, n] buffer reshaped to ``[B, *spec.shape]`` in the spec's
  dtype: numpy, or a torch tensor for bfloat16, which numpy cannot hold."""
  shaped = flat.reshape((batch,) + tuple(spec.shape))
  if spec.dtype == bfloat16:
    return torch.from_numpy(shaped).to(bfloat16)
  return shaped.astype(to_numpy_dtype(spec.dtype), copy=False)


# -------------------------------------------------------------- encoding


def _put_varint(out: bytearray, value: int) -> None:
  value &= 0xffffffffffffffff
  while True:
    b = value & 0x7f
    value >>= 7
    if value:
      out.append(b | 0x80)
    else:
      out.append(b)
      return


def _put_bytes(out: bytearray, field: int, payload: bytes) -> None:
  _put_varint(out, (field << 3) | 2)
  _put_varint(out, len(payload))
  out += payload


def _feature_bytes(kind: int, values) -> bytes:
  inner = bytearray()
  if kind == KIND_BYTES:
    for blob in values:
      _put_bytes(inner, 1, bytes(blob))
    field = 1
  elif kind == KIND_FLOAT:
    packed = np.asarray(values, '<f4').tobytes()
    if packed:
      _put_bytes(inner, 1, packed)
    field = 2
  else:
    packed = bytearray()
    for v in np.asarray(values, np.int64).tolist():
      _put_varint(packed, v)
    if packed:
      _put_bytes(inner, 1, bytes(packed))
    field = 3
  feature = bytearray()
  _put_bytes(feature, field, bytes(inner))
  return bytes(feature)


def encode_features(features: Dict[str, Tuple[int, object]]) -> bytes:
  """One serialized tf.Example from ``{name: (wire kind, values)}``."""
  feats = bytearray()
  for name in sorted(features):
    kind, values = features[name]
    entry = bytearray()
    _put_bytes(entry, 1, name.encode())
    _put_bytes(entry, 2, _feature_bytes(kind, values))
    _put_bytes(feats, 1, bytes(entry))
  example = bytearray()
  _put_bytes(example, 1, bytes(feats))
  return bytes(example)


def encode_example(spec_struct, numpy_struct, png_level: int = 6) -> bytes:
  """Encodes ONE example (no batch dim) as a serialized tf.Example.

  Values are keyed by spec path and written under the spec's name: float
  specs as a FloatList (float32), integer and bool specs as an Int64List,
  image specs as a BytesList of one PNG (``image_codec.encode_png`` at
  zlib level ``png_level``; a JPEG-declared spec reads it back too, since
  the decoder goes by the bytes). A varlen spec's value may have any
  length. A missing optional spec is skipped; a missing required one
  raises."""
  flat_spec = algebra.flatten_spec_structure(spec_struct)
  flat_values = algebra.flatten_spec_structure(numpy_struct)
  features: Dict[str, Tuple[int, object]] = {}
  for key, spec in flat_spec.items():
    spec = TensorSpec.to_spec(spec)
    if key not in flat_values:
      if spec.is_optional:
        continue
      raise ValueError(f'Missing value for required spec {key!r}.')
    kind, _ = feature_kind(spec)
    value = flat_values[key]
    if isinstance(value, torch.Tensor):
      value = value.detach().cpu().float().numpy() if (
          value.dtype == bfloat16) else value.detach().cpu().numpy()
    value = np.asarray(value)
    if kind == KIND_BYTES:
      values: object = [image_codec.encode_png(value, png_level)]
    else:
      values = value.reshape(-1)
    features[spec.name or key.split('/')[-1]] = (kind, values)
  return encode_features(features)


def decode_values(named, parsed: Dict[str, object],
                  image_out: Optional[Dict[str, np.ndarray]] = None,
                  decode_workers: int = 0
                  ) -> Tuple[SpecStruct, SpecStruct]:
  """(features, labels) SpecStructs from a parsed batch: image bytes
  decoded by ``image_codec`` (into ``image_out[out_key]`` when given)."""
  feats, labels = SpecStruct(), SpecStruct()
  for out_key, _, spec in named:
    value = parsed[out_key]
    if is_encoded_image(spec):
      value = image_codec.decode_image_batch(
          value, tuple(spec.shape), to_numpy_dtype(spec.dtype),
          out=None if image_out is None else image_out.get(out_key),
          workers=decode_workers, key=out_key[2:])
    (feats if out_key.startswith('f/') else labels)[out_key[2:]] = value
  return feats, labels


def make_plain_parse_fn(feature_spec, label_spec=None):
  """``parse_fn(records) -> (features, labels)`` on the plain decoder:
  the reference the C++ parse fn of ``data/native_io.py`` is held to."""
  named = named_specs(feature_spec, label_spec)
  flat_f = algebra.flatten_spec_structure(feature_spec)
  flat_l = (None if label_spec is None else
            algebra.flatten_spec_structure(label_spec))

  def parse_fn(records) -> Tuple[SpecStruct, Optional[SpecStruct]]:
    feats, labels = decode_values(named, parse_batch(list(records), named))
    features = algebra.pack_flat_sequence_to_spec_structure(flat_f, feats)
    if flat_l is None:
      return features, None
    return features, algebra.pack_flat_sequence_to_spec_structure(
        flat_l, labels)

  return parse_fn
