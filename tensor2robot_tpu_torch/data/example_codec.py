"""tf.Example and tf.SequenceExample on the wire: the port's own encoder
and decoder, without TF.

The port's counterpart of ``tensor2robot_tpu/data/example_codec.py``,
which goes through TensorFlow's protobuf. The schema, as protobuf field
numbers:

    Example         {1: Features}
    SequenceExample {1: Features (context), 2: FeatureLists}
    Features        {1: map<string, Feature>}  (entries {1: key, 2: value})
    FeatureLists    {1: map<string, FeatureList {1: Feature*}>}
    Feature         {1: BytesList {1: bytes*},
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
*paths*, as the JAX codec addresses them:

* an encoded-image spec [H, W, C] is one blob, and [T, H, W, C] (an
  episode's frames) a BytesList of exactly T blobs; an empty blob decodes
  to zeros;
* a sequence spec (``is_sequence``) is a FeatureList of one Feature a
  step, parsed with ``tf.io.parse_sequence_example``'s semantics: padded
  with zeros to the batch's longest list, its counts as
  ``<key>_length`` int64, a missing list an error;
* a spec with a ``dataset_key`` is read from that dataset's stream of a
  zipped multi-dataset batch (:func:`make_parse_fn`).
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


def is_encoded_image(spec: TensorSpec) -> bool:
  return spec.data_format is not None


def feature_kind(spec: TensorSpec) -> Tuple[int, int]:
  """(wire kind, values per example, or per step of a sequence spec). An
  encoded-image spec is a bytes feature of one blob for [H, W, C], and
  of T blobs for a context spec [T, H, W, C] (an episode's frames)."""
  if is_encoded_image(spec):
    if len(spec.shape) == 3:
      return KIND_BYTES, 1
    if len(spec.shape) == 4 and not spec.is_sequence and (
        spec.shape[0] is not None):
      return KIND_BYTES, int(spec.shape[0])
    raise ValueError(f'An encoded-image spec is [H, W, C], or [T, H, W, C] '
                     f'outside a sequence: {spec}')
  if spec.is_sequence and spec.varlen_default_value is not None:
    raise ValueError(f'A sequence spec takes no varlen_default_value: {spec}')
  flat = int(np.prod(spec.shape, dtype=np.int64))
  if dtype_name(spec.dtype) in _FLOAT_NAMES:
    return KIND_FLOAT, flat
  if spec.dtype.is_floating_point or spec.dtype.is_complex:
    raise ValueError(f'Cannot hold {spec} in a tf.Example.')
  return KIND_INT64, flat


def named_specs(feature_spec, label_spec=None, dataset_key: str = ''):
  """``(output key, on-disk name, spec)`` of every feature (``f/`` keys)
  and label (``l/`` keys) that the stream ``dataset_key`` holds, in the
  order of the flat spec structures. The single stream ('') holds every
  spec, and a spec routed to a dataset raises there: it needs a
  ``dataset_map``. A sequence spec's parse adds ``<output key>_length``."""
  named = []
  for prefix, spec_struct in (('f/', feature_spec), ('l/', label_spec)):
    if spec_struct is None:
      continue
    for key, spec in algebra.flatten_spec_structure(spec_struct).items():
      if not dataset_key and spec.dataset_key:
        raise ValueError(f'{key} is read from dataset {spec.dataset_key!r}: '
                         'give the generator a dataset_map.')
      if dataset_key and spec.dataset_key != dataset_key:
        continue
      feature_kind(spec)
      named.append((prefix + key, spec.name or key.split('/')[-1], spec))
  return named


def dataset_keys(feature_spec, label_spec=None):
  """The sorted dataset keys the specs route to ('' for none)."""
  keys = set()
  for spec_struct in (feature_spec, label_spec):
    if spec_struct is not None:
      keys.update(spec.dataset_key or '' for spec in
                  algebra.flatten_spec_structure(spec_struct).values())
  return sorted(keys)


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


def _map_entries(buf: bytes, start: int, end: int):
  """(key, (start, end) of the value) of each entry of the map that is
  field 1 of a message (Features, FeatureLists)."""
  for f1, w1, entry in _fields(buf, start, end):
    if f1 != 1 or w1 != 2:
      continue
    key, value = None, None
    for f2, w2, v2 in _fields(buf, *entry):
      if f2 == 1 and w2 == 2:
        key = buf[v2[0]:v2[1]].decode('utf-8', 'surrogateescape')
      elif f2 == 2 and w2 == 2:
        value = v2
    yield key, value


def decode_sequence_example(serialized: bytes, kinds: Dict[str, int],
                            sequence_kinds: Optional[Dict[str, int]] = None
                            ) -> Tuple[Dict[str, list], Dict[str, list]]:
  """``({name: values}, {name: [values of each step]})``: the context
  features that ``kinds`` asks for and the feature lists that
  ``sequence_kinds`` asks for ({name: wire kind}) of one serialized
  tf.Example or tf.SequenceExample (field 1 of both holds the features);
  a later map entry of the same name replaces an earlier one."""
  buf = bytes(serialized)
  sequence_kinds = sequence_kinds or {}
  context: Dict[str, list] = {}
  lists: Dict[str, list] = {}
  names = list(kinds) + list(sequence_kinds)
  try:
    for field, wire, value in _fields(buf, 0, len(buf)):
      if field == 1 and wire == 2:
        for key, feature in _map_entries(buf, *value):
          if key in kinds and feature is not None:
            context[key] = _feature_values(buf, *feature, kinds[key], key)
      elif field == 2 and wire == 2 and sequence_kinds:
        for key, steps in _map_entries(buf, *value):
          if key not in sequence_kinds or steps is None:
            continue
          lists[key] = [
              _feature_values(buf, *step, sequence_kinds[key], key)
              for f, w, step in _fields(buf, *steps) if f == 1 and w == 2]
  except ValueError as e:
    if any(str(e).startswith(f'{k}:') for k in names):
      raise
    raise ValueError('malformed Example') from e
  return context, lists


def parse_batch(records: Sequence[bytes], named) -> Dict[str, object]:
  """The C++ parser's plain version: ``{output key: value}`` for a batch,
  numeric features as numpy ``[B, *spec.shape]`` (varlen ones padded with
  ``varlen_default_value`` or clipped), bytes features as a flat list of
  ``B * count`` blobs (``b''`` where absent). A sequence spec's steps,
  padded to the batch's longest list with zeros (or ``b''``), come as
  ``[B, T, *spec.shape]`` (or ``B * T`` blobs), with their counts as
  ``<output key>_length``, int64 ``[B]``: ``tf.io.parse_sequence_example``'s
  semantics, a missing list an error."""
  kinds, sequence_kinds = {}, {}
  fields = []
  for out_key, name, spec in named:
    kind, count = feature_kind(spec)
    (sequence_kinds if spec.is_sequence else kinds)[name] = kind
    fields.append((out_key, name, spec, kind, count))
  batch = len(records)
  out: Dict[str, object] = {}
  buffers = {}
  steps = {}
  for out_key, name, spec, kind, count in fields:
    pad = spec.varlen_default_value
    if spec.is_sequence:
      steps[out_key] = [None] * batch
    elif kind == KIND_BYTES:
      buffers[out_key] = [b''] * (batch * count)
    elif kind == KIND_FLOAT:
      buffers[out_key] = np.full((batch, count), pad or 0.0, np.float32)
    else:
      buffers[out_key] = np.full((batch, count), int(pad or 0), np.int64)
  for b, record in enumerate(records):
    try:
      decoded, lists = decode_sequence_example(record, kinds, sequence_kinds)
    except ValueError as e:
      if 'malformed Example' in str(e):
        raise ValueError(f'malformed Example at batch index {b}') from e
      raise
    for out_key, name, spec, kind, count in fields:
      if spec.is_sequence:
        if name not in lists:
          raise ValueError(f'{name}: feature list missing')
        for t, values in enumerate(lists[name]):
          if len(values) != count:
            raise ValueError(f'{name}: step {t} has {len(values)} values, '
                             f'expected {count}')
        steps[out_key][b] = lists[name]
        continue
      required = spec.varlen_default_value is None and not spec.is_optional
      values = decoded.get(name)
      if values is None:
        if required:
          raise ValueError(f'{name}: required feature missing')
        continue
      if not values and required:
        raise ValueError(f'{name}: required feature empty/missing')
      if (spec.varlen_default_value is None and values and
          len(values) != count):
        raise ValueError(f'{name}: expected {count} values, got '
                         f'{len(values)}')
      values = values[:count]
      if kind == KIND_BYTES:
        for j, (offset, length) in enumerate(values):
          buffers[out_key][b * count + j] = bytes(
              record[offset:offset + length])
      else:
        buffers[out_key][b, :len(values)] = values
  for out_key, name, spec, kind, count in fields:
    if spec.is_sequence:
      lengths = np.asarray([len(s) for s in steps[out_key]], np.int64)
      longest = int(lengths.max()) if batch else 0
      if kind == KIND_BYTES:
        blobs = [b''] * (batch * longest)
        for b, record in enumerate(records):
          for t, ((offset, length),) in enumerate(steps[out_key][b]):
            blobs[b * longest + t] = bytes(record[offset:offset + length])
        out[out_key] = blobs
      else:
        value = np.zeros((batch, longest, count),
                         np.float32 if kind == KIND_FLOAT else np.int64)
        for b, rows in enumerate(steps[out_key]):
          if rows:
            value[b, :len(rows)] = rows
        out[out_key] = as_spec_array(value, spec, batch, (longest,))
      out[out_key + '_length'] = lengths
      continue
    value = buffers[out_key]
    out[out_key] = value if kind == KIND_BYTES else as_spec_array(
        value, spec, batch)
  return out


def as_spec_array(flat: np.ndarray, spec: TensorSpec, batch: int,
                  steps: Tuple[int, ...] = ()):
  """A parsed [B, n] (or a sequence's [B, T, n]) buffer reshaped to
  ``[B, *steps, *spec.shape]`` in the spec's dtype: numpy, or a torch
  tensor for bfloat16, which numpy cannot hold."""
  shaped = flat.reshape((batch,) + tuple(steps) + tuple(spec.shape))
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


def _features_bytes(features: Dict[str, Tuple[int, object]]) -> bytes:
  """A Features message from ``{name: (wire kind, values)}``."""
  feats = bytearray()
  for name in sorted(features):
    kind, values = features[name]
    entry = bytearray()
    _put_bytes(entry, 1, name.encode())
    _put_bytes(entry, 2, _feature_bytes(kind, values))
    _put_bytes(feats, 1, bytes(entry))
  return bytes(feats)


def encode_features(features: Dict[str, Tuple[int, object]],
                    feature_lists: Optional[Dict[str, Tuple[int, list]]] = None
                    ) -> bytes:
  """One serialized tf.Example from ``{name: (wire kind, values)}``, or,
  with ``feature_lists`` (``{name: (wire kind, [values of each step])}``),
  one tf.SequenceExample whose context is ``features``."""
  example = bytearray()
  _put_bytes(example, 1, _features_bytes(features))
  if feature_lists is not None:
    lists = bytearray()
    for name in sorted(feature_lists):
      kind, steps = feature_lists[name]
      feature_list = bytearray()
      for values in steps:
        _put_bytes(feature_list, 1, _feature_bytes(kind, values))
      entry = bytearray()
      _put_bytes(entry, 1, name.encode())
      _put_bytes(entry, 2, bytes(feature_list))
      _put_bytes(lists, 1, bytes(entry))
    _put_bytes(example, 2, bytes(lists))
  return bytes(example)


def _wire_values(kind: int, value: np.ndarray, png_level: int):
  if kind != KIND_BYTES:
    return value.reshape(-1)
  if value.ndim == 4:
    return [image_codec.encode_png(image, png_level) for image in value]
  return [image_codec.encode_png(value, png_level)]


def encode_example(spec_struct, numpy_struct, png_level: int = 6) -> bytes:
  """Encodes ONE example (no batch dim) as a serialized tf.Example, or as a
  tf.SequenceExample when a spec is a sequence.

  Values are keyed by spec path and written under the spec's name: float
  specs as a FloatList (float32), integer and bool specs as an Int64List,
  image specs as a BytesList of PNGs (``image_codec.encode_png`` at zlib
  level ``png_level``), one an image, T for a [T, H, W, C] spec; a
  JPEG-declared spec reads them back too, since the decoder goes by the
  bytes. A sequence spec's value has a leading step dim, each step one
  Feature of its FeatureList. A varlen spec's value may have any length.
  A missing optional spec is skipped; a missing required one raises."""
  flat_spec = algebra.flatten_spec_structure(spec_struct)
  flat_values = algebra.flatten_spec_structure(numpy_struct)
  features: Dict[str, Tuple[int, object]] = {}
  feature_lists: Dict[str, Tuple[int, list]] = {}
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
    name = spec.name or key.split('/')[-1]
    if spec.is_sequence:
      feature_lists[name] = (kind, [_wire_values(kind, step, png_level)
                                    for step in value])
    else:
      features[name] = (kind, _wire_values(kind, value, png_level))
  return encode_features(features, feature_lists or None)


def image_lead(spec: TensorSpec, batch: int, blobs: int) -> Tuple[int, ...]:
  """The leading dims of a parsed image feature's decoded batch: [B] for
  an image, [B, T] for an episode's frames or a sequence's steps."""
  if len(spec.shape) == 4:
    return (batch, int(spec.shape[0]))
  if spec.is_sequence:
    return (batch, blobs // batch if batch else 0)
  return (batch,)


def decode_values(named, parsed: Dict[str, object], batch: int,
                  image_out: Optional[Dict[str, np.ndarray]] = None,
                  decode_workers: int = 0
                  ) -> Tuple[SpecStruct, SpecStruct]:
  """(features, labels) flat SpecStructs from a parsed batch of ``batch``
  examples, sequence lengths included: image blobs decoded by
  ``image_codec`` into one ``[*lead, H, W, C]`` buffer a feature
  (``image_out[out_key]`` when given)."""
  feats, labels = SpecStruct(), SpecStruct()
  for out_key, _, spec in named:
    value = parsed[out_key]
    if is_encoded_image(spec):
      lead = image_lead(spec, batch, len(value))
      shape = tuple(int(d) for d in spec.shape[-3:])
      out = None if image_out is None else image_out.get(out_key)
      if out is None:
        out = np.empty(lead + shape, to_numpy_dtype(spec.dtype))
      image_codec.decode_image_batch(
          value, shape, to_numpy_dtype(spec.dtype),
          out=out.reshape((-1,) + shape), workers=decode_workers,
          key=out_key[2:])
      value = out
    target = feats if out_key.startswith('f/') else labels
    target[out_key[2:]] = value
    if spec.is_sequence:
      target[out_key[2:] + '_length'] = parsed[out_key + '_length']
  return feats, labels


def pack(flat_spec, values):
  """Packs parsed values into ``flat_spec`` with its sequence-length specs
  (``algebra.add_sequence_length_specs``), as the JAX codec packs."""
  return algebra.pack_flat_sequence_to_spec_structure(
      algebra.add_sequence_length_specs(flat_spec), values)


def streams_of(records) -> Dict[str, list]:
  """``{dataset_key: records}`` of a batch: a dict of record lists, a list
  of ``{dataset_key: record}`` examples (zipped streams), or a list of
  records (the single stream, '')."""
  if isinstance(records, dict):
    return {key: list(value) for key, value in records.items()}
  records = list(records)
  if records and isinstance(records[0], dict):
    return {key: [r[key] for r in records] for key in records[0]}
  return {'': records}


def make_parse_fn(feature_spec, label_spec=None, parser_factory=None,
                  decode_workers: int = 0):
  """``parse_fn(records, image_out=None) -> (features, labels)``: each
  dataset's stream (``streams_of``) parsed by a parser of its named specs
  (``parser_factory(named).parse_batch``; the plain decoder by default),
  then decoded and packed. A spec routed to a dataset is read from that
  dataset's stream under its own name, as the JAX codec's
  ``make_parse_fn`` reads a ``{dataset_key: serialized}`` dict."""
  plans = {key: named_specs(feature_spec, label_spec, key)
           for key in dataset_keys(feature_spec, label_spec)}
  if parser_factory is None:
    parsers = {key: (lambda records, named=named: parse_batch(records, named))
               for key, named in plans.items()}
    get_parser = parsers.__getitem__
  else:
    get_parser = lambda key: parser_factory(key, plans[key])
  flat_f = algebra.flatten_spec_structure(feature_spec)
  flat_l = (None if label_spec is None else
            algebra.flatten_spec_structure(label_spec))

  def parse_fn(records, image_out=None
               ) -> Tuple[SpecStruct, Optional[SpecStruct]]:
    streams = streams_of(records)
    if sorted(streams) != sorted(plans):
      raise ValueError(f'records of datasets {sorted(streams)}, the specs '
                       f'read {sorted(plans)}')
    feats, labels = SpecStruct(), SpecStruct()
    for key, stream in streams.items():
      f, l = decode_values(plans[key], get_parser(key)(stream), len(stream),
                           image_out=image_out,
                           decode_workers=decode_workers)
      feats.update(f)
      labels.update(l)
    features = pack(flat_f, feats)
    if flat_l is None:
      return features, None
    return features, pack(flat_l, labels)

  parse_fn.plans = plans
  return parse_fn


def make_plain_parse_fn(feature_spec, label_spec=None):
  """``parse_fn(records) -> (features, labels)`` on the plain decoder:
  the reference the C++ parse fn of ``data/native_io.py`` is held to."""
  return make_parse_fn(feature_spec, label_spec)
