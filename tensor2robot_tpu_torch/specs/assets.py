"""T2RAssets: the spec contract that travels with every export, the port's
counterpart of ``tensor2robot_tpu/specs/assets.py``.

Each export version carries ``assets.extra/t2r_assets.pbtxt``: the
feature spec, the label spec and the global step, so a predictor can
rebuild the input contract without the model's code. The file is the
protobuf text format of the ``T2RAssets`` message of
``tensor2robot_tpu/proto/t2r.proto``, written and parsed here without
protobuf, in the layout ``text_format.MessageToString`` gives it (fields
in number order, map entries sorted by key, proto3 defaults left out), so
the JAX package's ``load_specs_from_export_dir`` reads the port's file
and the port reads the JAX package's. A JSON twin
(``t2r_assets.json``) is written beside it for proto-free consumers.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from tensor2robot_tpu_torch.specs.spec_struct import SpecStruct
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec

EXTRA_ASSETS_DIRECTORY = 'assets.extra'
T2R_ASSETS_FILENAME = 't2r_assets.pbtxt'
T2R_ASSETS_JSON_FILENAME = 't2r_assets.json'

# The scalar fields of ExtendedTensorSpec, by their text-format kind.
_STRING_FIELDS = ('dtype', 'name', 'data_format', 'dataset_key')
_BOOL_FIELDS = ('is_optional', 'is_extracted', 'has_varlen_default_value',
                'is_sequence')
_REPEATED_FIELDS = ('shape',)


def _quote(text: str) -> str:
  """A text-format string literal (C escapes, as protobuf writes them)."""
  out = []
  for byte in text.encode('utf-8'):
    char = chr(byte)
    if char in '"\\\'':
      out.append('\\' + char)
    elif char == '\n':
      out.append('\\n')
    elif 32 <= byte < 127:
      out.append(char)
    else:
      out.append(f'\\{byte:03o}')
  return '"' + ''.join(out) + '"'


def _float_text(value: float) -> str:
  """The shortest text that reads back as the same float32."""
  return np.format_float_positional(np.float32(value), unique=True,
                                    trim='-')


def _spec_lines(spec: TensorSpec, indent: str) -> List[str]:
  lines = []
  for field, value in spec.to_proto_fields().items():
    if field in _REPEATED_FIELDS:
      lines.extend(f'{indent}{field}: {int(v)}' for v in value)
    elif field in _STRING_FIELDS:
      lines.append(f'{indent}{field}: {_quote(value)}')
    elif field in _BOOL_FIELDS:
      lines.append(f'{indent}{field}: true')
    else:
      lines.append(f'{indent}{field}: {_float_text(value)}')
  return lines


def _struct_lines(name: str, struct: SpecStruct) -> List[str]:
  lines = [f'{name} {{']
  for key, spec in sorted(struct.spec_items()):
    lines.append('  key_value {')
    lines.append(f'    key: {_quote(key)}')
    lines.append('    value {')
    lines.extend(_spec_lines(spec, '      '))
    lines.append('    }')
    lines.append('  }')
  lines.append('}')
  return lines


def t2r_assets_text(feature_spec: Optional[SpecStruct],
                    label_spec: Optional[SpecStruct],
                    global_step: int = 0) -> str:
  """The text format of a ``T2RAssets`` message; a spec that is None is
  left unset, as the JAX package leaves it."""
  lines: List[str] = []
  if feature_spec is not None:
    lines.extend(_struct_lines('feature_spec', feature_spec))
  if label_spec is not None:
    lines.extend(_struct_lines('label_spec', label_spec))
  if int(global_step):
    lines.append(f'global_step: {int(global_step)}')
  return '\n'.join(lines) + '\n' if lines else ''


_TOKEN = re.compile(r'\s*(?:(#[^\n]*)|([A-Za-z_][A-Za-z0-9_]*)|'
                    r'("(?:[^"\\\n]|\\.)*")|'
                    r'([-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|\.\d+(?:[eE][-+]?\d+)?|'
                    r'inf|nan))|([{}:]))')


def _tokens(text: str) -> List[Tuple[str, str]]:
  tokens, pos = [], 0
  text = text.rstrip()
  while pos < len(text):
    match = _TOKEN.match(text, pos)
    if match is None:
      raise ValueError(f'Cannot parse T2RAssets text at {text[pos:pos + 40]!r}')
    pos = match.end()
    comment, ident, string, number, punct = match.groups()
    if comment is not None:
      continue
    if ident is not None:
      tokens.append(('ident', ident))
    elif string is not None:
      tokens.append(('string', _unquote(string)))
    elif number is not None:
      tokens.append(('number', number))
    else:
      tokens.append(('punct', punct))
  return tokens


def _unquote(literal: str) -> str:
  body = literal[1:-1]
  raw = bytearray()
  i = 0
  while i < len(body):
    char = body[i]
    if char != '\\':
      raw.extend(char.encode('utf-8'))
      i += 1
      continue
    nxt = body[i + 1]
    if nxt in '01234567':
      digits = re.match(r'[0-7]{1,3}', body[i + 1:]).group(0)
      raw.append(int(digits, 8))
      i += 1 + len(digits)
    elif nxt == 'x':
      digits = re.match(r'[0-9a-fA-F]{1,2}', body[i + 2:]).group(0)
      raw.append(int(digits, 16))
      i += 2 + len(digits)
    else:
      raw.extend({'n': b'\n', 't': b'\t', 'r': b'\r'}.get(
          nxt, nxt.encode('utf-8')))
      i += 2
  return raw.decode('utf-8')


def _parse_message(tokens, pos: int, close: Optional[str]):
  """Fields of one message up to its closing brace: {name: [values]}."""
  fields: Dict[str, list] = {}
  while pos < len(tokens):
    kind, value = tokens[pos]
    if kind == 'punct' and value == close:
      return fields, pos + 1
    if kind != 'ident':
      raise ValueError(f'Expected a field name, got {value!r}')
    name = value
    pos += 1
    if tokens[pos] == ('punct', ':'):
      pos += 1
    kind, value = tokens[pos]
    if kind == 'punct' and value == '{':
      sub, pos = _parse_message(tokens, pos + 1, '}')
      fields.setdefault(name, []).append(sub)
      continue
    fields.setdefault(name, []).append((kind, value))
    pos += 1
  if close is not None:
    raise ValueError('Unterminated message in T2RAssets text.')
  return fields, pos


def _scalar(field: str, token):
  kind, value = token
  if field in _STRING_FIELDS:
    return value
  if field in _BOOL_FIELDS:
    return value in ('true', 't', '1', 'True')
  if field in _REPEATED_FIELDS or field in ('global_step', 'key'):
    return value if kind == 'string' else int(value)
  return float(value)


def _struct_from_fields(fields: Dict[str, list]) -> SpecStruct:
  items = []
  for entry in fields.get('key_value', []):
    key = _scalar('key', entry['key'][-1])
    spec_fields = {}
    for field, values in (entry.get('value') or [{}])[-1].items():
      if field in _REPEATED_FIELDS:
        spec_fields[field] = [_scalar(field, v) for v in values]
      else:
        spec_fields[field] = _scalar(field, values[-1])
    items.append((key, TensorSpec.from_proto_fields(spec_fields)))
  return SpecStruct(sorted(items))


def parse_t2r_assets_text(text: str) -> Tuple[SpecStruct, SpecStruct, int]:
  """(feature_spec, label_spec, global_step) of a ``T2RAssets`` text; an
  unset spec reads as an empty SpecStruct, as protobuf reads it."""
  fields, _ = _parse_message(_tokens(text), 0, None)
  step = fields.get('global_step')
  return (_struct_from_fields((fields.get('feature_spec') or [{}])[-1]),
          _struct_from_fields((fields.get('label_spec') or [{}])[-1]),
          int(_scalar('global_step', step[-1])) if step else 0)


def write_assets_to_export_dir(export_dir: str,
                               feature_spec: SpecStruct,
                               label_spec: Optional[SpecStruct],
                               global_step: int = 0) -> str:
  """Writes ``assets.extra/t2r_assets.pbtxt`` (the text format) and its
  JSON twin under an export dir; returns the path of the text file."""
  assets_dir = os.path.join(export_dir, EXTRA_ASSETS_DIRECTORY)
  os.makedirs(assets_dir, exist_ok=True)
  path = os.path.join(assets_dir, T2R_ASSETS_FILENAME)
  with open(path, 'w') as f:
    f.write(t2r_assets_text(feature_spec, label_spec, global_step))
  json_twin = {
      'feature_spec': (feature_spec or SpecStruct()).to_json_dict(),
      'label_spec': (label_spec or SpecStruct()).to_json_dict(),
      'global_step': int(global_step),
  }
  with open(os.path.join(assets_dir, T2R_ASSETS_JSON_FILENAME), 'w') as f:
    json.dump(json_twin, f, indent=2, sort_keys=True)
  return path


def load_specs_from_export_dir(
    export_dir: str) -> Tuple[SpecStruct, SpecStruct, int]:
  """(feature_spec, label_spec, global_step) of an export dir."""
  path = os.path.join(export_dir, EXTRA_ASSETS_DIRECTORY, T2R_ASSETS_FILENAME)
  with open(path) as f:
    return parse_t2r_assets_text(f.read())
