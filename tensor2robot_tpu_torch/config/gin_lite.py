"""gin_lite: a gin-config-compatible dependency-injection engine; the
port's own copy of ``tensor2robot_tpu/config/gin_lite.py`` (pure Python).

Binaries parse ``.gin`` files and call one function; an experiment is a
config file binding models, input generators and run parameters. This
module implements the subset of gin the framework needs, with gin's file
syntax:

* ``Name.param = value`` — bind a constructor/function parameter.
* ``scope/Name.param = value`` — scoped binding (overrides the unscoped one
  when the callable is invoked via ``@scope/Name`` or inside that scope).
* ``MACRO = value`` and ``%MACRO`` — macros.
* ``@Name`` — reference to the configured callable (injected as-is).
* ``@Name()`` / ``@scope/Name()`` — evaluated at injection time.
* ``#`` comments, multi-line values via bracket continuation.

Python API mirrors gin: ``configurable``, ``external_configurable``,
``parse_config``, ``parse_config_files_and_bindings``, ``bind_parameter``,
``query_parameter``, ``operative_config_str``, ``clear_config``.
"""

from __future__ import annotations

import ast
import functools
import inspect
import io
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

_REGISTRY: Dict[str, Callable] = {}  # GUARDED_BY(_LOCK)
_BINDINGS: Dict[Tuple[str, str], Dict[str, Any]] = {}  # (scope,name) → params  # GUARDED_BY(_LOCK)
_MACROS: Dict[str, Any] = {}  # GUARDED_BY(_LOCK)
_OPERATIVE: Dict[str, Dict[str, Any]] = {}  # GUARDED_BY(_LOCK)
_LOCK = threading.RLock()
_SCOPE_STACK = threading.local()


class ConfigError(Exception):
  pass


def _scopes() -> List[str]:
  if not hasattr(_SCOPE_STACK, 'stack'):
    _SCOPE_STACK.stack = []
  return _SCOPE_STACK.stack


class _ScopeContext:
  def __init__(self, scope: str):
    self._scope = scope

  def __enter__(self):
    _scopes().append(self._scope)
    return self

  def __exit__(self, *exc):
    _scopes().pop()


def config_scope(scope: str) -> _ScopeContext:
  return _ScopeContext(scope)


# ------------------------------------------------------------------ registry


def _register(name: str, wrapped: Callable) -> None:
  with _LOCK:
    if name in _REGISTRY and _REGISTRY[name] is not wrapped:
      raise ConfigError(f'A configurable named {name!r} already exists.')
    _REGISTRY[name] = wrapped


def configurable(name_or_fn=None, module: Optional[str] = None):
  """Decorator registering a function/class as configurable (gin API)."""

  def decorate(fn, name=None):
    reg_name = name or fn.__name__
    if module:
      reg_name = f'{module}.{reg_name}'
    wrapped = _make_configurable(fn, reg_name)
    _register(reg_name, wrapped)
    # Classes are returned as-is (their __init__ wrapper is what the
    # registry holds); functions return the wrapper so direct calls also
    # receive bindings — same behavior as gin.
    return wrapped

  if callable(name_or_fn):
    return decorate(name_or_fn)
  return lambda fn: decorate(fn, name=name_or_fn)


def external_configurable(fn, name: Optional[str] = None,
                          module: Optional[str] = None):
  """Registers a callable defined elsewhere (gin.external_configurable)."""
  reg_name = name or fn.__name__
  if module:
    reg_name = f'{module}.{reg_name}'
  wrapped = _make_configurable(fn, reg_name)
  _register(reg_name, wrapped)
  return wrapped


def _make_configurable(fn: Callable, name: str) -> Callable:
  if inspect.isclass(fn):
    orig_init = fn.__init__

    @functools.wraps(orig_init)
    def init_wrapper(self, *args, **kwargs):
      merged = _merged_params(name, kwargs, orig_init, args)
      orig_init(self, *args, **merged)

    try:
      fn.__init__ = init_wrapper
    except TypeError as e:  # builtins
      raise ConfigError(f'Cannot make {fn} configurable: {e}')
    return fn

  @functools.wraps(fn)
  def wrapper(*args, **kwargs):
    merged = _merged_params(name, kwargs, fn, args)
    return fn(*args, **merged)

  wrapper.__wrapped_configurable__ = fn
  return wrapper


def _merged_params(name: str, kwargs: Dict[str, Any], fn: Callable,
                   args: Tuple) -> Dict[str, Any]:
  bound = _lookup_bindings(name)
  if not bound:
    return kwargs
  merged = dict(kwargs)
  try:
    sig = inspect.signature(fn)
    accepted = set(sig.parameters)
    has_var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                     for p in sig.parameters.values())
    positional = [
        p.name for p in sig.parameters.values()
        if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                      inspect.Parameter.POSITIONAL_OR_KEYWORD)
    ]
    # Account for the bound `self` slot in __init__ wrappers.
    if positional and positional[0] == 'self':
      positional = positional[1:]
    consumed = set(positional[:len(args)])
  except (TypeError, ValueError):
    accepted, has_var_kw, consumed = set(), True, set()
  applied = {}
  for param, value in bound.items():
    if param in merged or param in consumed:
      continue  # caller wins over config
    if not has_var_kw and param not in accepted:
      raise ConfigError(
          f'Configurable {name!r} has no parameter {param!r}.')
    value = _resolve(value)
    merged[param] = value
    applied[param] = value
  if applied:
    with _LOCK:
      _OPERATIVE.setdefault(name, {}).update(applied)
  return merged


def _lookup_bindings(name: str) -> Dict[str, Any]:
  with _LOCK:
    result = dict(_BINDINGS.get(('', name), {}))
    for scope in _scopes():
      result.update(_BINDINGS.get((scope, name), {}))
    return result


# ------------------------------------------------------------------- values


class _Reference:
  """A ``@name`` or ``@scope/name`` (optionally called) value."""

  def __init__(self, name: str, evaluate: bool):
    self.scope, _, self.name = name.rpartition('/')
    self.evaluate = evaluate

  def __repr__(self):
    # gin syntax, so config_str() round-trips through parse_config.
    prefix = f'{self.scope}/' if self.scope else ''
    return f'@{prefix}{self.name}' + ('()' if self.evaluate else '')

  def resolve(self):
    with _LOCK:
      target = _REGISTRY.get(self.name)
    if target is None:
      raise ConfigError(f'No configurable named {self.name!r} registered.')
    if not self.evaluate:
      if self.scope:
        scope = self.scope

        @functools.wraps(target)
        def scoped(*args, **kwargs):
          with config_scope(scope):
            return target(*args, **kwargs)

        return scoped
      return target
    if self.scope:
      with config_scope(self.scope):
        return target()
    return target()


class _Macro:
  def __init__(self, name: str):
    self.name = name

  def __repr__(self):
    # gin syntax, so config_str() round-trips through parse_config.
    return f'%{self.name}'

  def resolve(self):
    with _LOCK:
      if self.name not in _MACROS:
        raise ConfigError(f'Undefined macro %{self.name}.')
      value = _MACROS[self.name]
    return _resolve(value)


def _resolve(value):
  if isinstance(value, (_Reference, _Macro)):
    return value.resolve()
  if isinstance(value, list):
    return [_resolve(v) for v in value]
  if isinstance(value, tuple):
    return tuple(_resolve(v) for v in value)
  if isinstance(value, dict):
    return {k: _resolve(v) for k, v in value.items()}
  return value


# ------------------------------------------------------------------- parser


def _parse_value(text: str):
  text = text.strip()
  if text.startswith('@'):
    body = text[1:].strip()
    if body.endswith('()'):
      return _Reference(body[:-2].strip(), evaluate=True)
    return _Reference(body, evaluate=False)
  if text.startswith('%'):
    return _Macro(text[1:].strip())
  # Containers may hold references/macros: parse elementwise.
  if text and text[0] in '([{':
    try:
      return ast.literal_eval(text)
    except (ValueError, SyntaxError):
      return _parse_container(text)
  try:
    return ast.literal_eval(text)
  except (ValueError, SyntaxError) as e:
    raise ConfigError(f'Cannot parse value: {text!r}') from e


def _split_top_level(text: str) -> List[str]:
  parts, depth, current, in_str = [], 0, [], None
  for ch in text:
    if in_str:
      current.append(ch)
      if ch == in_str:
        in_str = None
      continue
    if ch in '\'"':
      in_str = ch
      current.append(ch)
    elif ch in '([{':
      depth += 1
      current.append(ch)
    elif ch in ')]}':
      depth -= 1
      current.append(ch)
    elif ch == ',' and depth == 0:
      parts.append(''.join(current))
      current = []
    else:
      current.append(ch)
  tail = ''.join(current).strip()
  if tail:
    parts.append(tail)
  return parts


def _parse_container(text: str):
  open_ch, close_ch = text[0], text[-1]
  if (open_ch, close_ch) not in (('(', ')'), ('[', ']'), ('{', '}')):
    raise ConfigError(f'Unbalanced container: {text!r}')
  inner = text[1:-1]
  items = _split_top_level(inner)
  if open_ch == '{':
    out = {}
    for item in items:
      if ':' not in item:
        raise ConfigError(f'Bad dict item: {item!r}')
      k, _, v = item.partition(':')
      out[ast.literal_eval(k.strip())] = _parse_value(v)
    return out
  values = [_parse_value(i) for i in items]
  return tuple(values) if open_ch == '(' else values


def _logical_lines(text: str):
  """Joins bracket/backslash continuations into single logical lines."""
  buffer = ''
  depth = 0
  for raw in io.StringIO(text):
    line = raw.split('#', 1)[0].rstrip('\n').rstrip()
    if not line.strip() and not buffer:
      continue
    if buffer:
      buffer += ' ' + line.strip()
    else:
      buffer = line.strip()
    if buffer.endswith('\\'):
      buffer = buffer[:-1].rstrip()
      continue
    depth = 0
    in_str = None
    for ch in buffer:
      if in_str:
        if ch == in_str:
          in_str = None
      elif ch in '\'"':
        in_str = ch
      elif ch in '([{':
        depth += 1
      elif ch in ')]}':
        depth -= 1
    if depth > 0:
      continue
    yield buffer
    buffer = ''
  if buffer:
    yield buffer


def parse_config(bindings) -> None:
  """Parses a gin config string (or list of binding strings)."""
  if isinstance(bindings, (list, tuple)):
    bindings = '\n'.join(bindings)
  for line in _logical_lines(bindings):
    if line.startswith(('import ', 'include ')):
      # gin files import python modules for registration side effects; our
      # registrations happen at package import, so record & skip.
      continue
    if '=' not in line:
      raise ConfigError(f'Bad config line: {line!r}')
    target, _, value_text = line.partition('=')
    target = target.strip()
    value = _parse_value(value_text)
    if '.' not in target:
      with _LOCK:
        _MACROS[target] = value
      continue
    scoped_name, _, param = target.rpartition('.')
    scope, _, name = scoped_name.rpartition('/')
    with _LOCK:
      _BINDINGS.setdefault((scope, name), {})[param] = value


def parse_config_files_and_bindings(
    config_files: Optional[Sequence[str]] = None,
    bindings: Optional[Sequence[str]] = None) -> None:
  for path in config_files or ():
    with open(path) as f:
      parse_config(f.read())
  if bindings:
    parse_config(list(bindings))


def bind_parameter(target: str, value: Any) -> None:
  scoped_name, _, param = target.rpartition('.')
  scope, _, name = scoped_name.rpartition('/')
  with _LOCK:
    _BINDINGS.setdefault((scope, name), {})[param] = value


def query_parameter(target: str, resolve: bool = False) -> Any:
  """Returns the binding for ``scope/name.param``.

  ``resolve=True`` evaluates macros/references to their values (e.g. a
  ``%model_dir``-bound path resolves to the string) instead of returning
  the raw binding object.
  """
  scoped_name, _, param = target.rpartition('.')
  scope, _, name = scoped_name.rpartition('/')
  with _LOCK:
    if (scope, name) in _BINDINGS and param in _BINDINGS[(scope, name)]:
      value = _BINDINGS[(scope, name)][param]
    else:
      raise ConfigError(f'No binding for {target!r}.')
  return _resolve(value) if resolve else value


def get_configurable(name: str) -> Callable:
  with _LOCK:
    if name not in _REGISTRY:
      raise ConfigError(f'No configurable named {name!r} registered.')
    return _REGISTRY[name]


def operative_config_str() -> str:
  """Bindings actually consumed so far (gin's operative config log)."""
  with _LOCK:
    lines = []
    for name in sorted(_OPERATIVE):
      for param, value in sorted(_OPERATIVE[name].items()):
        lines.append(f'{name}.{param} = {value!r}')
    return '\n'.join(lines)


def config_str() -> str:
  with _LOCK:
    lines = [f'{name} = {value!r}' for name, value in sorted(_MACROS.items())]
    for (scope, name) in sorted(_BINDINGS):
      prefix = f'{scope}/' if scope else ''
      for param, value in sorted(_BINDINGS[(scope, name)].items()):
        lines.append(f'{prefix}{name}.{param} = {value!r}')
    return '\n'.join(lines)


def clear_config() -> None:
  with _LOCK:
    _BINDINGS.clear()
    _MACROS.clear()
    _OPERATIVE.clear()


def clear_registry() -> None:  # test helper
  with _LOCK:
    _REGISTRY.clear()
