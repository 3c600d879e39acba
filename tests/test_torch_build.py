"""The ctypes bindings of the CUDA kernels agree with their C entry points.

The kernels compile only where there is a card, so a mismatch between a
wrapper's ``argtypes`` and the ``extern "C"`` signature in ``csrc/*.cu``
would first show as a refused call on the card. These tests read the C
signatures from the sources and hold every wrapper's binding to them, and
check the build command and its cache key without compiling anything.
"""

import ctypes
import re

import pytest

from tensor2robot_tpu_torch.ops import _build, conv_s2d, pool

_ENTRY = re.compile(r'^int\s+(t2r_\w+)\(([^)]*)\)\s*\{', re.MULTILINE)
_C_TYPES = {'const void*': ctypes.c_void_p, 'void*': ctypes.c_void_p,
            'int': ctypes.c_int}


def _c_entry_points(name):
  """{entry point: [ctypes type of each parameter]} of ``csrc/<name>.cu``."""
  source = (_build.CSRC_DIR / f'{name}.cu').read_text()
  extern = source[source.index('extern "C"'):]
  entries = {}
  for fn_name, params in _ENTRY.findall(extern):
    types = []
    for param in params.split(','):
      c_type = ' '.join(param.split()[:-1]).replace(' *', '*')
      types.append(_C_TYPES[c_type])
    entries[fn_name] = types
  return entries


@pytest.mark.parametrize('name,module', [('pool', pool),
                                         ('conv_s2d', conv_s2d)])
def test_argtypes_match_c_signature(name, module):
  entries = _c_entry_points(name)
  assert set(module._SIGNATURES) <= set(entries)
  for fn_name, argtypes in module._SIGNATURES.items():
    assert list(argtypes) == entries[fn_name], fn_name


def test_every_source_is_built_and_bound():
  sources = sorted(p.stem for p in _build.CSRC_DIR.glob('*.cu'))
  assert sorted(_build.SOURCES) == sources


def test_build_targets_hopper_and_keys_on_source():
  flags = ' '.join(_build.NVCC_FLAGS)
  assert 'arch=compute_90a,code=sm_90a' in flags
  assert '-shared' in flags and '-fPIC' in flags
  paths = {_build.library_path(name) for name in _build.SOURCES}
  assert len(paths) == len(_build.SOURCES)
  for path in paths:
    assert path.parent == _build.BUILD_DIR
    assert re.fullmatch(r'lib\w+-[0-9a-f]{16}\.so', path.name)
