"""The ctypes bindings of the CUDA kernels agree with their C entry points.

The kernels compile only where there is a card, so a mismatch between a
wrapper's ``argtypes`` and the ``extern "C"`` signature in ``csrc/*.cu``
would first show as a refused call on the card. These tests read the C
signatures from the sources and hold every wrapper's binding to them, and
check the build command and its cache key without compiling anything.
"""

import ctypes
import re
import types

import pytest

from tensor2robot_tpu_torch.ops import (_build, conv_s2d, flash_attention,
                                        fused_update, photometric, pool)

_ENTRY = re.compile(r'^int\s+(t2r_\w+)\(([^)]*)\)\s*\{', re.MULTILINE)
# A host array (the fused update's leaf table) is passed as its address.
_C_TYPES = {'const void*': ctypes.c_void_p, 'void*': ctypes.c_void_p,
            'const int64_t*': ctypes.c_void_p, 'int': ctypes.c_int,
            'float': ctypes.c_float}


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


@pytest.mark.parametrize('name,module', [
    ('pool', pool), ('conv_s2d', conv_s2d),
    ('flash_attention', flash_attention), ('fused_update', fused_update),
    ('photometric', photometric),
    ('flash_attention_bwd', types.SimpleNamespace(
        _SIGNATURES=flash_attention._BWD_SIGNATURES))])  # pylint: disable=protected-access
def test_argtypes_match_c_signature(name, module):
  entries = _c_entry_points(name)
  assert set(module._SIGNATURES) == set(entries)
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


def test_fused_update_table_fits_the_kernel():
  """The Python side chunks leaves by the kernel's table size, which fits
  Hopper's 32,764 bytes of kernel parameters beside the scalars, the
  guard's pointer and the device rates' pointer (52 bytes a leaf: five
  pointers, a count, a block start); the table is a __grid_constant__
  parameter; the build never uses fast-math (the update needs IEEE
  division and sqrt)."""
  source = (_build.CSRC_DIR / 'fused_update.cu').read_text()
  match = re.search(r'constexpr int kMaxLeaves = (\d+);', source)
  leaves = int(match.group(1))
  assert leaves == fused_update.LEAVES_PER_LAUNCH == 512
  table = 5 * 8 * leaves + 8 * leaves + 4 * (leaves + 1) + 4
  scalars = 10 * 4
  assert table + scalars + 2 * 8 <= 32764
  assert ('sizeof(Table) + sizeof(Scalars) + 2 * sizeof(void*) <= 32764'
          in source)
  assert re.search(r'fused_update_kernel\(__grid_constant__ const Table t,',
                   source)
  assert not any('fast' in flag for flag in _build.NVCC_FLAGS)


def test_build_keeps_each_compiler_report_beside_its_library():
  for name in _build.SOURCES:
    report = _build.report_path(name)
    library = _build.library_path(name)
    assert report.parent == library.parent
    assert report.name == library.name[:-len('.so')] + '.ptxas.txt'


def _constants(name):
  """{name: value} of the ``constexpr int`` constants of ``csrc/<name>.cu``,
  each expression evaluated over the constants before it."""
  source = (_build.CSRC_DIR / f'{name}.cu').read_text()
  values = {}
  for key, expr in re.findall(r'constexpr int (\w+) = ([^;]+);', source):
    values[key] = eval(expr, {}, dict(values))  # pylint: disable=eval-used
  return values


def test_dw_planner_mirrors_the_tensor_core_kernel():
  """The host planner's tile, block and padding numbers are the bfloat16
  dW kernel's, and its fixed run count is one wave of that kernel's
  minimum blocks per SM on an H100's 132 SMs."""
  c = _constants('conv_s2d')
  assert c['kPixels'] == conv_s2d._TILE_PIXELS
  assert c['kMmaMaxTaps'] == conv_s2d._MMA_MAX_TAPS
  assert c['kMmaChannels'] == conv_s2d._MMA_CHANNELS
  assert c['kMmaStages'] == conv_s2d._MMA_STAGES
  assert c['kMmaRowPad'] == conv_s2d._MMA_ROW_PAD
  assert c['kMmaBStride'] == c['kMmaChannels'] + conv_s2d._MMA_ROW_PAD
  assert c['kMmaThreads'] == 4 * 32 and c['kMmaChannels'] == 4 * 16
  assert conv_s2d._DW_MMA_CHUNKS == 132 * c['kMmaBlocksPerSm']


def test_fwd_planner_mirrors_the_tensor_core_kernel():
  """The host planner's tile, block and padding numbers are the bfloat16
  forward kernel's: one warpgroup's wgmma over a 64 x 64 output tile of
  8 x 8 core matrices, the patch at most 512 taps deep, and a run count of
  one wave of the kernel's minimum blocks per SM on an H100's 132 SMs; the
  C entry point it calls is bound to its signature."""
  c = _constants('conv_s2d')
  assert c['kFwdChannels'] == conv_s2d._FWD_CHANNELS == 2 * 32
  assert c['kPixels'] == conv_s2d._TILE_PIXELS == 2 * 32
  assert c['kMmaThreads'] == 4 * 32
  assert c['kFwdMaxTaps'] == conv_s2d._MAX_PATCH_DEPTH
  assert c['kFwdStages'] == conv_s2d._FWD_STAGES
  assert c['kCoreRows'] * 8 == c['kPixels'] == c['kFwdChannels']
  assert conv_s2d._FWD_MMA_CHUNKS == 132 * c['kFwdBlocksPerSm']
  entries = _c_entry_points('conv_s2d')
  assert conv_s2d._SIGNATURES['t2r_conv_s2d_fwd_mma'] == entries[
      't2r_conv_s2d_fwd_mma']
  assert conv_s2d._SIGNATURES['t2r_conv_s2d_fwd'] == entries[
      't2r_conv_s2d_fwd']


def test_flash_fwd_entry_takes_the_plan():
  """t2r_flash_fwd takes the host planner's route code and q-tile rows
  just before the stream, which its ctypes binding passes as ints. (That
  it refuses a plan that differs from its own choice is held on the card,
  in tests/test_torch_cuda_kernels.py.)"""
  params = _c_entry_points('flash_attention')['t2r_flash_fwd']
  assert params[-3:] == [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
  assert flash_attention._SIGNATURES['t2r_flash_fwd'] == params  # pylint: disable=protected-access
  assert len(params) == 15


def test_stack_frame_lines_are_read_per_instantiation():
  """chip_smoke.py reads each fused_update_kernel instantiation's stack
  frame from ptxas -v's report, whose 'Function properties for' line
  names the kernel and whose next line gives its frame."""
  import chip_smoke  # pylint: disable=import-outside-toplevel

  report = '\n'.join([
      "ptxas info    : Compiling entry function "
      "'_ZN12_GLOBAL__N_119fused_update_kernelILb1ELb1ELb1EEEvNS_5TableE' "
      "for 'sm_90a'",
      'ptxas info    : Function properties for '
      '_ZN12_GLOBAL__N_119fused_update_kernelILb1ELb1ELb1EEEvNS_5TableE',
      '    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
      'ptxas info    : Used 40 registers, 26680 bytes cmem[0]',
      'ptxas info    : Function properties for _ZN4misc6kernelEv',
      '    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
      'ptxas info    : Function properties for '
      '_ZN12_GLOBAL__N_119fused_update_kernelILb0ELb0ELb0EEEvNS_5TableE',
      '    26632 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
  ])
  frames = chip_smoke.stack_frames(report, 'fused_update_kernel')
  assert sorted(line.split()[0] for line in frames.values()) == ['0', '26632']
  assert all('fused_update_kernel' in name for name in frames)
