"""The pool forward's launch choice: the host mirror against the kernel.

``ops/pool.fwd_launch`` says which instantiation of ``pool_fwd_kernel``
(``csrc/pool.cu``) a call takes: 8 channels a thread in 16-byte accesses or
one, 32- or 64-bit offsets, a templated window (all taps in flight) or the
runtime loop, and the 2-D grid. The C entry refuses a choice other than its
own, so a drift would first show as a refused launch on the card; these
tests hold the mirror to the source's constants and to the choices the
QT-Opt paths need, and check that the wrapper hands the choice to the C
entry, without compiling anything.
"""

import contextlib
import re
import types

import pytest
import torch

from tensor2robot_tpu_torch.ops import _build, pool


def _source():
  return (_build.CSRC_DIR / 'pool.cu').read_text()


def _constants():
  """{name: value} of the ``constexpr int`` constants of ``csrc/pool.cu``."""
  return {key: int(value) for key, value in
          re.findall(r'constexpr int (\w+) = (\d+);', _source())}


def _pads(shape, window, strides, padding='SAME'):
  return pool.resolve_padding(padding, window, strides, shape[1:3])


def test_mirror_holds_the_kernel_constants():
  c = _constants()
  assert c['kFwdThreads'] == pool._FWD_THREADS  # pylint: disable=protected-access
  assert c['kFwdMaxGridY'] == pool._FWD_MAX_GRID_Y  # pylint: disable=protected-access
  assert c['kFwdVec'] == pool._FWD_VEC == 8  # pylint: disable=protected-access
  assert c['kNarrowIndexBits'] == pool._NARROW_INDEX_BITS == 31  # pylint: disable=protected-access
  assert c['kFwdThreads'] % 32 == 0


def test_templated_windows_are_the_kernels():
  """Every (kh, kw) the source names, in ``fixed_window`` and in the
  launcher's dispatch, is one of the mirror's templated windows, and each
  of those is instantiated."""
  source = _source()
  named = set(re.findall(r'kh == (\d+) && kw == (\d+)', source))
  assert {(int(a), int(b)) for a, b in named} == set(pool._FWD_WINDOWS)  # pylint: disable=protected-access
  for kh, kw in pool._FWD_WINDOWS:  # pylint: disable=protected-access
    assert f'launch_fwd_as<T, Index, kVec, {kh}, {kw}>' in source
  assert 'launch_fwd_as<T, Index, kVec, 0, 0>' in source


def test_vector_rule_is_the_kernels():
  """The C launcher takes 8 channels a thread exactly where C is a
  multiple of kFwdVec and all three pointers are 16-byte aligned."""
  source = _source()
  assert re.search(r'C % kFwdVec == 0 && aligned16\(x\) && aligned16\(out\) '
                   r'&&\s+aligned16\(slot\)', source)
  assert '(int64_t)1 << kNarrowIndexBits' in source


@pytest.mark.parametrize('name,shape,window,strides,aligned,want', [
    # The QT-Opt pools, serving (B=64) and training (B=32).
    ('pool1', (64, 236, 236, 64), (3, 3), (3, 3), True, (8, 0, 1, (5, 5056))),
    ('pool2', (64, 79, 79, 64), (3, 3), (3, 3), True, (8, 0, 1, (2, 1728))),
    ('pool3', (64, 27, 27, 64), (2, 2), (2, 2), True, (8, 0, 1, (1, 896))),
    ('pool1_train', (32, 236, 236, 64), (3, 3), (3, 3), True,
     (8, 0, 1, (5, 2528))),
    # One channel a thread: C not a multiple of 8, or an unaligned pointer.
    ('c3', (2, 11, 13, 3), (3, 2), (1, 2), True, (1, 0, 0, (1, 22))),
    ('unaligned', (8, 79, 79, 64), (3, 3), (3, 3), False,
     (1, 0, 1, (14, 216))),
    # A window without an instantiation of its own.
    ('overlap_3x2', (2, 23, 23, 8), (3, 2), (2, 1), True, (8, 0, 0, (1, 24))),
    # 64-bit offsets past 2**31 elements; grid y capped, the rows strided.
    ('wide', (1, 8200, 8200, 32), (3, 3), (3, 3), True,
     (8, 1, 1, (86, 2734))),
    ('many_rows', (4096, 79, 79, 8), (3, 3), (3, 3), True,
     (8, 0, 1, (1, 65535))),
], ids=lambda v: v if isinstance(v, str) else None)
def test_launch_choice(name, shape, window, strides, aligned, want):
  del name
  launch = pool.fwd_launch(shape, window, strides,
                           _pads(shape, window, strides), aligned=aligned)
  assert (launch['vec'], launch['wide'], launch['templated'],
          launch['grid']) == want
  assert launch['threads'] == 128


def test_grid_covers_every_output():
  """Grid x times the block covers each row's (ow, channel group) pairs
  with less than one block left over; grid y covers every B*OH row, or
  the cap strides over them."""
  for shape, window, strides in (((3, 29, 31, 24), (3, 3), (2, 3)),
                                 ((2, 236, 236, 64), (3, 3), (3, 3)),
                                 ((5, 9, 9, 5), (2, 2), (1, 1))):
    pads = _pads(shape, window, strides)
    launch = pool.fwd_launch(shape, window, strides, pads)
    plan = pool._plan(shape, window, strides, pads, torch.float32)  # pylint: disable=protected-access
    cols = plan['ow'] * shape[3] // launch['vec']
    gx, gy = launch['grid']
    assert (gx - 1) * launch['threads'] < cols <= gx * launch['threads']
    assert gy == min(shape[0] * plan['oh'], 65535)


def test_refuses_an_undefined_pool():
  with pytest.raises(ValueError, match='unsupported'):
    pool.fwd_launch((1, 4, 4, 8), (3, 3), (1, 1), ((3, 0), (0, 0)))


def test_wrapper_hands_its_choice_to_the_entry_point(monkeypatch):
  """pool_fwd with the C library, the device check and the stream replaced
  by stand-ins: the entry point gets as many arguments as its ctypes
  binding, the geometry, and fwd_launch's choice for the actual pointers;
  the launch counter moves."""
  calls = []

  def entry(*args):
    calls.append(args)
    return 0

  lib = types.SimpleNamespace(t2r_pool_fwd=entry, t2r_pool_bwd=entry)
  monkeypatch.setattr(_build, 'load', lambda name, signatures: lib)
  monkeypatch.setattr(pool, '_cuda_input', lambda x: None)
  monkeypatch.setattr(torch.cuda, 'device',
                      lambda device: contextlib.nullcontext())
  monkeypatch.setattr(torch.cuda, 'current_stream',
                      lambda device: types.SimpleNamespace(cuda_stream=0))
  for shape, window, strides in (((2, 236, 236, 64), (3, 3), (3, 3)),
                                 ((2, 11, 13, 3), (3, 2), (1, 2))):
    x = torch.zeros(shape, dtype=torch.bfloat16)
    pads = _pads(shape, window, strides)
    before = pool.pool_fwd.launches
    out, slot = pool.pool_fwd(x, window, strides, pads)
    args = calls[-1]
    assert len(args) == len(pool._SIGNATURES['t2r_pool_fwd'])  # pylint: disable=protected-access
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, out, slot))
    launch = pool.fwd_launch(shape, window, strides, pads, aligned=aligned)
    assert args[3:8] == (1,) + tuple(shape)
    assert args[-4:-1] == (launch['vec'], launch['wide'],
                           launch['templated'])
    assert pool.pool_fwd.launches == before + 1

