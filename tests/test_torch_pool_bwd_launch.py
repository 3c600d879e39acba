"""The pool backward's launch choice and both its routes, on the CPU.

``ops/pool.bwd_launch`` says which route and instantiation of the backward
(``csrc/pool.cu``) a call takes: the scatter route (stride == window, a
thread per window stores its positions) or the gather route (a thread per
sh x sw phase block of input pixels sums the windows that cover them), 8
channels a thread or one, 32- or 64-bit offsets, a templated window, the
gather route's tiles and stages, and the grid. The C entry refuses a
choice other than its own, so these tests hold the mirror to the source's
constants and rules and to the choices the QT-Opt and Grasp2Vec pools
need, and check that the wrapper hands the choice to the C entry, without
compiling anything.

The scatter kernel itself runs only on the card. ``emulate_scatter``
repeats its writes in numpy, thread by thread as the kernel orders them
(the window's positions inside the image, then the uncovered tails that
the last window row and column write as +0), on raw bits. It must write
every element of dx exactly once and equal, bit for bit, the JAX
package's ``_pool_bwd_kernel`` (its non-overlapping branch, interpreted on
the CPU), with -0.0 and NaN cotangents and VALID tails; the port's plain
version must equal both.

``emulate_gather`` repeats the gather kernel's tile walk in numpy: each
tile's windows staged with their halo (the output's windows only), each
thread's phase block read from its stage, its pixels summed in ascending
(oh, ow) order from +0 and rounded to the cotangent's dtype after every
add, one store a pixel. It must write every element of dx exactly once
and equal, bit for bit, ``plain_max_pool_bwd`` and the JAX package's
``_pool_grad_call`` (interpreted on the CPU, where its planner takes the
pool: C % 8 == 0) with NaN, +-0 and +-inf cotangents. Where an add meets a
NaN the three give NaN in the same elements, but which payload an add
returns is the implementation's (on the CPU, numpy keeps the first
operand's, torch and XLA canonicalize or pick otherwise; on the card every
add returns the canonical NaN, and ``chip_smoke.py`` holds the kernel to
the plain version bit for bit there), so those elements are compared as
NaN; every other element bit for bit.
"""

import contextlib
import re
import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tensor2robot_tpu.ops import _pallas_dispatch
from tensor2robot_tpu.ops import pool as jax_pool
from tensor2robot_tpu_torch.ops import _build, pool

_BITS = {np.float32: np.uint32, ml_dtypes.bfloat16: np.uint16}
_TORCH = {np.float32: torch.float32, ml_dtypes.bfloat16: torch.bfloat16}
_TORCH_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _source():
  return (_build.CSRC_DIR / 'pool.cu').read_text()


def _pads(shape, window, strides, padding='SAME'):
  return pool.resolve_padding(padding, window, strides, shape[1:3])


def test_mirror_holds_the_kernel_constants():
  c = {key: int(value) for key, value in
       re.findall(r'constexpr int (\w+) = (\d+);', _source())}
  # pylint: disable=protected-access
  assert c['kGatherThreads'] == pool._GATHER_THREADS == 256
  assert c['kGatherGroups'] == pool._GATHER_GROUPS == 8
  assert c['kGatherTileCols'] == pool._GATHER_TILE_COLS == 8
  assert c['kGatherStages'] == pool._GATHER_STAGES == 2
  assert c['kGatherBlocksPerSm'] == pool._GATHER_BLOCKS_PER_SM
  assert c['kGatherMaxGridY'] == pool._GATHER_MAX_GRID_Y
  assert c['kSms'] == pool._SMS
  assert c['kSmSharedBytes'] == pool._SM_SHARED_BYTES
  assert c['kBlockReservedBytes'] == pool._BLOCK_RESERVED_BYTES
  assert c['kMaxBlockSharedBytes'] == pool._MAX_BLOCK_SHARED_BYTES
  assert c['kFwdThreads'] == pool._FWD_THREADS
  # pylint: enable=protected-access
  source = _source()
  assert 'pool_bwd_kernel<' not in source  # the 1-D gather kernel is gone
  assert '__launch_bounds__(kGatherThreads, kGatherBlocksPerSm)' in source


def test_route_rules_are_the_kernels():
  """The C launcher takes the scatter route exactly where stride ==
  window, templates the forward's windows there and the 3x3/s2 window on
  the gather route, and takes 8 channels a thread where C % 8 == 0 and
  all three pointers are 16-byte aligned."""
  source = _source()
  assert 'const bool disjoint = sh == kh && sw == kw;' in source
  assert re.search(r'const bool vector = C % kFwdVec == 0 && aligned16\(g\) '
                   r'&& aligned16\(slot\) &&\s+aligned16\(dx\);', source)
  assert re.search(r'const bool fixed = disjoint \? fixed_window\(kh, kw\)\s+'
                   r': kh == 3 && kw == 3 && sh == 2 && sw == 2;', source)
  assert 'templated != (fixed ? 1 : 0)' in source
  assert pool._GATHER_WINDOW == ((3, 3), (2, 2))  # pylint: disable=protected-access
  for kh, kw in pool._FWD_WINDOWS:  # pylint: disable=protected-access
    assert f'launch_scatter_as<T, Index, kVec, {kh}, {kw}>' in source
  assert 'launch_scatter_as<T, Index, kVec, 0, 0>' in source
  assert 'launch_gather_as<T, Index, kVec, true>' in source
  assert 'launch_gather_as<T, Index, kVec, false>' in source


@pytest.mark.parametrize('name,shape,window,strides,padding,aligned,want', [
    # The QT-Opt pools, training (B=32) and serving (B=64): scatter, 8
    # channels a thread, templated, the forward's grid.
    ('pool1', (32, 236, 236, 64), (3, 3), (3, 3), 'SAME', True,
     ('scatter', 8, 0, 1, (5, 2528))),
    ('pool2', (32, 79, 79, 64), (3, 3), (3, 3), 'SAME', True,
     ('scatter', 8, 0, 1, (2, 864))),
    ('pool3', (32, 27, 27, 64), (2, 2), (2, 2), 'SAME', True,
     ('scatter', 8, 0, 1, (1, 448))),
    ('pool1_serving', (64, 236, 236, 64), (3, 3), (3, 3), 'SAME', True,
     ('scatter', 8, 0, 1, (5, 5056))),
    # VALID tails no window covers; a window without an instantiation.
    ('valid_tails', (1, 11, 14, 8), (3, 3), (3, 3), 'VALID', True,
     ('scatter', 8, 0, 1, (1, 3))),
    ('valid_2x3', (1, 10, 13, 5), (2, 3), (2, 3), 'VALID', True,
     ('scatter', 1, 0, 0, (1, 5))),
    # One channel a thread: C % 8 != 0, or an unaligned pointer.
    ('c3', (4, 79, 79, 3), (3, 3), (3, 3), 'SAME', True,
     ('scatter', 1, 0, 1, (1, 108))),
    ('unaligned', (8, 79, 79, 64), (3, 3), (3, 3), 'SAME', False,
     ('scatter', 1, 0, 1, (14, 216))),
    # Overlapping windows take the gather route: the grid's x is a tile
    # column and channel span, its y the persistent blocks over the tile
    # rows. The Grasp2Vec stem (3x3/s2, pads (1, 1)) at both towers'
    # batches: 119 x 119 phase blocks in tiles of 4 x 8, 15 tile columns,
    # 26 blocks down each (one wave at three an SM).
    ('stem_b32', (32, 236, 236, 64), (3, 3), (2, 2), ((1, 1), (1, 1)), True,
     ('gather', 8, 0, 1, (15, 26))),
    ('stem_b16', (16, 236, 236, 64), (3, 3), (2, 2), ((1, 1), (1, 1)), True,
     ('gather', 8, 0, 1, (15, 26))),
    ('overlap_3x3_s2', (4, 23, 23, 64), (3, 3), (2, 2), 'SAME', True,
     ('gather', 8, 0, 1, (2, 12))),
    ('overlap_c3', (2, 11, 13, 3), (3, 2), (1, 2), 'SAME', True,
     ('gather', 1, 0, 0, (1, 2))),
    # 64-bit offsets past 2**31 elements; grid y capped, the rows strided.
    ('wide', (1, 8200, 8200, 32), (3, 3), (3, 3), 'SAME', True,
     ('scatter', 8, 1, 1, (86, 2734))),
    ('wide_gather', (1, 8200, 8200, 32), (3, 3), (2, 2), 'SAME', True,
     ('gather', 8, 1, 1, (513, 1))),
    ('many_rows', (4096, 79, 79, 8), (3, 3), (3, 3), 'SAME', True,
     ('scatter', 8, 0, 1, (1, 65535))),
], ids=lambda v: v if isinstance(v, str) else None)
def test_launch_choice(name, shape, window, strides, padding, aligned, want):
  del name
  launch = pool.bwd_launch(shape, window, strides,
                           _pads(shape, window, strides, padding),
                           aligned=aligned)
  assert (launch['route'], launch['vec'], launch['wide'],
          launch['templated'], launch['grid']) == want
  assert launch['threads'] == (128 if want[0] == 'scatter' else 256)


def test_scatter_grid_covers_every_window():
  for shape, window in (((3, 29, 31, 24), (3, 3)), ((2, 236, 236, 64), (3, 3)),
                        ((5, 9, 9, 5), (2, 2)), ((1, 10, 13, 16), (2, 3))):
    pads = _pads(shape, window, window)
    launch = pool.bwd_launch(shape, window, window, pads)
    plan = pool._plan(shape, window, window, pads, torch.float32)  # pylint: disable=protected-access
    cols = plan['ow'] * shape[3] // launch['vec']
    gx, gy = launch['grid']
    assert (gx - 1) * launch['threads'] < cols <= gx * launch['threads']
    assert gy == min(shape[0] * plan['oh'], 65535)


def test_gather_grid_is_capped():
  """The gather grid's y is capped at one wave of resident blocks (three
  an SM of 132) over its x, at least 1, at most the tile rows and
  65,535; x covers every tile column of every channel span."""
  for shape, window, strides, dtype in (
      ((1, 2**20, 2**20, 8), (3, 3), (2, 2), torch.bfloat16),
      ((32, 236, 236, 64), (3, 3), (2, 2), torch.float32),
      ((70000, 6, 6, 8), (3, 3), (1, 1), torch.bfloat16),
      ((2, 40, 40, 200), (5, 4), (2, 3), torch.float32)):
    launch = pool.bwd_launch(shape, window, strides,
                             _pads(shape, window, strides), dtype=dtype)
    gx, gy = launch['grid']
    row_tiles, col_tiles = launch['tiles']
    assert gx == col_tiles * launch['spans']
    assert gy == min(max(1, 132 * 3 // gx), shape[0] * row_tiles, 65535)
    assert launch['smem'] <= 233472 // 3 - 1024


def test_refuses_an_undefined_pool():
  with pytest.raises(ValueError, match='unsupported'):
    pool.bwd_launch((1, 4, 4, 8), (3, 3), (1, 1), ((3, 0), (0, 0)))


def emulate_scatter(g_bits, slot, xshape, window, pads):
  """The scatter route's stores, in numpy on raw bits: each (window row,
  window column) thread, vectorized over the batch and the channels,
  stores its window's positions inside the image (the cotangent's bits
  where the slot names the position, else 0), then the tails: below the
  last window row over its columns (tail columns included), and right of
  the last window column beside its rows. Returns dx's bits and how often
  each element was written."""
  _, h, w, _ = xshape
  kh, kw = window
  (plh, _), (plw, _) = pads
  oh, ow = g_bits.shape[1:3]
  dx = np.full(xshape, 0x5a5a, g_bits.dtype)  # not a value any store makes
  writes = np.zeros(xshape, np.int32)

  def put(ih, iw, value):
    dx[:, ih, iw] = value
    writes[:, ih, iw] += 1

  for o_w in range(ow):
    w0 = o_w * kw - plw
    w_lo, w_win = max(w0, 0), min(w0 + kw, w)
    w_end = w if o_w == ow - 1 else w_win
    for o_h in range(oh):
      h0 = o_h * kh - plh
      v, sl = g_bits[:, o_h, o_w], slot[:, o_h, o_w]
      for dy in range(kh):
        for dx_ in range(kw):
          ih, iw = h0 + dy, w0 + dx_
          if 0 <= ih < h and 0 <= iw < w:
            put(ih, iw, np.where(sl == dy * kw + dx_, v, 0))
      h_win = min(h0 + kh, h)
      if o_h == oh - 1:
        for ih in range(h_win, h):
          for iw in range(w_lo, w_end):
            put(ih, iw, 0)
      for ih in range(max(h0, 0), h_win):
        for iw in range(w_win, w_end):
          put(ih, iw, 0)
  return dx, writes


# Non-overlapping pools at the QT-Opt windows and pads (spatial sizes cut),
# VALID tails in rows and columns, explicit pads, a runtime window.
SCATTER_CASES = [
    ('pool1_pads_0_1', (2, 26, 26, 8), (3, 3), 'SAME'),
    ('pool2_pads_1_1', (2, 25, 25, 8), (3, 3), 'SAME'),
    ('pool3_pads_0_1', (3, 27, 27, 16), (2, 2), 'SAME'),
    ('valid_tails', (1, 11, 14, 8), (3, 3), 'VALID'),
    ('valid_2x3', (1, 10, 13, 8), (2, 3), 'VALID'),
    ('explicit_tail', (1, 12, 13, 8), (3, 3), ((1, 0), (2, 0))),
]


def _cotangent(shape, np_dtype, seed):
  """Seeded cotangent bits with -0.0, +0.0, infinities and NaNs planted in:
  in float32 NaNs of several payloads, in bfloat16 the canonical quiet NaNs
  of either sign (the JAX kernel, interpreted by XLA on the CPU, computes
  bfloat16 through float32 and returns any other NaN canonicalized)."""
  rng = np.random.RandomState(seed)
  g = rng.randn(*shape).astype(np.float32).astype(np_dtype)
  bits = g.view(_BITS[np_dtype])
  flat = bits.reshape(-1)
  special = ([0x8000, 0x0000, 0x7fc0, 0xffc0, 0x7f80, 0xff80]
             if np_dtype == ml_dtypes.bfloat16 else
             [0x80000000, 0x0, 0x7fc00123, 0xffa00001, 0x7f800000,
              0xff800000])
  where = rng.choice(flat.size, size=min(flat.size, 6 * 40), replace=False)
  flat[where] = np.resize(np.array(special, bits.dtype), where.size)
  return bits.view(np_dtype)


@pytest.mark.parametrize('np_dtype', [np.float32, ml_dtypes.bfloat16],
                         ids=['float32', 'bfloat16'])
@pytest.mark.parametrize('name,shape,window,padding', SCATTER_CASES,
                         ids=[case[0] for case in SCATTER_CASES])
def test_scatter_emulation_is_the_jax_kernel_bit_for_bit(name, shape, window,
                                                         padding, np_dtype):
  del name
  pads = _pads(shape, window, window, padding)
  assert pool.bwd_launch(shape, window, window, pads)['route'] == 'scatter'
  x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
  x[..., 0] = np.round(x[..., 0] * 2) / 2  # ties
  tx = torch.from_numpy(x).to(_TORCH[np_dtype])
  _, slot = pool.plain_max_pool_argmax(tx, window, window, pads)
  g = _cotangent(tuple(slot.shape), np_dtype, seed=5)
  bits, writes = emulate_scatter(g.view(_BITS[np_dtype]), slot.numpy(),
                                 shape, window, pads)
  assert (writes == 1).all()
  plan = jax_pool._plan(shape, window, window, pads, np.float32)  # pylint: disable=protected-access
  with _pallas_dispatch.force_kernels(True):
    want = np.asarray(jax_pool._pool_grad_call(  # pylint: disable=protected-access
        jnp.asarray(g), jnp.asarray(slot.numpy()), shape, plan))
  np.testing.assert_array_equal(bits, want.view(_BITS[np_dtype]))
  # The plain version places, not adds, the routed cotangents here.
  tg = torch.from_numpy(g.view(_BITS[np_dtype]).astype(np.int64)).to(
      _TORCH_BITS[_TORCH[np_dtype]]).view(_TORCH[np_dtype])
  plain = pool.plain_max_pool_bwd(tg, slot, shape, window, window, pads)
  np.testing.assert_array_equal(
      plain.view(_TORCH_BITS[plain.dtype]).numpy().astype(np.int64) &
      (0xffff if np_dtype == ml_dtypes.bfloat16 else 0xffffffff),
      bits.astype(np.int64))


def test_plain_overlapping_sums_start_from_plus_zero():
  """Overlapping windows add from +0, as the JAX kernel's accumulation
  does: a lone -0.0 cotangent gives +0, and the plain version equals the
  JAX kernel (interpreted) bit for bit on the same -0.0 cotangent."""
  shape, window, strides = (1, 5, 5, 8), (3, 3), (2, 2)
  x = torch.zeros(shape)
  x[0, 2, 2] = 1.0
  pads = ((0, 0), (0, 0))
  _, slot = pool.plain_max_pool_argmax(x, window, strides, pads)
  g = torch.full(tuple(slot.shape), -0.0)
  dx = pool.plain_max_pool_bwd(g, slot, shape, window, strides, pads)
  assert not bool(torch.signbit(dx).any())
  plan = jax_pool._plan(shape, window, strides, pads, np.float32)  # pylint: disable=protected-access
  with _pallas_dispatch.force_kernels(True):
    want = np.asarray(jax_pool._pool_grad_call(  # pylint: disable=protected-access
        jnp.asarray(g.numpy()), jnp.asarray(slot.numpy()), shape, plan))
  np.testing.assert_array_equal(dx.numpy().view(np.uint32),
                                want.view(np.uint32))


def test_wrapper_hands_its_choice_to_the_entry_point(monkeypatch):
  """pool_bwd with the C library, the device check and the stream replaced
  by stand-ins: the entry gets as many arguments as its ctypes binding, the
  geometry and bwd_launch's choice for the actual pointers; both counters
  move on the scatter route, only ``launches`` on the gather route."""
  calls = []

  def entry(*args):
    calls.append(args)
    return 0

  lib = types.SimpleNamespace(t2r_pool_fwd=entry, t2r_pool_bwd=entry)
  monkeypatch.setattr(_build, 'load', lambda name, signatures: lib)
  monkeypatch.setattr(pool, '_cuda_cotangent', lambda g, slot: None)
  monkeypatch.setattr(torch.cuda, 'device',
                      lambda device: contextlib.nullcontext())
  monkeypatch.setattr(torch.cuda, 'current_stream',
                      lambda device: types.SimpleNamespace(cuda_stream=0))
  for shape, window, strides, scatter in (
      ((2, 236, 236, 64), (3, 3), (3, 3), 1),
      ((2, 11, 13, 3), (3, 2), (1, 2), 0)):
    pads = _pads(shape, window, strides)
    plan = pool._plan(shape, window, strides, pads, torch.bfloat16)  # pylint: disable=protected-access
    out_shape = (shape[0], plan['oh'], plan['ow'], shape[3])
    g = torch.zeros(out_shape, dtype=torch.bfloat16)
    slot = torch.zeros(out_shape, dtype=torch.int32)
    before = (pool.pool_bwd.launches, pool.pool_bwd.scatter_launches)
    dx = pool.pool_bwd(g, slot, shape, window, strides, pads)
    args = calls[-1]
    assert len(args) == len(pool._SIGNATURES['t2r_pool_bwd'])  # pylint: disable=protected-access
    aligned = all(t.data_ptr() % 16 == 0 for t in (g, slot, dx))
    launch = pool.bwd_launch(shape, window, strides, pads, aligned=aligned,
                             dtype=torch.bfloat16)
    assert args[3:8] == (1,) + tuple(shape)
    assert args[-5:-1] == (scatter, launch['vec'], launch['wide'],
                           launch['templated'])
    assert (pool.pool_bwd.launches, pool.pool_bwd.scatter_launches) == (
        before[0] + 1, before[1] + scatter)


def emulate_gather(g_bits, slot, xshape, window, strides, pads, launch,
                   np_dtype):
  """The gather route's tile walk, in numpy on raw bits (see the module
  docstring). Returns dx's bits and how often each element was written."""
  b_, h, w, c = xshape
  (kh, kw), (sh, sw) = window, strides
  (plh, _), (plw, _) = pads
  oh_n, ow_n = g_bits.shape[1:3]
  vec, cgs = launch['vec'], launch['groups_per_span']
  hr, hc = launch['halo']
  tr, tc = launch['tile']
  m_lo, n_lo = launch['block_origin']
  rows, cols = launch['blocks']
  row_tiles, col_tiles = launch['tiles']
  assert (hr, hc) == (-(-kh // sh) - 1, -(-kw // sw) - 1)
  span_elems = cgs * vec
  g = g_bits.view(np_dtype)
  dx = np.full(xshape, 0x5a5a, g_bits.dtype)  # not a value any store makes
  writes = np.zeros(xshape, np.int32)
  for span in range(launch['spans']):
    ch = span * span_elems + np.arange(span_elems)
    ch_ok = ch < c
    for tile_row in range(b_ * row_tiles):
      b, rt = divmod(tile_row, row_tiles)
      m0 = m_lo + rt * tr
      for ct in range(col_tiles):
        n0 = n_lo + ct * tc
        # The stage: the tile's windows with their halo; NaN and -7 where
        # no copy of an output window lands.
        st_g = np.full((tr + hr, tc + hc, span_elems), np.nan, np.float32)
        st_s = np.full((tr + hr, tc + hc, span_elems), -7, np.int32)
        for a in range(tr + hr):
          for bc in range(tc + hc):
            oh, ow = m0 - hr + a, n0 - hc + bc
            if 0 <= oh < oh_n and 0 <= ow < ow_n:
              st_g[a, bc, ch_ok] = g[b, oh, ow, ch[ch_ok]].astype(np.float32)
              st_s[a, bc, ch_ok] = slot[b, oh, ow, ch[ch_ok]]
        for ur in range(tr):
          for uc in range(tc):
            m, n = m0 + ur, n0 + uc
            if m >= m_lo + rows or n >= n_lo + cols:
              continue
            for r in range(sh):
              for q in range(sw):
                ih, iw = m * sh + r - plh, n * sw + q - plw
                if not (0 <= ih < h and 0 <= iw < w):
                  continue
                acc = np.zeros(span_elems, np_dtype)
                for a in range(hr + 1):
                  for bc in range(hc + 1):
                    oh, ow = m - hr + a, n - hc + bc
                    dy, dxx = r + (hr - a) * sh, q + (hc - bc) * sw
                    if dy >= kh or dxx >= kw or not (
                        0 <= oh < oh_n and 0 <= ow < ow_n):
                      continue
                    sl = st_s[ur + a, uc + bc]
                    hit = (sl == dy * kw + dxx) & ch_ok
                    assert (sl[ch_ok] != -7).all()
                    with np.errstate(invalid='ignore'):  # inf - inf
                      acc = np.where(hit, (acc.astype(np.float32) +
                                           st_g[ur + a, uc + bc]).astype(
                                               np_dtype), acc)
                dx[b, ih, iw, ch[ch_ok]] = acc[ch_ok].view(g_bits.dtype)
                writes[b, ih, iw, ch[ch_ok]] += 1
  return dx, writes


# Overlapping pools: the Grasp2Vec stem's 3x3/s2 with pads (1, 1) and with
# SAME's (0, 1), both cut to 24 x 24; the odd (3, 2)/(1, 2) window; ragged
# last tiles in rows and columns (14 x 19 phase blocks in tiles of 4 x 8);
# C = 3 (one channel a thread; the JAX planner takes C % 8 == 0 only).
GATHER_CASES = [
    ('stem_pads_1_1', (2, 24, 24, 8), (3, 3), (2, 2), ((1, 1), (1, 1))),
    ('stem_same_0_1', (2, 24, 24, 8), (3, 3), (2, 2), 'SAME'),
    ('odd_3x2_s1x2', (2, 11, 13, 16), (3, 2), (1, 2), 'SAME'),
    ('ragged_tiles', (1, 27, 37, 64), (3, 3), (2, 2), 'SAME'),
    ('c3', (2, 13, 11, 3), (3, 3), (2, 2), 'SAME'),
]


@pytest.mark.parametrize('np_dtype', [np.float32, ml_dtypes.bfloat16],
                         ids=['float32', 'bfloat16'])
@pytest.mark.parametrize('name,shape,window,strides,padding', GATHER_CASES,
                         ids=[case[0] for case in GATHER_CASES])
def test_gather_emulation_is_plain_and_jax_bit_for_bit(name, shape, window,
                                                       strides, padding,
                                                       np_dtype):
  pads = _pads(shape, window, strides, padding)
  launch = pool.bwd_launch(shape, window, strides, pads,
                           dtype=_TORCH[np_dtype])
  assert launch['route'] == 'gather' and launch['staged']
  assert launch['templated'] == int((window, strides) == ((3, 3), (2, 2)))
  if name == 'ragged_tiles':
    assert launch['blocks'][0] % launch['tile'][0] != 0
    assert launch['blocks'][1] % launch['tile'][1] != 0
  x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
  x[..., 0] = np.round(x[..., 0] * 2) / 2  # ties
  tx = torch.from_numpy(x).to(_TORCH[np_dtype])
  _, slot = pool.plain_max_pool_argmax(tx, window, strides, pads)
  g = _cotangent(tuple(slot.shape), np_dtype, seed=7)
  bits, writes = emulate_gather(g.view(_BITS[np_dtype]), slot.numpy(), shape,
                                window, strides, pads, launch, np_dtype)
  assert (writes == 1).all()
  tg = torch.from_numpy(g.view(_BITS[np_dtype]).astype(np.int64)).to(
      _TORCH_BITS[_TORCH[np_dtype]]).view(_TORCH[np_dtype])
  plain = pool.plain_max_pool_bwd(tg, slot, shape, window, strides, pads)
  mask = 0xffff if np_dtype == ml_dtypes.bfloat16 else 0xffffffff
  references = [(plain.view(_TORCH_BITS[plain.dtype]).numpy().astype(
      np.int64) & mask).astype(_BITS[np_dtype])]
  plan = jax_pool._plan(shape, window, strides, pads, np.float32)  # pylint: disable=protected-access
  assert (plan is None) == (shape[3] % 8 != 0)
  if plan is not None:
    with _pallas_dispatch.force_kernels(True):
      want = np.asarray(jax_pool._pool_grad_call(  # pylint: disable=protected-access
          jnp.asarray(g), jnp.asarray(slot.numpy()), shape, plan))
    references.append(want.view(_BITS[np_dtype]))
  nan = np.isnan(bits.view(np_dtype).astype(np.float32))
  assert nan.any()  # the planted NaNs reach dx
  for reference in references:
    np.testing.assert_array_equal(
        np.isnan(reference.view(np_dtype).astype(np.float32)), nan)
    np.testing.assert_array_equal(bits[~nan], reference[~nan])


@pytest.mark.parametrize('name,shape,window,strides,padding', GATHER_CASES,
                         ids=[case[0] for case in GATHER_CASES])
def test_gather_tiles_cover_every_pixel_once(name, shape, window, strides,
                                             padding):
  """Every input pixel lies in one phase block of one tile, every channel
  in one span; a tile's threads fit the block; the halo holds every
  window that covers a block of the tile."""
  del name
  pads = _pads(shape, window, strides, padding)
  launch = pool.bwd_launch(shape, window, strides, pads)
  (kh, kw), (sh, sw) = window, strides
  tr, tc = launch['tile']
  m_lo, n_lo = launch['block_origin']
  rows, cols = launch['blocks']
  assert tr * tc * launch['groups_per_span'] <= launch['threads']
  ih, iw = np.arange(shape[1]), np.arange(shape[2])
  m, n = (ih + pads[0][0]) // sh, (iw + pads[1][0]) // sw
  assert m.min() == m_lo and m.max() == m_lo + rows - 1
  assert n.min() == n_lo and n.max() == n_lo + cols - 1
  # Windows covering padded row p: oh in [ceil((p - kh + 1) / sh), p // sh].
  p = ih + pads[0][0]
  assert ((m - -(-(p - kh + 1) // sh)) <= launch['halo'][0]).all()
  p = iw + pads[1][0]
  assert ((n - -(-(p - kw + 1) // sw)) <= launch['halo'][1]).all()
  groups = shape[3] // launch['vec']
  spans = launch['spans']
  assert (spans - 1) * launch['groups_per_span'] < groups <= (
      spans * launch['groups_per_span'])
