"""Port parity: the argmax-slot max pool against the JAX package.

The port's plain ``max_pool_argmax`` (what a CPU tensor runs; the CUDA
kernel is held against it on the card by ``chip_smoke.py``) must equal the
JAX Pallas pool kernel (interpreted on the CPU) BITWISE, pooled values and
int32 slots alike, in float32 and bfloat16. Inputs come from a seeded
numpy generator with planted ties.

The JAX package's public ``max_pool_argmax`` refuses bfloat16 (its
geometry plan tests ``np.issubdtype(dtype, np.floating)``, which is False
for bfloat16), so the bfloat16 cases call its kernel launcher
``_pool_call`` with the plan it builds for float32; the kernel body is the
same for both dtypes. ``test_jax_pool_gate_refuses_bfloat16`` pins that
fault of the JAX package.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tensor2robot_tpu.ops import pool as jax_pool
from tensor2robot_tpu_torch.ops import pool as torch_pool

# The three QT-Opt pools at their real spatial sizes (channels cut from
# 64 to 8), an overlapping window, VALID padding and odd sizes.
CASES = [
    ('pool1', (1, 236, 236, 8), (3, 3), (3, 3), 'SAME'),
    ('pool2', (2, 79, 79, 8), (3, 3), (3, 3), 'SAME'),
    ('pool3', (2, 27, 27, 16), (2, 2), (2, 2), 'SAME'),
    ('overlap_3x3_s2', (2, 23, 23, 8), (3, 3), (2, 2), 'SAME'),
    ('valid', (1, 10, 13, 8), (2, 3), (2, 3), 'VALID'),
    ('odd', (2, 11, 13, 16), (3, 2), (1, 2), 'SAME'),
]

DTYPES = {'float32': (np.float32, torch.float32),
          'bfloat16': (ml_dtypes.bfloat16, torch.bfloat16)}


def _tied(shape, seed):
  """Seeded data with ties: channel 0 rounded to halves."""
  x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
  x[..., 0] = np.round(x[..., 0] * 2) / 2
  return x


def _both(x32, dtype_name):
  np_dtype, torch_dtype = DTYPES[dtype_name]
  return (jnp.asarray(x32.astype(np_dtype)),
          torch.from_numpy(x32).to(torch_dtype))


def _jax_pool(x, window, strides, pads):
  """The JAX Pallas pool kernel on ``x`` (see module docstring)."""
  if x.dtype == jnp.float32:
    return jax_pool.max_pool_argmax(x, window, strides, pads)
  plan = jax_pool._plan(x.shape, window, strides, pads, np.float32)  # pylint: disable=protected-access
  return jax_pool._pool_call(x, plan)  # pylint: disable=protected-access


def _assert_bitwise(jax_out, torch_out):
  (jv, js), (tv, ts) = jax_out, torch_out
  np.testing.assert_array_equal(
      np.asarray(jv).astype(np.float32), tv.float().numpy())
  np.testing.assert_array_equal(np.asarray(js), ts.numpy())
  assert ts.dtype == torch.int32


def test_qtopt_pads_are_asymmetric_at_full_width():
  pads = {
      name: torch_pool.resolve_padding(padding, window, strides, shape[1:3])
      for name, shape, window, strides, padding in CASES[:3]
  }
  assert pads['pool1'] == ((0, 1), (0, 1))
  assert pads['pool2'] == ((1, 1), (1, 1))
  assert pads['pool3'] == ((0, 1), (0, 1))
  for name, shape, window, strides, padding in CASES[:3]:
    assert pads[name] == jax_pool.resolve_padding(padding, window, strides,
                                                  shape[1:3])


@pytest.mark.parametrize('dtype_name', sorted(DTYPES))
@pytest.mark.parametrize('name,shape,window,strides,padding', CASES,
                         ids=[c[0] for c in CASES])
def test_plain_pool_bitwise_vs_jax(name, shape, window, strides, padding,
                                   dtype_name):
  del name
  jx, tx = _both(_tied(shape, seed=sum(shape)), dtype_name)
  pads = torch_pool.resolve_padding(padding, window, strides, shape[1:3])
  assert pads == jax_pool.resolve_padding(padding, window, strides,
                                          shape[1:3])
  _assert_bitwise(_jax_pool(jx, window, strides, pads),
                  torch_pool.max_pool_argmax(tx, window, strides, pads))


@pytest.mark.parametrize('dtype_name', sorted(DTYPES))
def test_planted_tie_first_slot_wins(dtype_name):
  x = np.zeros((1, 4, 4, 8), np.float32)
  x[0, 1, 1, :] = 5.0   # window (0,0): the max is at slot 3
  x[0, 0, 2, :] = 7.0   # window (0,1): the max is at slot 0
  x[0, 2, 2, :] = 9.0
  x[0, 3, 3, :] = 9.0   # window (1,1): a tie; the FIRST slot (0) wins
  x[0, 0, 0, 1] = x[0, 0, 1, 1] = x[0, 1, 0, 1] = 5.0  # 4-way tie: slot 0
  jx, tx = _both(x, dtype_name)
  pads = ((0, 0), (0, 0))
  out, slot = torch_pool.max_pool_argmax(tx, (2, 2), (2, 2), pads)
  assert (slot[0, 0, 0, 2:] == 3).all() and slot[0, 0, 0, 1] == 0
  assert (slot[0, 0, 1] == 0).all()
  assert (slot[0, 1, 1] == 0).all()
  assert (out[0, 1, 1].float() == 9.0).all()
  _assert_bitwise(_jax_pool(jx, (2, 2), (2, 2), pads), (out, slot))


def test_jax_pool_gate_refuses_bfloat16():
  """Fault of the JAX package: its kernel gate refuses bfloat16, so a
  bfloat16 tower (device_type='tpu') never takes the Pallas pool and falls
  back to reduce_window. The port's kernel takes bfloat16."""
  shape = (64, 236, 236, 64)
  assert jax_pool.is_supported(shape, (3, 3), (3, 3), 'SAME', jnp.float32)
  assert not jax_pool.is_supported(shape, (3, 3), (3, 3), 'SAME',
                                   jnp.bfloat16)
  pads = torch_pool.resolve_padding('SAME', (3, 3), (3, 3), shape[1:3])
  assert torch_pool._plan(shape, (3, 3), (3, 3), pads, torch.bfloat16)  # pylint: disable=protected-access


def test_padding_never_wins():
  """An all-negative window at the padded edge picks a real element."""
  x = -np.abs(_tied((1, 5, 5, 8), seed=3)) - 1.0
  _, slot = torch_pool.max_pool_argmax(torch.from_numpy(x), (3, 3), (3, 3),
                                       ((1, 1), (1, 1)))
  # Window (0, 0) covers padded row 0 and column 0: slots 0-3 and 6 are
  # padding, so the winner is one of the data slots 4, 5, 7, 8.
  assert set(np.unique(slot[0, 0, 0].numpy())) <= {4, 5, 7, 8}


def test_reference_pool_matches_plain():
  """The stock F.max_pool2d form (kernel policy 'none') agrees with the
  kernel's plain version on values."""
  x = torch.from_numpy(_tied((2, 27, 27, 8), seed=5))
  got = torch_pool.max_pool(x, (2, 2), (2, 2), 'SAME')
  ref = torch_pool.reference_max_pool(x, (2, 2), (2, 2), 'SAME')
  assert torch.equal(got, ref)


def test_unsupported_geometry_raises():
  x = torch.zeros((1, 8, 8, 8))
  with pytest.raises(ValueError):
    torch_pool.max_pool_argmax(x, (2, 2), (2, 2), ((2, 0), (0, 0)))
  with pytest.raises(ValueError):
    torch_pool.max_pool_argmax(x.to(torch.int32), (2, 2), (2, 2),
                               ((0, 0), (0, 0)))
