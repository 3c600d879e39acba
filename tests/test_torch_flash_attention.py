"""Port parity: flash attention's plain versions against the JAX kernels.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
``tests/test_flash_attention.py`` does; the port runs the plain versions
(``plain_flash_fwd``, ``plain_flash_dq``, ``plain_flash_dkv``) behind its
autograd Function, because the tensors lie on the CPU. Bars are the JAX
suite's: float32 output atol 2e-5, gradients atol 5e-4, bfloat16 output
atol 3e-2. The kernels themselves are held to the plain versions on the
card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.ops import flash_attention as jax_fa
from tensor2robot_tpu.parallel import sequence_parallel as jax_sp
from tensor2robot_tpu_torch.ops import flash_attention as fa
from tensor2robot_tpu_torch.parallel import sequence_parallel as sp

SHAPES = [  # the JAX suite's (tests/test_flash_attention.py)
    ((2, 256, 2, 32), 64, 128),
    ((1, 512, 4, 64), 256, 512),
    ((1, 128, 2, 16), 128, 128),
    ((1, 256, 2, 16), 128, 64),
]


def _qkv(shape, seed=0):
  rng = np.random.RandomState(seed)
  return tuple(rng.randn(*shape).astype(np.float32) for _ in range(3))


def _torch(*arrays, dtype=torch.float32, grad=False):
  return tuple(torch.from_numpy(a).to(dtype).requires_grad_(grad)
               for a in arrays)


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('shape,bq,bk', SHAPES)
def test_forward_matches_jax_kernel(shape, bq, bk, causal):
  q, k, v = _qkv(shape)
  want = jax_fa.flash_attention(*map(jnp.asarray, (q, k, v)), causal, bq, bk)
  got = fa.flash_attention(*_torch(q, k, v), causal, bq, bk)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def _jax_grads(q, k, v, ct, causal, bq, bk):
  def loss(q, k, v):
    out = jax_fa.flash_attention(q, k, v, causal, bq, bk)
    return jnp.sum(out.astype(jnp.float32) * ct)
  return jax.grad(loss, argnums=(0, 1, 2))(
      *map(jnp.asarray, (q, k, v)))


def _port_grads(q, k, v, ct, causal, bq, bk):
  tq, tk, tv = _torch(q, k, v, grad=True)
  out = fa.flash_attention(tq, tk, tv, causal, bq, bk)
  (out * torch.from_numpy(ct)).sum().backward()
  return out, (tq.grad, tk.grad, tv.grad)


@pytest.mark.parametrize('streamed', [False, True],
                         ids=['staged', 'streamed'])
@pytest.mark.parametrize('causal', [False, True])
def test_gradients_match_jax_kernel(monkeypatch, causal, streamed):
  """dq, dk, dv through both packages' custom backward; ``streamed``
  sets both packages' staging budget to 1 byte, so the JAX side runs its
  streamed kernels and the port resolves the streamed regime's blocks."""
  if streamed:
    monkeypatch.setattr(jax_fa, '_MAX_STAGED_KV_BYTES', 1)
    monkeypatch.setattr(fa, '_MAX_STAGED_KV_BYTES', 1)
    assert fa._use_streamed(256, 32, 4)
  q, k, v = _qkv((2, 256, 2, 32), seed=1)
  ct = np.random.RandomState(2).randn(2, 256, 2, 32).astype(np.float32)
  want = _jax_grads(q, k, v, ct, causal, 64, 128)
  out, got = _port_grads(q, k, v, ct, causal, 64, 128)
  want_out = jax_fa.flash_attention(*map(jnp.asarray, (q, k, v)), causal, 64,
                                    128)
  np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                             atol=2e-5)
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4)


@pytest.mark.parametrize('causal', [False, True])
def test_gradients_match_the_dense_oracle(causal):
  """The port's flash gradients against autograd of its own dense
  reference_attention (the JAX suite's oracle test)."""
  q, k, v = _qkv((1, 128, 2, 16), seed=5)
  ct = torch.from_numpy(
      np.random.RandomState(6).randn(1, 128, 2, 16).astype(np.float32))
  grads = []
  for fn in (lambda *a: fa.flash_attention(*a, causal, 64, 32),
             lambda *a: sp.reference_attention(*a, causal=causal)):
    args = _torch(q, k, v, grad=True)
    (fn(*args) * ct).sum().backward()
    grads.append([a.grad for a in args])
  for got, want in zip(*grads):
    torch.testing.assert_close(got, want, atol=5e-4, rtol=0)


def test_reference_attention_matches_jax():
  q, k, v = _qkv((2, 64, 2, 8), seed=9)
  for causal in (False, True):
    got = sp.reference_attention(*_torch(q, k, v), causal=causal)
    want = jax_sp.reference_attention(*map(jnp.asarray, (q, k, v)),
                                      causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize('causal', [False, True])
def test_bfloat16_forward_matches_jax_kernel(causal):
  q, k, v = _qkv((2, 256, 2, 32), seed=3)
  want = jax_fa.flash_attention(
      *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal, 64, 128)
  got = fa.flash_attention(*_torch(q, k, v, dtype=torch.bfloat16), causal,
                           64, 128)
  assert got.dtype == torch.bfloat16
  np.testing.assert_allclose(got.float().numpy(),
                             np.asarray(want.astype(jnp.float32)), atol=3e-2)


@pytest.mark.parametrize('streamed', [False, True],
                         ids=['staged', 'streamed'])
@pytest.mark.parametrize('causal', [False, True])
def test_logsumexp_matches_jax_kernel(monkeypatch, causal, streamed):
  if streamed:
    monkeypatch.setattr(jax_fa, '_MAX_STAGED_KV_BYTES', 1)
    monkeypatch.setattr(fa, '_MAX_STAGED_KV_BYTES', 1)
  q, k, v = _qkv((2, 128, 2, 16), seed=4)
  out, res = jax_fa._flash_fwd(*map(jnp.asarray, (q, k, v)), causal, 64, 32)
  want_lse = np.asarray(res[4])
  got_out, got_lse = fa.plain_flash_fwd(*_torch(q, k, v), causal, 64, 32)
  assert got_lse.dtype == torch.float32
  assert tuple(got_lse.shape) == want_lse.shape == (4, 1, 128)
  np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=2e-5)
  np.testing.assert_allclose(got_out.numpy(), np.asarray(out), atol=2e-5)


def test_predicates_match_jax_interpret_mode():
  """is_supported, _use_streamed and _resolve_blocks over a grid of
  (T, D, itemsize, blocks), against the JAX package off-TPU."""
  for t in (8, 16, 24, 40, 80, 100, 128, 136, 1024, 4096, 33792, 65536,
            131072):
    for d in (4, 8, 12, 64, 120, 128, 136):
      for itemsize in (2, 4):
        assert fa._use_streamed(t, d, itemsize) == jax_fa._use_streamed(
            t, d, itemsize), (t, d, itemsize)
        for blocks in ((None, None), (64, 128), (128, None), (None, 24)):
          assert fa._resolve_blocks(t, d, *blocks, itemsize) == (
              jax_fa._resolve_blocks(t, d, *blocks, itemsize))
          assert fa.is_supported(t, d, *blocks, itemsize=itemsize) == (
              jax_fa.is_supported(t, d, *blocks, interpret=True,
                                  itemsize=itemsize)), (t, d, blocks)


@pytest.mark.parametrize('shape,bq,bk', [
    ((1, 100, 2, 16), 64, 64),     # not divisible by the blocks
    ((1, 128, 2, 256), 128, 128),  # head dim above 128
    ((1, 128, 2, 12), 128, 128),   # head dim not a multiple of 8
    ((1, 60, 2, 16), 60, 60),      # blocks not a multiple of 8
])
def test_check_raises_the_jax_errors(shape, bq, bk):
  q, _, _ = _qkv(shape)
  with pytest.raises(ValueError) as want:
    jax_fa._check(jnp.asarray(q), bq, bk)
  with pytest.raises(ValueError) as got:
    fa._check(torch.from_numpy(q), bq, bk)
  assert str(got.value) == str(want.value)


def test_cpu_tensors_bump_no_launch_counter():
  q, k, v = _qkv((1, 64, 2, 8), seed=8)
  before = (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches)
  args = _torch(q, k, v, grad=True)
  fa.flash_attention(*args, causal=True).sum().backward()
  assert all(a.grad is not None for a in args)
  assert (fa.flash_fwd.launches, fa.flash_dq.launches,
          fa.flash_dkv.launches) == before
  with pytest.raises(ValueError, match='CUDA'):
    fa.flash_fwd(*_torch(q, k, v))


def test_jax_tpu_gate_refuses_the_sequential_shape():
  """On a TPU the JAX package's predicate demands 128-row blocks (Mosaic's
  lane tile), so the sequential model's attention (T=80, head dim 64)
  never took the Pallas kernel there; the port's predicate keeps the
  package's off-TPU block minimum of 8, and the card runs the kernel."""
  assert not jax_fa.is_supported(80, 64, interpret=False, itemsize=4)
  assert jax_fa.is_supported(80, 64, interpret=True, itemsize=4)
  assert fa.is_supported(80, 64, itemsize=4)
  # The long-horizon shape (T=1024, head dim 8) takes it on both.
  assert jax_fa.is_supported(1024, 8, interpret=False, itemsize=4)
  assert fa.is_supported(1024, 8, itemsize=4)
