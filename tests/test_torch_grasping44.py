"""Port parity: Grasping44 against the JAX network.

JAX ``Grasping44(kernel_policy='pool_conv')`` runs its Pallas pool and
conv kernels through the interpreter (``force_kernels(True)``, as
``tests/test_kernels.py`` does); the port runs the kernels' plain versions
on the CPU. Both get the same seeded numpy weights (the port through
``utils/convert.py``) on the tiny config of ``tests/test_qtopt.py``:
80x80 images, ``num_convs=(2, 2, 1)``, float32.

Tolerances (float32; sums are reassociated, the conv1 matmul and the
batch-norm reductions run in another order):
* eval logits: atol 1e-5; predictions: atol 1e-6;
* train-mode logits: atol 2e-4, since batch statistics over a batch of 4
  divide by small variances and amplify the reassociation noise;
* batch statistics after one train-mode forward: atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_weights import random_variables

from tensor2robot_tpu.ops import _pallas_dispatch
from tensor2robot_tpu.research.qtopt import networks as jax_networks
from tensor2robot_tpu_torch.research.qtopt import networks as torch_networks
from tensor2robot_tpu_torch.utils import convert

IMAGE = (80, 80)
NUM_CONVS = (2, 2, 1)
BATCH = 4


@pytest.fixture(scope='module')
def setup():
  rng = np.random.RandomState(0)
  images = rng.rand(BATCH, *IMAGE, 3).astype(np.float32)
  params = rng.randn(BATCH, 5).astype(np.float32)
  jax_net = jax_networks.Grasping44(num_convs=NUM_CONVS,
                                    kernel_policy='pool_conv')
  shapes = jax.eval_shape(lambda: jax_net.init(
      jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(params)))
  variables = random_variables(shapes, seed=1)
  torch_net = torch_networks.Grasping44(
      image_size=IMAGE, grasp_param_size=5, num_convs=NUM_CONVS,
      kernel_policy='pool_conv')
  torch_net.load_state_dict(convert.jax_variables_to_torch(variables),
                            strict=True)
  return images, params, jax_net, variables, torch_net


def _torch_forward(net, images, params, train):
  net.train(train)
  with torch.no_grad():
    return net(torch.from_numpy(images), torch.from_numpy(params))


@pytest.mark.parametrize('action_batched', [False, True])
def test_eval_forward_matches_jax(setup, action_batched):
  images, params, jax_net, variables, torch_net = setup
  if action_batched:  # the rank-3 [B, A, P] CEM broadcast
    params = np.random.RandomState(2).randn(BATCH, 3, 5).astype(np.float32)
  with _pallas_dispatch.force_kernels(True):
    jax_logits, jax_ends = jax_net.apply(
        variables, jnp.asarray(images), jnp.asarray(params), train=False)
  logits, ends = _torch_forward(torch_net, images, params, train=False)
  assert logits.dtype == torch.float32
  assert tuple(ends['predictions'].shape) == (
      (BATCH, 3) if action_batched else (BATCH,))
  np.testing.assert_allclose(logits.numpy(), np.asarray(jax_logits),
                             rtol=0, atol=1e-5)
  np.testing.assert_allclose(ends['predictions'].numpy(),
                             np.asarray(jax_ends['predictions']),
                             rtol=0, atol=1e-6)


@pytest.mark.parametrize('action_batched', [False, True])
def test_train_forward_and_batch_stats_match_jax(setup, action_batched):
  images, params, jax_net, variables, _ = setup
  if action_batched:
    params = np.random.RandomState(3).randn(BATCH, 2, 5).astype(np.float32)
  # A fresh module per case: train mode updates its buffers in place.
  torch_net = torch_networks.Grasping44(
      image_size=IMAGE, grasp_param_size=5, num_convs=NUM_CONVS,
      kernel_policy='pool_conv')
  torch_net.load_state_dict(convert.jax_variables_to_torch(variables))
  with _pallas_dispatch.force_kernels(True):
    (jax_logits, _), mutated = jax_net.apply(
        variables, jnp.asarray(images), jnp.asarray(params), train=True,
        mutable=['batch_stats'])
  logits, _ = _torch_forward(torch_net, images, params, train=True)
  np.testing.assert_allclose(logits.numpy(), np.asarray(jax_logits),
                             rtol=0, atol=2e-4)

  want = convert.jax_variables_to_torch({
      'params': variables['params'],
      'batch_stats': jax.device_get(mutated['batch_stats']),
  })
  got = torch_net.state_dict()
  stats = [k for k in want if k.endswith(('.mean', '.var'))]
  assert len(stats) == 2 * (1 + sum(NUM_CONVS) + 1 + 2)
  before = convert.jax_variables_to_torch(variables)
  for key in stats:
    assert not torch.equal(before[key], want[key]), key
    np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                               rtol=0, atol=1e-6, err_msg=key)


def test_full_width_geometry():
  """At 472x472 the tower flattens 8x8x64 features into fc0, and the
  parameter tree holds every layer of num_convs=(6, 6, 3)."""
  net = torch_networks.Grasping44()
  shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
  assert shapes['fc0.weight'] == (64, 8 * 8 * 64)
  assert shapes['conv1_1.kernel'] == (6, 6, 3, 64)
  assert shapes['conv2.conv.weight'] == (64, 64, 5, 5)
  assert shapes['conv14.conv.weight'] == (64, 64, 3, 3)
  assert 'conv17.conv.weight' not in shapes


def test_converter_rejects_unmapped_and_unknown_collections(setup):
  _, _, _, variables, _ = setup
  extra = dict(variables)
  extra['fp8_stats'] = {'conv2': {'amax': np.zeros((16,), np.float32)}}
  with pytest.raises(ValueError, match='fp8_stats'):
    convert.jax_variables_to_torch(extra)
  params = dict(variables['params'])
  params['mystery'] = {'kernel': np.zeros((2, 2), np.float32)}
  with pytest.raises(ValueError, match='mystery'):
    convert.jax_variables_to_torch({'params': params,
                                    'batch_stats': variables['batch_stats']})
  missing = {'params': variables['params']}
  net = torch_networks.Grasping44(image_size=IMAGE, num_convs=NUM_CONVS)
  with pytest.raises(RuntimeError, match='Missing key'):
    net.load_state_dict(convert.jax_variables_to_torch(missing), strict=True)


def test_init_weights_is_seeded_truncated_normal():
  nets = [torch_networks.Grasping44(image_size=IMAGE, num_convs=NUM_CONVS)
          for _ in range(2)]
  for net in nets:
    net.init_weights(torch.Generator().manual_seed(3))
  a, b = (n.state_dict() for n in nets)
  assert all(torch.equal(a[k], b[k]) for k in a)
  kernel = a['conv2.conv.weight']
  assert float(kernel.abs().max()) <= 0.02
  assert 0.007 < float(kernel.std()) < 0.01
  assert torch.equal(a['conv2.bn.scale'], torch.ones(64))
  assert torch.equal(a['bn1.var'], torch.ones(64))
  assert torch.equal(a['logit.bias'], torch.zeros(1))
