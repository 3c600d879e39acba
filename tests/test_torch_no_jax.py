"""The port stands alone: no JAX, no JAX package, no quiet CPU fallback.

* Static: an ``ast`` scan of every module of ``tensor2robot_tpu_torch``
  and of ``chip_smoke.py`` finds no import of ``jax``, ``flax``,
  ``optax``, ``orbax``, ``ml_dtypes`` or the ``tensor2robot_tpu`` package
  (matched as the exact name or the ``tensor2robot_tpu.`` prefix, since
  ``tensor2robot_tpu_torch`` shares the prefix).
* Runtime: a subprocess blocks those packages in ``sys.modules`` and
  imports every module of the port.
* Dispatch: a CPU tensor takes the plain path and bumps no launch counter;
  a forced-kernel run and a CUDA request on a host with no card raise.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import tensor2robot_tpu_torch
from tensor2robot_tpu_torch.ops import _dispatch, conv_s2d, pool
from tensor2robot_tpu_torch.predictors import CheckpointPredictor
from tensor2robot_tpu_torch.research.qtopt import GraspingModelWrapper

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = pathlib.Path(tensor2robot_tpu_torch.__file__).resolve().parent
BLOCKED_ROOTS = ('jax', 'flax', 'optax', 'orbax', 'ml_dtypes')


def _is_blocked(name: str) -> bool:
  if name.split('.')[0] in BLOCKED_ROOTS:
    return True
  return name == 'tensor2robot_tpu' or name.startswith('tensor2robot_tpu.')


def _imported_names(path: pathlib.Path):
  tree = ast.parse(path.read_text(), filename=str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module
      for alias in node.names:
        yield f'{node.module}.{alias.name}'


def _port_sources():
  return sorted(PACKAGE.rglob('*.py'))


def test_blocked_name_matching():
  assert _is_blocked('jax.numpy') and _is_blocked('flax')
  assert _is_blocked('tensor2robot_tpu') and _is_blocked('tensor2robot_tpu.ops')
  assert not _is_blocked('tensor2robot_tpu_torch.ops')
  assert not _is_blocked('jaxtyping')


def test_static_scan_finds_no_jax_import():
  sources = _port_sources() + [REPO / 'chip_smoke.py']
  assert len(sources) > 20
  offenders = [(str(path.relative_to(REPO)), name)
               for path in sources for name in _imported_names(path)
               if _is_blocked(name)]
  assert not offenders


def test_every_port_module_imports_with_jax_blocked():
  modules = sorted(
      '.'.join(('tensor2robot_tpu_torch',) + path.relative_to(
          PACKAGE).with_suffix('').parts).removesuffix('.__init__')
      for path in _port_sources())
  script = '\n'.join([
      'import importlib, sys',
      f'for name in {BLOCKED_ROOTS + ("tensor2robot_tpu",)!r}:',
      '  sys.modules[name] = None',
      f'for module in {modules!r}:',
      '  importlib.import_module(module)',
      'leaked = [m for m in sys.modules if m.startswith("tensor2robot_tpu.")',
      '          and sys.modules[m] is not None]',
      'assert not leaked, leaked',
      'print("imported", len(' + repr(modules) + '))',
  ])
  env = dict(os.environ, PYTHONPATH=str(REPO))
  result = subprocess.run([sys.executable, '-c', script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
  assert result.returncode == 0, result.stderr[-2000:]
  assert f'imported {len(modules)}' in result.stdout


def test_cpu_tensor_takes_plain_path_without_launching():
  pool.pool_fwd.launches = 0
  conv_s2d.conv_s2d_fwd.launches = 0
  x = torch.from_numpy(np.random.RandomState(0).randn(2, 27, 27, 8)
                       .astype(np.float32))
  out, slot = pool.max_pool_argmax(x, (2, 2), (2, 2), ((0, 1), (0, 1)))
  want = pool.plain_max_pool_argmax(x, (2, 2), (2, 2), ((0, 1), (0, 1)))
  assert torch.equal(out, want[0]) and torch.equal(slot, want[1])
  image = torch.zeros((1, 20, 20, 3))
  kernel = torch.zeros((6, 6, 3, 8))
  assert conv_s2d.conv2d(image, kernel, (2, 2), 'SAME').shape == (1, 10, 10,
                                                                  8)
  assert pool.pool_fwd.launches == 0
  assert conv_s2d.conv_s2d_fwd.launches == 0


def test_kernel_wrappers_refuse_cpu_tensors():
  x = torch.zeros((1, 8, 8, 8))
  with pytest.raises(ValueError, match='CUDA'):
    pool.pool_fwd(x, (2, 2), (2, 2), ((0, 0), (0, 0)))
  with pytest.raises(ValueError, match='CUDA'):
    conv_s2d.conv_s2d_fwd(torch.zeros((1, 8, 8, 3)),
                          torch.zeros((3, 3, 3, 8)), (1, 1),
                          ((1, 1), (1, 1)))
  assert pool.pool_fwd.launches == 0


def test_forced_kernels_raise_on_cpu_tensor(monkeypatch):
  x = torch.zeros((1, 8, 8, 8))
  with _dispatch.force_kernels(True):
    with pytest.raises(RuntimeError, match='forced on'):
      pool.max_pool(x, (2, 2), (2, 2), 'VALID')
  monkeypatch.setenv('T2R_FORCE_PALLAS_KERNELS', '1')
  with pytest.raises(RuntimeError, match='forced on'):
    conv_s2d.conv2d(torch.zeros((1, 8, 8, 3)), torch.zeros((3, 3, 3, 8)),
                    (1, 1), 'SAME')
  monkeypatch.setenv('T2R_FORCE_PALLAS_KERNELS', '0')
  assert pool.max_pool(x, (2, 2), (2, 2), 'VALID').shape == (1, 4, 4, 8)


def test_cuda_request_without_card_raises(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  model = GraspingModelWrapper(device_type='gpu', kernel_policy='pool_conv')
  with pytest.raises(RuntimeError, match='no CUDA card'):
    CheckpointPredictor(model)
  with pytest.raises(RuntimeError, match='no CUDA card'):
    CheckpointPredictor(model, device='cuda:0')
  assert CheckpointPredictor(model, device='cpu').device.type == 'cpu'


def test_kernel_policy_validation():
  assert _dispatch.validate_kernel_policy(None) == 'none'
  assert _dispatch.policy_enables_pool('pool')
  assert not _dispatch.policy_enables_conv('pool')
  assert _dispatch.policy_enables_conv('pool_conv')
  with pytest.raises(ValueError):
    _dispatch.validate_kernel_policy('all')
