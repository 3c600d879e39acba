"""Shared helpers of the port's export, predictor and batching tests.

* :func:`trained_mock`: the port's ``MockT2RModel`` trained a few steps on
  the CPU (the JAX suite's ``_trained_trainer``), for the filesystem and
  serving-plane contracts.
* :func:`qtopt_predictor`: the tiny QT-Opt config of ``tests/
  test_qtopt.py`` (96x112 frames, 80x80 crop, ``num_convs=(2, 2, 1)``,
  ``kernel_policy='pool_conv'``) in a ``CheckpointPredictor`` with seeded
  weights of std 1/sqrt(fan_in), so that candidate actions score apart.
* :func:`qtopt_features`: seeded numpy frames and actions for it.
* :func:`paired_qtopt_variables` and :func:`paired_qtopt_exports`: one
  seeded variables tree for both packages, and exported by the JAX package
  (``jax.export``) and by the port (``torch.export``, through
  ``utils/convert``), on the CPU, for the HTTP and quantized-serving parity
  tests.
* :func:`one_thread`: a module fixture, autouse wherever it is imported.
"""

import os

import numpy as np
import pytest
import torch

from tensor2robot_tpu_torch.export import exporters
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.predictors import CheckpointPredictor
from tensor2robot_tpu_torch.research.qtopt import GraspingModelWrapper
from tensor2robot_tpu_torch.train import Trainer, TrainerConfig
from tensor2robot_tpu_torch.utils.mocks import MockInputGenerator, MockT2RModel

QT_CONFIG = dict(input_shape=(96, 112, 3), target_shape=(80, 80),
                 num_convs=(2, 2, 1), kernel_policy='pool_conv')


@pytest.fixture(scope='module', autouse=True)
def one_thread():
  """One intra-op thread for an importing file's torch work: the suite
  runs six worker processes on the host's cores, and torch's default of a
  thread a core oversubscribes them."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def trained_mock(tmp_path, steps=5, callbacks=(), **config_kwargs):
  """(trainer, model): the mock model trained ``steps`` steps on the CPU
  with a checkpoint at the end (and every ``save_interval_steps``)."""
  model = MockT2RModel()
  config = dict(model_dir=str(tmp_path / 'm'), max_train_steps=steps,
                save_interval_steps=steps, eval_interval_steps=0,
                log_interval_steps=0, async_checkpoints=False)
  config.update(config_kwargs)
  trainer = Trainer(model, TrainerConfig(**config), device='cpu',
                    callbacks=callbacks)
  gen = MockInputGenerator(batch_size=8)
  gen.set_specification_from_model(model, ModeKeys.TRAIN)
  trainer.train(gen.create_iterator(ModeKeys.TRAIN))
  return trainer, model


def at_step(trainer, step):
  """The trainer's serving state re-stamped at ``step`` (the JAX suite's
  ``state.replace(step=...)``)."""
  return exporters.ServingState(step, trainer.state.eval_state_dict())


def mock_features(value: float, n: int = 1):
  return {'measured_position': np.full((n, 2), value, np.float32)}


def spread_state_dict(network, seed: int):
  """Kernels of std 1/sqrt(fan_in), BatchNorm scales near 1, variances in
  [0.5, 1.5), biases and means of std 0.1."""
  generator = torch.Generator().manual_seed(seed)
  state = {}
  for name, value in network.state_dict().items():
    if name.endswith(('kernel', 'weight')):
      fan_in = (value[..., 0].numel() if name.endswith('kernel') else
                value[0].numel())
      value = torch.randn(value.shape, generator=generator) / fan_in**0.5
    elif name.endswith('scale'):
      value = 1.0 + 0.1 * torch.randn(value.shape, generator=generator)
    elif name.endswith('var'):
      value = 0.5 + torch.rand(value.shape, generator=generator)
    else:
      value = 0.1 * torch.randn(value.shape, generator=generator)
    state[name] = value
  return state


def qtopt_model(device_type='gpu', kernel_policy='pool_conv'):
  config = dict(QT_CONFIG, kernel_policy=kernel_policy)
  return GraspingModelWrapper(device_type=device_type, **config)


def qtopt_predictor(device_type='gpu', seed=1, kernel_policy='pool_conv'):
  """(model, CheckpointPredictor on the CPU with spread weights)."""
  model = qtopt_model(device_type, kernel_policy)
  predictor = CheckpointPredictor(model, device='cpu')
  predictor.load_state_dict(spread_state_dict(model.create_module(), seed),
                            global_step=seed)
  return model, predictor


def qtopt_features(seed: int, n: int):
  rng = np.random.RandomState(seed)
  return {
      'state/image': rng.randint(0, 256, (n,) + QT_CONFIG['input_shape'],
                                 dtype=np.uint8),
      'action/world_vector': rng.randn(n, 3).astype(np.float32),
      'action/vertical_rotation': rng.randn(n, 2).astype(np.float32),
  }


def export_predictor(model, predictor, root, version=None, **kwargs) -> str:
  """Exports a ``CheckpointPredictor``'s weights as one version of
  ``root``; returns the version dir."""
  state = exporters.ServingState(predictor.global_step,
                                 predictor.network.state_dict())
  return exporters.ModelExporter(**kwargs).export(model, state, str(root),
                                                  version=version)


def version_files(path):
  """Relative paths of every file under a version dir."""
  out = []
  for dirpath, _, files in os.walk(path):
    for name in files:
      out.append(os.path.relpath(os.path.join(dirpath, name), path))
  return sorted(out)


def paired_qtopt_variables(seed: int = 1, bfloat16: bool = False):
  """(JAX model, port model, variables): one seeded numpy variables tree of
  the tiny QT-Opt config (``tests/torch_port_weights.py``), with the
  float32 or the bfloat16 dtype policy on both sides."""
  import jax  # pylint: disable=import-outside-toplevel
  from torch_port_weights import random_variables  # pylint: disable=import-outside-toplevel

  from tensor2robot_tpu.ops import _pallas_dispatch  # pylint: disable=import-outside-toplevel
  from tensor2robot_tpu.predictors import (  # pylint: disable=import-outside-toplevel
      CheckpointPredictor as JaxCheckpointPredictor)
  from tensor2robot_tpu.research.qtopt import (  # pylint: disable=import-outside-toplevel
      GraspingModelWrapper as JaxGraspingModelWrapper)

  jax_model = JaxGraspingModelWrapper(
      device_type='tpu' if bfloat16 else 'cpu', **QT_CONFIG)
  jax_predictor = JaxCheckpointPredictor(jax_model, model_dir='unused')
  with _pallas_dispatch.force_kernels(True):
    jax_predictor.init_randomly()
  variables = random_variables(jax.device_get(jax_predictor._variables),  # pylint: disable=protected-access
                               seed=seed)
  model = GraspingModelWrapper(device_type='gpu' if bfloat16 else 'cpu',
                               **QT_CONFIG)
  return jax_model, model, variables


def paired_qtopt_exports(root, seed: int = 1, step: int = 3,
                         bfloat16: bool = False):
  """(model, eager port predictor, JAX export root, port export root) of
  one seeded variables tree of the tiny QT-Opt config (float32 unless
  ``bfloat16``)."""
  import types  # pylint: disable=import-outside-toplevel

  from tensor2robot_tpu.export import exporters as jax_exporters  # pylint: disable=import-outside-toplevel

  jax_model, model, variables = paired_qtopt_variables(seed, bfloat16)
  jax_root, port_root = str(root / 'jax'), str(root / 'port')
  jax_exporters.ModelExporter().export(
      jax_model, types.SimpleNamespace(eval_variables=variables, step=step),
      jax_root)
  eager = CheckpointPredictor(model, device='cpu')
  eager.load_variables(variables, global_step=step)
  export_predictor(model, eager, root / 'port')
  return model, eager, jax_root, port_root
