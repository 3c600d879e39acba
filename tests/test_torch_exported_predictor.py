"""The exported predictor on the CPU: the port's ``ExportedModelPredictor``
over a ``torch.export`` program against its own eager ``CheckpointPredictor``
and against the JAX package's ``ExportedModelPredictor`` over the JAX
export of the same weights.

Both packages serve the same seeded numpy variables (``tests/
torch_port_weights.py``; the port through ``utils/convert``) on the tiny
QT-Opt config (96x112 frames, 80x80 crop, ``num_convs=(2, 2, 1)``,
``kernel_policy='pool_conv'``): the JAX side exports with ``jax.export``,
the port with ``torch.export`` (its custom ops run their plain versions on
the CPU).

Bars: the exported program against the eager predictor, bit for bit (the
program runs the same aten ops and the same plain versions in the same
order); against the JAX exported predictor, the serving bands of
``tests/test_torch_cem_serving.py``: float32 ``q_predicted`` atol 1e-6,
bfloat16 atol 4e-3 (two bfloat16 ulps of a q in [0.25, 0.5); the two
frameworks round to bfloat16 at different points).
"""

import os
import shutil
import types

import jax
import numpy as np
import pytest
import torch
from torch_port_weights import random_variables
from torch_serving_fixtures import (  # one_thread: an autouse fixture
    QT_CONFIG, export_predictor, mock_features, one_thread, qtopt_features,
    trained_mock)

from tensor2robot_tpu.export import exporters as jax_exporters
from tensor2robot_tpu.ops import _pallas_dispatch
from tensor2robot_tpu.predictors import (
    CheckpointPredictor as JaxCheckpointPredictor)
from tensor2robot_tpu.predictors import (
    ExportedModelPredictor as JaxExportedModelPredictor)
from tensor2robot_tpu.research.qtopt import (
    GraspingModelWrapper as JaxGraspingModelWrapper)
from tensor2robot_tpu_torch.data import example_codec
from tensor2robot_tpu_torch.export import exporters
from tensor2robot_tpu_torch.observability import metrics as metrics_lib
from tensor2robot_tpu_torch.policies import CEMPolicy
from tensor2robot_tpu_torch.predictors import (CheckpointPredictor,
                                               EagerServingFn,
                                               ExportedModelPredictor)
from tensor2robot_tpu_torch.research.qtopt import GraspingModelWrapper

CEM = dict(action_size=5, cem_samples=16, cem_iters=3, num_elites=4)
BANDS = {'float32': 1e-6, 'bfloat16': 4e-3}


def _served(tmp_path_factory, jax_device_type, torch_device_type):
  """(model, eager predictor, port exported predictor, JAX exported
  predictor), all serving one seeded variables tree at step 3."""
  jax_model = JaxGraspingModelWrapper(device_type=jax_device_type,
                                      **QT_CONFIG)
  jax_predictor = JaxCheckpointPredictor(jax_model, model_dir='unused')
  with _pallas_dispatch.force_kernels(True):
    jax_predictor.init_randomly()
  variables = random_variables(jax.device_get(jax_predictor._variables),  # pylint: disable=protected-access
                               seed=1)
  root = tmp_path_factory.mktemp(f'exports_{torch_device_type}')
  jax_exporters.ModelExporter().export(
      jax_model, types.SimpleNamespace(eval_variables=variables, step=3),
      str(root / 'jax'))
  jax_exported = JaxExportedModelPredictor(str(root / 'jax'))
  assert jax_exported.restore()
  model = GraspingModelWrapper(device_type=torch_device_type, **QT_CONFIG)
  eager = CheckpointPredictor(model, device='cpu')
  eager.load_variables(variables, global_step=3)
  export_predictor(model, eager, root / 'port')
  exported = ExportedModelPredictor(str(root / 'port'), device='cpu')
  assert exported.restore()
  return model, eager, exported, jax_exported


@pytest.fixture(scope='module', params=['float32', 'bfloat16'])
def served(request, tmp_path_factory):
  devices = {'float32': ('cpu', 'cpu'), 'bfloat16': ('tpu', 'gpu')}
  return (request.param,) + _served(tmp_path_factory,
                                    *devices[request.param])


def test_exported_matches_eager_bit_for_bit(served):
  dtype, model, eager, exported, _ = served
  assert model.compute_dtype == getattr(torch, dtype)
  assert exported.stateless_serving_fn().program_key[0] == 'torch_export'
  features = qtopt_features(7, 16)
  got = exported.predict(features)['q_predicted']
  want = eager.predict(features)['q_predicted']
  assert got.dtype == np.float32 and got.shape == (16,)
  np.testing.assert_array_equal(got, want)
  assert np.diff(np.sort(want)).min() > 0  # distinct scores
  fn = exported.device_serving_fn()
  device = fn({k: torch.from_numpy(v) for k, v in features.items()})
  np.testing.assert_array_equal(device['q_predicted'].numpy(), want)


def test_exported_matches_jax_exported_within_the_serving_band(served):
  dtype, _, _, exported, jax_exported = served
  features = qtopt_features(8, 16)
  want = jax_exported.predict(features)['q_predicted']
  got = exported.predict(features)['q_predicted']
  assert exported.global_step == jax_exported.global_step == 3
  np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                             atol=BANDS[dtype])


@pytest.mark.parametrize('seed', [5, 11])
def test_device_resident_cem_through_the_exported_predictor(served, seed):
  _, model, eager, exported, _ = served
  state = np.random.RandomState(seed).randint(
      0, 256, QT_CONFIG['input_shape']).astype(np.uint8)
  actions = []
  for predictor in (eager, exported):
    np.random.seed(seed)
    actions.append(CEMPolicy(t2r_model=model, predictor=predictor,
                             device_resident=True,
                             **CEM).get_cem_action_device(state, None, 0))
  (want, want_debug), (got, debug) = actions
  assert got.shape == (5,)
  np.testing.assert_array_equal(got, want)
  assert debug['q_predicted'] == want_debug['q_predicted']


def test_predict_example_bytes_and_warmup(served):
  _, _, eager, exported, _ = served
  spec = exported.get_feature_specification()
  features = qtopt_features(9, 2)
  records = [example_codec.encode_example(
      spec, {k: v[b] for k, v in features.items()}) for b in range(2)]
  got = exported.predict_example_bytes(records)['q_predicted']
  np.testing.assert_array_equal(got, eager.predict(features)['q_predicted'])
  assert exported.warmup() == 2  # the two serialized warmup examples


def test_warmup_falls_back_to_the_npz_requests(tmp_path):
  trainer, model = trained_mock(tmp_path)
  root = tmp_path / 'export'
  path = exporters.ModelExporter().export(model, trainer.state, str(root))
  os.remove(os.path.join(path, 'assets.extra',
                         exporters.WARMUP_EXAMPLES_FILENAME))
  predictor = ExportedModelPredictor(str(root), device='cpu')
  assert predictor.restore() and predictor.warmup() == 2


def test_predict_without_model_class(tmp_path, monkeypatch):
  trainer, model = trained_mock(tmp_path)
  root = str(tmp_path / 'export')
  exporters.ModelExporter().export(model, trainer.state, root)

  def refuse(*args, **kwargs):
    raise AssertionError('the model class must not be loaded')

  monkeypatch.setattr(exporters, 'load_model_from_export_dir', refuse)
  predictor = ExportedModelPredictor(root, device='cpu')
  assert predictor.restore() and predictor._model is None  # pylint: disable=protected-access
  out = predictor.predict(mock_features(0.3, n=3))['a_predicted']
  want = trainer.predict(mock_features(0.3, n=3))['a_predicted']
  np.testing.assert_array_equal(out, want)
  # A single example may come without its batch dim.
  single = predictor.predict({'measured_position': np.zeros(2, np.float32)})
  assert single['a_predicted'].shape == (1,)


def test_model_class_path_without_the_program(tmp_path):
  trainer, model = trained_mock(tmp_path)
  root = str(tmp_path / 'export')
  exporters.ModelExporter(serialize_serving=False).export(
      model, trainer.state, root)
  predictor = ExportedModelPredictor(root, device='cpu')
  assert predictor.restore()
  serving = predictor.stateless_serving_fn()
  assert isinstance(serving.fn, EagerServingFn)
  assert serving.program_key[0] == 'eager_forward'
  np.testing.assert_array_equal(
      predictor.predict(mock_features(0.4, n=2))['a_predicted'],
      trainer.predict(mock_features(0.4, n=2))['a_predicted'])


def test_hot_reload_and_the_last_good_generation(tmp_path):
  trainer, model = trained_mock(tmp_path)
  root = str(tmp_path / 'export')
  exporter = exporters.ModelExporter()
  exporter.export(model, trainer.state, root, version=1)
  predictor = ExportedModelPredictor(root, device='cpu')
  assert predictor.restore() and predictor.global_step == 5
  first = predictor.stateless_serving_fn()
  state = trainer.state.eval_state_dict()
  moved = {k: v + 0.25 if v.is_floating_point() else v
           for k, v in state.items()}
  exporter.export(model, exporters.ServingState(105, moved), root, version=2)
  assert predictor.restore() and predictor.global_step == 105
  second = predictor.stateless_serving_fn()
  # A weights-only version keeps the loaded program and swaps the params.
  assert second.fn is first.fn and second.program_key == first.program_key
  assert second.params is not first.params
  assert not torch.equal(second.params['dense_0.weight'],
                         first.params['dense_0.weight'])
  before = predictor.predict(mock_features(0.5, n=2))
  # A committed version whose state cannot load: the last good one stays.
  broken = os.path.join(root, '3')
  shutil.copytree(os.path.join(root, '2'), broken)
  with open(os.path.join(broken, 'state', exporters.STATE_FILENAME),
            'wb') as f:
    f.write(b'not a checkpoint')
  fallbacks = metrics_lib.counter('predictor/load_fallbacks')
  count = fallbacks.value
  assert predictor.restore()
  assert fallbacks.value == count + 1
  assert predictor.global_step == 105 and predictor.model_path.endswith('2')
  np.testing.assert_array_equal(
      predictor.predict(mock_features(0.5, n=2))['a_predicted'],
      before['a_predicted'])


def test_first_load_failure_raises_and_timeout_returns_false(tmp_path):
  predictor = ExportedModelPredictor(str(tmp_path / 'none'), timeout=0.1,
                                     device='cpu')
  assert not predictor.restore()
  with pytest.raises(ValueError, match='restore'):
    predictor.get_feature_specification()
  trainer, model = trained_mock(tmp_path)
  root = str(tmp_path / 'export')
  path = exporters.ModelExporter().export(model, trainer.state, root)
  os.remove(os.path.join(path, 'state', exporters.STATE_FILENAME))
  with pytest.raises(FileNotFoundError):
    ExportedModelPredictor(root, device='cpu').restore()
