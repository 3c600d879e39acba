"""Exported serving programs of SNAIL and Grasp2Vec, on the CPU.

Three models, each at a small size: SNAIL sequential and SNAIL
long-horizon (episode 8, so T = 16; 48x48 crops of the 220x300 frames;
long-horizon 2 heads of 8; float32) with seeded JAX variables carried
across by ``utils/convert.snail_variables_to_torch``, and Grasp2Vec
(ResNet-18 towers, 64x64 crops of the 512x640 frames, bfloat16 towers,
``kernel_policy='pool'``) with seeded weights.

Each is exported by ``ModelExporter`` and must write
``self_contained_serving_fn: true`` with its kernel nodes in the meta:
two ``t2r.flash_fwd`` for either SNAIL (one per attention block), two
``t2r.pool_fwd`` for Grasp2Vec (each tower's stem pool). One process that
cannot import ``tensor2robot_tpu_torch.research`` or ``.models`` loads all
three versions and predicts at batches 1 and 8 (Grasp2Vec: 1 and 4); its
outputs must be the in-process eager ``CheckpointPredictor``'s bit for bit
(the program runs the same aten ops and the same plain versions in the
same order on one thread). The SNAIL programs' ``inference_output`` lies
within 2e-5 of the JAX model's PREDICT forward on the same preprocessed
features (the band of ``tests/test_torch_vrgripper.py``). The exported
predictor in process replays the version's warmup requests, and the
program's batch dimension is symbolic.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_weights import random_variables
from torch_serving_fixtures import one_thread  # pylint: disable=unused-import  # an autouse fixture

from tensor2robot_tpu.modes import ModeKeys as JaxModeKeys
from tensor2robot_tpu.research.vrgripper import (
    VRGripperEnvLongHorizonModel as JaxLongHorizon)
from tensor2robot_tpu.research.vrgripper import (
    VRGripperEnvSequentialModel as JaxSequential)
from tensor2robot_tpu_torch.export import exporters
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.predictors import (CheckpointPredictor,
                                               ExportedModelPredictor)
from tensor2robot_tpu_torch.research.grasp2vec import (Grasp2VecModel,
                                                       Grasp2VecPreprocessor)
from tensor2robot_tpu_torch.research.vrgripper import (
    VRGripperEnvLongHorizonModel, VRGripperEnvSequentialModel)
from tensor2robot_tpu_torch.specs import numpy_gen
from tensor2robot_tpu_torch.utils import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPISODE = 8
IMAGE = (48, 48)
LONG_HORIZON = dict(num_attention_heads=2, attention_head_size=8)
TINY_CROP = (0, 40, 64, 0, 168, 64)
JAX_BAND = 2e-5
FLASH, POOL = 't2r.flash_fwd.default', 't2r.pool_fwd.default'
# name: (batches, kernel nodes)
MODELS = {'sequential': ((1, 8), {FLASH: 2}),
          'long_horizon': ((1, 8), {FLASH: 2}),
          'grasp2vec': ((1, 4), {POOL: 2})}


class _TinyCrop(Grasp2VecPreprocessor):

  def __init__(self, **kwargs):
    super().__init__(scene_crop=TINY_CROP, goal_crop=TINY_CROP, **kwargs)


def _snail(name):
  """(JAX model, port model, variables, port state_dict)."""
  jax_cls, cls, extra = {
      'sequential': (JaxSequential, VRGripperEnvSequentialModel, {}),
      'long_horizon': (JaxLongHorizon, VRGripperEnvLongHorizonModel,
                       LONG_HORIZON)}[name]
  kwargs = dict(extra, episode_length=EPISODE, image_size=IMAGE,
                device_type='cpu')
  jax_model, model = jax_cls(**kwargs), cls(**kwargs)
  spec = jax_model.preprocessor.get_out_feature_specification(
      JaxModeKeys.TRAIN)
  example = {key: jnp.zeros((1,) + tuple(1 if d is None else d
                                         for d in value.shape), jnp.float32)
             for key, value in spec.items()}
  shapes = jax.eval_shape(lambda: jax_model.init_variables(
      jax.random.PRNGKey(0), example))
  variables = random_variables(shapes, seed=1)
  return (jax_model, model, variables,
          convert.snail_variables_to_torch(variables))


def _grasp2vec():
  model = Grasp2VecModel(scene_size=TINY_CROP[2:3] * 2,
                         goal_size=TINY_CROP[2:3] * 2, resnet_size=18,
                         kernel_policy='pool', preprocessor_cls=_TinyCrop)
  network = model.create_module()
  model.init_network(network, torch.Generator().manual_seed(2))
  return model, network.state_dict()


def _features(predictor, batch, seed):
  return dict(numpy_gen.make_random_numpy(
      predictor.get_feature_specification(), batch_size=batch, seed=seed))


# Loads every export root named on the command line in one process that
# cannot import the model's modules, predicts each root's saved feature
# batches and saves the outputs.
_LOADER = '''
import importlib.abc, json, sys
class _Blocked(importlib.abc.MetaPathFinder):
  def find_spec(self, name, path=None, target=None):
    if name.startswith(('tensor2robot_tpu_torch.research',
                        'tensor2robot_tpu_torch.models')):
      raise ImportError('blocked: ' + name)
    return None
sys.meta_path.insert(0, _Blocked())
import numpy as np
import torch
torch.set_num_threads(1)
from tensor2robot_tpu_torch.predictors import ExportedModelPredictor
jobs = json.loads(sys.argv[1])
for root, inputs, output in jobs:
  predictor = ExportedModelPredictor(root, device='cpu')
  assert predictor.restore()
  outputs = {}
  batches = np.load(inputs)
  for name in sorted({key.split('/')[0] for key in batches.files}):
    features = {key.split('/', 1)[1]: batches[key] for key in batches.files
                if key.split('/')[0] == name}
    for key, value in predictor.predict(features).items():
      outputs[name + '/' + key] = value
  np.savez(output, **outputs)
leaked = sorted(m for m in sys.modules if m.startswith((
    'tensor2robot_tpu_torch.research', 'tensor2robot_tpu_torch.models')))
assert not leaked, leaked
print('loaded without the model')
'''


@pytest.fixture(scope='module', name='exported')
def _exported(tmp_path_factory):
  """name -> (model, eager predictor, version dir, {batch: (features,
  eager outputs)}, {batch: the loader's outputs}, JAX model, variables)."""
  root = tmp_path_factory.mktemp('export_models')
  out, jobs = {}, []
  for index, name in enumerate(MODELS):
    if name == 'grasp2vec':
      (model, state_dict), jax_model, variables = _grasp2vec(), None, None
    else:
      jax_model, model, variables, state_dict = _snail(name)
    eager = CheckpointPredictor(model, device='cpu')
    eager.load_state_dict(state_dict, global_step=7)
    path = exporters.ModelExporter().export(
        model, exporters.ServingState(7, eager.network.state_dict()),
        str(root / name), version=1)
    batches = {}
    for batch in MODELS[name][0]:
      features = _features(eager, batch, seed=10 * index + batch)
      batches[batch] = (features, eager.predict(features))
    np.savez(root / f'{name}_in.npz', **{
        f'{batch}/{key}': value for batch, (features, _) in batches.items()
        for key, value in features.items()})
    jobs.append((str(root / name), str(root / f'{name}_in.npz'),
                 str(root / f'{name}_out.npz')))
    out[name] = [model, eager, path, batches, None, jax_model, variables]
  result = subprocess.run(
      [sys.executable, '-c', _LOADER, json.dumps(jobs)], cwd=str(root),
      env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
      timeout=600, check=False)
  assert result.returncode == 0, result.stderr[-3000:]
  assert 'loaded without the model' in result.stdout
  for name, (_, _, output) in zip(MODELS, jobs):
    loaded = np.load(output)
    out[name][4] = {batch: {key.split('/', 1)[1]: loaded[key]
                            for key in loaded.files
                            if key.split('/')[0] == str(batch)}
                    for batch in MODELS[name][0]}
  return out


@pytest.mark.parametrize('name', sorted(MODELS))
def test_export_writes_a_self_contained_program(exported, name):
  _, _, path, _, _, _, _ = exported[name]
  meta = exporters.read_export_meta(path)
  assert meta['self_contained_serving_fn'] is True
  assert meta['kernel_ops'] == MODELS[name][1]
  program = torch.export.load(os.path.join(path,
                                           exporters.SERVING_FN_FILENAME))
  assert exporters.kernel_op_counts(program) == MODELS[name][1]
  # The batch is symbolic; the episode length and the frames are not.
  features = [node.meta['val'] for node in program.graph.nodes
              if node.op == 'placeholder' and
              node.name.startswith('features')]
  assert features and all(isinstance(f.shape[0], torch.SymInt) and
                          all(isinstance(d, int) for d in f.shape[1:])
                          for f in features)
  assert not program.state_dict  # the weights are inputs


@pytest.mark.parametrize('name', sorted(MODELS))
def test_program_without_the_model_matches_eager_bit_for_bit(exported,
                                                             name):
  _, _, _, batches, loaded, _, _ = exported[name]
  for batch, (_, want) in batches.items():
    got = loaded[batch]
    assert set(got) == set(want)
    for key in want:
      assert got[key].dtype == np.float32, (key, got[key].dtype)
      assert got[key].shape[0] == batch
      np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize('name', sorted(MODELS))
def test_exported_predictor_in_process_and_its_warmup(exported, name):
  _, _, path, batches, _, _, _ = exported[name]
  predictor = ExportedModelPredictor(os.path.dirname(path), device='cpu')
  assert predictor.restore()
  assert predictor.stateless_serving_fn().program_key[0] == 'torch_export'
  assert predictor.warmup() == exporters.WARMUP_REQUESTS
  features, want = batches[1]
  got = predictor.predict(features)
  for key in want:
    np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize('name', ['long_horizon', 'sequential'])
def test_snail_program_within_the_jax_forward(exported, name):
  """The JAX model's PREDICT forward (its dense attention) on the port's
  preprocessed features against the program's flash forward, at the
  larger batch."""
  model, _, _, batches, loaded, jax_model, variables = exported[name]
  batch = max(batches)
  features = batches[batch][0]
  preprocessed, _ = model.preprocessor.preprocess(
      {k: torch.from_numpy(v) for k, v in features.items()}, None,
      ModeKeys.PREDICT)
  want, _ = jax_model.inference_network_fn(
      variables, {k: jnp.asarray(v.numpy())
                  for k, v in preprocessed.items()}, None,
      JaxModeKeys.PREDICT)
  got = loaded[batch]['inference_output']
  assert got.shape == (batch, 1, EPISODE, 7)
  np.testing.assert_allclose(got, np.asarray(want['inference_output']),
                             rtol=0, atol=JAX_BAND)
