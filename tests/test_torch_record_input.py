"""Port parity: the record input generators, resumable streams and the
trainer's staged upload.

* ``NativeRecordInputGenerator`` gives bit for bit the JAX package's
  batches for the same files, seed and batch size, with ``engine_workers``
  0 and 2, on the checked-in pose_env records (JPEG) and on port-written
  PNG shards read by a two-slot interleave; a ring of reused buffers
  (``reuse_batch_buffers``, released once per batch) gives the same
  stream.
* Eval mode of ``DefaultRecordInputGenerator`` (one file, unshuffled,
  repeating) gives bit for bit the JAX ``DefaultRecordInputGenerator``'s
  tf.data batches across the epoch boundary on a PNG shard, and the same
  labels on the pose_env records.
* A checkpointable iterator restored by seek and by replay continues bit
  for bit; a position saved with a pending (staged) batch resumes at it.
* The trainer stages one batch ahead (``staged_batches``) and consumes
  the iterator as before; ring slots go back after their step; an input
  state saved at a checkpoint is the trained batches' position; and
  ``train_eval_model(checkpoint_input_state=True)`` stopped at step 4 and
  resumed to 8 equals the uninterrupted 8 steps bit for bit, ring buffers
  on.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from tensor2robot_tpu.data import input_generators as jax_generators
from tensor2robot_tpu.modes import ModeKeys as JaxModeKeys
from tensor2robot_tpu.research.pose_env import (
    PoseEnvRegressionModel as JaxPoseModel)
from tensor2robot_tpu.research.qtopt import GraspingModelWrapper as JaxWrapper
from tensor2robot_tpu_torch.data import (engine, example_codec,
                                         input_generators, records)
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.research.pose_env import PoseEnvRegressionModel
from tensor2robot_tpu_torch.research.qtopt import GraspingModelWrapper
from tensor2robot_tpu_torch.train import (Trainer, TrainerCallback,
                                          TrainerConfig, train_eval_model)
from tensor2robot_tpu_torch.train import input_state
from tensor2robot_tpu_torch.train.trainer import BatchUploader

TEST_DATA = os.path.join(os.path.dirname(__file__), 'test_data',
                         'pose_env_test_data.tfrecord')
IMAGE = (24, 32, 3)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _qtopt_models():
  kwargs = dict(device_type='cpu', input_shape=IMAGE, target_shape=(16, 16),
                num_convs=(1, 1, 1))
  return GraspingModelWrapper(**kwargs), JaxWrapper(**kwargs)


@pytest.fixture(scope='module')
def png_shards(tmp_path_factory):
  """Three port-written shards of QT-Opt examples with PNG frames."""
  root = tmp_path_factory.mktemp('png_shards')
  model, _ = _qtopt_models()
  feature_spec = model.preprocessor.get_in_feature_specification(
      ModeKeys.TRAIN)
  label_spec = model.preprocessor.get_in_label_specification(ModeKeys.TRAIN)
  spec = dict(feature_spec.items())
  spec.update(label_spec.items())
  rng = np.random.RandomState(0)
  paths = []
  for shard, count in enumerate((11, 7, 9)):
    examples = []
    for _ in range(count):
      value = {
          'state/image': rng.randint(0, 256, IMAGE, dtype=np.uint8),
          'action/world_vector': rng.randn(3).astype(np.float32),
          'action/vertical_rotation': rng.randn(2).astype(np.float32),
          'reward': rng.randint(0, 2, (1,)).astype(np.float32),
      }
      examples.append(example_codec.encode_example(spec, value))
    paths.append(records.write_examples(
        str(root / f'qtopt-{shard:05d}.tfrecord'), examples))
  return paths


def _assert_batches_equal(got, want, what):
  for part in (0, 1):
    assert set(got[part]) == set(want[part]), what
    for key in want[part]:
      a, b = got[part][key], np.asarray(want[part][key])
      assert a.dtype == b.dtype and a.shape == b.shape, (what, key)
      assert np.array_equal(a, b), (what, key)


def _take(iterator, count, release=False):
  out = []
  for _ in range(count):
    features, labels = next(iterator)
    out.append(({k: np.array(v) for k, v in features.items()},
                {k: np.array(v) for k, v in labels.items()}))
    if release:
      iterator.release()
  return out


@pytest.mark.parametrize('workers', [0, 2])
@pytest.mark.parametrize('data', ['pose_env', 'png_shards'])
def test_native_batches_match_jax(png_shards, workers, data):
  if data == 'pose_env':
    pattern, batch, buffer, cycle, steps = TEST_DATA, 16, 32, 16, 14
    model, jax_model = (PoseEnvRegressionModel(device_type='cpu'),
                        JaxPoseModel(device_type='cpu'))
  else:
    pattern = ','.join(png_shards)
    batch, buffer, cycle, steps = 4, 10, 2, 16
    model, jax_model = _qtopt_models()
  kwargs = dict(batch_size=batch, shuffle_buffer_size=buffer,
                cycle_length=cycle, seed=7, engine_workers=workers)
  gen = input_generators.NativeRecordInputGenerator(pattern, **kwargs)
  gen.set_specification_from_model(model, ModeKeys.TRAIN)
  jax_gen = jax_generators.NativeRecordInputGenerator(pattern, **kwargs)
  jax_gen.set_specification_from_model(jax_model, JaxModeKeys.TRAIN)
  got = _take(gen.create_iterator(ModeKeys.TRAIN), steps)
  want = _take(jax_gen.create_iterator(JaxModeKeys.TRAIN), steps)
  for i, (g, w) in enumerate(zip(got, want)):
    _assert_batches_equal(g, w, f'batch {i}')
  if workers:
    ring = input_generators.NativeRecordInputGenerator(
        pattern, reuse_batch_buffers=True, engine_ring_depth=3, **kwargs)
    ring.set_specification_from_model(model, ModeKeys.TRAIN)
    iterator = ring.create_iterator(ModeKeys.TRAIN)
    assert iterator.reuse_buffers
    for i, (g, w) in enumerate(zip(_take(iterator, steps, release=True),
                                   want)):
      _assert_batches_equal(g, w, f'ring batch {i}')


def test_ring_without_release_fails_loudly(png_shards):
  model, _ = _qtopt_models()
  gen = input_generators.NativeRecordInputGenerator(
      ','.join(png_shards), batch_size=4, seed=1, engine_workers=1,
      engine_ring_depth=2, reuse_batch_buffers=True)
  gen.set_specification_from_model(model, ModeKeys.TRAIN)
  iterator = gen.create_iterator(ModeKeys.TRAIN)
  iterator._lease_timeout = 0.2  # pylint: disable=protected-access
  next(iterator)
  next(iterator)
  with pytest.raises(RuntimeError, match='ring slots are leased'):
    next(iterator)
  iterator.close()


def test_autotune_is_core_aware():
  assert engine.autotune(cpus=1).serial
  decision = engine.autotune(cpus=8)
  assert decision.num_workers == 4 and decision.ring_depth == 8
  assert engine.autotune(num_workers=2, cpus=1).num_workers == 2
  assert engine.autotune(num_workers=3, ring_depth=2).ring_depth == 4


def test_eval_stream_matches_jax_default_generator(png_shards):
  model, jax_model = _qtopt_models()
  gen = input_generators.DefaultRecordInputGenerator(
      file_patterns=png_shards[0], batch_size=4)
  gen.set_specification_from_model(model, ModeKeys.EVAL)
  jax_gen = jax_generators.DefaultRecordInputGenerator(
      file_patterns=png_shards[0], batch_size=4)
  jax_gen.set_specification_from_model(jax_model, JaxModeKeys.EVAL)
  # 11 records: batch 2 and batch 5 span the epoch boundaries.
  got = _take(gen.create_iterator(ModeKeys.EVAL), 6)
  want = _take(jax_gen.create_iterator(JaxModeKeys.EVAL), 6)
  for i, (g, w) in enumerate(zip(got, want)):
    _assert_batches_equal(g, w, f'eval batch {i}')
  pose = input_generators.DefaultRecordInputGenerator(
      file_patterns=TEST_DATA, batch_size=16)
  pose.set_specification_from_model(PoseEnvRegressionModel(device_type='cpu'),
                                    ModeKeys.EVAL)
  jax_pose = jax_generators.DefaultRecordInputGenerator(
      file_patterns=TEST_DATA, batch_size=16)
  jax_pose.set_specification_from_model(JaxPoseModel(device_type='cpu'),
                                        JaxModeKeys.EVAL)
  for g, w in zip(_take(pose.create_iterator(ModeKeys.EVAL), 8),
                  _take(jax_pose.create_iterator(JaxModeKeys.EVAL), 8)):
    for key in w[1]:
      assert np.array_equal(g[1][key], np.asarray(w[1][key]))


def test_default_generator_refuses_what_is_not_ported():
  # dataset_map is ported (tests/test_torch_record_meta.py); both sources
  # at once, or neither, are refused as in the JAX package.
  with pytest.raises(ValueError, match='mutually exclusive'):
    input_generators.DefaultRecordInputGenerator(file_patterns='x.tfrecord',
                                                 dataset_map={'a': 'x'})
  with pytest.raises(ValueError, match='Provide file_patterns'):
    input_generators.DefaultRecordInputGenerator()
  with pytest.raises(NotImplementedError, match='queue 1 item 10'):
    input_generators.DefaultRecordInputGenerator(file_patterns='x.tfrecord',
                                                 error_budget=3)


def _checkpointable(pattern, model, seed=3, **kwargs):
  gen = input_generators.NativeRecordInputGenerator(
      pattern, batch_size=4, shuffle_buffer_size=6, cycle_length=2,
      seed=seed, engine_workers=2, **kwargs)
  gen.set_specification_from_model(model, ModeKeys.TRAIN)
  return gen.create_checkpointable_iterator(ModeKeys.TRAIN)


@pytest.mark.parametrize('allow_seek', [True, False], ids=['seek', 'replay'])
def test_checkpointable_restore_continues_bit_for_bit(tmp_path, png_shards,
                                                       allow_seek):
  model, _ = _qtopt_models()
  pattern = ','.join(png_shards)
  straight = _take(_checkpointable(pattern, model), 16)
  it = _checkpointable(pattern, model)
  _take(it, 9)
  prefix = str(tmp_path / 'state')
  it.save(prefix)
  it.save(prefix + '_pending', pending=1)
  restored = _checkpointable(pattern, model)
  _take(restored, 2)
  assert restored.restore(prefix, allow_seek=allow_seek) == (
      'seek' if allow_seek else 'replay')
  for i, (g, w) in enumerate(zip(_take(restored, 7), straight[9:])):
    _assert_batches_equal(g, w, f'batch {9 + i}')
  again = _checkpointable(pattern, model)
  again.restore(prefix + '_pending', allow_seek=allow_seek)
  assert again.delivered == 8
  _assert_batches_equal(_take(again, 1)[0], straight[8], 'the pending batch')


def test_checkpointable_refuses_an_unseeded_shuffle(png_shards):
  model, _ = _qtopt_models()
  with pytest.raises(ValueError, match='needs a seed'):
    _checkpointable(png_shards[0], model, seed=None)


def test_uploader_passes_cpu_batches_through():
  uploader = BatchUploader(torch.device('cpu'))
  array = np.arange(6, dtype=np.float32)
  tensor = torch.ones(3)
  released = []
  staged = uploader.stage(({'a': array, 'b': tensor}, None),
                          lambda: released.append(1))
  features, labels = uploader.consume(staged)
  assert labels is None and features['b'] is tensor
  assert features['a'].data_ptr() == array.ctypes.data  # no copy
  assert not released
  uploader.finish(staged)
  uploader.finish(staged)
  assert released == [1]


class _Probe(TrainerCallback):
  """Records ``staged_batches`` and the batches' rewards step by step."""

  def __init__(self):
    self.staged = []

  def after_step(self, trainer, step, scalars):
    self.staged.append(trainer.staged_batches)


def _pose_batches(count, batch=4, seed=0):
  rng = np.random.RandomState(seed)
  return [({'state/image': rng.randint(0, 256, (batch, 64, 64, 3),
                                       dtype=np.uint8)},
           {'target_pose': rng.randn(batch, 2).astype(np.float32),
            'reward': -rng.rand(batch, 1).astype(np.float32)})
          for _ in range(count)]


def test_trainer_stages_one_batch_ahead_and_consumes_as_before():
  batches = iter(_pose_batches(6))
  probe = _Probe()
  trainer = Trainer(PoseEnvRegressionModel(device_type='cpu'),
                    TrainerConfig(max_train_steps=2, log_interval_steps=0),
                    device='cpu', callbacks=[probe])
  trainer.train(batches)
  assert probe.staged == [1, 0] and trainer.staged_batches == 0
  trainer.config.max_train_steps = 4
  trainer.train(batches)
  assert trainer.step == 4 and probe.staged == [1, 0, 1, 0]
  assert len(list(batches)) == 2  # four batches trained, none skipped


def _record_run(model_dir, steps, pattern, ring):
  """train_eval_model with checkpoint_input_state on the pose_env
  records; returns the final network and optimizer state."""
  gen = input_generators.NativeRecordInputGenerator(
      pattern, batch_size=4, shuffle_buffer_size=16, seed=13,
      engine_workers=2 if ring else 0, reuse_batch_buffers=ring)
  recorder = _Recorder()
  train_eval_model(
      model=PoseEnvRegressionModel(device_type='cpu'), model_dir=model_dir,
      train_input_generator=gen, max_train_steps=steps,
      save_interval_steps=2, eval_interval_steps=0, log_interval_steps=0,
      checkpoint_input_state=True, callbacks=[recorder], device='cpu')
  return recorder


class _Recorder(TrainerCallback):

  def __init__(self):
    self.state = None
    self.positions = {}

  def after_checkpoint(self, trainer, step):
    self.positions[step] = trainer.staged_batches

  def end(self, trainer):
    state = trainer.state
    self.state = ({k: v.clone() for k, v in
                   state.network.state_dict().items()},
                  state.optimizer.state_dict())


def _pose_copy(tmp_path):
  """A copy of the pose_env records: a checkpointable stream writes index
  sidecars beside its shards."""
  path = tmp_path / 'pose_env.tfrecord'
  shutil.copyfile(TEST_DATA, path)
  return str(path)


@pytest.mark.parametrize('ring', [False, True], ids=['fresh', 'ring'])
def test_train_eval_model_resumes_input_state_bit_for_bit(tmp_path, ring):
  data = _pose_copy(tmp_path)
  straight = _record_run(str(tmp_path / 'straight'), 8, data, ring)
  first = _record_run(str(tmp_path / 'resumed'), 4, data, ring)
  # The saves at 2 (a batch staged) and 4 (the last step, none).
  assert first.positions == {2: 1, 4: 0}
  root = tmp_path / 'resumed' / input_state.INPUT_STATE_DIRNAME / 'train'
  saved = root / 'process_0' / 'step_2' / 'state.json'
  assert json.loads(saved.read_text())['batches_delivered'] == 2
  resumed = _record_run(str(tmp_path / 'resumed'), 8, data, ring)
  want_net, want_opt = straight.state
  got_net, got_opt = resumed.state
  for name, value in want_net.items():
    assert torch.equal(got_net[name], value), name
  for index, slots in want_opt['state'].items():
    for slot, value in slots.items():
      assert torch.equal(got_opt['state'][index][slot], value), (index, slot)


def test_trainer_binary_trains_from_records(tmp_path):
  """The gin surface: the trainer binary on the pose_env records with
  checkpoint_input_state, through the registered generator and model."""
  from tensor2robot_tpu_torch import config as t2r_config
  from tensor2robot_tpu_torch.bin import run_t2r_trainer
  from tensor2robot_tpu_torch.train import latest_checkpoint_step
  model_dir = tmp_path / 'model'
  data = _pose_copy(tmp_path)
  config = tmp_path / 'records.gin'
  config.write_text(f"""
train_eval_model.model = @PoseEnvRegressionModel()
PoseEnvRegressionModel.device_type = 'cpu'
train_eval_model.train_input_generator = @train/NativeRecordInputGenerator()
train_eval_model.eval_input_generator = @eval/DefaultRecordInputGenerator()
train/NativeRecordInputGenerator.file_patterns = '{data}'
train/NativeRecordInputGenerator.seed = 5
eval/DefaultRecordInputGenerator.file_patterns = '{data}'
NativeRecordInputGenerator.batch_size = 4
DefaultRecordInputGenerator.batch_size = 4
train_eval_model.model_dir = '{model_dir}'
train_eval_model.max_train_steps = 2
train_eval_model.eval_steps = 1
train_eval_model.checkpoint_input_state = True
train_eval_model.device = 'cpu'
""")
  try:
    metrics = run_t2r_trainer.main(['--gin_configs', str(config)])
  finally:
    t2r_config.clear_config()
  assert np.isfinite(metrics['pose_mse'])
  assert latest_checkpoint_step(str(model_dir / 'checkpoints')) == 2
  assert (model_dir / input_state.INPUT_STATE_DIRNAME / 'train' / 'process_0'
          / 'step_2' / 'state.json').exists()
