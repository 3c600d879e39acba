"""Port parity: the record feed's remainder against the JAX package.

* SNAIL's MetaExample records (one condition and one inference episode of
  [T, 220, 300, 3] frames a record, empty blobs among them): the port's
  ``DefaultRecordInputGenerator`` in EVAL mode gives bit for bit the JAX
  generator's tf.data batches from the same files, for the
  ``VRGripperEnvSequentialModel`` in-specs.
* ``dataset_map`` (specs routed to zipped dataset streams),
  ``FractionalRecordInputGenerator`` and ``MultiEvalRecordInputGenerator``
  (by argument, ``T2R_MULTI_EVAL_NAME`` and ``TF_CONFIG``) give the JAX
  generators' EVAL batches.
* ``TaskGroupedRecordInputGenerator`` in EVAL mode gives the JAX
  generator's meta batches on per-task files of ``PoseEnvRegressionModel``
  examples of unequal lengths; in TRAIN every group comes from one task.
* ``multi_batch_apply`` and ``split_train_val`` are the JAX package's.
* The port's copies of ``run_train_sequential.gin`` and
  ``run_train_reg.gin`` train through ``run_t2r_trainer.main`` on the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

from tensor2robot_tpu.data import input_generators as jax_generators
from tensor2robot_tpu.meta_learning import meta_tfdata as jax_meta_tfdata
from tensor2robot_tpu.modes import ModeKeys as JaxModeKeys
from tensor2robot_tpu.research.pose_env import (
    PoseEnvRegressionModel as JaxPoseModel)
from tensor2robot_tpu.research.vrgripper import (
    VRGripperEnvSequentialModel as JaxSequentialModel)
from tensor2robot_tpu.specs import SpecStruct as JaxSpecStruct
from tensor2robot_tpu.specs import TensorSpec as JaxTensorSpec
from tensor2robot_tpu_torch.data import (example_codec, image_codec,
                                         input_generators, records)
from tensor2robot_tpu_torch.meta_learning import meta_tfdata
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.research.pose_env import PoseEnvRegressionModel
from tensor2robot_tpu_torch.research.vrgripper import (
    VRGripperEnvSequentialModel)
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec, algebra

EPISODE = 3
POSE_DATA = os.path.join(os.path.dirname(__file__), 'test_data',
                         'pose_env_test_data.tfrecord')
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQUENTIAL_GIN = os.path.join(
    REPO, 'tensor2robot_tpu_torch/research/vrgripper/configs/'
    'run_train_sequential.gin')
REG_GIN = os.path.join(
    REPO, 'tensor2robot_tpu_torch/research/pose_env/configs/run_train_reg.gin')


def _flat_in_specs(model, mode=ModeKeys.TRAIN):
  spec = dict(algebra.flatten_spec_structure(
      model.preprocessor.get_in_feature_specification(mode)).items())
  labels = model.preprocessor.get_in_label_specification(mode)
  if labels is not None:
    spec.update(algebra.flatten_spec_structure(labels).items())
  return spec


def _record(spec, values, empty=()):
  """One tf.Example of ``values`` under ``spec``'s names, images as PNG
  (zlib level 1), the (key, frame) pairs of ``empty`` as empty blobs."""
  features = {}
  for key, s in spec.items():
    kind, _ = example_codec.feature_kind(s)
    value = np.asarray(values[key])
    if kind == example_codec.KIND_BYTES:
      frames = value if value.ndim == 4 else value[None]
      blobs = [b'' if (key, t) in empty else image_codec.encode_png(f, 1)
               for t, f in enumerate(frames)]
      features[s.name] = (kind, blobs)
    else:
      features[s.name] = (kind, value.reshape(-1))
  return example_codec.encode_features(features)


def _meta_values(rng):
  frames = (EPISODE, 220, 300, 3)
  values = {}
  for prefix in ('condition', 'inference'):
    values[f'{prefix}/features/image/0'] = rng.randint(0, 256, frames,
                                                       dtype=np.uint8)
    values[f'{prefix}/features/gripper_pose/0'] = rng.randn(
        EPISODE, 14).astype(np.float32)
  values['condition/labels/action/0'] = rng.randn(EPISODE, 7).astype(
      np.float32)
  values['action/0'] = rng.randn(EPISODE, 7).astype(np.float32)
  return values


def write_meta_shards(root, model, files, per_file, seed, empty=()):
  """MetaExample shards of the SNAIL model's in-specs; ``empty`` holds
  (file, record, key, frame) tuples written as empty blobs."""
  spec = _flat_in_specs(model)
  rng = np.random.RandomState(seed)
  paths = []
  for f in range(files):
    examples = []
    for r in range(per_file):
      holes = {(key, t) for (ff, rr, key, t) in empty if (ff, rr) == (f, r)}
      examples.append(_record(spec, _meta_values(rng), holes))
    paths.append(records.write_examples(
        os.path.join(root, f'meta-{f:05d}.tfrecord'), examples))
  return paths


def _as_numpy(batch):
  features, labels = batch
  return ({k: np.asarray(v) for k, v in features.items()},
          None if labels is None else
          {k: np.asarray(v) for k, v in labels.items()})


def _assert_same(got, want, what):
  for part in (0, 1):
    if want[part] is None:
      assert got[part] is None, what
      continue
    assert sorted(got[part]) == sorted(want[part]), what
    for key in want[part]:
      a, b = got[part][key], want[part][key]
      assert a.dtype == b.dtype and a.shape == b.shape, (what, key)
      assert np.array_equal(a, b), (what, key)


def _eval_batches(gen, mode, count):
  it = gen.create_iterator(mode)
  try:
    return [_as_numpy(next(it)) for _ in range(count)]
  finally:
    close = getattr(it, 'close', None)
    if close is not None:
      close()


def test_snail_meta_records_match_the_jax_generator(tmp_path):
  model = VRGripperEnvSequentialModel(episode_length=EPISODE,
                                      device_type='cpu')
  jax_model = JaxSequentialModel(episode_length=EPISODE, device_type='cpu')
  empty = {(0, 0, 'condition/features/image/0', 2),
           (1, 0, 'inference/features/image/0', 0)}
  paths = write_meta_shards(str(tmp_path), model, 2, 1, seed=4, empty=empty)
  pattern = os.path.join(str(tmp_path), 'meta-*.tfrecord')
  port = input_generators.DefaultRecordInputGenerator(
      file_patterns=pattern, batch_size=2)
  port.set_specification_from_model(model, ModeKeys.EVAL)
  jax = jax_generators.DefaultRecordInputGenerator(file_patterns=pattern,
                                                   batch_size=2)
  jax.set_specification_from_model(jax_model, JaxModeKeys.EVAL)
  got = _eval_batches(port, ModeKeys.EVAL, 2)
  want = _eval_batches(jax, JaxModeKeys.EVAL, 2)
  for i, (g, w) in enumerate(zip(got, want)):
    _assert_same(g, w, i)
  image = got[0][0]['condition/features/image/0']
  assert image.shape == (2, EPISODE, 220, 300, 3)
  assert not image[0, 2].any() and image[0, 1].any() and image[1, 2].any()
  assert not got[0][0]['inference/features/image/0'][1, 0].any()
  assert len(paths) == 2


def _routed_specs(kind):
  struct, spec = (SpecStruct, TensorSpec) if kind == 'port' else (
      JaxSpecStruct, JaxTensorSpec)
  features, labels = struct(), struct()
  features['a/x'] = spec((3,), np.float32, name='x', dataset_key='d1')
  features['b/img'] = spec((8, 6, 3), np.uint8, name='img',
                           data_format='PNG', dataset_key='d2')
  features['b/n'] = spec((2,), np.int64, name='n', dataset_key='d2')
  labels['r'] = spec((1,), np.float32, name='r', dataset_key='d1')
  return features, labels


def _routed_shards(root):
  features, labels = _routed_specs('port')
  rng = np.random.RandomState(2)
  d1 = {'a/x': features['a/x'], 'r': labels['r']}
  d2 = {'b/img': features['b/img'], 'b/n': features['b/n']}
  patterns = {}
  for name, spec, sizes in (('d1', d1, (5, 4)), ('d2', d2, (7,))):
    paths = []
    for shard, count in enumerate(sizes):
      examples = []
      for _ in range(count):
        values = {'a/x': rng.randn(3).astype(np.float32),
                  'r': rng.randn(1).astype(np.float32),
                  'b/img': rng.randint(0, 256, (8, 6, 3), dtype=np.uint8),
                  'b/n': rng.randint(-5, 5, 2).astype(np.int64)}
        examples.append(example_codec.encode_example(
            spec, {k: values[k] for k in spec}))
      paths.append(records.write_examples(
          os.path.join(root, f'{name}-{shard:05d}.tfrecord'), examples))
    patterns[name] = ','.join(paths)
  return patterns


def test_dataset_map_matches_the_jax_generator(tmp_path):
  patterns = _routed_shards(str(tmp_path))
  port = input_generators.DefaultRecordInputGenerator(dataset_map=patterns,
                                                      batch_size=3)
  port.set_specification(*_routed_specs('port'))
  jax = jax_generators.DefaultRecordInputGenerator(dataset_map=patterns,
                                                   batch_size=3)
  jax.set_specification(*_routed_specs('jax'))
  got = _eval_batches(port, ModeKeys.EVAL, 5)
  want = _eval_batches(jax, JaxModeKeys.EVAL, 5)
  for i, (g, w) in enumerate(zip(got, want)):
    _assert_same(g, w, i)
  # TRAIN zips two seeded shuffles; its stream is the port's own.
  port_train = input_generators.DefaultRecordInputGenerator(
      dataset_map=patterns, batch_size=3, seed=1, shuffle_buffer_size=4)
  port_train.set_specification(*_routed_specs('port'))
  batch = _eval_batches(port_train, ModeKeys.TRAIN, 1)[0]
  assert batch[0]['b/img'].shape == (3, 8, 6, 3)
  assert batch[1]['r'].shape == (3, 1)


def _pose_shards(root, sizes, seed=0, tag='pose'):
  """Shards of PoseEnvRegressionModel examples; each example's reward is
  its shard's index, so a batch shows where its examples came from."""
  model = PoseEnvRegressionModel(device_type='cpu')
  spec = _flat_in_specs(model)
  rng = np.random.RandomState(seed)
  paths = []
  for shard, count in enumerate(sizes):
    examples = []
    for _ in range(count):
      examples.append(example_codec.encode_example(spec, {
          'state/image': rng.randint(0, 256, (64, 64, 3), dtype=np.uint8),
          'target_pose': rng.randn(2).astype(np.float32),
          'reward': np.full((1,), shard, np.float32)}, png_level=1))
    paths.append(records.write_examples(
        os.path.join(root, f'{tag}-{shard:05d}.tfrecord'), examples))
  return paths


def test_fractional_generator_matches_the_jax_generator(tmp_path):
  paths = _pose_shards(str(tmp_path), (3, 4, 2, 5))
  pattern = os.path.join(str(tmp_path), 'pose-*.tfrecord')
  port = input_generators.FractionalRecordInputGenerator(
      file_fraction=0.5, file_patterns=pattern, batch_size=2)
  port.set_specification_from_model(
      PoseEnvRegressionModel(device_type='cpu'), ModeKeys.EVAL)
  jax = jax_generators.FractionalRecordInputGenerator(
      file_fraction=0.5, file_patterns=pattern, batch_size=2)
  jax.set_specification_from_model(JaxPoseModel(device_type='cpu'),
                                   JaxModeKeys.EVAL)
  assert port._resolved_filenames() == paths[:2]  # pylint: disable=protected-access
  got = _eval_batches(port, ModeKeys.EVAL, 5)
  want = _eval_batches(jax, JaxModeKeys.EVAL, 5)
  for i, (g, w) in enumerate(zip(got, want)):
    _assert_same(g, w, i)
  assert set(np.concatenate([g[1]['reward'] for g in got]).ravel()) == {0, 1}
  with pytest.raises(ValueError, match='file_fraction'):
    input_generators.FractionalRecordInputGenerator(file_fraction=0.0,
                                                    file_patterns=pattern)


@pytest.mark.parametrize('route', ['argument', 'env', 'tf_config'])
def test_multi_eval_generator_matches_the_jax_generator(tmp_path,
                                                        monkeypatch, route):
  a = _pose_shards(str(tmp_path), (3,), seed=1, tag='a')
  b = _pose_shards(str(tmp_path), (4,), seed=2, tag='b')
  datasets = {'a': a[0], 'b': b[0]}
  monkeypatch.delenv(input_generators.MULTI_EVAL_ENV, raising=False)
  monkeypatch.delenv('TF_CONFIG', raising=False)
  kwargs = {}
  if route == 'argument':
    kwargs['multi_eval_name'] = 'b'
  elif route == 'env':
    monkeypatch.setenv(input_generators.MULTI_EVAL_ENV, 'b')
  else:
    monkeypatch.setenv('TF_CONFIG', json.dumps({'multi_eval_name': 'b'}))
  port = input_generators.MultiEvalRecordInputGenerator(
      eval_dataset_map=datasets, batch_size=3, **kwargs)
  port.set_specification_from_model(
      PoseEnvRegressionModel(device_type='cpu'), ModeKeys.EVAL)
  jax = jax_generators.MultiEvalRecordInputGenerator(
      eval_dataset_map=datasets, batch_size=3, **kwargs)
  jax.set_specification_from_model(JaxPoseModel(device_type='cpu'),
                                   JaxModeKeys.EVAL)
  assert port.multi_eval_name == jax.multi_eval_name == 'b'
  for i, (g, w) in enumerate(zip(_eval_batches(port, ModeKeys.EVAL, 3),
                                 _eval_batches(jax, JaxModeKeys.EVAL, 3))):
    _assert_same(g, w, i)
  with pytest.raises(ValueError, match='Unknown eval dataset'):
    input_generators.MultiEvalRecordInputGenerator(
        eval_dataset_map={'a': a[0]}, multi_eval_name='c')


def test_task_grouped_eval_matches_the_jax_generator(tmp_path):
  _pose_shards(str(tmp_path), (5, 9, 4, 6), seed=3)
  pattern = os.path.join(str(tmp_path), 'pose-*.tfrecord')
  kwargs = dict(file_patterns=pattern, num_train_samples_per_task=2,
                num_val_samples_per_task=2, batch_size=3)
  port = input_generators.TaskGroupedRecordInputGenerator(**kwargs)
  port.set_specification_from_model(
      PoseEnvRegressionModel(device_type='cpu'), ModeKeys.EVAL)
  jax = jax_generators.TaskGroupedRecordInputGenerator(**kwargs)
  jax.set_specification_from_model(JaxPoseModel(device_type='cpu'),
                                   JaxModeKeys.EVAL)
  got = _eval_batches(port, ModeKeys.EVAL, 4)
  want = _eval_batches(jax, JaxModeKeys.EVAL, 4)
  for i, (g, w) in enumerate(zip(got, want)):
    _assert_same(g, w, i)
  assert got[0][0]['condition/features/state/image'].shape == (3, 2, 64, 64,
                                                               3)
  # TRAIN: seeded visits; each group is one task's.
  train = input_generators.TaskGroupedRecordInputGenerator(seed=7, **kwargs)
  train.set_specification_from_model(
      PoseEnvRegressionModel(device_type='cpu'), ModeKeys.TRAIN)
  for features, labels in _eval_batches(train, ModeKeys.TRAIN, 3):
    tasks = np.concatenate([features['condition/labels/reward'],
                            labels['reward']], axis=1)[..., 0]
    assert (tasks == tasks[:, :1]).all()


def test_interleave_is_tf_data_interleave():
  tf = pytest.importorskip('tensorflow')
  sizes = [3, 1, 4, 0, 2]
  for cycle, block in ((2, 1), (3, 2), (5, 1)):
    want = list(tf.data.Dataset.range(len(sizes)).interleave(
        lambda i: tf.data.Dataset.range(10 * i, 10 * i + tf.gather(
            tf.constant(sizes, tf.int64), i)),
        cycle_length=cycle, block_length=block).as_numpy_iterator())
    got = list(input_generators.interleave(
        iter(range(len(sizes))), lambda i: range(10 * i, 10 * i + sizes[i]),
        cycle, block))
    assert got == [int(v) for v in want], (cycle, block)
  with pytest.raises(ValueError, match='every element is empty'):
    list(input_generators.interleave(iter(lambda: 0, 1), lambda _: [], 2))


def test_multi_batch_apply_and_split_train_val_match_jax():
  rng = np.random.RandomState(0)
  x = rng.randn(2, 3, 4).astype(np.float32)
  y = rng.randn(2, 3, 5).astype(np.float32)

  def fn(a, b):
    return {'sum': a.sum(-1), 'cat': np.concatenate([a, b], -1)
            if isinstance(a, np.ndarray) else torch.cat([a, b], -1)}

  want = jax_meta_tfdata.multi_batch_apply(fn, 2, x, y)
  got = meta_tfdata.multi_batch_apply(fn, 2, torch.from_numpy(x),
                                      torch.from_numpy(y))
  for key in ('sum', 'cat'):
    assert got[key].shape == tuple(want[key].shape)
    assert np.array_equal(got[key].numpy(), np.asarray(want[key]))
  struct = {'f': x, 'g': y}
  jax_train, jax_val = jax_meta_tfdata.split_train_val(struct, 1)
  train, val = meta_tfdata.split_train_val(
      {k: torch.from_numpy(v) for k, v in struct.items()}, 1)
  for got_part, want_part in ((train, jax_train), (val, jax_val)):
    assert sorted(got_part) == sorted(want_part)
    for key in want_part:
      assert np.array_equal(got_part[key].numpy(), np.asarray(want_part[key]))


def _run_binary(gin, bindings):
  from tensor2robot_tpu_torch import config as t2r_config
  from tensor2robot_tpu_torch.bin import run_t2r_trainer
  argv = ['--gin_configs', gin, '--no-handle_preemption']
  for binding in bindings:
    argv += ['--gin_bindings', binding]
  try:
    return run_t2r_trainer.main(argv)
  finally:
    t2r_config.clear_config()


def test_sequential_gin_trains_from_meta_records(tmp_path):
  from tensor2robot_tpu_torch.train import latest_checkpoint_step
  model = VRGripperEnvSequentialModel(episode_length=EPISODE,
                                      device_type='cpu')
  write_meta_shards(str(tmp_path), model, 2, 2, seed=9)
  pattern = os.path.join(str(tmp_path), 'meta-*.tfrecord')
  model_dir = tmp_path / 'model'
  metrics = _run_binary(SEQUENTIAL_GIN, [
      f"train/DefaultRecordInputGenerator.file_patterns = '{pattern}'",
      f"eval/DefaultRecordInputGenerator.file_patterns = '{pattern}'",
      f"train_eval_model.model_dir = '{model_dir}'",
      f'VRGripperEnvSequentialModel.episode_length = {EPISODE}',
      "VRGripperEnvSequentialModel.device_type = 'cpu'",
      'DefaultRecordInputGenerator.batch_size = 2',
      'train_eval_model.max_train_steps = 2',
      'train_eval_model.eval_steps = 1',
      "train_eval_model.device = 'cpu'"])
  assert metrics and all(np.isfinite(v) for v in metrics.values())
  assert latest_checkpoint_step(str(model_dir / 'checkpoints')) == 2


def test_pose_env_reg_gin_trains_from_the_test_records(tmp_path):
  from tensor2robot_tpu_torch.train import latest_checkpoint_step
  model_dir = tmp_path / 'model'
  metrics = _run_binary(REG_GIN, [
      f"train/DefaultRecordInputGenerator.file_patterns = '{POSE_DATA}'",
      f"eval/DefaultRecordInputGenerator.file_patterns = '{POSE_DATA}'",
      f"train_eval_model.model_dir = '{model_dir}'",
      "PoseEnvRegressionModel.device_type = 'cpu'",
      'train_eval_model.max_train_steps = 3',
      'train_eval_model.eval_steps = 1',
      "train_eval_model.device = 'cpu'"])
  assert np.isfinite(metrics['pose_mse'])
  assert latest_checkpoint_step(str(model_dir / 'checkpoints')) == 3
