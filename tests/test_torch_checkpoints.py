"""Port parity: the checkpoint protocol against the JAX package.

* Visibility: over one directory the port wrote (steps 1-4, step 4 left
  without its commit marker, stray ``ckpt_backup``, ``ckpt_`` and
  ``ckpt_7.tmpfoo`` entries), the JAX package's
  ``latest_checkpoint_step`` and ``checkpoints_iterator`` give what the
  port's give; and likewise over a directory with no marker at all.
  Exact.
* Retention: for ``max_to_keep`` in {1, 3} and ``keep_period`` in
  {None, 4}, saving steps 1-12 leaves the same step directories under the
  JAX ``CheckpointManager`` (orbax, a numpy state, synchronous saves) as
  under the port's. Exact. The JAX runs happen once, in a module fixture.
* Restore: a truncated newest step falls back, all corrupt raises
  (``tests/test_resilience.py``'s pins), an explicit torn step and a
  topology mismatch raise; an async save is committed at the next save or
  wait, not before.
* The payload: a QT-Opt train state saved and loaded into a fresh state
  is bit for bit what was saved, and the load replaces no live tensor.

About 4 s alone on the CPU (most of it the orbax saves).
"""

import logging
import os
import shutil

import numpy as np
import pytest
import torch

from tensor2robot_tpu.train import checkpoints as jax_ckpt
from tensor2robot_tpu_torch.research.qtopt import GraspingModelWrapper
from tensor2robot_tpu_torch.train import Trainer, TrainerConfig
from tensor2robot_tpu_torch.train import checkpoints as ckpt
from tensor2robot_tpu_torch.train import train_state

RETENTION = [(1, None), (1, 4), (3, None), (3, 4)]
STRAYS = ('ckpt_backup', 'ckpt_', 'ckpt_7.tmpfoo')


@pytest.fixture(scope='module', autouse=True)
def one_thread():
  """One intra-op thread for this file's torch work: the suite runs six
  worker processes on the host's cores, and torch's default of a thread a
  core oversubscribes them (the resume tests took 40-70 s each that way,
  under 2 s alone)."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)

def _payload(step):
  return {'x': torch.full((3,), float(step)), 'step': step}


def truncate_checkpoint(ckpt_dir, step):
  """Every file of the step to 0 bytes, the marker included: a save cut
  off mid-write (``tensor2robot_tpu/utils/faults.truncate_checkpoint``)."""
  for root, _, files in os.walk(os.path.join(ckpt_dir, f'ckpt_{step}')):
    for name in files:
      with open(os.path.join(root, name), 'w'):
        pass


@pytest.mark.parametrize('markers', [True, False])
def test_visibility_matches_jax(tmp_path, markers):
  directory = str(tmp_path)
  with ckpt.CheckpointManager(directory, max_to_keep=None,
                              async_save=False) as manager:
    for step in range(1, 5):
      manager.save(step, _payload(step), force=True)
  for step in (4,) if markers else range(1, 5):
    os.remove(ckpt.commit_marker_path(directory, step))
  for name in STRAYS:
    os.makedirs(os.path.join(directory, name))
  want = 3 if markers else 4
  assert jax_ckpt.latest_checkpoint_step(directory) == want
  assert ckpt.latest_checkpoint_step(directory) == want
  kwargs = dict(min_interval_secs=0.01, timeout=0.05)
  assert (list(ckpt.checkpoints_iterator(directory, **kwargs)) ==
          list(jax_ckpt.checkpoints_iterator(directory, **kwargs)) == [want])
  assert ckpt.latest_checkpoint_step(str(tmp_path / 'missing')) is None


@pytest.fixture(scope='module')
def orbax_retention(tmp_path_factory):
  """The step directories orbax keeps, for each RETENTION case."""
  kept = {}
  for max_to_keep, keep_period in RETENTION:
    directory = str(tmp_path_factory.mktemp('orbax'))
    with jax_ckpt.CheckpointManager(directory, max_to_keep=max_to_keep,
                                    keep_period=keep_period,
                                    async_save=False) as manager:
      for step in range(1, 13):
        manager.save(step, {'x': np.full((3,), step, np.float32)},
                     force=True)
    kept[(max_to_keep, keep_period)] = sorted(os.listdir(directory))
  return kept


@pytest.mark.parametrize('max_to_keep,keep_period', RETENTION)
def test_retention_matches_orbax(tmp_path, orbax_retention, max_to_keep,
                                 keep_period):
  with ckpt.CheckpointManager(str(tmp_path), max_to_keep=max_to_keep,
                              keep_period=keep_period,
                              async_save=False) as manager:
    for step in range(1, 13):
      manager.save(step, _payload(step), force=True)
  assert (sorted(os.listdir(tmp_path)) ==
          orbax_retention[(max_to_keep, keep_period)])


def test_restore_falls_back_to_older_step_on_truncation(tmp_path, caplog):
  directory = str(tmp_path)
  with ckpt.CheckpointManager(directory, async_save=False) as manager:
    manager.save(1, _payload(1), force=True)
    manager.save(2, _payload(2), force=True)
  truncate_checkpoint(directory, 2)
  with caplog.at_level(logging.WARNING):
    step, payload = ckpt.CheckpointManager(directory).restore()
  assert step == 1 and payload['step'] == 1
  assert torch.equal(payload['x'], torch.full((3,), 1.0))
  assert any('falling back' in r.message for r in caplog.records)


def test_restore_raises_when_all_checkpoints_corrupt(tmp_path):
  directory = str(tmp_path)
  with ckpt.CheckpointManager(directory, async_save=False) as manager:
    manager.save(1, _payload(1), force=True)
  truncate_checkpoint(directory, 1)
  with pytest.raises(RuntimeError, match='failed to restore'):
    ckpt.CheckpointManager(directory).restore()


def test_torn_step_is_invisible_and_reported_once(tmp_path, caplog):
  directory = str(tmp_path)
  with ckpt.CheckpointManager(directory, async_save=False) as manager:
    manager.save(1, _payload(1), force=True)
    manager.save(2, _payload(2), force=True)
  os.remove(ckpt.commit_marker_path(directory, 2))
  with caplog.at_level(logging.WARNING):
    for _ in range(3):
      assert ckpt.latest_checkpoint_step(directory) == 1
  assert sum('torn' in r.message for r in caplog.records) == 1
  manager = ckpt.CheckpointManager(directory)
  assert manager.restore()[0] == 1
  with pytest.raises(RuntimeError, match='no commit marker'):
    manager.restore(step=2)


def test_topology_mismatch_raises(tmp_path):
  directory = str(tmp_path)
  saved = {'grad_accum_microbatches': 1, 'steps_per_dispatch': 1,
           'process_count': 1}
  with ckpt.CheckpointManager(directory, async_save=False,
                              topology=saved) as manager:
    manager.save(1, _payload(1), force=True)
  marker = ckpt.read_commit_marker(directory, 1)
  assert marker['step'] == 1 and marker['hosts'] == [0]
  assert marker['topology'] == saved
  other = dict(saved, steps_per_dispatch=8)
  with pytest.raises(ckpt.TopologyMismatchError,
                     match='steps_per_dispatch.*checkpoint_topology_check'):
    ckpt.CheckpointManager(directory, topology=other).restore()
  # Without a topology the check is off.
  assert ckpt.CheckpointManager(directory).restore()[0] == 1


def test_async_save_commits_at_the_next_save_or_wait(tmp_path):
  directory = str(tmp_path)
  manager = ckpt.CheckpointManager(directory, async_save=True)
  live = {'x': torch.zeros(4)}
  assert manager.save(1, live)
  live['x'].add_(1.0)  # the save copied the payload before returning
  assert ckpt.read_commit_marker(directory, 1) is None
  assert not manager.save(1, live)  # pending: not saved twice
  assert manager.save(2, live)
  assert ckpt.read_commit_marker(directory, 1) is not None
  assert ckpt.read_commit_marker(directory, 2) is None
  manager.wait_until_finished()
  assert ckpt.latest_checkpoint_step(directory) == 2
  assert torch.equal(manager.restore(step=1)[1]['x'], torch.zeros(4))
  assert torch.equal(manager.restore()[1]['x'], torch.ones(4))
  assert set(manager.timings) == {'copy_ms', 'serialize_ms', 'sync_ms',
                                  'write_ms'}
  # Not a multiple of the interval, and not forced: no save.
  interval = ckpt.CheckpointManager(str(tmp_path / 'i'),
                                    save_interval_steps=3, async_save=False)
  assert not interval.save(4, live)
  assert interval.save(6, live) and interval.save(4, live, force=True)


def test_eval_backup_and_the_gc_race(tmp_path):
  ckpt_dir, backup_dir = str(tmp_path / 'c'), str(tmp_path / 'b')
  with ckpt.CheckpointManager(ckpt_dir, async_save=False) as manager:
    manager.save(5, _payload(5), force=True)
  assert ckpt.create_backup_checkpoint_for_eval(ckpt_dir, 7,
                                                backup_dir) is None
  backup = ckpt.create_backup_checkpoint_for_eval(ckpt_dir, 5, backup_dir)
  assert backup == os.path.join(backup_dir, 'ckpt_5')
  shutil.rmtree(os.path.join(ckpt_dir, 'ckpt_5'))
  assert ckpt.latest_checkpoint_step(ckpt_dir) is None
  assert ckpt.restore_from_backup(backup)['step'] == 5


def _tiny_trainer(model_dir=''):
  model = GraspingModelWrapper(device_type='cpu', input_shape=(80, 80, 3),
                               target_shape=(80, 80), num_convs=(2, 2, 1),
                               kernel_policy='pool_conv')
  return Trainer(model, TrainerConfig(model_dir=model_dir, max_train_steps=2,
                                      log_interval_steps=0, seed=3),
                 device='cpu')


def _qtopt_batches(count, seed=0):
  rng = np.random.RandomState(seed)
  return [({
      'state/image': rng.randint(0, 256, (4, 80, 80, 3)).astype(np.uint8),
      'action/world_vector': rng.randn(4, 3).astype(np.float32),
      'action/vertical_rotation': rng.randn(4, 2).astype(np.float32),
  }, {'reward': rng.randint(0, 2, (4, 1)).astype(np.float32)})
          for _ in range(count)]


def same_bits(a, b):
  """Equal dtype, shape and bits (a signed zero or a NaN payload counts)."""
  if a.dtype != b.dtype or a.shape != b.shape:
    return False
  if a.is_floating_point():
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    a, b = a.view(bits), b.view(bits)
  return torch.equal(a, b)


def _tensors(tree, prefix=''):
  if isinstance(tree, torch.Tensor):
    yield prefix, tree
  elif isinstance(tree, dict):
    for key, value in tree.items():
      yield from _tensors(value, f'{prefix}/{key}')
  elif isinstance(tree, (list, tuple)):
    for i, value in enumerate(tree):
      yield from _tensors(value, f'{prefix}/{i}')


def test_payload_round_trip_is_bitwise_and_in_place(tmp_path):
  trained = _tiny_trainer(str(tmp_path))
  trained.train(iter(_qtopt_batches(2)))  # the final save: step 2
  saved = train_state.state_dict(trained.state)
  fresh = _tiny_trainer()
  fresh.initialize(_qtopt_batches(1)[0][0])
  state = fresh.state
  live = {id(t) for t in state.network.parameters()}
  live |= {id(t) for t in state.ema.values()}
  step, payload = ckpt.CheckpointManager(
      str(tmp_path / 'checkpoints')).restore()
  assert step == 2
  train_state.load_state_dict(state, payload)
  # Momentum buffers are created at the first step: the fresh state had
  # none, so the load made them; everything else is the same object.
  assert live == ({id(t) for t in state.network.parameters()} |
                  {id(t) for t in state.ema.values()})
  got = dict(_tensors(train_state.state_dict(state)))
  want = dict(_tensors(saved))
  assert set(got) == set(want) and len(want) > 100
  for name, tensor in want.items():
    assert same_bits(got[name], tensor), name
  assert state.step == 2
  groups = state.optimizer.param_groups
  assert [g['count'] for g in groups] == [2] * len(groups)
  # A second load goes into the slots the first one made.
  buffers = [state.optimizer.state[p]['momentum_buffer']
             for p in state.network.parameters()]
  train_state.load_state_dict(state, payload)
  assert all(a is state.optimizer.state[p]['momentum_buffer']
             for a, p in zip(buffers, state.network.parameters()))
  with pytest.raises(ValueError, match='EMA'):
    train_state.load_state_dict(state, dict(payload, ema=None))
