"""The asynchronous save: what the loop hands the writer, and what it writes.

* A save copies the payload into the manager's staging buffers (one a
  dtype, every tensor a view); the live state moving on, and the next
  save reusing the buffers, change nothing that a resume reads.
* While a write is pending its step is invisible; once committed it reads
  back bit for bit what the state held at the save.
* A write that fails leaves the step torn (no marker, invisible to
  restore) and raises at the next save, which is not taken.
* ``prepare`` allocates the staging that the first save then reuses.
* ``state.pt`` is what ``torch.save`` writes for the payload: every record
  byte for byte (the pickle from the staging's kept reductions included),
  and ``torch.load(..., weights_only=True)`` reads it back, bfloat16,
  integer, generator and transposed tensors included.
"""

import os
import threading
import zipfile

import pytest
import torch

from tensor2robot_tpu_torch.train import checkpoints as ckpt


def _payload(seed):
  g = torch.Generator().manual_seed(seed)
  return {
      'step': seed,
      'network': {f'layer{i}.weight': torch.randn(4, i + 2, generator=g)
                  for i in range(6)},
      'optimizer': {'state': {i: {'mu': torch.randn(3, generator=g),
                                  'count': torch.tensor(i)}
                              for i in range(4)},
                    'param_groups': [{'lr': 0.5, 'params': [0, 1, 2, 3]}]},
      'ema': {'w': torch.randn(5, generator=g).to(torch.bfloat16)},
      'generator': g.get_state(),
      'transposed': torch.randn(3, 7, generator=g).t(),
  }


def _clone(tree):
  if isinstance(tree, torch.Tensor):
    return tree.clone()
  if isinstance(tree, dict):
    return {k: _clone(v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_clone(v) for v in tree)
  return tree


def _same(a, b):
  if isinstance(a, torch.Tensor):
    return (a.dtype == b.dtype and a.shape == b.shape and
            torch.equal(a.view(torch.uint8) if a.dtype == torch.bfloat16
                        else a, b.view(torch.uint8)
                        if b.dtype == torch.bfloat16 else b))
  if isinstance(a, dict):
    return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
  if isinstance(a, (list, tuple)):
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
  return a == b


def _bump(tree):
  """Moves every floating tensor of ``tree`` on, in place."""
  if isinstance(tree, torch.Tensor):
    if tree.is_floating_point():
      tree.add_(1.0)
  elif isinstance(tree, dict):
    for value in tree.values():
      _bump(value)
  elif isinstance(tree, (list, tuple)):
    for value in tree:
      _bump(value)


def test_a_pending_write_does_not_change_what_a_resume_reads(tmp_path,
                                                             monkeypatch):
  directory = str(tmp_path)
  gate = threading.Event()
  real = ckpt.write_payload

  def held(*args, **kwargs):
    gate.wait(30)
    return real(*args, **kwargs)

  monkeypatch.setattr(ckpt, 'write_payload', held)
  manager = ckpt.CheckpointManager(directory, async_save=True)
  live = _payload(1)
  want = _clone(live)
  assert manager.save(1, live, force=True)
  _bump(live)  # training goes on while the write is pending
  # Pending: invisible to a resume.
  assert ckpt.CheckpointManager(directory).restore() is None
  assert ckpt.latest_checkpoint_step(directory) is None
  gate.set()
  manager.wait_until_finished()
  step, got = ckpt.CheckpointManager(directory).restore()
  assert step == 1 and _same(got, want)
  # The next save reuses the staging buffers; step 1's file is unchanged.
  want_2 = _clone(live)
  assert manager.save(2, live, force=True)
  _bump(live)
  manager.wait_until_finished()
  assert _same(ckpt.CheckpointManager(directory).restore(step=1)[1], want)
  assert _same(ckpt.CheckpointManager(directory).restore()[1], want_2)


def test_a_failed_write_leaves_the_step_torn_and_raises_at_the_next_save(
    tmp_path, monkeypatch):
  directory = str(tmp_path)
  manager = ckpt.CheckpointManager(directory, async_save=True)
  assert manager.save(1, _payload(1), force=True)
  manager.wait_until_finished()

  failed = threading.Event()

  def broken(path, payload, pickle_module=None):
    with open(path, 'wb') as f:
      f.write(b'partial')
    failed.set()
    raise OSError('disk full')

  monkeypatch.setattr(ckpt, 'write_payload', broken)
  assert manager.save(2, _payload(2), force=True)  # the write fails behind
  assert failed.wait(30)
  monkeypatch.undo()
  with pytest.raises(RuntimeError, match='step 2 .* failed to write') as info:
    manager.save(3, _payload(3), force=True)
  assert isinstance(info.value.__cause__, OSError)
  assert ckpt.read_commit_marker(directory, 2) is None
  assert ckpt.read_commit_marker(directory, 3) is None
  assert ckpt.latest_checkpoint_step(directory) == 1
  assert ckpt.CheckpointManager(directory).restore()[0] == 1
  # The manager goes on: the next save commits.
  assert manager.save(4, _payload(4), force=True)
  manager.wait_until_finished()
  assert ckpt.latest_checkpoint_step(directory) == 4


def test_state_file_is_torch_save_byte_for_byte(tmp_path):
  payload = _payload(5)
  staging = ckpt.HostStaging()
  for _ in range(2):  # the second copy reuses the buffers and reductions
    host = staging.copy(payload)
  dtypes = {v.dtype for v in staging._views}  # pylint: disable=protected-access
  assert len({v.untyped_storage().data_ptr() for v in staging._views}) == len(  # pylint: disable=protected-access
      dtypes)
  ours, theirs = str(tmp_path / 'ours.pt'), str(tmp_path / 'base.pt')
  timings = ckpt.write_payload(ours, host, staging.pickle_module)
  assert set(timings) == {'serialize_ms', 'sync_ms'}
  torch.save(host, theirs)
  with zipfile.ZipFile(ours) as a, zipfile.ZipFile(theirs) as b:
    names = [n.split('/', 1)[1] for n in a.namelist()]
    assert sorted(names) == sorted(n.split('/', 1)[1] for n in b.namelist())
    assert len([n for n in names if n.startswith('data/')]) == len(dtypes)
    for name in names:
      if name != '.data/serialization_id':
        assert a.read('ours/' + name) == b.read('base/' + name), name
  loaded = torch.load(ours, map_location='cpu', weights_only=True)
  assert _same(loaded, payload)
  assert os.path.getsize(ours) == os.path.getsize(theirs)


def test_prepare_allocates_the_staging_before_the_first_save(tmp_path):
  manager = ckpt.CheckpointManager(str(tmp_path), async_save=False)
  payload = _payload(3)
  manager.prepare(payload)
  buffers = {v.dtype: v.untyped_storage().data_ptr()
             for v in manager._staging._views}  # pylint: disable=protected-access
  assert manager.save(1, payload, force=True)
  assert {v.dtype: v.untyped_storage().data_ptr()
          for v in manager._staging._views} == buffers  # pylint: disable=protected-access
  assert _same(manager.restore()[1], payload)
