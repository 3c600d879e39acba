"""The port's non-finite guard: counterparts of ``tests/test_resilience.py``'s
non-finite tests, on the tiny QT-Opt critic (80x80 crops of 88x88 frames,
``num_convs=(2, 2, 1)``, batch 4, float32) so that a skipped step has a
random crop, train-mode batch statistics, an EMA and optimizer slots to
leave alone.

Three arms: the stock momentum optimizer (untagged), stock Adam, and Adam
on the fused path (``fused_update=True``, a scheduled rate, the EMA and the
guard through the kernel's plain version). A NaN batch under
``'skip_update'`` leaves parameters, batch statistics, moments, counts, the
EMA, the step and the generator exactly as a run that never drew it; the
raise and halt policies, the accounting (held to the JAX
``NonFinitePolicy``) and the guard's flag are pinned too; with clean data
the guarded step is bitwise the unguarded one.
"""

import numpy as np
import pytest
import torch

from tensor2robot_tpu.train import resilience as jax_resilience
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.research.qtopt import GraspingModelWrapper
from tensor2robot_tpu_torch.train import Trainer, TrainerConfig
from tensor2robot_tpu_torch.train import resilience
from tensor2robot_tpu_torch.train.trainer import all_finite

ARMS = ('momentum', 'adam', 'fused')


def _batches(count, seed=0, batch=4):
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(count):
    out.append(({
        'state/image': rng.randint(0, 256, (batch, 88, 88, 3)).astype(
            np.uint8),
        'action/world_vector': rng.randn(batch, 3).astype(np.float32),
        'action/vertical_rotation': rng.randn(batch, 2).astype(np.float32),
    }, {'reward': rng.randint(0, 2, (batch, 1)).astype(np.float32)}))
  return out


def _nanify(batch):
  features, labels = batch
  features = dict(features)
  poisoned = features['action/world_vector'].copy()
  poisoned[1, 0] = np.nan
  features['action/world_vector'] = poisoned
  return features, labels


def _train(batches, arm, max_steps=None, **cfg):
  kwargs = {}
  if arm != 'momentum':
    kwargs['create_optimizer_fn'] = lambda: optimizers.create_adam_optimizer(
        optimizers.create_exp_decaying_learning_rate_fn(
            1e-3, decay_steps=2, decay_rate=0.5))
  model = GraspingModelWrapper(device_type='cpu', input_shape=(88, 88, 3),
                               target_shape=(80, 80), num_convs=(2, 2, 1),
                               **kwargs)
  trainer = Trainer(model, TrainerConfig(
      max_train_steps=len(batches) if max_steps is None else max_steps,
      log_interval_steps=0, fused_update=arm == 'fused', **cfg),
                    device='cpu')
  trainer.train(iter(batches))
  assert (trainer.fused_plan is not None) == (arm == 'fused')
  return trainer


def _assert_state_bitwise(a, b):
  assert a.step == b.step
  for (name, x), y in zip(a.state.network.state_dict().items(),
                          b.state.network.state_dict().values()):
    assert torch.equal(x, y), name
  for name in a.state.ema:
    assert torch.equal(a.state.ema[name], b.state.ema[name]), f'ema {name}'
  sa, sb = a.state.optimizer.state_dict(), b.state.optimizer.state_dict()
  assert sa['param_groups'] == sb['param_groups']
  assert set(sa['state']) == set(sb['state'])
  for index, slots in sa['state'].items():
    for slot, value in slots.items():
      assert torch.equal(value, sb['state'][index][slot]), (index, slot)
  assert torch.equal(a.state.generator.get_state(),
                     b.state.generator.get_state())


@pytest.mark.parametrize('arm', ARMS)
def test_nan_batch_skip_update_equals_run_without_it(arm):
  b = _batches(3)
  run_a = _train([b[0], _nanify(b[1]), b[2]], arm, max_steps=2,
                 nonfinite_mode='skip_update')
  assert run_a.step == 2
  assert run_a.nonfinite_policy.bad_steps == 1
  for param in run_a.state.network.parameters():
    assert bool(torch.isfinite(param).all())
  run_b = _train([b[0], b[2]], arm, nonfinite_mode='skip_update')
  _assert_state_bitwise(run_a, run_b)


@pytest.mark.parametrize('arm', ARMS)
def test_guard_on_clean_data_is_bitwise_guard_off(arm):
  b = _batches(3, seed=1)
  guarded = _train(b, arm, nonfinite_mode='skip_update')
  plain = _train(b, arm)
  assert guarded.nonfinite_policy.bad_steps == 0
  assert plain.nonfinite_policy is None
  _assert_state_bitwise(guarded, plain)


def test_nan_batch_raise_policy_on_the_fused_path():
  b = _batches(3, seed=2)
  with pytest.raises(resilience.NonFiniteError, match='policy=raise'):
    _train([b[0], _nanify(b[1]), b[2]], 'fused', max_steps=3,
           nonfinite_mode='raise')


def test_raise_leaves_the_state_of_the_last_good_step():
  b = _batches(2, seed=2)
  model = GraspingModelWrapper(device_type='cpu', input_shape=(88, 88, 3),
                               target_shape=(80, 80), num_convs=(2, 2, 1))
  trainer = Trainer(model, TrainerConfig(max_train_steps=3,
                                         log_interval_steps=0,
                                         nonfinite_mode='raise'),
                    device='cpu')
  with pytest.raises(resilience.NonFiniteError, match='policy=raise'):
    trainer.train(iter([b[0], _nanify(b[1])]))
  assert trainer.step == 1
  reference = _train([b[0]], 'momentum', nonfinite_mode='raise')
  _assert_state_bitwise(trainer, reference)


@pytest.mark.parametrize('arm', ('momentum', 'fused'))
def test_raise_fires_one_dispatch_behind_at_k_steps_per_dispatch(arm):
  """At steps_per_dispatch=3 the guard's count is read one dispatch
  behind, as in the JAX trainer: a NaN batch in the first dispatch raises
  after the second, and the state is that of the last good step, bit for
  bit a run over the good batches alone."""
  b = _batches(9, seed=5)
  poisoned = [b[0], _nanify(b[1])] + b[2:]
  model_kwargs = {}
  if arm != 'momentum':
    model_kwargs['create_optimizer_fn'] = (
        lambda: optimizers.create_adam_optimizer(
            optimizers.create_exp_decaying_learning_rate_fn(
                1e-3, decay_steps=2, decay_rate=0.5)))
  model = GraspingModelWrapper(device_type='cpu', input_shape=(88, 88, 3),
                               target_shape=(80, 80), num_convs=(2, 2, 1),
                               **model_kwargs)
  trainer = Trainer(model, TrainerConfig(
      max_train_steps=9, log_interval_steps=0, steps_per_dispatch=3,
      fused_update=arm == 'fused', nonfinite_mode='raise'), device='cpu')
  with pytest.raises(resilience.NonFiniteError, match='at step 3 '):
    trainer.train(iter(poisoned))
  assert trainer.step == 5  # dispatches 1 and 2 ran, one update skipped
  reference = _train([b[0]] + b[2:6], arm, nonfinite_mode='raise')
  _assert_state_bitwise(trainer, reference)


@pytest.mark.parametrize('arm', ('momentum', 'fused'))
def test_all_nan_stream_halts_after_consecutive_budget(arm):
  poisoned = [_nanify(x) for x in _batches(5, seed=3)]
  with pytest.raises(resilience.NonFiniteError, match='3 consecutive'):
    _train(poisoned, arm, nonfinite_mode='skip_update',
           nonfinite_halt_after=3)


def test_nonfinite_policy_accounting_matches_jax():
  observations = [(1, 1), (0, 2), (2, 3), (1, 4), (1, 5)]
  policies = [resilience.NonFinitePolicy('skip_update', halt_after=3),
              jax_resilience.NonFinitePolicy('skip_update', halt_after=3)]
  for policy in policies:
    for count, step in observations[:-1]:
      policy.observe(count, step=step)
    assert policy.bad_steps == 4
    assert policy.consecutive_bad == 2
    with pytest.raises((resilience.NonFiniteError,
                        jax_resilience.NonFiniteError), match='3 consecutive'):
      policy.observe(*observations[-1])
  off = resilience.NonFinitePolicy('off')
  off.observe(1, step=1)
  assert not off.enabled and off.bad_steps == 0
  with pytest.raises(ValueError):
    resilience.NonFinitePolicy('explode')
  with pytest.raises(ValueError):
    Trainer(GraspingModelWrapper(device_type='cpu'),
            TrainerConfig(nonfinite_mode='explode'), device='cpu')


@pytest.mark.parametrize('poison,want', [(None, True), ('nan', False),
                                         ('inf', False), ('-inf', False),
                                         ('big', True), ('loss', False)])
def test_all_finite_flag(poison, want):
  grads = [torch.ones(3), torch.full((2, 2), 3e38), torch.zeros(5)]
  loss = torch.tensor(0.5)
  if poison == 'loss':
    loss = torch.tensor(float('nan'))
  elif poison == 'big':
    grads[0] = torch.full((3,), 3e38)  # the L1 norm overflows; still finite
  elif poison is not None:
    grads[2][3] = float(poison)
  flag = all_finite(loss, grads + [None])
  assert flag.shape == (1,) and flag.dtype == torch.bool
  assert bool(flag) is want
