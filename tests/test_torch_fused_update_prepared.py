"""The fused update's table: what the trainer's call hands the kernel.

``ops/fused_update.apply_update`` validates each optimizer's leaves once (a
``PreparedUpdate``) and, each step, checks by identity and address that
the tensors are those it validated and that the new gradients keep their
layouts, then packs the table from the step's addresses. On the CPU the
same bookkeeping runs (the table is built from CPU tensors, nothing
launches) and the plain version computes, so these tests pin, without a
card:

* the leaves, their order and the scalars handed to the plain version are
  those of the optimizer's parameters with a gradient, and five trainer
  steps with the validation kept are bit for bit those of validating anew
  every step;
* the leaves are validated anew after ``optimizer.load_state_dict``, after
  an EMA tensor is replaced, after a parameter's storage moves, and after a
  parameter loses or gains its gradient (the packed pointers follow), and
  the validation is kept, the table differing only in its g column, when
  only the gradients are new;
* a gradient in a layout the kernel does not take raises;
* the host bias corrections are bit for bit ``bias_correction``.
"""

import copy
import operator

import numpy as np
import pytest
import torch

from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.ops import fused_update
from tensor2robot_tpu_torch.research.qtopt import GraspingModelWrapper
from tensor2robot_tpu_torch.train import Trainer, TrainerConfig

SHAPES = [(4, 3, 2, 2), (7,), (1,), (0,), (5, 6), (129,)]
P, G, MU, NU, EMA, N = range(6)


def _setup(seed=0, with_ema=True, kind='adam'):
  generator = torch.Generator().manual_seed(seed)
  params = [torch.nn.Parameter(torch.randn(shape, generator=generator))
            for shape in SHAPES]
  factory = (optimizers.create_adam_optimizer(3e-3) if kind == 'adam' else
             optimizers.create_gradient_descent_optimizer(3e-3))
  optimizer = factory(params)
  ema = ({p: p.detach().clone() for p in params} if with_ema else None)
  plan = fused_update.plan_for(optimizer, ema_decay=0.9)
  return params, optimizer, ema, plan, generator


def _new_grads(params, generator, skip=()):
  for i, p in enumerate(params):
    p.grad = None if i in skip else torch.randn(p.shape, generator=generator)


def _table(plan, optimizer, ema):
  """(the kept PreparedUpdate, the table it packs for the current
  gradients)."""
  prepared, operands = fused_update.prepare(plan, optimizer, ema)
  return prepared, prepared.pack(operands)


def test_hands_the_plain_version_the_leaves_and_scalars(
    monkeypatch):
  """Three steps, one parameter without a gradient: each call of the plain
  version gets the optimizer's parameters with a gradient, in group order,
  with their moments and EMA, and the learning rate and bias corrections
  of ``bias_correction``."""
  params, optimizer, ema, plan, generator = _setup()
  calls = []
  plain = fused_update.plain_fused_update

  def record(leaves, kind, lr, c1, c2, b1, b2, eps, decay, ok=None,
             rates=None):
    assert rates is None  # the host-scalar form outside a CUDA graph
    calls.append((list(leaves), (kind, lr, c1, c2, b1, b2, eps, decay, ok)))
    plain(leaves, kind, lr, c1, c2, b1, b2, eps, decay, ok)

  monkeypatch.setattr(fused_update, 'plain_fused_update', record)
  for step in range(3):
    _new_grads(params, generator, skip=(1,))
    # The leaves, as apply_update read them before the validation was kept.
    want_leaves = []
    for p in params:
      if p.grad is None:
        continue
      state = optimizer.state[p]
      want_leaves.append((p, p.grad, state.get('mu'), state.get('nu'),
                          ema[p]))
    count = optimizer.param_groups[0]['count']
    want_scalars = ('adam', 3e-3,
                    float(fused_update.bias_correction(0.9, count + 1)),
                    float(fused_update.bias_correction(0.999, count + 1)),
                    0.9, 0.999, 1e-8, 0.9, None)
    assert fused_update.apply_update(plan, optimizer, dict(ema))
    leaves, scalars = calls[-1]
    assert scalars == want_scalars
    assert len(leaves) == len(want_leaves) == len(params) - 1
    for got, (p, g, mu, nu, e) in zip(leaves, want_leaves):
      assert got.p.data_ptr() == p.data_ptr() and got.p.shape == p.shape
      assert got.g is g and got.ema is e
      if step:
        assert got.mu is mu and got.nu is nu
      else:  # created at the first step, as the stock Adam creates them
        assert got.mu is optimizer.state[p]['mu']


def _grasping_batches(seed, count, batch=4):
  rng = np.random.RandomState(seed)
  return [({
      'state/image': rng.randint(0, 256, (batch, 80, 80, 3)).astype(np.uint8),
      'action/world_vector': rng.randn(batch, 3).astype(np.float32),
      'action/vertical_rotation': rng.randn(batch, 2).astype(np.float32),
  }, {'reward': rng.randint(0, 2, (batch, 1)).astype(np.float32)})
          for _ in range(count)]


def test_five_trainer_steps_bitwise_as_validating_every_step(monkeypatch):
  """A fused Trainer (tagged Adam under a decaying rate, the EMA and the
  skip_update guard) over 5 steps: with the validation kept and with the
  leaves validated anew every step, bit for bit the same parameters,
  moments, EMA and counts."""
  states, packs = [], []
  init = fused_update.PreparedUpdate.__init__

  def counted_init(self, *args):
    packs.append(1)
    init(self, *args)

  monkeypatch.setattr(fused_update.PreparedUpdate, '__init__', counted_init)
  for repack in (False, True):
    del packs[:]
    if repack:
      monkeypatch.setattr(fused_update.PreparedUpdate, 'holds',
                          lambda self, operands: False)
    model = GraspingModelWrapper(
        device_type='cpu', input_shape=(80, 80, 3), target_shape=(80, 80),
        num_convs=(2, 2, 1),
        create_optimizer_fn=lambda: optimizers.create_adam_optimizer(
            optimizers.create_exp_decaying_learning_rate_fn(
                1e-3, decay_steps=2, staircase=True)))
    trainer = Trainer(model, TrainerConfig(
        max_train_steps=5, log_interval_steps=0, fused_update=True,
        nonfinite_mode='skip_update'), device='cpu')
    trainer.train(iter(_grasping_batches(3, 5)))
    assert trainer.fused_plan is not None and trainer.step == 5
    _, table = _table(trainer.fused_plan, trainer.state.optimizer,
                      trainer.state.ema_by_param())
    assert len(packs) == (6 if repack else 1)
    states.append((trainer.state, table))
  (kept, kept_table), (fresh, _) = states
  assert fresh.optimizer.param_groups[0]['count'] == 5
  assert (kept.optimizer.param_groups[0]['count'] ==
          fresh.optimizer.param_groups[0]['count'])
  for (name, a), b in zip(kept.network.named_parameters(),
                          fresh.network.parameters()):
    assert torch.equal(a, b), name
    for slot in ('mu', 'nu'):
      assert torch.equal(kept.optimizer.state[a][slot],
                         fresh.optimizer.state[b][slot]), (name, slot)
  for name in kept.ema:
    assert torch.equal(kept.ema[name], fresh.ema[name]), name
  assert len(kept_table) == len(list(kept.network.parameters()))


@pytest.mark.parametrize('skip', [(), (1,)])
def test_validation_is_kept_when_only_the_gradients_are_new(skip):
  """Also with a parameter that has no gradient at either step (its EMA
  still blends)."""
  params, optimizer, ema, plan, generator = _setup()
  _new_grads(params, generator, skip)
  fused_update.apply_update(plan, optimizer, dict(ema))
  prepared, before = _table(plan, optimizer, ema)
  _new_grads(params, generator, skip)
  idle_ema = ema[params[1]].clone()
  fused_update.apply_update(plan, optimizer, dict(ema))
  kept, after = _table(plan, optimizer, ema)
  assert kept is prepared
  assert not torch.equal(ema[params[1]], idle_ema)
  # It keeps no step's gradients alive.
  grads = [p.grad for p in params]
  assert not any(any(map(operator.is_, grads, [t] * len(grads)))
                 for t in prepared.fixed)
  np.testing.assert_array_equal(after[:, [P, MU, NU, EMA, N]],
                                before[:, [P, MU, NU, EMA, N]])
  nonempty = [p for i, p in enumerate(params) if p.numel() and i not in skip]
  assert list(after[:, G]) == [p.grad.data_ptr() for p in nonempty]
  assert not np.array_equal(after[:, G], before[:, G])
  # Rows: every non-empty parameter, in order, with its moments and EMA.
  assert list(after[:, P]) == [p.data_ptr() for p in nonempty]
  assert list(after[:, MU]) == [optimizer.state[p]['mu'].data_ptr()
                                for p in nonempty]
  assert list(after[:, EMA]) == [ema[p].data_ptr() for p in nonempty]
  assert list(after[:, N]) == [p.numel() for p in nonempty]


def _repacks(change, column):
  """Steps once, applies ``change``, steps again: the leaves are validated
  anew and ``column`` of the table changed (None: the rows changed).
  Returns the parameters, the optimizer, the EMA and the new table."""
  params, optimizer, ema, plan, generator = _setup()
  _new_grads(params, generator)
  fused_update.apply_update(plan, optimizer, dict(ema))
  prepared, before = _table(plan, optimizer, ema)
  ema = change(params, optimizer, ema, generator) or ema
  fused_update.apply_update(plan, optimizer, dict(ema))
  revalidated, table = _table(plan, optimizer, ema)
  assert revalidated is not prepared
  if column is None:
    assert table.shape != before.shape
  else:
    assert not np.array_equal(table[:, column], before[:, column])
  return params, optimizer, ema, table


def test_repacked_after_load_state_dict():
  def change(params, optimizer, ema, generator):
    optimizer.load_state_dict(copy.deepcopy(optimizer.state_dict()))
    _new_grads(params, generator)

  _, optimizer, _, repacked = _repacks(change, MU)
  nonempty = [p for group in optimizer.param_groups for p in group['params']
              if p.numel()]
  assert list(repacked[:, MU]) == [
      optimizer.state[p]['mu'].data_ptr() for p in nonempty]
  assert list(repacked[:, NU]) == [
      optimizer.state[p]['nu'].data_ptr() for p in nonempty]


def test_repacked_after_an_ema_tensor_is_replaced():
  def change(params, optimizer, ema, generator):
    del optimizer
    ema = dict(ema)
    ema[params[0]] = ema[params[0]].clone()
    _new_grads(params, generator)
    return ema

  params, _, ema, repacked = _repacks(change, EMA)
  assert repacked[0, EMA] == ema[params[0]].data_ptr()


def test_repacked_after_a_parameter_moves():
  def change(params, optimizer, ema, generator):
    del optimizer, ema
    params[4].data = params[4].data.clone()  # what Module.to() does
    _new_grads(params, generator)

  params, _, _, repacked = _repacks(change, P)
  assert params[4].data_ptr() in list(repacked[:, P])


def test_repacked_when_a_parameter_loses_its_gradient():
  def change(params, optimizer, ema, generator):
    del optimizer, ema
    _new_grads(params, generator, skip=(4,))

  params, _, _, repacked = _repacks(change, None)
  assert list(repacked[:, P]) == [p.data_ptr() for i, p in
                                        enumerate(params)
                                        if p.numel() and i != 4]


def test_repacked_when_a_parameter_gains_its_gradient():
  params, optimizer, ema, plan, generator = _setup()
  _new_grads(params, generator, skip=(4,))
  fused_update.apply_update(plan, optimizer, dict(ema))
  prepared, table = _table(plan, optimizer, ema)
  _new_grads(params, generator)
  fused_update.apply_update(plan, optimizer, dict(ema))
  revalidated, repacked = _table(plan, optimizer, ema)
  assert revalidated is not prepared
  assert len(repacked) == len(table) + 1
  assert params[4].grad.data_ptr() in list(repacked[:, G])


def test_a_gradient_in_a_foreign_layout_raises():
  params, optimizer, ema, plan, generator = _setup()
  _new_grads(params, generator)
  fused_update.apply_update(plan, optimizer, dict(ema))
  _new_grads(params, generator)
  params[4].grad = torch.zeros(6, 5).t()  # [5, 6] with swapped strides
  with pytest.raises(ValueError, match='does not copy'):
    fused_update.apply_update(plan, optimizer, dict(ema))
  # A first step packs through _check_leaves, which raises as well.
  params, optimizer, ema, plan, generator = _setup(seed=1)
  _new_grads(params, generator)
  params[4].grad = torch.zeros(6, 5).t()
  with pytest.raises(ValueError, match='strides'):
    fused_update.apply_update(plan, optimizer, dict(ema))


def test_sgd_without_ema_packs_zero_moment_and_ema_columns():
  params, optimizer, _, plan, generator = _setup(with_ema=False, kind='sgd')
  _new_grads(params, generator)
  assert fused_update.apply_update(plan, optimizer)
  _, table = _table(plan, optimizer, None)
  assert not table[:, [MU, NU, EMA]].any()
  assert list(table[:, P]) == [p.data_ptr() for p in params if p.numel()]


@pytest.mark.parametrize('decay', [0.9, 0.999])
def test_host_bias_correction_is_bitwise_torchs(decay):
  """Counts 1 to 10**5 (and 0): the host float is bit for bit the float
  of the float32 tensor ``bias_correction`` computes."""
  for count in range(0, 10**5 + 1):
    assert fused_update.host_bias_correction(decay, count) == float(
        fused_update.bias_correction(decay, count)), count
