"""Port parity: the fused optimizer/EMA/guard update against the JAX package.

Kernel level: the port's plain version (``ops/fused_update.plain_fused_update``
through ``apply_update``, as the trainer calls it) against the JAX package's
``apply_update`` with its Pallas kernel interpreted on the CPU
(``force_kernels(True)``), from the same seeded params, gradients, moments,
EMA and counts (the optax state comes in through
``utils/convert.optax_state_to_torch``), in all 8 variants (Adam or SGD, EMA
on or off, guard on or off) at a constant and a scheduled learning rate,
over leaves of 1, 127, 129 and 131,372 elements (the last crosses two of the
TPU kernel's (1024, 128) blocks). Band: the JAX package's, atol 1e-6 /
rtol 1e-5. A False guard leaves everything bitwise.

Trainer level: the fused step against the stock ``Adam`` over 1 step; the
port's ``Trainer(fused_update=True)`` against the JAX
``Trainer(fused_update=True)`` on the small SNAIL sequential model over 3
steps; an untagged optimizer under ``fused_update=True`` is bitwise the
stock path.

Multi-step Adam comparisons exclude leaves whose true gradient is 0: Adam's
``mu / sqrt(nu)`` turns float32 rounding noise into steps of about ±lr
there. The last test pins that finding on the JAX package's own mock, where
it makes ``tests/test_device_feed.py::
test_fused_update_composes_with_device_feed`` fail.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_device_feed import make_batches, make_trainer
from test_torch_vrgripper import (EPISODE, IMAGE, STEPS, _batches, _JaxModel,
                                  _PortModel, _trainer_variables)

from tensor2robot_tpu.layers import snail as jax_snail
from tensor2robot_tpu.models import optimizers as jax_optimizers
from tensor2robot_tpu.ops import _pallas_dispatch
from tensor2robot_tpu.ops import fused_update as jax_fused
from tensor2robot_tpu.train.trainer import Trainer as JaxTrainer
from tensor2robot_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from tensor2robot_tpu_torch.layers import snail
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.ops import fused_update
from tensor2robot_tpu_torch.research.qtopt import GraspingModelWrapper
from tensor2robot_tpu_torch.train import Trainer, TrainerConfig
from tensor2robot_tpu_torch.utils import convert

# Leaves of 1, 127, 129 (a [43, 3] kernel) and 131,372 elements.
SHAPES = {'a': {'bias': (1,)}, 'b': {'bias': (127,)},
          'c': {'kernel': (43, 3)}, 'd': {'scale': (131072 + 300,)}}
COUNT = 7
DECAY = 0.9
ATOL, RTOL = 1e-6, 1e-5
# Leaves whose gradient is 0 but for rounding (see the module docstring).
ZERO_GRADIENT_LEAVES = ('key.bias', 'final_norm.bias')


def _tree(rng, positive=False):
  tree = {}
  for scope, leaves in SHAPES.items():
    tree[scope] = {}
    for leaf, shape in leaves.items():
      value = rng.randn(*shape).astype(np.float32)
      tree[scope][leaf] = np.abs(value) * 1e-3 if positive else value
  return tree


def _to_torch(tree):
  return convert.snail_variables_to_torch({'params': tree})


def _network(params):
  """A module whose parameters are the converted ``params`` tree."""
  net = torch.nn.Module()
  for name, value in _to_torch(params).items():
    scope, leaf = name.split('.')
    if not hasattr(net, scope):
      net.add_module(scope, torch.nn.Module())
    getattr(net, scope).register_parameter(
        leaf, torch.nn.Parameter(value.clone()))
  return net


def _schedule(torch_side):
  make = (optimizers.create_exp_decaying_learning_rate_fn if torch_side else
          jax_optimizers.create_exp_decaying_learning_rate_fn)
  return make(1e-2, decay_steps=3, decay_rate=0.5, staircase=True)


def _case(kind, scheduled, seed=0):
  """Seeded (params, grads, ema, JAX optimizer, JAX opt state)."""
  rng = np.random.RandomState(seed)
  params, grads, ema = _tree(rng), _tree(rng), _tree(rng)
  lr = _schedule(False) if scheduled else 3e-3
  if kind == 'adam':
    tx = jax_optimizers.create_adam_optimizer(lr)
  else:
    tx = jax_optimizers.create_gradient_descent_optimizer(lr)
  state = tx.init(jax.tree_util.tree_map(jnp.asarray, params))

  def fill(s):
    if isinstance(s, optax.ScaleByAdamState):
      return optax.ScaleByAdamState(
          count=jnp.asarray(COUNT, jnp.int32),
          mu=jax.tree_util.tree_map(jnp.asarray, _tree(rng)),
          nu=jax.tree_util.tree_map(jnp.asarray, _tree(rng, positive=True)))
    if isinstance(s, optax.ScaleByScheduleState):
      return optax.ScaleByScheduleState(count=jnp.asarray(COUNT, jnp.int32))
    return s

  kinds = (optax.ScaleByAdamState, optax.ScaleByScheduleState)
  state = jax.tree_util.tree_map(fill, state,
                                 is_leaf=lambda s: isinstance(s, kinds))
  return params, grads, ema, tx, state


def _found(state, kind):
  return [s for s in jax.tree_util.tree_leaves(
      state, is_leaf=lambda s: isinstance(s, kind)) if isinstance(s, kind)]


def _port(kind, scheduled, params, grads, ema, jax_state, with_ema):
  """The port's network, tagged optimizer (state converted from optax),
  gradients and EMA."""
  net = _network(params)
  lr = _schedule(True) if scheduled else 3e-3
  factory = (optimizers.create_adam_optimizer(lr) if kind == 'adam' else
             optimizers.create_gradient_descent_optimizer(lr))
  assert fused_update.spec_of(factory).kind == kind
  optimizer = factory(net.parameters())
  adams = _found(jax_state, optax.ScaleByAdamState)
  scheds = _found(jax_state, optax.ScaleByScheduleState)
  adam = None
  if adams:
    adam = (np.asarray(adams[0].count), jax.device_get(adams[0].mu),
            jax.device_get(adams[0].nu))
  optimizer.load_state_dict(convert.optax_state_to_torch(
      optimizer, net, adam=adam,
      schedule_count=np.asarray(scheds[0].count) if scheds else None,
      variables_to_torch=convert.snail_variables_to_torch))
  for name, g in _to_torch(grads).items():
    net.get_parameter(name).grad = g.clone()
  ema_t = _to_torch(ema) if with_ema else None
  ema_by_param = (None if ema_t is None else
                  {p: ema_t[n] for n, p in net.named_parameters()})
  return net, optimizer, ema_t, ema_by_param


def _moments(net, optimizer):
  out = {}
  for name, p in net.named_parameters():
    for slot, value in optimizer.state[p].items():
      out[f'{slot} {name}'] = value
  return out


VARIANTS = [(kind, ema, guard) for kind in ('adam', 'sgd')
            for ema in (False, True) for guard in (False, True)]


@pytest.mark.parametrize('scheduled', [False, True])
@pytest.mark.parametrize('kind,with_ema,guard', VARIANTS)
def test_plain_update_matches_jax_kernel(kind, with_ema, guard, scheduled):
  params, grads, ema, tx, state = _case(kind, scheduled)
  with _pallas_dispatch.force_kernels(True):
    plan = jax_fused.plan_for(tx, ema_decay=DECAY if with_ema else None,
                              opt_state=state)
    assert plan is not None
    want_p, want_state, want_ema = jax.jit(functools.partial(
        jax_fused.apply_update, plan))(
            jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, grads), state,
            jax.tree_util.tree_map(jnp.asarray, ema) if with_ema else None,
            ok=jnp.asarray(True) if guard else None)
  net, optimizer, ema_t, ema_by_param = _port(kind, scheduled, params, grads,
                                              ema, state, with_ema)
  plan = fused_update.plan_for(optimizer, ema_decay=DECAY)
  assert plan is not None
  applied = fused_update.apply_update(
      plan, optimizer, ema_by_param,
      ok=torch.tensor([True]) if guard else None)
  assert applied
  got = dict(net.named_parameters())
  for name, want in _to_torch(jax.device_get(want_p)).items():
    np.testing.assert_allclose(got[name].detach().numpy(), want.numpy(),
                               atol=ATOL, rtol=RTOL, err_msg=name)
  if with_ema:
    for name, want in _to_torch(jax.device_get(want_ema)).items():
      np.testing.assert_allclose(ema_t[name].numpy(), want.numpy(),
                                 atol=ATOL, rtol=RTOL, err_msg=f'ema {name}')
  moments = _moments(net, optimizer)
  for adam in _found(want_state, optax.ScaleByAdamState):
    for slot in ('mu', 'nu'):
      for name, want in _to_torch(jax.device_get(getattr(adam, slot))).items():
        np.testing.assert_allclose(moments[f'{slot} {name}'].numpy(),
                                   want.numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=f'{slot} {name}')
  if kind == 'sgd':
    assert not moments
  counts = {int(s.count) for s in _found(
      want_state, (optax.ScaleByAdamState, optax.ScaleByScheduleState))}
  assert counts == ({COUNT + 1} if kind == 'adam' or scheduled else set())
  for group in optimizer.param_groups:
    assert group.get('count') == (COUNT + 1 if counts else None)


@pytest.mark.parametrize('kind,with_ema', [('adam', True), ('sgd', True),
                                           ('adam', False)])
def test_false_guard_leaves_everything_bitwise(kind, with_ema):
  params, grads, ema, _, state = _case(kind, scheduled=True, seed=3)
  net, optimizer, ema_t, ema_by_param = _port(kind, True, params, grads, ema,
                                              state, with_ema)
  before = {k: v.detach().clone() for k, v in net.named_parameters()}
  moments = {k: v.clone() for k, v in _moments(net, optimizer).items()}
  ema_before = None if ema_t is None else {k: v.clone()
                                           for k, v in ema_t.items()}
  plan = fused_update.plan_for(optimizer, ema_decay=DECAY)
  net.get_parameter('c.weight').grad[0, 0] = float('nan')
  assert not fused_update.apply_update(plan, optimizer, ema_by_param,
                                       ok=torch.tensor([False]))
  for name, p in net.named_parameters():
    assert torch.equal(p.detach(), before[name]), name
  for name, value in _moments(net, optimizer).items():
    assert torch.equal(value, moments[name]), name
  if ema_t is not None:
    for name, value in ema_t.items():
      assert torch.equal(value, ema_before[name]), name
  assert all(group['count'] == COUNT for group in optimizer.param_groups)


def test_fused_step_matches_stock_adam_and_keeps_its_state_dict():
  """One step from a fresh optimizer: the fused update against the stock
  ``Adam.step`` within the band; both leave the same ``state_dict`` shape,
  so either can resume the other."""
  params, grads, _, _, _ = _case('adam', scheduled=True, seed=5)
  runs = []
  for fused in (False, True):
    net = _network(params)
    optimizer = optimizers.create_adam_optimizer(_schedule(True))(
        net.parameters())
    for name, g in _to_torch(grads).items():
      net.get_parameter(name).grad = g.clone()
    if fused:
      assert fused_update.apply_update(fused_update.plan_for(optimizer),
                                       optimizer)
    else:
      optimizer.step()
    runs.append((net, optimizer))
  (stock_net, stock_opt), (fused_net, fused_opt) = runs
  for (name, got), want in zip(fused_net.named_parameters(),
                               stock_net.parameters()):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               atol=ATOL, rtol=RTOL, err_msg=name)
  stock_sd, fused_sd = stock_opt.state_dict(), fused_opt.state_dict()
  assert stock_sd['param_groups'] == fused_sd['param_groups']
  assert stock_sd['param_groups'][0]['count'] == 1
  assert set(stock_sd['state']) == set(fused_sd['state'])
  for index, slots in stock_sd['state'].items():
    assert set(slots) == set(fused_sd['state'][index]) == {'mu', 'nu'}
    for slot, value in slots.items():
      np.testing.assert_allclose(fused_sd['state'][index][slot].numpy(),
                                 value.numpy(), atol=ATOL, rtol=RTOL)
  # The fused optimizer resumes through the stock step and back.
  stock_opt.load_state_dict(fused_sd)
  assert fused_update.plan_for(stock_opt) is not None


def test_parameter_without_gradient_takes_the_stock_path():
  """A parameter without a gradient keeps its value and moments and still
  takes its EMA blend, as the stock Adam and EMA leave it."""
  params, grads, ema, _, _ = _case('adam', scheduled=False, seed=9)
  runs = []
  for fused in (False, True):
    net = _network(params)
    optimizer = optimizers.create_adam_optimizer(3e-3)(net.parameters())
    for name, g in _to_torch(grads).items():
      if name != 'b.bias':
        net.get_parameter(name).grad = g.clone()
    ema_t = _to_torch(ema)
    if fused:
      fused_update.apply_update(
          fused_update.plan_for(optimizer, ema_decay=DECAY), optimizer,
          {p: ema_t[n] for n, p in net.named_parameters()})
    else:
      optimizer.step()
      for name, p in net.named_parameters():
        ema_t[name].mul_(DECAY).add_(p.detach(), alpha=1 - DECAY)
    runs.append((net, optimizer, ema_t))
  (stock, stock_opt, stock_ema), (fused, fused_opt, fused_ema) = runs
  assert torch.equal(fused.get_parameter('b.bias'), stock.get_parameter(
      'b.bias'))
  assert not fused_opt.state[fused.get_parameter('b.bias')]
  for name, value in fused_ema.items():
    np.testing.assert_allclose(value.numpy(), stock_ema[name].numpy(),
                               atol=ATOL, rtol=RTOL, err_msg=name)


def test_plan_depends_on_the_tag_and_the_state_only():
  net = _network(_case('adam', False)[0])
  assert fused_update.plan_for(
      optimizers.create_momentum_optimizer()(net.parameters())) is None
  assert fused_update.plan_for(
      optimizers.create_rms_prop_optimizer()(net.parameters())) is None
  adam = optimizers.default_create_optimizer_fn()(net.parameters())
  assert fused_update.plan_for(adam) is not None  # CPU tensors: still a plan
  adam.state[next(iter(net.parameters()))]['extra'] = torch.zeros(1)
  assert fused_update.plan_for(adam) is None  # an unrecognised slot
  sgd = optimizers.create_gradient_descent_optimizer(_schedule(True))(
      net.parameters())
  assert fused_update.plan_for(sgd).spec.kind == 'sgd'
  assert 'count' in sgd.param_groups[0]
  assert 'count' not in optimizers.GradientDescent(
      net.parameters(), 1e-3).param_groups[0]


def test_gradient_descent_matches_optax_sgd():
  params, grads, _, tx, state = _case('sgd', scheduled=True, seed=7)
  net, optimizer, _, _ = _port('sgd', True, params, grads, None, state, False)
  optimizer.step()
  updates, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state)
  want = optax.apply_updates(jax.tree_util.tree_map(jnp.asarray, params),
                             updates)
  got = dict(net.named_parameters())
  for name, value in _to_torch(jax.device_get(want)).items():
    np.testing.assert_allclose(got[name].detach().numpy(), value.numpy(),
                               atol=ATOL, rtol=RTOL, err_msg=name)
  assert optimizer.param_groups[0]['count'] == COUNT + 1


@pytest.mark.parametrize('name,args', [
    ('create_constant_learning_rate_fn', (3e-4,)),
    ('create_exp_decaying_learning_rate_fn', (1e-3, 10, 0.5, True)),
    ('create_exp_decaying_learning_rate_fn', (1e-3, 10, 0.5, False)),
])
def test_learning_rate_factories_match_jax(name, args):
  got = getattr(optimizers, name)(*args)
  want = getattr(jax_optimizers, name)(*args)
  for count in (0, 1, 9, 10, 11, 35):
    np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6)


def test_kernel_wrapper_raises_on_layouts_it_does_not_take():
  p = torch.zeros(4, 6)
  leaf = fused_update.Leaf(p, torch.zeros(6, 4).t())
  with pytest.raises(ValueError, match='CUDA'):
    fused_update.fused_update([leaf], 'sgd', 1e-3, 1, 1, 0.9, 0.999, 1e-8,
                              None)
  with pytest.raises(ValueError, match='strides'):
    fused_update._check_leaves([leaf], False, False, p.device)  # pylint: disable=protected-access
  # A [32, 32, 1, 1] weight and a gradient whose size-1 dims have other
  # strides address the same elements in the same order.
  p = torch.zeros(32, 32, 1, 1)
  g = torch.zeros(32, 32, 1, 1).as_strided((32, 32, 1, 1), (32, 1, 32, 32))
  fused_update._check_leaves([fused_update.Leaf(p, g)], False, False,  # pylint: disable=protected-access
                             p.device)
  assert not fused_update._dense(torch.zeros(4, 6)[:, :3])  # pylint: disable=protected-access
  assert fused_update._dense(torch.zeros(4, 6).t())  # pylint: disable=protected-access


# ----------------------------------------------------------------- trainer


def test_trainer_fused_update_matches_jax_fused_trainer(monkeypatch):
  """The port's Trainer (fused, plain version) against the JAX Trainer
  (fused, Pallas kernel interpreted) on the small SNAIL sequential model
  over 3 Adam steps, from the same weights on the same batches. Band as
  ``test_torch_vrgripper.py::test_trainer_matches_jax``: each change within
  2·lr per element, each leaf's change within 1e-2 relative L2, except the
  zero-gradient leaves."""
  variables = _trainer_variables()
  jax_model = _JaxModel(episode_length=EPISODE, image_size=IMAGE,
                        device_type='cpu',
                        init_from_checkpoint_fn=lambda params, state: (
                            variables['params'], {}))
  jax_trainer = JaxTrainer(jax_model, JaxTrainerConfig(
      model_dir='', max_train_steps=STEPS, eval_interval_steps=0,
      log_interval_steps=0, fused_update=True))
  monkeypatch.setattr(jax_snail, '_flash_auto_ok', lambda: True)
  monkeypatch.setattr(snail, '_flash_auto_ok', lambda x: True)
  with _pallas_dispatch.force_kernels(True):
    jax_trainer.train(iter(_batches()), None)
  want_vars = jax.device_get(dict(jax_trainer.state.variables))
  model = _PortModel(
      episode_length=EPISODE, image_size=IMAGE, device_type='cpu',
      init_from_checkpoint_fn=lambda network: network.load_state_dict(
          convert.snail_variables_to_torch(variables)))
  trainer = Trainer(model, TrainerConfig(max_train_steps=STEPS,
                                         log_interval_steps=0,
                                         fused_update=True), device='cpu')
  stock_calls = []
  monkeypatch.setattr(optimizers.Adam, 'step',
                      lambda self, closure=None: stock_calls.append(1))
  trainer.train(iter(_batches()))
  assert trainer.fused_plan is not None and not stock_calls
  assert trainer.state.optimizer.param_groups[0]['count'] == STEPS
  start = convert.snail_variables_to_torch(variables)
  want = convert.snail_variables_to_torch(want_vars)
  got = trainer.state.network.state_dict()
  assert set(got) == set(want)
  lr = 1e-4
  for name in want:
    change, want_change = got[name] - start[name], want[name] - start[name]
    assert not torch.equal(got[name], start[name]), name
    ulps = 4 * np.finfo(np.float32).eps * float(want[name].abs().max())
    assert float((change - want_change).abs().max()) <= 2 * lr + ulps, name
    if not name.endswith(ZERO_GRADIENT_LEAVES):
      assert float((change - want_change).norm()) <= 1e-2 * float(
          want_change.norm()), name


def _grasping_batches(seed=0, count=2, batch=4):
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(count):
    out.append(({
        'state/image': rng.randint(0, 256, (batch, 80, 80, 3)).astype(
            np.uint8),
        'action/world_vector': rng.randn(batch, 3).astype(np.float32),
        'action/vertical_rotation': rng.randn(batch, 2).astype(np.float32),
    }, {'reward': rng.randint(0, 2, (batch, 1)).astype(np.float32)}))
  return out


def test_untagged_optimizer_under_fused_update_is_bitwise_stock():
  """QT-Opt's momentum builder is untagged: fused_update=True keeps the
  stock path, bit for bit, as in the JAX package."""
  states = []
  for fused in (False, True):
    model = GraspingModelWrapper(device_type='cpu', input_shape=(80, 80, 3),
                                 target_shape=(80, 80), num_convs=(2, 2, 1))
    trainer = Trainer(model, TrainerConfig(max_train_steps=2,
                                           log_interval_steps=0,
                                           fused_update=fused), device='cpu')
    trainer.train(iter(_grasping_batches()))
    assert trainer.fused_plan is None
    assert isinstance(trainer.state.optimizer, optimizers.MomentumSGD)
    states.append(trainer.state)
  for (name, a), b in zip(states[0].network.state_dict().items(),
                          states[1].network.state_dict().values()):
    assert torch.equal(a, b), name
  for name in states[0].ema:
    assert torch.equal(states[0].ema[name], states[1].ema[name]), name


# ------------------------------------------------------ the JAX finding


def test_jax_fused_parity_gap_is_one_zero_gradient_leaf():
  """The JAX mock (MockT2RModel, tagged Adam at lr 1e-2), stock against the
  forced fused path over 6 steps: every leaf within the band but
  ``Dense_0.bias``, which feeds a train-mode BatchNorm, so its true gradient
  is 0: its nu stays below 1e-15 and Adam turns its rounding noise into
  steps of about ±lr. That leaf, not the kernel, is what fails
  ``test_fused_update_composes_with_device_feed``."""
  runs = []
  for fused in (False, True):
    trainer = make_trainer(max_train_steps=6, fused_update=fused)
    with _pallas_dispatch.force_kernels(fused):
      trainer.train(iter(make_batches(6)), None)
    runs.append(trainer.state)
  stock, fused = runs
  got = jax.tree_util.tree_leaves_with_path(jax.device_get(fused.params))
  want = jax.tree_util.tree_leaves(jax.device_get(stock.params))
  outside = []
  for (path, a), b in zip(got, want):
    name = jax.tree_util.keystr(path)
    if not np.allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=RTOL):
      outside.append(name)
  assert outside == ["['Dense_0']['bias']"]
  for state in runs:
    (adam,) = _found(state.opt_state, optax.ScaleByAdamState)
    assert float(np.abs(np.asarray(adam.nu['Dense_0']['bias'])).max()) < 1e-15
