"""Port parity: the gradient-clipping and accumulation wrappers.

``models/optimizers.with_gradient_clipping`` and
``with_gradient_accumulation`` against the JAX package's wrappers (optax's
``clip_by_global_norm`` / ``clip`` chain and ``optax.MultiSteps``), on the
CPU:

* clipping by global norm, by value and both, in front of momentum under a
  decaying schedule, over 6 steps of seeded gradients whose norm crosses
  the limit both ways: parameters within 1e-6 of their largest magnitude
  (the norm's sums run in another order; the rest is elementwise);
* accumulation over 2 and 3 calls, over momentum and Adam, over 7 steps:
  parameters, the inner slots and the running mean (``acc_grads``) within
  the same band, ``mini_step`` and ``gradient_step`` exactly, and the
  parameters bit for bit unmoved on the calls that hold, as the JAX
  package's ``tests/test_memory_scaling.py`` checks;
* an optax state taken mid-window (``optax_state_to_torch``) resumes in the
  port and ends where optax ends;
* through the trainer, accumulation over 3 calls of clipped momentum at 4
  steps a dispatch is bit for bit 4 single steps (so which calls of a
  dispatch apply moves from dispatch to dispatch), with and without a NaN
  batch under ``skip_update``; a checkpoint round trip resumes bit for
  bit; ``fused_update=True`` over a wrapped Adam takes the stock path.

About 17 s alone on the CPU, imports included.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_steps_per_dispatch import (assert_state_bitwise, nanify,
                                           qtopt_batches)

from tensor2robot_tpu.models import optimizers as jax_optimizers
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.research.qtopt import GraspingModelWrapper
from tensor2robot_tpu_torch.train import Trainer, TrainerConfig
from tensor2robot_tpu_torch.train.train_state import (load_state_dict,
                                                      state_dict)
from tensor2robot_tpu_torch.utils import convert

SHAPES = {'b': (5,), 'w': (3, 4)}
BAND = 1e-6


class _Params(torch.nn.Module):

  def __init__(self, values):
    super().__init__()
    for name, value in values.items():
      self.register_parameter(name, torch.nn.Parameter(
          torch.from_numpy(np.array(value, np.float32))))


def _to_torch(variables):
  return {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in variables['params'].items()}


def _initial(seed=0):
  rng = np.random.RandomState(seed)
  return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(steps, seed=1, scale=None):
  rng = np.random.RandomState(seed)
  scale = scale or [1.0] * steps
  return [{k: (rng.randn(*s) * scale[i]).astype(np.float32)
           for k, s in SHAPES.items()} for i in range(steps)]


def _jax_schedule():
  return jax_optimizers.create_exp_decaying_learning_rate_fn(
      0.1, decay_steps=2, decay_rate=0.5, staircase=True)


def _schedule():
  return optimizers.create_exp_decaying_learning_rate_fn(
      0.1, decay_steps=2, decay_rate=0.5, staircase=True)


def _inner(kind):
  if kind == 'momentum':
    return (jax_optimizers.create_momentum_optimizer(_jax_schedule(), 0.9),
            optimizers.create_momentum_optimizer(_schedule(), 0.9))
  return (jax_optimizers.create_adam_optimizer(_jax_schedule()),
          optimizers.create_adam_optimizer(_schedule()))


def _assert_close(got, want, what):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  scale = max(float(np.abs(want).max()), 1e-12)
  err = float(np.abs(got - want).max())
  assert err <= BAND * scale, (what, err, scale)


def _run(jax_opt, port_factory, grads, params=None, opt_state=None,
         module=None, optimizer=None):
  """Both optimizers over ``grads``; returns (jax params, jax state, port
  module, port optimizer, per-step port params)."""
  params = params or {k: jnp.asarray(v) for k, v in _initial().items()}
  opt_state = opt_state if opt_state is not None else jax_opt.init(params)
  if module is None:
    module = _Params({k: np.asarray(v) for k, v in params.items()})
    optimizer = port_factory(module.parameters())
  names = dict(module.named_parameters())
  history = []
  update = jax.jit(jax_opt.update)
  for g in grads:
    updates, opt_state = update(
        {k: jnp.asarray(v) for k, v in g.items()}, opt_state, params)
    params = optax.apply_updates(params, updates)
    optimizer.zero_grad(set_to_none=True)
    for k, v in g.items():
      names[k].grad = torch.from_numpy(v.copy())
    before = {k: p.detach().clone() for k, p in names.items()}
    optimizer.step()
    history.append((before, {k: p.detach().clone() for k, p in names.items()}))
    for k in names:
      _assert_close(names[k].detach(), params[k], k)
  return params, opt_state, module, optimizer, history


# ----------------------------------------------------------------- clipping


@pytest.mark.parametrize('clip', [dict(clip_norm=4.0), dict(clip_value=0.5),
                                  dict(clip_norm=4.0, clip_value=0.5)],
                         ids=['norm', 'value', 'both'])
def test_clipping_matches_optax(clip):
  jax_inner, port_inner = _inner('momentum')
  # Norms of about 2.4 to 9.7: some steps clip by norm, some do not.
  grads = _grads(6, scale=[0.5, 2.0, 0.6, 1.5, 0.7, 1.2])
  norms = [np.sqrt(sum(float((v * v).sum()) for v in g.values()))
           for g in grads]
  assert min(norms) < 4.0 < max(norms)
  _run(jax_optimizers.with_gradient_clipping(jax_inner, **clip),
       optimizers.with_gradient_clipping(port_inner, **clip), grads)


# ------------------------------------------------------------- accumulation


@pytest.mark.parametrize('kind', ['momentum', 'adam'])
@pytest.mark.parametrize('k', [2, 3])
def test_accumulation_matches_multisteps(kind, k):
  jax_inner, port_inner = _inner(kind)
  jax_opt = jax_optimizers.with_gradient_accumulation(jax_inner, k)
  _, opt_state, module, optimizer, history = _run(
      jax_opt, optimizers.with_gradient_accumulation(port_inner, k),
      _grads(7))
  for call, (before, after) in enumerate(history):
    moved = (call + 1) % k == 0
    for name in before:
      assert torch.equal(before[name], after[name]) != moved, (call, name)
  group = optimizer.param_groups[0]
  assert group['mini_step'] == int(opt_state.mini_step) == 7 % k
  assert group['gradient_step'] == int(opt_state.gradient_step) == 7 // k
  for name, p in module.named_parameters():
    _assert_close(optimizer.state[p]['acc_grads'], opt_state.acc_grads[name],
                  f'acc {name}')
  parts = convert._optax_parts(opt_state.inner_opt_state)  # pylint: disable=protected-access
  slots = ({'momentum_buffer': parts['momentum']} if kind == 'momentum' else
           {'mu': parts['adam'][1], 'nu': parts['adam'][2]})
  for slot, tree in slots.items():
    for name, p in module.named_parameters():
      _assert_close(optimizer.state[p][slot], tree[name], f'{slot} {name}')


def test_accumulation_holds_the_params_until_the_window_ends():
  """The JAX package's ``test_optimizer_multistep_accumulation``: plain SGD
  at 0.1, two calls a window; the first call leaves the parameters, the
  second applies the mean."""
  module = _Params({'w': np.ones(2, np.float32)})
  optimizer = optimizers.with_gradient_accumulation(
      optimizers.create_gradient_descent_optimizer(0.1), 2)(
          module.parameters())
  for expected in (np.ones(2), np.ones(2) - 0.1):
    module.w.grad = torch.ones(2)
    optimizer.step()
    np.testing.assert_allclose(module.w.detach().numpy(), expected,
                               rtol=1e-6)
  inner = optimizers.create_adam_optimizer()
  assert optimizers.with_gradient_accumulation(inner, 1) is inner


def test_optax_state_resumes_mid_window():
  jax_inner, port_inner = _inner('momentum')
  clip = dict(clip_norm=4.0, clip_value=0.5)
  jax_opt = jax_optimizers.with_gradient_accumulation(
      jax_optimizers.with_gradient_clipping(jax_inner, **clip), 3)
  port_factory = optimizers.with_gradient_accumulation(
      optimizers.with_gradient_clipping(port_inner, **clip), 3)
  grads = _grads(8, scale=[0.5, 2.0, 0.6, 1.5, 0.7, 1.2, 1.8, 0.4])
  params = {k: jnp.asarray(v) for k, v in _initial().items()}
  opt_state = jax_opt.init(params)
  for g in grads[:4]:  # one window and one call into the next
    updates, opt_state = jax_opt.update(
        {k: jnp.asarray(v) for k, v in g.items()}, opt_state, params)
    params = optax.apply_updates(params, updates)
  assert int(opt_state.mini_step) == 1
  module = _Params({k: np.asarray(v) for k, v in params.items()})
  optimizer = port_factory(module.parameters())
  optimizer.load_state_dict(convert.optax_state_to_torch(
      optimizer, module, variables_to_torch=_to_torch,
      **convert._optax_parts(jax.device_get(opt_state))))  # pylint: disable=protected-access
  assert optimizer.param_groups[0]['mini_step'] == 1
  assert optimizer.param_groups[0]['count'] == 1
  _run(jax_opt, None, grads[4:], params=params, opt_state=opt_state,
       module=module, optimizer=optimizer)


# ------------------------------------------------------------ the trainer


def _wrapped_momentum():
  return optimizers.with_gradient_accumulation(
      optimizers.with_gradient_clipping(
          optimizers.create_momentum_optimizer(_schedule(), 0.9),
          clip_norm=1.0, clip_value=0.5), 3)


def _trainer(k, create_optimizer_fn=_wrapped_momentum, **cfg):
  model = GraspingModelWrapper(device_type='cpu', input_shape=(88, 88, 3),
                               target_shape=(80, 80), num_convs=(2, 2, 1),
                               create_optimizer_fn=create_optimizer_fn)
  cfg.setdefault('max_train_steps', 8)
  return Trainer(model, TrainerConfig(log_interval_steps=0,
                                      eval_interval_steps=0,
                                      steps_per_dispatch=k, **cfg),
                 device='cpu')


@pytest.mark.parametrize('guard', [False, True], ids=['plain', 'nan_batch'])
def test_k_steps_with_accumulation_are_bitwise_single_steps(guard):
  batches = qtopt_batches(8 + guard, seed=5)
  cfg = {}
  if guard:
    batches[5] = nanify(batches[5])
    cfg['nonfinite_mode'] = 'skip_update'
  # K=1 counts applied updates, K>1 dispatched steps: both take every
  # batch and apply 8 updates.
  single = _trainer(1, **cfg)
  grouped = _trainer(4, max_train_steps=len(batches), **cfg)
  single.train(iter(batches))
  grouped.train(iter(batches))
  assert_state_bitwise(single, grouped)
  group = grouped.state.optimizer.param_groups[0]
  assert (group['mini_step'], group['gradient_step'], group['count']) == (
      8 % 3, 8 // 3, 8 // 3)
  if guard:
    assert grouped.nonfinite_policy.bad_steps == 1


def test_checkpoint_round_trip_resumes_mid_window():
  batches = qtopt_batches(7, seed=6)
  straight = _trainer(1, max_train_steps=7)
  straight.train(iter(batches))
  first = _trainer(1, max_train_steps=4)
  first.train(iter(batches[:4]))
  payload = state_dict(first.state)
  assert payload['optimizer']['param_groups'][0]['mini_step'] == 1
  resumed = _trainer(1, max_train_steps=7)
  resumed.initialize(batches[0][0])
  load_state_dict(resumed.state, payload)
  resumed.train(iter(batches[4:]))
  assert_state_bitwise(straight, resumed)


def test_fused_update_over_a_wrapped_adam_takes_the_stock_path(caplog):
  adam = optimizers.create_adam_optimizer(1e-3)
  assert getattr(adam, 'fused_spec', None) is not None
  wrapped = optimizers.with_gradient_clipping(adam, clip_norm=1.0)
  assert getattr(wrapped, 'fused_spec', None) is None
  with caplog.at_level(logging.INFO):
    trainer = _trainer(1, create_optimizer_fn=lambda: wrapped,
                       fused_update=True, max_train_steps=2)
    trainer.train(iter(qtopt_batches(2, seed=7)))
  assert trainer.fused_plan is None
  assert trainer.step == 2
  assert sum('stock update path' in r.getMessage()
             for r in caplog.records) == 1
