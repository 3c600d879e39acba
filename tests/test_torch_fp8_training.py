"""Port parity: fp8 training (``quantize/fp8_training.py``) against the JAX
package's ``tensor2robot_tpu/quantize/fp8_training.py``, on the CPU.

Module level, from the same seeded numpy inputs:

* the qdq, bit for bit: float8_e4m3fn and float8_e5m2, float32 and
  bfloat16 sources, edge values (0, -0, subnormals, the bound, past it),
  the scale of an empty history (1), the clamp, the straight-through
  gradient, the cotangent's qdq at its own amax;
* the Dense and Conv injections against ``Fp8DotGeneral`` /
  ``Fp8ConvGeneralDilated`` (float32; the contractions run in another
  order): outputs and both gradients within 1e-6 of their largest
  magnitude, the rolled histories bit for bit; the space-to-depth conv's
  operand hook against the JAX hook, its cotangent left un-quantized;
* the window against ``_DelayedAmax`` over 20 calls (past its 16 slots),
  bit for bit, frozen in eval mode.

Slice level, a narrow Grasping44 (80x80 frames, ``num_convs=(1, 1, 1)``,
float32, batch 4) trained 3 steps at fp8 against the JAX trainer from the
same weights, ``kernel_policy='none'`` at M=1 and ``'pool_conv'`` at
``grad_accum_microbatches=2`` (two rolls a step). Bands: the first
(micro)batch, quantized at scale 1 by the empty windows, matches closely:
its amaxes within 1e-5 relative and, at M=1, the whole first step (loss
5e-5, each parameter's change within 1e-3 of its largest magnitude plus
four float32 ulps, batch statistics and windows 1e-5 relative). After it,
the scales come from the windows and a single element that lands
on the other side of an e4m3 rounding boundary (bn1's statistics are
summed in another order, a 3e-5 difference that moves one of conv2's
50,176 inputs by one e4m3 step) moves every layer after it: the losses
are held to the JAX package's own fp8 acceptance band ``|a - b| <= 0.02 +
0.1 |a|`` (``tests/test_kernels.py``), the windows within 15% relative,
the batch statistics within 1e-3 of their largest magnitude, each
parameter within 1e-2 of its largest magnitude, and the 3 steps' change
of all parameters together pointing the way JAX's does (cosine above 0.5;
measured 0.74 and 0.79, each leaf's values within 3.7e-3, the statistics
within 1.1e-4). The frozen windows are held closely: the port network
loaded with JAX's state after each step and run in eval mode (no batch
statistics, so no amplification) gives JAX's eval logits within 3e-3 of
their largest magnitude (measured 1.1e-3 where one element crosses a
boundary, 2e-7 elsewhere).

Port-only: remat ('conv_towers' and 'full') bit for bit 'none' at fp8,
the windows rolled once a step; K=2 bit for bit K=1; a checkpoint round
trip; a skipped step's rolls undone; the converter of ``fp8_stats`` for both conv1 scopes; eval and
predict leave the windows alone; the exported program (traced on the
CPU) holds the fp8 casts and gives the eager predict's bits; float32
master weights and slots; fp8 against bf16 in the JAX band; the
validation and gating of ``tests/test_kernels.py``.

About 70 s alone on the CPU, imports included; 24 s of it the two JAX
trainer runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from test_torch_steps_per_dispatch import assert_state_bitwise, nanify
from torch_port_weights import random_variables

from tensor2robot_tpu.ops import conv_s2d as jax_conv_s2d
from tensor2robot_tpu.quantize import fp8_training as jax_fp8
from tensor2robot_tpu.research.qtopt import GraspingModelWrapper as JaxWrapper
from tensor2robot_tpu.research.qtopt import networks as jax_networks
from tensor2robot_tpu.train.trainer import Trainer as JaxTrainer
from tensor2robot_tpu.train.trainer import TrainerCallback as JaxCallback
from tensor2robot_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from tensor2robot_tpu_torch.export import exporters
from tensor2robot_tpu_torch.ops import conv_s2d
from tensor2robot_tpu_torch.predictors import (CheckpointPredictor,
                                               ExportedModelPredictor)
from tensor2robot_tpu_torch.quantize import fp8_training as fp8
from tensor2robot_tpu_torch.research.qtopt import (GraspingModelWrapper,
                                                   networks)
from tensor2robot_tpu_torch.train import Trainer, TrainerCallback, TrainerConfig
from tensor2robot_tpu_torch.train.train_state import (load_state_dict,
                                                      state_dict)
from tensor2robot_tpu_torch.utils import convert

IMAGE = (80, 80, 3)
NUM_CONVS = (1, 1, 1)
BATCH = 4
STEPS = 3
FORMATS = ((fp8.E4M3, jnp.float8_e4m3fn), (fp8.E5M2, jnp.float8_e5m2))


def _bits(a):
  a = np.asarray(a)
  return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _same_bits(got, want):
  got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else (
      np.asarray(got, np.float32))
  np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want,
                                                             np.float32)))


def _band(got, want, band, what, resolution=0.0):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  scale = max(float(np.abs(want).max()), 1e-30)
  err = float(np.abs(got - want).max())
  assert err <= band * scale + resolution, (what, err, scale)


def _values(seed=0, n=4000):
  rng = np.random.RandomState(seed)
  x = (rng.lognormal(0, 3, n) * rng.choice([-1, 1], n)).astype(np.float32)
  edges = np.array([0.0, -0.0, 448.0, -448.0, 600.0, -600.0, 57344.0, 7e4,
                    2.0**-9, 2.0**-10, 2.0**-16, 2.0**-17, 1e-30],
                   np.float32)
  return np.concatenate([x, edges])


# ---------------------------------------------------------------- the qdq


@pytest.mark.parametrize('source', ['float32', 'bfloat16'])
@pytest.mark.parametrize('fmt', [0, 1], ids=['e4m3fn', 'e5m2'])
def test_qdq_is_bitwise_jax(fmt, source):
  torch_dtype, jax_dtype = FORMATS[fmt]
  x = _values()
  tx, jx = torch.from_numpy(x), jnp.asarray(x)
  if source == 'bfloat16':
    tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
  for amax in (0.0, 1.0, 448.0, 3.7e3, 2.5e-3):
    scale = fp8.amax_scale(torch.tensor(amax), torch_dtype)
    jscale = jax_fp8.amax_scale(jnp.float32(amax), jax_dtype)
    _same_bits(scale, jscale)
    got = fp8.quantize_dequantize(tx, scale, torch_dtype)
    want = jax_fp8.quantize_dequantize(jx, jscale, jax_dtype)
    assert got.dtype == tx.dtype
    _same_bits(got, np.asarray(want.astype(jnp.float32)))
  _same_bits(fp8.qdq_current(tx, torch_dtype),
             np.asarray(jax_fp8.qdq_current(jx, jax_dtype).astype(
                 jnp.float32)))


def test_amax_scale_of_many_windows_is_bitwise_jax():
  amaxes = np.abs(np.random.RandomState(1).lognormal(0, 4, 20000)).astype(
      np.float32)
  amaxes[:3] = 0.0
  for torch_dtype, jax_dtype in FORMATS:
    got = fp8.amax_scale(torch.from_numpy(amaxes), torch_dtype)
    assert torch.equal(got[:3], torch.ones(3))
    _same_bits(got, jax_fp8.amax_scale(jnp.asarray(amaxes), jax_dtype))


def test_qdq_clamps_and_passes_the_gradient_straight_through():
  x = torch.linspace(-600, 600, 41, requires_grad=True)
  scale = fp8.amax_scale(torch.tensor(448.0), fp8.E4M3)
  y = fp8.quantize_dequantize(x, scale, fp8.E4M3)
  assert bool(torch.isfinite(y).all())       # saturates, never NaN
  assert float(y.detach().abs().max()) <= 448.0 + 1e-3
  y.sum().backward()
  assert torch.equal(x.grad, torch.ones_like(x))


# -------------------------------------------------------- the injections


def _history(seed, length=16):
  return (np.random.RandomState(seed).rand(length) * 3).astype(np.float32)


def _jax_fp8_stats(lhs, rhs):
  return {'lhs': {'amax_history': lhs}, 'rhs': {'amax_history': rhs}}


def _load_windows(module, lhs, rhs):
  with torch.no_grad():
    module.lhs.amax_history.copy_(torch.from_numpy(lhs))
    module.rhs.amax_history.copy_(torch.from_numpy(rhs))


def test_dense_injection_matches_fp8_dot_general():
  rng = np.random.RandomState(2)
  x = rng.randn(6, 32).astype(np.float32)
  w = (rng.randn(32, 16) * 0.1).astype(np.float32)
  g = rng.randn(6, 16).astype(np.float32)
  lhs, rhs = _history(3), _history(4) * 0.1
  dense = fnn.Dense(16, use_bias=False,
                    dot_general_cls=jax_fp8.Fp8DotGeneral)
  variables = {'params': {'kernel': w},
               'fp8_stats': {'Fp8DotGeneral_0': _jax_fp8_stats(lhs, rhs)}}

  def forward(x, w):
    return dense.apply({**variables, 'params': {'kernel': w}}, x,
                       mutable=['fp8_stats'])

  _, mutated = forward(jnp.asarray(x), jnp.asarray(w))
  y, vjp_fn = jax.vjp(lambda a, b: forward(a, b)[0], jnp.asarray(x),
                      jnp.asarray(w))
  dx, dw = vjp_fn(jnp.asarray(g))

  injection = fp8.injection('fp8').train()
  _load_windows(injection, lhs, rhs)
  tx = torch.from_numpy(x).requires_grad_(True)
  tw = torch.from_numpy(w.T.copy()).requires_grad_(True)
  qx, qw = injection(tx, tw)
  ty = injection.output(torch.nn.functional.linear(qx, qw))
  ty.backward(torch.from_numpy(g))
  _band(ty.detach(), y, 1e-6, 'y')
  _band(tx.grad, dx, 1e-6, 'dx')
  _band(tw.grad.T, dw, 1e-6, 'dw')
  window = mutated['fp8_stats']['Fp8DotGeneral_0']
  _same_bits(injection.lhs.amax_history, window['lhs']['amax_history'])
  _same_bits(injection.rhs.amax_history, window['rhs']['amax_history'])


@pytest.mark.parametrize('hook', [False, True], ids=['injection', 'hook'])
def test_conv_injection_and_operand_hook_match_jax(hook):
  """``kernel_policy='none'``'s conv1 (nn.Conv + Fp8ConvGeneralDilated:
  operands and cotangent quantized) and ``'pool_conv'``'s (the
  space-to-depth conv's operand hook: the cotangent left alone), both on
  the port's ``SpaceToDepthConv``; NHWC x HWIO, 6x6/s2 SAME."""
  rng = np.random.RandomState(5)
  x = rng.rand(2, 16, 16, 3).astype(np.float32)
  w = (rng.randn(6, 6, 3, 8) * 0.05).astype(np.float32)
  g = rng.randn(2, 8, 8, 8).astype(np.float32)
  lhs, rhs = _history(6), _history(7) * 0.05
  if hook:
    conv = jax_conv_s2d.SpaceToDepthConv(
        8, (6, 6), strides=(2, 2), use_bias=False,
        quantize_cls=jax_fp8.conv_quantize_cls('fp8'))
    scope = '_ConvOperandQdq_0'
  else:
    conv = fnn.Conv(8, (6, 6), strides=(2, 2), use_bias=False,
                    conv_general_dilated_cls=jax_fp8.Fp8ConvGeneralDilated)
    scope = 'Fp8ConvGeneralDilated_0'
  variables = {'params': {'kernel': w},
               'fp8_stats': {scope: _jax_fp8_stats(lhs, rhs)}}

  def forward(a, b):
    return conv.apply({**variables, 'params': {'kernel': b}}, a,
                      mutable=['fp8_stats'])

  _, mutated = forward(jnp.asarray(x), jnp.asarray(w))
  y, vjp_fn = jax.vjp(lambda a, b: forward(a, b)[0], jnp.asarray(x),
                      jnp.asarray(w))
  dx, dw = vjp_fn(jnp.asarray(g))

  module = conv_s2d.SpaceToDepthConv(
      3, 8, (6, 6), strides=(2, 2), use_bias=False, use_kernel=hook,
      fp8=(fp8.conv_operand_hook if hook else fp8.injection)('fp8'))
  module.train()
  _load_windows(module.fp8, lhs, rhs)
  with torch.no_grad():
    module.kernel.copy_(torch.from_numpy(w))
  tx = torch.from_numpy(x).requires_grad_(True)
  ty = module(tx)
  ty.backward(torch.from_numpy(g))
  _band(ty.detach(), y, 1e-6, 'y')
  _band(tx.grad, dx, 1e-6, 'dx')
  _band(module.kernel.grad, dw, 1e-6, 'dw')
  window = mutated['fp8_stats'][scope]
  _same_bits(module.fp8.lhs.amax_history, window['lhs']['amax_history'])
  _same_bits(module.fp8.rhs.amax_history, window['rhs']['amax_history'])
  if hook:
    # The kernel path's dW reads the raw cotangent.
    scale = fp8.amax_scale(torch.from_numpy(lhs).max(), fp8.E4M3)
    qx = fp8.quantize_dequantize(torch.from_numpy(x), scale, fp8.E4M3)
    pads = conv_s2d.resolve_padding('SAME', (6, 6), (2, 2), (16, 16))
    assert torch.equal(module.kernel.grad, conv_s2d.plain_conv2d_dw(
        qx, torch.from_numpy(g), (6, 6, 3, 8), (2, 2), pads))


def test_window_rolls_as_delayed_amax():
  rng = np.random.RandomState(8)
  xs = [(rng.randn(5, 7) * rng.lognormal(0, 1)).astype(np.float32)
        for _ in range(20)]
  module = jax_fp8._DelayedAmax()  # pylint: disable=protected-access
  stats = {'amax_history': jnp.zeros((16,), jnp.float32)}
  window = fp8.DelayedAmax().train()
  for x in xs:
    want, mutated = module.apply({'fp8_stats': stats}, jnp.asarray(x),
                                 mutable=['fp8_stats'])
    stats = mutated['fp8_stats']
    got = window(torch.from_numpy(x))
    _same_bits(got, want)
    _same_bits(window.amax_history, stats['amax_history'])
  frozen = window.amax_history.clone()
  window.eval()
  want = module.apply({'fp8_stats': stats}, jnp.asarray(xs[0]))
  _same_bits(window(torch.from_numpy(xs[0])), want)
  assert torch.equal(window.amax_history, frozen)


# --------------------------------------------------- the slice: training


def _batches(seed=0, count=STEPS, frame=IMAGE):
  rng = np.random.RandomState(seed)
  return [({'state/image': rng.randint(0, 256, (BATCH,) + frame).astype(
      np.uint8),
            'action/world_vector': rng.randn(BATCH, 3).astype(np.float32),
            'action/vertical_rotation': rng.randn(BATCH, 2).astype(
                np.float32)},
           {'reward': rng.randint(0, 2, (BATCH, 1)).astype(np.float32)})
          for _ in range(count)]


def _variables(policy):
  net = jax_networks.Grasping44(num_convs=NUM_CONVS, matmul_precision='fp8',
                                kernel_policy=policy)
  shapes = jax.eval_shape(lambda: net.init(
      jax.random.PRNGKey(0), jnp.zeros((1,) + IMAGE), jnp.zeros((1, 5))))
  variables = dict(random_variables(
      {'params': shapes['params'], 'batch_stats': shapes['batch_stats']},
      seed=1))
  variables['fp8_stats'] = jax.tree_util.tree_map(
      lambda s: np.zeros(s.shape, np.float32), shapes['fp8_stats'])
  return variables


class _JaxSnapshots(JaxCallback):

  def __init__(self):
    self.by_step = {}

  def after_step(self, trainer, step, scalars):
    self.by_step[step] = (float(scalars['loss']),
                          jax.device_get(dict(trainer.state.variables)))


class _Losses(TrainerCallback):
  """Each step's loss, and the network's state after the first."""

  def __init__(self):
    self.by_step = {}
    self.first_state = None

  def after_step(self, trainer, step, scalars):
    self.by_step[step] = float(scalars['loss'])
    if self.first_state is None:
      self.first_state = {k: v.clone() for k, v in
                          trainer.state.network.state_dict().items()}


def _port_model(variables=None, **kwargs):
  kwargs.setdefault('matmul_precision', 'fp8')
  if variables is not None:
    kwargs['init_from_checkpoint_fn'] = lambda network: (
        network.load_state_dict(convert.jax_variables_to_torch(variables)))
  return GraspingModelWrapper(device_type='cpu', input_shape=IMAGE,
                              target_shape=IMAGE[:2], num_convs=NUM_CONVS,
                              **kwargs)


def _port_trainer(model, steps=STEPS, callbacks=(), **cfg):
  return Trainer(model, TrainerConfig(max_train_steps=steps,
                                      log_interval_steps=1, **cfg),
                 device='cpu', callbacks=list(callbacks))


@pytest.fixture(scope='module', params=[('none', 1), ('pool_conv', 2)],
                ids=['none', 'pool_conv_m2'])
def jax_run(request):
  policy, m = request.param
  variables = _variables(policy)
  # The JAX trainer gets copies: XLA on the CPU may alias numpy buffers and
  # write a donated state into them.
  copied = jax.tree_util.tree_map(np.copy, variables)
  model = JaxWrapper(
      device_type='cpu', input_shape=IMAGE, target_shape=IMAGE[:2],
      num_convs=NUM_CONVS, kernel_policy=policy, matmul_precision='fp8',
      init_from_checkpoint_fn=lambda params, state: (
          copied['params'], {k: copied[k] for k in copied if k != 'params'}))
  snapshots = _JaxSnapshots()
  trainer = JaxTrainer(model, JaxTrainerConfig(
      model_dir='', max_train_steps=STEPS, eval_interval_steps=0,
      log_interval_steps=1, grad_accum_microbatches=m),
                       callbacks=[snapshots])
  trainer.train(iter(_batches()), None)
  return policy, m, variables, snapshots.by_step


def test_narrow_grasping44_trains_against_the_jax_trainer(jax_run):
  policy, m, variables, jax_steps = jax_run
  losses = _Losses()
  trainer = _port_trainer(_port_model(variables, kernel_policy=policy),
                          callbacks=[losses], grad_accum_microbatches=m)
  trainer.train(iter(_batches()))
  start = convert.jax_variables_to_torch(variables)
  params = {n for n, _ in trainer.state.network.named_parameters()}

  # The first (micro)batch quantizes at scale 1, by the empty windows: its
  # amaxes, the first roll, match closely; at M=1 so does the whole step.
  want = convert.jax_variables_to_torch(jax_steps[1][1])
  got = losses.first_state
  windows = [n for n in want if n.endswith('amax_history')]
  assert len(windows) == 2 * (1 + sum(NUM_CONVS) + 2 + 3)
  for name in windows:
    _band(got[name][-m], want[name][-m], 1e-5, name)
    assert float(got[name][-1 - m]) == 0, name
  if m == 1:
    np.testing.assert_allclose(losses.by_step[1], jax_steps[1][0], rtol=0,
                               atol=5e-5)
    for name in want:
      if name in params:
        ulps = 4 * np.finfo(np.float32).eps * float(want[name].abs().max())
        _band(got[name] - start[name], want[name] - start[name], 1e-3,
              name, ulps)
      else:
        _band(got[name], want[name], 1e-5, name)

  # Steps 2 and 3: the fp8 band.
  for step in range(1, STEPS + 1):
    a, b = jax_steps[step][0], losses.by_step[step]
    assert abs(a - b) <= 0.02 + 0.1 * abs(a), (step, a, b)
  want = convert.jax_variables_to_torch(jax_steps[STEPS][1])
  got = trainer.state.network.state_dict()
  for name in windows:
    rows = want[name][-STEPS * m:]
    _band(got[name][-STEPS * m:], rows, 0.15, name)
    assert bool((got[name][:-STEPS * m] == 0).all()), name
  for name in want:
    if name in params:
      _band(got[name], want[name], 1e-2, name)
    elif name not in windows:
      _band(got[name], want[name], 1e-3, name)
  moved = torch.cat([(got[n] - start[n]).double().ravel() for n in params])
  want_moved = torch.cat([(want[n] - start[n]).double().ravel()
                          for n in params])
  cosine = float(moved @ want_moved / (moved.norm() * want_moved.norm()))
  assert cosine > 0.5, cosine

  # The frozen windows at the scales they hold after each step.
  frame = _batches(seed=11, count=1)[0][0]
  image = frame['state/image'].astype(np.float32) / 255.0
  grasp = np.concatenate([frame['action/world_vector'],
                          frame['action/vertical_rotation']], -1)
  jax_net = jax_networks.Grasping44(num_convs=NUM_CONVS,
                                    matmul_precision='fp8',
                                    kernel_policy=policy)
  network = networks.Grasping44(image_size=IMAGE[:2], num_convs=NUM_CONVS,
                                kernel_policy=policy,
                                matmul_precision='fp8').eval()
  for step in range(1, STEPS + 1):
    want_logits, _ = jax_net.apply(jax_steps[step][1], jnp.asarray(image),
                                   jnp.asarray(grasp), train=False)
    network.load_state_dict(
        convert.jax_variables_to_torch(jax_steps[step][1]))
    with torch.no_grad():
      logits, _ = network(torch.from_numpy(image), torch.from_numpy(grasp))
    _band(logits, want_logits, 3e-3, ('eval logits', step))


@pytest.mark.parametrize('policy', ['conv_towers', 'full'])
def test_remat_is_bitwise_none_at_fp8(policy):
  batches = _batches(seed=3, count=2)
  plain = _port_trainer(_port_model(kernel_policy='pool_conv'), steps=2)
  recomputed = _port_trainer(_port_model(kernel_policy='pool_conv',
                                         remat_policy=policy), steps=2)
  plain.train(iter(batches))
  recomputed.train(iter(batches))
  for (name, a), b in zip(plain.state.network.state_dict().items(),
                          recomputed.state.network.state_dict().values()):
    assert torch.equal(a, b), name
  window = recomputed.state.network.conv2.conv.fp8.lhs.amax_history
  assert int((window > 0).sum()) == 2  # rolled once a step


@pytest.mark.parametrize('guard', [False, True], ids=['plain', 'nan_batch'])
def test_two_steps_a_dispatch_are_bitwise_single_steps(guard):
  """K=2 against K=1, and with a NaN batch under ``skip_update``: the
  skipped step's rolls (a NaN amax in ``fcgrasp``'s window) are undone
  with the other buffers, so the run equals one without that batch."""
  batches = _batches(seed=4, count=5, frame=(88, 88, 3))
  cfg = {}
  if guard:
    batches.insert(2, nanify(batches[2]))
    cfg['nonfinite_mode'] = 'skip_update'

  def run(k, feed, steps):
    model = GraspingModelWrapper(
        device_type='cpu', input_shape=(88, 88, 3), target_shape=IMAGE[:2],
        num_convs=NUM_CONVS, kernel_policy='pool_conv',
        matmul_precision='fp8')
    trainer = _port_trainer(model, steps=steps, steps_per_dispatch=k, **cfg)
    trainer.train(iter(feed))
    return trainer

  # K=1 counts applied updates, K>1 the steps it takes.
  single, grouped = run(1, batches, 5), run(2, batches, len(batches))
  assert_state_bitwise(single, grouped)
  if guard:
    assert grouped.nonfinite_policy.bad_steps == 1
    clean = run(1, batches[:2] + batches[3:], 5)
    assert_state_bitwise(single, clean)
    window = single.state.network.fcgrasp.fp8.lhs.amax_history
    assert bool(torch.isfinite(window).all()) and int((window > 0).sum()) == 5


def test_checkpoint_round_trip_and_the_fp8_stats_converter():
  batches = _batches(seed=5, count=4)
  straight = _port_trainer(_port_model(kernel_policy='pool_conv'), steps=4)
  straight.train(iter(batches))
  first = _port_trainer(_port_model(kernel_policy='pool_conv'), steps=2)
  first.train(iter(batches[:2]))
  payload = state_dict(first.state)
  windows = [k for k in payload['network'] if k.endswith('amax_history')]
  assert windows and all(payload['network'][k].dtype == torch.float32
                         for k in windows)
  resumed = _port_trainer(_port_model(kernel_policy='pool_conv'), steps=4)
  resumed.initialize(batches[0][0])
  load_state_dict(resumed.state, payload)
  resumed.train(iter(batches[2:]))
  for (name, a), b in zip(straight.state.network.state_dict().items(),
                          resumed.state.network.state_dict().values()):
    assert torch.equal(a, b), name
  # Both conv1 scopes of the JAX tree land on the port's buffers.
  for policy in ('none', 'pool_conv'):
    variables = _variables(policy)
    variables['fp8_stats'] = jax.tree_util.tree_map(
        lambda a: np.arange(a.size, dtype=np.float32) + 1.0,
        variables['fp8_stats'])
    network = networks.Grasping44(image_size=IMAGE[:2], num_convs=NUM_CONVS,
                                  kernel_policy=policy,
                                  matmul_precision='fp8')
    network.load_state_dict(convert.jax_variables_to_torch(variables),
                            strict=True)
    assert float(network.conv1_1.fp8.rhs.amax_history[-1]) == 16.0


def test_eval_and_predict_leave_the_windows_alone():
  batches = _batches(seed=6, count=3)
  trainer = _port_trainer(_port_model(kernel_policy='pool_conv'), steps=2)
  trainer.train(iter(batches[:2]))
  before = {k: v.clone() for k, v in trainer.state.network.state_dict().items()
            if k.endswith('amax_history')}
  trainer.config.eval_steps = 1
  metrics = trainer.evaluate(iter(batches[2:]))
  assert np.isfinite(metrics['loss'])
  trainer.predict(batches[2][0])
  for name, value in trainer.state.network.state_dict().items():
    if name in before:
      assert torch.equal(value, before[name]), name


def test_exported_program_holds_the_qdq_and_matches_eager(tmp_path):
  trainer = _port_trainer(_port_model(kernel_policy='pool_conv'), steps=2)
  trainer.train(iter(_batches(seed=7, count=2)))
  model = trainer.model
  predictor = CheckpointPredictor(model, device='cpu')
  predictor.load_state_dict(trainer.state.eval_state_dict(), global_step=2)
  path = exporters.ModelExporter().export(
      model, exporters.ServingState(2, trainer.state.eval_state_dict()),
      str(tmp_path))
  program = torch.export.load(f'{path}/serving_fn.pt2')
  casts = [n for n in program.graph.nodes
           if n.op == 'call_function' and 'float8_e4m3fn' in str(n.kwargs)]
  assert len(casts) >= 2 * (1 + sum(NUM_CONVS) + 2 + 3)
  exported = ExportedModelPredictor(str(tmp_path), device='cpu')
  assert exported.restore()
  features = _batches(seed=8, count=1)[0][0]
  features = {'state/image': features['state/image'][:, :80, :80],
              **{k: v for k, v in features.items() if k != 'state/image'}}
  want = predictor.predict(features)
  got = exported.predict(features)
  np.testing.assert_array_equal(got['q_predicted'], want['q_predicted'])


def test_master_weights_stay_float32_and_fp8_tracks_bf16():
  """The JAX package's ``test_fp8_training_parity_band_and_master_weights``
  on the port: 4 steps at fp8 and at bf16 (float32 compute on the CPU)
  from the same weights, every loss in the band, parameters and slots
  float32, the windows advanced, and no window in the bf16 network."""
  batches = _batches(seed=9, count=4)
  runs = {}
  for precision in ('bf16', 'fp8'):
    losses = _Losses()
    trainer = _port_trainer(_port_model(kernel_policy='pool_conv',
                                        matmul_precision=precision),
                            steps=4, callbacks=[losses])
    trainer.train(iter(batches))
    runs[precision] = (trainer, losses.by_step)
  for step in range(1, 5):
    a, b = runs['bf16'][1][step], runs['fp8'][1][step]
    assert np.isfinite(b) and abs(a - b) <= 0.02 + 0.1 * abs(a), step
  trainer = runs['fp8'][0]
  for p in trainer.state.network.parameters():
    assert p.dtype == torch.float32
  for slots in trainer.state.optimizer.state.values():
    for value in slots.values():
      assert value.dtype == torch.float32
  windows = [b for n, b in trainer.state.network.named_buffers()
             if n.endswith('amax_history')]
  assert windows and all(float(w[-1]) > 0 for w in windows)
  assert not any(n.endswith('amax_history')
                 for n, _ in runs['bf16'][0].state.network.named_buffers())


def test_matmul_precision_validation_and_gating():
  with pytest.raises(ValueError, match='matmul_precision'):
    fp8.validate_matmul_precision('int8')
  assert fp8.validate_matmul_precision(None) == 'bf16'
  model = _port_model(matmul_precision='bf16')
  assert model.matmul_precision == 'bf16'
  Trainer(model, TrainerConfig(max_train_steps=1, matmul_precision='fp8'),
          device='cpu')
  assert model.matmul_precision == 'fp8'
  assert model.create_module().conv2.conv.fp8 is not None
  kept = _port_model(matmul_precision='fp8')
  Trainer(kept, TrainerConfig(max_train_steps=1), device='cpu')
  assert kept.matmul_precision == 'fp8'
  with pytest.raises(ValueError, match='matmul_precision'):
    Trainer(_port_model(), TrainerConfig(max_train_steps=1,
                                         matmul_precision='int4'),
            device='cpu')
  with pytest.raises(ValueError, match='matmul_precision'):
    _port_model(matmul_precision='fp16')
