"""Port parity: K optimizer steps per dispatch (``steps_per_dispatch``).

The port's counterparts of the JAX package's ``tests/test_trainer.py``
K-step tests and ``tests/test_device_feed.py``'s feed drills, on the CPU,
where a dispatch is the K device-form steps run eagerly (on the card the
same steps are one captured CUDA graph replay, held bit for bit to K=1 by
``chip_smoke.py``'s ``phase_dispatch``):

* K=3 against K=1 in the port, bit for bit, over 7 = 3+3+1 batches
  (QT-Opt's tiny critic: 88x88 frames cropped to 80x80, so every step
  draws crop offsets; the stock momentum arm, stock Adam and the fused
  Adam + EMA arm): parameters, batch statistics, optimizer slots and
  groups, EMA, generator state and step;
* the port's K=3 against the JAX trainer's K=3 on the mock model from the
  same seeded weights, in the bands ``tests/test_torch_train_eval.py``
  holds the port's trainer to the JAX one (each parameter's change within
  1e-3 of that change's largest magnitude plus four float32 ulps, batch
  statistics 1e-5, the loss 5e-5 absolute), under plain SGD: the mock's
  first bias feeds a train-mode batch norm, so its true gradient is 0, and
  Adam would turn either framework's rounding noise there into steps of
  about +-lr (and the running mean with them);
* saves at [3, 6, 7] and ``MetricsLoggerCallback`` rows at [3, 6, 9], as
  the JAX trainer; a ragged tail ends at step 2;
* prefetch and the device feed bit for bit the plain K-step run, and one
  ``trainer/h2d/device_puts`` a dispatch;
* a NaN batch inside a group skips exactly its own update (its draws go
  to the next step), with the JAX trainer's applied-step count, bit for
  bit a run that never drew it and the K=1 guarded run;
* SIGTERM mid-dispatch checkpoints at the next boundary and a fresh
  trainer resumes bit for bit an uninterrupted run;
* the crop at device offsets equals the host-offset crop bit for bit; the
  rates a dispatch selects on the device equal ``exponential_decay`` (and
  optax's) at each applied count; the plain fused update fed its rates as
  a device buffer equals its host-scalar form bit for bit;
* the commit markers carry K and M, and a run with others refuses them;
* the dispatch breakdown's counters, log-window keys and 'dispatch'
  flight events, and the non-finite skips' registry counter and flight
  event, as the JAX trainer's.

About 25 s alone on the CPU.
"""

import json
import os
import signal

import jax
import numpy as np
import optax
import pytest
import torch
from torch_port_weights import random_variables

from tensor2robot_tpu.models import optimizers as jax_optimizers
from tensor2robot_tpu.observability import flight as jax_flight
from tensor2robot_tpu.observability import metrics as jax_metrics
from tensor2robot_tpu.specs import SpecStruct as JaxSpecStruct
from tensor2robot_tpu.train.trainer import Trainer as JaxTrainer
from tensor2robot_tpu.train.trainer import TrainerCallback as JaxCallback
from tensor2robot_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from tensor2robot_tpu.utils.mocks import MockT2RModel as JaxMockModel
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.observability import flight
from tensor2robot_tpu_torch.observability import metrics as metrics_lib
from tensor2robot_tpu_torch.ops import fused_update
from tensor2robot_tpu_torch.preprocessors import image_transformations
from tensor2robot_tpu_torch.research.qtopt import GraspingModelWrapper
from tensor2robot_tpu_torch.train import checkpoints as ckpt
from tensor2robot_tpu_torch.train import (GracefulShutdown, PreemptedError,
                                          Trainer, TrainerCallback,
                                          TrainerConfig,
                                          latest_checkpoint_step)
from tensor2robot_tpu_torch.train.callbacks import MetricsLoggerCallback
from tensor2robot_tpu_torch.utils.mocks import MockT2RModel

FRAME = (88, 88, 3)
CROP = (80, 80)
ARMS = ('momentum', 'adam', 'fused')


def qtopt_batches(count, seed=0, batch=4):
  rng = np.random.RandomState(seed)
  return [({'state/image': rng.randint(0, 256, (batch,) + FRAME).astype(
      np.uint8),
            'action/world_vector': rng.randn(batch, 3).astype(np.float32),
            'action/vertical_rotation': rng.randn(batch, 2).astype(
                np.float32)},
           {'reward': rng.randint(0, 2, (batch, 1)).astype(np.float32)})
          for _ in range(count)]


def nanify(batch):
  features, labels = batch
  features = dict(features)
  poisoned = features['action/world_vector'].copy()
  poisoned[1, 0] = np.nan
  features['action/world_vector'] = poisoned
  return features, labels


def qtopt_trainer(arm='momentum', callbacks=(), shutdown=None, **cfg):
  kwargs = {}
  if arm != 'momentum':
    kwargs['create_optimizer_fn'] = lambda: optimizers.create_adam_optimizer(
        optimizers.create_exp_decaying_learning_rate_fn(
            1e-3, decay_steps=2, decay_rate=0.5))
  model = GraspingModelWrapper(device_type='cpu', input_shape=FRAME,
                               target_shape=CROP, num_convs=(2, 2, 1),
                               **kwargs)
  cfg.setdefault('log_interval_steps', 0)
  cfg.setdefault('eval_interval_steps', 0)
  trainer = Trainer(model, TrainerConfig(fused_update=arm == 'fused', **cfg),
                    device='cpu', callbacks=list(callbacks),
                    shutdown=shutdown)
  assert (trainer.config.fused_update and arm == 'fused') or arm != 'fused'
  return trainer


def run_qtopt(batches, k, arm='momentum', max_steps=None, **cfg):
  trainer = qtopt_trainer(
      arm, max_train_steps=len(batches) if max_steps is None else max_steps,
      steps_per_dispatch=k, **cfg)
  trainer.train(iter(batches))
  assert (trainer.fused_plan is not None) == (arm == 'fused')
  return trainer


def assert_state_bitwise(a, b):
  assert a.step == b.step
  for (name, x), y in zip(a.state.network.state_dict().items(),
                          b.state.network.state_dict().values()):
    assert torch.equal(x, y), name
  for name in a.state.ema or {}:
    assert torch.equal(a.state.ema[name], b.state.ema[name]), f'ema {name}'
  sa, sb = a.state.optimizer.state_dict(), b.state.optimizer.state_dict()
  assert sa['param_groups'] == sb['param_groups']
  assert set(sa['state']) == set(sb['state'])
  for index, slots in sa['state'].items():
    for slot, value in slots.items():
      assert torch.equal(value, sb['state'][index][slot]), (index, slot)
  assert torch.equal(a.state.generator.get_state(),
                     b.state.generator.get_state())


# ------------------------------------------------- K against K=1, bitwise


@pytest.mark.parametrize('arm', ARMS)
def test_k_steps_per_dispatch_are_bitwise_k_single_steps(arm):
  batches = qtopt_batches(7)
  single = run_qtopt(batches, 1, arm)
  grouped = run_qtopt(batches, 3, arm)
  assert single.step == grouped.step == 7
  assert_state_bitwise(single, grouped)


# --------------------------------------------- against the JAX trainer


def fast_adam():
  return optimizers.create_adam_optimizer(1e-2)


def mock_batches(count, batch_size=8, seed=0):
  rng = np.random.RandomState(seed)
  batches = []
  for _ in range(count):
    points = rng.uniform(-1.0, 1.0, (batch_size, 2)).astype(np.float32)
    batches.append(({'measured_position': points},
                    {'valid_position': (points.sum(axis=1) > 0).astype(
                        np.float32)}))
  return batches


def jax_batches(batches):
  out = []
  for features, labels in batches:
    f, l = JaxSpecStruct(), JaxSpecStruct()
    for key, value in features.items():
      f[key] = value
    for key, value in labels.items():
      l[key] = value
    out.append((f, l))
  return out


def mock_variables():
  model = JaxMockModel(device_type='cpu')
  shapes = jax.eval_shape(lambda: model.create_module().init(
      jax.random.PRNGKey(0), {'measured_position': np.zeros((1, 2),
                                                             np.float32)},
      train=False))
  return random_variables(shapes, seed=3)


def load_mock_variables(network, variables):
  params, stats = variables['params'], variables['batch_stats']
  with torch.no_grad():
    for name in ('Dense_0', 'Dense_1', 'Dense_2'):
      dense = getattr(network, 'dense_' + name[-1])
      dense.weight.copy_(torch.from_numpy(
          np.asarray(params[name]['kernel']).T.copy()))
      dense.bias.copy_(torch.from_numpy(np.asarray(params[name]['bias'])))
    bn = network.batch_norm
    bn.scale.copy_(torch.from_numpy(np.asarray(params['BatchNorm_0']['scale'])))
    bn.bias.copy_(torch.from_numpy(np.asarray(params['BatchNorm_0']['bias'])))
    bn.mean.copy_(torch.from_numpy(np.asarray(stats['BatchNorm_0']['mean'])))
    bn.var.copy_(torch.from_numpy(np.asarray(stats['BatchNorm_0']['var'])))


def mock_trainer(k, callbacks=(), shutdown=None, model_dir='', **cfg):
  model = MockT2RModel(device_type='cpu',
                       create_optimizer_fn=cfg.pop('optimizer_fn', fast_adam),
                       **cfg.pop('model_kwargs', {}))
  cfg.setdefault('log_interval_steps', 0)
  cfg.setdefault('eval_interval_steps', 0)
  cfg.setdefault('async_checkpoints', False)
  return Trainer(model, TrainerConfig(model_dir=model_dir,
                                      steps_per_dispatch=k, **cfg),
                 device='cpu', callbacks=list(callbacks), shutdown=shutdown)


def sgd():
  return optimizers.create_gradient_descent_optimizer(0.1)


def jax_mock_trainer(k, variables=None, optimizer_fn=None, **cfg):
  kwargs = {}
  if variables is not None:
    kwargs['init_from_checkpoint_fn'] = lambda params, state: (
        variables['params'], {'batch_stats': variables['batch_stats']})
  model = JaxMockModel(
      device_type='cpu',
      create_optimizer_fn=optimizer_fn or (
          lambda: jax_optimizers.create_adam_optimizer(1e-2)),
      **kwargs)
  return JaxTrainer(model, JaxTrainerConfig(
      model_dir='', eval_interval_steps=0, log_interval_steps=0,
      prefetch_batches=0, auto_input_layouts=False, steps_per_dispatch=k,
      **cfg))


def test_k3_matches_the_jax_trainer_at_k3():
  variables = mock_variables()
  batches = mock_batches(7)
  jax_trainer = jax_mock_trainer(
      3, variables, max_train_steps=7,
      optimizer_fn=lambda: jax_optimizers.create_gradient_descent_optimizer(
          0.1))
  jax_scalars = jax_trainer.train(iter(jax_batches(batches)), None)
  port = mock_trainer(3, max_train_steps=7, optimizer_fn=sgd,
                      model_kwargs=dict(init_from_checkpoint_fn=lambda net:
                                        load_mock_variables(net, variables)))
  scalars = port.train(iter(batches))
  assert port.step == int(jax_trainer.step) == 7
  np.testing.assert_allclose(scalars['loss'], float(jax_scalars['loss']),
                             rtol=0, atol=5e-5)
  params = jax.device_get(jax_trainer.state.params)
  stats = jax.device_get(jax_trainer.state.model_state)['batch_stats']
  start = mock_trainer(1, max_train_steps=0, model_kwargs=dict(
      init_from_checkpoint_fn=lambda net: load_mock_variables(net,
                                                              variables)))
  start.initialize(batches[0][0])
  begin = {k: v.clone() for k, v in start.state.network.state_dict().items()}
  got = port.state.network.state_dict()
  ulps = 4 * np.finfo(np.float32).eps
  for name in ('Dense_0', 'Dense_1', 'Dense_2'):
    prefix = 'dense_' + name[-1]
    for leaf, want in (('weight', np.asarray(params[name]['kernel']).T),
                       ('bias', np.asarray(params[name]['bias']))):
      change = got[f'{prefix}.{leaf}'].numpy() - begin[f'{prefix}.{leaf}'].numpy()
      want_change = want - begin[f'{prefix}.{leaf}'].numpy()
      band = 1e-3 * np.abs(want_change).max() + ulps * np.abs(want).max()
      assert np.abs(change - want_change).max() <= band, (prefix, leaf)
  for leaf, want in (('mean', stats['BatchNorm_0']['mean']),
                     ('var', stats['BatchNorm_0']['var'])):
    want = np.asarray(want)
    assert np.abs(got[f'batch_norm.{leaf}'].numpy() - want).max() <= (
        1e-5 * np.abs(want).max()), leaf


# --------------------------------------------- intervals and the tail


def test_commit_markers_carry_k_and_m_and_refuse_another(tmp_path):
  model_dir = str(tmp_path / 'm')
  trainer = mock_trainer(3, model_dir=model_dir, max_train_steps=3,
                         grad_accum_microbatches=2)
  trainer.train(iter(mock_batches(3)))
  marker = ckpt.read_commit_marker(os.path.join(model_dir, 'checkpoints'), 3)
  assert marker['topology']['steps_per_dispatch'] == 3
  assert marker['topology']['grad_accum_microbatches'] == 2
  for k, m in ((1, 2), (3, 1)):
    with pytest.raises(ckpt.TopologyMismatchError):
      mock_trainer(k, model_dir=model_dir, max_train_steps=6,
                   grad_accum_microbatches=m).train(iter(mock_batches(4)))


def test_saves_quantize_to_dispatch_boundaries(tmp_path):
  trainer = mock_trainer(3, model_dir=str(tmp_path / 'm'), max_train_steps=7,
                         save_interval_steps=2)
  trainer.train(iter(mock_batches(7)))
  assert trainer.checkpoint_manager.all_steps() == [3, 6, 7]


def test_callback_cadence_at_k_steps_per_dispatch(tmp_path):
  trainer = mock_trainer(3, model_dir=str(tmp_path / 'm'), max_train_steps=9,
                         save_interval_steps=0, log_interval_steps=2,
                         callbacks=[MetricsLoggerCallback()])
  trainer.train(iter(mock_batches(9)))
  with open(tmp_path / 'm' / 'metrics.jsonl') as f:
    steps = [json.loads(line)['step'] for line in f
             if json.loads(line)['kind'] == 'train']
  assert steps == [3, 6, 9], steps


def test_ragged_tail_trains_as_its_own_group():
  batches = mock_batches(1) + mock_batches(1, batch_size=5, seed=1)
  trainer = mock_trainer(3, max_train_steps=2)
  trainer.train(iter(batches))
  assert trainer.step == 2


# ----------------------------------------- prefetch and the device feed


@pytest.mark.parametrize('k,steps', [(2, 8), (3, 7)])
def test_prefetch_and_device_feed_are_bitwise_and_count_one_put(k, steps):
  batches = qtopt_batches(steps)
  plain = run_qtopt(batches, k, prefetch_batches=0)
  puts = metrics_lib.counter('trainer/h2d/device_puts')
  before = puts.value
  fed = run_qtopt(batches, k, prefetch_batches=2, device_feed=True)
  assert puts.value - before == -(-steps // k)
  assert_state_bitwise(plain, fed)
  assert_state_bitwise(run_qtopt(batches, 1), fed)


# ------------------------------------------------------ the NaN slice


@pytest.mark.parametrize('arm', ('momentum', 'fused'))
def test_nan_slice_skips_exactly_its_own_update(arm):
  b = qtopt_batches(6, seed=4)
  poisoned = [b[0], b[1], nanify(b[2]), b[3], b[4], b[5]]
  grouped = run_qtopt(poisoned, 3, arm, nonfinite_mode='skip_update')
  assert grouped.nonfinite_policy.bad_steps == 1
  assert grouped.step == 5
  clean = run_qtopt([b[0], b[1], b[3], b[4], b[5]], 3, arm,
                    nonfinite_mode='skip_update')
  assert clean.nonfinite_policy.bad_steps == 0
  assert_state_bitwise(clean, grouped)
  single = run_qtopt(poisoned, 1, arm, max_steps=6,
                     nonfinite_mode='skip_update')
  assert_state_bitwise(single, grouped)


def test_nan_slice_applied_steps_match_jax():
  batches = mock_batches(6)
  features, labels = batches[2]
  batches[2] = ({'measured_position': np.full_like(
      features['measured_position'], np.nan)}, labels)
  jax_trainer = jax_mock_trainer(3, max_train_steps=6,
                                 nonfinite_mode='skip_update')
  jax_trainer.train(iter(jax_batches(batches)), None)
  port = mock_trainer(3, max_train_steps=6, nonfinite_mode='skip_update')
  port.train(iter(batches))
  assert port.step == int(jax_trainer.step) == 5
  assert (port.nonfinite_policy.bad_steps ==
          jax_trainer.nonfinite_policy.bad_steps == 1)


# ---------------------------------------------------- SIGTERM resume


class _Signal(TrainerCallback):
  """Sends SIGTERM at the first boundary at or after ``at_step``."""

  def __init__(self, at_step):
    self._at_step, self.fired = at_step, None

  def after_step(self, trainer, step, scalars):
    if self.fired is None and step >= self._at_step:
      self.fired = step
      os.kill(os.getpid(), signal.SIGTERM)


def test_sigterm_mid_dispatch_resumes_bit_exact(tmp_path):
  batches = qtopt_batches(9, seed=5)
  reference = run_qtopt(batches, 3, device_feed=True)
  model_dir = str(tmp_path / 'm')
  prev = signal.getsignal(signal.SIGTERM)
  shutdown = GracefulShutdown(signals=(signal.SIGTERM,)).install()
  try:
    trainer = qtopt_trainer(callbacks=[_Signal(4)], shutdown=shutdown,
                            model_dir=model_dir, max_train_steps=9,
                            save_interval_steps=1000, async_checkpoints=False,
                            steps_per_dispatch=3, device_feed=True)
    with pytest.raises(PreemptedError):
      trainer.train(iter(batches))
  finally:
    shutdown.uninstall()
    signal.signal(signal.SIGTERM, prev)
  saved = latest_checkpoint_step(os.path.join(model_dir, 'checkpoints'))
  assert saved == 6
  resumed = qtopt_trainer(model_dir=model_dir, max_train_steps=9,
                          save_interval_steps=1000, async_checkpoints=False,
                          steps_per_dispatch=3, device_feed=True)
  # The batch pulled to build the state is not trained on a resume.
  resumed.train(iter(batches[saved - 1:]))
  assert_state_bitwise(reference, resumed)


# ------------------------------------- the capture-safe step's parts


def test_device_offset_crop_equals_host_offset_crop():
  rng = np.random.RandomState(6)
  images = torch.from_numpy(rng.randint(0, 256, (3, 30, 41, 3)).astype(
      np.uint8))
  for seed in range(6):
    generator = torch.Generator().manual_seed(seed)
    host = image_transformations.random_crop_images(images, (17, 23),
                                                    generator)
    offsets = image_transformations.random_crop_offsets(
        torch.Generator().manual_seed(seed), images.shape, (17, 23))
    device = image_transformations.crop_at_device_offsets(
        images, (17, 23), torch.tensor(offsets))
    assert torch.equal(host, device) and device.is_contiguous()


def test_device_selected_rates_equal_exponential_decay():
  schedule = optimizers.exponential_decay(1e-3, 2, 0.5, staircase=True)
  jax_schedule = optax.exponential_decay(1e-3, 2, 0.5, staircase=True)
  optimizer = optimizers.MomentumSGD([torch.nn.Parameter(torch.zeros(2))],
                                     schedule)
  for start in (0, 3, 7):
    rates = torch.tensor([optimizer.rates(start + j) for j in range(3)],
                         dtype=torch.float32)
    slot = torch.zeros((), dtype=torch.int64)
    applied = 0
    for ok in (True, False, True):
      row = rates.index_select(0, slot.reshape(1)).reshape(3)
      want = np.float32(schedule(start + applied))
      assert row[0].numpy() == want
      assert want == np.float32(jax_schedule(start + applied))
      slot.add_(int(ok))
      applied += int(ok)


@pytest.mark.parametrize('kind', fused_update.KINDS)
@pytest.mark.parametrize('ema', [False, True])
@pytest.mark.parametrize('guard', [None, True, False])
def test_plain_fused_update_device_rates_are_bitwise_host_scalars(kind, ema,
                                                                   guard):
  rng = np.random.RandomState(7)
  spec = fused_update.FusedSpec(
      kind, optimizers.exponential_decay(3e-3, 2, 0.5, staircase=True))

  def leaves():
    out = []
    for shape in ((5, 3), (7,), (2, 2, 2)):
      tensors = [torch.from_numpy(rng.randn(*shape).astype(np.float32))
                 for _ in range(5)]
      out.append(fused_update.Leaf(
          tensors[0], tensors[1],
          tensors[2] if kind == 'adam' else None,
          tensors[3].abs() if kind == 'adam' else None,
          tensors[4] if ema else None))
    return out

  first = leaves()
  second = [fused_update.Leaf(*(None if t is None else t.clone()
                                for t in leaf)) for leaf in first]
  ok = None if guard is None else torch.tensor([guard])
  decay = 0.99 if ema else None
  for count in range(4):
    lr, c1, c2 = fused_update.host_rates(spec, count)
    fused_update.plain_fused_update(first, kind, lr, c1, c2, spec.b1,
                                    spec.b2, spec.eps, decay, ok)
    fused_update.plain_fused_update(
        second, kind, 0.0, 0.0, 0.0, spec.b1, spec.b2, spec.eps, decay, ok,
        rates=torch.tensor([lr, c1, c2], dtype=torch.float32))
    for a, b in zip(first, second):
      for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
          assert torch.equal(x, y)


# --------------------------------- the breakdown and the registry mirror


class _LogScalars(TrainerCallback):

  def __init__(self):
    self.rows = []

  def after_step(self, trainer, step, scalars):
    if isinstance(scalars.get('loss'), float):
      self.rows.append((step, dict(scalars)))


def test_dispatch_breakdown_matches_the_jax_trainer():
  """Per-dispatch counters, the log window's breakdown keys and one
  'dispatch' flight event a boundary, against the JAX trainer's at K=3."""
  class JaxLog(JaxCallback):

    def __init__(self):
      self.rows = []

    def after_step(self, trainer, step, scalars):
      if isinstance(scalars.get('loss'), float):
        self.rows.append((step, dict(scalars)))

  batches = mock_batches(12)
  counters = ('trainer/dispatches', 'trainer/steps', 'trainer/examples')
  jax_before = [jax_metrics.counter(c).value for c in counters]
  port_before = [metrics_lib.counter(c).value for c in counters]
  jax_log, port_log = JaxLog(), _LogScalars()
  jax_trainer = jax_mock_trainer(3, max_train_steps=12)
  jax_trainer._callbacks.append(jax_log)  # pylint: disable=protected-access
  jax_trainer._config.log_interval_steps = 6  # pylint: disable=protected-access
  jax_trainer.train(iter(jax_batches(batches)), None)
  events = len(flight.events())
  port = mock_trainer(3, max_train_steps=12, log_interval_steps=6,
                      callbacks=[port_log])
  port.train(iter(batches))
  assert ([jax_metrics.counter(c).value - v
           for c, v in zip(counters, jax_before)] ==
          [metrics_lib.counter(c).value - v
           for c, v in zip(counters, port_before)] == [4, 12, 96])
  assert [step for step, _ in port_log.rows] == [
      step for step, _ in jax_log.rows] == [6, 12]
  keys = {'examples_per_sec', 'input_bound_fraction',
          'goodput_examples_per_sec', 'breakdown/wall_ms',
          'breakdown/host_wait_ms', 'breakdown/placement_ms',
          'breakdown/dispatch_ms', 'breakdown/device_step_ms',
          'breakdown/callback_ms'}
  for (_, got), (_, want) in zip(port_log.rows, jax_log.rows):
    assert keys <= set(want)
    assert set(got) == keys | {'loss'}
    assert all(value >= 0 for value in got.values())
  boundaries = [e for e in flight.events()[events:]
                if e['kind'] == 'dispatch']
  assert [e['detail'].split()[0] for e in boundaries] == [
      'step=3', 'step=6', 'step=9', 'step=12']


def test_nonfinite_skips_are_mirrored_like_jax():
  batches = mock_batches(6)
  features, labels = batches[2]
  batches[2] = ({'measured_position': np.full_like(
      features['measured_position'], np.nan)}, labels)
  name = 'resilience/nonfinite_skipped_steps'
  jax_before, port_before = (jax_metrics.counter(name).value,
                             metrics_lib.counter(name).value)
  jax_mock_trainer(3, max_train_steps=6, nonfinite_mode='skip_update').train(
      iter(jax_batches(batches)), None)
  mock_trainer(3, max_train_steps=6, nonfinite_mode='skip_update').train(
      iter(batches))
  assert (jax_metrics.counter(name).value - jax_before ==
          metrics_lib.counter(name).value - port_before == 1)
  # Observed one dispatch behind, for the dispatch that ended at step 3.
  skip, = [e['detail'] for e in flight.events()[-8:]
           if e['kind'] == 'nonfinite'][-1:]
  want, = [e['detail'] for e in jax_flight.events()[-8:]
           if e['kind'] == 'nonfinite'][-1:]
  assert skip == want == 'count=1 step=3 consecutive=1 mode=skip_update'


def test_the_qtopt_config_binds_the_dispatch_knobs(tmp_path):
  from tensor2robot_tpu_torch import config as t2r_config
  from tensor2robot_tpu_torch.bin import run_t2r_trainer

  path = os.path.join(os.path.dirname(run_t2r_trainer.__file__), '..',
                      'research', 'qtopt', 'configs', 'train_qtopt.gin')
  t2r_config.register_framework_configurables()
  t2r_config.clear_config()
  try:
    t2r_config.parse_config_files_and_bindings([path], [
        f"train_eval_model.model_dir = '{tmp_path}'",
        'train_eval_model.device_feed = True',
        'train_eval_model.prefetch_batches = 2',
        'train_eval_model.grad_accum_microbatches = 2',
        "GraspingModelWrapper.remat_policy = 'conv_towers'"])
    query = t2r_config.query_parameter
    assert query('train_eval_model.steps_per_dispatch') == 8
    assert query('train_eval_model.device_feed') is True
    assert query('train_eval_model.prefetch_batches') == 2
    assert query('train_eval_model.grad_accum_microbatches') == 2
    model = query('train_eval_model.model', resolve=True)
    assert model.remat_policy == 'conv_towers'
  finally:
    t2r_config.clear_config()
