"""Port parity: checkpoints, resume, eval and serving from a checkpoint.

QT-Opt, on the tiny config of ``tests/test_torch_training.py`` (80x80
images, ``num_convs=(2, 2, 1)``, float32, batch 4, crop = image, so that no
random draw enters a cross-framework comparison):

* resume, bit for bit on the CPU: 3 steps, a save, a fresh ``Trainer`` on
  the same ``model_dir`` and 3 more steps against 6 steps straight through,
  with async checkpoints on and off, and with the fused update over a
  tagged Adam (whose plan keeps its ``PreparedUpdate`` across a restore
  into the live trainer): every parameter, momentum buffer or moment,
  group ``count``, EMA tensor, batch statistic and the generator state
  (``torch.equal``);
* a JAX checkpoint read by the JAX package, converted with
  ``utils/convert.jax_train_state_to_torch`` and saved by the port:
  - resumed by a port ``Trainer`` for one step, against the JAX run's
    next step, in the bands of ``test_trainer_matches_jax`` (parameter
    change 1e-3 of its largest magnitude plus four float32 ulps, EMA 1e-6,
    batch statistics 1e-5, scalars atol 5e-5);
  - restored by the port's ``CheckpointPredictor``: q within atol 1e-6 of
    the JAX ``CheckpointPredictor.restore()`` over the orbax step (the
    predictions band of ``tests/test_torch_grasping44.py``);
  - evaluated by the port's ``Trainer.evaluate`` over 2 batches: ``q_mean``
    and ``td_abs_error`` within atol 1e-6 and ``loss`` within 1e-5 of the
    JAX ``Trainer.evaluate`` (the predictions and eval-logits bands).
  The JAX trainer runs once, in a module fixture.

The JAX package's trainer and resilience tests mirrored one for one on the
port's mock model (``tests/test_trainer.py``, ``tests/test_resilience.py``,
the continuous evaluator of ``tests/test_input_engine.py``), the synthetic
input generators against the JAX ones (exact), the trainer binary, and the
knobs that still raise.

About 40 s alone on the CPU, most of it the JAX fixture's compiles.
"""

import json
import logging
import os
import shutil
import signal

import jax
import numpy as np
import pytest
import torch
from test_torch_checkpoints import truncate_checkpoint
from test_torch_training import (BATCH, IMAGE, NUM_CONVS, _assert_band,
                                 _assert_change_band, _batches, _Snapshots,
                                 _variables)

from tensor2robot_tpu.data import input_generators as jax_ig
from tensor2robot_tpu.predictors import CheckpointPredictor as JaxPredictor
from tensor2robot_tpu.research.qtopt import GraspingModelWrapper as JaxWrapper
from tensor2robot_tpu.train import checkpoints as jax_ckpt
from tensor2robot_tpu.train.trainer import Trainer as JaxTrainer
from tensor2robot_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from tensor2robot_tpu_torch import config as t2r_config
from tensor2robot_tpu_torch.bin import run_t2r_trainer
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.models import (default_init_from_checkpoint_fn,
                                           optimizers)
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.predictors import CheckpointPredictor
from tensor2robot_tpu_torch.research.qtopt import GraspingModelWrapper
from tensor2robot_tpu_torch.train import (GracefulShutdown, PreemptedError,
                                          Trainer, TrainerCallback,
                                          TrainerConfig,
                                          latest_checkpoint_step,
                                          predict_from_model, resilience,
                                          train_eval_model)
from tensor2robot_tpu_torch.train import checkpoints as ckpt
from tensor2robot_tpu_torch.train import train_state
from tensor2robot_tpu_torch.train.callbacks import TensorBoardCallback
from tensor2robot_tpu_torch.train.trainer import EVAL_STATE_FILENAME
from tensor2robot_tpu_torch.utils import convert
from tensor2robot_tpu_torch.utils.mocks import (MockInputGenerator,
                                                MockT2RModel)

STEPS = 3
EVAL_BATCHES = 2


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

# ------------------------------------------------------ QT-Opt, port only


def _qtopt(optimizer_fn=None):
  kwargs = {} if optimizer_fn is None else {
      'create_optimizer_fn': optimizer_fn}
  return GraspingModelWrapper(
      device_type='cpu', input_shape=IMAGE, target_shape=IMAGE[:2],
      num_convs=NUM_CONVS, kernel_policy='pool_conv', **kwargs)


def _tagged_adam():
  return optimizers.create_adam_optimizer(
      optimizers.create_exp_decaying_learning_rate_fn(1e-3, decay_steps=2,
                                                      staircase=True))


def _config(model_dir, steps, **kwargs):
  return TrainerConfig(model_dir=model_dir, max_train_steps=steps,
                       log_interval_steps=0, save_interval_steps=0, seed=5,
                       **kwargs)


def _state_tensors(state):
  """Every tensor of the train state by name, the generator's included."""
  out = {f'network/{k}': v for k, v in state.network.state_dict().items()}
  names = {p: n for n, p in state.network.named_parameters()}
  for p, slots in state.optimizer.state.items():
    out.update({f'slot/{names[p]}/{k}': v for k, v in slots.items()})
  out.update({f'ema/{k}': v for k, v in state.ema.items()})
  out['generator'] = state.generator.get_state()
  return out


def _assert_same_state(got, want):
  a, b = _state_tensors(got), _state_tensors(want)
  assert set(a) == set(b)
  for name in b:
    assert torch.equal(a[name], b[name]), name
  assert got.step == want.step
  assert ([g['count'] for g in got.optimizer.param_groups] ==
          [g['count'] for g in want.optimizer.param_groups])


@pytest.mark.parametrize('case', ['sync', 'async', 'fused_adam'])
def test_resume_is_bitwise_an_uninterrupted_run(tmp_path, case):
  optimizer_fn = _tagged_adam if case == 'fused_adam' else None
  kwargs = dict(async_checkpoints=case == 'async',
                fused_update=case == 'fused_adam')
  batches = _batches(seed=11, count=2 * STEPS)
  straight = Trainer(_qtopt(optimizer_fn),
                     _config('', 2 * STEPS, **kwargs), device='cpu')
  straight.train(iter(batches))
  model_dir = str(tmp_path)
  first = Trainer(_qtopt(optimizer_fn), _config(model_dir, STEPS, **kwargs),
                  device='cpu')
  first.train(iter(batches[:STEPS]))
  assert latest_checkpoint_step(os.path.join(model_dir, 'checkpoints')) == 3
  resumed = Trainer(_qtopt(optimizer_fn),
                    _config(model_dir, 2 * STEPS, **kwargs), device='cpu')
  # On resume the first batch builds the state and is not trained on.
  resumed.train(iter(batches[STEPS - 1:]))
  _assert_same_state(resumed.state, straight.state)
  if case == 'fused_adam':
    # A restore into the live trainer copies into the tensors the fused
    # plan validated, so it keeps its PreparedUpdate and continues.
    prepared = resumed.fused_plan.prepared[0]
    assert prepared is not None
    assert resumed.restore_checkpoint() == 2 * STEPS
    resumed.restore_checkpoint(STEPS)
    resumed.config.max_train_steps = 2 * STEPS
    resumed.train(iter(batches[STEPS:]))
    assert resumed.fused_plan.prepared[0] is prepared
    _assert_same_state(resumed.state, straight.state)


# --------------------------------------------- QT-Opt against the JAX package


@pytest.fixture(scope='module')
def jax_checkpoints(tmp_path_factory):
  """The JAX trainer, STEPS steps with saves at 2 and 3, snapshots after
  each step, its eval over EVAL_BATCHES batches at the end, its
  CheckpointPredictor's q over the orbax steps, and steps 2 and 3 read back
  with the JAX CheckpointManager, as numpy."""
  variables = _variables()
  model_dir = str(tmp_path_factory.mktemp('jax'))

  def model():
    return JaxWrapper(
        device_type='cpu', input_shape=IMAGE, target_shape=IMAGE[:2],
        num_convs=NUM_CONVS,
        init_from_checkpoint_fn=lambda params, state: (
            variables['params'], {'batch_stats': variables['batch_stats']}))

  snapshots = _Snapshots()
  trainer = JaxTrainer(
      model(), JaxTrainerConfig(
          model_dir=model_dir, max_train_steps=STEPS, save_interval_steps=2,
          eval_steps=EVAL_BATCHES, eval_interval_steps=0,
          log_interval_steps=0, async_checkpoints=False,
          prefetch_batches=0),
      callbacks=[snapshots])
  trainer.train(iter(_batches()), None)
  metrics = trainer.evaluate(iter(_batches(seed=21, count=EVAL_BATCHES)))
  trainer.close()
  predictor = JaxPredictor(model(), model_dir)
  assert predictor.restore() and predictor.global_step == STEPS
  (features, _), = _batches(seed=9, count=1)
  q = predictor.predict(features)['q_predicted']
  ckpt_dir = os.path.join(model_dir, 'checkpoints')
  with jax_ckpt.CheckpointManager(ckpt_dir, async_save=False) as manager:
    states = {step: jax.device_get(manager.restore(trainer.state, step=step))
              for step in (STEPS - 1, STEPS)}
  return {'snapshots': snapshots.by_step, 'metrics': metrics, 'q': q,
          'features': features, 'states': states}


def _port_checkpoint(model_dir, jax_state):
  """The JAX state, converted, as the port's committed checkpoint."""
  trainer = Trainer(_qtopt(), _config('', 0), device='cpu')
  state = trainer.initialize(_batches(count=1)[0][0])
  payload = convert.jax_train_state_to_torch(jax_state, state, seed=5)
  with ckpt.CheckpointManager(os.path.join(model_dir, 'checkpoints'),
                              async_save=False) as manager:
    assert manager.save(payload['step'], payload, force=True)


def test_jax_checkpoint_resumes_in_the_port(tmp_path, jax_checkpoints):
  start = jax_checkpoints['states'][STEPS - 1]
  _port_checkpoint(str(tmp_path), start)
  trainer = Trainer(_qtopt(), _config(str(tmp_path), STEPS), device='cpu')
  batch = _batches()[STEPS - 1]
  scalars = trainer.train(iter([batch, batch]))
  assert trainer.step == STEPS
  groups = trainer.state.optimizer.param_groups
  assert [g['count'] for g in groups] == [STEPS] * len(groups)
  want_scalars, want_vars, want_eval = jax_checkpoints['snapshots'][STEPS]
  for key in ('loss', 'q_mean'):
    np.testing.assert_allclose(scalars[key], want_scalars[key], rtol=0,
                               atol=5e-5, err_msg=key)
  start = convert.jax_variables_to_torch(
      {'params': start.params, **start.model_state})
  want = convert.jax_variables_to_torch(want_vars)
  want_ema = convert.jax_variables_to_torch(want_eval)
  got = trainer.state.network.state_dict()
  got_ema = trainer.state.eval_state_dict()
  params = {name for name, _ in trainer.state.network.named_parameters()}
  assert set(got) == set(want)
  for name in want:
    if name in params:
      _assert_change_band(got[name], want[name], start[name], 1e-3, name)
      _assert_band(got_ema[name], want_ema[name], 1e-6, f'ema {name}')
    else:
      _assert_band(got[name], want[name], 1e-5, name)


def test_jax_checkpoint_serves_from_the_port_predictor(tmp_path,
                                                       jax_checkpoints):
  _port_checkpoint(str(tmp_path), jax_checkpoints['states'][STEPS])
  predictor = CheckpointPredictor(_qtopt(), str(tmp_path), device='cpu')
  assert predictor.restore() and predictor.global_step == STEPS
  q = predictor.predict(jax_checkpoints['features'])['q_predicted']
  assert q.shape == (BATCH,)
  np.testing.assert_allclose(q, jax_checkpoints['q'], rtol=0, atol=1e-6)


def test_jax_checkpoint_evaluates_in_the_port(tmp_path, jax_checkpoints):
  _port_checkpoint(str(tmp_path), jax_checkpoints['states'][STEPS])
  trainer = Trainer(_qtopt(), _config(str(tmp_path), STEPS,
                                      eval_steps=EVAL_BATCHES), device='cpu')
  metrics = trainer.evaluate(iter(_batches(seed=21, count=EVAL_BATCHES)))
  want = jax_checkpoints['metrics']
  assert set(metrics) == set(want) == {'loss', 'q_mean', 'td_abs_error'}
  assert trainer.step == STEPS
  for key, atol in (('q_mean', 1e-6), ('td_abs_error', 1e-6), ('loss', 1e-5)):
    np.testing.assert_allclose(metrics[key], want[key], rtol=0, atol=atol,
                               err_msg=key)


def test_predictor_copies_new_steps_into_the_served_network(tmp_path):
  """A restore publishes by copy_: the serving function a policy holds
  serves each new step."""
  model_dir = str(tmp_path)
  trainer = Trainer(_qtopt(), _config(model_dir, 1), device='cpu')
  trainer.train(iter(_batches(count=1)))
  predictor = CheckpointPredictor(_qtopt(), model_dir, device='cpu')
  assert predictor.restore() and predictor.global_step == 1
  serving_fn = predictor.device_serving_fn()
  assert predictor.restore()  # nothing newer: nothing reloaded
  trainer.config.max_train_steps = 2
  trainer.train(iter(_batches(seed=4, count=1)))
  assert predictor.restore() and predictor.global_step == 2
  assert predictor.device_serving_fn() is serving_fn
  want = trainer.state.eval_state_dict()
  for name, value in serving_fn.network.state_dict().items():
    assert torch.equal(value, want[name]), name
  empty = CheckpointPredictor(_qtopt(), str(tmp_path / 'none'),
                              device='cpu')
  assert not empty.restore()


# ------------------------------------------------------ synthetic generators


@pytest.mark.parametrize('kind', ['random', 'constant'])
def test_synthetic_generators_match_jax(kind):
  model = _qtopt()
  jax_model = JaxWrapper(device_type='cpu', input_shape=IMAGE,
                         target_shape=IMAGE[:2], num_convs=NUM_CONVS)
  if kind == 'random':
    port = input_generators.DefaultRandomInputGenerator(batch_size=2)
    ref = jax_ig.DefaultRandomInputGenerator(batch_size=2)
  else:
    port = input_generators.DefaultConstantInputGenerator(0.5, batch_size=2)
    ref = jax_ig.DefaultConstantInputGenerator(0.5, batch_size=2)
  port.set_specification_from_model(model, ModeKeys.TRAIN)
  ref.set_specification_from_model(jax_model, ModeKeys.TRAIN)
  got, want = port.create_iterator(ModeKeys.TRAIN), ref.create_iterator(
      ModeKeys.TRAIN)
  for _ in range(2):
    (features, labels), (want_features, want_labels) = next(got), next(want)
    for tree, want_tree in ((features, want_features), (labels, want_labels)):
      assert set(tree) == set(want_tree)
      for key in want_tree:
        assert tree[key].dtype == want_tree[key].dtype, key
        np.testing.assert_array_equal(tree[key], want_tree[key], err_msg=key)


def test_generator_input_generator_batches_examples():
  def examples():
    for i in range(3):
      yield ({'measured_position': np.full((2,), i, np.float32)},
             {'valid_position': np.float32(i % 2)})

  gen = input_generators.GeneratorInputGenerator(examples, batch_size=4)
  gen.set_specification_from_model(MockT2RModel(device_type='cpu'),
                                    ModeKeys.TRAIN)
  features, labels = next(gen.create_iterator(ModeKeys.TRAIN))
  np.testing.assert_array_equal(features['measured_position'][:, 0],
                                [0, 1, 2, 0])
  np.testing.assert_array_equal(labels['valid_position'], [0, 1, 0, 0])


# ------------------------------- the JAX package's trainer tests, mirrored


def fast_adam():
  return optimizers.create_adam_optimizer(1e-2)


def make_generators(model, batch_size=32):
  train_gen = MockInputGenerator(batch_size=batch_size)
  eval_gen = MockInputGenerator(batch_size=batch_size)
  train_gen.set_specification_from_model(model, ModeKeys.TRAIN)
  eval_gen.set_specification_from_model(model, ModeKeys.EVAL)
  return train_gen, eval_gen


def mock_config(model_dir='', **kwargs):
  kwargs.setdefault('eval_interval_steps', 0)
  kwargs.setdefault('log_interval_steps', 0)
  kwargs.setdefault('async_checkpoints', False)
  return TrainerConfig(model_dir=model_dir, **kwargs)


def run_mock(model_dir, max_steps, batch_size=8, **kwargs):
  return train_eval_model(
      model=MockT2RModel(), model_dir=model_dir,
      train_input_generator=MockInputGenerator(batch_size=batch_size),
      max_train_steps=max_steps, save_interval_steps=10,
      eval_interval_steps=0, log_interval_steps=0, device='cpu', **kwargs)


def test_mock_model_converges(tmp_path):
  model = MockT2RModel(create_optimizer_fn=fast_adam)
  metrics = train_eval_model(
      model=model, model_dir=str(tmp_path / 'm'),
      train_input_generator=MockInputGenerator(batch_size=32),
      eval_input_generator=MockInputGenerator(batch_size=32),
      max_train_steps=400, eval_steps=10, eval_interval_steps=200,
      save_interval_steps=200, log_interval_steps=100, device='cpu')
  assert metrics['accuracy'] > 0.95, metrics
  assert metrics['loss'] < 0.3, metrics
  assert latest_checkpoint_step(str(tmp_path / 'm' / 'checkpoints')) == 400


def test_trainer_resumes_from_checkpoint(tmp_path):
  model_dir = str(tmp_path / 'm')
  run_mock(model_dir, 10, batch_size=16)
  assert latest_checkpoint_step(os.path.join(model_dir, 'checkpoints')) == 10
  run_mock(model_dir, 20, batch_size=16)  # restores 10, trains 10 more
  assert latest_checkpoint_step(os.path.join(model_dir, 'checkpoints')) == 20


def test_save_interval_zero_disables_periodic_saves(tmp_path):
  model = MockT2RModel()
  model_dir = str(tmp_path / 'm')
  gen = MockInputGenerator(batch_size=8)
  gen.set_specification_from_model(model, ModeKeys.TRAIN)
  trainer = Trainer(model, mock_config(model_dir, max_train_steps=3,
                                       save_interval_steps=0), device='cpu')
  trainer.train(gen.create_iterator(ModeKeys.TRAIN), None)
  ckpt_dir = os.path.join(model_dir, 'checkpoints')
  assert latest_checkpoint_step(ckpt_dir) == 3
  assert os.listdir(ckpt_dir) == ['ckpt_3']


def test_predict_from_model():
  stream = predict_from_model(model=MockT2RModel(),
                              input_generator=MockInputGenerator(batch_size=4),
                              model_dir='', device='cpu')
  out = next(stream)
  assert out['a_predicted'].shape == (4,)
  assert np.all(out['a_predicted'] >= 0.0)
  assert np.all(out['a_predicted'] <= 1.0)


def test_eval_backup_survives_trainer_gc(tmp_path):
  model = MockT2RModel(device_type='cpu', create_optimizer_fn=fast_adam)
  train_gen, eval_gen = make_generators(model)
  trainer = Trainer(model, mock_config(str(tmp_path / 'm'), max_train_steps=4,
                                       save_interval_steps=4), device='cpu')
  trainer.train(train_gen.create_iterator(ModeKeys.TRAIN), None)
  trainer.close()
  ckpt_dir = str(tmp_path / 'm' / 'checkpoints')
  backup_dir = str(tmp_path / 'm' / ckpt.EVAL_BACKUP_DIRNAME)
  step = latest_checkpoint_step(ckpt_dir)
  assert step == 4
  backup = ckpt.create_backup_checkpoint_for_eval(ckpt_dir, step, backup_dir)
  assert backup is not None and os.path.isdir(backup)
  shutil.rmtree(os.path.join(ckpt_dir, f'ckpt_{step}'))
  assert latest_checkpoint_step(ckpt_dir) is None
  evaluator = Trainer(model, mock_config(max_train_steps=4, eval_steps=2),
                      device='cpu')
  features, _ = next(eval_gen.create_iterator(ModeKeys.EVAL))
  evaluator.initialize(features)
  train_state.load_state_dict(evaluator.state,
                              ckpt.restore_from_backup(backup))
  metrics = evaluator.evaluate(eval_gen.create_iterator(ModeKeys.EVAL))
  assert np.isfinite(metrics['loss'])
  assert evaluator.step == 4


def test_backup_detects_gc_race(tmp_path):
  ckpt_dir = str(tmp_path / 'checkpoints')
  os.makedirs(ckpt_dir)
  assert ckpt.create_backup_checkpoint_for_eval(
      ckpt_dir, 7, str(tmp_path / 'backup')) is None


def _train_source(tmp_path, steps):
  model = MockT2RModel(device_type='cpu', create_optimizer_fn=fast_adam)
  train_gen, _ = make_generators(model)
  trainer = Trainer(model, mock_config(str(tmp_path / 'src'),
                                       max_train_steps=steps,
                                       save_interval_steps=steps),
                    device='cpu')
  trainer.train(train_gen.create_iterator(ModeKeys.TRAIN), None)
  trainer.close()
  return trainer, str(tmp_path / 'src' / 'checkpoints' / f'ckpt_{steps}')


def test_warm_start_partial_restore(tmp_path):
  trainer, source = _train_source(tmp_path, 3)
  src = {k: v.clone()
         for k, v in trainer.state.network.named_parameters()}
  warm = MockT2RModel(device_type='cpu',
                      init_from_checkpoint_fn=default_init_from_checkpoint_fn(
                          source, exclude=('dense_2',)))
  gen, _ = make_generators(warm)
  trainer2 = Trainer(warm, mock_config(max_train_steps=1), device='cpu')
  trainer2.initialize(next(gen.create_iterator(ModeKeys.TRAIN))[0])
  restored = excluded = 0
  for name, value in trainer2.state.network.named_parameters():
    if 'dense_2' in name:
      excluded += 1
      assert not torch.allclose(value, src[name]), name
    else:
      restored += 1
      assert torch.equal(value, src[name]), name
  assert restored > 0 and excluded > 0
  # A bare state_dict file works the same way.
  bare = str(tmp_path / 'bare.pt')
  torch.save(dict(trainer.state.network.state_dict()), bare)
  network = warm.create_module()
  default_init_from_checkpoint_fn(bare, include=('dense_1',))(network)
  assert torch.equal(network.dense_1.weight, src['dense_1.weight'])


def test_warm_start_no_match_raises(tmp_path):
  _, source = _train_source(tmp_path, 1)
  warm = MockT2RModel(device_type='cpu',
                      init_from_checkpoint_fn=default_init_from_checkpoint_fn(
                          source, include=('no_such_module',)))
  gen, _ = make_generators(warm)
  trainer2 = Trainer(warm, mock_config(max_train_steps=1), device='cpu')
  with pytest.raises(ValueError, match='matched no parameters'):
    trainer2.initialize(next(gen.create_iterator(ModeKeys.TRAIN))[0])


def test_tensorboard_callback_writes_events(tmp_path):
  model = MockT2RModel(device_type='cpu', create_optimizer_fn=fast_adam)
  train_gen, eval_gen = make_generators(model)
  trainer = Trainer(model, mock_config(str(tmp_path / 'm'), max_train_steps=4,
                                       save_interval_steps=4,
                                       eval_interval_steps=4,
                                       log_interval_steps=2),
                    device='cpu', callbacks=[TensorBoardCallback()])
  trainer.train(train_gen.create_iterator(ModeKeys.TRAIN),
                lambda: eval_gen.create_iterator(ModeKeys.EVAL))
  trainer.close()
  for kind in ('train', 'eval'):
    event_dir = str(tmp_path / 'm' / 'events' / kind)
    assert os.path.isdir(event_dir), event_dir
    assert any(n.startswith('events.out.tfevents')
               for n in os.listdir(event_dir)), os.listdir(event_dir)


class _Preempt(TrainerCallback):
  """Requests a shutdown, or sends a real signal, at ``at_step``
  (``tensor2robot_tpu/utils/faults.PreemptionCallback``)."""

  def __init__(self, at_step, shutdown=None, signum=None):
    self._at_step, self._shutdown, self._signum = at_step, shutdown, signum

  def after_step(self, trainer, step, scalars):
    if step != self._at_step:
      return
    if self._signum is not None:
      os.kill(os.getpid(), self._signum)
    else:
      self._shutdown.request()


def make_trainer(model_dir='', callbacks=(), shutdown=None, **cfg):
  model = MockT2RModel(create_optimizer_fn=fast_adam)
  cfg.setdefault('prefetch_batches', 0)
  return Trainer(model, mock_config(model_dir, async_checkpoints=True, **cfg),
                 device='cpu', callbacks=callbacks, shutdown=shutdown)


def _train_iter(trainer):
  gen = MockInputGenerator(batch_size=8)
  gen.set_specification_from_model(trainer.model, ModeKeys.TRAIN)
  return gen.create_iterator(ModeKeys.TRAIN)


def test_preemption_checkpoints_and_resumes(tmp_path):
  model_dir = str(tmp_path / 'm')
  shutdown = GracefulShutdown()  # not installed: driven programmatically
  trainer = make_trainer(model_dir, [_Preempt(5, shutdown=shutdown)],
                         shutdown, max_train_steps=12,
                         save_interval_steps=1000)
  with pytest.raises(PreemptedError) as excinfo:
    trainer.train(_train_iter(trainer), None)
  assert excinfo.value.step == 5
  assert excinfo.value.exit_code == resilience.PREEMPTED_EXIT_CODE
  ckpt_dir = os.path.join(model_dir, 'checkpoints')
  assert latest_checkpoint_step(ckpt_dir) == 5
  resumed = make_trainer(model_dir, max_train_steps=12,
                         save_interval_steps=1000)
  resumed.train(_train_iter(resumed), None)
  assert resumed.step == 12
  assert latest_checkpoint_step(ckpt_dir) == 12


def test_preemption_via_real_sigterm(tmp_path):
  model_dir = str(tmp_path / 'm')
  prev = signal.getsignal(signal.SIGTERM)
  shutdown = GracefulShutdown(signals=(signal.SIGTERM,)).install()
  try:
    trainer = make_trainer(model_dir, [_Preempt(3, signum=signal.SIGTERM)],
                           shutdown, max_train_steps=10,
                           save_interval_steps=1000)
    with pytest.raises(PreemptedError):
      trainer.train(_train_iter(trainer), None)
    assert latest_checkpoint_step(os.path.join(model_dir, 'checkpoints')) == 3
    # The first signal consumed the handler: the previous one is back.
    assert signal.getsignal(signal.SIGTERM) == prev
  finally:
    shutdown.uninstall()
    signal.signal(signal.SIGTERM, prev)


def test_trainer_resumes_from_older_step_when_latest_truncated(tmp_path,
                                                               caplog):
  model_dir = str(tmp_path / 'm')
  ckpt_dir = os.path.join(model_dir, 'checkpoints')
  run_mock(model_dir, 20)
  assert latest_checkpoint_step(ckpt_dir) == 20
  truncate_checkpoint(ckpt_dir, 20)
  with caplog.at_level(logging.WARNING):
    run_mock(model_dir, 30)
  assert latest_checkpoint_step(ckpt_dir) == 30
  assert any('falling back' in r.message for r in caplog.records)


def test_vanished_checkpoint_resumes_from_survivor(tmp_path):
  model_dir = str(tmp_path / 'm')
  ckpt_dir = os.path.join(model_dir, 'checkpoints')
  run_mock(model_dir, 20)
  shutil.rmtree(os.path.join(ckpt_dir, 'ckpt_20'))
  assert latest_checkpoint_step(ckpt_dir) == 10
  run_mock(model_dir, 30)
  assert latest_checkpoint_step(ckpt_dir) == 30


def test_continuous_eval_skips_evaluated_steps_after_restart(tmp_path,
                                                             monkeypatch):
  model_dir = str(tmp_path / 'm')

  def train_to(max_steps):
    model = MockT2RModel(device_type='cpu', create_optimizer_fn=fast_adam)
    train_gen, _ = make_generators(model, batch_size=8)
    trainer = Trainer(model, mock_config(model_dir, max_train_steps=max_steps,
                                         save_interval_steps=2),
                      device='cpu')
    trainer.train(train_gen.create_iterator(ModeKeys.TRAIN), None)
    trainer.close()

  train_to(2)

  class EvalRecorder(TrainerCallback):

    def __init__(self, on_eval=None):
      self.steps = []
      self._on_eval = on_eval

    def after_eval(self, trainer, step, metrics):
      self.steps.append(int(trainer.step))
      if self._on_eval is not None:
        self._on_eval()

  def run_eval(callbacks):
    return train_eval_model(
        model=MockT2RModel(device_type='cpu', create_optimizer_fn=fast_adam),
        model_dir=model_dir, eval_input_generator=MockInputGenerator(8),
        max_train_steps=4, eval_steps=2, use_continuous_eval=True,
        eval_timeout_secs=0.5, log_interval_steps=0, callbacks=callbacks,
        device='cpu')

  # Run 1: after the step-2 eval, training reaches step 4 and a preemption
  # lands; the evaluator records its position and raises, resumable.
  shutdown = GracefulShutdown()
  monkeypatch.setattr(resilience, '_GLOBAL_SHUTDOWN', shutdown)

  def extend_then_preempt():
    train_to(4)
    shutdown.request()

  recorder = EvalRecorder(on_eval=extend_then_preempt)
  with pytest.raises(PreemptedError) as excinfo:
    run_eval([recorder])
  assert excinfo.value.exit_code == 42
  assert recorder.steps == [2]
  state_path = os.path.join(model_dir, EVAL_STATE_FILENAME)
  with open(state_path) as f:
    assert json.load(f) == {'last_evaluated_step': 2}
  # Run 2: the restarted evaluator skips step 2 and evaluates step 4.
  monkeypatch.setattr(resilience, '_GLOBAL_SHUTDOWN', None)
  recorder2 = EvalRecorder()
  metrics = run_eval([recorder2])
  assert recorder2.steps == [4]
  assert np.isfinite(metrics['loss'])
  with open(state_path) as f:
    assert json.load(f) == {'last_evaluated_step': 4}


# ----------------------------------------------------------------- binary


def test_trainer_binary_leaves_a_committed_checkpoint(tmp_path):
  model_dir = tmp_path / 'model'
  config = tmp_path / 'exp.gin'
  config.write_text(f"""
train_eval_model.model = @MockT2RModel()
train_eval_model.train_input_generator = @train/MockInputGenerator()
train_eval_model.eval_input_generator = @eval/MockInputGenerator()
train_eval_model.model_dir = '{model_dir}'
train_eval_model.max_train_steps = 3
train_eval_model.eval_steps = 1
train_eval_model.device = 'cpu'
MockInputGenerator.batch_size = 8
""")
  prev = signal.getsignal(signal.SIGTERM)
  try:
    metrics = run_t2r_trainer.main(['--gin_configs', str(config)])
  finally:
    t2r_config.clear_config()
  assert signal.getsignal(signal.SIGTERM) == prev
  assert np.isfinite(metrics['loss']) and 'accuracy' in metrics
  ckpt_dir = str(model_dir / 'checkpoints')
  assert latest_checkpoint_step(ckpt_dir) == 3
  assert ckpt.read_commit_marker(ckpt_dir, 3)['step'] == 3
  operative = (model_dir / 'operative_config-0.gin').read_text()
  assert 'train_eval_model.max_train_steps = 3' in operative
  assert (model_dir / 'config-0.gin').exists()


def test_the_qtopt_config_parses_to_the_port_model(tmp_path):
  t2r_config.register_framework_configurables()
  t2r_config.clear_config()
  try:
    path = os.path.join(os.path.dirname(run_t2r_trainer.__file__), '..',
                        'research', 'qtopt', 'configs', 'train_qtopt.gin')
    t2r_config.parse_config_files_and_bindings([path], [
        f"train_eval_model.model_dir = '{tmp_path}'"])
    model = t2r_config.query_parameter('train_eval_model.model',
                                       resolve=True)
    assert isinstance(model, GraspingModelWrapper)
    assert model.kernel_policy == 'pool_conv'
    # The reference config's production dispatch mode is live in the port.
    assert t2r_config.query_parameter(
        'train_eval_model.steps_per_dispatch') == 8
  finally:
    t2r_config.clear_config()
