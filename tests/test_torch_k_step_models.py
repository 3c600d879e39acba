"""Port parity: SNAIL and Grasp2Vec at K optimizer steps per dispatch.

On the CPU a dispatch is the K device-form steps run eagerly (on the card
the same steps are one captured CUDA graph replay, held bit for bit to K=1
by ``chip_smoke.py``'s ``phase_dispatch_models``). The preprocessors' draws
are taken beforehand (``host_draws``) and handed over on the device
(``DeviceDraws``):

* the tiny SNAIL models (sequential, with and without mixup, and
  long-horizon with 2 heads of 8; episode 8, 64x64 frames cropped at
  random offsets to 60x60 and resized to 48x48; the flash path forced, so
  its plain versions run) at K=2 over 4 batches and at K=3 over 4 (a
  ragged tail of 1), bit for bit the K=1 run: parameters, Adam moments and
  groups, generator state and step;
* a NaN slice under ``nonfinite_mode='skip_update'`` (the stock and the
  fused Adam arm): the skipped step's draws go to the next step, bit for
  bit the K=1 guarded run;
* the tiny Grasp2Vec trainer (ResNet-18 towers at 64 px, batch 2) at K=2
  and at K=3 with a ragged tail, bit for bit K=1;
* the port's SNAIL trainer at K=2 against the JAX trainer at K=2 from the
  same weights (``utils/convert.snail_variables_to_torch``), in
  ``tests/test_torch_vrgripper.py::test_trainer_matches_jax``'s band.

About 85 s alone on the CPU (110 s with the imports): 40 s the JAX K=2
trainer, which interprets its Pallas kernels, 35 s the Grasp2Vec steps.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.layers import snail as jax_snail
from tensor2robot_tpu.train.trainer import Trainer as JaxTrainer
from tensor2robot_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from tensor2robot_tpu_torch.layers import snail
from tensor2robot_tpu_torch.meta_learning import preprocessors as meta
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.research.grasp2vec import Grasp2VecModel
from tensor2robot_tpu_torch.research.vrgripper import (
    DefaultVRGripperPreprocessor, VRGripperEnvLongHorizonModel,
    VRGripperEnvSequentialModel)
from tensor2robot_tpu_torch.train import Trainer, TrainerConfig
from tensor2robot_tpu_torch.utils import convert
from test_torch_grasp2vec import _frame_batches, _tiny_crop_model
from test_torch_steps_per_dispatch import assert_state_bitwise
from test_torch_vrgripper import (EPISODE, IMAGE, LONG_HORIZON, _JaxModel,
                                  _PortModel, _Snapshots, _trainer_variables)
from test_torch_vrgripper import _batches as flat_crop_batches

BATCH = 2
FRAME = (64, 64)
CROP = (60, 60)
SNAIL_CASES = (('sequential', 0.0), ('sequential', 0.4),
               ('long_horizon', 0.0))
K_CASES = ((2, 4), (3, 4))


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(name='force_flash')
def _force_flash(monkeypatch):
  """The SNAIL attention through the flash path (its plain versions on
  the CPU), as on the card."""
  monkeypatch.setattr(snail, '_flash_auto_ok', lambda x: True)
  monkeypatch.setattr(jax_snail, '_flash_auto_ok', lambda: True)


def _snail_model(name, mixup_alpha, **kwargs):
  """A tiny SNAIL model whose 64x64 frames take a random 60x60 crop
  (offsets drawn in TRAIN) resized to 48x48, with mixup at
  ``mixup_alpha``."""
  base_cls = (VRGripperEnvSequentialModel if name == 'sequential' else
              VRGripperEnvLongHorizonModel)

  class Cropped(base_cls):

    @property
    def preprocessor(self):
      base = DefaultVRGripperPreprocessor(
          src_img_res=FRAME, crop_size=CROP, mixup_alpha=mixup_alpha,
          model_feature_specification_fn=self._episode_feature_specification,
          model_label_specification_fn=self._episode_label_specification)
      return meta.FixedLenMetaExamplePreprocessor(base_preprocessor=base)

  extra = LONG_HORIZON if name == 'long_horizon' else {}
  return Cropped(episode_length=EPISODE, image_size=IMAGE, device_type='cpu',
                 **extra, **kwargs)


def _snail_batches(count, seed=0):
  rng = np.random.RandomState(seed)
  batches = []
  for _ in range(count):
    features = {}
    for prefix in ('condition', 'inference'):
      features[f'{prefix}/features/image/0'] = rng.randint(
          0, 256, (BATCH, EPISODE) + FRAME + (3,)).astype(np.uint8)
      features[f'{prefix}/features/gripper_pose/0'] = rng.randn(
          BATCH, EPISODE, 14).astype(np.float32)
    features['condition/labels/action/0'] = rng.randn(
        BATCH, EPISODE, 7).astype(np.float32)
    batches.append((features, {'action/0': rng.randn(
        BATCH, EPISODE, 7).astype(np.float32)}))
  return batches


def _train(model, batches, k, max_steps=None, **cfg):
  trainer = Trainer(model, TrainerConfig(
      max_train_steps=len(batches) if max_steps is None else max_steps,
      log_interval_steps=0, steps_per_dispatch=k, **cfg), device='cpu')
  trainer.train(iter(batches))
  return trainer


# --------------------------------------------------------------- SNAIL


@pytest.mark.parametrize('k,steps', K_CASES)
@pytest.mark.parametrize('name,mixup_alpha', SNAIL_CASES)
def test_snail_k_steps_are_bitwise_k_single_steps(force_flash, name,
                                                  mixup_alpha, k, steps):
  del force_flash
  batches = _snail_batches(steps)
  single = _train(_snail_model(name, mixup_alpha), batches, 1)
  grouped = _train(_snail_model(name, mixup_alpha), batches, k)
  assert single.step == grouped.step == steps
  assert_state_bitwise(single, grouped)
  # The draws moved the generator: the crop offsets were random.
  assert not torch.equal(grouped.state.generator.get_state(),
                         torch.Generator().manual_seed(0).get_state())


def _nanify(batch):
  features, labels = batch
  features = dict(features)
  pose = features['inference/features/gripper_pose/0'].copy()
  pose[1, 3, 0] = np.nan
  features['inference/features/gripper_pose/0'] = pose
  return features, labels


@pytest.mark.parametrize('fused', [False, True])
def test_snail_nan_slice_skips_exactly_its_own_update(force_flash, fused):
  """A NaN gripper pose in slot 1 of the first dispatch of 3: the update
  is skipped, the next step takes its crop and mixup draws, and the state
  is bit for bit the K=1 guarded run's."""
  del force_flash
  batches = _snail_batches(6, seed=4)
  batches[1] = _nanify(batches[1])
  cfg = dict(nonfinite_mode='skip_update', fused_update=fused)
  grouped = _train(_snail_model('sequential', 0.4), batches, 3, **cfg)
  single = _train(_snail_model('sequential', 0.4), batches, 1,
                  max_steps=6, **cfg)
  assert (grouped.fused_plan is not None) == fused
  assert grouped.nonfinite_policy.bad_steps == 1
  assert single.nonfinite_policy.bad_steps == 1
  assert grouped.step == single.step == 5
  assert_state_bitwise(single, grouped)


@functools.lru_cache(maxsize=None)
def _jax_k2_run(steps):
  """The JAX trainer at steps_per_dispatch=2 over ``steps`` batches of
  ``test_torch_vrgripper``'s model (source frames equal to the crop, so
  every crop offset is 0 in both packages), flash forced on."""
  variables = _trainer_variables()
  model = _JaxModel(episode_length=EPISODE, image_size=IMAGE,
                    device_type='cpu',
                    init_from_checkpoint_fn=lambda params, state: (
                        variables['params'], {}))
  snapshots = _Snapshots()
  trainer = JaxTrainer(
      model, JaxTrainerConfig(model_dir='', max_train_steps=steps,
                              eval_interval_steps=0, log_interval_steps=0,
                              steps_per_dispatch=2, prefetch_batches=0),
      callbacks=[snapshots])
  with pytest.MonkeyPatch.context() as patch:
    patch.setattr(jax_snail, '_flash_auto_ok', lambda: True)
    trainer.train(iter(flat_crop_batches(count=steps)), None)
  return variables, snapshots.by_step[steps]


def test_snail_k2_matches_the_jax_trainer_at_k2(force_flash):
  """The port's K=2 trainer against the JAX K=2 trainer over 4 batches, in
  ``test_trainer_matches_jax``'s band: the loss within 2e-5; each
  parameter's change within 2·lr + 4 float32 ulps per element and, but on
  the key biases and the final LayerNorm bias (gradient 0 but for
  rounding), 1e-2 relative L2."""
  del force_flash
  steps = 4
  variables, (want_scalars, want_vars) = _jax_k2_run(steps)
  model = _PortModel(
      episode_length=EPISODE, image_size=IMAGE, device_type='cpu',
      init_from_checkpoint_fn=lambda network: network.load_state_dict(
          convert.snail_variables_to_torch(variables)))
  trainer = Trainer(model, TrainerConfig(max_train_steps=steps,
                                         log_interval_steps=0,
                                         steps_per_dispatch=2), device='cpu')
  scalars = trainer.train(iter(flat_crop_batches(count=steps)))
  assert trainer.step == steps
  np.testing.assert_allclose(scalars['loss'], want_scalars['loss'], rtol=0,
                             atol=2e-5)
  start = convert.snail_variables_to_torch(variables)
  want = convert.snail_variables_to_torch(jax.device_get(want_vars))
  got = trainer.state.network.state_dict()
  assert set(got) == set(want)
  lr = 1e-4
  for name in want:
    change, want_change = got[name] - start[name], want[name] - start[name]
    assert not torch.equal(got[name], start[name]), name
    ulps = 4 * np.finfo(np.float32).eps * float(want[name].abs().max())
    assert float((change - want_change).abs().max()) <= 2 * lr + ulps, name
    if not name.endswith(('key.bias', 'final_norm.bias')):
      assert float((change - want_change).norm()) <= 1e-2 * float(
          want_change.norm()), name


# ----------------------------------------------------------- Grasp2Vec


@functools.lru_cache(maxsize=None)
def _grasp2vec_single(fused):
  return _train(_tiny_crop_model(Grasp2VecModel), _frame_batches(4, batch=2),
                1, fused_update=fused)


@pytest.mark.parametrize('k,fused', [(2, False), (3, False), (2, True)])
def test_grasp2vec_k_steps_are_bitwise_k_single_steps(k, fused):
  """ResNet-18 towers at 64 px, Adam (stock, or the fused update's plain
  version): K=2 over 4 batches and K=3 over 4 (3 + a ragged 1), every
  crop and flip drawn beforehand, bit for bit K=1."""
  single = _grasp2vec_single(fused)
  grouped = _train(_tiny_crop_model(Grasp2VecModel),
                   _frame_batches(4, batch=2), k, fused_update=fused)
  assert (grouped.fused_plan is not None) == fused
  assert isinstance(grouped.state.optimizer, optimizers.Adam)
  assert single.step == grouped.step == 4
  assert_state_bitwise(single, grouped)
