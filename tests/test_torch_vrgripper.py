"""Port parity: the SNAIL meta-learners of ``research/vrgripper``.

Preprocessing (``crop_resize_images`` and its resize matrices,
``DefaultVRGripperPreprocessor`` with the JAX package's crop offsets
injected), the meta spec transforms, ``pack_vrgripper_meta_features``,
both models' forward in TRAIN (flash: the JAX side's Pallas kernels in
interpret mode, the port's plain versions) and PREDICT (the JAX side
dense, the port's flash forward, which serving exports), the dtype
that reaches the attention kernels, and the port's ``Trainer`` against the
JAX ``Trainer`` over 1 and 3 steps.

Small sizes: episode_length 8 (T = 16), 48×48 images, long-horizon 2 heads
of 8. Bands are stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_weights import random_variables

from tensor2robot_tpu.layers import snail as jax_snail
from tensor2robot_tpu.meta_learning import preprocessors as jax_meta
from tensor2robot_tpu.modes import ModeKeys as JaxModeKeys
from tensor2robot_tpu.ops import flash_attention as jax_fa
from tensor2robot_tpu.preprocessors import (
    image_transformations as jax_transforms)
from tensor2robot_tpu.research.vrgripper import (
    DefaultVRGripperPreprocessor as JaxVRGripperPreprocessor)
from tensor2robot_tpu.research.vrgripper import (
    VRGripperEnvLongHorizonModel as JaxLongHorizon)
from tensor2robot_tpu.research.vrgripper import (
    VRGripperEnvSequentialModel as JaxSequential)
from tensor2robot_tpu.research.vrgripper import (
    VRGripperEnvTecModel as JaxTec)
from tensor2robot_tpu.research.vrgripper import (
    pack_vrgripper_meta_features as jax_pack)
from tensor2robot_tpu.train.trainer import Trainer as JaxTrainer
from tensor2robot_tpu.train.trainer import TrainerCallback
from tensor2robot_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from tensor2robot_tpu_torch.layers import snail
from tensor2robot_tpu_torch.meta_learning import preprocessors as meta
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.ops import flash_attention as fa
from tensor2robot_tpu_torch.preprocessors import image_transformations
from tensor2robot_tpu_torch.research.vrgripper import (
    DefaultVRGripperPreprocessor, VRGripperEnvLongHorizonModel,
    VRGripperEnvSequentialModel, VRGripperEnvTecModel,
    pack_vrgripper_meta_features)
from tensor2robot_tpu_torch.train import Trainer, TrainerConfig
from tensor2robot_tpu_torch.utils import convert

EPISODE = 8
IMAGE = (48, 48)
BATCH = 2
STEPS = 3
LONG_HORIZON = dict(num_attention_heads=2, attention_head_size=8)
MODELS = {'sequential': (JaxSequential, VRGripperEnvSequentialModel, {}),
          'long_horizon': (JaxLongHorizon, VRGripperEnvLongHorizonModel,
                           LONG_HORIZON)}


@pytest.fixture(name='force_flash')
def _force_flash(monkeypatch):
  """The auto flash gates on, as the JAX tests force theirs."""
  monkeypatch.setattr(jax_snail, '_flash_auto_ok', lambda: True)
  monkeypatch.setattr(snail, '_flash_auto_ok', lambda x: True)


# ------------------------------------------------------- preprocessing


@pytest.mark.parametrize('crop,target', [((200, 100), None), ((280, 100), None),
                                         ((60, 48), None)])
def test_resize_weights_match_jax_image_resize(crop, target):
  """The [target, crop] matrices of ``jax.image.resize`` of an identity,
  antialiased on downscale, within 1e-6 (the model's 200→100 and 280→100
  and the tests' 60→48)."""
  del target
  size, out = crop
  want = np.asarray(jax.image.resize(jnp.eye(size, dtype=jnp.float32),
                                     (out, size), 'bilinear'))
  got = image_transformations.resize_weights(size, out)
  assert got.shape == want.shape == (out, size)
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize('offsets', [None, (0, 0), (20, 20), (7, 13)])
def test_crop_resize_images_matches_jax(offsets):
  """Center crop (None) and injected offsets, 220×300 uint8 → 200×280 →
  100×100, float32 in the input's units: within 1e-3 of values up to 255
  (float32 sums of 200 and 280 terms, reassociated)."""
  images = np.random.RandomState(0).randint(
      0, 256, (3, 220, 300, 3)).astype(np.uint8)
  oy, ox = offsets if offsets is not None else ((220 - 200) // 2,
                                                (300 - 280) // 2)
  got = image_transformations.crop_resize_images(
      oy, ox, torch.from_numpy(images), (200, 280), (100, 100))
  want = jax_transforms.crop_resize_images(oy, ox, jnp.asarray(images),
                                           (200, 280), (100, 100))
  assert got.dtype == torch.float32 and got.shape == (3, 100, 100, 3)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)


def _episode_specs(episode, image, cls=VRGripperEnvTecModel):
  model = cls(episode_length=episode, image_size=image)
  return (model._episode_feature_specification,  # pylint: disable=protected-access
          model._episode_label_specification)  # pylint: disable=protected-access


def _jax_offsets(rng, h=220, w=300, crop=(200, 280)):
  """The offsets the JAX preprocessor draws from ``rng`` in TRAIN."""
  crop_rng, _ = jax.random.split(rng)
  rng_h, rng_w = jax.random.split(crop_rng)
  return (int(jax.random.randint(rng_h, (), 0, h - crop[0] + 1)),
          int(jax.random.randint(rng_w, (), 0, w - crop[1] + 1)))


@pytest.mark.parametrize('mode', [ModeKeys.TRAIN, ModeKeys.PREDICT])
def test_vrgripper_preprocessor_matches_jax(mode):
  """TRAIN takes the JAX package's offsets (drawn from its key, injected
  here); PREDICT the centre crop. Images within 1e-5 of values in [0, 1];
  poses and actions pass through unchanged."""
  feature_fn, label_fn = _episode_specs(4, (100, 100))
  rng = np.random.RandomState(1)
  features = {'image': rng.randint(0, 256, (2, 4, 220, 300, 3)).astype(
      np.uint8), 'gripper_pose': rng.randn(2, 4, 14).astype(np.float32)}
  labels = {'action': rng.randn(2, 4, 7).astype(np.float32)}
  key = jax.random.PRNGKey(3)
  jax_feature_fn, jax_label_fn = _episode_specs(4, (100, 100), JaxTec)
  jax_pre = JaxVRGripperPreprocessor(
      model_feature_specification_fn=jax_feature_fn,
      model_label_specification_fn=jax_label_fn)
  want, want_labels = jax_pre.preprocess(
      dict(features), dict(labels), mode, key)
  offsets = _jax_offsets(key) if mode == ModeKeys.TRAIN else None
  pre = DefaultVRGripperPreprocessor(
      model_feature_specification_fn=feature_fn,
      model_label_specification_fn=label_fn, crop_offsets=offsets)
  got, got_labels = pre.preprocess(
      {k: torch.from_numpy(v) for k, v in features.items()},
      {k: torch.from_numpy(v) for k, v in labels.items()}, mode,
      torch.Generator().manual_seed(0))
  assert set(got) == set(want)
  np.testing.assert_allclose(got['image'].numpy(), np.asarray(want['image']),
                             rtol=0, atol=1e-5)
  np.testing.assert_array_equal(got['gripper_pose'].numpy(),
                                np.asarray(want['gripper_pose']))
  np.testing.assert_array_equal(got_labels['action'].numpy(),
                                np.asarray(want_labels['action']))


def test_training_crop_draws_one_offset_pair_from_the_generator():
  feature_fn, label_fn = _episode_specs(2, (100, 100))
  frames = torch.from_numpy(np.random.RandomState(2).randint(
      0, 256, (2, 2, 220, 300, 3)).astype(np.uint8))
  pre = DefaultVRGripperPreprocessor(
      model_feature_specification_fn=feature_fn,
      model_label_specification_fn=label_fn)
  out, _ = pre.preprocess({'image': frames,
                           'gripper_pose': torch.zeros(2, 2, 14)}, None,
                          ModeKeys.TRAIN, torch.Generator().manual_seed(5))
  generator = torch.Generator().manual_seed(5)
  oy = int(torch.randint(0, 21, (), generator=generator))
  ox = int(torch.randint(0, 21, (), generator=generator))
  want = image_transformations.crop_resize_images(
      oy, ox, frames.reshape(4, 220, 300, 3), (200, 280), (100, 100)) / 255.0
  torch.testing.assert_close(out['image'], want.reshape(2, 2, 100, 100, 3))


# ------------------------------------------------------------ the specs


def _spec_table(spec):
  return {key: (tuple(value.shape), np.dtype(str(value.dtype).replace(
      'torch.', '')).name, value.name) for key, value in spec.items()}


@pytest.mark.parametrize('mode', [ModeKeys.TRAIN, ModeKeys.PREDICT])
@pytest.mark.parametrize('name', sorted(MODELS))
def test_meta_specs_match_jax(name, mode):
  """Names, shapes and dtypes of every key: the model's specs and its
  preprocessor's in and out specs (condition/inference with the samples
  dim, MetaExample ``<prefix>_ep<i>/<name>`` columns)."""
  jax_cls, cls, kwargs = MODELS[name]
  kwargs = dict(kwargs, episode_length=EPISODE, image_size=IMAGE)
  jax_model, model = jax_cls(**kwargs), cls(**kwargs)
  pairs = [(jax_model.get_feature_specification(mode),
            model.get_feature_specification(mode)),
           (jax_model.get_label_specification(mode),
            model.get_label_specification(mode))]
  for fn in ('get_in_feature_specification', 'get_in_label_specification',
             'get_out_feature_specification', 'get_out_label_specification'):
    pairs.append((getattr(jax_model.preprocessor, fn)(mode),
                  getattr(model.preprocessor, fn)(mode)))
  for want, got in pairs:
    assert _spec_table(got) == _spec_table(want)


def test_meta_spec_functions_match_jax():
  feature_fn, label_fn = _episode_specs(3, IMAGE)
  jax_feature_fn, jax_label_fn = _episode_specs(3, IMAGE, JaxTec)
  mode = ModeKeys.TRAIN
  assert _spec_table(meta.create_maml_feature_spec(
      feature_fn(mode), label_fn(mode))) == _spec_table(
          jax_meta.create_maml_feature_spec(jax_feature_fn(mode),
                                            jax_label_fn(mode)))
  assert _spec_table(meta.create_maml_label_spec(label_fn(mode))) == (
      _spec_table(jax_meta.create_maml_label_spec(jax_label_fn(mode))))
  assert _spec_table(meta.create_metaexample_spec(
      feature_fn(mode), 2, 'condition')) == _spec_table(
          jax_meta.create_metaexample_spec(jax_feature_fn(mode), 2,
                                           'condition'))
  episodes = {f'image/{i}': torch.full((2, 3), float(i)) for i in range(2)}
  stacked = meta.stack_intra_task_episodes(episodes, 2)
  assert stacked['image'].shape == (2, 2, 3)
  assert bool((stacked['image'][:, 1] == 1).all())


def test_pack_features_matches_jax():
  rng = np.random.RandomState(4)
  image = rng.rand(*IMAGE, 3).astype(np.float32)
  pose = rng.randn(14).astype(np.float32)
  episode = [((rng.rand(*IMAGE, 3), rng.randn(14)), rng.randn(7), 1.0, None,
              False, {}) for _ in range(5)]
  for prev in ([episode], None):
    got = pack_vrgripper_meta_features((image, pose), prev, 0, EPISODE, 2)
    want = jax_pack((image, pose), prev, 0, EPISODE, 2)
    assert set(got) == set(want)
    for key in want:
      np.testing.assert_array_equal(got[key], want[key], err_msg=key)
  model = VRGripperEnvSequentialModel(episode_length=EPISODE,
                                      image_size=IMAGE)
  current = model.pack_features((image, pose), [episode], 0)
  current['inference/features/image/0'][0, :3] = 0.5
  spliced = model.pack_features((image, pose), [episode], 3, current)
  assert bool((spliced['inference/features/image/0'][0, :3] == 0.5).all())
  assert bool((spliced['inference/features/image/0'][0, 3:] == image).all())


# -------------------------------------------------------------- forward


def _features(jax_model, seed=0):
  spec = jax_model.preprocessor.get_out_feature_specification(
      JaxModeKeys.TRAIN)
  rng = np.random.RandomState(seed)
  return {key: rng.rand(BATCH, *[1 if d is None else d
                                 for d in value.shape]).astype(np.float32)
          for key, value in spec.items()}


def _carried(name, seed=1):
  jax_cls, cls, kwargs = MODELS[name]
  kwargs = dict(kwargs, episode_length=EPISODE, image_size=IMAGE,
                device_type='cpu')
  jax_model, model = jax_cls(**kwargs), cls(**kwargs)
  features = _features(jax_model)
  shapes = jax.eval_shape(lambda: jax_model.init_variables(
      jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in features.items()}))
  variables = random_variables(shapes, seed=seed)
  network = model.create_module()
  network.load_state_dict(convert.snail_variables_to_torch(variables),
                          strict=True)
  return jax_model, model, variables, network, features


@pytest.mark.parametrize('mode', [ModeKeys.TRAIN, ModeKeys.PREDICT])
@pytest.mark.parametrize('name', sorted(MODELS))
def test_forward_matches_jax(force_flash, monkeypatch, name, mode):
  """TRAIN runs the flash path on both sides. In PREDICT the JAX model
  pins the dense form (its flash entry raises if reached) and the port
  takes the flash forward on every device (the custom op an exported
  program holds), once per attention block; ``inference_output`` within
  2e-5."""
  del force_flash
  jax_model, model, variables, network, features = _carried(name)
  calls = []
  if mode == ModeKeys.PREDICT:
    def boom(*args, **kwargs):
      raise AssertionError('flash_attention reached in PREDICT')
    monkeypatch.setattr(jax_fa, 'flash_attention', boom)
    monkeypatch.setattr(snail, '_flash_auto_ok', lambda x: False)

    def counted(*args, fn=fa.flash_attention, **kwargs):
      calls.append(args[0].shape)
      return fn(*args, **kwargs)
    monkeypatch.setattr(fa, 'flash_attention', counted)
  want, _ = jax_model.inference_network_fn(
      variables, {k: jnp.asarray(v) for k, v in features.items()}, None, mode)
  got = model.inference_network_fn(
      network, {k: torch.from_numpy(v) for k, v in features.items()}, None,
      mode)
  assert set(got) == set(want)
  out = got['inference_output']
  assert out.shape == (BATCH, 1, EPISODE, 7)
  assert len(calls) == (2 if mode == ModeKeys.PREDICT else 0)
  np.testing.assert_allclose(out.detach().numpy(),
                             np.asarray(want['inference_output']), rtol=0,
                             atol=2e-5)


@pytest.mark.parametrize('name', sorted(MODELS))
def test_attention_kernels_see_float32(force_flash, monkeypatch, name):
  """At the models' default device types (the JAX package's 'tpu', the
  port's 'gpu') the meta preprocessor applies no bfloat16 policy, so the
  flash kernels are fed float32 q, k, v on both sides."""
  del force_flash
  jax_cls, cls, kwargs = MODELS[name]
  kwargs = dict(kwargs, episode_length=EPISODE, image_size=IMAGE)
  jax_model, model = jax_cls(**kwargs), cls(**kwargs)
  seen = {'jax': [], 'torch': []}
  jax_real, real = jax_fa.flash_attention, fa.flash_attention

  def jax_spy(q, *args, **kwargs):
    seen['jax'].append(q.dtype)
    return jax_real(q, *args, **kwargs)

  def spy(q, *args, **kwargs):
    seen['torch'].append(q.dtype)
    return real(q, *args, **kwargs)

  monkeypatch.setattr(jax_fa, 'flash_attention', jax_spy)
  monkeypatch.setattr(fa, 'flash_attention', spy)
  features = _features(jax_model)
  variables = jax_model.init_variables(
      jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in features.items()})
  jax_model.inference_network_fn(
      variables, {k: jnp.asarray(v) for k, v in features.items()}, None,
      JaxModeKeys.TRAIN)
  network = model.create_module()
  model.init_network(network, torch.Generator().manual_seed(0))
  model.inference_network_fn(
      network, {k: torch.from_numpy(v) for k, v in features.items()}, None,
      ModeKeys.TRAIN)
  assert seen['jax'] == [jnp.float32] * 2
  assert seen['torch'] == [torch.float32] * 2


def test_what_is_not_ported_yet_raises():
  with pytest.raises(NotImplementedError, match='MDN'):
    VRGripperEnvSequentialModel(num_mixture_components=3)
  with pytest.raises(NotImplementedError, match='queue 1 item 9'):
    VRGripperEnvTecModel().create_module()
  model = VRGripperEnvLongHorizonModel()

  class Mesh:
    shape = {'data': 1, 'seq': 4}

  with pytest.raises(NotImplementedError, match='queue 1 item 10'):
    model.set_mesh(Mesh())
  model.set_mesh(None)


# -------------------------------------------------------------- trainer


class _PortPreprocessorModel:
  """Mixin: source frames equal to the crop (60×60 → 48×48), so every
  random crop offset is 0 in both packages and no random stream has to be
  shared."""

  @property
  def preprocessor(self):
    base = DefaultVRGripperPreprocessor(
        src_img_res=(60, 60), crop_size=(60, 60),
        model_feature_specification_fn=self._episode_feature_specification,
        model_label_specification_fn=self._episode_label_specification)
    return meta.FixedLenMetaExamplePreprocessor(base_preprocessor=base)


class _JaxPreprocessorModel:

  @property
  def preprocessor(self):
    base = JaxVRGripperPreprocessor(
        src_img_res=(60, 60), crop_size=(60, 60),
        model_feature_specification_fn=self._episode_feature_specification,
        model_label_specification_fn=self._episode_label_specification)
    return jax_meta.FixedLenMetaExamplePreprocessor(base_preprocessor=base)


class _JaxModel(_JaxPreprocessorModel, JaxSequential):
  pass


class _PortModel(_PortPreprocessorModel, VRGripperEnvSequentialModel):
  pass


def _batches(seed=0, count=STEPS):
  rng = np.random.RandomState(seed)
  batches = []
  for _ in range(count):
    features = {}
    for prefix in ('condition', 'inference'):
      features[f'{prefix}/features/image/0'] = rng.randint(
          0, 256, (BATCH, EPISODE, 60, 60, 3)).astype(np.uint8)
      features[f'{prefix}/features/gripper_pose/0'] = rng.randn(
          BATCH, EPISODE, 14).astype(np.float32)
    features['condition/labels/action/0'] = rng.randn(
        BATCH, EPISODE, 7).astype(np.float32)
    labels = {'action/0': rng.randn(BATCH, EPISODE, 7).astype(np.float32)}
    batches.append((features, labels))
  return batches


def _trainer_variables():
  jax_model = _JaxModel(episode_length=EPISODE, image_size=IMAGE,
                        device_type='cpu')
  features = _features(jax_model)
  shapes = jax.eval_shape(lambda: jax_model.init_variables(
      jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in features.items()}))
  return random_variables(shapes, seed=2)


class _Snapshots(TrainerCallback):

  def __init__(self):
    self.by_step = {}

  def after_step(self, trainer, step, scalars):
    self.by_step[step] = ({k: float(v) for k, v in scalars.items()},
                          jax.device_get(dict(trainer.state.variables)))


@pytest.fixture(scope='module', name='jax_run')
def _jax_run():
  """The JAX trainer, STEPS steps of default Adam, flash forced on."""
  variables = _trainer_variables()
  model = _JaxModel(episode_length=EPISODE, image_size=IMAGE,
                    device_type='cpu',
                    init_from_checkpoint_fn=lambda params, state: (
                        variables['params'], {}))
  snapshots = _Snapshots()
  trainer = JaxTrainer(
      model, JaxTrainerConfig(model_dir='', max_train_steps=STEPS,
                              eval_interval_steps=0, log_interval_steps=0),
      callbacks=[snapshots])
  with pytest.MonkeyPatch.context() as patch:
    patch.setattr(jax_snail, '_flash_auto_ok', lambda: True)
    trainer.train(iter(_batches()), None)
  return variables, snapshots.by_step


@pytest.mark.parametrize('steps', [1, STEPS])
def test_trainer_matches_jax(force_flash, jax_run, steps):
  """The port's Trainer (flash plain versions on the CPU) against the JAX
  Trainer, from the same weights on the same batches.

  Band: the loss within 2e-5. Each parameter's change since the start
  within 2·lr + 4 float32 ulps of the parameter per element: Adam's first
  step moves an element by lr·g/(|g| + eps), about ±lr whatever |g|, so an
  element whose gradient is near 0 can flip sign between two float32
  computations and move by up to 2·lr the other way. Across each leaf, the
  changes agree to 1e-2 relative L2, except on two kinds of leaf whose
  gradient is 0 but for rounding, which Adam turns into changes of no
  common direction: the attention blocks' key biases (softmax is invariant
  to a constant added to a query's logits) and the tower's final LayerNorm
  bias (the spatial softmax is invariant to a constant added to a
  channel)."""
  del force_flash
  variables, by_step = jax_run
  model = _PortModel(
      episode_length=EPISODE, image_size=IMAGE, device_type='cpu',
      init_from_checkpoint_fn=lambda network: network.load_state_dict(
          convert.snail_variables_to_torch(variables)))
  trainer = Trainer(model, TrainerConfig(max_train_steps=steps,
                                         log_interval_steps=0), device='cpu')
  scalars = trainer.train(iter(_batches()))
  assert trainer.step == steps
  want_scalars, want_vars = by_step[steps]
  assert set(scalars) == {'loss', 'bc_loss'}
  np.testing.assert_allclose(scalars['loss'], want_scalars['loss'], rtol=0,
                             atol=2e-5)
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
    if not name.endswith(('key.bias', 'final_norm.bias')):
      assert float((change - want_change).norm()) <= 1e-2 * float(
          want_change.norm()), name
