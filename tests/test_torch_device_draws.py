"""Port parity: the preprocessors' draws taken beforehand (``host_draws``)
and handed over on the device (``DeviceDraws``), as a K-step dispatch
hands them over (``steps_per_dispatch`` > 1).

For each preprocessor that draws in TRAIN, ``host_draws`` on one
generator followed by ``preprocess(..., DeviceDraws)`` gives bit for bit
what ``preprocess(..., generator)`` gives on a second generator from the
same seed, and the two generators end in the same state:

* ``DefaultVRGripperPreprocessor``: the crop with and without the resize
  (``crop_resize_at_device_offsets`` and ``crop_at_device_offsets``), with
  mixup on and off, with ``crop_offsets`` injected (no offsets drawn);
* ``FixedLenMetaExamplePreprocessor`` over it: one set of draws for the
  condition and the inference call;
* ``Grasp2VecPreprocessor``: the scene's and the goal's crops and the six
  flips, ten integers.

The crop-resize at device offsets is bit for bit ``crop_resize_images`` at
the same host offsets, and within 1e-3 of the JAX ``crop_resize_images``
on values up to 255 (``tests/test_torch_vrgripper.py``'s band). Every
preprocessor draws the same count each step (the trainer's draws tensor
is [K, width]).

About 7 s alone on the CPU, 15 s with the imports.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.preprocessors import (
    image_transformations as jax_transforms)
from tensor2robot_tpu_torch.meta_learning import preprocessors as meta
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.preprocessors import image_transformations
from tensor2robot_tpu_torch.preprocessors.base import DeviceDraws
from tensor2robot_tpu_torch.research.grasp2vec import (Grasp2VecModel,
                                                       Grasp2VecPreprocessor)
from tensor2robot_tpu_torch.research.vrgripper import (
    DefaultVRGripperPreprocessor, VRGripperEnvSequentialModel)

SOURCE = (30, 40)
CROP = (24, 32)


def _torch_batch(spec, rng, batch=3):
  """Seeded tensors in ``spec``'s shapes: uint8 frames, float32 values."""
  out = {}
  for key, value in spec.items():
    shape = (batch,) + tuple(1 if d is None else d for d in value.shape)
    if 'uint8' in str(value.dtype):
      out[key] = torch.from_numpy(rng.randint(0, 256, shape).astype(np.uint8))
    else:
      out[key] = torch.from_numpy(rng.randn(*shape).astype(np.float32))
  return out


def _vrgripper(mixup_alpha, crop_offsets, resize):
  """The vrgripper preprocessor at small sizes: 30x40 frames cropped to
  24x32, resized to 12x16 (or taken at the crop's size)."""
  model = VRGripperEnvSequentialModel(
      episode_length=4, image_size=(12, 16) if resize else CROP)
  return DefaultVRGripperPreprocessor(
      src_img_res=SOURCE, crop_size=CROP, mixup_alpha=mixup_alpha,
      crop_offsets=crop_offsets,
      model_feature_specification_fn=model._episode_feature_specification,  # pylint: disable=protected-access
      model_label_specification_fn=model._episode_label_specification)  # pylint: disable=protected-access


def _both_ways(pre, features, labels, seed):
  """(the generator's result, the device draws' result, the draws), each
  from a generator seeded ``seed``; asserts the generators end alike."""
  drawn = torch.Generator().manual_seed(seed)
  want = pre.preprocess(dict(features), None if labels is None else
                        dict(labels), ModeKeys.TRAIN, drawn)
  ahead = torch.Generator().manual_seed(seed)
  draws = pre.host_draws(ahead)
  values = torch.tensor([] if draws is None else draws, dtype=torch.int64)
  got = pre.preprocess(dict(features), None if labels is None else
                       dict(labels), ModeKeys.TRAIN, DeviceDraws(values))
  assert torch.equal(drawn.get_state(), ahead.get_state())
  return want, got, draws


def _assert_bitwise(want, got):
  for w, g in zip(want, got):
    assert (w is None) == (g is None)
    if w is None:
      continue
    assert set(w) == set(g)
    for key in w:
      assert w[key].dtype == g[key].dtype, key
      assert torch.equal(w[key], g[key]), key


# ------------------------------------------------------ the crop-resize


@pytest.mark.parametrize('offsets', [(0, 0), (20, 20), (7, 13), (3, 19)])
def test_crop_resize_at_device_offsets_is_the_host_crop_resize(offsets):
  """220x300 uint8 -> 200x280 crop -> 100x100: bit for bit the host
  offsets' result, and within 1e-3 of the JAX function (float32 sums of
  200 and 280 terms, reassociated)."""
  images = np.random.RandomState(1).randint(
      0, 256, (2, 220, 300, 3)).astype(np.uint8)
  frames = torch.from_numpy(images)
  host = image_transformations.crop_resize_images(
      offsets[0], offsets[1], frames, (200, 280), (100, 100))
  device = image_transformations.crop_resize_at_device_offsets(
      frames, (200, 280), (100, 100), torch.tensor(offsets))
  assert device.dtype == torch.float32 and device.shape == (2, 100, 100, 3)
  assert torch.equal(host, device)
  want = jax_transforms.crop_resize_images(
      offsets[0], offsets[1], jnp.asarray(images), (200, 280), (100, 100))
  np.testing.assert_allclose(device.numpy(), np.asarray(want), rtol=0,
                             atol=1e-3)


# ------------------------------------------------- the preprocessors


@pytest.mark.parametrize('resize', [True, False])
@pytest.mark.parametrize('crop_offsets', [None, (3, 2)])
@pytest.mark.parametrize('mixup_alpha', [0.0, 0.4])
def test_vrgripper_device_draws_are_the_generator_draws(mixup_alpha,
                                                        crop_offsets, resize):
  pre = _vrgripper(mixup_alpha, crop_offsets, resize)
  rng = np.random.RandomState(2)
  features = _torch_batch(pre.get_in_feature_specification(ModeKeys.TRAIN),
                          rng)
  labels = _torch_batch(pre.get_in_label_specification(ModeKeys.TRAIN), rng)
  for seed in range(3):
    want, got, draws = _both_ways(pre, features, labels, seed)
    _assert_bitwise(want, got)
    width = (0 if crop_offsets else 2) + (2 if mixup_alpha else 0)
    assert (draws is None) == (width == 0)
    assert width == 0 or len(draws) == width
  if mixup_alpha:  # the mix moved the images and the labels
    unmixed = _vrgripper(0.0, crop_offsets, resize)
    plain = unmixed.preprocess(dict(features), dict(labels), ModeKeys.TRAIN,
                               torch.Generator().manual_seed(0))
    assert not torch.equal(plain[1]['action'], want[1]['action'])


@pytest.mark.parametrize('mixup_alpha', [0.0, 0.4])
def test_meta_wrapper_takes_one_set_of_draws_for_both_calls(mixup_alpha):
  """The meta preprocessor over vrgripper: host_draws is the base's, taken
  once, and the condition and inference calls both take it, as at K=1
  they replay one generator state (so both episodes see the same crop)."""
  base = _vrgripper(mixup_alpha, None, True)
  pre = meta.FixedLenMetaExamplePreprocessor(base_preprocessor=base)
  rng = np.random.RandomState(3)
  features = _torch_batch(pre.get_in_feature_specification(ModeKeys.TRAIN),
                          rng)
  labels = _torch_batch(pre.get_in_label_specification(ModeKeys.TRAIN), rng)
  for seed in range(3):
    want, got, draws = _both_ways(pre, features, labels, seed)
    _assert_bitwise(want, got)
    assert draws == base.host_draws(torch.Generator().manual_seed(seed))
  # Both calls cropped at the same offsets: equal frames in, equal out.
  same = dict(features)
  same['inference/features/image/0'] = same['condition/features/image/0']
  out, _ = pre.preprocess(same, dict(labels), ModeKeys.TRAIN, DeviceDraws(
      torch.tensor(base.host_draws(torch.Generator().manual_seed(9)))))
  if not mixup_alpha:
    assert torch.equal(out['condition/features/image'],
                       out['inference/features/image'])


def _grasp2vec_frames(seed, batch=1):
  rng = np.random.RandomState(seed)
  return {key: torch.from_numpy(rng.randint(0, 256, (batch, 512, 640, 3),
                                            dtype=np.uint8))
          for key in Grasp2VecPreprocessor.IMAGE_KEYS}


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_grasp2vec_device_draws_are_the_generator_draws(seed):
  """The scene and goal crops at device offsets and the six flips taken
  by a select: bit for bit the generator's crops and flips."""
  pre = Grasp2VecModel(device_type='cpu').preprocessor
  want, got, draws = _both_ways(pre, _grasp2vec_frames(seed), None, seed)
  _assert_bitwise(want, got)
  augmentation = pre.draw_augmentation(torch.Generator().manual_seed(seed),
                                       ModeKeys.TRAIN)
  assert draws == list(augmentation.scene + augmentation.goal) + [
      int(f) for pair in augmentation.flips for f in pair]


def test_grasp2vec_device_flips_cover_every_pair():
  """Over seeds whose draws take each (left-right, up-down) pair on some
  image, the device select equals the host flip."""
  pre = Grasp2VecModel(device_type='cpu').preprocessor
  frames = _grasp2vec_frames(7)
  seen = set()
  for seed in range(8):
    draws = pre.host_draws(torch.Generator().manual_seed(seed))
    seen.update(zip(draws[4::2], draws[5::2]))
    want, got, _ = _both_ways(pre, frames, None, seed)
    _assert_bitwise(want, got)
  assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


@pytest.mark.parametrize('which', ['vrgripper', 'vrgripper_mixup', 'meta',
                                   'grasp2vec'])
def test_host_draws_take_the_same_count_every_step(which):
  """The trainer stacks K steps' draws into one int64 [K, width] tensor:
  the width may not depend on the values drawn."""
  if which == 'grasp2vec':
    pre, width = Grasp2VecModel(device_type='cpu').preprocessor, 10
  elif which == 'meta':
    pre = meta.FixedLenMetaExamplePreprocessor(
        base_preprocessor=_vrgripper(0.4, None, True))
    width = 4
  else:
    mixup = 0.4 if which == 'vrgripper_mixup' else 0.0
    pre, width = _vrgripper(mixup, None, True), 2 + (2 if mixup else 0)
  generator = torch.Generator().manual_seed(11)
  rows = [pre.host_draws(generator) for _ in range(50)]
  assert {len(row) for row in rows} == {width}
  assert torch.tensor(rows, dtype=torch.int64).shape == (50, width)


@pytest.mark.parametrize('distortion', ['random_brightness',
                                        'random_saturation', 'random_hue',
                                        'random_contrast'])
def test_photometric_distortions_under_device_draws_raise(distortion):
  """The photometric chain draws per image within the step and has no
  host draws yet: under ``DeviceDraws`` an enabled distortion raises,
  citing its ROADMAP item, and with every distortion off only the clip
  runs (QT-Opt's default)."""
  images = torch.rand(2, 4, 4, 3) * 1.5
  draws = DeviceDraws(torch.zeros(2, dtype=torch.int64))
  with pytest.raises(NotImplementedError, match='queue 1 item 12'):
    image_transformations.apply_photometric_image_distortions(
        images, draws, **{distortion: True})
  assert torch.equal(
      image_transformations.apply_photometric_image_distortions(images,
                                                                draws),
      torch.clamp(images, 0.0, 1.0))
