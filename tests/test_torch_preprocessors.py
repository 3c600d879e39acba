"""Port parity: the image crops and the photometric chain against the JAX
package.

The centre crop must equal the JAX one exactly. The random crop draws its
offset from a torch generator, which cannot reproduce JAX's threefry
stream, so it is held to the JAX semantics instead: one offset for the
whole batch, a window of the input, and the same crop from the same seed;
with injected offsets it equals the JAX crop at those offsets exactly.
The photometric chain's deterministic pieces (colour-space conversions and
each adjustment at given parameters) match the JAX functions within 1e-6
in float32; its random draws come from the generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.preprocessors import (
    image_transformations as jax_transforms)
from tensor2robot_tpu_torch.preprocessors import image_transformations

IMAGES = np.random.RandomState(0).randint(0, 256, (3, 20, 25, 3),
                                          dtype=np.uint8)


@pytest.mark.parametrize('target', [(12, 12), (20, 25), (7, 18)])
def test_center_crop_matches_jax(target):
  want = np.asarray(jax_transforms.center_crop_images(jnp.asarray(IMAGES),
                                                      target))
  got = image_transformations.center_crop_images(torch.from_numpy(IMAGES),
                                                 target)
  np.testing.assert_array_equal(got.numpy(), want)


def test_random_crop_is_one_seeded_window_for_the_batch():
  images = torch.from_numpy(IMAGES)
  crops = [image_transformations.random_crop_images(
      images, (12, 9), torch.Generator().manual_seed(seed)) for seed in
           (3, 3, 4, 5, 6)]
  assert torch.equal(crops[0], crops[1])
  windows = set()
  for crop in crops:
    assert crop.shape == (3, 12, 9, 3)
    matches = [(oh, ow) for oh in range(20 - 12 + 1)
               for ow in range(25 - 9 + 1)
               if torch.equal(images[:, oh:oh + 12, ow:ow + 9], crop)]
    assert len(matches) == 1
    windows.add(matches[0])
  assert len(windows) > 1


def test_crop_larger_than_image_raises():
  with pytest.raises(ValueError, match='larger'):
    image_transformations.center_crop_images(torch.from_numpy(IMAGES),
                                             (21, 5))
  with pytest.raises(ValueError, match='larger'):
    image_transformations.random_crop_images(torch.from_numpy(IMAGES),
                                             (5, 26))


@pytest.mark.parametrize('offsets', [(0, 0), (8, 16), (3, 5)])
def test_random_crop_with_injected_offsets_matches_jax(offsets):
  """The JAX crop is one dynamic_slice at (offset_h, offset_w) for the whole
  batch; injected offsets give exactly that window."""
  target = (12, 9)
  want = np.asarray(jax.lax.dynamic_slice(
      jnp.asarray(IMAGES), (0, offsets[0], offsets[1], 0),
      (3,) + target + (3,)))
  got = image_transformations.random_crop_images(
      torch.from_numpy(IMAGES), target, offsets=offsets)
  np.testing.assert_array_equal(got.numpy(), want)


def test_random_crop_of_the_full_image_takes_offset_zero():
  images = torch.from_numpy(IMAGES)
  crop = image_transformations.random_crop_images(
      images, (20, 25), torch.Generator().manual_seed(1))
  assert torch.equal(crop, images)
  with pytest.raises(ValueError, match='out of range'):
    image_transformations.random_crop_images(images, (12, 9),
                                             offsets=(9, 0))


def _float_images(seed=0, shape=(3, 10, 12, 3)):
  return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def test_colour_space_round_trip_matches_jax():
  rgb = _float_images()
  rgb[0, 0, 0] = (0.5, 0.5, 0.5)  # grey: zero saturation, zero hue
  rgb[0, 0, 1] = (0.0, 0.0, 0.0)  # black: zero value
  hsv = image_transformations.rgb_to_hsv(torch.from_numpy(rgb))
  want = np.asarray(jax_transforms.rgb_to_hsv(jnp.asarray(rgb)))
  np.testing.assert_allclose(hsv.numpy(), want, rtol=0, atol=1e-6)
  back = image_transformations.hsv_to_rgb(hsv)
  np.testing.assert_allclose(
      back.numpy(), np.asarray(jax_transforms.hsv_to_rgb(jnp.asarray(want))),
      rtol=0, atol=1e-6)
  np.testing.assert_allclose(back.numpy(), rgb, rtol=0, atol=1e-5)


@pytest.mark.parametrize('name,shape', [
    ('adjust_brightness', (3, 1, 1, 1)),
    ('adjust_saturation', (3, 1, 1)),
    ('adjust_hue', (3, 1, 1)),
    ('adjust_contrast', (3, 1, 1, 1)),
])
def test_adjustments_match_jax(name, shape):
  images = _float_images(seed=1)
  param = np.random.RandomState(2).uniform(0.2, 1.4, shape).astype(
      np.float32)
  got = getattr(image_transformations, name)(torch.from_numpy(images),
                                             torch.from_numpy(param))
  want = getattr(jax_transforms, name)(jnp.asarray(images),
                                       jnp.asarray(param))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                             atol=1e-6)


def test_photometric_chain_defaults_only_clip_and_draws_are_seeded():
  images = 1.4 * _float_images(seed=3) - 0.2
  got = image_transformations.apply_photometric_image_distortions(
      torch.from_numpy(images))
  want = jax_transforms.apply_photometric_image_distortions(
      jax.random.PRNGKey(0), jnp.asarray(images))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  options = dict(random_brightness=True, random_saturation=True,
                 random_hue=True, random_contrast=True,
                 random_noise_level=0.05)
  runs = [image_transformations.apply_photometric_image_distortions(
      torch.from_numpy(images), torch.Generator().manual_seed(seed),
      **options) for seed in (5, 5, 6)]
  assert torch.equal(runs[0], runs[1])
  assert not torch.equal(runs[0], runs[2])
  for run in runs:
    assert float(run.min()) >= 0.0 and float(run.max()) <= 1.0

