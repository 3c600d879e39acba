"""Port parity: the image crops against the JAX package.

The centre crop must equal the JAX one exactly. The random crop draws its
offset from a torch generator, which cannot reproduce JAX's threefry
stream, so it is held to the JAX semantics instead: one offset for the
whole batch, a window of the input, and the same crop from the same seed.
"""

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
