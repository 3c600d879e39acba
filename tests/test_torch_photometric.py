"""Port parity: the fused photometric pass against the JAX package.

The plain version (``ops/photometric.plain_brightness_contrast``) against the
JAX ``fused_brightness_contrast(..., interpret=True)`` (its Pallas kernel
interpreted on the CPU) on the same seeded images, brightness shifts and
contrast factors: float32 within 1e-6 (the per-channel means are float32
sums in another order), bfloat16 within one bfloat16 ulp of the result
(a float32 difference of one ulp can cross a bfloat16 rounding boundary).
Then the fused branch of ``apply_photometric_image_distortions`` against
the stock chain on the same generator, and the wrapper's contract.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.ops import photometric as jax_photometric
from tensor2robot_tpu_torch.ops import photometric
from tensor2robot_tpu_torch.preprocessors import image_transformations

SHAPES = [(3, 10, 12, 3), (2, 17, 9, 1), (2, 8, 8, 4), (1, 40, 33, 3)]


def _inputs(shape, seed=0):
  rng = np.random.RandomState(seed)
  images = rng.rand(*shape).astype(np.float32)
  delta = rng.uniform(-0.125, 0.125, shape[0]).astype(np.float32)
  factor = rng.uniform(0.5, 1.5, shape[0]).astype(np.float32)
  return images, delta, factor


@pytest.mark.parametrize('shape', SHAPES)
def test_plain_matches_jax_kernel_float32(shape):
  images, delta, factor = _inputs(shape)
  want = np.asarray(jax_photometric.fused_brightness_contrast(
      jnp.asarray(images), jnp.asarray(delta), jnp.asarray(factor),
      interpret=True))
  got = photometric.fused_brightness_contrast(
      torch.from_numpy(images), torch.from_numpy(delta),
      torch.from_numpy(factor))
  assert got.dtype == torch.float32 and got.shape == shape
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
  assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


@pytest.mark.parametrize('shape', SHAPES[:2])
def test_plain_matches_jax_kernel_bfloat16(shape):
  images, delta, factor = _inputs(shape, seed=1)
  want = jax_photometric.fused_brightness_contrast(
      jnp.asarray(images, jnp.bfloat16), jnp.asarray(delta),
      jnp.asarray(factor), interpret=True)
  assert want.dtype == jnp.bfloat16
  want = np.asarray(want.astype(jnp.float32))
  got = photometric.plain_brightness_contrast(
      torch.from_numpy(images).to(torch.bfloat16), torch.from_numpy(delta),
      torch.from_numpy(factor))
  assert got.dtype == torch.bfloat16
  # One bfloat16 ulp at each value (8 significant bits): 2**(e - 8) for
  # want = m * 2**e with m in [0.5, 1).
  ulp = np.ldexp(1.0, np.frexp(want)[1] - 8)
  assert (np.abs(got.float().numpy() - want) <= ulp).all()


@pytest.mark.parametrize('shape', SHAPES)
def test_derived_float32_band_covers_other_evaluations(shape):
  """chip_smoke.photometric_float32_band (the card's bfloat16 bar) holds
  two other float32 evaluations to the plain version: the JAX kernel
  (interpreted; its means read back at factor 0) and a fused multiply-add
  over float64-summed means. Each lies within the band everywhere, and the
  band is far under the float32 check's 1e-6."""
  import chip_smoke  # pylint: disable=import-outside-toplevel
  images, delta, factor = _inputs(shape, seed=2)
  timages, tdelta, tfactor = (torch.from_numpy(v)
                              for v in (images, delta, factor))
  plain = photometric.plain_brightness_contrast(timages, tdelta, tfactor)

  def jax_pass(scale):
    return torch.from_numpy(np.asarray(
        jax_photometric.fused_brightness_contrast(
            jnp.asarray(images), jnp.asarray(delta), jnp.asarray(scale),
            interpret=True)).copy())

  jax_mean = jax_pass(np.zeros_like(factor))[:, :1, :1, :]
  x = timages + tdelta.reshape(-1, 1, 1, 1)
  f64_mean = x.double().mean(dim=(1, 2), keepdim=True).float()
  fma = ((x - f64_mean).double() * tfactor.double().reshape(-1, 1, 1, 1) +
         f64_mean.double()).float().clamp(0.0, 1.0)
  for other, mean in ((jax_pass(factor), jax_mean), (fma, f64_mean)):
    assert bool(((mean > 0) & (mean < 1)).all())
    band = chip_smoke.photometric_float32_band(timages, tdelta, tfactor,
                                               mean)
    assert bool(((other.double() - plain.double()).abs() <= band).all())
    assert float(band.max()) < 1e-6


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_fused_branch_equals_stock_chain_on_one_generator(dtype):
  images = torch.from_numpy(_inputs((4, 14, 11, 3), seed=2)[0]).to(dtype)
  options = dict(random_brightness=True, random_contrast=True,
                 max_delta_brightness=0.2, lower_contrast=0.3,
                 upper_contrast=1.7)
  stock = image_transformations.apply_photometric_image_distortions(
      images, torch.Generator().manual_seed(7), **options)
  generator = torch.Generator().manual_seed(7)
  fused = image_transformations.apply_photometric_image_distortions(
      images, generator, use_fused_kernel=True, **options)
  assert fused.dtype == dtype  # the kernel writes the input's dtype
  # Both branches drew two (B, 1, 1, 1) tensors and nothing else.
  reference = torch.Generator().manual_seed(7)
  torch.rand((4, 1, 1, 1), generator=reference)
  torch.rand((4, 1, 1, 1), generator=reference)
  assert torch.equal(generator.get_state(), reference.get_state())
  np.testing.assert_allclose(fused.float().numpy(),
                             stock.to(dtype).float().numpy(), rtol=0,
                             atol=1e-6 if dtype == torch.float32 else 2**-8)


def test_other_distortions_keep_the_stock_chain():
  images = torch.from_numpy(_inputs((2, 6, 7, 3), seed=3)[0])
  options = dict(random_brightness=True, random_contrast=True,
                 random_saturation=True)
  a, b = (image_transformations.apply_photometric_image_distortions(
      images, torch.Generator().manual_seed(1), use_fused_kernel=fused,
      **options) for fused in (False, True))
  assert torch.equal(a, b)


def test_kernel_wrapper_contract():
  images, delta, factor = (torch.from_numpy(x) for x in _inputs((2, 5, 4, 3)))
  with pytest.raises(ValueError, match='CUDA'):
    photometric.photometric(images, delta, factor)
  with pytest.raises(ValueError, match='one brightness delta'):
    photometric.plain_brightness_contrast(images, delta[:1], factor)
  with pytest.raises(ValueError, match='float32 or bfloat16'):
    photometric.plain_brightness_contrast(images.double(), delta, factor)
  # Slices of a multiple of 768 elements cover each image exactly.
  for shape in [(32, 472, 472, 3), (2, 5, 4, 3), (1, 128, 96, 1)]:
    pixels, channels, slice_, slices = photometric._geometry(shape)  # pylint: disable=protected-access
    elements = pixels * channels
    assert slice_ % 768 == 0 and slice_ <= 16 * 768
    assert slice_ * (slices - 1) < elements <= slice_ * slices
