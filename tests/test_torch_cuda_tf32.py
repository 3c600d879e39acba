"""The float32 SNAIL vision tower on the card at torch's TF32 defaults.

Marked ``cuda``: skips with a reason where no CUDA card is visible.
PyTorch runs a float32 convolution through cuDNN in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True, while float32 matmuls stay
float32), and the port's library code sets neither flag. So on the card a
user's float32 SNAIL tower (``layers/vision_layers.py``, stock
``F.conv2d``) runs its convs in TF32, where the CPU and the JAX reference
run them in float32. This file pins how far that lands. The CPU tower is
held to the flax module at 2e-5 of the output's scale by
``tests/test_torch_snail.py::test_images_to_features_matches_flax``, so
the band here, plus 2e-5, bounds the card's distance from the reference.
The file imports neither JAX nor the JAX package; run it as
``tests/test_torch_cuda_kernels.py`` says.
"""

import copy

import pytest
import torch

from tensor2robot_tpu_torch.layers import vision_layers

pytestmark = pytest.mark.cuda

# A batch of SNAIL frames as the tower sees them: 100x100 RGB in [0, 1)
# after the meta preprocessing's crop-resize and scaling.
FRAMES = (256, 100, 100, 3)
# See test_float32_tower_under_tf32_defaults_stays_in_band.
TF32_BAND = 3e-4
FLOAT32_BAND = 2e-5


@pytest.fixture(name='device')
def _device():
  """The card at torch's defaults (cuBLAS TF32 off, cuDNN TF32 on), both
  flags restored after the test."""
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card: cuDNN TF32 exists only there')
  saved = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = True
  try:
    yield torch.device('cuda')
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _distance(got, want):
  """Largest error over the output's scale (its largest magnitude, at
  least 1), as the CPU-vs-flax test measures it."""
  scale = max(1.0, float(want.abs().max()))
  return float((got.cpu() - want).abs().max()) / scale


def _bf16_convs(tower):
  """A copy of ``tower`` whose convs run at bfloat16 precision: weights and
  each conv's input rounded to bfloat16, products summed in float32, as
  bfloat16 tensor cores do; everything else stays float32."""
  control = copy.deepcopy(tower)
  for module in control.modules():
    if isinstance(module, vision_layers._Conv):  # pylint: disable=protected-access
      with torch.no_grad():
        module.weight.copy_(module.weight.bfloat16().float())
      module.register_forward_pre_hook(
          lambda _, args: (args[0].bfloat16().float(),) + args[1:])
  return control


@pytest.mark.parametrize('seed', (0, 1, 2))
def test_float32_tower_under_tf32_defaults_stays_in_band(device, seed):
  """The same seeded float32 tower and frames on the CPU and on the card:
  at torch's defaults, with cuDNN TF32 off, and a control whose convs run
  at bfloat16 precision (TF32 off).

  The band, TF32_BAND = 3e-4 of the output's scale, lies between two
  readings on an NVIDIA H100 80GB HBM3 (700 W), seeds 0 to 2, as the max
  over the points and the softmax maps: under TF32, 8.9e-5 to 1.5e-4;
  the bfloat16 control, 6.7e-4 to 1.0e-3. TF32 keeps 10 of float32's 23
  mantissa bits and bfloat16 7, so the control's rounding is 8 times
  TF32's and its distance 7 to 9 times as large. The band is twice the
  largest TF32 reading and under half the smallest control reading, so
  a tower whose convs lost precision below TF32's fails it, and the test
  shows that the control does. With TF32 off, the card's float32 convs
  differ from the CPU's only in their sum order: FLOAT32_BAND is the
  CPU-vs-flax band, 2e-5 (2.3e-7 measured).
  """
  generator = torch.Generator().manual_seed(seed)
  tower = vision_layers.ImagesToFeaturesModel()
  tower.init_weights(generator)
  frames = torch.rand(FRAMES, generator=generator)
  card = copy.deepcopy(tower).to(device)
  control = _bf16_convs(tower).to(device)
  with torch.no_grad():
    want_points, want_ends = tower(frames)
    points, ends = card(frames.to(device))
    torch.backends.cudnn.allow_tf32 = False
    exact_points, exact_ends = card(frames.to(device))
    bf16_points, bf16_ends = control(frames.to(device))
  torch.cuda.synchronize()
  readings = {}
  for name, (got_points, got_ends) in (
      ('tf32', (points, ends)), ('float32', (exact_points, exact_ends)),
      ('bf16 control', (bf16_points, bf16_ends))):
    readings[name] = max(_distance(got_points, want_points),
                         _distance(got_ends['softmax'], want_ends['softmax']))
  print(f'float32 SNAIL tower {FRAMES} seed {seed} on '
        f'{torch.cuda.get_device_name(0)}, card against CPU, max over points '
        'and softmax: ' + ', '.join(f'{name} {value:.3e}'
                                    for name, value in readings.items()))
  assert points.dtype == torch.float32
  assert readings['tf32'] <= TF32_BAND, readings
  assert readings['float32'] <= FLOAT32_BAND, readings
  assert readings['bf16 control'] > TF32_BAND, readings
