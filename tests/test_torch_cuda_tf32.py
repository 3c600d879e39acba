"""The float32 SNAIL vision tower on the card at torch's TF32 defaults.

Marked ``cuda``: skips with a reason where no CUDA card is visible.
PyTorch runs a float32 convolution through cuDNN in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True, while float32 matmuls stay
float32), and the port's library code sets neither flag. So on the card a
user's float32 SNAIL tower (``layers/vision_layers.py``, stock
``F.conv2d``) runs its convs in TF32, where the CPU and the JAX reference
run them in float32. This file pins how far that lands, for the output
and for the parameter gradients. The CPU tower is
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
# See test_float32_tower_gradients_under_tf32_defaults_stay_in_band.
TF32_GRAD_BAND = 1e-1
FLOAT32_GRAD_BAND = 5e-3
# The final LayerNorm's bias has gradient 0 but for rounding: the spatial
# softmax is invariant to a constant added to a channel.
INVARIANT_LEAVES = ('final_norm.bias',)


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


def _round_output_gradient(_, args, out):
  """Rounds the gradient that reaches a conv's output to bfloat16, so the
  conv's backward products see it as bfloat16 tensor cores would."""
  del args
  if out.requires_grad:
    out.register_hook(lambda g: g.bfloat16().float())


def _bf16_convs(tower):
  """A copy of ``tower`` whose convs run at bfloat16 precision: weights,
  each conv's input and, in a backward, the gradient of its output rounded
  to bfloat16, products summed in float32, as bfloat16 tensor cores do;
  everything else stays float32."""
  control = copy.deepcopy(tower)
  for module in control.modules():
    if isinstance(module, vision_layers._Conv):  # pylint: disable=protected-access
      with torch.no_grad():
        module.weight.copy_(module.weight.bfloat16().float())
      module.register_forward_pre_hook(
          lambda _, args: (args[0].bfloat16().float(),) + args[1:])
      module.register_forward_hook(_round_output_gradient)
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


def _gradients(tower, frames, cotangent):
  """{leaf name: gradient on the CPU} of sum(points * cotangent)."""
  points, _ = tower(frames)
  names, params = zip(*tower.named_parameters())
  grads = torch.autograd.grad((points * cotangent).sum(), params)
  return {name: g.cpu() for name, g in zip(names, grads)}


def _worst_leaf(grads, want):
  """(largest relative L2 error ||got - want|| / ||want|| over the leaves,
  that leaf's name), the invariant leaves left out."""
  return max((float((grads[name] - w).norm() / w.norm()), name)
             for name, w in want.items() if name not in INVARIANT_LEAVES)


@pytest.mark.parametrize('seed', (0, 1, 2))
def test_float32_tower_gradients_under_tf32_defaults_stay_in_band(device,
                                                                  seed):
  """The parameter gradients of the same seeded float32 tower, frames and
  cotangent on the points, on the CPU and on the card: at torch's defaults
  (cuDNN TF32 on, in the backward's convs as in the forward's), with cuDNN
  TF32 off, and a control whose convs run at bfloat16 precision (TF32
  off). Each is read as its worst leaf's relative L2 error against the
  CPU's float32 gradient.

  The band, TF32_GRAD_BAND = 1e-1, lies between two readings on an NVIDIA
  H100 80GB HBM3 (700 W), seeds 0 to 2: under TF32 the worst leaf lands
  4.1e-2 to 6.9e-2 from the CPU (a LayerNorm or conv bias, whose gradient
  is a long cancelling sum), the bfloat16 control 1.3e-1 to 2.2e-1. The
  two lie only about 3x apart, not the forward's 8x, as expected if relu
  inputs that a rounding error moves across 0 dominate: a gradient changes
  by a whole element at each, their number grows with the rounding, and
  the L2 error with its square root (sqrt(8) = 2.8). The band sits near
  their geometric mean, 1.4x above the largest TF32 reading and 1.3x
  below the smallest control reading. With TF32 off the card's gradients
  differ from the CPU's only in their sum order, which flips a few relu
  inputs too: 2.8e-5 to 1.6e-3 (FLOAT32_GRAD_BAND = 5e-3).
  """
  generator = torch.Generator().manual_seed(seed)
  tower = vision_layers.ImagesToFeaturesModel()
  tower.init_weights(generator)
  frames = torch.rand(FRAMES, generator=generator)
  cotangent = torch.randn((FRAMES[0], 64), generator=generator)
  card = copy.deepcopy(tower).to(device)
  control = _bf16_convs(tower).to(device)
  want = _gradients(tower, frames, cotangent)
  card_frames, card_cotangent = frames.to(device), cotangent.to(device)
  tf32 = _gradients(card, card_frames, card_cotangent)
  torch.backends.cudnn.allow_tf32 = False
  exact = _gradients(card, card_frames, card_cotangent)
  bf16 = _gradients(control, card_frames, card_cotangent)
  readings = {name: _worst_leaf(grads, want) for name, grads in (
      ('tf32', tf32), ('float32', exact), ('bf16 control', bf16))}
  print(f'float32 SNAIL tower gradients {FRAMES} seed {seed} on '
        f'{torch.cuda.get_device_name(0)}, card against CPU, worst leaf '
        'relative L2: ' + ', '.join(
            f'{name} {value:.3e} ({leaf})'
            for name, (value, leaf) in readings.items()))
  assert readings['tf32'][0] <= TF32_GRAD_BAND, readings
  assert readings['float32'][0] <= FLOAT32_GRAD_BAND, readings
  assert readings['bf16 control'][0] > TF32_GRAD_BAND, readings
