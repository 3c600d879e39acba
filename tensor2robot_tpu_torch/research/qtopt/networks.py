"""QT-Opt grasping critic network (Grasping44) as a PyTorch module.

The port's counterpart of ``tensor2robot_tpu/research/qtopt/networks.py``:
a conv tower over the 472x472 grasp image; grasp params embedded and
broadcast-added to the image features; two more conv stages; an MLP ->
logit -> sigmoid q.

Layouts: the module takes NHWC images, like the JAX one. The first conv
and the first pool run on NHWC tensors (the kernels' layout); the rest of
the tower runs NCHW tensors in channels-last memory, so every switch
between the two is a free ``permute`` of the same storage. The features
are flattened in NHWC order before ``fc0``, as in the JAX module, so the
converted ``fc0`` weights line up.

Numerics follow flax's modules:

* ``_BatchNorm`` is ``flax.linen.BatchNorm`` (``layers/normalization.py``):
  statistics in at least float32 with the biased variance
  E[x^2] - E[x]^2, running averages updated as
  ``momentum * old + (1 - momentum) * new`` (flax's ``momentum=0.9997`` is
  torch's ``momentum=0.0003``), output cast to the compute dtype.
* ``bn1`` takes its statistics from the pre-pool tensor and applies them
  to the pooled one (``_PooledBatchNormRelu``).
* SAME padding is resolved as XLA does it, which is asymmetric at full
  width: conv1 6x6/s2 on 472 pads (2, 2); pool1 3x3/s3 on 236 pads
  (0, 1); pool2 3x3/s3 on 79 pads (1, 1); pool3 2x2/s2 on 27 pads (0, 1).
* With ``dtype=torch.bfloat16``, convs and dense layers run in bfloat16,
  batch-norm statistics stay float32 and the logits leave in float32.

Under a ``remat_policy`` other than 'none' each ``_ConvBN`` tower block is
a recompute region (``layers/remat.py``): its activations are recomputed
in the backward, its batch statistics move once, and the parameter and
buffer names do not change.

Under ``kernel_policy='pool'`` the three max-pools go through
``ops.pool`` (the CUDA kernel on the card); ``'pool_conv'`` also routes
``conv1_1`` through ``ops.conv_s2d``. The other convs and the dense
layers are computed by ``F.conv2d`` / ``F.linear``, as the JAX package
leaves them to XLA.

Under ``matmul_precision='fp8'`` every conv and dense layer owns an
``fp8`` injection (``quantize/fp8_training.py``): its operands are
quantize-dequantized through float8_e4m3fn by their delayed amax windows
(``<layer>.fp8.{lhs,rhs}.amax_history`` buffers) and its cotangent through
float8_e5m2. ``conv1_1`` on the kernel path (``'pool_conv'``) takes the
operand hook alone, so its kernels' backward reads the un-quantized
cotangent, as in the JAX package.

Parameter and buffer names (see ``utils/convert.py`` for the mapping from
the flax tree): ``conv1_1.kernel`` (HWIO), ``bn1.{bias,mean,var}``,
``conv<l>.conv.weight`` (OIHW) and ``conv<l>.bn.*``, ``fcgrasp.weight``,
``fcgrasp_bn.*``, ``fcgrasp2.{weight,bias}``, ``fc<l>.weight``,
``fc<l>_bn.*``, ``logit.{weight,bias}``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import remat
from tensor2robot_tpu_torch.layers.normalization import BatchNorm as _BatchNorm
from tensor2robot_tpu_torch.layers.normalization import \
    batch_stats as _batch_stats
from tensor2robot_tpu_torch.layers.normalization import \
    feature_shape as _feature_shape
from tensor2robot_tpu_torch.layers.normalization import \
    update_running_stats as _update_running_stats
from tensor2robot_tpu_torch.ops import _dispatch as dispatch
from tensor2robot_tpu_torch.ops import pool as pool_ops
from tensor2robot_tpu_torch.ops.conv_s2d import SpaceToDepthConv
from tensor2robot_tpu_torch.ops.pool import resolve_padding
from tensor2robot_tpu_torch.quantize import fp8_training as fp8_lib

_INIT_STDDEV = 0.01


class _PooledBatchNormRelu(nn.Module):
  """BatchNorm(+bias)+relu applied AFTER a max pool, statistics BEFORE.

  ``relu(bn(pool(x)))`` with the statistics of the full pre-pool ``x``
  equals ``pool(relu(bn(x)))`` for a scale-free batch norm (the normalize
  is strictly increasing), at a ninth of the elementwise traffic.
  """

  def __init__(self, features: int, momentum: float, epsilon: float):
    super().__init__()
    self.momentum, self.epsilon = momentum, epsilon
    self.bias = nn.Parameter(torch.zeros(features))
    self.register_buffer('mean', torch.zeros(features))
    self.register_buffer('var', torch.ones(features))

  def forward(self, x: torch.Tensor, pooled: torch.Tensor,
              feature_dim: int) -> torch.Tensor:
    feature_dim %= x.dim()
    if self.training:
      dims = [d for d in range(x.dim()) if d != feature_dim]
      mean, var = _batch_stats(x, dims)
      _update_running_stats(self, mean, var)
    else:
      mean, var = self.mean, self.var
    shape = _feature_shape(pooled, feature_dim)
    inv = torch.rsqrt(var + self.epsilon)
    y = ((pooled.float() - mean.reshape(shape)) * inv.reshape(shape) +
         self.bias.reshape(shape))
    return F.relu(y).to(pooled.dtype)


class _Conv(nn.Module):
  """Bias-free conv on NCHW tensors with an OIHW ``weight`` and XLA's
  resolution of SAME padding; ``fp8``, the injection of
  ``matmul_precision='fp8'`` (None for bf16)."""

  def __init__(self, in_features: int, features: int, kernel: int,
               strides: int, padding: str, dtype: Optional[torch.dtype],
               matmul_precision: str = 'bf16'):
    super().__init__()
    self.kernel, self.strides, self.padding = kernel, strides, padding
    self.dtype = dtype
    self.weight = nn.Parameter(
        torch.zeros(features, in_features, kernel, kernel))
    self.fp8 = fp8_lib.injection(matmul_precision)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dtype = self.dtype or x.dtype
    x, w = x.to(dtype), self.weight.to(dtype)
    if self.fp8 is not None:
      x, w = self.fp8(x, w)
    (plh, phh), (plw, phw) = resolve_padding(
        self.padding, (self.kernel, self.kernel), (self.strides,) * 2,
        tuple(x.shape[2:4]))
    if plh != phh or plw != phw:
      x = F.pad(x, (plw, phw, plh, phh))
      plh = plw = 0
    y = F.conv2d(x, w, stride=self.strides, padding=(plh, plw))
    return y if self.fp8 is None else self.fp8.output(y)


class _ConvBN(nn.Module):
  """conv -> BatchNorm(scale) -> relu, no conv bias (BatchNorm cancels it);
  one recompute region under a ``remat_policy`` other than 'none'
  (``layers/remat.py``)."""

  def __init__(self, in_features: int, features: int, kernel: int,
               padding: str, decay: float, epsilon: float,
               dtype: Optional[torch.dtype], remat_policy: str = 'none',
               matmul_precision: str = 'bf16'):
    super().__init__()
    self.remat_policy = remat.validate_remat_policy(remat_policy)
    self.conv = _Conv(in_features, features, kernel, 1, padding, dtype,
                      matmul_precision)
    self.bn = _BatchNorm(features, True, decay, epsilon, dtype)

  def _block(self, x: torch.Tensor) -> torch.Tensor:
    return F.relu(self.bn(self.conv(x), feature_dim=1))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return remat.checkpointed(self._block, self.remat_policy, x)


class _Dense(nn.Module):
  """Dense layer with a [out, in] ``weight`` and optional ``bias``;
  ``fp8``, the injection of ``matmul_precision='fp8'`` (None for bf16),
  wraps the product before the bias is added."""

  def __init__(self, in_features: int, features: int, use_bias: bool,
               dtype: Optional[torch.dtype], matmul_precision: str = 'bf16'):
    super().__init__()
    self.dtype = dtype
    self.weight = nn.Parameter(torch.zeros(features, in_features))
    if use_bias:
      self.bias = nn.Parameter(torch.zeros(features))
    else:
      self.register_parameter('bias', None)
    self.fp8 = fp8_lib.injection(matmul_precision)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dtype = self.dtype or x.dtype
    bias = None if self.bias is None else self.bias.to(dtype)
    if self.fp8 is None:
      return F.linear(x.to(dtype), self.weight.to(dtype), bias)
    x, w = self.fp8(x.to(dtype), self.weight.to(dtype))
    y = self.fp8.output(F.linear(x, w))
    return y if bias is None else y + bias


def _same(size: int, stride: int) -> int:
  return -(-size // stride)


class Grasping44(nn.Module):
  """The Grasping44 Q-network.

  ``forward(images, grasp_params, softmax=False)``:

  * ``images``: [B, H, W, 3] grasp image (``image_size`` = (H, W)).
  * ``grasp_params``: [B, P] or, for CEM action batches, [B, A, P]; the
    image features [B, ...] are broadcast against the A actions, so the
    conv tower runs once per image.

  Returns (logits, end_points) with ``predictions`` = sigmoid(logits),
  shaped [B] or [B, A]. Train/eval batch-norm follows ``self.training``.
  """

  def __init__(self,
               image_size: Tuple[int, int] = (472, 472),
               grasp_param_size: int = 5,
               num_convs: Tuple[int, int, int] = (6, 6, 3),
               hid_layers: int = 2,
               num_classes: int = 1,
               batch_norm_decay: float = 0.9997,
               batch_norm_epsilon: float = 0.001,
               dtype: Optional[torch.dtype] = None,
               kernel_policy: str = 'none',
               remat_policy: str = 'none',
               matmul_precision: str = 'bf16'):
    super().__init__()
    self.num_convs = tuple(num_convs)
    self.hid_layers = hid_layers
    self.num_classes = num_classes
    self.dtype = dtype
    self.kernel_policy = dispatch.validate_kernel_policy(kernel_policy)
    self.remat_policy = remat.validate_remat_policy(remat_policy)
    self.matmul_precision = fp8_lib.validate_matmul_precision(
        matmul_precision)
    precision = self.matmul_precision
    decay, eps = batch_norm_decay, batch_norm_epsilon
    tower = dict(decay=decay, epsilon=eps, dtype=dtype,
                 remat_policy=self.remat_policy, matmul_precision=precision)

    conv_kernel = dispatch.policy_enables_conv(self.kernel_policy)
    self.conv1_1 = SpaceToDepthConv(
        3, 64, (6, 6), strides=(2, 2), padding='SAME', use_bias=False,
        dtype=dtype, use_kernel=conv_kernel,
        fp8=(fp8_lib.conv_operand_hook(precision) if conv_kernel else
             fp8_lib.injection(precision)))
    self.bn1 = _PooledBatchNormRelu(64, decay, eps)
    n0, n1, n2 = self.num_convs
    self._tower1 = [f'conv{l}' for l in range(2, 2 + n0)]
    self._tower2 = [f'conv{l}' for l in range(2 + n0, 2 + n0 + n1)]
    self._tower3 = [f'conv{l}' for l in range(2 + n0 + n1, 2 + n0 + n1 + n2)]
    for name in self._tower1:
      self.add_module(name, _ConvBN(64, 64, 5, 'SAME', **tower))
    for name in self._tower2:
      self.add_module(name, _ConvBN(64, 64, 3, 'SAME', **tower))
    for name in self._tower3:
      self.add_module(name, _ConvBN(64, 64, 3, 'VALID', **tower))

    self.fcgrasp = _Dense(grasp_param_size, 256, False, dtype, precision)
    self.fcgrasp_bn = _BatchNorm(256, False, decay, eps, dtype)
    self.fcgrasp2 = _Dense(256, 64, True, dtype, precision)

    h, w = image_size
    for stride in (2, 3, 3, 2):  # conv1, pool1, pool2, pool3 (all SAME)
      h, w = _same(h, stride), _same(w, stride)
    h, w = h - 2 * n2, w - 2 * n2  # VALID 3x3 convs
    if h < 1 or w < 1:
      raise ValueError(f'image_size {image_size} is too small for '
                       f'num_convs {num_convs}.')
    features = h * w * 64
    for l in range(hid_layers):
      self.add_module(f'fc{l}', _Dense(features, 64, False, dtype,
                                       precision))
      self.add_module(f'fc{l}_bn', _BatchNorm(64, True, decay, eps, dtype))
      features = 64
    self.logit_name = 'logit' if num_classes == 1 else f'logit_{num_classes}'
    self.add_module(self.logit_name,
                    _Dense(64, num_classes, True, dtype, precision))

  def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
    """The JAX module's initialisers: conv and dense kernels from a normal
    of std 0.01 truncated at two std; biases zero; batch-norm scale one,
    bias zero, running mean zero and variance one."""
    with torch.no_grad():
      for name, param in self.named_parameters():
        leaf = name.rsplit('.', 1)[-1]
        if leaf in ('kernel', 'weight'):
          nn.init.trunc_normal_(param, std=_INIT_STDDEV,
                                a=-2 * _INIT_STDDEV, b=2 * _INIT_STDDEV,
                                generator=generator)
        elif leaf == 'scale':
          param.fill_(1.0)
        else:
          param.zero_()
      for name, buf in self.named_buffers():
        buf.fill_(1.0 if name.endswith('var') else 0.0)

  def _max_pool(self, x: torch.Tensor, window: Tuple[int, int],
                strides: Tuple[int, int]) -> torch.Tensor:
    """NHWC max pool, SAME padding, through the kernel entry when the
    kernel policy routes pools there."""
    if dispatch.policy_enables_pool(self.kernel_policy):
      return pool_ops.max_pool(x.contiguous(), window, strides, 'SAME')
    return pool_ops.reference_max_pool(x, window, strides, 'SAME')

  def _pool_nchw(self, x: torch.Tensor, window, strides) -> torch.Tensor:
    pooled = self._max_pool(x.permute(0, 2, 3, 1), window, strides)
    return pooled.permute(0, 3, 1, 2)

  def forward(self, images: torch.Tensor, grasp_params: torch.Tensor,
              softmax: bool = False):
    end_points: Dict[str, torch.Tensor] = {}
    action_batched = grasp_params.dim() == 3
    if self.dtype is not None:
      images = images.to(self.dtype)
      grasp_params = grasp_params.to(self.dtype)

    # Image tower: conv1 and pool1 on NHWC, then channels-last NCHW.
    net = self.conv1_1(images)
    pooled = self._max_pool(net, (3, 3), (3, 3))
    net = self.bn1(net, pooled, feature_dim=3).permute(0, 3, 1, 2)
    for name in self._tower1:
      net = getattr(self, name)(net)
    net = self._pool_nchw(net, (3, 3), (3, 3))
    end_points['pool2'] = net.permute(0, 2, 3, 1)

    # Grasp-param embedding.
    fcgrasp = F.relu(self.fcgrasp_bn(self.fcgrasp(grasp_params),
                                     feature_dim=-1))
    fcgrasp = self.fcgrasp2(fcgrasp)
    end_points['fcgrasp'] = fcgrasp

    # Merge: broadcast-add the action context onto the image features.
    if action_batched:
      net = net[:, None] + fcgrasp[:, :, :, None, None]
      batch, actions = net.shape[0], net.shape[1]
      net = net.reshape((batch * actions,) + tuple(net.shape[2:]))
    else:
      net = net + fcgrasp[:, :, None, None]
    net = net.contiguous(memory_format=torch.channels_last)
    end_points['vsum'] = net.permute(0, 2, 3, 1)

    for name in self._tower2:
      net = getattr(self, name)(net)
    net = self._pool_nchw(net, (2, 2), (2, 2))
    for name in self._tower3:
      net = getattr(self, name)(net)
    end_points['final_conv'] = net.permute(0, 2, 3, 1)

    net = net.permute(0, 2, 3, 1).reshape(net.shape[0], -1)
    for l in range(self.hid_layers):
      net = getattr(self, f'fc{l}')(net)
      net = F.relu(getattr(self, f'fc{l}_bn')(net, feature_dim=-1))
    logits = getattr(self, self.logit_name)(net).float()
    end_points['logits'] = logits

    predictions = (torch.softmax(logits, dim=-1) if softmax else
                   torch.sigmoid(logits))
    if self.num_classes == 1:
      predictions = predictions.squeeze(-1)
    if action_batched:
      predictions = predictions.reshape((batch, actions) + (
          () if self.num_classes == 1 else (self.num_classes,)))
    end_points['predictions'] = predictions
    return logits, end_points
