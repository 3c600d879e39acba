"""Vision layers: the conv tower with a spatial-softmax head, and FiLM.

The port's counterpart of ``tensor2robot_tpu/layers/vision_layers.py``
(``film_modulation``, ``film_params_size``, ``ImagesToFeaturesModel``,
``FILMParams``, ``ImageFeaturesToPoseModel``; the high-resolution tower is
not ported yet).

Numerics follow the flax modules with ``dtype=None``: each conv and dense
layer computes in the promotion of its input and its float32 parameters,
so a bfloat16 image (the device-boundary dtype policy) leaves the first
conv as float32, and the tower computes in float32 from there on. The
normalisations are flax's (``layers/normalization.py``): LayerNorm with
epsilon 1e-6 over the channels, without a scale in the conv blocks and
with one at ``final_norm``; or BatchNorm (momentum 0.99, epsilon 1e-4)
under ``use_batch_norm``.

Layout: the tower takes NHWC images, as the JAX module does, and runs its
convs on the NCHW view of the same storage (channels-last memory). Its
parameter names follow the flax tree (``conv2``..``conv6``, ``norm2``..,
``final_conv_1x1``, ``final_norm``; ``utils/convert.py`` maps the leaves).
Under a ``remat_policy`` other than 'none' each conv block is a recompute
region (``layers/remat.py``); the names do not change.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import remat
from tensor2robot_tpu_torch.layers.normalization import BatchNorm, LayerNorm
from tensor2robot_tpu_torch.layers.spatial_softmax import spatial_softmax

_NUM_CHANNELS_PER_BLOCK = 32


def promoted(x: torch.Tensor, *params: torch.Tensor) -> torch.Tensor:
  """``x`` cast to the promotion of its dtype and the parameters' (flax's
  ``promote_dtype`` under ``dtype=None``)."""
  dtype = x.dtype
  for p in params:
    dtype = torch.promote_types(dtype, p.dtype)
  return x.to(dtype)


def xavier_uniform_(param: torch.Tensor, fan_in: int, fan_out: int,
                    generator: Optional[torch.Generator] = None) -> None:
  """flax's ``xavier_uniform``: U(-a, a), a = sqrt(6 / (fan_in + fan_out))."""
  bound = math.sqrt(6.0 / (fan_in + fan_out))
  nn.init.uniform_(param, -bound, bound, generator=generator)


def lecun_normal_(param: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> None:
  """flax's default kernel init, ``lecun_normal``: a normal of variance
  1/fan_in truncated at two standard deviations (std corrected for the
  truncation)."""
  std = math.sqrt(1.0 / fan_in) / .87962566103423978
  nn.init.trunc_normal_(param, std=std, a=-2 * std, b=2 * std,
                        generator=generator)


class Dense(nn.Module):
  """``flax.linen.Dense``: a [out, in] ``weight`` and a ``bias``, computed
  in the promotion of the input and the parameters."""

  def __init__(self, in_features: int, features: int):
    super().__init__()
    self.weight = nn.Parameter(torch.zeros(features, in_features))
    self.bias = nn.Parameter(torch.zeros(features))

  def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
    lecun_normal_(self.weight, self.weight.shape[1], generator)
    nn.init.zeros_(self.bias)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = promoted(x, self.weight)
    return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def film_modulation(net: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor) -> torch.Tensor:
  """FiLM with the zero-centred-gamma convention on NHWC ``net``:
  (1 + γ)·x + β, with γ and β [B, C]."""
  gamma = gamma[:, None, None, :]
  beta = beta[:, None, None, :]
  return (1.0 + gamma) * net + beta


def film_params_size(num_blocks: int,
                     channels: int = _NUM_CHANNELS_PER_BLOCK) -> int:
  return 2 * num_blocks * channels


class _Conv(nn.Module):
  """VALID 2-D conv with an OIHW ``weight`` and a ``bias``, flax's tower
  initialisers (xavier uniform, bias 0.01)."""

  def __init__(self, in_channels: int, features: int, kernel: int,
               stride: int):
    super().__init__()
    self.stride = stride
    self.weight = nn.Parameter(
        torch.zeros(features, in_channels, kernel, kernel))
    self.bias = nn.Parameter(torch.zeros(features))

  def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
    out, cin, kh, kw = self.weight.shape
    xavier_uniform_(self.weight, cin * kh * kw, out * kh * kw, generator)
    nn.init.constant_(self.bias, 0.01)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = promoted(x, self.weight)
    return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                    stride=self.stride)


class ImagesToFeaturesModel(nn.Module):
  """Conv tower → spatial softmax.

  ``forward(images, film_output_params=None)`` takes NHWC ``images`` and
  returns ``(expected_feature_points [B, 2*num_output_maps],
  {'softmax': maps [B, h, w, num_output_maps]})``. FiLM params, when given,
  are ``[B, 2*num_blocks*32]`` laid out as all gammas then all betas
  (block-major). Batch norm (``use_batch_norm``) follows ``self.training``.
  """

  def __init__(self, filter_size: int = 3, num_blocks: int = 5,
               num_output_maps: int = 32, use_batch_norm: bool = False,
               in_channels: int = 3, remat_policy: str = 'none'):
    super().__init__()
    self.num_blocks = num_blocks
    self.remat_policy = remat.validate_remat_policy(remat_policy)
    self.use_batch_norm = use_batch_norm
    channels = _NUM_CHANNELS_PER_BLOCK
    for i in range(num_blocks):
      stride = 2 if i in (0, 1) else 1
      self.add_module(f'conv{i + 2}', _Conv(
          in_channels if i == 0 else channels, channels, filter_size, stride))
      self.add_module(f'norm{i + 2}', self._norm(channels, scale=False))
    self.final_conv_1x1 = _Conv(channels, num_output_maps, 1, 1)
    self.final_norm = self._norm(num_output_maps, scale=True)

  def _norm(self, features: int, scale: bool) -> nn.Module:
    if self.use_batch_norm:
      return BatchNorm(features, use_scale=scale, momentum=0.99,
                       epsilon=1e-4)
    return LayerNorm(features, use_scale=scale)

  def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
    with torch.no_grad():
      for module in self.modules():
        if isinstance(module, _Conv):
          module.init_weights(generator)
        elif isinstance(module, (BatchNorm, LayerNorm)):
          if module.scale is not None:
            module.scale.fill_(1.0)
          module.bias.zero_()
          if isinstance(module, BatchNorm):
            module.mean.zero_()
            module.var.fill_(1.0)

  def _conv_block(self, i: int, net: torch.Tensor,
                  gamma: Optional[torch.Tensor] = None,
                  beta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One conv -> norm -> FiLM -> relu block: the recompute region under
    a ``remat_policy`` other than 'none' (``layers/remat.py``)."""
    net = getattr(self, f'conv{i + 2}')(net)
    net = getattr(self, f'norm{i + 2}')(net, feature_dim=1)
    if gamma is not None:
      net = film_modulation(net.permute(0, 2, 3, 1), gamma,
                            beta).permute(0, 3, 1, 2)
    return F.relu(net)

  def forward(self, images: torch.Tensor,
              film_output_params: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    channels = _NUM_CHANNELS_PER_BLOCK
    gammas = betas = None
    if film_output_params is not None:
      expected = film_params_size(self.num_blocks, channels)
      if film_output_params.dim() != 2 or (
          film_output_params.shape[-1] != expected):
        raise ValueError(
            f'FiLM params must be [B, {expected}], got '
            f'{tuple(film_output_params.shape)}')
      split = torch.split(film_output_params, channels, dim=-1)
      gammas, betas = split[:self.num_blocks], split[self.num_blocks:]

    net = images.permute(0, 3, 1, 2)  # NCHW view of the NHWC storage
    for i in range(self.num_blocks):
      film = () if gammas is None else (gammas[i], betas[i])
      net = remat.checkpointed(functools.partial(self._conv_block, i),
                               self.remat_policy, net, *film)
    net = self.final_conv_1x1(net)
    net = self.final_norm(net, feature_dim=1)
    points, softmax = spatial_softmax(net.permute(0, 2, 3, 1))
    return points, {'softmax': softmax}


class FILMParams(nn.Module):
  """Linear γ/β generator from an embedding (the flax ``film`` Dense)."""

  def __init__(self, embedding_size: int,
               film_output_size: int = film_params_size(5)):
    super().__init__()
    self.film_output_size = film_output_size
    self.film = Dense(embedding_size, film_output_size)

  def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
    with torch.no_grad():
      self.film.init_weights(generator)

  def forward(self, embedding: torch.Tensor) -> torch.Tensor:
    return self.film(embedding)


class ImageFeaturesToPoseModel(nn.Module):
  """Feature points (+ aux input) -> pose MLP, the flax module's
  ``ImageFeaturesToPoseModel``.

  A learned ``bias_transform`` vector (``bias_transform_size`` wide,
  initialised to 0.01) is tiled over the batch and concatenated to the
  input: MAML's inner loop gets a direct knob on the MLP's input. Then
  ``num_layers`` of Dense(``hidden_dim``) -> LayerNorm -> relu
  (``pose_fc<i>``, ``pose_norm<i>``; flax names the norms
  ``LayerNorm_<i>``), and a Dense(``num_outputs``) head
  (``pose_fc<num_layers>``) when ``num_outputs``. Dense kernels are
  drawn from a normal of std 0.01 truncated at two std, biases 0.01.
  ``forward`` returns ``(net, aux_output)``; ``aux_output`` is a
  Dense(``aux_output_dim``) of the feature points (``pose_fc_aux``) or
  None.
  """

  def __init__(self, in_features: int, num_outputs: Optional[int],
               aux_input_dim: int = 0, aux_output_dim: int = 0,
               hidden_dim: int = 100, num_layers: int = 2,
               bias_transform_size: int = 10):
    super().__init__()
    self.num_outputs = num_outputs
    self.num_layers = num_layers
    self.bias_transform_size = bias_transform_size
    width = in_features + aux_input_dim + bias_transform_size
    if bias_transform_size > 0:
      self.bias_transform = nn.Parameter(torch.zeros(bias_transform_size))
    else:
      self.register_parameter('bias_transform', None)
    for i in range(num_layers):
      self.add_module(f'pose_fc{i}', Dense(width, hidden_dim))
      self.add_module(f'pose_norm{i}', LayerNorm(hidden_dim))
      width = hidden_dim
    if num_outputs:
      self.add_module(f'pose_fc{num_layers}', Dense(width, num_outputs))
    self.pose_fc_aux = (Dense(in_features, aux_output_dim)
                        if aux_output_dim > 0 else None)

  def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
    with torch.no_grad():
      for module in self.modules():
        if isinstance(module, Dense):
          nn.init.trunc_normal_(module.weight, std=0.01, a=-0.02, b=0.02,
                                generator=generator)
          nn.init.constant_(module.bias, 0.01)
        elif isinstance(module, LayerNorm):
          module.scale.fill_(1.0)
          module.bias.zero_()
      if self.bias_transform is not None:
        self.bias_transform.fill_(0.01)

  def forward(self, expected_feature_points: torch.Tensor,
              aux_input: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    net = expected_feature_points
    if aux_input is not None:
      net = torch.cat([net, aux_input], dim=1)
    if self.bias_transform is not None:
      tiled = self.bias_transform.expand(net.shape[0], -1).to(net.dtype)
      net = torch.cat([net, tiled], dim=1)
    for i in range(self.num_layers):
      net = getattr(self, f'pose_fc{i}')(net)
      net = F.relu(getattr(self, f'pose_norm{i}')(net))
    if self.num_outputs:
      net = getattr(self, f'pose_fc{self.num_layers}')(net)
    aux_output = None
    if self.pose_fc_aux is not None:
      aux_output = self.pose_fc_aux(expected_feature_points)
    return net, aux_output
