"""ResNet v1/v2 (18-200) with per-block FiLM conditioning.

The port's counterpart of ``tensor2robot_tpu/layers/resnet.py``: the same
block sizes, blocks, endpoints and FiLM generator.

Layout: the modules take NHWC images, as the JAX ones do, and run their
convs on the NCHW view of the same storage (channels-last memory), so the
endpoints (returned NHWC) and the stem pool's NHWC kernel entry are free
``permute`` views of the conv activations.

Numerics follow flax's modules:

* convs have no bias; every padding is symmetric, (k - 1) // 2 on each
  side for the odd kernels a ResNet uses (7 -> 3, 3 -> 1, 1 -> 0), which
  is both the JAX module's explicit padding of strided convs and its SAME
  padding at stride 1, so the conv pads itself (no padded copy);
* ``_BatchNorm`` is ``flax.linen.BatchNorm`` (``layers/normalization.py``)
  with momentum 0.997 and epsilon 1e-5: statistics in float32, output in
  the input's dtype;
* ``dtype`` is the activation dtype of the convs and ``final_dense``
  (bfloat16 on the card); None computes in the promotion of the input and
  the float32 parameters. The FiLM generator's dense layers always take
  the promotion.

The stem's 3x3/s2 max pool with (1, 1) padding on both axes goes through
``ops/pool.max_pool`` (the CUDA kernels on the card: overlapping windows,
so the backward takes the gather route) when ``kernel_policy`` enables
pools, else through ``ops/pool.reference_max_pool``. Under a
``remat_policy`` other than 'none' each residual block is a recompute
region (``layers/remat.py``).

Parameter and buffer names follow the flax tree, so that
``utils/convert.resnet_variables_to_torch`` maps it leaf by leaf:
``initial_conv.weight`` (OIHW), ``block_layer<i>_block<j>.{conv1,conv2,
conv3,proj}.weight``, flax's auto-numbered ``_BatchNorm_<n>`` as
``bn<n>`` (in the order the JAX module calls them, in a block and at the
top, where ``bn0`` is v1's stem norm or v2's final norm),
``final_dense.{weight,bias}``; ``FilmResNet`` holds ``resnet`` and
``film_generator.film<i>``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import normalization, remat
from tensor2robot_tpu_torch.layers.vision_layers import Dense
from tensor2robot_tpu_torch.ops import _dispatch as dispatch
from tensor2robot_tpu_torch.ops import pool as pool_ops

BLOCK_SIZES = {
    18: [2, 2, 2, 2],
    34: [3, 4, 6, 3],
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
    200: [3, 24, 36, 3],
}

# v1/v2 bottleneck cutoff: sizes < 50 use basic blocks.
_BOTTLENECK_MIN_SIZE = 50
_STEM_POOL = dict(window=(3, 3), strides=(2, 2), pads=((1, 1), (1, 1)))


def apply_film(inputs: torch.Tensor,
               film_gamma_beta: Optional[torch.Tensor]) -> torch.Tensor:
  """(1 + gamma) * x + beta on NCHW ``inputs``, gamma and beta split from
  a [B, 2C] ``film_gamma_beta`` and cast to the input's dtype."""
  if film_gamma_beta is None:
    return inputs
  gamma, beta = torch.chunk(film_gamma_beta, 2, dim=-1)
  gamma = (1.0 + gamma)[:, :, None, None].to(inputs.dtype)
  beta = beta[:, :, None, None].to(inputs.dtype)
  return gamma * inputs + beta


def variance_scaling_fan_out_(weight: torch.Tensor,
                              generator: Optional[torch.Generator] = None
                              ) -> None:
  """flax's ``variance_scaling(2.0, 'fan_out', 'truncated_normal')`` for
  an OIHW conv weight: fan_out = kh * kw * out, a normal of variance
  2 / fan_out truncated at two standard deviations (std corrected for the
  truncation)."""
  out_channels, _, kh, kw = weight.shape
  std = math.sqrt(2.0 / (kh * kw * out_channels)) / .87962566103423978
  nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                        generator=generator)


class _BatchNorm(normalization.BatchNorm):
  """BatchNorm over NCHW channels with the TF official model's
  hyperparameters (momentum .997, eps 1e-5), output in the input's dtype."""

  def __init__(self, features: int):
    super().__init__(features, use_scale=True, momentum=0.997, epsilon=1e-5)

  def forward(self, x: torch.Tensor) -> torch.Tensor:  # pylint: disable=arguments-differ
    return super().forward(x, feature_dim=1).to(x.dtype)


class _Conv(nn.Module):
  """Bias-free NCHW conv with an OIHW ``weight`` and symmetric padding
  (k - 1) // 2."""

  def __init__(self, in_features: int, features: int, kernel: int,
               strides: int, dtype: Optional[torch.dtype]):
    super().__init__()
    if kernel % 2 != 1:
      raise ValueError(f'ResNet convs have odd kernels, got {kernel}.')
    self.strides, self.padding, self.dtype = strides, (kernel - 1) // 2, dtype
    self.weight = nn.Parameter(
        torch.zeros(features, in_features, kernel, kernel))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dtype = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
    return F.conv2d(x.to(dtype), self.weight.to(dtype), stride=self.strides,
                    padding=self.padding)


class _Block(nn.Module):
  """One residual block, v1 or v2, basic or bottleneck, FiLM-aware, on
  NCHW tensors; one recompute region under a ``remat_policy`` other than
  'none'."""

  def __init__(self, in_features: int, filters: int, strides: int,
               bottleneck: bool, version: int, project_shortcut: bool,
               dtype: Optional[torch.dtype] = None,
               remat_policy: str = 'none'):
    super().__init__()
    self.bottleneck, self.version = bottleneck, version
    self.project_shortcut = project_shortcut
    self.remat_policy = remat.validate_remat_policy(remat_policy)
    out_filters = filters * (4 if bottleneck else 1)
    # Convs and norms in the order the JAX block creates them, so the norms'
    # indices are flax's auto-numbering.
    norms: List[int] = []
    if version == 2:
      norms.append(in_features)
    if project_shortcut:
      self.proj = _Conv(in_features, out_filters, 1, strides, dtype)
      if version == 1:
        norms.append(out_filters)
    if bottleneck:
      self.conv1 = _Conv(in_features, filters, 1, 1, dtype)
      self.conv2 = _Conv(filters, filters, 3, strides, dtype)
      self.conv3 = _Conv(filters, out_filters, 1, 1, dtype)
      norms += [filters, filters]
    else:
      self.conv1 = _Conv(in_features, filters, 3, strides, dtype)
      self.conv2 = _Conv(filters, out_filters, 3, 1, dtype)
      norms.append(filters)
    if version == 1:
      norms.append(out_filters)
    for i, features in enumerate(norms):
      self.add_module(f'bn{i}', _BatchNorm(features))

  def _bn(self, i: int) -> _BatchNorm:
    return getattr(self, f'bn{i}')

  def _residual(self, net: torch.Tensor, first_bn: int) -> torch.Tensor:
    """conv1 -> (bn, relu, conv2)... through the last conv; norms from
    ``first_bn`` on."""
    net = self.conv1(net)
    net = F.relu(self._bn(first_bn)(net))
    net = self.conv2(net)
    if self.bottleneck:
      net = F.relu(self._bn(first_bn + 1)(net))
      net = self.conv3(net)
    return net

  def _block(self, x: torch.Tensor,
             film_gamma_beta: Optional[torch.Tensor]) -> torch.Tensor:
    shortcut = x
    if self.version == 2:
      # Pre-activation; the projection is taken from the pre-activated input.
      pre = F.relu(self.bn0(x))
      if self.project_shortcut:
        shortcut = self.proj(pre)
      net = self._residual(pre, 1)
      # FiLM on the block output before the residual add.
      return apply_film(net, film_gamma_beta) + shortcut
    # v1: post-activation.
    first = 0
    if self.project_shortcut:
      shortcut = self.bn0(self.proj(x))
      first = 1
    net = self._residual(x, first)
    net = self._bn(first + (2 if self.bottleneck else 1))(net)
    # FiLM before the final ReLU.
    net = apply_film(net, film_gamma_beta)
    return F.relu(net + shortcut)

  def forward(self, x: torch.Tensor,
              film_gamma_beta: Optional[torch.Tensor] = None) -> torch.Tensor:
    return remat.checkpointed(self._block, self.remat_policy, x,
                              film_gamma_beta)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
  return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
  return x.permute(0, 3, 1, 2)


class ResNet(nn.Module):
  """ResNet v1/v2 with optional FiLM conditioning per block.

  ``forward(images, film_gamma_betas=None)`` takes NHWC ``images`` and
  returns ``(logits_or_features, endpoints)``; the endpoints are NHWC
  views: ``initial_conv``, ``initial_max_pool``, ``block_layer{1..4}``,
  ``pre_final_pool``, ``final_reduce_mean``, ``final_dense``. Train or
  eval batch norm follows ``self.training``.

  ``film_gamma_betas[i][j]`` conditions block j of block layer i with a
  [B, 2 * C_out] tensor (or None): the :class:`LinearFilmGenerator` layout.
  ``in_channels`` is the images' channel count (the JAX module infers it).
  """

  def __init__(self,
               resnet_size: int = 50,
               num_classes: Optional[int] = None,
               num_filters: int = 64,
               version: int = 2,
               first_pool: bool = True,
               include_initial_layers: bool = True,
               dtype: Optional[torch.dtype] = None,
               remat_policy: str = 'none',
               kernel_policy: str = 'none',
               in_channels: int = 3):
    super().__init__()
    if version not in (1, 2):
      raise ValueError(f'ResNet version must be 1 or 2, got {version}.')
    self.resnet_size, self.num_classes = resnet_size, num_classes
    self.num_filters, self.version = num_filters, version
    self.first_pool = first_pool
    self.include_initial_layers = include_initial_layers
    self.dtype = dtype
    self.remat_policy = remat.validate_remat_policy(remat_policy)
    self.kernel_policy = dispatch.validate_kernel_policy(kernel_policy)
    bottleneck = resnet_size >= _BOTTLENECK_MIN_SIZE
    features = in_channels
    if include_initial_layers:
      self.initial_conv = _Conv(in_channels, num_filters, 7, 2, dtype)
      features = num_filters
      if version == 1:
        self.bn0 = _BatchNorm(num_filters)
    self._blocks: List[List[str]] = []
    for i, num_blocks in enumerate(self.block_sizes):
      filters = num_filters * (2**i)
      names = []
      for j in range(num_blocks):
        name = f'block_layer{i + 1}_block{j}'
        self.add_module(name, _Block(
            features, filters, (1 if i == 0 else 2) if j == 0 else 1,
            bottleneck, version, project_shortcut=(j == 0), dtype=dtype,
            remat_policy=self.remat_policy))
        features = filters * (4 if bottleneck else 1)
        names.append(name)
      self._blocks.append(names)
    if version == 2:
      self.bn0 = _BatchNorm(features)
    if num_classes is not None:
      self.final_dense = Dense(features, num_classes)

  @property
  def block_sizes(self) -> List[int]:
    return BLOCK_SIZES[self.resnet_size]

  @property
  def filter_sizes(self) -> List[int]:
    mult = 4 if self.resnet_size >= _BOTTLENECK_MIN_SIZE else 1
    return [self.num_filters * (2**i) * mult for i in range(4)]

  def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
    """The JAX module's initialisers: conv kernels from
    :func:`variance_scaling_fan_out_`, ``final_dense`` lecun-normal with a
    zero bias; batch norms scale one, bias zero, mean zero, variance one."""
    with torch.no_grad():
      for module in self.modules():
        if isinstance(module, _Conv):
          variance_scaling_fan_out_(module.weight, generator)
        elif isinstance(module, _BatchNorm):
          module.scale.fill_(1.0)
          module.bias.zero_()
          module.mean.zero_()
          module.var.fill_(1.0)
      if self.num_classes is not None:
        self.final_dense.init_weights(generator)

  def _stem_pool(self, net: torch.Tensor) -> torch.Tensor:
    """The 3x3/s2 pool with (1, 1) padding, on the NHWC view."""
    x = _nhwc(net)
    if dispatch.policy_enables_pool(self.kernel_policy):
      pooled = pool_ops.max_pool(x.contiguous(), _STEM_POOL['window'],
                                 _STEM_POOL['strides'], _STEM_POOL['pads'])
    else:
      pooled = pool_ops.reference_max_pool(x, _STEM_POOL['window'],
                                           _STEM_POOL['strides'],
                                           _STEM_POOL['pads'])
    return _nchw(pooled)

  def forward(self, images: torch.Tensor,
              film_gamma_betas: Optional[Sequence[Sequence[Optional[
                  torch.Tensor]]]] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    if film_gamma_betas is None:
      film_gamma_betas = [[None] * n for n in self.block_sizes]
    endpoints: Dict[str, torch.Tensor] = {}
    net = images if self.dtype is None else images.to(self.dtype)
    net = _nchw(net).contiguous(memory_format=torch.channels_last)
    if self.include_initial_layers:
      net = self.initial_conv(net)
      if self.version == 1:
        net = F.relu(self.bn0(net))
      endpoints['initial_conv'] = _nhwc(net)
      if self.first_pool:
        net = self._stem_pool(net)
      endpoints['initial_max_pool'] = _nhwc(net)

    for i, names in enumerate(self._blocks):
      for j, name in enumerate(names):
        net = getattr(self, name)(net, film_gamma_betas[i][j])
      endpoints[f'block_layer{i + 1}'] = _nhwc(net)

    if self.version == 2:
      net = F.relu(self.bn0(net))
    endpoints['pre_final_pool'] = _nhwc(net)
    # The mean accumulates in at least float32 and returns in the
    # activation dtype, as jnp.mean does.
    net = net.to(torch.promote_types(net.dtype, torch.float32)).mean(
        dim=(2, 3)).to(net.dtype)
    endpoints['final_reduce_mean'] = net
    if self.num_classes is not None:
      dense = self.final_dense
      dtype = self.dtype or torch.promote_types(net.dtype, dense.weight.dtype)
      net = F.linear(net.to(dtype), dense.weight.to(dtype),
                     dense.bias.to(dtype))
      endpoints['final_dense'] = net
    return net, endpoints


class LinearFilmGenerator(nn.Module):
  """Linear FiLM gamma/beta generator for every enabled block layer.

  ``forward(embedding)`` returns ``film_gamma_betas[i][j]`` of shape
  [B, 2 * C_out_i], or None for a disabled layer; ``film<i>`` is a Dense
  ``embedding_size -> num_blocks * C_out_i * 2``, computed in the
  promotion of the embedding and its float32 parameters.
  """

  def __init__(self, embedding_size: int, block_sizes: Sequence[int],
               filter_sizes: Sequence[int],
               enabled_block_layers: Optional[Sequence[bool]] = None):
    super().__init__()
    if enabled_block_layers and (
        len(enabled_block_layers) != len(block_sizes)):
      raise ValueError(
          f'Got {len(enabled_block_layers)} bools for '
          f'enabled_block_layers, expected {len(block_sizes)}')
    self.block_sizes = tuple(block_sizes)
    self.filter_sizes = tuple(filter_sizes)
    self.enabled_block_layers = (tuple(enabled_block_layers)
                                 if enabled_block_layers else None)
    for i, num_blocks in enumerate(self.block_sizes):
      if self._enabled(i):
        self.add_module(f'film{i}', Dense(
            embedding_size, num_blocks * self.filter_sizes[i] * 2))

  def _enabled(self, i: int) -> bool:
    return not self.enabled_block_layers or self.enabled_block_layers[i]

  def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
    for child in self.children():
      child.init_weights(generator)

  def forward(self, embedding: torch.Tensor
              ) -> List[List[Optional[torch.Tensor]]]:
    film_gamma_betas: List[List[Optional[torch.Tensor]]] = []
    for i, num_blocks in enumerate(self.block_sizes):
      if not self._enabled(i):
        film_gamma_betas.append([None] * num_blocks)
        continue
      flat = getattr(self, f'film{i}')(embedding)
      film_gamma_betas.append(list(torch.chunk(flat, num_blocks, dim=-1)))
    return film_gamma_betas


class FilmResNet(nn.Module):
  """ResNet whose blocks are conditioned on an embedding through FiLM:
  embedding -> linear gamma/beta per block -> conditioned ResNet forward.

  ``embedding_size`` declares the conditioning width (the JAX module
  creates its generator at the first call with an embedding); without it
  there is no generator and ``forward`` takes no embedding.
  """

  def __init__(self,
               resnet_size: int = 50,
               num_classes: Optional[int] = None,
               version: int = 2,
               enabled_block_layers: Optional[Sequence[bool]] = None,
               dtype: Optional[torch.dtype] = None,
               remat_policy: str = 'none',
               kernel_policy: str = 'none',
               embedding_size: Optional[int] = None,
               in_channels: int = 3):
    super().__init__()
    self.resnet = ResNet(resnet_size=resnet_size, num_classes=num_classes,
                         version=version, dtype=dtype,
                         remat_policy=remat_policy,
                         kernel_policy=kernel_policy,
                         in_channels=in_channels)
    if embedding_size is not None:
      self.film_generator = LinearFilmGenerator(
          embedding_size, BLOCK_SIZES[resnet_size],
          self.resnet.filter_sizes, enabled_block_layers)

  def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
    self.resnet.init_weights(generator)
    if hasattr(self, 'film_generator'):
      self.film_generator.init_weights(generator)

  def forward(self, images: torch.Tensor,
              embedding: Optional[torch.Tensor] = None):
    film_gamma_betas = None
    if embedding is not None:
      if not hasattr(self, 'film_generator'):
        raise ValueError('FilmResNet was built without embedding_size, so '
                         'it takes no embedding.')
      film_gamma_betas = self.film_generator(embedding)
    return self.resnet(images, film_gamma_betas)


def resnet_model(images, is_training: bool, num_classes: Optional[int] = None,
                 resnet_size: int = 50, **unused_kwargs):
  """Functional alias mirroring the reference builder's call shape: the
  module twice, as the JAX alias returns it (``images`` gives the input
  channels; apply the module with ``train()`` / ``eval()`` set from
  ``is_training``)."""
  del unused_kwargs
  model = ResNet(resnet_size=resnet_size, num_classes=num_classes,
                 in_channels=int(images.shape[-1]))
  model.train(is_training)
  return model, model
