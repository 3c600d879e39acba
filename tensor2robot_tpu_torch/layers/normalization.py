"""flax.linen's BatchNorm and LayerNorm, as the JAX package's modules use them.

The port keeps its own copies of flax's normalisation numerics, which
differ from torch's defaults:

* statistics are computed in at least float32 with flax's fast variance,
  ``max(E[x^2] - E[x]^2, 0)`` (biased);
* the output is ``(x - mean) * (rsqrt(var + eps) * scale) + bias``;
* :class:`LayerNorm` reduces over the feature dimension only, with
  ``epsilon=1e-6`` (torch's ``nn.LayerNorm`` uses 1e-5) and an optional
  scale (``use_scale``);
* :class:`BatchNorm` keeps running averages updated as ``momentum * old +
  (1 - momentum) * new`` (flax's ``momentum=0.99`` is torch's 0.01) in the
  ``mean`` / ``var`` buffers, and normalises with the batch statistics in
  train mode (``self.training``), with the running ones otherwise; the
  averages are not updated again while a recompute region replays the
  forward (:func:`update_running_stats`).

Both take the feature dimension as an argument, so NHWC and NCHW tensors
normalise alike. The output is cast to ``dtype`` when given, else it
keeps the promotion of the input and the float32 parameters, as flax's
``dtype=None`` does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tensor2robot_tpu_torch.layers import remat


def batch_stats(x: torch.Tensor, dims: Sequence[int]):
  """flax's fast variance over ``dims``: (mean, max(E[x^2] - E[x]^2, 0))
  in at least float32."""
  xf = x.to(torch.promote_types(x.dtype, torch.float32))
  mean = xf.mean(dim=dims)
  mean2 = (xf * xf).mean(dim=dims)
  return mean, torch.clamp_min(mean2 - mean * mean, 0.0)


def feature_shape(x: torch.Tensor, feature_dim: int):
  shape = [1] * x.dim()
  shape[feature_dim] = x.shape[feature_dim]
  return shape


@torch.no_grad()
def update_running_stats(module: nn.Module, mean: torch.Tensor,
                         var: torch.Tensor) -> None:
  """``momentum * old + (1 - momentum) * new`` into ``module.mean`` and
  ``module.var``, in place; skipped while a recompute region replays the
  forward (``layers/remat.py``), so the averages move once a step."""
  if remat.recomputing():
    return
  module.mean.copy_(module.momentum * module.mean +
                    (1.0 - module.momentum) * mean)
  module.var.copy_(module.momentum * module.var +
                   (1.0 - module.momentum) * var)


class BatchNorm(nn.Module):
  """``flax.linen.BatchNorm`` over one feature dimension (see module doc)."""

  def __init__(self, features: int, use_scale: bool, momentum: float,
               epsilon: float, dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
    if use_scale:
      self.scale = nn.Parameter(torch.ones(features))
    else:
      self.register_parameter('scale', None)
    self.bias = nn.Parameter(torch.zeros(features))
    self.register_buffer('mean', torch.zeros(features))
    self.register_buffer('var', torch.ones(features))

  def forward(self, x: torch.Tensor, feature_dim: int) -> torch.Tensor:
    feature_dim %= x.dim()
    if self.training:
      dims = [d for d in range(x.dim()) if d != feature_dim]
      mean, var = batch_stats(x, dims)
      update_running_stats(self, mean, var)
    else:
      mean, var = self.mean, self.var
    shape = feature_shape(x, feature_dim)
    y = x - mean.reshape(shape)
    mul = torch.rsqrt(var + self.epsilon)
    if self.scale is not None:
      mul = mul * self.scale
    y = y * mul.reshape(shape) + self.bias.reshape(shape)
    return y.to(self.dtype or y.dtype)


class LayerNorm(nn.Module):
  """``flax.linen.LayerNorm`` over one feature dimension (see module doc)."""

  def __init__(self, features: int, use_scale: bool = True,
               epsilon: float = 1e-6, dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.epsilon, self.dtype = epsilon, dtype
    if use_scale:
      self.scale = nn.Parameter(torch.ones(features))
    else:
      self.register_parameter('scale', None)
    self.bias = nn.Parameter(torch.zeros(features))

  def forward(self, x: torch.Tensor, feature_dim: int = -1) -> torch.Tensor:
    feature_dim %= x.dim()
    mean, var = batch_stats(x, [feature_dim])
    mean, var = mean.unsqueeze(feature_dim), var.unsqueeze(feature_dim)
    shape = feature_shape(x, feature_dim)
    y = x - mean
    mul = torch.rsqrt(var + self.epsilon)
    if self.scale is not None:
      mul = mul * self.scale.reshape(shape)
    y = y * mul + self.bias.reshape(shape)
    return y.to(self.dtype or y.dtype)
