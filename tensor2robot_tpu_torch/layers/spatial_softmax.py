"""Spatial softmax: expected 2-D feature coordinates (soft arg-max).

The port's counterpart of ``tensor2robot_tpu/layers/spatial_softmax.py``:
one softmax over the flattened pixels of each channel and one matmul
against the coordinate grid. Coordinates lie in [-1, 1]; the inner
dimension is ordered ``[x1..xC, y1..yC]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _coordinate_grid(num_rows: int, num_cols: int, dtype,
                     device) -> torch.Tensor:
  """[num_rows*num_cols, 2] grid of (x, y) in [-1, 1]."""
  ys = torch.linspace(-1.0, 1.0, num_rows, dtype=dtype, device=device)
  xs = torch.linspace(-1.0, 1.0, num_cols, dtype=dtype, device=device)
  grid_y, grid_x = torch.meshgrid(ys, xs, indexing='ij')
  return torch.stack([grid_x.reshape(-1), grid_y.reshape(-1)], dim=-1)


def spatial_softmax(features: torch.Tensor,
                    temperature: float = 1.0,
                    spatial_gumbel_softmax: bool = False,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Expected feature coordinates of [B, H, W, C] feature maps.

  Computes in the promotion of the features' dtype and float32, and
  returns in the features' dtype:
  (expected_feature_points [B, 2*C] ordered [x1..xC, y1..yC],
   softmax [B, H, W, C]). ``spatial_gumbel_softmax`` adds Gumbel noise
  drawn from ``generator`` (which it requires) to the logits: a relaxed
  one-hot sample at temperature 1.
  """
  batch, num_rows, num_cols, num_features = features.shape
  compute_dtype = torch.promote_types(features.dtype, torch.float32)
  logits = features.permute(0, 3, 1, 2).reshape(
      batch, num_features, num_rows * num_cols).to(compute_dtype)
  logits = logits / temperature
  if spatial_gumbel_softmax:
    if generator is None:
      raise ValueError('spatial_gumbel_softmax requires a generator.')
    tiny = torch.finfo(compute_dtype).tiny
    uniform = torch.rand(logits.shape, generator=generator,
                         dtype=compute_dtype, device=generator.device)
    gumbel = -torch.log(-torch.log(uniform.clamp_min(tiny)))
    logits = logits + gumbel.to(logits.device)
  attention = torch.softmax(logits, dim=-1)
  grid = _coordinate_grid(num_rows, num_cols, compute_dtype, features.device)
  expected_xy = attention @ grid  # [B, C, 2]
  points = torch.cat([expected_xy[..., 0], expected_xy[..., 1]], dim=-1)
  softmax_maps = attention.reshape(batch, num_features, num_rows,
                                   num_cols).permute(0, 2, 3, 1)
  return points.to(features.dtype), softmax_maps.to(features.dtype)
