"""Grasp2Vec heatmap localization.

The port's counterpart of ``tensor2robot_tpu/research/grasp2vec/
visualization.py``: correlate a goal embedding against a scene's spatial
feature map, and read the response as a softmax heatmap or as the
expected (x, y) of a spatial softmax (``layers/spatial_softmax.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from tensor2robot_tpu_torch.layers.spatial_softmax import spatial_softmax


def get_softmax_response(goal_embedding: torch.Tensor,
                         scene_spatial: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Correlation heatmap and its maximal response.

  Args:
    goal_embedding: [B, C] goal vectors.
    scene_spatial: [B, H, W, C] scene feature maps.

  Returns:
    (heatmap [B, H, W, 1] softmaxed over the pixels, response [B]: the
    maximal logit), in the promotion of the two inputs' dtypes.
  """
  heatmap_logits = torch.einsum('bhwc,bc->bhw', *_promoted(scene_spatial,
                                                           goal_embedding))
  batch, h, w = heatmap_logits.shape
  flat = heatmap_logits.reshape(batch, h * w)
  softmax = torch.softmax(flat, dim=-1).reshape(batch, h, w, 1)
  response = torch.amax(flat, dim=-1)
  return softmax, response


def heatmap_keypoints(goal_embedding: torch.Tensor,
                      scene_spatial: torch.Tensor) -> torch.Tensor:
  """Expected (x, y) in [-1, 1] of the correlation heatmap, [B, 2]."""
  heatmap = torch.einsum('bhwc,bc->bhw', *_promoted(scene_spatial,
                                                    goal_embedding))
  points, _ = spatial_softmax(heatmap[..., None])
  return points


def _promoted(*tensors: torch.Tensor):
  dtype = tensors[0].dtype
  for t in tensors[1:]:
    dtype = torch.promote_types(dtype, t.dtype)
  return [t.to(dtype) for t in tensors]
