"""Grasp2Vec embedding network.

The port's counterpart of ``tensor2robot_tpu/research/grasp2vec/
networks.py``: a ResNet trunk (``layers/resnet.py``) producing spatial
feature maps, relu'd, mean-pooled into the embedding vector.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers.resnet import ResNet


class Embedding(nn.Module):
  """Scene/goal embedding: ``forward(image)`` -> (vector, spatial map).

  ``image`` is NHWC. ``dtype`` is the tower's activation dtype (bfloat16
  on the card); the spatial map [B, H, W, C] (NHWC view) stays in it,
  while the embedding vector [B, C] is the spatial mean taken in float32:
  it feeds the numerically sensitive embedding-arithmetic losses. Train or
  eval batch norm follows ``self.training``.
  """

  def __init__(self, resnet_size: int = 50,
               dtype: Optional[torch.dtype] = None,
               remat_policy: str = 'none', kernel_policy: str = 'none'):
    super().__init__()
    self.resnet = ResNet(resnet_size=resnet_size, num_classes=None,
                         dtype=dtype, remat_policy=remat_policy,
                         kernel_policy=kernel_policy)

  def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
    self.resnet.init_weights(generator)

  def forward(self, image: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    _, endpoints = self.resnet(image)
    spatial = F.relu(endpoints['pre_final_pool'])
    summed = torch.mean(spatial.float(), dim=(1, 2))
    return summed, spatial
