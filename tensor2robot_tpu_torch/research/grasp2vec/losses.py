"""Grasp2Vec embedding losses.

The port's counterpart of ``tensor2robot_tpu/research/grasp2vec/
losses.py``: N-pairs (both directions), semi-hard triplet, L2 and cosine
arithmetic consistency (``pregrasp - postgrasp ~ goal``) and keypoint
quadrant accuracy, with the reference's class-style aliases.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _npairs_loss(labels: torch.Tensor, embeddings_anchor: torch.Tensor,
                 embeddings_positive: torch.Tensor) -> torch.Tensor:
  """Softmax cross entropy over anchor . positive^T similarities."""
  logits = embeddings_anchor @ embeddings_positive.T
  log_probs = torch.log_softmax(logits, dim=1)
  one_hot = F.one_hot(labels, logits.shape[1]).to(log_probs.dtype)
  return -torch.mean(torch.sum(one_hot * log_probs, dim=1))


def npairs_loss(pregrasp_embedding: torch.Tensor,
                goal_embedding: torch.Tensor,
                postgrasp_embedding: torch.Tensor,
                non_negativity_constraint: bool = False) -> torch.Tensor:
  """Bidirectional N-pairs on (pre - post, goal)."""
  pair_a = pregrasp_embedding - postgrasp_embedding
  if non_negativity_constraint:
    pair_a = F.relu(pair_a)
  pair_b = goal_embedding
  labels = torch.arange(pair_a.shape[0], device=pair_a.device)
  return (_npairs_loss(labels, pair_a, pair_b) +
          _npairs_loss(labels, pair_b, pair_a))


def _masked_mean(distances: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
  mask = mask.to(torch.float32).reshape(-1)
  total = torch.sum(mask)
  return torch.where(total > 0,
                     torch.sum(distances * mask) / torch.clamp_min(total, 1.0),
                     torch.zeros((), dtype=distances.dtype,
                                 device=distances.device))


def l2_arithmetic_loss(pregrasp_embedding, goal_embedding,
                       postgrasp_embedding, mask) -> torch.Tensor:
  """Masked mean ||pre - goal - post||^2."""
  raw = pregrasp_embedding - goal_embedding - postgrasp_embedding
  return _masked_mean(torch.sum(torch.square(raw), dim=1), mask)


def _normalize(x: torch.Tensor) -> torch.Tensor:
  return x / torch.clamp_min(torch.linalg.norm(x, dim=1, keepdim=True), 1e-12)


def cosine_arithmetic_loss(pregrasp_embedding, goal_embedding,
                           postgrasp_embedding, mask) -> torch.Tensor:
  """Masked mean cosine distance of (pre - post) against goal."""
  pair_a = _normalize(pregrasp_embedding - postgrasp_embedding)
  pair_b = _normalize(goal_embedding)
  return _masked_mean(1.0 - torch.sum(pair_a * pair_b, dim=1), mask)


def triplet_semihard_loss(labels: torch.Tensor, embeddings: torch.Tensor,
                          margin: float = 1.0) -> torch.Tensor:
  """Semi-hard mining triplet loss: for each anchor-positive pair (i, j)
  the negative is the closest one farther than d(i, j), or the farthest
  negative where none is."""
  dots = embeddings @ embeddings.T
  sq = torch.diagonal(dots)
  pdist = torch.clamp_min(sq[:, None] - 2 * dots + sq[None, :], 0.0)
  adjacency = labels[:, None] == labels[None, :]
  batch = embeddings.shape[0]

  inf = torch.tensor(1e9, dtype=pdist.dtype, device=pdist.device)
  neg_mask = (~adjacency)[:, None, :]  # [i, j, k]: k a negative of i
  d_ij = pdist[:, :, None]
  d_ik = pdist[:, None, :].expand(batch, batch, batch)
  semihard = neg_mask & (d_ik > d_ij)
  semihard_min = torch.amin(torch.where(semihard, d_ik, inf), dim=2)
  hardest_max = torch.amax(torch.where(neg_mask, d_ik, -inf), dim=2)
  neg_dist = torch.where(semihard_min < inf, semihard_min, hardest_max)

  loss_mat = torch.clamp_min(pdist + margin - neg_dist, 0.0)
  pos_mask = adjacency & ~torch.eye(batch, dtype=torch.bool,
                                    device=adjacency.device)
  num_pos = torch.clamp_min(torch.sum(pos_mask).to(pdist.dtype), 1.0)
  return torch.sum(torch.where(pos_mask, loss_mat,
                               torch.zeros_like(loss_mat))) / num_pos


def triplet_loss(pregrasp_embedding, goal_embedding, postgrasp_embedding
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Semi-hard triplet (margin 3) on the normalized (pre - post) and goal
  vectors; returns (loss, pairs, labels)."""
  pair_a = _normalize(pregrasp_embedding - postgrasp_embedding)
  pair_b = _normalize(goal_embedding)
  labels = torch.arange(pair_a.shape[0], device=pair_a.device)
  labels = torch.cat([labels, labels])
  pairs = torch.cat([pair_a, pair_b], dim=0)
  return triplet_semihard_loss(labels, pairs, margin=3.0), pairs, labels


def keypoint_accuracy(keypoints: torch.Tensor, labels: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Quadrant accuracy of spatial-softmax keypoints: (accuracy, the mean
  sigmoid cross entropy of the quadrant logits against one-hot labels)."""
  keypoints = keypoints.reshape(-1, 2)
  quadrant_centers = torch.tensor(
      [[0.5, -0.5], [-0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]],
      dtype=torch.float32, device=keypoints.device)
  logits = keypoints @ quadrant_centers.T
  predictions = torch.argmax(logits, dim=1)
  labels = labels.reshape(-1).to(torch.int64)
  correct = torch.mean((predictions == labels).to(torch.float32))
  labels_onehot = F.one_hot(labels, 4).to(torch.float32)
  per_elem = (torch.clamp_min(logits, 0) - logits * labels_onehot +
              torch.log1p(torch.exp(-torch.abs(logits))))
  return correct, torch.mean(per_elem)


# Reference-name aliases.
NPairsLoss = npairs_loss
TripletLoss = triplet_loss
L2ArithmeticLoss = l2_arithmetic_loss
CosineArithmeticLoss = cosine_arithmetic_loss
KeypointAccuracy = keypoint_accuracy
