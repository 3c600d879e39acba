"""The dense attention oracle of ``tensor2robot_tpu/parallel/sequence_parallel.py``.

Ring and Ulysses sequence parallelism are not ported yet (ROADMAP.md
queue 1 item 10); :func:`reference_attention` is the single-device dense
path that ``layers.snail.MultiHeadAttentionBlock`` falls back to when the
flash kernels are not taken.
"""

from __future__ import annotations

import math

import torch


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
  """Plain full attention on [B, T, H, D], in float32, returned in q's
  dtype."""
  scale = 1.0 / math.sqrt(q.shape[-1])
  logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
  if causal:
    t = q.shape[1]
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, float('-inf'))
  probs = torch.softmax(logits, dim=-1)
  return torch.einsum('bhqk,bkhd->bqhd', probs, v.float()).to(q.dtype)
