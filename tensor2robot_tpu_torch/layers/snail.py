"""SNAIL meta-learner blocks: dilated causal convs and causal attention.

The port's counterpart of ``tensor2robot_tpu/layers/snail.py`` (Mishra et
al. 2017), on [B, T, C] tensors, with the same shape contracts and
parameter trees (``utils/convert.py`` maps the flax leaves):

* :class:`CausalConv`: left pad by ``(k - 1)·dilation``, then a VALID
  dilated 1-D conv (``conv.weight`` [out, in, k]);
* :class:`DenseBlock`: ``tanh(xf) · sigmoid(xg)`` concatenated to the input;
* :class:`TCBlock`: DenseBlocks with dilations 2¹..2^⌈log₂T⌉;
* :class:`AttentionBlock`: single-head causal attention, read concatenated
  (``key``, ``query``, ``value``: flax's ``Dense_0``, ``Dense_1``,
  ``Dense_2``);
* :class:`MultiHeadAttentionBlock`: H heads of size D.

Both attention blocks take the flash kernels (``ops/flash_attention.py``)
when ``use_flash`` is None (auto) and :func:`_flash_auto_ok` says the
activations lie on a CUDA device and the problem is supported; otherwise
the dense form. ``forward(x, serving=True)`` (the PREDICT path) takes the
flash forward wherever the problem is supported, on every device: it is
the custom op ``t2r::flash_fwd``, which launches the kernel on the card
and runs its plain version on the CPU, so an exported program holds the
kernel whatever device traced it, and the eager chain computes what the
program computes. ``use_flash=False`` pins the dense form.
``return_prob=True`` forces the dense form (the [B, T, T] probabilities
are what flash attention avoids) and cannot be combined with
``use_flash=True``. Every layer computes in the promotion of its input and
its float32 parameters, as the flax modules do.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers.vision_layers import (Dense,
                                                         lecun_normal_,
                                                         promoted)
from tensor2robot_tpu_torch.ops import flash_attention as fa
from tensor2robot_tpu_torch.parallel.sequence_parallel import (
    reference_attention)


class CausalConv(nn.Module):
  """Causal dilated 1-D conv over [B, T, C]."""

  def __init__(self, in_channels: int, filters: int, dilation_rate: int = 1,
               kernel_size: int = 2):
    super().__init__()
    self.dilation_rate = dilation_rate
    self.kernel_size = kernel_size
    self.conv = nn.Conv1d(in_channels, filters, kernel_size,
                          dilation=dilation_rate)

  def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
    lecun_normal_(self.conv.weight, self.conv.weight[0].numel(), generator)
    nn.init.zeros_(self.conv.bias)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    pad = (self.kernel_size - 1) * self.dilation_rate
    x = promoted(x, self.conv.weight)
    x = F.pad(x.transpose(1, 2), (pad, 0))  # [B, C, pad + T]
    out = F.conv1d(x, self.conv.weight.to(x.dtype),
                   self.conv.bias.to(x.dtype), dilation=self.dilation_rate)
    return out.transpose(1, 2)


class DenseBlock(nn.Module):
  """Gated activation, concatenated to the input: [B, T, C + filters]."""

  def __init__(self, in_channels: int, filters: int, dilation_rate: int = 1):
    super().__init__()
    self.xf = CausalConv(in_channels, filters, dilation_rate)
    self.xg = CausalConv(in_channels, filters, dilation_rate)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    activations = torch.tanh(self.xf(x)) * torch.sigmoid(self.xg(x))
    return torch.cat([promoted(x, activations), activations], dim=2)


class TCBlock(nn.Module):
  """DenseBlocks with dilations 2¹..2^⌈log₂T⌉ (``blocks[i - 1]`` is flax's
  ``DenseBlock_<i>``)."""

  def __init__(self, in_channels: int, sequence_length: int, filters: int):
    super().__init__()
    num_blocks = int(np.ceil(np.log2(sequence_length)))
    self.blocks = nn.ModuleList(
        DenseBlock(in_channels + (i - 1) * filters, filters, 2**i)
        for i in range(1, num_blocks + 1))
    self.out_channels = in_channels + num_blocks * filters

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for block in self.blocks:
      x = block(x)
    return x


def causally_masked_softmax(logits: torch.Tensor) -> torch.Tensor:
  """Softmax over the last dim of [B, T, T] logits with positions j > i
  masked out."""
  t = logits.shape[-1]
  mask = torch.ones((t, t), dtype=torch.bool, device=logits.device).tril()
  return torch.softmax(logits.masked_fill(~mask, float('-inf')), dim=-1)


def _flash_pad_dim(key_size: int, value_size: int) -> int:
  """Shared head dim for the flash kernels: max(dk, dv) rounded up to 8."""
  d = max(key_size, value_size)
  return -(-d // 8) * 8


def flash_supported(t: int, key_size: int, value_size: int,
                    itemsize: int = 2) -> bool:
  """Whether the flash path can serve an AttentionBlock problem."""
  return fa.is_supported(t, _flash_pad_dim(key_size, value_size),
                         itemsize=itemsize)


def _flash_auto_ok(x: torch.Tensor) -> bool:
  """Auto-dispatch gate: the activations lie on a CUDA device (where the
  flash kernels launch). On the CPU the dense form is the faster path.
  Tests monkeypatch this to exercise the flash path's plain versions."""
  return x.device.type == 'cuda'


def _flash_causal_read(query: torch.Tensor, key: torch.Tensor,
                       values: torch.Tensor) -> torch.Tensor:
  """Causal attention read through the flash kernels, O(T·D) memory.

  q/k ([B, T, dk]) and v ([B, T, dv]) are zero-padded to one 8-aligned
  head dim (zero pads contribute nothing to q·kᵀ or the read), and q is
  pre-scaled so the kernel's 1/√d_pad matches the SNAIL 1/√dk logits.
  """
  dk, dv = query.shape[-1], values.shape[-1]
  d = _flash_pad_dim(dk, dv)
  query = query * float(np.sqrt(d / dk))

  def pad(x):
    need = d - x.shape[-1]
    if need:
      x = F.pad(x, (0, need))
    return x[:, :, None, :]  # single head: [B, T, 1, d]

  out = fa.flash_attention(pad(query), pad(key), pad(values), causal=True)
  return out[:, :, 0, :dv]


class AttentionBlock(nn.Module):
  """Causal single-head attention, read concatenated:
  ``forward(x) -> ([B, T, C + value_size], end_points)``.

  ``end_points`` holds ``{'attn_prob': [B, T, T]}`` only under
  ``return_prob=True``, which forces the dense path.
  """

  def __init__(self, in_channels: int, key_size: int, value_size: int,
               return_prob: bool = False, use_flash: Optional[bool] = None):
    super().__init__()
    self.key_size, self.value_size = key_size, value_size
    self.return_prob, self.use_flash = return_prob, use_flash
    self.key = Dense(in_channels, key_size)
    self.query = Dense(in_channels, key_size)
    self.value = Dense(in_channels, value_size)
    self.out_channels = in_channels + value_size

  def forward(self, x: torch.Tensor, serving: bool = False
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    key, query, values = self.key(x), self.query(x), self.value(x)
    t = x.shape[1]
    use_flash = self.use_flash
    if use_flash is None:
      use_flash = (not self.return_prob and
                   (serving or _flash_auto_ok(query)) and
                   flash_supported(t, self.key_size, self.value_size,
                                   itemsize=query.dtype.itemsize))
    if use_flash:
      if self.return_prob:
        raise ValueError(
            'return_prob=True requires the dense path (the [B, T, T] '
            'probability tensor is what flash attention avoids); do not '
            'combine it with use_flash=True.')
      read = _flash_causal_read(query, key, values)
      return torch.cat([promoted(x, read), read], dim=2), {}
    logits = torch.einsum('btk,bsk->bts', query, key)
    probs = causally_masked_softmax(logits / math.sqrt(self.key_size))
    read = torch.einsum('bts,bsv->btv', probs, values)
    end_points = {'attn_prob': probs} if self.return_prob else {}
    return torch.cat([promoted(x, read), read], dim=2), end_points


class MultiHeadAttentionBlock(nn.Module):
  """Causal multi-head SNAIL attention for long-horizon sequences.

  H heads of size D: the flash kernels when ``use_flash`` (or, under None,
  ``serving`` or :func:`_flash_auto_ok`, and
  :func:`~tensor2robot_tpu_torch.ops.flash_attention.is_supported`),
  otherwise the dense oracle. Returns ``([B, T, C + H·D], {})``. The JAX
  block's ``attention_fn`` (ring/Ulysses sequence parallelism) is not
  ported yet.
  """

  def __init__(self, in_channels: int, num_heads: int, head_size: int,
               use_flash: Optional[bool] = None):
    super().__init__()
    self.num_heads, self.head_size = num_heads, head_size
    self.use_flash = use_flash
    self.query = Dense(in_channels, num_heads * head_size)
    self.key = Dense(in_channels, num_heads * head_size)
    self.value = Dense(in_channels, num_heads * head_size)
    self.out_channels = in_channels + num_heads * head_size

  def forward(self, x: torch.Tensor, serving: bool = False
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    b, t = x.shape[:2]
    h, d = self.num_heads, self.head_size

    def heads(dense):
      return dense(x).reshape(b, t, h, d)

    query, key, values = heads(self.query), heads(self.key), heads(self.value)
    use_flash = self.use_flash
    if use_flash is None:
      use_flash = (serving or _flash_auto_ok(query)) and fa.is_supported(
          t, d, itemsize=query.dtype.itemsize)
    if use_flash:
      out = fa.flash_attention(query, key, values, causal=True)
    else:
      out = reference_attention(query, key, values, causal=True)
    read = out.reshape(b, t, h * d)
    return torch.cat([promoted(x, read), read], dim=2), {}


def init_snail_weights(module: nn.Module,
                       generator: Optional[torch.Generator] = None) -> None:
  """flax's default initialisers for every SNAIL layer under ``module``:
  lecun-normal kernels and zero biases."""
  with torch.no_grad():
    for sub in module.modules():
      if isinstance(sub, (Dense, CausalConv)):
        sub.init_weights(generator)
