"""fp8 training: delayed-amax-scaled quantize-dequantize of the contractions.

The port's counterpart of ``tensor2robot_tpu/quantize/fp8_training.py``,
with its arithmetic unchanged. Each operand of a Dense or Conv contraction
is quantized to ``float8_e4m3fn`` and dequantized straight back to the
compute dtype, so the contraction sees exactly the values an fp8 matmul
would read; its cotangent is quantized to ``float8_e5m2`` (gradients need
range, not mantissa) from the cotangent's own amax before the two gradient
contractions. Gradients leave the injected ops unscaled in the compute
dtype, and the parameters and every optimizer slot stay float32.

Scaling is per-tensor DELAYED amax: each operand keeps a window of its
last ``DEFAULT_HISTORY_LENGTH`` amaxes in a float32 buffer
(:class:`DelayedAmax`, ``amax_history``); a step quantizes by the window's
maximum over the steps before it, then rolls its own amax in. Being a
buffer, the window travels with the batch statistics: the trainer's
snapshot and guard, the captured K-step graph, checkpoints, eval and
export carry it with no plumbing of their own. It rolls only in train
mode (the JAX package's mutable ``'fp8_stats'`` collection), once per
forward: a remat region's recompute (``layers/remat.recomputing``) does
not roll it again and quantizes with the scale of the forward it repeats.

The qdq is plain torch ops, as the JAX package's is plain XLA ops:
``x.float() / scale`` (a division by a tensor, so a card computes the
quotient rather than a product with the reciprocal), clamped to the
format's finite range, cast to fp8 and back to float32, times the scale,
cast to the compute dtype. The scale is the window's amax divided by the
format's maximum (:func:`amax_scale`), a division here too.

Entry points: :class:`Fp8Operands` is the injection a layer owns as its
``fp8`` submodule (:func:`injection`: operand qdq plus the e5m2
cotangent; :func:`conv_operand_hook`: operand qdq alone,
conv1 on the space-to-depth kernel path, whose kernels see the
un-quantized cotangent, as the JAX package's ``conv_quantize_cls`` hook).
Models thread ``matmul_precision`` ('bf16' | 'fp8');
``TrainerConfig.matmul_precision`` overrides it, gated by
:func:`require_fp8_support`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tensor2robot_tpu_torch.layers import remat
from tensor2robot_tpu_torch.quantize.quantization import fp8_supported

MATMUL_BF16 = 'bf16'
MATMUL_FP8 = 'fp8'
MATMUL_PRECISIONS = (MATMUL_BF16, MATMUL_FP8)

# float8_e4m3fn / float8_e5m2 finite maxima; a cast past them is NaN
# (e4m3fn has no inf), hence the clamp.
E4M3_MAX = 448.0
E5M2_MAX = 57344.0
E4M3 = getattr(torch, 'float8_e4m3fn', None)
E5M2 = getattr(torch, 'float8_e5m2', None)

# The delayed-scaling window, in steps.
DEFAULT_HISTORY_LENGTH = 16


def validate_matmul_precision(precision: Optional[str]) -> str:
  """Normalises/validates a matmul-precision name (None -> 'bf16')."""
  precision = MATMUL_BF16 if precision is None else str(precision)
  if precision not in MATMUL_PRECISIONS:
    raise ValueError(
        f'Unknown matmul_precision {precision!r}; expected one of '
        f'{MATMUL_PRECISIONS}.')
  return precision


def require_fp8_support(precision: Optional[str]) -> str:
  """Validates ``precision`` and gates 'fp8' on this torch build's fp8
  dtypes (``quantization.fp8_supported``, the serving plane's gate)."""
  precision = validate_matmul_precision(precision)
  if precision == MATMUL_FP8 and not fp8_supported():
    raise ValueError("matmul_precision='fp8' requested but this torch build "
                     'has no float8_e4m3fn')
  return precision


def _fp8_max(dtype: torch.dtype) -> float:
  return E5M2_MAX if dtype == E5M2 else E4M3_MAX


class QuantizeDequantize(torch.autograd.Function):
  """``dq(q(x))`` at a per-tensor ``scale``, with a straight-through
  gradient: the cotangent passes to ``x`` untouched, the rounding treated
  as noise."""

  @staticmethod
  def forward(ctx, x, scale, dtype):  # pylint: disable=arguments-differ
    del ctx
    bound = _fp8_max(dtype)
    scaled = (x.float() / scale).clamp(-bound, bound)
    return (scaled.to(dtype).float() * scale).to(x.dtype)

  @staticmethod
  def backward(ctx, g):  # pylint: disable=arguments-differ
    del ctx
    return g, None, None


def quantize_dequantize(x: torch.Tensor, scale: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
  """:class:`QuantizeDequantize` of ``x`` at the float32 0-d ``scale``."""
  return QuantizeDequantize.apply(x, scale, dtype)


def amax_scale(amax: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
  """The scale that maps ``amax`` onto the format's finite maximum; an
  empty history (amax 0) keeps scale 1. A division by a tensor of the
  bound, as the JAX package's train step computes it (a card divides a
  tensor by a host scalar as a product with its reciprocal)."""
  amax = amax.float()
  return torch.where(amax > 0.0, amax / torch.full_like(amax, _fp8_max(dtype)),
                     torch.ones_like(amax))


def qdq_current(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
  """qdq at the scale of ``x``'s own amax (the cotangent's path)."""
  amax = x.detach().abs().amax().float()
  return quantize_dequantize(x, amax_scale(amax, dtype), dtype)


class CotangentQdq(torch.autograd.Function):
  """The identity forward; the backward qdq's the cotangent to e5m2 at
  its own amax. Applied to a contraction's output (before any bias), so
  both gradient contractions read the fp8-rounded cotangent."""

  @staticmethod
  def forward(ctx, y):  # pylint: disable=arguments-differ
    del ctx
    return y

  @staticmethod
  def backward(ctx, g):  # pylint: disable=arguments-differ
    del ctx
    return qdq_current(g, E5M2)


class DelayedAmax(nn.Module):
  """One operand's delayed scaling: qdq by the maximum of ``amax_history``
  (the steps before this one), then, in train mode, roll this step's amax
  into the window in place. A remat recompute neither rolls nor reads the
  rolled window: it takes the scale its first forward used."""

  def __init__(self):
    super().__init__()
    self.register_buffer('amax_history',
                         torch.zeros(DEFAULT_HISTORY_LENGTH))
    self._step_scale: Optional[torch.Tensor] = None

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    recompute = remat.recomputing() and self._step_scale is not None
    if recompute:
      scale = self._step_scale
    else:
      scale = amax_scale(self.amax_history.max(), E4M3)
    y = quantize_dequantize(x, scale, E4M3)
    if self.training and not recompute:
      self._step_scale = scale
      with torch.no_grad():
        current = x.detach().abs().amax().float().reshape(1)
        self.amax_history.copy_(
            torch.cat([self.amax_history[1:], current]))
    return y


class Fp8Operands(nn.Module):
  """A contraction's fp8 injection: ``(lhs, rhs) -> (qdq(lhs), qdq(rhs))``
  by the windows ``lhs`` and ``rhs``; :meth:`output` wraps the
  contraction's output in :class:`CotangentQdq` when
  ``quantize_cotangent``."""

  def __init__(self, quantize_cotangent: bool):
    super().__init__()
    self.quantize_cotangent = quantize_cotangent
    self.lhs = DelayedAmax()
    self.rhs = DelayedAmax()

  def forward(self, lhs: torch.Tensor,
              rhs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return self.lhs(lhs), self.rhs(rhs)

  def output(self, y: torch.Tensor) -> torch.Tensor:
    return CotangentQdq.apply(y) if self.quantize_cotangent else y


def injection(matmul_precision: Optional[str]) -> Optional[Fp8Operands]:
  """A Dense or Conv layer's ``fp8`` submodule (JAX ``Fp8DotGeneral`` /
  ``Fp8ConvGeneralDilated``: operands and cotangent), None for bf16."""
  if validate_matmul_precision(matmul_precision) != MATMUL_FP8:
    return None
  return Fp8Operands(True)


def conv_operand_hook(matmul_precision: Optional[str]
                      ) -> Optional[Fp8Operands]:
  """The space-to-depth conv's operand hook (JAX ``conv_quantize_cls``):
  operands qdq'd, the cotangent left alone; None for bf16."""
  if validate_matmul_precision(matmul_precision) != MATMUL_FP8:
    return None
  return Fp8Operands(False)
