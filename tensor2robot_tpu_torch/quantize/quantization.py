"""Post-training weight-only quantization (int8 / fp8) for serving.

The port's counterpart of ``tensor2robot_tpu/quantize/quantization.py``,
with its arithmetic unchanged:

* **Weight-only.** A quantized leaf is a :class:`QuantizedTensor`, the
  int8 or ``torch.float8_e4m3fn`` payload and its float32 per-output-
  channel symmetric scale: ``scale = amax / bound`` over every axis but
  the output channel's (bound 127 for int8, 448 for fp8), 1.0 for a dead
  channel. int8 is ``rint(w / scale)`` clipped to ±127, fp8 the float32
  ``w / scale`` cast to e4m3fn, and the dequantized weight is
  ``q.float32 * scale``. Activations stay as the network computes them.
* **Layout.** The JAX package scales over every axis but the last, since
  flax kernels are ``(..., in, out)``. The port's weights are the
  ``state_dict`` leaves that ``utils/convert.py`` writes: a ``weight`` is
  in torch's layout, output channel first (Linear ``[out, in]``, Conv1d
  ``[out, in, k]``, Conv2d OIHW), and a ``kernel`` keeps flax's layout,
  output channel last (QT-Opt's space-to-depth ``conv1_1.kernel``,
  HWIO). :func:`output_axis` reads the axis from the name and raises for a
  >= 2-D leaf of any other name, rather than guess.
* **Skip list.** Biases, norm scales and statistics, and any leaf below
  2-D stay full precision (:func:`should_quantize`, matched against the
  dotted parts of a ``state_dict`` key, plus caller patterns matched as
  substrings of the key).
* **The served fn dequantizes inside each call**
  (:func:`quantize_serving_fn`): the served params are the payload, so
  ``param_bytes`` counts what the card holds; the fn wraps whatever
  ``fn(params, features)`` the predictor hands out (an exported program
  unchanged, or the model's own code) and its ``program_key`` becomes
  ``('quant', mode, key)``.
* **Parity is a gate** (:func:`check_parity`): both fns run on seeded
  spec-shaped calibration batches (``specs/numpy_gen``, the JAX seeds)
  and the worst error per output is held to ``atol + rtol * max|full|``.
  The serving plane adopts a quantized generation only inside the band.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from tensor2robot_tpu_torch.specs import numpy_gen
from tensor2robot_tpu_torch.specs.dtypes import to_host_numpy

INT8 = 'int8'
FP8 = 'fp8'
OFF = 'off'
MODES = (INT8, FP8)

# int8's symmetric range; float8_e4m3fn's largest finite value.
_INT8_BOUND = 127.0
_FP8_BOUND = 448.0
_PAYLOAD_DTYPES = {INT8: torch.int8, FP8: torch.float8_e4m3fn}

# Key parts that mark a leaf as quantization-sensitive: norm statistics and
# affine terms (the >= 2-D rule already skips them; the list guards models
# that reshape them).
DEFAULT_SKIP_COMPONENTS = frozenset(
    {'bias', 'scale', 'mean', 'var', 'batch_stats'})


class QuantizedTensor(NamedTuple):
  """A weight leaf as (payload, per-output-channel scale): ``qvalue`` int8
  or float8_e4m3fn in the weight's shape, ``scale`` float32 of the weight's
  rank, 1 on every axis but the output channel's."""

  qvalue: torch.Tensor
  scale: torch.Tensor


def fp8_supported() -> bool:
  """Whether this torch build has ``float8_e4m3fn``."""
  return hasattr(torch, 'float8_e4m3fn')


def _require_mode(mode: str) -> str:
  if mode in (None, OFF, ''):
    raise ValueError('quantization mode is off; nothing to do')
  if mode not in MODES:
    raise ValueError(f'unknown quantization mode {mode!r}; '
                     f'expected one of {MODES + (OFF,)}')
  if mode == FP8 and not fp8_supported():
    raise ValueError('fp8 quantization requested but this torch build has '
                     'no float8_e4m3fn')
  return mode


def output_axis(key: str, weight: torch.Tensor) -> int:
  """The output-channel axis of a >= 2-D ``state_dict`` leaf: 0 for a
  ``weight`` (torch's layout), the last for a ``kernel`` (flax's layout,
  kept by the converters for QT-Opt's space-to-depth conv). Raises for any
  other name."""
  name = key.rsplit('.', 1)[-1]
  if name == 'weight':
    return 0
  if name == 'kernel':
    return weight.dim() - 1
  raise ValueError(f'No known output-channel axis for the {weight.dim()}-D '
                   f'leaf {key!r}: only a torch-layout weight or a '
                   'flax-layout kernel is quantized.')


def channel_scales(weight: torch.Tensor, bound: float,
                   axis: int) -> torch.Tensor:
  """Per-output-channel symmetric float32 scales: amax over every axis but
  ``axis``, over ``bound``; a dead (all-zero) channel gets 1.0, so its
  dequantized weight is exactly zero."""
  axes = tuple(d for d in range(weight.dim()) if d != axis % weight.dim())
  amax = torch.amax(torch.abs(weight), dim=axes, keepdim=True)
  scales = amax.to(torch.float32) / bound
  return torch.where(scales > 0.0, scales, torch.ones_like(scales))


def quantize_array(weight: torch.Tensor, mode: str,
                   axis: int = 0) -> QuantizedTensor:
  """One weight -> :class:`QuantizedTensor`, scaled per channel along
  ``axis``, on the weight's device."""
  _require_mode(mode)
  weight = weight.detach()
  if mode == INT8:
    scale = channel_scales(weight, _INT8_BOUND, axis)
    q = torch.clamp(torch.round(weight.to(torch.float32) / scale),
                    -_INT8_BOUND, _INT8_BOUND).to(torch.int8)
  else:
    scale = channel_scales(weight, _FP8_BOUND, axis)
    q = (weight.to(torch.float32) / scale).to(torch.float8_e4m3fn)
  return QuantizedTensor(qvalue=q, scale=scale)


def dequantize_array(qt: QuantizedTensor) -> torch.Tensor:
  """Inverse of :func:`quantize_array`: ``qvalue.float32 * scale``."""
  return qt.qvalue.to(torch.float32) * qt.scale


def should_quantize(key: str, leaf: torch.Tensor,
                    skip_patterns: Sequence[str] = ()) -> bool:
  """The default leaf policy: floating, >= 2-D (matmul and conv weights;
  bias, scale, mean and var vectors stay full precision), no dotted part
  of ``key`` in :data:`DEFAULT_SKIP_COMPONENTS`, no caller pattern a
  substring of ``key``."""
  if not torch.is_floating_point(leaf) or leaf.dim() < 2:
    return False
  if any(part.lower() in DEFAULT_SKIP_COMPONENTS for part in key.split('.')):
    return False
  return not any(pattern in key for pattern in skip_patterns)


def quantize_params(params: Mapping[str, torch.Tensor],
                    mode: str = INT8,
                    skip_patterns: Sequence[str] = (),
                    predicate: Callable[[str, torch.Tensor], bool] = None
                    ) -> Dict[str, Any]:
  """Weight-only quantization of a flat ``state_dict``: every leaf that
  passes ``predicate`` (default :func:`should_quantize`) becomes a
  :class:`QuantizedTensor`; the others pass through as the same tensor
  objects."""
  _require_mode(mode)
  predicate = predicate or (
      lambda key, leaf: should_quantize(key, leaf, skip_patterns))
  return {key: (quantize_array(leaf, mode, output_axis(key, leaf))
                if predicate(key, leaf) else leaf)
          for key, leaf in params.items()}


def dequantize_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """Every :class:`QuantizedTensor` replaced by its dequantized float32
  tensor; the other leaves unchanged."""
  return {key: dequantize_array(leaf) if isinstance(leaf, QuantizedTensor)
          else leaf for key, leaf in params.items()}


def tensors(params: Mapping[str, Any]):
  """Every tensor of a (possibly quantized) params dict: a quantized
  leaf's payload and scale."""
  for leaf in params.values():
    if isinstance(leaf, QuantizedTensor):
      yield from leaf
    else:
      yield leaf


def map_tensors(params: Mapping[str, Any],
                fn: Callable[[torch.Tensor], torch.Tensor]) -> Dict[str, Any]:
  """``fn`` over every tensor of a (possibly quantized) params dict,
  keeping its structure (placing it on a device, copying it to the
  host)."""
  return {key: (QuantizedTensor(*(fn(t) for t in leaf))
                if isinstance(leaf, QuantizedTensor) else fn(leaf))
          for key, leaf in params.items()}


def param_bytes(params: Mapping[str, Any]) -> int:
  """The params' bytes as held on the device (a quantized leaf counts its
  payload and its scales)."""
  return int(sum(t.numel() * t.element_size() for t in tensors(params)))


def cast_tree_bytes(params: Mapping[str, Any], dtype: torch.dtype) -> int:
  """The bytes the params would take with their floating leaves cast to
  ``dtype`` (the bfloat16-serving denominator of the compression)."""
  itemsize = torch.empty((), dtype=dtype).element_size()
  return int(sum(t.numel() * (itemsize if torch.is_floating_point(t)
                              else t.element_size())
                 for t in tensors(params)))


def quantized_leaf_count(params: Mapping[str, Any]) -> int:
  return sum(isinstance(leaf, QuantizedTensor) for leaf in params.values())


class DequantizingFn:
  """``fn(params, features)`` over quantized params: dequantizes them, then
  calls the full-precision fn it wraps. A wrapped fn with a
  ``call_transient`` method (``predictors.EagerServingFn``) takes the
  dequantized weights through it, since they live for one call only."""

  def __init__(self, inner: Callable):
    self.inner = inner
    self._call = getattr(inner, 'call_transient', inner)

  def __call__(self, params, features):
    return self._call(dequantize_params(params), features)


def quantize_serving_fn(serving, mode: str = INT8,
                        skip_patterns: Sequence[str] = ()):
  """A ``StatelessServingFn`` -> its weight-quantized twin: ``params`` the
  quantized dict (quantized on the params' device), ``fn`` a
  :class:`DequantizingFn` over the original, ``program_key``
  ``('quant', mode, key)``, so that a consumer never shares warmed state
  between precisions while a weights-only swap in one mode still does."""
  _require_mode(mode)
  with torch.no_grad():
    qparams = quantize_params(serving.params, mode=mode,
                              skip_patterns=skip_patterns)
  return serving._replace(fn=DequantizingFn(serving.fn), params=qparams,
                          program_key=('quant', mode, serving.program_key))


class ParityReport(NamedTuple):
  """Worst quantized-versus-full error over the calibration batches."""

  ok: bool
  max_abs_err: float
  max_rel_err: float
  atol: float
  rtol: float
  per_output: Dict[str, float]  # output key -> max abs err

  def describe(self) -> str:
    status = 'within' if self.ok else 'OUTSIDE'
    return (f'quantization parity {status} band: max_abs_err='
            f'{self.max_abs_err:.3e} (atol={self.atol:.1e}), '
            f'max_rel_err={self.max_rel_err:.3e} (rtol={self.rtol:.1e}), '
            f'per_output={ {k: round(v, 6) for k, v in self.per_output.items()} }')


def check_parity(full_serving, quant_serving, atol: float, rtol: float,
                 calibration_batches: int = 2,
                 calibration_batch_size: int = 4,
                 seed: int = 0) -> ParityReport:
  """Runs both serving fns on seeded spec-shaped calibration batches (on
  the params' device); the band is per output key:
  ``max|q - f| <= atol + rtol * max|f|``. The gate the serving plane
  applies before it adopts a quantized generation."""
  device = next(tensors(full_serving.params)).device
  max_abs, max_rel, ok = 0.0, 0.0, True
  per_output: Dict[str, float] = {}
  for i in range(calibration_batches):
    batch = numpy_gen.make_random_numpy(
        full_serving.feature_spec, batch_size=calibration_batch_size,
        seed=seed + i)
    features = {key: torch.from_numpy(np.ascontiguousarray(value)).to(device)
                for key, value in batch.items()}
    with torch.inference_mode():
      full_out = full_serving.fn(full_serving.params, features)
      quant_out = quant_serving.fn(quant_serving.params, features)
    for key in full_out:
      f = np.asarray(to_host_numpy(full_out[key]), np.float32)
      q = np.asarray(to_host_numpy(quant_out[key]), np.float32)
      abs_err = float(np.max(np.abs(q - f))) if f.size else 0.0
      scale = float(np.max(np.abs(f))) if f.size else 0.0
      per_output[key] = max(per_output.get(key, 0.0), abs_err)
      max_abs = max(max_abs, abs_err)
      if scale > 0.0:
        max_rel = max(max_rel, abs_err / scale)
      if abs_err > atol + rtol * scale:
        ok = False
  return ParityReport(ok=ok, max_abs_err=max_abs, max_rel_err=max_rel,
                      atol=atol, rtol=rtol, per_output=per_output)
