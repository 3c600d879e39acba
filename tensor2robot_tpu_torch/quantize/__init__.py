"""Post-training weight-only quantization (int8 / fp8) for serving."""

from tensor2robot_tpu_torch.quantize.quantization import (
    DEFAULT_SKIP_COMPONENTS, FP8, INT8, MODES, OFF, DequantizingFn,
    ParityReport, QuantizedTensor, cast_tree_bytes, channel_scales,
    check_parity, dequantize_array, dequantize_params, fp8_supported,
    map_tensors, output_axis, param_bytes, quantize_array, quantize_params,
    quantize_serving_fn, quantized_leaf_count, should_quantize, tensors)

__all__ = [
    'DEFAULT_SKIP_COMPONENTS', 'FP8', 'INT8', 'MODES', 'OFF',
    'DequantizingFn', 'ParityReport', 'QuantizedTensor', 'cast_tree_bytes',
    'channel_scales', 'check_parity', 'dequantize_array',
    'dequantize_params', 'fp8_supported', 'map_tensors', 'output_axis',
    'param_bytes', 'quantize_array', 'quantize_params',
    'quantize_serving_fn', 'quantized_leaf_count', 'should_quantize',
    'tensors',
]
