"""The int8 quantized-base runtime (``optim/quant.py``)."""

from repro_torch.optim.quant import (QUANT_MODES, QuantizedLeaf,
                                     check_quant_mode, deq,
                                     dequantize_tree, is_quantized,
                                     quantize_leaf, quantize_tree,
                                     quantized_bytes, take_rows,
                                     take_rows_f32, tree_is_quantized,
                                     with_delta)

__all__ = ["QUANT_MODES", "QuantizedLeaf", "check_quant_mode", "deq",
           "dequantize_tree", "is_quantized", "quantize_leaf",
           "quantize_tree", "quantized_bytes", "take_rows", "take_rows_f32",
           "tree_is_quantized", "with_delta"]
