"""Derivative-based baselines (Adam, SGD, ``optim/adam.py``), int8
gradient compression and the int8 quantized-base runtime
(``optim/quant.py``)."""

from repro_torch.optim.adam import (AdamConfig, AdamState, adam_init,
                                    adam_update, grad_train_step,
                                    sgd_train_step)
from repro_torch.optim.compression import int8_compress_tree
from repro_torch.optim.quant import (QUANT_MODES, QuantizedLeaf,
                                     check_quant_mode, deq,
                                     dequantize_tree, is_quantized,
                                     quantize_leaf, quantize_tree,
                                     quantized_bytes, take_rows,
                                     take_rows_f32, tree_is_quantized,
                                     with_delta)

__all__ = ["AdamConfig", "AdamState", "adam_init", "adam_update",
           "grad_train_step", "sgd_train_step", "int8_compress_tree",
           "QUANT_MODES", "QuantizedLeaf", "check_quant_mode", "deq",
           "dequantize_tree", "is_quantized", "quantize_leaf",
           "quantize_tree", "quantized_bytes", "take_rows", "take_rows_f32",
           "tree_is_quantized", "with_delta"]
