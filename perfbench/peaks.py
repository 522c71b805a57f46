"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at
the full 700 W power limit)."""

PEAK_FLOPS = {
    "bfloat16": 989e12,   # tensor cores
    "float32": 67e12,     # FFMA outside the tensor cores
}
HBM_BYTES_PER_S = 3.35e12
