"""Kernels: plain PyTorch versions and the hand-written CUDA kernels
(``csrc/``), dispatched by device in :mod:`repro_torch.kernels.ops`."""
