"""Analytic model counts (``roofline/analysis.py``)."""

from repro_torch.roofline.analysis import active_params, model_flops

__all__ = ["active_params", "model_flops"]
