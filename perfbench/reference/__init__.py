"""Plain float32 references the benchmark holds the port to.

Nothing here imports ``repro_torch``, ``repro`` or ``jax``: the
reference makes its own perturbations, forwards and updates from the
inputs the benchmark hands to both sides.
"""
