"""PyTorch/CUDA port of the PocketLLM reproduction (``repro``).

Mirrors the JAX package's module layout; imports ``torch``, never
``jax`` and nothing of ``repro``. This first slice serves personalized
models: OPT-1.3B with per-user ZO adapters replayed onto a shared base,
a paged KV cache and chunked prefill, on hand-written CUDA kernels
(``zo_add``, ``flash_decode``, ``flash_prefill``) for Hopper.
"""
