"""PyTorch/CUDA port of the PocketLLM reproduction (``repro``).

Mirrors the JAX package's module layout; imports ``torch``, never
``jax`` and nothing of ``repro``. It serves personalized models
(OPT-1.3B with per-user ZO adapters replayed onto a shared base, a paged
KV cache and chunked prefill) and fine-tunes OPT-1.3B and RoBERTa-large
with MeZO (the ``mezo*`` strategies through ``runtime.Trainer`` and
``launch.train``, the fused perturbed forward included). The kernels are
hand-written CUDA for Hopper: ``zo_add``, ``flash_decode``,
``flash_prefill``, ``zo_matmul`` and ``flash_attention``.
"""
