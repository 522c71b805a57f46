"""PyTorch/CUDA port of the PocketLLM reproduction (``repro``).

Mirrors the JAX package's module layout; imports ``torch``, never
``jax`` and nothing of ``repro``. It serves personalized models
(OPT-1.3B with per-user ZO adapters replayed onto a shared base, a paged
KV cache and chunked prefill) and fine-tunes OPT-1.3B and RoBERTa-large
with MeZO (the ``mezo*`` strategies through ``runtime.Trainer`` and
``launch.train``, the fused perturbed forward included), over a
full-precision or an int8 base (``optim.quant``). The kernels are
hand-written CUDA for Hopper: ``zo_add``, ``flash_decode``,
``flash_prefill``, ``zo_matmul``, ``flash_attention``, ``zo_add_q`` and
``zo_matmul_q``.
"""
