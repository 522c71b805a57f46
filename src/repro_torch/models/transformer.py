"""Family assembly over the block-registry runtime.

Port of the JAX package's ``models/transformer.py`` for the decoder-only
dense family (OPT-1.3B, the paper's model, and the other dense configs)
and the encoder-only classifier (RoBERTa-large, the paper's other
model: the same [attn, ffn] plan, bidirectional, a CLS head, no decode).
``build_model(cfg)`` returns a :class:`Model` bundle of functions:

  init(generator, device)                     -> params (flat, ``/`` keys)
  forward(params, batch, perturb=None)        -> (logits, aux)
  loss(params, batch, perturb=None)           -> scalar (the ZO objective)
  init_cache(bsz, max_len=None, device=...)   -> StateCache
  decode_step(params, cache, tok, pos, ...)   -> (logits, cache)
  prefill(params, cache, prompt)              -> (logits, cache)
  init_paged_cache(bsz, n_pages, page_size, max_len=None, device=...)
  prefill_chunk(params, cache, toks, pos, pages=, write_mask=)
  verify_window(params, cache, toks, pos, pages=, write_mask=)

``init`` builds the same tree, shapes, dtypes and init scales as the JAX
``_lm_init``; it cannot reproduce ``jax.random``'s numbers, so parity
tests carry the JAX parameters across instead (``checkpoint/store.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial
from typing import Callable, Dict, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models import runtime as RT
from repro_torch.models.config import ModelConfig
from repro_torch.models.runtime import ModelPlan, StackPlan, Sublayer

__all__ = ["Model", "build_model", "param_shapes", "resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; asking for CUDA without one raises
    (entry points never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' to run on the CPU")
    return device


@dataclasses.dataclass(frozen=True, eq=False)
class Model:
    cfg: ModelConfig
    plan: ModelPlan
    init: Callable
    forward: Callable
    loss: Callable
    init_cache: Callable
    decode_step: Optional[Callable] = None
    prefill: Optional[Callable] = None
    init_paged_cache: Optional[Callable] = None
    prefill_chunk: Optional[Callable] = None
    verify_window: Optional[Callable] = None


def _lm_plan(cfg: ModelConfig) -> ModelPlan:
    """Decoder-only LM and the encoder-only classifier: [attn, ffn] per
    layer (the encoder's attention is bidirectional through
    ``cfg.causal``)."""
    ffn = "moe" if cfg.n_experts else "mlp"
    return ModelPlan(cfg, StackPlan("blocks", cfg.n_layers, (
        Sublayer("ln_attn", "attn", "attention"),
        Sublayer("ln_ffn", ffn, ffn))))


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """``path -> (shape, dtype, init)`` of the JAX ``_lm_init`` tree for a
    dense decoder; ``init`` is ``("normal", std)``, ``"ones"`` or
    ``"zeros"``."""
    d, hd, nl = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers
    dt = L.dtype_of(cfg)
    f32 = torch.float32
    bias = cfg.norm == "layernorm"
    out_std = 0.02 / max(nl, 1) ** 0.5
    spec: Dict[str, tuple] = {"embed/tok": ((cfg.vocab, d), dt,
                                            ("normal", 0.02))}
    if cfg.pos == "learned":
        spec["embed/pos"] = ((cfg.max_seq, d), dt, ("normal", 0.02))

    def norm(prefix, stacked):
        lead = (nl,) if stacked else ()
        spec[f"{prefix}/scale"] = (lead + (d,), f32, "ones")
        if cfg.norm == "layernorm":
            spec[f"{prefix}/bias"] = (lead + (d,), f32, "zeros")

    def proj(prefix, d_in, d_out, std):
        spec[f"{prefix}/w"] = ((nl, d_in, d_out), dt, ("normal", std))
        if bias:
            spec[f"{prefix}/b"] = ((nl, d_out), dt, "zeros")

    norm("blocks/ln_attn", True)
    proj("blocks/attn/wq", d, cfg.n_heads * hd, 0.02)
    proj("blocks/attn/wk", d, cfg.n_kv_heads * hd, 0.02)
    proj("blocks/attn/wv", d, cfg.n_kv_heads * hd, 0.02)
    proj("blocks/attn/wo", cfg.n_heads * hd, d, out_std)
    if cfg.qk_norm:
        spec["blocks/attn/q_norm"] = ((nl, hd), f32, "ones")
        spec["blocks/attn/k_norm"] = ((nl, hd), f32, "ones")
    norm("blocks/ln_ffn", True)
    if cfg.act in ("swiglu", "geglu"):
        spec["blocks/mlp/w_in/w"] = ((nl, d, cfg.d_ff, 2), dt,
                                     ("normal", 0.02))
    else:
        proj("blocks/mlp/w_in", d, cfg.d_ff, 0.02)
    proj("blocks/mlp/w_out", cfg.d_ff, d, out_std)
    norm("ln_f", False)
    if not cfg.tie_embeddings:
        spec["lm_head/w"] = ((d, cfg.vocab), dt, ("normal", 0.02))
    if cfg.n_classes:
        spec["cls_head/w"] = ((d, cfg.n_classes), f32, ("normal", 0.02))
        spec["cls_head/b"] = ((cfg.n_classes,), f32, "zeros")
    return spec


def _lm_init(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random parameters of the JAX tree layout, drawn in path order from
    ``generator`` (on its own device) and placed on ``device``."""
    device = resolve_device(device)
    params = {}
    for path, (shape, dt, how) in param_shapes(cfg).items():
        if how == "ones":
            t = torch.ones(shape, dtype=dt, device=device)
        elif how == "zeros":
            t = torch.zeros(shape, dtype=dt, device=device)
        else:
            t = torch.randn(shape, generator=generator,
                            device=generator.device) * how[1]
            t = t.to(dtype=dt, device=device)
        params[path] = t
    return params


def _check_supported(cfg: ModelConfig):
    if cfg.family not in ("dense", "encoder") or cfg.n_experts:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: the "
            f"port runs dense decoders and the encoder classifier; the "
            f"other families land with a later slice")


def _no_decode(*_args, **_kwargs):
    """Decode-path stub for encoder-only architectures."""
    raise ValueError("encoder-only arch has no decode path")


@functools.lru_cache(maxsize=None)
def build_model(cfg: ModelConfig) -> Model:
    """Memoized on the (frozen, hashable) config."""
    _check_supported(cfg)
    plan = _lm_plan(cfg)
    dtype = L.dtype_of(cfg)
    if cfg.family == "encoder":
        return Model(cfg=cfg, plan=plan, init=partial(_lm_init, cfg),
                     forward=partial(RT.forward, plan),
                     loss=partial(RT.loss, plan), init_cache=_no_decode)
    return Model(
        cfg=cfg, plan=plan,
        init=partial(_lm_init, cfg),
        forward=partial(RT.forward, plan),
        loss=partial(RT.loss, plan),
        init_cache=lambda bsz, max_len=None, device="cuda": RT.init_cache(
            plan, bsz, max_len or cfg.max_seq, dtype, resolve_device(device)),
        decode_step=partial(RT.decode_step, plan),
        prefill=partial(RT.prefill, plan),
        init_paged_cache=(
            (lambda bsz, n_pages, page_size, max_len=None, device="cuda":
             RT.init_paged_cache(plan, bsz, n_pages, page_size, dtype,
                                 resolve_device(device), max_len=max_len))
            if RT.plan_pages(plan) else None),
        prefill_chunk=(partial(RT.prefill_chunk, plan)
                       if RT.plan_pages(plan) else None),
        verify_window=(partial(RT.verify_window, plan)
                       if RT.plan_pages(plan) else None),
    )
