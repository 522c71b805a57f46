"""Family assembly over the block-registry runtime.

Port of the JAX package's ``models/transformer.py`` for every family:
the decoder-only dense LM (OPT-1.3B, the paper's model, and the other
dense configs) and its MoE variant, the encoder-only classifier
(RoBERTa-large, the paper's other model: the same [attn, ffn] plan,
bidirectional, a CLS head, no decode), the mamba/attention hybrid
(jamba: super-blocks of ``block_len`` sublayers nested ``sub_i``), RWKV-6
(``ssm``) and the encoder-decoder (whisper: ``enc_blocks`` /
``dec_blocks``). ``build_model(cfg)`` returns a :class:`Model` bundle
of functions:

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
family inits (``_lm_init``, ``_hybrid_init``, ``_rwkv_init``,
``_encdec_init``); it cannot reproduce ``jax.random``'s numbers, so
parity tests carry the JAX parameters across instead
(``checkpoint/store.py``). A family without pageable state (rwkv6) has
no ``init_paged_cache``, ``prefill_chunk`` or ``verify_window``: its
engine serves the dense layout.
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial
from typing import Callable, Dict, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import rwkv6 as R
from repro_torch.models import runtime as RT
from repro_torch.models.config import ModelConfig
from repro_torch.models.runtime import ModelPlan, StackPlan, Sublayer

__all__ = ["Model", "build_model", "build_plan", "param_shapes",
           "resolve_device"]


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
    """Decoder-only LM (dense / moe / vlm backbone) and the encoder-only
    classifier: [attn, ffn] per layer (the encoder's attention is
    bidirectional through ``cfg.causal``)."""
    ffn = "moe" if cfg.n_experts else "mlp"
    return ModelPlan(cfg, StackPlan("blocks", cfg.n_layers, (
        Sublayer("ln_attn", "attn", "attention"),
        Sublayer("ln_ffn", ffn, ffn))))


def _hybrid_ffn(cfg, i: int) -> str:
    return "moe" if cfg.n_experts and i % 2 == 1 else "mlp"


def _hybrid_plan(cfg: ModelConfig) -> ModelPlan:
    """Hybrid (jamba): super-blocks of ``block_len`` sublayers -- mamba
    everywhere except ``attn_index``, an FFN (MoE on odd sublayers when
    configured) after each mixer."""
    subs = []
    for i in range(cfg.block_len):
        if i == cfg.attn_index:
            subs.append(Sublayer(f"sub_{i}/ln", f"sub_{i}/attn", "attention"))
        else:
            subs.append(Sublayer(f"sub_{i}/ln", f"sub_{i}/mamba", "mamba"))
        ffn = _hybrid_ffn(cfg, i)
        subs.append(Sublayer(f"sub_{i}/ln_ffn", f"sub_{i}/{ffn}", ffn))
    return ModelPlan(cfg, StackPlan("blocks", cfg.n_layers // cfg.block_len,
                                    tuple(subs)))


def _rwkv_plan(cfg: ModelConfig) -> ModelPlan:
    return ModelPlan(cfg, StackPlan("blocks", cfg.n_layers, (
        Sublayer("ln1", "tm", "rwkv_timemix"),
        Sublayer("ln2", "cm", "rwkv_channelmix"))))


def _encdec_plan(cfg: ModelConfig) -> ModelPlan:
    """Encoder-decoder (whisper): the stub frontend's ``enc_embeds`` in
    the batch feed the encoder; decoder = [self-attn, cross-attn, mlp]
    per layer."""
    enc = StackPlan("enc_blocks", cfg.enc_layers, (
        Sublayer("ln_attn", "attn", "attention", (("causal", False),)),
        Sublayer("ln_ffn", "mlp", "mlp")))
    dec = StackPlan("dec_blocks", cfg.dec_layers, (
        Sublayer("ln_self", "self", "attention", (("causal", True),)),
        Sublayer("ln_cross", "cross", "cross_attention"),
        Sublayer("ln_ffn", "mlp", "mlp")))
    return ModelPlan(cfg, dec, encoder=enc)


_PLANS = {"dense": _lm_plan, "moe": _lm_plan, "encoder": _lm_plan,
          "hybrid": _hybrid_plan, "ssm": _rwkv_plan, "encdec": _encdec_plan}


def build_plan(cfg: ModelConfig) -> ModelPlan:
    if cfg.family not in _PLANS:
        raise ValueError(f"unknown family {cfg.family}")
    return _PLANS[cfg.family](cfg)


class _Spec:
    """Collects ``path -> (shape, dtype, init)`` of one parameter tree;
    every helper takes the stack's leading layer dims ``lead``."""

    def __init__(self, cfg: ModelConfig):
        self.cfg, self.out = cfg, {}
        self.dt = L.dtype_of(cfg)
        self.out_std = 0.02 / max(cfg.n_layers, 1) ** 0.5

    def leaf(self, path, shape, dtype, how):
        self.out[path] = (tuple(shape), dtype, how)

    def norm(self, prefix, lead=()):
        d = self.cfg.d_model
        self.leaf(f"{prefix}/scale", lead + (d,), torch.float32, "ones")
        if self.cfg.norm == "layernorm":
            self.leaf(f"{prefix}/bias", lead + (d,), torch.float32, "zeros")

    def proj(self, prefix, d_in, d_out, lead=(), std=0.02, bias=False,
             dtype=None):
        dt = dtype or self.dt
        self.leaf(f"{prefix}/w", lead + (d_in, d_out), dt, ("normal", std))
        if bias:
            self.leaf(f"{prefix}/b", lead + (d_out,), dt, "zeros")

    def attn(self, prefix, lead):
        cfg, d = self.cfg, self.cfg.d_model
        hd, bias = cfg.resolved_head_dim, cfg.norm == "layernorm"
        self.proj(f"{prefix}/wq", d, cfg.n_heads * hd, lead, bias=bias)
        self.proj(f"{prefix}/wk", d, cfg.n_kv_heads * hd, lead, bias=bias)
        self.proj(f"{prefix}/wv", d, cfg.n_kv_heads * hd, lead, bias=bias)
        self.proj(f"{prefix}/wo", cfg.n_heads * hd, d, lead,
                  std=self.out_std, bias=bias)
        if cfg.qk_norm:
            self.leaf(f"{prefix}/q_norm", lead + (hd,), torch.float32,
                      "ones")
            self.leaf(f"{prefix}/k_norm", lead + (hd,), torch.float32,
                      "ones")

    def mlp(self, prefix, lead, d_ff=None):
        cfg, d = self.cfg, self.cfg.d_model
        f, bias = d_ff or cfg.d_ff, cfg.norm == "layernorm"
        if cfg.act in ("swiglu", "geglu"):
            self.leaf(f"{prefix}/w_in/w", lead + (d, f, 2), self.dt,
                      ("normal", 0.02))
        else:
            self.proj(f"{prefix}/w_in", d, f, lead, bias=bias)
        self.proj(f"{prefix}/w_out", f, d, lead, std=self.out_std,
                  bias=bias)

    def moe(self, prefix, lead):
        cfg, d = self.cfg, self.cfg.d_model
        e, f = cfg.n_experts, cfg.expert_dff or cfg.d_ff
        gated = cfg.act in ("swiglu", "geglu")
        self.leaf(f"{prefix}/router", lead + (d, e), torch.float32,
                  ("normal", 0.02))
        self.leaf(f"{prefix}/w_in", lead + ((e, d, f, 2) if gated
                                            else (e, d, f)),
                  self.dt, ("normal", 0.02))
        self.leaf(f"{prefix}/w_out", lead + (e, f, d), self.dt,
                  ("normal", self.out_std))
        if cfg.n_shared_experts:
            self.mlp(f"{prefix}/shared", lead, cfg.n_shared_experts * f)

    def mamba(self, prefix, lead):
        cfg = self.cfg
        d, di, dtr = M.dims(cfg)
        n, f32 = cfg.mamba_d_state, torch.float32
        self.proj(f"{prefix}/in_proj", d, 2 * di, lead)
        self.leaf(f"{prefix}/conv_w", lead + (cfg.mamba_d_conv, di), self.dt,
                  ("normal", 0.1))
        self.leaf(f"{prefix}/conv_b", lead + (di,), self.dt, "zeros")
        self.proj(f"{prefix}/x_proj", di, dtr + 2 * n, lead)
        if cfg.mamba_inner_norm:
            for name, width in (("dt_norm", dtr), ("b_norm", n),
                                ("c_norm", n)):
                self.leaf(f"{prefix}/{name}/scale", lead + (width,), f32,
                          "ones")
        self.proj(f"{prefix}/dt_proj", dtr, di, lead, bias=True)
        self.leaf(f"{prefix}/A_log", lead + (di, n), f32, "a_log")
        self.leaf(f"{prefix}/D", lead + (di,), f32, "ones")
        self.proj(f"{prefix}/out_proj", di, d, lead, std=self.out_std)

    def timemix(self, prefix, lead):
        d, f32 = self.cfg.d_model, torch.float32
        h, hd = R.heads(self.cfg)
        lora = R.lora_rank(self.cfg)
        self.leaf(f"{prefix}/mu", lead + (5, d), f32, ("normal", 0.02))
        for name in ("wr", "wk", "wv", "wg"):
            self.proj(f"{prefix}/{name}", d, d, lead)
        self.leaf(f"{prefix}/w0", lead + (d,), f32, ("full", -6.0))
        self.leaf(f"{prefix}/w_lora_a", lead + (d, lora), f32,
                  ("normal", 0.02))
        self.leaf(f"{prefix}/w_lora_b", lead + (lora, d), f32, "zeros")
        self.leaf(f"{prefix}/bonus", lead + (h, hd), f32, ("normal", 0.02))
        self.leaf(f"{prefix}/ln_x", lead + (d,), f32, "ones")
        self.proj(f"{prefix}/wo", d, d, lead, std=self.out_std)

    def channelmix(self, prefix, lead):
        d, f = self.cfg.d_model, self.cfg.d_ff
        self.leaf(f"{prefix}/mu", lead + (2, d), torch.float32,
                  ("normal", 0.02))
        self.proj(f"{prefix}/wr", d, d, lead)
        self.proj(f"{prefix}/wk", d, f, lead)
        self.proj(f"{prefix}/wv", f, d, lead, std=self.out_std)

    def embed(self):
        cfg = self.cfg
        self.leaf("embed/tok", (cfg.vocab, cfg.d_model), self.dt,
                  ("normal", 0.02))
        if cfg.pos == "learned":
            self.leaf("embed/pos", (cfg.max_seq, cfg.d_model), self.dt,
                      ("normal", 0.02))

    def lm_head(self):
        self.proj("lm_head", self.cfg.d_model, self.cfg.vocab)


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """``path -> (shape, dtype, init)`` of the JAX family init's tree;
    ``init`` is ``("normal", std)``, ``("full", value)``, ``"ones"``,
    ``"zeros"`` or ``"a_log"`` (mamba's S4D-real ``log(1..n)`` rows)."""
    sp = _Spec(cfg)
    sp.embed()
    if cfg.family in ("dense", "moe", "encoder"):
        lead = (cfg.n_layers,)
        sp.norm("blocks/ln_attn", lead)
        sp.attn("blocks/attn", lead)
        sp.norm("blocks/ln_ffn", lead)
        if cfg.n_experts:
            sp.moe("blocks/moe", lead)
        else:
            sp.mlp("blocks/mlp", lead)
        sp.norm("ln_f")
        if not cfg.tie_embeddings:
            sp.lm_head()
        if cfg.n_classes:
            sp.proj("cls_head", cfg.d_model, cfg.n_classes,
                    dtype=torch.float32, bias=True)
    elif cfg.family == "hybrid":
        lead = (cfg.n_layers // cfg.block_len,)
        for i in range(cfg.block_len):
            sp.norm(f"blocks/sub_{i}/ln", lead)
            if i == cfg.attn_index:
                sp.attn(f"blocks/sub_{i}/attn", lead)
            else:
                sp.mamba(f"blocks/sub_{i}/mamba", lead)
            sp.norm(f"blocks/sub_{i}/ln_ffn", lead)
            ffn = _hybrid_ffn(cfg, i)
            getattr(sp, ffn)(f"blocks/sub_{i}/{ffn}", lead)
        sp.norm("ln_f")
        sp.lm_head()
    elif cfg.family == "ssm":
        lead = (cfg.n_layers,)
        sp.norm("blocks/ln1", lead)
        sp.timemix("blocks/tm", lead)
        sp.norm("blocks/ln2", lead)
        sp.channelmix("blocks/cm", lead)
        sp.norm("ln_f")
        sp.lm_head()
    elif cfg.family == "encdec":
        enc, dec = (cfg.enc_layers,), (cfg.dec_layers,)
        sp.norm("enc_blocks/ln_attn", enc)
        sp.attn("enc_blocks/attn", enc)
        sp.norm("enc_blocks/ln_ffn", enc)
        sp.mlp("enc_blocks/mlp", enc)
        for part in ("self", "cross"):
            sp.norm(f"dec_blocks/ln_{part}", dec)
            sp.attn(f"dec_blocks/{part}", dec)
        sp.norm("dec_blocks/ln_ffn", dec)
        sp.mlp("dec_blocks/mlp", dec)
        sp.norm("ln_enc")
        sp.norm("ln_f")
    else:
        raise ValueError(f"unknown family {cfg.family}")
    return sp.out


def _init(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random parameters of the JAX tree layout, drawn in path order from
    ``generator`` (on its own device) and placed on ``device``."""
    device = resolve_device(device)
    params = {}
    for path, (shape, dt, how) in param_shapes(cfg).items():
        if how == "ones":
            t = torch.ones(shape, dtype=dt, device=device)
        elif how == "zeros":
            t = torch.zeros(shape, dtype=dt, device=device)
        elif how == "a_log":
            n = torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                             device=device)
            t = torch.log(n).expand(shape).to(dt).contiguous()
        elif how[0] == "full":
            t = torch.full(shape, how[1], dtype=dt, device=device)
        else:
            t = torch.randn(shape, generator=generator,
                            device=generator.device) * how[1]
            t = t.to(dtype=dt, device=device)
        params[path] = t
    return params


def _no_decode(*_args, **_kwargs):
    """Decode-path stub for encoder-only architectures."""
    raise ValueError("encoder-only arch has no decode path")


@functools.lru_cache(maxsize=None)
def build_model(cfg: ModelConfig) -> Model:
    """Memoized on the (frozen, hashable) config."""
    plan = build_plan(cfg)
    dtype = L.dtype_of(cfg)
    if cfg.family == "encoder":
        return Model(cfg=cfg, plan=plan, init=partial(_init, cfg),
                     forward=partial(RT.forward, plan),
                     loss=partial(RT.loss, plan), init_cache=_no_decode)
    return Model(
        cfg=cfg, plan=plan,
        init=partial(_init, cfg),
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
