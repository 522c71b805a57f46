"""Top-k Mixture-of-Experts with sort-based capacity dispatch.

Port of the JAX package's ``models/moe.py`` (``moe_apply``; its
``moe_apply_ep`` shard_map paths need a device mesh, and without one the
reference itself returns ``moe_apply``, so ``cfg.moe_ep`` configs compute
the same function here). The (token, expert) assignment list is sorted
by expert id and each expert's first ``capacity`` rows are scattered
into an (E, C, D) buffer -- O(T*k*D) memory, never a (T, E, C) one-hot.
Assignments past capacity are dropped: their combine weight is zero, so
the residual path carries those tokens unchanged.

Dispatch and combine are deterministic on the card: a kept assignment
owns its buffer row (no two writes meet, and dropped ones go to one
spare row that nothing reads), and the combine gathers each token's k
expert outputs in top-k order and sums them -- no atomic float
``index_add_``, so two calls on the same input are bit-equal (the
serving and replay contracts rest on it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


def _expert_ffn(cfg, w_in, w_out, x):
    """x: (E, C, D) -> (E, C, D), per-expert weights stacked on dim 0."""
    if cfg.act in ("swiglu", "geglu"):
        h = torch.einsum("ecd,edfg->ecfg", x, w_in)
        u, g = h[..., 0], h[..., 1]
        h = u * (F.silu(g) if cfg.act == "swiglu"
                 else F.gelu(g, approximate="tanh"))
    elif cfg.act == "gelu":
        h = F.gelu(torch.einsum("ecd,edf->ecf", x, w_in), approximate="tanh")
    else:
        h = torch.relu(torch.einsum("ecd,edf->ecf", x, w_in))
    return torch.einsum("ecf,efd->ecd", h, w_out)


def capacity(n_tokens: int, cfg) -> int:
    c = int(n_tokens * cfg.topk * cfg.capacity_factor / cfg.n_experts)
    return max(8, c)


def moe_apply(cfg, p, x):
    """x: (B, S, D) -> (out (B, S, D), aux load-balancing loss). ``p`` is
    the block's plain (perturbed or dequantized) expert sub-dict."""
    b, s, d = x.shape
    tt = b * s
    e, k = cfg.n_experts, cfg.topk
    c = capacity(tt, cfg)
    xf = x.reshape(tt, d)

    logits = xf.to(torch.float32) @ p["router"]                # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)                   # (T, k)
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)

    # load-balancing auxiliary loss (Switch-style)
    density = F.one_hot(idx[:, 0], e).to(torch.float32).mean(0)
    aux = e * torch.mean(probs.mean(0) * density)

    # ---- sort-based dispatch -------------------------------------------
    flat_e = idx.reshape(-1)                                   # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = order // k                                            # its token
    starts = torch.searchsorted(se, torch.arange(e, device=x.device))
    pos = torch.arange(tt * k, device=x.device) - starts[se]
    keep = pos < c
    slot = se * c + torch.where(keep, pos, 0)
    buf = torch.zeros((e * c + 1, d), dtype=x.dtype, device=x.device)
    buf[torch.where(keep, slot, e * c)] = xf[st]               # row e*c: spare
    yexp = _expert_ffn(cfg, p["w_in"], p["w_out"],
                       buf[:-1].reshape(e, c, d)).reshape(e * c, d)

    # ---- combine: each token's k outputs, in top-k order ---------------
    inv = torch.empty_like(order)
    inv[order] = torch.arange(tt * k, device=x.device)
    w = gate.reshape(-1)[order] * keep
    contrib = yexp[slot] * w.to(x.dtype)[:, None]              # sorted order
    out = contrib[inv].reshape(tt, k, d).sum(1).to(x.dtype).reshape(b, s, d)

    if cfg.n_shared_experts:
        out = out + L.mlp_apply(cfg, p["shared"], x)
    return out, aux
