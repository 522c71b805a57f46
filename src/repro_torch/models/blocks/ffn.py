"""FFN blocks: dense MLP and top-k MoE (stateless -- the runtime calls
``apply`` in every mode).

Port of the JAX package's ``models/blocks/ffn.py``. The MoE block is the
one place the fused ZO path takes a *scoped* transient copy: expert
weights are 3/4-D stacked leaves consumed inside sort-based dispatch,
so there is no 2-D use site for ``zo_matmul`` to fuse into. With a ctx
the block perturbs its expert sub-dict into a transient
(``ctx.materialize``: the ``zo_add`` kernel on the card, one launch a
leaf; the int8 kernels for a quantized one), under the span
``moe.materialize`` and counted in ``moe.materialized_bytes``; without
one it dequantizes an int8 base -- per block and layer slice, never the
whole model."""

from __future__ import annotations

import torch

from repro_torch.core.batching import take_lane
from repro_torch.core.spans import count, span
from repro_torch.models import layers as L
from repro_torch.models import moe as MoE
from repro_torch.models.blocks.base import BlockType, register_block
from repro_torch.optim.quant import dequantize_tree


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _mlp_apply(cfg, p, x, rc, ctx=None):
    return L.mlp_apply(cfg, p, x, ctx), _zero(x)


def _moe_apply(cfg, p, x, rc, ctx=None):
    """``ctx.materialize`` (perturb + dequant) of the expert sub-dict
    with a ctx, a plain dequant without one; the salts are the leaves'
    full paths (``blocks/moe/w_in``, ``blocks/moe/shared/w_in/w``). A
    ``cfg.moe_ep`` config dispatches through ``moe_apply_ep``, as the
    reference's block does: under a mesh the expert-parallel body, without
    one ``moe_apply`` itself.

    Under a user-axis ctx the lanes dispatch one at a time, as the
    reference's vmapped lane does: lane i's B * S tokens route with
    ``capacity(B * S)`` through lane i's own experts, materialized by its
    scalar ctx and freed before the next lane's (one lane's transient,
    never n), and the aux loss comes back per lane, (n,)."""
    fn = MoE.moe_apply_ep if cfg.moe_ep else MoE.moe_apply
    if ctx is not None and ctx.batched:
        outs, aux = [], []
        for i, (lctx, xl) in enumerate(zip(ctx.lanes(),
                                           ctx.split_lanes(x))):
            y, a = fn(cfg, _materialize(lctx, take_lane(p, i)), xl)
            outs.append(y)
            aux.append(a)
        return torch.cat(outs), torch.stack(aux)
    p = dequantize_tree(p) if ctx is None else _materialize(ctx, p)
    return fn(cfg, p, x)


def _materialize(ctx, p):
    """``ctx.materialize(p)`` under the span ``moe.materialize``, its
    bytes counted in ``moe.materialized_bytes``."""
    with span("moe.materialize"):
        out = ctx.materialize(p)
    count("moe.materialized_bytes", sum(
        t.numel() * t.element_size() for t in _leaves(out)))
    return out


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


MLP = register_block(BlockType(name="mlp", apply=_mlp_apply))
MOE = register_block(BlockType(name="moe", apply=_moe_apply))
