"""Generic backbone engine: forward / loss / cache / decode / prefill for
every ported architecture, driven by a declarative plan.

Port of the JAX package's ``models/runtime.py``. ``forward`` threads a
:class:`~repro_torch.core.perturb_ctx.PerturbCtx` into every block
(``ctx.scope(stack).at_layer(l)`` then the sublayer's param path), so
``loss(..., perturb=ctx)`` is the fused perturbed forward of MeZO. A
family is a :class:`ModelPlan`: a :class:`StackPlan` of :class:`Sublayer`
rows naming a norm leaf, a mixer param path and a registered block type.
The engine owns the one residual pattern::

    for each layer (a Python loop over the stacked (L, ...) leaves):
        for each sublayer:  x = x + block(norm(x))

Parameters are the flat ``/``-keyed dict (see ``core/perturb.py``); the
stack's leaves are nested and sliced one layer at a time here.
Under a user-axis ctx (the multi-tenant step: ``tokens`` (n, B, S), n
lanes each with its own seed and coefficient) the lanes ride flattened
in the batch, the user-stacked parameters' per-user parts are sliced at
``[:, layer]`` (``core.batching.user_leaf_axes`` says which), and
``loss`` returns the (n,) per-lane losses, each computed at the scalar
path's shapes, as the reference's vmapped lane computes it: every
family takes it. A MoE block dispatches lane by lane (capacity and the
aux loss per lane: ``forward``'s aux is then (n,)), the recurrent scans
run over the flattened lanes with their contractions lane by lane, and
an encoder-decoder runs its encoder under the same ctx over the
flattened ``enc_embeds``.

An encoder-decoder plan carries a second, stateless stack
(``ModelPlan.encoder``) that ``forward`` runs over ``batch["enc_embeds"]``
before the decoder; its normed output reaches the cross-attention
blocks through ``RunCtx.enc_out``.

The StateCache mirrors the JAX one: ``{scope: {mixer path: {leaf: (L,
...)}}}`` with layers on axis 0 and, for dense leaves, batch on axis 1;
paged pool leaves are ``(L, n_pages, page_size, KV, hd)``, and recurrent
state (mamba, rwkv) stays dense next to them. Blocks update their
layer's slice in place, so the returned cache is the cache passed in --
except in a verify window, where recurrent state is not touched: the
returned cache then holds, in place of each recurrent leaf, its (L, W,
B, ...) snapshots, one a window offset, for the engine to commit the
accepted offset from (:func:`commit_window`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.batching import user_leaf_axes
from repro_torch.core.perturb_ctx import sub as _sub
from repro_torch.core.spans import span
from repro_torch.models import layers as L
from repro_torch.models import sharding as shd
from repro_torch.models.blocks import RunCtx, get_block
from repro_torch.models.config import ModelConfig
from repro_torch.optim.quant import is_quantized

AUX_LOSS_WEIGHT = 0.01


# ---------------------------------------------------------------------------
# plans


@dataclasses.dataclass(frozen=True)
class Sublayer:
    """One residual unit: ``x = x + block(norm(x))``; ``ln`` / ``mixer``
    are ``/``-separated param paths within the layer; ``opts`` are static
    kwargs forwarded to the block."""
    ln: str
    mixer: str
    block: str
    opts: Tuple[Tuple[str, Any], ...] = ()


@dataclasses.dataclass(frozen=True)
class StackPlan:
    """A stack of identical layers under ``params[scope]``."""
    scope: str
    n_layers: int
    sublayers: Tuple[Sublayer, ...]


@dataclasses.dataclass(frozen=True)
class ModelPlan:
    cfg: ModelConfig
    stack: StackPlan                     # the decoded / backbone stack
    encoder: Optional[StackPlan] = None  # enc-dec only (stateless)


# ---------------------------------------------------------------------------
# nested-path helpers


def _get(d, path: str):
    for part in path.split("/"):
        d = d[part]
    return d


def _set(d, path: str, val):
    parts = path.split("/")
    for part in parts[:-1]:
        d = d.setdefault(part, {})
    d[parts[-1]] = val


def _copy_tree(d):
    return {k: _copy_tree(v) if isinstance(v, dict) else v
            for k, v in d.items()}


def nest(params: Dict[str, torch.Tensor], prefix: str) -> dict:
    """The leaves under ``prefix/`` as a nested dict (prefix stripped)."""
    out: dict = {}
    head = prefix + "/"
    for path, leaf in params.items():
        if path.startswith(head):
            _set(out, path[len(head):], leaf)
    return out


def _index(tree, i: int, axes=None):
    """Layer ``i`` of every (L, ...) leaf of a nested dict (views); a
    quantized leaf slices its q, scale and delta together. ``axes``: the
    tree is user-stacked, and ``core.batching.user_leaf_axes`` gives it;
    a part on the user axis (0) has its layer axis at 1."""
    def pick(t, ax):
        return None if t is None else t[i] if ax is None else t[:, i]

    def one(v, ax):
        if isinstance(v, dict):
            return _index(v, i, ax)
        if axes is None:
            return v.layer(i) if is_quantized(v) else v[i]
        if is_quantized(v):
            return dataclasses.replace(v, q=pick(v.q, ax.q),
                                       scale=pick(v.scale, ax.scale),
                                       delta=pick(v.delta, ax.delta))
        return pick(v, ax)
    return {k: one(v, None if axes is None else axes[k])
            for k, v in tree.items()}


def _embed_positions(cfg, positions, write_mask):
    """Learned-position ids with those of masked lanes clamped into the
    table: a draft step or window offset that writes nothing may sit past
    ``max_seq - 1``, where torch's gather raises (the reference's
    ``jnp.take`` returns NaN rows, which its trash page then carries). A
    live position never exceeds the admission reservation."""
    if cfg.pos != "learned" or write_mask is None:
        return positions
    if write_mask.dim() < positions.dim():
        write_mask = write_mask[:, None]
    return torch.where(write_mask, positions,
                       positions.clamp(max=cfg.max_seq - 1))


def _pos_vector(pos, b: int, device) -> torch.Tensor:
    """A scalar or (B,) position as a (B,) int32 tensor on ``device``."""
    pos = torch.as_tensor(pos, device=device).to(torch.int32)
    return pos.expand(b).contiguous() if pos.dim() == 0 else pos


# ---------------------------------------------------------------------------
# the one residual loop, in three modes


def _stack_apply(cfg, stack: StackPlan, params, x, rc: RunCtx, ctx=None):
    """Full-sequence stack. The perturb ctx binds the layer index
    (``at_layer``), so each layer's z slice is that of the stacked leaf."""
    blocks = nest(params, stack.scope)
    sctx = _sub(ctx, stack.scope)
    batched = ctx is not None and ctx.batched
    axes = user_leaf_axes(blocks) if batched else None
    # the aux loss: per lane under a user-axis ctx
    aux = torch.zeros((ctx.n_lanes,) if batched else (),
                      dtype=torch.float32, device=x.device)
    spans = ["model.mixer." + sl.block for sl in stack.sublayers]
    for li in range(stack.n_layers):
        bp = _index(blocks, li, axes)
        bctx = None if sctx is None else sctx.at_layer(li)
        for sl, name in zip(stack.sublayers, spans):
            bt = get_block(sl.block)
            z = L.norm_apply(cfg, _get(bp, sl.ln), x, _sub(bctx, sl.ln))
            with span(name):
                y, a = bt.apply(cfg, _get(bp, sl.mixer), z, rc,
                                ctx=_sub(bctx, sl.mixer), **dict(sl.opts))
            x = x + shd.settle(y)
            aux = aux + a
    return x, aux


def _window_scan(bt, cfg, p, state, z, rc, opts):
    """Verify walk of a recurrent block (mamba, rwkv): ``decode_step``
    once a window offset on a copy of the layer's state, the cache left
    as it was. Returns (y (B, W, D), {leaf: (W, B, ...)}): offset i's
    entry is the state after window tokens 0..i, so the engine can commit
    exactly the accepted prefix."""
    carry = {k: v.clone() for k, v in state.items()}
    rc1 = dataclasses.replace(rc, write_mask=None)
    ys, snaps = [], {k: [] for k in carry}
    for i in range(z.shape[1]):
        y, carry = bt.decode_step(cfg, p, carry, z[:, i:i + 1], rc1, **opts)
        ys.append(y)
        for k, v in carry.items():
            snaps[k].append(v.clone())
    return (torch.cat(ys, dim=1),
            {k: torch.stack(v) for k, v in snaps.items()})


def _stack_seq(cfg, stack: StackPlan, params, state, x, rc: RunCtx,
               mode: str):
    """Stateful stack walk: mode 'decode' (one token), 'prefill' (a whole
    prompt into a dense cache), 'chunk' (a prompt chunk straight into
    the page pool; recurrent state advances through the block's
    prefill) or 'verify' (a speculative window over the page pool;
    recurrent state is scanned a window offset at a time and left as it
    was). Returns (x, snapshots): in verify mode ``{mixer path: {leaf:
    (L, W, B, ...)}}`` of every recurrent block, else empty."""
    blocks = nest(params, stack.scope)
    snaps: dict = {}
    for li in range(stack.n_layers):
        bp, ls = _index(blocks, li), _index(state, li)
        for sl in stack.sublayers:
            bt = get_block(sl.block)
            z = L.norm_apply(cfg, _get(bp, sl.ln), x)
            opts = dict(sl.opts)
            p = _get(bp, sl.mixer)
            if not bt.stateful:
                y, _ = bt.apply(cfg, p, z, rc, **opts)
            elif mode == "verify" and bt.verify is None and bt.mutable_state:
                y, ns = _window_scan(bt, cfg, p, _get(ls, sl.mixer), z, rc,
                                     opts)
                for k, v in ns.items():
                    snaps.setdefault(sl.mixer, {}).setdefault(k, []).append(v)
            else:
                fn = {"decode": bt.decode_step, "prefill": bt.prefill,
                      "chunk": bt.prefill_paged or bt.prefill,
                      "verify": bt.verify or bt.decode_step}[mode]
                y, _ = fn(cfg, p, _get(ls, sl.mixer), z, rc, **opts)
            x = x + shd.settle(y)
    return x, {m: {k: torch.stack(v) for k, v in leaves.items()}
               for m, leaves in snaps.items()}


#: the batch inputs a user-axis forward reads, each with its lane axis
_LANE_INPUTS = ("tokens", "attn_mask", "patch_embeds", "enc_embeds")


def check_user_axis(plan: ModelPlan, batch, n_lanes: int):
    """Every family takes the user-axis forward; what cannot run is a
    batch whose inputs do not carry the ctx's ``n_lanes`` lanes on axis
    0 (``tokens`` (n, B, S), ``enc_embeds`` (n, B, T, d), ...), or an
    encoder-decoder batch without ``enc_embeds``. Raises ``ValueError``
    naming the input."""
    if plan.encoder is not None and "enc_embeds" not in batch:
        raise ValueError(f"{plan.cfg.name}: a user-axis batch needs "
                         f"enc_embeds (n, B, T, d) for the encoder")
    for key in _LANE_INPUTS:
        v = batch.get(key)
        if v is None:
            continue
        rank = 3 if key in ("tokens", "attn_mask") else 4
        if v.dim() != rank or v.shape[0] != n_lanes:
            raise ValueError(
                f"{plan.cfg.name}: user-axis {key} must carry {n_lanes} "
                f"lanes on axis 0 (rank {rank}), got {tuple(v.shape)}")


# ---------------------------------------------------------------------------
# model functions (what build_model wires into the Model facade)


def forward(plan: ModelPlan, params, batch, last_only=False, perturb=None):
    """Full-sequence forward -> (logits, aux). ``perturb`` (a PerturbCtx)
    switches on the fused perturbed forward; a user-axis one takes
    ``tokens`` (n, B, S) (and every other input with its lane axis) and
    returns logits (n * B, ...) and aux (n,). A batch's
    ``patch_embeds`` (B, P, d), the vlm frontend stub, is prepended to
    the token embeddings and cut off again before the LM head; an
    enc-dec plan runs its encoder over ``enc_embeds`` (B, T_enc, d), the
    audio frontend stub."""
    x, aux, n_prefix = _trunk(plan, params, batch, perturb)
    return _head(plan, params, x, n_prefix, last_only, perturb), aux


def _trunk(plan: ModelPlan, params, batch, perturb=None):
    """:func:`forward` up to the final norm: (x, aux, the number of
    prefix positions the head cuts off)."""
    cfg = plan.cfg
    batched = perturb is not None and perturb.batched
    if batched:
        check_user_axis(plan, batch, perturb.n_lanes)
    tokens = batch["tokens"]
    kv_mask = batch.get("attn_mask")
    patches = batch.get("patch_embeds")
    frames = batch["enc_embeds"] if plan.encoder is not None else None
    if batched:
        tokens = tokens.reshape(-1, tokens.shape[-1])
        if kv_mask is not None:
            kv_mask = kv_mask.reshape(-1, kv_mask.shape[-1])
        if patches is not None:
            patches = patches.reshape(-1, *patches.shape[-2:])
        if frames is not None:
            frames = frames.reshape(-1, *frames.shape[-2:])
    with span("model.embed"):
        x = L.embed_apply(cfg, nest(params, "embed"), tokens,
                          ctx=_sub(perturb, "embed"))
    n_prefix = 0
    if patches is not None:            # vlm: prepend the stub patches
        x = torch.cat([patches.to(x.dtype), x], dim=1)
        n_prefix = patches.shape[1]
    enc_out = None
    if plan.encoder is not None:       # enc-dec: the stub frontend's frames
        e = frames.to(L.dtype_of(cfg))
        erc = RunCtx(positions=torch.arange(e.shape[1], device=e.device)[None])
        e, _ = _stack_apply(cfg, plan.encoder, params, e, erc, perturb)
        enc_out = L.norm_apply(cfg, nest(params, "ln_enc"), e,
                               _sub(perturb, "ln_enc"))
    positions = torch.arange(x.shape[1], device=x.device)[None]
    rc = RunCtx(positions=positions, kv_mask=kv_mask, enc_out=enc_out)
    x, aux = _stack_apply(cfg, plan.stack, params, x, rc, perturb)
    x = L.norm_apply(cfg, nest(params, "ln_f"), x, _sub(perturb, "ln_f"))
    return x, aux, n_prefix


def _head(plan: ModelPlan, params, x, n_prefix=0, last_only=False,
          perturb=None):
    """The final-normed ``x`` to logits: the CLS head (roberta/SST-2),
    or the LM head over the positions past the prefix."""
    if plan.cfg.n_classes:             # CLS pooling + head
        cls = x[:, 0].to(torch.float32)
        return L.dense(nest(params, "cls_head"), torch.tanh(cls),
                       _sub(perturb, "cls_head"))
    if n_prefix:
        x = x[:, n_prefix:]
    if last_only:
        x = x[:, -1:]
    return _logits(plan, params, x, perturb)


def _logits(plan: ModelPlan, params, x, ctx=None):
    head = nest(params, "lm_head") or None
    return L.unembed(plan.cfg, nest(params, "embed"), head, x, ctx)


def softmax_xent(logits, targets, mask=None):
    """Cross entropy in the reference's order: the max and the subtraction
    in the logits' dtype, the exp-sum in f32, the gold logit read exactly
    from the logits."""
    m = logits.amax(dim=-1)
    sumexp = torch.exp((logits - m[..., None]).to(torch.float32)).sum(-1)
    lse = m.to(torch.float32) + torch.log(sumexp)
    if shd.is_dtensor(logits):     # vocab-parallel: no gather of logits
        gold = shd.gather_last(logits, targets)
    else:
        gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = lse - gold.to(torch.float32)
    if mask is not None:
        return torch.sum(nll * mask) / (torch.sum(mask) + 1e-9)
    return torch.mean(nll)


def loss(plan: ModelPlan, params, batch, perturb=None):
    """The ZO objective: CE (+ aux) for LMs, the CLS head's CE for the
    encoder classifier. ``perturb`` switches on the fused forward; a
    user-axis one returns the (n,) losses of its lanes, each reduced over
    its own (B, S) exactly as a lone forward reduces it. Under a mesh
    (DTensor parameters) the loss comes back as a plain tensor, the global
    scalar every rank holds, as the reference's replicated loss is."""
    x, aux, n_prefix = _trunk(plan, params, batch, perturb)
    with span("model.head_loss"):
        logits = _head(plan, params, x, n_prefix, perturb=perturb)
        del x                          # freed before the loss, as in forward()
        if perturb is not None and perturb.batched:
            lanes = perturb.lane_view(logits).unbind(0)
            keys = ("label",) if plan.cfg.n_classes else ("targets",
                                                          "loss_mask")
            per_lane = [dict(zip(keys, vals)) for vals in zip(*[
                batch[k].unbind(0) if k in batch else [None] * len(lanes)
                for k in keys])]
            return torch.stack([_ce(plan, lg, b, a) for lg, b, a in
                                zip(lanes, per_lane, aux.unbind(0))])
        out = _ce(plan, logits, batch, aux)
    return out.full_tensor() if shd.is_dtensor(out) else out


def _ce(plan: ModelPlan, logits, batch, aux):
    if plan.cfg.n_classes:
        return softmax_xent(logits, batch["label"])
    ce = softmax_xent(logits, batch["targets"], batch.get("loss_mask"))
    return ce + AUX_LOSS_WEIGHT * aux


def init_cache(plan: ModelPlan, bsz, max_len, dtype, device):
    """Dense StateCache: every leaf (n_layers, B, ...)."""
    cfg = plan.cfg
    sub: dict = {}
    for sl in plan.stack.sublayers:
        bt = get_block(sl.block)
        if not bt.stateful:
            continue
        spec = bt.state_spec(cfg, bsz, max_len, dtype)
        _set(sub, sl.mixer,
             {name: torch.zeros((plan.stack.n_layers,) + shape, dtype=dt,
                                device=device)
              for name, (shape, dt) in spec.items()})
    return {plan.stack.scope: sub}


def plan_pages(plan: ModelPlan) -> bool:
    """True iff any sublayer of the stack has pageable state."""
    return any(get_block(sl.block).paged_state_spec is not None
               for sl in plan.stack.sublayers)


def init_paged_cache(plan: ModelPlan, bsz, n_pages, page_size, dtype,
                     device, max_len=None):
    """Paged StateCache: pageable leaves (attention K/V) become
    ``(n_layers, n_pages, page_size, ...)`` pools shared by every slot
    through a page table; physical page 0 is the trash page. Blocks
    without pageable state keep the dense (n_layers, B, ...) layout."""
    cfg = plan.cfg
    sub: dict = {}
    for sl in plan.stack.sublayers:
        bt = get_block(sl.block)
        if not bt.stateful:
            continue
        if bt.paged_state_spec is not None:
            spec = bt.paged_state_spec(cfg, dtype)
            lead = (plan.stack.n_layers, n_pages, page_size)
        else:
            spec = bt.state_spec(cfg, bsz, max_len or cfg.max_seq, dtype)
            lead = (plan.stack.n_layers,)
        _set(sub, sl.mixer,
             {name: torch.zeros(lead + shape, dtype=dt, device=device)
              for name, (shape, dt) in spec.items()})
    return {plan.stack.scope: sub}


def decode_step(plan: ModelPlan, params, cache, tokens, pos, pages=None,
                write_mask=None):
    """tokens: (B, 1) -> (logits (B, 1, V), cache) with the cache written
    at ``pos`` (scalar or (B,)). With a paged cache, ``pages`` is the
    (B, n_live) int32 table slice; ``write_mask`` (B,) confines writes to
    a slot subset (masked slots scatter into the trash page, or keep
    their old dense entry)."""
    cfg = plan.cfg
    pos = _pos_vector(pos, tokens.shape[0], tokens.device)
    x = L.embed_apply(cfg, nest(params, "embed"), tokens,
                      positions=_embed_positions(cfg, pos.long()[:, None],
                                                 write_mask))
    rc = RunCtx(pos=pos, pages=pages, write_mask=write_mask)
    x, _ = _stack_seq(cfg, plan.stack, params, cache[plan.stack.scope], x,
                      rc, "decode")
    x = L.norm_apply(cfg, nest(params, "ln_f"), x)
    return _logits(plan, params, x), cache


def _paged_window(plan: ModelPlan, params, cache, tokens, pos, pages,
                  write_mask, mode: str):
    """Tokens (B, W) at per-slot positions ``pos .. pos + W - 1`` through
    the stack in ``mode`` ('chunk' or 'verify') -> (logits (B, W, V),
    cache); the window's K/V is written through the page table."""
    cfg = plan.cfg
    pos = _pos_vector(pos, tokens.shape[0], tokens.device)
    positions = (pos.long()[:, None]
                 + torch.arange(tokens.shape[1], device=tokens.device))
    x = L.embed_apply(cfg, nest(params, "embed"), tokens,
                      positions=_embed_positions(cfg, positions,
                                                 write_mask))
    rc = RunCtx(pos=pos, positions=positions, pages=pages,
                write_mask=write_mask)
    scope = plan.stack.scope
    x, snaps = _stack_seq(cfg, plan.stack, params, cache[scope], x, rc, mode)
    x = L.norm_apply(cfg, nest(params, "ln_f"), x)
    if snaps:
        sub = _copy_tree(cache[scope])
        for m, leaves in snaps.items():
            _set(sub, m, {**_get(sub, m), **leaves})
        cache = {scope: sub}
    return _logits(plan, params, x), cache


def verify_window(plan: ModelPlan, params, cache, tokens, pos, pages=None,
                  write_mask=None):
    """Speculative-verify scoring call: tokens (B, W) at per-slot
    positions ``pos .. pos + W - 1`` -> (logits (B, W, V), cache). The
    window's K/V is written through the page table, so the pool
    afterwards holds this model's K/V at every window position;
    ``write_mask`` (B, W) sends offsets past a slot's window to the trash
    page. Recurrent state is left as it was: the returned cache holds its
    per-offset snapshots (L, W, B, ...) instead (:func:`commit_window`)."""
    return _paged_window(plan, params, cache, tokens, pos, pages,
                         write_mask, "verify")


def prefill_chunk(plan: ModelPlan, params, cache, tokens, pos, pages=None,
                  write_mask=None):
    """Chunked prefill into a paged cache: tokens (B, C) at per-slot
    positions ``pos .. pos + C - 1`` -> (logits (B, C, V), cache). The
    chunk's K/V is written through the page table, which must cover
    ``pos + C - 1``."""
    return _paged_window(plan, params, cache, tokens, pos, pages,
                         write_mask, "chunk")


def commit_window(plan: ModelPlan, cache, vcache, acc, mask) -> None:
    """Fold a verify window's result into ``cache`` in place: each
    recurrent leaf of a slot in ``mask`` (B,) bool takes its snapshot at
    window offset ``acc[slot]`` (the state after consuming offsets 0 ..
    acc); pool and read-only leaves are ``vcache``'s own (already
    written, or never)."""
    for old, new in zip(recurrent_leaves(plan, cache),
                        recurrent_leaves(plan, vcache)):
        slots = torch.arange(old.shape[1], device=old.device)
        sel = new[:, acc, slots]                        # (L, B, ...)
        m = mask.reshape(1, -1, *([1] * (old.dim() - 2)))
        old.copy_(torch.where(m, sel, old))


def is_pool(name: str) -> bool:
    """A cache leaf shared by every slot through the page table
    (``k_pages``); every other leaf is dense, batch on axis 1."""
    return name.endswith("_pages")


def recurrent_leaves(plan: ModelPlan, cache):
    """The dense state leaves of a cache's mutable blocks (mamba / rwkv
    state), in plan order: what a speculative draft must leave as it
    found it, what a verify window returns snapshots of, and what a
    chunked admission starts from zero."""
    sub = cache[plan.stack.scope]
    out = []
    for sl in plan.stack.sublayers:
        bt = get_block(sl.block)
        if bt.stateful and bt.mutable_state:
            out += [t for name, t in _get(sub, sl.mixer).items()
                    if not is_pool(name)]
    return out


def prefill(plan: ModelPlan, params, cache, tokens):
    """Whole-prompt prefill: one pass over the (B, P) prompt writes cache
    positions [0, P) and returns next-token logits (B, 1, V)."""
    cfg = plan.cfg
    x = L.embed_apply(cfg, nest(params, "embed"), tokens)
    rc = RunCtx(positions=torch.arange(tokens.shape[1],
                                       device=tokens.device)[None])
    x, _ = _stack_seq(cfg, plan.stack, params, cache[plan.stack.scope], x,
                      rc, "prefill")
    x = L.norm_apply(cfg, nest(params, "ln_f"), x[:, -1:])
    return _logits(plan, params, x), cache


__all__ = ["AUX_LOSS_WEIGHT", "ModelPlan", "StackPlan", "Sublayer",
           "check_user_axis", "commit_window", "decode_step", "forward",
           "init_cache", "init_paged_cache", "is_pool", "loss", "nest",
           "plan_pages", "prefill", "prefill_chunk", "recurrent_leaves",
           "softmax_xent", "verify_window"]
