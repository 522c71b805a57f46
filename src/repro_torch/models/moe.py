"""Top-k Mixture-of-Experts with sort-based capacity dispatch (EP).

Port of the JAX package's ``models/moe.py``: ``moe_apply`` and the
expert-parallel ``moe_apply_ep`` / ``_moe_ep_weights_stationary``. The
(token, expert) assignment list is sorted by expert id and each expert's
first ``capacity`` rows are scattered into an (E, C, D) buffer -- O(T*k*D)
memory, never a (T, E, C) one-hot. Assignments past capacity are
dropped: their combine weight is zero, so the residual path carries
those tokens unchanged. ``capacity_factor`` None is dropless routing
(Jamba's): a call's capacity is its largest expert load, read to the
host once (``moe.route.sync``) and rounded up to 64 rows, so every
assignment is kept through the same dispatch. The gates are the top-k
softmax probabilities, renormalized to sum 1 unless ``moe_renorm`` is
False.

``moe_apply`` runs its stages under the spans ``moe.route`` (gates,
capacity, dispatch), ``moe.experts`` and ``moe.combine``, and counts its
calls, assignments, expert rows and (dropless) largest load in
``core.spans.COUNTS``. :data:`ROUTES`, when a list, receives each call's
top-k expert ids (T, k) on the device, in call order.

Dispatch and combine are deterministic on the card: a kept assignment
owns its buffer row (no two writes meet, and dropped ones go to one
spare row that nothing reads), and the combine gathers each token's k
expert outputs in top-k order and sums them -- no atomic float
``index_add_``, so two calls on the same input are bit-equal (the
serving and replay contracts rest on it).

Under an ambient mesh (``sharding.use_mesh``; DTensor activations and
expert weights sharded on the expert axis over ``model``):

  * ``moe_apply`` takes the reference's auto-sharded plan as a local
    form: the tokens are gathered, every rank dispatches all of them,
    the (E, C, D) buffer is sharded over ``model`` (``maybe_shard``, the
    reference's annotation), each rank runs its experts, and the combine
    gathers the whole expert output back -- the full-buffer collective
    per layer that the reference's EP path exists to avoid;
  * ``moe_apply_ep`` is the reference's ``shard_map`` body on this rank's
    shards (``to_local`` / functional collectives): each model rank owns
    ``E / model`` experts and selects its own tokens with a per-shard
    capacity; density and probs are averaged over the batch axes, and the
    one collective on the activations is the bf16 sum of the combined
    (T, D) output over ``model``. With ``fsdp_params`` the data axis
    gathers the F-sliced expert weights per layer; at decode-sized token
    counts (``b * s <= 8192``, gated) the weights stay put and the tokens
    are gathered instead (``_moe_ep_weights_stationary``).

Without a mesh, or a ``model`` axis, or with ``n_experts % model != 0``,
``moe_apply_ep`` is ``moe_apply``, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import spans
from repro_torch.core.spans import span
from repro_torch.models import layers as L
from repro_torch.models import sharding as shd

#: None, or a list that each ``moe_apply`` call appends its (T, k) expert
#: ids to (the benchmark compares them with its reference's routing)
ROUTES = None
#: dropless capacity is the largest load rounded up to this many rows
DROPLESS_ROWS = 64


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


def capacity(n_tokens: int, cfg, idx=None) -> int:
    """Expert rows a call: from ``capacity_factor``, or dropless (None):
    the largest load of the call's expert ids ``idx``, read to the host
    and rounded up to :data:`DROPLESS_ROWS`."""
    if cfg.capacity_factor is not None:
        c = int(n_tokens * cfg.topk * cfg.capacity_factor / cfg.n_experts)
        return max(8, c)
    if idx is None:
        raise ValueError("dropless routing (capacity_factor None) runs on "
                         "moe_apply alone, not on the expert-parallel path")
    with span("moe.route.sync"):
        load = int(torch.bincount(idx.reshape(-1),
                                  minlength=cfg.n_experts).max())
    spans.count_max("moe.max_load", load)
    return max(DROPLESS_ROWS, -(-load // DROPLESS_ROWS) * DROPLESS_ROWS)


def _gates(cfg, xf, router):
    logits = xf.to(torch.float32) @ router                     # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, cfg.topk, dim=-1)            # (T, k)
    if cfg.moe_renorm:
        gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    density = F.one_hot(idx[:, 0], cfg.n_experts).to(torch.float32).mean(0)
    return probs, gate, idx, density


def _dispatch(flat_e, n_exp: int, c: int, k: int, valid=None):
    """Sort (token, expert) assignments by expert id (``n_exp`` experts;
    ``valid`` False marks one owned elsewhere, sorted to the tail) and
    give each kept one its buffer row. Returns (order, token of each
    sorted assignment, its row, kept)."""
    dev = flat_e.device
    if valid is None:
        key = flat_e
    else:
        key = torch.where(valid, flat_e, n_exp)                # sentinel tail
    order = torch.argsort(key, stable=True)
    se = key[order]
    sec = se.clamp(0, n_exp - 1)
    starts = torch.searchsorted(se, torch.arange(n_exp, device=dev))
    pos = torch.arange(flat_e.numel(), device=dev) - starts[sec]
    keep = pos < c
    if valid is not None:
        keep = keep & valid[order]
    slot = sec * c + torch.where(keep, pos, 0)
    return order, order // k, slot, keep


def _scatter(xf, st, slot, keep, rows: int):
    """The (rows, D) expert buffer: kept assignment i's token in row
    ``slot[i]``; dropped ones go to a spare last row, cut off here."""
    buf = torch.zeros((rows + 1, xf.shape[-1]), dtype=xf.dtype,
                      device=xf.device)
    buf[torch.where(keep, slot, rows)] = xf[st]
    return buf[:-1]


def _combine(yexp, order, slot, keep, gate, k: int, dtype):
    """Each token's k expert outputs (rows ``slot`` of ``yexp``) weighted
    by its gates and summed in top-k order: (T, D)."""
    n = order.numel()
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=order.device)
    w = gate.reshape(-1)[order] * keep
    contrib = yexp[slot] * w.to(dtype)[:, None]                # sorted order
    return contrib[inv].reshape(n // k, k, -1).sum(1).to(dtype)


def moe_apply(cfg, p, x):
    """x: (B, S, D) -> (out (B, S, D), aux load-balancing loss). ``p`` is
    the block's plain (perturbed or dequantized) expert sub-dict."""
    if shd.is_dtensor(x):
        return _moe_apply_auto(cfg, p, x)
    b, s, d = x.shape
    tt = b * s
    e, k = cfg.n_experts, cfg.topk
    xf = x.reshape(tt, d)
    with span("moe.route"):
        probs, gate, idx, density = _gates(cfg, xf, p["router"])
        # load-balancing auxiliary loss (Switch-style)
        aux = e * torch.mean(probs.mean(0) * density)
        if ROUTES is not None:
            ROUTES.append(idx)
        c = capacity(tt, cfg, idx)
        order, st, slot, keep = _dispatch(idx.reshape(-1), e, c, k)
        buf = _scatter(xf, st, slot, keep, e * c)
    spans.count("moe.calls")
    spans.count("moe.assignments", tt * k)
    spans.count("moe.rows", e * c)
    with span("moe.experts"):
        yexp = _expert_ffn(cfg, p["w_in"], p["w_out"],
                           buf.reshape(e, c, d)).reshape(e * c, d)
    with span("moe.combine"):
        out = _combine(yexp, order, slot, keep, gate, k,
                       x.dtype).reshape(b, s, d)
    if cfg.n_shared_experts:
        out = out + L.mlp_apply(cfg, p["shared"], x)
    return out, aux


# ---------------------------------------------------------------------------
# under a mesh


def _replicated(t):
    """A DTensor's whole value on every rank (gathered), as a plain
    tensor; a plain tensor as it is."""
    if not shd.is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh,
                          [Replicate()] * t.device_mesh.ndim).to_local()


def _model_only(w, mesh):
    """The local expert block of an expert-sharded weight: sharded on the
    expert axis over ``model`` and nothing else (a weight also sharded
    over ``data`` -- ``fsdp_params`` -- is gathered over it first)."""
    from torch.distributed.tensor import Replicate, Shard
    names = shd.axis_names(mesh)
    pl = [Shard(0) if n == "model" else Replicate() for n in names]
    return w.redistribute(mesh, pl).to_local()


def _moe_apply_auto(cfg, p, x):
    """The reference's auto-sharded ``moe_apply`` under a mesh, as a
    local form (module docstring)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    b, s, d = x.shape
    tt = b * s
    e, k = cfg.n_experts, cfg.topk
    xf = _replicated(x).reshape(tt, d)               # the tokens, gathered
    probs, gate, idx, density = _gates(cfg, xf, _replicated(p["router"]))
    aux = e * torch.mean(probs.mean(0) * density)
    c = capacity(tt, cfg, idx)
    order, st, slot, keep = _dispatch(idx.reshape(-1), e, c, k)
    buf = _scatter(xf, st, slot, keep, e * c).reshape(e, c, d)
    rep = [Replicate()] * mesh.ndim
    buf = shd.maybe_shard(DTensor.from_local(buf, mesh, rep), "model", None,
                          None)
    if shd.is_dtensor(p["w_in"]):
        w_in, w_out = _model_only(p["w_in"], mesh), _model_only(p["w_out"],
                                                                mesh)
    else:
        lo = shd.local_offsets(buf)[0]
        n_loc = buf.to_local().shape[0]
        w_in, w_out = p["w_in"][lo:lo + n_loc], p["w_out"][lo:lo + n_loc]
    yl = _expert_ffn(cfg, w_in, w_out, buf.to_local())
    yexp = DTensor.from_local(yl.contiguous(), mesh, buf.placements,
                              shape=buf.shape,
                              stride=shd.contiguous_stride(buf.shape))
    yexp = shd.maybe_shard(yexp, "model", None, None)
    # the combine reads any expert's rows: the whole output, gathered
    yexp = _replicated(yexp).reshape(e * c, d)
    out = _combine(yexp, order, slot, keep, gate, k, x.dtype).reshape(b, s, d)
    out = DTensor.from_local(out, mesh, rep).redistribute(mesh, x.placements)
    if cfg.n_shared_experts:
        out = out + shd.settle(L.mlp_apply(cfg, p["shared"], x))
    return out, _replicated_dt(aux, mesh)


def _batch_axes(mesh, b: int):
    """The batch axes (pod, data) whose product divides b, in order, and
    that product (the reference's ``chosen``)."""
    sizes = shd.axis_sizes(mesh)
    chosen, prod = [], 1
    for a in ("pod", "data"):
        if a in sizes and b % (prod * sizes[a]) == 0:
            chosen.append(a)
            prod *= sizes[a]
    return chosen, prod


def _replicated_dt(t, mesh):
    """A value every rank holds alike (the aux loss after its means) as a
    replicated DTensor: its gradient then comes back to this rank as a
    plain tensor, as the collectives behind it take it."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim)


def _mean_over(t, mesh, axes):
    """The mean of ``t`` over the named mesh axes (the reference's
    ``pmean``), one all-reduce an axis."""
    sizes = shd.axis_sizes(mesh)
    for a in axes:
        if sizes[a] > 1:
            t = _sum_over(t, mesh, [a]) / sizes[a]
    return t


def _sum_over(t, mesh, axes):
    import torch.distributed._functional_collectives as fc
    sizes = shd.axis_sizes(mesh)
    for a in axes:
        if sizes[a] > 1:             # a one-rank axis has nothing to sum
            t = fc.wait_tensor(fc.all_reduce(t, "sum", mesh.get_group(a)))
    return t


def _gather_over(t, mesh, axes, dim: int):
    """All-gather ``t`` along ``dim`` over the named mesh axes (tiled, the
    later axis minor)."""
    import torch.distributed._functional_collectives as fc
    sizes = shd.axis_sizes(mesh)
    for a in reversed(axes):
        if sizes[a] > 1:
            t = fc.wait_tensor(fc.all_gather_tensor(t, dim,
                                                    mesh.get_group(a)))
    return t


def _local_of(t, mesh):
    """The local shard of a DTensor on ``mesh`` (a plain tensor as it
    is), with the placements it was found in."""
    if not shd.is_dtensor(t):
        return t, None
    from torch.distributed.tensor import Partial
    if any(isinstance(pl, Partial) for pl in t.placements):
        t = shd.settle(t)
    return t.to_local(), t.placements


def _in_model_replicated(x, mesh):
    """x with ``Replicate()`` on every mesh dim but the batch ones."""
    if not shd.is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    names = shd.axis_names(mesh)
    pl = [p if (isinstance(p, Shard) and p.dim == 0 and n in ("pod", "data"))
          else Replicate() for n, p in zip(names, x.placements)]
    return shd.settle(x).redistribute(mesh, pl)


def _shared_local(cfg, xf, sw_in, sw_out):
    """The shared expert on this rank's F slice (w_in column-, w_out
    row-sharded over ``model``): its partial sum rides the routed
    experts' all-reduce."""
    h = torch.einsum("td,dfg->tfg", xf, sw_in)
    act = (F.silu(h[..., 1]) if cfg.act == "swiglu"
           else F.gelu(h[..., 1], approximate="tanh"))
    return (h[..., 0] * act) @ sw_out


def _ep_local(cfg, xf, router, w_in, w_out, me: int, e_local: int, c: int,
              mesh, mean_axes):
    """One model rank's share of the EP combine for tokens ``xf`` (T, D):
    its experts' outputs for the tokens routed to them, and the aux loss
    (density and probs averaged over ``mean_axes``)."""
    t, d = xf.shape
    k = cfg.topk
    probs, gate, idx, density = _gates(cfg, xf, router)
    pm = probs.mean(0)
    if mean_axes:   # global token mean, matching the auto-sharded path
        density = _mean_over(density, mesh, mean_axes)
        pm = _mean_over(pm, mesh, mean_axes)
    aux = cfg.n_experts * torch.mean(pm * density)
    flat_e = idx.reshape(-1) - me * e_local
    mine = (flat_e >= 0) & (flat_e < e_local)
    order, st, slot, keep = _dispatch(flat_e, e_local, c, k, valid=mine)
    buf = _scatter(xf, st, slot, keep, e_local * c)
    yexp = _expert_ffn(cfg, w_in, w_out,
                       buf.reshape(e_local, c, d)).reshape(e_local * c, d)
    return _combine(yexp, order, slot, keep, gate, k, xf.dtype), aux


def moe_apply_ep(cfg, p, x):
    """Expert-parallel MoE over the ambient mesh's ``model`` axis (module
    docstring); ``moe_apply`` without one."""
    mesh = shd.ambient()
    names = shd.axis_names(mesh) if mesh is not None else ()
    if "model" not in names or not shd.is_dtensor(p["w_in"]):
        return moe_apply(cfg, p, x)
    sizes = shd.axis_sizes(mesh)
    n_model = sizes["model"]
    if cfg.n_experts % n_model:
        return moe_apply(cfg, p, x)
    from torch.distributed.tensor import DTensor

    b, s, d = x.shape
    chosen, prod = _batch_axes(mesh, b)
    fsdp = cfg.fsdp_params and "data" in names
    gated = cfg.act in ("swiglu", "geglu")
    if fsdp and gated and b * s <= 8192:
        # decode-sized token counts: moving the expert weights for a few
        # thousand tokens is backwards -- keep the weights stationary and
        # gather the (tiny) tokens instead
        return _moe_ep_weights_stationary(cfg, p, x, mesh, chosen, prod)
    e_local = cfg.n_experts // n_model
    c = capacity((b // prod) * s, cfg)
    me = mesh.get_local_rank("model")
    x = _in_model_replicated(x, mesh)
    xl, x_pl = _local_of(x, mesh)
    router = _replicated(p["router"])
    w_in, w_out = p["w_in"].to_local(), p["w_out"].to_local()
    if fsdp:
        # ZeRO-3 style: expert weights stored F-sharded over `data`;
        # gather this layer's local experts just-in-time (F is axis 2 of
        # both the gated (E, D, F, 2) and flat (E, D, F) w_in)
        w_in = _gather_over(w_in, mesh, ["data"], 2)
        w_out = _gather_over(w_out, mesh, ["data"], 1)
    bl, sl, _ = xl.shape
    xf = xl.reshape(bl * sl, d)
    out, aux = _ep_local(cfg, xf, router, w_in, w_out, me, e_local, c, mesh,
                         chosen)
    # fold the always-on shared expert into the same sum as the routed
    # experts: its w_out partial rides the existing all-reduce
    fold_shared = bool(cfg.n_shared_experts) and gated and "shared" in p
    if fold_shared:
        out = out + _shared_local(cfg, xf, p["shared"]["w_in"]["w"].to_local(),
                                  p["shared"]["w_out"]["w"].to_local())
    # one sum over `model`, in the activation dtype (bf16 at full size)
    out = _sum_over(out, mesh, ["model"]).reshape(bl, sl, d)
    out = DTensor.from_local(out.contiguous(), mesh, x_pl, shape=x.shape,
                             stride=shd.contiguous_stride(x.shape))
    if cfg.n_shared_experts and not fold_shared:
        out = out + shd.settle(L.mlp_apply(cfg, p["shared"], x))
    return out, _replicated_dt(aux, mesh)


def _moe_ep_weights_stationary(cfg, p, x, mesh, chosen, prod):
    """Inference-MoE dispatch for tiny token counts (decode): the tokens
    are gathered over the batch axes, every (model, data) rank computes
    its experts' F-slice partials for all of them, and one sum over the
    axes that shard the weights (``model`` and ``data``) returns the
    combined output -- no weight moves. The shared expert's partial is
    added on one data rank only. (The reference sums over ``model`` and the
    batch axes and adds the shared expert on every rank; a ``pod`` axis
    among the batch axes, whose ranks hold the same F slice, and the data
    ranks, which hold the same shared-expert slice, would each count a
    partial more than once.)"""
    from torch.distributed.tensor import DTensor
    b, s, d = x.shape
    n_model = shd.axis_sizes(mesh)["model"]
    e_local = cfg.n_experts // n_model
    c = capacity(b * s, cfg)
    me = mesh.get_local_rank("model")
    x = _in_model_replicated(x, mesh)
    xl, x_pl = _local_of(x, mesh)
    bl = xl.shape[0]
    xa = _gather_over(xl, mesh, chosen, 0) if chosen else xl
    xf = xa.reshape(-1, d)
    out, aux = _ep_local(cfg, xf, _replicated(p["router"]),
                         p["w_in"].to_local(), p["w_out"].to_local(), me,
                         e_local, c, mesh, [])
    names = shd.axis_names(mesh)
    if cfg.n_shared_experts and "shared" in p and (
            "data" not in names or mesh.get_local_rank("data") == 0):
        # the shared expert is sharded over `model` only: one data rank
        # adds its partial, so the sum over `data` counts it once
        out = out + _shared_local(cfg, xf, p["shared"]["w_in"]["w"].to_local(),
                                  p["shared"]["w_out"]["w"].to_local())
    out = _sum_over(out, mesh, ["model"] + (["data"] if "data" in names
                                            else []))
    out = out.reshape(-1, s, d)
    if chosen:
        i = 0
        for a in chosen:
            i = i * shd.axis_sizes(mesh)[a] + mesh.get_local_rank(a)
        out = out[i * bl:(i + 1) * bl]
    out = DTensor.from_local(out.contiguous(), mesh, x_pl, shape=x.shape,
                             stride=shd.contiguous_stride(x.shape))
    return out, _replicated_dt(aux, mesh)
