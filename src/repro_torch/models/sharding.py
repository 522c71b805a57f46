"""Parameter / activation sharding rules for the (pod, data, model) mesh.

Port of the JAX package's ``models/sharding.py``. Megatron-style tensor
parallelism over the ``model`` axis:

  * embeddings + lm_head: vocab-sharded,
  * attention: head axis sharded (wq/wk/wv column-, wo row-parallel),
  * MLP: w_in column-, w_out row-parallel,
  * MoE: the *expert* axis sharded (expert parallelism); router replicated,
  * mamba/rwkv: d_inner / channel projections column/row-sharded,
  * norms/scalars: replicated.

Params are replicated across ``pod`` and ``data`` (ZO direction
parallelism needs no param sharding across pods -- cross-pod traffic is
scalars only).

Rules are matched on the ``/``-joined leaf path, most-specific-first. A
spec is a :class:`P`: a tuple whose entries are ``None``, an axis name or
a tuple of axis names, entry for entry the reference's ``PartitionSpec``.
``spec_tree(params)`` maps a flat ``path -> tensor`` dict (any object
with ``.shape``/``.ndim``, or a shape tuple) to specs, ``fit_spec`` drops
axes that do not divide a dim, and :func:`placements` turns a fitted spec
into ``torch.distributed.tensor`` placements on a ``DeviceMesh`` --
``Shard(d)`` on each mesh dim that splits tensor dim d, ``Replicate()``
elsewhere -- which :func:`distribute_tree` applies. A dim split over two
mesh axes (the cache's ``("model", "data")``) gets ``Shard(d)`` on both:
the shard shapes are the reference's, the order of the blocks along d is
DTensor's (mesh-dim order).

``use_mesh(mesh)`` sets the ambient mesh (``jax.set_mesh``'s
counterpart) that :func:`maybe_shard` and the expert-parallel MoE read;
without one, both are no-ops, as in the reference.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import re
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.dtensor import (  # noqa: F401  (re-exported)
    contiguous_stride, is_dtensor, local_offsets, settle)


class P(tuple):
    """A partition spec: one entry per tensor dim, each ``None``, a mesh
    axis name or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + tuple.__repr__(tuple(self))

    def __getnewargs__(self):
        return tuple(self)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names without devices or a process group
    (what the rules need; the reference's ``AbstractMesh``)."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, an :class:`AbstractMesh`
    or any object with ``axis_names`` and ``devices`` (an array)."""
    if hasattr(mesh, "mesh_dim_names"):
        shape = tuple(mesh.mesh.shape)
    elif hasattr(mesh, "devices"):
        shape = tuple(mesh.devices.shape)
    else:
        shape = tuple(mesh.shape)
    return dict(zip(axis_names(mesh), shape))


# (path regex, spec builder given leaf ndim). Leading scan axis (stacked
# blocks) is detected by ndim relative to the rule's base rank.
_RULES = [
    # embeddings: vocab-sharded
    (r"embed/tok$", lambda nd: P("model", None)),
    (r"embed/pos$", lambda nd: P(None, None)),
    (r"lm_head/w$", lambda nd: _stk(nd, 2, P(None, "model"))),
    (r"cls_head/w$", lambda nd: P(None, None)),
    # attention
    (r"(attn|self|cross)/wq/w$", lambda nd: _stk(nd, 2, P(None, "model"))),
    (r"(attn|self|cross)/wk/w$", lambda nd: _stk(nd, 2, P(None, "model"))),
    (r"(attn|self|cross)/wv/w$", lambda nd: _stk(nd, 2, P(None, "model"))),
    (r"(attn|self|cross)/wo/w$", lambda nd: _stk(nd, 2, P("model", None))),
    (r"(attn|self|cross)/w[qkv]/b$", lambda nd: _stk(nd, 1, P("model"))),
    (r"(attn|self|cross)/wo/b$", lambda nd: _stk(nd, 1, P(None))),
    # dense MLPs (incl. moe shared expert). Gated w_in uses the
    # interleaved (D, F, 2) layout: shard F.
    (r"(mlp|shared)/w_in/w$", lambda nd: _gated_or_flat_in(nd)),
    (r"(mlp|shared)/w_out/w$", lambda nd: _stk(nd, 2, P("model", None))),
    (r"(mlp|shared)/w_in/b$", lambda nd: _stk(nd, 1, P("model"))),
    (r"(mlp|shared)/w_out/b$", lambda nd: _stk(nd, 1, P(None))),
    # MoE: expert-parallel over the expert axis
    (r"moe/router$", lambda nd: _stk(nd, 2, P(None, None))),
    # w_in: flat (E, D, F) or gated-interleaved (E, D, F, 2), +stack axis
    (r"moe/w_in$", lambda nd: _stk(nd, 3, P("model", None, None))
     or _stk(nd - 1, 3, P("model", None, None, None))),
    (r"moe/w_out$", lambda nd: _stk(nd, 3, P("model", None, None))),
]

# fsdp_params=True: expert weights additionally sharded over ``data`` on
# the per-expert hidden dim (storage), gathered per layer inside the EP
# dispatch (ZeRO-3 style). Required when params/chip exceed device memory
# with model-only sharding (kimi-k2: 2 TB of expert weights).
_FSDP_RULES = [
    (r"moe/w_in$", lambda nd: _stk(nd, 3, P("model", None, "data"))
     or _stk(nd - 1, 3, P("model", None, "data", None))),
    (r"moe/w_out$", lambda nd: _stk(nd, 3, P("model", "data", None))),
]

_RULES += [
    # mamba
    (r"mamba/in_proj/w$", lambda nd: _stk(nd, 2, P(None, "model"))),
    (r"mamba/out_proj/w$", lambda nd: _stk(nd, 2, P("model", None))),
    (r"mamba/(conv_w|conv_b|x_proj/w|dt_proj/w|dt_proj/b|A_log|D)",
     lambda nd: None),  # replicate small SSM innards
    # rwkv6
    (r"tm/w[rkvg]/w$", lambda nd: _stk(nd, 2, P(None, "model"))),
    (r"tm/wo/w$", lambda nd: _stk(nd, 2, P("model", None))),
    (r"cm/wk/w$", lambda nd: _stk(nd, 2, P(None, "model"))),
    (r"cm/wv/w$", lambda nd: _stk(nd, 2, P("model", None))),
    (r"cm/wr/w$", lambda nd: _stk(nd, 2, P(None, None))),
]


def _gated_or_flat_in(nd: int, shape=None):
    # rank 2 = ungated (D, F); rank 3 = gated (D, F, 2) OR stacked
    # ungated (L, D, F), told apart by the trailing dim of 2;
    # rank 4 = stacked gated (L, D, F, 2).
    if nd == 2:
        return P(None, "model")
    if nd == 3:
        if shape is not None and shape[-1] == 2:
            return P(None, "model", None)      # gated (D, F, 2)
        return P(None, None, "model")          # stacked ungated (L, D, F)
    if nd == 4:
        return P(None, None, "model", None)
    return None


def _stk(nd: int, base: int, spec: P):
    """Prepend None for a stacked scan axis when leaf rank = base+1."""
    if nd == base:
        return spec
    if nd == base + 1:
        return P(None, *spec)
    return None


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(n) for n in (leaf.shape if hasattr(leaf, "shape")
                                  else leaf))


def leaf_spec(path: str, ndim: int, shape=None, fsdp: bool = False) -> P:
    rules = (_FSDP_RULES + _RULES) if fsdp else _RULES
    for pat, fn in rules:
        if re.search(pat, path):
            try:
                s = fn(ndim, shape)
            except TypeError:
                s = fn(ndim)
            if s is not None:
                return s
            break
    return P()  # replicate


def spec_tree(params: Dict[str, Any], fsdp: bool = False,
              use_tp: bool = True) -> Dict[str, P]:
    """Spec of every leaf of a flat ``path -> leaf`` dict."""
    if not use_tp:   # small models: replicate weights, pure DP
        return {path: P() for path in params}
    return {path: leaf_spec(path, len(_shape(l)), _shape(l), fsdp)
            for path, l in params.items()}


def fit_spec(shape, spec: P, mesh) -> P:
    """Drop sharded axes that do not evenly divide their dim (replicate
    instead) -- e.g. odd vocab sizes like granite's 49155."""
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    fixed = []
    for d, entry in enumerate(spec):
        if entry is None:
            fixed.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        keep, prod = [], 1
        for ax in axes:
            if ax not in names:
                continue
            sz = sizes[ax]
            if shape[d] % (prod * sz) == 0:
                keep.append(ax)
                prod *= sz
        fixed.append(tuple(keep) if len(keep) > 1 else
                     (keep[0] if keep else None))
    return P(*fixed)


def fit_specs(tree: Dict[str, Any], specs: Dict[str, P], mesh
              ) -> Dict[str, P]:
    return {k: fit_spec(_shape(tree[k]), specs[k], mesh) for k in tree}


# ---------------------------------------------------------------------------
# batch / cache shardings (shape- and mesh-aware: axes that do not divide
# a dim are dropped rather than producing an invalid sharding)


def _fit(mesh, dim: int, *names):
    """Largest prefix of ``names`` whose product divides ``dim``."""
    have, sizes = axis_names(mesh), axis_sizes(mesh)
    chosen = []
    prod = 1
    for n in names:
        if n is None or n not in have:
            continue
        sz = sizes[n]
        if dim % (prod * sz) == 0:
            chosen.append(n)
            prod *= sz
    if not chosen:
        return None
    return tuple(chosen) if len(chosen) > 1 else chosen[0]


def batch_spec(batch_like: Dict[str, Any], mesh, data_axes=("data",)
               ) -> Dict[str, P]:
    """Shard the leading (batch) dim of every batch leaf over data axes."""
    def spec(l):
        shape = _shape(l)
        if len(shape) == 0:
            return P()
        return P(_fit(mesh, shape[0], *data_axes),
                 *(None,) * (len(shape) - 1))
    return {k: spec(v) for k, v in batch_like.items()}


# cache leaf name -> (batch_dim, seq_dim, model_dim). KV caches shard
# *sequence* over the model axis (sequence-parallel cache: kv_heads are
# too few to shard 16-way and the cache dominates decode memory).
_CACHE_LAYOUTS = {
    # Every unified StateCache leaf is (n_layers, B, ...) -- batch always
    # dim 1 (models/runtime).
    "k": (1, 2, None), "v": (1, 2, None),
    "xk": (1, None, None), "xv": (1, None, None),
    "conv": (1, None, None),          # (nb, B, w, di)
    "ssm": (1, None, 2),              # (nb, B, di, n): di over model
    "state": (1, 2, None),            # (L, B, H, hd, hd): H over model
    "x_prev": (1, None, None),        # rwkv token-shift buffers
    # paged KV pools (L, n_pages, page_size, KV, hd): no batch axis --
    # slots address the shared pool through a page table, so shard the
    # page axis the way dense K/V shards its sequence axis
    "k_pages": (None, 1, None), "v_pages": (None, 1, None),
}


def _cache_leaf_spec(name: str, shape, mesh) -> P:
    bd, sd, md = _CACHE_LAYOUTS.get(name, (None, None, None))
    nd = len(shape)
    spec = [None] * nd
    if bd is not None and bd < nd:
        spec[bd] = _fit(mesh, shape[bd], "data")
    if sd is not None and sd < nd:
        # sequence (or page/head) axis over model; spill onto data when
        # no batch axis is using it (long-context batch=1 decode, or a
        # pool leaf with no batch axis at all)
        if bd is None or spec[bd] is None:
            spec[sd] = _fit(mesh, shape[sd], "model", "data")
        else:
            spec[sd] = _fit(mesh, shape[sd], "model")
    if md is not None and md < nd:
        spec[md] = _fit(mesh, shape[md], "model")
    return P(*spec)


def cache_spec(cache_like, mesh):
    """Spec of every leaf of a (nested) cache dict, keyed by its name."""
    return {k: cache_spec(v, mesh) if isinstance(v, dict)
            else _cache_leaf_spec(k, _shape(v), mesh)
            for k, v in cache_like.items()}


# ---------------------------------------------------------------------------
# DTensor placements and the ambient mesh


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of a (fitted) spec: ``Shard(d)`` on each mesh
    dim that splits tensor dim d, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for ax in axis_names(mesh):
        dim = None
        for d, entry in enumerate(spec):
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            if ax in axes:
                dim = d
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def param_specs(params: Dict[str, Any], mesh, fsdp: bool = False,
                use_tp: bool = True) -> Dict[str, P]:
    """Fitted spec of every leaf: ``fit_specs(spec_tree(...))``."""
    return fit_specs(params, spec_tree(params, fsdp=fsdp, use_tp=use_tp),
                     mesh)


def sharding_tree(params: Dict[str, Any], mesh, fsdp: bool = False,
                  use_tp: bool = True) -> Dict[str, tuple]:
    """DTensor placements of every leaf on ``mesh`` (a ``DeviceMesh``)."""
    return {k: placements(s, mesh) for k, s in
            param_specs(params, mesh, fsdp, use_tp).items()}


def shard_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """Per-device shape of a leaf of ``shape`` under a fitted spec."""
    sizes = axis_sizes(mesh)
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        div = 1
        for ax in axes:
            div *= sizes[ax]
        out.append(int(n) // div)
    return tuple(out)


def distribute(t: torch.Tensor, mesh, spec: P):
    """``t`` as a DTensor on ``mesh`` by a fitted spec. Every rank is
    expected to hold the same full ``t``: each keeps its own block, with
    no communication. A DTensor on another mesh or layout is gathered
    first."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    if isinstance(t, DTensor):
        t = t.redistribute(t.device_mesh,
                           [Replicate()] * t.device_mesh.ndim).to_local()
    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)


def distribute_tree(params: Dict[str, torch.Tensor], mesh,
                    fsdp: bool = False, use_tp: bool = True,
                    specs: Optional[Dict[str, P]] = None
                    ) -> Dict[str, Any]:
    """Every leaf of a flat dict as a DTensor by the plan (non-floating
    leaves too: they are replicated or sharded like any other)."""
    specs = specs or param_specs(params, mesh, fsdp, use_tp)
    return {k: distribute(v, mesh, specs[k]) for k, v in params.items()}


_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the ambient mesh of the block, as
    ``jax.set_mesh`` does; model code reads it through :func:`ambient`.
    The block also runs under DTensor's ``implicit_replication``, so plain
    tensors the model code makes itself (masks, positions) count as
    replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    tok = _MESH.set(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _MESH.reset(tok)


def ambient():
    """The ambient ``DeviceMesh``, or None."""
    return _MESH.get()


def maybe_shard(x, *spec):
    """Redistribute ``x`` to ``spec`` (fitted: axes that do not divide a
    dim are dropped) iff an ambient mesh with the named axes is set and
    ``x`` is a DTensor on it. A no-op in mesh-less runs, so model code
    can annotate activations unconditionally."""
    mesh = ambient()
    if mesh is None or not is_dtensor(x):
        return x
    names = set(axis_names(mesh))
    for entry in spec:
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        if any(a not in names for a in axes):
            return x
    return x.redistribute(mesh, placements(
        fit_spec(tuple(x.shape), P(*spec), mesh), mesh))


def split_heads(t, n_heads: int, head_dim: int):
    """(..., n_heads * head_dim) -> (..., n_heads, head_dim). A DTensor
    sharded on its last dim keeps the sharding on the head axis where the
    mesh splits whole heads; where it does not (8 KV heads over a model
    axis of 16), the last dim is gathered first, as GSPMD reshards such a
    reshape."""
    shape = tuple(t.shape[:-1]) + (n_heads, head_dim)
    if not is_dtensor(t):
        return t.reshape(shape)
    from torch.distributed.tensor import Replicate, Shard
    last = t.dim() - 1
    sizes = axis_sizes(t.device_mesh)
    names = axis_names(t.device_mesh)
    div = 1
    for n, p in zip(names, t.placements):
        if isinstance(p, Shard) and p.dim % t.dim() == last:
            div *= sizes[n]
    if div > 1 and n_heads % div:
        t = t.redistribute(t.device_mesh, [
            Replicate() if isinstance(p, Shard) and p.dim % t.dim() == last
            else p for p in t.placements])
    return t.reshape(shape)


def merge_heads(t):
    """(..., H, hd) -> (..., H * hd), :func:`split_heads`' inverse. A
    DTensor whose head axis no mesh dim splits (the heads were gathered)
    is reshaped on its local block and wrapped back with its placements,
    so that in the backward pass the gradient a row-parallel projection
    returns sharded on the flat dim is gathered to those placements before
    it is unflattened -- DTensor cannot unflatten a dim that the mesh does
    not split into whole heads."""
    shape = tuple(t.shape[:-2]) + (t.shape[-2] * t.shape[-1],)
    if not is_dtensor(t):
        return t.reshape(shape)
    from torch.distributed.tensor import DTensor, Shard
    heads = t.dim() - 2
    if any(isinstance(p, Shard) and p.dim % t.dim() >= heads
           for p in t.placements):
        return t.reshape(shape)
    local = t.to_local()
    return DTensor.from_local(local.reshape(*local.shape[:-2], -1),
                              t.device_mesh, t.placements,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def local_heads(fn, q, k, v, *rest):
    """``fn(q, k, v, *rest)`` of an attention over (B, S, H, hd) queries
    and (B, T, KV, hd) keys/values, any of them DTensors, computed on this
    rank's heads: q keeps its placements (batch and head sharding); k and
    v are gathered on the mesh dims that shard q's heads unless they split
    their KV heads in the same groups, and each local query head meets
    its own KV head. ``rest`` (masks) is taken on the batch placement.
    Returns a DTensor placed as q."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    names = axis_names(mesh)
    h, kvh = q.shape[2], k.shape[2]
    g = h // kvh

    def as_dt(t):
        if is_dtensor(t):
            return settle(t)
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim)

    q, k, v = as_dt(q), as_dt(k), as_dt(v)
    head_dims = [i for i, p in enumerate(q.placements)
                 if isinstance(p, Shard) and p.dim == 2]
    aligned = all(isinstance(k.placements[i], Shard)
                  and k.placements[i].dim == 2 for i in head_dims)
    kv_pl = []
    for i, (qp, kp) in enumerate(zip(q.placements, k.placements)):
        if i in head_dims:
            kv_pl.append(kp if aligned else Replicate())
        elif isinstance(qp, Shard) and qp.dim == 0:
            kv_pl.append(qp)
        else:
            kv_pl.append(Replicate())
    k, v = k.redistribute(mesh, kv_pl), v.redistribute(mesh, kv_pl)
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    if head_dims and not aligned:
        h0 = local_offsets(q)[2]
        sel = torch.div(torch.arange(h0, h0 + ql.shape[2],
                                     device=kl.device), g,
                        rounding_mode="floor")
        kl, vl = kl[:, :, sel], vl[:, :, sel]
    b0, bl = local_offsets(q)[0], ql.shape[0]

    def local_rest(t):
        if t is None:
            return None
        if is_dtensor(t):
            return t.redistribute(mesh, [
                p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in t.placements]).to_local()
        return t[b0:b0 + bl] if t.shape[0] == q.shape[0] else t

    out = fn(ql, kl.contiguous(), vl.contiguous(),
             *[local_rest(t) for t in rest]).contiguous()
    return DTensor.from_local(out, mesh, q.placements, shape=q.shape,
                              stride=contiguous_stride(q.shape))


def gather_last(x, idx):
    """``torch.gather(x, -1, idx[..., None])[..., 0]`` for a DTensor ``x``
    (the logits) whose last dim may be sharded (the vocab): each rank
    reads the indices in its block of the last dim, zero elsewhere, and
    the result is ``Partial()`` over that mesh dim -- the vocab-parallel
    cross entropy's gold logit, with no gather of the logits. ``idx``
    (a DTensor or a plain tensor) is placed as ``x`` is on the leading
    dims."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    last = x.dim() - 1
    il = (idx._local_tensor if is_dtensor(idx) else idx).long()
    xl = x._local_tensor
    v0 = local_offsets(x)[last]
    pl = []
    for p in x.placements:
        if isinstance(p, Shard) and p.dim % x.dim() == last:
            pl.append(Partial())
        elif isinstance(p, (Shard, Replicate)):
            pl.append(p)
        else:
            raise ValueError(f"gather_last: no local form for {x.placements}")
    mine = (il >= v0) & (il < v0 + xl.shape[-1])
    got = torch.gather(xl, -1, torch.where(mine, il - v0, 0)[..., None])
    got = torch.where(mine, got[..., 0], torch.zeros((), dtype=xl.dtype))
    shape = tuple(x.shape[:-1])
    return DTensor.from_local(got.contiguous(), x.device_mesh, pl,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))
