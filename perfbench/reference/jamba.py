"""Plain float32 forward, loss and MeZO-SGD steps of the Jamba
architecture (AI21-Jamba2-Mini: Jamba 1.5 Mini's shapes), written from
its published description and the configuration file's ``model`` block.

The network: the token embedding (no positions), then
``n_layers / block_len`` periods of ``block_len`` layers, layer ``i`` of
a period ``x = x + mixer(rmsnorm(x))``, ``x = x + ffn(rmsnorm(x))``;
the mixer is GQA causal attention (no positional encoding, no biases)
at ``attn_index`` and a Mamba-1 mixer elsewhere; the FFN is a mixture of
experts on odd layers and a dense SwiGLU elsewhere; then a final RMSNorm
(eps 1e-6 throughout) and the untied LM head.

* Mamba-1 (Jamba's mixer): ``x, z = in_proj(h)``, a depthwise causal
  conv of width ``d_conv`` with bias, ``silu``; ``x_proj`` to
  (dt, B, C) of widths (d_model / 16, n, n), each RMS-normalized with a
  scale of its own; ``delta = softplus(dt @ dt_proj + b)``, ``A =
  -exp(A_log)``; the recurrence ``h_t = exp(delta_t A) h_{t-1} + delta_t
  x_t B_t`` in time order, ``y_t = C_t . h_t + D x_t``, gated by
  ``silu(z)``, then ``out_proj``.
* The MoE: router logits in f32, a softmax over the experts, the top-k
  probabilities kept as they are (``moe_renorm`` False) and every routed
  token computed (dropless); SwiGLU experts ``(u * silu(g)) @ w_out``
  with ``[u, g] = x @ w_in``. The objective adds ``0.01 x`` the Switch
  load-balancing term ``E * mean(mean_t(probs) * share of first choices)``
  summed over the MoE layers, as the port's does (the source's objective
  is cross entropy alone: a departure the configuration file lists).

Every parameter is held as the configuration stores it (bf16) and every
sum runs in f32 with TF32 off. A perturbed forward takes
``theta + c * z(seed)`` for each of a few coefficients at once (the two
signs of a MeZO step): each leaf is upcast to f32 one layer, one expert
or one block of rows at a time, its z drawn once for every coefficient
with the frozen ``zhash.py``, and the activations carry the coefficients
on a leading axis. Nothing of the size of the parameters is made: the
steps update the weights in place, a block of rows at a time, and the
change norms draw the initial weights again from the seed.

``precision`` and ``half_batch`` are ``model.py``'s controls and fault.
``routes`` (per coefficient, the program's (T, k) expert ids of each MoE
layer in order) settles near ties. The program routes from bf16
activations, the reference from f32 ones, and where two experts' router
logits lie closer than that rounding can move them the two may rank them
apart. So a token takes the program's experts, at the reference's own
gates, where each of its top-k choices is within :data:`TIE_ROUNDING` of
the reference's choice in that place: ``own_j - got_j <= u * sum_i
|x_i| |w_i,own_j - w_i,got_j|``, the most that rounding the router's
input to bf16 (unit roundoff ``u``) moves the difference of the two
logits. Elsewhere it keeps its own. The assignments so taken are counted
(``taken``: a departure the configuration file lists), and those the
reference still routes elsewhere (``flips``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from perfbench.reference import zhash
from perfbench.reference.model import _attention, _mm, lower, storage_dtype

F32 = torch.float32
NORM_EPS = 1e-6
AUX_LOSS_WEIGHT = 0.01
CHUNK = 1 << 25            # elements of a leaf taken at a time
SCAN_BLOCK = 128           # time steps whose decays are formed at once
TIE_ROUNDING = 2.0 ** -8   # bf16's unit roundoff, for near ties in routing


def _dims(model: dict):
    d = model["d_model"]
    di = model["mamba_expand"] * d
    return d, di, max(1, d // 16), model["mamba_d_state"]


def _ffn_kind(model: dict, i: int) -> str:
    return "moe" if model.get("n_experts") and i % 2 == 1 else "mlp"


def param_spec(model: dict) -> Dict[str, tuple]:
    """``path -> (shape, dtype, init)``: ``("normal", std)``, ``"ones"``,
    ``"zeros"`` or ``"a_log"`` (rows ``log(1..n)``); the port's tree and
    init scales for the hybrid family."""
    d, di, dtr, n = _dims(model)
    h, kv = model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or d // h
    f, e = model["d_ff"], model.get("n_experts", 0)
    fe = model.get("expert_dff") or f
    dt = storage_dtype(model)
    out_std = 0.02 / math.sqrt(model["n_layers"])
    lead = (model["n_layers"] // model["block_len"],)
    spec: Dict[str, tuple] = {"embed/tok": ((model["vocab"], d), dt,
                                            ("normal", 0.02))}

    def leaf(path, shape, dtype=dt, init=("normal", 0.02)):
        spec[path] = (lead + tuple(shape), dtype, init)

    for i in range(model["block_len"]):
        pre = f"blocks/sub_{i}"
        leaf(f"{pre}/ln/scale", (d,), F32, "ones")
        if i == model["attn_index"]:
            for name, width in (("wq", h), ("wk", kv), ("wv", kv)):
                leaf(f"{pre}/attn/{name}/w", (d, width * hd))
            leaf(f"{pre}/attn/wo/w", (h * hd, d), init=("normal", out_std))
        else:
            m = f"{pre}/mamba"
            leaf(f"{m}/in_proj/w", (d, 2 * di))
            leaf(f"{m}/conv_w", (model["mamba_d_conv"], di),
                 init=("normal", 0.1))
            leaf(f"{m}/conv_b", (di,), init="zeros")
            leaf(f"{m}/x_proj/w", (di, dtr + 2 * n))
            if model.get("mamba_inner_norm"):
                for name, width in (("dt_norm", dtr), ("b_norm", n),
                                    ("c_norm", n)):
                    leaf(f"{m}/{name}/scale", (width,), F32, "ones")
            leaf(f"{m}/dt_proj/w", (dtr, di))
            leaf(f"{m}/dt_proj/b", (di,), init="zeros")
            leaf(f"{m}/A_log", (di, n), F32, "a_log")
            leaf(f"{m}/D", (di,), F32, "ones")
            leaf(f"{m}/out_proj/w", (di, d), init=("normal", out_std))
        leaf(f"{pre}/ln_ffn/scale", (d,), F32, "ones")
        if _ffn_kind(model, i) == "moe":
            leaf(f"{pre}/moe/router", (d, e), F32)
            leaf(f"{pre}/moe/w_in", (e, d, fe, 2))
            leaf(f"{pre}/moe/w_out", (e, fe, d), init=("normal", out_std))
        else:
            leaf(f"{pre}/mlp/w_in/w", (d, f, 2))
            leaf(f"{pre}/mlp/w_out/w", (f, d), init=("normal", out_std))
    spec["ln_f/scale"] = ((d,), F32, "ones")
    spec["lm_head/w"] = ((d, model["vocab"]), dt, ("normal", 0.02))
    return spec


def iter_params(model: dict, seed: int, device):
    """``(path, leaf)`` in the tree's order, drawn as :func:`make_params`
    draws them (one generator on ``device`` seeded with ``seed``, one draw
    a stacked leaf, in the stored dtype)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for path, (shape, dt, init) in param_spec(model).items():
        t = torch.empty(shape, dtype=dt, device=device)
        if init == "ones":
            t.fill_(1.0)
        elif init == "zeros":
            t.zero_()
        elif init == "a_log":
            t.copy_(torch.log(torch.arange(1, shape[-1] + 1, dtype=F32,
                                           device=device)))
        else:
            t.normal_(0.0, init[1], generator=gen)
        yield path, t


def make_params(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights both sides get."""
    return dict(iter_params(model, seed, device))


# ---------------------------------------------------------------------------
# a leaf a piece at a time


def _pieces(path: str, shape):
    """``(layer, r0, r1)``: rows ``r0:r1`` of each layer of a stacked
    ``blocks/`` leaf (layer None: of the leaf), at most :data:`CHUNK`
    elements a piece."""
    layers = range(shape[0]) if path.startswith("blocks/") else [None]
    inner = shape[1:] if path.startswith("blocks/") else shape
    step = max(1, CHUNK // max(1, math.prod(inner[1:])))
    for li in layers:
        for r0 in range(0, inner[0], step):
            yield li, r0, min(r0 + step, inner[0])


def _piece(t, li, r0, r1):
    return (t if li is None else t[li])[r0:r1]


def _piece_z(seed, path, t, li, r0, r1):
    shape = t.shape if li is None else t.shape[1:]
    return zhash.leaf_z(seed, path, shape, t.device, li,
                        rows=torch.arange(r0, r1, device=t.device))


def sgd_update(params, seed: int, coeff: float) -> None:
    """``theta += coeff * z(seed)`` on every leaf, in place, in f32 and
    rounded to the leaf's dtype."""
    for path, t in params.items():
        for li, r0, r1 in _pieces(path, t.shape):
            v = _piece(t, li, r0, r1)
            z = _piece_z(seed, path, t, li, r0, r1)
            v.copy_((v.to(F32) + coeff * z).to(v.dtype))


def change_norms(model: dict, weights_seed: int, params) -> Dict[str, float]:
    """Per leaf, the f32 norm of ``params`` less the weights ``seed``
    draws (drawn again, one leaf at a time)."""
    out = {}
    device = next(iter(params.values())).device
    for path, t0 in iter_params(model, weights_seed, device):
        t = params[path]
        acc = torch.zeros((), dtype=torch.float64, device=device)
        for li, r0, r1 in _pieces(path, t.shape):
            diff = (_piece(t, li, r0, r1).to(F32)
                    - _piece(t0, li, r0, r1).to(F32))
            acc += (diff * diff).sum().double()
        out[path] = float(acc) ** 0.5
        del t0
    return out


# ---------------------------------------------------------------------------
# the forward, for several coefficients at once


class Leaves:
    """``theta + c * z(seed)`` for each ``c`` of ``coeffs``, stacked on a
    leading axis, in f32; ``seed`` None reads ``theta`` (one entry)."""

    def __init__(self, params, seed: Optional[int], coeffs):
        self.params, self.seed = params, seed
        self.coeffs = [float(torch.tensor(c, dtype=F32)) for c in coeffs]

    def get(self, path: str, layer=None, rows=None) -> torch.Tensor:
        p = self.params[path]
        p = p if layer is None else p[layer]
        w = (p if rows is None else p[rows]).to(F32)
        if self.seed is None:
            return w[None]
        z = zhash.leaf_z(self.seed, path, p.shape, w.device, layer, rows)
        return torch.stack([w + c * z for c in self.coeffs])


def _act(x, precision):
    return lower(x, precision) if precision == "fp8" else x


def _bcast(v, x):
    """A stacked leaf ``(nC, *leaf)`` shaped to broadcast against
    activations ``(nC, B, S, ..., *leaf)``."""
    return v.reshape(v.shape[0], *([1] * (x.dim() - v.dim())), *v.shape[1:])


def _rmsnorm(x, scale):
    var = (x * x).mean(-1, keepdim=True)
    return x * torch.rsqrt(var + NORM_EPS) * _bcast(scale, x)


def _dense(lv, path, x, layer, precision):
    """``x (nC, B, S, K) @ w (nC, K, N)``."""
    return _act(_mm(x, lv.get(path, layer)[:, None], precision), precision)


def _softplus(x):
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _attn(lv, pre, hn, li, model, precision):
    d, h, kv = model["d_model"], model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or d // h
    nc, b, s, _ = hn.shape
    q, k, v = (_dense(lv, f"{pre}/{n}/w", hn, li, precision)
               .reshape(nc, b, s, -1, hd) for n in ("wq", "wk", "wv"))
    k, v = (t.repeat_interleave(h // kv, dim=3) for t in (k, v))
    out = torch.stack([torch.cat([
        _attention(q[c, r:r + 1], k[c, r:r + 1], v[c, r:r + 1], True,
                   precision) for r in range(b)]) for c in range(nc)])
    return _dense(lv, f"{pre}/wo/w", _act(out, precision), li, precision)


def _scan(x, delta, a, bmat, cmat, d, z, h0=None):
    """The time-ordered recurrence over rows R = nC * B: x, delta, z
    (R, S, di); a (R, di, n); B, C (R, S, n); d (R, di); from ``h0`` (R,
    di, n) or zeros; the decays and inputs of :data:`SCAN_BLOCK` steps
    formed at a time."""
    r, s, di = x.shape
    h = (torch.zeros((r, di, a.shape[-1]), dtype=F32, device=x.device)
         if h0 is None else h0)
    ys = []
    for t0 in range(0, s, SCAN_BLOCK):
        t1 = min(s, t0 + SCAN_BLOCK)
        da = torch.exp(delta[:, t0:t1, :, None] * a[:, None])
        dbx = ((delta[:, t0:t1] * x[:, t0:t1])[..., None]
               * bmat[:, t0:t1, None, :])
        hs = torch.empty_like(da)
        for j in range(t1 - t0):
            h = torch.addcmul(dbx[:, j], da[:, j], h, out=hs[:, j])
        ys.append(torch.einsum("rtdn,rtn->rtd", hs, cmat[:, t0:t1]))
        del da, dbx, hs
    y = torch.cat(ys, dim=1) + x * d[:, None]
    return y * F.silu(z)


def _mamba(lv, pre, hn, li, model, precision):
    _, di, dtr, n = _dims(model)
    nc, b, s, _ = hn.shape
    act = lambda t: _act(t, precision)      # noqa: E731
    xi, z = _dense(lv, f"{pre}/in_proj/w", hn, li, precision).chunk(2, -1)
    conv_w = lv.get(f"{pre}/conv_w", li)                # (nC, d_conv, di)
    window = F.pad(xi, (0, 0, conv_w.shape[1] - 1, 0))
    conv = window[:, :, 0:s] * _bcast(conv_w[:, 0], xi)
    for i in range(1, conv_w.shape[1]):
        conv = conv + window[:, :, i:i + s] * _bcast(conv_w[:, i], xi)
    conv = act(conv + _bcast(lv.get(f"{pre}/conv_b", li), xi))
    xc = act(F.silu(conv))
    proj = _dense(lv, f"{pre}/x_proj/w", xc, li, precision)
    dt_raw, bmat, cmat = torch.split(proj, [dtr, n, n], dim=-1)
    if model.get("mamba_inner_norm"):
        dt_raw, bmat, cmat = (
            _rmsnorm(t, lv.get(f"{pre}/{name}/scale", li))
            for name, t in (("dt_norm", dt_raw), ("b_norm", bmat),
                            ("c_norm", cmat)))
    dt = _mm(dt_raw, lv.get(f"{pre}/dt_proj/w", li)[:, None], precision)
    delta = _softplus(dt + _bcast(lv.get(f"{pre}/dt_proj/b", li), dt))
    a = -torch.exp(lv.get(f"{pre}/A_log", li))          # (nC, di, n)

    def rows(t):                                        # (nC, B, ...) flat
        return t.reshape(nc * b, *t.shape[2:])

    def per_row(v):                                     # (nC, ...) -> rows
        return v.repeat_interleave(b, dim=0)
    y = _scan(rows(xc), rows(delta), per_row(a), rows(bmat), rows(cmat),
              per_row(lv.get(f"{pre}/D", li)), rows(z))
    return _dense(lv, f"{pre}/out_proj/w", act(y.reshape(nc, b, s, di)), li,
                  precision)


def _mlp(lv, pre, hn, li, precision):
    w_in = lv.get(f"{pre}/w_in/w", li)                  # (nC, d, f, 2)
    hh = _act(torch.einsum("cbsd,cdfg->cbsfg", lower(hn, precision),
                           lower(w_in, precision)), precision)
    u = _act(hh[..., 0] * F.silu(hh[..., 1]), precision)
    return _dense(lv, f"{pre}/w_out/w", u, li, precision)


def _ties(xf, router, logits, own, got):
    """Of one coefficient's tokens: ``own`` (T, k) the reference's top-k
    ids, ``got`` the program's. The ids routed (the program's on the
    tokens whose every choice is within rounding of the reference's, the
    module docstring's rule; the reference's elsewhere), the assignments
    taken from the program and those still routed apart."""
    e = router.shape[-1]
    pair = (router[:, :, None] - router[:, None, :]).abs().reshape(-1, e * e)
    tol = TIE_ROUNDING * (xf.abs() @ pair).gather(-1, own * e + got)
    gap = logits.gather(-1, own) - logits.gather(-1, got)
    take = (gap <= tol).all(-1, keepdim=True)
    idx = torch.where(take, got, own)

    def apart(ids):
        return int((~(got[:, :, None] == ids[:, None, :]).any(-1)).sum())
    return idx, apart(own) - apart(idx), apart(idx)


def _moe(lv, pre, hn, li, model, precision, routes, tally):
    """Dropless top-k MoE: (out (nC, B, S, d), aux (nC,))."""
    e, k = model["n_experts"], model["topk"]
    nc, b, s, d = hn.shape
    xf = hn.reshape(nc, b * s, d)
    router = lv.get(f"{pre}/router", li)                # (nC, d, E)
    logits = _mm(xf, router, precision)
    probs = torch.softmax(logits, dim=-1)               # (nC, T, E)
    idx = torch.topk(probs, k, dim=-1).indices
    if routes is not None:
        settled = []
        for c in range(nc):
            ids, taken, flips = _ties(xf[c], router[c], logits[c], idx[c],
                                      routes[c].pop(0).to(idx.device))
            settled.append(ids)
            tally["taken"][c] += taken
            tally["flips"][c] += flips
        idx = torch.stack(settled)
    gate = probs.gather(-1, idx)
    if model.get("moe_renorm", True):
        gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    density = F.one_hot(idx[..., 0], e).to(F32).mean(1)
    aux = e * (probs.mean(1) * density).mean(-1)
    out = torch.zeros_like(xf)
    for ex in range(e):
        rows = torch.tensor([ex], device=hn.device)
        w_in = lv.get(f"{pre}/w_in", li, rows)[:, 0]    # (nC, d, f, 2)
        w_out = lv.get(f"{pre}/w_out", li, rows)[:, 0]  # (nC, f, d)
        for c in range(nc):
            tok, slot = torch.nonzero(idx[c] == ex, as_tuple=True)
            if tok.numel() == 0:
                continue
            hh = _act(torch.einsum("td,dfg->tfg", lower(xf[c, tok], precision),
                                   lower(w_in[c], precision)), precision)
            u = _act(hh[..., 0] * F.silu(hh[..., 1]), precision)
            y = _act(_mm(u, w_out[c], precision), precision)
            out[c].index_add_(0, tok, y * gate[c, tok, slot, None])
        del w_in, w_out
    return _act(out.reshape(nc, b, s, d), precision), aux


def _head_ce(lv, x, batch, precision) -> torch.Tensor:
    """Mean next-token CE of each coefficient's rows: (nC,) f64; the head
    read a block of rows at a time."""
    p = lv.params["lm_head/w"]
    d, v = p.shape
    step = max(1, CHUNK // v)
    logits = torch.zeros(x.shape[:-1] + (v,), dtype=F32, device=x.device)
    for r0 in range(0, d, step):
        rows = torch.arange(r0, min(d, r0 + step), device=x.device)
        w = lv.get("lm_head/w", None, rows)             # (nC, rows, V)
        for c in range(x.shape[0]):
            logits[c] += _mm(x[c, ..., r0:r0 + rows.numel()], w[c],
                             precision)
        del w
    logits = _act(logits, precision)
    mask = batch["loss_mask"].to(F32)
    out = []
    for c in range(x.shape[0]):
        total = torch.zeros((), dtype=torch.float64, device=x.device)
        for r in range(x.shape[1]):
            nll = F.cross_entropy(logits[c, r], batch["targets"][r].long(),
                                  reduction="none")
            total += (nll * mask[r]).sum().double()
        out.append(total / mask.sum().double())
    return torch.stack(out)


def losses(model: dict, params, batch, seed: Optional[int] = None,
           coeffs=(0.0,), precision: str = "f32", half_batch: bool = False,
           routes: Optional[List[List[torch.Tensor]]] = None):
    """The objective at ``theta + c * z(seed)`` for each ``c`` (``seed``
    None: at theta, once): (a list of Python floats, and without
    ``routes`` None, else ``{"taken": [...], "flips": [...]}``, the
    assignments of each coefficient taken from the program at near ties
    and those still routed apart from it)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _losses(model, params, batch, seed, coeffs, precision,
                           half_batch, routes)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _losses(model, params, batch, seed, coeffs, precision, half_batch,
            routes):
    for key in ("act", "norm", "pos"):
        want = {"act": "swiglu", "norm": "rmsnorm", "pos": "none"}[key]
        if model[key] != want:
            raise ValueError(f"the Jamba reference has {key} {want!r}")
    if model.get("capacity_factor") is not None:
        raise ValueError("the Jamba reference routes dropless")
    lv = Leaves(params, seed, coeffs if seed is not None else (0.0,))
    if half_batch:
        batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
    routes = None if routes is None else [list(r) for r in routes]
    nc = len(lv.coeffs)
    tally = {"taken": [0] * nc, "flips": [0] * nc}
    x = _act(lv.get("embed/tok", None, batch["tokens"]), precision)
    aux = torch.zeros((nc,), dtype=F32, device=x.device)
    for li in range(model["n_layers"] // model["block_len"]):
        for i in range(model["block_len"]):
            pre = f"blocks/sub_{i}"
            hn = _act(_rmsnorm(x, lv.get(f"{pre}/ln/scale", li)), precision)
            if i == model["attn_index"]:
                y = _attn(lv, f"{pre}/attn", hn, li, model, precision)
            else:
                y = _mamba(lv, f"{pre}/mamba", hn, li, model, precision)
            x = _act(x + y, precision)
            hn = _act(_rmsnorm(x, lv.get(f"{pre}/ln_ffn/scale", li)),
                      precision)
            if _ffn_kind(model, i) == "moe":
                y, a = _moe(lv, f"{pre}/moe", hn, li, model, precision,
                            routes, tally)
                aux = aux + a
            else:
                y = _mlp(lv, f"{pre}/mlp", hn, li, precision)
            x = _act(x + y, precision)
    x = _act(_rmsnorm(x, lv.get("ln_f/scale")), precision)
    ce = _head_ce(lv, x, batch, precision)
    total = ce + AUX_LOSS_WEIGHT * aux.double()
    return [float(v) for v in total], (None if routes is None else tally)


# ---------------------------------------------------------------------------
# MeZO-SGD steps


def _f32(x) -> float:
    return float(torch.tensor(x, dtype=F32))


def follow(model: dict, mezo: dict, params, batches: List[dict],
           run_seed: int, weights_seed: int, precision: str = "f32",
           half_batch: bool = False, routes=None) -> dict:
    """``reference.train.follow`` for the fused estimator: steps on
    ``params`` (in place) from the weights ``weights_seed`` draws, both
    signs of a direction in one forward. ``routes[t][k]`` are the
    program's routes of step ``t``'s direction ``k`` (``+eps``, then
    ``-eps``). Returns the losses, gs, ``grad`` and ``change`` (the
    change norms after the first step over lr, and after the last) and,
    with ``routes``, ``taken`` and ``flips`` (:func:`losses`'s, per step
    and direction, of ``+eps`` and ``-eps``)."""
    eps, lr = _f32(mezo["eps"]), _f32(mezo["lr"])
    k_dirs = int(mezo.get("n_directions", 1))
    inv_k = _f32(1.0 / k_dirs)
    out = {"losses": [], "gs": [], "taken": [], "flips": []}
    for t, batch in enumerate(batches):
        gs_k, l_k = [], []
        for k in range(k_dirs):
            s = zhash.direction_seed(run_seed, t, k)
            (lp, lm), fl = losses(model, params, batch, s, (eps, -eps),
                                  precision, half_batch,
                                  None if routes is None else routes[t][k])
            gs_k.append(_f32((lp - lm) / (2.0 * eps)))
            l_k.append((lp + lm) / 2.0)
            if fl is not None:
                out["taken"].append(fl["taken"])
                out["flips"].append(fl["flips"])
        out["losses"].append(sum(l_k) / k_dirs)
        out["gs"].append(gs_k)
        for k in range(k_dirs):
            sgd_update(params, zhash.direction_seed(run_seed, t, k),
                       _f32(_f32(-lr * inv_k) * gs_k[k]))
        if t == 0:
            out["grad"] = {p: v / lr for p, v in change_norms(
                model, weights_seed, params).items()}
    out["change"] = change_norms(model, weights_seed, params)
    return out


def replay(model: dict, mezo: dict, params, gs: List[List[float]],
           run_seed: int, weights_seed: int) -> dict:
    """``reference.train.replay`` for the fused estimator: the update
    alone, driven by a side's gs, from the weights ``weights_seed``
    draws; returns ``grad`` and ``change``."""
    lr = _f32(mezo["lr"])
    inv_k = _f32(1.0 / int(mezo.get("n_directions", 1)))
    out = {}
    for t, gs_k in enumerate(gs):
        for k, g in enumerate(gs_k):
            sgd_update(params, zhash.direction_seed(run_seed, t, k),
                       _f32(_f32(-lr * inv_k) * _f32(g)))
        if t == 0:
            out["grad"] = {p: v / lr for p, v in change_norms(
                model, weights_seed, params).items()}
    out["change"] = change_norms(model, weights_seed, params)
    return out
