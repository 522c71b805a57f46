"""Plain float32 forward and loss of the two model families the benchmark
runs: the decoder-only LM (OPT) and the encoder classifier (RoBERTa).

The architecture is the one the configuration file's ``model`` block
states, as the port defines it: pre-LayerNorm residual blocks ``x = x +
attn(ln(x))``, ``x = x + mlp(ln(x))`` with biases on every projection,
learned positions ``0..S-1``, a final LayerNorm, then the LM head (the
token embedding's transpose where ``tie_embeddings`` holds, else a leaf
of its own, no bias) and next-token cross entropy, or ``tanh`` of the
first token's state through a ``(d, n_classes)`` head and its cross
entropy.
Attention is softmax attention with scale ``1/sqrt(hd)`` and ``-1e30``
masking; the encoder's is bidirectional.

Every parameter is held as the configuration stores it (bf16 or f32)
and every sum runs in f32 with TF32 off. A perturbed forward evaluates
the network at ``theta + c * z(seed)``: each leaf is upcast to f32 and
its z added in f32 where it is used, one layer at a time, so nothing of
the size of the parameters is ever materialized.

``precision`` names a lower-precision control of the same arithmetic:
``"fp8"`` rounds both operands of every matrix product, and every
activation the configuration holds in its 16-bit dtype (the embedding,
each norm's and projection's output, the residual stream, the logits),
to float8 e4m3 with one scale a tensor; ``"tf32"`` rounds only the products' operands, to TF32's
10-bit mantissa (an f32 configuration keeps f32 activations); ``"f32"``
is the reference itself.
``half_batch`` is a planted fault: the loss averages only the first half
of the batch rows.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from perfbench.reference import zhash

F32 = torch.float32
NEG_INF = -1e30


def storage_dtype(model: dict) -> torch.dtype:
    return torch.bfloat16 if model["dtype"] == "bfloat16" else F32


def param_spec(model: dict) -> Dict[str, tuple]:
    """``path -> (shape, dtype, init)``: ``("normal", std)``, ``"ones"``
    or ``"zeros"``; the layout and init scales of the port's tree."""
    d, f, v = model["d_model"], model["d_ff"], model["vocab"]
    n_l, h = model["n_layers"], model["n_heads"]
    hd = d // h
    dt = storage_dtype(model)
    out_std = 0.02 / math.sqrt(n_l)
    spec: Dict[str, tuple] = {}
    spec["embed/tok"] = ((v, d), dt, ("normal", 0.02))
    spec["embed/pos"] = ((model["max_seq"], d), dt, ("normal", 0.02))

    def norm(prefix, lead):
        spec[f"{prefix}/scale"] = (lead + (d,), F32, "ones")
        spec[f"{prefix}/bias"] = (lead + (d,), F32, "zeros")

    def proj(prefix, d_in, d_out, lead, std=0.02, bias=True, dtype=dt):
        spec[f"{prefix}/w"] = (lead + (d_in, d_out), dtype, ("normal", std))
        if bias:
            spec[f"{prefix}/b"] = (lead + (d_out,), dtype, "zeros")

    lead = (n_l,)
    norm("blocks/ln_attn", lead)
    for name in ("wq", "wk", "wv"):
        proj(f"blocks/attn/{name}", d, h * hd, lead)
    proj("blocks/attn/wo", h * hd, d, lead, std=out_std)
    norm("blocks/ln_ffn", lead)
    proj("blocks/mlp/w_in", d, f, lead)
    proj("blocks/mlp/w_out", f, d, lead, std=out_std)
    norm("ln_f", ())
    if not model.get("tie_embeddings"):
        proj("lm_head", d, v, (), bias=False)
    if model.get("n_classes"):
        proj("cls_head", d, model["n_classes"], (), dtype=F32)
    return spec


def make_params(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights both sides get: one generator on ``device`` seeded
    with ``seed``, one draw a (stacked) leaf, in the stored dtype."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for path, (shape, dt, init) in param_spec(model).items():
        t = torch.empty(shape, dtype=dt, device=device)
        if init == "ones":
            t.fill_(1.0)
        elif init == "zeros":
            t.zero_()
        else:
            t.normal_(0.0, init[1], generator=gen)
        out[path] = t
    return out


# ---------------------------------------------------------------------------
# lower-precision operands (the controls)


def _round_mantissa(x: torch.Tensor, keep: int) -> torch.Tensor:
    """f32 rounded to nearest even at ``keep`` explicit mantissa bits."""
    drop = 23 - keep
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    half = 1 << (drop - 1)
    lsb = (bits >> drop) & 1
    bits = ((bits + half - 1 + lsb) >> drop) << drop
    return bits.to(torch.int32).view(F32)


def lower(x: torch.Tensor, precision: str) -> torch.Tensor:
    """An f32 matmul operand as the control's precision holds it."""
    if precision == "f32":
        return x
    if precision == "tf32":
        return _round_mantissa(x, 10)
    if precision == "fp8":
        amax = x.abs().amax().clamp(min=1e-30)
        scale = 448.0 / amax
        return (x * scale).to(torch.float8_e4m3fn).to(F32) / scale
    raise ValueError(f"unknown precision {precision!r}")


class Perturbed:
    """``theta + c * z(seed)`` read one leaf (or one layer of a stacked
    leaf) at a time, in f32; ``seed`` None reads ``theta`` itself."""

    def __init__(self, params, seed: Optional[int], coeff: float):
        self.params, self.seed = params, seed
        self.coeff = float(torch.tensor(coeff, dtype=F32))

    def leaf(self, path: str, layer=None) -> torch.Tensor:
        p = self.params[path]
        w = (p if layer is None else p[layer]).to(F32)
        if self.seed is None:
            return w
        z = zhash.leaf_z(self.seed, path, w.shape, w.device, layer)
        return w + self.coeff * z

    def rows(self, path: str, ids: torch.Tensor) -> torch.Tensor:
        p = self.params[path]
        w = p[ids].to(F32)
        if self.seed is None:
            return w
        z = zhash.leaf_z(self.seed, path, p.shape, w.device, rows=ids)
        return w + self.coeff * z


def _mm(x, w, precision):
    return lower(x, precision) @ lower(w, precision)


def _act(x, precision):
    """An activation as a control that replaces the 16-bit activation
    dtype holds it (unchanged for the reference and for TF32)."""
    return lower(x, precision) if precision == "fp8" else x


def _layernorm(x, scale, bias, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    d = x - mu
    var = (d * d).mean(-1, keepdim=True)
    return d * torch.rsqrt(var + eps) * scale + bias


def _attention(q, k, v, causal: bool, precision: str):
    """q, k, v (B, S, H, hd) f32."""
    b, s, h, hd = q.shape
    scale = float(torch.tensor(1.0 / math.sqrt(hd), dtype=F32))
    qh = q.permute(0, 2, 1, 3) * scale
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    scores = _mm(qh, kh.transpose(-1, -2), precision)
    if causal:
        live = torch.ones((s, s), dtype=torch.bool,
                          device=q.device).tril()
        scores = scores.masked_fill(~live, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = _mm(probs, vh, precision)
    return out.permute(0, 2, 1, 3).reshape(b, s, h * hd)


def _dense(pp: Perturbed, prefix, x, layer, precision, bias=True):
    y = _mm(x, pp.leaf(f"{prefix}/w", layer), precision)
    if bias:
        y = y + pp.leaf(f"{prefix}/b", layer)
    return _act(y, precision)


def loss(model: dict, params, batch, seed: Optional[int] = None,
         coeff: float = 0.0, precision: str = "f32",
         half_batch: bool = False) -> float:
    """The training objective at ``theta + coeff * z(seed)`` as a Python
    float: mean next-token CE (LM) or the CLS head's CE (classifier)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            return _loss(model, params, batch, seed, coeff, precision,
                         half_batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _loss(model, params, batch, seed, coeff, precision, half_batch):
    pp = Perturbed(params, seed, coeff)
    tokens = batch["tokens"]
    if half_batch:
        batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        tokens = batch["tokens"]
    b, s = tokens.shape
    d, h = model["d_model"], model["n_heads"]
    hd = d // h
    causal = model.get("causal", True)
    pos = torch.arange(s, device=tokens.device)

    def act(t):
        return _act(t, precision)
    x = act(act(pp.rows("embed/tok", tokens))
            + act(pp.rows("embed/pos", pos))[None])
    gelu = model["act"] == "gelu"
    for li in range(model["n_layers"]):
        hn = act(_layernorm(x, pp.leaf("blocks/ln_attn/scale", li),
                            pp.leaf("blocks/ln_attn/bias", li)))
        q, k, v = (_dense(pp, f"blocks/attn/{n}", hn, li, precision)
                   .reshape(b, s, h, hd) for n in ("wq", "wk", "wv"))
        a = act(_attention(q, k, v, causal, precision))
        x = act(x + _dense(pp, "blocks/attn/wo", a, li, precision))
        hn = act(_layernorm(x, pp.leaf("blocks/ln_ffn/scale", li),
                            pp.leaf("blocks/ln_ffn/bias", li)))
        u = _dense(pp, "blocks/mlp/w_in", hn, li, precision)
        u = act(F.gelu(u, approximate="tanh") if gelu else torch.relu(u))
        x = act(x + _dense(pp, "blocks/mlp/w_out", u, li, precision))
    x = act(_layernorm(x, pp.leaf("ln_f/scale"), pp.leaf("ln_f/bias")))
    if model.get("n_classes"):
        logits = _dense(pp, "cls_head", torch.tanh(x[:, 0]), None,
                        precision)
        return float(F.cross_entropy(logits, batch["label"].long()))
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    w = (pp.leaf("embed/tok").T if model.get("tie_embeddings")
         else pp.leaf("lm_head/w"))
    for r in range(b):                  # one row of logits at a time
        logits = _act(_mm(x[r], w, precision), precision)
        nll = F.cross_entropy(logits, batch["targets"][r].long(),
                              reduction="none")
        total += (nll * batch["loss_mask"][r].to(F32)).sum().double()
    return float(total / batch["loss_mask"].to(F32).sum().double())
