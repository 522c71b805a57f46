"""Operations and bytes a cell's work needs, counted from the shapes of
the configuration's leaves and the batch (not from what the program
launches), so that however the program does the work, the same work is
read.

Per forward of ``B x S`` tokens: every projection is a matrix product of
``M = B * S`` rows (the classifier head: ``B`` rows, at the first token
only), ``2 M K N`` operations; attention adds ``2 * 2 B H S^2 hd``,
halved when causal. A MeZO step is ``2 K`` forwards (K directions).
"""

from __future__ import annotations

from typing import List, Tuple

from perfbench.peaks import HBM_BYTES_PER_S, PEAK_FLOPS
from perfbench.reference.model import param_spec

_BYTES = {"bfloat16": 2, "float32": 4}


def projections(model: dict, b: int, s: int) -> List[Tuple[int, int, int]]:
    """(M, K, N) of every projection of one forward."""
    d, f, h = model["d_model"], model["d_ff"], model["n_heads"]
    hd = d // h
    m = b * s
    layer = [(m, d, h * hd)] * 3 + [(m, h * hd, d), (m, d, f), (m, f, d)]
    out = layer * model["n_layers"]
    if model.get("n_classes"):
        out.append((b, d, model["n_classes"]))
    else:
        out.append((m, d, model["vocab"]))
    return out


def attention_flops(model: dict, b: int, s: int) -> float:
    h, hd = model["n_heads"], model["d_model"] // model["n_heads"]
    full = 2.0 * 2.0 * b * h * s * s * hd * model["n_layers"]
    return full / 2.0 if model.get("causal", True) else full


def forward_flops(model: dict, b: int, s: int) -> float:
    return (sum(2.0 * m * k * n for m, k, n in projections(model, b, s))
            + attention_flops(model, b, s))


def step_flops(model: dict, mezo: dict, b: int, s: int) -> float:
    return 2.0 * int(mezo.get("n_directions", 1)) * forward_flops(model, b, s)


def peak_flops(model: dict) -> float:
    return PEAK_FLOPS[model["dtype"]]


def zo_matmul_bound_s(model: dict, mezo: dict, b: int, s: int,
                      lanes: int = 1, weights: int = 1) -> float:
    """Least device time of one forward's perturbed projections: per
    product max(operations / peak of its body, (X + W + Y bytes) / HBM).
    bf16 activations with Rademacher z run on the tensor cores, the
    rest on the FFMA body (the f32 peak). A user-axis forward runs
    ``lanes`` lanes of ``b x s`` tokens over ``weights`` distinct W. A
    tied LM head is no perturbed projection (the forward perturbs the
    embedding into a transient and multiplies by its transpose), so it
    is left out."""
    xb = _BYTES[model["dtype"]]
    tc = model["dtype"] == "bfloat16" and mezo["dist"] == "rademacher"
    peak = PEAK_FLOPS["bfloat16" if tc else "float32"]
    prods = projections(model, b, s)
    if model.get("tie_embeddings") and not model.get("n_classes"):
        prods = prods[:-1]
    total = 0.0
    for m, k, n in prods:
        wb = 4 if (model.get("n_classes") and n == model["n_classes"]) \
            else xb
        by = lanes * (m * k * xb + m * n * xb) + weights * k * n * wb
        total += max(2.0 * lanes * m * k * n / peak, by / HBM_BYTES_PER_S)
    return total


def _transient(model: dict, path: str) -> bool:
    """Whether a fused forward perturbs the leaf whole into a transient:
    the norm scales, the biases, and the embedding of a tied LM head
    (the classifier reads no LM head)."""
    return path.endswith(("/scale", "/bias", "/b")) or (
        path == "embed/tok" and bool(model.get("tie_embeddings"))
        and not model.get("n_classes"))


def leaf_bytes(model: dict, transient_only: bool = False) -> float:
    """Bytes of every leaf (``transient_only``: of the leaves a fused forward
    perturbs into transients)."""
    total = 0.0
    for path, (shape, dt, _) in param_spec(model).items():
        if transient_only and not _transient(model, path):
            continue
        n = 1
        for x in shape:
            n *= x
        total += n * (2 if str(dt).endswith("bfloat16") else 4)
    return total


def zo_add_bytes_per_step(model: dict, mezo: dict, estimator: str) -> float:
    """Bytes the ``zo_add`` sweeps of one step read and write (each leaf
    read once and written once a sweep): the fused step perturbs the
    transient leaves in each of its 2K forwards and sweeps every leaf once
    a direction to update; the walk sweeps every leaf three times a
    direction (+eps, -2eps, +eps) and once more to update."""
    k = int(mezo.get("n_directions", 1))
    every = 2.0 * leaf_bytes(model)
    if estimator == "fused":
        return (2.0 * k * 2.0 * leaf_bytes(model, transient_only=True)
                + k * every)
    if estimator == "walk":
        return 4.0 * k * every
    raise ValueError(f"no byte count for estimator {estimator!r}")


def zo_add_bytes_users(model: dict, mezo: dict, dispatches: int,
                       user_steps: int, lanes: int) -> float:
    """Bytes of a multi-tenant engine's ``zo_add_users`` sweeps: each
    dispatch's one forward perturbs the transient leaves of all ``lanes``
    forward lanes (both signs of every slot), and each user-step's update
    sweeps every leaf of its slot once a direction."""
    k = int(mezo.get("n_directions", 1))
    transient = 2.0 * leaf_bytes(model, transient_only=True)
    return (k * dispatches * lanes * transient
            + k * user_steps * 2.0 * leaf_bytes(model))
