"""Per-slot token sampling: greedy, seeded top-k, and speculative
rejection sampling.

Port of the JAX package's ``serve/sampling.py``. The engine owns one
``torch.Generator``; :func:`step_keys` draws one generator per slot from
it for each step, so every slot samples from its own stream and a run is
reproducible from the engine seed. torch's generators give other
numbers than ``jax.random`` for the same seed: sampled tokens match the
JAX package in distribution, greedy tokens match exactly.
"""

from __future__ import annotations

from typing import List

import torch


def step_keys(generator: torch.Generator, n_slots: int
              ) -> List[torch.Generator]:
    """Advance the engine generator one step; returns ``n_slots``
    per-slot generators seeded from it."""
    seeds = torch.randint(0, 2**62, (n_slots,), generator=generator,
                          device=generator.device)
    return [torch.Generator(device=generator.device).manual_seed(int(s))
            for s in seeds.tolist()]


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits: (B, V) -> (B,) argmax tokens."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_topk(generators, logits: torch.Tensor, k: int,
                temperature: float = 1.0) -> torch.Tensor:
    """Seeded top-k sampling, one generator per row.

    logits: (B, V). Renormalizes over the k largest logits, scaled by
    ``temperature``. Returns (B,) int32 tokens.
    """
    k = max(1, min(k, logits.shape[-1]))
    vals, idx = torch.topk(logits.to(torch.float32), k, dim=-1)
    t = max(float(temperature), 1e-6)
    probs = torch.softmax(vals / t, dim=-1)
    out = []
    for row, gen in enumerate(generators):
        j = torch.multinomial(probs[row].to(gen.device), 1, generator=gen)
        out.append(idx[row, j.to(idx.device)])
    return torch.cat(out).to(torch.int32)


def spec_accept(generator: torch.Generator, draft, logits, k: int,
                temperature: float = 1.0):
    """Speculative rejection sampling against a greedy draft.

    draft: (d,) greedily drafted tokens (d >= 1); logits: (d+1, V) target
    logits at the d+1 window positions (the top-k/temperature truncation
    of :func:`sample_topk` defines the target distribution p_i). The
    draft distribution is one-hot on draft[i], so the standard accept
    rule reduces to: accept draft[i] with probability p_i(draft[i]); on
    the first rejection resample from p_i with the draft token zeroed;
    if every draft token is accepted, draw the bonus token from p_d. The
    emitted sequence is distributed as d+1 sequential draws from the
    target. Returns ``(n_accepted, next_token)``: commit
    ``draft[:n_accepted]`` followed by ``next_token``.
    """
    draft = torch.as_tensor(draft, dtype=torch.long)
    logits = torch.as_tensor(logits).to(torch.float32)
    d = draft.shape[0]
    k = max(1, min(k, logits.shape[-1]))
    t = max(float(temperature), 1e-6)
    vals, idx = torch.topk(logits, k, dim=-1)
    probs = torch.zeros_like(logits).scatter_(
        1, idx, torch.softmax(vals / t, dim=-1))        # (d+1, V)
    p_draft = probs[:d].gather(1, draft[:, None])[:, 0]
    accept = torch.rand(d, generator=generator) < p_draft
    n = int(torch.cumprod(accept.to(torch.int64), 0).sum())
    row = probs[n]                                       # resample source
    resid = row.clone()
    if n < d:
        resid[draft[n]] = 0.0                            # bonus: full p_d
    if not resid.sum() > 0:
        resid = row                                      # numeric fallback
    nxt = torch.multinomial(resid, 1, generator=generator)
    return n, int(nxt)
