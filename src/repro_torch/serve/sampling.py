"""Per-slot token sampling: greedy and seeded top-k.

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
