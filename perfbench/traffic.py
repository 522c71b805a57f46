"""The one traffic generator: training batches from a workload's
``traffic`` parameters and ``--seed``.

Batch ``i`` of a run is a pure function of ``(seed, i)``: a generator on
the device seeded from both draws its rows, so every batch differs and
a second run with the seed repeats them. ``task`` is

* ``"lm"``: ``batch`` rows of ``seq + 1`` token ids uniform over the
  vocabulary; ``tokens`` are the first ``seq``, ``targets`` the last
  ``seq`` (next-token prediction) and ``loss_mask`` is all ones;
* ``"cls"``: ``batch`` rows of ``seq`` ids uniform over ``1..vocab-1``
  with id 0 (the classifier token) first, and a ``label`` a row uniform
  over ``n_classes`` (an SST-2-shaped task).

The sizes and the draws are the same for every seed; only the values
change.
"""

from __future__ import annotations

import torch


def stream_seed(seed: int, stream: int, index: int) -> int:
    """Seed of item ``index`` of stream ``stream`` of a run."""
    return (int(seed) * 1_000_003 + stream * 7_919_001 + index) % (2 ** 63)


def make_batch(traffic: dict, vocab: int, n_classes: int, seed: int,
               index: int, device, stream: int = 1) -> dict:
    """Batch ``index`` of ``stream`` (lanes of a multi-tenant cell use
    their own streams)."""
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream, index))
    b, s = int(traffic["batch"]), int(traffic["seq"])
    if traffic["task"] == "lm":
        chunk = torch.randint(0, vocab, (b, s + 1), generator=gen,
                              device=device)
        return {"tokens": chunk[:, :-1].contiguous(),
                "targets": chunk[:, 1:].contiguous(),
                "loss_mask": torch.ones((b, s), dtype=torch.float32,
                                        device=device)}
    if traffic["task"] == "cls":
        toks = torch.randint(1, vocab, (b, s), generator=gen, device=device)
        toks[:, 0] = 0
        label = torch.randint(0, n_classes, (b,), generator=gen,
                              device=device)
        return {"tokens": toks, "label": label}
    raise ValueError(f"unknown task {traffic['task']!r}")


class Feed:
    """The batches of one run in order, as an iterator: batch ``i`` is
    :func:`make_batch` ``(seed, i)``; ``taken`` counts those handed out."""

    def __init__(self, traffic: dict, vocab: int, n_classes: int, seed: int,
                 device):
        self.args = (traffic, vocab, n_classes, seed, device)
        self.taken = 0

    def batch(self, index: int) -> dict:
        return make_batch(*self.args[:4], index, self.args[4])

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = self.batch(self.taken)
        self.taken += 1
        return b
