"""Deterministic synthetic datasets with planted, learnable structure.

A numpy-only copy of the JAX package's ``data/synthetic.py`` (the port
imports nothing of that package): the same functions give the same
batches from the same seed.

* ``synthetic_lm_corpus`` -- a first-order Markov language over ``vocab``
  tokens (each token strongly predicts a successor), so next-token CE has
  ~2 nats of learnable signal below the uniform-prior loss.

* ``synthetic_sst2`` -- the paper's RoBERTa/SST-2 task shape: binary
  "sentiment" where a handful of planted lexicon tokens determine the
  label.
"""

from __future__ import annotations

import numpy as np


def synthetic_lm_corpus(n_tokens: int, vocab: int, seed: int = 0,
                        peakiness: float = 0.85) -> np.ndarray:
    """Markov-chain token stream: P(next = succ(tok)) = peakiness."""
    rng = np.random.default_rng(seed)
    succ = rng.permutation(vocab)
    toks = np.empty(n_tokens, np.int32)
    toks[0] = rng.integers(vocab)
    jump = rng.random(n_tokens) > peakiness
    rand = rng.integers(0, vocab, n_tokens)
    for i in range(1, n_tokens):
        toks[i] = rand[i] if jump[i] else succ[toks[i - 1]]
    return toks


def lm_batch_at(step: int, batch: int, seq: int, vocab: int,
                stream: np.ndarray, seed: int = 0):
    """Batch addressed by step index -- resume at step N replays exactly
    the batch an uninterrupted run would have seen (checkpoint/restart
    determinism)."""
    rng = np.random.default_rng((seed + 1) * 1_000_003 + step)
    n = len(stream) - 1
    starts = rng.integers(0, n - seq - 1, batch)
    idx = starts[:, None] + np.arange(seq + 1)[None]
    chunk = stream[idx]
    return {
        "tokens": chunk[:, :-1].astype(np.int32),
        "targets": chunk[:, 1:].astype(np.int32),
        "loss_mask": np.ones((batch, seq), np.float32),
    }


def lm_batches(batch: int, seq: int, vocab: int, seed: int = 0,
               n_steps: int = 10 ** 9, start_step: int = 0):
    """Yields step-indexed {tokens, targets, loss_mask} dicts."""
    stream = synthetic_lm_corpus((batch * (seq + 1)) * 64, vocab, seed)
    for step in range(start_step, n_steps):
        yield lm_batch_at(step, batch, seq, vocab, stream, seed)


def synthetic_sst2(n: int, seq: int, vocab: int, seed: int = 0):
    """Planted-lexicon binary classification (SST-2 stand-in)."""
    rng = np.random.default_rng(seed)
    n_lex = max(8, vocab // 16)
    pos_lex = rng.choice(vocab - 1, n_lex, replace=False) + 1
    neg_lex = rng.choice(vocab - 1, n_lex, replace=False) + 1
    toks = rng.integers(1, vocab, (n, seq)).astype(np.int32)
    labels = rng.integers(0, 2, n).astype(np.int32)
    # plant 3 lexicon tokens per example at random positions (not pos 0)
    for i in range(n):
        lex = pos_lex if labels[i] else neg_lex
        pos = rng.choice(seq - 1, 3, replace=False) + 1
        toks[i, pos] = rng.choice(lex, 3)
    toks[:, 0] = 0  # CLS
    return toks, labels


def sst2_batches(batch: int, seq: int, vocab: int, seed: int = 0,
                 n_examples: int = 4096):
    toks, labels = synthetic_sst2(n_examples, seq, vocab, seed)
    rng = np.random.default_rng(seed + 1)
    while True:
        idx = rng.integers(0, n_examples, batch)
        yield {"tokens": toks[idx], "label": labels[idx]}
