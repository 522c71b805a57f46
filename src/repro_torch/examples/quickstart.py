"""Quickstart: PocketLLM's claim in one file.

Port of the JAX package's ``examples/quickstart.py``. Fine-tunes a
reduced OPT-family model twice on the same synthetic data: once with MeZO
(derivative-free, 2 forwards a direction, no optimizer state) and once
with Adam, reporting loss descent and the *state memory* each method
needs -- the paper's Table 1 contrast in miniature.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The MeZO arm's attention runs the ``flash_attention`` kernel on the card;
the Adam arm's runs plain attention (``attn_impl="chunked"``), since the
kernel has no backward.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import MezoConfig
from repro_torch.data.synthetic import lm_batches
from repro_torch.optim.adam import AdamConfig, adam_init
from repro_torch.runtime import Trainer, TrainerConfig

STEPS, BATCH, SEQ = 100, 8, 32
MEZO = MezoConfig(eps=1e-2, lr=1e-2, n_directions=8)
ADAM = AdamConfig(lr=1e-3)
OPTIMIZERS = ("mezo", "adam")


def reduced_config():
    return get_config("opt-1.3b").reduced(n_layers=2, d_model=64, d_ff=128,
                                          vocab=128)


def state_bytes(tree) -> int:
    """Bytes of every tensor in a (nested) dict, list or dataclass."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if dataclasses.is_dataclass(tree):
        tree = vars(tree)
    if isinstance(tree, dict):
        tree = tree.values()
    return sum(state_bytes(t) for t in tree)


def train_arm(cfg, optimizer: str, steps: int = STEPS, device="cuda",
              params=None, log_fn=print) -> Trainer:
    """One arm: ``steps`` of ``optimizer`` on ``lm_batches(seed=1)`` from
    ``params`` (a copy is trained; default the Trainer's seed-0 init).
    Returns the Trainer, its final parameters as ``.params``."""
    impl = "chunked" if optimizer == "adam" else "flash"
    tc = TrainerConfig(optimizer=optimizer, mezo=MEZO, adam=ADAM,
                       n_steps=steps, log_every=20, device=device)
    tr = Trainer(dataclasses.replace(cfg, attn_impl=impl), tc,
                 lm_batches(BATCH, SEQ, cfg.vocab, seed=1), log_fn=log_fn)
    if params is not None:
        params = {k: v.clone() for k, v in params.items()}
    tr.params = tr.train(params)
    return tr


def state_memory(cfg, device="cuda", params=None):
    """(parameter bytes, Adam's moment bytes) of ``cfg``'s tree."""
    if params is None:
        params = Trainer(cfg, TrainerConfig(device=device),
                         iter(())).init_params()
    return state_bytes(params), state_bytes(adam_init(params))


def report(runs, p_bytes: int, a_bytes: int):
    print("\n=== PocketLLM quickstart ===")
    for opt, losses in runs.items():
        print(f"{opt:5s}: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"({len(losses)} steps)")
    print(f"\ntrain-state memory beyond params ({p_bytes/1e6:.1f} MB):")
    print("  mezo: 0.0 MB (z is regenerated from a seed; no grads, "
          "no moments)")
    print(f"  adam: {a_bytes/1e6:.1f} MB (fp32 moments) + gradient buffer "
          f"+ activations for backprop")


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "quickstart")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    cfg = reduced_config()
    runs = {opt: train_arm(cfg, opt, device=args.device).losses
            for opt in OPTIMIZERS}
    report(runs, *state_memory(cfg, args.device))
    first = np.mean(runs["mezo"][:10])
    last = np.mean(runs["mezo"][-10:])
    assert last < first, "MeZO should descend"


if __name__ == "__main__":
    main()
