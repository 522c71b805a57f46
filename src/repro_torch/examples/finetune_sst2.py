"""Paper Sec 4.1: fine-tune RoBERTa-large on SST-2 with MeZO.

Port of the JAX package's ``examples/finetune_sst2.py``. Reduced
RoBERTa-large config + synthetic SST-2 (planted sentiment lexicon);
reports loss and accuracy before/after. This is the paper's Figure-1
experiment end to end, including the replay-log checkpoint flow: the
run snapshots every 100 steps and logs each step's (seed, gs).

  PYTHONPATH=src python -m repro_torch.examples.finetune_sst2 [--device cpu]

The checkpoint goes to ``repro_torch_sst2_ckpt`` under the temporary
directory. The MeZO forwards' attention runs the ``flash_attention``
kernel on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile
from typing import Optional

import torch

from repro_torch.configs import get_config
from repro_torch.core import MezoConfig
from repro_torch.data.synthetic import sst2_batches, synthetic_sst2
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.serve.adapters import tree_bytes

SEQ, STEPS, BATCH = 32, 300, 16
MEZO = MezoConfig(eps=1e-2, lr=2e-2, n_directions=8)
SNAPSHOT_EVERY = 100
EVAL_N, EVAL_SEED = 256, 99
CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_sst2_ckpt")


def reduced_config():
    return get_config("roberta-large").reduced(n_layers=2, d_model=128,
                                               d_ff=256, vocab=256)


def eval_set(cfg):
    """The held-out (tokens, labels) accuracy is read on."""
    return synthetic_sst2(EVAL_N, SEQ, cfg.vocab, seed=EVAL_SEED)


def accuracy(model, params, toks, labels) -> float:
    """Share of ``labels`` the argmax of ``model.forward``'s logits hits."""
    device = next(iter(params.values())).device
    with torch.no_grad():
        logits, _ = model.forward(params, {
            "tokens": torch.as_tensor(toks).to(device)})
    pred = logits.argmax(-1).cpu().numpy()
    return float((pred == labels).mean())


def make_trainer(cfg, ckpt: str, steps: int = STEPS, device="cuda",
                 log_fn=print) -> Trainer:
    """The example's Trainer: ``mezo`` (the walk estimator) over
    ``sst2_batches(seed=5)``, a fresh checkpoint directory ``ckpt``."""
    shutil.rmtree(ckpt, ignore_errors=True)
    tc = TrainerConfig(optimizer="mezo", mezo=MEZO, n_steps=steps,
                       ckpt_dir=ckpt, snapshot_every=SNAPSHOT_EVERY,
                       log_every=50, device=device)
    return Trainer(dataclasses.replace(cfg, attn_impl="flash"), tc,
                   sst2_batches(BATCH, SEQ, cfg.vocab, seed=5),
                   log_fn=log_fn)


def finetune(tr: Trainer, p0, toks, labels):
    """Accuracy at ``p0``, train a copy, accuracy after: returns
    ``(acc0, acc1, params)``."""
    acc0 = accuracy(tr.model, p0, toks, labels)
    params = tr.train({k: v.clone() for k, v in p0.items()})
    acc1 = accuracy(tr.model, params, toks, labels)
    return acc0, acc1, params


def log_bytes(ckpt: str) -> int:
    return os.path.getsize(os.path.join(ckpt, "replay.jsonl"))


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "finetune_sst2")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    cfg = reduced_config()
    tr = make_trainer(cfg, CKPT, device=args.device)
    p0 = tr.init_params()
    toks, labels = eval_set(cfg)
    acc0, acc1, _ = finetune(tr, p0, toks, labels)
    print(f"\nSST-2 (synthetic): acc {acc0:.3f} -> {acc1:.3f}; "
          f"loss {tr.losses[0]:.3f} -> {tr.losses[-1]:.3f}")
    print(f"replay log: {log_bytes(CKPT)} bytes for {STEPS} steps (vs "
          f"{tree_bytes(p0)/1e6:.1f} MB params)")
    assert acc1 > acc0, "fine-tuning should help"


if __name__ == "__main__":
    main()
