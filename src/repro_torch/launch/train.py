"""Training launcher: the paper's end-to-end MeZO fine-tuning flow.

Port of the JAX package's ``launch/train.py``: the same flags, plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions,
for reduced configs):

  PYTHONPATH=src python -m repro_torch.launch.train --arch opt-1.3b \\
      --reduced --device cpu --optimizer mezo-fused --steps 6 --batch 4 \\
      --seq 32

``--optimizer`` names a registered strategy; ``--estimator`` /
``--update`` compose any pairing (``--estimator fused --update
momentum``). ``--metrics-out`` writes the per-step losses in the JAX
CLI's format. ``--quant int8`` trains over a frozen int8 base with f32
deltas. ``--optimizer adam`` trains the gradient baseline (autograd and
Adam at ``--adam-lr``); ``--straggler-redundancy R`` schedules R extra
directions a step and logs each step's survivor mask.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

import numpy as np

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.engine import (MezoConfig, estimator_names,
                                     strategy_names, update_rule_names)
from repro_torch.data.synthetic import lm_batches, sst2_batches
from repro_torch.optim.adam import AdamConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def _with_frontend_stub(batches, bsz: int, cfg, seed: int):
    """The modality frontend stubs (the JAX CLI's): each batch gains
    standard normal ``enc_embeds`` (B, enc_len, d_model) for an encdec
    config, then ``patch_embeds`` (B, num_patches, d_model) for a vlm
    one, from one numpy stream seeded ``seed + 7``."""
    rng = np.random.default_rng(seed + 7)
    for b in batches:
        if cfg.family == "encdec":
            b["enc_embeds"] = rng.standard_normal(
                (bsz, cfg.enc_len, cfg.d_model), dtype=np.float32)
        if cfg.num_patches:
            b["patch_embeds"] = rng.standard_normal(
                (bsz, cfg.num_patches, cfg.d_model), dtype=np.float32)
        yield b


def batch_stream(cfg, bsz: int, seq: int, seed: int):
    """The CLI's batches for ``cfg``: synthetic SST-2 for a classifier,
    else LM batches with the frontend stubs the config takes."""
    if cfg.n_classes:
        return sst2_batches(bsz, seq, cfg.vocab, seed=seed)
    batches = lm_batches(bsz, seq, cfg.vocab, seed=seed)
    if cfg.family == "encdec" or cfg.num_patches:
        batches = _with_frontend_stub(batches, bsz, cfg, seed)
    return batches


def make_trainer(args) -> Trainer:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.seq and cfg.family != "encoder":
        cfg = dataclasses.replace(cfg, max_seq=max(cfg.max_seq, args.seq))
    batches = batch_stream(cfg, args.batch, args.seq or 64, args.seed)
    tcfg = TrainerConfig(
        optimizer=args.optimizer,
        estimator=args.estimator, update=args.update,
        quant=args.quant,
        mezo=MezoConfig(eps=args.eps, lr=args.lr,
                        n_directions=args.directions, dist=args.zo_dist,
                        use_kernel=args.use_kernel,
                        momentum=args.momentum,
                        momentum_window=args.momentum_window,
                        weight_decay=args.weight_decay),
        adam=AdamConfig(lr=args.adam_lr),
        n_steps=args.steps, seed=args.seed, ckpt_dir=args.ckpt_dir,
        snapshot_every=args.snapshot_every, log_every=args.log_every,
        straggler_redundancy=args.straggler_redundancy,
        device=args.device)
    return Trainer(cfg, tcfg, batches)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="opt-1.3b", choices=ALL_ARCHS)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--optimizer", default="mezo",
                    choices=strategy_names() + ["adam"],
                    help="registered strategy name, or adam (gradient "
                         "baseline)")
    ap.add_argument("--estimator", default=None,
                    choices=estimator_names(),
                    help="direction evaluator; with --update, composes any "
                         "estimator x update pairing (overrides "
                         "--optimizer)")
    ap.add_argument("--update", default=None, choices=update_rule_names(),
                    help="update rule applied to the (seed, gs) estimate")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--adam-lr", type=float, default=1e-4,
                    help="the gradient baseline's (--optimizer adam) lr")
    ap.add_argument("--directions", type=int, default=1)
    ap.add_argument("--momentum", type=float, default=0.9,
                    help="ZO momentum beta (momentum update rule only)")
    ap.add_argument("--momentum-window", type=int, default=8,
                    help="steps of (seed, gs) history the truncated "
                         "seed-replay momentum keeps")
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--zo-dist", default="rademacher",
                    choices=["rademacher", "gaussian"])
    ap.add_argument("--quant", default="none",
                    help="base-weight quantization mode (none | int8): "
                         "int8 freezes the base as int8 + per-channel "
                         "scales; the ZO update stream lands in per-leaf "
                         "f32 deltas. Validated by the trainer (unknown "
                         "modes raise with the supported list)")
    ap.add_argument("--use-kernel", action="store_true",
                    help="no effect: tensors on the card always take the "
                         "CUDA kernels, tensors on the CPU their plain "
                         "versions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--snapshot-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--straggler-redundancy", type=int, default=0)
    ap.add_argument("--metrics-out", default=None)
    return ap


def run(argv=None, params=None) -> Trainer:
    """Parse ``argv``, train, write ``--metrics-out``; returns the trainer
    (its ``losses``, ``model`` and ``strategy``). ``params`` replaces the
    seeded random init, e.g. with the JAX package's parameters."""
    args = build_argparser().parse_args(argv)
    tr = make_trainer(args)
    tr.params = tr.train(params)
    if args.metrics_out:
        os.makedirs(os.path.dirname(args.metrics_out) or ".", exist_ok=True)
        with open(args.metrics_out, "w") as f:
            json.dump({"arch": args.arch, "optimizer": args.optimizer,
                       "losses": tr.losses}, f)
    print(f"[train] done: loss {tr.losses[0]:.4f} -> {tr.losses[-1]:.4f} "
          f"({len(tr.losses)} steps)")
    return tr


def main(argv: Optional[list] = None):
    run(argv)


if __name__ == "__main__":
    main()
