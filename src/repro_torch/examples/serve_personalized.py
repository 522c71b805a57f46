"""End-to-end personalized-LLM flow (the paper's motivating scenario),
multi-user edition.

Port of the JAX package's ``examples/serve_personalized.py``:

  1. fine-tune TWO "users" on their own (synthetic) private data with
     MeZO -- same shared base weights, different data,
  2. export each user's fine-tune as a ZO adapter: the replay log alone,
     a few KB of (seed, gs) scalars instead of a parameter tree,
  3. serve interleaved per-user requests from ONE engine instance --
     adapters materialized on demand (base + replay), continuous-batching
     decode.

  PYTHONPATH=src python -m repro_torch.examples.serve_personalized [--device cpu]

The serving base is the Trainer's own seed-0 init on the same device
(:func:`serving_base`): the port draws it from a ``torch.Generator`` on
that device, so a second recipe, or another device, would give another
base. Beyond the JAX file, each user's materialized parameters are held
to that user's trained ones at atol 0 (vmapdir keeps the base point
pristine, so replay is the live trajectory bit for bit). The checkpoints
go to ``repro_torch_personalized_<user>`` under the temporary directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import MezoConfig
from repro_torch.data.synthetic import lm_batches
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.serve import AdapterStore, Request, ServeEngine, tree_bytes

MZ = MezoConfig(eps=1e-2, lr=5e-3, n_directions=4)
USERS = {"alice": 11, "bob": 23}          # user -> private-data seed
STEPS = 30
N_REQUESTS, PROMPT_LEN, MAX_NEW = 6, 8, 6


def reduced_config():
    return get_config("gemma-2b").reduced()


def ckpt_dirs(root: Optional[str] = None) -> Dict[str, str]:
    root = root or tempfile.gettempdir()
    return {u: os.path.join(root, f"repro_torch_personalized_{u}")
            for u in USERS}


def _train_config(steps: int, ckpt: Optional[str], device) -> TrainerConfig:
    # vmapdir estimator => pristine base point => the replay log is a
    # bit-exact reconstruction of the fine-tune (walk would drift ~1e-5)
    return TrainerConfig(optimizer="mezo-parallel", mezo=MZ, n_steps=steps,
                         ckpt_dir=ckpt, snapshot_every=15, log_every=10,
                         seed=0, device=device)


def serving_base(cfg, device="cuda"):
    """The shared base: the Trainer's seed-0 init, drawn on ``device``."""
    return Trainer(cfg, _train_config(0, None, device), iter(())
                   ).init_params()


def finetune(cfg, user: str, data_seed: int, ckpt: str, steps: int = STEPS,
             device="cuda", params=None):
    """One user's fine-tune from ``params`` (default the Trainer's seed-0
    init) on ``lm_batches(8, 32, seed=data_seed)``, checkpointed into a
    fresh ``ckpt``. Returns ``(trainer, trained params)``."""
    shutil.rmtree(ckpt, ignore_errors=True)
    tr = Trainer(dataclasses.replace(cfg, attn_impl="flash"),
                 _train_config(steps, ckpt, device),
                 lm_batches(8, 32, cfg.vocab, seed=data_seed))
    trained = tr.train(params)
    print(f"[{user}] fine-tuned on private data: "
          f"loss {tr.losses[0]:.3f} -> {tr.losses[-1]:.3f}")
    return tr, trained


def adapter_store(base, ckpts: Dict[str, str], device="cuda"):
    """A fresh store over ``base`` that imports every user's replay log;
    asserts each user really moved off the base."""
    store = AdapterStore(base, MZ, device=device)
    for user in USERS:
        ad = store.import_checkpoint(user, ckpts[user])
        print(f"[{user}] adapter: {ad.n_steps} steps, {ad.nbytes} B "
              f"(base tree: {tree_bytes(base)} B)")
    first = next(iter(base))
    deltas = {u: float((store.materialize(u)[first].float()
                        - base[first].float()).abs().max()) for u in USERS}
    assert all(d > 0 for d in deltas.values()), deltas   # really fine-tuned
    return store


def check_materialized(store, trained: Dict[str, dict]):
    """Each user's materialized parameters equal its trained ones at
    atol 0 (replay == live)."""
    for user, params in trained.items():
        mat = store.materialize(user)
        diff = sorted(k for k in params if not torch.equal(mat[k],
                                                           params[k]))
        assert not diff, f"{user}: materialized != trained in {diff[:3]}"


def requests(cfg):
    """The 6 interleaved requests (8 prompt tokens, 6 new each)."""
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (N_REQUESTS, PROMPT_LEN), dtype=np.int32)
    users = [u for _, u in zip(range(N_REQUESTS), 3 * list(USERS))]
    return [Request(prompt=prompts[i], max_new=MAX_NEW, user=u)
            for i, u in enumerate(users)]


def serve(cfg, store, device="cuda"):
    """The requests through one dense engine of 2 slots (admission
    happens mid-flight). Returns ``(engine, completions, rid -> user)``."""
    engine = ServeEngine(cfg, store, n_slots=2, max_len=32, seed=0,
                         device=device)
    rids = {engine.submit(r): r.user for r in requests(cfg)}
    return engine, engine.run(), rids


def report(engine, store, completions, rids):
    served = {}
    for c in completions:
        assert c.tokens.shape == (MAX_NEW,) and rids[c.rid] == c.user
        served.setdefault(c.user, []).append(c.rid)
        print(f"[serve] rid={c.rid} user={c.user}: {c.tokens.tolist()}")
    assert set(served) == set(USERS), served
    st = engine.stats
    print(f"[serve] interleaved {len(completions)} requests from "
          f"{len(served)} adapters in one engine | prefill "
          f"{st.prefill_tps:.0f} tok/s | decode {st.decode_tps:.0f} tok/s | "
          f"adapter cache: {store.stats['misses']} materializations, "
          f"{store.stats['hits']} hits")


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "serve_personalized")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    cfg = reduced_config()
    ckpts = ckpt_dirs()
    trained = {user: finetune(cfg, user, seed, ckpts[user],
                              device=args.device)[1]
               for user, seed in USERS.items()}

    # fresh "serving process": shared base weights + per-user scalar logs
    base = serving_base(cfg, args.device)
    store = adapter_store(base, ckpts, args.device)
    check_materialized(store, trained)
    engine, completions, rids = serve(cfg, store, args.device)
    report(engine, store, completions, rids)
    print("OK: fine-tune x2 -> export ZO adapters -> serve interleaved")


if __name__ == "__main__":
    main()
