"""Where serve_personalized's engine rows part from the reference loop.

On the card: fine-tune the example's two users on full-width gemma-2b for
``--steps`` vmapdir steps each (``chip_smoke.py`` EX3's recipe), serve
the example's 6 requests through its dense engine of 2 slots, then the
same requests on the base (no adapter). For every request it prints one
JSON line with the largest |difference| over its 6 picked logits rows:

* ``engine_vs_recipe``: the engine against its recipe run outside it
  (``chip_smoke._prefill_forced``: each prompt prefilled alone, then the
  dense decode_step teacher-forced on the served tokens);
* ``engine_vs_serve``: against ``serve()``'s loop (the prompt fed token
  by token, ``chip_smoke._teacher_forced``);
* ``serve_vs_f32`` and ``engine_vs_f32``: each against that loop on the
  parameters in f32, the rounding noise of a bf16 row;

and whether any parameter of the base or a user changed while serving.

  python scripts/serve_prefill_probe.py --steps 10
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _max(a, b) -> float:
    return float((a - b).abs().max())


def probe(torch, cs, cfg, store, users, tag):
    import numpy as np
    from repro_torch.examples import serve_personalized as sp
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve import engine as engine_mod
    trees = {u: store.materialize(u) for u in users}
    before = {u: {k: v.clone() for k, v in t.items()}
              for u, t in trees.items()}
    (_, comps, _), rows = cs._engine_rows(
        torch, engine_mod, lambda: sp.serve(cfg, store, "cuda"))
    changed = {str(u): sorted(k for k in t if not torch.equal(before[u][k],
                                                              t[k]))
               for u, t in trees.items()}
    del before
    f32 = dataclasses.replace(cfg, dtype="float32")
    for user in users:
        mine = sorted((c for c in comps if c.user == user),
                      key=lambda c: c.rid)
        params = trees[user]
        prompts = np.stack([c.prompt for c in mine])
        served = np.stack([c.tokens for c in mine])
        recipe = cs._prefill_forced(torch, serve_mod, cfg, params, prompts,
                                    served)
        loop = cs._teacher_forced(torch, serve_mod, cfg, params, prompts,
                                  served)
        wide = cs._teacher_forced(torch, serve_mod, f32, {
            k: v.float() for k, v in params.items()}, prompts, served)
        for i, c in enumerate(mine):
            eng = torch.stack([rows[(c.rid, j)] for j in range(sp.MAX_NEW)])
            print(json.dumps({
                "tag": tag, "rid": c.rid, "user": str(user),
                "engine_vs_recipe": _max(eng, recipe[i]),
                "engine_vs_serve": _max(eng, loop[i]),
                "serve_vs_f32": _max(loop[i], wide[i]),
                "engine_vs_f32": _max(eng, wide[i]),
                "max_abs_logit": float(wide[i].abs().max())}), flush=True)
    print(json.dumps({"tag": tag, "leaves_changed_while_serving": changed}),
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_personalized as sp
    from repro_torch.kernels import build
    from repro_torch.serve import AdapterStore
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.library()
    cfg = get_config("gemma-2b")
    ckpts = sp.ckpt_dirs(str(cs.WORK))
    base = sp.serving_base(cfg, "cuda")
    for user, seed in sp.USERS.items():
        sp.finetune(cfg, user, seed, ckpts[user], steps=args.steps,
                    device="cuda", params=base)
    store = sp.adapter_store(base, ckpts, "cuda")
    for d in ckpts.values():
        shutil.rmtree(d, ignore_errors=True)
    probe(torch, cs, cfg, store, list(sp.USERS), f"{args.steps} steps")
    # the base: the same requests with no adapter
    requests = sp.requests
    sp.requests = lambda c: [dataclasses.replace(r, user=None)
                             for r in requests(c)]
    probe(torch, cs, cfg, AdapterStore(base, sp.MZ, device="cuda"), [None],
          "base")


if __name__ == "__main__":
    main()
