"""Serving launcher: thin CLI over the personalized serving subsystem.

Port of the JAX package's ``launch/serve.py`` (the same flags but
``--family``, whose other families the port does not run yet, plus
``--device``). It builds an engine, loads per-user ZO adapters from
replay logs, serves a synthetic request mix and prints the summary line:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch opt-1.3b \\
      --paged --page-size 16 --prefill-chunk 32 --spec-k 3 \\
      --adapter alice=/path/to/ckpt_alice --adapter bob=/path/to/ckpt_bob

Runs on the CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core import MezoConfig
from repro_torch.models import build_model
from repro_torch.models.transformer import resolve_device
from repro_torch.serve import AdapterStore, Request, ServeEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="opt-1.3b", choices=ALL_ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ckpt-dir", default=None,
                    help="load BASE params from this checkpoint dir")
    ap.add_argument("--adapter", action="append", default=[],
                    metavar="USER=CKPT_DIR",
                    help="register USER's replay log as a ZO adapter "
                         "(repeatable); requests round-robin over users "
                         "(over the base when none is given)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--sample", action="store_true",
                    help="seeded top-k sampling instead of greedy")
    ap.add_argument("--topk", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dist", default="rademacher",
                    choices=("rademacher", "gaussian"),
                    help="perturbation dist the adapters were trained with")
    ap.add_argument("--weight-decay", type=float, default=0.0,
                    help="weight decay the adapters were trained with")
    ap.add_argument("--cache-mb", type=float, default=None,
                    help="adapter-store byte budget for materialized trees")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: attention K/V in a shared page "
                         "pool with per-slot page tables (decode reads "
                         "only live pages via the flash_decode kernel)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (paged mode)")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="total pool pages incl. the trash page (default: "
                         "slots x ceil(max_len/page_size) + 1)")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="self-speculative decoding (needs --paged): the "
                         "frozen base drafts up to K tokens per round into "
                         "the slot's shared KV pages, base+delta verifies "
                         "them in one batched window call; greedy output "
                         "is bit-identical to plain decoding")
    ap.add_argument("--prefill-chunk", type=int, default=None, metavar="N",
                    help="chunked prefill (needs --paged): admissions "
                         "advance at most N prompt tokens per engine step, "
                         "written straight into the slot's KV pages; "
                         "composes with --spec-k")
    return ap


def build_engine(args, params=None) -> ServeEngine:
    """The model, adapters and engine from parsed ``args``, with the
    synthetic request mix submitted. ``params`` replaces the seeded
    random base (e.g. an int8 base from ``optim.quant.quantize_tree``,
    which the CLI itself never makes: it has no ``--quant``)."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = model.init(gen, device)
    if args.ckpt_dir:
        step = store.latest_step(args.ckpt_dir)
        if step is not None:
            params = store.load_params(args.ckpt_dir, step, params)
            print(f"[serve] loaded base checkpoint step {step}")

    adapters = AdapterStore(
        params, MezoConfig(dist=args.dist, weight_decay=args.weight_decay),
        cache_bytes=(int(args.cache_mb * 2**20) if args.cache_mb else None),
        device=device)
    users = []
    for spec in args.adapter:
        user, _, ckpt = spec.partition("=")
        if not ckpt:
            raise SystemExit(f"--adapter wants USER=CKPT_DIR, got {spec!r}")
        ad = adapters.import_checkpoint(user, ckpt)
        users.append(user)
        print(f"[serve] adapter {user!r}: {ad.n_steps} steps, "
              f"{ad.nbytes} bytes")
    if not users:
        users = [None]                     # base weights only

    engine = ServeEngine(cfg, adapters, n_slots=args.slots,
                         max_len=args.prompt_len + args.gen,
                         seed=args.seed, paged=args.paged,
                         page_size=args.page_size,
                         pool_pages=args.pool_pages, spec_k=args.spec_k,
                         prefill_chunk=args.prefill_chunk, device=device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.requests, args.prompt_len),
                           dtype=np.int32)
    for i in range(args.requests):
        engine.submit(Request(prompt=prompts[i], max_new=args.gen,
                              user=users[i % len(users)],
                              greedy=not args.sample, topk=args.topk,
                              temperature=args.temperature))
    return engine


def run(args, params=None):
    """Build the engine from parsed ``args`` (and ``params``, see
    :func:`build_engine`) and serve the request mix. Returns ``(engine,
    completions, seconds)``."""
    engine = build_engine(args, params)
    t0 = time.perf_counter()
    completions = engine.run()
    return engine, completions, time.perf_counter() - t0


def summary(args, engine, completions, dt) -> str:
    st = engine.stats
    adapters = engine.store
    paged_note = (f" | paged: {engine.pool_pages} pages x "
                  f"{engine.page_size} tok, peak in use "
                  f"{st.peak_pages_in_use}" if engine.paged else "")
    if engine.spec_k:
        paged_note += (f" | spec k={engine.spec_k}: accepted "
                       f"{st.spec_accepted}/{st.spec_drafted} drafts "
                       f"({st.spec_accept_rate:.0%}) in "
                       f"{st.decode_steps} rounds")
    if engine.prefill_chunk:
        paged_note += f" | chunked prefill C={engine.prefill_chunk}"
    n_done = max(len(completions), 1)
    lat_note = (f" | ttft avg {st.ttft_s / n_done * 1e3:.0f}ms "
                f"(queue {st.queue_wait_s / n_done * 1e3:.0f}ms) | "
                f"decode stall {st.decode_stall_s:.2f} slot-s")
    return (f"[serve] {args.requests} reqs x ({args.prompt_len} prompt + "
            f"{args.gen} gen) in {dt:.2f}s | prefill {st.prefill_tps:.0f} "
            f"tok/s | decode {st.decode_tps:.0f} tok/s | "
            f"adapter materializations: {adapters.stats['misses']} "
            f"(hits {adapters.stats['hits']})" + lat_note + paged_note)


def main(argv=None):
    args = build_parser().parse_args(argv)
    engine, completions, dt = run(args)
    for c in completions:
        tag = c.user if c.user is not None else "base"
        print(f"[serve] rid={c.rid} user={tag}: {c.tokens.tolist()}")
    print(summary(args, engine, completions, dt))


if __name__ == "__main__":
    main()
