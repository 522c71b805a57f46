#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py

Needs one CUDA card (written for an H100) and the CUDA toolkit. Phases:

1. device: the card's name and power limit; TF32 off.
2. build: every kernel of ``src/repro_torch/csrc`` with nvcc for sm_90a.
3. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the main paths' shapes, with its time, the plain version's,
   one library call's where there is one, and the bound (the larger of
   bytes over 3.35 TB/s and operations over the peak rate of their type;
   bf16 tensor cores for the bf16 bodies of ``zo_matmul*`` and
   ``flash_attention``, their SIMT f32 bound beside it). A kernel and its
   library calls are timed in one process, in turns, as CUDA-graph
   replays (5 rounds of 200 calls, medians; ``time_interleaved``): every
   SDPA backend that takes the case, the fastest named as the library;
   cuBLAS SGEMM for the ``zo_matmul`` family, with bf16 cuBLAS of the
   unperturbed W beside it as the product's floor; the ``zo_add`` family
   (no library call) with both arms, Rademacher and Gaussian z, the
   Gaussian bounded by the instructions its z adds an element (counted
   in the SASS of a probe, ``gauss_instructions``):
   ``zo_add``, ``flash_decode``, ``flash_prefill``; T0 ``zo_matmul`` and
   ``flash_attention`` (their SIMT bodies too: ``zo_matmul`` at
   RoBERTa-large's three projection shapes in f32 and the Gaussian arm
   at OPT-1.3B's ``w_in`` slice, ``SIMT_MM_TIMED``; ``flash_attention``
   f32 at RoBERTa-large's, ``SIMT_ATTN_TIMED``); Q0 ``zo_add_q`` and
   ``zo_matmul_q``; S0
   ``flash_verify`` (B 4, W 4, 32 heads of 64, page 16, positions 96-128,
   f32 and bf16, three GQA layouts and every family's heads
   (``REAL_HEADS``, kimi-k2's 64 heads of 112 over 8 KV heads among
   them), NaN in the trash page, two calls
   bit-equal, bf16 on the tensor-core body and f32 on the SIMT body;
   timed as ``VERIFY_TIMED``). The paged
   ``flash_decode`` / ``flash_prefill`` are checked at pages 8 and 16,
   f32 and bf16, KV 32 and 8, on ragged serving positions, the edges of
   a 64-key tile and a context up to 2048 (``ATTN_CHECKED``), and at
   page 16 at every ``REAL_HEADS`` layout: two calls
   bit-equal, NaN in the trash page and in each slot's unread last-page
   tail leaving the output bit-equal, prefill's bf16 launches on its
   tensor-core body and f32 on its SIMT body; and timed in bf16 at B 4
   (the rows timed since the first port), at the serving admission's B 1
   prefill and a decode at positions up to 2047 (``ATTN_TIMED``), with
   the page gather + SDPA in one graph beside the pre-gathered
   yardstick, as context. ``flash_decode`` takes its split route at
   every G >= 2 layout and its slot route at G = 1: both held at every
   ``REAL_HEADS`` layout, f32 and bf16, B 8 at short positions and up to
   2047 with a slot at 0 and at chunk edges, pages 16 and 64
   (``DECODE_SPLIT_CHECKED``): the limits, two calls bit-equal, NaN where
   no row reads leaving the output bit-equal, each slot alone (B 1)
   bit-equal to its row at B 8; timed at every G >= 2 layout, short and
   long (``GQA_DECODE_TIMED``); the tensor-core body (bf16, G 8-16) is
   also held to the split model with P rounded as it rounds it
   (``SPLIT_TC_RTOL``, ``SPLIT_TC_ATOL``);
   ``flash_prefill`` and ``flash_verify`` timed once at every
   ``REAL_HEADS`` layout. ``flash_attention`` is also checked at B 8 x
   128 at every ``REAL_HEADS`` layout and at whisper-base's encoder (B 8
   x 1500), and timed at every ``REAL_HEADS`` layout (B 8 x 128,
   causal); ``zo_matmul`` at jamba's ``x_proj`` (N 288) and whisper's
   width (512), against their plain versions at the same limits.
   ``selective_scan`` (Mamba-1's scan, which replaces the JAX package's
   ``lax.scan``) at the Jamba cell's shape (B 2 x S 4096, d_inner 8192,
   d_state 16) against its plain version: in f32 within
   ``SCAN_F32_RTOL`` of max|y|, in bf16 (x and z) every element within
   ``SCAN_BF16_RTOL`` of its own |y| plus ``SCAN_BF16_RMS`` of rms(y);
   timed beside it and beside its bound (the larger of its least bytes
   over HBM and its exponentials and FMAs over the SFU and FP32 pipes,
   ``scan_bound_s``); no PyTorch call computes it.
4. serving: ``repro_torch.launch.serve.run`` on full-width, 24-layer
   OPT-1.3B (bf16, random weights from a seed), paged KV with page size 16
   and chunked prefill C = 32, 4 slots, 8 greedy requests (96-token
   prompts, 32 new tokens): the CLI's six round-robin over two replayed
   ZO adapters, two more submitted for the base. The first-step logits must agree with the dense-mode engine
   (plain attention) within a bf16 tolerance, and a user's must differ
   from the base's on one prompt.
5. profile: a shorter run of the same path (4 requests, 16 new tokens)
   under ``torch.profiler``: the device's busy share of the serving wall
   time and the kernels that take the most device time.
G1. gemma-2b at full width and depth (18 layers, 8 heads over 1 KV head
   of 256, bf16, random weights from seed 0) through the serve CLI's
   engine with phase 4's mix (8 greedy requests of 96 + 32 tokens, 4
   slots, page 16, chunks of 32, the base model): every ``flash_decode``
   launch on the split route; the tokens held to the port's reference
   loop ``serve()`` (dense cache, token by token, no paged kernel), each
   request's first differing position recorded; every one of the 8 x 32
   steps' logits held to the dense decode_step's on the engine's own
   tokens (teacher-forced) within ``G1_LOGITS_ATOL``, each picked
   token a near-tie there at worst; decode tok/s and TTFT; a profiled window of 8
   decode steps: busy share and ``flash_decode``'s device time.
S1. phase 4's requests with ``--spec-k 3`` (the base drafts through
   ``flash_decode``, each user's weights verify through ``flash_verify``):
   tokens held to phase 4's under the near-tie rule of
   ``_hold_to_plain``, acceptance, rounds, decode tok/s, TTFT, and the
   launches a call read off the code (24 a draft step, 24 a verify).
S2. a user with lr 1e-6 records (4 requests + 2 base): acceptance above
   0.9, fewer rounds than half the decode tokens, the plain tokens.
S4. 4 sampled requests (top-k 8) with ``--spec-k 3``: full length, two
   runs from one seed give the same tokens.
S5. phase 5's profile with ``--spec-k 3``.
T1. the train CLI (``launch.train.run``), full-width OPT-1.3B,
   ``mezo-fused``, 4 steps at B 8 x S 128: losses, step time, tokens/s,
   peak memory, launch counts, and a step-0 snapshot + replay-log restore
   bit-exact with the live parameters.
T4. one T1 step under the profiler.
T2. / T3. the Trainer with flash attention (OPT-1.3B, then RoBERTa-large,
   f32): 2 fused steps, the first loss against the materialized one.
R1. the train CLI on full-width RoBERTa-large (f32, synthetic SST-2),
   ``mezo-fused``, 4 steps at B 8 x S 128: losses, step time, tokens/s,
   peak memory, launches by body (all 290 ``zo_matmul`` launches a step
   on the SIMT body), one step under the profiler.
Q1. the frozen int8 base: OPT-1.3B (bf16) and RoBERTa-large (f32)
   quantized with no deltas; the fused loss at +-eps (every projection
   through ``zo_matmul_q``) against the loss at ``ctx.materialize``
   (every quantized leaf through ``zo_add_q``); resident bytes and the
   fused forward's peak memory.
Q2. the train CLI with ``--quant int8`` (OPT-1.3B, ``mezo-fused``, 4 steps
   at B 8 x S 128): losses, step time, tokens/s, peak memory; q and scales
   bit-frozen, deltas moved; a bit-exact snapshot + replay restore; one
   step under the profiler.
Q3. serving phase 4's requests from one int8 base holding the two
   replayed users: within 0.15 of the dense-mode engine, a user differs
   from the base, the cache charges only per-user bytes; then one user's
   compact int8 delta (``export_delta`` -> ``put_delta``) against the
   replayed user's weights, serving the same requests closer to the
   replayed user than to the base.
S3. Q3's int8 base with ``--spec-k 3``, tokens held to Q3's plain ones
   under S1's rule.
U0. ``zo_add_users`` (U = 4 stacked f32 deltas of OPT-1.3B's ``w_in`` and
   LM head), ``zo_matmul_users`` (X (4, 1024, 2048) bf16 over a shared and
   a per-lane W) and ``zo_matmul_users(scale=)`` (a shared int8 W) at the
   ``w_in`` slice and LM head shapes: against their plain versions, every
   lane against a lone scalar launch at atol 0; times, bounds, and the
   library yardstick (one cuBLAS SGEMM ``torch.bmm``, TF32 off); and a
   bf16 (4, 24, 2048, 8192) stack updated in place on lanes 0 and 2 (U1's
   use), the other lanes bit-unchanged.
U1. the ``train_fleet`` CLI at full width (OPT-1.3B, 6 users on 4 slots,
   3 fused sgd steps each, B 8 x S 128): launches a dispatch (independent
   of U), every user's losses, parameters and replay log against a lone
   Trainer at atol 0, one eviction and re-admission bit-exact; U4 one of
   its dispatches under the profiler.
U2. the same with ``--quant int8``: q and scales frozen and shared by the
   slots.
U3. the user-axis fused loss over one shared base (bf16, then a frozen int8
   base), U = 4: every lane's loss equal to the scalar fused loss.
F1-F5, the other model families at full width (bf16, random weights
from seed 0), each phase printing its seconds, peak memory, launches by
kernel and body and a profiled step or decode window's device busy
share; every fused-vs-materialized check runs the fused loss at +eps
with flash attention (every projection through ``zo_matmul``'s
tensor-core body) against the loss at ``ctx.materialize`` (plain
attention) within 2e-2:
F1. granite-moe-1b-a400m (24 layers, 32 experts top 8): the train CLI (4
   steps, B 8 x 128), fused vs materialized, two MoE dispatches of one
   input bit-equal, phase 4's requests (paged, chunked) and with
   ``--spec-k 3`` (reported: MoE windows share expert capacity).
F2. rwkv6-7b (32 layers): the train CLI (2 steps), fused vs
   materialized, serving in the dense layout (``paged=True`` has nothing
   to page): decode logits against the forward over the same tokens,
   in bf16 within 0.5 (``RWKV_BF16_ATOL``, which decodes that zero
   ``x_prev`` or the WKV state must exceed) and in f32 within 0.15;
   ``spec_k`` and ``prefill_chunk`` raise.
F3. jamba-v0.1-52b cut to one super-block (8 of 32 sublayers: 1
   attention, 7 mamba, 4 MoE of 16 experts) through the Trainer and
   ServeEngine APIs: 2 steps, every Mamba forward on the
   ``selective_scan`` kernel (4 x 7 launches), fused vs materialized (with the routing
   flips between the two forwards, again with capacity for every token
   and, below, with dense FFNs), paged serving with chunked prefill (one
   replayed user beside the base), ``spec_k`` 3 with its tokens held to
   plain under the near-tie rule save where a routing difference is
   witnessed at or before the part (``_routing_witness``), then the
   config in f32 and with dense FFNs, held to the near-tie rule.
F4. whisper-base (6 + 6 layers, 1500 frames): the train CLI with the
   ``enc_embeds`` stub (4 steps), fused vs materialized (the encoder's
   bidirectional attention on ``flash_attention``), paged serving of
   token-only requests (cross state left at zeros) held to the
   dense-layout engine under the near-tie rule.
F5. gemma-2b, qwen3-4b, chatglm3-6b, glm4-9b, pixtral-12b at 2 layers:
   fused vs materialized; a 64-token prompt in chunks of 32 and 8 decode
   steps over pages of 16 against the dense forward within 0.15, every
   attention on ``flash_prefill`` / ``flash_decode`` at the config's head
   dim (256 for gemma, 128 for the rest).
UF1-UF4, the multi-tenant step of those families at full width (bf16,
random weights from seed 0, one shared base), every lane held to a lone
``Trainer`` (or the scalar fused loss) at atol 0, each phase printing
its seconds, peak memory and launches by kernel and body:
UF1. granite-moe-1b-a400m, full depth, through the ``train_fleet`` CLI:
   6 users on 4 slots, 3 fused sgd steps each, B 8 x 128; every MoE
   dispatch routes one lane's 1024 tokens against that lane's capacity
   (recorded: some lane drops past it); every user's losses, parameters
   and replay log against a lone Trainer; one dispatch profiled.
UF2. rwkv6-7b, full depth, through the CLI: 3 users on 2 slots, 2
   steps, B 4 x 128, against lone Trainers.
UF3. jamba-v0.1-52b cut as F3 (8 sublayers): the user-axis fused loss
   over one shared 27 GB base, U = 2 lanes, each against the scalar
   fused loss, every Mamba forward one ``selective_scan`` launch over
   both lanes; peak memory.
UF4. whisper-base, full depth, through the ``TrainEngine`` with batches
   that carry ``enc_embeds`` (8 x 1500 frames): 4 users on 4 slots, 3
   steps, B 8 x 128, against lone Trainers.
FL1, A1, ST1, P1, the async fleet, the gradient baseline, the straggler
arm and the data pipeline (OPT-1.3B at full width and depth, bf16,
random weights from seed 0, B 8 x 128):
FL1. ``repro_torch.launch.fleet.run``: 24 leases applied (K 2, decay
   0.95) over 4 flagship workers, one a x5 straggler, duplicate
   deliveries every 3rd result, a join after 6 and a leave after 12
   applied updates, ``--verify-replay`` from theta_0 (max |diff| 0);
   dropped >= 1, resizes 2, staleness >= 1; the snapshot a lease held
   from version 3 on, and theta_0, bit-unchanged; launches read off the
   code, every ``zo_matmul`` on its tensor-core body; wall s, applied
   leases a wall second, peak memory, the most live parameter versions,
   and one lease evaluation under the profiler. Then 4 steps fused and
   4 with ``--estimator vmapdir`` (W' materialized through ``zo_add``):
   one schedule, losses within 2e-2.
A1. the train CLI with ``--optimizer adam`` (4 steps): the loss
   descends; step s and peak memory beside T1's MeZO peak; one Trainer
   step with int8-compressed gradients; RoBERTa-large (f32): autograd's
   gradient projected on a Rademacher z against the fused SPSA gs over
   the same z and batch at eps 1e-4 (``ADAM_SPSA_*``), the reading at
   the training eps 1e-3 beside it.
ST1. the train CLI with ``--straggler-redundancy 1 --directions 2`` (3
   steps): every record logs its 3-direction mask, launches read off the
   code, a snapshot + replay restore bit-exact.
P1. ``DataPipeline(device="cuda")``: batches bit-equal to the host's
   and read at once on the consumer's stream; ``close()`` joins a worker
   blocked on a full queue; ``next()`` after it raises.
SH1, SH2, DR1, the multi-device tier:
SH1. ``zo_add`` on every 16-way shard (as the sharding plan splits a
   16-way model axis) of OPT-1.3B's and qwen3-4b's largest stacked and
   2-D leaves, f32 and bf16, Rademacher and Gaussian, and of kimi-k2's
   expert ``w_out`` (one layer, 16 x 16 on expert and F), launched at the
   shard's global offsets, equals the whole leaf's launch sliced at atol
   0; ``zo_matmul``'s column-parallel shards equal the whole product's
   column slice and its row-parallel partial sums add up to it, within
   the kernel's limits; the plain versions at offsets hold as in phase
   3; one shard's launch is timed beside the whole leaf's.
SH2. a one-rank nccl group, a (1, 1, 1) ("pod", "data", "model") mesh:
   full-width granite-moe-1b-a400m (``moe_ep``: the expert-parallel body,
   32 experts local) and OPT-1.3B take 2 fused MeZO steps at B 8 x 128
   through DTensor params and the kernels; losses, gs and params equal
   the mesh-less steps' at atol 0 (granite-moe, were its EP combine to
   reorder a sum: losses, gs and every leaf within the limits stated at
   ``SH2_STEPS``); every ``zo_matmul`` / ``flash_attention`` launch on
   the body the dtype picks; the group is destroyed after.
DR1. ``python -m repro_torch.launch.dryrun`` in a process a cell, started
   before SH1 on the host's cores: qwen3-4b ``train_4k``, granite-moe
   ``decode_32k`` and kimi-k2 ``train_4k`` on 256 fake ranks (16 x 16);
   each cell's per-device bytes and roofline terms on a line; fails if a
   cell fails or kimi-k2's parameters exceed 80 GB a device.
EX1-EX3, the examples (``repro_torch.examples``) at full width, each
phase printing its seconds, peak memory and launches by kernel and body,
then running its example's ``main()`` at the reduced defaults with the
example's own asserts:
EX1. quickstart on OPT-1.3B (bf16, B 8 x 32, 4 of 100 steps an arm):
   MeZO (the walk, K 8, attention on ``flash_attention``'s tensor-core
   body) and Adam (autograd, plain attention): finite losses, step s,
   peak memory, the train-state bytes beyond the parameters (0 and two
   f32 moments + the count).
EX2. finetune_sst2 on RoBERTa-large (f32, 16 x 32, K 8, the walk, 20 of
   300 steps): accuracy before and after (not held), the replay log's
   bytes beside the parameters', peak memory, ``flash_attention`` on its
   SIMT body; the checkpoint (a snapshot + the log tail) restored within
   ``EX2_DRIFT_ULPS`` of the live parameters (its ``main()`` is left to
   the CPU tests).
EX3. serve_personalized on gemma-2b (bf16): two users, 10 of 30
   ``mezo-parallel`` steps each from the Trainer's seed-0 init on the
   card, their logs imported by a fresh AdapterStore, materialized ==
   trained at atol 0, the 6 interleaved requests (8 + 6 tokens) through
   a dense engine of 2 slots, each user's tokens held to ``serve()`` on
   its materialized parameters: every logits row the engine picked from
   equal at atol 0 to its recipe outside the engine (each prompt
   prefilled alone, then the dense decode_step, teacher-forced); beside
   ``serve()``'s token-by-token rows and their f32 twins, the
   differences and the near-tie gaps printed; one step profiled.
Then one ``{"kernels": [...]}`` line (each kernel with its launches on
every path above; each must have launched on one) and the final
``{"ok": true, ...}``.

Launch counts are reset just before each path and read just after, by
kernel and, for the two-body kernels, by body (``ops.BODIES``): T1-T4,
R1, Q1, U1, U3, UF1-UF4, FL1, ST1 and SH2 must run every ``zo_matmul*`` /
``flash_attention``
launch on the body the dtype picks (bf16: tensor cores, f32: SIMT; of
the tensor-core ``zo_matmul`` / ``zo_matmul_users`` launches, those on
the Hopper route are counted again as ``tc_tma``, in the phase lines and
the kernels line's ``launches_by_body``), and
the bf16 serving paths (phase 4, Q3, S1-S4, G1) every ``flash_prefill``
and ``flash_verify`` launch on its tensor-core body; ``flash_decode`` is
counted by route too (``flash_decode/slot``, ``flash_decode/split``). Any
failed check exits non-zero before the final line. Imports nothing of JAX
and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
WORK = ROOT / "build" / "chip_smoke"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
SFU_EXP_PER_S = 16 * 132 * 1.98e9   # ex2 a clock an SM, 132 SMs, boost
FMA_OPS_PER_S = 128 * 132 * 1.98e9  # FP32 lanes a clock an SM
SCAN_F32_RTOL = 1e-4     # of max|y|: fast exp (ex2.approx) and FMA
SCAN_BF16_RTOL = 2e-2    # of each |y|: four bf16 roundings (2^-8 each) lie
#                          between the two, three in the plain version
#                          (C.h + D x, silu(z), their product), one in the
#                          kernel (after the gate)
SCAN_BF16_RMS = 1e-3     # of rms(y): room for the f32 differences where
#                          y is near 0
# instructions a thread can issue a second, chip-wide: the f32 peak at two
# flops an FMA instruction (132 SMs x 128 lanes x 1.98 GHz)
INSTR_RATE = PEAK_FLOPS["f32"] / 2

# tolerances, stated before the first run on the card
ZO_GAUSS_ATOL = 1e-6     # f32 z: last ulps of logf/cosf only (no FMA)
ATTN_BF16_ATOL = 2e-2    # bf16 out: the plain version rounds probs to bf16
ATTN_F32_ATOL = 2e-5     # f32 out: summation order only
# flash_decode's tensor-core split body (bf16, G 8-16) against its own
# model (paged_attn_split_ref with P rounded to bf16): |out - model| <=
# SPLIT_TC_RTOL |model| + SPLIT_TC_ATOL[case]. The relative part is the
# output's rounding to bf16 (2^-8 of it at most); the absolute part is P
# rounded at the running max of each 16-key slice where the model rounds
# at the chunk's max, noise that averages down over more keys: measured
# at most 1.64e-3 over the short cases and 3.9e-4 over the long ones
# (NVIDIA H100 80GB HBM3, 700 W), limits 2.4x and 2.6x that. At long
# positions an output of N(0, 1) data is ~0.03, so 2e-2 against
# paged_attn_ref alone would pass a body that drops or misweighs part of
# a chunk
SPLIT_TC_RTOL = 2 ** -8
SPLIT_TC_ATOL = {"short": 4e-3, "long": 1e-3}
LOGITS_BF16_ATOL = 0.15  # 24 bf16 layers, chunked kernels vs dense plain
# G1: every logit of gemma-2b's 8 x 32 served steps (18 bf16 layers, a
# 256000-word vocabulary whose largest logits lie at 16-32, where a bf16
# step is 0.125) against the dense decode_step's on the same tokens:
# measured at most 0.1875 (NVIDIA H100 80GB HBM3, 700 W), limit 1.33x
G1_LOGITS_ATOL = 0.25
ZO_MM_F32_RTOL = 2e-5    # max|d| / max|Y|, f32 out: summation order only
ZO_MM_BF16_RTOL = 1e-2   # bf16 out: one rounding of Y (2^-8 relative)
OPT_FUSED_ATOL = 2e-2    # bf16: also the rounding of W' the materialized
#                          path does and the fused (f32 W') path does not
ROBERTA_FUSED_ATOL = 1e-4  # f32: summation order over 24 layers only
#   the same two limits hold Q1's frozen int8 base (fused f32 W' against
#   the materialized W' rounded to the leaf's dtype)
Q_EFF_ATOL = 1e-7        # + max|mat - base| / 127: one int8 step of the
#                          compact delta (tests/test_quant.py's bound, for
#                          f32 effective weights; a bf16 leaf adds one
#                          bf16 step of its own rounding)

# the training phases' shapes: full width and depth, batch 8 x 128 tokens
TRAIN_STEPS, TRAIN_B, TRAIN_S = 4, 8, 128


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_interleaved(torch, fns: dict, iters: int = 200, repeats: int = 5):
    """Median ms a call of each of ``fns`` (name -> fn, or name -> (fn,
    ctx) with ``ctx()`` a context manager held around the calls), timed in
    one process in turns: ``repeats`` rounds, each replaying every fn's
    CUDA graph of ``iters`` calls once between two CUDA events. Graph
    replays keep the host's launch cost out of the device time, so a
    kernel and its library call are compared on the card alone."""
    graphs = {}
    side = torch.cuda.Stream()
    for name, entry in fns.items():
        fn, ctx = entry if isinstance(entry, tuple) else (entry, None)
        with (ctx() if ctx else contextlib.nullcontext()):
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):          # warm-up off the graph
                fn()
                fn()
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(iters):
                    fn()
        graphs[name] = g
    torch.cuda.synchronize()
    samples: dict = {name: [] for name in fns}
    for _ in range(repeats):
        for name, g in graphs.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            samples[name].append(start.elapsed_time(end) / iters)
    del graphs
    torch.cuda.empty_cache()
    return {name: sorted(v)[len(v) // 2] for name, v in samples.items()}


def sdpa_backends(torch, call):
    """``{"sdpa_<backend>": (call, ctx)}`` for every SDPA backend that
    accepts ``call()``'s case (each one tried once under
    ``torch.nn.attention.sdpa_kernel``, eagerly and in a CUDA graph; one
    that refuses the case raises and is left out). The port calls none of
    them."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(be), warnings.catch_warnings():
                warnings.simplefilter("ignore")   # "kernel not used because"
                call()
                torch.cuda.synchronize()
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    call()
            torch.cuda.synchronize()
            del g
        except RuntimeError:
            torch.cuda.synchronize()
            continue
        out[f"sdpa_{be.name.lower()}"] = (call, lambda be=be: sdpa_kernel(be))
    check(bool(out), "no SDPA backend accepts the yardstick's case")
    return out


def kernel_vs_library(torch, kernel, library: dict, iters: int = 200):
    """The kernel and each library call through ``time_interleaved``:
    (kernel ms, fastest library ms, its name, every library ms)."""
    t = time_interleaved(torch, {"kernel": kernel, **library}, iters=iters)
    ms = t.pop("kernel")
    name = min(t, key=t.get)
    return ms, t[name], name, t


def bound(n_bytes: float, flops: float, kind: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions


# the zo_add family's timed cases (PERF.md section 6 rows 1-3): OPT-1.3B's
# two largest leaves, the stacked w_in and the LM head, as a bf16 leaf
# (zo_add), an int8 leaf with its scales (zo_add_q) and 4 stacked f32
# deltas (zo_add_users)
ZO_ADD_TIMED = (("zo_add", "blocks/mlp/w_in/w", (24, 2048, 8192)),
                ("zo_add", "lm_head/w", (2048, 50272)),
                ("zo_add_q", "blocks/mlp/w_in/w", (24, 2048, 8192)),
                ("zo_add_q", "lm_head/w", (2048, 50272)),
                ("zo_add_users", "blocks/mlp/w_in/w", (4, 24, 2048, 8192)),
                ("zo_add_users", "lm_head/w", (4, 2048, 50272)))
U_COEFFS = [1e-3, -1e-3, 2e-3, -5e-4]     # 4 lanes: both signs, 2 eps
U_SEEDS = [975318642 + 7 * i for i in range(4)]

_GAUSS_INSTR: list = []


def _hot_path_length(sass: str) -> int:
    """Instructions on a probe function's hot path in ``cuobjdump -sass``
    text: from its entry to its first EXIT, jumping over every region that
    a conditional forward branch skips when the region holds a loop (a
    backward branch) or a call -- the math library's slow paths (cosf's
    Payne-Hanek reduction for huge arguments, sqrtf's out-of-range call),
    which the probe's arguments never take."""
    import re
    code = []
    for line in sass.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if m:
            code.append((int(m.group(1), 16), m.group(2).strip()))
    at = {a: k for k, (a, _) in enumerate(code)}
    k, n = 0, 0
    while k < len(code):
        addr, text = code[k]
        n += 1
        if text == "EXIT":
            return n
        m = re.match(r"@!?U?P\d BRA (0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) > addr:
            target = int(m.group(1), 16)
            loop_or_call = False
            for a, t in code[k + 1:at[target]]:
                b = re.search(r"\bBRA (0x[0-9a-f]+)", t)
                loop_or_call |= t.startswith("CALL") or (
                    b is not None and int(b.group(1), 16) <= a)
            if loop_or_call:
                k = at[target]
                continue
        k += 1
    fail("SASS probe: no EXIT on the hot path")


def gauss_instructions() -> int:
    """Instructions Gaussian z adds to an element over Rademacher z: the
    hot paths (``_hot_path_length``) of two probe kernels built from
    ``csrc/zo_hash.cuh`` for sm_90a, each ``out[i] =
    z_from_bits(avalanche(in[i]), dist)``, Gaussian minus Rademacher
    (``cuobjdump -sass``). The Gaussian arm's operations bound."""
    if _GAUSS_INSTR:
        return _GAUSS_INSTR[0]
    import re
    out = WORK / "sass_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(
        '#include "zo_hash.cuh"\n'
        "template <int DIST>\n"
        "__global__ void probe(const unsigned* in, float* out) {\n"
        "  const int i = threadIdx.x;\n"
        "  out[i] = repro_torch::z_from_bits(repro_torch::avalanche(in[i]),"
        " DIST);\n}\n"
        "template __global__ void probe<0>(const unsigned*, float*);\n"
        "template __global__ void probe<1>(const unsigned*, float*);\n")
    cuda = Path("/usr/local/cuda/bin")
    subprocess.run([str(cuda / "nvcc"), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-cubin", "-I", str(SRC / "repro_torch" / "csrc"),
                    "-o", str(out / "probe.cubin"), str(out / "probe.cu")],
                   check=True, capture_output=True, timeout=300)
    sass = subprocess.run([str(cuda / "cuobjdump"), "-sass",
                           str(out / "probe.cubin")], check=True,
                          capture_output=True, text=True, timeout=60).stdout
    (out / "probe.sass").write_text(sass)
    by_dist = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split()[0]
        for d in (0, 1):
            if f"ILi{d}E" in name:
                by_dist[d] = _hot_path_length(part)
    check(set(by_dist) == {0, 1}, f"SASS probe: functions {list(by_dist)}")
    _GAUSS_INSTR.append(by_dist[1] - by_dist[0])
    return _GAUSS_INSTR[0]


def _zo_case(torch, name, path, shape, seed=1234567, coeff=-0.00731):
    """(call(dist, out), n elements, bytes a call moves) for one
    ZO_ADD_TIMED case, inputs from a seeded generator; ``call`` writes
    into a preallocated output (zo_add_q allocates its own)."""
    from repro_torch.core import rng
    from repro_torch.kernels import zo_perturb as zp
    from repro_torch.optim.quant import quantize_leaf
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    salt = rng.leaf_salt(path)
    w = torch.randn(shape, generator=gen, device=dev) * 0.02
    n = w.numel()
    if name == "zo_add":
        w = w.to(torch.bfloat16)
        out = torch.empty_like(w)
        return (lambda dist: zp.zo_add_cuda(w, seed, salt, coeff, dist,
                                            out=out)), n, 4.0 * n
    if name == "zo_add_q":
        ql = quantize_leaf(w.to(torch.bfloat16))
        del w
        q, sc = ql.q, ql.scale
        return (lambda dist: zp.zo_add_q_cuda(q, sc, seed, salt, coeff,
                                              dist)), n, 5.0 * n + 4.0 * \
            sc.numel()
    out = torch.empty_like(w)
    return (lambda dist: zp.zo_add_users_cuda(w, U_SEEDS, salt, U_COEFFS,
                                              dist, out=out)), n, 8.0 * n


def time_zo_add(torch, name, path, shape, iters=50,
                dists=("rademacher", "gaussian")):
    """One ZO_ADD_TIMED case: each arm of ``dists`` as CUDA-graph replays
    in turns (``time_interleaved``), each beside its bound: the bytes
    (each input read once, the output written once) over 3.35 TB/s
    against, for Rademacher z, 2 flops an element at the f32 peak (the
    rows' bound since the first port) and, for Gaussian z, the
    instructions it adds an element (``gauss_instructions``) at
    ``INSTR_RATE``."""
    call, n, n_bytes = _zo_case(torch, name, path, shape)
    t = time_interleaved(torch, {d: (lambda d=d: call(d)) for d in dists},
                         iters=iters)
    del call
    torch.cuda.empty_cache()
    b_ms, b_by = bound(n_bytes, 2.0 * n, "f32")
    row = {"shape": list(shape), "ms": t["rademacher"], "bound_ms": b_ms,
           "bound_by": b_by, "bound_share": b_ms / t["rademacher"]}
    if "gaussian" in t:
        g_instr = gauss_instructions()
        g_ms, g_by = max((n * g_instr / INSTR_RATE * 1e3, "operations"),
                         (n_bytes / HBM_BYTES_PER_S * 1e3, "bytes"))
        row.update({"gaussian_ms": t["gaussian"], "gaussian_bound_ms": g_ms,
                    "gaussian_bound_by": g_by,
                    "gaussian_instructions_an_element": g_instr})
    return row


def _zo_timed_rows(torch, name, plain):
    """``time_zo_add`` over ``name``'s ZO_ADD_TIMED cases, each with its
    plain version's ms from ``plain`` (leaf path -> ms); printed as
    kernel lines; returns the rows."""
    rows = []
    for kern, path, shape in ZO_ADD_TIMED:
        if kern != name:
            continue
        row = {"phase": "kernel", "name": name, "leaf": path,
               **time_zo_add(torch, name, path, shape),
               "plain_ms": plain[path], "library_ms": None}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def _zo_result(rows, err):
    """The kernels line's entry: the two leaves together (one sweep's main
    cost), Rademacher; the Gaussian arm beside it."""
    return {"max_abs_err": err, "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes", "library_ms": None,
            "gaussian_ms": sum(r["gaussian_ms"] for r in rows),
            "gaussian_bound_ms": sum(r["gaussian_bound_ms"] for r in rows)}


def kernel_zo_add(torch, results):
    from repro_torch.core import rng
    from repro_torch.kernels import zo_perturb as zp
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    errs, plain = [], {}
    seed, coeff = 1234567, -0.00731
    for kern, path, shape in ZO_ADD_TIMED:
        if kern != "zo_add":
            continue
        w = (torch.randn(shape, generator=gen, device=dev) * 0.02).to(
            torch.bfloat16)
        salt = rng.leaf_salt(path)
        got = zp.zo_add_cuda(w, seed, salt, coeff)
        want = zp.zo_add_ref(w, seed, salt, coeff)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(torch.equal(got, want),
              f"zo_add {shape} Rademacher not bit-exact (max err {err})")
        errs.append(err)
        del want, got
        # the Gaussian arm timed below, on the same bf16 leaf
        got = zp.zo_add_cuda(w, seed, salt, coeff, dist="gaussian")
        want = zp.zo_add_ref(w, seed, salt, coeff, dist="gaussian")
        gerr = (got.float() - want.float()).abs().max().item()
        check(gerr <= ZO_GAUSS_ATOL, f"zo_add {shape} bf16 Gaussian err "
              f"{gerr} > {ZO_GAUSS_ATOL}")
        print(json.dumps({"phase": "kernel", "name": "zo_add",
                          "dist": "gaussian", "dtype": "bfloat16",
                          "shape": list(shape), "max_abs_err": gerr,
                          "tolerance": ZO_GAUSS_ATOL}), flush=True)
        del want, got
        plain[path] = time_ms(lambda: zp.zo_add_ref(w, seed, salt, coeff),
                              iters=2, warmup=1)
        del w
        torch.cuda.empty_cache()
    # Gaussian: f32 zeros + 1.0 * z, so the output is z itself
    w = torch.zeros((2048, 8192), dtype=torch.float32, device=dev)
    salt = rng.leaf_salt("blocks/attn/wq/w")
    got = zp.zo_add_cuda(w, seed, salt, 1.0, dist="gaussian")
    want = zp.zo_add_ref(w, seed, salt, 1.0, dist="gaussian")
    gerr = (got - want).abs().max().item()
    check(gerr <= ZO_GAUSS_ATOL, f"zo_add Gaussian err {gerr} > "
          f"{ZO_GAUSS_ATOL}")
    check(abs(got.mean().item()) < 1e-2 and abs(got.std().item() - 1) < 1e-2,
          "zo_add Gaussian z is not N(0, 1)")
    print(json.dumps({"phase": "kernel", "name": "zo_add", "dist": "gaussian",
                      "dtype": "float32", "shape": [2048, 8192],
                      "max_abs_err": gerr, "tolerance": ZO_GAUSS_ATOL}),
          flush=True)
    del w, got, want
    torch.cuda.empty_cache()
    rows = _zo_timed_rows(torch, "zo_add", plain)
    results["zo_add"] = _zo_result(rows, max(errs))


def _paged_case(torch, b, ps, kvh, hd, n_live, pos, garbage):
    """Random pools with scrambled page tables; page 0 (trash) filled with
    ``garbage`` (a finite value or NaN)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    n_pages = 1 + b * n_live + 5
    k = torch.randn((n_pages, ps, kvh, hd), generator=gen, device=dev)
    v = torch.randn((n_pages, ps, kvh, hd), generator=gen, device=dev)
    k[0] = garbage
    v[0] = garbage
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    pages = torch.zeros((b, n_live), dtype=torch.int32, device=dev)
    for i, p in enumerate(pos):
        live = 1 + p // ps
        pages[i, :live] = perm[i * n_live:i * n_live + live].to(torch.int32)
    return k, v, pages, torch.tensor(pos, dtype=torch.int32, device=dev)


def _poison_unread(k, v, pages, last):
    """NaN wherever slot i's rows may not read: the trash page and, in
    each slot's last live page, the positions past ``last[i]``."""
    ps = k.shape[1]
    k[0], v[0] = float("nan"), float("nan")
    for i, t in enumerate(last):
        page = int(pages[i, t // ps])
        k[page, t % ps + 1:] = float("nan")
        v[page, t % ps + 1:] = float("nan")


def _attn_cost(q_rows_pos, kvh, g, hd, itemsize, q_numel):
    """Bytes and flops a paged attention call needs for this data: each
    row reads keys 0..qpos; K/V of a (slot, KV head) counted once at its
    longest row; q read, out written once."""
    keys = sum(max(r) + 1 for r in q_rows_pos)          # per KV head
    kv_bytes = 2 * keys * kvh * hd * itemsize
    flops = 4 * hd * g * kvh * sum(sum(p + 1 for p in r) for r in q_rows_pos)
    return kv_bytes + 2 * q_numel * itemsize, flops


ATTN_C = 32                  # the serving path's prefill chunk
# the paged kernels' correctness cases (phase 3): positions, n_live at
# page 16 (doubled at page 8): the serving path's ragged slots, the edges
# of a 64-key tile, and a long context up to OPT-1.3B's 2048 positions
ATTN_CHECKED = {"flash_decode": (([95, 110, 127, 40], 8),
                                 ([63, 64, 127, 128], 9),
                                 ([2047, 1640, 1480, 1030], 128)),
                "flash_prefill": (([64, 78, 96, 8], 8),
                                  ([63, 64, 127, 128], 11),
                                  ([2016, 1640, 1480, 1030], 128))}
# the timed cases, bf16 at OPT-1.3B's width (32 heads of 64, page 16):
# (kernel, label, positions, n_live). "B 4" keeps the shapes timed since
# the first port, "B 1" is the serving admission's prefill (one slot's
# chunk at a time), "long" a decode step at positions up to 2047
ATTN_TIMED = (("flash_decode", "B 4", [95, 110, 127, 40], 8),
              ("flash_decode", "long", [2047, 1640, 1480, 1030], 128),
              ("flash_prefill", "B 4", [64, 78, 96, 8], 8),
              ("flash_prefill", "B 1", [64], 8))


# flash_verify's timed case (S0): the speculative path's window W = k + 1
# at B 4, positions 96-127 (the row timed since the first port)
VERIFY_TIMED = ("flash_verify", "B 4", [96, 110, 124, 101], 8)


def _attn_fns(name):
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import flash_verify as fv
    if name == "flash_decode":
        return fd.flash_decode, fd.paged_attn_ref
    if name == "flash_verify":
        return fv.flash_verify, fv.verify_attn_ref
    return fp.flash_prefill, fp.prefill_attn_ref


def _attn_rows(name):
    """Query rows a slot of the timed case: one decode token, a prefill
    chunk, a verify window."""
    return {"flash_decode": 1, "flash_prefill": ATTN_C,
            "flash_verify": SPEC_K + 1}[name]


# the (heads, KV heads, head dim) of every config a family phase serves
# or trains beyond OPT-1.3B's 32 x 64: gemma-2b (MQA at 256), qwen3-4b,
# pixtral-12b and jamba (G 4 at 128), chatglm3-6b and glm4-9b (G 16 at
# 128), granite-moe (G 2 at 64), whisper-base (8 heads of 64),
# kimi-k2-1t-a32b (G 8 at 112, the one head dim not a power of two)
REAL_HEADS = {"gemma-2b": (8, 1, 256), "qwen3-4b pixtral jamba": (32, 8, 128),
              "chatglm3 glm4": (32, 2, 128), "granite-moe": (16, 8, 64),
              "whisper-base": (8, 8, 64), "kimi-k2": (64, 8, 112)}
# flash_decode timed at every G >= 2 REAL_HEADS layout (its split route),
# bf16, page 16: the B 4 positions of ATTN_TIMED ("short"; kimi-k2's is
# the row timed since head dim 112 was added) and its long context
GQA_DECODE_TIMED = (("short", [95, 110, 127, 40], 8),
                    ("long", [2047, 1640, 1480, 1030], 128))
# the split route's checks: B 8 (each slot also alone, at B 1), the
# serving path's short positions and a long context with a slot at 0 and
# at chunk edges, at pages 16 and 64 (table widths at page 16)
DECODE_SPLIT_CHECKED = {"short": ([95, 110, 127, 40, 0, 63, 64, 17], 8),
                        "long": ([2047, 1640, 1480, 1030, 0, 511, 1024,
                                  2000], 128)}


def _check_paged_case(torch, name, ps, pos, n_live16, h, kvh, hd, dt, tol,
                      gen):
    """One paged-kernel case against its plain version: within ``tol``,
    finite, two calls bit-equal, NaN in the trash page and in each slot's
    unread last-page tail leaving the output bit-equal, every prefill
    launch on the body its dtype picks. Returns the max error."""
    from repro_torch.kernels import build
    dev = torch.device("cuda")
    kern, ref = _attn_fns(name)
    c = 1 if name == "flash_decode" else ATTN_C
    n_live = n_live16 * 16 // ps
    last = [p + c - 1 for p in pos]
    b = len(pos)
    label = f"{name} {dt} page {ps} H {h} KV {kvh} hd {hd} pos {pos}"
    k, v, pages, _ = _paged_case(torch, b, ps, kvh, hd, n_live, last, 1e4)
    k, v = k.to(dt), v.to(dt)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    q_shape = (b, h, hd) if c == 1 else (b, c, h, hd)
    q = torch.randn(q_shape, generator=gen, device=dev).to(dt)
    body = "tc" if dt == torch.bfloat16 else "simt"
    before = dict(build.BODIES)
    got = kern(q, k, v, pages, pos_t)
    if name == "flash_prefill":
        moved = {bb: build.BODIES[f"{name}/{bb}"] - before[f"{name}/{bb}"]
                 for bb in ("tc", "simt")}
        check(moved[body] == 1 and sum(moved.values()) == 1,
              f"{label}: bodies {moved}, expected one {body}")
    want = ref(q, k, v, pages, pos_t)
    err = (got.float() - want.float()).abs().max().item()
    check(err <= tol and torch.isfinite(got).all().item(),
          f"{label}: max err {err} > {tol}")
    check(torch.equal(kern(q, k, v, pages, pos_t), got),
          f"{label}: two calls differ")
    _poison_unread(k, v, pages, last)
    check(torch.equal(kern(q, k, v, pages, pos_t), got),
          f"{label}: NaN where no row reads reached the output")
    return err


def check_paged_attention(torch):
    """Each paged kernel against its plain version (``_check_paged_case``)
    at pages 8 and 16, f32 and bf16, 32 heads of 64 over KV 32 (G 1) and
    8 (G 4), on every ATTN_CHECKED case; then at page 16 on the first two
    cases at each REAL_HEADS layout. Returns the worst error by kernel
    and dtype."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    dtypes = ((torch.float32, ATTN_F32_ATOL), (torch.bfloat16, ATTN_BF16_ATOL))
    errs: dict = {}
    real: dict = {}
    for name, cases in ATTN_CHECKED.items():
        for ps in (16, 8):
            for pos, n_live16 in cases:
                for kvh in (32, 8):
                    for dt, tol in dtypes:
                        err = _check_paged_case(torch, name, ps, pos,
                                                n_live16, 32, kvh, 64, dt,
                                                tol, gen)
                        key = (name, str(dt).split(".")[-1])
                        errs[key] = max(errs.get(key, 0.0), err)
        for arch, (h, kvh, hd) in REAL_HEADS.items():
            for pos, n_live16 in cases[:2]:
                for dt, tol in dtypes:
                    err = _check_paged_case(torch, name, 16, pos, n_live16,
                                            h, kvh, hd, dt, tol, gen)
                    key = (name, str(dt).split(".")[-1])
                    errs[key] = max(errs.get(key, 0.0), err)
                    rk = f"{name} {arch} {key[1]}"
                    real[rk] = max(real.get(rk, 0.0), err)
    print(json.dumps({"phase": "kernel checks", "name": "paged attention",
                      "cases": {n: [p for p, _ in cs]
                                for n, cs in ATTN_CHECKED.items()},
                      "page_sizes": [16, 8], "kv_heads": [32, 8],
                      "real_heads": REAL_HEADS,
                      "max_abs_err": {f"{n} {d}": e
                                      for (n, d), e in errs.items()},
                      "max_abs_err_real_heads": real,
                      "tolerance_f32": ATTN_F32_ATOL,
                      "tolerance": ATTN_BF16_ATOL}), flush=True)
    return errs


def time_paged_attention(torch, name, pos, n_live, checked=True,
                         heads=(32, 32, 64), context=True):
    """One ATTN_TIMED case in bf16 at ``heads`` (H, KV, hd; OPT-1.3B's by
    default): the kernel, its plain version, every
    SDPA backend over K/V gathered to logical order beforehand (the
    yardstick, as for every other attention row) and, as context only
    (``context``), every backend with the page gather and transposes
    inside the timed graph. ``checked``:
    the kernel's output is held to the plain version's first (off only
    for a deliberately patched tree, ``scripts/paged_attn_ablation.py``)."""
    import torch.nn.functional as F
    kern, ref = _attn_fns(name)
    dev = torch.device("cuda")
    h, kvh, hd = heads
    ps = 16
    b = len(pos)
    rows = _attn_rows(name)
    k, v, pages, _ = _paged_case(torch, b, ps, kvh, hd, n_live,
                                 [p + rows - 1 for p in pos], 0.0)
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    q_shape = (b, h, hd) if rows == 1 else (b, rows, h, hd)
    q = torch.randn(q_shape, generator=gen, device=dev).to(torch.bfloat16)
    err = (kern(q, k, v, pages, pos_t).float()
           - ref(q, k, v, pages, pos_t).float()).abs().max().item()
    check(err <= ATTN_BF16_ATOL or not checked,
          f"{name} timed case {pos}: err {err}")
    plain = time_ms(lambda: ref(q, k, v, pages, pos_t), iters=20)
    pl = pages.long()
    t = n_live * ps
    qpos = pos_t.long()[:, None] + torch.arange(rows, device=dev)
    mask = (torch.arange(t, device=dev)[None, None, :]
            <= qpos[:, :, None])[:, None]               # (B, 1, rows, T)
    qq = q.reshape(b, rows, h, hd).transpose(1, 2).contiguous()
    kk = k[pl].reshape(b, t, kvh, hd).transpose(1, 2).contiguous()
    vv = v[pl].reshape(b, t, kvh, hd).transpose(1, 2).contiguous()

    def gathered():
        kg = k[pl].reshape(b, t, kvh, hd).transpose(1, 2)
        vg = v[pl].reshape(b, t, kvh, hd).transpose(1, 2)
        return F.scaled_dot_product_attention(
            q.reshape(b, rows, h, hd).transpose(1, 2), kg, vg,
            attn_mask=mask, enable_gqa=kvh != h)

    library = sdpa_backends(torch, lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask, enable_gqa=kvh != h))
    context = ({f"gather_{n}": e for n, e in
                sdpa_backends(torch, gathered).items()} if context else {})
    times = time_interleaved(torch, {"kernel": lambda: kern(
        q, k, v, pages, pos_t), **library, **context})
    ms = times.pop("kernel")
    lib_all = {n: times[n] for n in library}
    lib_name = min(lib_all, key=lib_all.get)
    rows_pos = [[p + r for r in range(rows)] for p in pos]
    n_bytes, flops = _attn_cost(rows_pos, kvh, h // kvh, hd, 2, q.numel())
    b_ms, b_by = bound(n_bytes + 8 * b, flops, "bf16")
    return {"shape": list(q_shape), "heads": [h, kvh, hd], "pos": pos,
            "page_size": ps,
            "n_live": n_live, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "library_ms": lib_all[lib_name],
            "library": lib_name, "library_ms_by_call": lib_all,
            "gather_sdpa_ms_by_call": {n: times[n] for n in context},
            "bound_ms": b_ms, "bound_by": b_by}


def kernel_attention(torch, results):
    errs = check_paged_attention(torch)
    for name, label, pos, n_live in ATTN_TIMED:
        row = time_paged_attention(torch, name, pos, n_live)
        print(json.dumps({"phase": "kernel", "name": name, "case": label,
                          **row, "max_abs_err_f32": errs[(name, "float32")],
                          "tolerance_f32": ATTN_F32_ATOL,
                          "tolerance": ATTN_BF16_ATOL}), flush=True)
        if label == "B 4":                  # the kernels line's row
            results[name] = {**{k: row[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library")}, "max_abs_err": errs[(name, "bfloat16")],
                "cases": {}}
        results[name]["cases"][label] = {k: row[k] for k in (
            "ms", "library_ms", "library", "bound_ms", "plain_ms")}
    # flash_decode at every G >= 2 layout (the split route), flash_prefill
    # at every layout
    split_errs = check_decode_split(torch)
    for arch, heads in REAL_HEADS.items():
        cases = [("flash_prefill", f"{arch} B 4", *ATTN_TIMED[2][2:])]
        if heads[0] != heads[1]:
            cases = [("flash_decode", f"{arch} {label}", pos, n_live)
                     for label, pos, n_live in GQA_DECODE_TIMED] + cases
        for name, label, pos, n_live in cases:
            row = time_paged_attention(torch, name, pos, n_live, heads=heads,
                                       context=False)
            print(json.dumps({"phase": "kernel", "name": name, "case": label,
                              **row, "tolerance": ATTN_BF16_ATOL}),
                  flush=True)
            results[name]["cases"][label] = {k: row[k] for k in (
                "ms", "library_ms", "library", "bound_ms", "plain_ms")}
    results["flash_decode"]["max_abs_err"] = max(
        results["flash_decode"]["max_abs_err"],
        *[e for (_, d), e in split_errs.items() if d == "bfloat16"])


def check_decode_split(torch):
    """``flash_decode`` at every REAL_HEADS layout (G >= 2: the split
    route, its tensor-core body for bf16 at G 8-16; G = 1: the slot
    route; as ``build.BODIES`` counts) against its
    plain version, f32 and bf16, DECODE_SPLIT_CHECKED's B 8 cases at
    pages 16 and 64: within the attention limits, finite, two calls
    bit-equal, NaN in the trash page and past each slot's position
    leaving the output bit-equal, and each slot alone (B 1) bit-equal to
    its row at B 8. Returns the worst error by (layout, dtype)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as fd
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    errs: dict = {}
    tc_model: dict = {}             # label: (max |err|, max excess)
    for arch, (h, kvh, hd) in REAL_HEADS.items():
        route = "slot" if h == kvh else "split"
        for case, (pos, n_live16) in DECODE_SPLIT_CHECKED.items():
            for ps in (16, 64):
                n_live = n_live16 * 16 // ps
                k0, v0, pages, pos_t = _paged_case(torch, len(pos), ps, kvh,
                                                   hd, n_live, pos, 1e4)
                q0 = torch.randn((len(pos), h, hd), generator=gen,
                                 device=dev)
                for dt, tol in ((torch.float32, ATTN_F32_ATOL),
                                (torch.bfloat16, ATTN_BF16_ATOL)):
                    q, k, v = q0.to(dt), k0.clone().to(dt), v0.clone().to(dt)
                    d = str(dt).split(".")[-1]
                    label = (f"flash_decode {arch} {d} {case} page {ps}")
                    tc = dt == torch.bfloat16 and 8 <= h // kvh <= 16
                    before = dict(build.BODIES)
                    got = fd.flash_decode(q, k, v, pages, pos_t)
                    moved = {r: build.BODIES[f"flash_decode/{r}"] - before[
                        f"flash_decode/{r}"] for r in ("slot", "split",
                                                       "split_tc")}
                    check(moved == {"slot": route == "slot",
                                    "split": route == "split",
                                    "split_tc": tc},
                          f"{label}: routes {moved}, expected {route}"
                          f"{' on tensor cores' if tc else ''}")
                    want = fd.paged_attn_ref(q, k, v, pages, pos_t)
                    err = (got.float() - want.float()).abs().max().item()
                    check(err <= tol and torch.isfinite(got).all().item(),
                          f"{label}: max err {err} > {tol}")
                    check(torch.equal(fd.flash_decode(q, k, v, pages, pos_t),
                                      got), f"{label}: two calls differ")
                    if tc:          # its own model: P rounded as it rounds
                        model = fd.paged_attn_split_ref(q, k, v, pages, pos_t,
                                                        round_p=True)
                        diff = (got.float() - model).abs()
                        over = (diff - SPLIT_TC_RTOL * model.abs()).max()
                        tc_model[label] = (diff.max().item(), over.item(),
                                           SPLIT_TC_ATOL[case])
                    for i in range(len(pos)):
                        one = fd.flash_decode(
                            q[i:i + 1].contiguous(), k, v,
                            pages[i:i + 1].contiguous(),
                            pos_t[i:i + 1].contiguous())
                        check(torch.equal(one[0], got[i]),
                              f"{label}: slot {i} alone differs from B 8")
                    _poison_unread(k, v, pages, pos)
                    check(torch.equal(fd.flash_decode(q, k, v, pages, pos_t),
                                      got),
                          f"{label}: NaN where no row reads reached the "
                          f"output")
                    key = (arch, d)
                    errs[key] = max(errs.get(key, 0.0), err)
                del k0, v0, q0, k, v, q
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "kernel checks", "name": "flash_decode routes",
                      "cases": DECODE_SPLIT_CHECKED, "page_sizes": [16, 64],
                      "real_heads": REAL_HEADS,
                      "max_abs_err": {f"{a} {d}": e
                                      for (a, d), e in errs.items()},
                      "batch_invariant": True, "two_calls_bit_equal": True,
                      "tolerance_f32": ATTN_F32_ATOL,
                      "tolerance": ATTN_BF16_ATOL,
                      "tc_vs_rounded_model": {
                          lb: {"max_abs_err": e, "max_excess": x}
                          for lb, (e, x, _) in tc_model.items()},
                      "tc_rtol": SPLIT_TC_RTOL,
                      "tc_atol": SPLIT_TC_ATOL}), flush=True)
    for lb, (e, x, atol) in tc_model.items():
        check(x <= atol,
              f"{lb}: the tensor-core body is {e} from its rounded model, "
              f"{x} past {SPLIT_TC_RTOL} x |model| > {atol}")
    n_tc = sum(8 <= h // kvh <= 16 for h, kvh, _ in REAL_HEADS.values())
    check(len(tc_model) == n_tc * len(DECODE_SPLIT_CHECKED) * 2,
          f"the tensor-core body was held to its model in {len(tc_model)} "
          f"cases")
    return errs


def _mm_row(bf16, m, k, n, n_bytes, lanes, t, gauss=False):
    """The timing and bound keys of a ``zo_matmul``-family row: kernel
    and library (cuBLAS SGEMM, TF32 off) ms from ``time_interleaved``, the
    bf16 cuBLAS product of the unperturbed W as the product's floor
    (context, not the yardstick), the bound at the peak of the body that
    runs (bf16 X, Rademacher z: bf16 tensor cores; else the SIMT body's
    f32 FMAs, with ``gauss`` the instructions Gaussian z adds a weight,
    ``gauss_instructions``, beside them at ``INSTR_RATE``) and the SIMT
    body's f32 bound beside it."""
    flops = 2.0 * lanes * m * k * n
    tc = bf16 and not gauss
    b_ms, b_by = bound(n_bytes, flops, "bf16" if tc else "f32")
    row = {"body": "tc" if tc else "simt", "kernel_ms": t["kernel"],
           "library_ms": t["sgemm"], "library": "sgemm",
           "cublas_bf16_ms": t.get("cublas_bf16"), "bound_ms": b_ms,
           "bound_by": b_by,
           "bound_f32_simt_ms": bound(n_bytes, flops, "f32")[0]}
    if gauss:
        instr = gauss_instructions()
        row["bound_ms"] = max(b_ms, (flops / 2 + lanes * k * n * instr) /
                              INSTR_RATE * 1e3)
        row["gauss_instructions_a_weight"] = instr
    return row


def _mm_result(rows, opt):
    """The kernels line's entry: OPT-1.3B's two shapes summed (one w_in
    slice and the LM head), as zo_add's row sums its two largest leaves."""
    return {"max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["kernel_ms"] for r in opt),
            "plain_ms": sum(r["plain_ms"] for r in opt),
            "bound_ms": sum(r["bound_ms"] for r in opt),
            "bound_by": "operations",
            "library_ms": sum(r["library_ms"] for r in opt),
            "library": "sgemm",
            "cublas_bf16_ms": sum(r["cublas_bf16_ms"] for r in opt),
            "bound_f32_simt_ms": sum(r["bound_f32_simt_ms"] for r in opt)}


# T0's SIMT body cases beside OPT-1.3B's two tensor-core shapes (PERF.md
# section 6, row 4-f32): RoBERTa-large's three projection shapes at B 8 x
# 128 (f32 X), and the Gaussian arm at OPT-1.3B's w_in slice (bf16 X):
# (label, M, K, N, dtype, dist timed, leaf path, layer)
SIMT_MM_TIMED = (
    ("roberta wq", 1024, 1024, 1024, "float32", "rademacher",
     "blocks/attn/wq/w", 5),
    ("roberta w_in slice", 1024, 1024, 4096, "float32", "rademacher",
     "blocks/mlp/w_in/w", 5),
    ("roberta w_out", 1024, 4096, 1024, "float32", "rademacher",
     "blocks/mlp/w_out/w", 5),
    ("opt w_in slice gaussian", 1024, 2048, 8192, "bfloat16", "gaussian",
     "blocks/mlp/w_in/w", 5))


def mm_case(torch, gen, m, k, n, dt, path, layer, seed=987654321):
    """x (M, K), w (K, N) of ``dt`` from ``gen`` and the kernel's keyword
    arguments: the leaf's seed and salt, or a layer slice's prehashed
    base (prime offset 1)."""
    from repro_torch.core import rng
    x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
    w = (torch.randn((k, n), generator=gen, device="cuda") * 0.02).to(dt)
    salt = rng.leaf_salt(path)
    if layer is None:
        kw = dict(seed=seed, salt=salt, prime_offset=0, prehashed=False)
    else:
        kw = dict(seed=rng.fold_leading(rng.leaf_base(seed, salt), layer),
                  salt=0, prime_offset=1, prehashed=True)
    return x, w, kw


def mm_library(torch, x, w, coeff, dist, kw):
    """The yardstick's operands: f32 X and W' = W + c z materialized."""
    from repro_torch.kernels import zo_perturb as zp
    z = zp.tile_z(kw["seed"], kw["salt"], tuple(w.shape), 0, 0, dist,
                  kw["prime_offset"], kw["prehashed"], device=w.device)
    wp = w.float() + torch.tensor(coeff, dtype=torch.float32,
                                  device=w.device) * z
    return x.float(), wp


def kernel_zo_matmul(torch, results):
    """T0: ``zo_matmul`` at the training path's shapes against its plain
    version; the library yardstick is cuBLAS SGEMM (TF32 off) of
    ``X.float() @ W'`` on a W' materialized beforehand. OPT-1.3B's bf16
    shapes run the tensor-core body, ``SIMT_MM_TIMED`` the SIMT body."""
    from repro_torch.kernels import zo_perturb as zp
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    coeff = 1e-3
    cases = [  # (name, M, K, N, dtype, leaf path, layer or None, dist)
        ("opt w_in slice", 1024, 2048, 8192, torch.bfloat16,
         "blocks/mlp/w_in/w", 5, "rademacher"),
        ("opt lm_head", 1024, 2048, 50272, torch.bfloat16, "lm_head/w",
         None, "rademacher")] + [
        (label, m, k, n, getattr(torch, dt), path, layer, dist)
        for label, m, k, n, dt, dist, path, layer in SIMT_MM_TIMED]
    rows = []
    for label, m, k, n, dt, path, layer, dist in cases:
        x, w, kw = mm_case(torch, gen, m, k, n, dt, path, layer)
        tol = ZO_MM_F32_RTOL if dt == torch.float32 else ZO_MM_BF16_RTOL
        errs, abs_err = {}, 0.0
        for d in ("rademacher", "gaussian"):
            got = zp.zo_matmul_cuda(x, w, coeff=coeff, dist=d, **kw)
            want = zp.zo_matmul_ref(x, w, coeff=coeff, dist=d, **kw)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs().max()
            err = (diff / want.float().abs().max()).item()
            check(err <= tol and torch.isfinite(got).all().item(),
                  f"zo_matmul {label} {d}: max|d|/max|Y| {err} > {tol}")
            errs[d] = err
            abs_err = max(abs_err, diff.item())
            del got, want
        plain = time_ms(lambda: zp.zo_matmul_ref(x, w, coeff=coeff,
                                                 dist=dist, **kw),
                        iters=2, warmup=1)
        xf, wp = mm_library(torch, x, w, coeff, dist, kw)
        t = time_interleaved(torch, {
            "kernel": lambda: zp.zo_matmul_cuda(x, w, coeff=coeff,
                                                dist=dist, **kw),
            "sgemm": lambda: xf @ wp,
            **({"cublas_bf16": lambda: x @ w} if dt == torch.bfloat16
               else {})})
        del wp, xf
        row = {"phase": "kernel", "name": "zo_matmul", "case": label,
               "shape": [m, k, n], "dtype": str(dt).split(".")[-1],
               "dist": dist,
               **_mm_row(dt == torch.bfloat16, m, k, n,
                         (m * k + k * n + m * n) * x.element_size(), 1, t,
                         gauss=dist == "gaussian"),
               "rel_err_rademacher": errs["rademacher"],
               "rel_err_gaussian": errs["gaussian"], "tolerance": tol,
               "max_abs_err": abs_err, "plain_ms": plain}
        if row["body"] == "simt":
            row["tile"] = list(zp.simt_tile(m, n))
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, w
        torch.cuda.empty_cache()
    # the families' narrow projections, checked and not timed: jamba's
    # x_proj (di 8192 -> dt_rank + 2 * d_state = 288) at B 8 x 128 and
    # whisper-base's encoder wq (512 -> 512) at B 8 x 1500
    for label, m, k, n, path, layer in (
            ("jamba x_proj", 1024, 8192, 288, "blocks/sub_1/mamba/x_proj/w",
             1),
            ("whisper enc wq", 12000, 512, 512, "enc_blocks/attn/wq/w", 2)):
        x, w, kw = mm_case(torch, gen, m, k, n, torch.bfloat16, path,
                           layer)
        errs, abs_err = {}, 0.0
        for dist in ("rademacher", "gaussian"):
            got = zp.zo_matmul_cuda(x, w, coeff=coeff, dist=dist, **kw)
            want = zp.zo_matmul_ref(x, w, coeff=coeff, dist=dist, **kw)
            diff = (got.float() - want.float()).abs().max()
            err = (diff / want.float().abs().max()).item()
            check(err <= ZO_MM_BF16_RTOL and torch.isfinite(got).all().item(),
                  f"zo_matmul {label} {dist}: max|d|/max|Y| {err} > "
                  f"{ZO_MM_BF16_RTOL}")
            errs[dist] = err
            abs_err = max(abs_err, diff.item())
        row = {"phase": "kernel checks", "name": "zo_matmul", "case": label,
               "shape": [m, k, n], "dtype": "bfloat16",
               "rel_err_rademacher": errs["rademacher"],
               "rel_err_gaussian": errs["gaussian"],
               "tolerance": ZO_MM_BF16_RTOL, "max_abs_err": abs_err}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, w, got, want
    torch.cuda.empty_cache()
    results["zo_matmul"] = _mm_result(rows, rows[:2])
    results["zo_matmul"]["cases"] = {   # the SIMT body's timed cases
        r["case"]: {k: r[k] for k in ("body", "kernel_ms", "library_ms",
                                      "bound_ms", "plain_ms")}
        for r in rows[2:] if "kernel_ms" in r}


def _flash_cost(b, s, t, h, kvh, hd, causal, item):
    """Bytes (q, k, v read once, out written once) and flops (q.k and
    p.v, 2 * hd each, over the live (row, key) pairs)."""
    pairs = (sum(min(i + 1, t) for i in range(s)) if causal else s * t)
    flops = 4.0 * hd * b * h * pairs
    n_bytes = (2 * b * s * h * hd + 2 * b * t * kvh * hd) * item
    return n_bytes, flops


def scan_bound_s(b, s, di, n):
    """Least time of one Mamba layer's scan (``perfbench/flops_hybrid.py``
    counts it so): the larger of its least bytes (x, z, y, dt's input, B,
    C at 2 bytes) over HBM and its ``b s di n`` exponentials, each with 2
    FP32 operations beside it, split between the SFUs and the FP32 pipe
    (3 operations an exponential there) so that both finish together."""
    n_bytes = 2 * b * s * (3 * di + di // 32 + 2 * n)
    n_exp = b * s * di * n
    x = min(1.0, SFU_EXP_PER_S * 5 / (FMA_OPS_PER_S + 3 * SFU_EXP_PER_S))
    compute = max(x * n_exp / SFU_EXP_PER_S,
                  ((1 - x) * 3 + 2) * n_exp / FMA_OPS_PER_S)
    by = "bytes" if n_bytes / HBM_BYTES_PER_S >= compute else "arithmetic"
    return max(n_bytes / HBM_BYTES_PER_S, compute), by


def kernel_selective_scan(torch, results):
    """T0: ``selective_scan`` against its plain version at the Jamba
    cell's shape (one Mamba layer of B 2 x S 4096), f32 and bf16, timed
    beside it in bf16."""
    from repro_torch.kernels import selective_scan as ss
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    b, s, di, n = 2, 4096, 8192, 16

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std
    xz32 = rnd(b, s, 2 * di)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=dev)).expand(di, n).contiguous()
    rest = (rnd(b, s, di, std=0.3), rnd(di, std=0.1), a_log, rnd(b, s, n),
            rnd(b, s, n), torch.ones(di, device=dev))
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        xz = xz32.to(dtype)
        args = (xz[..., :di].contiguous(), *rest, xz[..., di:])
        got, _ = ss.selective_scan_cuda(*args)
        want, _ = ss.selective_scan_ref(*args)
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        err = (got - want).abs()
        scale = want.abs().max().item()
        ok = torch.isfinite(got).all().item()
        if dtype == torch.float32:
            ok = ok and err.max().item() <= SCAN_F32_RTOL * scale
        else:
            rms = want.square().mean().sqrt().item()
            ok = ok and bool((err <= SCAN_BF16_RTOL * want.abs()
                              + SCAN_BF16_RMS * rms).all())
        key = str(dtype).split(".")[1]
        errs[key] = {"max_abs_err": err.max().item(), "max_abs_y": scale,
                     "max_err_over_y": (err / want.abs().clamp_min(
                         1e-30)).max().item() if key == "bfloat16" else None}
        check(ok, f"selective_scan {key}: {errs[key]} out of its limits")
        del got, want, err
    plain = time_ms(lambda: ss.selective_scan_ref(*args), iters=1,
                    warmup=1)
    ms = time_interleaved(torch, {"kernel": lambda: ss.selective_scan_cuda(
        *args)}, iters=20)["kernel"]
    bound_s, by = scan_bound_s(b, s, di, n)
    row = {"phase": "kernel", "name": "selective_scan",
           "shape": [b, s, di, n], "dtype": "bfloat16", "errors": errs,
           "tolerance": {"f32_of_max_y": SCAN_F32_RTOL,
                         "bf16_of_y": SCAN_BF16_RTOL,
                         "bf16_of_rms_y": SCAN_BF16_RMS},
           "kernel_ms": ms, "plain_ms": plain, "bound_ms": bound_s * 1e3,
           "bound_by": by, "library_ms": None}
    print(json.dumps(row), flush=True)
    results["selective_scan"] = {
        "max_abs_err": errs["bfloat16"]["max_abs_err"], "ms": ms,
        "plain_ms": plain, "bound_ms": bound_s * 1e3, "bound_by": by,
        "library_ms": None, "library": "none"}
    del args, xz, xz32, rest
    torch.cuda.empty_cache()


# T0's f32 (SIMT body) attention, timed (PERF.md section 6, row 8-f32):
# RoBERTa-large's bidirectional attention at B 8 x 128, 16 heads of 64:
# (label, B, S, H, KV, hd, causal)
SIMT_ATTN_TIMED = (("roberta bidirectional", 8, 128, 16, 16, 64, False),)


def kernel_flash_attention(torch, results):
    """T0: ``flash_attention`` against its plain version; the library
    yardstick is ``F.scaled_dot_product_attention`` on the same tensors."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    cases = [  # (label, B, S, H, KV, hd, causal, dtype)
        ("opt causal", 8, 128, 32, 32, 64, True, torch.bfloat16),
        *[c + (torch.float32,) for c in SIMT_ATTN_TIMED],
        ("ragged gqa causal", 3, 100, 8, 2, 16, True, torch.float32),
        ("ragged gqa bidirectional", 3, 100, 8, 2, 16, False,
         torch.bfloat16),
        # the families' training shape (B 8 x 128, causal) at every
        # REAL_HEADS layout
        *[(f"{arch} causal", 8, 128, *heads, True, torch.bfloat16)
          for arch, heads in REAL_HEADS.items()]]
    rows = []
    for label, b, s, h, kvh, hd, causal, dt in cases:
        q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dt)
        k = torch.randn((b, s, kvh, hd), generator=gen, device=dev).to(dt)
        v = torch.randn((b, s, kvh, hd), generator=gen, device=dev).to(dt)
        got = fa.flash_attention_cuda(q, k, v, causal)
        want = fa.flash_attention_ref(q, k, v, causal)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = ATTN_F32_ATOL if dt == torch.float32 else ATTN_BF16_ATOL
        check(err <= tol and torch.isfinite(got).all().item(),
              f"flash_attention {label}: max err {err} > {tol}")
        plain = time_ms(lambda: fa.flash_attention_ref(q, k, v, causal),
                        iters=10)
        qq, kk, vv = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms, lib, lib_name, lib_all = kernel_vs_library(
            torch, lambda: fa.flash_attention_cuda(q, k, v, causal),
            sdpa_backends(torch, lambda: F.scaled_dot_product_attention(
                qq, kk, vv, is_causal=causal, enable_gqa=kvh != h)))
        n_bytes, flops = _flash_cost(b, s, s, h, kvh, hd, causal,
                                     q.element_size())
        # bf16 runs the tensor-core body: the bound at the bf16 peak; the
        # SIMT body's f32 bound beside it
        bf16 = dt == torch.bfloat16
        b_ms, b_by = bound(n_bytes, flops, "bf16" if bf16 else "f32")
        row = {"phase": "kernel", "name": "flash_attention", "case": label,
               "shape": [b, s, h, kvh, hd], "causal": causal,
               "dtype": str(dt).split(".")[-1],
               "body": "tc" if bf16 else "simt", "max_abs_err": err,
               "tolerance": tol, "kernel_ms": ms, "plain_ms": plain,
               "library_ms": lib, "library": lib_name,
               "library_ms_by_call": lib_all, "bound_ms": b_ms,
               "bound_by": b_by,
               "bound_f32_simt_ms": bound(n_bytes, flops, "f32")[0]}
        print(json.dumps(row), flush=True)
        rows.append(row)
    # the families' training shapes (B 8 x 128, causal) at REAL_HEADS,
    # and whisper-base's encoder (B 8 x 1500, bidirectional): checked,
    # not timed
    real = {}
    for arch, (h, kvh, hd) in REAL_HEADS.items():
        for dt, tol in ((torch.float32, ATTN_F32_ATOL),
                        (torch.bfloat16, ATTN_BF16_ATOL)):
            s, causal = ((1500, False) if arch == "whisper-base"
                         and dt == torch.bfloat16 else (128, True))
            q = torch.randn((8, s, h, hd), generator=gen, device=dev).to(dt)
            k = torch.randn((8, s, kvh, hd), generator=gen,
                            device=dev).to(dt)
            v = torch.randn((8, s, kvh, hd), generator=gen,
                            device=dev).to(dt)
            got = fa.flash_attention_cuda(q, k, v, causal)
            err = (got.float() - fa.flash_attention_ref(q, k, v, causal)
                   .float()).abs().max().item()
            label = f"flash_attention {arch} S {s} {dt}"
            check(err <= tol and torch.isfinite(got).all().item(),
                  f"{label}: max err {err} > {tol}")
            real[f"{arch} S {s} {str(dt).split('.')[-1]}"] = err
            del q, k, v, got
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "kernel checks", "name": "flash_attention",
                      "real_heads": REAL_HEADS, "batch": 8,
                      "max_abs_err": real, "tolerance_f32": ATTN_F32_ATOL,
                      "tolerance": ATTN_BF16_ATOL}), flush=True)
    main = rows[0]                       # the OPT-1.3B training shape
    results["flash_attention"] = {
        "max_abs_err": max([main["max_abs_err"]] + [
            e for c, e in real.items() if c.endswith("bfloat16")]),
        "ms": main["kernel_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "library": main["library"],
        "cases": {r["case"]: {k: r[k] for k in (
            "kernel_ms", "library_ms", "library", "bound_ms", "plain_ms")}
            for r in rows[1:]}}


def kernel_zo_add_q(torch, results):
    """Q0: ``zo_add_q`` on OPT-1.3B's two largest leaves quantized (the
    stacked ``w_in`` and the LM head) against its plain version; no
    library call computes it."""
    from repro_torch.core import rng
    from repro_torch.kernels import zo_perturb as zp
    from repro_torch.optim.quant import quantize_leaf
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    seed, coeff = 24681357, 0.00513
    plain, worst = {}, 0.0
    shapes = {path: shape for kern, path, shape in ZO_ADD_TIMED
              if kern == "zo_add_q"}
    for path, shape in shapes.items():
        ql = quantize_leaf((torch.randn(shape, generator=gen, device=dev)
                            * 0.02).to(torch.bfloat16))
        q, sc, salt = ql.q, ql.scale, rng.leaf_salt(path)
        errs = {}
        for dist in ("rademacher", "gaussian"):
            got = zp.zo_add_q_cuda(q, sc, seed, salt, coeff, dist)
            want = zp.zo_add_q_ref(q, sc, seed, salt, coeff, dist)
            torch.cuda.synchronize()
            errs[dist] = (got - want).abs().max().item()
            if dist == "rademacher":
                check(torch.equal(got, want), f"zo_add_q {shape} Rademacher "
                      f"not bit-exact (max err {errs[dist]})")
            else:
                check(errs[dist] <= ZO_GAUSS_ATOL, f"zo_add_q {shape} "
                      f"Gaussian err {errs[dist]} > {ZO_GAUSS_ATOL}")
            del got, want
        plain[path] = time_ms(lambda: zp.zo_add_q_ref(q, sc, seed, salt,
                                                      coeff),
                              iters=2, warmup=1)
        print(json.dumps({"phase": "kernel checks", "name": "zo_add_q",
                          "shape": list(shape),
                          "max_abs_err_rademacher": errs["rademacher"],
                          "max_abs_err_gaussian": errs["gaussian"],
                          "tolerance_gaussian": ZO_GAUSS_ATOL}), flush=True)
        worst = max(worst, errs["rademacher"])
        del ql, q, sc
        torch.cuda.empty_cache()
    rows = _zo_timed_rows(torch, "zo_add_q", plain)
    results["zo_add_q"] = _zo_result(rows, worst)


def kernel_zo_matmul_q(torch, results):
    """Q0: ``zo_matmul_q`` at the frozen-base forward's shapes against its
    plain version; the library yardstick is cuBLAS SGEMM (TF32 off) of
    ``X.float() @ W'``, W' = q * s + c * z materialized beforehand."""
    from repro_torch.core import rng
    from repro_torch.kernels import zo_perturb as zp
    from repro_torch.optim.quant import quantize_leaf
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    seed, coeff = 135792468, -1e-3
    cases = [  # (name, M, K, N, X dtype, leaf path, layer or None)
        ("opt w_in slice", 1024, 2048, 8192, torch.bfloat16,
         "blocks/mlp/w_in/w", 5),
        ("opt lm_head", 1024, 2048, 50272, torch.bfloat16, "lm_head/w",
         None),
        ("roberta w_in slice", 1024, 1024, 4096, torch.float32,
         "blocks/mlp/w_in/w", 5)]
    rows = []
    for label, m, k, n, dt, path, layer in cases:
        x = torch.randn((m, k), generator=gen, device=dev).to(dt)
        ql = quantize_leaf(torch.randn((k, n), generator=gen, device=dev)
                           * 0.02)
        q, sc, salt = ql.q, ql.scale, rng.leaf_salt(path)
        if layer is None:
            kw = dict(seed=seed, salt=salt, prime_offset=0, prehashed=False)
        else:
            kw = dict(seed=rng.fold_leading(rng.leaf_base(seed, salt), layer),
                      salt=0, prime_offset=1, prehashed=True)
        tol = ZO_MM_F32_RTOL if dt == torch.float32 else ZO_MM_BF16_RTOL
        errs, abs_err = {}, 0.0
        for dist in ("rademacher", "gaussian"):
            got = zp.zo_matmul_q_cuda(x, q, sc, coeff=coeff, dist=dist, **kw)
            want = zp.zo_matmul_q_ref(x, q, sc, coeff=coeff, dist=dist, **kw)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs().max()
            err = (diff / want.float().abs().max()).item()
            check(err <= tol and torch.isfinite(got).all().item(),
                  f"zo_matmul_q {label} {dist}: max|d|/max|Y| {err} > {tol}")
            errs[dist] = err
            abs_err = max(abs_err, diff.item())
            del got, want
        plain = time_ms(lambda: zp.zo_matmul_q_ref(x, q, sc, coeff=coeff,
                                                   **kw), iters=2, warmup=1)
        wp = zp.zo_add_q_ref(q, sc, kw["seed"], kw["salt"], coeff,
                             prime_offset=kw["prime_offset"],
                             prehashed=kw["prehashed"])
        xf = x.float()
        wd = (q.float() * sc).to(dt)             # the dequantized base
        t = time_interleaved(torch, {
            "kernel": lambda: zp.zo_matmul_q_cuda(x, q, sc, coeff=coeff,
                                                  **kw),
            "sgemm": lambda: xf @ wp,
            **({"cublas_bf16": lambda: x @ wd} if dt == torch.bfloat16
               else {})})
        del wp, xf, wd
        row = {"phase": "kernel", "name": "zo_matmul_q", "case": label,
               "shape": [m, k, n], "dtype": str(dt).split(".")[-1],
               **_mm_row(dt == torch.bfloat16, m, k, n,
                         (m * k + m * n) * x.element_size()
                         + k * n + 4 * n, 1, t),
               "rel_err_rademacher": errs["rademacher"],
               "rel_err_gaussian": errs["gaussian"], "tolerance": tol,
               "max_abs_err": abs_err, "plain_ms": plain}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, ql, q, sc
        torch.cuda.empty_cache()
    results["zo_matmul_q"] = _mm_result(rows, rows[:2])


# ---------------------------------------------------------------------------
# U0: the user-batched kernels (the multi-tenant step)


def kernel_zo_add_users(torch, results):
    """U0: ``zo_add_users`` on U = 4 stacked OPT-1.3B leaves (the f32
    deltas of the stacked ``w_in`` and of the LM head) against its plain
    version and against a lone ``zo_add`` launch per lane; no library
    call computes it."""
    from repro_torch.core import rng
    from repro_torch.kernels import zo_perturb as zp
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    seeds = U_SEEDS
    shapes = {path: shape for kern, path, shape in ZO_ADD_TIMED
              if kern == "zo_add_users"}
    plain, worst = {}, 0.0
    for path, shape in shapes.items():
        w = torch.randn(shape, generator=gen, device=dev) * 0.02
        salt = rng.leaf_salt(path)
        errs = {}
        for dist in ("rademacher", "gaussian"):
            got = zp.zo_add_users_cuda(w, seeds, salt, U_COEFFS, dist)
            want = zp.zo_add_users_ref(w, seeds, salt, U_COEFFS, dist)
            torch.cuda.synchronize()
            errs[dist] = (got - want).abs().max().item()
            tol = 0.0 if dist == "rademacher" else ZO_GAUSS_ATOL
            check(errs[dist] <= tol, f"zo_add_users {shape} {dist}: err "
                  f"{errs[dist]} > {tol}")
            del want
            for i in range(4):
                check(torch.equal(got[i], zp.zo_add_cuda(
                    w[i], seeds[i], salt, U_COEFFS[i], dist)),
                    f"zo_add_users {shape} {dist}: lane {i} differs from a "
                    f"lone zo_add launch")
            del got
        plain[path] = time_ms(lambda: zp.zo_add_users_ref(w, seeds, salt,
                                                          U_COEFFS),
                              iters=1, warmup=1)
        print(json.dumps({"phase": "U0 kernel checks",
                          "name": "zo_add_users", "dtype": "float32",
                          "shape": list(shape),
                          "max_abs_err_rademacher": errs["rademacher"],
                          "max_abs_err_gaussian": errs["gaussian"],
                          "tolerance_gaussian": ZO_GAUSS_ATOL,
                          "lanes_equal_lone_launches": True}), flush=True)
        worst = max(worst, errs["rademacher"])
        del w
        torch.cuda.empty_cache()
    # U1's use: the bf16 VEC=8 instantiation updating only the active
    # lanes of a stacked parameter in place; the others keep their bits
    path, lanes = "blocks/mlp/w_in/w", [0, 2]
    w = (torch.randn((4, 24, 2048, 8192), generator=gen, device=dev)
         * 0.02).to(torch.bfloat16)
    before = w.clone()
    salt = rng.leaf_salt(path)
    lane_seeds = [seeds[i] for i in lanes]
    lane_coeffs = [U_COEFFS[i] for i in lanes]
    zp.zo_add_users_cuda(w, lane_seeds, salt, lane_coeffs, out=w,
                         lanes=lanes)
    want = zp.zo_add_users_ref(before[lanes], lane_seeds, salt, lane_coeffs)
    torch.cuda.synchronize()
    err = (w[lanes].float() - want.float()).abs().max().item()
    check(err == 0.0, f"zo_add_users bf16 lanes={lanes} in place: err "
          f"{err} > 0 against the plain version")
    for j, i in enumerate(lanes):
        check(torch.equal(w[i], zp.zo_add_cuda(before[i], lane_seeds[j], salt,
                                                lane_coeffs[j])),
              f"zo_add_users bf16 lane {i} differs from a lone zo_add launch")
    frozen = [i for i in range(4) if i not in lanes]
    check(all(torch.equal(w[i], before[i]) for i in frozen),
          f"zo_add_users bf16 lanes={lanes}: lanes {frozen} moved")
    print(json.dumps({"phase": "U0 kernel", "name": "zo_add_users",
                      "dtype": "bfloat16", "shape": list(w.shape),
                      "lanes": lanes, "in_place": True,
                      "max_abs_err_rademacher": err,
                      "lanes_equal_lone_launches": True,
                      "other_lanes_unchanged": True}), flush=True)
    del w, before, want
    torch.cuda.empty_cache()
    rows = _zo_timed_rows(torch, "zo_add_users", plain)
    results["zo_add_users"] = _zo_result(rows, worst)


def kernel_zo_matmul_users(torch, results):
    """U0: ``zo_matmul_users`` (X (4, 1024, 2048) bf16 over a shared and a
    per-lane W) and ``zo_matmul_users(scale=)`` (a shared int8 W) at the
    ``w_in`` slice and LM head shapes, against their plain versions and a
    lone ``zo_matmul`` / ``zo_matmul_q`` launch per lane. The library
    yardstick is one cuBLAS SGEMM call, TF32 off, ``torch.bmm`` of
    ``X.float()`` with every lane's W' materialized beforehand."""
    from repro_torch.core import rng
    from repro_torch.kernels import zo_perturb as zp
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    seed0 = 864213579
    u = len(U_COEFFS)
    cases = [("opt w_in slice", 1024, 2048, 8192, "blocks/mlp/w_in/w", 5),
             ("opt lm_head", 1024, 2048, 50272, "lm_head/w", None)]
    rows = {"shared": [], "per-lane": [], "int8": []}
    for label, m, k, n, path, layer in cases:
        salt = rng.leaf_salt(path)
        seeds = [seed0 + 3 * i for i in range(u)]
        if layer is None:
            kw = dict(salt=salt, prime_offset=0, prehashed=False)
            lane_seeds = seeds
        else:
            kw = dict(salt=0, prime_offset=1, prehashed=True)
            lane_seeds = [rng.fold_leading(rng.leaf_base(s, salt), layer)
                          for s in seeds]
        x = torch.randn((u, m, k), generator=gen, device=dev).to(
            torch.bfloat16)
        for weight in rows:
            scale, kernel = None, "zo_matmul_users"
            if weight == "per-lane":
                w = (torch.randn((u, k, n), generator=gen, device=dev)
                     * 0.02).to(torch.bfloat16)
            elif weight == "shared":
                w = (torch.randn((k, n), generator=gen, device=dev)
                     * 0.02).to(torch.bfloat16)
            else:
                w = torch.randint(-127, 128, (k, n), generator=gen,
                                  device=dev, dtype=torch.int8)
                scale = 2.0 ** torch.randint(-12, -6, (n,), generator=gen,
                                             device=dev).float()
                kernel = "zo_matmul_users_q"

            def lane_w(i):
                return w[i] if w.dim() == 3 else w

            errs, abs_err = {}, 0.0
            for dist in ("rademacher", "gaussian"):
                got = zp.zo_matmul_users_cuda(x, w, lane_seeds,
                                              coeffs=U_COEFFS, dist=dist,
                                              scale=scale, **kw)
                want = zp.zo_matmul_users_ref(x, w, lane_seeds,
                                              coeffs=U_COEFFS, dist=dist,
                                              scale=scale, **kw)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs().max()
                err = (diff / want.float().abs().max()).item()
                check(err <= ZO_MM_BF16_RTOL
                      and torch.isfinite(got).all().item(),
                      f"{kernel} {label} {weight} {dist}: max|d|/max|Y| "
                      f"{err} > {ZO_MM_BF16_RTOL}")
                del want
                for i in range(u):
                    if scale is None:
                        lone = zp.zo_matmul_cuda(
                            x[i], lane_w(i), lane_seeds[i],
                            coeff=U_COEFFS[i], dist=dist, **kw)
                    else:
                        lone = zp.zo_matmul_q_cuda(
                            x[i], w, scale, lane_seeds[i],
                            coeff=U_COEFFS[i], dist=dist, **kw)
                    check(torch.equal(got[i], lone),
                          f"{kernel} {label} {weight} {dist}: lane {i} "
                          f"differs from a lone launch")
                    del lone
                errs[dist] = err
                abs_err = max(abs_err, diff.item())
                del got
            row = {"phase": "U0 kernel", "name": kernel, "case": label,
                   "weight": weight, "lanes": u, "shape": [m, k, n],
                   "dtype": "bfloat16",
                   "rel_err_rademacher": errs["rademacher"],
                   "rel_err_gaussian": errs["gaussian"],
                   "tolerance": ZO_MM_BF16_RTOL, "max_abs_err": abs_err,
                   "lanes_equal_lone_launches": True}
            if weight != "shared":   # the kernels line's two weights
                row.update(_users_times(torch, zp, x, w, scale, lane_seeds,
                                        kw, u, m, k, n, lane_w))
            print(json.dumps(row), flush=True)
            rows[weight].append(row)
            del w
            torch.cuda.empty_cache()
        del x
    # the kernels line: the per-lane W of the multi-tenant state (U1) for
    # zo_matmul_users, the shared int8 base (U3) for zo_matmul_users_q,
    # each summed over the two shapes
    for name, weight in (("zo_matmul_users", "per-lane"),
                         ("zo_matmul_users_q", "int8")):
        results[name] = _mm_result(rows[weight], rows[weight])


def _users_times(torch, zp, x, w, scale, lane_seeds, kw, u, m, k, n,
                 lane_w):
    """A U0 row's times: the kernel, one cuBLAS SGEMM ``torch.bmm`` of
    ``X.float()`` with every lane's W' made beforehand (the yardstick) and
    one bf16 ``torch.bmm`` of the unperturbed W (the product's floor),
    through ``time_interleaved``; the plain version's time; the bound."""
    plain = time_ms(lambda: zp.zo_matmul_users_ref(
        x, w, lane_seeds, coeffs=U_COEFFS, scale=scale, **kw),
        iters=1, warmup=1)
    wp = torch.stack([
        zp.zo_add_q_ref(w, scale, lane_seeds[i], kw["salt"], U_COEFFS[i],
                        prime_offset=kw["prime_offset"],
                        prehashed=kw["prehashed"])
        if scale is not None else
        zp.zo_add_ref(lane_w(i).float(), lane_seeds[i], kw["salt"],
                      U_COEFFS[i], prime_offset=kw["prime_offset"],
                      prehashed=kw["prehashed"])
        for i in range(u)])
    xf = x.float()
    wd = (w.float() * scale).to(x.dtype) if scale is not None else w
    wd = wd.expand(u, k, n) if wd.dim() == 2 else wd
    t = time_interleaved(torch, {
        "kernel": lambda: zp.zo_matmul_users_cuda(
            x, w, lane_seeds, coeffs=U_COEFFS, scale=scale, **kw),
        "sgemm": lambda: torch.bmm(xf, wp),
        "cublas_bf16": lambda: torch.bmm(x, wd)})
    del wp, xf, wd
    w_bytes = w.numel() * w.element_size() + (0 if scale is None else 4 * n)
    return {**_mm_row(x.dtype == torch.bfloat16, m, k, n,
                      2.0 * u * (m * k + m * n) + w_bytes, u, t),
            "plain_ms": plain}


def kernel_flash_verify(torch, results):
    """S0: the verify window at serving shapes (B 4, W = k + 1 = 4, page
    16, ragged positions 96-128) in f32 and bf16: 32 heads of 64 in three
    GQA layouts (W * G = 4 rows, 16 rows, and 64 rows over blockIdx.z)
    and every REAL_HEADS layout, NaN in the trash page, two calls
    bit-equal, bf16 on the tensor-core body and f32 on the SIMT body;
    times in bf16 at OPT-1.3B's shape (``VERIFY_TIMED``, through
    ``time_paged_attention``)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_verify as fv
    dev = torch.device("cuda")
    b, w, ps, n_live = 4, SPEC_K + 1, 16, 8
    pos = VERIFY_TIMED[2]
    cover = [p + w - 1 for p in pos]
    gen = torch.Generator(device=dev).manual_seed(5)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    errs = {}
    layouts = [((32, kvh, 64), dt, tol) for kvh, dt, tol in (
        (32, torch.float32, ATTN_F32_ATOL),
        (8, torch.float32, ATTN_F32_ATOL),
        (2, torch.float32, ATTN_F32_ATOL),
        (8, torch.bfloat16, ATTN_BF16_ATOL),
        (2, torch.bfloat16, ATTN_BF16_ATOL),
        (32, torch.bfloat16, ATTN_BF16_ATOL))]
    layouts += [(heads, dt, tol) for heads in REAL_HEADS.values()
                for dt, tol in ((torch.float32, ATTN_F32_ATOL),
                                (torch.bfloat16, ATTN_BF16_ATOL))]
    for (h, kvh, hd), dt, tol in layouts:
        label = f"flash_verify H {h} KV {kvh} hd {hd} {dt}"
        k, v, pages, _ = _paged_case(torch, b, ps, kvh, hd, n_live, cover,
                                     1e4)
        k, v = k.to(dt), v.to(dt)
        q = torch.randn((b, w, h, hd), generator=gen, device=dev).to(dt)
        body = "tc" if dt == torch.bfloat16 else "simt"
        before = dict(build.BODIES)
        got = fv.flash_verify(q, k, v, pages, pos_t)
        moved = {bb: build.BODIES[f"flash_verify/{bb}"]
                 - before[f"flash_verify/{bb}"] for bb in ("tc", "simt")}
        check(moved[body] == 1 and sum(moved.values()) == 1,
              f"{label}: bodies {moved}, expected one {body}")
        want = fv.verify_attn_ref(q, k, v, pages, pos_t)
        err = (got.float() - want.float()).abs().max().item()
        check(err <= tol and torch.isfinite(got).all().item(),
              f"{label}: max err {err} > {tol}")
        check(torch.equal(fv.flash_verify(q, k, v, pages, pos_t), got),
              f"{label}: two calls differ")
        k[0], v[0] = float("nan"), float("nan")
        check(torch.equal(fv.flash_verify(q, k, v, pages, pos_t), got),
              f"{label}: NaN in the trash page reached the output")
        errs[(f"{h}/{kvh}/{hd}", str(dt))] = err
    name, case, pos, n_live = VERIFY_TIMED
    row = time_paged_attention(torch, name, pos, n_live)
    err = max(e for (_, dt), e in errs.items() if "bfloat16" in dt)
    print(json.dumps({"phase": "kernel", "name": name, "case": case, **row,
                      "max_abs_err_by_heads_dtype": {
                          f"{hs} {dt}": e for (hs, dt), e in errs.items()},
                      "tolerance_f32": ATTN_F32_ATOL,
                      "max_abs_err": err, "tolerance": ATTN_BF16_ATOL}),
          flush=True)
    results["flash_verify"] = {**{k: row[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library")},
        "max_abs_err": err, "cases": {}}
    for arch, heads in REAL_HEADS.items():       # once at every layout
        row = time_paged_attention(torch, name, pos, n_live, heads=heads,
                                   context=False)
        print(json.dumps({"phase": "kernel", "name": name,
                          "case": f"{arch} {case}", **row,
                          "tolerance": ATTN_BF16_ATOL}), flush=True)
        results["flash_verify"]["cases"][f"{arch} {case}"] = {
            k: row[k] for k in ("ms", "library_ms", "library", "bound_ms",
                                "plain_ms")}


# ---------------------------------------------------------------------------
# phase 4: the main path


def _write_adapter(path: Path, seed: int):
    """4 replay records, K = 2, |lr * g| >= 1e-2 so updates survive bf16."""
    import numpy as np
    rng = np.random.default_rng(seed)
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "replay.jsonl", "w") as f:
        for step in range(4):
            gs = (rng.choice([-1.0, 1.0], size=2)
                  * rng.uniform(1.0, 2.0, size=2)).astype(np.float32)
            f.write(json.dumps({"step": step,
                                "seed": int(rng.integers(2**31)),
                                "gs": gs.tolist(), "lr": 1e-2,
                                "eps": 1e-3}) + "\n")


def _recorded(torch, engine_mod, fn):
    """Call ``fn()`` recording each request's first-step logits (the row
    the engine picks the first token from): (fn's result, {rid: row})."""
    first = {}
    orig = engine_mod.ServeEngine._activate

    def recording(self, slot, req, logits_row, plen):
        first[req.rid] = torch.from_numpy(logits_row.copy())
        return orig(self, slot, req, logits_row, plen)

    engine_mod.ServeEngine._activate = recording
    try:
        return fn(), first
    finally:
        engine_mod.ServeEngine._activate = orig


N_BASE = 2   # base requests beside the CLI's mix (phases 4 and Q3)


def _serve(torch, serve_mod, engine_mod, argv, params=None, hook=None):
    """Build the CLI's engine (``build_engine``, on ``params`` when given),
    submit ``N_BASE`` requests for the base model beside the CLI's
    requests -- with adapters the CLI serves only its users, as the JAX
    CLI does -- call ``hook(engine)``, serve them all, and record each
    request's first-step logits."""
    import numpy as np
    from repro_torch.serve import Request
    args = serve_mod.build_parser().parse_args(argv)

    def run():
        engine = serve_mod.build_engine(args, params)
        prompts = np.random.default_rng(args.seed + 1).integers(
            0, engine.cfg.vocab, (N_BASE, args.prompt_len), dtype=np.int32)
        for p in prompts:
            engine.submit(Request(prompt=p, max_new=args.gen, user=None))
        if hook is not None:
            hook(engine)
        t0 = time.perf_counter()
        comps = engine.run()
        return engine, comps, time.perf_counter() - t0
    (engine, comps, dt), first = _recorded(torch, engine_mod, run)
    return args, engine, comps, dt, first


SERVE_KERNELS = ("zo_add", "flash_decode", "flash_prefill")


def main_path(torch, paths):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve import engine as engine_mod
    users = {}
    for i, user in enumerate(("alice", "bob")):
        users[user] = WORK / user
        _write_adapter(users[user], 100 + i)
    common = ["--arch", "opt-1.3b", "--device", "cuda", "--slots", "4",
              "--requests", str(8 - N_BASE), "--prompt-len", "96", "--gen",
              "32", "--seed", "0"]
    for user, path in users.items():
        common += ["--adapter", f"{user}={path}"]
    paged = common + ["--paged", "--page-size", "16", "--prefill-chunk", "32"]

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    args, engine, comps, dt, first = _serve(torch, serve_mod, engine_mod,
                                            paged)
    torch.cuda.synchronize()
    launches = _snapshot(ops)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(serve_mod.summary(args, engine, comps, dt), flush=True)
    print(json.dumps({"phase": "main_path", "launches": launches,
                      "peak_memory_gib": peak_gb,
                      "materialize_s": engine.store.stats["materialize_s"],
                      "seconds": dt}), flush=True)
    for name in SERVE_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the serving path")
    _check_paged_bodies("serve", launches)
    paths["serve"] = launches
    cfg = engine.cfg
    check(len(comps) == 8, f"{len(comps)} completions, expected 8")
    check(sorted({str(c.user) for c in comps}) == ["None", "alice", "bob"],
          f"served users {sorted({str(c.user) for c in comps})}")
    for comp in comps:
        t = comp.tokens
        check(t.shape == (32,) and int(t.min()) >= 0
              and int(t.max()) < cfg.vocab,
              f"rid {comp.rid}: bad tokens {t.tolist()}")
        check(torch.isfinite(first[comp.rid]).all().item(),
              f"rid {comp.rid}: non-finite first-step logits")

    # a user's first-step logits differ from the base's on the same prompt
    model, store = engine.model, engine.store
    c0 = comps[0]
    check(c0.user == "alice", f"rid 0 served by {c0.user}, expected alice")
    prompt = torch.as_tensor(c0.prompt, dtype=torch.long,
                             device="cuda")[None]
    base_lg, _ = model.prefill(store.materialize(None),
                               model.init_cache(1, 96, device="cuda"), prompt)
    diff_user = (first[0] - base_lg[0, -1].float().cpu()).abs().max().item()
    check(diff_user > LOGITS_BF16_ATOL,
          f"alice's logits equal the base's (max diff {diff_user})")
    del engine, store, model, base_lg
    torch.cuda.empty_cache()

    # the dense-mode engine (plain attention) as the reference
    _, _, dense_comps, _, dense_first = _serve(torch, serve_mod, engine_mod,
                                               common)
    worst = max((first[r] - dense_first[r]).abs().max().item()
                for r in first)
    same_first = sum(int(a.tokens[0] == d.tokens[0])
                     for a, d in zip(comps, dense_comps))
    print(json.dumps({"phase": "reference", "first_logits_max_abs_err":
                      worst, "tolerance": LOGITS_BF16_ATOL,
                      "user_vs_base_max_abs_diff": diff_user,
                      "first_tokens_equal": same_first}), flush=True)
    check(worst <= LOGITS_BF16_ATOL,
          f"paged/chunked first-step logits differ from dense by {worst}")
    return paged, common, comps


def _profiled(torch, fn):
    """Run ``fn`` under ``torch.profiler``: (wall us, device us by kernel
    name, device events). Kernels on one stream do not overlap, so their
    durations add. Only the device is traced: CPU op events would slow
    the window and take most of the time parsing the trace (3x on phase
    5's window), and no reading uses them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    n_events = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            n_events += 1
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
    return wall_us, by_name, n_events


def _profile_line(phase, wall_us, by_name, n_events, **extra):
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    port: dict = {}                # the port's kernels by function name
    for name, us in by_name.items():
        if "repro_torch::" in name:
            fn = name.replace("(anonymous namespace)::", "")
            fn = fn.split("<")[0].split("(")[0].split("::")[-1]
            port[fn] = port.get(fn, 0.0) + us / 1e3
    print(json.dumps({
        "phase": phase, **extra, "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3 if by_name else "not measured",
        "device_busy_share": busy_us / wall_us if by_name
        else "not measured", "device_kernels": n_events,
        "top_kernels_ms": {name[:60]: us / 1e3 for name, us in top},
        "port_kernels_ms": port}), flush=True)


def profile_path(torch, paged_argv, phase="profile"):
    """Device busy share of serving (4 requests, 16 new tokens)."""
    from repro_torch.launch import serve as serve_mod
    argv = list(paged_argv)
    argv[argv.index("--requests") + 1] = "4"
    argv[argv.index("--gen") + 1] = "16"
    engine = serve_mod.build_engine(serve_mod.build_parser().parse_args(argv))
    for user in engine.store.users():          # replay outside the window
        engine.store.materialize(user)
    wall_us, by_name, n_events = _profiled(torch, engine.run)
    _profile_line(phase, wall_us, by_name, n_events, requests=4, gen=16,
                  decode_steps=engine.stats.decode_steps)


# ---------------------------------------------------------------------------
# G1: gemma-2b served at full width and depth (flash_decode's split route)

GEMMA_ARGV = ["--arch", "gemma-2b", "--device", "cuda", "--slots", "4",
              "--requests", "8", "--prompt-len", "96", "--gen", "32",
              "--seed", "0", "--paged", "--page-size", "16",
              "--prefill-chunk", "32"]


def _engine_rows(torch, engine_mod, fn):
    """Call ``fn()`` recording every logits row the engine picks a greedy
    token from: rows[(rid, j)] for generated token j -- the first from
    the prefill's row, the rest from each decode step's (a slot's row
    from the call that writes it: one call a step, or one an adapter
    under a write mask). Returns (fn's result, rows)."""
    import dataclasses
    rows, last = {}, {}
    orig_build = engine_mod.build_model
    orig_activate = engine_mod.ServeEngine._activate
    orig_commit = engine_mod.ServeEngine._commit

    def build(cfg):
        model = orig_build(cfg)
        step = model.decode_step

        def call(*a, **kw):
            lg, cache = step(*a, **kw)
            mask = kw.get("write_mask")
            for slot, row in enumerate(lg[:, -1].float().cpu()):
                if mask is None or bool(mask[slot]):
                    last[slot] = row
            return lg, cache
        return dataclasses.replace(model, decode_step=call)

    def activate(self, slot, req, logits_row, plen):
        rows[(req.rid, 0)] = torch.from_numpy(logits_row.copy())
        return orig_activate(self, slot, req, logits_row, plen)

    def commit(self, slot, toks):
        rows[(self._req[slot].rid, len(self._out[slot]))] = last[slot]
        return orig_commit(self, slot, toks)

    engine_mod.build_model = build
    engine_mod.ServeEngine._activate = activate
    engine_mod.ServeEngine._commit = commit
    try:
        return fn(), rows
    finally:
        engine_mod.build_model = orig_build
        engine_mod.ServeEngine._activate = orig_activate
        engine_mod.ServeEngine._commit = orig_commit


def _teacher_forced(torch, serve_mod, cfg, params, prompts, tokens):
    """The dense-cache decode_step (``serve()``'s loop, no paged kernel)
    fed each request's prompt and then its served tokens: (B, gen, vocab)
    f32 host logits, row j the one generated token j is picked from."""
    import numpy as np
    model = serve_mod.build_model(cfg)
    seq = torch.as_tensor(np.concatenate([prompts, tokens], axis=1),
                          dtype=torch.long, device="cuda")
    plen, gen = prompts.shape[1], tokens.shape[1]
    cache = model.init_cache(seq.shape[0], plen + gen, device="cuda")
    out = []
    with torch.no_grad():
        for t in range(plen + gen - 1):
            lg, cache = model.decode_step(params, cache, seq[:, t:t + 1], t)
            if t >= plen - 1:
                out.append(lg[:, -1].float().cpu())
    return torch.stack(out, dim=1)


def _prefill_forced(torch, serve_mod, cfg, params, prompts, tokens):
    """The serving engine's own recipe outside the engine: each prompt
    prefilled alone (B = 1, as the engine admits a request) and its cache
    installed into a batch cache, then the dense decode_step fed the
    served tokens: (B, gen, vocab) f32 host logits, row j the one
    generated token j is picked from."""
    model = serve_mod.build_model(cfg)
    plen, gen = prompts.shape[1], tokens.shape[1]
    cache = model.init_cache(len(prompts), plen + gen, device="cuda")

    def install(dst, src, i):
        for name, leaf in dst.items():
            if isinstance(leaf, dict):
                install(leaf, src[name], i)
            else:
                leaf[:, i] = src[name][:, 0]
    first = []
    with torch.no_grad():
        for i, prompt in enumerate(prompts):
            one = model.init_cache(1, plen + gen, device="cuda")
            lg, one = model.prefill(params, one, torch.as_tensor(
                prompt[None], dtype=torch.long, device="cuda"))
            install(cache, one, i)
            first.append(lg[0, -1].float().cpu())
        out = [torch.stack(first)]
        seq = torch.as_tensor(tokens, dtype=torch.long, device="cuda")
        for j in range(gen - 1):
            lg, cache = model.decode_step(params, cache, seq[:, j:j + 1],
                                          plen + j)
            out.append(lg[:, -1].float().cpu())
    return torch.stack(out, dim=1)


def g1_gemma(torch, paths):
    """G1: gemma-2b at its published widths and full depth (18 layers, 8
    heads over 1 KV head of 256, bf16, random weights from seed 0)
    through the serve CLI's engine with phase 4's mix: 8 greedy requests
    of 96 + 32 tokens, 4 slots, page 16, chunks of 32, the base model
    (no adapter). Every decode launch is on ``flash_decode``'s split
    route. Its tokens are set beside the port's reference loop
    ``serve()`` (token by token through the dense-cache decode_step: no
    paged kernel, all 8 prompts in one batch): each request's first
    differing position. Every step is held teacher-forced: the dense
    decode_step fed the engine's own tokens gives, for each of the 8 x 32
    generated tokens, logits the engine's are within G1_LOGITS_ATOL of,
    and the served token lies within LOGITS_BF16_ATOL of its best (a
    near-tie at worst). Then a profiled window of 8 decode steps on 4
    slots: the device's busy share and ``flash_decode``'s device time."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve import engine as engine_mod
    label = "G1 gemma-2b serve"
    args = serve_mod.build_parser().parse_args(GEMMA_ARGV)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    (engine, comps, dt), rows = _engine_rows(
        torch, engine_mod, lambda: serve_mod.run(args))
    torch.cuda.synchronize()
    launches = _snapshot(ops)
    paths[label] = launches
    print(serve_mod.summary(args, engine, comps, dt), flush=True)
    cfg = engine.cfg
    check((cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
           cfg.dtype) == (18, 8, 1, 256, "bfloat16"),
          f"{label}: not gemma-2b's published shape: {cfg}")
    for name in ("flash_decode", "flash_prefill"):
        check(launches[name] > 0, f"{label}: {name} was not launched")
    check(launches["flash_decode/split"] == launches["flash_decode"]
          == launches["flash_decode/split_tc"]
          and launches["flash_decode/slot"] == 0,
          f"{label}: flash_decode launches off the split route's "
          f"tensor-core body: {launches['flash_decode/split_tc']} of "
          f"{launches['flash_decode']}")
    _check_paged_bodies(label, launches)
    comps = sorted(comps, key=lambda c: c.rid)
    check(len(comps) == 8, f"{label}: {len(comps)} completions, expected 8")
    for comp in comps:
        t = comp.tokens
        check(t.shape == (args.gen,) and int(t.min()) >= 0
              and int(t.max()) < cfg.vocab,
              f"{label} rid {comp.rid}: bad tokens {t.tolist()}")
    st = engine.stats
    _phase_line(torch, label, dt, launches, arch=cfg.name,
                decode_tok_s=st.decode_tps, prefill_tok_s=st.prefill_tps,
                ttft_avg_s=st.ttft_s / len(comps),
                decode_steps=st.decode_steps)

    # the reference loop on the same base weights and prompts, free
    # running: where each request first parts from it
    prompts = np.stack([c.prompt for c in comps])
    served = np.stack([c.tokens for c in comps])
    params = engine.store.materialize(None)
    t0 = time.perf_counter()
    ref = serve_mod.serve(cfg, params, prompts, args.gen, device="cuda")
    ref_s = time.perf_counter() - t0
    first_diff = {}
    for comp, r in zip(comps, ref):
        ne = np.flatnonzero(comp.tokens != r)
        if ne.size:
            first_diff[comp.rid] = int(ne[0])
    # every step, teacher-forced: the dense decode_step on the engine's
    # own tokens; the engine's logits within G1_LOGITS_ATOL of its, and
    # each served token a near-tie there at worst
    dense = _teacher_forced(torch, serve_mod, cfg, params, prompts, served)
    err = torch.zeros(len(comps), args.gen)
    gap = torch.zeros(len(comps), args.gen)
    for i, comp in enumerate(comps):
        # up to its first difference a request's history is serve()'s
        same = first_diff.get(comp.rid, args.gen - 1) + 1
        check(np.array_equal(dense[i, :same].argmax(-1).numpy(),
                             ref[i, :same]),
              f"{label} rid {comp.rid}: the teacher-forced loop parts from "
              f"serve() within its first {same} tokens")
        for j in range(args.gen):
            row, want = rows[(comp.rid, j)], dense[i, j]
            check(int(row.argmax()) == int(comp.tokens[j]),
                  f"{label} rid {comp.rid} token {j}: not the recorded "
                  f"row's argmax")
            err[i, j] = (row - want).abs().max()
            gap[i, j] = want.max() - want[int(comp.tokens[j])]
    print(json.dumps({"phase": "G1 tokens vs serve()",
                      "identical_requests": len(comps) - len(first_diff),
                      "requests": len(comps),
                      "first_diff_position": {str(r): j for r, j in
                                              first_diff.items()},
                      "steps_held": err.numel(),
                      "logits_max_abs_err": err.max().item(),
                      "logits_max_abs_err_by_request": {
                          str(c.rid): err[i].max().item()
                          for i, c in enumerate(comps)},
                      "logits_tolerance": G1_LOGITS_ATOL,
                      "near_tie_max_gap": gap.max().item(),
                      "tokens_not_dense_argmax": int((gap > 0).sum()),
                      "tolerance": LOGITS_BF16_ATOL,
                      "reference_seconds": ref_s}), flush=True)
    check(err.max().item() <= G1_LOGITS_ATOL,
          f"{label}: the engine's logits are {err.max().item()} from the "
          f"dense decode_step's on its own tokens > {G1_LOGITS_ATOL}")
    check(gap.max().item() <= LOGITS_BF16_ATOL,
          f"{label}: a served token lies {gap.max().item()} under the "
          f"dense decode_step's best > {LOGITS_BF16_ATOL}")

    store = engine.store
    del engine
    torch.cuda.empty_cache()
    wall_us, by_name = _profile_decode_window(
        torch, "G1 profile decode", engine_mod, cfg, store,
        list(prompts[:4]), steps=8, paged=True, page_size=16)
    split_us = sum(us for n, us in by_name.items() if "flash_decode" in n)
    check(any("flash_decode_split_tc_kernel" in n for n in by_name)
          and any("flash_decode_merge_kernel" in n for n in by_name),
          f"{label}: the profiled decode steps show no split-route kernel")
    print(json.dumps({"phase": "G1 flash_decode device time",
                      "decode_steps": 8, "layers": cfg.n_layers,
                      "flash_decode_ms": split_us / 1e3,
                      "flash_decode_ms_a_step": split_us / 8e3,
                      "share_of_wall": split_us / wall_us}), flush=True)
    del store, params, rows, dense
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# S1-S5: self-speculative serving (the base drafts, base+delta verifies)

SPEC_K = 3
# launches a spec round makes, read off the code: every decode_step and
# verify_window call runs its attention kernel once in each of OPT-1.3B's
# 24 layers (a draft step is one decode_step with the base weights; a
# verify is one verify_window call for each distinct active user)
SPEC_PER_CALL = {"flash_decode": 24, "flash_verify": 24}


def _count_calls(counts):
    """A ``_serve`` hook counting the engine's decode_step and
    verify_window calls into ``counts``."""
    import dataclasses

    def hook(engine):
        model = engine.model

        def counted(name):
            fn = getattr(model, name)

            def call(*a, **kw):
                counts[name] = counts.get(name, 0) + 1
                return fn(*a, **kw)
            return call
        engine.model = dataclasses.replace(
            model, decode_step=counted("decode_step"),
            verify_window=counted("verify_window"))
    return hook


def _record_rows(rows):
    """A ``_serve`` hook recording, for every decode call, the logits row
    each written slot picks its next token from: rows[(rid, index of that
    token)]."""
    import dataclasses

    import numpy as np

    def hook(engine):
        fn = engine.model.decode_step

        def call(params, cache, toks, pos, pages=None, write_mask=None):
            lg, cache = fn(params, cache, toks, pos, pages=pages,
                           write_mask=write_mask)
            host = lg[:, -1].float().cpu()
            live = (engine._active if write_mask is None
                    else write_mask.cpu().numpy())
            for slot in np.flatnonzero(live):
                rows[(engine._req[slot].rid, len(engine._out[slot]))] = \
                    host[slot]
            return lg, cache
        engine.model = dataclasses.replace(engine.model, decode_step=call)
    return hook


def _hold_to_plain(torch, label, argv, params, spec, plain):
    """The rule for tokens on the card, stated before the first run: each
    request's speculative tokens equal the plain engine's, or at the first
    position where they differ the plain engine's logits for the two
    tokens lie within LOGITS_BF16_ATOL (a bf16 near-tie that the verify
    window's M = B * W projections may flip: cuBLAS picks its algorithm
    by M). The plain logits come from a rerun of the plain
    engine, made only when some request differs. Returns (identical
    requests, {rid: gap}) and fails on a wider gap."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve import engine as engine_mod
    check([c.rid for c in spec] == [c.rid for c in plain],
          f"{label}: completions differ in rids")
    first_diff = {}
    for a, b in zip(spec, plain):
        check(a.tokens.shape == b.tokens.shape,
              f"{label} rid {a.rid}: {a.tokens.shape} tokens, plain "
              f"{b.tokens.shape}")
        ne = (a.tokens != b.tokens).nonzero()[0]
        if ne.size:
            first_diff[a.rid] = (int(ne[0]), int(b.tokens[ne[0]]),
                                 int(a.tokens[ne[0]]))
    gaps = {}
    if first_diff:
        rows = {}
        _, _, rerun, _, first = _serve(torch, serve_mod, engine_mod, argv,
                                       params=params,
                                       hook=_record_rows(rows))
        for c in rerun:
            rows[(c.rid, 0)] = first[c.rid]
        check([c.tokens.tolist() for c in rerun]
              == [c.tokens.tolist() for c in plain],
              f"{label}: the plain engine's rerun gave other tokens")
        gaps = _near_tie_gaps(label, first_diff, rows)
    return len(spec) - len(first_diff), gaps


def _near_tie_gaps(label, first_diff, rows):
    """``_hold_to_plain``'s rule on recorded plain rows: at each request's
    first differing token j, the plain logits of the two tokens lie within
    LOGITS_BF16_ATOL. ``first_diff``: {rid: (j, plain token, other)}."""
    gaps = {}
    for rid, (j, want, got) in first_diff.items():
        row = rows[(rid, j)]
        gaps[rid] = abs(row[want] - row[got]).item()
        check(gaps[rid] <= LOGITS_BF16_ATOL,
              f"{label} rid {rid}: token {j} is {got}, plain {want}, "
              f"plain logits {gaps[rid]} apart > {LOGITS_BF16_ATOL}")
    return gaps


def _spec_run(torch, paths, label, argv, params=None,
              per_call=SPEC_PER_CALL):
    """Serve ``argv`` with ``--spec-k`` through ``_serve``: launch counts
    against the calls (``per_call``: launches a call, by kernel), tokens
    in range; returns (args, engine, completions, seconds)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve import engine as engine_mod
    calls = {}
    ops.reset_launches()
    args, engine, comps, dt, first = _serve(
        torch, serve_mod, engine_mod, argv, params=params,
        hook=_count_calls(calls))
    torch.cuda.synchronize()
    launches = _snapshot(ops)
    paths[label] = launches
    print(serve_mod.summary(args, engine, comps, dt), flush=True)
    _check_paged_bodies(label, launches)
    for name, per in per_call.items():
        fn = "decode_step" if name == "flash_decode" else "verify_window"
        check(launches[name] == per * calls.get(fn, 0) > 0,
              f"{label}: {launches[name]} {name} launches for "
              f"{calls.get(fn, 0)} {fn} calls (expected {per} a call)")
    for comp in comps:
        t = comp.tokens
        check(t.shape == (args.gen,) and int(t.min()) >= 0
              and int(t.max()) < engine.cfg.vocab,
              f"{label} rid {comp.rid}: bad tokens {t.tolist()}")
        check(torch.isfinite(first[comp.rid]).all().item(),
              f"{label} rid {comp.rid}: non-finite first-step logits")
    st = engine.stats
    n = max(len(comps), 1)
    print(json.dumps({
        "phase": label, "spec_k": engine.spec_k,
        "accept_rate": st.spec_accept_rate, "drafted": st.spec_drafted,
        "accepted": st.spec_accepted, "rounds": st.decode_steps,
        "decode_tokens": st.decode_tokens, "decode_tok_s": st.decode_tps,
        "ttft_avg_s": st.ttft_s / n, "seconds": dt,
        "accept_rate_by_user": {
            str(u): [c.accept_rate for c in comps if c.user == u]
            for u in sorted({c.user for c in comps}, key=str)},
        "calls": calls, "launches": launches}), flush=True)
    return args, engine, comps, dt


def s1_spec_serving(torch, paths, paged_argv, plain):
    """S1: phase 4's requests with --spec-k 3 against phase 4's tokens."""
    argv = paged_argv + ["--spec-k", str(SPEC_K)]
    _, engine, comps, _ = _spec_run(torch, paths, "S1 spec", argv)
    check(len(comps) == len(plain),
          f"S1: {len(comps)} completions, expected {len(plain)}")
    check(engine.stats.spec_drafted > 0, "S1: nothing drafted")
    same, gaps = _hold_to_plain(torch, "S1", paged_argv, None, comps, plain)
    print(json.dumps({"phase": "S1 tokens", "identical_requests": same,
                      "requests": len(comps), "near_tie_gaps": gaps,
                      "tolerance": LOGITS_BF16_ATOL}), flush=True)


def s2_tiny_delta(torch, paths, common):
    """S2: a user whose records barely move the weights (lr 1e-6) drafts
    nearly its own target: acceptance above 0.9, fewer rounds than half
    the decode tokens, the plain engine's tokens."""
    import numpy as np
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve import engine as engine_mod
    path = WORK / "tiny"
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(7)
    with open(path / "replay.jsonl", "w") as f:
        for step in range(4):
            f.write(json.dumps({"step": step,
                                "seed": int(rng.integers(2**31)),
                                "gs": rng.normal(size=2).astype(
                                    np.float32).tolist(),
                                "lr": 1e-6, "eps": 1e-3}) + "\n")
    argv = list(common)
    while "--adapter" in argv:
        i = argv.index("--adapter")
        del argv[i:i + 2]
    argv[argv.index("--requests") + 1] = "4"
    argv += ["--adapter", f"tiny={path}", "--paged", "--page-size", "16",
             "--prefill-chunk", "32"]
    _, plain_eng, plain, _, _ = _serve(torch, serve_mod, engine_mod, argv)
    plain_tps = plain_eng.stats.decode_tps
    del plain_eng
    _, engine, comps, _ = _spec_run(torch, paths, "S2 spec tiny",
                                    argv + ["--spec-k", str(SPEC_K)])
    st = engine.stats
    check(st.spec_accept_rate > 0.9,
          f"S2: acceptance {st.spec_accept_rate} <= 0.9")
    check(st.decode_steps < st.decode_tokens / 2,
          f"S2: {st.decode_steps} rounds for {st.decode_tokens} tokens")
    same, gaps = _hold_to_plain(torch, "S2", argv, None, comps, plain)
    print(json.dumps({"phase": "S2 tokens", "identical_requests": same,
                      "requests": len(comps), "near_tie_gaps": gaps,
                      "plain_decode_tok_s": plain_tps,
                      "spec_decode_tok_s": st.decode_tps}), flush=True)


def s3_int8_spec(torch, paths, paged_argv, base, plain):
    """S3: Q3's int8 base drafts for itself and its users; tokens held
    against Q3's plain tokens."""
    argv = paged_argv + ["--spec-k", str(SPEC_K)]
    _, engine, comps, _ = _spec_run(torch, paths, "S3 spec int8", argv,
                                    params=base)
    same, gaps = _hold_to_plain(torch, "S3", paged_argv, base, comps, plain)
    print(json.dumps({"phase": "S3 tokens", "identical_requests": same,
                      "requests": len(comps), "near_tie_gaps": gaps,
                      "tolerance": LOGITS_BF16_ATOL}), flush=True)


def s4_sampled(torch, paths, paged_argv):
    """S4: 4 sampled requests (top-k 8) with --spec-k 3: full length, and
    two runs from one seed give the same tokens."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    argv = list(paged_argv)
    argv[argv.index("--requests") + 1] = "4"
    argv += ["--spec-k", str(SPEC_K), "--sample", "--topk", "8"]
    args = serve_mod.build_parser().parse_args(argv)
    runs = []
    for i in range(2):
        ops.reset_launches()
        engine, comps, dt = serve_mod.run(args)
        torch.cuda.synchronize()
        if i == 0:
            paths["S4 spec sampled"] = _snapshot(ops)
            _check_paged_bodies("S4 spec sampled", paths["S4 spec sampled"])
        runs.append([c.tokens.tolist() for c in comps])
        check(len(comps) == 4 and all(
            len(c.tokens) == args.gen and 0 <= min(c.tokens) and
            max(c.tokens) < engine.cfg.vocab for c in comps),
            f"S4 run {i}: incomplete or bad sampled completions")
    check(runs[0] == runs[1], "S4: one seed gave two token streams")
    st = engine.stats
    print(json.dumps({"phase": "S4 spec sampled", "requests": 4,
                      "reproduced": True, "accept_rate": st.spec_accept_rate,
                      "rounds": st.decode_steps,
                      "decode_tok_s": st.decode_tps, "seconds": dt,
                      "launches": paths["S4 spec sampled"]}), flush=True)


# ---------------------------------------------------------------------------
# T1-T4: fused MeZO training


def _leaf_counts(cfg):
    """Launches a fused step must make at K = 1 on the layernorm, biased
    configs of this path (OPT-1.3B, RoBERTa-large), read off the code:
    every floating 2-D weight the forward uses goes through ``zo_matmul``
    (``PerturbCtx.matmul``), every norm scale/bias and projection bias
    through ``zo_add`` (``PerturbCtx.perturb``), embeddings through
    ``z_rows`` (no kernel); the sgd update sweeps every leaf once with
    ``zo_add``; ``flash_attention`` runs once a layer a forward."""
    fwd_mm, fwd_add, n_leaves = _forward_counts(cfg)
    return {"zo_matmul": 2 * fwd_mm,
            "zo_add": n_leaves + 2 * fwd_add,
            "flash_attention": (2 * cfg.n_layers
                                if cfg.attn_impl == "flash" else 0),
            "zo_matmul_q": 0, "zo_add_q": 0}


def _forward_counts(cfg):
    """(2-D weights a fused forward multiplies by, norm/bias leaves it
    perturbs, leaves of the tree) on the configs of these paths."""
    from repro_torch.models.transformer import param_shapes
    per_layer_mm = 6                       # wq wk wv wo w_in w_out
    per_layer_add = 4 + 6                  # 2 norms' scale+bias, 6 biases
    head_mm = 1                            # lm_head, or the CLS head
    head_add = 2 + (1 if cfg.n_classes else 0)   # ln_f, cls_head/b
    return (cfg.n_layers * per_layer_mm + head_mm,
            cfg.n_layers * per_layer_add + head_add,
            len(param_shapes(cfg)))


def _snapshot(ops):
    """Launches since the last reset: by kernel, and for the two-body
    kernels by body too (``"zo_matmul/tc"``, ``"zo_matmul/simt"``)."""
    return {**ops.LAUNCHES, **ops.BODIES}


def _check_bodies(label, launches, want, bf16):
    """The two-body kernels' launches ``want`` (read off the code) are all
    on the tensor-core body on a bf16 path -- every path here draws
    Rademacher z -- and all on the SIMT body on an f32 one
    (``csrc/zo_matmul.cu``'s and ``csrc/flash_attention.cu``'s rule)."""
    body, other = ("tc", "simt") if bf16 else ("simt", "tc")
    exp = {}
    for k, n in want.items():
        if f"{k}/tc" in launches:
            exp[f"{k}/{body}"], exp[f"{k}/{other}"] = n, 0
    got = {k: launches[k] for k in exp}
    # of the tensor-core launches, those on zo_matmul's Hopper route
    hopper = {k: launches[k] for k in (f"{n}/tc_tma" for n in want)
              if k in launches}
    print(json.dumps({"phase": f"{label} bodies", "launches": got,
                      "expected": exp, "tc_tma": hopper}), flush=True)
    check(got == exp, f"{label}: launches by body {got} != expected {exp}")


def _check_paged_bodies(label, launches):
    """A bf16 serving path runs every flash_prefill and flash_verify
    launch on the tensor-core body (``csrc/flash_prefill.cu``'s and
    ``csrc/flash_verify.cu``'s rule)."""
    _check_bodies(label, launches,
                  {k: launches[k] for k in ("flash_prefill", "flash_verify")},
                  True)


def _check_launches(label, launches, cfg, steps):
    want = {k: steps * v for k, v in _leaf_counts(cfg).items()}
    got = {k: launches[k] for k in want}
    print(json.dumps({"phase": label, "launches": launches,
                      "expected": want}), flush=True)
    check(got == want, f"{label}: launches {got} != expected {want}")
    _check_bodies(label, launches, want, cfg.dtype == "bfloat16")


def _batches(cfg, bsz, seq):
    """The CLI's batch stream for ``cfg`` (seed 0), frontend stubs
    included."""
    from repro_torch.launch.train import batch_stream
    return batch_stream(cfg, bsz, seq, 0)


def _first_batch(torch, cfg, bsz, seq):
    return {k: torch.as_tensor(v).to("cuda")
            for k, v in next(_batches(cfg, bsz, seq)).items()}


def _timed_steps(torch, strategy, loss_fn, state, batch, mcfg, n):
    """Mean host-clock seconds of ``n`` synchronized steps."""
    from repro_torch.core import rng
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        state, _ = strategy.step(loss_fn, state, batch,
                                 rng.fold_seed(12345, i), mcfg)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n, state


def train_main_path(torch, paths):
    """T1: the CLI, full-width OPT-1.3B, 4 fused steps at B 8, S 128."""
    import shutil
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    ckpt = WORK / "train_opt"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--arch", "opt-1.3b", "--optimizer", "mezo-fused", "--steps",
            str(TRAIN_STEPS), "--batch", str(TRAIN_B), "--seq",
            str(TRAIN_S), "--ckpt-dir", str(ckpt), "--log-every", "1",
            "--seed", "0"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    tr = train_mod.run(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _snapshot(ops)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    paths["train_opt"] = launches
    cfg = tr.mcfg
    check(len(tr.losses) == TRAIN_STEPS
          and all(math.isfinite(x) for x in tr.losses),
          f"T1 losses {tr.losses}")
    _check_launches("T1 launches", launches, cfg, TRAIN_STEPS)

    # step-0 snapshot + replay of the log tail == the live parameters
    mgr = CheckpointManager(str(ckpt), mezo_cfg=tr.tcfg.mezo,
                            update_rule=tr.strategy.update)
    like = tr.strategy.init_state(
        {k: torch.empty_like(v) for k, v in tr.params.items()},
        tr.tcfg.mezo)
    t1 = time.perf_counter()
    restored, nxt = mgr.restore(like)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    mgr.log.close()
    check(nxt == TRAIN_STEPS, f"T1 restore resumes at {nxt}")
    diff = [k for k in tr.params
            if not torch.equal(restored.params[k], tr.params[k])]
    check(not diff, f"T1 restore differs from the live params in {diff[:3]}")
    del restored, like
    torch.cuda.empty_cache()

    batch = _first_batch(torch, cfg, TRAIN_B, TRAIN_S)
    state = tr.strategy.init_state(tr.params, tr.tcfg.mezo)
    torch.cuda.reset_peak_memory_stats()
    step_s, state = _timed_steps(torch, tr.strategy, tr.model.loss, state,
                                 batch, tr.tcfg.mezo, 2)
    step_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(json.dumps({"phase": "T1 train", "losses": tr.losses,
                      "run_seconds": dt, "restore_seconds": restore_s,
                      "restore_bit_exact": True, "step_s": step_s,
                      "tokens_per_s": TRAIN_B * TRAIN_S / step_s,
                      "peak_memory_gib": peak_gb,
                      "step_peak_memory_gib": step_peak_gb}), flush=True)
    return tr, state, batch, peak_gb


def profile_train(torch, tr, state, batch, label="T4 profile", count=True):
    """T4 (and Q2's, F1-F4's): one fused step under the profiler; with
    ``count`` (T4), its launches against one T1 step's, read off the
    code."""
    from repro_torch.core import rng
    from repro_torch.kernels import ops

    def one():
        tr.strategy.step(tr.model.loss, state, batch, rng.fold_seed(777, 0),
                         tr.tcfg.mezo)
    ops.reset_launches()
    wall_us, by_name, n_events = _profiled(torch, one)
    _profile_line(label, wall_us, by_name, n_events, steps=1)
    if count and tr.tcfg.quant == "none":
        _check_launches(f"{label} launches", _snapshot(ops), tr.mcfg, 1)


def train_fused_vs_materialized(torch, paths, arch, label, tol):
    """T2 / T3: the Trainer API with attn_impl="flash", 2 fused steps; the
    first loss against the materialized one (add_scaled_z through the
    zo_add kernel, then the unperturbed forward, chunked attention)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import MezoConfig, add_scaled_z, rng
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.runtime import Trainer, TrainerConfig
    base = get_config(arch)
    cfg = dataclasses.replace(base, attn_impl="flash")
    mcfg = MezoConfig(eps=1e-3, lr=1e-4)
    tr = Trainer(cfg, TrainerConfig(optimizer="mezo-fused", mezo=mcfg,
                                    n_steps=2, log_every=1, seed=0,
                                    device="cuda"),
                 _batches(cfg, TRAIN_B, TRAIN_S))
    params = tr.init_params()
    # the materialized reference on the first step's batch and direction
    batch = _first_batch(torch, cfg, TRAIN_B, TRAIN_S)
    s = rng.fold_seed(rng.fold_seed(0, 0), 0)
    eps = torch.tensor(mcfg.eps, dtype=torch.float32)
    chunked = build_model(dataclasses.replace(base, attn_impl="chunked"))
    with torch.no_grad():
        lp = chunked.loss(add_scaled_z(params, s, eps), batch)
        lm = chunked.loss(add_scaled_z(params, s, -eps), batch)
    mat = float(0.5 * (lp + lm))
    torch.cuda.empty_cache()
    ops.reset_launches()
    t0 = time.perf_counter()
    tr.train(params)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _snapshot(ops)
    paths[label] = launches
    _check_launches(f"{label} launches", launches, cfg, 2)
    err = abs(tr.losses[0] - mat)
    print(json.dumps({"phase": label, "arch": arch, "losses": tr.losses,
                      "materialized_loss": mat, "abs_err": err,
                      "tolerance": tol, "seconds": dt}), flush=True)
    check(all(math.isfinite(x) for x in tr.losses),
          f"{label}: losses {tr.losses}")
    check(err <= tol, f"{label}: fused loss {tr.losses[0]} vs materialized "
          f"{mat}: {err} > {tol}")


def r1_roberta(torch, paths):
    """R1: the train CLI on full-width RoBERTa-large (f32, synthetic
    SST-2), ``mezo-fused``, 4 steps at B 8 x 128: losses, step time,
    tokens/s, peak memory, launches by kernel and body (every
    ``zo_matmul`` launch, 290 a step, on the SIMT body), then one step
    under the profiler (busy share, device ms, the port's kernels' ms)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    argv = ["--arch", "roberta-large", "--optimizer", "mezo-fused",
            "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_B), "--seq",
            str(TRAIN_S), "--log-every", "1", "--seed", "0"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    tr = train_mod.run(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _snapshot(ops)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    paths["R1 roberta"] = launches
    cfg = tr.mcfg
    check(cfg.dtype == "float32" and len(tr.losses) == TRAIN_STEPS
          and all(math.isfinite(x) for x in tr.losses),
          f"R1 {cfg.dtype} losses {tr.losses}")
    _check_launches("R1 launches", launches, cfg, TRAIN_STEPS)
    per_step = 2 * _forward_counts(cfg)[0]
    check(per_step == 290 and launches["zo_matmul/simt"] ==
          per_step * TRAIN_STEPS and launches["zo_matmul/tc"] == 0,
          f"R1: zo_matmul launches by body {launches['zo_matmul/simt']} "
          f"simt, {launches['zo_matmul/tc']} tc for {TRAIN_STEPS} steps")
    batch = _first_batch(torch, cfg, TRAIN_B, TRAIN_S)
    state = tr.strategy.init_state(tr.params, tr.tcfg.mezo)
    torch.cuda.reset_peak_memory_stats()
    step_s, state = _timed_steps(torch, tr.strategy, tr.model.loss, state,
                                 batch, tr.tcfg.mezo, 2)
    print(json.dumps({"phase": "R1 train", "arch": "roberta-large",
                      "dtype": cfg.dtype, "losses": tr.losses,
                      "run_seconds": dt, "step_s": step_s,
                      "tokens_per_s": TRAIN_B * TRAIN_S / step_s,
                      "peak_memory_gib": peak_gb,
                      "step_peak_memory_gib":
                          torch.cuda.max_memory_allocated() / 2**30,
                      "zo_matmul_simt_per_step": per_step}), flush=True)
    profile_train(torch, tr, state, batch, label="R1 profile")


# ---------------------------------------------------------------------------
# Q1-Q3: the int8 base


def _gib(n_bytes) -> float:
    return n_bytes / 2**30


def q1_frozen_base(torch, paths, arch, tol):
    """Q1: full-width ``arch`` quantized with no deltas (a frozen base);
    the fused loss at +-eps against the loss at ``ctx.materialize``."""
    from repro_torch.configs import get_config
    from repro_torch.core import PerturbCtx
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim.quant import (is_quantized, quantize_tree,
                                         quantized_bytes, tensor_bytes)
    cfg = get_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    full_bytes = sum(tensor_bytes(t) for t in params.values())
    qparams = quantize_tree(params)
    del params
    torch.cuda.empty_cache()
    resident, f32_eq = quantized_bytes(qparams)
    n_q = sum(is_quantized(v) for v in qparams.values())
    batch = _first_batch(torch, cfg, TRAIN_B, TRAIN_S)
    eps, seed = 1e-3, 4242
    fwd_mm, fwd_add, n_leaves = _forward_counts(cfg)
    fused, mat = {}, {}
    with torch.no_grad():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        for c in (eps, -eps):
            fused[c] = float(model.loss(qparams, batch,
                                        perturb=PerturbCtx(seed, c)))
        torch.cuda.synchronize()
        fused_s = (time.perf_counter() - t0) / 2
        fused_launches = _snapshot(ops)
        peak = torch.cuda.max_memory_allocated()
        ops.reset_launches()
        for c in (eps, -eps):
            mat[c] = float(model.loss(PerturbCtx(seed, c).materialize(
                qparams), batch))
        torch.cuda.synchronize()
        mat_launches = _snapshot(ops)
    label = f"Q1 {arch}"
    paths[f"{label} fused"] = fused_launches
    paths[f"{label} materialized"] = mat_launches
    want_fused = {"zo_matmul_q": 2 * fwd_mm, "zo_add": 2 * fwd_add,
                  "zo_matmul": 0, "zo_add_q": 0}
    want_mat = {"zo_add_q": 2 * n_q, "zo_add": 2 * (n_leaves - n_q),
                "zo_matmul_q": 0, "zo_matmul": 0}
    err = max(abs(fused[c] - mat[c]) for c in fused)
    print(json.dumps({
        "phase": label, "dtype": cfg.dtype, "batch": [TRAIN_B, TRAIN_S],
        "quantized_leaves": n_q, "fused_loss": list(fused.values()),
        "materialized_loss": list(mat.values()), "max_abs_err": err,
        "tolerance": tol, "fused_forward_s": fused_s,
        "resident_bytes": resident, "f32_equivalent_bytes": f32_eq,
        "unquantized_bytes": full_bytes,
        "resident_gib": _gib(resident),
        "f32_over_resident": f32_eq / resident,
        "unquantized_over_resident": full_bytes / resident,
        "fused_peak_memory_gib": _gib(peak),
        "fused_peak_over_resident_gib": _gib(peak - before),
        "launches_fused": fused_launches, "expected_fused": want_fused,
        "launches_materialized": mat_launches,
        "expected_materialized": want_mat}), flush=True)
    check(all(math.isfinite(v) for v in [*fused.values(), *mat.values()]),
          f"{label}: losses {fused} {mat}")
    check({k: fused_launches[k] for k in want_fused} == want_fused,
          f"{label}: fused launches {fused_launches} != {want_fused}")
    _check_bodies(f"{label} fused", fused_launches, want_fused,
                  cfg.dtype == "bfloat16")
    check({k: mat_launches[k] for k in want_mat} == want_mat,
          f"{label}: materialize launches {mat_launches} != {want_mat}")
    check(err <= tol, f"{label}: fused vs materialized {err} > {tol}")


def q2_int8_train(torch, paths):
    """Q2: the train CLI with ``--quant int8``, OPT-1.3B, 4 fused steps."""
    import shutil
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.optim.quant import is_quantized, quantize_tree
    ckpt = WORK / "train_opt_int8"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--arch", "opt-1.3b", "--optimizer", "mezo-fused", "--steps",
            str(TRAIN_STEPS), "--batch", str(TRAIN_B), "--seq",
            str(TRAIN_S), "--ckpt-dir", str(ckpt), "--log-every", "1",
            "--seed", "0", "--quant", "int8"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    tr = train_mod.run(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _snapshot(ops)
    peak_gb = _gib(torch.cuda.max_memory_allocated())
    paths["Q2 train int8"] = launches
    cfg = tr.mcfg
    check(len(tr.losses) == TRAIN_STEPS
          and all(math.isfinite(x) for x in tr.losses),
          f"Q2 losses {tr.losses}")
    fwd_mm, fwd_add, n_leaves = _forward_counts(cfg)
    want = {"zo_add": TRAIN_STEPS * (2 * (fwd_mm + fwd_add) + n_leaves),
            "zo_matmul_q": 0, "zo_matmul": 0, "zo_add_q": 0}
    print(json.dumps({"phase": "Q2 launches", "launches": launches,
                      "expected": want}), flush=True)
    check({k: launches[k] for k in want} == want,
          f"Q2: launches {launches} != expected {want}")

    # q and the scales bit-frozen (against the same seed's init), deltas
    # moved
    q0 = quantize_tree(tr.init_params())
    moved = 0.0
    for k, leaf in tr.params.items():
        if is_quantized(leaf):
            check(torch.equal(leaf.q, q0[k].q)
                  and torch.equal(leaf.scale, q0[k].scale),
                  f"Q2: {k} int8 values or scales moved")
            moved += leaf.delta.abs().sum().item()
    del q0
    check(moved > 0.0, "Q2: no delta moved")

    # step-0 snapshot + replay of the log tail == the live state
    mgr = CheckpointManager(str(ckpt), mezo_cfg=tr.tcfg.mezo,
                            update_rule=tr.strategy.update)
    t1 = time.perf_counter()
    restored, nxt = mgr.restore(tr.strategy.init_state(tr.params,
                                                       tr.tcfg.mezo))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    mgr.log.close()
    check(nxt == TRAIN_STEPS, f"Q2 restore resumes at {nxt}")
    for k, live in tr.params.items():
        got = restored.params[k]
        same = (torch.equal(got.q, live.q) and torch.equal(got.scale,
                                                           live.scale)
                and torch.equal(got.delta, live.delta)
                if is_quantized(live) else torch.equal(got, live))
        check(same, f"Q2 restore differs from the live params at {k}")
    del restored
    torch.cuda.empty_cache()

    batch = _first_batch(torch, cfg, TRAIN_B, TRAIN_S)
    state = tr.strategy.init_state(tr.params, tr.tcfg.mezo)
    torch.cuda.reset_peak_memory_stats()
    step_s, state = _timed_steps(torch, tr.strategy, tr.model.loss, state,
                                 batch, tr.tcfg.mezo, 2)
    step_peak_gb = _gib(torch.cuda.max_memory_allocated())
    profile_train(torch, tr, state, batch, "Q2 profile")
    print(json.dumps({"phase": "Q2 train int8", "losses": tr.losses,
                      "run_seconds": dt, "restore_seconds": restore_s,
                      "restore_bit_exact": True, "step_s": step_s,
                      "tokens_per_s": TRAIN_B * TRAIN_S / step_s,
                      "peak_memory_gib": peak_gb,
                      "step_peak_memory_gib": step_peak_gb,
                      "delta_abs_sum": moved}), flush=True)


def q3_int8_serving(torch, paths, paged_argv, dense_argv):
    """Q3: phase 4's requests from one int8 base; then a compact user."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import build_model
    from repro_torch.optim.quant import is_quantized, quantize_tree
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve import engine as engine_mod
    cfg = get_config("opt-1.3b")
    base = quantize_tree(build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), "cuda"))
    ops.reset_launches()
    args, engine, comps, dt, first = _serve(torch, serve_mod, engine_mod,
                                            paged_argv, params=base)
    torch.cuda.synchronize()
    launches = _snapshot(ops)
    paths["Q3 serve int8"] = launches
    print(serve_mod.summary(args, engine, comps, dt), flush=True)
    for name in SERVE_KERNELS:
        check(launches[name] > 0,
              f"Q3: kernel {name} was not launched serving the int8 base")
    _check_paged_bodies("Q3 serve int8", launches)
    check(len(comps) == 8, f"Q3: {len(comps)} completions, expected 8")
    check(sorted({str(c.user) for c in comps}) == ["None", "alice", "bob"],
          f"Q3 served users {sorted({str(c.user) for c in comps})}")
    for comp in comps:
        t = comp.tokens
        check(t.shape == (32,) and int(t.min()) >= 0
              and int(t.max()) < cfg.vocab,
              f"Q3 rid {comp.rid}: bad tokens {t.tolist()}")
        check(torch.isfinite(first[comp.rid]).all().item(),
              f"Q3 rid {comp.rid}: non-finite first-step logits")
    store, model = engine.store, engine.model
    del engine

    # the cache charges each user's own bytes only: deltas and the small
    # unquantized leaves, never the shared int8 values and scales
    per_user = shared = 0
    for user in store.users():
        for k, leaf in store.materialize(user).items():
            if is_quantized(leaf):
                check(leaf.q is base[k].q, f"Q3: {user} copied {k}'s q")
                per_user += leaf.delta.numel() * 4
                shared += leaf.q.numel() + leaf.scale.numel() * 4
            else:
                per_user += leaf.numel() * leaf.element_size()
    cached = store.cached_bytes()
    check(cached == per_user, f"Q3: cached_bytes {cached} != {per_user}")

    c0 = comps[0]
    check(c0.user == "alice", f"Q3 rid 0 served by {c0.user}")
    prompt = torch.as_tensor(c0.prompt, dtype=torch.long,
                             device="cuda")[None]
    base_lg, _ = model.prefill(base, model.init_cache(1, 96, device="cuda"),
                               prompt)
    base_row = base_lg[0, -1].float().cpu()
    diff_user = (first[0] - base_row).abs().max().item()
    check(diff_user > LOGITS_BF16_ATOL,
          f"Q3: alice's logits equal the base's (max diff {diff_user})")

    # the dense-mode engine on the same int8 base as the reference
    _, _, dense_comps, _, dense_first = _serve(torch, serve_mod, engine_mod,
                                               dense_argv, params=base)
    worst = max((first[r] - dense_first[r]).abs().max().item()
                for r in first)
    check(worst <= LOGITS_BF16_ATOL,
          f"Q3: paged/chunked first-step logits differ from dense by "
          f"{worst}")

    # alice's compact int8 delta against her replayed weights
    t0 = time.perf_counter()
    store.put_delta("alice_int8", store.export_delta("alice"))
    compact = store.materialize("alice_int8")
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    mat = store.materialize("alice")
    eff = (lambda x: x.dequantize_f32() if is_quantized(x) else x.float())
    worst_eff = 0.0
    for k, b in base.items():
        bound_k = (eff(mat[k]) - eff(b)).abs().max().item() / 127.0 \
            + Q_EFF_ATOL
        if not is_quantized(b) and b.dtype == torch.bfloat16:
            # a bf16 leaf stores both sides rounded to bf16: one more
            # bf16 step at the leaf's magnitude
            bound_k += (torch.finfo(torch.bfloat16).eps
                        * eff(mat[k]).abs().max().item())
        e = (eff(compact[k]) - eff(mat[k])).abs().max().item()
        check(e <= bound_k, f"Q3: compact {k} off by {e} > {bound_k}")
        worst_eff = max(worst_eff, e / bound_k)
    # the compact user serves alice's requests
    alice = [c for c in comps if c.user == "alice"]
    eng = ServeEngine(cfg, store, n_slots=4, max_len=96 + 32, seed=0,
                      paged=True, page_size=16, prefill_chunk=32,
                      device="cuda")
    for c in alice:
        eng.submit(Request(prompt=c.prompt, max_new=32, user="alice_int8"))
    compact_comps, compact_first = _recorded(torch, engine_mod, eng.run)
    check(len(compact_comps) == len(alice), "Q3: compact user's requests")
    for comp in compact_comps:
        t = comp.tokens
        check(t.shape == (32,) and int(t.min()) >= 0
              and int(t.max()) < cfg.vocab,
              f"Q3 compact rid {comp.rid}: bad tokens {t.tolist()}")
    c_row = compact_first[compact_comps[0].rid]
    check(torch.isfinite(c_row).all().item(),
          "Q3: compact user's first-step logits are not finite")
    compact_vs_user = (c_row - first[0]).abs().max().item()
    check(compact_vs_user < diff_user,
          f"Q3: the compact user's logits are {compact_vs_user} from the "
          f"replayed user's, the base's {diff_user}")
    print(json.dumps({
        "phase": "Q3 serve int8", "first_logits_max_abs_err": worst,
        "tolerance": LOGITS_BF16_ATOL, "user_vs_base_max_abs_diff": diff_user,
        "cached_bytes": cached, "per_user_bytes": per_user,
        "shared_int8_bytes_not_charged": shared,
        "compact_seconds": compact_s,
        "compact_weight_err_over_bound": worst_eff,
        "compact_vs_replayed_first_logits": compact_vs_user,
        "compact_tokens_equal_replayed": sum(
            int((a.tokens == b.tokens).all())
            for a, b in zip(compact_comps, alice)),
        "launches": launches}), flush=True)
    return base, comps


# ---------------------------------------------------------------------------
# U1-U4: multi-tenant training (one TrainEngine over one resident base)

FLEET_USERS, FLEET_SLOTS, FLEET_STEPS = 6, 4, 3


def _fleet_counts(cfg, quant, dispatches):
    """Launches the CLI's run must make, read off the code (K = 1, the
    chunked attention, every lane active or not): a dispatch runs ONE
    2U-lane forward -- each projection one ``zo_matmul_users`` (over an
    int8 base with deltas: one ``zo_add_users`` for its per-lane W'
    instead), each norm/bias leaf one ``zo_add_users`` -- and the sgd
    update sweeps every leaf once with ``zo_add_users``; no scalar
    kernel runs. Independent of U."""
    fwd_mm, fwd_add, n_leaves = _forward_counts(cfg)
    if quant == "int8":
        per = {"zo_add_users": fwd_mm + fwd_add + n_leaves,
               "zo_matmul_users": 0}
    else:
        per = {"zo_add_users": fwd_add + n_leaves,
               "zo_matmul_users": fwd_mm}
    per.update({"zo_matmul_users_q": 0, "zo_matmul": 0, "zo_add": 0,
                "zo_matmul_q": 0, "zo_add_q": 0, "flash_attention": 0})
    return per, {k: v * dispatches for k, v in per.items()}


def _lone_trainer(torch, cfg, user, quant, mz, log_dir, batches=None,
                  steps=FLEET_STEPS):
    """A lone port Trainer of ``user`` (the derived seed, the CLI's batch
    stream -- or ``batches``, a step -> batch function -- the CLI's seeded
    init) over ``steps`` steps, whose checkpoint manager writes the
    replay log but skips the step-0 snapshot (a multi-GB write that the
    comparison does not read). Returns (losses, final params)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.engine import SGD
    from repro_torch.launch.train_fleet import user_batches
    from repro_torch.models import build_model
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.train import derive_user_seed

    class LogOnly(CheckpointManager):
        def on_step(self, step, state, aux=None, direction_mask=None):
            self.log.append(step, aux.seed, aux.gs, self.cfg.lr,
                            self.cfg.eps, mask=direction_mask)

    fn = batches or user_batches(cfg, user, TRAIN_B, TRAIN_S, 0)
    tr = Trainer(cfg, TrainerConfig(
        estimator="fused", update="sgd", mezo=mz, quant=quant,
        n_steps=steps, seed=derive_user_seed(0, user), device="cuda",
        log_every=10 ** 6), iter([fn(t) for t in range(steps)]),
        log_fn=lambda s: None)
    tr.ckpt = LogOnly(str(log_dir), mezo_cfg=mz, update_rule=SGD)
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), "cuda")
    final = tr.train(params)
    tr.ckpt.log.close()
    return tr.losses, final


def _same_leaf(torch, a, b) -> bool:
    from repro_torch.optim.quant import is_quantized
    if is_quantized(a):
        return (torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
                and torch.equal(a.delta, b.delta))
    return torch.equal(a, b)


def u_fleet(torch, paths, quant):
    """U1 (bf16 base) / U2 (``--quant int8``): the ``train_fleet`` CLI at
    full width, 6 users on 4 slots, 3 steps, B 8 x S 128, mezo-fused +
    sgd; every user against a lone Trainer; one eviction and re-admission;
    the launches of the run; for U1 one dispatch under the profiler
    (U4)."""
    import shutil
    from repro_torch.core.engine import MezoConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import train_fleet
    from repro_torch.optim.quant import is_quantized, quantize_tree
    from repro_torch.train import TrainEngine, TrainJob
    label = "U2 fleet int8" if quant == "int8" else "U1 fleet"
    root = WORK / ("fleet_" + quant)
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--arch", "opt-1.3b", "--device", "cuda", "--users",
            str(FLEET_USERS), "--slots",
            str(FLEET_SLOTS), "--steps", str(FLEET_STEPS), "--batch",
            str(TRAIN_B), "--seq", str(TRAIN_S), "--estimator", "fused",
            "--update", "sgd", "--seed", "0", "--quant", quant,
            "--log-dir", str(root / "engine"), "--out",
            str(root / "summary.json")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    engine, results = train_fleet.run(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _snapshot(ops)
    peak = _gib(torch.cuda.max_memory_allocated())
    paths[label] = launches
    st, cfg, store = engine.stats, engine.cfg, engine.store
    mz = MezoConfig(eps=1e-3, lr=1e-4)
    check(st.finished == FLEET_USERS and st.admitted == FLEET_USERS,
          f"{label}: {st}")
    check(st.user_steps == FLEET_USERS * FLEET_STEPS, f"{label}: {st}")
    per, want = _fleet_counts(cfg, quant, st.dispatches)
    got = {k: launches[k] for k in want}
    print(json.dumps({"phase": f"{label} launches", "launches": launches,
                      "expected": want, "per_dispatch": per,
                      "dispatches": st.dispatches}), flush=True)
    check(got == want, f"{label}: launches {got} != expected {want}")
    _check_bodies(label, launches, want, cfg.dtype == "bfloat16")
    resident = None
    if quant == "int8":
        # q and the scales: the CLI's seeded init quantized, bit-frozen
        q0 = quantize_tree(engine.model.init(
            torch.Generator(device="cuda").manual_seed(0), "cuda"))
        for k, leaf in store.base.items():
            if is_quantized(leaf):
                check(torch.equal(leaf.q, q0[k].q)
                      and torch.equal(leaf.scale, q0[k].scale),
                      f"{label}: {k}'s int8 values or scales moved")
                lanes = engine._state.params[k]
                check(lanes.q is leaf.q and lanes.scale is leaf.scale,
                      f"{label}: the slots copied {k}'s int8 base")
        del q0
        resident = sum(leaf.q.numel() + 4 * leaf.scale.numel()
                       for leaf in store.base.values() if is_quantized(leaf))
    if quant == "none":
        u4_profile(torch, engine)
    state_gib = _gib(sum(
        (v.delta.numel() * 4 if is_quantized(v) and v.delta is not None
         else 0) if is_quantized(v) else v.numel() * v.element_size()
        for v in engine._state.params.values()))
    del engine
    torch.cuda.empty_cache()
    store.cache_bytes = 1          # keep one materialized user at a time

    # every user against a lone Trainer: losses, parameters, replay log
    t1 = time.perf_counter()
    for r in results:
        losses, final = _lone_trainer(torch, cfg, r.user, quant, mz,
                                      root / f"lone_{r.user}")
        check(r.losses == losses, f"{label} {r.user}: losses {r.losses} != "
              f"lone {losses}")
        mat = store.materialize(r.user)
        for k, leaf in final.items():
            check(_same_leaf(torch, leaf, mat[k]),
                  f"{label} {r.user}: {k} differs from the lone run")
        log = (root / "engine" / f"{r.user}.jsonl").read_bytes()
        check(log == (root / f"lone_{r.user}" / "replay.jsonl").read_bytes(),
              f"{label} {r.user}: replay log differs from the lone run's")
        del final, mat
        torch.cuda.empty_cache()
    lone_s = time.perf_counter() - t1

    # one eviction and re-admission: user-0 evicted after one step,
    # user-1 trains in its slot meanwhile, user-0 resumes from its log
    from repro_torch.serve import AdapterStore
    ev = train_fleet.user_batches
    fresh = AdapterStore(store.base, mezo_cfg=store.cfg, device="cuda",
                         update_rule=store.rule)
    ops.reset_launches()
    eng = TrainEngine(cfg, fresh, n_slots=1, seed=0, mezo_cfg=mz)
    eng.submit(TrainJob(user="user-0", batches=ev(cfg, "user-0", TRAIN_B,
                                                  TRAIN_S, 0),
                        n_steps=FLEET_STEPS))
    eng.step()
    first = eng.evict("user-0")
    eng.submit(TrainJob(user="user-1", batches=ev(cfg, "user-1", TRAIN_B,
                                                  TRAIN_S, 0), n_steps=1))
    eng.submit(TrainJob(user="user-0", batches=ev(cfg, "user-0", TRAIN_B,
                                                  TRAIN_S, 0),
                        n_steps=FLEET_STEPS))
    resumed = [r for r in eng.run()
               if r.user == "user-0" and not r.evicted][0]
    torch.cuda.synchronize()
    paths[f"{label} evict"] = _snapshot(ops)
    del eng
    want_losses = [r for r in results if r.user == "user-0"][0].losses
    check(first.evicted and resumed.start_step == 1,
          f"{label}: eviction {first.n_steps}, resumed at "
          f"{resumed.start_step}")
    check(first.losses + resumed.losses == want_losses,
          f"{label}: evicted + resumed losses {first.losses} + "
          f"{resumed.losses} != {want_losses}")
    a, b = fresh.materialize("user-0"), store.materialize("user-0")
    for k in a:
        check(_same_leaf(torch, a[k], b[k]),
              f"{label}: the re-admitted user-0 differs at {k}")
    del a, b, fresh, store
    torch.cuda.empty_cache()
    print(json.dumps({
        "phase": label, "users": FLEET_USERS, "slots": FLEET_SLOTS,
        "steps": FLEET_STEPS, "batch": [TRAIN_B, TRAIN_S],
        "dispatches": st.dispatches, "user_steps": st.user_steps,
        "user_steps_per_s": st.user_steps_per_s,
        "dispatch_s": st.train_s / st.dispatches,
        "tokens_per_s": st.user_steps * TRAIN_B * TRAIN_S / st.train_s,
        "run_seconds": dt, "peak_memory_gib": peak,
        "stacked_state_gib": state_gib, "int8_resident_bytes": resident,
        "lanes_bit_equal_lone_trainers": True, "lone_check_seconds": lone_s,
        "evict_readmit_bit_exact": True,
        "losses": {r.user: r.losses for r in results}}), flush=True)


def u4_profile(torch, engine, label="U4 profile"):
    """U4: one U1 dispatch (4 active lanes, both signs: 8 lanes) under
    the profiler, on the engine's stacked state after the CLI's run (UF1:
    the same for granite-moe)."""
    import numpy as np
    from repro_torch.core import rng
    from repro_torch.launch.train_fleet import user_batches
    cfg = engine.cfg
    lanes = [user_batches(cfg, f"user-{i}", TRAIN_B, TRAIN_S, 0)(0)
             for i in range(FLEET_SLOTS)]
    batch = {k: torch.from_numpy(np.stack([b[k] for b in lanes])).to("cuda")
             for k in lanes[0]}
    seeds = [rng.fold_seed(4321, i) for i in range(FLEET_SLOTS)]
    eps = torch.full((FLEET_SLOTS,), 1e-3)
    lr = torch.full((FLEET_SLOTS,), 1e-4)

    def one():
        engine._state, _ = engine.strategy.step_users(
            engine.model.loss, engine._state, batch, seeds, engine.mz,
            [True] * FLEET_SLOTS, eps=eps, lr=lr)
    one()                                   # warm (allocator, cuBLAS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    wall_us, by_name, n_events = _profiled(torch, one)
    _profile_line(label, wall_us, by_name, n_events, dispatches=1,
                  lanes=2 * FLEET_SLOTS, dispatch_s_unprofiled=warm_s)


def u3_shared_base(torch, paths, base):
    """U3: the user-axis fused loss over one shared base, U = 4 lanes
    (two seeds, both signs), over the bf16 base and a frozen int8 base
    (Q1's path batched): each lane's loss against the scalar fused loss
    at atol 0; launches; peak memory against Q1's. The shared base is a
    user-stacked tree of one lane (views ``v[None]``; a frozen int8 leaf
    has no lane axis), so lane i reads it as lane i % 1."""
    from repro_torch.configs import get_config
    from repro_torch.core import PerturbCtx
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim.quant import is_quantized, quantize_tree
    cfg = get_config("opt-1.3b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    if base == "int8":
        params = quantize_tree(params)
        torch.cuda.empty_cache()
    batch = _first_batch(torch, cfg, TRAIN_B, TRAIN_S)
    u = len(U_COEFFS)
    seeds = [4242, 4242, 77, 77]
    coeffs = [1e-3, -1e-3, 1e-3, -1e-3]
    lanes_batch = {k: v[None].expand(u, *v.shape) for k, v in batch.items()}
    fwd_mm, fwd_add, _ = _forward_counts(cfg)
    mm = "zo_matmul_users_q" if base == "int8" else "zo_matmul_users"
    want = {mm: fwd_mm, "zo_add_users": fwd_add, "zo_matmul": 0,
            "zo_matmul_q": 0, "zo_add": 0}
    label = f"U3 shared {base}"
    with torch.no_grad():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        shared = {k: v if is_quantized(v) else v[None]
                  for k, v in params.items()}
        got = model.loss(shared, lanes_batch, perturb=PerturbCtx(
            seed=seeds, coeff=coeffs))
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        launches = _snapshot(ops)
        peak = torch.cuda.max_memory_allocated()
        paths[label] = launches
        scalar = [model.loss(params, batch, perturb=PerturbCtx(s, c))
                  for s, c in zip(seeds, coeffs)]
    got = got.tolist()
    scalar = [x.item() for x in scalar]
    print(json.dumps({
        "phase": label, "lanes": u, "batch": [TRAIN_B, TRAIN_S],
        "losses": got, "scalar_losses": scalar,
        "user_axis_forward_s": fwd_s, "peak_memory_gib": _gib(peak),
        "peak_over_resident_gib": _gib(peak - before),
        "launches": launches, "expected": want}), flush=True)
    check(got == scalar, f"{label}: lane losses {got} != scalar {scalar}")
    check({k: launches[k] for k in want} == want,
          f"{label}: launches {launches} != {want}")
    _check_bodies(label, launches, want, cfg.dtype == "bfloat16")


# ---------------------------------------------------------------------------
# F1-F5: the other model families at full width

FAMILY_FUSED_ATOL = OPT_FUSED_ATOL   # bf16 fused vs materialized loss
JAMBA_LAYERS = 8        # F3's cut: one super-block, 8 of 32 sublayers
DENSE_LAYERS = 2        # F5's cut: 2 layers of each dense config
# rwkv6-7b's bf16 decode against its bf16 forward (F2), set between the
# sound readings on an H100 (decode 0.234; two sound forwards 0.18-0.23
# apart) and F2's controls (x_prev zeroed 1.02, WKV state zeroed 9.06),
# which must exceed it
RWKV_BF16_ATOL = 0.5
F5_ARCHS = ("gemma-2b", "qwen3-4b", "chatglm3-6b", "glm4-9b", "pixtral-12b")
F5_PROMPT, F5_CHUNK, F5_DECODE = 64, 32, 8


def _phase_line(torch, label, seconds, launches, **extra):
    """A phase's line: seconds, peak memory since the last reset, launch
    counts by kernel and body."""
    print(json.dumps({"phase": label, "seconds": seconds,
                      "peak_memory_gib":
                          torch.cuda.max_memory_allocated() / 2**30,
                      "launches": {k: v for k, v in launches.items() if v},
                      **extra}), flush=True)


def _check_tc(label, launches, names):
    """Every launch of each named two-body kernel on its bf16 tensor-core
    body, and at least one."""
    for name in names:
        check(launches[f"{name}/tc"] > 0 and launches[f"{name}/simt"] == 0,
              f"{label}: {name} launches by body tc "
              f"{launches[f'{name}/tc']}, simt {launches[f'{name}/simt']}")


@contextlib.contextmanager
def _routing(torch, calls):
    """Record every ``moe_apply`` call's routing into ``calls``: the
    router's top-(k + 1) experts by probability (B, S, k + 1), their
    logits, and the assignments dropped past capacity."""
    from repro_torch.models import moe
    orig = moe.moe_apply

    def recording(cfg, p, x):
        k = cfg.topk
        lg = x.reshape(-1, x.shape[-1]).to(torch.float32) @ p["router"]
        idx = torch.topk(torch.softmax(lg, dim=-1), k + 1, dim=-1).indices
        # moe_apply's dispatch: an assignment is kept while its rank among
        # its expert's assignments (token-major order) is under capacity
        flat = idx[:, :k].reshape(-1)
        order = torch.argsort(flat, stable=True)
        starts = torch.searchsorted(flat[order], torch.arange(
            cfg.n_experts, device=flat.device))
        rank = torch.empty_like(order)
        rank[order] = (torch.arange(flat.numel(), device=flat.device)
                       - starts[flat[order]])
        dropped = (rank >= moe.capacity(lg.shape[0], cfg)).reshape(-1, k)
        calls.append({"idx": idx.reshape(*x.shape[:2], -1).cpu(),
                      "logit": lg.gather(-1, idx).reshape(
                          *x.shape[:2], -1).cpu(),
                      "drops": dropped.sum(-1).reshape(x.shape[:2]).cpu(),
                      "dropped": int(dropped.sum())})
        return orig(cfg, p, x)
    moe.moe_apply = recording
    try:
        yield calls
    finally:
        moe.moe_apply = orig


def _route(call, k, *at):
    """(sorted top-k experts, logit margin between the k-th and the
    (k + 1)-th, assignments dropped past capacity) of one recorded
    token."""
    idx, lg = call["idx"][at], call["logit"][at]
    return (sorted(idx[:k].tolist()), (lg[k - 1] - lg[k]).item(),
            int(call["drops"][at]))


def _flips(torch, a, b, k):
    """Tokens whose top-k expert set differs between two recorded
    passes over the same tokens, by MoE layer."""
    return [int((a_["idx"][..., :k].sort(-1).values
                 != b_["idx"][..., :k].sort(-1).values).any(-1).sum())
            for a_, b_ in zip(a, b)]


def _fused_vs_materialized(torch, label, cfg, params, batch, paths,
                           routing=False):
    """The fused perturbed loss (flash attention, every projection through
    ``zo_matmul``) at +eps against the loss at ``ctx.materialize`` (every
    leaf through ``zo_add``, plain attention), on ``batch``."""
    import dataclasses
    from repro_torch.core import PerturbCtx, rng
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    fused_model = build_model(dataclasses.replace(cfg, attn_impl="flash"))
    plain_model = build_model(dataclasses.replace(cfg, attn_impl="chunked"))
    ctx = PerturbCtx(seed=rng.fold_seed(rng.fold_seed(0, 0), 0), coeff=1e-3)
    fused_calls, mat_calls = [], []
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad(), (_routing(torch, fused_calls) if routing
                           else contextlib.nullcontext()):
        fused = float(fused_model.loss(params, batch, perturb=ctx))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _snapshot(ops)
    paths[f"{label} fused"] = launches
    with torch.no_grad(), (_routing(torch, mat_calls) if routing
                           else contextlib.nullcontext()):
        mat = ctx.materialize(params)
        ref = float(plain_model.loss(mat, batch))
    del mat
    torch.cuda.empty_cache()
    err = abs(fused - ref)
    extra = {} if not routing else {
        "capacity_factor": cfg.capacity_factor,
        "tokens": batch["tokens"].numel(),
        "routing_flips_by_moe_layer": _flips(torch, fused_calls, mat_calls,
                                             cfg.topk),
        "dropped_fused": [c["dropped"] for c in fused_calls],
        "dropped_materialized": [c["dropped"] for c in mat_calls]}
    print(json.dumps({"phase": f"{label} fused vs materialized",
                      "arch": cfg.name, "fused_loss": fused,
                      "materialized_loss": ref, "abs_err": err,
                      "tolerance": FAMILY_FUSED_ATOL,
                      "fused_forward_s": dt, **extra,
                      "launches": {k: v for k, v in launches.items() if v}}),
          flush=True)
    check(math.isfinite(fused) and err <= FAMILY_FUSED_ATOL,
          f"{label}: fused loss {fused} vs materialized {ref}: {err}")
    _check_tc(label, launches, ["zo_matmul"] + (
        ["flash_attention"] if cfg.family != "ssm" else []))
    check(launches["zo_add"] > 0, f"{label}: no zo_add launch")
    return launches


def _cli_train(torch, paths, label, arch, steps, profile=True):
    """The train CLI at full width and depth, ``mezo-fused``, B 8 x 128:
    losses, step s, tokens/s, peak memory, launches by body, and (with
    ``profile``) one profiled step."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    argv = ["--arch", arch, "--optimizer", "mezo-fused", "--steps",
            str(steps), "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
            "--log-every", "1", "--seed", "0", "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    tr = train_mod.run(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _snapshot(ops)
    paths[f"{label} train"] = launches
    check(len(tr.losses) == steps and all(math.isfinite(x)
                                          for x in tr.losses),
          f"{label} losses {tr.losses}")
    _check_tc(f"{label} train", launches, ["zo_matmul"])
    batch = _first_batch(torch, tr.mcfg, TRAIN_B, TRAIN_S)
    state = tr.strategy.init_state(tr.params, tr.tcfg.mezo)
    step_s, state = _timed_steps(torch, tr.strategy, tr.model.loss, state,
                                 batch, tr.tcfg.mezo, 1)
    _phase_line(torch, f"{label} train", dt, launches, arch=arch,
                losses=tr.losses, step_s=step_s,
                tokens_per_s=TRAIN_B * TRAIN_S / step_s)
    if profile:
        profile_train(torch, tr, state, batch,
                      label=f"{label} profile step", count=False)
    return tr, batch


def _profile_decode_window(torch, label, engine_mod, cfg, store, prompts,
                           steps=8, **kw):
    """Device busy share of ``steps`` engine steps of pure decode: a
    fresh engine admits one request a slot first (unprofiled)."""
    engine = engine_mod.ServeEngine(cfg, store, n_slots=len(prompts),
                                    max_len=128, seed=0, device="cuda", **kw)
    for p in prompts:
        engine.submit(engine_mod.Request(prompt=p, max_new=32))
    engine.step()
    wall_us, by_name, n_events = _profiled(torch, lambda: [engine.step()
                                                 for _ in range(steps)])
    _profile_line(label, wall_us, by_name, n_events, decode_steps=steps,
                  slots=len(prompts))
    return wall_us, by_name


def _family_argv(paged_argv, arch):
    argv = list(paged_argv)
    argv[argv.index("--arch") + 1] = arch
    return argv


def _serve_family(torch, paths, label, argv, hook=None):
    """Phase 4's request mix for another arch through the serve CLI:
    tokens in range, first-step logits finite, launches by body."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve import engine as engine_mod
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    args, engine, comps, dt, first = _serve(torch, serve_mod, engine_mod,
                                            argv, hook=hook)
    torch.cuda.synchronize()
    launches = _snapshot(ops)
    paths[label] = launches
    print(serve_mod.summary(args, engine, comps, dt), flush=True)
    for comp in comps:
        t = comp.tokens
        check(t.shape == (args.gen,) and int(t.min()) >= 0
              and int(t.max()) < engine.cfg.vocab,
              f"{label} rid {comp.rid}: bad tokens {t.tolist()}")
        check(torch.isfinite(first[comp.rid]).all().item(),
              f"{label} rid {comp.rid}: non-finite first-step logits")
    st = engine.stats
    _phase_line(torch, label, dt, launches, arch=engine.cfg.name,
                paged=engine.paged, decode_tok_s=st.decode_tps,
                ttft_avg_s=st.ttft_s / max(len(comps), 1),
                decode_steps=st.decode_steps)
    return args, engine, comps, first


def f1_moe(torch, paths, paged_argv):
    """F1: granite-moe-1b-a400m at full width and depth."""
    from repro_torch.models import moe
    from repro_torch.models.runtime import _index, nest
    arch = "granite-moe-1b-a400m"
    tr, batch = _cli_train(torch, paths, "F1", arch, TRAIN_STEPS)
    cfg = tr.mcfg
    _fused_vs_materialized(torch, "F1", cfg, tr.params, batch, paths)
    # MoE dispatch twice on layer 0's experts and the batch's embeddings
    p0 = _index(nest(tr.params, "blocks"), 0)["moe"]
    x = tr.params["embed/tok"][batch["tokens"].long()]
    with torch.no_grad():
        a, aux_a = moe.moe_apply(cfg, p0, x)
        b, aux_b = moe.moe_apply(cfg, p0, x)
    torch.cuda.synchronize()
    same = torch.equal(a, b) and torch.equal(aux_a, aux_b)
    print(json.dumps({"phase": "F1 dispatch", "tokens": x.shape[0] *
                      x.shape[1], "experts": cfg.n_experts,
                      "topk": cfg.topk,
                      "capacity": moe.capacity(x.shape[0] * x.shape[1],
                                               cfg),
                      "bit_equal": same}), flush=True)
    check(same, "F1: two MoE dispatches of one input differ")
    del tr, batch, p0, x, a, b
    torch.cuda.empty_cache()
    argv = _family_argv(paged_argv, arch)
    _serve_family(torch, paths, "F1 serve", argv)
    _spec_run(torch, paths, "F1 spec", argv + ["--spec-k", str(SPEC_K)],
              per_call={"flash_decode": cfg.n_layers,
                        "flash_verify": cfg.n_layers})


def _decode_vs_forward(torch, model, params, comps, first, rows):
    """Max |decode logits - forward logits| over every picked token of
    ``comps`` (base requests): the forward runs over prompt + generated
    tokens; ``rows`` / ``first`` are the engine's recorded rows."""
    worst = 0.0
    for c in comps:
        rows[(c.rid, 0)] = first[c.rid]
        toks = torch.as_tensor(list(c.prompt) + c.tokens[:-1].tolist(),
                               dtype=torch.long, device="cuda")[None]
        with torch.no_grad():
            ref, _ = model.forward(params, {"tokens": toks})
        plen = len(c.prompt)
        for j in range(len(c.tokens)):
            d = rows[(c.rid, j)] - ref[0, plen - 1 + j].float().cpu()
            worst = max(worst, d.abs().max().item())
    return worst


def _zeroing(rows, names):
    """A ``_serve`` hook: ``_record_rows``, and before every decode step
    the cache leaves named in ``names`` set to zero (a control: a decode
    that loses that part of its state)."""
    import dataclasses
    record = _record_rows(rows)

    def zero(d):
        for name, v in d.items():
            if isinstance(v, dict):
                zero(v)
            elif name in names:
                v.zero_()

    def hook(engine):
        record(engine)
        fn = engine.model.decode_step

        def call(params, cache, *a, **kw):
            zero(cache)
            return fn(params, cache, *a, **kw)
        engine.model = dataclasses.replace(engine.model, decode_step=call)
    return hook


def _forward_noise(torch, model, params, comps, cut=16):
    """Two sound full-sequence passes apart: max |logits| difference, over
    the generated positions they share, between the forward over prompt
    + generated tokens and the forward over all but the last ``cut``."""
    worst = 0.0
    for c in comps:
        toks = torch.as_tensor(list(c.prompt) + c.tokens[:-1].tolist(),
                               dtype=torch.long, device="cuda")[None]
        n, plen = toks.shape[1] - cut, len(c.prompt)
        with torch.no_grad():
            full, _ = model.forward(params, {"tokens": toks})
            short, _ = model.forward(params, {"tokens": toks[:, :n]})
        d = (full[0, plen - 1:n].float() - short[0, plen - 1:].float())
        worst = max(worst, d.abs().max().item())
    return worst


def f2_rwkv(torch, paths):
    """F2: rwkv6-7b at full width and depth; serving in the dense layout
    against the port's own forward over the same tokens: bf16 through the
    serve CLI, held to RWKV_BF16_ATOL, which two controls (decodes that
    zero the token shift's ``x_prev`` or the WKV state at each step) must
    exceed; then the same weights in f32 through the API, held to
    LOGITS_BF16_ATOL. In bf16 on an H100 two sound full-sequence passes
    of different lengths already differ by about 0.2 (the bf16 GEMMs'
    roundings over 32 layers; printed as ``forward_vs_forward``)."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve import AdapterStore, ServeEngine
    from repro_torch.serve import engine as engine_mod
    arch = "rwkv6-7b"
    tr, batch = _cli_train(torch, paths, "F2", arch, 2, profile=False)
    _fused_vs_materialized(torch, "F2", tr.mcfg, tr.params, batch, paths)
    del tr, batch
    torch.cuda.empty_cache()
    argv = ["--arch", arch, "--device", "cuda", "--slots", "4",
            "--requests", "2", "--prompt-len", "96", "--gen", "32",
            "--seed", "0", "--paged"]
    rows = {}
    _, engine, comps, first = _serve_family(torch, paths, "F2 serve", argv,
                                            hook=_record_rows(rows))
    check(not engine.paged, "F2: rwkv6 served a paged layout")
    params = engine.store.materialize(None)
    bf16_err = _decode_vs_forward(torch, engine.model, params, comps, first,
                                  rows)
    noise = _forward_noise(torch, engine.model, params, comps)
    controls = {}
    for what, names in (("x_prev zeroed", ("x_prev",)),
                        ("wkv state zeroed", ("state",))):
        rows_c = {}
        _, _, comps_c, _, first_c = _serve(
            torch, serve_mod, engine_mod, argv, params=params,
            hook=_zeroing(rows_c, names))
        controls[what] = _decode_vs_forward(torch, engine.model, params,
                                            comps_c, first_c, rows_c)
    print(json.dumps({"phase": "F2 bf16 decode vs forward",
                      "max_abs_err": bf16_err, "forward_vs_forward": noise,
                      "controls_max_abs_err": controls,
                      "tolerance": RWKV_BF16_ATOL}), flush=True)
    check(bf16_err <= RWKV_BF16_ATOL,
          f"F2: bf16 decode logits {bf16_err} from the forward's")
    for what, err in controls.items():
        check(err > RWKV_BF16_ATOL,
              f"F2: the control with {what} sits within {RWKV_BF16_ATOL} "
              f"({err}): the limit cannot tell it from a sound decode")
    _profile_decode_window(torch, "F2 profile decode", engine_mod,
                           engine.cfg, engine.store,
                           [c.prompt for c in comps], paged=True)
    del engine
    gc.collect()
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    p32 = {k: v.float() for k, v in params.items()}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    store = AdapterStore(p32, device="cuda")
    rows = {}
    engine, comps, dt, first = _api_serve(
        torch, engine_mod, cfg, store, (None,), hook=_record_rows(rows),
        paged=True)
    check(not engine.paged, "F2: rwkv6 served a paged layout")
    worst = _decode_vs_forward(torch, engine.model, p32, comps, first, rows)
    print(json.dumps({"phase": "F2 decode vs forward",
                      "max_abs_err_f32": worst, "max_abs_err_bf16": bf16_err,
                      "f32_seconds": dt, "tolerance": LOGITS_BF16_ATOL}),
          flush=True)
    check(worst <= LOGITS_BF16_ATOL,
          f"F2: f32 decode logits {worst} from the forward's")
    for kw, what in (({"spec_k": SPEC_K}, "speculative decoding"),
                     ({"prefill_chunk": 32}, "chunked prefill")):
        try:
            ServeEngine(cfg, store, n_slots=2, max_len=128, paged=True,
                        device="cuda", **kw)
        except ValueError as e:
            check("no pageable state" in str(e) and what in str(e),
                  f"F2: {kw} raised {e}")
        else:
            fail(f"F2: {kw} did not raise")
    print(json.dumps({"phase": "F2 paged-only options raise",
                      "spec_k": True, "prefill_chunk": True}), flush=True)
    del engine, store, p32
    gc.collect()


def _api_serve(torch, engine_mod, cfg, store, users, hook=None, **kw):
    """Phase 4's mix through the ServeEngine API (a config the CLIs have
    no flag for): 6 requests round-robin over ``users`` and 2 for the
    base, 96 + 32 tokens, 4 slots; (engine, completions, seconds,
    first-step logits by rid)."""
    import numpy as np

    def run():
        engine = engine_mod.ServeEngine(cfg, store, n_slots=4, max_len=128,
                                        seed=0, device="cuda", **kw)
        if hook is not None:
            hook(engine)
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab, (8, 96), dtype=np.int32)
        for i in range(8):
            engine.submit(engine_mod.Request(
                prompt=prompts[i], max_new=32,
                user=users[i % len(users)] if i < 6 else None))
        t0 = time.perf_counter()
        comps = engine.run()
        torch.cuda.synchronize()
        return engine, comps, time.perf_counter() - t0
    (engine, comps, dt), first = _recorded(torch, engine_mod, run)
    return engine, comps, dt, first


def f3_train(torch, paths, cfg=None):
    """F3's training phase: 2 fused steps through the Trainer, the fused
    loss against the materialized one (every Mamba forward on the
    ``selective_scan`` kernel), launches and one profiled step; ``cfg``
    F3's cut by default."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import MezoConfig
    from repro_torch.kernels import ops
    from repro_torch.runtime import Trainer, TrainerConfig
    if cfg is None:
        cfg = dataclasses.replace(get_config("jamba-v0.1-52b"),
                                  n_layers=JAMBA_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, TrainerConfig(optimizer="mezo-fused",
                                    mezo=MezoConfig(eps=1e-3, lr=1e-4),
                                    n_steps=2, log_every=1, seed=0,
                                    device="cuda"),
                 _batches(cfg, TRAIN_B, TRAIN_S))
    params = tr.init_params()
    batch = _first_batch(torch, cfg, TRAIN_B, TRAIN_S)
    _fused_vs_materialized(torch, "F3", cfg, params, batch, paths,
                           routing=True)
    # the trace of that gap: the same weights and batch with capacity for
    # every token (no drops); the dense-FFN variant follows below
    _fused_vs_materialized(
        torch, "F3 capacity for every token", dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.topk), params, batch,
        paths, routing=True)
    ops.reset_launches()
    t0 = time.perf_counter()
    tr.train(params)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _snapshot(ops)
    paths["F3 train"] = launches
    check(len(tr.losses) == 2 and all(math.isfinite(x) for x in tr.losses),
          f"F3 losses {tr.losses}")
    _check_tc("F3 train", launches, ["zo_matmul"])
    # every Mamba forward through the selective_scan kernel: the fused
    # checks' forwards ran before the reset, the 2 steps' 4 after it
    n_mamba = cfg.n_layers // cfg.block_len * (cfg.block_len - 1)
    check(launches["selective_scan"] == 4 * n_mamba,
          f"F3 train: {launches['selective_scan']} selective_scan launches "
          f"for {4 * n_mamba} Mamba forwards")
    state = tr.strategy.init_state(params, tr.tcfg.mezo)
    step_s, state = _timed_steps(torch, tr.strategy, tr.model.loss, state,
                                 batch, tr.tcfg.mezo, 1)
    _phase_line(torch, "F3 train", dt, launches, arch=cfg.name,
                n_layers=cfg.n_layers, losses=tr.losses, step_s=step_s,
                tokens_per_s=TRAIN_B * TRAIN_S / step_s)
    profile_train(torch, tr, state, batch, label="F3 profile step",
                  count=False)
    del tr, state, batch, params
    torch.cuda.empty_cache()


def f3_hybrid(torch, paths):
    """F3: jamba-v0.1-52b at full width, one super-block deep, through
    the Trainer and ServeEngine APIs."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import AdapterStore
    from repro_torch.serve import engine as engine_mod
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"),
                              n_layers=JAMBA_LAYERS)
    f3_train(torch, paths, cfg)

    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    # one replayed user beside the base: each is a 27 GB copy of the cut
    store = AdapterStore(params, device="cuda")
    store.import_checkpoint("alice", str(WORK / "alice"))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rows = {}
    engine, plain, dt, first = _api_serve(
        torch, engine_mod, cfg, store, ("alice",),
        hook=_record_rows(rows), paged=True, page_size=16, prefill_chunk=32)
    launches = _snapshot(ops)
    paths["F3 serve"] = launches
    for c in plain:
        rows[(c.rid, 0)] = first[c.rid]
        check(c.tokens.shape == (32,) and 0 <= int(c.tokens.min())
              and int(c.tokens.max()) < cfg.vocab
              and torch.isfinite(first[c.rid]).all().item(),
              f"F3 rid {c.rid}: bad tokens or logits")
    _check_paged_bodies("F3 serve", launches)
    check(launches["flash_prefill"] > 0 and launches["flash_decode"] > 0,
          "F3: the paged kernels did not launch")
    st = engine.stats
    _phase_line(torch, "F3 serve", dt, launches, decode_tok_s=st.decode_tps,
                ttft_avg_s=st.ttft_s / len(plain),
                decode_steps=st.decode_steps)
    _profile_decode_window(torch, "F3 profile decode", engine_mod, cfg,
                           store, [c.prompt for c in plain[:4]], paged=True,
                           page_size=16)
    # speculative at the config itself: launches, acceptance, and the
    # tokens against the plain run's: in bf16 a verify window and a
    # decode step can route a token to other experts (top-k over router
    # logits a rounding apart), after which the tokens part by more than
    # a near-tie; such a part must come with a witnessed routing
    # difference
    calls = {}
    ops.reset_launches()
    engine, spec, dt, _ = _api_serve(
        torch, engine_mod, cfg, store, ("alice",),
        hook=_count_calls(calls), paged=True, page_size=16,
        prefill_chunk=32, spec_k=SPEC_K)
    launches = _snapshot(ops)
    paths["F3 spec"] = launches
    n_attn = cfg.n_layers // cfg.block_len         # one attention a block
    for name, fn in (("flash_decode", "decode_step"),
                     ("flash_verify", "verify_window")):
        check(launches[name] == n_attn * calls.get(fn, 0) > 0,
              f"F3 spec: {launches[name]} {name} launches for "
              f"{calls.get(fn, 0)} {fn} calls")
    _check_paged_bodies("F3 spec", launches)
    first_diff = _first_diffs(spec, plain)
    st = engine.stats
    _phase_line(torch, "F3 spec", dt, launches, spec_k=SPEC_K,
                accept_rate=st.spec_accept_rate, rounds=st.decode_steps,
                decode_tok_s=st.decode_tps, calls=calls,
                identical_requests=len(spec) - len(first_diff),
                plain_logit_gaps={rid: abs(rows[(rid, j)][w]
                                           - rows[(rid, j)][g]).item()
                                  for rid, (j, w, g) in first_diff.items()})
    del engine
    # the near-tie rule, save where the witness finds the two runs' MoE
    # routing parted at or before the token (a top-k flip or a drop)
    witness = _routing_witness(torch, engine_mod, cfg, store, first_diff,
                               plain, spec)
    for rid, (j, want, got) in first_diff.items():
        gap = abs(rows[(rid, j)][want] - rows[(rid, j)][got]).item()
        check(gap <= LOGITS_BF16_ATOL
              or witness[rid]["first_difference"] is not None,
              f"F3 spec rid {rid}: token {j} is {got}, plain {want}, plain "
              f"logits {gap} apart and no routing difference before it")
    del store, params, model
    gc.collect()
    torch.cuda.empty_cache()
    # held to plain decode under the near-tie rule where no routing flip
    # is in the comparison: the config in f32 with capacity for every
    # token (the base drafting for itself: a user's copy does not fit
    # beside a 52 GB base), and in bf16 with dense FFNs for a user
    f32 = dataclasses.replace(cfg, dtype="float32",
                              capacity_factor=cfg.n_experts / cfg.topk)
    for label, c, users in (("F3 spec tokens f32", f32, (None,)),
                            ("F3 spec tokens dense-ffn",
                             dataclasses.replace(cfg, n_experts=0),
                             ("alice",))):
        model = build_model(c)
        store = AdapterStore(
            model.init(torch.Generator(device="cuda").manual_seed(0),
                       "cuda"), device="cuda")
        if "alice" in users:
            store.import_checkpoint("alice", str(WORK / "alice"))
        rows = {}
        _, plain, _, first = _api_serve(
            torch, engine_mod, c, store, users, hook=_record_rows(rows),
            paged=True, page_size=16, prefill_chunk=32)
        for p in plain:
            rows[(p.rid, 0)] = first[p.rid]
        engine, spec, _, _ = _api_serve(
            torch, engine_mod, c, store, users, paged=True, page_size=16,
            prefill_chunk=32, spec_k=SPEC_K)
        first_diff = _first_diffs(spec, plain)
        gaps = _near_tie_gaps(label, first_diff, rows)
        if not c.n_experts:             # F3's fused gap with MoE off
            _fused_vs_materialized(torch, "F3 dense-ffn", c,
                                   store.materialize(None),
                                   _first_batch(torch, c, TRAIN_B, TRAIN_S),
                                   paths)
        print(json.dumps({"phase": label, "dtype": c.dtype,
                          "n_experts": c.n_experts, "users": users,
                          "requests": len(spec),
                          "identical_requests": len(spec) - len(first_diff),
                          "accept_rate": engine.stats.spec_accept_rate,
                          "near_tie_gaps": gaps,
                          "tolerance": LOGITS_BF16_ATOL}), flush=True)
        del engine, store, model, plain, spec
        gc.collect()
        torch.cuda.empty_cache()


def _route_rows(calls, table, which):
    """An ``_api_serve`` hook: for every ``which`` call of the engine's
    model (``decode_step`` or ``verify_window``), each written row's
    routing in every MoE layer, as ``_route`` gives it, into
    table[(rid, index of the token the row's logits pick)]. A verify
    row past the accepted prefix is written again next round, so the
    last write is the row whose token was kept."""
    import dataclasses

    import numpy as np

    def hook(engine):
        fn = getattr(engine.model, which)
        k = engine.cfg.topk

        def call(params, cache, toks, pos, pages=None, write_mask=None):
            calls.clear()
            out = fn(params, cache, toks, pos, pages=pages,
                     write_mask=write_mask)
            live = (np.repeat(engine._active[:, None], toks.shape[1], 1)
                    if write_mask is None else
                    write_mask.cpu().numpy().reshape(toks.shape[0], -1))
            for slot, w in zip(*np.nonzero(live)):
                rid = engine._req[slot].rid
                table[(rid, len(engine._out[slot]) + int(w))] = [
                    _route(c, k, slot, w) for c in calls]
            return out
        engine.model = dataclasses.replace(engine.model, **{which: call})
    return hook


def _routing_witness(torch, engine_mod, cfg, store, first_diff, plain, spec):
    """F3's second witness for the routing cause: the plain and the
    speculative run again with every MoE layer's routing recorded by
    token (``_route_rows``: decode steps in the plain run, verify windows
    in the speculative one). For each request that parted at token j:
    the first (token, layer) at or before j whose top-k experts differ
    between the two runs or loses an assignment past capacity in one of
    them, with the router's k-th vs (k + 1)-th logit margin in each, and
    the margins at j, by rid. The reruns must reproduce both runs'
    tokens."""
    if not first_diff:
        return {}
    dec, ver, calls = {}, {}, []
    with _routing(torch, calls):
        _, plain2, _, _ = _api_serve(
            torch, engine_mod, cfg, store, ("alice",),
            hook=_route_rows(calls, dec, "decode_step"), paged=True,
            page_size=16, prefill_chunk=32)
        _, spec2, _, _ = _api_serve(
            torch, engine_mod, cfg, store, ("alice",),
            hook=_route_rows(calls, ver, "verify_window"), paged=True,
            page_size=16, prefill_chunk=32, spec_k=SPEC_K)
    check([c.tokens.tolist() for c in plain2] == [c.tokens.tolist()
                                                  for c in plain]
          and [c.tokens.tolist() for c in spec2] == [c.tokens.tolist()
                                                     for c in spec],
          "F3 routing witness: the reruns gave other tokens")
    out = {}
    for rid, (j, want, got) in first_diff.items():
        flip = None
        for t in range(1, j + 1):       # token 0 is the shared prefill's
            for layer, (a, b) in enumerate(zip(dec[(rid, t)],
                                               ver[(rid, t)])):
                if a[0] != b[0] or a[2] != b[2]:
                    flip = {"token": t, "moe_layer": layer,
                            "decode_experts": a[0], "verify_experts": b[0],
                            "decode_margin": a[1], "verify_margin": b[1],
                            "decode_dropped": a[2], "verify_dropped": b[2]}
                    break
            if flip:
                break
        out[rid] = {"token": j, "plain": want, "spec": got,
                    "first_difference": flip,
                    "margins_at_token": {
                        "decode": [r[1] for r in dec[(rid, j)]],
                        "verify": [r[1] for r in ver[(rid, j)]]}}
    print(json.dumps({"phase": "F3 spec routing witness", "topk": cfg.topk,
                      "requests": out}), flush=True)
    return out


def _first_diffs(spec, plain):
    """{rid: (first differing index, plain token, other)} of two runs'
    completions."""
    out = {}
    for a, b in zip(spec, plain):
        check(a.rid == b.rid and a.tokens.shape == b.tokens.shape,
              f"rid {a.rid}: completions differ in shape")
        ne = (a.tokens != b.tokens).nonzero()[0]
        if ne.size:
            out[a.rid] = (int(ne[0]), int(b.tokens[ne[0]]),
                          int(a.tokens[ne[0]]))
    return out


def f4_encdec(torch, paths, paged_argv, dense_argv):
    """F4: whisper-base at full width and depth: the train CLI with the
    enc_embeds stub, then paged serving of token-only requests held to
    the dense-layout engine."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve import engine as engine_mod
    arch = "whisper-base"
    tr, batch = _cli_train(torch, paths, "F4", arch, TRAIN_STEPS)
    _fused_vs_materialized(torch, "F4", tr.mcfg, tr.params, batch, paths)
    del tr, batch
    torch.cuda.empty_cache()
    argv = _family_argv(paged_argv, arch)
    _, engine, comps, _ = _serve_family(torch, paths, "F4 serve", argv)
    cross = engine.cache["dec_blocks"]["cross"]
    check(not cross["xk"].any().item() and not cross["xv"].any().item(),
          "F4: serving wrote the cross-attention state")
    _check_paged_bodies("F4 serve", paths["F4 serve"])
    del engine, cross
    dense = _family_argv(dense_argv, arch)
    _, _, dense_comps, _, _ = _serve(torch, serve_mod, engine_mod, dense)
    same, gaps = _hold_to_plain(torch, "F4", dense, None, comps, dense_comps)
    print(json.dumps({"phase": "F4 paged vs dense tokens",
                      "identical_requests": same, "requests": len(comps),
                      "near_tie_gaps": gaps,
                      "tolerance": LOGITS_BF16_ATOL}), flush=True)


def f5_dense(torch, paths):
    """F5: the five other dense configs at full width, 2 layers each: the
    fused loss against the materialized one; a chunked prefill and
    decode steps over a page pool against the dense forward; every
    attention on its kernel at the config's head dim."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    for arch in F5_ARCHS:
        cfg = dataclasses.replace(get_config(arch), n_layers=DENSE_LAYERS)
        model = build_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
        batch = _first_batch(torch, cfg, TRAIN_B, TRAIN_S)
        label = f"F5 {arch}"
        fused = _fused_vs_materialized(torch, label, cfg, params, batch,
                                       paths)
        check(fused["flash_attention"] == DENSE_LAYERS,
              f"{label}: {fused['flash_attention']} flash_attention "
              f"launches for {DENSE_LAYERS} layers")
        # paged: a 64-token prompt in chunks of 32, then 8 decode steps
        b, ps = 2, 16
        n_live = -(-(F5_PROMPT + F5_DECODE) // ps)
        pages = torch.arange(1, 1 + b * n_live, dtype=torch.int32,
                             device="cuda").reshape(b, n_live)
        toks = batch["tokens"][:b, :F5_PROMPT + F5_DECODE].long()
        cache = model.init_paged_cache(b, 1 + b * n_live, ps, device="cuda")
        ops.reset_launches()
        got = []
        with torch.no_grad():
            for c in range(0, F5_PROMPT, F5_CHUNK):
                lg, cache = model.prefill_chunk(
                    params, cache, toks[:, c:c + F5_CHUNK],
                    torch.full((b,), c, dtype=torch.int32, device="cuda"),
                    pages=pages)
                got.append(lg)
            for t in range(F5_PROMPT, F5_PROMPT + F5_DECODE):
                lg, cache = model.decode_step(params, cache,
                                              toks[:, t:t + 1], t,
                                              pages=pages)
                got.append(lg)
            torch.cuda.synchronize()
            launches = _snapshot(ops)
            ref, _ = model.forward(params, {"tokens": toks})
        worst = (torch.cat(got, dim=1).float() - ref.float()).abs().max()
        worst = worst.item()
        chunks = F5_PROMPT // F5_CHUNK
        want = {"flash_prefill": DENSE_LAYERS * chunks,
                "flash_decode": DENSE_LAYERS * F5_DECODE}
        paths[label] = {k: fused[k] + launches[k] for k in launches}
        check(all(launches[k] == n for k, n in want.items()),
              f"{label}: paged launches {launches} != {want}")
        _check_paged_bodies(label, launches)
        wall_us, by_name, n_events = _profiled(
            torch, lambda: model.decode_step(
                params, cache, toks[:, -1:], F5_PROMPT + F5_DECODE - 1,
                pages=pages))
        _profile_line(f"{label} profile decode", wall_us, by_name,
                      n_events, decode_steps=1)
        _phase_line(torch, label, time.perf_counter() - t0,
                    paths[label], head_dim=cfg.resolved_head_dim,
                    heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
                    paged_vs_dense_max_abs_err=worst,
                    tolerance=LOGITS_BF16_ATOL)
        check(worst <= LOGITS_BF16_ATOL,
              f"{label}: paged logits {worst} from the dense forward's")
        del params, batch, cache, model, ref, got
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# UF1-UF4: the multi-tenant step of the other families (the user-axis
# forward of MoE, RWKV-6, the mamba hybrid and the encoder-decoder)

UF_MZ = dict(eps=1e-3, lr=1e-4)          # the train_fleet CLI's defaults
UF2_USERS, UF2_SLOTS, UF2_STEPS, UF2_B = 3, 2, 2, 4
UF3_SEEDS, UF3_COEFFS = [4242, 77], [1e-3, -1e-3]


@contextlib.contextmanager
def _lane_drops(torch, out):
    """Record each ``moe_apply`` call's token count and the assignments
    it drops past its capacity (a tensor on the card: no host sync), the
    routing recomputed as ``moe_apply`` computes it."""
    import torch.nn.functional as F
    from repro_torch.models import moe
    orig = moe.moe_apply

    def recording(cfg, p, x):
        xf = x.reshape(-1, x.shape[-1])
        probs = torch.softmax(xf.to(torch.float32) @ p["router"], dim=-1)
        idx = torch.topk(probs, cfg.topk, dim=-1).indices
        counts = F.one_hot(idx, cfg.n_experts).sum((0, 1))
        c = moe.capacity(xf.shape[0], cfg)
        out.append((xf.shape[0], (counts - c).clamp(min=0).sum()))
        return orig(cfg, p, x)
    moe.moe_apply = recording
    try:
        yield out
    finally:
        moe.moe_apply = orig


def _drops_summary(torch, label, calls, tokens):
    """Every recorded MoE dispatch routed one lane's ``tokens`` against
    that lane's capacity, and some lane dropped past it."""
    seen = {n for n, _ in calls}
    drops = torch.stack([d for _, d in calls]).tolist() if calls else []
    check(seen == {tokens}, f"{label}: MoE dispatches of {sorted(seen)} "
          f"tokens, expected one lane's {tokens}")
    check(max(drops, default=0) > 0,
          f"{label}: no lane dropped an assignment past its capacity")
    return {"moe_dispatches": len(calls), "tokens_a_dispatch": tokens,
            "dispatches_dropping": sum(d > 0 for d in drops),
            "assignments_dropped": sum(drops)}


def _uf_lone(torch, label, cfg, results, store, root, steps,
             batches=None):
    """Each user of ``results`` against a lone Trainer (``_lone_trainer``:
    the derived seed, the seeded init, the user's batches): losses,
    parameters and replay-log bytes at atol 0. Returns the seconds."""
    from repro_torch.core.engine import MezoConfig
    store.cache_bytes = 1          # keep one materialized user at a time
    t0 = time.perf_counter()
    for r in results:
        losses, final = _lone_trainer(
            torch, cfg, r.user, "none", MezoConfig(**UF_MZ),
            root / f"lone_{r.user}", steps=steps,
            batches=None if batches is None else batches(r.user))
        check(r.losses == losses, f"{label} {r.user}: losses {r.losses} "
              f"!= lone {losses}")
        mat = store.materialize(r.user)
        for k, leaf in final.items():
            check(_same_leaf(torch, leaf, mat[k]),
                  f"{label} {r.user}: {k} differs from the lone run")
        log = (root / "engine" / f"{r.user}.jsonl").read_bytes()
        check(log == (root / f"lone_{r.user}" / "replay.jsonl").read_bytes(),
              f"{label} {r.user}: replay log differs from the lone run's")
        del final, mat
        torch.cuda.empty_cache()
    return time.perf_counter() - t0


def _uf_cli(torch, paths, label, arch, users, slots, steps, bsz, root,
            record_drops=False):
    """The train_fleet CLI at full width: (engine, results, launches,
    seconds, peak GiB, recorded MoE dispatches)."""
    import shutil
    from repro_torch.kernels import ops
    from repro_torch.launch import train_fleet
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--arch", arch, "--device", "cuda", "--users", str(users),
            "--slots", str(slots), "--steps", str(steps), "--batch",
            str(bsz), "--seq", str(TRAIN_S), "--estimator", "fused",
            "--update", "sgd", "--seed", "0", "--log-dir",
            str(root / "engine"), "--out", str(root / "summary.json")]
    calls: list = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with (_lane_drops(torch, calls) if record_drops
          else contextlib.nullcontext()):
        engine, results = train_fleet.run(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _snapshot(ops)
    paths[label] = launches
    st = engine.stats
    check(st.finished == users and st.user_steps == users * steps,
          f"{label}: {st}")
    check(all(math.isfinite(x) for r in results for x in r.losses),
          f"{label}: losses {[r.losses for r in results]}")
    _check_tc(label, launches, ["zo_matmul_users"])
    check(launches["zo_add_users"] > 0 and launches["zo_matmul"] == 0,
          f"{label}: launches {launches}")
    return (engine, results, launches, dt,
            _gib(torch.cuda.max_memory_allocated()), calls)


def _uf_stats(st, bsz):
    return {"dispatches": st.dispatches, "user_steps": st.user_steps,
            "dispatch_s": st.train_s / st.dispatches,
            "user_steps_per_s": st.user_steps_per_s,
            "tokens_per_s": st.user_steps * bsz * TRAIN_S / st.train_s}


def uf1_moe_fleet(torch, paths):
    """UF1: granite-moe-1b-a400m at full depth through the ``train_fleet``
    CLI (6 users on 4 slots, 3 fused sgd steps each, B 8 x 128): each
    lane's MoE dispatch alone (its own capacity, recorded: some lane
    drops), every user against a lone Trainer at atol 0, one dispatch
    under the profiler."""
    label, arch = "UF1 moe fleet", "granite-moe-1b-a400m"
    root = WORK / "uf1"
    engine, results, launches, dt, peak, calls = _uf_cli(
        torch, paths, label, arch, FLEET_USERS, FLEET_SLOTS, FLEET_STEPS,
        TRAIN_B, root, record_drops=True)
    check(launches["zo_add"] > 0, f"{label}: no expert through zo_add")
    drops = _drops_summary(torch, label, calls, TRAIN_B * TRAIN_S)
    st, cfg, store = engine.stats, engine.cfg, engine.store
    u4_profile(torch, engine, label="UF1 profile")
    del engine, calls
    torch.cuda.empty_cache()
    lone_s = _uf_lone(torch, label, cfg, results, store, root, FLEET_STEPS)
    _phase_line(torch, label, dt, launches, arch=arch, users=FLEET_USERS,
                slots=FLEET_SLOTS, steps=FLEET_STEPS,
                batch=[TRAIN_B, TRAIN_S], peak_memory_gib=peak,
                **_uf_stats(st, TRAIN_B), drop_recorder_on=True, **drops,
                lanes_bit_equal_lone_trainers=True,
                lone_check_seconds=lone_s,
                losses={r.user: r.losses for r in results})


def uf2_rwkv_fleet(torch, paths):
    """UF2: rwkv6-7b at full depth through the ``train_fleet`` CLI (3
    users on 2 slots, 2 steps, B 4 x 128): every user against a lone
    Trainer at atol 0."""
    label, arch = "UF2 rwkv fleet", "rwkv6-7b"
    root = WORK / "uf2"
    engine, results, launches, dt, peak, _ = _uf_cli(
        torch, paths, label, arch, UF2_USERS, UF2_SLOTS, UF2_STEPS, UF2_B,
        root)
    check(launches["zo_add"] == 0, f"{label}: a scalar zo_add launched")
    st, cfg, store = engine.stats, engine.cfg, engine.store
    del engine
    torch.cuda.empty_cache()
    from repro_torch.launch.train_fleet import user_batches
    lone_s = _uf_lone(torch, label, cfg, results, store, root, UF2_STEPS,
                      batches=lambda u: user_batches(cfg, u, UF2_B, TRAIN_S,
                                                     0))
    _phase_line(torch, label, dt, launches, arch=arch, users=UF2_USERS,
                slots=UF2_SLOTS, steps=UF2_STEPS, batch=[UF2_B, TRAIN_S],
                peak_memory_gib=peak, **_uf_stats(st, UF2_B),
                lanes_bit_equal_lone_trainers=True,
                lone_check_seconds=lone_s,
                losses={r.user: r.losses for r in results})


def uf3_hybrid_shared_base(torch, paths):
    """UF3: jamba-v0.1-52b cut to one super-block (F3's 8 sublayers): the
    user-axis fused loss over one shared bf16 base, U = 2 lanes (two
    seeds, one sign each), each lane's MoE dispatch alone, each Mamba
    forward one ``selective_scan`` launch over both lanes; every lane's
    loss against the scalar fused loss at atol 0; peak memory."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import PerturbCtx
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    label = "UF3 hybrid shared base"
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"),
                              n_layers=JAMBA_LAYERS)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    batch = _first_batch(torch, cfg, TRAIN_B, TRAIN_S)
    u = len(UF3_SEEDS)
    lanes = {k: v[None].expand(u, *v.shape) for k, v in batch.items()}
    calls: list = []
    with torch.no_grad():
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        with _lane_drops(torch, calls):
            got = model.loss({k: v[None] for k, v in params.items()}, lanes,
                             perturb=PerturbCtx(seed=UF3_SEEDS,
                                                coeff=UF3_COEFFS))
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        launches = _snapshot(ops)
        peak = torch.cuda.max_memory_allocated()
        paths[label] = launches
        scalar = [model.loss(params, batch, perturb=PerturbCtx(s, c)).item()
                  for s, c in zip(UF3_SEEDS, UF3_COEFFS)]
    got = got.tolist()
    drops = _drops_summary(torch, label, calls, TRAIN_B * TRAIN_S)
    _phase_line(torch, label, fwd_s, launches, arch=cfg.name,
                n_layers=cfg.n_layers, lanes=u, batch=[TRAIN_B, TRAIN_S],
                peak_memory_gib=_gib(peak), resident_gib=_gib(resident),
                peak_over_resident_gib=_gib(peak - resident), losses=got,
                scalar_losses=scalar, **drops)
    check(got == scalar, f"{label}: lane losses {got} != scalar {scalar}")
    check(peak < 80e9, f"{label}: peak {peak} bytes")
    _check_tc(label, launches, ["zo_matmul_users"])
    check(launches["zo_add"] > 0 and launches["zo_matmul"] == 0,
          f"{label}: launches {launches}")
    # every Mamba forward through the kernel, one launch over both lanes
    n_mamba = cfg.n_layers // cfg.block_len * (cfg.block_len - 1)
    check(launches["selective_scan"] == n_mamba,
          f"{label}: {launches['selective_scan']} selective_scan launches "
          f"for {n_mamba} Mamba forwards")


def _enc_batches(cfg, user, bsz):
    """The train_fleet CLI's stream for ``user`` (B ``bsz`` x TRAIN_S,
    seed 0) with the audio frontend stub beside it: ``enc_embeds`` (B,
    T_enc, d) normals from a (user, step) seed. (The CLI makes none.)"""
    import zlib

    import numpy as np
    from repro_torch.launch.train_fleet import user_batches
    base = user_batches(cfg, user, bsz, TRAIN_S, 0)
    salt = zlib.crc32(f"0/{user}/enc".encode()) & 0x7FFFFFFF

    def fn(step):
        b = base(step)
        b["enc_embeds"] = np.random.default_rng((salt, step)).standard_normal(
            (bsz, cfg.enc_len, cfg.d_model), dtype=np.float32)
        return b
    return fn


def uf4_encdec_engine(torch, paths):
    """UF4: whisper-base at full depth through the ``TrainEngine`` (4
    users on 4 slots, 3 steps, B 8 x 128 with ``enc_embeds``): every user
    against a lone Trainer at atol 0."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.core.engine import MezoConfig
    from repro_torch.kernels import ops
    from repro_torch.runtime import train_multi_tenant
    from repro_torch.train import TrainJob
    label, users, slots, steps = "UF4 encdec engine", 4, 4, 3
    root = WORK / "uf4"
    shutil.rmtree(root, ignore_errors=True)
    cfg = get_config("whisper-base")
    jobs = [TrainJob(user=f"user-{i}", n_steps=steps,
                     batches=_enc_batches(cfg, f"user-{i}", TRAIN_B))
            for i in range(users)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    engine, results = train_multi_tenant(
        cfg, jobs, n_slots=slots, seed=0, mezo_cfg=MezoConfig(**UF_MZ),
        log_dir=str(root / "engine"), log_fn=lambda s: None, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _snapshot(ops)
    paths[label] = launches
    peak = _gib(torch.cuda.max_memory_allocated())
    st, store = engine.stats, engine.store
    check(st.finished == users and st.user_steps == users * steps,
          f"{label}: {st}")
    _check_tc(label, launches, ["zo_matmul_users"])
    check(launches["zo_add_users"] > 0 and launches["zo_matmul"] == 0,
          f"{label}: launches {launches}")
    del engine
    torch.cuda.empty_cache()
    lone_s = _uf_lone(torch, label, cfg, results, store, root, steps,
                      batches=lambda u: _enc_batches(cfg, u, TRAIN_B))
    _phase_line(torch, label, dt, launches, arch=cfg.name, users=users,
                slots=slots, steps=steps, batch=[TRAIN_B, TRAIN_S],
                enc_len=cfg.enc_len, peak_memory_gib=peak,
                **_uf_stats(st, TRAIN_B), lanes_bit_equal_lone_trainers=True,
                lone_check_seconds=lone_s,
                losses={r.user: r.losses for r in results})


# ---------------------------------------------------------------------------
# FL1, A1, ST1, P1: the async elastic fleet, the gradient baseline, the
# straggler arm and the data pipeline (OPT-1.3B at full width, bf16)

FLEET_ARGV = ["--arch", "opt-1.3b", "--device", "cuda", "--workers", "4",
              "--stragglers", "1", "--straggler-scale", "5",
              "--duplicate-every", "3", "--directions", "2",
              "--staleness-decay", "0.95", "--batch", str(TRAIN_B),
              "--seq", str(TRAIN_S), "--seed", "0"]
FLEET_LEASES = 24           # FL1's applied leases
FLEET_VMAPDIR_STEPS = 4     # FL1's fused-vs-materialized schedule check
# A1: |gs - <g, z>| for RoBERTa-large (f32), the fused SPSA estimate
# against autograd's gradient projected on the same z, stated before the
# first run: 5 % of |<g, z>| plus 5e-3 (f32 loss noise over 2 eps), at
# eps 1e-4, where the central difference's O(eps^2) curvature term is
# 100x under its value at the training eps 1e-3 (reported beside it: a
# reduced RoBERTa on the CPU reads 0.8-11 % off at 1e-3, 1e-5 at 1e-4)
ADAM_SPSA_EPS = 1e-4
ADAM_SPSA_RTOL, ADAM_SPSA_ATOL = 5e-2, 5e-3


def _fleet_run(torch, argv, hold_version=None):
    """``repro_torch.launch.fleet.run(argv)``, counting lease
    evaluations; with ``hold_version``, the first lease issued at that
    version or later is copied to the host at issue. Returns (sim,
    report, replay_ok, evaluations, (lease, host copy) or None)."""
    from repro_torch.launch import fleet as fleet_cli
    from repro_torch.runtime import fleet as fleet_mod
    evaluate, next_lease = (fleet_mod.FleetSim._evaluate,
                            fleet_mod.FleetCoordinator.next_lease)
    evals, held = [0], []

    def counted(self, w, lease):
        evals[0] += 1
        return evaluate(self, w, lease)

    def holding(self, worker, now):
        lease = next_lease(self, worker, now)
        if (lease is not None and not held and hold_version is not None
                and lease.version >= hold_version):
            held.append((lease, {k: v.cpu()
                                 for k, v in lease.params.items()}))
        return lease

    fleet_mod.FleetSim._evaluate = counted
    fleet_mod.FleetCoordinator.next_lease = holding
    try:
        sim, rep, ok = fleet_cli.run(argv)
    finally:
        fleet_mod.FleetSim._evaluate = evaluate
        fleet_mod.FleetCoordinator.next_lease = next_lease
    return sim, rep, ok, evals[0], (held[0] if held else None)


def _fleet_launches(label, launches, cfg, evals, applies, fused):
    """Launches the fleet CLI must make, read off the code: a lease
    evaluation runs 2K forwards (fused: each projection one
    ``zo_matmul``, each norm/bias leaf one ``zo_add``; vmapdir: one
    ``zo_add`` sweep of every leaf a forward, the forward plain), an
    apply (live, or of the log's replay) K ``zo_add`` sweeps of every
    leaf."""
    fwd_mm, fwd_add, n_leaves = _forward_counts(cfg)
    k = 2
    want = {"zo_matmul": evals * 2 * k * fwd_mm if fused else 0,
            "zo_add": (evals * 2 * k * (fwd_add if fused else n_leaves)
                       + applies * k * n_leaves),
            "flash_attention": 0, "zo_matmul_q": 0, "zo_add_q": 0}
    got = {name: launches[name] for name in want}
    print(json.dumps({"phase": f"{label} launches", "launches": got,
                      "expected": want, "evaluations": evals}), flush=True)
    check(got == want, f"{label}: launches {got} != expected {want}")
    if fused:
        _check_tc(label, launches, ["zo_matmul"])


def fl1_fleet(torch, paths):
    """FL1: the fleet CLI at full width (24 leases, K 2, 4 flagship
    workers, a x5 straggler, duplicate deliveries, a join and a leave),
    --verify-replay from theta_0; a held lease's snapshot and theta_0
    bit-unchanged; a profiled lease evaluation; then 4 steps fused and
    with --estimator vmapdir: the same schedule, losses within
    OPT_FUSED_ATOL."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.fleet import DirectionLease
    log = WORK / "fleet.jsonl"
    log.unlink(missing_ok=True)
    argv = FLEET_ARGV + ["--steps", str(FLEET_LEASES), "--join-after", "6",
                         "--leave-after", "12", "--log", str(log),
                         "--verify-replay"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    sim, rep, ok, evals, held = _fleet_run(torch, argv, hold_version=3)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = _snapshot(ops)
    paths["FL1 fleet"] = launches
    check(ok is True, f"FL1: replay from theta_0 not bit-exact ({ok})")
    check(rep.applied == FLEET_LEASES and rep.dropped >= 1
          and rep.resizes == 2 and max(rep.staleness) >= 1,
          f"FL1: applied {rep.applied}, dropped {rep.dropped}, resizes "
          f"{rep.resizes}, max staleness {max(rep.staleness)}")
    check(all(math.isfinite(x) for x in rep.losses),
          f"FL1 losses {rep.losses}")
    _fleet_launches("FL1 fleet", launches, sim.model_cfg, evals,
                    2 * rep.applied, fused=True)      # live + replay
    check(held is not None, "FL1: no lease was issued at version >= 3")
    lease, copy = held
    same = all(torch.equal(v.cpu(), copy[k])
               for k, v in lease.params.items())
    del copy
    fresh = sim.model.init(torch.Generator(device="cuda").manual_seed(0),
                           torch.device("cuda"))
    theta0 = all(torch.equal(fresh[k], v)
                 for k, v in sim.base_params.items())
    del fresh
    check(same and theta0, f"FL1: a held snapshot was written (lease at "
          f"version {lease.version}: {same}; theta_0: {theta0})")
    w = sim.workers[0]
    probe = DirectionLease(step=0, seed=sim.coord.step_seed(0), k=2,
                           version=rep.applied, params=rep.params,
                           worker=0, issued_at=0.0)
    wall_us, by_name, n_events = _profiled(
        torch, lambda: sim._evaluate(w, probe))
    _phase_line(torch, "FL1 fleet", dt, launches, applied=rep.applied,
                evaluations=evals, reissued=rep.reissued,
                dropped=rep.dropped, resizes=rep.resizes,
                max_staleness=max(rep.staleness),
                applied_per_wall_s=rep.applied / rep.wall_s,
                fleet_wall_s=rep.wall_s, virtual_s=rep.virtual_s,
                max_live_versions=rep.max_live_versions, peak_gib=peak,
                loss_first=rep.losses[0], loss_last=rep.losses[-1],
                replay_bitexact=ok, held_lease_version=lease.version,
                held_lease_unchanged=same)
    _profile_line("FL1 profile lease", wall_us, by_name, n_events,
                  directions=2)
    del sim, rep, lease, probe
    torch.cuda.empty_cache()

    # fused and materialized (vmapdir) evaluations: one schedule
    runs = {}
    for est in ("fused", "vmapdir"):
        ops.reset_launches()
        t0 = time.perf_counter()
        sim, rep, _, evals, _ = _fleet_run(torch, FLEET_ARGV + [
            "--steps", str(FLEET_VMAPDIR_STEPS), "--join-after", "2",
            "--estimator", est])
        torch.cuda.synchronize()
        launches = _snapshot(ops)
        if est == "vmapdir":
            paths["FL1 vmapdir"] = launches
        _fleet_launches(f"FL1 {est}", launches, sim.model_cfg, evals,
                        rep.applied, fused=est == "fused")
        runs[est] = (rep, time.perf_counter() - t0)
        del sim
        torch.cuda.empty_cache()
    (fr, _), (vr, vdt) = runs["fused"], runs["vmapdir"]
    keys = ("step", "seed", "staleness", "mask")
    same = ([[r.get(k) for k in keys] for r in fr.records]
            == [[r.get(k) for k in keys] for r in vr.records]
            and (fr.reissued, fr.dropped, fr.resizes, fr.virtual_s)
            == (vr.reissued, vr.dropped, vr.resizes, vr.virtual_s))
    err = max(abs(a - b) for a, b in zip(fr.losses, vr.losses))
    print(json.dumps({"phase": "FL1 vmapdir", "seconds": vdt,
                      "same_schedule": same, "fused_losses": fr.losses,
                      "vmapdir_losses": vr.losses, "max_abs_err": err,
                      "tolerance": OPT_FUSED_ATOL}), flush=True)
    check(same, "FL1: the vmapdir fleet's schedule differs from the fused")
    check(err <= OPT_FUSED_ATOL, f"FL1 vmapdir: losses {err} apart > "
          f"{OPT_FUSED_ATOL}")


def a1_adam(torch, paths, t1_peak_gib):
    """A1: the train CLI with --optimizer adam (OPT-1.3B, B 8 x 128, 4
    steps): the loss descends; step s and peak memory beside T1's MeZO
    peak (``t1_peak_gib``, this run's, at the same batch); one
    Trainer step with compressed gradients; RoBERTa-large (f32):
    autograd's gradient projected on z against the fused SPSA gs over
    the same z and batch."""
    from repro_torch.core import MezoConfig, dot_with_z, engine, rng
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.models import build_model
    from repro_torch.optim import adam
    from repro_torch.runtime import Trainer, TrainerConfig
    argv = ["--arch", "opt-1.3b", "--optimizer", "adam", "--steps",
            str(TRAIN_STEPS), "--batch", str(TRAIN_B), "--seq",
            str(TRAIN_S), "--log-every", "1", "--seed", "0", "--device",
            "cuda"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    tr = train_mod.run(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    paths["A1 adam"] = _snapshot(ops)
    check(all(math.isfinite(x) for x in tr.losses)
          and tr.losses[-1] < tr.losses[0], f"A1: losses {tr.losses}")
    params, cfg, cli_losses = tr.params, tr.mcfg, tr.losses
    del tr
    torch.cuda.empty_cache()
    batch = _first_batch(torch, cfg, TRAIN_B, TRAIN_S)
    model = build_model(cfg)
    state = adam.adam_init(params)
    acfg = adam.AdamConfig(lr=1e-4)
    adam.grad_train_step(model.loss, params, batch, state, acfg)  # warm
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(2):
        params, state, loss = adam.grad_train_step(model.loss, params,
                                                   batch, state, acfg)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t1) / 2
    del state
    torch.cuda.empty_cache()
    # one Trainer step with int8 gradient compression
    tc = TrainerConfig(optimizer="adam",
                       adam=adam.AdamConfig(lr=1e-4, compress_grads=True),
                       n_steps=1, log_every=1, device="cuda")
    ct = Trainer(cfg, tc, _batches(cfg, TRAIN_B, TRAIN_S),
                 log_fn=lambda m: None)
    before = params["blocks/mlp/w_in/w"].clone()
    ct.train(params)
    moved = not torch.equal(before, params["blocks/mlp/w_in/w"])
    check(len(ct.losses) == 1 and math.isfinite(ct.losses[0]) and moved,
          f"A1 compressed step: loss {ct.losses}, moved {moved}")
    compressed_loss = ct.losses[0]
    del params, ct, before
    torch.cuda.empty_cache()

    # RoBERTa-large (f32): <g, z> against the fused SPSA gs
    rcfg = get_config("roberta-large")
    rmodel = build_model(rcfg)
    rparams = rmodel.init(torch.Generator(device="cuda").manual_seed(0),
                          torch.device("cuda"))
    rbatch = _first_batch(torch, rcfg, TRAIN_B, TRAIN_S)
    loss, grads = adam.value_and_grad(rmodel.loss, rparams, rbatch)
    seed = rng.fold_seed(2024, 0)
    gz = float(dot_with_z(rparams, rng.fold_seed(seed, 0), grads))
    del grads
    gs = {eps: float(engine._eval_fused(
        rmodel.loss, rparams, rbatch, seed,
        MezoConfig(eps=eps, n_directions=1))[1][0])
        for eps in (ADAM_SPSA_EPS, 1e-3)}
    gs, gs_train_eps = gs[ADAM_SPSA_EPS], gs[1e-3]
    err = abs(gs - gz)
    tol = ADAM_SPSA_RTOL * abs(gz) + ADAM_SPSA_ATOL
    print(json.dumps({"phase": "A1 adam", "cli_losses": cli_losses,
                      "run_seconds": dt, "step_s": step_s,
                      "tokens_per_s": TRAIN_B * TRAIN_S / step_s,
                      "peak_memory_gib": peak,
                      "t1_mezo_peak_gib": t1_peak_gib,
                      "peak_over_t1": peak / t1_peak_gib,
                      "compressed_step_loss": compressed_loss,
                      "roberta_loss": float(loss),
                      "roberta_g_dot_z": gz, "roberta_spsa_gs": gs,
                      "spsa_eps": ADAM_SPSA_EPS,
                      "roberta_spsa_gs_eps_1e-3": gs_train_eps,
                      "abs_err": err, "tolerance": tol}), flush=True)
    check(err <= tol, f"A1 roberta: SPSA gs {gs} vs <g, z> {gz}: {err} "
          f"> {tol}")


def st1_stragglers(torch, paths):
    """ST1: the train CLI with --straggler-redundancy 1 --directions 2 (3
    steps, OPT-1.3B, B 8 x 128): every record logs its mask, launches
    read off the code, and a snapshot + replay restore bit-exact."""
    import shutil
    from repro_torch.checkpoint import CheckpointManager, ReplayLog
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    ckpt = WORK / "train_st1"
    shutil.rmtree(ckpt, ignore_errors=True)
    steps = 3
    argv = ["--arch", "opt-1.3b", "--optimizer", "mezo-fused", "--steps",
            str(steps), "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
            "--directions", "2", "--straggler-redundancy", "1",
            "--ckpt-dir", str(ckpt), "--log-every", "1", "--seed", "0",
            "--device", "cuda"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    tr = train_mod.run(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _snapshot(ops)
    paths["ST1 stragglers"] = launches
    fwd_mm, fwd_add, n_leaves = _forward_counts(tr.mcfg)
    k = 3                                   # K 2 + R 1
    want = {"zo_matmul": steps * 2 * k * fwd_mm,
            "zo_add": steps * (2 * k * fwd_add + k * n_leaves),
            "flash_attention": 0}
    got = {name: launches[name] for name in want}
    check(got == want, f"ST1: launches {got} != expected {want}")
    _check_tc("ST1", launches, ["zo_matmul"])
    recs = ReplayLog.read(str(ckpt / "replay.jsonl"))
    masks = [r.get("mask") for r in recs]
    check(len(recs) == steps and all(m is not None and len(m) == k
                                     for m in masks),
          f"ST1: logged masks {masks}")
    mcfg = tr._mezo_cfg()
    mgr = CheckpointManager(str(ckpt), mezo_cfg=mcfg,
                            update_rule=tr.strategy.update)
    like = tr.strategy.init_state(
        {n: torch.empty_like(v) for n, v in tr.params.items()}, mcfg)
    restored, nxt = mgr.restore(like)
    mgr.log.close()
    diff = [n for n in tr.params
            if not torch.equal(restored.params[n], tr.params[n])]
    check(nxt == steps and not diff,
          f"ST1: restore at {nxt}, differs in {diff[:3]}")
    del restored, like
    torch.cuda.empty_cache()
    step_s, _ = _timed_steps(torch, tr.strategy, tr.model.loss,
                             tr.strategy.init_state(tr.params, mcfg),
                             _first_batch(torch, tr.mcfg, TRAIN_B, TRAIN_S),
                             mcfg, 1)
    _phase_line(torch, "ST1 stragglers", dt, launches, losses=tr.losses,
                masks=masks, restore_bit_exact=True, step_s=step_s,
                tokens_per_s=TRAIN_B * TRAIN_S / step_s)
    del tr
    torch.cuda.empty_cache()


def p1_pipeline(torch):
    """P1: DataPipeline to the card: every batch bit-equal to the host's
    and usable at once on the consumer's stream; close() joins a worker
    blocked on a full queue; next() after close() raises."""
    from repro_torch.data import DataPipeline, lm_batches
    vocab = 50272
    t0 = time.perf_counter()
    host = list(lm_batches(TRAIN_B, TRAIN_S, vocab, seed=0, n_steps=6))
    got = list(DataPipeline(lm_batches(TRAIN_B, TRAIN_S, vocab, seed=0,
                                       n_steps=6), device="cuda"))
    sums = [int(b["tokens"].to(torch.int64).sum()) for b in got]
    equal = (len(got) == len(host) and all(
        b[k].is_cuda and torch.equal(b[k].cpu(), torch.from_numpy(h[k]))
        for b, h in zip(got, host) for k in h)
        and sums == [int(h["tokens"].astype("int64").sum()) for h in host])

    def endless():
        while True:
            yield next(lm_batches(TRAIN_B, TRAIN_S, vocab, seed=1))

    pipe = DataPipeline(endless(), device="cuda", prefetch=1)
    next(pipe)
    t1 = time.perf_counter()
    pipe.close()
    close_s = time.perf_counter() - t1
    joined = not pipe._thread.is_alive()
    try:
        next(pipe)
        raised = False
    except RuntimeError as e:
        raised = "closed" in str(e)
    print(json.dumps({"phase": "P1 pipeline", "batches": len(got),
                      "bit_equal": equal, "close_s": close_s,
                      "joined": joined, "next_after_close_raises": raised,
                      "seconds": time.perf_counter() - t0}), flush=True)
    check(equal and joined and raised and close_s < 5.0,
          f"P1: bit_equal {equal}, joined {joined}, raised {raised}, "
          f"close {close_s} s")


# ---------------------------------------------------------------------------
# SH1-SH2, DR1: the multi-device tier (shard offsets, the sharded step, the
# dry run)

# SH1's leaves, split as a 16-way model axis splits them (the sharding
# plan's dim): (kernel, arch, path, shape, split dim, dtypes)
SH1_ADD = (("opt-1.3b", "blocks/mlp/w_in/w", (24, 2048, 8192), 2),
           ("opt-1.3b", "lm_head/w", (2048, 50272), 1),
           ("qwen3-4b", "blocks/mlp/w_in/w", (36, 2560, 9728, 2), 2),
           ("qwen3-4b", "embed/tok", (151936, 2560), 0))
# kimi-k2's expert w_out, one layer, split 16 x 16 on (expert, F) as
# fsdp_params splits it (model x data), in its own dtype, bf16
SH1_KIMI = ("kimi-k2-1t-a32b", "blocks/moe/w_out", (384, 2048, 7168))
# (arch, path of a layer's 2-D slice, (K, N), parallel): column-parallel
# W shards give column slices, row-parallel ones partial sums
SH1_MM = (("opt-1.3b", "lm_head/w", (2048, 50272), "column"),
          ("opt-1.3b", "blocks/mlp/w_out/w", (8192, 2048), "row"),
          ("qwen3-4b", "blocks/attn/wq/w", (2560, 4096), "column"),
          ("qwen3-4b", "blocks/attn/wo/w", (4096, 2560), "row"))
SH_WAYS = 16
# SH2: the sharded step is the mesh-less step's arithmetic on a one-rank
# mesh (the same launches at zero offsets, the EP body's dispatch in the
# same order), so losses, gs and params are held at atol 0; were the EP
# combine to reorder a sum, granite-moe's losses would be held to F1's
# limit, FAMILY_FUSED_ATOL, its gs to that over 2 * eps, and each of its
# leaves to SH2_STEPS steps of (lr x that gs limit, the Rademacher |z| of
# 1, plus one rounding of the leaf's dtype at its largest entry): an
# update of lr * gs * z computed in f32 and rounded once to the leaf.
SH2_STEPS = 2
DR1_CELLS = (("qwen3-4b", "train_4k"), ("granite-moe-1b-a400m", "decode_32k"),
             ("kimi-k2-1t-a32b", "train_4k"))
DR1_MAX_PARAM_BYTES = 80e9      # one H100's memory


def _shard_slices(shape, dim, ways):
    n = shape[dim] // ways
    return [(i * n, n) for i in range(ways)]


def sh1_offsets(torch):
    """SH1: ``zo_add`` on every 16-way shard of full-width leaves at its
    offsets equals the whole launch's slice at atol 0 (Rademacher and
    Gaussian, f32 and bf16; kimi-k2's expert leaf 16 x 16 in bf16); the
    column-parallel ``zo_matmul`` shards equal the whole product's column
    slice, the row-parallel partial sums add up to it, within the
    kernel's limits; the plain versions at offsets hold to the kernels as
    phase 3 holds them; one shard's launch timed against the whole's."""
    from repro_torch.core import rng
    from repro_torch.kernels import ops
    from repro_torch.kernels import zo_perturb as zp
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    seed, coeff = 424242, -0.00731
    t0 = time.perf_counter()
    ops.reset_launches()
    n_add = n_mm = 0
    times = {}
    for arch, path, shape, dim in SH1_ADD:
        salt = rng.leaf_salt(path)
        for dtype in (torch.float32, torch.bfloat16):
            w = (torch.randn(shape, generator=gen, device=dev) * 0.02).to(
                dtype)
            for dist in ("rademacher", "gaussian"):
                whole = ops.zo_add(w, seed, salt, coeff, dist=dist)
                for j, (o, n) in enumerate(_shard_slices(shape, dim,
                                                         SH_WAYS)):
                    offs = [0] * len(shape)
                    offs[dim] = o
                    blk = w.narrow(dim, o, n).contiguous()
                    got = ops.zo_add(blk, seed, salt, coeff, dist=dist,
                                     offsets=offs)
                    n_add += 1
                    check(torch.equal(got, whole.narrow(dim, o, n)),
                          f"SH1 zo_add {arch} {path} {dtype} {dist} shard "
                          f"{j} != the whole leaf's slice")
                    if j == 1:
                        want = zp.zo_add_ref(blk, seed, salt, coeff, dist,
                                             offsets=offs)
                        err = (got.float() - want.float()).abs().max().item()
                        tol = 0.0 if dist == "rademacher" else ZO_GAUSS_ATOL
                        check(err <= tol, f"SH1 zo_add plain at offsets "
                              f"{path} {dtype} {dist}: err {err} > {tol}")
                        if (dtype == torch.bfloat16 and dist == "rademacher"
                                and path == "blocks/mlp/w_in/w"
                                and arch == "opt-1.3b"):
                            times["zo_add"] = {
                                "leaf": f"{arch} {path} {list(shape)} bf16",
                                "whole_ms": time_ms(lambda: zp.zo_add_cuda(
                                    w, seed, salt, coeff), 20),
                                "shard_ms": time_ms(lambda: zp.zo_add_cuda(
                                    blk, seed, salt, coeff, offsets=offs),
                                    20),
                                "shard_shape": list(blk.shape)}
                        del want
                    del blk, got
                del whole
            del w
            torch.cuda.empty_cache()
    # kimi-k2's expert leaf: 16 x 16 shards on (expert, F)
    arch, path, shape = SH1_KIMI
    salt = rng.leaf_salt(path)
    w = torch.empty(shape, dtype=torch.bfloat16, device=dev).normal_(
        0.0, 0.02, generator=gen)
    for dist in ("rademacher", "gaussian"):
        whole = ops.zo_add(w, seed, salt, coeff, dist=dist)
        for i, (eo, en) in enumerate(_shard_slices(shape, 0, SH_WAYS)):
            for j, (fo, fn) in enumerate(_shard_slices(shape, 1, SH_WAYS)):
                blk = w[eo:eo + en, fo:fo + fn].contiguous()
                got = ops.zo_add(blk, seed, salt, coeff, dist=dist,
                                 offsets=(eo, fo, 0))
                n_add += 1
                check(torch.equal(got, whole[eo:eo + en, fo:fo + fn]),
                      f"SH1 zo_add kimi-k2 expert shard ({i}, {j}) {dist}")
                del blk, got
        del whole
    del w
    torch.cuda.empty_cache()
    # zo_matmul: column- and row-parallel shards of a layer's slice
    for arch, path, (k, n), par in SH1_MM:
        base = rng.fold_leading(rng.leaf_base(seed, rng.leaf_salt(path)), 3)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((TRAIN_B * TRAIN_S, k), generator=gen,
                            device=dev).to(dtype)
            w = (torch.randn((k, n), generator=gen, device=dev) * 0.02).to(
                dtype)
            for dist in ("rademacher", "gaussian"):
                kw = dict(dist=dist, prime_offset=1, prehashed=True)
                whole = ops.zo_matmul(x, w, base, 0, 1e-3, **kw).float()
                scale = whole.abs().max().item()
                lim = ZO_MM_F32_RTOL if dtype == torch.float32 \
                    else ZO_MM_BF16_RTOL
                acc = torch.zeros_like(whole) if par == "row" else None
                worst = 0.0
                for j, (o, m) in enumerate(_shard_slices(
                        (k, n), 1 if par == "column" else 0, SH_WAYS)):
                    if par == "column":
                        wj = w[:, o:o + m].contiguous()
                        xj, offs = x, (0, o)
                    else:
                        wj = w[o:o + m].contiguous()
                        xj, offs = x[:, o:o + m].contiguous(), (o, 0)
                    got = ops.zo_matmul(xj, wj, base, 0, 1e-3,
                                        offsets=offs, **kw)
                    n_mm += 1
                    if par == "column":
                        worst = max(worst, (got.float() - whole[:, o:o + m])
                                    .abs().max().item() / scale)
                    else:
                        acc += got.float()
                    if j == 1:
                        want = zp.zo_matmul_ref(xj, wj, base, 0, 1e-3,
                                                offsets=offs, **kw)
                        err = ((got.float() - want.float()).abs().max()
                               / want.float().abs().max()).item()
                        check(err <= lim, f"SH1 zo_matmul plain at offsets "
                              f"{path} {dtype} {dist}: {err} > {lim}")
                        if (par == "column" and dtype == torch.bfloat16
                                and dist == "rademacher"
                                and arch == "opt-1.3b"):
                            times["zo_matmul"] = {
                                "leaf": f"{arch} {path} {[k, n]} bf16, X "
                                        f"{[TRAIN_B * TRAIN_S, k]}",
                                "whole_ms": time_ms(lambda: zp.zo_matmul_cuda(
                                    x, w, base, 0, 1e-3, **kw), 20),
                                "shard_ms": time_ms(lambda: zp.zo_matmul_cuda(
                                    xj, wj, base, 0, 1e-3, offsets=offs,
                                    **kw), 20),
                                "shard_shape": list(wj.shape)}
                        del want
                    del got, wj, xj
                if par == "row":
                    worst = (acc - whole).abs().max().item() / scale
                check(worst <= lim, f"SH1 zo_matmul {par}-parallel {path} "
                      f"{dtype} {dist}: {worst} > {lim}")
                print(json.dumps({"phase": "SH1 zo_matmul", "leaf": path,
                                  "parallel": par, "dtype": str(dtype),
                                  "dist": dist, "rel_err": worst,
                                  "limit": lim}), flush=True)
                del whole, acc
            del x, w
            torch.cuda.empty_cache()
    launches = _snapshot(ops)
    check(launches["zo_add"] >= n_add and launches["zo_matmul"] >= n_mm,
          f"SH1: launches {launches}")
    print(json.dumps({"phase": "SH1 offsets",
                      "seconds": time.perf_counter() - t0,
                      "shards_zo_add": n_add, "shards_zo_matmul": n_mm,
                      "times": times}), flush=True)


def _sh2_model(torch, arch, pmesh, shd, mcfg, batch_argv):
    """One full-width arch: SH2_STEPS fused MeZO steps mesh-less and
    through DTensor params on ``pmesh``; returns the phase's rows."""
    from repro_torch.configs import get_config
    from repro_torch.core.mezo import mezo_step_fused
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    cfg = get_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    batch = _first_batch(torch, cfg, *batch_argv)
    sparams = shd.distribute_tree({k: v.clone() for k, v in params.items()},
                                  pmesh)
    sbatch = {k: shd.distribute(v, pmesh, shd.P(("pod", "data"),
                                                *(None,) * (v.dim() - 1)))
              for k, v in batch.items()}
    plain, sharded = [], []
    t_plain = t_sharded = 0.0
    launches = None
    torch.cuda.reset_peak_memory_stats()
    for step in range(SH2_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, aux = mezo_step_fused(model.loss, params, batch, 100 + step,
                                      mcfg)
        torch.cuda.synchronize()
        t_plain += time.perf_counter() - t0
        plain.append((float(aux.loss), aux.gs.tolist()))
        ops.reset_launches()
        t0 = time.perf_counter()
        with shd.use_mesh(pmesh):
            sparams, saux = mezo_step_fused(model.loss, sparams, sbatch,
                                            100 + step, mcfg)
        torch.cuda.synchronize()
        t_sharded += time.perf_counter() - t0
        snap = _snapshot(ops)
        launches = snap if launches is None else {
            k: launches[k] + snap[k] for k in snap}
        sharded.append((float(saux.loss), saux.gs.tolist()))
    gs_lim = FAMILY_FUSED_ATOL / (2 * mcfg.eps)
    dparam = dparam_over_limit = 0.0
    for k, v in params.items():
        if not v.is_floating_point():
            continue
        d = (sparams[k].to_local() - v).abs().max().item()
        lim = SH2_STEPS * (mcfg.lr * gs_lim + torch.finfo(v.dtype).eps *
                           v.abs().max().item())
        dparam = max(dparam, d)
        dparam_over_limit = max(dparam_over_limit, d / lim)
    return dict(cfg=cfg, plain=plain, sharded=sharded, dparam=dparam,
                dparam_over_limit=dparam_over_limit,
                s_plain=t_plain / SH2_STEPS, s_sharded=t_sharded / SH2_STEPS,
                launches=launches,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def sh2_sharded_step(torch, paths):
    """SH2: a one-rank nccl group and a (1, 1, 1) ("pod", "data", "model")
    mesh; full-width granite-moe-1b-a400m (moe_ep: the EP body with all
    32 experts local) and OPT-1.3B take SH2_STEPS fused MeZO steps at
    B 8 x 128 through DTensor params and the kernels, against the
    mesh-less steps (limits above SH2_STEPS). The group is destroyed
    before the next phase."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core.mezo import MezoConfig
    from repro_torch.kernels import ops
    from repro_torch.models import sharding as shd
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        pmesh = init_device_mesh("cuda", (1, 1, 1),
                                 mesh_dim_names=("pod", "data", "model"))
        mcfg = MezoConfig(n_directions=1)
        total = None
        for arch in ("granite-moe-1b-a400m", "opt-1.3b"):
            t0 = time.perf_counter()
            r = _sh2_model(torch, arch, pmesh, shd, mcfg,
                           (TRAIN_B, TRAIN_S))
            exact = r["plain"] == r["sharded"] and r["dparam"] == 0.0
            if arch == "opt-1.3b" or exact:
                check(exact, f"SH2 {arch}: sharded {r['sharded']} vs "
                      f"mesh-less {r['plain']}, max |dparam| {r['dparam']}")
            else:
                for (lp, gp), (ls, gs) in zip(r["plain"], r["sharded"]):
                    check(abs(lp - ls) <= FAMILY_FUSED_ATOL and
                          max(abs(a - b) for a, b in zip(gp, gs)) <=
                          FAMILY_FUSED_ATOL / (2 * mcfg.eps),
                          f"SH2 {arch}: {r['sharded']} vs {r['plain']}")
                check(r["dparam_over_limit"] <= 1.0,
                      f"SH2 {arch}: a leaf moved {r['dparam_over_limit']}x "
                      f"its limit (max |dparam| {r['dparam']})")
            check(r["launches"]["zo_add"] > 0 and
                  r["launches"]["zo_matmul"] > 0,
                  f"SH2 {arch}: kernels not launched {r['launches']}")
            _check_bodies(f"SH2 {arch}", r["launches"],
                          {k: r["launches"][k]
                           for k in ("zo_matmul", "flash_attention")},
                          r["cfg"].dtype == "bfloat16")
            total = r["launches"] if total is None else {
                k: total[k] + r["launches"][k] for k in total}
            _phase_line(torch, f"SH2 {arch}", time.perf_counter() - t0,
                        r["launches"], exact=exact,
                        losses_sharded=[x[0] for x in r["sharded"]],
                        losses_plain=[x[0] for x in r["plain"]],
                        max_abs_dparam=r["dparam"],
                        dparam_over_limit=r["dparam_over_limit"],
                        step_s_plain=r["s_plain"],
                        step_s_sharded=r["s_sharded"])
            del r
            torch.cuda.empty_cache()
        paths["SH2 sharded step"] = total
        ops.reset_launches()
    finally:
        dist.destroy_process_group()


def dr1_start(out_dir: Path):
    """DR1: the three dry-run cells, each ``python -m
    repro_torch.launch.dryrun`` in a process of its own (CPU only: fake
    tensors on a fake group of 256 ranks), started together."""
    import os
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape in DR1_CELLS:
        procs.append((arch, shape, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", str(out_dir)], cwd=str(ROOT),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return procs, time.perf_counter()


def dr1_finish(procs, t0, out_dir: Path):
    for arch, shape, p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            fail(f"DR1 {arch} {shape}: the dry run took over 600 s")
        lines = [ln for ln in out.splitlines() if ln.startswith("[dryrun]")]
        check(p.returncode == 0 and lines and "OK" in lines[-1],
              f"DR1 {arch} {shape}: rc {p.returncode}: {out[-1500:]}")
        (path,) = out_dir.glob(f"{arch}__{shape}__*.json")
        with open(path) as f:
            rec = json.load(f)
        r = rec["roofline"]
        print(json.dumps({
            "phase": "DR1 dryrun", "arch": arch, "shape": shape,
            "mesh": rec["mesh"], "param_bytes_per_device":
                rec["analytic_param_bytes_per_device"],
            "opt_bytes_per_device": rec.get("analytic_opt_bytes_per_device"),
            "cache_bytes_per_device":
                rec.get("analytic_cache_bytes_per_device"),
            "peak_live_bytes_rank0":
                rec["memory_analysis"]["peak_live_bytes_rank0"],
            "collectives": rec["collectives"],
            "t_compute_s": r["t_compute_s"], "t_memory_s": r["t_memory_s"],
            "t_collective_s": r["t_collective_s"],
            "bottleneck": r["bottleneck"], "t_trace_s": rec["t_trace_s"]}),
            flush=True)
        if arch == "kimi-k2-1t-a32b":
            check(rec["analytic_param_bytes_per_device"]
                  <= DR1_MAX_PARAM_BYTES,
                  f"DR1 kimi-k2: {rec['analytic_param_bytes_per_device']} "
                  f"parameter bytes a device > {DR1_MAX_PARAM_BYTES}")
    print(json.dumps({"phase": "DR1 done",
                      "seconds": time.perf_counter() - t0}), flush=True)


# ---------------------------------------------------------------------------
# EX1-EX3: the examples (repro_torch.examples) at full width

# the examples' step counts, cut from 100 (quickstart), 300 (finetune_sst2)
# and 30 a user (serve_personalized) to fit the script's time
EX1_STEPS, EX2_STEPS, EX3_STEPS = 4, 20, 10
# EX2 restores the walk's run from its checkpoint (a snapshot + the log
# tail replayed) against the live parameters. The walk is not pristine:
# each step's K in-place +eps, -2 eps, +eps sweeps round three times and
# the update once, each at most half an ulp of the leaf's largest value
# (+ 2 eps) in f32, so a leaf may sit up to 2 ulps a direction from its
# replay: 2 * steps * K * 2^-23 * (max |leaf| + 2 eps), per leaf
EX2_DRIFT_ULPS = 2
# EX3 holds every logits row the engine picked a token from, at atol 0,
# to the engine's recipe run outside it (_prefill_forced: each prompt
# prefilled alone, then the dense decode_step of that user's requests
# fed the served tokens): a row from the wrong adapter, a write the mask
# let through or a slot's cache mixed up changes its bits. Against the
# reference loop serve(), which feeds the prompt token by token, the
# rows are printed and not held: there a trained user's bf16 rows part
# from the engine's from the first row on, by 0.03-0.47 after 4-10
# steps, each of the two about as far from the f32 rows as the other
# (measured on an NVIDIA H100 80GB HBM3, 700 W); the base's do not part


def _quiet(_msg):
    pass


def ex1_quickstart(torch, paths):
    """EX1: the quickstart's two arms at full-width OPT-1.3B (bf16, the
    example's B 8 x 32 and hyperparameters, EX1_STEPS steps each): MeZO
    (the walk; attention on ``flash_attention``'s tensor-core body) and
    Adam (autograd, plain attention). Each arm's losses (finite), peak
    memory and train-state bytes beyond the parameters (MeZO: the sgd
    rule's empty state; Adam: two f32 moments and the count). Then the
    example's ``main()`` at its reduced defaults on the card."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.examples import quickstart as qs
    from repro_torch.kernels import ops
    cfg = get_config("opt-1.3b")
    # the seed-0 tree's bytes and its Adam moments', counted before the
    # arms so that their peaks hold no extra moments
    p_bytes, a_bytes = qs.state_memory(cfg, "cuda")
    for opt in qs.OPTIMIZERS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        ops.reset_launches()
        t0 = time.perf_counter()
        tr = qs.train_arm(cfg, opt, steps=EX1_STEPS, device="cuda",
                          log_fn=_quiet)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        label = f"EX1 quickstart {opt}"
        launches = paths[label] = _snapshot(ops)
        beyond = (a_bytes if opt == "adam"
                  else qs.state_bytes(tr.strategy.update.init_fn(tr.tcfg.mezo)))
        check(len(tr.losses) == EX1_STEPS
              and all(math.isfinite(x) for x in tr.losses),
              f"{label}: losses {tr.losses}")
        if opt == "mezo":
            _check_tc(label, launches, ["flash_attention"])
            check(launches["zo_add"] > 0, f"{label}: no zo_add launch")
        else:
            check(launches["flash_attention"] == 0 and launches["zo_add"] == 0,
                  f"{label}: the gradient arm launched a ZO kernel")
        _phase_line(torch, label, dt, launches, arch=cfg.name,
                    dtype=cfg.dtype, steps=EX1_STEPS, example_steps=qs.STEPS,
                    batch=qs.BATCH, seq=qs.SEQ, losses=tr.losses,
                    step_s=dt / EX1_STEPS, param_bytes=p_bytes,
                    state_bytes_beyond_params=beyond,
                    resident_before_gib=resident / 2**30,
                    arm_peak_gib=(torch.cuda.max_memory_allocated()
                                  - resident) / 2**30)
        del tr
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    qs.main(["--device", "cuda"])
    print(json.dumps({"phase": "EX1 quickstart main (reduced)",
                      "seconds": time.perf_counter() - t0}), flush=True)


def ex2_finetune_sst2(torch, paths):
    """EX2: finetune_sst2 at full-width RoBERTa-large (f32, the example's
    16 x 32 batches, 8 directions, the walk, snapshots every 100 steps)
    for EX2_STEPS steps: accuracy before and after (printed, not held),
    losses, the replay log's bytes against the parameters', peak memory,
    every ``flash_attention`` launch on the SIMT body; the checkpoint
    restored (snapshot + log tail) within EX2_DRIFT_ULPS of the live
    parameters. The example's ``main()`` (300 reduced steps) is left to
    the CPU tests: it took 17-37 s on the card."""
    import gc
    import shutil
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.examples import finetune_sst2 as sst2
    from repro_torch.kernels import ops
    from repro_torch.serve.adapters import tree_bytes
    label = "EX2 finetune_sst2"
    cfg = get_config("roberta-large")
    ckpt = WORK / "ex2_sst2"
    tr = sst2.make_trainer(cfg, str(ckpt), steps=EX2_STEPS, device="cuda",
                           log_fn=_quiet)
    p0 = tr.init_params()
    toks, labels = sst2.eval_set(cfg)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    acc0, acc1, params = sst2.finetune(tr, p0, toks, labels)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = paths[label] = _snapshot(ops)
    check(cfg.dtype == "float32" and len(tr.losses) == EX2_STEPS
          and all(math.isfinite(x) for x in tr.losses),
          f"{label}: {cfg.dtype} losses {tr.losses}")
    check(launches["flash_attention/simt"] > 0
          and launches["flash_attention/tc"] == 0
          and launches["zo_add"] > 0 and launches["zo_matmul"] == 0,
          f"{label}: launches {launches}")
    mcfg = tr.tcfg.mezo
    _phase_line(torch, label, dt, launches, arch=cfg.name, dtype=cfg.dtype,
                steps=EX2_STEPS, example_steps=sst2.STEPS,
                directions=mcfg.n_directions, batch=sst2.BATCH, seq=sst2.SEQ,
                losses=tr.losses, step_s=dt / EX2_STEPS, accuracy=[acc0, acc1],
                replay_log_bytes=sst2.log_bytes(str(ckpt)),
                param_bytes=tree_bytes(p0))
    mgr = CheckpointManager(str(ckpt), mezo_cfg=mcfg,
                            update_rule=tr.strategy.update)
    like = tr.strategy.init_state(
        {k: torch.empty_like(v) for k, v in params.items()}, mcfg)
    restored, nxt = mgr.restore(like)
    mgr.log.close()
    check(nxt == EX2_STEPS, f"{label}: restore resumes at {nxt}")
    worst, worst_err = 0.0, 0.0
    for k, live in params.items():
        limit = (EX2_DRIFT_ULPS * EX2_STEPS * mcfg.n_directions * 2.0 ** -23
                 * (float(live.abs().max()) + 2 * mcfg.eps))
        err = float((restored.params[k] - live).abs().max())
        worst_err = max(worst_err, err)
        worst = max(worst, err / limit)
        check(err <= limit, f"{label}: restored {k} is {err} from the live "
              f"parameters > {limit}")
    print(json.dumps({"phase": f"{label} restore", "snapshot_every":
                      sst2.SNAPSHOT_EVERY, "max_abs_err": worst_err,
                      "max_err_over_limit": worst,
                      "drift_ulps": EX2_DRIFT_ULPS}), flush=True)
    del tr, p0, params, restored, like
    shutil.rmtree(ckpt, ignore_errors=True)


def ex3_personalized(torch, paths):
    """EX3: serve_personalized at full-width gemma-2b (bf16): two users
    fine-tuned by ``mezo-parallel`` (vmapdir) for EX3_STEPS steps each
    from the Trainer's seed-0 init on the card, checkpointed; a fresh
    AdapterStore over that base imports both logs, each user's
    materialized parameters equal its trained ones at atol 0; a dense
    engine of 2 slots serves the 6 interleaved requests (8 + 6 tokens).
    Every logits row the engine picked a token from equals, at atol 0,
    the engine's recipe outside it on that user's materialized
    parameters (``_prefill_forced``). Each user's tokens are set beside
    the reference loop ``serve()``: its first difference, and
    teacher-forced, the engine's rows against its token-by-token rows and
    both against their f32 twins, with the served tokens' gaps under
    its best (printed, not held). The checkpoints are removed once
    imported. One vmapdir step under the profiler; then the
    example's ``main()`` at its reduced defaults."""
    import dataclasses
    import gc
    import shutil
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import fold_seed, get_strategy
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.examples import serve_personalized as sp
    from repro_torch.models import build_model
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve import engine as engine_mod
    label = "EX3 serve_personalized"
    cfg = get_config("gemma-2b")
    ckpts = sp.ckpt_dirs(str(WORK))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    base = sp.serving_base(cfg, "cuda")
    trained, losses = {}, {}
    for user, seed in sp.USERS.items():
        tr, trained[user] = sp.finetune(cfg, user, seed, ckpts[user],
                                        steps=EX3_STEPS, device="cuda",
                                        params=base)
        losses[user] = tr.losses
        check(len(tr.losses) == EX3_STEPS
              and all(math.isfinite(x) for x in tr.losses),
              f"{label} {user}: losses {tr.losses}")
        del tr
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    store = sp.adapter_store(base, ckpts, "cuda")
    sp.check_materialized(store, trained)
    del trained
    for d in ckpts.values():
        shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    (engine, comps, rids), rows = _engine_rows(
        torch, engine_mod, lambda: sp.serve(cfg, store, "cuda"))
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t1
    launches = paths[label] = _snapshot(ops)
    _check_tc(label, launches, ["flash_attention"])
    check(launches["zo_add"] > 0 and launches["flash_decode"] == 0
          and launches["flash_prefill"] == 0,
          f"{label}: launches {launches}")
    sp.report(engine, store, comps, rids)
    f32 = dataclasses.replace(cfg, dtype="float32")
    first_diff, exact, errs, floor, ties = {}, [], [], [], []
    for user in sp.USERS:
        mine = sorted((c for c in comps if c.user == user),
                      key=lambda c: c.rid)
        params = store.materialize(user)
        prompts = np.stack([c.prompt for c in mine])
        served = np.stack([c.tokens for c in mine])
        recipe = _prefill_forced(torch, serve_mod, cfg, params, prompts,
                                 served)
        ref = serve_mod.serve(cfg, params, prompts, sp.MAX_NEW,
                              device="cuda")
        dense = _teacher_forced(torch, serve_mod, cfg, params, prompts,
                                served)
        wide = _teacher_forced(torch, serve_mod, f32, {
            k: v.float() for k, v in params.items()}, prompts, served)
        for i, c in enumerate(mine):
            ne = np.flatnonzero(c.tokens != ref[i])
            same = int(ne[0]) if ne.size else sp.MAX_NEW
            if ne.size:
                first_diff[c.rid] = same
            check(np.array_equal(dense[i, :same].argmax(-1).numpy(),
                                 ref[i, :same]),
                  f"{label} rid {c.rid}: the teacher-forced loop parts "
                  f"from serve() within its first {same} tokens")
            for j in range(sp.MAX_NEW):
                row, want = rows[(c.rid, j)], dense[i, j]
                tok, best = int(c.tokens[j]), int(want.argmax())
                check(int(row.argmax()) == tok,
                      f"{label} rid {c.rid} token {j}: not the recorded "
                      f"row's argmax")
                exact.append(float((row - recipe[i, j]).abs().max()))
                errs.append(float((row - want).abs().max()))
                floor.append(float((want - wide[i, j]).abs().max()))
                top = float(want[best])
                # one bf16 step at |top|: 2^(floor(log2 |top|) - 7)
                step = 2.0 ** (math.frexp(top)[1] - 8)
                gap = top - float(want[tok])
                ties.append({"rid": c.rid, "token": j, "gap": gap,
                             "gap_bf16_steps": gap / step,
                             "serve_best": top, "serve_served": float(
                                 want[tok]),
                             "engine_best": float(row[best]),
                             "engine_served": float(row[tok])})
        del recipe, dense, wide
    widest = max(ties, key=lambda t: t["gap"])
    st = engine.stats
    _phase_line(torch, label, train_s + serve_s, launches, arch=cfg.name,
                dtype=cfg.dtype, steps=EX3_STEPS, example_steps=sp.STEPS,
                losses=losses, train_seconds=train_s, serve_seconds=serve_s,
                materialized_equals_trained=True,
                adapter_bytes={u: store._adapters[u].nbytes
                               for u in sp.USERS},
                decode_tok_s=st.decode_tps, prefill_tok_s=st.prefill_tps,
                requests=len(comps), rows_held=len(exact),
                recipe_max_abs_err=max(exact), first_diff_from_serve={
                    str(r): j for r, j in first_diff.items()},
                serve_logits_max_abs_err=max(errs),
                serve_vs_f32_max_abs_err=max(floor),
                near_tie_max_gap=widest["gap"], near_tie_widest=widest,
                gaps_over_bf16_rule=sum(t["gap"] > LOGITS_BF16_ATOL
                                        for t in ties))
    check(max(exact) == 0.0,
          f"{label}: the engine's rows are {max(exact)} from its recipe "
          f"run outside it on the same tokens (atol 0)")
    del engine, store
    gc.collect()
    torch.cuda.empty_cache()
    # one training step under the profiler: where a vmapdir step goes
    strat = get_strategy("mezo-parallel")
    model = build_model(dataclasses.replace(cfg, attn_impl="flash"))
    batch = {k: torch.as_tensor(v).to("cuda") for k, v in
             next(lm_batches(8, 32, cfg.vocab, seed=11)).items()}
    state = strat.init_state(base, sp.MZ)
    wall_us, by_name, n_events = _profiled(torch, lambda: strat.step(
        model.loss, state, batch, fold_seed(0, 0), sp.MZ))
    _profile_line(f"{label} profile", wall_us, by_name, n_events, steps=1,
                  directions=sp.MZ.n_directions)
    del base, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sp.main(["--device", "cuda"])
    print(json.dumps({"phase": "EX3 serve_personalized main (reduced)",
                      "seconds": time.perf_counter() - t0}), flush=True)


def main():
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda is not available: this smoke test needs a card")

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    print(json.dumps({"phase": "device", "kind": kind,
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)

    # 2. build
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0}),
          flush=True)

    # 3. kernels against their plain versions (T0 for the training pair)
    results: dict = {}
    kernel_zo_add(torch, results)
    kernel_attention(torch, results)
    kernel_zo_matmul(torch, results)
    kernel_flash_attention(torch, results)
    kernel_zo_add_q(torch, results)
    kernel_zo_matmul_q(torch, results)
    kernel_zo_add_users(torch, results)
    kernel_zo_matmul_users(torch, results)
    kernel_flash_verify(torch, results)                   # S0
    kernel_selective_scan(torch, results)
    torch.cuda.empty_cache()

    # 4-5. the serving path, and where its time goes
    paths: dict = {}
    paged_argv, dense_argv, plain = main_path(torch, paths)
    profile_path(torch, paged_argv)
    # S1-S5: self-speculative serving (S3 follows Q3)
    s1_spec_serving(torch, paths, paged_argv, plain)
    s2_tiny_delta(torch, paths, dense_argv)
    s4_sampled(torch, paths, paged_argv)
    profile_path(torch, paged_argv + ["--spec-k", str(SPEC_K)],
                 phase="S5 profile spec")
    torch.cuda.empty_cache()
    # G1: gemma-2b served on flash_decode's split route
    g1_gemma(torch, paths)

    # T1 + T4: the training CLI, then one profiled step
    tr, state, batch, t1_peak_gib = train_main_path(torch, paths)
    profile_train(torch, tr, state, batch)
    del tr, state, batch
    torch.cuda.empty_cache()
    # T2, T3: flash attention, fused vs materialized
    train_fused_vs_materialized(torch, paths, "opt-1.3b", "T2 flash",
                                OPT_FUSED_ATOL)
    torch.cuda.empty_cache()
    train_fused_vs_materialized(torch, paths, "roberta-large",
                                "T3 roberta", ROBERTA_FUSED_ATOL)
    torch.cuda.empty_cache()
    r1_roberta(torch, paths)                              # R1

    # Q1-Q3: the int8 base
    torch.cuda.empty_cache()
    q1_frozen_base(torch, paths, "opt-1.3b", OPT_FUSED_ATOL)
    torch.cuda.empty_cache()
    q1_frozen_base(torch, paths, "roberta-large", ROBERTA_FUSED_ATOL)
    torch.cuda.empty_cache()
    q2_int8_train(torch, paths)
    torch.cuda.empty_cache()
    base, q3_plain = q3_int8_serving(torch, paths, paged_argv, dense_argv)
    s3_int8_spec(torch, paths, paged_argv, base, q3_plain)
    del base, q3_plain

    # U1-U4: multi-tenant training over one resident base
    torch.cuda.empty_cache()
    u_fleet(torch, paths, "none")
    torch.cuda.empty_cache()
    u_fleet(torch, paths, "int8")
    for base in ("bf16", "int8"):
        torch.cuda.empty_cache()
        u3_shared_base(torch, paths, base)

    # F1-F5: the other model families at full width
    import gc
    for phase in (lambda: f1_moe(torch, paths, paged_argv),
                  lambda: f2_rwkv(torch, paths),
                  lambda: f3_hybrid(torch, paths),
                  lambda: f4_encdec(torch, paths, paged_argv, dense_argv),
                  lambda: f5_dense(torch, paths)):
        gc.collect()                    # engines a hook closes over
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phase()
        print(json.dumps({"phase": "family done",
                          "seconds": time.perf_counter() - t0}), flush=True)

    # UF1-UF4: the multi-tenant step of those families
    for phase in (lambda: uf1_moe_fleet(torch, paths),
                  lambda: uf2_rwkv_fleet(torch, paths),
                  lambda: uf3_hybrid_shared_base(torch, paths),
                  lambda: uf4_encdec_engine(torch, paths)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phase()
        print(json.dumps({"phase": "multi-tenant family done",
                          "seconds": time.perf_counter() - t0}), flush=True)

    # FL1, A1, ST1, P1: the fleet, the gradient baseline, stragglers, the
    # data pipeline
    for phase in (lambda: fl1_fleet(torch, paths),
                  lambda: a1_adam(torch, paths, t1_peak_gib),
                  lambda: st1_stragglers(torch, paths),
                  lambda: p1_pipeline(torch)):
        gc.collect()
        torch.cuda.empty_cache()
        phase()

    # SH1, SH2, DR1: the multi-device tier (the dry run's processes run
    # on the host's cores beside SH1 and SH2)
    dr1 = dr1_start(WORK / "dryrun")
    for phase in (lambda: sh1_offsets(torch),
                  lambda: sh2_sharded_step(torch, paths)):
        gc.collect()
        torch.cuda.empty_cache()
        phase()
    dr1_finish(*dr1, WORK / "dryrun")

    # EX1-EX3: the examples at full width
    for phase in (lambda: ex1_quickstart(torch, paths),
                  lambda: ex2_finetune_sst2(torch, paths),
                  lambda: ex3_personalized(torch, paths)):
        gc.collect()
        torch.cuda.empty_cache()
        phase()

    # 6. the kernels line, then the result
    from repro_torch.kernels import ops
    replaces = {"zo_add": "src/repro/kernels/zo_perturb.py:90",
                "flash_decode": "src/repro/kernels/flash_decode.py:57",
                "flash_prefill": "src/repro/kernels/flash_prefill.py:45",
                "zo_matmul": "src/repro/kernels/zo_perturb.py:214",
                "flash_attention": "src/repro/kernels/flash_attention.py:32",
                "zo_add_q": "src/repro/kernels/zo_perturb.py:99",
                "zo_matmul_q": "src/repro/kernels/zo_perturb.py:234",
                "zo_add_users": "src/repro/kernels/zo_perturb.py:165",
                "zo_matmul_users": "src/repro/kernels/zo_perturb.py:332",
                "zo_matmul_users_q": "src/repro/kernels/zo_perturb.py:352",
                "flash_verify": "src/repro/kernels/flash_verify.py:38",
                "selective_scan": "src/repro/models/mamba.py:71 (lax.scan; "
                                  "no Pallas kernel)"}
    sources = {"zo_add_q": "zo_add", "zo_matmul_q": "zo_matmul",
               "zo_add_users": "zo_add", "zo_matmul_users": "zo_matmul",
               "zo_matmul_users_q": "zo_matmul"}
    kernels = []
    for name, rep in replaces.items():
        r = results[name]
        by_path = {p: launches[name] for p, launches in paths.items()}
        total = sum(by_path.values())
        check(total > 0, f"kernel {name} was launched on no main path")
        kernels.append({"name": name, "route": "cuda",
                        "source": "src/repro_torch/csrc/"
                                  f"{sources.get(name, name)}.cu",
                        "replaces": rep, "launches": total,
                        "launches_by_path": by_path,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        **{k: r[k] for k in ("library", "cublas_bf16_ms",
                                             "bound_f32_simt_ms", "cases",
                                             "gaussian_ms",
                                             "gaussian_bound_ms")
                           if k in r},
                        **({"launches_by_body": {
                            b: sum(p[f"{name}/{b}"] for p in paths.values())
                            for b in ("tc", "tc_tma", "simt")
                            if f"{name}/{b}" in ops.BODIES}}
                           if f"{name}/tc" in ops.BODIES else {}),
                        **({"launches_by_route": {
                            r: sum(p[f"{name}/{r}"] for p in paths.values())
                            for r in ("slot", "split")},
                            "launches_split_tc": sum(p[f"{name}/split_tc"]
                                            for p in paths.values()),
                            "route_kernels": {
                                "slot": ["flash_decode_kernel"],
                                "split": ["flash_decode_split_kernel or "
                                          "flash_decode_split_tc_kernel",
                                          "flash_decode_merge_kernel"]}}
                           if name == "flash_decode" else {})})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
