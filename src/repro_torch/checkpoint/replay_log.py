"""Replay-log checkpointing -- ZO-native incremental checkpoints.

Port of the JAX package's ``checkpoint/replay_log.py``: the same JSONL
line format, torn-tail sealing and dedup rules, so a log written by
either package reads and replays unchanged in the other.

A MeZO trajectory is fully determined by (theta_0, [(seed_t, gs_t)]):
the update at step t is   theta -= lr/K * sum_k gs_t[k] * z(seed_t, k),
and z is regenerated from the seed. So instead of flushing terabytes of
params every N steps, we append ~(4 + 4K) bytes per step to a log and
snapshot full params only rarely. Recovery = load nearest snapshot +
the update rule over the tail (:func:`apply_record`): memory-bandwidth-bound,
zero forward passes. Bit-exact for the ``mezo_step_vmapdir`` path (same
update arithmetic on pristine params); for the in-place-walk ``mezo_step``
path, exact up to the walk's float roundoff drift (~1e-5 abs), which the
walk itself incurs anyway.

This is a capability *derivative-free* training gets for free and
derivative-based training fundamentally cannot have (gradients depend on
data); it is the fault-tolerance centerpiece of this framework
(DESIGN.md Sec 2).

Format: one JSONL line per step {"step","seed","gs","lr","eps"} -- tiny,
append-only, human-debuggable. fsync'd per append by default.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import List, Optional, Tuple

import numpy as np


class ReplayLog:
    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._seal_torn_tail(path)
        self._f = open(path, "a", buffering=1)

    @staticmethod
    def _seal_torn_tail(path: str):
        """A crash mid-append can leave a torn final line with NO
        newline; appending the restart's retried record would glue onto
        it and corrupt *both* lines. Seal the tear before appending."""
        try:
            with open(path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                torn = f.read(1) != b"\n"
        except (FileNotFoundError, OSError):
            return                        # missing or empty file
        if torn:
            with open(path, "ab") as f:
                f.write(b"\n")

    def append(self, step: int, seed, gs, lr: float, eps: float,
               mask=None, staleness=None):
        """``mask``: the step's straggler direction_mask, recorded so
        replay renormalizes over the same survivors the live update did.
        ``staleness``: for async (fleet) runs, the number of updates
        applied between the worker's params snapshot and this apply --
        replay scales the update by ``staleness_decay ** staleness``
        exactly as the live coordinator did."""
        rec = {"step": int(step), "seed": int(np.asarray(seed)),
               "gs": np.asarray(gs, np.float32).reshape(-1).tolist(),
               "lr": float(lr), "eps": float(eps)}
        if mask is not None:
            rec["mask"] = np.asarray(mask, np.float32).reshape(-1).tolist()
        if staleness is not None:
            rec["staleness"] = int(staleness)
        self._f.write(json.dumps(rec) + "\n")
        if self.fsync:
            self._f.flush()
            os.fsync(self._f.fileno())

    def close(self):
        self._f.close()

    @staticmethod
    def read(path: str, after_step: Optional[int] = None
             ) -> List[dict]:
        """Records with step > after_step, in order, tolerating corrupt
        lines (crash mid-append). A torn write is usually the tail, but a
        crash-then-restart appends *past* it -- so bad lines are skipped,
        not treated as end-of-log, and the retried step dedups below.
        Drops are counted and reported in one warning."""
        out, dropped = [], 0
        if not os.path.exists(path):
            return out
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    dropped += 1
                    continue
                if not isinstance(rec, dict) or "step" not in rec:
                    dropped += 1     # parseable junk (e.g. a bare number)
                    continue
                if after_step is None or rec["step"] > after_step:
                    out.append(rec)
        if dropped:
            warnings.warn(
                f"ReplayLog.read({path}): dropped {dropped} corrupt "
                f"line(s) (torn append); kept {len(out)} valid record(s)",
                RuntimeWarning, stacklevel=2)
        # de-duplicate on step (a retried step may be appended twice).
        # A benign retry repeats the record verbatim; async delivery can
        # also produce a *divergent* retry -- same step, different
        # seed/gs (e.g. a re-issued lease evaluated at a newer params
        # version). First-applied wins either way, but a divergent
        # duplicate is surfaced: it means two writers raced the log.
        kept, dedup, conflicts = {}, [], set()
        for r in out:
            prev = kept.get(r["step"])
            if prev is None:
                kept[r["step"]] = r
                dedup.append(r)
            elif (prev.get("seed") != r.get("seed")
                  or prev.get("gs") != r.get("gs")):
                conflicts.add(r["step"])
        if conflicts:
            shown = sorted(conflicts)
            warnings.warn(
                f"ReplayLog.read({path}): {len(conflicts)} conflicting "
                f"duplicate step(s) {shown[:8]}"
                f"{'...' if len(shown) > 8 else ''} carry different "
                f"seed/gs (divergent retry); kept the first-applied "
                f"record per step", RuntimeWarning, stacklevel=2)
        return dedup


def apply_record(rule, params, opt, rec: dict, cfg, inplace: bool = False):
    """Apply one logged record through the update rule ``rule``; returns
    ``(params, opt)``. The record's ``lr`` and ``eps`` replace the
    config's, its ``mask`` renormalizes over the logged survivors, and a
    record bearing ``staleness`` (an async fleet run) replays through the
    ``stale-sgd`` coefficients, ``staleness_decay ** staleness``: with
    sgd and stale-sgd alike, so a mixed log of synchronous and
    asynchronous records stays coherent. A stateful rule (momentum) has
    no stale form and refuses such a record."""
    from repro_torch.core.engine import STALE_SGD
    c = dataclasses.replace(cfg, lr=rec["lr"], eps=rec["eps"])
    mask = rec.get("mask")
    mask = None if mask is None else np.asarray(mask, np.float32)
    seed, gs = np.uint32(rec["seed"]), np.asarray(rec["gs"], np.float32)
    stale = rec.get("staleness")
    if stale is None:
        return rule.update_fn(params, opt, seed, gs, mask, c,
                              inplace=inplace)
    if rule.name not in ("sgd", STALE_SGD.name):
        raise ValueError(
            f"replay record for step {rec.get('step')} carries staleness, "
            f"which only the sgd and stale-sgd rules replay; the run's "
            f"rule is {rule.name!r}")
    return STALE_SGD.update_fn(params, opt, seed, gs, mask, c,
                               inplace=inplace, staleness=stale)


def replay_into(params, records: List[dict], cfg) -> Tuple[object, int]:
    """Apply logged updates in order, out of place. Returns (params,
    last_step).

    File order IS application order: async (fleet) logs carry step ids
    out of order -- the step field keys dedup/resume, never reordering.
    A record bearing ``staleness`` replays through the ``stale-sgd``
    rule (:func:`apply_record`); the fleet coordinator applies its live
    updates through this very function, so live-vs-replay is
    bit-identical by construction. ``params`` itself is never written:
    each record's first direction copies, the rest update that copy.
    """
    from repro_torch.core.engine import SGD
    last = -1
    for rec in records:
        params, _ = apply_record(SGD, params, {}, rec, cfg)
        last = rec["step"]
    return params, last
