"""Straggler mitigation via redundant direction evaluation.

Port of the JAX package's ``runtime/stragglers.py`` (numpy only, copied
so the port imports nothing of that package).

In gradient-based DP training a straggler holds up the whole all-reduce
(its gradient *shard* is irreplaceable). ZO direction-parallelism changes
the failure algebra: every pod's contribution is an i.i.d. SPSA sample,
so dropping a late pod just shrinks the direction sample -- the estimator
stays unbiased. The scheme:

  * schedule K + R directions per step (R redundant),
  * accept the first K to finish (here: a deadline against the median of
    an EMA of per-direction latencies),
  * renormalize the update over survivors (core.engine._direction_coeffs).

On a synchronous single-controller run we cannot observe true per-pod
latencies, so the policy also accepts externally reported "slow pod"
sets (the launcher would wire these from pod heartbeats); tests drive it
deterministically.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class StragglerPolicy:
    n_directions: int            # K: directions used by the update
    redundancy: int = 0          # R: extra directions scheduled
    deadline_factor: float = 3.0  # drop observations slower than f x median
    ema: float = 0.9

    def __post_init__(self):
        self._lat = np.zeros(self.total, np.float64)
        self._seen = False

    @property
    def total(self) -> int:
        return self.n_directions + self.redundancy

    @property
    def seen(self) -> bool:
        """True once at least one latency vector has been observed."""
        return self._seen

    @property
    def ema_latencies(self) -> np.ndarray:
        """Copy of the (total,) EMA latency estimates (zeros before the
        first observation). Feeding an entry's own EMA back through
        :meth:`observe` leaves it unchanged, so a caller tracking items
        that report latencies one at a time (the fleet coordinator's
        workers) can update a single entry per observation."""
        return self._lat.copy()

    def observe(self, latencies: Sequence[float]):
        lat = np.asarray(latencies, np.float64)
        if lat.shape != (self.total,):
            raise ValueError(
                f"StragglerPolicy.observe: latencies shape {lat.shape} "
                f"!= expected ({self.total},) (n_directions="
                f"{self.n_directions} + redundancy={self.redundancy})")
        self._lat = lat if not self._seen else (
            self.ema * self._lat + (1 - self.ema) * lat)
        self._seen = True

    def deadline(self) -> float:
        """Per-item latency budget: ``deadline_factor`` x the median of
        the EMA latencies -- the same cutoff :meth:`mask` drops slow
        observations with, exposed as an absolute duration so an async
        coordinator can expire (and re-issue) a direction lease instead
        of merely masking it. ``inf`` until the first observation: with
        no latency model yet, nothing can be declared late."""
        if not self._seen:
            return float("inf")
        return float(self.deadline_factor
                     * max(np.median(self._lat), 1e-9))

    def mask(self, slow: Optional[Sequence[int]] = None) -> np.ndarray:
        """(K+R,) 0/1 mask of accepted directions.

        Keeps the fastest ``n_directions`` among those not marked slow;
        if everything is marked slow, falls back to keeping all (progress
        beats purity).
        """
        m = np.ones(self.total, np.float32)
        if slow is not None:
            m[np.asarray(list(slow), int)] = 0.0
        if self._seen:
            med = np.median(self._lat[m > 0]) if (m > 0).any() else 0.0
            m[self._lat > self.deadline_factor * max(med, 1e-9)] = 0.0
        if m.sum() == 0:
            return np.ones(self.total, np.float32)
        # keep at most n_directions fastest survivors
        if m.sum() > self.n_directions and self._seen:
            order = np.argsort(np.where(m > 0, self._lat, np.inf))
            keep = order[: self.n_directions]
            m2 = np.zeros_like(m)
            m2[keep] = 1.0
            m = m2
        return m
