"""Straggler detection and reactive repartitioning (the port's copy of
repro.fleet.rebalancer; Lamina-style skew-aware placement, arXiv
2405.01814).

The engine's ``worker_busy_times()`` counters are sampled every decode
step; per-worker busy-time deltas feed an EWMA.  When the EWMA imbalance
(max/mean - 1) exceeds ``skew_threshold`` for ``patience`` consecutive
observations, the rebalancer proposes a new partition proportional to
each worker's *measured* rate (rows per busy-second) and the manager
live-migrates rows to it.  A cooldown suppresses re-triggering while the
post-migration EWMA is still dominated by stale samples.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.fleet.planner import PartitionPlanner

Slice = Tuple[int, int]


class Rebalancer:
    def __init__(self, *, ewma_alpha: float = 0.5,
                 skew_threshold: float = 0.25, patience: int = 2,
                 cooldown: int = 4, min_rows: int = 1):
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1]: {ewma_alpha}")
        self.alpha = ewma_alpha
        self.skew_threshold = skew_threshold
        self.patience = patience
        self.cooldown = cooldown
        self.min_rows = min_rows
        self._ewma: Optional[np.ndarray] = None
        self._last_busy: Optional[np.ndarray] = None
        self._hot_streak = 0
        self._cool = 0

    # ------------------------------------------------------------------ #
    def reset(self) -> None:
        """Forget measurements (topology changed: counts or rows moved)."""
        self._ewma = None
        self._last_busy = None
        self._hot_streak = 0
        self._cool = self.cooldown

    def observe(self, busy_times: Sequence[float]) -> float:
        """Feed cumulative busy counters; returns the current EWMA skew."""
        busy = np.asarray(list(busy_times), dtype=float)
        if self._last_busy is None or len(busy) != len(self._last_busy):
            self._last_busy = busy
            self._ewma = None
            return 0.0
        delta = np.maximum(busy - self._last_busy, 0.0)
        self._last_busy = busy
        if self._cool > 0:
            # post-migration steps are polluted by the changed workers'
            # graph re-captures: keep them out of the EWMA
            self._cool -= 1
            return self.skew()
        if self._ewma is None:
            self._ewma = delta
        else:
            self._ewma = self.alpha * delta + (1 - self.alpha) * self._ewma
        return self.skew()

    def skew(self) -> float:
        e = self._ewma
        if e is None or e.mean() <= 0:
            return 0.0
        return float(e.max() / e.mean() - 1.0)

    # ------------------------------------------------------------------ #
    def propose(self, slices: Sequence[Slice], mb_size: int
                ) -> Optional[List[Slice]]:
        """A new partition if the skew warrants one, else None.

        Measured rate of worker i = rows_i / ewma_busy_i (rows it chews
        per busy-second).  Workers that measured zero busy time keep
        their current rows (no evidence either way).
        """
        skew = self.skew()
        if skew <= self.skew_threshold or self._cool > 0:
            self._hot_streak = 0 if skew <= self.skew_threshold else \
                self._hot_streak
            return None
        self._hot_streak += 1
        if self._hot_streak < self.patience:
            return None
        rows = np.asarray([hi - lo for lo, hi in slices], dtype=float)
        e = self._ewma
        if e is None or np.any(rows <= 0):
            return None
        rates = np.where(e > 0, rows / np.maximum(e, 1e-12), rows)
        new = PartitionPlanner.plan_from_rates(rates, mb_size,
                                               min_rows=self.min_rows)
        if new == list(slices):
            self._hot_streak = 0
            return None
        return new
