"""Heterogeneity-aware partition planning for the R-worker fleet (the
port's copy of repro.fleet.planner).

Replaces the engine's fixed ``np.linspace`` micro-batch split with a
proportional row assignment: each worker gets rows in proportion to its
R-Part token rate (1/R_i from ``core.perfmodel``), apportioned by the
largest-remainder method so the bounds stay contiguous and exact.  The
rebalancer reuses the same apportionment with *measured* rates (rows per
busy-second).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import perfmodel as P
from repro_torch.core.config import ModelConfig
from repro_torch.fleet.profile import WorkerProfile

Slice = Tuple[int, int]


def apportion_rows(total: int, weights: Sequence[float],
                   min_rows: int = 0) -> List[Slice]:
    """Contiguous (lo, hi) slices of ``total`` rows proportional to
    ``weights`` (largest-remainder / Hamilton apportionment).

    ``min_rows`` floors every positive-weight worker's allocation; it
    must satisfy ``min_rows * n <= total``.
    """
    w = np.asarray(list(weights), dtype=float)
    n = len(w)
    if n == 0:
        raise ValueError("apportion_rows needs at least one weight")
    if np.any(w < 0) or w.sum() <= 0:
        raise ValueError(f"weights must be >= 0 with a positive sum: {w}")
    if min_rows * int((w > 0).sum()) > total:
        raise ValueError(
            f"min_rows={min_rows} infeasible: {int((w > 0).sum())} workers "
            f"x {min_rows} rows > {total} total rows")
    ideal = total * w / w.sum()
    base = np.floor(ideal).astype(int)
    # floor to min_rows for positive-weight workers, then hand out the
    # remaining rows by largest fractional remainder
    base = np.where(w > 0, np.maximum(base, min_rows), 0)
    while base.sum() > total:                 # min_rows floor overshot
        # shrink the most over-allocated worker above its floor
        surplus = np.where(base > min_rows, base - ideal, -np.inf)
        base[int(np.argmax(surplus))] -= 1
    rem = ideal - base
    for _ in range(total - int(base.sum())):
        i = int(np.argmax(rem))
        base[i] += 1
        rem[i] = -np.inf
    bounds = np.concatenate([[0], np.cumsum(base)])
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(n)]


class PartitionPlanner:
    """Maps worker profiles to a proportional row partition.

    With a model config the weights come from ``perfmodel.fleet_rates``
    (the roofline: bandwidth vs FLOP bound, paged block-table overhead)
    on ``hw_r`` (``perfmodel.GPU_H100`` by default); without one they are
    the profiles' raw ``mem_bw_scale`` (the R-Part is bandwidth-bound).
    """

    def __init__(self, profiles: Sequence[WorkerProfile],
                 cfg: Optional[ModelConfig] = None,
                 hw_r: Optional[P.Hardware] = None, page: int = 0):
        if not profiles:
            raise ValueError("PartitionPlanner needs at least one profile")
        self.profiles = list(profiles)
        self.cfg = cfg
        self.hw_r = hw_r or P.GPU_H100
        self.page = page

    def weights(self, profiles: Optional[Sequence[WorkerProfile]] = None
                ) -> List[float]:
        profiles = self.profiles if profiles is None else list(profiles)
        if self.cfg is None:
            return [p.mem_bw_scale for p in profiles]
        return P.fleet_rates(self.cfg, [p.scaled_hw(self.hw_r)
                                        for p in profiles], page=self.page)

    def plan(self, rows: int,
             profiles: Optional[Sequence[WorkerProfile]] = None,
             min_rows: int = 1) -> List[Slice]:
        """Partition ``rows`` micro-batch rows over the (surviving)
        profiles.  Every worker keeps at least ``min_rows`` when feasible;
        with fewer rows than workers the slowest workers get none."""
        profiles = self.profiles if profiles is None else list(profiles)
        w = self.weights(profiles)
        if min_rows * len(profiles) > rows:
            keep = sorted(range(len(w)), key=lambda i: -w[i])[:rows]
            w = [wi if i in keep else 0.0 for i, wi in enumerate(w)]
            min_rows = 0
        return apportion_rows(rows, w, min_rows=min_rows)

    @staticmethod
    def plan_from_rates(rates: Sequence[float], rows: int,
                        min_rows: int = 1) -> List[Slice]:
        """Partition from *measured* per-worker rates (the rebalancer)."""
        return apportion_rows(rows, rates, min_rows=min_rows)
