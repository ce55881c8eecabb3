"""Per-worker capability profiles for a heterogeneous R-worker fleet
(the port's copy of repro.fleet.profile).

FastDecode §5 handles "efficiency challenges brought by heterogeneity at
intra-device and inter-device scopes using scheduling and performance
modeling".  A :class:`WorkerProfile` is the inter-device half of that:
the planner's description of ONE R-worker's relative capabilities —
memory bandwidth (the R-Part is bandwidth-bound), FLOPs and page-pool
capacity — as scale factors over a baseline
:class:`repro_torch.core.perfmodel.Hardware` (``GPU_H100`` by default;
the JAX package defaults to its TPU profile), or as explicit hardware.

The port's R-workers are threads sharing one card, so they all run at
the same real speed; ``sim_slowdown``, ``sim_row_cost`` and
``sim_deliver_jitter`` inject the skew the planner and the rebalancer
must handle.  They act on the host side of the replayed graphs.  A real
deployment leaves them at their defaults.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Sequence

from repro_torch.core.perfmodel import GPU_H100, Hardware


@dataclass(frozen=True)
class WorkerProfile:
    """Planner-visible description of one R-worker.

    Scale factors are relative to the fleet's baseline hardware (an
    explicit ``hardware`` overrides them).  ``page_pool_scale`` scales an
    explicitly sized page pool (``pages_per_worker``); the default
    row-proportional pool sizing already tracks the planned partition.
    """
    name: str = "r-worker"
    mem_bw_scale: float = 1.0
    flops_scale: float = 1.0
    page_pool_scale: float = 1.0
    # simulated skew: sim_slowdown multiplies the worker's real compute
    # time (a slower device doing the same work); sim_row_cost adds a
    # deterministic seconds-per-row service time (a bandwidth-bound
    # worker streaming its rows' KV); sim_deliver_jitter delays result
    # DELIVERY by uniform [0, j) seconds without occupying the worker (an
    # async send over a jittery link)
    sim_slowdown: float = 1.0
    sim_row_cost: float = 0.0
    sim_deliver_jitter: float = 0.0
    hardware: Optional[Hardware] = None

    def scaled_hw(self, base: Hardware = GPU_H100) -> Hardware:
        """The Hardware this profile describes, for perfmodel queries."""
        if self.hardware is not None:
            return self.hardware
        return replace(base, name=f"{base.name}:{self.name}",
                       flops=base.flops * self.flops_scale,
                       mem_bw=base.mem_bw * self.mem_bw_scale)


def uniform_fleet(n: int, **kw) -> List[WorkerProfile]:
    """``n`` identical workers (the homogeneous baseline)."""
    return [WorkerProfile(name=f"r{i}", **kw) for i in range(n)]


def skewed_fleet(bw_scales: Sequence[float], **kw) -> List[WorkerProfile]:
    """One worker per entry, bandwidth-scaled: ``(2.0, 1.0)`` is a 2:1
    two-worker fleet."""
    return [WorkerProfile(name=f"r{i}", mem_bw_scale=float(s), **kw)
            for i, s in enumerate(bw_scales)]
