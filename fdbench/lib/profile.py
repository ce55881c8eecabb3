"""Reduction of a ``torch.profiler`` trace of a slice of the window: the
device's busy seconds (the union of every device interval over all
streams), device seconds by kernel name, and the longest idle gaps named
by what the host was doing.  The busy union and the per-kernel sums are
the arithmetic of ``chip_smoke.py``'s ``_profile_steps``, copied."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

NAME_CHARS = 120        # a kernel's demangled name, cut for the ledger


def _dev_events(prof) -> List:
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce(prof, t0_us: float, t1_us: float, top: int = 10) -> Dict:
    """Seconds of the slice [t0_us, t1_us] (the profiler's clock, in
    microseconds) in which an operation ran on the device, device seconds
    by kernel name, and the ``top`` longest idle gaps, each named by the
    host operation that overlapped it most."""
    dev = _dev_events(prof)
    spans = [(max(e.time_range.start, t0_us), min(e.time_range.end, t1_us))
             for e in dev]
    busy = _union([(a, b) for a, b in spans if b > a])
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = {}
    for e in dev:
        a, b = max(e.time_range.start, t0_us), min(e.time_range.end, t1_us)
        if b > a:
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e6
    gaps = []
    edges = [t0_us] + [x for ab in busy for x in ab] + [t1_us]
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]
    starts = np.array([e.time_range.start for e in host], dtype=np.float64)
    ends = np.array([e.time_range.end for e in host], dtype=np.float64)
    idle: Dict[str, float] = {}
    for a, b in gaps[:max(top * 20, 200)]:
        name = "no host op"
        if len(host):
            ov = np.minimum(b, ends) - np.maximum(a, starts)
            if ov.max() > 0:
                # the most overlap; of equals, the innermost (shortest) op
                i = np.lexsort((ends - starts, -ov))[0]
                name = host[i].name
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps_named = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_us / 1e6, "kernels": by_name,
            "device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
            "idle_gaps": [[n[:NAME_CHARS], s] for n, s in gaps_named]}
