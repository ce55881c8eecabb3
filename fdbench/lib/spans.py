"""Device-idle time put down to the port's own spans.

A traced run can attach a ``repro_torch.obs.SpanTracer`` to the engine
for the profiled slice (``ServingEngine.attach_tracer``) and mark its
clock (``mark_clock``) right after the profiler starts and again before
it stops.  ``reduce`` then places every span on the profiler's timeline
through those two anchors (``repro_torch.obs.spans.clock_map``), sweeps
*every* device-idle interval of the slice (the same bounds and the same
busy union as ``device_idle_pct``: ``profile._union`` over the device
intervals clipped to the slice) and puts each down to the S-worker's
innermost open span:

- ``engine``: an ``engine.*`` span (``ServingEngine.step`` outside the
  pipelined decode: admission, prefill, token upload, sampling, the token
  loop, the fleet);
- ``dispatch``: the pipeline's ``step N`` or a ``pipe.*`` span other than
  ``pipe.sink_wait`` (the S-side starts, dispatches, gathers and fused
  transitions);
- ``sink_wait``: ``pipe.sink_wait``, the S-worker blocked on the R-Part
  round trips;
- ``unspanned``: no span open on the S-worker (the caller's own time
  between ``step()`` calls).

The four add up to the slice's idle time.  ``rtt_host_ms`` is the mean,
over the round trips that lie in the slice, of the ``r-rtt`` span less
the longest ``r.sync`` among its workers (the D2H and the stream sync
that waits for the R-Part on the device): the round trip's host legs.

The readers return None where the run holds no spans or the tracer
dropped any.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from fdbench.lib import profile as P

S_TRACK = "s-worker"
PARTS = ("engine", "dispatch", "sink_wait", "unspanned")

Interval = Tuple[float, float]
Segment = Tuple[float, float, str]


def part(name: Optional[str]) -> str:
    """The part of the idle time an innermost S-worker span's name gives."""
    if name is None:
        return "unspanned"
    if name.startswith("engine."):
        return "engine"
    if name == "pipe.sink_wait":
        return "sink_wait"
    return "dispatch"


def innermost(spans: Sequence[Segment]) -> List[Segment]:
    """Disjoint segments ``(a, b, name)``, in order, on which ``name`` is
    the innermost open span of ``spans`` (``(start, end, name)``, nested
    as the spans of one thread are; a child that outlasts its parent by
    rounding is cut at the parent's end)."""
    out: List[Segment] = []
    stack: List[Tuple[float, str]] = []
    t = 0.0

    def close_until(x: Optional[float]) -> None:
        nonlocal t
        while stack and (x is None or stack[-1][0] <= x):
            end, name = stack.pop()
            if end > t:
                out.append((t, end, name))
                t = end

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        close_until(a)
        if stack:
            if a > t:
                out.append((t, a, stack[-1][1]))
            b = min(b, stack[-1][0])
        stack.append((b, name))
        t = a
    close_until(None)
    return out


def gaps(busy: Sequence[Interval], t0: float, t1: float) -> List[Interval]:
    """The idle intervals of [t0, t1] around ``busy`` (disjoint, sorted,
    inside [t0, t1]): every one, however short."""
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_by_name(idle: Sequence[Interval], segs: Sequence[Segment]
                 ) -> Dict[Optional[str], float]:
    """The idle time under each innermost span name (None: under no
    span), in the intervals' unit."""
    out: Dict[Optional[str], float] = {}
    j = 0
    for a, b in idle:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        covered = 0.0
        k = j
        while k < len(segs) and segs[k][0] < b:
            ov = min(b, segs[k][1]) - max(a, segs[k][0])
            if ov > 0:
                out[segs[k][2]] = out.get(segs[k][2], 0.0) + ov
                covered += ov
            k += 1
        if b - a > covered:
            out[None] = out.get(None, 0.0) + (b - a - covered)
    return out


def rtt_host(spans: Sequence[Dict], t0: float, t1: float
             ) -> Optional[float]:
    """Mean over the round trips inside [t0, t1] of the ``r-rtt`` span
    less the longest ``r.sync`` span among its workers (spans as dicts
    with ``a``, ``b``, ``cat``, ``name`` and ``args``; in their unit)."""
    sync: Dict[int, float] = {}
    for s in spans:
        if s["name"] == "r.sync" and "parent" in s["args"]:
            p = s["args"]["parent"]
            sync[p] = max(sync.get(p, 0.0), s["b"] - s["a"])
    legs = [s["b"] - s["a"] - sync[s["args"]["id"]] for s in spans
            if s["cat"] == "r-rtt" and s["args"].get("id") in sync
            and s["a"] >= t0 and s["b"] <= t1]
    return sum(legs) / len(legs) if legs else None


def _key(name: Optional[str]) -> str:
    if name is None:
        return "unspanned"
    return "step" if name.startswith("step ") else name


def reduce(prof, t0_us: float, t1_us: float, tracer) -> Dict:
    """The slice [t0_us, t1_us] (the profiler's clock) of a profile
    ``prof`` during which ``tracer`` was attached: its wall, the idle
    seconds by part and by innermost span name, ``rtt_host_ms``, the
    tracer's dropped spans and counters, and the engine steps whose
    ``engine.step`` span lies in the slice."""
    import torch
    from repro_torch.obs.spans import CLOCK_EVENT, clock_map
    clipped = [(max(e.time_range.start, t0_us), min(e.time_range.end, t1_us))
               for e in P._dev_events(prof)]
    busy = P._union([(a, b) for a, b in clipped if b > a])
    marks = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name == CLOCK_EVENT
                   and e.device_type == torch.autograd.DeviceType.CPU)
    to_us = clock_map(tracer.clock, [b for _, b in marks])
    spans = []
    for s in tracer.spans():
        a = tracer.t0 + s["ts_s"]
        spans.append(dict(s, a=to_us(a), b=to_us(a + s["dur_s"])))
    segs = innermost([(s["a"], s["b"], s["name"]) for s in spans
                      if s["track"] == S_TRACK])
    by_name = idle_by_name(gaps(busy, t0_us, t1_us), segs)
    parts = dict.fromkeys(PARTS, 0.0)
    named: Dict[str, float] = {}
    for name, us in by_name.items():
        parts[part(name)] += us / 1e6
        named[_key(name)] = named.get(_key(name), 0.0) + us / 1e6
    rtt = rtt_host(spans, t0_us, t1_us)
    anchors = tracer.clock
    return {"wall_s": (t1_us - t0_us) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "parts_s": parts,
            "idle_by_span_s": dict(sorted(named.items(),
                                          key=lambda kv: -kv[1])),
            "rtt_host_ms": None if rtt is None else rtt / 1e3,
            "dropped": tracer.dropped,
            "counters": tracer.counters(),
            "steps": sum(1 for s in spans if s["name"] == "engine.step"
                         and s["a"] >= t0_us and s["b"] <= t1_us),
            # profiler microseconds per perf_counter second, less 1e6
            "clock_drift_ppm": (to_us(anchors[-1]) - to_us(anchors[0]))
            / max(anchors[-1] - anchors[0], 1e-9) - 1e6}


def samples(sp: Dict) -> Dict:
    """What a traced run's ``samples`` line shows of ``reduce``'s result:
    the idle seconds by innermost span name (``unspanned`` the caller's
    own time), the dropped spans, and the counters per engine step."""
    steps = max(sp["steps"], 1)
    return {"idle_by_span_s": sp["idle_by_span_s"],
            "dropped_spans": sp["dropped"],
            "counters_per_step": {k: v / steps
                                  for k, v in sorted(sp["counters"].items())},
            "clock_drift_ppm": sp["clock_drift_ppm"]}


def _read(run) -> Optional[Dict]:
    sp = getattr(run, "spans", None)
    if not sp or sp["dropped"] or sp["wall_s"] <= 0:
        return None
    return sp


def _pct(run, name: str) -> Optional[float]:
    sp = _read(run)
    return None if sp is None else 100.0 * sp["parts_s"][name] / sp["wall_s"]


def idle_engine_pct(run) -> Optional[float]:
    """Device idle under an ``engine.*`` span, in % of the slice."""
    return _pct(run, "engine")


def idle_dispatch_pct(run) -> Optional[float]:
    """Device idle under ``step N`` or a ``pipe.*`` span other than
    ``pipe.sink_wait``, in % of the slice."""
    return _pct(run, "dispatch")


def idle_sink_wait_pct(run) -> Optional[float]:
    """Device idle under ``pipe.sink_wait``, in % of the slice."""
    return _pct(run, "sink_wait")


def rtt_host_ms(run) -> Optional[float]:
    """The mean round trip's host legs, in ms."""
    sp = _read(run)
    return None if sp is None else sp["rtt_host_ms"]
