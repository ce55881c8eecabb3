"""Per-request lifecycle timeline helpers.

A request's timeline is the ordered list of ``(event, step, t, extra)``
tuples that :meth:`repro_torch.serving.request.Request.mark`
appends:

    submitted -> admitted [prefix_hit, restored] -> prefill_chunk*
              -> first_token -> token* -> (preempted -> parked ->
              submitted' ...)* -> [migrated] -> finished

Everything here derives scalars from that list — the engine observes
them into registry histograms at the moment they become known
(queue wait at admission, TTFT at first token, inter-token per token),
so these helpers mainly serve tests, post-hoc analysis, and the
``request_timeline()`` debugging surface.  The port's copy of
repro.obs.timeline.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

Event = Tuple[str, int, float, object]   # (name, step, perf_counter_t, extra)

# canonical event vocabulary (order here is documentation, not enforcement
# — preemption legitimately loops a request back to submitted/admitted)
EVENTS = ("submitted", "admitted", "prefix_hit", "restored",
          "prefill_chunk", "first_token", "token", "draft", "verify",
          "accept", "preempted", "parked", "migrated", "finished")


def first_t(events: List[Event], name: str) -> Optional[float]:
    for ev, _step, t, _x in events:
        if ev == name:
            return t
    return None


def last_t(events: List[Event], name: str) -> Optional[float]:
    out = None
    for ev, _step, t, _x in events:
        if ev == name:
            out = t
    return out


def queue_wait_s(events: List[Event]) -> Optional[float]:
    """First admission latency: submitted -> admitted."""
    t0, t1 = first_t(events, "submitted"), first_t(events, "admitted")
    return None if t0 is None or t1 is None else max(0.0, t1 - t0)


def ttft_s(events: List[Event]) -> Optional[float]:
    """Time to first token: submitted -> first_token."""
    t0, t1 = first_t(events, "submitted"), first_t(events, "first_token")
    return None if t0 is None or t1 is None else max(0.0, t1 - t0)


def e2e_s(events: List[Event]) -> Optional[float]:
    t0, t1 = first_t(events, "submitted"), last_t(events, "finished")
    return None if t0 is None or t1 is None else max(0.0, t1 - t0)


def inter_token_s(events: List[Event]) -> List[float]:
    """Gaps between consecutive generated tokens (first_token counts as
    token zero; preemption resets the chain so re-prefill stalls are
    not mislabeled as one giant inter-token gap)."""
    gaps: List[float] = []
    prev: Optional[float] = None
    for ev, _step, t, _x in events:
        if ev in ("first_token", "token"):
            if prev is not None:
                gaps.append(max(0.0, t - prev))
            prev = t
        elif ev == "preempted":
            prev = None
    return gaps


def summarize(events: List[Event]) -> Dict[str, object]:
    """One request's derived latencies + event counts (test/debug aid)."""
    counts: Dict[str, int] = {}
    for ev, _s, _t, _x in events:
        counts[ev] = counts.get(ev, 0) + 1
    gaps = inter_token_s(events)
    return {
        "queue_wait_s": queue_wait_s(events),
        "ttft_s": ttft_s(events),
        "e2e_s": e2e_s(events),
        "inter_token_mean_s": sum(gaps) / len(gaps) if gaps else None,
        "events_count": counts,
    }
