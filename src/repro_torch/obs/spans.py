"""Ring-buffer pipeline span tracer with Chrome trace-event export.

The hetero decode loop records one span per (step, micro-batch, layer,
phase) R-Part round trip (dispatch -> last worker completion), one per
fused S-worker transition, and one per decode step; R-worker threads
add their busy windows.  Spans live in a bounded deque — a long
serving run keeps the most recent ``ring`` spans and counts what it
dropped, never growing without bound.

``export(path)`` writes the Chrome trace-event JSON format
(``{"traceEvents": [...]}``, ``ph: "X"`` complete events with
microsecond ``ts``/``dur``), loadable in Perfetto / ``chrome://tracing``
so OoO bubbles and straggler stalls are visually inspectable.

``add`` is the hot-path call: one perf_counter subtraction already done
by the caller, a tuple allocation, and a lock-guarded deque append.

The port's copy of repro.obs.spans (its lock a plain
``threading.Lock``).  The port's hot path replays CUDA graphs: a span is
host time around replays, dispatches and the sink's waits, recorded on
the host side of every replay call (Python inside a captured body runs
only at capture), and recording one adds no device synchronisation.

Beyond repro's tracer (the output is repro's while none of these is
used):

- a span may carry an ``id``, the ``parent`` span that caused it and the
  ``step`` its spans share; each goes into the span's ``args`` only when
  given (``next_id`` hands out ids, from any thread);
- named counters (``count``), written out with the spans;
- clock anchors (``mark_clock``): a ``perf_counter`` reading taken right
  after a ``record_function("repro.clock")`` range closes, so that under
  an active ``torch.profiler`` each anchor pairs with that range's end
  and ``clock_map`` places every span on the profiler's timeline; two
  anchors (one when the tracer is attached, one when it is detached) fix
  the offset and the rate between the two clocks.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

CLOCK_EVENT = "repro.clock"


class SpanTracer:
    def __init__(self, ring: int = 65536):
        self.t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._spans = deque(maxlen=max(1, int(ring)))
        self.added = 0          # lifetime adds; dropped = added - len(spans)
        self._ids = itertools.count(1)
        self._counters: Dict[str, float] = {}
        self.clock: List[float] = []     # mark_clock's perf_counter anchors

    # -- recording --------------------------------------------------------- #
    def now(self) -> float:
        return time.perf_counter()

    def next_id(self) -> int:
        """A fresh span id (``itertools.count``: atomic under the GIL)."""
        return next(self._ids)

    def add(self, name: str, cat: str, track: str,
            t_start: float, t_end: float,
            args: Optional[Dict] = None, *, id: Optional[int] = None,
            parent: Optional[int] = None,
            step: Optional[int] = None) -> None:
        """Record a complete span; ``t_start``/``t_end`` are
        ``perf_counter`` values (same clock as ``self.t0``)."""
        with self._lock:
            self._spans.append((name, cat, track, t_start, t_end, args,
                                id, parent, step))
            self.added += 1

    def add_spans(self, spans) -> None:
        """Record several spans under one lock: each a tuple of ``add``'s
        arguments in order, ``(name, cat, track, t_start, t_end, args,
        id, parent, step)``."""
        with self._lock:
            self._spans.extend(spans)
            self.added += len(spans)

    def count(self, name: str, n: float = 1) -> None:
        """Add ``n`` to the counter ``name``."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def mark_clock(self) -> float:
        """Open and close one ``record_function(CLOCK_EVENT)`` range (an
        event of an active ``torch.profiler``; nothing without one), then
        read ``perf_counter``: the anchor, kept in ``clock`` and
        returned, pairs with that range's end."""
        from torch.autograd.profiler import record_function
        with record_function(CLOCK_EVENT):
            pass
        t = time.perf_counter()
        with self._lock:
            self.clock.append(t)
        return t

    @property
    def dropped(self) -> int:
        with self._lock:
            return self.added - len(self._spans)

    # -- export ------------------------------------------------------------ #
    @staticmethod
    def _args(args, sid, parent, step) -> Optional[Dict]:
        if sid is None and parent is None and step is None:
            return args
        out = dict(args or {})
        for k, v in (("id", sid), ("parent", parent), ("step", step)):
            if v is not None:
                out[k] = v
        return out

    def spans(self) -> List[Dict]:
        """Spans as dicts (oldest first), for programmatic inspection."""
        with self._lock:
            raw = list(self._spans)
        out = []
        for name, cat, track, ts, te, args, sid, parent, step in raw:
            out.append({"name": name, "cat": cat, "track": track,
                        "ts_s": ts - self.t0,
                        "dur_s": max(0.0, te - ts),
                        "args": self._args(args, sid, parent, step) or {}})
        return out

    def to_chrome(self) -> Dict:
        """Chrome trace-event JSON object.  Tracks become tids (with
        ``thread_name`` metadata so Perfetto labels them); ts/dur are
        microseconds relative to tracer construction.  ``otherData``
        also holds the counters and the clock anchors (microseconds on
        the same scale) where there are any."""
        with self._lock:
            raw = list(self._spans)
            counters = dict(self._counters)
            clock = list(self.clock)
        tids: Dict[str, int] = {}
        events: List[Dict] = []
        for name, cat, track, ts, te, args, sid, parent, step in raw:
            tid = tids.setdefault(track, len(tids))
            ev = {"name": name, "cat": cat, "ph": "X",
                  "ts": round((ts - self.t0) * 1e6, 3),
                  "dur": round(max(0.0, te - ts) * 1e6, 3),
                  "pid": 0, "tid": tid}
            args = self._args(args, sid, parent, step)
            if args:
                ev["args"] = args
            events.append(ev)
        meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                 "args": {"name": track}} for track, tid in tids.items()]
        meta.append({"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                     "args": {"name": "repro serving"}})
        other: Dict = {"dropped_spans": self.added - len(raw)}
        if counters:
            other["counters"] = counters
        if clock:
            other["clock_us"] = [round((t - self.t0) * 1e6, 3)
                                 for t in clock]
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms",
                "otherData": other}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


def clock_map(anchors: Sequence[float],
              ends_us: Sequence[float]) -> Callable[[float], float]:
    """``perf_counter`` seconds -> the profiler's microseconds, from the
    anchors of ``mark_clock`` (``perf_counter`` seconds) and the ends of
    their ``CLOCK_EVENT`` ranges in the profiler's trace, in the same
    order: one pair fixes the offset, the first and last of two or more
    also the rate."""
    if not anchors or len(anchors) != len(ends_us):
        raise ValueError(f"{len(anchors)} clock anchors for "
                         f"{len(ends_us)} {CLOCK_EVENT} events")
    a0, e0 = float(anchors[0]), float(ends_us[0])
    rate = 1e6
    if len(anchors) > 1 and anchors[-1] > anchors[0]:
        rate = (float(ends_us[-1]) - e0) / (float(anchors[-1]) - a0)
    return lambda t: e0 + (t - a0) * rate
