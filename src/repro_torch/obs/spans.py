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
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional



class SpanTracer:
    def __init__(self, ring: int = 65536):
        self.t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._spans = deque(maxlen=max(1, int(ring)))
        self.added = 0          # lifetime adds; dropped = added - len(spans)

    # -- recording --------------------------------------------------------- #
    def now(self) -> float:
        return time.perf_counter()

    def add(self, name: str, cat: str, track: str,
            t_start: float, t_end: float,
            args: Optional[Dict] = None) -> None:
        """Record a complete span; ``t_start``/``t_end`` are
        ``perf_counter`` values (same clock as ``self.t0``)."""
        with self._lock:
            self._spans.append((name, cat, track, t_start, t_end, args))
            self.added += 1

    @property
    def dropped(self) -> int:
        with self._lock:
            return self.added - len(self._spans)

    # -- export ------------------------------------------------------------ #
    def spans(self) -> List[Dict]:
        """Spans as dicts (oldest first), for programmatic inspection."""
        with self._lock:
            raw = list(self._spans)
        out = []
        for name, cat, track, ts, te, args in raw:
            out.append({"name": name, "cat": cat, "track": track,
                        "ts_s": ts - self.t0,
                        "dur_s": max(0.0, te - ts),
                        "args": args or {}})
        return out

    def to_chrome(self) -> Dict:
        """Chrome trace-event JSON object.  Tracks become tids (with
        ``thread_name`` metadata so Perfetto labels them); ts/dur are
        microseconds relative to tracer construction."""
        with self._lock:
            raw = list(self._spans)
        tids: Dict[str, int] = {}
        events: List[Dict] = []
        for name, cat, track, ts, te, args in raw:
            tid = tids.setdefault(track, len(tids))
            ev = {"name": name, "cat": cat, "ph": "X",
                  "ts": round((ts - self.t0) * 1e6, 3),
                  "dur": round(max(0.0, te - ts) * 1e6, 3),
                  "pid": 0, "tid": tid}
            if args:
                ev["args"] = args
            events.append(ev)
        meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                 "args": {"name": track}} for track, tid in tids.items()]
        meta.append({"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                     "args": {"name": "repro serving"}})
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms",
                "otherData": {"dropped_spans": self.added - len(raw)}}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path
