"""Fleet telemetry: per-step load observations and lifecycle events (the
port's copy of repro.fleet.telemetry).

The manager records one observation per decode step (per-worker busy-time
deltas plus the current partition) and one event per migration, failure,
and recovery.  ``summary()`` is the machine-readable roll-up that the
engine's ``metrics()`` exports as ``fleet_*`` keys.

Observations are kept in a **ring buffer** (``max_observations``, default
4096): a long-running server records one per decode step forever, so an
unbounded list is a slow memory leak.  Roll-ups stay exact across
wraparound via running aggregates (``total_steps``, ``busy_s_total``)
maintained at record time — ``summary()`` never depends on what the ring
still holds.  Events (migrations/failures/recoveries) are rare and carry
the forensic detail, so they stay unbounded.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class FleetEvent:
    step: int
    kind: str                 # "migration" | "failure" | "recovery" | ...
    detail: Dict[str, object]


@dataclass
class StepObservation:
    step: int
    busy_deltas: Tuple[float, ...]       # per-worker busy seconds this step
    rows: Tuple[int, ...]                # per-worker row counts
    skew: float                          # max/mean busy imbalance - 1


class FleetTelemetry:
    def __init__(self, max_observations: int = 4096):
        self.max_observations = max(1, int(max_observations))
        self.observations: Deque[StepObservation] = \
            deque(maxlen=self.max_observations)
        self.events: List[FleetEvent] = []
        # running aggregates — exact regardless of ring wraparound
        self.total_steps = 0
        self.busy_s_total = 0.0

    def record_step(self, step: int, busy_deltas: Sequence[float],
                    rows: Sequence[int]) -> StepObservation:
        deltas = tuple(float(b) for b in busy_deltas)
        mean = sum(deltas) / len(deltas) if deltas else 0.0
        skew = (max(deltas) / mean - 1.0) if mean > 0 else 0.0
        obs = StepObservation(step, deltas, tuple(int(r) for r in rows), skew)
        self.observations.append(obs)
        self.total_steps += 1
        self.busy_s_total += sum(deltas)
        return obs

    def record_event(self, step: int, kind: str, **detail) -> None:
        self.events.append(FleetEvent(step, kind, detail))

    def events_of(self, kind: str) -> List[FleetEvent]:
        return [e for e in self.events if e.kind == kind]

    def last_skew(self) -> Optional[float]:
        return self.observations[-1].skew if self.observations else None

    def summary(self) -> Dict[str, object]:
        moved = sum(int(e.detail.get("moved_rows", 0))
                    for e in self.events_of("migration"))
        return {
            "steps": self.total_steps,
            "migrations": len(self.events_of("migration")),
            "failures": len(self.events_of("failure")),
            "recoveries": len(self.events_of("recovery")),
            "rows_migrated": moved,
            "last_skew": self.last_skew(),
        }
