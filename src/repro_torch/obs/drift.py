"""Perfmodel drift monitor: measured vs predicted, continuously.

``plan()`` / ``from_plan()`` bake in assumptions — per-transition
dispatch overhead, achievable tokens/s, prefix hit rate, tier
bandwidth — that rot as the fleet skews, workers die, or the workload
shifts.  The monitor splits a run into a **warmup** (the first
``warmup_steps`` decode steps are excluded entirely — JIT compilation
makes them pathologically slow and would poison the baseline), a
**calibration window** (the next ``calibration_steps`` steps, during
which it fits the baseline via
:func:`repro_torch.core.perfmodel.calibrate_orchestration` and a measured
tokens/s) and the **watch phase**, where every ``report()`` compares
the post-calibration measurements against that baseline and against
any analytic ``plan`` the engine was built from.

Residuals are ``measured - predicted`` with a relative form
``rel = residual / predicted``; ``|rel| > tolerance`` flags the key as
drifted.  Per-step cost is four float adds — the calibration fit and
the report are lazy.

The port's copy of repro.obs.drift.  On the card the first decode step
captures the CUDA graphs (and a chunked serve captures chunk graphs
mid-serve), so ``warmup_steps`` must reach past every capture: a capture
inside the calibration window poisons the baseline.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.perfmodel import (OrchestrationOverhead,
                                        calibrate_orchestration,
                                        orchestration_residuals)


@dataclass
class DriftRecord:
    key: str                 # schema-conformant metric name
    predicted: float
    measured: float

    @property
    def residual(self) -> float:
        return self.measured - self.predicted

    @property
    def rel(self) -> float:
        if self.predicted == 0.0:
            return 0.0 if self.measured == 0.0 else float("inf")
        return self.residual / self.predicted


@dataclass
class DriftReport:
    calibrated: bool
    steps_count: int                    # watch-phase steps measured
    records: List[DriftRecord] = field(default_factory=list)
    flagged: List[str] = field(default_factory=list)

    def record(self, key: str) -> Optional[DriftRecord]:
        for r in self.records:
            if r.key == key:
                return r
        return None

    def as_metrics(self) -> Dict[str, float]:
        out = {"drift_calibrated_count": float(self.calibrated),
               "drift_flagged_count": float(len(self.flagged)),
               "drift_steps_count": float(self.steps_count)}
        for r in self.records:
            out[f"drift_{r.key}_predicted"] = r.predicted
            out[f"drift_{r.key}_measured"] = r.measured
            out[f"drift_{r.key}_rel"] = r.rel
        return out

    def __str__(self) -> str:
        if not self.calibrated:
            return ("drift: still calibrating "
                    f"({self.steps_count} watch steps)")
        lines = [f"drift report ({self.steps_count} watch steps, "
                 f"{len(self.flagged)} flagged)"]
        for r in self.records:
            mark = " <-- DRIFTED" if r.key in self.flagged else ""
            lines.append(f"  {r.key:28s} predicted={r.predicted:12.6g} "
                         f"measured={r.measured:12.6g} "
                         f"rel={r.rel:+8.1%}{mark}")
        return "\n".join(lines)


class DriftMonitor:
    def __init__(self, cfg, num_mb: int, num_workers: int, *,
                 calibration_steps: int = 20, tolerance: float = 0.5,
                 warmup_steps: int = 2, plan: Optional[Dict] = None):
        self.cfg = cfg
        self.num_mb = num_mb
        self.num_workers = num_workers
        self.calibration_steps = max(1, int(calibration_steps))
        self.warmup_steps = max(0, int(warmup_steps))
        self.tolerance = float(tolerance)
        self.plan = plan
        self.steps = 0
        self.tokens = 0.0
        self.wall_s = 0.0
        # snapshots taken at the warmup and calibration boundaries
        self._warm_stats: Dict[str, float] = {}
        self._warm_tokens = 0.0
        self._warm_wall = 0.0
        self._calib_stats: Optional[Dict[str, float]] = None
        self._calib_tokens = 0.0
        self._calib_wall = 0.0
        self.baseline_overhead: Optional[OrchestrationOverhead] = None
        self.baseline_tokens_per_s = 0.0
        self._last_stats: Dict[str, float] = {}

    # -- hot path ----------------------------------------------------------- #
    def observe_step(self, *, wall_s: float, tokens: int,
                     step_stats: Dict[str, float],
                     num_workers: Optional[int] = None) -> None:
        """Called once per decode step.  ``step_stats`` is the engine's
        cumulative stats dict (kept by reference until a snapshot is
        needed, so the per-step cost is a few float adds)."""
        self.steps += 1
        self.tokens += tokens
        self.wall_s += wall_s
        if num_workers:
            self.num_workers = num_workers
        self._last_stats = step_stats
        if self.steps == self.warmup_steps:
            self._warm_stats = dict(step_stats)
            self._warm_tokens = self.tokens
            self._warm_wall = self.wall_s
        elif self.steps == self.warmup_steps + self.calibration_steps:
            self._calibrate(step_stats)

    def _calibrate(self, step_stats: Dict[str, float]) -> None:
        self._calib_stats = dict(step_stats)
        self._calib_tokens = self.tokens
        self._calib_wall = self.wall_s
        # the baseline fit is the delta over the calibration window
        # only — warmup steps (JIT compile) never enter it
        delta = {k: v - self._warm_stats.get(k, 0.0)
                 for k, v in step_stats.items()}
        self.baseline_overhead = calibrate_orchestration(
            delta, self.cfg, self.num_mb, self.num_workers)
        wall = self.wall_s - self._warm_wall
        if wall > 0:
            self.baseline_tokens_per_s = \
                (self.tokens - self._warm_tokens) / wall

    @property
    def calibrated(self) -> bool:
        return self._calib_stats is not None

    # -- reporting ---------------------------------------------------------- #
    def report(self) -> DriftReport:
        watch_steps = self.steps - self.warmup_steps - self.calibration_steps
        rep = DriftReport(calibrated=self.calibrated,
                          steps_count=max(0, watch_steps))
        if not self.calibrated or watch_steps <= 0:
            return rep
        # watch-phase deltas of the cumulative stats dict
        delta = {k: self._last_stats.get(k, 0.0) - self._calib_stats.get(k, 0.0)
                 for k in self._last_stats}
        measured_oh = calibrate_orchestration(
            delta, self.cfg, self.num_mb, self.num_workers)
        for k, v in orchestration_residuals(
                self.baseline_overhead, measured_oh).items():
            rep.records.append(DriftRecord(
                key=k, predicted=v["predicted"], measured=v["measured"]))
        wall = self.wall_s - self._calib_wall
        measured_tps = ((self.tokens - self._calib_tokens) / wall
                        if wall > 0 else 0.0)
        rep.records.append(DriftRecord(
            key="tokens_per_s", predicted=self.baseline_tokens_per_s,
            measured=measured_tps))
        if self.plan:
            # the analytic plan's own promise, reported alongside the
            # calibrated baseline (sim runs sit far below hardware
            # roofline, so this record is informational on CPU)
            tps = float(self.plan.get("tokens_per_s", 0.0) or 0.0)
            if tps > 0:
                rep.records.append(DriftRecord(
                    key="plan_tokens_per_s", predicted=tps,
                    measured=measured_tps))
        rep.flagged = [r.key for r in rep.records
                       if r.key != "plan_tokens_per_s"
                       and abs(r.rel) > self.tolerance]
        return rep
