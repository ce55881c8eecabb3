"""The fleet manager: owns the R-worker pool end to end (the port's copy
of repro.fleet.manager).

Construction: ``HeteroPipelineEngine(..., fleet=FleetManager(profiles))``
delegates worker construction: the planner turns profiles into a
proportional (possibly uneven) partition and the manager spawns one
``RWorker`` per non-empty slice.

Steady state: the serving engine calls ``pre_step`` before each decode
step (health check -> failure recovery) and ``post_step`` after it
(telemetry, EWMA straggler detection -> live migration, periodic KV
snapshots).  Both are no-ops when nothing needs doing.

On the card a topology change re-captures the changed workers' R-Part
graphs on their next step (``RWorker.reassign`` releases them); the
migration and recovery events carry their seconds and the wire bytes
moved.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.chaos.checksum import ChecksumError
from repro_torch.core.config import ModelConfig
from repro_torch.fleet.planner import PartitionPlanner
from repro_torch.fleet.profile import WorkerProfile
from repro_torch.fleet.rebalancer import Rebalancer
from repro_torch.fleet.recovery import KVSnapshotStore, dead_workers
from repro_torch.fleet.telemetry import FleetTelemetry

RECOVERY_MODES = ("reprefill", "snapshot", "zeros")


class FleetManager:
    def __init__(self, profiles: Sequence[WorkerProfile], *,
                 cfg: Optional[ModelConfig] = None, hw_r=None, page: int = 0,
                 rebalancer: Optional[Rebalancer] = None,
                 rebalance: bool = False,
                 snapshot_interval: int = 0,
                 recovery: str = "reprefill",
                 health_checks: bool = True,
                 telemetry_window: int = 4096):
        if recovery not in RECOVERY_MODES:
            raise ValueError(
                f"recovery must be one of {RECOVERY_MODES}, got {recovery!r}")
        self.profiles = list(profiles)
        self.planner = PartitionPlanner(self.profiles, cfg=cfg, hw_r=hw_r,
                                        page=page)
        self.rebalancer = rebalancer or (Rebalancer() if rebalance else None)
        self.snapshots = KVSnapshotStore(snapshot_interval)
        self.recovery_mode = recovery
        self.health_checks = health_checks
        self.telemetry = FleetTelemetry(max_observations=telemetry_window)
        self.engine = None
        self.step = 0
        self._profile_of: Dict[int, WorkerProfile] = {}   # id(worker) ->
        self._spawned_profiles: List[WorkerProfile] = []
        self._tele_busy: Optional[List[float]] = None
        # the serving layer's re-prefill callback, kept from pre_step so
        # mid-serve migrations (rebalance_now) can replay rows whose wire
        # payload failed its transport checksum
        self._reprefill: Optional[Callable] = None

    # -- construction ------------------------------------------------------ #
    def spawn_workers(self, cfg: ModelConfig, mb_size: int,
                      worker_kwargs: Dict[str, Any]):
        """Engine hook: profiles -> planned partition -> RWorker list.
        Profiles that plan to zero rows (more workers than rows) are
        dropped."""
        from repro_torch.core.hetero import RWorker
        slices = self.planner.plan(mb_size)
        workers, kept = [], []
        for (lo, hi), prof in zip(slices, self.profiles):
            if hi <= lo:
                continue
            kw = dict(worker_kwargs)
            if kw.get("num_pages"):
                kw["num_pages"] = max(1, int(kw["num_pages"]
                                             * prof.page_pool_scale))
            w = RWorker(len(workers), cfg, lo, hi, profile=prof,
                        slowdown=prof.sim_slowdown,
                        sim_row_cost=prof.sim_row_cost,
                        sim_deliver_jitter=prof.sim_deliver_jitter, **kw)
            self._profile_of[id(w)] = prof
            self._spawned_profiles.append(prof)
            workers.append(w)
            kept.append((lo, hi))
        return workers, kept

    def attach(self, engine) -> None:
        self.engine = engine
        for w in engine.workers:         # non-fleet-spawned engines too
            prof = self._profile_of.setdefault(
                id(w), WorkerProfile(name=w.name))
            if prof not in self._spawned_profiles:
                self._spawned_profiles.append(prof)

    # -- accounting -------------------------------------------------------- #
    def surviving_profiles(self) -> List[WorkerProfile]:
        return [self._profile_of[id(w)] for w in self.engine.workers]

    def weight_fraction(self) -> float:
        """Surviving fleet R-throughput as a fraction of the SPAWNED fleet
        (drives admission re-costing after a topology change); profiles
        the planner dropped at spawn never contributed."""
        spawned = self._spawned_profiles or self.profiles
        total = sum(self.planner.weights(spawned))
        if total <= 0:
            return 1.0
        return sum(self.planner.weights(self.surviving_profiles())) / total

    # -- per-step hooks ---------------------------------------------------- #
    def pre_step(self, reprefill: Optional[Callable] = None,
                 on_topology: Optional[Callable] = None) -> int:
        """Health check + recovery; returns how many failures were
        handled.  Runs BEFORE a decode step is dispatched, so a worker
        that died between steps never receives work it cannot answer."""
        handled = 0
        if reprefill is not None:
            self._reprefill = reprefill
        if not self.health_checks or self.engine is None:
            return handled
        while True:
            dead = dead_workers(self.engine)
            if not dead:
                break
            if len(self.engine.workers) <= 1:
                # fail fast: dispatching to a dead sole worker would block
                # on collect for its full timeout
                raise RuntimeError(
                    "fleet has no live R-workers left — the last worker "
                    "died and there is no survivor to adopt its rows")
            self.handle_failure(dead[0], reprefill=reprefill,
                                on_topology=on_topology)
            handled += 1
        return handled

    def post_step(self, step: Optional[int] = None) -> None:
        """Telemetry + straggler rebalancing + periodic snapshots; runs
        AFTER a decode step (counters fresh, no work in flight)."""
        eng = self.engine
        self.step = self.step + 1 if step is None else int(step)
        busy = eng.worker_busy_times()
        if self._tele_busy is None or len(self._tele_busy) != len(busy):
            deltas = [0.0] * len(busy)
        else:
            deltas = [max(0.0, b - p) for b, p in zip(busy, self._tele_busy)]
        self._tele_busy = list(busy)
        self.telemetry.record_step(self.step, deltas,
                                   [hi - lo for lo, hi in eng.slices])
        if self.rebalancer is not None:
            skew = self.rebalancer.observe(busy)
            proposal = self.rebalancer.propose(eng.slices, eng.mb_size)
            if proposal is not None:
                self.rebalance_now(proposal, skew=skew)
        if self.snapshots.maybe_snapshot(eng, self.step):
            self.telemetry.record_event(
                self.step, "snapshot", duration_s=self.snapshots.last_s,
                wire_bytes=self.snapshots.nbytes())

    # -- actions ----------------------------------------------------------- #
    def rebalance_now(self, new_slices, skew: Optional[float] = None) -> int:
        t0 = time.perf_counter()
        # the per-row wire format duplicates shared prefix pages: record
        # how much sharing the move un-shares (the serving layer
        # re-registers prompts afterwards so later admissions re-share)
        shared_before = self._shared_pages()
        moved = self.engine.apply_partition(new_slices)
        self._tele_busy = None               # the worker list may shrink
        if self.rebalancer is not None:
            self.rebalancer.reset()          # measurements are stale now
        # rows whose wire payload failed its checksum were installed from
        # `lost` filler: replay them from token history (when the serving
        # layer gave the callback), so a detected corruption costs a
        # re-prefill, not wrong tokens
        bad = list(getattr(self.engine, "corrupt_rows", []))
        replayed = 0
        if bad:
            if self._reprefill is not None:
                replayed = self._reprefill(bad)
            self.telemetry.record_event(
                self.step, "corruption", source="migration-wire",
                rows=len(bad), replayed=replayed)
        self.telemetry.record_event(
            self.step, "migration", moved_rows=moved, skew=skew,
            slices=list(self.engine.slices),
            unshared_pages=shared_before - self._shared_pages(),
            duration_s=time.perf_counter() - t0,
            **self._move_detail(), **self._tier_detail())
        return moved

    def _move_detail(self) -> Dict[str, float]:
        """The last repartition's wire bytes and its export and install
        seconds (the rest of its duration is the checksums)."""
        last = self.engine.last_migration
        return {k: last.get(k, 0) for k in ("wire_bytes", "export_s",
                                            "load_s")}

    def _shared_pages(self) -> int:
        eng = self.engine
        if eng is None or not getattr(eng, "prefix_cache", False):
            return 0
        return int(eng.prefix_cache_stats().get("shared_pages", 0))

    def _tier_detail(self) -> Dict[str, int]:
        """Host-tier occupancy for topology events: migrations and
        recoveries are when parked or swapped KV rides the tier."""
        tier = getattr(self.engine, "kv_tier", None)
        if tier is None:
            return {}
        return {"swapped_pages": tier.swapped_pages(),
                "host_tier_bytes": tier.nbytes()}

    def snapshot_now(self) -> None:
        self.snapshots.snapshot(self.engine, self.step)

    def handle_failure(self, widx: int,
                       reprefill: Optional[Callable] = None,
                       on_topology: Optional[Callable] = None) -> None:
        """Drop a dead worker, repartition the survivors through the
        planner, and restore its rows by the configured recovery mode."""
        eng = self.engine
        t0 = time.perf_counter()
        dead = eng.workers[widx]
        dead_slice = (dead.lo, dead.hi)
        self.telemetry.record_event(self.step, "failure", worker=dead.wid,
                                    slice=dead_slice)
        survivors = [w for i, w in enumerate(eng.workers) if i != widx]
        new_slices = self.planner.plan(
            eng.mb_size,
            profiles=[self._profile_of[id(w)] for w in survivors])
        lost = None
        mode = self.recovery_mode
        if mode == "snapshot":
            if self.snapshots.available():
                try:
                    lost = self.snapshots.payload()
                except ChecksumError:
                    # a corrupted snapshot is refused: recover exactly by
                    # re-prefill when the serving layer gave its callback,
                    # zeros otherwise (detected, never silent garbage)
                    self.telemetry.record_event(
                        self.step, "corruption", source="snapshot",
                        snapshot_step=self.snapshots.step)
                    mode = "reprefill" if reprefill is not None else "zeros"
            else:
                mode = "zeros"               # nothing snapshotted yet
        eng.remove_worker(widx, new_slices=new_slices, lost=lost)
        self._tele_busy = None
        if self.rebalancer is not None:
            self.rebalancer.reset()
        rows = [mb * eng.mb_size + r for mb in range(eng.num_mb)
                for r in range(*dead_slice)]
        # rows whose migration payload failed its checksum fell back to
        # `lost` in the repartition: replay them too
        rows += [r for r in getattr(eng, "corrupt_rows", [])
                 if r not in rows]
        replayed = 0
        if mode == "reprefill":
            if reprefill is None:
                mode = "zeros"               # no serving layer to replay
            else:
                replayed = reprefill(rows)
        self.telemetry.record_event(
            self.step, "recovery", mode=mode, rows=len(rows),
            replayed=replayed, snapshot_step=self.snapshots.step,
            duration_s=time.perf_counter() - t0,
            **self._move_detail(), **self._tier_detail())
        if on_topology is not None:
            on_topology(self.weight_fraction())
