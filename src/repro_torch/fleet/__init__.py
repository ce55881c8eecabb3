"""R-worker fleet management for the port (the port's copy of
repro.fleet): heterogeneity-aware partition planning, live KV migration,
straggler rebalancing, and failure recovery.

Entry point::

    from repro_torch.fleet import FleetManager, skewed_fleet
    fleet = FleetManager(skewed_fleet((2.0, 1.0)), cfg=cfg,
                         rebalance=True, snapshot_interval=8)
    eng = ServingEngine(params, cfg, batch=8, cache_len=256,
                        backend="hetero", paged_kv=True, fleet=fleet)
"""
from repro_torch.fleet.manager import RECOVERY_MODES, FleetManager
from repro_torch.fleet.planner import PartitionPlanner, apportion_rows
from repro_torch.fleet.profile import (WorkerProfile, skewed_fleet,
                                       uniform_fleet)
from repro_torch.fleet.rebalancer import Rebalancer
from repro_torch.fleet.recovery import KVSnapshotStore, dead_workers
from repro_torch.fleet.telemetry import FleetEvent, FleetTelemetry

__all__ = [
    "FleetManager", "RECOVERY_MODES", "PartitionPlanner", "apportion_rows",
    "WorkerProfile", "skewed_fleet", "uniform_fleet", "Rebalancer",
    "KVSnapshotStore", "dead_workers", "FleetEvent", "FleetTelemetry",
]
