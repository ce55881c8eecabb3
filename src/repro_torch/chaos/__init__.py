"""Deterministic fault injection for the port's heterogeneous serving
pipeline (the port's copy of repro.chaos).

A seeded :class:`FaultPlan` fires faults at named **sites** threaded
through the engine: R-worker crash / hang / compute error mid-step,
completion drop / duplication, KV wire-payload bit corruption, tier
swap / restore I/O failure, transient pool exhaustion, an aborted verify
step.  Triggers count occurrences (never the clock), so a plan and seed
replay the same fault schedule on every run.

The serving layer's supervisor (``ServingEngine``) turns every injected
fault into a recovery; ``tests/test_torch_chaos.py`` holds the recovered
runs token-exact to a fault-free oracle.  With no plan attached every
hook is one ``is None`` test.
"""
from repro_torch.chaos.checksum import (ChecksumError, payload_checksum,
                                        tree_digest)
from repro_torch.chaos.plan import (FAULT_SITES, ChaosComputeError,
                                    ChaosFault, ChaosIOError,
                                    ChaosPoolExhausted, FaultPlan, FaultSpec)

__all__ = [
    "FaultPlan", "FaultSpec", "FAULT_SITES",
    "ChaosFault", "ChaosComputeError", "ChaosIOError", "ChaosPoolExhausted",
    "ChecksumError", "tree_digest", "payload_checksum",
]
