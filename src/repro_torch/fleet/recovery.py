"""Failure detection and KV recovery for the R-worker fleet (the port's
copy of repro.fleet.recovery).

An attention worker that dies must not cost the whole batch its progress
(DéjàVu, arXiv 2403.01876).  Two recovery sources:

* ``KVSnapshotStore``: a periodic host copy of every worker's R-state in
  the dense wire format (``RWorker.export_rows``: numpy arrays, bf16 as
  its ``uint16`` bit pattern).  Restoring from it is exact when the
  snapshot was taken after the last decode step; otherwise the restored
  rows miss the tokens generated since (their positions stay masked).
* re-prefill: the serving layer recomputes lost rows exactly by running
  prefill on prompt + generated-so-far (``ServingEngine._replay_rows``).

Between decode steps death is ``not is_alive()`` (``dead_workers``, read
by ``FleetManager.pre_step``); mid-step the engine's collect loop
suspects dead, hung and silent workers (``_check_stall``) and aborts the
step with a ``StepFault`` that the serving layer's supervisor heals.

Snapshot payloads are checksummed (blake2b, ``chaos.checksum``) when
taken and verified at restore: a corrupted snapshot raises
``ChecksumError`` and the manager recovers through zeros + re-prefill
instead of installing garbage KV.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.chaos.checksum import ChecksumError, tree_digest


def dead_workers(engine) -> List[int]:
    """Indices (into ``engine.workers``) of workers that died."""
    return [i for i, w in enumerate(engine.workers) if not w.is_alive()]


class KVSnapshotStore:
    """Periodic host copy of the fleet's full R-state, keyed by layer key
    (micro-batch * num_layers + layer), each value covering the whole
    micro-batch in the dense wire format, so a restore works whatever
    partition the survivors adopt.

    The wire format is per row, so rows sharing ref-counted prefix pages
    are snapshotted with their own full copy (``nbytes`` measures it); the
    serving layer re-registers restored rows' prompts after a topology
    change so later admissions share again."""

    def __init__(self, interval: int = 0):
        self.interval = int(interval)
        self.step = -1                       # step of the stored snapshot
        self.data: Optional[Dict[int, Any]] = None
        self.checksums: Dict[int, bytes] = {}   # lkey -> capture digest
        self.last_s = 0.0                       # seconds of the last one

    def available(self) -> bool:
        return self.data is not None

    def nbytes(self) -> int:
        """Host bytes of the stored snapshot (0 when empty)."""
        if self.data is None:
            return 0
        return sum(np.asarray(leaf).nbytes for wire in self.data.values()
                   for leaf in wire.values())

    def maybe_snapshot(self, engine, step: int) -> bool:
        if self.interval <= 0 or step % self.interval != 0:
            return False
        self.snapshot(engine, step)
        return True

    def snapshot(self, engine, step: int) -> None:
        t0 = time.perf_counter()
        data: Dict[int, Any] = {}
        lkeys = sorted({k for w in engine.workers for k in w.state})
        for lk in lkeys:
            parts = [w.export_rows(lk, np.arange(w.hi - w.lo))
                     for w in engine.workers if lk in w.state]
            data[lk] = parts[0] if len(parts) == 1 else {
                k: np.concatenate([p[k] for p in parts], axis=0)
                for k in parts[0]}
        self.checksums = {lk: tree_digest(wire) for lk, wire in data.items()}
        chaos = getattr(engine, "chaos", None)
        if chaos is not None:
            for lk in data:
                if chaos.fire("wire_corrupt", where="snapshot", lkey=lk):
                    data[lk] = chaos.corrupt_tree(data[lk])
        self.data, self.step = data, step
        # parked pages belong to no row and ride the tier transport: copy
        # them to the host tier so a worker that later dies abruptly still
        # leaves its parked prefix chains restorable (the pages stay on
        # the device; a later real swap-out of the same digests is
        # deduplicated by the tier)
        if getattr(engine, "kv_tier", None) is not None:
            for w in engine.workers:
                for alloc in w.allocators.values():
                    alloc.flush_parked_to_tier()
        self.last_s = time.perf_counter() - t0

    def payload(self) -> Dict[int, Any]:
        """The stored wire payload, verified against its capture-time
        checksums: raises ``ChecksumError`` on corruption, so callers
        recover through zeros + re-prefill rather than restore garbage."""
        if self.data is None:
            raise RuntimeError("no snapshot taken yet")
        for lk, wire in self.data.items():
            want = self.checksums.get(lk)
            if want and tree_digest(wire) != want:
                raise ChecksumError(
                    f"KV snapshot (step {self.step}) failed its checksum "
                    f"for layer key {lk} — refusing to restore corrupted "
                    f"KV; recover via zeros + re-prefill instead")
        return self.data
