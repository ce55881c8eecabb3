"""Fault plans for the port (the port's copy of repro.chaos.plan):
seeded, occurrence-counted fault triggers.

Every injection point calls ``plan.fire(site, **ctx)``; the plan matches
the call against its :class:`FaultSpec` list and returns the spec that
fires (or ``None``).  Matching is deterministic: each spec keeps its own
``seen`` counter of matching invocations and fires on occurrences
``after < seen <= after + times``: no wall clock, no unseeded
randomness, so a plan replays identically run to run.

Injected exceptions derive from :class:`ChaosFault` and carry
``transient = True``: the step supervisor (``serving/engine.py``) tells
them from deterministic worker bugs, which it re-raises.

``corrupt_tree`` takes numpy arrays and torch tensors (a bf16 tensor has
no numpy dtype: its bytes are flipped through a ``uint8`` view of a host
copy), and returns corrupted host copies of the leaves.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

# The named injection sites (``fire()`` accepts any string; a misspelt
# site never fires, so tests assert on ``plan.fired``)
FAULT_SITES = (
    "r_step",        # RWorker._run_one: kind = crash | hang | error
    "completion",    # sink delivery:    kind = drop | dup
    "wire_corrupt",  # migration/snapshot payload bit flips (ctx: where=)
    "tier_corrupt",  # HostTier entry payload bit flips after checksum
    "tier_put",      # HostTier.put raises ChaosIOError
    "tier_get",      # HostTier.pop raises ChaosIOError
    "pool",          # PagedAllocator growth raises ChaosPoolExhausted
    "verify",        # spec-decode verify step aborts before commit
)


class ChaosFault(RuntimeError):
    """Base class of injected faults.  ``transient`` marks them safe to
    retry: the plan does not fire again once its budget is spent."""
    transient = True


class ChaosComputeError(ChaosFault):
    """Injected R-worker compute failure (site ``r_step``, kind
    ``error``)."""


class ChaosIOError(ChaosFault):
    """Injected host-tier I/O failure (sites ``tier_put`` / ``tier_get``)."""


class ChaosPoolExhausted(ChaosFault):
    """Injected transient page-pool exhaustion (site ``pool``).  Not a
    ``MemoryError``: the allocator's real-exhaustion fallback freezes the
    row, which is the wrong answer to a transient fault; this propagates
    to the step supervisor, which retries the step token-exactly."""


@dataclass
class FaultSpec:
    """One fault: where it fires, what it does, and when.

    ``after`` / ``times`` count *matching* ``fire()`` invocations: skip
    the first ``after`` matches, then fire on the next ``times``
    (``times=-1`` fires forever: a persistent fault the supervisor must
    escalate on)."""
    site: str
    kind: str = "fail"                 # site-specific action selector
    wid: Optional[int] = None          # only fire for this worker id
    where: Optional[str] = None        # only fire for this ctx "where"
    after: int = 0
    times: int = 1
    hang_s: float = 30.0               # sleep length for kind="hang"
    # run-time counters (mutated under the plan's lock)
    seen: int = field(default=0, compare=False)
    hits: int = field(default=0, compare=False)


class FaultPlan:
    """A seeded, thread-safe schedule of :class:`FaultSpec` triggers.

    ``fired`` is the forensic log, one dict per fired fault in firing
    order: the supervisor's MTTR attribution and the tests read it."""

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0):
        self.specs: List[FaultSpec] = list(specs)
        self.seed = int(seed)
        self._rng = np.random.default_rng(0xC7A05 + self.seed)
        self._lock = threading.Lock()
        self.fired: List[Dict[str, Any]] = []
        self.enabled = True
        # sites with at least one spec: fire() sits on the R-worker and
        # sink hot paths, so unarmed sites must not pay for the lock
        self._sites = frozenset(s.site for s in self.specs)

    def fire(self, site: str, **ctx: Any) -> Optional[FaultSpec]:
        """The spec that fires for this invocation, or None.  The first
        matching spec consumes the invocation; an exhausted spec passes it
        on to later specs of the same site."""
        if not self.enabled or site not in self._sites:
            return None
        with self._lock:
            for spec in self.specs:
                if spec.site != site:
                    continue
                if spec.wid is not None and ctx.get("wid") != spec.wid:
                    continue
                if spec.where is not None and ctx.get("where") != spec.where:
                    continue
                spec.seen += 1
                if spec.seen <= spec.after:
                    continue
                if 0 <= spec.times <= spec.hits:
                    continue
                spec.hits += 1
                self.fired.append(dict(site=site, kind=spec.kind,
                                       t=time.monotonic(), **ctx))
                return spec
        return None

    def count(self, site: Optional[str] = None) -> int:
        with self._lock:
            return len([f for f in self.fired
                        if site is None or f["site"] == site])

    # -- payload corruption -------------------------------------------------
    def corrupt_array(self, arr: np.ndarray) -> int:
        """Flip every bit of a few bytes of ``arr`` in place (which bytes
        is fixed by the plan's seed).  Returns the number of bytes
        touched."""
        a = np.asarray(arr)
        if a.size == 0 or not a.flags.writeable:
            return 0
        flat = a.view(np.uint8).reshape(-1)
        with self._lock:
            idx = self._rng.integers(0, flat.size,
                                     size=min(8, int(flat.size)))
        flat[np.asarray(idx)] ^= 0xFF
        return int(len(idx))

    def corrupt_tree(self, tree: Any) -> Any:
        """Corrupt every array leaf of a nested dict/list payload and
        return the corrupted tree of host copies (callers assign the
        result back).  A torch tensor leaf comes back as a host tensor of
        its dtype and shape, its bytes flipped through a ``uint8`` view
        (the same bytes an equal numpy array would get)."""
        if isinstance(tree, dict):
            return {k: self.corrupt_tree(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.corrupt_tree(v) for v in tree)
        if tree is None or isinstance(tree, (bool, int, float, str,
                                             bytes)):
            return tree
        if isinstance(tree, torch.Tensor):
            t = tree.detach().to("cpu", copy=True).contiguous()
            self.corrupt_array(t.reshape(-1).view(torch.uint8).numpy())
            return t
        a = np.array(tree)                 # writeable host copy
        self.corrupt_array(a)
        return a
