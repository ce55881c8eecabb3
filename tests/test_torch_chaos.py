"""The port's chaos harness and step supervisor against the JAX package
(the port's twins of tests/test_chaos.py):

* fault plans: the port's ``FaultPlan`` fires on the same invocations as
  ``repro``'s for the same ``fire()`` sequence, and ``corrupt_array``
  flips the same bytes for the same seed (``corrupt_tree`` also takes
  torch tensors, bf16 included);
* the fault matrix: crash, error, dup and pool on dense, paged and int8
  storage, a dropped completion, the spec-decode ``verify`` site, the
  three host-tier sites and wire corruption on migration and on a
  snapshot each heal (or degrade, detected) to the tokens of the
  colocated JAX oracle (``conftest.serve_trace(..., backend=
  "colocated")``) on the same weights;
* the orphaned append of a dropped completion: after the resync the
  allocators' row lengths and mapped pages equal a fault-free run's;
* the supervisor's bookkeeping, its re-raise with request ids, and
  ``close()`` warning on a hung worker, whose graphs are freed only once
  its thread has exited.

Timeouts keep clear of ``-n 6`` load: ``suspect_after_s`` 2 s,
``collect_timeout_s`` 60 s, faults triggered by occurrence counts, one
hang (3 s).  fp32 on the CPU."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import random_spec, serve_trace, tiny_cfg
from repro.chaos import FaultPlan as JFaultPlan
from repro.chaos import FaultSpec as JFaultSpec
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.request import Request as JRequest
from repro_torch import bridge
from repro_torch.chaos import (FAULT_SITES, FaultPlan, FaultSpec,
                               tree_digest)
from repro_torch.core.config import ModelConfig
from repro_torch.core.hetero import CollectTimeout, StepFault
from repro_torch.fleet import FleetManager, WorkerProfile
from repro_torch.serving import paged_cache as PC
from repro_torch.serving.engine import ServingEngine, SpecConfig
from repro_torch.serving.request import Request

CHAOS = dict(suspect_after_s=2.0, collect_timeout_s=60.0)
STORAGE = {"dense": {}, "paged": dict(paged_kv=True, page_size=4),
           "int8": dict(quantized_kv=True),
           "paged-int8": dict(paged_kv=True, page_size=4, quantized_kv=True)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jc = dataclasses.replace(tiny_cfg("qwen3-8b"), num_kv_heads=2)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    spec = random_spec(np.random.default_rng(11), jc, 6)
    return jc, tc, jp, tp, spec, serve_trace(jp, jc, spec,
                                             backend="colocated")


def _serve(tp, tc, spec, on_step=None, **kw):
    """conftest.serve_trace's loop for the port; ``on_step(eng)`` runs
    before every step.  Returns ({rid: tokens}, the closed engine)."""
    eng = ServingEngine(tp, tc, batch=kw.pop("batch", 4),
                        cache_len=kw.pop("cache_len", 48), device="cpu",
                        **kw)
    try:
        qi = 0
        order = sorted(range(len(spec)), key=lambda i: spec[i][2])
        while (qi < len(order) or eng.queue
               or any(s is not None for s in eng.slots)) \
                and eng.step_idx < 400:
            while qi < len(order) and spec[order[qi]][2] <= eng.step_idx:
                i = order[qi]
                eng.submit(Request(rid=i, prompt=spec[i][0],
                                   max_new_tokens=spec[i][1]))
                qi += 1
            if on_step is not None:
                on_step(eng)
            eng.step()
        return {r.rid: list(r.generated) for r in eng.finished}, eng
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# fault plans and payload corruption against repro's
# ---------------------------------------------------------------------------
PLANS = [
    [("r_step", dict(after=2, times=2))],
    [("r_step", dict(kind="crash", wid=1)), ("completion", dict(after=3))],
    [("wire_corrupt", dict(where="snapshot", times=-1)),
     ("wire_corrupt", dict(where="migration", after=1))],
    [("pool", dict(after=1, times=3)), ("pool", dict(times=1))],
]
CALLS = [("r_step", dict(wid=0)), ("r_step", dict(wid=1)),
         ("completion", dict(wid=1)), ("wire_corrupt", dict(where="snapshot")),
         ("wire_corrupt", dict(where="migration")), ("pool", {}),
         ("tier_put", {})] * 4


@pytest.mark.parametrize("plan", range(len(PLANS)))
def test_fault_plan_fires_like_repro(plan):
    mine = FaultPlan([FaultSpec(site=s, **kw) for s, kw in PLANS[plan]])
    ref = JFaultPlan([JFaultSpec(site=s, **kw) for s, kw in PLANS[plan]])
    got = [mine.fire(site, **ctx) for site, ctx in CALLS]
    want = [ref.fire(site, **ctx) for site, ctx in CALLS]
    assert [g is None for g in got] == [w is None for w in want]
    assert [None if g is None else (g.site, g.kind, g.hits) for g in got] \
        == [None if w is None else (w.site, w.kind, w.hits) for w in want]
    assert mine.count() == ref.count() >= 1
    for site in FAULT_SITES:
        assert mine.count(site) == ref.count(site)
    assert [{k: v for k, v in f.items() if k != "t"} for f in mine.fired] \
        == [{k: v for k, v in f.items() if k != "t"} for f in ref.fired]


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_corrupt_array_flips_the_bytes_repro_flips(seed):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(37).astype(np.float32)
    a, b = base.copy(), base.copy()
    assert FaultPlan(seed=seed).corrupt_array(a) \
        == JFaultPlan(seed=seed).corrupt_array(b) == 8
    assert a.tobytes() == b.tobytes() != base.tobytes()
    # a tree: the same draws in the same leaf order, on host copies
    tree = {"k": base.reshape(37, 1), "pos": np.arange(5, dtype=np.int32)}
    got = FaultPlan(seed=seed).corrupt_tree(tree)
    want = JFaultPlan(seed=seed).corrupt_tree(tree)
    assert all(got[k].tobytes() == want[k].tobytes() for k in tree)
    assert tree["pos"].tolist() == list(range(5))        # not in place


def test_corrupt_tree_takes_tensors():
    """A torch leaf (bf16 has no numpy dtype) comes back as a corrupted
    host tensor of its dtype and shape: its bytes flipped as an equal
    numpy array's, so ``tree_digest`` sees the change."""
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    bf = x.to(torch.bfloat16)
    got = FaultPlan(seed=5).corrupt_tree({"a": x, "b": bf, "n": None})
    want = x.numpy().copy()
    FaultPlan(seed=5).corrupt_array(want)
    assert got["a"].dtype == torch.float32 and got["a"].shape == (4, 6)
    assert got["a"].numpy().tobytes() == want.tobytes()
    assert got["b"].dtype == torch.bfloat16 and got["n"] is None
    assert torch.equal(x, torch.arange(24, dtype=torch.float32).reshape(4, 6))
    assert tree_digest({"b": got["b"]}) != tree_digest({"b": bf})


# ---------------------------------------------------------------------------
# the fault matrix: token equality with the colocated oracle IS the
# recovery proof (fault-free hetero == colocated is pinned elsewhere)
# ---------------------------------------------------------------------------
def _specs(fault, wid=1):
    return {
        "crash": [FaultSpec(site="r_step", kind="crash", wid=wid,
                            after=40)],
        "error": [FaultSpec(site="r_step", kind="error", wid=wid,
                            after=40)],
        "dup": [FaultSpec(site="completion", kind="dup", after=15)],
        "pool": [FaultSpec(site="pool", after=16)],
    }[fault]


MATRIX = [("crash", "paged", "ooo"), ("crash", "dense", "fifo"),
          ("error", "dense", "ooo"), ("error", "paged-int8", "fifo"),
          ("dup", "int8", "ooo"), ("pool", "paged", "ooo"),
          ("pool", "paged-int8", "fifo")]


@pytest.mark.parametrize("fault,storage,schedule", MATRIX)
def test_fault_matrix_token_exact(setup, fault, storage, schedule):
    jc, tc, jp, tp, spec, oracle = setup
    plan = FaultPlan(_specs(fault))
    got, eng = _serve(tp, tc, spec, backend="hetero", schedule=schedule,
                      chaos=plan, **STORAGE[storage], **CHAOS)
    assert plan.count() >= 1, "fault never fired: the matrix is vacuous"
    if "int8" in storage:
        # int8 storage is held to the JAX int8 engine elsewhere: here the
        # healed serve must equal the port's own fault-free one
        want, _ = _serve(tp, tc, spec, backend="hetero", schedule=schedule,
                         **STORAGE[storage])
    else:
        want = oracle
    assert got == want
    if fault == "dup":
        # absorbed by the idempotent scatter, counted, no fault
        assert eng.engine.step_stats["dup_completion_count"] >= 1
        assert eng.faults == 0
    else:
        assert eng.faults >= 1 and eng.recoveries >= 1
        assert eng.metrics()["fault_count"] == eng.faults
    # a crash fails the worker over; the rest retry on the same fleet
    assert len(eng.engine.workers) == (1 if fault == "crash" else 2)


def test_chaos_off_is_inert(setup):
    jc, tc, jp, tp, spec, oracle = setup
    plan = FaultPlan()
    got, eng = _serve(tp, tc, spec, backend="hetero", chaos=plan, **CHAOS)
    assert got == oracle and plan.count() == 0 and eng.faults == 0
    assert eng.spared_workers == 0


def _alloc_state(eng):
    return [(w.wid, mb, a.lengths[a.active].tolist(),
             [a.mapped_pages(r) for r in range(a.rows) if a.active[r]])
            for w in eng.engine.workers
            for mb, a in sorted(w.allocators.items())]


def test_dropped_completion_resyncs_the_orphaned_append(setup):
    """A dropped completion: the R-Part already grew the allocator and
    appended this step's KV; only the message is lost.  The supervisor's
    resync re-prefills every live row through ``write_rows``, which must
    reset each row's table and length (not append after the orphan): in
    lock step with a fault-free engine, the allocators' row lengths and
    mapped pages agree after every step, and the tokens are the
    oracle's.  Also the supervisor's bookkeeping: a CollectTimeout, then
    a recovery, no failover, lifecycle marks."""
    jc, tc, jp, tp, spec, oracle = setup
    # 12 completions a step (3 layers x 2 micro-batches x 2 workers): the
    # drop lands in step 5, with requests resident
    plan = FaultPlan([FaultSpec(site="completion", kind="drop", after=60)])
    kw = dict(batch=4, cache_len=48, backend="hetero", paged_kv=True,
              page_size=4, device="cpu", **CHAOS)
    a = ServingEngine(tp, tc, chaos=plan, observability=True, **kw)
    b = ServingEngine(tp, tc, **kw)
    try:
        order = sorted(range(len(spec)), key=lambda i: spec[i][2])
        qi, faulted = 0, []
        while qi < len(order) or a.queue \
                or any(s is not None for s in a.slots):
            while qi < len(order) and spec[order[qi]][2] <= a.step_idx:
                i = order[qi]
                for e in (a, b):
                    e.submit(Request(rid=i, prompt=spec[i][0],
                                     max_new_tokens=spec[i][1]))
                qi += 1
            a.step()
            b.step()
            faulted.append(a.faults)
            assert _alloc_state(a) == _alloc_state(b), a.step_idx
            assert a.step_idx < 400
        assert plan.count() == 1 and faulted[-1] >= 1
        got = {r.rid: list(r.generated) for r in a.finished}
        assert got == oracle
        m = a.metrics()
        assert m["fault_count"] >= 1 and m["recovered_count"] >= 1
        assert a.obs.mttr.count >= 1
        assert all(ev["mttr_s"] > 0 for ev in a.fault_events
                   if ev["kind"] == "recovered")
        kinds = [ev["kind"] for ev in a.fault_events]
        assert "CollectTimeout" in kinds and "recovered" in kinds
        assert a.fault_events[0]["lost"] and a.fault_events[0]["transient"]
        assert len(a.engine.workers) == 2 and a.spared_workers == 0
        marked = [r for r in a.finished
                  if any(e[0] == "fault" for e in r.events)]
        assert marked and all(
            any(e[0] == "recovered" for e in r.events) for r in marked)
    finally:
        a.close()
        b.close()


def test_spec_verify_fault_heals_token_exact(setup):
    """The ``verify`` site aborts a speculative step after the
    candidates' KV append and before commit: the healer re-prefills every
    live row (dropping the orphaned candidates) and re-runs the verify
    with the same drafts."""
    jc, tc, jp, tp, spec, oracle = setup
    plan = FaultPlan([FaultSpec(site="verify", after=3, times=2)])
    got, eng = _serve(tp, tc, spec, backend="hetero",
                      spec_decode=SpecConfig(k=3), paged_kv=True,
                      page_size=4, chaos=plan, **CHAOS)
    assert plan.count("verify") == 2
    assert got == oracle
    assert eng.faults == 2 and eng.recoveries >= 1


# ---------------------------------------------------------------------------
# host-tier sites: parked pages cross a migration through the tier, and a
# second round restores them; a failed put or get, or a corrupted entry,
# costs a re-prefill, never a wrong token
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def two_rounds(setup):
    jc, tc, jp, tp, spec, oracle = setup
    r = np.random.default_rng(11)
    prompts = [np.asarray(r.integers(1, jc.vocab_size,
                                     (int(r.integers(4, 9)),)), np.int32)
               for _ in range(4)]
    extras = [np.asarray(r.integers(1, jc.vocab_size, (3,)), np.int32)
              for _ in range(4)]

    def rounds(req_cls, hist=None):
        if hist is None:
            return [req_cls(rid=i, prompt=prompts[i], max_new_tokens=5)
                    for i in range(4)]
        return [req_cls(rid=100 + i,
                        prompt=np.concatenate([hist[i], extras[i]]),
                        max_new_tokens=5) for i in range(4)]

    colo = JServingEngine(jp, jc, batch=4, cache_len=64)
    want1 = _run(colo, rounds(JRequest))
    hist = [np.concatenate([prompts[i], np.asarray(want1[i], np.int32)])
            for i in range(4)]
    want2 = _run(colo, rounds(JRequest, hist))
    return rounds, hist, want1, want2


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return {r.rid: list(map(int, r.generated))
            for r in eng.run(max_steps=200)}


@pytest.mark.parametrize("site,times", [("tier_put", 2), ("tier_get", 1),
                                        ("tier_corrupt", 1)])
def test_tier_sites_token_exact(setup, two_rounds, site, times):
    jc, tc, jp, tp, spec, oracle = setup
    rounds, hist, want1, want2 = two_rounds
    plan = FaultPlan([FaultSpec(site=site, times=times)])
    eng = ServingEngine(tp, tc, batch=4, cache_len=64, device="cpu",
                        backend="hetero", paged_kv=True, page_size=4,
                        kv_tiering=True, chaos=plan, **CHAOS)
    try:
        assert _run(eng, rounds(Request)) == want1
        # the migration flushes every parked page to the tier
        eng.engine.apply_partition([(0, 2), (2, 2)])
        assert _run(eng, rounds(Request, hist)) == want2
        stats = eng.tiering_stats()
    finally:
        eng.close()
    assert plan.count(site) == times
    failed = {"tier_put": "put_failed_count", "tier_get": "get_failed_count",
              "tier_corrupt": "corrupt_count"}[site]
    assert stats[failed] == times and stats["restore_count"] > 0


PAGE, MAXP = 4, 5


def _conserved(a):
    free, cached, parked = set(a.free), set(a.prefix.lru), set(a.parked)
    assert len(free) + len(cached) + len(parked) + a.used_pages() \
        == a.num_pages
    return free, cached, parked


def test_tier_put_failure_conserves_pages():
    """A tier write failure mid-eviction reclaims the page anyway: it must
    not vanish from both the device pool and the tier."""
    plan = FaultPlan([FaultSpec(site="tier_put")])
    tier = PC.HostTier(chaos=plan)
    a = PC.PagedAllocator(2, 8, PAGE, MAXP, tier=tier, device="cpu")
    a.pool_reader = lambda: {0: {"k": torch.zeros((9, PAGE))}}
    a.admit(0, 16)
    a.admit(1, 16)                       # pool exactly full
    assert a.park_row(1, np.arange(16, dtype=np.int32))
    got = a._take_page()                 # evicts parked; tier.put fails
    assert tier.stats["put_failed"] == 1
    assert tier.swapped_pages() == 0
    free, cached, parked = _conserved(a)
    assert got not in free | cached | parked


def test_tier_restore_failure_keeps_pool_consistent():
    """A tier read failure mid-restore frees the staging page and keeps the
    entry; a corrupted payload is caught by its checksum.  Neither
    crashes the probe."""
    base = np.arange(16, dtype=np.int32)
    for fault, stat in [("tier_get", "get_failed"),
                        ("tier_corrupt", "corrupt")]:
        tier = PC.HostTier()
        a = PC.PagedAllocator(2, 8, PAGE, MAXP, tier=tier, device="cpu")
        a.pool_reader = lambda: {0: {"k": torch.zeros((9, PAGE))}}
        if fault == "tier_corrupt":      # corrupt on the way IN
            tier.chaos = FaultPlan([FaultSpec(site="tier_corrupt")])
        a.admit(0, 16)
        assert a.park_row(0, base)
        assert a.swap_out_all_parked() == 4
        if fault == "tier_get":          # fail on the way OUT
            tier.chaos = FaultPlan([FaultSpec(site="tier_get")])
        b = PC.PagedAllocator(2, 8, PAGE, MAXP, tier=tier, device="cpu")
        b.probe_prefix(base, restore=True)                  # no raise
        assert tier.stats[stat] >= 1, fault
        _conserved(b)


# ---------------------------------------------------------------------------
# fleet integration: migration-wire and snapshot corruption
# ---------------------------------------------------------------------------
def test_migration_wire_corruption_detected_and_replayed(setup):
    """``wire_corrupt`` (``where="migration"``): the repartition drops the
    payload that fails its checksum, installs zeros, and the manager
    replays those rows from token history: tokens stay the oracle's and
    the corruption is attributed in telemetry."""
    jc, tc, jp, tp, spec, oracle = setup
    plan = FaultPlan([FaultSpec(site="wire_corrupt", where="migration")])
    fleet = FleetManager([WorkerProfile(name="a"), WorkerProfile(name="b")])

    done = []

    def migrate(eng):
        # the first payload exported (worker 0, layer key 0) is the one
        # corrupted: move once its row 0 holds a request
        if not done and eng.slots[0] is not None:
            fleet.rebalance_now([(0, 2), (2, 2)])
            done.append(eng.step_idx)

    got, eng = _serve(tp, tc, spec, on_step=migrate, backend="hetero",
                      fleet=fleet, chaos=plan, **CHAOS)
    assert done and got == oracle and plan.count("wire_corrupt") == 1
    events = fleet.telemetry.events_of("corruption")
    assert events and events[0].detail["source"] == "migration-wire"
    assert events[0].detail["replayed"] >= 1
    assert len(eng.engine.workers) == 1


def test_snapshot_corruption_degrades_to_exact_reprefill(setup):
    """A corrupted KV snapshot fails its checksum at restore; the manager
    refuses it and re-prefills from token history instead, the corruption
    recorded in telemetry."""
    jc, tc, jp, tp, spec, oracle = setup
    plan = FaultPlan([FaultSpec(site="wire_corrupt", where="snapshot",
                                times=-1),
                      FaultSpec(site="r_step", kind="crash", wid=0,
                                after=40)])
    fleet = FleetManager([WorkerProfile(name="a"), WorkerProfile(name="b")],
                         snapshot_interval=2, recovery="snapshot")
    got, eng = _serve(tp, tc, spec, backend="hetero", fleet=fleet,
                      chaos=plan, **CHAOS)
    assert got == oracle
    assert plan.count("wire_corrupt") >= 1 and plan.count("r_step") == 1
    events = fleet.telemetry.events_of("corruption")
    assert events and events[0].detail["source"] == "snapshot"
    rec = fleet.telemetry.events_of("recovery")
    assert rec and rec[-1].detail["mode"] == "reprefill"
    assert eng.metrics()["fleet_recoveries_count"] == 1


# ---------------------------------------------------------------------------
# the supervisor's limits
# ---------------------------------------------------------------------------
def test_unhealable_fault_reraises_with_rids(setup):
    """With the retry budget at zero the StepFault surfaces, its message
    naming the affected request ids."""
    jc, tc, jp, tp, spec, oracle = setup
    plan = FaultPlan([FaultSpec(site="r_step", kind="crash", wid=0,
                                after=40)])
    eng = ServingEngine(tp, tc, batch=4, cache_len=48, backend="hetero",
                        chaos=plan, max_step_retries=0, device="cpu",
                        **CHAOS)
    try:
        for i, (p, n, _) in enumerate(spec):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=n))
        with pytest.raises(StepFault,
                           match=r"in-flight rids: \[\d") as ei:
            eng.run(max_steps=400)
        assert ei.value.dead_wids == (0,)
        assert eng.faults >= 1 and eng.recoveries == 0
    finally:
        eng.close()


def test_close_warns_on_hung_worker(setup):
    """close() does not leak a hung thread silently: it warns with the
    stuck worker ids.  The hung worker, removed from the fleet meanwhile,
    keeps its graphs until its thread has exited (it wakes, finds itself
    killed, and returns without replaying); then they are freed."""
    jc, tc, jp, tp, spec, oracle = setup
    # 3 layers x 2 micro-batches: the first step's items pass, the second
    # step's first item hangs
    plan = FaultPlan([FaultSpec(site="r_step", kind="hang", wid=0,
                                after=6, hang_s=3.0)])
    eng = ServingEngine(tp, tc, batch=4, cache_len=48, backend="hetero",
                        chaos=plan, max_step_retries=0, device="cpu",
                        **CHAOS)
    for i, (p, n, _) in enumerate(spec[:4]):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=n))
    eng.step()
    w0 = eng.engine.workers[0]
    assert w0._graphs
    with pytest.raises(CollectTimeout, match="timed out") as ei:
        eng.step()
    assert ei.value.hung_wids == (0,)
    eng._quiesce_workers(skip=(0,))
    eng.engine.remove_worker(0)
    eng.engine._reap_retired()
    assert w0.is_alive() and w0._graphs      # still asleep: kept
    with pytest.warns(RuntimeWarning, match=r"\[0\] did not exit"):
        eng.close()
    w0.join(timeout=10)
    assert not w0.is_alive()
    eng.engine._reap_retired()
    assert not w0._graphs and not eng.engine._retired


def test_every_fault_site_is_registered_as_in_repro():
    from repro.chaos import FAULT_SITES as J_SITES
    assert FAULT_SITES == J_SITES
