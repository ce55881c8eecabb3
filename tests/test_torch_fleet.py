"""The port's fleet management against the JAX package (the port's twins
of tests/test_fleet.py):

* planning: ``apportion_rows``, the planner (which defaults to
  ``perfmodel.GPU_H100`` where ``repro`` falls back to its TPU profile),
  the EWMA rebalancer and ``weight_fraction`` give ``repro``'s answers;
* the migration wire format: ``RWorker.export_rows`` gives ``repro``'s
  payload (keys, shapes, dtypes, positions and int8 codes exactly, fp32
  values within rounding) after the same serve prefix on paged fp32,
  paged int8, dense and dense int8 storage, and bit for bit when both
  hold the same state;
* live migration to an uneven split and back leaves every payload bit
  for bit as it was and the tokens the colocated JAX oracle's; snapshot
  and re-prefill recovery after a ``kill()``, the planner's uneven split
  and the rebalancer moving rows off a straggler are token-exact too;
* a changed worker releases its graphs and re-captures them (counted);
  an unchanged one keeps them.
fp32 on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_spec, serve_trace, tiny_cfg
from repro.core import hetero as JH
from repro.core import perfmodel as JP
from repro.fleet import PartitionPlanner as JPlanner
from repro.fleet import Rebalancer as JRebalancer
from repro.fleet import apportion_rows as japportion
from repro.fleet import skewed_fleet as jskewed
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.request import Request as JRequest
from repro_torch import bridge
from repro_torch.core import perfmodel as P
from repro_torch.core.config import ModelConfig
from repro_torch.core.hetero import HeteroPipelineEngine, RWorker
from repro_torch.fleet import (FleetManager, PartitionPlanner, Rebalancer,
                               WorkerProfile, apportion_rows, skewed_fleet,
                               uniform_fleet)
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request

STORAGE = {"paged": dict(paged_kv=True, page_size=4),
           "paged-int8": dict(paged_kv=True, page_size=4, quantized_kv=True),
           "dense": {}, "int8": dict(quantized_kv=True)}


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
    spec = random_spec(np.random.default_rng(11), jc, 8, spread=4)
    return jc, tc, jp, tp, spec, serve_trace(jp, jc, spec, batch=8,
                                             backend="colocated")


def _serve(tp, tc, spec, on_step=None, **kw):
    """conftest.serve_trace's loop for the port at batch 8; ``on_step(eng)``
    runs before every step.  Returns ({rid: tokens}, the closed engine)."""
    eng = ServingEngine(tp, tc, batch=kw.pop("batch", 8),
                        cache_len=kw.pop("cache_len", 48), device="cpu",
                        backend="hetero", **kw)
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
# planning against repro's
# ---------------------------------------------------------------------------
APPORTION = [(12, [2, 1], 0), (7, [1, 1, 1], 0), (5, [5, 1, 3], 1),
             (16, [0.5, 0.25, 0.25], 1), (9, [0.0, 3.0, 1.0], 2),
             (4, [1e-3, 1.0], 1), (30, [7, 5, 3, 1], 3)]


@pytest.mark.parametrize("case", range(len(APPORTION)))
def test_apportion_rows_matches_repro(case):
    total, w, min_rows = APPORTION[case]
    got = apportion_rows(total, w, min_rows=min_rows)
    assert got == japportion(total, w, min_rows=min_rows)
    assert got[0][0] == 0 and got[-1][1] == total
    assert all(b == c for (_, b), (c, _) in zip(got, got[1:]))


@pytest.mark.parametrize("args", [(4, []), (4, [0.0, 0.0]),
                                  (4, [1.0, -1.0]), (2, [1, 1, 1], 1)])
def test_apportion_rejects_what_repro_rejects(args):
    with pytest.raises(ValueError):
        japportion(*args)
    with pytest.raises(ValueError):
        apportion_rows(*args)


def test_planner_matches_repro_and_defaults_to_h100(setup):
    jc, tc, *_ = setup
    assert PartitionPlanner(skewed_fleet((2.0, 1.0))).hw_r is P.GPU_H100
    assert WorkerProfile(name="x").scaled_hw().mem_bw == P.GPU_H100.mem_bw
    h100 = JP.Hardware(**dataclasses.asdict(P.GPU_H100))
    for scales, rows, page in [((2.0, 1.0), 12, 0), ((4.0, 1.0, 2.0), 2, 0),
                               ((1.0, 3.0, 0.5), 16, 16)]:
        mine = PartitionPlanner(skewed_fleet(scales), cfg=tc, page=page)
        ref = JPlanner(jskewed(scales), cfg=jc, hw_r=h100, page=page)
        assert mine.weights() == pytest.approx(ref.weights(), rel=1e-12)
        assert mine.plan(rows) == ref.plan(rows)
        # without a config: the raw bandwidth scales
        assert PartitionPlanner(skewed_fleet(scales)).plan(rows) \
            == JPlanner(jskewed(scales)).plan(rows)
    (lo0, hi0), (lo1, hi1) = PartitionPlanner(
        skewed_fleet((2.0, 1.0)), cfg=tc).plan(12)
    assert hi0 - lo0 == 2 * (hi1 - lo1)


def test_rebalancer_matches_repro():
    rng = np.random.default_rng(3)
    for kw, base in [(dict(skew_threshold=0.2, patience=2, cooldown=2),
                      [3.0, 1.0]),
                     (dict(ewma_alpha=0.3, patience=1, cooldown=0),
                      [1.0, 1.02, 2.5]),
                     (dict(skew_threshold=0.25, patience=1, cooldown=0),
                      [1.0, 1.02])]:
        mine, ref = Rebalancer(**kw), JRebalancer(**kw)
        n = len(base)
        slices = apportion_rows(8, [1.0] * n, min_rows=1)
        busy = np.zeros(n)
        for t in range(12):
            busy = busy + np.asarray(base) * (1 + 0.05 * rng.random(n))
            assert mine.observe(busy) == pytest.approx(ref.observe(busy))
            got, want = mine.propose(slices, 8), ref.propose(slices, 8)
            assert got == want, (kw, t)
            if got is not None:
                slices = got
                mine.reset()
                ref.reset()


def test_weight_fraction_ignores_profiles_dropped_at_spawn(setup):
    """Profiles the planner dropped (more workers than rows) never
    contributed throughput and stay out of the re-costing fraction."""
    jc, tc, jp, tp, spec, oracle = setup
    fleet = FleetManager(skewed_fleet((4.0, 1.0, 2.0)))
    # batch 4 / 2 micro-batches = 2 rows: the weight-1 profile gets none
    eng = HeteroPipelineEngine(tp, tc, batch=4, cache_len=16,
                               num_microbatches=2, fleet=fleet,
                               device="cpu")
    try:
        assert len(eng.workers) == 2
        assert fleet.weight_fraction() == pytest.approx(1.0)
        eng.workers[1].kill()               # the weight-2 worker
        eng.workers[1].join(timeout=10)
        fleet.pre_step()
        ref = JPlanner(jskewed((4.0, 1.0, 2.0)))
        w = ref.weights()
        assert fleet.weight_fraction() == pytest.approx(
            w[0] / (w[0] + w[2])) == pytest.approx(4.0 / 6.0)
        assert len(eng.workers) == 1
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# the migration wire format against repro's
# ---------------------------------------------------------------------------
def _prefix(cls, req_cls, params, cfg, spec, steps, **kw):
    eng = cls(params, cfg, batch=4, cache_len=48, backend="hetero", **kw)
    for i, (p, n, _) in enumerate(spec):
        eng.submit(req_cls(rid=i, prompt=p, max_new_tokens=n))
    for _ in range(steps):
        eng.step()
    return eng


@pytest.mark.parametrize("storage", sorted(STORAGE))
def test_export_rows_matches_repro_after_a_serve_prefix(setup, storage):
    jc, tc, jp, tp, spec, oracle = setup
    je = _prefix(JServingEngine, JRequest, jp, jc, spec[:6], 3,
                 **STORAGE[storage])
    te = _prefix(ServingEngine, Request, tp, tc, spec[:6], 3, device="cpu",
                 **STORAGE[storage])
    try:
        pairs = list(zip(je.engine.workers, te.engine.workers))
        assert [(a.lo, a.hi) for a, _ in pairs] \
            == [(b.lo, b.hi) for _, b in pairs]
        n = 0
        for wj, wt in pairs:
            assert sorted(wj.state) == sorted(wt.state)
            for lk in sorted(wj.state):
                want = wj.export_rows(lk, np.arange(wj.hi - wj.lo))
                got = wt.export_rows(lk, np.arange(wt.hi - wt.lo))
                assert sorted(got) == sorted(want)
                for k, w in want.items():
                    w, g = np.asarray(w), got[k]
                    assert g.shape == w.shape and g.dtype == w.dtype, k
                    if w.dtype == np.float32:
                        np.testing.assert_allclose(g, w, rtol=0,
                                                   atol=1e-5)
                    else:       # positions and int8 codes
                        np.testing.assert_array_equal(g, w)
                    n += 1
        assert n
    finally:
        je.close()
        te.close()


@pytest.mark.parametrize("storage", sorted(STORAGE))
def test_export_rows_bitwise_on_the_same_state(setup, storage):
    """Both packages' workers hold the same rows (ragged lengths, one
    empty, one released on paged storage): the payloads are equal bit for
    bit."""
    jc, tc, *_ = setup
    kw = dict(quantized=storage.endswith("int8"),
              paged=storage.startswith("paged"), page_size=4,
              max_pages_per_seq=12)
    jw = JH.RWorker(0, jc, 0, 3, **kw)
    tw = RWorker(0, tc, 0, 3, device="cpu", **kw)
    rng = np.random.default_rng(4)
    cap, hkv, dh = 48, jc.num_kv_heads, jc.head_dim
    lens = [13, 0, 29]
    k = rng.standard_normal((3, cap, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((3, cap, hkv, dh)).astype(np.float32)
    pos = np.full((3, cap), -1, np.int32)
    for i, n in enumerate(lens):
        pos[i, :n] = np.arange(n)
    k[pos < 0] = 0.0
    v[pos < 0] = 0.0
    st = {"k": k, "v": v, "pos": pos}
    jw.load_state(5, {a: jnp.asarray(b) for a, b in st.items()})
    tw.load_state(5, {a: torch.from_numpy(b.copy()) for a, b in st.items()})
    if kw["paged"]:
        jw.release_rows(0, [2])
        tw.release_rows(0, [2])
    want = jw.export_rows(5, np.arange(3))
    got = tw.export_rows(5, np.arange(3))
    assert sorted(got) == sorted(want)
    for a in want:
        w = np.asarray(want[a])
        assert got[a].dtype == w.dtype and got[a].tobytes() == w.tobytes()


def _wire(eng):
    """{layer key: full micro-batch payload} over the engine's workers."""
    out = {}
    for lk in sorted({k for w in eng.engine.workers for k in w.state}):
        parts = [w.export_rows(lk, np.arange(w.hi - w.lo))
                 for w in eng.engine.workers]
        out[lk] = {k: np.concatenate([p[k] for p in parts])
                   for k in parts[0]}
    return out


@pytest.mark.parametrize("storage", sorted(STORAGE))
def test_migration_round_trip_is_bitwise_and_token_exact(setup, storage):
    """Mid-serve, apply_partition to an uneven split and back: every
    payload is bit for bit what it was before the moves, and the serve
    finishes with the colocated oracle's tokens (int8 storage: with the
    port's unmigrated int8 serve, itself held to the JAX int8 engine
    elsewhere)."""
    jc, tc, jp, tp, spec, oracle = setup
    moved = []

    def migrate(eng):
        if eng.step_idx == 5:
            before = _wire(eng)
            moved.append(eng.engine.apply_partition([(0, 3), (3, 4)]))
            assert eng.engine.slices == [(0, 3), (3, 4)]
            moved.append(eng.engine.apply_partition([(0, 2), (2, 4)]))
            after = _wire(eng)
            assert sorted(after) == sorted(before)
            for lk in before:
                for k, v in before[lk].items():
                    assert after[lk][k].tobytes() == v.tobytes(), (lk, k)

    got, eng = _serve(tp, tc, spec, on_step=migrate, **STORAGE[storage])
    assert moved == [2, 2]                  # 1 row x 2 micro-batches, twice
    if storage.endswith("int8"):
        want, _ = _serve(tp, tc, spec, **STORAGE[storage])
    else:
        want = oracle
    assert got == want
    assert eng.engine.topology_changes == 2
    assert eng.hotpath_stats()["recapture_count"] > 0


@pytest.mark.parametrize("mode", ["reprefill", "snapshot"])
def test_recovery_after_kill_is_token_exact(setup, mode):
    """Kill an R-worker between steps: the next step's health check fails
    it over and restores its rows by re-prefill or from the (current) KV
    snapshot; every request finishes with the colocated oracle's tokens."""
    jc, tc, jp, tp, spec, oracle = setup
    fleet = FleetManager(uniform_fleet(2), recovery=mode,
                         snapshot_interval=1 if mode == "snapshot" else 0)

    def kill(eng):
        if eng.step_idx == 6:
            w = eng.engine.workers[1]
            w.kill()
            w.join(timeout=10)

    got, eng = _serve(tp, tc, spec, on_step=kill, paged_kv=True,
                      page_size=4, fleet=fleet)
    assert got == oracle
    assert fleet.telemetry.summary()["recoveries"] == 1
    rec = fleet.telemetry.events_of("recovery")[0].detail
    assert rec["mode"] == mode and rec["rows"] == 4
    assert (rec["replayed"] > 0) == (mode == "reprefill")
    assert len(eng.engine.workers) == 1
    m = eng.metrics()
    assert m["fleet_failures_count"] == 1 and m["fault_count"] == 0


def test_planned_split_and_rebalancer_are_token_exact(setup):
    """The planner's 3:1 split of a (3.0, 1.0) fleet, then a straggler
    (sim_row_cost on the fast worker) that the EWMA rebalancer must move
    rows off, through live migrations: the colocated oracle's tokens."""
    jc, tc, jp, tp, spec, oracle = setup
    profs = [WorkerProfile(name="a", mem_bw_scale=3.0, sim_row_cost=0.004),
             WorkerProfile(name="b")]
    fleet = FleetManager(profs, cfg=tc, rebalancer=Rebalancer(
        skew_threshold=0.2, patience=2, cooldown=2))
    seen = []
    got, eng = _serve(tp, tc, spec, fleet=fleet, paged_kv=True, page_size=4,
                      on_step=lambda e: seen.append(tuple(e.engine.slices)))
    assert seen[0] == ((0, 3), (3, 4))           # the planner's split
    assert got == oracle
    assert fleet.telemetry.summary()["migrations"] >= 1
    lo, hi = eng.engine.slices[0]                # the straggler's slice
    assert hi - lo < 3, eng.engine.slices
    assert eng.metrics()["fleet_migrations_count"] >= 1


def test_pre_step_raises_when_last_worker_dies(setup):
    jc, tc, jp, tp, spec, oracle = setup
    fleet = FleetManager(uniform_fleet(1))
    eng = HeteroPipelineEngine(tp, tc, batch=4, cache_len=16,
                               num_microbatches=2, fleet=fleet,
                               device="cpu")
    try:
        eng.workers[0].kill()
        eng.workers[0].join(timeout=10)
        with pytest.raises(RuntimeError, match="no live R-workers"):
            fleet.pre_step()
    finally:
        eng.close()


def test_recost_admission_shrinks_w_lim_after_failure(setup):
    jc, tc, jp, tp, spec, oracle = setup
    fleet = FleetManager(uniform_fleet(2), recovery="reprefill")
    eng = ServingEngine(tp, tc, batch=4, cache_len=48, backend="hetero",
                        num_microbatches=2, admission="loadctl",
                        target_len=6, interval=2, fleet=fleet,
                        device="cpu")
    try:
        w0 = eng.load_ctl.w_lim
        eng.submit(Request(rid=0, prompt=np.ones((4,), np.int32),
                           max_new_tokens=4))
        eng.step()
        eng.engine.workers[0].kill()
        eng.engine.workers[0].join(timeout=10)
        eng.step()
        assert eng.load_ctl.w_lim == pytest.approx(0.5 * w0)
    finally:
        eng.close()


def test_changed_workers_recapture_unchanged_keep_their_graphs(setup):
    """A changed worker releases its graphs with its rows and re-captures
    them on its next step (counted with their seconds); a worker whose
    slice is unchanged keeps its graphs and captures nothing."""
    jc, tc, jp, tp, spec, oracle = setup
    eng = ServingEngine(tp, tc, batch=8, cache_len=48, backend="hetero",
                        num_r_workers=3, paged_kv=True, page_size=4,
                        device="cpu")
    try:
        for i, (p, n, _) in enumerate(spec[:4]):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=n))
        eng.step()
        w0, w1, w2 = eng.engine.workers
        assert eng.engine.slices == [(0, 1), (1, 2), (2, 4)]
        g0 = dict(w0._graphs)
        assert g0 and w1._graphs and w2._graphs
        eng.engine.apply_partition([(0, 1), (1, 3), (3, 4)])
        assert w0._graphs == g0 and not w1._graphs and not w2._graphs
        eng.step()
        assert w0.recapture_count == 0
        assert w1.recapture_count == len(w1._graphs) > 0
        assert w2.recapture_count == len(w2._graphs) > 0
        st = eng.hotpath_stats()
        assert st["recapture_count"] == w1.recapture_count \
            + w2.recapture_count and st["recapture_s"] > 0
    finally:
        eng.close()
    assert not w0._graphs and not w1._graphs      # freed at close


def test_profile_knobs_skew_the_fleet_token_exact(setup):
    """The profiles' simulated skew: ``sim_slowdown`` stretches a worker's
    items (its busy time grows with it) and ``sim_deliver_jitter`` posts
    its completions late from a timer while it moves on (completion order
    departs from issue order); the serve stays the oracle's."""
    jc, tc, jp, tp, spec, oracle = setup
    fleet = FleetManager([WorkerProfile(name="slow", sim_slowdown=3.0),
                          WorkerProfile(name="late",
                                        sim_deliver_jitter=0.01)])
    got, eng = _serve(tp, tc, spec, fleet=fleet, paged_kv=True, page_size=4,
                      suspect_after_s=2.0, collect_timeout_s=60.0)
    assert got == oracle
    slow, late = eng.engine.workers
    assert (slow.slowdown, slow.sim_deliver_jitter) == (3.0, 0.0)
    assert (late.slowdown, late.sim_deliver_jitter) == (1.0, 0.01)
    assert slow.profile.name == "slow" and late.profile.name == "late"
    assert slow.busy_time > late.busy_time
    assert eng.faults == 0 and eng.spared_workers == 0
