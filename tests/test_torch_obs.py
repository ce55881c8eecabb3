"""The port's observability (repro_torch.obs: metrics registry, schema,
timeline, span tracer, drift monitor; the engine's hooks and surfaces)
against repro.obs and the JAX engine on the same inputs:

- the registry, histogram percentiles, schema, timeline derivations and
  span export equal repro's on the same observations;
- one reduced hetero serve with observability on gives the same
  ``metrics()`` key set and the same counts as the JAX engine's, with or
  without the prefix cache, preemption and speculative decoding, and the
  same ``request_timeline`` event names and steps;
- the drift twins: a straggler made with ``sim_row_cost`` after
  calibration is flagged, a healthy fleet stays quiet;
- observability on and off give identical tokens and logits."""
import dataclasses
import json
import threading

import jax
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro import obs as JO
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.request import Request as JRequest
from repro_torch import bridge
from repro_torch import obs as TO
from repro_torch.core.config import ModelConfig
from repro_torch.serving.engine import ServingEngine, SpecConfig
from repro_torch.serving.request import Request


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jc = tiny_cfg("granite-3-8b")
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


# --------------------------------------------------------------------------- #
# primitives on the same observations
# --------------------------------------------------------------------------- #

def _observe(mod, vals):
    r = mod.MetricsRegistry()
    c = r.counter("submitted_count")
    g = r.gauge("queue_depth_count")
    h = r.histogram("ttft_s")
    for i, v in enumerate(vals):
        c.inc(1 + i % 3)
        g.set(i % 7)
        h.observe(v)
    with pytest.raises(TypeError):
        r.histogram("submitted_count")
    return r, h


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_and_percentiles_match(seed):
    rng = np.random.default_rng(seed)
    vals = list(np.concatenate([
        rng.lognormal(-4.0, 1.5, 500), [0.0, -1.0, 1e-9, 2e3],
        rng.uniform(0, 1, 100)]).astype(float))
    tr, th = _observe(TO, vals)
    jr, jh = _observe(JO, vals)
    assert tr.snapshot() == jr.snapshot()
    assert th.buckets == jh.buckets
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert th.percentile(q) == jh.percentile(q)
    assert th.mean == jh.mean
    assert TO.MetricsRegistry().snapshot() == {}


def test_registry_thread_safety():
    r = TO.MetricsRegistry()
    c = r.counter("n_count")
    h = r.histogram("v_s")
    n, per = 8, 2000

    def work(seed):
        for i in range(per):
            c.inc()
            h.observe((seed + i) % 10 / 1000.0 + 1e-6)

    ts = [threading.Thread(target=work, args=(k,)) for k in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert c.value == n * per == h.count == sum(h.buckets)


def test_schema_matches():
    keys = ["dispatch_s", "host_tier_bytes", "cached_tokens", "steps",
            "swapped_pages", "steps_count", "token_hit_rate", "hits",
            "tokens_per_s", "last_skew_ratio", "ttft_s_p50", "dispatch",
            "drift_dispatch_s_measured", "ooo_advances", "bytes_out"]
    assert [TO.check_key(k) for k in keys] == [JO.check_key(k) for k in keys]
    assert TO.LEGACY_ALIASES == JO.LEGACY_ALIASES
    d = {k: float(i) for i, k in enumerate(keys)}
    assert dict(TO.normalize(d)) == dict(JO.normalize(d))
    with pytest.raises(AssertionError):
        TO.assert_conforms(d)
    TO.assert_conforms(TO.normalize({"steps": 1.0, "dispatch_s": 0.5}))


def test_timeline_derivations_match():
    ev = [("submitted", 0, 10.0, None), ("admitted", 1, 10.5, None),
          ("first_token", 2, 11.0, None), ("token", 3, 11.2, None),
          ("token", 4, 11.4, None), ("preempted", 5, 11.5, None),
          ("submitted", 5, 11.5, None), ("admitted", 8, 13.0, None),
          ("first_token", 9, 13.1, None), ("token", 10, 13.3, None),
          ("finished", 10, 13.3, None)]
    for evs in (ev, ev[:3], [], [("submitted", 0, 1.0, None)]):
        assert TO.timeline.summarize(evs) == JO.timeline.summarize(evs)
        assert TO.timeline.inter_token_s(evs) == \
            JO.timeline.inter_token_s(evs)
        for name in TO.timeline.EVENTS:
            assert TO.timeline.first_t(evs, name) == \
                JO.timeline.first_t(evs, name)
            assert TO.timeline.last_t(evs, name) == \
                JO.timeline.last_t(evs, name)
    assert TO.timeline.EVENTS == JO.timeline.EVENTS
    # the request's own timeline records
    r = Request(rid=0, prompt=np.arange(3, dtype=np.int32),
                max_new_tokens=2)
    assert r.mark("submitted", 0, 1.5) == 1.5
    r.mark("preempted", 2, 2.5)
    r.mark("preempted", 4, 3.5, extra=7)
    assert r.event_t("preempted") == 2.5
    assert r.event_t("preempted", last=True) == 3.5
    assert r.event_t("finished") is None
    assert r.events[-1] == ("preempted", 4, 3.5, 7)


def test_span_tracer_matches(tmp_path):
    def fill(tr):
        for i in range(10):
            tr.add(f"s{i}", "cat", f"trk{i % 3}", tr.t0 + i,
                   tr.t0 + i + 0.5 - (i == 7), {"i": i} if i % 2 else None)
        return tr
    got, want = fill(TO.SpanTracer(ring=4)), fill(JO.SpanTracer(ring=4))
    assert got.added == want.added == 10
    assert got.dropped == want.dropped == 6
    assert got.spans() == want.spans()
    assert got.to_chrome() == want.to_chrome()
    with open(got.export(str(tmp_path / "t.json"))) as f:
        assert json.load(f) == json.loads(json.dumps(want.to_chrome()))


# --------------------------------------------------------------------------- #
# the engine: the port's serve against the JAX engine's
# --------------------------------------------------------------------------- #

def _prompts(cfg, n, seed=0, lo=3, hi=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def _serve(port, model, prompts, *, max_new=4, arrive=None, preempt=None,
           logits=None, **kw):
    """Serve ``prompts`` on the port's engine (``port``) or the JAX one;
    ``arrive`` {rid: step}, ``preempt`` {step: rid} preempts before a
    step; ``logits`` (a list, port only) receives each step's logits.
    Returns (engine metrics, {rid: timeline (event, step)}, {rid:
    tokens})."""
    jc, tc, jp, tp = model
    if port:
        eng = ServingEngine(tp, tc, device="cpu", **kw)
        R = Request
    else:
        eng = JServingEngine(jp, jc, **kw)
        R = JRequest
    arrive = arrive or {}
    pending = sorted(range(len(prompts)), key=lambda i: arrive.get(i, 0))
    try:
        while pending or eng.queue or any(s is not None for s in eng.slots):
            while pending and arrive.get(pending[0], 0) <= eng.step_idx:
                i = pending.pop(0)
                eng.submit(R(rid=i, prompt=prompts[i].copy(),
                             max_new_tokens=max_new))
            if preempt and eng.step_idx in preempt:
                assert eng.preempt(preempt[eng.step_idx])
            eng.step()
            if logits is not None and port:
                logits.append(None if eng.last_logits is None
                              else eng.last_logits.clone())
            assert eng.step_idx < 200
        m = eng.metrics()
        tl = {r.rid: [e[:2] for e in eng.request_timeline(r.rid)]
              for r in eng.finished}
        toks = {r.rid: [int(t) for t in r.generated] for r in eng.finished}
        return m, tl, toks
    finally:
        if eng.backend == "hetero":
            eng.close()


# counts fixed by the trace (host-clock values and scheduling-dependent
# counters such as ooo advances are left out)
def _counts(m):
    host = ("hotpath_ooo_advances_count",)
    return {k: v for k, v in m.items()
            if k.endswith(("_count", "_tokens", "_pages"))
            and not k.startswith("drift_") and k not in host}


SERVES = {
    "hetero-dense": dict(batch=4, cache_len=48, backend="hetero",
                         num_microbatches=2, kv_chunk=48),
    "hetero-paged-prefix-preempt": dict(
        batch=2, cache_len=64, backend="hetero", num_microbatches=2,
        kv_chunk=64, num_r_workers=1, paged_kv=True, page_size=8,
        pages_per_worker=64, prefix_cache=True),
    # tiering: the preempted row parks its pages (the "parked" event)
    "hetero-paged-tier-preempt": dict(
        batch=2, cache_len=64, backend="hetero", num_microbatches=2,
        kv_chunk=64, num_r_workers=1, paged_kv=True, page_size=8,
        pages_per_worker=64, kv_tiering=True),
    "hetero-paged-spec": dict(batch=4, cache_len=48, backend="hetero",
                              paged_kv=True, page_size=4,
                              spec_decode="k2"),
    "hetero-paged-chunked-sls": dict(
        batch=4, cache_len=48, backend="hetero", paged_kv=True,
        page_size=4, prefill_chunk=3, admission="sls", target_len=8,
        interval=2),
    "colocated": dict(batch=2, cache_len=32),
}


def _trace(name, cfg):
    """(prompts, serve kw) of a named serve."""
    if name.endswith("-preempt"):
        # rid 0 prefills and registers the prefix; rid 1 then admits as a
        # prefix hit, is preempted mid-decode and resumes
        shared = _prompts(cfg, 1, seed=3, lo=12, hi=13)[0]
        return [shared, shared], dict(arrive={1: 4}, preempt={7: 1},
                                      max_new=8)
    return _prompts(cfg, 6), {}


@pytest.mark.parametrize("name", sorted(SERVES))
def test_metrics_and_timelines_match_jax_engine(model, name):
    jc = model[0]
    kw = dict(SERVES[name])
    prompts, run_kw = _trace(name, jc)
    tkw, jkw = dict(kw), dict(kw)
    if kw.get("spec_decode") == "k2":
        from repro.serving.engine import SpecConfig as JSpecConfig
        tkw["spec_decode"], jkw["spec_decode"] = SpecConfig(k=2), \
            JSpecConfig(k=2)
    mt, tlt, tt = _serve(True, model, prompts, observability=True,
                         **run_kw, **tkw)
    mj, tlj, tj = _serve(False, model, prompts, observability=True,
                         **run_kw, **jkw)
    TO.assert_conforms(mt)
    assert tt == tj
    # the port's tier also reports the seconds its real page copies took
    port_only = {"tier_swap_out_copy_s", "tier_restore_copy_s"} \
        if "tier" in name else set()
    assert port_only <= set(mt)
    assert set(mt) - port_only == set(mj)
    assert _counts(mt) == _counts(mj)
    assert tlt == tlj
    n = len(prompts)
    assert mt["submitted_count"] == n and mt["finished_count"] == n
    # a resumed request samples a first token again
    assert mt["ttft_s_count"] == n + mt["preempted_count"]
    assert mt["e2e_s_count"] == n
    assert mt["generated_tokens"] == sum(len(v) for v in tt.values())
    if "preempt" in name:
        assert mt["preempted_count"] == 1 and mt["prefix_hit_count"] >= 1
        assert [e for e, _ in tlt[1]].count("admitted") == 2
    if "tier" in name:
        assert "parked" in [e for e, _ in tlt[1]]
    if "spec" in name:
        assert 0 < mt["spec_accepted_tokens"] <= mt["spec_drafted_tokens"]
    for events in tlt.values():
        kinds = [e for e, _ in events]
        assert kinds[0] == "submitted" and kinds[-1] == "finished"


@pytest.mark.parametrize("name", ["hetero-dense", "hetero-paged-spec"])
def test_observability_on_equals_off(model, name):
    jc = model[0]
    kw = dict(SERVES[name])
    if kw.get("spec_decode") == "k2":
        kw["spec_decode"] = SpecConfig(k=2)
    prompts, run_kw = _trace(name, jc)
    lg_on, lg_off = [], []
    m_on, _, on = _serve(True, model, prompts, observability=True,
                         logits=lg_on, **run_kw, **kw)
    m_off, tl_off, off = _serve(True, model, prompts, logits=lg_off,
                                **run_kw, **kw)
    assert on == off
    assert len(lg_on) == len(lg_off)
    for a, b in zip(lg_on, lg_off):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    assert "ttft_s_p50" in m_on and "ttft_s_p50" not in m_off
    assert all(events == [] for events in tl_off.values())


def test_trace_export_nests_and_toggles(model, tmp_path):
    jc, tc, _, tp = model
    eng = ServingEngine(tp, tc, batch=4, cache_len=48, backend="hetero",
                        num_microbatches=2, kv_chunk=48, device="cpu",
                        observability=True)
    try:
        for i, p in enumerate(_prompts(jc, 6)):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=4))
        eng.run(max_steps=100)
        doc = json.load(open(eng.export_trace(str(tmp_path / "t.json"))))
        xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        steps = {e["args"]["step"]: e for e in xs if e["cat"] == "step"}
        rtts = [e for e in xs if e["cat"] == "r-rtt"]
        assert steps and rtts and any(e["cat"] == "r-worker" for e in xs)
        # every R-Part round trip nests inside its step's span, and each
        # (step, micro-batch) chain of layers advances in order
        by_mb = {}
        for e in rtts:
            s = steps[e["args"]["step"]]
            assert s["ts"] - 1e-3 <= e["ts"]
            assert e["ts"] + e["dur"] <= s["ts"] + s["dur"] + 1e-3
            by_mb.setdefault((e["args"]["step"], e["args"]["mb"]),
                             []).append(e)
        for chain in by_mb.values():
            chain.sort(key=lambda e: e["ts"])
            lp = [(e["args"]["layer"], e["args"]["phase"]) for e in chain]
            assert lp == sorted(lp)
        # one r-rtt span per (step, micro-batch, layer), a step span per
        # step and a busy window per worker and dispatch
        n_steps = eng.step_idx
        assert len(steps) == n_steps
        assert len(rtts) == n_steps * 2 * tc.num_layers
        assert eng.metrics()["trace_spans_count"] == len(xs) == \
            n_steps * (1 + 2 * tc.num_layers * (1 + 2))
        # toggled off: the tracer is detached, nothing more is recorded
        eng.set_observability(False)
        eng.submit(Request(rid=9, prompt=_prompts(jc, 1)[0],
                           max_new_tokens=2))
        eng.run(max_steps=10)
        assert eng._obs_obj.tracer.added == len(xs)
        assert eng.engine.tracer is None
        assert all(w.tracer is None for w in eng.engine.workers)
        assert eng.request_timeline(9) == []
    finally:
        eng.close()


def test_observability_off_surfaces(model):
    jc, tc, _, tp = model
    eng = ServingEngine(tp, tc, batch=2, cache_len=32, device="cpu")
    for i, p in enumerate(_prompts(jc, 2)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=3))
    eng.run(max_steps=50)
    m = eng.metrics()
    TO.assert_conforms(m)
    assert "ttft_s_p50" not in m and m["steps_count"] > 0
    assert eng.request_timeline(0) == []
    with pytest.raises(KeyError):
        eng.request_timeline(99)
    with pytest.raises(RuntimeError):
        eng.set_observability(True)
    with pytest.raises(RuntimeError):
        eng.export_trace("unused.json")
    with pytest.raises(RuntimeError):
        eng.drift_report()
    # the colocated backend with observability: metrics, no drift monitor
    eng = ServingEngine(tp, tc, batch=2, cache_len=32, device="cpu",
                        observability=TO.ObsConfig(spans=False))
    for i, p in enumerate(_prompts(jc, 2)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=3))
    eng.run(max_steps=50)
    assert eng.metrics()["ttft_s_count"] == 2.0
    with pytest.raises(RuntimeError):
        eng.drift_report()
    with pytest.raises(RuntimeError):
        eng.export_trace("unused.json")
    with pytest.raises(TypeError):
        TO.coerce_obs_config("yes")


# --------------------------------------------------------------------------- #
# the drift monitor (twins of repro's drift tests)
# --------------------------------------------------------------------------- #

def test_drift_monitor_matches_jax_on_the_same_stats():
    """The same cumulative step stats into both monitors give the same
    report."""
    import repro.obs.drift as JD
    jc = tiny_cfg("granite-3-8b")
    tc = ModelConfig(**dataclasses.asdict(jc))
    plan = {"tokens_per_s": 900.0}
    t = TO.DriftMonitor(tc, 2, 2, calibration_steps=3, warmup_steps=1,
                        tolerance=0.5, plan=plan)
    j = JD.DriftMonitor(jc, 2, 2, calibration_steps=3, warmup_steps=1,
                        tolerance=0.5, plan=plan)
    stats = {}
    for step in range(9):
        slow = 4.0 if step >= 6 else 1.0
        for k, v in (("dispatch_s", 0.01 * slow), ("collect_s", 0.02),
                     ("s_dispatch_s", 0.03), ("steps", 1.0)):
            stats[k] = stats.get(k, 0.0) + v
        for mon in (t, j):
            mon.observe_step(wall_s=0.1 * slow, tokens=4,
                             step_stats=dict(stats), num_workers=2)
        rt, rj = t.report(), j.report()
        assert rt.calibrated == rj.calibrated
        assert rt.as_metrics() == rj.as_metrics()
        assert rt.flagged == rj.flagged and str(rt) == str(rj)
    assert "dispatch_s" in rt.flagged and "tokens_per_s" in rt.flagged


def _drift_engine(model, max_new, tol, cache_len, calibration_steps=6):
    jc, tc, _, tp = model
    ocfg = TO.ObsConfig(drift_warmup_steps=4,
                        drift_calibration_steps=calibration_steps,
                        drift_tolerance=tol)
    eng = ServingEngine(tp, tc, batch=4, cache_len=cache_len,
                        backend="hetero", num_microbatches=2,
                        kv_chunk=cache_len, device="cpu",
                        observability=ocfg)
    for i, p in enumerate(_prompts(jc, 4, seed=5, lo=4, hi=5)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=max_new))
    return eng


def test_drift_monitor_flags_a_straggler(model):
    from repro_torch.core.hetero import RWorker
    # the knob is a constructor argument too (clamped at 0, as in repro)
    assert RWorker(0, model[1], 0, 1, sim_row_cost=0.25,
                   device="cpu").sim_row_cost == 0.25
    assert RWorker(0, model[1], 0, 1, sim_row_cost=-1.0,
                   device="cpu").sim_row_cost == 0.0
    eng = _drift_engine(model, 60, 0.5, 80)
    try:
        for _ in range(10):           # warmup + calibration: healthy
            eng.step()
        assert eng.drift_report().calibrated
        # watch phase: one worker turns into a bandwidth-bound straggler
        eng.engine.workers[0].sim_row_cost = 0.05
        for _ in range(8):
            eng.step()
        rep = eng.drift_report()
        assert rep.calibrated and rep.steps_count >= 8
        keys = {r.key for r in rep.records}
        assert {"dispatch_s", "collect_s", "s_dispatch_s",
                "tokens_per_s"} <= keys
        tps = rep.record("tokens_per_s")
        assert tps.measured < tps.predicted and tps.rel < -0.5
        assert "tokens_per_s" in rep.flagged and "DRIFTED" in str(rep)
        m = eng.metrics()
        assert m["drift_flagged_count"] >= 1.0
        assert m["drift_tokens_per_s_rel"] == pytest.approx(tps.rel)
        TO.assert_conforms(m)
    finally:
        eng.close()


def test_drift_monitor_quiet_on_a_healthy_fleet(model):
    """repro's twin with longer windows (30 calibration and 30 watch
    steps where repro has 6 and 8): the port's dispatch costs ~25 µs a
    transition on the CPU, so one preemption of the S-worker thread by
    another process (the suite runs in parallel workers) moves the mean of
    a short window by several times; over 30 steps it does not."""
    eng = _drift_engine(model, 70, 3.0, 96, calibration_steps=30)
    try:
        for _ in range(64):
            eng.step()
        rep = eng.drift_report()
        assert rep.calibrated and rep.steps_count == 30
        assert rep.flagged == [], str(rep)
    finally:
        eng.close()
