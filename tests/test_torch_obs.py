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
- observability on and off give identical tokens and logits, and so does
  a bare tracer (``attach_tracer``);
- the port's own spans (``engine.*``, ``pipe.*``, ``r.*``) form one tree
  per step, timed from the stamps of the step's walls, and its clock
  anchors place spans on a ``torch.profiler`` timeline."""
import dataclasses
import json
import statistics
import threading
import time

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
           logits=None, spans=None, tracer=None, **kw):
    """Serve ``prompts`` on the port's engine (``port``) or the JAX one;
    ``arrive`` {rid: step}, ``preempt`` {step: rid} preempts before a
    step; ``logits`` (a list, port only) receives each step's logits,
    ``spans`` (a list, port only) the engine's tracer's spans, and
    ``tracer`` (port only) is attached with ``attach_tracer``.
    Returns (engine metrics, {rid: timeline (event, step)}, {rid:
    tokens})."""
    jc, tc, jp, tp = model
    if port:
        eng = ServingEngine(tp, tc, device="cpu", **kw)
        if tracer is not None:
            eng.attach_tracer(tracer)
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
        if port and eng.backend == "hetero":
            # an R-worker records its last span after its last post
            eng._quiesce_workers()
        m = eng.metrics()
        if spans is not None and port:
            spans.extend(eng.tracer.spans())
        tl = {r.rid: [e[:2] for e in eng.request_timeline(r.rid)]
              for r in eng.finished}
        toks = {r.rid: [int(t) for t in r.generated] for r in eng.finished}
        return m, tl, toks
    finally:
        if eng.backend == "hetero":
            eng.close()


# counts fixed by the trace (host-clock values and scheduling-dependent
# counters such as ooo advances are left out; the span count is compared
# on the spans repro records, as the port records more)
def _counts(m):
    host = ("hotpath_ooo_advances_count", "trace_spans_count")
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
    spans = []
    mt, tlt, tt = _serve(True, model, prompts, observability=True,
                         spans=spans, **run_kw, **tkw)
    mj, tlj, tj = _serve(False, model, prompts, observability=True,
                         **run_kw, **jkw)
    TO.assert_conforms(mt)
    assert tt == tj
    # the spans repro records (steps, round trips, R-worker busy windows),
    # one for one; the port's own (engine.*, pipe.*, r.*) besides
    assert mt["trace_spans_count"] == len(spans)
    assert sum(s["cat"] in ("step", "r-rtt", "r-worker") for s in spans) \
        == mj["trace_spans_count"]
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
    lg_on, lg_off, lg_tr = [], [], []
    m_on, _, on = _serve(True, model, prompts, observability=True,
                         logits=lg_on, **run_kw, **kw)
    m_off, tl_off, off = _serve(True, model, prompts, logits=lg_off,
                                **run_kw, **kw)
    tracer = TO.SpanTracer()
    m_tr, tl_tr, traced = _serve(True, model, prompts, logits=lg_tr,
                                 tracer=tracer, **run_kw, **kw)
    assert on == off == traced
    assert len(lg_on) == len(lg_off) == len(lg_tr)
    for a, b, c in zip(lg_on, lg_off, lg_tr):
        assert (a is None) == (b is None) == (c is None)
        if a is not None:
            assert torch.equal(a, b) and torch.equal(c, b)
    assert "ttft_s_p50" in m_on and "ttft_s_p50" not in m_off
    # the bare tracer recorded spans and counters, and wired no registry
    # or timeline
    assert tracer.added > 0 and tracer.counters()["graph.s.calls"] > 0
    assert "ttft_s_p50" not in m_tr and "trace_spans_count" not in m_tr
    assert all(events == [] for events in tl_tr.values())
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
        eng._quiesce_workers()
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
        # per step: a step span and the engine's five (engine.step, admit,
        # upload, sample, emit) and one engine.prefill where it admitted;
        # per micro-batch a pipe.start; per (micro-batch, layer) a
        # dispatch, an r-rtt, a gather and an advance, and for each of
        # the 2 workers a busy window and its five r.* spans; a
        # pipe.sink_wait per completion taken and per empty poll
        n_steps = eng.step_idx
        n_prefill = sum(1 for r in eng.records if r.admitted)
        n_wait = sum(e["name"] == "pipe.sink_wait" for e in xs)
        n_trips = n_steps * 2 * tc.num_layers
        assert len(steps) == n_steps
        assert len(rtts) == n_trips
        assert n_wait >= 2 * n_trips
        assert eng.metrics()["trace_spans_count"] == len(xs) == \
            n_steps * (1 + 5 + 2) + n_prefill + n_trips * (4 + 2 * 6) \
            + n_wait
        # toggled off: the tracer is detached, nothing more is recorded
        eng.set_observability(False)
        eng.submit(Request(rid=9, prompt=_prompts(jc, 1)[0],
                           max_new_tokens=2))
        eng.run(max_steps=10)
        assert eng._obs_obj.tracer.added == len(xs)
        assert eng.engine.tracer is None and eng.tracer is None
        assert all(w.tracer is None for w in eng.engine.workers)
        assert eng.request_timeline(9) == []
    finally:
        eng.close()


def test_span_tree_of_a_traced_serve(model):
    """A paged hetero serve (2 micro-batches, 2 R-workers) under a bare
    tracer: every S-worker span nests, by parent and in time, in its
    ``engine.step``; every R-worker span names a ``pipe.dispatch`` of the
    same pipeline step as its parent, whose id is its ``r-rtt`` span's;
    the step's walls are its spans' stamps; detached, nothing more is
    recorded."""
    jc, tc, _, tp = model
    eng = ServingEngine(tp, tc, batch=4, cache_len=48, backend="hetero",
                        num_microbatches=2, num_r_workers=2, paged_kv=True,
                        page_size=4, device="cpu")
    tr = TO.SpanTracer()
    eng.attach_tracer(tr)
    try:
        for i, p in enumerate(_prompts(jc, 6)):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=4))
        eng.run(max_steps=100)
        eng._quiesce_workers()
        spans = tr.spans()
        assert tr.dropped == 0 and eng.obs is None
        for sp in spans:
            sp["te"] = sp["ts_s"] + sp["dur_s"]
        # a round trip's r-rtt span shares its pipe.dispatch's id; every
        # other id names one span
        owners = [sp for sp in spans
                  if "id" in sp["args"] and sp["cat"] != "r-rtt"]
        by_id = {sp["args"]["id"]: sp for sp in owners}
        assert len(by_id) == len(owners)
        steps = [sp for sp in spans if sp["name"] == "engine.step"]
        assert len(steps) == eng.step_idx
        eps = 1e-9

        def inside(sp, outer):
            return (outer["ts_s"] - eps <= sp["ts_s"]
                    and sp["te"] <= outer["te"] + eps)

        def root(sp):
            while sp["name"] != "engine.step":
                sp = by_id[sp["args"]["parent"]]
            return sp

        s_side = [sp for sp in spans if sp["track"] == "s-worker"]
        for sp in s_side:
            top = root(sp)
            assert inside(sp, top), sp["name"]
            kind = sp["name"].split(".")[0].split(" ")[0]
            parent = by_id.get(sp["args"].get("parent"))
            if sp["name"] == "engine.prefill":
                # the monolithic prefill, inside the admission
                assert parent["name"] == "engine.admit"
                assert inside(sp, parent)
            elif kind == "engine" and sp is not top:
                assert parent is top and sp["args"]["step"] == \
                    top["args"]["step"]
            elif kind == "step":
                assert parent is top
            elif kind == "pipe":
                assert parent["cat"] == "step" and inside(sp, parent)
                assert sp["args"]["step"] == parent["args"]["step"]
        # each engine step's children do not overlap and stay inside its
        # wall; its record's walls are the same stamps
        for top, rec in zip(steps, eng.records):
            kids = sorted((sp for sp in s_side if sp["args"].get("parent")
                           == top["args"]["id"]), key=lambda x: x["ts_s"])
            assert {k["name"] for k in kids} >= {
                "engine.admit", "engine.upload", "engine.sample",
                "engine.emit"}
            for a, b in zip(kids, kids[1:]):
                assert a["te"] <= b["ts_s"] + eps
            admit = next(k for k in kids if k["name"] == "engine.admit")
            assert admit["dur_s"] == rec.prefill_wall
            up = next(k for k in kids if k["name"] == "engine.upload")
            smp = next(k for k in kids if k["name"] == "engine.sample")
            assert up["ts_s"] == admit["te"] or \
                abs(up["ts_s"] - admit["te"]) < eps
            assert abs(smp["te"] - up["ts_s"] - rec.decode_wall) < eps
            pre = [sp for sp in s_side if sp["name"] == "engine.prefill"
                   and sp["args"]["parent"] == admit["args"]["id"]]
            assert len(pre) == (1 if rec.admitted else 0)
        # the R side: every r.* span and busy window hangs off a dispatch
        # of its own pipeline step, which is its round trip
        dispatches = {sp["args"]["id"]: sp for sp in s_side
                      if sp["name"] == "pipe.dispatch"}
        r_side = [sp for sp in spans if sp["cat"] in ("r-part", "r-worker")]
        assert {sp["name"] for sp in r_side if sp["cat"] == "r-part"} == {
            "r.queue", "r.prep", "r.launch", "r.sync", "r.post"}
        for sp in r_side:
            d = dispatches[sp["args"]["parent"]]
            assert sp["args"]["step"] == d["args"]["step"]
            assert d["ts_s"] - eps <= sp["ts_s"]
        rtts = [sp for sp in spans if sp["cat"] == "r-rtt"]
        assert {sp["args"]["id"] for sp in rtts} == set(dispatches)
        n_items = len(rtts) * 2
        assert sum(sp["cat"] == "r-worker" for sp in r_side) == n_items
        c = tr.counters()
        assert c["graph.r.calls"] == n_items
        assert c["k1.calls"] == n_items
        assert c["r.d2h_bytes"] == c["s.h2d_bytes"] > 0
        assert c.get("graph.s.captures", 0) == 0
        # detached: nothing more is recorded anywhere
        eng.attach_tracer(None)
        assert eng.engine._s_pool.tracer is None
        assert all(w.tracer is None and w._pool.tracer is None
                   for w in eng.engine.workers)
        added, counts = tr.added, tr.counters()
        eng.submit(Request(rid=9, prompt=_prompts(jc, 1)[0],
                           max_new_tokens=3))
        eng.run(max_steps=10)
        eng._quiesce_workers()
        assert tr.added == added and tr.counters() == counts
    finally:
        eng.close()


def test_clock_anchors_place_spans_on_the_profiler_timeline():
    """Under a CPU ``torch.profiler``, two ``mark_clock`` anchors map a
    span taken around a ``record_function``-wrapped sleep onto that
    profiler event, within 0.1 ms at each end (the median of five)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.obs.spans import CLOCK_EVENT, clock_map
    tr = TO.SpanTracer()
    stamps = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.mark_clock()
        for _ in range(5):
            t0 = time.perf_counter()
            with record_function("work"):
                time.sleep(0.005)
            stamps.append((t0, time.perf_counter()))
        tr.mark_clock()
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    ends = [e.time_range.end for e in events if e.name == CLOCK_EVENT]
    work = [e.time_range for e in events if e.name == "work"]
    assert len(ends) == len(tr.clock) == 2 and len(work) == 5
    to_us = clock_map(tr.clock, ends)
    lead = statistics.median(w.start - to_us(a)
                             for (a, _), w in zip(stamps, work))
    lag = statistics.median(to_us(b) - w.end
                            for (_, b), w in zip(stamps, work))
    assert abs(lead) <= 100.0 and abs(lag) <= 100.0, (lead, lag)
    with pytest.raises(ValueError):
        clock_map(tr.clock, ends[:1])


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


# per decode step of the reduced hetero serve on the CPU (granite, 2
# micro-batches, 2 workers: 6 transitions a step): host seconds of the
# three orchestration terms, the step's wall and its tokens
_HEALTHY_STEP = {"dispatch_s": 3e-4, "collect_s": 1.2e-4,
                 "s_dispatch_s": 3.6e-4, "wall_s": 4e-3, "tokens": 4}


def _feed(mon, rng, steps, slow=None):
    """``steps`` seeded step records into ``mon``: each term the healthy
    value times lognormal noise (sigma 0.35), and one step in 15 on
    average preempted (every host term 4x: another process took the
    S-worker's core), the spread of the parallel suite's CPU serves;
    ``slow`` {term: factor} multiplies terms on top (a straggler)."""
    cum = dict(mon._last_stats)
    for _ in range(steps):
        spike = 4.0 if rng.random() < 1 / 15 else 1.0
        step = {k: v * spike * float(rng.lognormal(0.0, 0.35))
                * (slow or {}).get(k, 1.0)
                for k, v in _HEALTHY_STEP.items() if k != "tokens"}
        for k in ("dispatch_s", "collect_s", "s_dispatch_s"):
            cum[k] = cum.get(k, 0.0) + step[k]
        cum["steps"] = cum.get("steps", 0.0) + 1.0
        mon.observe_step(wall_s=step["wall_s"],
                         tokens=_HEALTHY_STEP["tokens"], step_stats=cum)


def _drift_monitor(model, tol=3.0):
    return TO.DriftMonitor(model[1], 2, 2, calibration_steps=30,
                           tolerance=tol, warmup_steps=4)


def test_drift_monitor_quiet_on_a_healthy_fleet(model):
    """A healthy fleet stays quiet at tolerance 3.0 (repro's twin uses 6
    calibration and 8 watch steps).  The property is held on seeded step
    streams with the spread the suite's CPU serves show (noise and
    preempted steps: ``_feed``), every seed of ten quiet; the live serve
    checks the wiring only: it calibrates over 30 steps, counts 30 watch
    steps and reports every record.  Its wall-clock host spans under six
    parallel test workers are not a healthy input: a preemption moves a
    sub-millisecond term by several times (one such run read collect_s
    +377%)."""
    for seed in range(10):
        mon = _drift_monitor(model)
        _feed(mon, np.random.default_rng(seed), 4 + 30 + 30)
        rep = mon.report()
        assert rep.calibrated and rep.steps_count == 30
        assert rep.flagged == [], (seed, str(rep))
    eng = _drift_engine(model, 70, 3.0, 96, calibration_steps=30)
    try:
        for _ in range(64):
            eng.step()
        rep = eng.drift_report()
        assert rep.calibrated and rep.steps_count == 30
        assert {r.key for r in rep.records} == {
            "dispatch_s", "collect_s", "s_dispatch_s", "tokens_per_s"}
    finally:
        eng.close()


def test_drift_monitor_flags_a_seeded_straggler_stream(model):
    """The same monitor and healthy calibration, then a watch phase whose
    collect and wait terms run 8x (a worker whose completions come late)
    with the step wall 8x: flagged at tolerance 3.0 (collect_s), and
    tokens_per_s too at repro's straggler tolerance of 0.5."""
    for tol, keys in ((3.0, {"collect_s"}), (0.5, {"collect_s",
                                                    "tokens_per_s"})):
        mon = _drift_monitor(model, tol)
        rng = np.random.default_rng(0)
        _feed(mon, rng, 4 + 30)
        _feed(mon, rng, 30, slow={"collect_s": 8.0, "wall_s": 8.0})
        rep = mon.report()
        assert keys <= set(rep.flagged), str(rep)
        assert "dispatch_s" not in rep.flagged
