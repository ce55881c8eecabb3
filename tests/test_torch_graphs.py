"""The port's step graphs (``repro_torch.core.graphs``) on the CPU, where a
StepGraph runs its body on the same static buffers a replay on the card
uses:

* each S-side transition of the port (``_start``, the fused
  ``s_advance(li) -> s_pre(li+1)``, the final logits head) against
  repro's jitted ``_start_fn(0)`` / ``_step_fn(li, 0)`` on the same
  numpy-made inputs and bridged weights, twice (the second pass refreshes
  every static buffer), fp32 within 1e-5;
* whole serves through the graph plumbing against the eager path and
  ``conftest.serve_trace`` (paged fp32, paged int8, dense int8, spec
  k = 3 with a rejecting drafter): rows admitted and retired mid-serve,
  rows crossing page boundaries (the fixed device table is refreshed in
  place), speculative truncation; tokens exact;
* the launch counters: a call adds the counts of one body run, a tally
  holds back only its own thread's adds;
* aliasing: a verify work's logits survive the next step unchanged;
* no host sync inside a captured body: every function a StepGraph body
  reaches in the port is scanned (AST) for ``.item()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()`` and ``.synchronize()``.
"""
import ast
import dataclasses
import importlib
import inspect
import textwrap
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_spec, serve_trace, tiny_cfg
from repro.core.hetero import HeteroPipelineEngine as JHeteroEngine
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.core import graphs
from repro_torch.core.config import ModelConfig
from repro_torch.core.hetero import HeteroPipelineEngine
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import ref as TREF
from repro_torch.serving import paged_cache as TPC
from repro_torch.serving.engine import ServingEngine, SpecConfig
from repro_torch.serving.request import Request

TOL = 1e-5
PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def twins():
    jc = dataclasses.replace(tiny_cfg("qwen3-8b"), num_kv_heads=2)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=0)


def _close_shards(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            _close(g[k], w[k])


# ---------------------------------------------------------------------------
# each S-side callable against repro's jitted one
# ---------------------------------------------------------------------------
def test_transitions_match_repro_callables(twins):
    jc, tc, jp, tp = twins
    kw = dict(batch=4, cache_len=16, num_r_workers=2, num_microbatches=2)
    jeng = JHeteroEngine(jp, jc, **kw)
    teng = HeteroPipelineEngine(tp, tc, device="cpu", **kw)
    try:
        rng = np.random.default_rng(5)
        mb, n = 1, 2                       # micro-batch 1 of 2 rows
        hq, dh, d = jc.num_heads, jc.head_dim, jc.d_model
        for rep in range(2):
            toks = rng.integers(1, jc.vocab_size, (n, 1)).astype(np.int32)
            lens = rng.integers(0, 12, n).astype(np.int32)
            act = np.array([True, rep == 0])
            teng.mb_lengths[mb] = torch.from_numpy(lens.copy())
            teng.mb_active[mb] = torch.from_numpy(act.copy())
            jcarry, jshards, _ = jeng._start_fn(0)(
                jp, jeng.layers[0][1], jnp.asarray(toks), {},
                jnp.asarray(lens), jnp.asarray(act))
            tcarry, tshards = teng._start(mb, torch.from_numpy(toks))
            _close(tcarry["h"], jcarry["h"])
            _close_shards(tshards, jshards)
            for li in range(jc.num_layers):
                h = rng.standard_normal((n, 1, d)).astype(np.float32)
                o = rng.standard_normal((n, 1, hq, dh)).astype(np.float32)
                fn, mode = jeng._step_fn(li, 0)
                jl, ja = jnp.asarray(lens), jnp.asarray(act)
                carry, r_out = {"h": torch.from_numpy(h.copy())}, \
                    {"o": torch.from_numpy(o.copy())}
                if mode == "fused":
                    jcarry, jshards, _ = fn(
                        jeng.layers[li][1], jeng.layers[li + 1][1],
                        {"h": jnp.asarray(h)}, {"o": jnp.asarray(o)}, {}, jl,
                        ja)
                    tcarry, tshards = teng._advance(mb, li, 0, carry, r_out)
                    _close(tcarry["h"], jcarry["h"])
                    _close_shards(tshards, jshards)
                else:
                    assert mode == "final" and li == jc.num_layers - 1
                    jlog = fn(jp, jeng.layers[li][1], {"h": jnp.asarray(h)},
                              {"o": jnp.asarray(o)}, jl, ja)
                    none, tlog = teng._advance(mb, li, 0, carry, r_out)
                    assert none is None
                    _close(tlog, jlog)
        # one graph per transition, reused by the second pass
        assert sorted(k[0] for k in teng._s_graphs) == \
            ["start"] + ["step"] * jc.num_layers
    finally:
        jeng.close()
        teng.close()


# ---------------------------------------------------------------------------
# whole serves: graph plumbing == eager path == the JAX engine's trace
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def serve_setup(twins):
    jc, tc, jp, tp = twins
    # a one-layer drafter of other weights: it disagrees with the target,
    # so verify steps reject drafts and truncate KV
    jdc = dataclasses.replace(jc, num_layers=1)
    tdc = ModelConfig(**dataclasses.asdict(jdc))
    tdp = bridge.params_from_numpy(jax.tree.map(
        np.asarray, JM.init_params(jax.random.PRNGKey(9), jdc)), tdc, "cpu")
    # prompts of 3-14 tokens and 5 new ones at page 4: every row crosses a
    # page boundary while it decodes; arrivals spread over 8 steps
    spec = random_spec(np.random.default_rng(11), jc, 7, max_new=5,
                       spread=8)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, tdc=tdc, tdp=tdp, spec=spec,
                traces={})


PAGED = dict(paged_kv=True, page_size=4)
MODES = {
    "paged": (dict(PAGED), {}),
    "paged-int8": (dict(PAGED, quantized_kv=True),
                   dict(backend="hetero", quantized_kv=True, **PAGED)),
    "dense-int8": (dict(quantized_kv=True),
                   dict(backend="hetero", quantized_kv=True)),
    "spec-paged": (dict(PAGED, spec="separate"), {}),
}


def _serve(s, **kw):
    """Serve the spec through the port's hetero engine; returns
    ({rid: tokens}, spec_stats)."""
    spec_kw = {}
    if kw.pop("spec", None):
        spec_kw = dict(spec_decode=SpecConfig(k=3, draft_cfg=s["tdc"],
                                              draft_params=s["tdp"]))
    eng = ServingEngine(s["tp"], s["tc"], batch=4, cache_len=48,
                        backend="hetero", device="cpu", **spec_kw, **kw)
    try:
        qi, spec = 0, s["spec"]
        order = sorted(range(len(spec)), key=lambda i: spec[i][2])
        while (qi < len(order) or eng.queue
               or any(r is not None for r in eng.slots)) \
                and eng.step_idx < 400:
            while qi < len(order) and spec[order[qi]][2] <= eng.step_idx:
                i = order[qi]
                eng.submit(Request(rid=i, prompt=spec[i][0],
                                   max_new_tokens=spec[i][1]))
                qi += 1
            eng.step()
        return ({r.rid: list(r.generated) for r in eng.finished},
                dict(eng.spec_stats))
    finally:
        eng.close()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_graph_serve_matches_eager_and_jax_trace(serve_setup, mode,
                                                 monkeypatch):
    s = serve_setup
    port_kw, jax_kw = MODES[mode]
    key = tuple(sorted(jax_kw))
    if key not in s["traces"]:
        s["traces"][key] = serve_trace(s["jp"], s["jc"], s["spec"], **jax_kw)
    want = s["traces"][key]
    refreshed = []          # (allocator, buffer) of each in-place refresh
    own = TPC.PagedAllocator.tables_device

    def spy(alloc):
        stale = alloc._dev_tables is not None and alloc._dirty
        out = own(alloc)
        if stale:
            refreshed.append((id(alloc), id(out)))
        return out
    monkeypatch.setattr(TPC.PagedAllocator, "tables_device", spy)
    got, stats = _serve(s, **port_kw)
    with graphs.eager():
        eager, eager_stats = _serve(s, **port_kw)
    assert got == eager == want and len(got) == len(s["spec"])
    assert stats == eager_stats
    if "paged_kv" in port_kw:
        # tables grew mid-decode, and each allocator kept one buffer
        assert refreshed
        bufs = {}
        for alloc, buf in refreshed:
            bufs.setdefault(alloc, set()).add(buf)
        assert all(len(b) == 1 for b in bufs.values())
    if "spec" in port_kw:
        # rejected drafts: every verify step truncated KV
        assert stats["accepted_tokens"] < stats["drafted_tokens"]


def test_captures_hold_the_cyclic_gc_off():
    """While any thread is inside a capture the cyclic GC stays off: a
    collection runs in whatever thread allocates, and collecting an old
    engine's graphs there destroys them inside that thread's capture
    (the capture is invalidated; seen on the card).  The last holder
    restores what the first one found."""
    import gc
    assert gc.isenabled()
    inside, leave = threading.Event(), threading.Event()

    def other():
        with graphs._no_gc():
            inside.set()
            leave.wait(10)
    t = threading.Thread(target=other)
    with graphs._no_gc():
        assert not gc.isenabled()
        t.start()
        assert inside.wait(10)
    assert not gc.isenabled()           # the other thread still holds it
    leave.set()
    t.join(10)
    assert gc.isenabled()
    gc.disable()                        # a caller's choice is kept
    try:
        with graphs._no_gc():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_close_releases_the_graphs(serve_setup):
    """A closed engine holds no graph (the S-side, the R-Parts', the
    drafter's): they are freed on the closing thread, not by a later
    collection that may run inside another engine's capture."""
    s = serve_setup
    eng = ServingEngine(s["tp"], s["tc"], batch=4, cache_len=48,
                        backend="hetero", paged_kv=True, page_size=4,
                        spec_decode=SpecConfig(k=2), device="cpu")
    eng.submit(Request(rid=0, prompt=s["spec"][0][0], max_new_tokens=8))
    eng.run(20)
    het = eng.engine
    assert het._s_graphs and all(w._graphs for w in het.workers)
    assert eng._draft_graph is not None and eng._commit_graph is not None
    eng.close()
    assert not het._s_graphs and not any(w._graphs for w in het.workers)
    assert eng._draft_graph is None and eng._commit_graph is None


# ---------------------------------------------------------------------------
# counters and aliasing
# ---------------------------------------------------------------------------
def test_a_call_adds_the_counts_of_one_body_run():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 4, 64)).astype(np.float32))
    pk = torch.from_numpy(rng.standard_normal((5, 4, 2, 64)).astype(
        np.float32))
    tables = torch.tensor([[0, 1], [2, -1]], dtype=torch.int32)
    lengths = torch.tensor([6, 3], dtype=torch.int32)

    def body(ins):
        return {"o": TPA.paged_decode_attention(ins["q"], pk, pk, tables,
                                                ins["lengths"])}
    g = graphs.StepGraph(body, {"q": q, "lengths": lengths},
                         graphs.GraphPool("cpu"))
    before = TPA.plain_calls.value
    outs = [g()["o"].clone() for _ in range(3)]
    assert g.counts == {TPA.plain_calls: 1}
    assert TPA.plain_calls.value - before == 3
    want = TREF.paged_decode_attention_ref(q, pk, pk, tables, lengths)
    for o in outs:
        torch.testing.assert_close(o, want, atol=0, rtol=0)
    # a fed input lands in the static buffer the body reads
    g.feed({"q": q * 2})
    assert g.inputs["q"] is q and g()["o"] is g.outputs["o"]


def test_tally_holds_back_only_its_own_thread():
    c = TPA.LaunchCounter()
    with TPA.tally() as counts:
        c.add()
        c.add(2)
        t = threading.Thread(target=c.add)
        t.start()
        t.join()
    assert counts == {c: 3} and c.value == 1
    c.add()
    assert c.value == 2


def test_verify_logits_survive_the_next_step(serve_setup):
    s = serve_setup
    eng = ServingEngine(s["tp"], s["tc"], batch=4, cache_len=48,
                        backend="hetero", device="cpu",
                        spec_decode=SpecConfig(k=3), **PAGED)
    try:
        rng = np.random.default_rng(4)
        for i in range(4):
            eng.submit(Request(rid=i, prompt=rng.integers(
                1, s["jc"].vocab_size, 6).astype(np.int32),
                max_new_tokens=12))
        eng.step()
        works = eng.engine.prefill_results
        assert works and all(wk.verify for wk in works)
        kept = [wk.logits.clone() for wk in works]
        eng.step()
        assert eng.engine.prefill_results is not works
        for wk, k in zip(works, kept):
            assert torch.equal(wk.logits, k)
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# no host sync inside a captured body (the torch analogue of RA002)
# ---------------------------------------------------------------------------
SYNCS = {"item", "cpu", "tolist", "numpy", "synchronize", "nonzero"}


def _resolve(call, scope, cls):
    """The port function a call names, or None: ``f`` (a global),
    ``mod.f`` (a global module's attribute) or ``self.f`` (a method of
    ``cls``)."""
    f = call.func
    obj = None
    if isinstance(f, ast.Name):
        obj = scope.get(f.id)
    elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        if f.value.id == "self" and cls is not None:
            obj = getattr(cls, f.attr, None)
        elif inspect.ismodule(scope.get(f.value.id)):
            obj = getattr(scope[f.value.id], f.attr, None)
    obj = inspect.unwrap(obj) if callable(obj) else None
    if inspect.isfunction(obj) and obj.__module__.startswith("repro_torch"):
        return obj
    return None


def _owner(fn):
    """The class a method was defined in (for its ``self.`` calls)."""
    parts = fn.__qualname__.split(".")
    if len(parts) < 2 or "<locals>" in parts:
        return None
    return fn.__globals__.get(parts[0])


def scan(node, scope, cls, where, seen, found) -> None:
    """Walk ``node`` (a function's AST) and every port function it calls,
    recording each host sync as (where, line, call)."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        if isinstance(sub.func, ast.Attribute) and sub.func.attr in SYNCS:
            found.append((where, sub.lineno, ast.unparse(sub)[:60]))
            continue
        fn = _resolve(sub, scope, cls)
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        scan(tree, fn.__globals__, _owner(fn), fn.__qualname__, seen, found)


def captured_bodies(module):
    """Every nested function named ``body`` in ``module``: the port's
    convention for a function handed to StepGraph.  Yields (qualified
    name, AST, the class of the method that builds it)."""
    tree = ast.parse(Path(module.__file__).read_text())
    for top in tree.body:
        classes = [top] if isinstance(top, ast.ClassDef) else []
        funcs = ([f for f in top.body if isinstance(f, ast.FunctionDef)]
                 if classes else [top] if isinstance(top, ast.FunctionDef)
                 else [])
        cls = getattr(module, top.name, None) if classes else None
        for f in funcs:
            for sub in ast.walk(f):
                if isinstance(sub, ast.FunctionDef) and sub.name == "body":
                    yield f"{getattr(cls, '__name__', '')}.{f.name}", sub, cls


def host_syncs(module, seen=None):
    """(bodies, syncs) of ``module``; ``seen`` (a set), when given,
    receives every port function the bodies reach."""
    found, n = [], 0
    seen = set() if seen is None else seen
    for where, node, cls in captured_bodies(module):
        n += 1
        scan(node, vars(module), cls, where, seen, found)
    return n, found


def test_captured_bodies_have_no_host_sync():
    bodies, syncs, reached = 0, [], set()
    for path in sorted(PORT.rglob("*.py")):
        mod = importlib.import_module("repro_torch." + ".".join(
            path.relative_to(PORT).with_suffix("").parts).replace(
                ".__init__", ""))
        n, found = host_syncs(mod, reached)
        bodies += n
        syncs += [(path.name,) + f for f in found]
    # the S-side transitions (4), the R-Parts (5), the drafter's step and
    # commit (2)
    assert bodies >= 11
    # the FFNs the S-side transitions run, the MoE dispatch among them
    from repro_torch.models import layers
    assert {layers.swiglu, layers.mlp, layers.moe_ffn,
            layers.moe_route} <= reached
    assert not syncs, syncs


def test_host_sync_scan_finds_a_sync_in_a_callee(tmp_path, monkeypatch):
    (tmp_path / "fake_bodies.py").write_text(textwrap.dedent('''
        import torch
        from repro_torch.core import decompose as D


        def helper(x):
            return int(x.sum().item())


        class Engine:
            def build(self):
                def body(ins):
                    D.num_phases("attn")
                    return {"n": self.count(ins["x"])}
                return body

            def count(self, x):
                return helper(x) + x.tolist()[0]
        '''))
    monkeypatch.syspath_prepend(str(tmp_path))
    mod = importlib.import_module("fake_bodies")
    # the port's own modules are scanned through; the fake's functions
    # count as port code for this check
    monkeypatch.setattr(mod.helper, "__module__", "repro_torch.fake")
    monkeypatch.setattr(mod.Engine.count, "__module__", "repro_torch.fake")
    n, found = host_syncs(mod)
    assert n == 1
    assert sorted(call for _, _, call in found) == ["x.sum().item()",
                                                    "x.tolist()"]
