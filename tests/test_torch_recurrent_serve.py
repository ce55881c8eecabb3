"""The recurrent models served by the port, against the JAX package on the
same weights and specs: recurrentgemma-2b (RG-LRU blocks, windowed MQA
every third layer) and mamba2-2.7b (SSD blocks, no attention).

* the ServingEngine against ``conftest.serve_trace`` (hetero paged),
  hetero == colocated with 1 and 2 workers (twin of
  ``tests/test_hetero.py:13``'s mamba2 case, and the same for the
  hybrid), ``prefill_chunk=4`` against monolithic and against ``repro``'s
  chunked serve (twin of ``tests/test_prefill_chunked.py:22,77``);
* storage: ``paged_kv=True`` keeps the hybrid's windowed layers dense (no
  paged key; twin of ``tests/test_paged_hetero.py:68``) and builds no
  allocator or pool for mamba2; a ring that wraps (window 8) against
  ``repro``; ``quantized_kv=True`` on the hybrid within the int8 bound of
  fp and equal to ``repro``'s int8 engine on teacher-forced logits;
* ``prefix_cache``, ``spec_decode`` and tiering refuse both archs with
  ``repro``'s errors;
* the recurrent rows' reset for chunked prefill (``begin_prefill_rows``);
* fleet: a live migration and a re-prefill failover of recurrent rows
  leave the tokens of the uninterrupted serve; ``export_rows`` of {h}
  rows equals ``repro``'s byte for byte;
* the admission schedules, ``from_plan``, observability and the
  static-batch API (``load_prefill``, ``decode_step``,
  ``decode_step_legacy``) on both archs.

fp32 tiny configs (3 layers, d_model 64); logits within 1e-4 (the other
model twins' tolerance), tokens exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_spec, serve_trace, tiny_cfg
from repro.core import hetero as JH
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.engine import SpecConfig as JSpecConfig
from repro_torch import bridge
from repro_torch.core.config import ModelConfig
from repro_torch.core.hetero import (ColocatedEngine, HeteroPipelineEngine,
                                     RWorker)
from repro_torch.fleet import FleetManager, uniform_fleet
from repro_torch.kernels import quant_kv as TQK
from repro_torch.models import model as TM
from repro_torch.serving import kv_cache as TKV
from repro_torch.serving.engine import ServingEngine, SpecConfig
from repro_torch.serving.request import Request
from test_torch_serving import serve_trace_torch

LOGIT_TOL = 1e-4
QUANT_BOUND = 0.5    # int8 against fp logits, as tests/test_hetero.py
ARCHS = ["recurrentgemma-2b", "mamba2-2.7b"]
HETERO = dict(backend="hetero", num_r_workers=2, paged_kv=True, page_size=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, seed=0, **kw):
    jc = dataclasses.replace(tiny_cfg(arch), **kw)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jax.random.PRNGKey(seed), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def _trace(tp, tc, spec, **kw):
    return serve_trace_torch(tp, tc, spec, **kw)[0]


@pytest.fixture(scope="module", params=ARCHS)
def rserve(request):
    """(arch, jc, tc, jp, tp, spec, repro's hetero paged serve)."""
    jc, tc, jp, tp = _setup(request.param)
    spec = random_spec(np.random.default_rng(1), jc, 6, spread=6)
    return (request.param, jc, tc, jp, tp, spec,
            serve_trace(jp, jc, spec, **HETERO))


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------
def test_hetero_paged_serve_matches_jax_oracle(rserve):
    _, _, tc, _, tp, spec, want = rserve
    assert _trace(tp, tc, spec, **HETERO) == want


@pytest.mark.parametrize("kw", [dict(backend="colocated"),
                                dict(HETERO, num_r_workers=1),
                                dict(backend="hetero", num_r_workers=1),
                                dict(backend="hetero", num_r_workers=2),
                                dict(HETERO, schedule="fifo")],
                         ids=["colocated", "paged-1w", "dense-1w",
                              "dense-2w", "paged-fifo"])
def test_hetero_equals_colocated(rserve, kw):
    _, _, tc, _, tp, spec, want = rserve
    assert _trace(tp, tc, spec, **kw) == want


def test_chunked_equals_monolithic_and_jax(rserve):
    """prefill_chunk=4 (ragged prompt tails, a chunk work beside decoding
    rows, the recurrent rows reset at admission): the monolithic tokens,
    and ``repro``'s chunked serve's."""
    _, jc, tc, jp, tp, spec, want = rserve
    got = _trace(tp, tc, spec, prefill_chunk=4, **HETERO)
    assert got == want
    assert got == serve_trace(jp, jc, spec, prefill_chunk=4, **HETERO)


def test_storage_stays_dense_or_poolless(rserve):
    """paged_kv=True: the hybrid's windowed layers keep the dense slab
    (no paged key, no allocator), mamba2 has no attention layer and so no
    allocator and no pool; its KV bytes per sequence are 0."""
    arch, _, tc, _, tp, spec, want = rserve
    eng = ServingEngine(tp, tc, batch=4, cache_len=48, device="cpu",
                        **HETERO)
    try:
        for i, (p, n, _) in enumerate(spec[:4]):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=n))
        for _ in range(3):
            eng.step()
        ws = eng.engine.workers
        assert all(not w.paged_keys and not w.allocators for w in ws)
        assert sum(w.pool_bytes() for w in ws) == 0
        assert eng.engine.paged_resident_bytes() == 0.0
        kinds = {k for k in tc.pattern}
        h_keys = [lk for w in ws for lk, st in w.state.items()
                  if set(st) == {"h"}]
        assert len(h_keys) == 2 * 2 * sum(k != "attn" for k in tc.pattern)
        if arch == "mamba2-2.7b":
            assert kinds == {"ssd"}
            assert TKV.kv_bytes_per_seq(tc, 48) == 0
            assert TKV.kv_bytes_per_seq(tc, 48, quantized=True) == 0
        else:
            slab = [st for w in ws for st in w.state.values() if "k" in st]
            assert slab and all(st["k"].shape[1] == min(48, tc.window)
                                for st in slab)
    finally:
        eng.close()


@pytest.mark.parametrize("kw", [dict(prefix_cache=True),
                                dict(spec_decode="spec"),
                                dict(kv_tiering=True)],
                         ids=["prefix_cache", "spec_decode", "tiering"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_spec_and_tiering_refused_as_jax(arch, kw):
    jc, tc, jp, tp = _setup(arch)
    errs = []
    for cls, params, cfg, spec_cls in ((JServingEngine, jp, jc, JSpecConfig),
                                       (ServingEngine, tp, tc, SpecConfig)):
        kk = dict(kw)
        if kk.get("spec_decode") == "spec":
            kk["spec_decode"] = spec_cls(k=2)
        extra = {} if cls is JServingEngine else {"device": "cpu"}
        with pytest.raises(ValueError) as e:
            cls(params, cfg, batch=4, cache_len=32, **HETERO, **kk, **extra)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_wrapped_ring_matches_jax():
    """The hybrid with a window of 8: every request's prompt and tokens
    run past it, so each attention slab (8 slots) wraps; the ring's order
    and masks against ``repro``'s chunked serve (which streams each row's
    tokens into the ring itself), monolithic, colocated and chunked.
    ``repro``'s monolithic prefill drops a short row's oldest in-window
    tokens when the padded batch is longer than the ring (ROADMAP §3;
    ``test_torch_recurrent.py::test_prefill_keeps_each_rows_window``);
    the port's does not."""
    jc, tc, jp, tp = _setup("recurrentgemma-2b", window=8)
    spec = random_spec(np.random.default_rng(5), jc, 5, p_lo=9, p_hi=20,
                       max_new=6, spread=4)
    want = serve_trace(jp, jc, spec, prefill_chunk=4, **HETERO)
    assert _trace(tp, tc, spec, **HETERO) == want
    assert _trace(tp, tc, spec, backend="colocated") == want
    assert _trace(tp, tc, spec, prefill_chunk=4, **HETERO) == want


# ---------------------------------------------------------------------------
# the recurrent rows' reset for chunked prefill
# ---------------------------------------------------------------------------
def test_begin_prefill_rows_zeroes_recurrent_rows_in_place():
    """The rows admitted for chunked prefill get h = 0 on their R-worker
    and a zero conv window S-side, in the buffers the graphs captured;
    the other rows keep theirs."""
    jc, tc, jp, tp = _setup("recurrentgemma-2b")
    eng = HeteroPipelineEngine(tp, tc, batch=4, cache_len=16,
                               num_r_workers=2, num_microbatches=2,
                               device="cpu")
    try:
        rng = np.random.default_rng(3)
        for mb in range(2):
            eng.load_prefill(mb, torch.from_numpy(rng.integers(
                1, jc.vocab_size, (2, 6)).astype(np.int32)),
                torch.tensor([6, 4], dtype=torch.int32))
        conv_bufs = [st["conv"] for st in eng.s_states[1] if st]
        h_bufs = {(w.wid, lk): st["h"] for w in eng.workers
                  for lk, st in w.state.items() if "h" in st}
        eng.begin_prefill_rows([3])              # mb 1, local row 1
        for li, st in enumerate(eng.s_states[1]):
            if st:
                assert float(st["conv"][1].abs().max()) == 0.0
                assert float(st["conv"][0].abs().max()) > 0.0
        assert [st["conv"] for st in eng.s_states[1] if st] == conv_bufs
        for w in eng.workers:
            for lk, st in w.state.items():
                if "h" not in st:
                    continue
                assert st["h"] is h_bufs[(w.wid, lk)]
                zero = lk // tc.num_layers == 1 and w.lo <= 1 < w.hi
                assert (float(st["h"].abs().max()) == 0.0) == zero
        assert not bool(eng.mb_active[1][1]) and int(eng.mb_lengths[1][1]) \
            == 0
    finally:
        eng.close()


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_of_a_reused_row_starts_from_zero(arch):
    """A row that served a prompt and decoded is re-admitted for chunked
    prefill of a new prompt (chunks of 3 while the other rows decode):
    its last chunk's logits equal a fresh whole-prompt prefill of that
    prompt, so its recurrent h and conv window restarted from zero (with
    the previous occupant's state they part by far more than 1e-4)."""
    jc, tc, jp, tp = _setup(arch)
    rng = np.random.default_rng(12)
    toks = rng.integers(1, jc.vocab_size, (4, 7)).astype(np.int32)
    plens = np.array([7, 5, 6, 4], np.int32)
    new = rng.integers(1, jc.vocab_size, (8,)).astype(np.int32)
    T = torch.from_numpy
    eng = HeteroPipelineEngine(tp, tc, batch=4, cache_len=24,
                               num_r_workers=2, num_microbatches=2,
                               device="cpu")
    try:
        for m in range(2):
            eng.load_prefill(m, T(toks[2 * m:2 * m + 2]),
                             T(plens[2 * m:2 * m + 2]))
        tok = toks[np.arange(4), plens - 1][:, None]
        for _ in range(3):
            eng.decode_step([T(tok[:2]), T(tok[2:])])
        eng.begin_prefill_rows([3])            # micro-batch 1, local row 1
        last = None
        for c0 in range(0, len(new), 3):
            part = new[c0:c0 + 3]
            chunk = np.zeros((1, 3), np.int32)
            chunk[0, :len(part)] = part
            wk = eng.queue_prefill_chunk(1, [1], chunk, [c0], [len(part)])
            eng.decode_step([T(tok[:2]), T(tok[2:])])
            last = wk.logits[1]
    finally:
        eng.close()
    want, _ = TM.prefill(tp, tc, T(new[None]), torch.tensor([len(new)]), 24)
    np.testing.assert_allclose(last.numpy(), want[0].numpy(),
                               atol=LOGIT_TOL, rtol=0)


def test_chunked_serve_with_reused_rows_matches_jax():
    """Batch 2 (one row per micro-batch), six requests, so every row is
    reused after a finished occupant under prefill_chunk=3: the tokens of
    ``repro``'s colocated serve (mamba2, whose tokens its state moves)."""
    jc, tc, jp, tp = _setup("mamba2-2.7b")
    spec = random_spec(np.random.default_rng(9), jc, 6, p_lo=4, p_hi=12,
                       max_new=4, spread=3)
    want = serve_trace(jp, jc, spec, batch=2, backend="colocated")
    got = _trace(tp, tc, spec, batch=2, prefill_chunk=3,
                 **dict(HETERO, num_r_workers=1))
    assert got == want


# ---------------------------------------------------------------------------
# int8 storage on the hybrid
# ---------------------------------------------------------------------------
def _static(eng, load, step, toks, plens, gen=4, mb=2):
    """load_prefill per micro-batch, then ``gen`` teacher-forced steps
    (the same tokens for every engine); the logits [gen, B, V]."""
    load(eng)
    out = []
    for i in range(gen):
        tok = toks[:, i:i + 1]
        out.append(np.concatenate([np.asarray(x) for x in step(
            eng, [tok[m * mb:(m + 1) * mb] for m in range(2)])]))
    return np.stack(out)


def test_quantized_kv_hybrid_within_int8_bound_and_equal_to_jax():
    """The hybrid's windowed layers on int8 R-worker storage (kernel 3's
    slab entry; its plain version here): teacher-forced logits within the
    int8 bound of the fp engine's and equal to ``repro``'s int8 engine."""
    jc, tc, jp, tp = _setup("recurrentgemma-2b")
    rng = np.random.default_rng(4)
    toks = rng.integers(1, jc.vocab_size, (4, 9)).astype(np.int32)
    plens = np.array([9, 5, 7, 3], np.int32)
    forced = rng.integers(1, jc.vocab_size, (4, 4)).astype(np.int32)

    def port(quantized):
        eng = HeteroPipelineEngine(tp, tc, batch=4, cache_len=16,
                                   num_r_workers=2, num_microbatches=2,
                                   quantized_kv=quantized, paged_kv=True,
                                   device="cpu")
        try:
            return _static(
                eng, lambda e: [e.load_prefill(
                    m, torch.from_numpy(toks[2 * m:2 * m + 2]),
                    torch.from_numpy(plens[2 * m:2 * m + 2]))
                    for m in range(2)],
                lambda e, t: e.decode_step([torch.from_numpy(x) for x in t]),
                forced, plens)
        finally:
            eng.close()

    TQK.plain_calls.reset()
    q8 = port(True)
    # one attention layer x 2 micro-batches x 2 workers x 4 steps
    assert TQK.plain_calls.value == 1 * 2 * 2 * 4
    fp = port(False)
    err = float(np.abs(q8 - fp).max())
    assert 0.0 < err < QUANT_BOUND
    jeng = JH.HeteroPipelineEngine(jp, jc, batch=4, cache_len=16,
                                   num_r_workers=2, num_microbatches=2,
                                   quantized_kv=True, paged_kv=True)
    try:
        want = _static(
            jeng, lambda e: [e.load_prefill(
                m, jnp.asarray(toks[2 * m:2 * m + 2]),
                jnp.asarray(plens[2 * m:2 * m + 2])) for m in range(2)],
            lambda e, t: e.decode_step([jnp.asarray(x) for x in t]),
            forced, plens)
    finally:
        jeng.close()
    np.testing.assert_allclose(q8, want, atol=LOGIT_TOL, rtol=0)


# ---------------------------------------------------------------------------
# fleet: migration, failover, the wire format
# ---------------------------------------------------------------------------
def _serve8(tp, tc, spec, on_step=None, **kw):
    eng = ServingEngine(tp, tc, batch=8, cache_len=48, device="cpu",
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


def _wire(eng):
    out = {}
    for lk in sorted({k for w in eng.engine.workers for k in w.state}):
        parts = [w.export_rows(lk, np.arange(w.hi - w.lo))
                 for w in eng.engine.workers]
        out[lk] = {k: np.concatenate([p[k] for p in parts])
                   for k in parts[0]}
    return out


@pytest.fixture(scope="module")
def fleet_setup():
    jc, tc, jp, tp = _setup("recurrentgemma-2b")
    spec = random_spec(np.random.default_rng(11), jc, 8, spread=4)
    want, _ = _serve8(tp, tc, spec, paged_kv=True, page_size=4)
    return tc, tp, spec, want


@pytest.mark.parametrize("storage", ["paged", "int8"])
def test_migration_round_trip_is_bitwise_and_token_exact(fleet_setup,
                                                         storage):
    """Mid-serve, the hybrid's rows (h, the int8 or fp windowed slabs)
    move to an uneven split and back: every payload is bit for bit what
    it was, and the tokens are the uninterrupted serve's."""
    tc, tp, spec, want = fleet_setup
    kw = (dict(paged_kv=True, page_size=4) if storage == "paged"
          else dict(quantized_kv=True))
    moved = []

    def migrate(eng):
        if eng.step_idx == 5:
            before = _wire(eng)
            assert any(set(p) == {"h"} for p in before.values())
            moved.append(eng.engine.apply_partition([(0, 3), (3, 4)]))
            moved.append(eng.engine.apply_partition([(0, 2), (2, 4)]))
            after = _wire(eng)
            for lk in before:
                for k, v in before[lk].items():
                    assert after[lk][k].tobytes() == v.tobytes(), (lk, k)

    got, eng = _serve8(tp, tc, spec, on_step=migrate, **kw)
    assert moved == [2, 2]
    if storage == "int8":
        want, _ = _serve8(tp, tc, spec, **kw)
    assert got == want
    assert eng.engine.topology_changes == 2


@pytest.mark.parametrize("mode", ["reprefill", "snapshot"])
def test_failover_is_token_exact(fleet_setup, mode):
    """Kill an R-worker between steps: its rows (recurrent h included)
    are re-prefilled from zero state on the survivor, or restored from
    the current snapshot's wire payloads; every request finishes with the
    uninterrupted serve's tokens."""
    tc, tp, spec, want = fleet_setup
    fleet = FleetManager(uniform_fleet(2), recovery=mode,
                         snapshot_interval=1 if mode == "snapshot" else 0)

    def kill(eng):
        if eng.step_idx == 6:
            w = eng.engine.workers[1]
            w.kill()
            w.join(timeout=10)

    got, eng = _serve8(tp, tc, spec, on_step=kill, paged_kv=True,
                       page_size=4, fleet=fleet)
    assert got == want
    rec = fleet.telemetry.events_of("recovery")[0].detail
    assert rec["mode"] == mode and (rec["replayed"] > 0) == (
        mode == "reprefill")
    assert len(eng.engine.workers) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_export_rows_of_h_bitwise_equals_jax(arch):
    """Both packages' workers hold the same recurrent rows: the wire
    payload ({h}, fp32) is equal byte for byte; and ``zero_r_state``
    gives ``repro``'s filler layer by layer."""
    jc, tc, jp, tp = _setup(arch)
    rng = np.random.default_rng(7)
    st = JM._block_state(jc, jc.layer_pattern[0], 3, 16)
    h = rng.standard_normal(st["h"].shape).astype(np.float32)
    jw = JH.RWorker(0, jc, 0, 3, paged=True, page_size=4)
    tw = RWorker(0, tc, 0, 3, paged=True, page_size=4, device="cpu")
    jw.load_state(5, {"h": jnp.asarray(h)})
    tw.load_state(5, {"h": torch.from_numpy(h.copy())})
    rows = np.array([2, 0])
    want, got = jw.export_rows(5, rows), tw.export_rows(5, rows)
    assert sorted(got) == sorted(want) == ["h"]
    assert got["h"].dtype == np.float32
    assert got["h"].tobytes() == np.asarray(want["h"]).tobytes()
    assert not tw.paged_keys
    jeng = JH.HeteroPipelineEngine(jp, jc, batch=4, cache_len=16,
                                   num_r_workers=2, num_microbatches=2,
                                   quantized_kv=True)
    teng = HeteroPipelineEngine(tp, tc, batch=4, cache_len=16,
                                num_r_workers=2, num_microbatches=2,
                                quantized_kv=True, device="cpu")
    try:
        jz, tz = jeng.zero_r_state(), teng.zero_r_state()
        assert len(jz) == len(tz) == tc.num_layers
        for a, b in zip(jz, tz):
            assert sorted(a) == sorted(b)
            for k in a:
                w = np.asarray(a[k])
                assert b[k].dtype == w.dtype and b[k].tobytes() \
                    == w.tobytes(), k
    finally:
        jeng.close()
        teng.close()


# ---------------------------------------------------------------------------
# admission schedules, from_plan, observability
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(admission="sls", target_len=20,
                                     interval=2),
                                dict(admission="loadctl", target_len=20,
                                     interval=2),
                                dict(observability=True)],
                         ids=["sls", "loadctl", "obs"])
def test_admissions_and_observability_keep_the_tokens(rserve, kw):
    """With no KV bytes in mamba2's R-state, SLS and the load controller
    still admit by resident length; greedy tokens stay the oracle's."""
    _, _, tc, _, tp, spec, want = rserve
    assert _trace(tp, tc, spec, **HETERO, **kw) == want


def test_from_plan_builds_and_serves(rserve):
    _, _, tc, _, tp, spec, want = rserve
    eng = ServingEngine.from_plan(tp, tc, seq_len=48, max_batch=4,
                                  backend="hetero", paged_kv=True,
                                  page_size=4, device="cpu")
    try:
        assert eng.plan["batch"] >= 1 and eng.plan["workers"] >= 1
        for i, (p, n, _) in enumerate(spec[:3]):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=n))
        while eng.queue or any(s is not None for s in eng.slots):
            eng.step()
            assert eng.step_idx < 100
        assert {r.rid: list(r.generated) for r in eng.finished} \
            == {i: want[i] for i in range(3)}
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# the static-batch API
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_static_api_matches_jax_on_both_engines(arch):
    """load_prefill per micro-batch, then greedy steps through the fused
    decode_step and the legacy step (alternating on one engine, built
    with profile_timing=True) and the colocated engine: the tokens and
    logits of ``repro``'s engines."""
    jc, tc, jp, tp = _setup(arch)
    rng = np.random.default_rng(8)
    toks = rng.integers(1, jc.vocab_size, (4, 9)).astype(np.int32)
    plens = np.array([9, 5, 7, 3], np.int32)
    first = toks[np.arange(4), plens - 1][:, None]

    def greedy(step, n=4):
        tok, outs = first, []
        for i in range(n):
            lg = np.asarray(step(i, tok), np.float32)
            outs.append(lg)
            tok = lg.argmax(-1)[:, None].astype(np.int32)
        return np.stack(outs)

    jeng = JH.HeteroPipelineEngine(jp, jc, batch=4, cache_len=16,
                                   num_r_workers=2, num_microbatches=2,
                                   paged_kv=True)
    try:
        for m in range(2):
            jeng.load_prefill(m, jnp.asarray(toks[2 * m:2 * m + 2]),
                              jnp.asarray(plens[2 * m:2 * m + 2]))
        want = greedy(lambda i, t: np.concatenate([np.asarray(x) for x in
                                                   jeng.decode_step(
            [jnp.asarray(t[:2]), jnp.asarray(t[2:])])]))
    finally:
        jeng.close()
    teng = HeteroPipelineEngine(tp, tc, batch=4, cache_len=16,
                                num_r_workers=2, num_microbatches=2,
                                paged_kv=True, profile_timing=True,
                                device="cpu")
    T = torch.from_numpy
    try:
        for m in range(2):
            teng.load_prefill(m, T(toks[2 * m:2 * m + 2]),
                              T(plens[2 * m:2 * m + 2]))

        def step(i, t):
            fn = teng.decode_step_legacy if i % 2 else teng.decode_step
            return torch.cat(fn([T(t[:2]), T(t[2:])])).numpy()
        got = greedy(step)
        assert all(b > 0 for b in teng.worker_busy_times())
    finally:
        teng.close()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
    col = ColocatedEngine(tp, tc, batch=4, cache_len=16, device="cpu")
    col.load_prefill(T(toks), T(plens))
    np.testing.assert_allclose(
        greedy(lambda i, t: col.decode_step(T(t)).numpy()), want,
        atol=LOGIT_TOL, rtol=0)
