"""The engine-level static-batch API of the port (the calls every bench
of the paper's figures and ``examples/quickstart.py`` make) against the
JAX package on the same weights and inputs: ``load_prefill`` +
``decode_step`` of ``HeteroPipelineEngine`` (dense and paged, 1 and 2
R-workers, ``ooo`` and ``fifo``) and of ``ColocatedEngine``, the
pre-fusion ``decode_step_legacy`` (alone and alternated with the fused
step), ``reset_step_stats`` and ``profile_timing``.  fp32; greedy tokens
exact, logits within 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.core.hetero import ColocatedEngine as JColocated
from repro.core.hetero import HeteroPipelineEngine as JHetero
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.core.config import ModelConfig
from repro_torch.core.hetero import ColocatedEngine, HeteroPipelineEngine
from repro_torch.kernels import paged_attention as TPA

TOL = 1e-4
BATCH, NUM_MB, CACHE, GEN = 4, 2, 24, 5
MB = BATCH // NUM_MB


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one intra-op thread, and the suite's
    other workers keep the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """Reduced llama-13b (the paper's evaluation model) with GQA, its
    weights from the JAX package, and ragged right-padded prompts."""
    jc = dataclasses.replace(tiny_cfg("llama-13b"), num_kv_heads=2)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(1, jc.vocab_size, (BATCH, 9)).astype(np.int32)
    plens = np.array([9, 5, 7, 3], np.int32)
    return jc, tc, jp, tp, toks, plens


def _first_tokens(toks, plens):
    return toks[np.arange(len(plens)), plens - 1][:, None]


def _drive(eng, step, toks, plens, load):
    """load_prefill per micro-batch, then GEN greedy steps through
    ``step`` (a callable of the engine and the step index); returns the
    tokens [GEN, B] and logits [GEN, B, V]."""
    load(eng, toks, plens)
    tok = _first_tokens(toks, plens)
    out_t, out_l = [], []
    for i in range(GEN):
        ls = step(eng, i, [tok[m * MB:(m + 1) * MB] for m in range(NUM_MB)])
        logits = np.concatenate([np.asarray(x) for x in ls])
        tok = logits.argmax(-1)[:, None].astype(np.int32)
        out_t.append(tok[:, 0])
        out_l.append(logits)
    return np.stack(out_t), np.stack(out_l)


def _load_jax(eng, toks, plens):
    for m in range(NUM_MB):
        sl = slice(m * MB, (m + 1) * MB)
        eng.load_prefill(m, jnp.asarray(toks[sl]), jnp.asarray(plens[sl]))


def _load_port(eng, toks, plens):
    for m in range(NUM_MB):
        sl = slice(m * MB, (m + 1) * MB)
        eng.load_prefill(m, torch.from_numpy(toks[sl]),
                         torch.from_numpy(plens[sl]))


def _jax_step(eng, i, toks):
    return eng.decode_step([jnp.asarray(t) for t in toks])


def _fused(eng, i, toks):
    return eng.decode_step([torch.from_numpy(t) for t in toks])


def _legacy(eng, i, toks):
    return eng.decode_step_legacy([torch.from_numpy(t) for t in toks])


def _alternate(eng, i, toks):
    return (_fused if i % 2 else _legacy)(eng, i, toks)


@pytest.fixture(scope="module")
def jax_ref(setup):
    """repro's HeteroPipelineEngine, load_prefill + decode_step, per
    (storage, workers)."""
    jc, _, jp, _, toks, plens = setup
    cache = {}

    def get(paged, workers):
        if (paged, workers) not in cache:
            eng = JHetero(jp, jc, batch=BATCH, cache_len=CACHE,
                          num_r_workers=workers, num_microbatches=NUM_MB,
                          paged_kv=paged, page_size=4)
            try:
                cache[(paged, workers)] = _drive(eng, _jax_step, toks,
                                                 plens, _load_jax)
            finally:
                eng.close()
        return cache[(paged, workers)]
    return get


def _port(tp, tc, **kw):
    return HeteroPipelineEngine(tp, tc, batch=BATCH, cache_len=CACHE,
                                num_microbatches=NUM_MB, page_size=4,
                                device="cpu", **kw)


@pytest.mark.parametrize("schedule", ["ooo", "fifo"])
@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_load_prefill_decode_matches_jax(setup, jax_ref, paged, workers,
                                         schedule):
    """repro's quickstart path, twinned: equal greedy tokens, logits
    within 1e-4, and the paged R-Part on every layer of every step."""
    _, tc, _, tp, toks, plens = setup
    want_t, want_l = jax_ref(paged, workers)
    TPA.plain_calls.reset()
    eng = _port(tp, tc, num_r_workers=workers, paged_kv=paged,
                schedule=schedule)
    try:
        got_t, got_l = _drive(eng, _fused, toks, plens, _load_port)
    finally:
        eng.close()
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_allclose(got_l, want_l, atol=TOL, rtol=0)
    n = tc.num_layers * NUM_MB * workers * GEN
    assert TPA.plain_calls.value == (n if paged else 0)


@pytest.mark.parametrize("how", ["legacy", "alternated"])
@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_legacy_step_equals_fused(setup, jax_ref, paged, workers, how):
    """decode_step_legacy gives decode_step's tokens and logits, alone and
    alternated with the fused step on one engine; both follow repro."""
    _, tc, _, tp, toks, plens = setup
    want_t, want_l = jax_ref(paged, workers)
    step = _legacy if how == "legacy" else _alternate
    TPA.plain_calls.reset()
    eng = _port(tp, tc, num_r_workers=workers, paged_kv=paged)
    try:
        got_t, got_l = _drive(eng, step, toks, plens, _load_port)
        stats = dict(eng.step_stats)
    finally:
        eng.close()
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_allclose(got_l, want_l, atol=TOL, rtol=0)
    assert TPA.plain_calls.value == (
        tc.num_layers * NUM_MB * workers * GEN if paged else 0)
    assert stats["steps"] == GEN
    for k in ("dispatch_s", "collect_s", "s_dispatch_s", "r_wait_s",
              "step_s"):
        assert stats[k] >= 0.0, k


def test_legacy_stats_keys_match_jax(setup):
    """The legacy step reports repro's legacy keys, and reset_step_stats
    empties both stats dicts as repro's does."""
    jc, tc, jp, tp, toks, plens = setup
    jeng = JHetero(jp, jc, batch=BATCH, cache_len=CACHE, num_r_workers=1,
                   num_microbatches=NUM_MB)
    eng = _port(tp, tc, num_r_workers=1)
    try:
        _load_jax(jeng, toks, plens)
        _load_port(eng, toks, plens)
        tok = _first_tokens(toks, plens)
        jeng.decode_step_legacy([jnp.asarray(tok[:MB]),
                                 jnp.asarray(tok[MB:])])
        _legacy(eng, 0, [tok[:MB], tok[MB:]])
        assert set(eng.last_step_stats) == set(jeng.last_step_stats)
        assert set(eng.step_stats) == set(jeng.step_stats)
        jeng.reset_step_stats()
        eng.reset_step_stats()
        assert eng.step_stats == jeng.step_stats == {}
        assert eng.last_step_stats == jeng.last_step_stats == {}
        _fused(eng, 1, [tok[:MB], tok[MB:]])
        assert eng.step_stats["steps"] == 1.0
    finally:
        jeng.close()
        eng.close()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_profile_timing_same_tokens_positive_busy(setup, jax_ref, paged):
    _, tc, _, tp, toks, plens = setup
    want_t, want_l = jax_ref(paged, 2)
    eng = _port(tp, tc, num_r_workers=2, paged_kv=paged,
                profile_timing=True)
    try:
        assert all(w.profile_timing for w in eng.workers)
        got_t, got_l = _drive(eng, _alternate, toks, plens, _load_port)
        busy = eng.worker_busy_times()
    finally:
        eng.close()
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_allclose(got_l, want_l, atol=TOL, rtol=0)
    assert len(busy) == 2 and all(b > 0.0 for b in busy)


def test_colocated_load_prefill_matches_jax(setup):
    jc, tc, jp, tp, toks, plens = setup
    jeng = JColocated(jp, jc, batch=BATCH, cache_len=CACHE)
    jeng.load_prefill(jnp.asarray(toks), jnp.asarray(plens))
    eng = ColocatedEngine(tp, tc, batch=BATCH, cache_len=CACHE, device="cpu")
    eng.load_prefill(torch.from_numpy(toks), torch.from_numpy(plens))
    for k in ("k", "v"):
        np.testing.assert_allclose(eng.state["stack"]["s0"][k].numpy(),
                                   np.asarray(jeng.state["stack"]["s0"][k]),
                                   atol=TOL, rtol=0)
    tok = _first_tokens(toks, plens)
    jt = tt = tok
    for _ in range(GEN):
        jl = np.asarray(jeng.decode_step(jnp.asarray(jt)))
        tl = eng.decode_step(torch.from_numpy(tt)).numpy()
        np.testing.assert_allclose(tl, jl, atol=TOL, rtol=0)
        jt = jl.argmax(-1)[:, None].astype(np.int32)
        tt = tl.argmax(-1)[:, None].astype(np.int32)
        np.testing.assert_array_equal(tt, jt)


def test_hetero_equals_colocated_after_reload(setup):
    """A second load_prefill on an engine that has stepped (graphs
    captured, pages held) starts clean: its tokens equal a fresh
    ColocatedEngine's on the new prompts."""
    _, tc, _, tp, toks, plens = setup
    toks2 = np.roll(toks, 1, axis=1)
    plens2 = np.array([4, 8, 6, 9], np.int32)
    eng = _port(tp, tc, num_r_workers=2, paged_kv=True)
    ref = ColocatedEngine(tp, tc, batch=BATCH, cache_len=CACHE, device="cpu")
    try:
        _drive(eng, _fused, toks, plens, _load_port)
        got_t, got_l = _drive(eng, _fused, toks2, plens2, _load_port)
    finally:
        eng.close()

    def colo_step(e, i, t):
        return [e.decode_step(torch.from_numpy(np.concatenate(t)))]
    want_t, want_l = _drive(
        ref, colo_step, toks2, plens2,
        lambda e, t, p: e.load_prefill(torch.from_numpy(t),
                                       torch.from_numpy(p)))
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_allclose(got_l, want_l, atol=TOL, rtol=0)


def test_enc_feats_raises(setup):
    _, tc, _, tp, toks, plens = setup
    feats = torch.zeros((MB, 4, tc.d_model))
    eng = _port(tp, tc, num_r_workers=1)
    try:
        with pytest.raises(NotImplementedError, match="enc_feats"):
            eng.load_prefill(0, torch.from_numpy(toks[:MB]),
                             torch.from_numpy(plens[:MB]), enc_feats=feats)
    finally:
        eng.close()
    colo = ColocatedEngine(tp, tc, batch=BATCH, cache_len=CACHE,
                           device="cpu")
    with pytest.raises(NotImplementedError, match="enc_feats"):
        colo.load_prefill(torch.from_numpy(toks), torch.from_numpy(plens),
                          enc_feats=feats)


def test_load_prefill_rejects_a_wrong_row_count(setup):
    _, tc, _, tp, toks, plens = setup
    eng = _port(tp, tc, num_r_workers=1)
    try:
        with pytest.raises(ValueError, match="micro-batch"):
            eng.load_prefill(0, torch.from_numpy(toks),
                             torch.from_numpy(plens))
    finally:
        eng.close()
