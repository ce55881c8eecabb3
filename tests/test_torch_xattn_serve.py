"""Cross-attention and the encoder-decoder through the port's static-batch
entry points (``load_prefill(..., enc_feats=...)`` + ``decode_step``,
``decode_step_legacy``, ``profile_timing``), against the JAX package's
engines on the same weights and numpy inputs: llama-3.2-vision-90b and
whisper-medium, tiny fp32 configs with seeded non-zero gates
(``test_torch_xattn.setup_xattn``).

* hetero == colocated at 1 and 2 R-workers, each against ``repro``'s
  engine, within 2e-4 (twin of ``tests/test_hetero.py``'s whisper case);
* whisper's ``paged_kv`` a no-op (twin of ``tests/test_paged_hetero.py::
  test_paged_noop_for_non_attention_arch``), vision paged and paged
  ``quantized_kv`` against ``repro``'s engines;
* the fused step == the legacy step == ``profile_timing``; every
  cross-attention R-Part goes through kernel 2's wrapper (its plain
  version here);
* what is refused, each beside a test that shows ``repro`` failing
  there: whisper with ``quantized_kv`` (``repro``: ``WorkerStepError`` at
  the first decode step) and ``ServingEngine`` on both archs
  (``repro``: ``AttributeError`` at the first ``step()``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hetero import ColocatedEngine as JColocated
from repro.core.hetero import HeteroPipelineEngine as JHetero
from repro.core.hetero import WorkerStepError as JWorkerStepError
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.request import Request as JRequest
from repro_torch.core.hetero import ColocatedEngine, HeteroPipelineEngine
from repro_torch.kernels import decode_attention as DA
from repro_torch.serving.engine import ServingEngine
from test_torch_xattn import feats_for, setup_xattn

B, S, GEN = 4, 12, 5
TOL = 2e-4          # as tests/test_hetero.py
ARCHS = ("whisper-medium", "llama-3.2-vision-90b")
_SETUPS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch):
    """(JAX cfg, port cfg, JAX params, port params, tokens, features); the
    vision arch at 5 layers (one period: 4 ATTN, 1 XATTN)."""
    if arch not in _SETUPS:
        jc, tc, jp, tp = setup_xattn(
            arch, layers=5 if arch == "llama-3.2-vision-90b" else 3)
        toks = np.random.default_rng(11).integers(
            0, jc.vocab_size, (B, S + GEN)).astype(np.int32)
        _SETUPS[arch] = (jc, tc, jp, tp, toks, feats_for(jc, B, 12))
    return _SETUPS[arch]


def _run(eng, toks, feats, colocated=False, legacy=False, jax_side=False):
    """load_prefill (per micro-batch on a hetero engine), then GEN steps
    teacher-forced on ``toks``; the logits of each step [GEN, B, V]."""
    T = jnp.asarray if jax_side else torch.from_numpy
    h = B // 2
    plens = np.full((B,), S, np.int32)
    if colocated:
        eng.load_prefill(T(toks[:, :S]), T(plens), enc_feats=T(feats))
    else:
        for m in range(2):
            sl = slice(m * h, (m + 1) * h)
            eng.load_prefill(m, T(toks[sl, :S]), T(plens[sl]),
                             enc_feats=T(feats[sl]))
    out = []
    for t in range(GEN):
        tok = toks[:, S + t:S + t + 1]
        if colocated:
            lg = eng.decode_step(T(tok))
        else:
            fn = eng.decode_step_legacy if legacy else eng.decode_step
            lg = np.concatenate([np.asarray(x) for x in fn(
                [T(tok[:h]), T(tok[h:])])])
        out.append(np.asarray(lg, np.float32))
    return np.stack(out)


def _hetero(arch, workers, jax_side=False, **kw):
    jc, tc, jp, tp, toks, feats = _setup(arch)
    if jax_side:
        eng = JHetero(jp, jc, batch=B, cache_len=S + GEN,
                      num_r_workers=workers, num_microbatches=2, kv_chunk=8,
                      **kw)
    else:
        eng = HeteroPipelineEngine(tp, tc, batch=B, cache_len=S + GEN,
                                   num_r_workers=workers,
                                   num_microbatches=2, kv_chunk=8,
                                   device="cpu", **kw)
    return eng


def _served(arch, workers, jax_side=False, legacy=False, **kw):
    eng = _hetero(arch, workers, jax_side, **kw)
    toks, feats = _setup(arch)[4:]
    try:
        return _run(eng, toks, feats, legacy=legacy, jax_side=jax_side), eng
    finally:
        eng.close()


def _colocated(arch, jax_side=False):
    jc, tc, jp, tp, toks, feats = _setup(arch)
    if jax_side:
        eng = JColocated(jp, jc, batch=B, cache_len=S + GEN)
    else:
        eng = ColocatedEngine(tp, tc, batch=B, cache_len=S + GEN,
                              device="cpu")
    return _run(eng, toks, feats, colocated=True, jax_side=jax_side)


def _diff(a, b):
    return float(np.abs(a - b).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_colocated_matches_jax(arch):
    assert _diff(_colocated(arch), _colocated(arch, jax_side=True)) < TOL


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_hetero_matches_colocated_and_jax(arch, workers):
    """The port's hetero engine against its colocated engine and against
    ``repro``'s hetero engine; every cross-attention R-Part went through
    kernel 2's wrapper: (XATTN layers + DEC_XATTN phases 1) x micro-batches
    x workers x steps plain calls."""
    jc = _setup(arch)[0]
    DA.plain_calls.reset()
    got, _ = _served(arch, workers)
    n_cross = sum(k in ("xattn", "dec_xattn") for k in jc.pattern)
    assert DA.plain_calls.value == n_cross * 2 * workers * GEN
    assert _diff(got, _colocated(arch)) < TOL
    want, _ = _served(arch, workers, jax_side=True)
    assert _diff(got, want) < TOL


def test_whisper_paged_kv_is_a_noop():
    """Twin of ``tests/test_paged_hetero.py::test_paged_noop_for_non_
    attention_arch``: the DEC_XATTN slabs (self-attention cache beside
    the cross K/V) stay dense under paged_kv, no page pool is built, and
    the logits are bit for bit the dense ones (and ``repro``'s paged
    run's within tolerance)."""
    dense, _ = _served("whisper-medium", 2)
    paged, eng = _served("whisper-medium", 2, paged_kv=True)
    assert all(not w.paged_keys and not w.allocators for w in eng.workers)
    np.testing.assert_array_equal(paged, dense)
    want, _ = _served("whisper-medium", 2, jax_side=True, paged_kv=True)
    assert _diff(paged, want) < TOL


@pytest.mark.parametrize("quantized", [False, True])
def test_vision_paged_matches_jax(quantized):
    """llama-3.2-vision-90b with paged_kv: its ATTN layers paged (bf16 or
    int8 pools), its XATTN layer's static slab dense, against ``repro``'s
    engine with the same storage."""
    got, eng = _served("llama-3.2-vision-90b", 2, paged_kv=True,
                       quantized_kv=quantized)
    n_attn = _setup("llama-3.2-vision-90b")[0].pattern.count("attn")
    for w in eng.workers:
        assert len(w.paged_keys) == 2 * n_attn
        assert all(set(st) == {"xk", "xv"} for lk, st in w.state.items()
                   if lk not in w.paged_keys)
    want, _ = _served("llama-3.2-vision-90b", 2, jax_side=True,
                      paged_kv=True, quantized_kv=quantized)
    assert _diff(got, want) < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_equals_legacy_and_profile_timing(arch):
    """The fused (graph-body) step, the legacy step (eager, FIFO, fan-in
    by concatenation) and the fused step with profile_timing chain the
    same phases and give the same logits; the legacy and fused steps
    alternate on one engine."""
    fused, _ = _served(arch, 2)
    legacy, _ = _served(arch, 2, legacy=True)
    timed, eng = _served(arch, 2, profile_timing=True)
    np.testing.assert_allclose(legacy, fused, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(timed, fused)
    assert eng.step_stats["steps"] == GEN
    eng = _hetero(arch, 2)
    toks, feats = _setup(arch)[4:]
    try:
        h = B // 2
        for m in range(2):
            sl = slice(m * h, (m + 1) * h)
            eng.load_prefill(m, torch.from_numpy(toks[sl, :S]),
                             torch.full((h,), S), enc_feats=torch.from_numpy(
                                 feats[sl]))
        for t in range(GEN):
            tok = torch.from_numpy(toks[:, S + t:S + t + 1])
            fn = eng.decode_step_legacy if t % 2 else eng.decode_step
            lg = torch.cat(fn([tok[:h], tok[h:]])).numpy()
            np.testing.assert_allclose(lg, fused[t], atol=1e-6, rtol=0)
    finally:
        eng.close()


def test_whisper_quantized_kv_is_refused():
    jc, tc, jp, tp, _, _ = _setup("whisper-medium")
    with pytest.raises(ValueError, match="quantized_kv"):
        HeteroPipelineEngine(tp, tc, batch=B, cache_len=S + GEN,
                             quantized_kv=True, device="cpu")
    # vision keeps it (its ATTN layers are the int8 ones): above


def test_jax_whisper_quantized_kv_fails_at_the_first_step():
    """Why the port refuses it: ``repro`` quantizes the DEC_XATTN state's
    k / v and then runs the plain self-attention phase on a state with
    no k."""
    jc, _, jp, _, toks, feats = _setup("whisper-medium")
    eng = JHetero(jp, jc, batch=B, cache_len=S + GEN, num_r_workers=2,
                  num_microbatches=2, quantized_kv=True)
    try:
        h = B // 2
        for m in range(2):
            sl = slice(m * h, (m + 1) * h)
            eng.load_prefill(m, jnp.asarray(toks[sl, :S]),
                             jnp.full((h,), S, jnp.int32),
                             enc_feats=jnp.asarray(feats[sl]))
        tok = jnp.asarray(toks[:, S:S + 1])
        with pytest.raises(JWorkerStepError):
            eng.decode_step([tok[:h], tok[h:]])
    finally:
        eng.close()


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_engine_refuses_cross_attention_archs(arch):
    _, tc, _, tp, _, _ = _setup(arch)
    for backend in ("colocated", "hetero"):
        with pytest.raises(ValueError, match="static-batch API"):
            ServingEngine(tp, tc, batch=B, cache_len=32, backend=backend,
                          device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_serving_engine_fails_at_the_first_admission(arch):
    """Why the port refuses it: ``repro``'s ServingEngine builds, then its
    prefill at the first admission gets no features."""
    jc, _, jp, _, toks, _ = _setup(arch)
    eng = JServingEngine(jp, jc, batch=B, cache_len=32, backend="colocated")
    try:
        eng.submit(JRequest(rid=0, prompt=toks[0, :S], max_new_tokens=2))
        with pytest.raises(AttributeError):
            eng.step()
    finally:
        eng.close()


@pytest.mark.parametrize("arch", ARCHS)
def test_static_api_refusals(arch):
    """load_prefill needs the features; chunk work is refused, as in
    ``repro``'s chunk mode."""
    eng = _hetero(arch, 1)
    try:
        with pytest.raises(ValueError, match="enc_feats"):
            eng.load_prefill(0, torch.ones((2, 4), dtype=torch.int32),
                             torch.full((2,), 4))
        with pytest.raises(NotImplementedError, match="cross-attention"):
            eng.queue_prefill_chunk(0, [0], np.ones((1, 4), np.int32), [0],
                                    [4])
    finally:
        eng.close()
