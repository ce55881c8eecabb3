"""The port's ServingEngine against the JAX oracle
``conftest.serve_trace`` on the same weights and the same trace: the
greedy {rid: tokens} must be equal (hetero paged, hetero dense, hetero
int8 dense and paged, and colocated; OoO and FIFO; reduced qwen3-8b and,
with tied embeddings, granite-3-8b), the paged and int8
R-Parts must run on every layer of every step (counted), int8 logits
must follow the JAX engine's teacher-forced, and admission must behave
like the reference's."""
import dataclasses
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from conftest import random_spec, serve_trace, tiny_cfg
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.request import Request as JRequest
from repro_torch import bridge
from repro_torch.core.config import ModelConfig
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import quant_kv as TQK
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one intra-op thread, and the suite's
    other workers (timing-sensitive chaos tests among them) keep the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def serve_trace_torch(params, cfg, spec, batch=4, cache_len=48,
                      max_steps=400, **kw):
    """The port's twin of conftest.serve_trace; returns ({rid: tokens},
    decode steps run)."""
    eng = ServingEngine(params, cfg, batch=batch, cache_len=cache_len,
                        device="cpu", **kw)
    try:
        qi = 0
        order = sorted(range(len(spec)), key=lambda i: spec[i][2])
        while (qi < len(order) or eng.queue
               or any(s is not None for s in eng.slots)) \
                and eng.step_idx < max_steps:
            while qi < len(order) and spec[order[qi]][2] <= eng.step_idx:
                i = order[qi]
                eng.submit(Request(rid=i, prompt=spec[i][0],
                                   max_new_tokens=spec[i][1]))
                qi += 1
            eng.step()
        return {r.rid: list(r.generated) for r in eng.finished}, eng.step_idx
    finally:
        eng.close()


@pytest.fixture(scope="module")
def setup():
    jc = dataclasses.replace(tiny_cfg("qwen3-8b"), num_kv_heads=2)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    spec = random_spec(np.random.default_rng(1), jc, 8)
    return jc, tc, jp, tp, spec, serve_trace(jp, jc, spec)


PORT_KW = {
    "hetero-paged-ooo": dict(backend="hetero", paged_kv=True, page_size=4),
    "hetero-paged-fifo": dict(backend="hetero", paged_kv=True, page_size=4,
                              schedule="fifo"),
    "hetero-dense": dict(backend="hetero"),
    "colocated": dict(backend="colocated"),
    "hetero-int8": dict(backend="hetero", quantized_kv=True),
    "hetero-paged-int8": dict(backend="hetero", quantized_kv=True,
                              paged_kv=True, page_size=4),
}


@pytest.fixture(scope="module")
def jax_int8_traces(setup):
    """JAX's serve_trace with quantized_kv=True, per int8 mode (int8
    storage rounds K/V, so its oracle is the JAX int8 engine, not the fp
    colocated one)."""
    jc, _, jp, _, spec, _ = setup
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = serve_trace(jp, jc, spec, **PORT_KW[mode])
        return cache[mode]
    return get


@pytest.mark.parametrize("mode", sorted(PORT_KW))
def test_port_serving_matches_jax_oracle(setup, jax_int8_traces, mode):
    jc, tc, jp, tp, spec, want = setup
    kw = PORT_KW[mode]
    int8 = kw.get("quantized_kv", False)
    paged = kw.get("paged_kv", False)
    if int8:
        want = jax_int8_traces(mode)
    TPA.plain_calls.reset()
    TQK.plain_calls.reset()
    got, steps = serve_trace_torch(tp, tc, spec, **kw)
    assert got == want
    # counted proof of the path: the paged (fp) or int8 R-Part ran on
    # every layer of every step, for both micro-batches and both R-workers
    n = tc.num_layers * 2 * 2 * steps
    assert TPA.plain_calls.value == (n if paged and not int8 else 0)
    assert TQK.plain_calls.value == (n if int8 else 0)


@pytest.fixture(scope="module")
def granite_setup():
    """Reduced granite-3-8b: tied embeddings, so every logit the engines
    sample from comes through embed.T (no lm_head in either package)."""
    jc = dataclasses.replace(tiny_cfg("granite-3-8b"), num_kv_heads=2)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jax.random.PRNGKey(4), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    spec = random_spec(np.random.default_rng(6), jc, 8)
    return tc, tp, spec, serve_trace(jp, jc, spec)


@pytest.mark.parametrize("mode", ["colocated", "hetero-dense",
                                  "hetero-paged-ooo"])
def test_granite_serving_matches_jax_oracle(granite_setup, mode):
    tc, tp, spec, want = granite_setup
    assert tc.tie_embeddings and "lm_head" not in tp
    got, _ = serve_trace_torch(tp, tc, spec, **PORT_KW[mode])
    assert got == want and len(want) == len(spec)


def _teacher_forced_logits(eng, reqs, forced=None):
    """Serve ``reqs`` (all submitted at step 0) recording the logits of
    every sampling call (prefill and decode) of the engine; with
    ``forced`` (a list of token arrays, one per sampling call) the engine
    is fed those tokens instead of its own argmax."""
    logs, toks = [], []
    orig = eng._sample_tokens

    def sample(logits, *rest):
        logs.append(np.asarray(logits, np.float32).copy())
        out = orig(logits, *rest)
        if forced is not None:
            out = np.array(forced[len(toks)], dtype=out.dtype)
        toks.append(out)
        return out
    eng._sample_tokens = sample
    try:
        for r in reqs:
            eng.submit(r)
        while eng.queue or any(s is not None for s in eng.slots):
            eng.step()
            assert eng.step_idx < 200
    finally:
        eng.close()
    return logs, toks


# port-int8 vs JAX-int8 logits, fp32, teacher-forced on JAX's tokens.  The
# int8 storage is bit-identical unless one K/V element lands on an exact
# .5 rounding boundary in one framework and not the other (their fp32
# projections differ by ~1e-7), so the difference is fp32 summation order:
# 2.4e-7 measured at this spec.  One flipped int8 level moves one element
# by one scale step (amax/127); all the quantization errors of a run
# together move these logits by 1.5e-3 against the fp engine (measured),
# so one flip stays well inside 1e-3, while a wrong mask, scale or slot
# moves logits by O(0.1).
INT8_LOGIT_TOL = 1e-3
QUANT_BOUND = 0.5    # int8 vs fp colocated, as tests/test_hetero.py holds


@pytest.mark.parametrize("mode", ["hetero-int8", "hetero-paged-int8"])
def test_port_int8_logits_follow_jax_teacher_forced(setup, mode):
    jc, tc, jp, tp, spec, _ = setup
    kw = dict(batch=4, cache_len=48, **PORT_KW[mode])
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=n)
             for i, (p, n, _) in enumerate(spec[:4])]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=n)
             for i, (p, n, _) in enumerate(spec[:4])]
    jlogs, jtoks = _teacher_forced_logits(JServingEngine(jp, jc, **kw),
                                          jreqs)
    tlogs, _ = _teacher_forced_logits(
        ServingEngine(tp, tc, device="cpu", **kw), treqs, forced=jtoks)
    flogs, _ = _teacher_forced_logits(
        ServingEngine(tp, tc, device="cpu", batch=4, cache_len=48),
        [Request(rid=i, prompt=p, max_new_tokens=n)
         for i, (p, n, _) in enumerate(spec[:4])], forced=jtoks)
    assert len(tlogs) == len(jlogs) == len(flogs) > 4
    # rows of a prefill call beyond its requests are padding
    for jl, tl, fl in zip(jlogs, tlogs, flogs):
        n = min(len(jl), len(tl))
        assert np.abs(tl[:n] - jl[:n]).max() <= INT8_LOGIT_TOL
        assert np.abs(tl[:n] - fl[:n]).max() <= QUANT_BOUND


@pytest.mark.parametrize("schedule", ["ooo", "fifo"])
def test_port_hetero_equals_port_colocated(schedule):
    cfg = ModelConfig(**dataclasses.asdict(tiny_cfg("llama-7b")))
    params = bridge.params_from_numpy(
        jax.tree.map(np.asarray,
                     JM.init_params(jax.random.PRNGKey(2),
                                    tiny_cfg("llama-7b"))), cfg, "cpu")
    spec = random_spec(np.random.default_rng(3), cfg, 10, p_hi=20,
                       max_new=7, spread=6)
    col, _ = serve_trace_torch(params, cfg, spec, batch=4, cache_len=40)
    het, _ = serve_trace_torch(params, cfg, spec, batch=4, cache_len=40,
                               backend="hetero", paged_kv=True,
                               page_size=4, schedule=schedule)
    assert het == col and len(col) == len(spec)


def test_paged_admission_cap_and_errors_like_reference(setup):
    """Small pools: the page budget holds requests back exactly as the
    reference engine's does (same slots, same admissions per step), a
    request over cache_len or over a whole pool is refused at submit."""
    jc, tc, jp, tp, _, _ = setup
    # one R-worker: each (worker, micro-batch) pool of 5 pages serves two
    # rows, and a request needs 3-5 pages over its life
    kw = dict(batch=4, cache_len=24, backend="hetero", num_r_workers=1,
              paged_kv=True, page_size=4, pages_per_worker=5)
    jeng = JServingEngine(jp, jc, **kw)
    teng = ServingEngine(tp, tc, device="cpu", **kw)
    try:
        rng = np.random.default_rng(5)
        for i in range(6):
            p = rng.integers(1, jc.vocab_size,
                             int(rng.integers(3, 12))).astype(np.int32)
            jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=6))
            teng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        for name, eng, req in (("jax", jeng, JRequest), ("port", teng,
                                                         Request)):
            with pytest.raises(ValueError, match="exceeds cache_len"):
                eng.submit(req(rid=90, prompt=np.arange(1, 20,
                                                        dtype=np.int32),
                               max_new_tokens=6))
            with pytest.raises(ValueError, match="raise pages_per_worker"):
                eng.submit(req(rid=91, prompt=np.arange(1, 23,
                                                        dtype=np.int32),
                               max_new_tokens=2))
        while jeng.queue or any(s is not None for s in jeng.slots):
            jr, tr = jeng.step(), teng.step()
            assert tr.admitted == jr.admitted, jeng.step_idx
            assert [getattr(s, "rid", None) for s in teng.slots] == \
                [getattr(s, "rid", None) for s in jeng.slots]
        assert {r.rid: r.generated for r in teng.finished} == \
            {r.rid: r.generated for r in jeng.finished}
        assert teng.records[0].admitted < 4      # the page budget held back
    finally:
        jeng.close()
        teng.close()


def test_not_ported_options_raise():
    tc = ModelConfig(**dataclasses.asdict(tiny_cfg("llama-7b")))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingEngine({}, tc, batch=2, cache_len=8, device="cpu",
                      fleet=4)
    # int8 storage, chunked prefill, speculative decoding, sampling, the
    # prefix cache, tiering and preemption are ported (their own test
    # files): they are taken, with the rest still refused beside them
    with pytest.raises(NotImplementedError, match="chaos"):
        ServingEngine({}, tc, batch=2, cache_len=8, device="cpu",
                      quantized_kv=True, chaos=True)
    with pytest.raises(NotImplementedError, match="observability"):
        ServingEngine({}, tc, batch=2, cache_len=8, device="cpu",
                      backend="hetero", prefill_chunk=4, paged_kv=True,
                      prefix_cache=True, kv_tiering=True, preempt_after=2,
                      observability=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingEngine({}, tc, batch=2, cache_len=8, device="cpu",
                      admission="sls")
    with pytest.raises(TypeError):
        ServingEngine({}, tc, batch=2, cache_len=8, device="cpu",
                      no_such_option=1)
    # the host tier's fault injection waits for the chaos harness
    from repro_torch.serving.paged_cache import HostTier
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        HostTier(chaos=object())


def test_serving_engine_refuses_cuda_without_it(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    _, tc, _, tp, _, _ = setup
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(tp, tc, batch=2, cache_len=8, backend="hetero")


def test_default_device_names_the_current_card(monkeypatch):
    """Entry points resolve "cuda" (and no device) to an indexed device:
    each R-worker thread passes it to torch.cuda.set_device, which refuses
    a device without an index."""
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    for dev in (None, "cuda", torch.device("cuda")):
        assert resolve_device(dev) == torch.device("cuda", 3)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_threads_stress_keeps_tokens_and_counts():
    """Shared state under thread pressure: 4 R-workers (one row each) with
    a 1 µs interpreter switch interval must still give the colocated
    tokens, and the launch counter the R-workers share must count every
    paged call exactly."""
    jc = dataclasses.replace(tiny_cfg("qwen3-8b", layers=2), num_kv_heads=2)
    cfg = ModelConfig(**dataclasses.asdict(jc))
    params = bridge.params_from_numpy(
        jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(7), jc)),
        cfg, "cpu")
    spec = random_spec(np.random.default_rng(8), cfg, 10, max_new=6,
                       spread=4)
    col, _ = serve_trace_torch(params, cfg, spec, batch=8, cache_len=32)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        TPA.plain_calls.reset()
        het, steps = serve_trace_torch(params, cfg, spec, batch=8,
                                       cache_len=32, backend="hetero",
                                       num_r_workers=4, paged_kv=True,
                                       page_size=4)
        assert het == col
        assert TPA.plain_calls.value == cfg.num_layers * 2 * 4 * steps
        counter = TPA.LaunchCounter()
        threads = [threading.Thread(
            target=lambda: [counter.add() for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert counter.value == 16 * 2000
    finally:
        sys.setswitchinterval(old)
