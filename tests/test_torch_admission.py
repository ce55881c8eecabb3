"""The port's admission schedules and ``from_plan`` against the JAX
engine on the same weights and the same trace (reduced llama-7b and
qwen3-8b): ``sls`` and ``loadctl`` admit the same number of requests at
every step, hold the same resident length after every step and give the
same greedy tokens, on dense, paged and colocated storage, with the
paged admission cap binding before the policy, and with loadctl's
chunked-prefill delay and prefix-cache shift; ``from_plan`` sizes the
same batch and R-worker count and returns the same plan dict when
``hw_s`` / ``hw_r`` are passed, and defaults to the H100 profile."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import random_spec, tiny_cfg
from repro.core import perfmodel as JP
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.request import Request as JRequest
from repro_torch import bridge
from repro_torch.core import perfmodel as TP
from repro_torch.core.config import ModelConfig
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX config, port config, JAX params, port params), built
    on first use."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jc = tiny_cfg(arch)
            tc = ModelConfig(**dataclasses.asdict(jc))
            jp = JM.init_params(jax.random.PRNGKey(3), jc)
            tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                          "cpu")
            cache[arch] = (jc, tc, jp, tp)
        return cache[arch]
    return get


def _run(eng, R, spec, max_steps=300):
    """Serve (prompt, max_new, arrive) specs; returns ({rid: tokens},
    [(admitted, resident_len) per step])."""
    try:
        qi = 0
        order = sorted(range(len(spec)), key=lambda i: spec[i][2])
        while (qi < len(order) or eng.queue
               or any(s is not None for s in eng.slots)) \
                and eng.step_idx < max_steps:
            while qi < len(order) and spec[order[qi]][2] <= eng.step_idx:
                i = order[qi]
                eng.submit(R(rid=i, prompt=spec[i][0].copy(),
                             max_new_tokens=spec[i][1]))
                qi += 1
            eng.step()
        assert not eng.queue and all(s is None for s in eng.slots)
        return ({r.rid: [int(t) for t in r.generated] for r in eng.finished},
                [(rec.admitted, rec.resident_len) for rec in eng.records])
    finally:
        if eng.backend == "hetero":
            eng.close()


def _shared_prefix_spec(cfg, n=6, prefix=10):
    rng = np.random.default_rng(7)
    shared = rng.integers(1, cfg.vocab_size, prefix).astype(np.int32)
    return [(np.concatenate([shared, rng.integers(
        1, cfg.vocab_size, int(rng.integers(1, 6))).astype(np.int32)]),
        5, i // 2) for i in range(n)]


CASES = {
    "sls-dense": dict(backend="hetero", admission="sls", target_len=8,
                      interval=3),
    "sls-colocated": dict(admission="sls", target_len=6, interval=2),
    "sls-paged-chunked": dict(backend="hetero", paged_kv=True, page_size=4,
                              admission="sls", target_len=10, interval=2,
                              prefill_chunk=4),
    "loadctl-dense": dict(backend="hetero", admission="loadctl",
                          target_len=8, interval=2),
    "loadctl-colocated-tight": dict(admission="loadctl", target_len=5,
                                    interval=1, w_lim=30.0),
    # the page budget binds before the policy: loadctl records only the
    # admissions that happen
    "loadctl-paged-capped": dict(backend="hetero", paged_kv=True,
                                 page_size=4, pages_per_worker=12,
                                 admission="loadctl", target_len=6,
                                 interval=2, w_lim=60.0),
    # chunked prefill delays generation by d = ceil(max prompt / chunk)
    "loadctl-paged-chunked": dict(backend="hetero", paged_kv=True,
                                  page_size=4, prefill_chunk=3,
                                  admission="loadctl", target_len=6,
                                  interval=2, w_lim=45.0),
    # a prefix hit generates one step later: the one-step shift
    "loadctl-prefix": dict(backend="hetero", paged_kv=True, page_size=4,
                           prefix_cache=True, admission="loadctl",
                           target_len=6, interval=2, w_lim=50.0),
}


# each policy runs on both archs, each case on one of them
ARCH_OF = {case: ("llama-7b", "qwen3-8b")[i % 2]
           for i, case in enumerate(sorted(CASES))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_admission_matches_jax_engine(models, case):
    jc, tc, jp, tp = models(ARCH_OF[case])
    kw = CASES[case]
    if "prefix" in case:
        spec = _shared_prefix_spec(jc)
    else:
        spec = random_spec(np.random.default_rng(11), jc, 8, p_lo=3,
                           p_hi=16, max_new=5, spread=6)
    want, want_steps = _run(JServingEngine(jp, jc, batch=4, cache_len=48,
                                           **kw), JRequest, spec)
    got, got_steps = _run(ServingEngine(tp, tc, batch=4, cache_len=48,
                                        device="cpu", **kw), Request, spec)
    assert got_steps == want_steps
    assert got == want
    admitted = [a for a, _ in got_steps]
    assert sum(admitted) == len(spec)
    if kw["admission"] == "sls":
        f = kw["interval"]
        m = -(-4 * f // kw["target_len"])
        assert all(a == 0 or (s % f == 0 and a <= m)
                   for s, a in enumerate(admitted))
    # the policy really shaped the admissions: greedy admits otherwise
    greedy = {k: v for k, v in kw.items()
              if k not in ("admission", "target_len", "interval", "w_lim")}
    _, g_steps = _run(ServingEngine(tp, tc, batch=4, cache_len=48,
                                    device="cpu", **greedy), Request, spec)
    assert [a for a, _ in g_steps] != admitted


def test_loadctl_controller_state_matches(models):
    """After a loadctl serve the two controllers track the same
    micro-batches (the Algorithm 1 bookkeeping, op for op)."""
    jc, tc, jp, tp = models("qwen3-8b")
    kw = CASES["loadctl-paged-chunked"]
    spec = random_spec(np.random.default_rng(5), jc, 8, p_lo=3, p_hi=16,
                       max_new=5, spread=6)
    eng_j = JServingEngine(jp, jc, batch=4, cache_len=48, **kw)
    eng_t = ServingEngine(tp, tc, batch=4, cache_len=48, device="cpu", **kw)
    _run(eng_j, JRequest, spec)
    _run(eng_t, Request, spec)
    assert eng_t.load_ctl.w_lim == eng_j.load_ctl.w_lim
    assert [dataclasses.astuple(m) for m in eng_t.load_ctl.mbs] == \
        [dataclasses.astuple(m) for m in eng_j.load_ctl.mbs]


def test_loadctl_default_w_lim_is_eq6(models):
    _, tc, _, tp = models("llama-7b")
    eng = ServingEngine(tp, tc, batch=4, cache_len=48, device="cpu",
                        admission="loadctl", target_len=8, interval=2)
    assert eng.load_ctl.w_lim == 4 * (8 + 2) / 2.0
    assert eng.load_ctl.seq_len == 8
    with pytest.raises(ValueError, match="admission"):
        ServingEngine(tp, tc, batch=4, cache_len=48, device="cpu",
                      admission="fifo")


def _hw_pair(name):
    t = TP.HW[name]
    j = JP.HW.get(name) or JP.Hardware(*dataclasses.astuple(t))
    return j, t


PLAN_CASES = {
    "paged-h100": dict(hw="h100-sxm5-80gb", kw=dict(paged_kv=True,
                                                    page_size=4)),
    "dense-a10-xeon": dict(hw=("a10", "xeon-5218"), kw=dict()),
    "tpu-loadctl-prefix": dict(
        hw="tpu-v5e", kw=dict(paged_kv=True, page_size=4,
                              prefix_cache=True, prefix_hit_rate=0.5,
                              prefix_len=16, admission="loadctl",
                              target_len=8, interval=2)),
    "v100-spec-chunk-plan": dict(
        hw="v100", kw=dict(paged_kv=True, page_size=4, spec_k="plan",
                           spec_alpha=0.7, prefill_chunk="plan")),
    "slo-epyc": dict(hw=("a10", "epyc-7452"), kw=dict(latency_slo=0.05)),
}


@pytest.mark.parametrize("arch", ["llama-7b", "qwen3-8b"])
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_from_plan_matches_jax(models, arch, case):
    jc, tc, jp, tp = models(arch)
    c = PLAN_CASES[case]
    names = c["hw"] if isinstance(c["hw"], tuple) else (c["hw"], c["hw"])
    (js, ts), (jr, tr) = _hw_pair(names[0]), _hw_pair(names[1])
    common = dict(seq_len=48, max_batch=8, backend="hetero", **c["kw"])
    ej = JServingEngine.from_plan(jp, jc, hw_s=js, hw_r=jr, **common)
    try:
        et = ServingEngine.from_plan(tp, tc, hw_s=ts, hw_r=tr,
                                     device="cpu", **common)
        try:
            assert et.plan == ej.plan
            assert (et.batch, et.cache_len, len(et.engine.workers),
                    et.engine.slices, et.prefill_chunk) == \
                (ej.batch, ej.cache_len, len(ej.engine.workers),
                 ej.engine.slices, ej.prefill_chunk)
            assert (et.spec.k if et.spec else None) == \
                (ej.spec.k if ej.spec else None)
            assert (et.load_ctl.w_lim if et.load_ctl else None) == \
                (ej.load_ctl.w_lim if ej.load_ctl else None)
        finally:
            et.close()
    finally:
        ej.close()


def test_from_plan_defaults_to_h100_and_serves(models):
    """No hardware given: the port plans for the H100 (repro for its
    TPU); the plan equals repro's given the H100's fields, the drift
    monitor reads it, and the planned engine serves the JAX engine's
    tokens under loadctl with observability on."""
    jc, tc, jp, tp = models("qwen3-8b")
    common = dict(seq_len=48, max_batch=4, backend="hetero", paged_kv=True,
                  page_size=4, admission="loadctl", target_len=5,
                  interval=2)
    jh = JP.Hardware(*dataclasses.astuple(TP.GPU_H100))
    ej = JServingEngine.from_plan(jp, jc, hw_s=jh, hw_r=jh,
                                  observability=True, **common)
    et = ServingEngine.from_plan(tp, tc, device="cpu", observability=True,
                                 **common)
    try:
        assert et.plan == ej.plan == TP.plan(tc, TP.GPU_H100, TP.GPU_H100,
                                             seq_len=48, page=4)
        assert et.plan != TP.plan(tc, TP.TPU_V5E, TP.TPU_V5E, seq_len=48,
                                  page=4)
        assert et._obs_obj.drift.plan is et.plan
        spec = random_spec(np.random.default_rng(2), jc, 6, p_lo=3,
                           p_hi=12, max_new=4, spread=3)
        want = _run(ej, JRequest, spec)
        got = _run(et, Request, spec)
        assert got == want
    finally:
        et.close()
        ej.close()
