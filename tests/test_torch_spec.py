"""Speculative decoding in the port's ServingEngine against the JAX
package (the port's twin of
test_equiv_matrix.py::test_spec_decode_greedy_matches_colocated): greedy
tokens equal to the colocated spec-off oracle ``conftest.serve_trace``
for paged and dense storage, and to the JAX spec engine's on int8 and
paged-int8 storage (whose tokens need not be the fp oracle's), OoO and
FIFO, with self-speculation and with a separate (rejecting) drafter;
``spec_stats`` equal to the JAX spec engine's on the same trace, weights
and storage; the verify R-Part counted on every layer of every verify
work; and the in-place drafter holding,
after a draft, exactly the state a fresh prefill of the committed tokens
gives.  Tokens and counts compare exactly; logits within 1e-5 (fp32)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import random_spec, serve_trace, tiny_cfg
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.engine import SpecConfig as JSpecConfig
from repro.serving.request import Request as JRequest
from repro_torch import bridge
from repro_torch.core.config import ModelConfig
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import quant_kv as TQK
from repro_torch.models import model as TM
from repro_torch.serving.engine import ServingEngine, SpecConfig
from repro_torch.serving.request import Request

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _serve(eng, spec, req_cls, max_steps=400):
    """Drive ``eng`` over (prompt, max_new, arrive_step) specs; returns
    ({rid: tokens}, verify works run) — a step with no live row runs no
    verify."""
    works = 0
    try:
        qi = 0
        order = sorted(range(len(spec)), key=lambda i: spec[i][2])
        seen = getattr(eng.engine, "prefill_results", None)
        while (qi < len(order) or eng.queue
               or any(s is not None for s in eng.slots)) \
                and eng.step_idx < max_steps:
            while qi < len(order) and spec[order[qi]][2] <= eng.step_idx:
                i = order[qi]
                eng.submit(req_cls(rid=i, prompt=spec[i][0],
                                   max_new_tokens=spec[i][1]))
                qi += 1
            eng.step()
            res = getattr(eng.engine, "prefill_results", None)
            if res is not seen:
                seen = res
                works += sum(wk.verify for wk in res)
        return {r.rid: list(r.generated) for r in eng.finished}, works
    finally:
        eng.close()


@pytest.fixture(scope="module")
def setup():
    jc = dataclasses.replace(tiny_cfg("qwen3-8b"), num_kv_heads=2)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    # a separate one-layer drafter of other weights: it disagrees with the
    # target, so verify steps reject and roll KV back
    jdc = dataclasses.replace(jc, num_layers=1)
    tdc = ModelConfig(**dataclasses.asdict(jdc))
    jdp = JM.init_params(jax.random.PRNGKey(9), jdc)
    tdp = bridge.params_from_numpy(jax.tree.map(np.asarray, jdp), tdc, "cpu")
    spec = random_spec(np.random.default_rng(1), jc, 8, max_new=7)
    oracle = serve_trace(jp, jc, spec)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, jdc=jdc, tdc=tdc, jdp=jdp,
                tdp=tdp, spec=spec, oracle=oracle)


@pytest.fixture(scope="module")
def jax_spec_stats(setup):
    """The JAX spec engine's spec_stats with the separate drafter (its
    rejections make the counts informative; self-speculation in fp32
    accepts every draft, which the test checks directly)."""
    s = setup
    eng = JServingEngine(s["jp"], s["jc"], batch=4, cache_len=48,
                         backend="hetero", paged_kv=True, page_size=4,
                         spec_decode=JSpecConfig(k=3, draft_cfg=s["jdc"],
                                                 draft_params=s["jdp"]))
    got, _ = _serve(eng, s["spec"], JRequest)
    assert got == s["oracle"]
    return dict(eng.spec_stats)


STORAGE = {"paged": dict(paged_kv=True, page_size=4), "dense": {},
           "int8": dict(quantized_kv=True),
           "paged-int8": dict(paged_kv=True, page_size=4, quantized_kv=True)}


@pytest.fixture(scope="module")
def jax_int8_spec(setup):
    """The JAX spec engine with the separate drafter on an int8 storage:
    (tokens, spec_stats), made on first use per storage."""
    s, runs = setup, {}

    def run(storage):
        if storage not in runs:
            eng = JServingEngine(
                s["jp"], s["jc"], batch=4, cache_len=48, backend="hetero",
                spec_decode=JSpecConfig(k=3, draft_cfg=s["jdc"],
                                        draft_params=s["jdp"]),
                **STORAGE[storage])
            got, _ = _serve(eng, s["spec"], JRequest)
            runs[storage] = (got, dict(eng.spec_stats))
        return runs[storage]
    return run


@pytest.mark.parametrize("drafter", ["self", "separate"])
@pytest.mark.parametrize("schedule", ["ooo", "fifo"])
@pytest.mark.parametrize("storage", sorted(STORAGE))
def test_port_spec_serve_matches_colocated_oracle(setup, jax_spec_stats,
                                                  jax_int8_spec, storage,
                                                  schedule, drafter):
    s = setup
    draft = {} if drafter == "self" else dict(draft_cfg=s["tdc"],
                                              draft_params=s["tdp"])
    int8 = "quantized_kv" in STORAGE[storage]
    want, want_stats = (jax_int8_spec(storage) if int8
                        else (s["oracle"], jax_spec_stats))
    eng = ServingEngine(s["tp"], s["tc"], batch=4, cache_len=48,
                        backend="hetero", schedule=schedule, device="cpu",
                        spec_decode=SpecConfig(k=3, **draft),
                        **STORAGE[storage])
    for counter in (TPA.plain_calls, TPA.verify_plain_calls,
                    TQK.plain_calls, TQK.verify_plain_calls):
        counter.reset()
    got, works = _serve(eng, s["spec"], Request)
    assert got == want
    st = eng.spec_stats
    if drafter == "separate":
        assert st == want_stats
        # the rollback path really ran
        assert st["accepted_tokens"] < st["drafted_tokens"]
    elif int8:
        # the drafter keeps an fp cache, the target reads int8 K/V: their
        # argmaxes may part, so self-speculation may reject too
        assert 0 < st["accepted_tokens"] <= st["drafted_tokens"]
    else:
        assert st["accepted_tokens"] == st["drafted_tokens"] > 0
    # every layer of every verify work, on both R-workers, went through
    # the paged verify R-Part (the plain version of kernel 4, or of kernel
    # 3's multi-token entry, on the CPU); decode never ran
    paged = "paged_kv" in STORAGE[storage]
    assert works > 0
    calls = s["tc"].num_layers * 2 * works if paged else 0
    assert TPA.verify_plain_calls.value == (0 if int8 else calls)
    assert TQK.verify_plain_calls.value == (calls if int8 else 0)
    assert TPA.plain_calls.value == TQK.plain_calls.value == 0


def test_drafter_after_draft_equals_fresh_prefill(setup):
    """The drafter drafts IN PLACE (its KV of the drafted positions stays
    behind; only lengths are restored).  After a draft, and again after a
    commit that rejected drafts, the drafter's next logits for every live
    row equal those of a fresh prefill of the row's committed tokens plus
    its pending token: the stale draft entries are never read."""
    s = setup
    eng = ServingEngine(s["tp"], s["tc"], batch=4, cache_len=48,
                        backend="hetero", paged_kv=True, page_size=4,
                        device="cpu",
                        spec_decode=SpecConfig(k=3, draft_cfg=s["tdc"],
                                               draft_params=s["tdp"]))
    try:
        rng = np.random.default_rng(21)
        for i in range(3):
            eng.submit(Request(rid=i, prompt=rng.integers(
                1, s["tc"].vocab_size, 5 + 3 * i).astype(np.int32),
                max_new_tokens=12))
        for _ in range(3):
            eng.step()
            live = eng._spec_rows()
            assert live
            eng._spec_sync_rows(live)
            eng._spec_draft(live)
            st = eng._spec_state
            rows = [row for row, _ in live]
            feeds = [eng.slots[row].feed_tokens for row in rows]
            assert st["lengths"][rows].tolist() == \
                [len(f) - 1 for f in feeds]
            # a throwaway copy, so the engine's drafter is left as it was
            work = {"stack": {"s0": {k: v.clone() for k, v in
                                     st["stack"]["s0"].items()}},
                    "rem": [{k: v.clone() for k, v in r.items()}
                            for r in st["rem"]],
                    "lengths": st["lengths"].clone()}
            logits, _ = TM.decode_step(
                s["tdp"], s["tdc"], work,
                torch.from_numpy(eng._last_tok[:, None].copy()))
            n = max(len(f) for f in feeds)
            toks = np.zeros((len(rows), n), np.int32)
            for i, f in enumerate(feeds):
                toks[i, :len(f)] = f
            fresh, _ = TM.prefill(
                s["tdp"], s["tdc"], torch.from_numpy(toks),
                torch.tensor([len(f) for f in feeds], dtype=torch.int32),
                eng._spec_cache)
            np.testing.assert_allclose(logits[rows].numpy(), fresh.numpy(),
                                       atol=TOL, rtol=0)
    finally:
        eng.close()
    assert eng.spec_stats["accepted_tokens"] \
        < eng.spec_stats["drafted_tokens"]


def test_spec_refusals_like_reference(setup):
    s = setup
    tc, tp = s["tc"], s["tp"]
    with pytest.raises(ValueError, match="backend='hetero'"):
        ServingEngine(tp, tc, batch=2, cache_len=8, device="cpu",
                      spec_decode=SpecConfig(k=2))
    with pytest.raises(ValueError, match="k must be >= 1"):
        ServingEngine(tp, tc, batch=2, cache_len=8, device="cpu",
                      backend="hetero", spec_decode=SpecConfig(k=0))
    with pytest.raises(ValueError, match="BOTH draft_cfg"):
        ServingEngine(tp, tc, batch=2, cache_len=8, device="cpu",
                      backend="hetero",
                      spec_decode=SpecConfig(k=2, draft_cfg=tc))
    eng = ServingEngine(tp, tc, batch=2, cache_len=16, device="cpu",
                        backend="hetero", num_r_workers=1,
                        spec_decode=SpecConfig(k=2))
    try:
        prompt = np.arange(1, 9, dtype=np.int32)
        eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=8))
        with pytest.raises(ValueError, match="speculative decoding rolls"):
            eng.submit(Request(rid=1, prompt=prompt, max_new_tokens=9))
        done = eng.run(max_steps=40)
        assert [len(r.generated) for r in done] == [8]
        # a plain (prefill) chunk is chunk work too: from offset 0 it runs
        # in a chunk-only step and returns the row's last-valid logits,
        # those of a whole-prompt prefill
        wk = eng.engine.queue_prefill_chunk(0, [0], [[5, 7, 2]], [0], [2])
        assert not wk.verify
        eng.engine.decode_step(None)
        assert eng.engine.prefill_results == [wk]
        want, _ = TM.prefill(tp, tc, torch.tensor([[5, 7]], dtype=torch.int32),
                             torch.tensor([2], dtype=torch.int32), 16)
        assert wk.logits.shape == (1, tc.vocab_size)
        np.testing.assert_allclose(wk.logits.numpy(), want.numpy(), atol=TOL,
                                   rtol=0)
    finally:
        eng.close()
