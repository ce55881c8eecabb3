"""KV tiering and preemption in the port against the JAX package (the
port's twins of test_equiv_matrix.py::
test_parked_and_restored_matches_uninterrupted and of serve_trace's
``preempt_at`` / the engine's ``preempt_after``):

* a request preempted mid-decode and resumed emits the tokens of one that
  never left residency: parked and restored through the prefix index on
  paged storage with tiering (fp32 and int8 pages), dropped and
  re-prefilled on dense storage; OoO and FIFO;
* ``preempt_at`` preempting running and mid-chunked-prefill rows: the
  JAX engine's tokens under the same preemptions;
* ``preempt_after`` with a pool cut so admission stalls: repro's tokens,
  fp32 and int8 pages, with and without speculative decoding, with
  preemptions, swap-outs and restores (their traffic is not repro's: the
  port holds the pages an admission chose while its later probes run,
  see ``test_admission_holds_the_pages_it_chose``);
* the fault that hold repairs (found by chip_smoke's equiv_prefix, in
  the JAX engine as in the port before it): under pool pressure a later
  request's probe swapped out or evicted pages an earlier request of the
  same admission then adopted, after they were reused;
* bf16 pages: a preempted, swapped-out and restored serve equals the
  uninterrupted one (the host round trip is bit-exact).
fp32 on the CPU unless said."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import STORAGE_KW, serve_trace, tiny_cfg
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.engine import SpecConfig as JSpecConfig
from repro.serving.request import Request as JRequest
from repro_torch import bridge
from repro_torch.core.config import ModelConfig
from repro_torch.serving import paged_cache as TPC
from repro_torch.serving.engine import ServingEngine, SpecConfig
from repro_torch.serving.paged_cache import HostTier, TierConfig
from repro_torch.serving.request import Request


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drive(eng, spec, req_cls, preempt_at=None):
    """serve_trace's loop for either package; returns ({rid: tokens},
    tiering stats or None)."""
    try:
        qi = 0
        order = sorted(range(len(spec)), key=lambda i: spec[i][2])
        while (qi < len(order) or eng.queue
               or any(s is not None for s in eng.slots)) \
                and eng.step_idx < 400:
            while qi < len(order) and spec[order[qi]][2] <= eng.step_idx:
                i = order[qi]
                eng.submit(req_cls(rid=i, prompt=spec[i][0],
                                   max_new_tokens=spec[i][1]))
                qi += 1
            for rid in (preempt_at or {}).get(eng.step_idx, ()):
                assert eng.preempt(rid), (eng.step_idx, rid)
            eng.step()
        stats = dict(eng.tiering_stats()) if eng.kv_tier is not None \
            else None
        return {r.rid: list(r.generated) for r in eng.finished}, stats
    finally:
        eng.close()


def _port(m, spec, preempt_at=None, **kw):
    kw = dict(dict(batch=4, cache_len=48), **kw)
    return _drive(ServingEngine(m["tp"], m["tc"], device="cpu", **kw),
                  spec, Request, preempt_at)


def _jax(m, spec, preempt_at=None, **kw):
    kw = dict(dict(batch=4, cache_len=48), **kw)
    return _drive(JServingEngine(m["jp"], m["jc"], **kw), spec, JRequest,
                  preempt_at)


@pytest.fixture(scope="module")
def park_setup():
    jc = tiny_cfg("granite-3-8b")
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    npp = jax.tree.map(np.asarray, jp)
    tp = bridge.params_from_numpy(npp, tc, "cpu")
    rng = np.random.default_rng(21)
    # rid 0 is the victim: long generation, provably mid-flight at the
    # preemption step on every backend/schedule combination
    spec = [
        (rng.integers(1, jc.vocab_size, 9).astype(np.int32), 10, 0),
        (rng.integers(1, jc.vocab_size, 6).astype(np.int32), 5, 1),
        (rng.integers(1, jc.vocab_size, 12).astype(np.int32), 6, 2),
        (rng.integers(1, jc.vocab_size, 5).astype(np.int32), 4, 4),
    ]
    oracle = serve_trace(jp, jc, spec, backend="colocated")
    assert len(oracle) == len(spec)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, npp=npp, spec=spec,
                oracle=oracle)


PARK_MATRIX = [(s, sched) for s in ("dense", "paged", "int8")
               for sched in ("ooo", "fifo")]
PARK_MATRIX += [("paged-int8", "ooo")]


@pytest.mark.parametrize("storage,schedule", PARK_MATRIX)
def test_parked_and_restored_matches_uninterrupted(park_setup, storage,
                                                   schedule):
    """A request preempted mid-conversation and resumed emits the tokens
    of one that never left residency (the JAX test's oracle): parked and
    readopted through the prefix index on paged storage with tiering,
    dropped and re-prefilled on dense storage."""
    m = park_setup
    kw = dict(STORAGE_KW[storage])
    if kw.get("paged_kv"):
        kw["kv_tiering"] = True
    got, stats = _port(m, m["spec"], preempt_at={3: [0]}, backend="hetero",
                       num_r_workers=2, schedule=schedule, **kw)
    assert got == m["oracle"]
    if stats is not None:
        assert stats["preemptions_count"] == 1


def test_preempt_at_matches_serve_trace(park_setup):
    """Preemptions of a running row and of a row mid-chunked-prefill
    (prefill_chunk=3), paged with tiering: the JAX engine's tokens and
    tier traffic under the same ``preempt_at``."""
    m = park_setup
    kw = dict(backend="hetero", num_r_workers=2, prefill_chunk=3,
              kv_tiering=True, **STORAGE_KW["paged"])
    at = {2: [0], 3: [2], 5: [1, 0]}
    want, jst = _jax(m, m["spec"], preempt_at=at, **kw)
    got, tst = _port(m, m["spec"], preempt_at=at, **kw)
    assert got == want == m["oracle"]
    assert {k: v for k, v in tst.items() if not k.endswith("_copy_s")} \
        == jst
    assert tst["preemptions_count"] == 4


@pytest.fixture(scope="module")
def pressure_setup(park_setup):
    """Six requests of 6-11 prompt and 8-13 new tokens on a pool of 8
    pages of 4 tokens per (worker, micro-batch): admission stalls, and
    ``preempt_after=2`` parks rows whose pages the ladder then swaps out
    and a later probe restores."""
    m = dict(park_setup)
    rng = np.random.default_rng(5)
    m["spec"] = [(rng.integers(1, m["jc"].vocab_size,
                               int(rng.integers(6, 12))).astype(np.int32),
                  int(rng.integers(8, 14)), int(rng.integers(0, 4)))
                 for _ in range(6)]
    m["oracle"] = serve_trace(m["jp"], m["jc"], m["spec"],
                              backend="colocated")
    return m


PRESSURE = {"paged": {}, "paged-int8": dict(quantized_kv=True),
            "paged-spec": dict(spec_k=2)}


@pytest.mark.parametrize("name", sorted(PRESSURE))
def test_preempt_after_matches_serve_trace(pressure_setup, name):
    m = pressure_setup
    extra = dict(PRESSURE[name])
    k = extra.pop("spec_k", 0)
    jextra = dict(extra, spec_decode=JSpecConfig(k=k)) if k else extra
    textra = dict(extra, spec_decode=SpecConfig(k=k)) if k else extra
    kw = dict(backend="hetero", num_r_workers=1, paged_kv=True,
              page_size=4, pages_per_worker=8, kv_tiering=True,
              preempt_after=2, cache_len=32)
    want, _ = _jax(m, m["spec"], **kw, **jextra)
    got, tst = _port(m, m["spec"], **kw, **textra)
    assert got == want
    if not extra:
        assert got == m["oracle"]
    assert tst["preemptions_count"] >= 1
    assert tst["swap_out_count"] >= 1 and tst["restore_count"] >= 1
    assert tst["corrupt_count"] == 0
    assert tst["swap_in_bytes"] * tst["swap_out_count"] \
        == tst["swap_out_bytes"] * tst["restore_count"]   # whole pages
    # the port's real copies were made (and timed)
    assert tst["swap_out_copy_s"] > 0 and tst["restore_copy_s"] > 0


def test_bf16_pages_swap_and_restore_bit_exact(park_setup):
    """bf16 storage: preempted and swapped-out rows restore their pages
    bit for bit, so the serve equals an uninterrupted one with a pool
    large enough for everything (the port against itself: the JAX
    package's bf16 rounding is not the port's)."""
    m = dict(park_setup)
    tc = dataclasses.replace(m["tc"], dtype="bfloat16")
    m["tc"] = tc
    m["tp"] = bridge.params_from_numpy(m["npp"], tc, "cpu",
                                       dtype=torch.bfloat16)
    rng = np.random.default_rng(5)
    spec = [(rng.integers(1, tc.vocab_size,
                          int(rng.integers(6, 12))).astype(np.int32),
             int(rng.integers(8, 14)), int(rng.integers(0, 4)))
            for _ in range(6)]
    base = dict(backend="hetero", num_r_workers=1, paged_kv=True,
                page_size=4, cache_len=32)
    want, _ = _port(m, spec, **base)
    tier = HostTier(TierConfig(dram_pages=4))   # spills to "disk" too
    got, st = _port(m, spec, pages_per_worker=8, kv_tiering=tier,
                    preempt_after=2, **base)
    assert got == want
    assert st["restore_count"] >= 1 and st["spill_count"] >= 1
    assert st["preemptions_count"] >= 1


def test_admission_holds_the_pages_it_chose():
    """The allocator side: pages held for an admission stay off the
    eviction ladder.  Two parked chains fill a pool of 4 pages; chain A
    is probed (as ``_choose_rows`` probes) and held, and the next
    allocation must swap out chain B's pages although A's are the oldest
    parked; released, A's are the ladder's first choice again."""
    tier = HostTier()
    a = TPC.PagedAllocator(2, 4, 4, 4, prefix_cache=True, tier=tier,
                           device="cpu")
    pool = {"k": torch.arange(4 * 4, dtype=torch.float32).reshape(4, 4)}
    a.pool_reader = lambda: {0: pool}
    chain_a = np.arange(1, 9, dtype=np.int32)
    chain_b = np.arange(101, 109, dtype=np.int32)
    for row, toks in ((0, chain_a), (1, chain_b)):
        a.admit(row, 8)
        assert a.park_row(row, toks)
    ids_a, cached = a.probe_prefix(chain_a, restore=True)
    assert cached == 8 and not a.take_restores() and not a.free
    ids_b = [p for p in a.parked if p not in ids_a]
    a.hold(ids_a)
    a.admit(0, 8)
    assert sorted(a.tables[0][:2]) == sorted(ids_b)
    assert a.probe_prefix(chain_a) == (ids_a, 8)     # still A's pages
    a.release_holds()
    a.release(0)
    assert a.free and tier.stats["swapped_out"] == 2


def test_admission_holds_the_pages_it_chose_in_a_serve():
    """The engine side, on the trace that exposed the fault: six requests
    of 40-89 prompt and 20-29 new tokens, one R-worker (two rows per
    pool), pools of 10 pages of 16, preempt_after=2 (23 preemptions).  The
    tokens must equal the colocated oracle's.  (The JAX engine's differ
    here: two of its admissions adopt pages that a later probe of the
    same admission had just reused.)"""
    jc = dataclasses.replace(tiny_cfg("qwen3-8b", layers=2, d_model=64,
                                      vocab=512), num_kv_heads=2)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    m = dict(jc=jc, tc=tc, jp=jp, tp=bridge.params_from_numpy(
        jax.tree.map(np.asarray, jp), tc, "cpu"))
    rng = np.random.default_rng(2)
    spec = [(rng.integers(1, jc.vocab_size, int(rng.integers(40, 91)))
             .astype(np.int32), int(rng.integers(20, 31)), 0)
            for _ in range(6)]
    kw = dict(batch=4, cache_len=256, backend="hetero", num_r_workers=1,
              paged_kv=True, page_size=16)
    oracle = serve_trace(jp, jc, spec, batch=4, cache_len=256,
                         backend="colocated")
    got, st = _port(m, spec, kv_tiering=True, preempt_after=2,
                    pages_per_worker=10, **kw)
    assert got == oracle
    assert st["preemptions_count"] >= 10 and st["restore_count"] >= 1
