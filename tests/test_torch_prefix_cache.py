"""The port's shared-prefix KV reuse against the JAX package:

* the host side, op for op: one op sequence (admit, probe, adopt,
  ensure_lengths, append_chunk, truncate, release, park, register) under
  eviction and swap-out pressure drives repro's ``PagedAllocator`` +
  ``HostTier`` and the port's; after every op the block tables, lengths,
  refcounts, free list, prefix index, LRU and parked order, pins, the
  clones and restores each op produced, the host tier (entries, order,
  stats) and the page pools (clones and restores applied) are exactly
  equal.  Driven by hypothesis and by a seeded fuzz;
* the device side: ``clone_pool_pages`` / ``restore_pool_pages`` write in
  place (every pool tensor keeps its ``data_ptr``: the R-Part graphs
  baked it) and give repro's bytes, int8 scales included; an int8 page
  swapped out and restored comes back bit for bit;
* ``kv_cache.shared_prefix_bytes_saved`` equals repro's;
* serving: ``prefix_cache=True`` on the port gives ``conftest.
  serve_trace``'s tokens (JAX) and the port's prefix-off tokens, on
  reduced qwen3-8b and granite-3-8b, paged and paged-int8, monolithic
  and chunked, with repro's hit counters; the option checks match
  repro's.
fp32 on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from conftest import STORAGE_KW, serve_trace, tiny_cfg
from repro.models import model as JM
from repro.serving import kv_cache as JKV
from repro.serving import paged_cache as JPC
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.request import Request as JRequest
from repro_torch import bridge
from repro_torch.core.config import ModelConfig
from repro_torch.serving import kv_cache as TKV
from repro_torch.serving import paged_cache as TPC
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request

ROWS, PAGES, PAGE, MAXP = 4, 14, 4, 5
CAP = MAXP * PAGE
_BASE = np.arange(1, 2 * CAP + 1, dtype=np.int32)
# prompt families sharing pairwise prefixes, so chains collide and the
# first-writer-wins paths fire
FAMILIES = [
    _BASE,
    np.concatenate([_BASE[:8], 1000 + _BASE[8:]]),
    np.concatenate([_BASE[:14], 2000 + _BASE[14:]]),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Twin:
    """repro's allocator + host tier and the port's, driven by the same
    ops.  Each owns a two-array 'pool' (distinct bytes per page) behind
    its ``pool_reader``; clones and restores are applied to it the way a
    worker applies them (repro functionally, the port in place)."""

    def __init__(self, dram_pages=0):
        self.j = JPC.PagedAllocator(
            ROWS, PAGES, PAGE, MAXP, prefix_cache=True,
            tier=JPC.HostTier(JPC.TierConfig(dram_pages=dram_pages)))
        self.t = TPC.PagedAllocator(
            ROWS, PAGES, PAGE, MAXP, prefix_cache=True,
            tier=TPC.HostTier(TPC.TierConfig(dram_pages=dram_pages)),
            device="cpu")
        base = np.arange(PAGES * PAGE * 2, dtype=np.float32).reshape(
            PAGES, PAGE, 2)
        self.jpool = {"k": jnp.asarray(base),
                      "s": jnp.asarray(-base[..., 0])}
        self.tpool = {"k": torch.from_numpy(base.copy()),
                      "s": torch.from_numpy(-base[..., 0].copy())}
        self.ptrs = {k: v.data_ptr() for k, v in self.tpool.items()}
        self.j.pool_reader = lambda: {0: self.jpool}
        self.t.pool_reader = lambda: {0: self.tpool}
        self.fam = [None] * ROWS

    def both(self, name, *args):
        """Call ``name`` on both allocators: equal results, or both raise
        MemoryError (returns None then)."""
        out = []
        for a in (self.j, self.t):
            try:
                out.append(getattr(a, name)(*args))
            except MemoryError:
                out.append(MemoryError)
        assert (out[0] is MemoryError) == (out[1] is MemoryError), \
            (name, out)
        if out[0] is MemoryError:
            return None
        assert out[0] == out[1], (name, out)
        return out[0]

    def _clones(self):
        cj, ct = self.j.take_clones(), self.t.take_clones()
        assert cj == ct
        if cj:
            self.jpool = JPC.clone_pool_pages(self.jpool, cj)
            TPC.clone_pool_pages(self.tpool, ct)

    def _restores(self):
        rj, rt = self.j.take_restores(), self.t.take_restores()
        assert [p for _, p in rj] == [p for _, p in rt]
        for (ej, _), (et, _) in zip(rj, rt):
            assert ej.digests == et.digests and ej.tier == et.tier
            for name in ej.payload[0]:
                np.testing.assert_array_equal(
                    et.payload[0][name].numpy(), ej.payload[0][name])
        if rj:
            self.jpool = JPC.restore_pool_pages(self.jpool, rj, 0)
            TPC.restore_pool_pages(self.tpool, rt, 0)

    # -- ops -----------------------------------------------------------------
    def admit(self, row, fam, length):
        if self.both("admit", row, length) is None:
            self.fam[row] = None
            return
        self.fam[row] = fam if length else None
        if length:
            self.both("register_prefix", row, FAMILIES[fam][:length])

    def release(self, row):
        self.both("release", row)
        self.fam[row] = None

    def park(self, row):
        fam = self.fam[row] if self.fam[row] is not None else 0
        self.both("park_row", row,
                  FAMILIES[fam][:int(self.j.lengths[row])])
        self.fam[row] = None

    def decode_grow(self, mask):
        new = np.minimum(self.j.lengths + 1, CAP + 3)
        self.both("ensure_lengths", new.copy(), np.asarray(mask, bool))
        self._clones()

    def append_chunk(self, row, cnt):
        base = np.zeros((ROWS,), np.int64)
        counts = np.zeros((ROWS,), np.int64)
        base[row] = int(self.j.lengths[row])
        counts[row] = cnt
        if base[row] == 0 and self.fam[row] is None:
            self.fam[row] = 0
        if base[row] + cnt > CAP:
            return
        self.both("append_chunk", base, counts)
        self._clones()

    def truncate(self, row, new_len):
        self.both("truncate", row, new_len)

    def register(self, row):
        fam = self.fam[row] if self.fam[row] is not None else 0
        self.both("register_prefix", row,
                  FAMILIES[fam][:int(self.j.lengths[row])])

    def probe(self, fam, want, restore):
        self.both("probe_prefix", FAMILIES[fam][:want], restore)
        self._restores()

    def adopt(self, row, fam, want):
        """Admission through the cache, as the engine does it: probe with
        restores (drained and applied), adopt the clamped prefix, stream
        the suffix as one chunk, register the prompt."""
        tokens = FAMILIES[fam][:want]
        ids, cached = self.both("probe_prefix", tokens, True)
        self._restores()
        eff = min(cached, want - 1)
        if eff <= 0:
            return
        self.both("adopt_prefix", row, ids[:-(-eff // PAGE)], eff)
        self.fam[row] = fam
        base = np.zeros((ROWS,), np.int64)
        counts = np.zeros((ROWS,), np.int64)
        base[row], counts[row] = eff, want - eff
        self.both("append_chunk", base, counts)
        self._clones()
        self.both("register_prefix", row, tokens)

    # -- equality ------------------------------------------------------------
    def check(self):
        j, t = self.j, self.t
        for name in ("tables", "lengths", "active", "frozen", "refcount"):
            np.testing.assert_array_equal(getattr(t, name),
                                          getattr(j, name), err_msg=name)
        assert t.free == j.free
        assert t.prefix.entries == j.prefix.entries
        assert t.prefix.page_digests == j.prefix.page_digests
        assert list(t.prefix.lru) == list(j.prefix.lru)
        assert list(t.parked) == list(j.parked)
        assert t._pinned == j._pinned
        for fn in ("used_pages", "cached_pages", "parked_pages",
                   "free_pages", "available_pages", "shared_pages",
                   "resident_tokens"):
            assert getattr(t, fn)() == getattr(j, fn)(), fn
        tt, jt = t.tier, j.tier
        assert list(tt.entries) == list(jt.entries)
        assert [e.tier for e in tt.entries.values()] \
            == [e.tier for e in jt.entries.values()]
        assert tt.stats == jt.stats
        assert tt.swapped_pages() == jt.swapped_pages()
        assert tt.nbytes() == jt.nbytes()
        for name in self.jpool:
            np.testing.assert_array_equal(self.tpool[name].numpy(),
                                          np.asarray(self.jpool[name]))
            assert self.tpool[name].data_ptr() == self.ptrs[name]


def _run_ops(ops, dram_pages=0):
    tw = Twin(dram_pages)
    for op in ops:
        kind = op[0] % 10
        row = op[1] % ROWS
        fam = op[2] % len(FAMILIES)
        length = 1 + op[3] % CAP
        if kind == 0:
            tw.admit(row, fam, length)
        elif kind == 1:
            tw.release(row)
        elif kind == 2:
            tw.park(row)
        elif kind == 3:
            tw.decode_grow([bool((op[3] >> i) & 1) for i in range(ROWS)])
        elif kind == 4:
            tw.append_chunk(row, 1 + op[3] % (2 * PAGE))
        elif kind == 5:
            tw.adopt(row, fam, length)
        elif kind == 6:
            tw.truncate(row, op[3] % (CAP + 1))
        elif kind == 7:
            tw.register(row)
        else:
            tw.probe(fam, length, kind == 8)
        tw.check()
    return tw


_op = st.tuples(st.integers(0, 9), st.integers(0, ROWS - 1),
                st.integers(0, 2), st.integers(0, CAP - 1))


@settings(max_examples=120, deadline=None)
@given(st.lists(_op, min_size=1, max_size=40), st.sampled_from([0, 2]))
def test_allocator_and_tier_equal_repro_op_for_op(ops, dram_pages):
    _run_ops(ops, dram_pages)


@pytest.mark.parametrize("seed,dram_pages", [(0, 0), (1, 0), (2, 2),
                                             (3, 1)])
def test_allocator_and_tier_equal_repro_seeded_fuzz(seed, dram_pages):
    """The same op vocabulary from a seeded generator, long sequences;
    the run must reach swap-outs, restores and clones."""
    r = np.random.default_rng(seed)
    ops = [tuple(int(x) for x in (r.integers(0, 10), r.integers(0, ROWS),
                                  r.integers(0, 3), r.integers(0, CAP)))
           for _ in range(250)]
    tw = _run_ops(ops, dram_pages)
    stt = tw.t.tier.stats
    assert stt["swapped_out"] > 0 and stt["restored"] > 0


# ---------------------------------------------------------------------------
# the device side: in place, repro's bytes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quantized", [False, True])
def test_clone_and_restore_write_in_place(quantized):
    r = np.random.default_rng(3)
    pool = TPC.init_page_pool(6, 4, 2, 8, device="cpu", quantized=quantized)
    for v in pool.values():                 # distinct bytes per page
        if v.dtype == torch.int8:
            v.copy_(torch.from_numpy(r.integers(-127, 128, v.shape,
                                                dtype=np.int8)))
        else:
            v.copy_(torch.from_numpy(r.standard_normal(v.shape).astype(
                np.float32)))
    ptrs = {k: v.data_ptr() for k, v in pool.items()}
    jpool = {k: jnp.asarray(v.numpy()) for k, v in pool.items()}
    clones = [(0, 3), (2, 5)]
    assert TPC.clone_pool_pages(pool, clones) is pool
    jpool = JPC.clone_pool_pages(jpool, clones)
    entries = [JPC.TierEntry(digests={b"a"}, payload={1: {
        k: np.asarray(v[1]) + 1 if v.dtype != jnp.int8
        else np.asarray(v[1]) // 2 for k, v in jpool.items()}}), ]
    tentries = [TPC.TierEntry(digests={b"a"}, payload={1: {
        k: torch.from_numpy(np.array(a)) for k, a in
        entries[0].payload[1].items()}})]
    TPC.restore_pool_pages(pool, [(tentries[0], 4)], 1)
    jpool = JPC.restore_pool_pages(jpool, [(entries[0], 4)], 1)
    # a layer the entry holds nothing of is untouched
    TPC.restore_pool_pages(pool, [(tentries[0], 0)], 7)
    for k, v in pool.items():
        assert v.data_ptr() == ptrs[k]
        np.testing.assert_array_equal(v.numpy(), np.asarray(jpool[k]))


def test_int8_page_swaps_out_and_restores_bit_exact():
    """An int8 pool's parked page, swapped out by the eviction ladder and
    restored by a probe, is bit-identical (values and scales)."""
    tier = TPC.HostTier()
    a = TPC.PagedAllocator(1, 2, 4, 2, prefix_cache=True, tier=tier,
                           device="cpu")
    pool = TPC.init_page_pool(2, 4, 2, 8, device="cpu", quantized=True)
    a.pool_reader = lambda: {0: pool}
    toks = np.arange(1, 9, dtype=np.int32)
    a.admit(0, 8)
    ids = [int(i) for i in a.tables[0][:2]]
    r = np.random.default_rng(0)
    for v in pool.values():
        src = (r.integers(-127, 128, v.shape, dtype=np.int8)
               if v.dtype == torch.int8
               else r.random(v.shape).astype(np.float32))
        v.copy_(torch.from_numpy(src))
    before = {k: v[ids].clone() for k, v in pool.items()}
    assert a.park_row(0, toks)
    a.admit(0, 8)               # takes both parked pages: two swap-outs
    assert tier.stats["swapped_out"] == 2 and a.parked_pages() == 0
    for v in pool.values():
        v.zero_()
    a.release(0)
    got, cached = a.probe_prefix(toks, restore=True)
    assert cached == 8 and tier.stats["restored"] == 2
    TPC.restore_pool_pages(pool, a.take_restores(), 0)
    for k, v in pool.items():
        assert torch.equal(v[got], before[k]), k
    assert tier.stats["bytes_in"] == tier.stats["bytes_out"]


def test_shared_prefix_bytes_saved_matches_jax():
    for arch, dtype in (("qwen3-8b", "float32"), ("granite-3-8b",
                                                  "bfloat16")):
        jc = dataclasses.replace(tiny_cfg(arch), dtype=dtype)
        tc = ModelConfig(**dataclasses.asdict(jc))
        for args in ((512, 12, 16), (20, 3, 4), (3, 5, 4), (64, 1, 16),
                     (17, 2, 16)):
            for q in (False, True):
                assert TKV.shared_prefix_bytes_saved(tc, *args, quantized=q) \
                    == JKV.shared_prefix_bytes_saved(jc, *args, quantized=q)


# ---------------------------------------------------------------------------
# serving with the prefix cache
# ---------------------------------------------------------------------------
def _shared_spec(cfg, seed):
    """Three requests sharing an 8-token (2-page) prefix, a later
    identical-prompt request (adopts the whole prompt, CoWs its partial
    tail page) and an unrelated one."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, cfg.vocab_size, 8).astype(np.int32)
    tail = rng.integers(1, cfg.vocab_size, 5).astype(np.int32)
    return [
        (np.concatenate([shared, tail]), 5, 0),
        (np.concatenate([shared, rng.integers(1, cfg.vocab_size, 3)
                         .astype(np.int32)]), 5, 2),
        (rng.integers(1, cfg.vocab_size, 7).astype(np.int32), 4, 3),
        (np.concatenate([shared, tail]), 3, 4),
        (np.concatenate([shared, rng.integers(1, cfg.vocab_size, 9)
                         .astype(np.int32)]), 4, 5),
    ]


@pytest.fixture(scope="module", params=["qwen3-8b", "granite-3-8b"])
def model(request):
    jc = tiny_cfg(request.param)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    spec = _shared_spec(jc, 7)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, spec=spec, traces={})


def _jax(m, name, **kw):
    """JAX serve_trace and prefix stats of the module's trace, once per
    option set."""
    if name not in m["traces"]:
        eng = JServingEngine(m["jp"], m["jc"], batch=4, cache_len=48, **kw)
        m["traces"][name] = _drive(eng, m["spec"], JRequest)
    return m["traces"][name]


def _drive(eng, spec, req_cls):
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
            eng.step()
        stats = (dict(eng.prefix_cache_stats()) if eng.prefix_cache
                 else None)
        return {r.rid: list(r.generated) for r in eng.finished}, stats
    finally:
        eng.close()


SERVES = {"paged": ("paged", 0), "paged-chunk4": ("paged", 4),
          "paged-int8": ("paged-int8", 0)}


@pytest.mark.parametrize("name", sorted(SERVES))
def test_prefix_cache_serve_matches_jax_and_prefix_off(model, name):
    storage, chunk = SERVES[name]
    kw = dict(backend="hetero", num_r_workers=1, prefill_chunk=chunk,
              **STORAGE_KW[storage])
    want, jstats = _jax(model, name, prefix_cache=True, **kw)
    eng = ServingEngine(model["tp"], model["tc"], batch=4, cache_len=48,
                        device="cpu", prefix_cache=True, **kw)
    got, tstats = _drive(eng, model["spec"], Request)
    off, _ = _drive(ServingEngine(model["tp"], model["tc"], batch=4,
                                  cache_len=48, device="cpu", **kw),
                    model["spec"], Request)
    assert got == want == off and len(got) == len(model["spec"])
    assert tstats == jstats
    assert tstats["hits_count"] >= 1 and tstats["cached_tokens"] >= 8
    if storage == "paged":
        # greedy fp32 with the cache == the colocated oracle (JAX)
        assert got == serve_trace(model["jp"], model["jc"], model["spec"],
                                  backend="colocated")


def test_prefix_cache_requires_paged_pure_attention():
    tc = ModelConfig(**dataclasses.asdict(tiny_cfg("qwen3-8b")))
    with pytest.raises(ValueError, match="paged_kv=True"):
        ServingEngine({}, tc, batch=2, cache_len=8, device="cpu",
                      backend="hetero", prefix_cache=True)
    with pytest.raises(ValueError, match="paged_kv=True"):
        ServingEngine({}, tc, batch=2, cache_len=8, device="cpu",
                      prefix_cache=True, paged_kv=True)
    with pytest.raises(ValueError, match="kv_tiering"):
        ServingEngine({}, tc, batch=2, cache_len=8, device="cpu",
                      backend="hetero", kv_tiering=True)
    windowed = dataclasses.replace(tc, window=4)
    with pytest.raises(ValueError, match="pure self-attention"):
        ServingEngine({}, windowed, batch=2, cache_len=8, device="cpu",
                      backend="hetero", paged_kv=True, prefix_cache=True)
