"""The speculative-decode verify pieces of the port against the JAX
package: kernel 4's plain versions (paged and dense) against
repro.kernels.ref AND the Pallas ``_verify_kernel`` in interpret mode,
over the kernel phase's case grid of chip_smoke.py; T = 1 against the
decode plain version; the chunk pieces (``chunk_ring_plan``,
``model.prefill_chunk``, ``r_attention_chunk``, the paged verify R-Part
on fp and int8 pools),
the allocator's ``append_chunk``/``truncate`` and the greedy
``spec_accept``.  fp32 on the CPU; tolerance 1e-5 absolute (the same
fp32 online softmax in both packages, summed in another order), and
exact where no float arithmetic is involved (tables, slots, tokens)."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.core import decompose as JD
from repro.kernels import ops as JOPS
from repro.kernels import paged_attention as JPA
from repro.kernels import ref as JREF
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving import paged_cache as JPC
from repro.serving import sampler as JS
from repro_torch import bridge
from repro_torch.core import decompose as TD
from repro_torch.core.config import ModelConfig
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import ref as TREF
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving import paged_cache as TPC
from repro_torch.serving import sampler as TS

TOL = 1e-5
# jitted: the eager reference compiles its scan op by op on every call
_JREF_VERIFY = jax.jit(JREF.paged_verify_attention_ref,
                       static_argnames=("window", "sink", "softcap"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one intra-op thread, and the suite's
    other workers keep the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _verify_case(rng, *, t, g, page, dh, hkv=1, b=4):
    """Ragged rows whose pages hold the last candidate (position base + t
    - 1), a -1 hole, a page shared by two rows and one all-unmapped row
    (its output must be exactly 0)."""
    base = np.array([page + 1, 2, page * 2, 0], np.int32)[:b]
    last = base + t - 1
    need = [-(-(int(n) + 1) // page) for n in last]
    mp = max(need) + 1
    n_pages = sum(need) + 2
    perm = rng.permutation(n_pages).astype(np.int32)
    tables = np.full((b, mp), -1, np.int32)
    cur = 0
    for r in range(b - 1):                       # last row: all unmapped
        tables[r, :need[r]] = perm[cur:cur + need[r]]
        cur += need[r]
    tables[2, 1] = -1                            # a hole
    tables[1, 0] = tables[0, 0]                  # a shared page
    q = rng.standard_normal((b, t, hkv * g, dh)).astype(np.float32)
    pk = rng.standard_normal((n_pages, page, hkv, dh)).astype(np.float32)
    pv = rng.standard_normal((n_pages, page, hkv, dh)).astype(np.float32)
    return q, pk, pv, tables, base


GRID = [(t, g, page, dh) for t in (1, 2, 4) for g in (1, 4)
        for page in (4, 16) for dh in (64, 128)]
OPTIONS = {"window-sink": dict(window=6, sink=2),
           "softcap": dict(softcap=3.0)}


@pytest.mark.parametrize("t,g,page,dh", GRID)
def test_plain_verify_matches_jax_ref_and_pallas(t, g, page, dh):
    rng = np.random.default_rng(1000 * t + 100 * g + page + dh)
    args = _verify_case(rng, t=t, g=g, page=page, dh=dh)
    TPA.verify_plain_calls.reset()
    got = TPA.paged_verify_attention(*map(_t, args)).numpy()
    assert TPA.verify_plain_calls.value == 1
    jargs = list(map(jnp.asarray, args))
    want_ref = np.asarray(_JREF_VERIFY(*jargs))
    want_pallas = np.asarray(JPA.paged_verify_attention(*jargs,
                                                        interpret=True))
    np.testing.assert_allclose(got, want_ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, want_pallas, atol=TOL, rtol=0)
    assert np.all(got[3] == 0)                   # no valid key -> zeros
    # the dense plain version on the gathered slab is the same function
    k, pos = TREF.paged_gather(_t(args[1]), _t(args[3]))
    v, _ = TREF.paged_gather(_t(args[2]), _t(args[3]))
    dense = TOPS.verify_attention(_t(args[0]), k, v, pos, _t(args[4]))
    jk, jpos = JREF.paged_gather(jargs[1], jargs[3])
    jv, _ = JREF.paged_gather(jargs[2], jargs[3])
    np.testing.assert_allclose(
        dense.numpy(), np.asarray(JOPS.verify_attention(jargs[0], jk, jv,
                                                        jpos, jargs[4])),
        atol=TOL, rtol=0)


@pytest.mark.parametrize("name", sorted(OPTIONS))
@pytest.mark.parametrize("t", [1, 4])
def test_plain_verify_options_match_pallas(name, t):
    rng = np.random.default_rng(7 + t)
    args = _verify_case(rng, t=t, g=2, page=4, dh=64)
    kw = OPTIONS[name]
    got = TPA.paged_verify_attention(*map(_t, args), **kw).numpy()
    jargs = list(map(jnp.asarray, args))
    np.testing.assert_allclose(
        got, np.asarray(JPA.paged_verify_attention(*jargs, interpret=True,
                                                   **kw)),
        atol=TOL, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(_JREF_VERIFY(*jargs, **kw)),
        atol=TOL, rtol=0)


@pytest.mark.parametrize("kw", [{}, OPTIONS["window-sink"],
                                OPTIONS["softcap"]])
def test_verify_t1_is_the_decode_plain_version(kw):
    rng = np.random.default_rng(3)
    q, pk, pv, tables, base = map(_t, _verify_case(rng, t=1, g=4, page=4,
                                                   dh=64))
    got = TPA.paged_verify_attention(q, pk, pv, tables, base, **kw)
    want = TREF.paged_decode_attention_ref(q[:, 0], pk, pv, tables, base,
                                           **kw)
    assert torch.equal(got[:, 0], want)


def test_verify_wrapper_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(4)
    q, pk, pv, tables, base = map(_t, _verify_case(rng, t=2, g=1, page=4,
                                                   dh=64))
    with pytest.raises(ValueError, match="no kernel"):
        TPA.paged_verify_attention(q.to("meta"), pk.to("meta"),
                                   pv.to("meta"), tables.to("meta"),
                                   base.to("meta"))
    # the kernel's checks, reachable without a card
    with pytest.raises(ValueError, match=r"q \[B,T,Hq,Dh\]"):
        TPA._check(q[:, 0], pk, pv, tables, base, q_dims=4)
    with pytest.raises(TypeError, match="int32"):
        TPA._check(q, pk, pv, tables.long(), base, q_dims=4)


# ---------------------------------------------------------------------------
# the chunk pieces
# ---------------------------------------------------------------------------
def test_chunk_ring_plan_matches_jax():
    rng = np.random.default_rng(11)
    cache_n, c = 8, 5
    old_pos = np.full((4, cache_n), -1, np.int32)
    old_pos[0, :6] = np.arange(6)
    old_pos[1, :] = np.arange(8, 16) % 8 + 8         # a wrapped ring
    old_pos[2, :3] = np.arange(3)
    base = np.array([6, 16, 3, 0], np.int32)
    valid = np.zeros((4, c), bool)
    valid[0, :2] = True
    valid[1, :5] = True
    valid[2, :] = True                 # 5 tokens over 3 free slots: ring
    qpos = (base[:, None] + np.arange(c)[None, :]).astype(np.int32)
    got = TL.chunk_ring_plan(_t(old_pos), _t(base), _t(valid), _t(qpos),
                             cache_n)
    want = JL.chunk_ring_plan(*map(jnp.asarray, (old_pos, base, valid,
                                                 qpos)), cache_n)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    del rng


def test_scatter_rows_drop_is_mode_drop():
    """The torch stand-in for ``.at[b, slots].set(v, mode="drop")``: kept
    entries land, dropped ones (slot == N) leave no trace, in rows that
    keep some entries and in a row that keeps none."""
    rng = np.random.default_rng(12)
    dst = rng.standard_normal((3, 6, 2)).astype(np.float32)
    vals = rng.standard_normal((3, 4, 2)).astype(np.float32)
    slots = np.array([[6, 2, 6, 5], [6, 6, 6, 6], [0, 1, 6, 3]])
    want = jnp.asarray(dst).at[np.arange(3)[:, None], slots].set(
        jnp.asarray(vals), mode="drop")
    got = _t(dst.copy())
    TL.scatter_rows_drop(got, _t(slots), _t(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def tiny():
    jc = dataclasses.replace(tiny_cfg("qwen3-8b", layers=2), num_kv_heads=2)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jax.random.PRNGKey(3), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def _chunks(toks, plens, c):
    """Right-padded prompts as a chain of chunks (tokens, chunk_pos)."""
    b, s = toks.shape
    for c0 in range(0, s, c):
        pos = np.full((b, c), -1, np.int32)
        tk = np.zeros((b, c), np.int32)
        for r in range(b):
            for j in range(c):
                if c0 + j < plens[r]:
                    pos[r, j] = c0 + j
                    tk[r, j] = toks[r, c0 + j]
        yield tk, pos


def test_prefill_chunk_chain_equals_prefill_and_jax(tiny):
    """Chained chunks (ragged rows, a row idle in the later chunks) equal
    one whole-prompt prefill in logits and state, and the JAX package's
    chained prefill_chunk in state, chunk by chunk."""
    jc, tc, jp, tp = tiny
    rng = np.random.default_rng(13)
    toks = rng.integers(1, jc.vocab_size, (3, 11)).astype(np.int32)
    plens = np.array([11, 7, 4], np.int32)
    lg, whole = TM.prefill(tp, tc, _t(toks), _t(plens), 24)
    jchunk = jax.jit(lambda p, s, t, c: JM.prefill_chunk(p, jc, s, t, c))
    st = TM.init_decode_state(tc, 3, 24, "cpu")
    jst = JM.init_decode_state(jc, 3, 24)
    last = {}
    for tk, pos in _chunks(toks, plens, 4):
        lgc, st = TM.prefill_chunk(tp, tc, st, _t(tk), _t(pos))
        jlg, jst = jchunk(jp, jst, jnp.asarray(tk), jnp.asarray(pos))
        fed = (pos >= 0).any(axis=1)
        np.testing.assert_allclose(lgc.numpy()[fed], np.asarray(jlg)[fed],
                                   atol=TOL, rtol=0)
        for r in np.nonzero(fed)[0]:
            last[r] = lgc[r]
        np.testing.assert_array_equal(
            st["stack"]["s0"]["pos"].numpy(),
            np.asarray(jst["stack"]["s0"]["pos"]))
        np.testing.assert_allclose(st["stack"]["s0"]["k"].numpy(),
                                   np.asarray(jst["stack"]["s0"]["k"]),
                                   atol=TOL, rtol=0)
    for r in range(3):
        np.testing.assert_allclose(last[r].numpy(), lg[r].numpy(),
                                   atol=TOL, rtol=0)
    # prefill also writes the padding's K/V (under pos -1): compare the
    # written slots
    pos = st["stack"]["s0"]["pos"]
    assert torch.equal(pos, whole["stack"]["s0"]["pos"])
    for k in ("k", "v"):
        np.testing.assert_allclose(st["stack"]["s0"][k][pos >= 0].numpy(),
                                   whole["stack"]["s0"][k][pos >= 0].numpy(),
                                   atol=TOL, rtol=0)
    assert st["lengths"].tolist() == plens.tolist()


def _chunk_r_in(rng, *, b, c, hq, hkv, dh, base, counts):
    valid = np.zeros((b, c), bool)
    for r, n in enumerate(counts):
        valid[r, :n] = True
    return {"q": rng.standard_normal((b, c, hq, dh)).astype(np.float32),
            "k": rng.standard_normal((b, c, hkv, dh)).astype(np.float32),
            "v": rng.standard_normal((b, c, hkv, dh)).astype(np.float32),
            "lengths": np.asarray(base, np.int32), "valid": valid}


def test_r_attention_chunk_matches_jax():
    """Dense chunk R-Part over a slab holding stale entries past a row's
    base (rejected speculative tokens), a bystander row and a ring that
    wraps."""
    rng = np.random.default_rng(14)
    b, cache_n, hkv, dh = 4, 12, 2, 16
    pos = np.full((b, cache_n), -1, np.int32)
    pos[0, :9] = np.arange(9)            # base 6: slots 6..8 are stale
    pos[1, :4] = np.arange(4)
    pos[2, :] = np.arange(12)            # base 12: the chunk wraps
    state = {"k": rng.standard_normal((b, cache_n, hkv, dh)).astype(
                 np.float32),
             "v": rng.standard_normal((b, cache_n, hkv, dh)).astype(
                 np.float32),
             "pos": pos}
    r_in = _chunk_r_in(rng, b=b, c=4, hq=4, hkv=hkv, dh=dh,
                       base=[6, 4, 12, 0], counts=[4, 0, 3, 2])
    jo, jst = jax.jit(partial(JD.r_attention_chunk, window=0, softcap=0.0))(
        jax.tree.map(jnp.asarray, r_in), jax.tree.map(jnp.asarray, state))
    tst = {k: _t(v.copy()) for k, v in state.items()}
    to, tst = TD.r_attention_chunk({k: _t(v) for k, v in r_in.items()},
                                   tst, window=0, softcap=0.0)
    live = r_in["valid"]
    np.testing.assert_allclose(to["o"].numpy()[live],
                               np.asarray(jo["o"])[live], atol=TOL, rtol=0)
    for k in ("k", "v", "pos"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]))


@pytest.mark.parametrize("page", [4, 16])
def test_r_attention_paged_verify_matches_jax(page):
    """Write-then-attend of C candidates per row through block tables cut
    to the used pages: the same outputs on the verified rows and the same
    pool contents (the port's scratch page aside)."""
    rng = np.random.default_rng(15 + page)
    b, c, hkv, dh, n_pages = 3, 4, 2, 16, 12
    base = np.array([2 * page + 1, page - 2, 0], np.int32)
    counts = [4, 4, 0]
    alloc = TPC.PagedAllocator(b, n_pages, page, 6, device="cpu")
    jalloc = JPC.PagedAllocator(b, n_pages, page, 6)
    for r in range(2):
        alloc.admit(r, int(base[r]))
        jalloc.admit(r, int(base[r]))
    alloc.append_chunk(base, np.asarray(counts))
    jalloc.append_chunk(base, np.asarray(counts))
    np.testing.assert_array_equal(alloc.tables, jalloc.tables)
    used = int((alloc.tables >= 0).sum(axis=1).max())
    mp = 1 << (used - 1).bit_length()
    tables = alloc.tables[:, :mp].copy()
    pool = {"k": rng.standard_normal((n_pages, page, hkv, dh)).astype(
                np.float32),
            "v": rng.standard_normal((n_pages, page, hkv, dh)).astype(
                np.float32)}
    r_in = _chunk_r_in(rng, b=b, c=c, hq=4, hkv=hkv, dh=dh, base=base,
                       counts=counts)
    jo, jpool = JPC.r_attention_paged_verify(
        jax.tree.map(jnp.asarray, r_in), jax.tree.map(jnp.asarray, pool),
        jnp.asarray(tables))
    tpool = {k: torch.cat([_t(v), torch.zeros((1,) + v.shape[1:])])
             for k, v in pool.items()}              # + the scratch page
    TPA.verify_plain_calls.reset()
    to, tpool = TPC.r_attention_paged_verify(
        {k: _t(v) for k, v in r_in.items()}, tpool, _t(tables))
    assert TPA.verify_plain_calls.value == 1
    live = r_in["valid"]
    np.testing.assert_allclose(to["o"].numpy()[live],
                               np.asarray(jo["o"])[live], atol=TOL, rtol=0)
    for k in ("k", "v"):
        np.testing.assert_array_equal(tpool[k][:n_pages].numpy(),
                                      np.asarray(jpool[k]))


def test_r_attention_paged_verify_refuses_int8_pools():
    """The paged verify R-Part on int8 pools, once refused, against the
    JAX package's: the candidates quantized into their pages (int8 values
    and scales exactly equal, the port's scratch page aside), then scored
    through the int8 multi-token op, its plain version on the CPU
    (counted), within 1e-5 on the verified rows."""
    from repro_torch.kernels import quant_kv as TQK
    rng = np.random.default_rng(31)
    page, b, c, hkv, dh, n_pages = 4, 3, 4, 2, 16, 12
    base = np.array([2 * page + 1, page - 2, 0], np.int32)
    counts = [4, 4, 0]
    alloc = TPC.PagedAllocator(b, n_pages, page, 6, device="cpu")
    jalloc = JPC.PagedAllocator(b, n_pages, page, 6)
    for r in range(2):
        alloc.admit(r, int(base[r]))
        jalloc.admit(r, int(base[r]))
    alloc.append_chunk(base, np.asarray(counts))
    jalloc.append_chunk(base, np.asarray(counts))
    np.testing.assert_array_equal(alloc.tables, jalloc.tables)
    used = int((alloc.tables >= 0).sum(axis=1).max())
    tables = alloc.tables[:, :1 << (used - 1).bit_length()].copy()
    pool = TPC.init_page_pool(n_pages, page, hkv, dh, quantized=True,
                              device="cpu")
    for name in ("k", "v"):
        x = rng.standard_normal((n_pages, page, hkv, dh)).astype(np.float32)
        pool[f"{name}_q"][:n_pages], pool[f"{name}_s"][:n_pages] = \
            TQK.quantize_kv(_t(x))
    jpool = {k: jnp.asarray(v[:n_pages].numpy()) for k, v in pool.items()}
    r_in = _chunk_r_in(rng, b=b, c=c, hq=4, hkv=hkv, dh=dh, base=base,
                       counts=counts)
    jo, jpool = JPC.r_attention_paged_verify(
        jax.tree.map(jnp.asarray, r_in), jpool, jnp.asarray(tables))
    TQK.verify_plain_calls.reset()
    to, pool = TPC.r_attention_paged_verify(
        {k: _t(v) for k, v in r_in.items()}, pool, _t(tables))
    assert TQK.verify_plain_calls.value == 1
    live = r_in["valid"]
    np.testing.assert_allclose(to["o"].numpy()[live],
                               np.asarray(jo["o"])[live], atol=TOL, rtol=0)
    for k in ("k_q", "k_s", "v_q", "v_s"):
        np.testing.assert_array_equal(pool[k][:n_pages].numpy(),
                                      np.asarray(jpool[k]))


def test_allocator_append_chunk_and_truncate_match_jax():
    """One seeded sequence of admissions, decode growth, verify appends
    (including a fresh re-admission at offset 0), rollbacks, releases and
    pool exhaustion: the same tables, lengths, frozen rows and free-page
    count after every operation."""
    rng = np.random.default_rng(16)
    rows, page, mp, n_pages = 4, 4, 8, 14
    t = TPC.PagedAllocator(rows, n_pages, page, mp, device="cpu")
    j = JPC.PagedAllocator(rows, n_pages, page, mp)
    for step in range(60):
        op = rng.integers(0, 5)
        if op == 0:
            r, n = int(rng.integers(rows)), int(rng.integers(0, 12))
            try:
                t.admit(r, n)
                tx = None
            except MemoryError as e:
                tx = e
            with pytest.raises(MemoryError) if tx else _nullctx():
                j.admit(r, n)
        elif op == 1:
            base = t.lengths.copy()
            base[rng.integers(rows)] = 0 if rng.random() < 0.2 else \
                base[0]
            counts = rng.integers(0, 5, rows) * (rng.random(rows) < 0.7)
            t.append_chunk(base, counts)
            j.append_chunk(base, counts)
        elif op == 2:
            r = int(rng.integers(rows))
            nl = int(rng.integers(0, t.lengths[r] + 2))
            assert t.truncate(r, nl) == j.truncate(r, nl)
        elif op == 3:
            r = int(rng.integers(rows))
            t.release(r)
            j.release(r)
        else:
            new = t.lengths + 1
            t.ensure_lengths(new)
            j.ensure_lengths(new)
        np.testing.assert_array_equal(t.tables, j.tables, err_msg=str(step))
        np.testing.assert_array_equal(t.lengths, j.lengths)
        np.testing.assert_array_equal(t.frozen, j.frozen)
        assert t.available_pages() == j.available_pages()


class _nullctx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_spec_accept_greedy_matches_jax():
    rng = np.random.default_rng(17)
    key = jax.random.PRNGKey(0)
    for k in range(0, 5):
        for _ in range(6):
            logits = rng.standard_normal((k + 1, 11)).astype(np.float32)
            am = logits.argmax(axis=-1)
            # drafts agreeing with the target up to a random point
            cut = int(rng.integers(0, k + 1))
            draft = [int(am[i]) if i < cut else int((am[i] + 1) % 11)
                     for i in range(k)]
            got = TS.spec_accept(_t(logits), draft)
            want = JS.spec_accept(jnp.asarray(logits), draft, key)
            assert got == (list(map(int, want[0])), int(want[1]))
    # the sampled branch (tests/test_torch_sampler.py) draws only from a
    # generator the caller passes: none given is refused
    with pytest.raises(ValueError, match="Generator"):
        TS.spec_accept(_t(logits), draft, temperature=0.7)
    toks, acc = TS.spec_accept(_t(logits), draft,
                               torch.Generator().manual_seed(0),
                               temperature=0.7)
    assert len(toks) == acc + 1 and toks[:acc] == draft[:acc]
