"""The port's paged R-Part against the JAX package: the plain
paged_decode_attention_ref against repro.kernels.ref AND the Pallas TPU
kernel in interpret mode; the page-pool writes and the allocator against
repro.serving.paged_cache.  fp32, tolerance 1e-5 absolute.  The Hopper
kernel itself runs only on the card (tests/test_torch_kernels_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as JPA
from repro.kernels import ref as JREF
from repro.serving import paged_cache as JPC
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import ref as TREF
from repro_torch.serving import paged_cache as TPC

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one intra-op thread, and the suite's
    other workers (timing-sensitive chaos tests among them) keep the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(rng, *, g, page, hkv=2, dh=16, b=4, mp=6):
    """Ragged rows, a -1 hole, a page shared by two rows and one
    all-unmapped row (its output must be exactly 0)."""
    lengths = np.array([page * 3 + 1, 2, page * 5, 0], np.int32)[:b]
    need = [-(-(int(n) + 1) // page) for n in lengths]
    n_pages = sum(need) + 2
    perm = rng.permutation(n_pages).astype(np.int32)
    tables = np.full((b, mp), -1, np.int32)
    cur = 0
    for r in range(b - 1):                       # last row: all unmapped
        tables[r, :need[r]] = perm[cur:cur + need[r]]
        cur += need[r]
    tables[2, 1] = -1                            # a hole
    tables[1, 0] = tables[0, 0]                  # a shared page
    q = rng.standard_normal((b, hkv * g, dh)).astype(np.float32)
    pk = rng.standard_normal((n_pages, page, hkv, dh)).astype(np.float32)
    pv = rng.standard_normal((n_pages, page, hkv, dh)).astype(np.float32)
    return q, pk, pv, tables, lengths


ATTN_KW = {"plain": {}, "window-sink": dict(window=6, sink=2),
           "softcap": dict(softcap=3.0)}


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("page", [4, 16])
def test_plain_paged_attention_matches_jax_ref_and_pallas(g, page):
    rng = np.random.default_rng(10 * g + page)
    args = _case(rng, g=g, page=page)
    got = TPA.paged_decode_attention(*map(torch.from_numpy, args)).numpy()
    jargs = list(map(jnp.asarray, args))
    want_ref = np.asarray(JREF.paged_decode_attention_ref(*jargs))
    want_pallas = np.asarray(JPA.paged_decode_attention(*jargs,
                                                        interpret=True))
    np.testing.assert_allclose(got, want_ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, want_pallas, atol=TOL, rtol=0)
    assert np.all(got[3] == 0)                   # all-masked row -> zeros


@pytest.mark.parametrize("name", ["window-sink", "softcap"])
def test_plain_paged_attention_options_match_pallas(name):
    rng = np.random.default_rng(7)
    args = _case(rng, g=2, page=4)
    kw = ATTN_KW[name]
    got = TPA.paged_decode_attention(*map(torch.from_numpy, args),
                                     **kw).numpy()
    jargs = list(map(jnp.asarray, args))
    np.testing.assert_allclose(
        got, np.asarray(JPA.paged_decode_attention(*jargs, interpret=True,
                                                   **kw)), atol=TOL, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(JREF.paged_decode_attention_ref(*jargs, **kw)),
        atol=TOL, rtol=0)


def test_cpu_tensors_take_the_plain_version_and_are_counted():
    rng = np.random.default_rng(1)
    args = list(map(torch.from_numpy, _case(rng, g=2, page=4)))
    before_plain, before_k = TPA.plain_calls.value, TPA.launches.value
    out = TPA.paged_decode_attention(*args)
    torch.testing.assert_close(out, TREF.paged_decode_attention_ref(*args))
    assert TPA.plain_calls.value == before_plain + 1
    assert TPA.launches.value == before_k


@pytest.mark.parametrize("bad", ["dtype", "noncontig", "head_dim",
                                 "tables_dtype", "gqa"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad):
    rng = np.random.default_rng(2)
    q, pk, pv, tables, lengths = map(torch.from_numpy,
                                     _case(rng, g=2, page=4, dh=64))
    if bad == "dtype":
        q = q.to(torch.float16)
    elif bad == "noncontig":
        pk = pk.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "head_dim":
        q, pk, pv = q[..., :32].contiguous(), pk[..., :32].contiguous(), \
            pv[..., :32].contiguous()
    elif bad == "tables_dtype":
        tables = tables.long()
    elif bad == "gqa":
        q = q[:, :3].contiguous()
    with pytest.raises((TypeError, ValueError)):
        TPA._check(q, pk, pv, tables, lengths)
    q, pk, pv, tables, lengths = map(torch.from_numpy,
                                     _case(rng, g=2, page=4, dh=64))
    TPA._check(q, pk, pv, tables, lengths)
    # an R-worker's row slice: int32 tables/lengths need no 16-byte start
    TPA._check(q[1:3], pk, pv, tables[1:3], lengths[1:3])


def test_write_token_paged_matches_jax_and_drops_unmapped_rows():
    rng = np.random.default_rng(3)
    n_pages, page, hkv, dh = 6, 4, 2, 8
    pk = rng.standard_normal((n_pages, page, hkv, dh)).astype(np.float32)
    pv = rng.standard_normal((n_pages, page, hkv, dh)).astype(np.float32)
    tables = np.array([[0, 1, -1], [2, -1, -1], [-1, -1, -1], [3, 4, 5]],
                      np.int32)
    lengths = np.array([5, 4, 1, 7], np.int32)   # row 1: slot past its table
    active = np.array([True, True, True, False])
    k_new = rng.standard_normal((4, hkv, dh)).astype(np.float32)
    v_new = rng.standard_normal((4, hkv, dh)).astype(np.float32)
    want = JPC.write_token_paged({"k": jnp.asarray(pk), "v": jnp.asarray(pv)},
                                 jnp.asarray(tables), jnp.asarray(lengths),
                                 jnp.asarray(k_new), jnp.asarray(v_new),
                                 active=jnp.asarray(active))
    pool = TPC.init_page_pool(n_pages, page, hkv, dh, device="cpu")
    pool["k"][:n_pages] = torch.from_numpy(pk)
    pool["v"][:n_pages] = torch.from_numpy(pv)
    got = TPC.write_token_paged(pool, torch.from_numpy(tables),
                                torch.from_numpy(lengths),
                                torch.from_numpy(k_new),
                                torch.from_numpy(v_new),
                                active=torch.from_numpy(active))
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name][:n_pages].numpy(),
                                      np.asarray(want[name]))
    # only row 0 wrote (page 1, slot 1); the rest landed on the scratch page
    changed = np.argwhere(got["k"][:n_pages].numpy() != pk)
    assert set(map(tuple, changed[:, :2])) == {(1, 1)}


def test_dense_rows_to_pages_and_allocator_match_jax():
    rng = np.random.default_rng(4)
    rows, cache, page, hkv, dh = 3, 12, 4, 2, 8
    lens = np.array([9, 0, 4])
    k = rng.standard_normal((rows, cache, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((rows, cache, hkv, dh)).astype(np.float32)
    pos = np.where(np.arange(cache)[None] < lens[:, None],
                   np.arange(cache)[None], -1).astype(np.int32)
    ja = JPC.PagedAllocator(rows, 8, page, 3)
    ta = TPC.PagedAllocator(rows, 8, page, 3, device="cpu")
    jpool = JPC.dense_rows_to_pages(
        JPC.init_page_pool(8, page, hkv, dh), ja, np.arange(rows),
        {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(pos)})
    tpool = TPC.dense_rows_to_pages(
        TPC.init_page_pool(8, page, hkv, dh, device="cpu"), ta,
        np.arange(rows),
        {"k": torch.from_numpy(k), "v": torch.from_numpy(v),
         "pos": torch.from_numpy(pos)})
    np.testing.assert_array_equal(ta.tables, ja.tables)
    for name in ("k", "v"):
        np.testing.assert_array_equal(tpool[name][:8].numpy(),
                                      np.asarray(jpool[name]))
    # decode growth, release and re-admission keep the same page ids
    for alloc in (ja, ta):
        alloc.ensure_lengths(np.array([13, 1, 5]))
        alloc.release(0)
        alloc.admit(0, 6)
    np.testing.assert_array_equal(ta.tables, ja.tables)
    np.testing.assert_array_equal(ta.lengths, ja.lengths)
    assert ta.used_pages() == ja.used_pages()
    assert ta.available_pages() == ja.available_pages()
    assert [ta.mapped_pages(r) for r in range(rows)] == \
        [ja.mapped_pages(r) for r in range(rows)]
    assert TPC.page_pool_token_bytes(tpool) == \
        JPC.page_pool_token_bytes(jpool)
    dev = ta.tables_device()
    assert dev.dtype == torch.int32 and dev is ta.tables_device()
    before = dev.clone()
    ta.release(2)                                # a host mutation
    # one fixed buffer (CUDA graphs read it in place), refreshed by copy
    assert ta.tables_device() is dev
    np.testing.assert_array_equal(dev.numpy(), ta.tables)
    assert not torch.equal(dev, before)


@pytest.mark.parametrize("make", ["PagedAllocator", "init_page_pool",
                                  "RWorker"])
def test_constructors_default_to_the_card_and_raise_without_it(
        make, monkeypatch):
    """With no device given, the allocator, the page pool and the
    R-worker resolve it as every entry point of the port does: the card,
    and a raise where there is none (never a quiet CPU run)."""
    import dataclasses
    from conftest import tiny_cfg
    from repro_torch.core import hetero as THET
    from repro_torch.core.config import ModelConfig
    cfg = ModelConfig(**dataclasses.asdict(tiny_cfg("qwen3-8b")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = {
        "PagedAllocator": lambda **kw: TPC.PagedAllocator(2, 8, 4, 3, **kw),
        "init_page_pool": lambda **kw: TPC.init_page_pool(8, 4, 2, 16, **kw),
        "RWorker": lambda **kw: THET.RWorker(0, cfg, 0, 2, paged=True,
                                             **kw),
    }[make]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
    obj = build(device="cpu")
    dev = obj["k"].device if isinstance(obj, dict) else obj.device
    assert dev == torch.device("cpu")
