"""The port's int8 KV storage and dense flash-decode against the JAX
package on the same numpy inputs: ``quantize_kv`` bit-identical; the
plain versions of kernels 2 and 3 within 1e-5 of ``repro.kernels.ref``
and within 3e-5 (the JAX package's own bound, tests/test_kernels.py) of
the Pallas kernels in interpret mode; ``r_attention_int8``, the int8
chunk R-Part and the int8 page pools with exactly equal storage and
outputs within 1e-5.  fp32
unless stated.  The Hopper kernels themselves run only on the card
(tests/test_torch_kernels_cuda.py)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.core import hetero as JHET
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.serving import kv_cache as JKV
from repro.serving import paged_cache as JPC
from repro_torch import bridge
from repro_torch.core import hetero as THET
from repro_torch.core.config import ModelConfig
from repro_torch.kernels import decode_attention as TDA
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import quant_kv as TQK
from repro_torch.kernels import ref as TREF
from repro_torch.serving import kv_cache as TKV
from repro_torch.serving import paged_cache as TPC

TOL = 1e-5
PALLAS_TOL = 3e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one intra-op thread, and the suite's
    other workers (timing-sensitive chaos tests among them) keep the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------
def _quant_input(rng):
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                          # amax 0 -> the 1e-8 floor
    # amax 127 -> scale 1: exact .5 ties, rounded half to even
    x[0, 1, 0] = np.r_[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5,
                       np.zeros(8)]
    x[1, 2, 1] *= 1e-6                        # tiny but nonzero
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_identical_to_jax(dtype):
    x = _quant_input(np.random.default_rng(0))
    if dtype == "bfloat16":
        jx = jnp.asarray(x).astype(jnp.bfloat16)
        # bf16 crosses as its uint16 bit pattern, as the bridge carries it
        tx = bridge.tensor_from_numpy(np.asarray(jx).view(np.uint16), "cpu")
        assert tx.dtype == torch.bfloat16
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jq, js = JOPS.quantize_kv(jx)
    tq, ts = TOPS.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    np.testing.assert_array_equal(
        TOPS.dequantize_kv(tq, ts).numpy(),
        np.asarray(JOPS.dequantize_kv(jq, js)))
    if dtype == "float32":                    # ties went half to even
        assert tq[0, 1, 0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


# ---------------------------------------------------------------------------
# kernels 2 and 3: the plain versions against the reference and Pallas
# ---------------------------------------------------------------------------
def _slab_case(rng, *, g, hkv=2, dh=16, s=50):
    """Three rows over an S=50 slab (no multiple of any tile): row 0 holds
    positions 0..39 in order with a -1 hole; row 1 a ring-ordered cache
    (positions 60..109, slot = pos % S); row 2 no valid slot at all (its
    output must be exactly 0)."""
    pos = np.full((3, s), -1, np.int32)
    pos[0, :40] = np.arange(40)
    pos[0, 7] = -1
    ring = np.arange(60, 110)
    pos[1, ring % s] = ring
    lengths = np.array([39, 109, 5], np.int32)
    q = rng.standard_normal((3, hkv * g, dh)).astype(np.float32)
    k = rng.standard_normal((3, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((3, s, hkv, dh)).astype(np.float32)
    return q, k, v, pos, lengths


ATTN_KW = {"plain": {}, "window-sink": dict(window=24, sink=4),
           "softcap": dict(softcap=3.0)}
CASES = [(g, "plain") for g in (1, 2, 4)] + [(2, "window-sink"),
                                             (4, "softcap")]


def _run_both(kernel, args, kw):
    """(port plain version, JAX ref, JAX Pallas interpret) outputs."""
    q, k, v, pos, lengths = args
    if kernel == "int8":
        kq, ks = TQK.quantize_kv(torch.from_numpy(k))
        vq, vs = TQK.quantize_kv(torch.from_numpy(v))
        targs = (_t(q), kq, ks, vq, vs, _t(pos), _t(lengths))
        got = TQK.decode_attention_int8(*targs, **kw)
        jargs = [_j(a) for a in targs]
        want = JREF.decode_attention_int8_ref(*jargs, **kw)
        pallas = JOPS.decode_attention_int8(*jargs, use_kernel="pallas",
                                            block_s=32, **kw)
    else:
        targs = tuple(map(_t, args))
        got = TDA.decode_attention(*targs, **kw)
        jargs = [_j(a) for a in args]
        want = JREF.decode_attention_ref(*jargs, **kw)
        pallas = JOPS.decode_attention(*jargs, use_kernel="pallas",
                                       block_s=32, **kw)
    return got.numpy(), np.asarray(want), np.asarray(pallas)


@pytest.mark.parametrize("kernel", ["dense", "int8"])
@pytest.mark.parametrize("g,opt", CASES)
def test_plain_slab_attention_matches_jax_ref_and_pallas(kernel, g, opt):
    rng = np.random.default_rng(10 * g + len(opt))
    got, want, pallas = _run_both(kernel, _slab_case(rng, g=g),
                                  ATTN_KW[opt])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=PALLAS_TOL, rtol=0)
    assert np.all(got[2] == 0)                   # all-invalid row -> zeros


@pytest.mark.parametrize("kernel", ["dense", "int8"])
def test_cpu_tensors_take_the_plain_version_and_are_counted(kernel):
    rng = np.random.default_rng(1)
    q, k, v, pos, lengths = map(_t, _slab_case(rng, g=2))
    mod = TQK if kernel == "int8" else TDA
    before_plain, before_k = mod.plain_calls.value, mod.launches.value
    if kernel == "int8":
        kq, ks = TQK.quantize_kv(k)
        vq, vs = TQK.quantize_kv(v)
        out = TOPS.decode_attention_int8(q, kq, ks, vq, vs, pos, lengths)
        want = TREF.decode_attention_int8_ref(q, kq, ks, vq, vs, pos,
                                              lengths)
    else:
        out = TOPS.decode_attention(q, k, v, pos, lengths)
        want = TREF.decode_attention_ref(q, k, v, pos, lengths)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert mod.plain_calls.value == before_plain + 1
    assert mod.launches.value == before_k


def _check_args(kernel, rng, dh=64):
    q, k, v, pos, lengths = map(_t, _slab_case(rng, g=2, dh=dh))
    if kernel == "int8":
        kq, ks = TQK.quantize_kv(k)
        vq, vs = TQK.quantize_kv(v)
        return dict(q=q, k=kq, v=vq, pos=pos, lengths=lengths,
                    kv_dtype=torch.int8, scales=(ks, vs))
    return dict(q=q, k=k, v=v, pos=pos, lengths=lengths,
                kv_dtype=torch.float32)


def _misaligned(t):
    """A copy of ``t`` whose data starts one element past a 16-byte
    boundary."""
    flat = torch.zeros(t.numel() + 16, dtype=t.dtype)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("kernel", ["dense", "int8"])
@pytest.mark.parametrize("bad", ["dtype", "noncontig", "misaligned",
                                 "head_dim", "gqa", "pos_dtype"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(kernel, bad):
    rng = np.random.default_rng(2)
    a = _check_args(kernel, rng)
    if bad == "dtype":
        a["q"] = a["q"].to(torch.float16)
        if kernel == "dense":      # and a mismatch of k against q
            a["k"] = a["k"].to(torch.bfloat16)
    elif bad == "noncontig":
        a["k"] = a["k"].transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "misaligned":
        a["v"] = _misaligned(a["v"])
        assert a["v"].data_ptr() % 16
    elif bad == "head_dim":      # Dh 256 is recurrentgemma's, not ported
        a = _check_args(kernel, rng, dh=256)
    elif bad == "gqa":
        a["q"] = a["q"][:, :3].contiguous()
    elif bad == "pos_dtype":
        a["pos"] = a["pos"].long()
    with pytest.raises((TypeError, ValueError)):
        TDA._check(**a)
    a = _check_args(kernel, rng)
    TDA._check(**a)
    # an R-worker's row slice: q, pos, lengths and scales need no 16-byte
    # start (k and v are per-worker slabs)
    a["q"], a["pos"], a["lengths"] = a["q"][1:], a["pos"][1:], \
        a["lengths"][1:]
    a["k"], a["v"] = a["k"][1:].clone(), a["v"][1:].clone()
    a["scales"] = tuple(s[1:] for s in a.get("scales", ()))
    TDA._check(**a)


# ---------------------------------------------------------------------------
# kv_cache: dense int8 storage
# ---------------------------------------------------------------------------
def _int8_state(rng, b=4, cache=12, hkv=2, dh=8):
    k = rng.standard_normal((b, cache, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, cache, hkv, dh)).astype(np.float32)
    lens = np.array([5, 11, 0, 12])[:b]
    pos = np.where(np.arange(cache)[None] < lens[:, None],
                   np.arange(cache)[None], -1).astype(np.int32)
    return {"k": k, "v": v, "pos": pos}


def test_attn_state_quantize_roundtrip_and_bytes_match_jax():
    st = _int8_state(np.random.default_rng(3))
    jq = JKV.quantize_attn_state({k: _j(v) for k, v in st.items()})
    tq = TKV.quantize_attn_state({k: _t(v) for k, v in st.items()})
    assert sorted(tq) == sorted(jq) == ["k_q", "k_s", "pos", "v_q", "v_s"]
    for name in jq:
        np.testing.assert_array_equal(tq[name].numpy(), np.asarray(jq[name]))
    jd, td = JKV.dequantize_attn_state(jq), TKV.dequantize_attn_state(tq)
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(td[name].numpy(), np.asarray(jd[name]))
    assert TKV.cache_bytes(tq) == JKV.cache_bytes(jq)
    jc = tiny_cfg("qwen3-8b")
    tc = ModelConfig(**dataclasses.asdict(jc))
    for quantized in (False, True):
        assert TKV.kv_bytes_per_seq(tc, 100, quantized) == \
            JKV.kv_bytes_per_seq(jc, 100, quantized)
        assert TKV.paged_kv_bytes_per_seq(tc, 37, 16, quantized) == \
            JKV.paged_kv_bytes_per_seq(jc, 37, 16, quantized)


@pytest.mark.parametrize("opt", ["plain", "window-sink", "softcap"])
def test_r_attention_int8_matches_jax_and_keeps_inactive_rows(opt):
    rng = np.random.default_rng(4)
    b, cache, hkv, g, dh = 4, 12, 2, 2, 8
    st = TKV.quantize_attn_state({k: _t(v) for k, v in
                                  _int8_state(rng, b, cache, hkv, dh).items()})
    # rows: append at 5; wrap the ring (12 -> slot 0); inactive; append at 11
    lengths = np.array([5, 12, 3, 11], np.int32)
    active = np.array([True, True, False, True])
    r_in = {"q": rng.standard_normal((b, 1, hkv * g, dh)).astype(np.float32),
            "k": rng.standard_normal((b, 1, hkv, dh)).astype(np.float32),
            "v": rng.standard_normal((b, 1, hkv, dh)).astype(np.float32),
            "lengths": lengths, "active": active}
    kw = dict(window=ATTN_KW[opt].get("window", 0),
              softcap=ATTN_KW[opt].get("softcap", 0.0))
    before = {k: v.clone() for k, v in st.items()}
    jout, jst = JKV.r_attention_int8({k: _j(v) for k, v in r_in.items()},
                                     {k: _j(v.numpy()) for k, v in
                                      st.items()}, **kw)
    tout, tst = TKV.r_attention_int8({k: _t(v) for k, v in r_in.items()},
                                     st, **kw)
    assert tst is st                                # updated in place
    for name in jst:
        np.testing.assert_array_equal(tst[name].numpy(),
                                      np.asarray(jst[name]))
        # the inactive row kept its stored state
        assert torch.equal(tst[name][2], before[name][2])
    np.testing.assert_allclose(tout["o"].numpy(), np.asarray(jout["o"]),
                               atol=TOL, rtol=0)


def test_int8_chunk_and_prefix_helpers_wait_for_their_slices():
    """Both helpers are ported now.  The prefix cache's byte helper equals
    the JAX package's on int8 storage (more cases in
    tests/test_torch_prefix_cache.py); the int8 chunk R-Part (chunked
    prefill and the dense int8 verify): against the JAX package on rows
    that append mid-slab, over stale entries past their offset, from
    offset 0, not at all, and past the ring's end (the chunk wraps): int8
    values, scales and positions exactly equal, outputs within 1e-5 on the
    valid positions."""
    jc = tiny_cfg("qwen3-8b")
    tc = ModelConfig(**dataclasses.asdict(jc))
    for args in ((32, 2, 16), (40, 5, 4), (3, 4, 4), (64, 1, 16)):
        assert TKV.shared_prefix_bytes_saved(tc, *args, quantized=True) \
            == JKV.shared_prefix_bytes_saved(jc, *args, quantized=True)
    rng = np.random.default_rng(8)
    b, c, hkv, g, dh = 4, 4, 2, 2, 8
    st = TKV.quantize_attn_state({k: _t(v) for k, v in
                                  _int8_state(rng, b, 12, hkv, dh).items()})
    valid = np.zeros((b, c), bool)
    for r, n in enumerate([4, 3, 2, 0]):
        valid[r, :n] = True
    r_in = {"q": rng.standard_normal((b, c, hkv * g, dh)).astype(np.float32),
            "k": rng.standard_normal((b, c, hkv, dh)).astype(np.float32),
            "v": rng.standard_normal((b, c, hkv, dh)).astype(np.float32),
            "lengths": np.array([5, 8, 0, 12], np.int32), "valid": valid}
    r_in["valid"][3] = True                   # row 3: the chunk wraps
    jout, jst = JKV.r_attention_int8_chunk(
        {k: _j(v) for k, v in r_in.items()},
        {k: _j(v.numpy()) for k, v in st.items()}, window=0, softcap=0.0)
    tout, tst = TKV.r_attention_int8_chunk(
        {k: _t(v) for k, v in r_in.items()}, st, window=0, softcap=0.0)
    assert tst is st                                # updated in place
    for name in jst:
        np.testing.assert_array_equal(tst[name].numpy(),
                                      np.asarray(jst[name]))
    live = r_in["valid"]
    np.testing.assert_allclose(tout["o"].numpy()[live],
                               np.asarray(jout["o"])[live], atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# paged_cache: int8 page pools
# ---------------------------------------------------------------------------
def _pools(rng, n_pages=6, page=4, hkv=2, dh=8):
    """The same int8 pool contents for JAX (no scratch page) and the port
    (one scratch page, index n_pages)."""
    tpool = TPC.init_page_pool(n_pages, page, hkv, dh, quantized=True,
                               device="cpu")
    for name, x in (("k", rng.standard_normal((n_pages, page, hkv, dh))),
                    ("v", rng.standard_normal((n_pages, page, hkv, dh)))):
        qv, sv = TQK.quantize_kv(torch.from_numpy(x.astype(np.float32)))
        tpool[f"{name}_q"][:n_pages] = qv
        tpool[f"{name}_s"][:n_pages] = sv
    jpool = {k: _j(v[:n_pages].numpy()) for k, v in tpool.items()}
    return jpool, tpool


def test_int8_page_pool_layout_matches_jax():
    jpool = JPC.init_page_pool(5, 4, 2, 8, quantized=True)
    tpool = TPC.init_page_pool(5, 4, 2, 8, quantized=True, device="cpu")
    assert sorted(tpool) == sorted(jpool)
    for name in jpool:
        assert tuple(tpool[name].shape) == (6,) + tuple(jpool[name].shape[1:])
        assert str(tpool[name].dtype).split(".")[-1] == \
            str(jpool[name].dtype)
    assert TPC.pool_pages(tpool) == 5
    assert TPC.page_pool_token_bytes(tpool) == \
        JPC.page_pool_token_bytes(jpool)


def test_int8_write_token_paged_matches_jax_and_drops_unmapped_rows():
    rng = np.random.default_rng(5)
    n_pages, hkv, dh = 6, 2, 8
    jpool, tpool = _pools(rng, n_pages)
    before = {k: v.clone() for k, v in tpool.items()}
    tables = np.array([[0, 1, -1], [2, -1, -1], [-1, -1, -1], [3, 4, 5]],
                      np.int32)
    lengths = np.array([5, 4, 1, 7], np.int32)   # row 1: slot past its table
    active = np.array([True, True, True, False])
    k_new = rng.standard_normal((4, hkv, dh)).astype(np.float32)
    v_new = rng.standard_normal((4, hkv, dh)).astype(np.float32)
    want = JPC.write_token_paged(jpool, _j(tables), _j(lengths), _j(k_new),
                                 _j(v_new), active=_j(active))
    got = TPC.write_token_paged(tpool, _t(tables), _t(lengths), _t(k_new),
                                _t(v_new), active=_t(active))
    for name in want:
        np.testing.assert_array_equal(got[name][:n_pages].numpy(),
                                      np.asarray(want[name]))
        # only row 0 wrote (page 1, slot 1); the rest hit the scratch page
        changed = (got[name][:n_pages] != before[name][:n_pages])
        changed = changed.reshape(n_pages, 4, -1).any(dim=-1)
        assert set(map(tuple, changed.nonzero().tolist())) == {(1, 1)}


@pytest.mark.parametrize("payload", ["fp", "int8"])
def test_int8_dense_rows_to_pages_matches_jax(payload):
    rng = np.random.default_rng(6)
    rows, cache, page, hkv, dh = 3, 12, 4, 2, 8
    st = _int8_state(rng, rows, cache, hkv, dh)
    st["pos"][1] = -1                              # an empty row
    if payload == "int8":
        jrows = JKV.quantize_attn_state({k: _j(v) for k, v in st.items()})
        trows = TKV.quantize_attn_state({k: _t(v) for k, v in st.items()})
    else:
        jrows = {k: _j(v) for k, v in st.items()}
        trows = {k: _t(v) for k, v in st.items()}
    ja = JPC.PagedAllocator(rows, 8, page, 3)
    ta = TPC.PagedAllocator(rows, 8, page, 3, device="cpu")
    jpool = JPC.dense_rows_to_pages(
        JPC.init_page_pool(8, page, hkv, dh, quantized=True), ja,
        np.arange(rows), jrows)
    tpool = TPC.dense_rows_to_pages(
        TPC.init_page_pool(8, page, hkv, dh, quantized=True, device="cpu"),
        ta,
        np.arange(rows), trows)
    np.testing.assert_array_equal(ta.tables, ja.tables)
    for name in jpool:
        np.testing.assert_array_equal(tpool[name][:8].numpy(),
                                      np.asarray(jpool[name]))
    if payload == "int8":
        with pytest.raises(ValueError, match="fp page pool"):
            TPC.dense_rows_to_pages(TPC.init_page_pool(8, page, hkv, dh,
                                                       device="cpu"),
                                    TPC.PagedAllocator(rows, 8, page, 3,
                                                       device="cpu"),
                                    np.arange(rows), trows)


@pytest.mark.parametrize("g", [1, 4])
def test_int8_r_attention_paged_tables_matches_jax(g):
    rng = np.random.default_rng(7 + g)
    n_pages, page, hkv, dh = 6, 4, 2, 8
    jpool, tpool = _pools(rng, n_pages, page, hkv, dh)
    tables = np.array([[0, 1, -1], [2, -1, -1], [-1, -1, -1], [3, 4, 5]],
                      np.int32)
    lengths = np.array([5, 2, 1, 9], np.int32)   # row 2 unmapped: output 0
    r_in = {"q": rng.standard_normal((4, 1, hkv * g, dh)).astype(np.float32),
            "k": rng.standard_normal((4, 1, hkv, dh)).astype(np.float32),
            "v": rng.standard_normal((4, 1, hkv, dh)).astype(np.float32),
            "lengths": lengths}
    jout, jp = JPC.r_attention_paged_tables(
        {k: _j(v) for k, v in r_in.items()}, jpool, _j(tables))
    before = TQK.plain_calls.value
    tout, tp = TPC.r_attention_paged_tables(
        {k: _t(v) for k, v in r_in.items()}, tpool, _t(tables))
    assert TQK.plain_calls.value == before + 1   # through kernel 3's op
    for name in jp:
        np.testing.assert_array_equal(tp[name][:n_pages].numpy(),
                                      np.asarray(jp[name]))
    np.testing.assert_allclose(tout["o"].numpy(), np.asarray(jout["o"]),
                               atol=TOL, rtol=0)
    assert np.all(tout["o"][2].numpy() == 0)
    # the CPU chain (gather + kernel 3's plain version) is exactly the
    # paged int8 reference
    q = _t(r_in["q"][:, 0])
    np.testing.assert_array_equal(
        TOPS.paged_decode_attention_int8(
            q, tp["k_q"], tp["k_s"], tp["v_q"], tp["v_s"], _t(tables),
            _t(lengths)).numpy(),
        TREF.paged_decode_attention_int8_ref(
            q, tp["k_q"], tp["k_s"], tp["v_q"], tp["v_s"], _t(tables),
            _t(lengths)).numpy())


# ---------------------------------------------------------------------------
# RWorker: payloads coerced to the worker's storage, as in the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("payload", ["fp-payload", "int8-payload"])
def test_rworker_storage_matches_jax(paged, quantized, payload):
    """load_state of an fp or int8 payload (the latter the wire format of
    a quantized worker), then write_rows of a fresh fp prefix: the stored
    arrays (dense slabs or page pools) and block tables equal the JAX
    RWorker's."""
    rng = np.random.default_rng(11)
    jc = tiny_cfg("qwen3-8b")
    tc = ModelConfig(**dataclasses.asdict(jc))
    st = _int8_state(rng, 3, 12, 2, 8)
    new = _int8_state(rng, 1, 12, 2, 8)
    jst = {k: _j(v) for k, v in st.items()}
    tst = {k: _t(v) for k, v in st.items()}
    if payload == "int8-payload":
        jst, tst = JKV.quantize_attn_state(jst), TKV.quantize_attn_state(tst)
    kw = dict(quantized=quantized, paged=paged, page_size=4)
    jw = JHET.RWorker(0, jc, 0, 3, **kw)
    tw = THET.RWorker(0, tc, 0, 3, device="cpu", **kw)
    jw.load_state(0, jst)
    tw.load_state(0, tst)
    jw.write_rows(0, np.array([1]), {k: _j(v) for k, v in new.items()})
    tw.write_rows(0, np.array([1]), {k: _t(v) for k, v in new.items()})
    want, got = jw.state[0], tw.state[0]
    assert sorted(got) == sorted(want)
    assert ("k_q" in got) == quantized
    for name, w in want.items():
        g = got[name][:w.shape[0]] if paged else got[name]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if paged:
        np.testing.assert_array_equal(tw.allocators[0].tables,
                                      jw.allocators[0].tables)
