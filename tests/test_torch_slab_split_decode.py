"""The split-K model of the dense kernels (kernels 2 and 3) and of kernel
3's paged addressing against the JAX package, the slab split plan's
properties, and the paged int8 op's CPU path.

``kernels/ref.slab_split_attention_ref`` computes, per split of
``slots_per_split`` slab slots, the partial (m, l, acc) with the
kernel's masking (validity from ``pos``, never from the slot index) and
merges the partials as the merge kernel of ``csrc/decode_attention.cu``
does; for int8 storage it folds the scales into the products as the
kernel does (s = k_s * (q . k_q), acc += (p * v_s) * v_q).
``paged_split_attention_ref`` with int8 pools and their scales is the
model of the paged entry.  Both are held against ``repro.kernels.ref``
(``decode_attention_ref``, ``decode_attention_int8_ref``,
``paged_decode_attention_int8_ref``) and the Pallas kernels in interpret
mode on the same numpy inputs: GQA ratios 1/4/8, Dh 64/128, -1 holes, a
ring-ordered row under window + sink, softcap, a row with no valid slot
(exactly 0), a short row whose later splits hold no valid slot, and
splits of 1, 2 and 4 slots, of 16 slots (several slots per split as in
the kernel) and one split over the whole slab.  fp32 on the CPU;
tolerance 1e-5 absolute against the reference (the same fp32 online
softmax summed in another order, with the int8 scales applied after the
product rather than before) and 3e-5 against Pallas (the JAX package's
own bound, tests/test_kernels.py).  The split plan depends on shapes
alone; its properties are checked exactly."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro_torch.kernels import decode_attention as TDA
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import quant_kv as TQK
from repro_torch.kernels import ref as TREF

TOL = 1e-5
PALLAS_TOL = 3e-5
NEG_INF = -1e30
S = 50
_STATIC = ("window", "sink", "softcap")
_JREF = {"dense": jax.jit(JREF.decode_attention_ref, static_argnames=_STATIC),
         "int8": jax.jit(JREF.decode_attention_int8_ref,
                         static_argnames=_STATIC)}
_JREF_PAGED8 = jax.jit(JREF.paged_decode_attention_int8_ref,
                       static_argnames=_STATIC)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one intra-op thread, and the suite's
    other workers keep the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slab_case(seed, *, g, dh, hkv=2):
    """Four rows over an S=50 slab (no multiple of any split size here):
    row 0 holds positions 0..39 in order with -1 holes; row 1 a
    ring-ordered cache (positions 60..109 at slot pos % S); row 2 no
    valid slot at all (its output must be exactly 0); row 3 positions
    0..5 only, so every later split is empty.  int8 values and scales
    come from the fp values by the port's quantize_kv."""
    rng = np.random.default_rng(seed)
    pos = np.full((4, S), -1, np.int32)
    pos[0, :40] = np.arange(40)
    pos[0, [7, 8, 30]] = -1
    ring = np.arange(60, 110)
    pos[1, ring % S] = ring
    pos[3, :6] = np.arange(6)
    lengths = np.array([39, 109, 5, 5], np.int32)
    q = rng.standard_normal((4, hkv * g, dh)).astype(np.float32)
    k = rng.standard_normal((4, S, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((4, S, hkv, dh)).astype(np.float32)
    kq, ks = (x.numpy() for x in TQK.quantize_kv(torch.from_numpy(k)))
    vq, vs = (x.numpy() for x in TQK.quantize_kv(torch.from_numpy(v)))
    return dict(q=q, k=k, v=v, pos=pos, lengths=lengths, kq=kq, ks=ks,
                vq=vq, vs=vs)


OPTS = {"plain": {}, "window-sink": dict(window=24, sink=4),
        "softcap": dict(softcap=3.0)}
_JAX_CACHE = {}


def _jax_outputs(kernel, g, dh, opt):
    """(repro.kernels.ref, Pallas interpret) outputs of the case, cached
    per (kernel, g, dh, opt)."""
    key = (kernel, g, dh, opt)
    if key not in _JAX_CACHE:
        c = _slab_case(100 * g + dh, g=g, dh=dh)
        kw = OPTS[opt]
        j = {n: jnp.asarray(a) for n, a in c.items()}
        if kernel == "int8":
            args = (j["q"], j["kq"], j["ks"], j["vq"], j["vs"], j["pos"],
                    j["lengths"])
            pallas = JOPS.decode_attention_int8(*args, use_kernel="pallas",
                                                block_s=16, **kw)
        else:
            args = (j["q"], j["k"], j["v"], j["pos"], j["lengths"])
            pallas = JOPS.decode_attention(*args, use_kernel="pallas",
                                           block_s=16, **kw)
        _JAX_CACHE[key] = (np.asarray(_JREF[kernel](*args, **kw)),
                           np.asarray(pallas))
    return _JAX_CACHE[key]


def _slab_split(kernel, c, sps, **kw):
    t = {n: torch.from_numpy(a) for n, a in c.items()}
    if kernel == "int8":
        return TREF.slab_split_attention_ref(
            t["q"], t["kq"], t["vq"], t["pos"], t["lengths"],
            slots_per_split=sps, k_scale=t["ks"], v_scale=t["vs"],
            **kw).numpy()
    return TREF.slab_split_attention_ref(
        t["q"], t["k"], t["v"], t["pos"], t["lengths"], slots_per_split=sps,
        **kw).numpy()


@pytest.mark.parametrize("sps", [1, 2, 4, 16, None])
@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("kernel", ["dense", "int8"])
def test_slab_split_model_matches_jax_ref_and_pallas(kernel, g, dh, opt,
                                                     sps):
    c = _slab_case(100 * g + dh, g=g, dh=dh)
    got = _slab_split(kernel, c, sps or S, **OPTS[opt])
    want, pallas = _jax_outputs(kernel, g, dh, opt)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=PALLAS_TOL, rtol=0)
    assert np.all(got[2] == 0)              # no valid slot: exactly 0


@pytest.mark.parametrize("kernel", ["dense", "int8"])
def test_slab_split_empty_splits_carry_no_weight(kernel):
    """Splits with no valid slot for a row (row 3 past slot 5, row 0
    between the sink and the window, every split of row 2) carry m =
    NEG_INF, l = 0 and acc = 0, and the merge gives them weight 0 whatever
    their l and acc hold: garbage there changes no bit, and row 2 stays
    exactly 0, never NaN."""
    c = _slab_case(7, g=4, dh=64)
    t = {n: torch.from_numpy(a) for n, a in c.items()}
    kw = dict(window=24, sink=4)
    if kernel == "int8":
        args = (t["q"], t["kq"], t["vq"], t["pos"], t["lengths"])
        kw.update(k_scale=t["ks"], v_scale=t["vs"])
    else:
        args = (t["q"], t["k"], t["v"], t["pos"], t["lengths"])
    m, l, acc = TREF.slab_split_partials_ref(*args, slots_per_split=4, **kw)
    empty = m <= NEG_INF / 2
    assert bool(empty[:, 2].all())                    # row 2: every split
    assert bool(empty[2:, 3].all()) and not bool(empty[:2, 3].any())
    assert bool(empty[1:4, 0].all())      # row 0: slots 4..15 (sink 4,
    assert not bool(empty[0, 0].any())    # window 24 at query 39)
    assert bool((l[empty] == 0).all()) and bool((acc[empty] == 0).all())
    clean = TREF.merge_split_partials_ref(m, l, acc)
    dirty = TREF.merge_split_partials_ref(
        m, torch.where(empty, torch.full_like(l, 7.0), l),
        torch.where(empty[..., None], torch.full_like(acc, float("nan")),
                    acc))
    assert torch.equal(dirty, clean)
    assert bool((dirty[2] == 0).all()) and bool(dirty.isfinite().all())


def test_slab_split_model_needs_pos_not_the_slot_index():
    """Permuting the slots of a row (with its pos entries) changes no
    result: validity and order come from pos, as a ring stores them."""
    c = _slab_case(9, g=4, dh=64)
    perm = np.random.default_rng(0).permutation(S)
    p = dict(c)
    for n in ("k", "v", "kq", "vq", "pos", "ks", "vs"):
        p[n] = np.ascontiguousarray(c[n][:, perm])
    for kernel in ("dense", "int8"):
        np.testing.assert_allclose(_slab_split(kernel, p, 8),
                                   _slab_split(kernel, c, 8), atol=TOL,
                                   rtol=0)


# ---------------------------------------------------------------------------
# kernel 3's paged addressing: the int8 split model over pages
# ---------------------------------------------------------------------------
def _paged_int8_case(seed, *, g, page, dh=64, hkv=2):
    """Five rows: several pages, a short row, a row of length 0, a -1 hole
    and a page shared by two rows, one all-unmapped row (exactly 0), and
    two spare table pages past every row (empty trailing splits)."""
    rng = np.random.default_rng(seed)
    lengths = np.array([page * 5 + 1, 2, page * 7 - 1, 0, page * 3],
                       np.int32)
    need = [-(-(int(n) + 1) // page) for n in lengths]
    mp = max(need) + 2
    n_pages = sum(need) + 1
    perm = rng.permutation(n_pages).astype(np.int32)
    tables = np.full((5, mp), -1, np.int32)
    cur = 0
    for r in range(4):                          # row 4: all unmapped
        tables[r, :need[r]] = perm[cur:cur + need[r]]
        cur += need[r]
    tables[2, 3] = -1
    tables[1, 0] = tables[0, 2]
    q = rng.standard_normal((5, hkv * g, dh)).astype(np.float32)
    pk = torch.from_numpy(
        rng.standard_normal((n_pages, page, hkv, dh)).astype(np.float32))
    pv = torch.from_numpy(
        rng.standard_normal((n_pages, page, hkv, dh)).astype(np.float32))
    pkq, pks = TQK.quantize_kv(pk)
    pvq, pvs = TQK.quantize_kv(pv)
    return (torch.from_numpy(q), pkq, pks, pvq, pvs,
            torch.from_numpy(tables), torch.from_numpy(lengths))


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("pps", [1, 2, 4, None])
@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("g", [1, 4, 8])
def test_paged_int8_split_model_matches_jax(g, page, pps, opt):
    args = _paged_int8_case(10 * g + page, g=g, page=page)
    q, pkq, pks, pvq, pvs, tables, lengths = args
    kw = OPTS[opt]
    got = TREF.paged_split_attention_ref(
        q, pkq, pvq, tables, lengths, pages_per_split=pps or tables.shape[1],
        k_scale=pks, v_scale=pvs, **kw).numpy()
    want = np.asarray(_JREF_PAGED8(*(jnp.asarray(a.numpy()) for a in args),
                                   **kw))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    unsplit = TREF.paged_decode_attention_int8_ref(*args, **kw).numpy()
    np.testing.assert_allclose(got, unsplit, atol=TOL, rtol=0)
    assert np.all(got[4] == 0)              # all-unmapped row: exactly 0


def test_paged_int8_op_on_cpu_is_the_gather_chain_and_counted():
    """On CPU tensors ``ops.paged_decode_attention_int8`` is exactly
    ``ref.paged_decode_attention_int8_ref`` and counts one plain call, no
    launch of either addressing."""
    args = _paged_int8_case(3, g=4, page=4)
    before = (TQK.plain_calls.value, TQK.launches.value,
              TQK.paged_launches.value)
    for kw in ({}, dict(window=6, sink=2, softcap=3.0)):
        out = TOPS.paged_decode_attention_int8(*args, **kw)
        want = TREF.paged_decode_attention_int8_ref(*args, **kw)
        torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert (TQK.plain_calls.value, TQK.launches.value,
            TQK.paged_launches.value) == (before[0] + 2, before[1],
                                          before[2])


def _misaligned(t):
    flat = torch.zeros(t.numel() + 16, dtype=t.dtype)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("bad", ["q_dtype", "pool_dtype", "scale_dtype",
                                 "scale_shape", "pool_shape", "noncontig",
                                 "misaligned", "head_dim", "gqa",
                                 "tables_dtype", "batch"])
def test_paged_int8_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, pkq, pks, pvq, pvs, tables, lengths = _paged_int8_case(
        4, g=2, page=4)
    a = dict(q=q, pk_q=pkq, pk_s=pks, pv_q=pvq, pv_s=pvs, tables=tables,
             lengths=lengths)
    TQK._check_paged(**a)
    if bad == "q_dtype":
        a["q"] = q.to(torch.float16)
    elif bad == "pool_dtype":
        a["pv_q"] = pvq.to(torch.float32)
    elif bad == "scale_dtype":
        a["pk_s"] = pks.double()
    elif bad == "scale_shape":
        a["pv_s"] = pvs[:, :, :1].contiguous()
    elif bad == "pool_shape":
        a["pv_q"] = pvq[1:].contiguous()
    elif bad == "noncontig":
        a["pk_q"] = pkq.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "misaligned":
        a["pk_q"] = _misaligned(pkq)
        assert a["pk_q"].data_ptr() % 16
    elif bad == "head_dim":
        a["q"] = torch.zeros(q.shape[:2] + (32,))
    elif bad == "gqa":
        a["q"] = q[:, :3].contiguous()
    elif bad == "tables_dtype":
        a["tables"] = tables.long()
    elif bad == "batch":
        a["lengths"] = lengths[:3].contiguous()
    with pytest.raises((TypeError, ValueError)):
        TQK._check_paged(**a)


# ---------------------------------------------------------------------------
# the slab split plan
# ---------------------------------------------------------------------------
SLAB_PLAN_GRID = [(b, hkv, g, s, sms) for b in (1, 2, 8, 64)
                  for hkv in (1, 2, 8) for g in (1, 4, 8, 16)
                  for s in (1, 50, 300, 1024, 4096, 20000) for sms in (8, 132)]


# recurrentgemma-2b's windowed heads (Hkv 1, G 10): its int8 serve's
# per-worker call (2 rows, S 1024) and 64 rows over the 2048-slot window
HYBRID_PLAN_SHAPES = [(2, 1, 10, 1024, 132), (64, 1, 10, 2048, 132)]


@pytest.mark.parametrize("b,hkv,g,s,sms",
                         SLAB_PLAN_GRID[::11] + HYBRID_PLAN_SHAPES)
def test_slab_plan_covers_every_slot_once(b, hkv, g, s, sms):
    sps, n = TDA.slab_plan(b, hkv, g, s, sms)
    assert 1 <= sps <= min(s, TDA.MAX_SPLIT_SLOTS)
    assert n * sps >= s and (n - 1) * sps < s     # no empty slab split
    covered = np.zeros(s, int)
    for i in range(n):
        covered[i * sps:(i + 1) * sps] += 1
    assert np.all(covered == 1)
    if b * hkv * TPA.row_groups(1, g) >= sms and s <= TDA.MAX_SPLIT_SLOTS:
        assert n == 1                    # the grid already fills the SMs
    if n > 1 and s <= TDA.MAX_SPLIT_SLOTS:
        assert sps >= TPA.SPLIT_MIN_TOKENS


@pytest.mark.parametrize("b,hkv,g,s,sms",
                         SLAB_PLAN_GRID[5::23] + HYBRID_PLAN_SHAPES)
@pytest.mark.parametrize("dh", [128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_slab_plan_covers_every_slot_once(b, hkv, g, s, sms, dh,
                                               dtype):
    """Kernel 3's slab entry plans its splits for its own row groups
    (``quant_kv.slab_row_groups``: 16 query heads per CTA with a bf16 q at
    Dh 256, else 8): every slot once, no empty split, one split where its
    grid fills the SMs, and the CTAs it launches per (row, kv-head, split)
    as the C side chooses them."""
    q = torch.zeros((b, hkv * g, dh), dtype=dtype)
    kq = torch.zeros((b, s, hkv, dh), dtype=torch.int8)
    TPA._SM_COUNT[q.device] = sms
    try:
        sps, n = TQK.slab_plan(q, kq)
    finally:
        del TPA._SM_COUNT[q.device]
    groups = TQK.slab_row_groups(g, dh, dtype)
    assert groups == -(-g // (16 if dtype == torch.bfloat16 and dh == 256
                              else 8))
    wide = dtype == torch.bfloat16 and dh == 256
    assert (sps, n) == TPA.capped_split_plan(b, hkv, groups, s, 1, sms,
                                             TDA.MAX_SPLIT_SLOTS,
                                             one_wave=wide)
    if wide and n > 1:
        # one wave of at most SPLIT_CTAS_PER_SM CTAs per SM
        assert b * hkv * n <= TPA.SPLIT_CTAS_PER_SM * sms or \
            sps == TPA.SPLIT_MIN_TOKENS or sps == TDA.MAX_SPLIT_SLOTS
    assert 1 <= sps <= min(s, TDA.MAX_SPLIT_SLOTS)
    assert n * sps >= s and (n - 1) * sps < s
    if b * hkv * groups >= sms and s <= TDA.MAX_SPLIT_SLOTS:
        assert n == 1
    if n > 1 and s <= TDA.MAX_SPLIT_SLOTS:
        assert sps >= TPA.SPLIT_MIN_TOKENS


def test_slab_plan_at_the_serve_and_bandwidth_shapes():
    """The dense-int8 serve's per-worker call (2 rows, 8 kv-heads, G 4,
    S = 1024) splits into 16 splits of 64 slots (256 CTAs in place of the
    first version's 16); 64 rows x 4096 slots is one split; the paged
    entry takes kernel 1's plan over the table."""
    assert TDA.slab_plan(2, 8, 4, 1024, 132) == (64, 16)
    assert TDA.slab_plan(64, 8, 4, 4096, 132) == (4096, 1)
    q = torch.zeros((2, 32, 128))
    pool = torch.zeros((129, 16, 8, 128), dtype=torch.int8)
    tables = torch.zeros((2, 64), dtype=torch.int32)
    TPA._SM_COUNT[q.device] = 132
    try:
        assert TQK.paged_plan(q, pool, tables) == TPA.split_plan(
            2, 8, 1, 64, 16, 132) == (4, 16)
    finally:
        del TPA._SM_COUNT[q.device]


def test_slab_plan_depends_on_shapes_only():
    """The plans take no lengths and no pos (they live on the card), so
    they need no host sync; the wrappers' plans read only shapes and the
    SM count."""
    assert list(inspect.signature(TDA.slab_plan).parameters) == [
        "b", "hkv", "g", "s_len", "sm_count"]
    for fn in (TDA.kernel_plan, TQK.paged_plan):
        src = inspect.getsource(fn)
        assert "lengths" not in src and "pos" not in src
        assert ".shape" in src
    assert TDA.slab_plan(3, 2, 4, 300, 132) == TDA.slab_plan(3, 2, 4, 300,
                                                             132)
