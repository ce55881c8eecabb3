"""Plain PyTorch versions of the port's kernels.

They reuse the chunked flash attention of ``repro_torch.models.layers``,
the same function the model's decode path runs, so kernel == ref also
implies kernel == model (as ``repro/kernels/ref.py`` does for the JAX
package).  The CPU tests run them; ``chip_smoke.py`` holds the Hopper
kernel against them on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L


def decode_attention_ref(q, k, v, pos, lengths, *, window: int = 0,
                         sink: int = 0, softcap: float = 0.0):
    """q [B,Hq,Dh]; k,v [B,S,Hkv,Dh]; pos [B,S]; lengths [B] -> [B,Hq,Dh]."""
    o = L.flash_attention(q[:, None], k, v, lengths[:, None].to(torch.int32),
                          pos, causal=True, window=window, sink=sink,
                          softcap=softcap)
    return o[:, 0]


def decode_attention_int8_ref(q, k_q, k_scale, v_q, v_scale, pos, lengths,
                              *, window: int = 0, sink: int = 0,
                              softcap: float = 0.0):
    """Dequantize in fp32 (``quant_kv.dequantize_kv``, written out here so
    this module imports no kernel wrapper), cast to q.dtype, then
    ``decode_attention_ref``."""
    k = (k_q.to(torch.float32) * k_scale[..., None]).to(q.dtype)
    v = (v_q.to(torch.float32) * v_scale[..., None]).to(q.dtype)
    return decode_attention_ref(q, k, v, pos, lengths, window=window,
                                sink=sink, softcap=softcap)


def paged_gather(pages, tables):
    """pages [P,page,...]; tables [B,MP] int32 -> ([B, MP*page, ...],
    [B, MP*page] slot-derived positions, -1 on unmapped pages)."""
    b, mp = tables.shape
    page = pages.shape[1]
    safe = torch.clamp(tables, min=0).long()
    out = pages[safe]                                    # [B, MP, page, ...]
    pos = torch.arange(mp * page, dtype=torch.int32,
                       device=pages.device).reshape(1, mp, page)
    pos = torch.where((tables >= 0)[:, :, None], pos,
                      torch.full((), -1, dtype=torch.int32,
                                 device=pages.device))
    return (out.reshape(b, mp * page, *pages.shape[2:]),
            pos.reshape(b, mp * page))


def paged_decode_attention_ref(q, pages_k, pages_v, tables, lengths, *,
                               window: int = 0, sink: int = 0,
                               softcap: float = 0.0):
    """q [B,Hq,Dh]; pages_k/v [P,page,Hkv,Dh]; tables [B,MP];
    lengths [B] -> [B,Hq,Dh]."""
    k, pos = paged_gather(pages_k, tables)
    v, _ = paged_gather(pages_v, tables)
    return decode_attention_ref(q, k.to(q.dtype), v.to(q.dtype), pos,
                                lengths, window=window, sink=sink,
                                softcap=softcap)


def paged_decode_attention_int8_ref(q, pk_q, pk_s, pv_q, pv_s, tables,
                                    lengths, *, window: int = 0,
                                    sink: int = 0, softcap: float = 0.0):
    """Int8 page pools: values [P,page,Hkv,Dh] int8 + scales [P,page,Hkv]."""
    k_q, pos = paged_gather(pk_q, tables)
    k_s, _ = paged_gather(pk_s, tables)
    v_q, _ = paged_gather(pv_q, tables)
    v_s, _ = paged_gather(pv_s, tables)
    return decode_attention_int8_ref(q, k_q, k_s, v_q, v_s, pos, lengths,
                                     window=window, sink=sink,
                                     softcap=softcap)


# ---------------------------------------------------------------------------
# speculative-decode verify: T candidate queries per row in one sweep.
# Query t of row b sits at absolute position lengths[b] + t (``lengths`` is
# the row's token count BEFORE the verify step, the base the candidates
# were written at), so decode's ``pos <= lengths`` becomes
# ``pos <= lengths + t`` per query.  T == 1 is the decode plain version.
# ---------------------------------------------------------------------------
def verify_attention_ref(q, k, v, pos, lengths, *, window: int = 0,
                         sink: int = 0, softcap: float = 0.0,
                         kv_chunk: int = 1024):
    """q [B,T,Hq,Dh]; k,v [B,S,Hkv,Dh]; pos [B,S]; lengths [B]
    -> [B,T,Hq,Dh]."""
    t = q.shape[1]
    qpos = (lengths[:, None].to(torch.int32)
            + torch.arange(t, dtype=torch.int32, device=q.device)[None, :])
    return L.flash_attention(q, k, v, qpos, pos, causal=True, window=window,
                             sink=sink, softcap=softcap,
                             kv_chunk=max(k.shape[1], kv_chunk))


def paged_verify_attention_ref(q, pages_k, pages_v, tables, lengths, *,
                               window: int = 0, sink: int = 0,
                               softcap: float = 0.0, kv_chunk: int = 1024):
    """q [B,T,Hq,Dh]; pages_k/v [P,page,Hkv,Dh]; tables [B,MP];
    lengths [B] -> [B,T,Hq,Dh]."""
    k, pos = paged_gather(pages_k, tables)
    v, _ = paged_gather(pages_v, tables)
    return verify_attention_ref(q, k.to(q.dtype), v.to(q.dtype), pos,
                                lengths, window=window, sink=sink,
                                softcap=softcap, kv_chunk=kv_chunk)


def verify_attention_int8_ref(q, k_q, k_scale, v_q, v_scale, pos, lengths,
                              *, window: int = 0, sink: int = 0,
                              softcap: float = 0.0, kv_chunk: int = 1024):
    """``verify_attention_ref`` over int8 K/V [B,S,Hkv,Dh] with fp32
    scales [B,S,Hkv], dequantized in fp32 and cast to q.dtype first (as
    ``decode_attention_int8_ref``)."""
    k = (k_q.to(torch.float32) * k_scale[..., None]).to(q.dtype)
    v = (v_q.to(torch.float32) * v_scale[..., None]).to(q.dtype)
    return verify_attention_ref(q, k, v, pos, lengths, window=window,
                                sink=sink, softcap=softcap,
                                kv_chunk=kv_chunk)


def paged_verify_attention_int8_ref(q, pk_q, pk_s, pv_q, pv_s, tables,
                                    lengths, *, window: int = 0,
                                    sink: int = 0, softcap: float = 0.0,
                                    kv_chunk: int = 1024):
    """Int8 page pools (values [P,page,Hkv,Dh] int8 + scales
    [P,page,Hkv]) gathered into a per-row slab, then
    ``verify_attention_int8_ref``: the plain version of kernel 3's
    multi-token paged entry."""
    k_q, pos = paged_gather(pk_q, tables)
    k_s, _ = paged_gather(pk_s, tables)
    v_q, _ = paged_gather(pv_q, tables)
    v_s, _ = paged_gather(pv_s, tables)
    return verify_attention_int8_ref(q, k_q, k_s, v_q, v_s, pos, lengths,
                                     window=window, sink=sink,
                                     softcap=softcap, kv_chunk=kv_chunk)


# ---------------------------------------------------------------------------
# split-K (flash-decoding) model of csrc/paged_attention.cu and
# csrc/decode_attention.cu (T query tokens per row for kernel 4 and kernel
# 3's multi-token entry): split s owns table pages [s*pps, (s+1)*pps) of a
# pool, or slots [s*sps, (s+1)*sps) of a slab; each split yields a partial
# (m, l, acc) with the kernel's masking (a masked score has p = 0, so a
# split with no valid key for a query carries m = NEG_INF, l = 0, acc = 0),
# and the merge combines the partials in split order, an empty partial (m <=
# NEG_INF/2) weighing 0 whatever its l and acc hold.  Int8 storage folds the
# scales into the products as the kernel does: s = k_s * (q . k_q) and acc
# += (p * v_s) * v_q.  Tests hold it against the JAX reference and the
# unsplit plain versions above; no serving path runs it.
# ---------------------------------------------------------------------------
def _split_partial(qg, qpos, k, v, kpos, *, window, sink, softcap,
                   k_s=None, v_s=None):
    """One split's partial.  qg [B,T,Hkv,G,Dh] fp32 (scaled); qpos [B,T];
    k, v [B,n,Hkv,Dh] (storage values); kpos [B,n] (-1 = empty); k_s, v_s
    [B,n,Hkv] fp32 or None -> m, l [B,T,Hq] and acc [B,T,Hq,Dh] fp32."""
    b, t, hkv, g, dh = qg.shape
    f32 = torch.float32
    s = torch.einsum("bthgd,bshd->bthgs", qg, k.to(f32))
    if k_s is not None:
        s = s * k_s.permute(0, 2, 1)[:, None, :, None, :]
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    msk = L._mask(qpos, kpos, causal=True, window=window,
                  sink=sink)[:, :, None, None, :]         # [B,T,1,1,n]
    s = torch.where(msk, s, torch.tensor(L.NEG_INF, dtype=f32))
    m = s.amax(dim=-1)
    p = torch.where(msk, torch.exp(s - m[..., None]),
                    torch.zeros((), dtype=f32))
    l = p.sum(dim=-1)
    if v_s is not None:
        p = p * v_s.permute(0, 2, 1)[:, None, :, None, :]
    acc = torch.einsum("bthgs,bshd->bthgd", p, v.to(f32))
    return (m.reshape(b, t, hkv * g), l.reshape(b, t, hkv * g),
            acc.reshape(b, t, hkv * g, dh))


def _scaled_q(q, hkv):
    b, t, hq, dh = q.shape
    return q.to(torch.float32).reshape(b, t, hkv, hq // hkv, dh) \
        / math.sqrt(dh)


def paged_split_partials_ref(q, pages_k, pages_v, tables, lengths, *,
                             pages_per_split: int, window: int = 0,
                             sink: int = 0, softcap: float = 0.0,
                             k_scale=None, v_scale=None):
    """q [B,T,Hq,Dh] (query t at position lengths[b] + t) -> fp32
    (m [S,B,T,Hq], l [S,B,T,Hq], acc [S,B,T,Hq,Dh]), acc not normalized,
    S = ceil(MP / pages_per_split).  Int8 pools pass their scales
    [P,page,Hkv] as ``k_scale`` / ``v_scale``."""
    t = q.shape[1]
    mp, page, hkv = tables.shape[1], pages_k.shape[1], pages_k.shape[2]
    qg = _scaled_q(q, hkv)
    qpos = (lengths[:, None].to(torch.int32)
            + torch.arange(t, dtype=torch.int32, device=q.device)[None, :])
    parts = []
    for lo in range(0, mp, pages_per_split):
        tb = tables[:, lo:lo + pages_per_split]
        k, kpos = paged_gather(pages_k, tb)
        v, _ = paged_gather(pages_v, tb)
        kpos = torch.where(kpos >= 0, kpos + lo * page, kpos)
        scales = {}
        if k_scale is not None:
            scales = dict(k_s=paged_gather(k_scale, tb)[0],
                          v_s=paged_gather(v_scale, tb)[0])
        parts.append(_split_partial(qg, qpos, k, v, kpos, window=window,
                                    sink=sink, softcap=softcap, **scales))
    return tuple(torch.stack(x) for x in zip(*parts))


def slab_split_partials_ref(q, k, v, pos, lengths, *, slots_per_split: int,
                            window: int = 0, sink: int = 0,
                            softcap: float = 0.0, k_scale=None,
                            v_scale=None):
    """The dense kernels' split: q [B,Hq,Dh] (one query at lengths[b]);
    k, v [B,S,Hkv,Dh] with pos [B,S] (validity from pos, never from the
    slot index) -> fp32 (m [n,B,Hq], l [n,B,Hq], acc [n,B,Hq,Dh]), n =
    ceil(S / slots_per_split).  Int8 slabs pass their scales [B,S,Hkv]."""
    qg = _scaled_q(q[:, None], k.shape[2])
    qpos = lengths[:, None].to(torch.int32)
    parts = []
    for lo in range(0, k.shape[1], slots_per_split):
        sl = slice(lo, lo + slots_per_split)
        scales = {}
        if k_scale is not None:
            scales = dict(k_s=k_scale[:, sl], v_s=v_scale[:, sl])
        m, l, acc = _split_partial(qg, qpos, k[:, sl], v[:, sl], pos[:, sl],
                                   window=window, sink=sink,
                                   softcap=softcap, **scales)
        parts.append((m[:, 0], l[:, 0], acc[:, 0]))
    return tuple(torch.stack(x) for x in zip(*parts))


def merge_split_partials_ref(m, l, acc):
    """Partials of a split model ([S, ...] m, l and [S, ..., Dh] acc) ->
    [..., Dh] fp32; a query whose every partial is empty gives exactly
    0."""
    mx = m.amax(dim=0)
    live = m > L.NEG_INF / 2
    w = torch.where(live, torch.exp(m - mx), torch.zeros((), dtype=m.dtype))
    lsum = (w * l).sum(dim=0)
    o = torch.where(live[..., None], w[..., None] * acc,
                    torch.zeros((), dtype=acc.dtype)).sum(dim=0)
    return torch.where((mx > L.NEG_INF / 2)[..., None],
                       o / torch.clamp(lsum, min=1e-30)[..., None],
                       torch.zeros((), dtype=o.dtype))


def paged_split_attention_ref(q, pages_k, pages_v, tables, lengths, *,
                              pages_per_split: int, window: int = 0,
                              sink: int = 0, softcap: float = 0.0,
                              k_scale=None, v_scale=None):
    """The paged split model end to end: q [B,Hq,Dh] (decode) or
    [B,T,Hq,Dh] (verify) -> the same shape in q.dtype."""
    q4 = q[:, None] if q.dim() == 3 else q
    out = merge_split_partials_ref(*paged_split_partials_ref(
        q4, pages_k, pages_v, tables, lengths,
        pages_per_split=pages_per_split, window=window, sink=sink,
        softcap=softcap, k_scale=k_scale, v_scale=v_scale))
    return (out[:, 0] if q.dim() == 3 else out).to(q.dtype)


def slab_split_attention_ref(q, k, v, pos, lengths, *, slots_per_split: int,
                             window: int = 0, sink: int = 0,
                             softcap: float = 0.0, k_scale=None,
                             v_scale=None):
    """The slab split model end to end: q [B,Hq,Dh] -> [B,Hq,Dh] in
    q.dtype."""
    return merge_split_partials_ref(*slab_split_partials_ref(
        q, k, v, pos, lengths, slots_per_split=slots_per_split,
        window=window, sink=sink, softcap=softcap, k_scale=k_scale,
        v_scale=v_scale)).to(q.dtype)


# ---------------------------------------------------------------------------
# the order of operations of kernel 3's 16-row tensor-core engine
# (csrc/decode_attention.cu ``Mma16Engine``: the slab entry at Dh 256 with a
# bf16 q, the multi-token entry at T*G > 8).  Each split walks its slots in
# tiles of 64 from its first slot; per tile: scores k_s * scale * (q . k_q)
# with q as bf16 (the kernel's fp16 q, scaled by a power of two per row,
# holds the same values), the tile's max per query row taken over the whole
# tile (the 4 warps share one running m), p = exp(s - m), P' = p * v_s *
# 2^T split into fp16 hi + lo, with 2^T a running power of two per (row,
# kv-head) lowered when the tile's largest v_s (over the slots it loads)
# would take P' past 2^15, and O += V^T hi + V^T lo computed by quarters of
# the output dims (each warp owns one), O / 2^T at the end; then the split
# merge.  Tests hold it against the JAX package; no serving path runs it.
# ---------------------------------------------------------------------------
MMA16_TILE = 64


def _pow2_below(x):
    """2^(14 - floor(log2 x)) (at most 2^126) where x > 0, else inf: the
    power of two that takes x into [2^14, 2^15)."""
    _, e = torch.frexp(x)
    t = torch.ldexp(torch.ones_like(x), torch.clamp(15 - e, max=126))
    return torch.where(x > 0, t, torch.full_like(x, math.inf))


def int8_mma16_attention_ref(q, k_q, k_s, v_q, v_s, kpos, qpos, *,
                             slots_per_split: int, window: int = 0,
                             sink: int = 0, softcap: float = 0.0):
    """q [B,T,Hq,Dh] (read as bf16); k_q, v_q int8 [B,S,Hkv,Dh]; k_s, v_s
    fp32 [B,S,Hkv]; kpos [B,S] each slot's position (-1 = empty; a paged
    pool gathered by ``paged_gather``); qpos [B,T] each query's position ->
    [B,T,Hq,Dh] fp32."""
    f32 = torch.float32
    b, t, hq, dh = q.shape
    s_len, hkv = k_q.shape[1], k_q.shape[2]
    g = hq // hkv
    qg = q.to(torch.bfloat16).to(f32).reshape(b, t, hkv, g, dh)
    scale = 1.0 / math.sqrt(dh)
    quarter = dh // 4
    parts = []
    for lo in range(0, s_len, slots_per_split):
        m = torch.full((b, t, hkv, g), L.NEG_INF, dtype=f32)
        l = torch.zeros((b, t, hkv, g), dtype=f32)
        acc = torch.zeros((b, t, hkv, g, dh), dtype=f32)
        ps = torch.full((b, hkv), 2.0 ** 126, dtype=f32)
        for t0 in range(lo, min(lo + slots_per_split, s_len), MMA16_TILE):
            sl = slice(t0, min(t0 + MMA16_TILE, lo + slots_per_split, s_len))
            kt = k_q[:, sl].to(f32)                  # [B,n,Hkv,Dh]
            vt = v_q[:, sl].to(f32)
            sc = torch.einsum("bthgd,bnhd->bthgn", qg, kt) \
                * (k_s[:, sl] * scale).permute(0, 2, 1)[:, None, :, None, :]
            if softcap > 0.0:
                sc = softcap * torch.tanh(sc / softcap)
            msk = L._mask(qpos, kpos[:, sl], causal=True, window=window,
                          sink=sink)[:, :, None, None, :]
            sc = torch.where(msk, sc, torch.tensor(L.NEG_INF, dtype=f32))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.where(msk, torch.exp(sc - m_new[..., None]),
                            torch.zeros((), dtype=f32))
            cm = torch.exp(m - m_new)
            l = l * cm + p.sum(dim=-1)
            # the slots the kernel loads: those some query sees
            loaded = msk[:, :, 0, 0, :].any(dim=1)            # [B,n]
            vmax = torch.where(loaded[..., None], v_s[:, sl],
                               torch.zeros((), dtype=f32)).amax(dim=1)
            ps_new = torch.minimum(ps, _pow2_below(vmax))
            pratio = (ps_new / ps)[:, None, :, None]
            ps = ps_new
            sv = (v_s[:, sl] * ps[:, None, :]).permute(0, 2, 1)
            pv = p * sv[:, None, :, None, :]
            hi = pv.to(torch.float16).to(f32)
            lo_ = (pv - hi).to(torch.float16).to(f32)
            acc = acc * (cm * pratio)[..., None]
            acc = torch.cat([
                acc[..., w * quarter:(w + 1) * quarter]
                + torch.einsum("bthgn,bnhd->bthgd", hi,
                               vt[..., w * quarter:(w + 1) * quarter])
                + torch.einsum("bthgn,bnhd->bthgd", lo_,
                               vt[..., w * quarter:(w + 1) * quarter])
                for w in range(4)], dim=-1)
            m = m_new
        acc = acc / ps[:, None, :, None, None]
        parts.append((m.reshape(b, t, hq), l.reshape(b, t, hq),
                      acc.reshape(b, t, hq, dh)))
    return merge_split_partials_ref(*(torch.stack(x) for x in zip(*parts)))


# ---------------------------------------------------------------------------
# the order of operations of the tokens-as-M tensor-core engine for bf16
# K/V (csrc/tc_decode.cuh ``Bf16MmaEngine``: kernel 1's decode and kernel 2
# with a bf16 q).  Each split walks its slots in 64-row tiles cut from the
# start of each run of slots it reads (a slab split's [lo, hi); a paged
# split's part inside the sink, then its part inside the window, up to the
# query, as csrc/paged_attention.cu's ``make_span``); warp w of a tile owns
# its rows 16w..16w+15 and keeps its own online softmax: scores q . k in
# fp32 from bf16 q and K (unscaled), times 1/sqrt(Dh), then the softcap and
# the mask, the max over the warp's 16 rows, p = exp(s - m) split into bf16
# hi + lo, acc += V^T hi + V^T lo; the 4 warps' states merge at the end of
# the split, then the split merge.  Tests hold it against the JAX package;
# no serving path runs it.
# ---------------------------------------------------------------------------
BF16_MMA_TILE = 64
BF16_MMA_WARP_ROWS = 16


def _round32(x):
    """A sum, a product or a transcendental of the bf16 engine's model,
    taken in fp64 and rounded once to fp32: the correctly rounded fp32
    value on any host, whatever order its BLAS or vector unit would sum
    fp32 in."""
    return x.to(torch.float32)


def _bf16_mma_split(qg, k, v, kpos, qpos, idx, *, window, sink, softcap):
    """One split's partial.  qg [B,Hkv,G,Dh] fp32 (bf16 values); k, v
    [B,S,Hkv,Dh]; kpos [B,S] (-1 = empty or unmapped); qpos [B]; idx [B,n]
    the slot each tile row holds (-1: none), n a multiple of the tile ->
    m, l [B,Hq] and acc [B,Hq,Dh] fp32.  Every dot product, sum and
    exponential is taken in fp64 and rounded to fp32 where the kernel
    holds an fp32 value (``_round32``), so the model is the same on every
    host."""
    f32, f64 = torch.float32, torch.float64
    b, hkv, g, dh = qg.shape
    nw = BF16_MMA_TILE // BF16_MMA_WARP_ROWS
    scale = 1.0 / math.sqrt(dh)
    m = torch.full((b, hkv, g, nw), L.NEG_INF, dtype=f32)
    l = torch.zeros((b, hkv, g, nw), dtype=f32)
    acc = torch.zeros((b, hkv, g, nw, dh), dtype=f32)
    rows = torch.arange(b)[:, None]
    neg = torch.tensor(L.NEG_INF, dtype=f32)
    q64 = qg.to(f64)
    for t0 in range(0, idx.shape[1], BF16_MMA_TILE):
        ti = idx[:, t0:t0 + BF16_MMA_TILE]                       # [B,64]
        sl = ti.clamp(min=0).long()
        kp = torch.where(ti >= 0, kpos[rows, sl], torch.full_like(ti, -1))
        seen = L._mask(qpos[:, None], kp, causal=True, window=window,
                       sink=sink)[:, 0]                          # [B,64]
        # rows the kernel does not load are zero-filled, never read
        shape = (b, nw, BF16_MMA_WARP_ROWS, hkv, dh)
        zero = torch.zeros((), dtype=f64)
        kt = torch.where(seen[..., None, None], k[rows, sl].to(f64),
                         zero).reshape(shape)
        vt = torch.where(seen[..., None, None], v[rows, sl].to(f64),
                         zero).reshape(shape)
        msk = seen.reshape(b, 1, 1, nw, -1)
        s = _round32(torch.einsum("bhgd,bwrhd->bhgwr", q64, kt)) * scale
        if softcap > 0.0:
            s = softcap * _round32(torch.tanh((s / softcap).to(f64)))
        s = torch.where(msk, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(msk,
                        _round32(torch.exp((s - m_new[..., None]).to(f64))),
                        torch.zeros((), dtype=f32))
        corr = _round32(torch.exp((m - m_new).to(f64)))
        l = l * corr + _round32(p.to(f64).sum(dim=-1))
        hi = p.to(torch.bfloat16).to(f64)
        lo = (p - hi.to(f32)).to(torch.bfloat16).to(f64)
        acc = (acc * corr[..., None]
               + _round32(torch.einsum("bhgwr,bwrhd->bhgwd", hi, vt))
               + _round32(torch.einsum("bhgwr,bwrhd->bhgwd", lo, vt)))
        m = m_new
    mx = m.amax(dim=-1)
    live = m > L.NEG_INF / 2
    w = torch.where(live, _round32(torch.exp((m - mx[..., None]).to(f64))),
                    torch.zeros((), dtype=f32))
    ls = _round32((l * w).to(f64).sum(dim=-1))
    o = _round32(torch.where(live[..., None], acc * w[..., None],
                         torch.zeros((), dtype=f32)).to(f64).sum(dim=-2))
    hq = hkv * g
    return mx.reshape(b, hq), ls.reshape(b, hq), o.reshape(b, hq, dh)


def _tile_rows(runs, b):
    """[B, n] slot indices (-1: none) of the tiles cut from the start of
    each run [a, e) of every row (``runs`` [B] lists of (a, e))."""
    per_row = []
    for row in runs:
        idx = []
        for a, e in row:
            n = -(-(e - a) // BF16_MMA_TILE) * BF16_MMA_TILE
            idx += [a + r if a + r < e else -1 for r in range(n)]
        per_row.append(idx)
    width = max(BF16_MMA_TILE, max(len(x) for x in per_row))
    width = -(-width // BF16_MMA_TILE) * BF16_MMA_TILE
    return torch.tensor([x + [-1] * (width - len(x)) for x in per_row],
                        dtype=torch.int64).reshape(b, width)


def _bf16_mma(q, k, v, kpos, lengths, runs_of_split, n_splits, *, window,
              sink, softcap):
    b, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.to(torch.bfloat16).to(torch.float32).reshape(b, hkv, hq // hkv,
                                                        dh)
    qpos = lengths.to(torch.int32)
    parts = [_bf16_mma_split(qg, k, v, kpos, qpos,
                             _tile_rows(runs_of_split(s), b), window=window,
                             sink=sink, softcap=softcap)
             for s in range(n_splits)]
    # the split merge (merge_splits), its sums in fp64 as above
    f32, f64 = torch.float32, torch.float64
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    mx = m.amax(dim=0)
    live = m > L.NEG_INF / 2
    w = torch.where(live, _round32(torch.exp((m - mx).to(f64))),
                    torch.zeros((), dtype=f32))
    lsum = _round32((w * l).to(f64).sum(dim=0))
    o = _round32(torch.where(live[..., None], w[..., None] * acc,
                             torch.zeros((), dtype=f32)).to(f64).sum(dim=0))
    return torch.where((mx > L.NEG_INF / 2)[..., None],
                       o / torch.clamp(lsum, min=1e-30)[..., None],
                       torch.zeros((), dtype=f32))


def bf16_mma_slab_ref(q, k, v, pos, lengths, *, slots_per_split: int,
                      window: int = 0, sink: int = 0, softcap: float = 0.0):
    """Kernel 2's order on the tensor-core engine: q [B,Hq,Dh] (read as
    bf16); k, v bf16 [B,S,Hkv,Dh]; pos [B,S] (-1 = empty; validity from
    pos, never from the slot index); lengths [B] -> [B,Hq,Dh] fp32.  Split
    s reads slots [s*sps, (s+1)*sps) in tiles cut from its first slot."""
    b, s_len = pos.shape
    n_splits = -(-s_len // slots_per_split)

    def runs(s):
        lo = s * slots_per_split
        return [[(lo, min(lo + slots_per_split, s_len))]] * b
    return _bf16_mma(q.cpu(), k.cpu(), v.cpu(), pos.cpu(), lengths.cpu(),
                     runs, n_splits, window=window, sink=sink,
                     softcap=softcap)


def bf16_mma_paged_ref(q, pages_k, pages_v, tables, lengths, *,
                       pages_per_split: int, window: int = 0, sink: int = 0,
                       softcap: float = 0.0):
    """Kernel 1's order on the tensor-core engine: q [B,Hq,Dh] (read as
    bf16); pages_k/v bf16 [P,page,Hkv,Dh]; tables [B,MP] (-1 = unmapped);
    lengths [B] -> [B,Hq,Dh] fp32.  Split s owns table pages [s*pps,
    (s+1)*pps) and reads, of the positions up to the query, its part inside
    the sink and then its part inside the window, each in tiles cut from
    its start (``make_span``)."""
    tables, lengths = tables.cpu(), lengths.cpu()
    k, kpos = paged_gather(pages_k.cpu(), tables)
    v, _ = paged_gather(pages_v.cpu(), tables)
    b, mp = tables.shape
    page = pages_k.shape[1]
    pps = pages_per_split
    n_splits = -(-mp // pps)

    def runs(s):
        out = []
        for r in range(b):
            base = int(lengths[r])
            last = min(base, mp * page - 1)
            lo = s * pps * page
            hi = min(min((s + 1) * pps, mp) * page, last + 1)
            if window <= 0:
                out.append([(lo, max(hi, lo))])
                continue
            e1 = max(lo, min(hi, sink))
            a2 = max(lo, base - window + 1, e1)
            out.append([(lo, e1), (a2, max(hi, a2))])
        return out
    return _bf16_mma(q.cpu(), k, v, kpos, lengths, runs, n_splits,
                     window=window, sink=sink, softcap=softcap)
