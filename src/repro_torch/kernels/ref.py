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


# ---------------------------------------------------------------------------
# split-K (flash-decoding) model of csrc/paged_attention.cu: split s owns
# table pages [s*pps, (s+1)*pps); each split yields a partial (m, l, acc)
# with the kernel's masking (a masked score has p = 0, so a split with no
# valid key for a query carries m = NEG_INF, l = 0, acc = 0), and the merge
# combines the partials in split order, an empty partial (m <= NEG_INF/2)
# weighing 0 whatever its l and acc hold.  Tests hold it against the JAX
# reference and the unsplit plain versions above; no serving path runs it.
# ---------------------------------------------------------------------------
def paged_split_partials_ref(q, pages_k, pages_v, tables, lengths, *,
                             pages_per_split: int, window: int = 0,
                             sink: int = 0, softcap: float = 0.0):
    """q [B,T,Hq,Dh] (query t at position lengths[b] + t) -> fp32
    (m [S,B,T,Hq], l [S,B,T,Hq], acc [S,B,T,Hq,Dh]), acc not normalized,
    S = ceil(MP / pages_per_split)."""
    b, t, hq, dh = q.shape
    mp, page, hkv = tables.shape[1], pages_k.shape[1], pages_k.shape[2]
    g = hq // hkv
    f32 = torch.float32
    qg = q.to(f32).reshape(b, t, hkv, g, dh) / math.sqrt(dh)
    qpos = (lengths[:, None].to(torch.int32)
            + torch.arange(t, dtype=torch.int32, device=q.device)[None, :])
    ms, ls, accs = [], [], []
    for lo in range(0, mp, pages_per_split):
        tb = tables[:, lo:lo + pages_per_split]
        k, kpos = paged_gather(pages_k, tb)
        v, _ = paged_gather(pages_v, tb)
        kpos = torch.where(kpos >= 0, kpos + lo * page, kpos)
        s = torch.einsum("bthgd,bshd->bthgs", qg, k.to(f32))
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        msk = L._mask(qpos, kpos, causal=True, window=window,
                      sink=sink)[:, :, None, None, :]     # [B,T,1,1,S]
        s = torch.where(msk, s, torch.tensor(L.NEG_INF, dtype=f32))
        m = s.amax(dim=-1)
        p = torch.where(msk, torch.exp(s - m[..., None]),
                        torch.zeros((), dtype=f32))
        ms.append(m.reshape(b, t, hq))
        ls.append(p.sum(dim=-1).reshape(b, t, hq))
        accs.append(torch.einsum("bthgs,bshd->bthgd", p,
                                 v.to(f32)).reshape(b, t, hq, dh))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def merge_split_partials_ref(m, l, acc):
    """Partials of ``paged_split_partials_ref`` -> [B,T,Hq,Dh] fp32; a
    query whose every partial is empty gives exactly 0."""
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
                              sink: int = 0, softcap: float = 0.0):
    """The split model end to end: q [B,Hq,Dh] (decode) or [B,T,Hq,Dh]
    (verify) -> the same shape in q.dtype."""
    q4 = q[:, None] if q.dim() == 3 else q
    out = merge_split_partials_ref(*paged_split_partials_ref(
        q4, pages_k, pages_v, tables, lengths,
        pages_per_split=pages_per_split, window=window, sink=sink,
        softcap=softcap))
    return (out[:, 0] if q.dim() == 3 else out).to(q.dtype)
