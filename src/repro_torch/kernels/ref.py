"""Plain PyTorch versions of the port's kernels.

They reuse the chunked flash attention of ``repro_torch.models.layers``,
the same function the model's decode path runs, so kernel == ref also
implies kernel == model (as ``repro/kernels/ref.py`` does for the JAX
package).  The CPU tests run them; ``chip_smoke.py`` holds the Hopper
kernel against them on the card.
"""
from __future__ import annotations

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
