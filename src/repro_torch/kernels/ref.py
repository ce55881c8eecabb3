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
