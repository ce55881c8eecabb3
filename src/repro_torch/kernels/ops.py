"""Dispatch for the R-Part attention kernels (counterpart of
``repro/kernels/ops.py``).

``use_kernel="auto"`` is the only mode: each wrapper launches its Hopper
kernel for a CUDA tensor and runs the plain version for a CPU tensor.
So the dense int8 op runs kernel 3 on the card, where ``repro`` runs its
jnp reference even on the TPU (``kv_cache.r_attention_int8`` defaults to
``use_kernel="ref"``), and the paged int8 op runs kernel 3's paged entry
where ``repro`` gathers and then runs its int8 kernel: same functions,
another dispatch.  The cross-attention R-Part, jnp flash attention in
``repro``, runs kernel 2 (``decode_attention``) on the card.  The verify
ops
follow ``repro``'s split: the paged fp verify has its kernel (kernel 4),
the dense verify is plain torch on both devices (jnp in ``repro``).  So is
the dense int8 verify.  The paged int8 verify, jnp in ``repro`` (it
gathers the int8 pages into a slab), runs kernel 3's multi-token paged
entry on the card, reading the pools in place.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import quant_kv as _qk
from repro_torch.kernels import ref as _ref


def _auto(use_kernel: str) -> None:
    if use_kernel != "auto":
        raise ValueError(f"use_kernel must be 'auto', got {use_kernel!r}")


def decode_attention(q, k, v, pos, lengths, *, window: int = 0, sink: int = 0,
                     softcap: float = 0.0, use_kernel: str = "auto"):
    """Batched decode attention (kernel 2).  q [B,Hq,Dh]; k,v
    [B,S,Hkv,Dh]; pos [B,S] int32; lengths [B] int32 -> [B,Hq,Dh].  The
    cross-attention R-Part (``decompose.r_cross_attention``) calls it
    with an all-zero pos, where ``repro`` runs its jnp flash attention."""
    _auto(use_kernel)
    return _da.decode_attention(q, k, v, pos, lengths, window=window,
                                sink=sink, softcap=softcap)


def decode_attention_int8(q, k_q, k_scale, v_q, v_scale, pos, lengths, *,
                          window: int = 0, sink: int = 0, softcap: float = 0.0,
                          use_kernel: str = "auto"):
    _auto(use_kernel)
    return _qk.decode_attention_int8(q, k_q, k_scale, v_q, v_scale, pos,
                                     lengths, window=window, sink=sink,
                                     softcap=softcap)


def paged_decode_attention(q, pages_k, pages_v, tables, lengths, *,
                           window: int = 0, sink: int = 0,
                           softcap: float = 0.0, use_kernel: str = "auto"):
    """Block-table decode attention.  q [B,Hq,Dh]; pages_k/v
    [P,page,Hkv,Dh]; tables [B,MP] int32; lengths [B] -> [B,Hq,Dh]."""
    _auto(use_kernel)
    return _pa.paged_decode_attention(q, pages_k, pages_v, tables, lengths,
                                      window=window, sink=sink,
                                      softcap=softcap)


def paged_decode_attention_int8(q, pk_q, pk_s, pv_q, pv_s, tables, lengths,
                                *, window: int = 0, sink: int = 0,
                                softcap: float = 0.0,
                                use_kernel: str = "auto"):
    """Block-table decode attention over int8 pools: ``repro``'s kernel
    path gathers the pages into a per-sequence slab and runs the int8
    kernel on it; on the card the port runs kernel 3's paged entry, which
    reads the pages and scales through the table in one C call (no
    gather).  On a CPU tensor it is exactly
    ``ref.paged_decode_attention_int8_ref`` (the gather chain)."""
    _auto(use_kernel)
    return _qk.paged_decode_attention_int8(q, pk_q, pk_s, pv_q, pv_s, tables,
                                           lengths, window=window,
                                           sink=sink, softcap=softcap)


def verify_attention(q, k, v, pos, lengths, *, window: int = 0,
                     sink: int = 0, softcap: float = 0.0,
                     kv_chunk: int = 1024, use_kernel: str = "auto"):
    """Dense multi-token verify.  q [B,T,Hq,Dh]; k,v [B,S,Hkv,Dh];
    pos [B,S] int32; lengths [B] int32 base -> [B,T,Hq,Dh].  Plain torch
    on every device, as ``repro``'s is jnp on every backend: the
    bandwidth win is the single sweep, not a kernel."""
    _auto(use_kernel)
    return _ref.verify_attention_ref(q, k, v, pos, lengths, window=window,
                                     sink=sink, softcap=softcap,
                                     kv_chunk=kv_chunk)


def paged_verify_attention(q, pages_k, pages_v, tables, lengths, *,
                           window: int = 0, sink: int = 0,
                           softcap: float = 0.0, use_kernel: str = "auto"):
    """Block-table multi-token verify (kernel 4).  q [B,T,Hq,Dh]; pages_k/v
    [P,page,Hkv,Dh]; tables [B,MP] int32; lengths [B] base ->
    [B,T,Hq,Dh]."""
    _auto(use_kernel)
    return _pa.paged_verify_attention(q, pages_k, pages_v, tables, lengths,
                                      window=window, sink=sink,
                                      softcap=softcap)


def verify_attention_int8(q, k_q, k_scale, v_q, v_scale, pos, lengths, *,
                          window: int = 0, sink: int = 0, softcap: float = 0.0,
                          kv_chunk: int = 1024, use_kernel: str = "auto"):
    """Dense multi-token verify over int8 K/V [B,S,Hkv,Dh] with fp32
    scales [B,S,Hkv].  Plain torch on every device, as ``repro``'s is jnp
    on every backend; on no serve path (the dense int8 verify R-Part is
    ``kv_cache.r_attention_int8_chunk``)."""
    _auto(use_kernel)
    return _ref.verify_attention_int8_ref(
        q, k_q, k_scale, v_q, v_scale, pos, lengths, window=window,
        sink=sink, softcap=softcap, kv_chunk=kv_chunk)


def paged_verify_attention_int8(q, pk_q, pk_s, pv_q, pv_s, tables, lengths,
                                *, window: int = 0, sink: int = 0,
                                softcap: float = 0.0,
                                use_kernel: str = "auto"):
    """Block-table multi-token verify over int8 pools: ``repro`` gathers
    the pages into a slab and runs the dense int8 verify reference; on the
    card the port runs kernel 3's multi-token paged entry (one C call, no
    gather).  On a CPU tensor it is exactly
    ``ref.paged_verify_attention_int8_ref`` (the gather chain)."""
    _auto(use_kernel)
    return _qk.paged_verify_attention_int8(q, pk_q, pk_s, pv_q, pv_s, tables,
                                           lengths, window=window,
                                           sink=sink, softcap=softcap)


quantize_kv = _qk.quantize_kv
dequantize_kv = _qk.dequantize_kv
