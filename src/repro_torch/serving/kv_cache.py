"""KV-cache utilities of the port, including the int8-quantized variant
(paper §5.2; counterpart of repro.serving.kv_cache).

The model's decode state already *is* the cache (repro_torch.models.model).
This module adds:
  * size accounting helpers (with the bytes the prefix cache's shared
    pages save, ``shared_prefix_bytes_saved``),
  * conversion of a bf16/fp32 attention block state into int8 + scales,
  * the parameter-free quantized R-Part ops (decompose-compatible), which
    quantize incoming K/V on write: the decode op attends through kernel 3,
    the chunk op (chunked prefill and the dense int8 verify) through the
    plain flash attention, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.config import ATTN, DEC_XATTN, ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.kernels import ops
from repro_torch.models import layers as L

_INT8_KEYS = ("k_q", "k_s", "v_q", "v_s")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def cache_bytes(st) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(st))


def quantize_attn_state(st: Dict) -> Dict:
    """{'k','v','pos',...} (bf16/fp32 caches) -> int8 + per-(token,head)
    scales."""
    kq, ks = ops.quantize_kv(st["k"])
    vq, vs = ops.quantize_kv(st["v"])
    out = {k: v for k, v in st.items() if k not in ("k", "v")}
    out.update({"k_q": kq, "k_s": ks, "v_q": vq, "v_s": vs})
    return out


def dequantize_attn_state(st: Dict) -> Dict:
    out = {k: v for k, v in st.items() if k not in _INT8_KEYS}
    out["k"] = ops.dequantize_kv(st["k_q"], st["k_s"])
    out["v"] = ops.dequantize_kv(st["v_q"], st["v_s"])
    return out


def r_attention_int8(r_in: Dict, r_state: Dict, *, window: int,
                     softcap: float):
    """Quantized R-Part attention: write the new (k, v) as int8, attend
    with fp32 accumulation through kernel 3.  Drop-in for
    decompose.r_attention on an R-worker that stores its cache quantized.
    r_state {k_q, k_s, v_q, v_s, pos} is updated IN PLACE; with an
    optional bool ``r_in["active"]`` [B], inactive rows write their stored
    slot back unchanged (where the JAX package drops the write)."""
    q, k, v, lengths = r_in["q"], r_in["k"], r_in["v"], r_in["lengths"]
    cache_n = r_state["k_q"].shape[1]
    b = q.shape[0]
    slot = (lengths % cache_n).long()
    bidx = torch.arange(b, device=q.device)
    k_new_q, k_new_s = ops.quantize_kv(k[:, 0])
    v_new_q, v_new_s = ops.quantize_kv(v[:, 0])
    new = {"k_q": k_new_q, "k_s": k_new_s, "v_q": v_new_q, "v_s": v_new_s,
           "pos": lengths.to(torch.int32)}
    act = r_in.get("active")
    for name, val in new.items():
        if act is not None:
            old = r_state[name][bidx, slot]
            val = torch.where(act.reshape((-1,) + (1,) * (old.dim() - 1)),
                              val, old)
        r_state[name][bidx, slot] = val
    o = ops.decode_attention_int8(
        q[:, 0].contiguous(), r_state["k_q"], r_state["k_s"],
        r_state["v_q"], r_state["v_s"], r_state["pos"],
        lengths.to(torch.int32).contiguous(), window=window,
        softcap=softcap)
    return {"o": o[:, None]}, r_state


def r_attention_int8_chunk(r_in: Dict, r_state: Dict, *, window: int,
                           softcap: float, kv_chunk: int = 1024):
    """Chunk counterpart of :func:`r_attention_int8`: quantize and append C
    tokens per row (the per-(token, head) scales a whole-prompt load
    produces, so the stored bytes are bit-identical to it), and attend the
    chunk queries against [dequantized old cache + fp chunk] through the
    plain flash attention (as the JAX package does; cross-chunk attention
    reads dequantized keys where a whole-prompt prefill attended fp ones).

    r_in: q/k/v [B,C,...], lengths [B] (KV offset), valid [B,C].  Old
    entries at positions >= the row's offset are masked; ring discipline
    keeps the last min(C_valid, cache_n) chunk tokens (``chunk_ring_plan``).
    r_state {k_q, k_s, v_q, v_s, pos} is updated IN PLACE, after the
    attention has read it."""
    q, k, v = r_in["q"], r_in["k"], r_in["v"]
    base, valid = r_in["lengths"], r_in["valid"]
    cache_n = r_state["k_q"].shape[1]
    c = q.shape[1]
    qpos = (base[:, None].to(torch.int32)
            + torch.arange(c, dtype=torch.int32, device=q.device)[None, :])
    slots, old_pos, kpos_new = L.chunk_ring_plan(
        r_state["pos"], base, valid, qpos, cache_n)
    old_k = ops.dequantize_kv(r_state["k_q"], r_state["k_s"])
    old_v = ops.dequantize_kv(r_state["v_q"], r_state["v_s"])
    kcat = torch.cat([old_k, k.to(old_k.dtype)], dim=1)
    vcat = torch.cat([old_v, v.to(old_v.dtype)], dim=1)
    pcat = torch.cat([old_pos, kpos_new], dim=1)
    o = L.flash_attention(q, kcat, vcat, qpos, pcat, causal=True,
                          window=window, softcap=softcap,
                          kv_chunk=max(kcat.shape[1], kv_chunk))
    k_q, k_s = ops.quantize_kv(k)
    v_q, v_s = ops.quantize_kv(v)
    for name, val in (("k_q", k_q), ("k_s", k_s), ("v_q", v_q),
                      ("v_s", v_s), ("pos", qpos)):
        L.scatter_rows_drop(r_state[name], slots, val)
    return {"o": o}, r_state


def _token_slot_bytes(cfg: ModelConfig, quantized: bool) -> int:
    """Bytes one token-slot of one layer's KV occupies (K + V, plus the
    int8 path's per-(token, head) fp32 scales)."""
    per_tok = 2 * cfg.num_kv_heads * cfg.head_dim
    if quantized:
        return per_tok * 1 + 2 * cfg.num_kv_heads * 4
    return per_tok * torch_dtype(cfg.dtype).itemsize


def kv_bytes_per_seq(cfg: ModelConfig, cache_len: int,
                     quantized: bool = False) -> int:
    n_attn = sum(1 for k in cfg.pattern if k in (ATTN, DEC_XATTN))
    return n_attn * cache_len * _token_slot_bytes(cfg, quantized)


def paged_kv_bytes_per_seq(cfg: ModelConfig, seq_len: int, page: int,
                           quantized: bool = False,
                           table_entry_bytes: int = 4) -> int:
    """Resident bytes a ``seq_len``-token sequence actually occupies under
    block-granular allocation: page-rounded KV plus its block-table row.
    Compare with ``kv_bytes_per_seq(cfg, cache_len)``, which every dense
    row pays regardless of its length."""
    n_pages = -(-seq_len // page)
    # only plain self-attention layers are paged (dec_xattn keeps the
    # dense slab for its static cross-KV)
    n_attn = sum(1 for k in cfg.pattern if k == ATTN)
    return n_attn * (n_pages * page * _token_slot_bytes(cfg, quantized)
                     + n_pages * table_entry_bytes)


def shared_prefix_bytes_saved(cfg: ModelConfig, prefix_len: int,
                              n_sharers: int, page: int,
                              quantized: bool = False) -> int:
    """Resident KV bytes the ref-counted prefix cache deduplicates when
    ``n_sharers`` sequences share a ``prefix_len``-token prefix: the
    shared full pages are stored ONCE instead of once per row (each
    sharer still pays its own block-table row, and the partial tail page
    diverges onto a private CoW clone per writer, so only full pages
    count)."""
    if n_sharers <= 1 or prefix_len < page:
        return 0
    full_pages = prefix_len // page
    n_attn = sum(1 for k in cfg.pattern if k == ATTN)
    per_page = page * _token_slot_bytes(cfg, quantized)
    return (n_sharers - 1) * full_pages * per_page * n_attn
