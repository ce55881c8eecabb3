"""The paper's model decomposition (FastDecode §3.1) for the port, ATTN
blocks only (counterpart of repro.core.decompose).

Each block splits into the S-Part (``s_pre`` / ``s_advance``: norms,
QKV/O projections, FFN — shared parameters, batch-friendly) and the
parameter-free R-Part (``r_attention``: append the new token's K/V and
attend over the cache).  Only activations cross the boundary (q, k, v
-> o).  The invariant

    model.apply_block(kind, p, h, st, ctx) == run_decomposed(kind, p, h, st, ctx)

is held by tests/test_torch_model.py.  Decode mode, plus the chunk mode
that carries a speculative-decode verify step (C candidate tokens per
row) through the same S/R split; prefill runs as a batched forward on
the S-worker.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.core.config import ATTN, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.model import Ctx, _ffn, _qkv_proj


def num_phases(kind: str) -> int:
    return 1


def _attn_only(kind: str) -> None:
    if kind != ATTN:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (the other mixers are "
            f"queued in ROADMAP.md)")


def attn_state_lengths(st) -> torch.Tensor:
    """Token count per row of a dense attention r_state, from the stored
    positions (-1 marks an unwritten slot)."""
    return (st["pos"] >= 0).sum(dim=1).to(torch.int32)


def r_attention(r_in: Dict[str, torch.Tensor], r_state, *, window: int,
                softcap: float, kv_chunk: int = 1024):
    """Append (k, v) at ``lengths`` and attend with q; the KV never leaves.

    r_in: q [B,1,Hq,Dh] (rope'd), k, v [B,1,Hkv,Dh], lengths [B], and an
    optional bool ``active`` [B]: inactive rows write nothing and keep
    their stored state (their output is discarded).  r_state {k, v, pos}
    is updated in place (each row writes only its own slot, so an
    inactive row simply writes its old values back)."""
    q, k, v, lengths = r_in["q"], r_in["k"], r_in["v"], r_in["lengths"]
    cache_n = r_state["k"].shape[1]
    b = q.shape[0]
    slot = (lengths % cache_n).long()
    bidx = torch.arange(b, device=q.device)
    k_new, v_new, p_new = k[:, 0], v[:, 0], lengths.to(torch.int32)
    act = r_in.get("active")
    if act is not None:
        k_new = torch.where(act[:, None, None], k_new,
                            r_state["k"][bidx, slot])
        v_new = torch.where(act[:, None, None], v_new,
                            r_state["v"][bidx, slot])
        p_new = torch.where(act, p_new, r_state["pos"][bidx, slot])
    r_state["k"][bidx, slot] = k_new.to(r_state["k"].dtype)
    r_state["v"][bidx, slot] = v_new.to(r_state["v"].dtype)
    r_state["pos"][bidx, slot] = p_new
    o = L.flash_attention(q, r_state["k"], r_state["v"], lengths[:, None],
                          r_state["pos"], causal=True, window=window,
                          softcap=softcap, kv_chunk=max(cache_n, kv_chunk))
    return {"o": o}, r_state


def r_attention_chunk(r_in: Dict[str, torch.Tensor], r_state, *,
                      window: int, softcap: float, kv_chunk: int = 1024):
    """Chunk R-Part: append C tokens per row and attend them against
    [old cache + chunk] (write-then-attend semantics, equal to
    whole-prompt prefill up to float association).

    r_in: q [B,C,Hq,Dh], k, v [B,C,Hkv,Dh] (rope'd), lengths [B] (tokens
    already cached per row: the KV offset), valid [B,C] bool (False for
    padding and rows not fed: they write nothing and their output is
    discarded).  Old entries at positions >= the row's offset (a
    previous occupant's, or rejected speculative tokens) are masked out;
    ring discipline keeps only the last min(C_valid, cache_n) chunk
    tokens.  r_state {k, v, pos} is updated in place."""
    q, k, v = r_in["q"], r_in["k"], r_in["v"]
    base, valid = r_in["lengths"], r_in["valid"]
    cache_n = r_state["k"].shape[1]
    c = q.shape[1]
    qpos = (base[:, None].to(torch.int32)
            + torch.arange(c, dtype=torch.int32, device=q.device)[None, :])
    slots, old_pos, kpos_new = L.chunk_ring_plan(
        r_state["pos"], base, valid, qpos, cache_n)
    kcat = torch.cat([r_state["k"], k.to(r_state["k"].dtype)], dim=1)
    vcat = torch.cat([r_state["v"], v.to(r_state["v"].dtype)], dim=1)
    pcat = torch.cat([old_pos, kpos_new], dim=1)
    o = L.flash_attention(q, kcat, vcat, qpos, pcat, causal=True,
                          window=window, softcap=softcap,
                          kv_chunk=max(kcat.shape[1], kv_chunk))
    L.scatter_rows_drop(r_state["k"], slots, k)
    L.scatter_rows_drop(r_state["v"], slots, v)
    L.scatter_rows_drop(r_state["pos"], slots, qpos)
    return {"o": o}, r_state


class PhaseOut(NamedTuple):
    carry: Any                 # S-side residual
    r_in: Optional[Dict]       # payload for the R-worker (None if finished)


def s_pre(kind: str, p, h, ctx: Ctx) -> PhaseOut:
    """S-side phase 0: from block input to the R payload."""
    _attn_only(kind)
    cfg = ctx.cfg
    hn = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv_proj(p, hn, cfg)
    q = L.rope(q, ctx.qpos, cfg.rope_theta)
    k = L.rope(k, ctx.qpos, cfg.rope_theta)
    return PhaseOut({"h": h}, {"q": q, "k": k, "v": v,
                               "lengths": ctx.lengths})


def s_pre_stateful(kind: str, p, h, s_state, ctx: Ctx):
    """s_pre for kinds with S-side state; ATTN keeps none.
    Returns (PhaseOut, s_state)."""
    return s_pre(kind, p, h, ctx), s_state


def s_pre_chunk_stateful(kind: str, p, h, s_state, ctx: Ctx, valid):
    """Chunk-mode s_pre_stateful: h is [B, C, D], ``valid`` [B, C] marks
    real tokens; the payload carries ``valid`` so the R-Part gates its
    writes.  ``ctx.qpos`` holds the chunk's absolute positions (base +
    offset) and ``ctx.lengths`` the per-row KV offsets.  ATTN keeps no
    S-side state.  Returns (PhaseOut, s_state)."""
    out = s_pre(kind, p, h, ctx)
    r_in = dict(out.r_in)
    r_in["valid"] = valid
    return PhaseOut(out.carry, r_in), s_state


def _finish(p, h, cfg: ModelConfig):
    if cfg.ffn_kind == "none" or "ln2" not in p:
        return h
    hn = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    return h + _ffn(p, hn, cfg)


def s_advance(kind: str, phase: int, p, carry, r_out, ctx: Ctx):
    """Consume the R result: o projection, residual and FFN."""
    _attn_only(kind)
    o = r_out["o"]
    b, s = o.shape[:2]
    mix = o.reshape(b, s, -1) @ p["wo"]
    return _finish(p, carry["h"] + mix, ctx.cfg)


def s_advance_chunk(kind: str, phase: int, p, carry, r_out, ctx: Ctx):
    """Chunk-mode s_advance: per-position R results [B, C, ...] to the
    block output [B, C, D]; the attention math is already
    sequence-general."""
    return s_advance(kind, phase, p, carry, r_out, ctx)


def r_dispatch_chunk(kind: str, phase: int, r_in, r_state,
                     cfg: ModelConfig, kv_chunk: int = 1024):
    """Chunk-work counterpart of :func:`r_dispatch` (dense storage)."""
    _attn_only(kind)
    return r_attention_chunk(r_in, r_state, window=cfg.window,
                             softcap=cfg.attn_logit_softcap,
                             kv_chunk=kv_chunk)


def r_dispatch(kind: str, phase: int, r_in, r_state, cfg: ModelConfig,
               kv_chunk: int = 1024):
    _attn_only(kind)
    return r_attention(r_in, r_state, window=cfg.window,
                       softcap=cfg.attn_logit_softcap, kv_chunk=kv_chunk)


def split_block_state(kind: str, st: Dict):
    """(r_state, s_state): attention state lives wholly R-side."""
    _attn_only(kind)
    return st, {}


def merge_block_state(kind: str, r_state: Dict, s_state: Dict):
    out = dict(r_state)
    out.update(s_state)
    return out


def run_decomposed(kind: str, p, h, st, ctx: Ctx, kv_chunk: int = 1024):
    """Single-process reference: chain the phases.  Mirrors
    model.apply_block for decode."""
    r_state, s_state = split_block_state(kind, st)
    po, s_state = s_pre_stateful(kind, p, h, s_state, ctx)
    r_out, r_state = r_dispatch(kind, 0, po.r_in, r_state, ctx.cfg,
                                kv_chunk)
    h = s_advance(kind, 0, p, po.carry, r_out, ctx)
    return h, merge_block_state(kind, r_state, s_state)
