"""The paper's model decomposition (FastDecode §3.1) for the port's
blocks (counterpart of repro.core.decompose).

Each block splits into the S-Part (``s_pre`` / ``s_advance``: norms,
projections, gates, the short convs, FFN — shared parameters,
batch-friendly; the conv window is the S-side's small per-row state) and
the parameter-free R-Part: ``r_attention`` (append the new token's K/V
and attend over the cache), ``r_cross_attention`` (attend over the
static cross-attention K/V, kernel 2 on the card), ``r_rglru`` (h_t = a
h_{t-1} + b) or ``r_ssd`` (the SSD state update and readout).  Only
activations cross the boundary (q, k, v -> o; q -> o; a, b -> h; x, dt,
B, C -> y).  A block runs as a chain of phases, each an S-side advance
then an R-Part: one phase for every kind but DEC_XATTN, whose two are
its self-attention and then its cross-attention.  The invariant

    model.apply_block(kind, p, h, st, ctx) == run_decomposed(kind, p, h, st, ctx)

is held by tests/test_torch_model.py.  Decode mode, plus the chunk mode
that carries a speculative-decode verify step (C candidate tokens per
row) through the same S/R split; prefill runs as a batched forward on
the S-worker.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

import torch.nn.functional as F

from repro_torch.core.config import (ATTN, DEC_XATTN, RGLRU, SSD, XATTN,
                                     ModelConfig)
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.model import Ctx, _ffn, _qkv_proj

F32 = torch.float32

# r_in entries that are per-head constants, not per-row data: every
# R-worker gets them whole (``r_ssd``)
RIN_BROADCAST = ("A_log", "D")
# the R-Part result key of each kind (``s_advance`` reads it)
R_OUT_KEY = {ATTN: "o", XATTN: "o", DEC_XATTN: "o", RGLRU: "h", SSD: "y"}


def num_phases(kind: str) -> int:
    return 2 if kind == DEC_XATTN else 1


def _check_kind(kind: str) -> None:
    if kind not in R_OUT_KEY:
        raise ValueError(f"block kind {kind!r} has no decode R-Part (an "
                         f"ENC_ATTN block runs only in the encoder)")


def _no_chunk(kind: str) -> None:
    if kind in (XATTN, DEC_XATTN):
        raise NotImplementedError(
            f"chunked prefill does not support block kind {kind!r} "
            f"(enc-dec / vision archs): use whole-prompt prefill")


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


def cross_pos(b: int, s: int, device) -> torch.Tensor:
    """The key positions of a cross-attention slab: all 0, so every slot
    is valid for a query at any position >= 0, with no window."""
    return torch.zeros((b, s), dtype=torch.int32, device=device)


def r_cross_attention(r_in, r_state, *, pos=None):
    """Attend q against the static (image / encoder) K/V held R-side:
    decode attention of one query per row over the dense slab
    ``r_state`` {xk, xv} [B, S, Hkv, Dh], every slot valid.  That is
    kernel 2's function with an all-zero ``pos`` [B, S] (``cross_pos``;
    the caller may pass one it keeps, as an R-worker's graph does),
    window 0 and softcap 0, so it goes through ``ops.decode_attention``:
    kernel 2 on a CUDA tensor, its plain version on a CPU one.  The state
    is read only.  r_in: q [B,1,Hq,Dh], lengths [B] (>= 0)."""
    q = r_in["q"]
    xk, xv = r_state["xk"], r_state["xv"]
    if pos is None:
        pos = cross_pos(q.shape[0], xk.shape[1], q.device)
    o = ops.decode_attention(q[:, 0].contiguous(), xk, xv, pos,
                             r_in["lengths"].to(torch.int32))
    return {"o": o[:, None]}, r_state


def r_rglru(r_in, r_state):
    """h_t = a * h_{t-1} + b, the parameter-free LRU recurrence.  An
    optional ``active`` [B] gates the update (inactive rows keep their
    h).  r_state {h} is updated in place; the result is a copy."""
    h = r_in["a"] * r_state["h"] + r_in["b"]
    act = r_in.get("active")
    if act is not None:
        h = torch.where(act[:, None], h, r_state["h"])
    r_state["h"].copy_(h)
    return {"h": h}, r_state


def r_rglru_chunk(r_in, r_state):
    """Chunk LRU: scan h_t = a_t h_{t-1} + b_t over the chunk from the
    stored h, invalid positions (``valid`` False) as identity steps (a=1,
    b=0), so short prompts and rows not fed leave h untouched.  r_in: a, b
    [B,C,W], valid [B,C].  Returns every position's h; the last becomes
    the stored h."""
    valid = r_in["valid"][..., None]
    a = torch.where(valid, r_in["a"], torch.ones((), dtype=F32,
                                                 device=valid.device))
    b_ = torch.where(valid, r_in["b"], torch.zeros((), dtype=F32,
                                                   device=valid.device))
    h = L.rglru_scan_h0(a, b_, r_state["h"])
    r_state["h"].copy_(h[:, -1, :])
    return {"h": h}, r_state


def r_ssd(r_in, r_state):
    """SSD state update and readout (parameter-free given x, dt, B, C;
    the per-head A_log and D ride in r_in).  An optional ``active`` [B]
    gates the update.  r_state {h} is updated in place."""
    y, h = L.ssd_step(r_in["x"], r_in["dt"], r_in["A_log"], r_in["B"],
                      r_in["C"], r_in["D"], r_state["h"])
    act = r_in.get("active")
    if act is not None:
        h = torch.where(act[:, None, None, None], h, r_state["h"])
    r_state["h"].copy_(h)
    return {"y": y}, r_state


def r_ssd_chunk(r_in, r_state, *, chunk: int):
    """Chunk SSD: the chunk-parallel recurrence from the stored h, with
    dt = 0 and x = 0 at invalid positions (identity steps).  r_in: x
    [B,C,H,P], dt [B,C,H], B, C [B,C,N], valid [B,C]."""
    valid = r_in["valid"]
    zero = torch.zeros((), dtype=F32, device=valid.device)
    dt = torch.where(valid[..., None], r_in["dt"], zero)
    x = torch.where(valid[:, :, None, None], r_in["x"],
                    zero.to(r_in["x"].dtype))
    y, h = L.ssd_chunked(x, dt, r_in["A_log"], r_in["B"], r_in["C"],
                         r_in["D"], chunk=chunk, h0=r_state["h"],
                         return_state=True)
    r_state["h"].copy_(h)
    return {"y": y}, r_state


class PhaseOut(NamedTuple):
    carry: Any                 # S-side residual
    r_in: Optional[Dict]       # payload for the R-worker (None if finished)


def _xq(p, hn, cfg, prefix=""):
    """Cross-attention's query [B, S, Hq, Dh] (not roped: the features
    carry no position)."""
    b, s = hn.shape[:2]
    return (hn @ p[prefix + "wq"]).reshape(b, s, cfg.num_heads,
                                           cfg.head_dim)


def s_pre(kind: str, p, h, ctx: Ctx) -> PhaseOut:
    """S-side phase 0 of an attention block: from block input to the R
    payload, q, k, v for self-attention (ATTN, and DEC_XATTN's first
    phase), q for XATTN (the recurrent kinds go through
    :func:`s_pre_stateful`)."""
    if kind not in (ATTN, XATTN, DEC_XATTN):
        raise NotImplementedError(
            f"s_pre of {kind!r}: its conv state makes it s_pre_stateful")
    cfg = ctx.cfg
    hn = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    if kind == XATTN:
        return PhaseOut({"h": h}, {"q": _xq(p, hn, cfg),
                                   "lengths": ctx.lengths})
    q, k, v = _qkv_proj(p, hn, cfg)
    q = L.rope(q, ctx.qpos, cfg.rope_theta)
    k = L.rope(k, ctx.qpos, cfg.rope_theta)
    return PhaseOut({"h": h}, {"q": q, "k": k, "v": v,
                               "lengths": ctx.lengths})


def _rglru_in(p, h, cfg):
    hn = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    gate = F.gelu((hn @ p["w_in_gate"]).to(F32),
                  approximate="tanh").to(h.dtype)
    return gate, hn @ p["w_in_rnn"]


def _ssd_in(p, h, cfg):
    di, n = cfg.d_inner, cfg.ssm_state
    hn = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    z, xbc, dt = torch.split(hn @ p["w_in"], [di, di + 2 * n,
                                               cfg.ssd_heads], dim=-1)
    return z, F.silu(xbc.to(F32)).to(h.dtype), dt


def _ssd_payload(p, xbc, dt, cfg, b, c):
    di, n = cfg.d_inner, cfg.ssm_state
    xs, Bm, Cm = torch.split(xbc, [di, n, n], dim=-1)
    xs = xs.reshape(b, c, cfg.ssd_heads, cfg.ssd_head_dim)
    dt = F.softplus(dt.to(F32) + p["dt_bias"][None, None, :])
    return {"x": xs, "dt": dt, "B": Bm, "C": Cm, "A_log": p["A_log"],
            "D": p["Dskip"]}


def s_pre_stateful(kind: str, p, h, s_state, ctx: Ctx):
    """s_pre for every kind: a recurrent block's S-side holds its conv
    window (``s_state`` {"conv"}), ATTN none.  Returns (PhaseOut,
    new_s_state); the caller writes the new state where it keeps it."""
    cfg = ctx.cfg
    if kind == RGLRU:
        gate, r = _rglru_in(p, h, cfg)
        r, new_conv = L.causal_conv1d(p["conv"], r, s_state["conv"])
        a, b_ = L._rglru_gates(p, r[:, 0])
        return (PhaseOut({"h": h, "gate": gate}, {"a": a, "b": b_}),
                {"conv": new_conv})
    if kind == SSD:
        z, xbc, dt = _ssd_in(p, h, cfg)
        xbc, new_conv = L.causal_conv1d(p["conv"], xbc, s_state["conv"])
        r_in = _ssd_payload(p, xbc, dt, cfg, h.shape[0], 1)
        for k in ("x", "dt", "B", "C"):
            r_in[k] = r_in[k][:, 0]
        return PhaseOut({"h": h, "z": z}, r_in), {"conv": new_conv}
    return s_pre(kind, p, h, ctx), s_state


def s_pre_chunk_stateful(kind: str, p, h, s_state, ctx: Ctx, valid):
    """Chunk-mode s_pre_stateful: h is [B, C, D], ``valid`` [B, C] marks
    real tokens; the payload carries ``valid`` so the R-Part gates its
    writes and updates the same way, and the S-side conv windows freeze
    at each row's last valid position.  ``ctx.qpos`` holds the chunk's
    absolute positions (base + offset) and ``ctx.lengths`` the per-row
    KV offsets.  Returns (PhaseOut, new_s_state)."""
    cfg = ctx.cfg
    t_end = valid.sum(dim=1)
    if kind == RGLRU:
        gate, r = _rglru_in(p, h, cfg)
        r, new_conv = L.causal_conv1d_chunk(p["conv"], r, s_state["conv"],
                                            t_end)
        a, b_ = L._rglru_gates(p, r)
        return (PhaseOut({"h": h, "gate": gate},
                         {"a": a, "b": b_, "valid": valid}),
                {"conv": new_conv})
    if kind == SSD:
        z, xbc, dt = _ssd_in(p, h, cfg)
        xbc, new_conv = L.causal_conv1d_chunk(p["conv"], xbc,
                                              s_state["conv"], t_end)
        r_in = _ssd_payload(p, xbc, dt, cfg, h.shape[0], h.shape[1])
        r_in["valid"] = valid
        return PhaseOut({"h": h, "z": z}, r_in), {"conv": new_conv}
    _no_chunk(kind)
    out = s_pre(kind, p, h, ctx)
    r_in = dict(out.r_in)
    r_in["valid"] = valid
    return PhaseOut(out.carry, r_in), s_state


def _finish(p, h, cfg: ModelConfig):
    if cfg.ffn_kind == "none" or "ln2" not in p:
        return h
    hn = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    return h + _ffn(p, hn, cfg)[0]


def _ssd_out(p, carry, y, cfg):
    """An SSD block's output from the R result y [B, S, H, P]: gated
    RMSNorm, out projection, residual (no FFN)."""
    h = carry["h"]
    b, s = y.shape[:2]
    y = y.reshape(b, s, cfg.d_inner).to(h.dtype)
    y = L.rms_norm(y * F.silu(carry["z"].to(F32)).to(h.dtype),
                   p["gate_norm"], cfg.norm_eps)
    return h + y @ p["w_out"]


def s_advance(kind: str, phase: int, p, carry, r_out, ctx: Ctx):
    """Consume the R result of ``phase`` (decode: one position): the
    block output, or (DEC_XATTN's phase 0) a :class:`PhaseOut` whose
    payload {q, lengths} feeds the cross-attention phase."""
    cfg = ctx.cfg
    h = carry["h"]
    if kind == RGLRU:
        hr = r_out["h"]                                   # [B, W] fp32
        out = (hr[:, None, :].to(h.dtype) * carry["gate"]) @ p["w_out"]
        return _finish(p, h + out, cfg)
    if kind == SSD:
        return _ssd_out(p, carry, r_out["y"][:, None], cfg)
    _check_kind(kind)
    o = r_out["o"]
    b, s = o.shape[:2]
    o = o.reshape(b, s, -1)
    if kind == XATTN:
        mix = (o @ p["wo"]) * torch.tanh(p["gate_attn"].to(o.dtype))
        h = h + mix
        f = _ffn(p, L.rms_norm(h, p["ln2"], cfg.norm_eps), cfg)[0]
        return h + f * torch.tanh(p["gate_ffn"].to(f.dtype))
    if kind == DEC_XATTN and phase == 0:
        h = h + o @ p["wo"]
        hx = L.rms_norm(h, p["lnx"], cfg.norm_eps)
        return PhaseOut({"h": h}, {"q": _xq(p, hx, cfg, "x_"),
                                   "lengths": ctx.lengths})
    mix = o @ p["x_wo" if kind == DEC_XATTN else "wo"]
    return _finish(p, h + mix, cfg)


def s_advance_chunk(kind: str, phase: int, p, carry, r_out, ctx: Ctx):
    """Chunk-mode s_advance: per-position R results [B, C, ...] to the
    block output [B, C, D]; the attention math is already
    sequence-general, the recurrent kinds take every position."""
    h = carry["h"]
    if kind == RGLRU:
        out = (r_out["h"].to(h.dtype) * carry["gate"]) @ p["w_out"]
        return _finish(p, h + out, ctx.cfg)
    if kind == SSD:
        return _ssd_out(p, carry, r_out["y"], ctx.cfg)
    return s_advance(kind, phase, p, carry, r_out, ctx)


def r_dispatch_chunk(kind: str, phase: int, r_in, r_state,
                     cfg: ModelConfig, kv_chunk: int = 1024):
    """Chunk-work counterpart of :func:`r_dispatch` (dense storage)."""
    if kind == RGLRU:
        return r_rglru_chunk(r_in, r_state)
    if kind == SSD:
        return r_ssd_chunk(r_in, r_state, chunk=cfg.ssd_chunk)
    _check_kind(kind)
    _no_chunk(kind)
    return r_attention_chunk(r_in, r_state, window=cfg.window,
                             softcap=cfg.attn_logit_softcap,
                             kv_chunk=kv_chunk)


def r_dispatch(kind: str, phase: int, r_in, r_state, cfg: ModelConfig,
               kv_chunk: int = 1024, pos=None):
    """The R-Part of (``kind``, ``phase``) on dense storage; ``pos`` is a
    cross-attention's kept all-zero key positions (``r_cross_attention``)."""
    if kind == RGLRU:
        return r_rglru(r_in, r_state)
    if kind == SSD:
        return r_ssd(r_in, r_state)
    _check_kind(kind)
    if kind == XATTN or (kind == DEC_XATTN and phase == 1):
        return r_cross_attention(r_in, r_state, pos=pos)
    return r_attention(r_in, r_state, window=cfg.window,
                       softcap=cfg.attn_logit_softcap, kv_chunk=kv_chunk)


def split_block_state(kind: str, st: Dict):
    """(r_state, s_state): attention state (a cross-attention block's
    static xk / xv with it) lives wholly R-side; a recurrent block keeps
    h R-side and its conv window S-side."""
    if kind in (RGLRU, SSD):
        return {"h": st["h"]}, {"conv": st["conv"]}
    _check_kind(kind)
    return st, {}


def merge_block_state(kind: str, r_state: Dict, s_state: Dict):
    out = dict(r_state)
    out.update(s_state)
    return out


def run_decomposed(kind: str, p, h, st, ctx: Ctx, kv_chunk: int = 1024):
    """Single-process reference: chain the phases.  Mirrors
    model.apply_block for decode."""
    r_state, s_state = split_block_state(kind, st)
    po, new_s = s_pre_stateful(kind, p, h, s_state, ctx)
    for k, v in new_s.items():
        s_state[k].copy_(v)
    for phase in range(num_phases(kind)):
        r_out, r_state = r_dispatch(kind, phase, po.r_in, r_state, ctx.cfg,
                                    kv_chunk)
        po = s_advance(kind, phase, p, po.carry, r_out, ctx)
    return po, merge_block_state(kind, r_state, s_state)
