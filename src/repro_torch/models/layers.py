"""Layer primitives of the port (PyTorch counterpart of repro.models.layers).

The chunked flash attention here is the oracle every kernel's plain
version reduces to (``repro_torch.kernels.ref``), exactly as in the JAX
package.  Layouts are the JAX package's:

  activations  [B, S, D]
  q            [B, S, Hq, Dh]
  k/v          [B, S, Hkv, Dh]
  kv positions are ABSOLUTE token positions; -1 marks an invalid slot.
  Keys are stored rope-rotated.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32
NEG_INF = -1e30


def rms_norm(x, scale, eps: float = 1e-6):
    """fp32 RMSNorm with a ``(1 + scale)`` gain (scales are zero-init),
    cast back to x's dtype."""
    x32 = x.to(F32)
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(F32))).to(x.dtype)


def chunk_ring_plan(old_pos, base, valid, qpos, cache_n: int):
    """The chunk write/mask derivation shared by every dense chunk-attention
    path (the model's chunk mode and the R-Part's ``r_attention_chunk``).

    old_pos [B,Sk] stored positions, base [B] per-row KV offsets,
    valid [B,C] real-token mask, qpos [B,C] absolute chunk positions,
    cache_n the ring size.  Returns:

      slots      [B,C]  ring slots to write the chunk at, ``cache_n`` for
                        a dropped write.  Ring discipline keeps only the
                        last min(C_valid, cache_n) chunk tokens, so no two
                        kept tokens of a row share a slot.
      old_pos_m  [B,Sk] stored positions with entries >= the row's offset
                        masked to -1 (stale data of a previous occupant,
                        or rejected speculative tokens, is not attended).
      kpos_new   [B,C]  chunk key positions (-1 where invalid).
    """
    cnt = valid.sum(dim=1)
    wvalid = valid & (qpos >= (base + cnt - cache_n)[:, None])
    slots = torch.where(wvalid, qpos % cache_n,
                        torch.full_like(qpos, cache_n))
    old_pos_m = torch.where(old_pos < base[:, None], old_pos,
                            torch.full_like(old_pos, -1))
    kpos_new = torch.where(valid, qpos, torch.full_like(qpos, -1))
    return slots, old_pos_m, kpos_new


def scatter_rows_drop(dst, slots, vals) -> None:
    """``dst[b, slots[b, c]] = vals[b, c]`` in place, dropping entries whose
    slot equals ``dst.shape[1]`` (out of range): the JAX package's
    ``.at[...].set(mode="drop")``, which torch's ``index_put_`` lacks.

    No host sync: a dropped entry is redirected to a write that happens
    anyway, with the same value — the row's first kept entry, or, in a
    row that keeps none, slot 0 written with its own current value — so
    duplicate indices always carry equal values and the result does not
    depend on the order of the writes.  Kept entries must have distinct
    slots per row (``chunk_ring_plan`` guarantees it).
    dst [B,N,...]; slots [B,C] int; vals [B,C,...]."""
    b, n = dst.shape[:2]
    slots = slots.long()
    keep = slots < n
    first = keep.to(torch.int8).argmax(dim=1)                  # [B]
    has = keep.any(dim=1)
    bidx = torch.arange(b, device=dst.device)
    rep_slot = torch.where(has, slots[bidx, first],
                           torch.zeros_like(first))
    rep_val = torch.where(
        has.reshape((b,) + (1,) * (vals.dim() - 2)),
        vals[bidx, first].to(dst.dtype), dst[bidx, 0])
    slot_w = torch.where(keep, slots, rep_slot[:, None])
    val_w = torch.where(keep.reshape(keep.shape + (1,) * (vals.dim() - 2)),
                        vals.to(dst.dtype), rep_val[:, None])
    dst[bidx[:, None].expand_as(slot_w), slot_w] = val_w


def rope(x, positions, theta: float):
    """RoPE over INTERLEAVED pairs (x[..., 0::2] against x[..., 1::2]), as
    the JAX package does — not the half-split ``rotate_half`` form.
    x [..., S, H, D], positions [..., S]."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=F32,
                                        device=x.device) / d))
    ang = positions.to(F32)[..., None] * inv            # [..., S, D/2]
    ang = ang[..., None, :]                             # [..., S, 1, D/2]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., 0::2].to(F32), x[..., 1::2].to(F32)
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def _mask(qpos, kpos, *, causal, window, sink):
    """qpos [B,Sq], kpos [B,Sk] -> bool [B,Sq,Sk] (True = attend)."""
    q = qpos[:, :, None]
    k = kpos[:, None, :]
    m = k >= 0
    if causal:
        m = m & (k <= q)
    if window > 0:
        in_win = k > q - window
        if sink > 0:
            in_win = in_win | (k < sink)
        m = m & in_win
    return m


def _flash_chunk_scan(q, qpos, k, v, kpos, *, causal, window, sink, softcap,
                      scale, kv_chunk):
    """Online-softmax attention of one q block against all kv chunks.
    q [B,Sq,Hkv,G,Dh] (grouped), k/v [B,Sk,Hkv,Dh]; fp32 accumulation.
    Returns [B,Sq,Hkv,G,Dh] fp32."""
    b, sq, hkv, g, dh = q.shape
    sk = k.shape[1]
    nkc = max(1, -(-sk // kv_chunk))
    q32 = q.to(F32) * scale
    m_i = torch.full((b, hkv, g, sq), NEG_INF, dtype=F32, device=q.device)
    l_i = torch.zeros((b, hkv, g, sq), dtype=F32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dh), dtype=F32, device=q.device)
    for c in range(nkc):
        # a ragged last chunk is simply shorter: the JAX scan pads it with
        # kpos = -1, which contributes nothing to the softmax
        sl = slice(c * kv_chunk, min(sk, (c + 1) * kv_chunk))
        kj, vj, pj = k[:, sl].to(F32), v[:, sl].to(F32), kpos[:, sl]
        s = torch.einsum("bqhgd,bshd->bhgqs", q32, kj)
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        msk = _mask(qpos, pj, causal=causal, window=window, sink=sink)
        # a Python scalar, not a device tensor made from one (a host copy
        # that a CUDA-graph capture refuses)
        s = torch.where(msk[:, None, None, :, :], s, NEG_INF)
        m_new = torch.maximum(m_i, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_i - m_new)
        l_i = l_i * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqs,bshd->bhgqd", p, vj)
        m_i = m_new
    out = acc / torch.clamp(l_i, min=1e-30)[..., None]
    # rows with no valid key at all -> zeros
    out = torch.where((m_i > NEG_INF / 2)[..., None], out,
                      torch.zeros((), dtype=F32, device=out.device))
    return out.permute(0, 3, 1, 2, 4)


def flash_attention(q, k, v, qpos, kpos, *, causal=True, window=0, sink=0,
                    softcap=0.0, q_chunk=1024, kv_chunk=1024):
    """Memory-efficient attention.

    q [B,Sq,Hq,Dh]; k,v [B,Sk,Hkv,Dh]; qpos [B,Sq]; kpos [B,Sk] (-1 invalid).
    Returns [B,Sq,Hq,Dh] in q.dtype; only (q_chunk, kv_chunk) score blocks
    are ever materialized."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    if hq % hkv:
        raise ValueError(f"num heads {hq} not a multiple of kv heads {hkv}")
    g = hq // hkv
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, sq, hkv, g, dh)
    outs = []
    for lo in range(0, sq, q_chunk):
        hi = min(sq, lo + q_chunk)
        outs.append(_flash_chunk_scan(
            qg[:, lo:hi], qpos[:, lo:hi], k, v, kpos, causal=causal,
            window=window, sink=sink, softcap=softcap, scale=scale,
            kv_chunk=kv_chunk))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def naive_attention(q, k, v, qpos, kpos, *, causal=True, window=0, sink=0,
                    softcap=0.0):
    """O(Sq*Sk)-memory reference used only in tests."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dh).to(F32) / math.sqrt(dh)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg, k.to(F32))
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    msk = _mask(qpos, kpos, causal=causal, window=window, sink=sink)
    s = torch.where(msk[:, None, None, :, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(msk[:, None, None, :, :].any(dim=-1, keepdim=True), p,
                    torch.zeros((), dtype=F32, device=p.device))
    o = torch.einsum("bhgqs,bshd->bqhgd", p, v.to(F32))
    return o.reshape(b, sq, hq, dh).to(q.dtype)


def swiglu(p, x):
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    return (F.silu(g.to(F32)).to(x.dtype) * u) @ p["w_down"]


def mlp(p, x):
    """GELU MLP.  ``jax.nn.gelu`` defaults to the tanh approximation, so
    this one does too (the exact erf form differs by up to ~1e-3)."""
    h = x @ p["w_in"]
    h = F.gelu(h.to(F32), approximate="tanh").to(x.dtype)
    return h @ p["w_out"]


# ---------------------------------------------------------------------------
# Mixture of Experts (capacity-based dispatch, GShard/Switch style; a token
# over an expert's capacity falls through to the residual connection)
# ---------------------------------------------------------------------------
def moe_route(probs, *, top_k: int, capacity_factor: float):
    """The routing of ``moe_ffn``: probs [T, E] fp32 ->

      gate_w    [T, k]   top-k weights renormalized by max(sum, 1e-9)
      gate_idx  [T, k]   their experts; ties go to the lower index, as
                         ``lax.top_k`` (a stable descending sort)
      pos       [T*k]    each entry's slot in its expert, counted over the
                         token-major [T*k] order (token t's k entries
                         are entries t*k .. t*k+k-1)
      keep      [T*k]    pos < cap
      cap       int      max(1, ceil(T*k/E * capacity_factor)), from the
                         static shape, so the body needs no host sync

    Padded and inactive rows route like any other token and take
    capacity, as in the JAX package: the drops depend on T."""
    t, e = probs.shape
    k = top_k
    _, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_idx = order[:, :k]
    gate_w = torch.gather(probs, 1, gate_idx)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    cap = max(1, int(math.ceil(t * k / e * capacity_factor)))
    flat_e = gate_idx.reshape(-1)
    onehot = (flat_e[:, None] == torch.arange(e, device=probs.device)).to(
        torch.int32)                                       # [T*k, E]
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1)
    return gate_w, gate_idx, pos, pos < cap, cap


def moe_ffn(p, x, *, num_experts: int, top_k: int,
            capacity_factor: float = 2.0):
    """x [..., d] -> (y [..., d], aux_loss scalar): the JAX package's
    ``moe_ffn`` with its capacity rule and drops.

    No atomics and no duplicate-index writes that matter: a kept entry
    owns its (expert, slot); dropped entries are routed to a spare slot
    ``cap`` of a [E, cap + 1, d] buffer that the expert products never
    read.  The k outputs of a token are summed in a fixed order (over
    the k axis of [T, k, d]), so a replay of a CUDA graph equals the
    eager run bit for bit.  Nothing here syncs with the host."""
    orig_shape = x.shape
    d = orig_shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    e, k = num_experts, top_k

    logits = (xt @ p["router"]).to(F32)                    # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx, pos, keep, cap = moe_route(
        probs, top_k=k, capacity_factor=capacity_factor)

    # load-balance aux loss (Switch eq. 4)
    me = probs.mean(dim=0)
    flat_e = gate_idx.reshape(-1)
    ce = (flat_e[:, None] == torch.arange(e, device=x.device)).to(F32).sum(
        0) / (t * k)
    aux = e * (me * ce).sum()

    tok = torch.arange(t * k, device=x.device) // k
    slot = torch.where(keep, pos, torch.full_like(pos, cap))
    buf = torch.zeros((e, cap + 1, d), dtype=xt.dtype, device=x.device)
    buf[flat_e, slot] = xt[tok]
    buf = buf[:, :cap]

    g = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    h = F.silu(g.to(F32)).to(x.dtype) * u
    outb = torch.bmm(h, p["w_down"])                       # [E, cap, d]

    safe_pos = torch.where(keep, pos, torch.full_like(pos, cap - 1))
    gathered = outb[flat_e, safe_pos]                      # [T*k, d]
    w = (gate_w.reshape(-1) * keep).to(outb.dtype)
    y = (gathered * w[:, None]).reshape(t, k, d).sum(dim=1)
    return y.reshape(orig_shape), aux
