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
    buf = xt.new_zeros((e, cap + 1, d))    # a DTensor's under a mesh
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


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin, arXiv:2402.19427)
# ---------------------------------------------------------------------------
_LRU_C = 8.0  # the fixed c exponent from the paper


def _rglru_gates(p, xc):
    """xc [..., W] (post-conv branch) -> (a, b) of h_t = a*h_{t-1} + b, in
    fp32 whatever xc's dtype."""
    x32 = xc.to(F32)
    r = torch.sigmoid(x32 @ p["w_a"].to(F32) + p["b_a"].to(F32))
    i = torch.sigmoid(x32 @ p["w_x"].to(F32) + p["b_x"].to(F32))
    log_a = -_LRU_C * F.softplus(p["lam"].to(F32)) * r
    a = torch.exp(log_a)
    # sqrt(1-a^2) multiplier, computed stably
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * (i * x32)


def _linear_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along dim 1 from h = 0:
    returns (prod_{k<=t} a_k, h_t).  Hillis-Steele doubling over the
    associative combine (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2), the
    operator ``lax.associative_scan`` takes: log2(S) elementwise steps of
    products and sums of terms in [0, 1] (no division, no
    exp(-cumsum(log a)), which overflows on long prompts).  Shapes only:
    no host sync."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return a, b


def rglru_scan(p, xc):
    """Full-sequence RG-LRU.  xc [B,S,W] -> h [B,S,W] (fp32)."""
    a, b = _rglru_gates(p, xc)
    return _linear_scan(a, b)[1]


def rglru_scan_h0(a, b, h0):
    """The recurrence from an explicit initial state (chunk
    continuation).  a, b [B,S,W] fp32 gates (identity steps: a=1, b=0),
    h0 [B,W] fp32.  Returns h [B,S,W]."""
    a_s, b_s = _linear_scan(a, b)
    return a_s * h0[:, None, :].to(F32) + b_s


def rglru_step(p, xc, h_prev):
    """One decode step.  xc [B,W], h_prev [B,W] (fp32) -> (h, h)."""
    a, b = _rglru_gates(p, xc)
    h = a * h_prev + b
    return h, h


def _conv_sum(w, xp, s: int):
    """sum_i xp[:, i:i+s] * w[i], in the order of the JAX package's
    Python ``sum`` (from 0, i ascending)."""
    ys = 0
    for i in range(w.shape[0]):
        ys = ys + xp[:, i:i + s, :] * w[i][None, None, :]
    return ys


def causal_conv1d(w, x, state=None):
    """Depthwise causal conv.  w [CW, D], x [B,S,D]; with ``state``
    [B, CW-1, D] (previous inputs) streaming decode.  Returns
    (y, new_state)."""
    cw = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    ys = _conv_sum(w, xp, x.shape[1])
    new_state = xp[:, xp.shape[1] - (cw - 1):, :] if cw > 1 else x[:, :0]
    return ys, new_state


def causal_conv1d_chunk(w, x, state, t_end):
    """Streaming causal conv over a chunk whose valid length varies per
    row.  w [CW, D], x [B,C,D], state [B, CW-1, D], t_end [B] int in
    [0, C].  y for all C positions (garbage past t_end, causally
    confined); each row's new state is the window ending at its LAST
    VALID position, so a row whose prompt ended mid-chunk keeps a clean
    state and a row with t_end == 0 keeps its old one."""
    cw = w.shape[0]
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    ys = _conv_sum(w, xp, x.shape[1])
    if cw > 1:
        idx = (t_end.long()[:, None]
               + torch.arange(cw - 1, device=x.device)[None, :])
        new_state = torch.gather(
            xp, 1, idx[..., None].expand(-1, -1, xp.shape[-1]))
    else:
        new_state = x[:, :0]
    return ys, new_state


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality, arXiv:2405.21060 §6)
# ---------------------------------------------------------------------------
def ssd_chunked(x, dt, A_log, B, C, D, *, chunk: int, h0=None,
                return_state: bool = False):
    """Chunk-parallel SSD, fp32 throughout.

    x [Bb,S,H,P], dt [Bb,S,H] (softplus'd, > 0), A_log [H] (A =
    -exp(A_log)), B, C [Bb,S,N] shared across heads (ngroups 1), D [H]
    skip, h0 [Bb,H,P,N] fp32 or None.  Returns y [Bb,S,H,P] (and h_last
    [Bb,H,P,N] with ``return_state``).  The chunk count comes from the
    static shape; the inter-chunk recurrence is a Python loop over it."""
    bb, s, h, p = x.shape
    n = B.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    x32 = x.to(F32)
    A = -torch.exp(A_log.to(F32))                          # [H] negative
    dA = dt.to(F32) * A[None, None, :]                     # [Bb,S,H]
    xc = x32.reshape(bb, nc, chunk, h, p)
    dtc = dt.to(F32).reshape(bb, nc, chunk, h)
    dAc = dA.reshape(bb, nc, chunk, h)
    Bc = B.to(F32).reshape(bb, nc, chunk, n)
    Cc = C.to(F32).reshape(bb, nc, chunk, n)

    cums = torch.cumsum(dAc, dim=2)                        # [Bb,nc,L,H]
    # intra-chunk: decay(i <- j) = exp(cums_i - cums_j), j <= i; masked
    # before the exp (a j > i entry would overflow)
    seg = cums[:, :, :, None, :] - cums[:, :, None, :, :]  # [Bb,nc,L,L,H]
    li = torch.arange(chunk, device=x.device)
    causal = (li[:, None] >= li[None, :])[None, None, :, :, None]
    decay = torch.exp(torch.where(causal, seg, torch.full(
        (), float("-inf"), dtype=F32, device=x.device)))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)           # [Bb,nc,L,L]
    w_ij = cb[..., None] * decay * dtc[:, :, None, :, :]   # [Bb,nc,L,L,H]
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", w_ij, xc)

    # chunk states: S_c = sum_j exp(cums_L - cums_j) dt_j B_j x_j
    chunk_decay = torch.exp(cums[:, :, -1:, :] - cums)     # [Bb,nc,L,H]
    states = torch.einsum("bcjh,bcjn,bcjhp->bchpn", chunk_decay * dtc, Bc,
                          xc)                              # [Bb,nc,H,P,N]

    # inter-chunk recurrence (nc steps), emitting each chunk's entry state
    tot_decay = torch.exp(cums[:, :, -1, :])               # [Bb,nc,H]
    carry = (torch.zeros((bb, h, p, n), dtype=F32, device=x.device)
             if h0 is None else h0.to(F32))
    prev = []
    for ci in range(nc):
        prev.append(carry)
        carry = carry * tot_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                 # [Bb,nc,H,P,N]

    in_decay = torch.exp(cums)                             # [Bb,nc,L,H]
    y_off = torch.einsum("bcin,bcih,bchpn->bcihp", Cc, in_decay,
                         prev_states)
    y = (y_diag + y_off).reshape(bb, nc * chunk, h, p)[:, :s]
    y = y + x32[:, :s] * D.to(F32)[None, None, :, None]
    if return_state:
        return y, carry
    return y


def ssd_step(x, dt, A_log, B, C, D, h_prev):
    """One decode step of the SSD recurrence.  x [Bb,H,P], dt [Bb,H],
    B, C [Bb,N], h_prev [Bb,H,P,N] fp32:
    h_t = exp(dt*A) h_{t-1} + dt * B x;  y = C.h + D x."""
    x32, dt32 = x.to(F32), dt.to(F32)
    A = -torch.exp(A_log.to(F32))
    da = torch.exp(dt32 * A[None, :])                      # [Bb,H]
    h = (h_prev * da[:, :, None, None]
         + torch.einsum("bh,bn,bhp->bhpn", dt32, B.to(F32), x32))
    y = torch.einsum("bn,bhpn->bhp", C.to(F32), h)
    return y + x32 * D.to(F32)[None, :, None], h


def ssd_naive(x, dt, A_log, B, C, D, h0=None):
    """Sequential reference recurrence (tests only)."""
    bb, s, h, p = x.shape
    n = B.shape[-1]
    hst = (torch.zeros((bb, h, p, n), dtype=F32, device=x.device)
           if h0 is None else h0.to(F32))
    ys = []
    for t in range(s):
        y, hst = ssd_step(x[:, t], dt[:, t], A_log, B[:, t], C[:, t], D, hst)
        ys.append(y)
    return torch.stack(ys, dim=1), hst
