"""The port's model: the decoder of repro.models.model with the ATTN,
RG-LRU and SSD mixers, a SwiGLU, a GELU MLP or a mixture-of-experts FFN
(SSD blocks have none), the early fusion of a ``vision_stub`` frontend
(patch embeddings in place of the first token embeddings), the gated
cross-attention (XATTN) layers of a vision model, and whisper's
encoder-decoder: a non-causal encoder of ENC_ATTN blocks over stub frame
embeddings and DEC_XATTN decoder blocks (self-attention, then
cross-attention to the encoder output).

Public entry points (same layout and semantics as the JAX package):

    init_params(cfg, generator, device)
    train_forward(params, cfg, tokens, enc_feats=None, q_chunk, kv_chunk,
                  remat) -> (logits [B, S, V] fp32, aux)
    init_decode_state(cfg, batch, cache_len, device)
    prefill(params, cfg, tokens, prompt_lens, cache_len, enc_feats=None)
        -> (last_logits, state)
    prefill_chunk(params, cfg, state, tokens, chunk_pos) -> (last_logits, state)
    decode_step(params, cfg, state, tokens) -> (logits, state)
    scatter_rows(state, sub, rows, sub_rows)

Params are a plain dict mirroring the JAX pytree: ``embed``,
``final_norm``, ``lm_head``, ``stack`` (one entry ``s{i}`` per slot i
of ``cfg.layer_pattern``, {name: [n_full, ...]}), ``rem`` (the
blocks past the last full period, of ``layer_pattern[i]``'s kind) and,
for an encoder-decoder, ``encoder`` ({"stack": {"s0": ...},
"final_norm"}).
Layers run as a Python loop over the stacked leaves.  Decode state
(attention KV slabs; a cross-attention block's static ``xk``/``xv``,
written once by ``prefill``; a recurrent block's fp32 ``h`` and its conv
window) is preallocated, and ``prefill``, ``prefill_chunk``,
``decode_step`` and ``scatter_rows`` update it IN PLACE (the returned
state is the same tensors), which keeps one copy of the cache instead
of one per step.  ``train_forward`` keeps no state and writes nothing in
place, so autograd sees every op of it (the backward is autograd's, as
the JAX package's is ``jax.value_and_grad``'s).

This is the port's colocated oracle; the S-/R-Part split of each block
lives in ``repro_torch.core.decompose``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.config import (ATTN, DEC_XATTN, ENC_ATTN, FFN_MLP,
                                     FFN_MOE, FFN_NONE, FFN_SWIGLU, RGLRU,
                                     SSD, XATTN, ModelConfig,
                                     check_supported)
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import layers as L

F32 = torch.float32


class Ctx(NamedTuple):
    cfg: ModelConfig
    mode: str                    # train | prefill | chunk | decode
    qpos: torch.Tensor           # [B, Sq] absolute positions of the q tokens
    lengths: torch.Tensor        # [B] current sequence lengths
    kv_chunk: int = 1024
    q_chunk: int = 1024
    # [B, S_enc, d_enc] the features cross-attention projects at prefill:
    # the encoder's output, or a vision model's patch embeddings
    enc_feats: Optional[torch.Tensor] = None


def _is_norm(name: str) -> bool:
    return name.startswith("ln") or name.endswith("norm")


def _ffn_param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.ffn_kind == FFN_SWIGLU:
        return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    if cfg.ffn_kind == FFN_MLP:
        return {"w_in": (d, f), "w_out": (f, d)}
    if cfg.ffn_kind == FFN_MOE:
        e = cfg.num_experts
        return {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
                "w_down": (e, f, d)}
    raise NotImplementedError(f"ffn kind {cfg.ffn_kind!r} is not ported yet")


def _attn_param_shapes(cfg: ModelConfig, cross: bool = False
                       ) -> Dict[str, tuple]:
    """Q/K/V/O projections; cross-attention's K/V read the features
    (``encoder_d_model`` wide) and take no qk-norm."""
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    src = cfg.encoder_d_model if cross else d
    shapes = {"wq": (d, hq * hd), "wk": (src, hkv * hd),
              "wv": (src, hkv * hd), "wo": (hq * hd, d)}
    if cfg.qk_norm and not cross:
        shapes["q_norm"] = (hd,)
        shapes["k_norm"] = (hd,)
    return shapes


def _block_param_shapes(cfg: ModelConfig, kind: str = ATTN
                        ) -> Dict[str, tuple]:
    d = cfg.d_model
    shapes: Dict[str, tuple] = {"ln1": (d,)}
    if kind in (ATTN, ENC_ATTN):
        shapes.update(_attn_param_shapes(cfg))
    elif kind == DEC_XATTN:
        shapes.update(_attn_param_shapes(cfg))
        shapes["lnx"] = (d,)
        shapes.update({"x_" + k: v for k, v in
                       _attn_param_shapes(cfg, cross=True).items()})
    elif kind == XATTN:
        shapes.update(_attn_param_shapes(cfg, cross=True))
        shapes["gate_attn"] = (1,)
        shapes["gate_ffn"] = (1,)
    elif kind == RGLRU:
        w = cfg.rnn_width
        shapes.update({
            "w_in_rnn": (d, w), "w_in_gate": (d, w),
            "conv": (cfg.conv_width, w), "w_a": (w, w), "b_a": (w,),
            "w_x": (w, w), "b_x": (w,), "lam": (w,), "w_out": (w, d)})
    elif kind == SSD:
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssd_heads
        shapes.update({
            "w_in": (d, 2 * di + 2 * n + h),
            "conv": (cfg.conv_width, di + 2 * n),
            "A_log": (h,), "Dskip": (h,), "dt_bias": (h,),
            "gate_norm": (di,), "w_out": (di, d)})
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    if kind != SSD and cfg.ffn_kind != FFN_NONE:
        shapes["ln2"] = (d,)
        shapes.update({"ffn_" + k: v
                       for k, v in _ffn_param_shapes(cfg).items()})
    return shapes


# leaves the JAX package keeps in fp32 whatever ``cfg.dtype`` (besides the
# norm scales): the RG-LRU's gate biases and decay, the SSD's per-head
# constants, an XATTN block's tanh gates
FP32_LEAVES = ("lam", "b_a", "b_x", "A_log", "Dskip", "dt_bias",
               "gate_attn", "gate_ffn")


def _normal(gen, shape, scale, dtype, device):
    x = torch.randn(shape, generator=gen, dtype=F32, device=gen.device)
    return (x * scale).to(device=device, dtype=dtype)


def _normal_stacked(gen, shape, scale, dtype, device):
    """A stacked leaf drawn one layer at a time into its final dtype, so
    the fp32 transient is one layer's, not the stack's (llama-13b's
    stacked ``ffn_w_gate`` would be 11.3 GB of fp32 in one draw); an
    expert leaf [L, E, ...] one expert of one layer at a time (one
    grok-1 layer's ``ffn_w_gate`` is 6.4 GB of fp32)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        if len(shape) > 3:
            out[i] = _normal_stacked(gen, shape[1:], scale, dtype, device)
        else:
            out[i] = _normal(gen, shape[1:], scale, dtype, device)
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Random weights with the JAX package's shapes and scales (0.02, and
    0.02/sqrt(2L) for the output projections), zero-init norms and (as
    the JAX package) zero-init XATTN gates, so that an XATTN block with
    these weights is the identity: tanh(0) = 0.  The
    numbers are torch's, not jax.random's: tests that compare the two
    packages carry JAX's weights across with ``repro_torch.bridge``.
    Draws on ``generator``'s device, then moves to ``device``."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    n_full, rem = divmod(cfg.num_layers, len(cfg.layer_pattern))
    depth_scale = 0.02 / math.sqrt(2.0 * cfg.num_layers)

    def uniform(full, lo, hi):
        u = torch.rand(full, generator=generator, dtype=F32,
                       device=generator.device)
        return (lo + (hi - lo) * u).to(device)

    def block(kind, stack_n):
        out = {}
        for name, shp in _block_param_shapes(cfg, kind).items():
            full = ((stack_n,) if stack_n else ()) + shp
            if _is_norm(name) or name in ("dt_bias", "b_a", "b_x",
                                          "gate_attn", "gate_ffn"):
                out[name] = torch.zeros(full, dtype=F32, device=device)
            elif name == "lam":
                # a in [0.9, 0.999] roughly (the Griffin init):
                # softplus^-1(-log a) of a = u^(1/c)
                a = uniform(full, 0.9, 0.999) ** (1.0 / L._LRU_C)
                out[name] = torch.log(torch.expm1(-torch.log(a)))
            elif name == "A_log":
                out[name] = torch.log(uniform(full, 1.0, 16.0))
            elif name == "Dskip":
                out[name] = torch.ones(full, dtype=F32, device=device)
            else:
                scale = depth_scale if name in ("wo", "x_wo", "w_out",
                                                "ffn_w_down",
                                                "ffn_w_out") else 0.02
                draw = _normal_stacked if stack_n else _normal
                out[name] = draw(generator, full, scale, dtype, device)
        return out

    params: Dict[str, Any] = {
        "embed": _normal(generator, (cfg.vocab_size, cfg.d_model), 0.02,
                         dtype, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=F32, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(generator, (cfg.d_model, cfg.vocab_size),
                                    0.02, dtype, device)
    pattern = cfg.layer_pattern
    params["stack"] = {f"s{i}": block(kind, n_full)
                       for i, kind in enumerate(pattern)}
    params["rem"] = [block(pattern[i], 0) for i in range(rem)]
    if cfg.is_encdec:
        params["encoder"] = {
            "stack": {"s0": block(ENC_ATTN, cfg.encoder_layers)},
            "final_norm": torch.zeros((cfg.d_model,), dtype=F32,
                                      device=device)}
    return params


def _block_state(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                 device):
    dtype = torch_dtype(cfg.dtype)
    hkv, hd = cfg.num_kv_heads, cfg.head_dim

    def slab(c):
        return torch.zeros((batch, c, hkv, hd), dtype=dtype, device=device)
    if kind in (ATTN, DEC_XATTN):
        # a DEC_XATTN block's self-attention cache has no window
        c = min(cache_len, cfg.window) if cfg.window and kind == ATTN \
            else cache_len
        st = {"k": slab(c), "v": slab(c),
              "pos": torch.full((batch, c), -1, dtype=torch.int32,
                                device=device)}
        if kind == DEC_XATTN:
            st.update(xk=slab(cfg.encoder_seq), xv=slab(cfg.encoder_seq))
        return st
    if kind == XATTN:
        return {"xk": slab(cfg.encoder_seq), "xv": slab(cfg.encoder_seq)}
    if kind == RGLRU:
        w = cfg.rnn_width
        return {"h": torch.zeros((batch, w), dtype=F32, device=device),
                "conv": torch.zeros((batch, cfg.conv_width - 1, w),
                                    dtype=dtype, device=device)}
    if kind == SSD:
        return {"h": torch.zeros((batch, cfg.ssd_heads, cfg.ssd_head_dim,
                                  cfg.ssm_state), dtype=F32, device=device),
                "conv": torch.zeros((batch, cfg.conv_width - 1,
                                     cfg.d_inner + 2 * cfg.ssm_state),
                                    dtype=dtype, device=device)}
    # an ENC_ATTN block runs only in the stateless encoder
    raise ValueError(f"block kind {kind!r} has no decode state")


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      device=None):
    check_supported(cfg)
    device = resolve_device(device)
    pattern = cfg.layer_pattern
    n_full, rem = divmod(cfg.num_layers, len(pattern))

    def stacked(kind):
        one = _block_state(cfg, kind, batch, cache_len, device)
        return {k: v[None].repeat((n_full,) + (1,) * v.dim())
                for k, v in one.items()}

    return {
        "stack": {f"s{i}": stacked(kind) for i, kind in enumerate(pattern)},
        "rem": [_block_state(cfg, pattern[i], batch, cache_len, device)
                for i in range(rem)],
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# attention sub-blocks
# ---------------------------------------------------------------------------
def _qkv_proj(p, x, cfg: ModelConfig):
    """Self-attention's q, k, v (a DEC_XATTN block's unprefixed ones)."""
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, hq, hd)
    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _self_attention(p, x, st, ctx: Ctx, *, causal: bool = True):
    """Self-attention block body (no residual/norm).  Train (the decoder
    and the encoder): x is the whole sequence, every position valid, no
    state; ``causal=False`` for an ENC_ATTN block.  Prefill: x
    is the whole (right-padded) prompt and each row's last min(len,
    cache) tokens land in the ring cache.  Chunk: x is C tokens at
    positions ``qpos`` (-1 for padding), appended at the row's offset
    ``lengths`` and attended against [old cache + chunk].  Decode: x is
    one token, appended at ``lengths``.  ``st`` is updated in place and
    returned.  q and k are roped in every mode, the encoder's too."""
    cfg = ctx.cfg
    q, k, v = _qkv_proj(p, x, cfg)
    win = cfg.window
    q = L.rope(q, ctx.qpos, cfg.rope_theta)
    k = L.rope(k, ctx.qpos, cfg.rope_theta)        # keys stored rotated
    b, s = x.shape[:2]
    if ctx.mode == "train":
        out = L.flash_attention(q, k, v, ctx.qpos, ctx.qpos, causal=causal,
                                window=win, softcap=cfg.attn_logit_softcap,
                                q_chunk=ctx.q_chunk, kv_chunk=ctx.kv_chunk)
    elif ctx.mode == "prefill":
        cache_n = st["k"].shape[1]
        idx = torch.arange(s, device=x.device)[None, :]
        kpos = torch.where(idx < ctx.lengths[:, None], ctx.qpos,
                           torch.full((), -1, dtype=ctx.qpos.dtype,
                                      device=x.device)).to(torch.int32)
        out = L.flash_attention(q, k, v, ctx.qpos, kpos, causal=True,
                                window=win, softcap=cfg.attn_logit_softcap,
                                q_chunk=ctx.q_chunk, kv_chunk=ctx.kv_chunk)
        m = min(s, cache_n)
        slots = torch.arange(s - m, s, device=x.device) % cache_n
        st["k"][:, slots] = k[:, s - m:]
        st["v"][:, slots] = v[:, s - m:]
        st["pos"][:, slots] = kpos[:, s - m:]
        if s > cache_n:
            # a ring shorter than the padded prompt: the write above keeps
            # the last cache_n positions of the PADDED batch, which drops
            # a shorter row's oldest in-window tokens (the JAX package
            # does so).  Those positions [len - cache_n, s - cache_n) go
            # to their slots here, which hold padding (pos -1): a row the
            # write above served right is left bit for bit as it is
            keep = ((idx < ctx.lengths[:, None])
                    & (idx >= ctx.lengths[:, None] - cache_n)
                    & (idx < s - cache_n)).expand(b, s)
            lost = torch.where(keep, idx % cache_n,
                               torch.full_like(idx, cache_n))
            L.scatter_rows_drop(st["k"], lost, k)
            L.scatter_rows_drop(st["v"], lost, v)
            L.scatter_rows_drop(st["pos"], lost, kpos)
    elif ctx.mode == "decode":
        cache_n = st["k"].shape[1]
        slot = (ctx.lengths % cache_n).long()
        bidx = torch.arange(b, device=x.device)
        st["k"][bidx, slot] = k[:, 0]
        st["v"][bidx, slot] = v[:, 0]
        st["pos"][bidx, slot] = ctx.lengths.to(torch.int32)
        out = L.flash_attention(q, st["k"], st["v"], ctx.qpos, st["pos"],
                                causal=True, window=win,
                                softcap=cfg.attn_logit_softcap,
                                kv_chunk=max(cache_n, 1))
    elif ctx.mode == "chunk":
        # old entries at positions the chunk covers (a previous occupant's,
        # or rejected speculative tokens) are masked by pos >= base;
        # intra-chunk causality comes from the positions
        cache_n = st["k"].shape[1]
        qpos = ctx.qpos
        slots, old_pos, kpos_new = L.chunk_ring_plan(
            st["pos"], ctx.lengths, qpos >= 0, qpos, cache_n)
        kcat = torch.cat([st["k"], k.to(st["k"].dtype)], dim=1)
        vcat = torch.cat([st["v"], v.to(st["v"].dtype)], dim=1)
        pcat = torch.cat([old_pos, kpos_new], dim=1)
        out = L.flash_attention(q, kcat, vcat, qpos, pcat, causal=True,
                                window=win, softcap=cfg.attn_logit_softcap,
                                q_chunk=ctx.q_chunk,
                                kv_chunk=max(kcat.shape[1], 1))
        L.scatter_rows_drop(st["k"], slots, k)
        L.scatter_rows_drop(st["v"], slots, v)
        L.scatter_rows_drop(st["pos"], slots, qpos.to(torch.int32))
    else:
        raise ValueError(f"attention mode {ctx.mode!r}")
    out = out.reshape(b, s, -1) @ p["wo"]
    return out, st


def _cross_attention(p, x, st, ctx: Ctx, prefix: str = ""):
    """Cross-attention against static features (no residual/norm): q from
    x; K/V projected from ``ctx.enc_feats`` in train and prefill mode
    (prefill writes them into ``st["xk"]``/``st["xv"]`` in place), read
    from the state in decode mode.  Every feature slot is valid and none
    is causal (an all-zero key position).  ``prefix`` "x_" names a
    DEC_XATTN block's cross projections."""
    if ctx.mode == "chunk":
        raise NotImplementedError(
            "chunked prefill does not support cross-attention blocks "
            "(enc-dec / vision archs): use whole-prompt prefill")
    cfg = ctx.cfg
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b, s, _ = x.shape
    q = (x @ p[prefix + "wq"]).reshape(b, s, hq, hd)
    if ctx.mode == "decode":
        xk, xv = st["xk"], st["xv"]
    else:
        f = ctx.enc_feats.to(x.dtype)
        se = f.shape[1]
        xk = (f @ p[prefix + "wk"]).reshape(b, se, hkv, hd)
        xv = (f @ p[prefix + "wv"]).reshape(b, se, hkv, hd)
        if st is not None:
            st["xk"].copy_(xk)
            st["xv"].copy_(xv)
    kpos = torch.zeros((b, xk.shape[1]), dtype=torch.int32, device=x.device)
    out = L.flash_attention(q, xk, xv, ctx.qpos, kpos, causal=False,
                            kv_chunk=ctx.kv_chunk)
    return out.reshape(b, s, -1) @ p[prefix + "wo"], st


# ---------------------------------------------------------------------------
# non-attention mixers
# ---------------------------------------------------------------------------
def _write(st, new) -> None:
    """Copy a mixer's new state into ``st`` in place; train mode has no
    state (``st`` None) and writes nothing."""
    if st is None:
        return
    for k, v in new.items():
        st[k].copy_(v)


def _rglru_mixer(p, x, st, ctx: Ctx):
    """RG-LRU block body (no residual/norm); ``st`` {h, conv} updated in
    place.  Train mode runs from a zero state and keeps none.  Chunk mode
    continues the recurrence from ``st["h"]`` with identity steps (a=1,
    b=0) at invalid positions; prefill of ragged prompts freezes the conv
    window at each prompt's end and takes h at its last valid
    position."""
    gate = F.gelu((x @ p["w_in_gate"]).to(F32),
                  approximate="tanh").to(x.dtype)
    r = x @ p["w_in_rnn"]
    if ctx.mode == "chunk":
        valid = ctx.qpos >= 0
        r, new_conv = L.causal_conv1d_chunk(p["conv"], r, st["conv"],
                                            valid.sum(dim=1))
        a, b_ = L._rglru_gates(p, r)
        a = torch.where(valid[..., None], a, torch.ones((), dtype=F32,
                                                        device=a.device))
        b_ = torch.where(valid[..., None], b_, torch.zeros(
            (), dtype=F32, device=b_.device))
        h = L.rglru_scan_h0(a, b_, st["h"])
        new_h = h[:, -1, :]
    elif ctx.mode == "prefill":
        t_end = torch.clamp(ctx.lengths, 0, x.shape[1])
        r, new_conv = L.causal_conv1d_chunk(p["conv"], r, st["conv"], t_end)
        h = L.rglru_scan(p, r)
        idx = torch.clamp(ctx.lengths.long() - 1, 0, h.shape[1] - 1)
        new_h = h[torch.arange(h.shape[0], device=h.device), idx]
    elif ctx.mode == "decode":
        r, new_conv = L.causal_conv1d(p["conv"], r, st["conv"])
        h, new_h = L.rglru_step(p, r[:, 0], st["h"])
        h = h[:, None, :]
    elif ctx.mode == "train":
        r, new_conv = L.causal_conv1d(p["conv"], r)
        h = L.rglru_scan(p, r)
        new_h = None
    else:
        raise NotImplementedError(f"RG-LRU mode {ctx.mode!r} is not ported")
    out = (h.to(x.dtype) * gate) @ p["w_out"]
    _write(st, {"h": new_h, "conv": new_conv})
    return out, st


def _ssd_mixer(p, x, st, ctx: Ctx):
    """Mamba-2 SSD block body (no residual); ``st`` {h, conv} updated in
    place (train mode: no state, from h = 0).  Positions past a row's
    prompt (prefill) or invalid chunk positions are identity steps (dt=0,
    x=0) and do not advance the conv window."""
    cfg = ctx.cfg
    di, n, hh, pp = cfg.d_inner, cfg.ssm_state, cfg.ssd_heads, \
        cfg.ssd_head_dim
    b, s, _ = x.shape
    zxbcdt = x @ p["w_in"]
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * n, hh], dim=-1)
    xbc_in = F.silu(xbc.to(F32)).to(x.dtype)
    valid = None
    if ctx.mode in ("prefill", "chunk"):
        if ctx.mode == "chunk":
            valid = ctx.qpos >= 0
        else:
            valid = (torch.arange(s, device=x.device)[None, :]
                     < ctx.lengths[:, None])
        xbc, new_conv = L.causal_conv1d_chunk(p["conv"], xbc_in, st["conv"],
                                              valid.sum(dim=1))
    elif ctx.mode == "decode":
        xbc, new_conv = L.causal_conv1d(p["conv"], xbc_in, st["conv"])
    elif ctx.mode == "train":
        xbc, new_conv = L.causal_conv1d(p["conv"], xbc_in)
    else:
        raise NotImplementedError(f"SSD mode {ctx.mode!r} is not ported")
    xs, Bm, Cm = torch.split(xbc, [di, n, n], dim=-1)
    xs = xs.reshape(b, s, hh, pp)
    dt = F.softplus(dt.to(F32) + p["dt_bias"][None, None, :])
    if valid is not None:
        zero = torch.zeros((), dtype=F32, device=x.device)
        dt = torch.where(valid[..., None], dt, zero)
        xs = torch.where(valid[:, :, None, None], xs, zero.to(xs.dtype))
    if ctx.mode == "decode":
        y, new_h = L.ssd_step(xs[:, 0], dt[:, 0], p["A_log"], Bm[:, 0],
                              Cm[:, 0], p["Dskip"], st["h"])
        y = y[:, None]
    else:
        y, new_h = L.ssd_chunked(xs, dt, p["A_log"], Bm, Cm, p["Dskip"],
                                 chunk=cfg.ssd_chunk,
                                 h0=None if st is None else st["h"],
                                 return_state=True)
    y = y.reshape(b, s, di).to(x.dtype)
    y = L.rms_norm(y * F.silu(z.to(F32)).to(x.dtype), p["gate_norm"],
                   cfg.norm_eps)
    _write(st, {"h": new_h, "conv": new_conv})
    return y @ p["w_out"], st


def _ffn(p, x, cfg: ModelConfig):
    """(the FFN's output, its aux loss): a MoE's load-balance loss, 0.0
    for the others.  The aux loss is a training term; the serve path
    drops it."""
    fp = {k[4:]: v for k, v in p.items() if k.startswith("ffn_")}
    if cfg.ffn_kind == FFN_MLP:
        return L.mlp(fp, x), 0.0
    if cfg.ffn_kind == FFN_MOE:
        return L.moe_ffn(fp, x, num_experts=cfg.num_experts,
                         top_k=cfg.top_k,
                         capacity_factor=cfg.moe_capacity)
    return L.swiglu(fp, x), 0.0


def apply_block(kind: str, p, h, st, ctx: Ctx):
    """Returns (h, st, aux): aux is the FFN's aux loss (0.0 but for a
    MoE FFN)."""
    cfg = ctx.cfg
    hn = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    if kind == ATTN:
        mix, st = _self_attention(p, hn, st, ctx)
    elif kind == ENC_ATTN:
        mix, st = _self_attention(p, hn, st, ctx, causal=False)
    elif kind == XATTN:
        mix, st = _cross_attention(p, hn, st, ctx)
        mix = mix * torch.tanh(p["gate_attn"].to(mix.dtype))
    elif kind == DEC_XATTN:
        mix, st = _self_attention(p, hn, st, ctx)
        h = h + mix
        hx = L.rms_norm(h, p["lnx"], cfg.norm_eps)
        mix, st = _cross_attention(p, hx, st, ctx, prefix="x_")
    elif kind == RGLRU:
        mix, st = _rglru_mixer(p, hn, st, ctx)
    elif kind == SSD:
        mix, st = _ssd_mixer(p, hn, st, ctx)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    h = h + mix
    if kind == SSD or cfg.ffn_kind == FFN_NONE:
        return h, st, 0.0
    hn = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    f, aux = _ffn(p, hn, cfg)
    if kind == XATTN:
        f = f * torch.tanh(p["gate_ffn"].to(f.dtype))
    return h + f, st, aux


def per_layer(tree, cfg: ModelConfig):
    """A stacked params or state tree as one entry per layer, in layer
    order; stacked leaves are indexed (views), so in-place state updates
    land in ``tree``."""
    pattern = cfg.layer_pattern
    period = len(pattern)
    n_full = cfg.num_layers // period
    out = []
    for li in range(cfg.num_layers):
        per, slot = divmod(li, period)
        if per < n_full:
            out.append({k: v[per]
                        for k, v in tree["stack"][f"s{slot}"].items()})
        else:
            out.append(tree["rem"][li - n_full * period])
    return out


def _run_layers(params, h, state, ctx: Ctx, remat: bool = False):
    """Every layer in order; returns (h, state, aux), aux the blocks' aux
    losses summed in layer order from an fp32 0.  ``state`` is None in
    train mode.  ``remat`` checkpoints each full pattern period (the
    body of the JAX package's layer scan, which its ``jax.checkpoint``
    wraps): its activations are recomputed in the backward; the
    remainder blocks are not checkpointed, as in the JAX package."""
    cfg = ctx.cfg
    period = len(cfg.layer_pattern)
    n_full = cfg.num_layers // period
    ps = per_layer(params, cfg)
    sts = (per_layer(state, cfg) if state is not None
           else [None] * cfg.num_layers)

    def run(lo, hi, h, aux):
        for li in range(lo, hi):
            h, _, a = apply_block(cfg.pattern[li], ps[li], h, sts[li], ctx)
            aux = aux + a
        return h, aux

    aux = torch.zeros((), dtype=F32, device=h.device)
    for per in range(n_full):
        lo = per * period
        if remat:
            # the forward draws no random numbers: no RNG state to keep
            h, aux = checkpoint(run, lo, lo + period, h, aux,
                                use_reentrant=False,
                                preserve_rng_state=False)
        else:
            h, aux = run(lo, lo + period, h, aux)
    h, aux = run(n_full * period, cfg.num_layers, h, aux)
    return h, state, aux


def has_xattn(cfg: ModelConfig) -> bool:
    """The arch has cross-attention layers (XATTN or DEC_XATTN)."""
    return XATTN in cfg.layer_pattern or DEC_XATTN in cfg.layer_pattern


def early_fusion(cfg: ModelConfig) -> bool:
    """A ``vision_stub`` frontend with no cross-attention layer: its patch
    embeddings enter through ``_embed``."""
    return cfg.frontend == "vision_stub" and not has_xattn(cfg)


def _embed(params, cfg: ModelConfig, tokens, enc_feats=None):
    h = params["embed"][tokens.long()]
    if enc_feats is not None and early_fusion(cfg):
        # early fusion: patch embeddings occupy the first n positions
        n = enc_feats.shape[1]
        h = torch.cat([enc_feats.to(h.dtype), h[:, n:]], dim=1)
    return h


def _encode(params, cfg: ModelConfig, enc_feats):
    """Whisper-style encoder over stub frame embeddings [B, S_enc, d]:
    ENC_ATTN blocks (roped, non-causal, every position valid) and the
    encoder's final norm."""
    h = enc_feats.to(torch_dtype(cfg.dtype))
    b, se = h.shape[:2]
    epos = torch.arange(se, dtype=torch.int32,
                        device=h.device)[None].expand(b, se)
    ectx = Ctx(cfg, "train", epos, torch.full((b,), se, dtype=torch.int32,
                                              device=h.device))
    enc = params["encoder"]
    stack = enc["stack"]["s0"]
    for i in range(cfg.encoder_layers):
        h, _, _ = apply_block(ENC_ATTN,
                              {k: v[i] for k, v in stack.items()}, h, None,
                              ectx)
    return L.rms_norm(h, enc["final_norm"], cfg.norm_eps)


def _logits(params, cfg: ModelConfig, h):
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    tab = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return (h @ tab).to(F32)


def train_forward(params, cfg: ModelConfig, tokens, enc_feats=None,
                  q_chunk: int = 1024, kv_chunk: int = 1024,
                  remat: bool = False):
    """tokens [B, S] -> (logits [B, S, V] fp32, aux loss scalar fp32).
    Every position is valid and causal; no state.  ``enc_feats``: an
    encoder-decoder's frame embeddings (the encoder runs over them), a
    cross-attention arch's patch features, or an early-fusion arch's
    patch embeddings (they replace the first n token embeddings).
    ``remat`` checkpoints each full pattern period (see ``_run_layers``).
    Differentiable end to end: nothing is written in place."""
    b, s = tokens.shape
    dev = tokens.device
    if has_xattn(cfg) and enc_feats is None:
        raise ValueError(f"{cfg.name} has cross-attention layers: "
                         f"train_forward needs enc_feats [B, "
                         f"{cfg.encoder_seq}, {cfg.encoder_d_model}]")
    enc_out = (_encode(params, cfg, enc_feats) if cfg.is_encdec
               else enc_feats)
    h = _embed(params, cfg, tokens, enc_feats)
    qpos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
    ctx = Ctx(cfg, "train", qpos, torch.full((b,), s, dtype=torch.int32,
                                             device=dev),
              kv_chunk, q_chunk, enc_out)
    h, _, aux = _run_layers(params, h, None, ctx, remat=remat)
    return _logits(params, cfg, h), aux


def prefill(params, cfg: ModelConfig, tokens, prompt_lens, cache_len: int,
            enc_feats=None, q_chunk: int = 1024, kv_chunk: int = 1024):
    """Process right-padded prompts tokens [B,Sp] with prompt_lens [B].
    ``enc_feats`` [B, n, d]: an early-fusion arch's patch embeddings
    (they replace the first n token embeddings), a cross-attention
    arch's features (a vision model's patch embeddings, or the frame
    embeddings an encoder-decoder's encoder runs over first; required
    for both).  Returns (logits at each prompt's last token [B,V],
    state)."""
    b, s = tokens.shape
    dev = tokens.device
    if has_xattn(cfg) and enc_feats is None:
        raise ValueError(f"{cfg.name} has cross-attention layers: prefill "
                         f"needs enc_feats [B, {cfg.encoder_seq}, "
                         f"{cfg.encoder_d_model}]")
    state = init_decode_state(cfg, b, cache_len, dev)
    prompt_lens = prompt_lens.to(torch.int32)
    state["lengths"] = prompt_lens.clone()
    enc_out = (_encode(params, cfg, enc_feats) if cfg.is_encdec
               else enc_feats)
    h = _embed(params, cfg, tokens, enc_feats)
    qpos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
    ctx = Ctx(cfg, "prefill", qpos, prompt_lens, kv_chunk, q_chunk,
              enc_out)
    h, state, _ = _run_layers(params, h, state, ctx)
    # the lm head runs on each prompt's last position only: the JAX
    # package builds [B, S, V] logits and then picks the same rows, which
    # gives the same numbers (the head is per position) at 0.6 MB per
    # prompt token less at V = 151,936
    last = torch.clamp(prompt_lens.long() - 1, 0, s - 1)
    h_last = h[torch.arange(b, device=dev), last][:, None]
    return _logits(params, cfg, h_last)[:, 0], state


def prefill_chunk(params, cfg: ModelConfig, state, tokens, chunk_pos,
                  kv_chunk: int = 1024):
    """Append a chunk of tokens to an EXISTING decode state, in place (KV
    offset = the row's current length), and return each row's logits at
    its last valid chunk position.

    tokens [B, C] (right-padded); chunk_pos [B, C] absolute positions,
    -1 marking padding and rows not being fed: such positions write no
    KV, and a row with none is untouched.  A fed row's first valid
    position must equal its current length.  Returns (last_logits [B, V],
    state) with ``lengths`` advanced by each row's valid count; chaining
    chunks reproduces ``prefill`` up to float association.  The lm head
    runs on each row's last valid position only (as in ``prefill``)."""
    b, c = tokens.shape
    chunk_pos = chunk_pos.to(torch.int32)
    valid = chunk_pos >= 0
    base = state["lengths"].to(torch.int32)
    ctx = Ctx(cfg, "chunk", chunk_pos, base, kv_chunk, c)
    h = _embed(params, cfg, tokens)
    h, state, _ = _run_layers(params, h, state, ctx)
    cnt = valid.sum(dim=1).to(torch.int32)
    last = torch.clamp(cnt.long() - 1, 0, c - 1)
    h_last = h[torch.arange(b, device=h.device), last][:, None]
    state["lengths"] = base + cnt
    return _logits(params, cfg, h_last)[:, 0], state


def scatter_rows(state, sub, rows, sub_rows):
    """Continuous batching: copy batch rows ``sub_rows`` of ``sub`` into
    rows ``rows`` of ``state``, in place (stack leaves carry a leading
    layer dim)."""
    dev = state["lengths"].device
    rows = torch.as_tensor(rows, dtype=torch.long, device=dev)
    sub_rows = torch.as_tensor(sub_rows, dtype=torch.long, device=dev)
    for slot, cur in state["stack"].items():
        for k, c in cur.items():
            c[:, rows] = sub["stack"][slot][k][:, sub_rows]
    for cs, ns in zip(state["rem"], sub["rem"]):
        for k in cs:
            cs[k][rows] = ns[k][sub_rows]
    state["lengths"][rows] = sub["lengths"][sub_rows]
    return state


def decode_step(params, cfg: ModelConfig, state, tokens, kv_chunk=1024):
    """One token per sequence.  tokens [B,1] -> (logits [B,V], state)."""
    h = _embed(params, cfg, tokens)
    lengths = state["lengths"]
    ctx = Ctx(cfg, "decode", lengths[:, None], lengths, kv_chunk, 1)
    h, state, _ = _run_layers(params, h, state, ctx)
    logits = _logits(params, cfg, h)[:, 0]
    state["lengths"] = lengths + 1
    return logits, state
