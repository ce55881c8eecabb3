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

Under ``distributed.api.use_rules(mesh, rules)`` the same entry points
run on DTensor params and state (``distributed.sharding``): ``D.shard``
pins activations to the rules' layout at the reference's sites (each
named below), the in-place state writes touch only the rank's own block
of the state (``_scatter_slots``, ``_copy_into``: DTensor refuses an
in-place write that would move a sharded dim), and the tensors the model
makes itself (aranges, fills, the RoPE frequencies) enter as replicated
through ``D.implicit_replication`` at each entry point.  Outside
``use_rules`` every ``D.`` call is the identity and no DTensor is made.
"""
from __future__ import annotations

import functools
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
from repro_torch.distributed import api as D
from repro_torch.distributed import layout
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


def _param_tree(cfg: ModelConfig, leaf):
    """The params' tree (embed, final_norm, lm_head unless tied, one stack
    per pattern slot, the remainder blocks, the encoder), each leaf
    ``leaf(name, shape, stacked)``, made in a fixed order (the draws of
    ``init_params`` follow it)."""
    n_full, rem = divmod(cfg.num_layers, len(cfg.layer_pattern))

    def block(kind, stack_n):
        return {name: leaf(name, ((stack_n,) if stack_n else ()) + shp,
                           bool(stack_n))
                for name, shp in _block_param_shapes(cfg, kind).items()}

    params: Dict[str, Any] = {
        "embed": leaf("embed", (cfg.vocab_size, cfg.d_model), False),
        "final_norm": leaf("final_norm", (cfg.d_model,), False),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = leaf("lm_head", (cfg.d_model, cfg.vocab_size),
                                 False)
    pattern = cfg.layer_pattern
    params["stack"] = {f"s{i}": block(kind, n_full)
                       for i, kind in enumerate(pattern)}
    params["rem"] = [block(pattern[i], 0) for i in range(rem)]
    if cfg.is_encdec:
        params["encoder"] = {
            "stack": {"s0": block(ENC_ATTN, cfg.encoder_layers)},
            "final_norm": leaf("final_norm", (cfg.d_model,), False)}
    return params


def _leaf_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    return F32 if _is_norm(name) or name in FP32_LEAVES \
        else torch_dtype(cfg.dtype)


def param_shapes(cfg: ModelConfig):
    """``init_params``' tree of ``meta`` tensors: its structure, shapes and
    dtypes, nothing allocated."""
    check_supported(cfg)
    return _param_tree(cfg, lambda name, shape, _: torch.empty(
        shape, dtype=_leaf_dtype(cfg, name), device="meta"))


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
    depth_scale = 0.02 / math.sqrt(2.0 * cfg.num_layers)

    def uniform(full, lo, hi):
        u = torch.rand(full, generator=generator, dtype=F32,
                       device=generator.device)
        return (lo + (hi - lo) * u).to(device)

    def leaf(name, full, stacked):
        if _is_norm(name) or name in ("dt_bias", "b_a", "b_x", "gate_attn",
                                      "gate_ffn"):
            return torch.zeros(full, dtype=F32, device=device)
        if name == "lam":
            # a in [0.9, 0.999] roughly (the Griffin init):
            # softplus^-1(-log a) of a = u^(1/c)
            a = uniform(full, 0.9, 0.999) ** (1.0 / L._LRU_C)
            return torch.log(torch.expm1(-torch.log(a)))
        if name == "A_log":
            return torch.log(uniform(full, 1.0, 16.0))
        if name == "Dskip":
            return torch.ones(full, dtype=F32, device=device)
        scale = depth_scale if name in ("wo", "x_wo", "w_out", "ffn_w_down",
                                        "ffn_w_out") else 0.02
        draw = _normal_stacked if stacked else _normal
        return draw(generator, full, scale, torch_dtype(cfg.dtype), device)

    return _param_tree(cfg, leaf)


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
    """The zeroed decode state (``pos`` -1).  Under ``use_rules`` its
    leaves are DTensors laid out by the rules (``layout._state_axes``),
    each rank allocating only its own block."""
    if D._current() is None:
        return plain_decode_state(cfg, batch, cache_len, device)
    mesh, rules = D._current()
    return layout.allocate(
        plain_decode_state(cfg, batch, cache_len, "meta"), mesh, rules,
        layout._state_axes, resolve_device(device),
        fill=lambda name: -1 if name == "pos" else 0)


def plain_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                       device=None):
    """``init_decode_state`` of plain tensors, whatever the rules."""
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
# state writes (rank-local under a mesh)
# ---------------------------------------------------------------------------
def _scatter_slots(dst, slots, vals, drop: bool = False) -> None:
    """``dst[b, slots[b, c]] = vals[b, c]`` in place; with ``drop`` a slot
    of ``dst.shape[1]`` is dropped (``L.scatter_rows_drop``).  On a
    DTensor ``dst`` rank-locally: each rank writes the entries whose row
    and slot fall in its own block and drops the others; ``vals`` comes
    to the rank laid out as ``dst`` but for dim 1 (an activation-sized
    move), ``slots`` as ``dst``'s rows."""
    if not D.is_dtensor(dst):
        if drop:
            L.scatter_rows_drop(dst, slots, vals)
        else:
            rows = torch.arange(dst.shape[0], device=dst.device)[:, None]
            dst[rows, slots.long()] = vals
        return
    local, slot0 = D.local_slots(dst)
    vals = D.local_like(vals, dst, dims=tuple(
        d for d in range(dst.dim()) if d != 1))
    slots = D.local_like(slots, dst, dims=(0,)).long() - slot0
    n = local.shape[1]
    slots = torch.where((slots >= 0) & (slots < n), slots,
                        torch.full_like(slots, n))
    L.scatter_rows_drop(local, slots, vals)


def _copy_into(dst, src) -> None:
    """``dst.copy_(src)`` in place; a DTensor ``dst`` takes ``src``
    redistributed to its own layout."""
    if D.is_dtensor(dst):
        dst.to_local().copy_(D.local_like(src, dst, dims=range(dst.dim())))
    else:
        dst.copy_(src)


# ---------------------------------------------------------------------------
# attention sub-blocks
# ---------------------------------------------------------------------------
def _split_heads(y, n: int, hd: int, heads: str):
    """A projection [B, S, n*hd] as heads [B, S, n, hd].  Under a mesh the
    flat dim is first laid out as the heads will be (split over the mesh
    axis of ``heads`` if n divides by it, else whole): DTensor cannot
    split a dim sharded finer than its leading factor."""
    b, s = y.shape[:2]
    mesh_ctx = D._current()
    if mesh_ctx is not None:
        spec = D.logical_to_spec(mesh_ctx[0], mesh_ctx[1], (b, s, n, hd),
                                 ("batch", "qkv_seq", heads, "head_dim"))
        y = D.constrain(y, spec[:3])
    return y.reshape(b, s, n, hd)


def _merge_heads(out):
    """Attention's [B, S, H, hd] as [B, S, H*hd] for the o projection.
    Under a mesh the heads are first laid out by the rules (split over
    the ``heads`` axis if H divides by it, else whole), so the flat dim
    is a plain split (DTensor turns a strided one into a broadcast
    batched matmul against the weight)."""
    b, s = out.shape[:2]
    if D._current() is None:
        return out.reshape(b, s, -1)
    out = D.shard(out, "batch", "qkv_seq", "heads", "head_dim")
    # then split as the o projection's input dim is stored: an explicit
    # move, so that the backward brings the grad back to the heads'
    # layout before the view (a move inside the matmul would not)
    return D.shard(out.reshape(b, s, -1), "batch", "qkv_seq", "heads_dim")


def _heads_split(x) -> int:
    """Into how many blocks a DTensor's dim 2 (its heads) is split."""
    from torch.distributed.tensor import Shard
    n = 1
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim == 2:
            n *= x.device_mesh.size(i)
    return n


def _mesh_kv_heads(q, k, v):
    """Under a mesh: when q's heads are split over more blocks than there
    are kv heads (GQA, e.g. 8 kv heads on a model axis of 16), k and v
    repeated to q's heads and laid out as q, so the attention stays
    head-parallel (DTensor cannot split the grouped [Hkv, G] view of a
    finer-split heads dim).  k and v as they are otherwise."""
    if not D.is_dtensor(q) or q.shape[2] == k.shape[2]:
        return k, v
    n = _heads_split(q)
    if n == 1 or k.shape[2] % n == 0:
        return k, v
    idx = torch.arange(q.shape[2], device=q.device) // (
        q.shape[2] // k.shape[2])
    return tuple(D.constrain(t.index_select(2, idx), _spec_of(q))
                 for t in (k, v))


def _attend(q, k, v, qpos, kpos, like_kv: bool = False, **kw):
    """``L.flash_attention``.  Under a mesh, rank-local: attention over an
    unsplit key sequence is batch- and head-parallel, so q, k, v and the
    positions are laid out alike on rows and heads (as q is, or, with
    ``like_kv``, as a cache or features k is: the small q moves, not the
    state), each rank attends over its own block and the blocks form
    the output.  DTensor's own propagation through the grouped einsums
    is skipped: on a 3-axis mesh it takes minutes per op to plan."""
    if not D.is_dtensor(q) and not D.is_dtensor(k):
        return L.flash_attention(q, k, v, qpos, kpos, **kw)
    src = D.to_dtensor(k if like_kv else q, D._current()[0])
    spec = _spec_of(src)
    spec = (spec[0], None, spec[2], None)
    q = D.constrain(q, spec)
    if not like_kv:
        k, v = _mesh_kv_heads(q, k, v)
    ql, kl, vl = (D.constrain(t, spec).to_local() for t in (q, k, v))
    pq, pk = (D.constrain(t, spec[:2]).to_local() for t in (qpos, kpos))
    out = L.flash_attention(ql, kl, vl, pq, pk, **kw)
    return D.from_local(out, q.device_mesh, q.placements, q.shape)


def _spec_of(x):
    """The spec of a DTensor's placements (one entry per dim)."""
    from torch.distributed.tensor import Shard
    names = x.device_mesh.mesh_dim_names
    out = [[] for _ in range(x.dim())]
    for name, pl in zip(names, x.placements):
        if isinstance(pl, Shard):
            out[pl.dim].append(name)
    return tuple(None if not e else e[0] if len(e) == 1 else tuple(e)
                 for e in out)


def _qkv_proj(p, x, cfg: ModelConfig):
    """Self-attention's q, k, v (a DEC_XATTN block's unprefixed ones)."""
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(x @ p["wq"], hq, hd, "heads")
    k = _split_heads(x @ p["wk"], hkv, hd, "kv_heads")
    v = _split_heads(x @ p["wv"], hkv, hd, "kv_heads")
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
    # mesh site: q and k after RoPE (ref model.py:270-271)
    q = D.shard(q, "batch", "qkv_seq", "heads", "head_dim")
    k = D.shard(k, "batch", "qkv_seq", "kv_heads", "head_dim")
    b, s = x.shape[:2]
    if ctx.mode == "train":
        out = _attend(q, k, v, ctx.qpos, ctx.qpos, causal=causal,
                                window=win, softcap=cfg.attn_logit_softcap,
                                q_chunk=ctx.q_chunk, kv_chunk=ctx.kv_chunk)
    elif ctx.mode == "prefill":
        cache_n = st["k"].shape[1]
        idx = torch.arange(s, device=x.device)[None, :]
        kpos = torch.where(idx < ctx.lengths[:, None], ctx.qpos,
                           torch.full((), -1, dtype=ctx.qpos.dtype,
                                      device=x.device)).to(torch.int32)
        out = _attend(q, k, v, ctx.qpos, kpos, causal=True,
                                window=win, softcap=cfg.attn_logit_softcap,
                                q_chunk=ctx.q_chunk, kv_chunk=ctx.kv_chunk)
        m = min(s, cache_n)
        slots = (torch.arange(s - m, s, device=x.device) % cache_n)[None]
        # mesh site: the prefill write, rank-local
        for name, val in (("k", k), ("v", v), ("pos", kpos)):
            _scatter_slots(st[name], slots.expand(b, m), val[:, s - m:])
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
            for name, val in (("k", k), ("v", v), ("pos", kpos)):
                _scatter_slots(st[name], lost, val, drop=True)
    elif ctx.mode == "decode":
        cache_n = st["k"].shape[1]
        slot = (ctx.lengths % cache_n).long()
        # mesh site: the decode write, rank-local (ref model.py:326-328)
        for name, val in (("k", k), ("v", v),
                          ("pos", ctx.lengths.to(torch.int32)[:, None])):
            _scatter_slots(st[name], slot[:, None], val)
        # mesh site: the cache after its write (ref model.py:329-330)
        kc = D.shard(st["k"], "kv_batch", "cache", "kv_heads", "head_dim")
        vc = D.shard(st["v"], "kv_batch", "cache", "kv_heads", "head_dim")
        mesh_ctx = D._current()
        if mesh_ctx is not None and mesh_ctx[1].get("_explicit_decode_attn"):
            # the pinned flash-decoding schedule (ref model.py:331-341)
            from repro_torch.distributed.collectives import \
                decode_attention_sharded
            out = decode_attention_sharded(
                q, kc, vc, st["pos"], ctx.lengths, mesh=mesh_ctx[0],
                rules=mesh_ctx[1], window=win,
                softcap=cfg.attn_logit_softcap)
        elif D.is_dtensor(kc) and _spec_of(kc)[1] is not None:
            # mesh site: the implicit schedule over a sequence-sharded
            # cache (fastdecode): DTensor's propagation picks the
            # collectives around the softmax; q is laid out as the
            # cache's rows and kv heads (its heads gather, not the cache)
            kv_spec = _spec_of(kc)
            q = D.constrain(q, (kv_spec[0], None, kv_spec[2], None))
            out = L.flash_attention(q, kc, vc, ctx.qpos, st["pos"],
                                    causal=True, window=win,
                                    softcap=cfg.attn_logit_softcap,
                                    kv_chunk=max(cache_n, 1))
        else:
            out = _attend(q, kc, vc, ctx.qpos, st["pos"], like_kv=True,
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
        out = _attend(q, kcat, vcat, qpos, pcat, causal=True, window=win,
                      softcap=cfg.attn_logit_softcap, q_chunk=ctx.q_chunk,
                      kv_chunk=max(kcat.shape[1], 1))
        for name, val in (("k", k), ("v", v),
                          ("pos", qpos.to(torch.int32))):
            _scatter_slots(st[name], slots, val, drop=True)
    else:
        raise ValueError(f"attention mode {ctx.mode!r}")
    out = _merge_heads(out) @ p["wo"]
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
    q = _split_heads(x @ p[prefix + "wq"], hq, hd, "heads")
    if ctx.mode == "decode":
        xk, xv = st["xk"], st["xv"]
    else:
        f = ctx.enc_feats.to(x.dtype)
        se = f.shape[1]
        xk = _split_heads(f @ p[prefix + "wk"], hkv, hd, "kv_heads")
        xv = _split_heads(f @ p[prefix + "wv"], hkv, hd, "kv_heads")
        if st is not None:
            _copy_into(st["xk"], xk)
            _copy_into(st["xv"], xv)
    kpos = torch.zeros((b, xk.shape[1]), dtype=torch.int32, device=x.device)
    out = _attend(q, xk, xv, ctx.qpos, kpos, like_kv=ctx.mode == "decode",
                  causal=False, kv_chunk=ctx.kv_chunk)
    return _merge_heads(out) @ p[prefix + "wo"], st


# ---------------------------------------------------------------------------
# non-attention mixers
# ---------------------------------------------------------------------------
def _write(st, new) -> None:
    """Copy a mixer's new state into ``st`` in place; train mode has no
    state (``st`` None) and writes nothing."""
    if st is None:
        return
    for k, v in new.items():
        _copy_into(st[k], v)


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


def _ffn(p, x, cfg: ModelConfig, mode: str = ""):
    """(the FFN's output, its aux loss): a MoE's load-balance loss, 0.0
    for the others.  The aux loss is a training term; the serve path
    drops it.  A MoE in train or prefill mode on a mesh with a ``model``
    axis above 1 that divides the sequence takes the explicit schedule
    of ``distributed.moe`` (ref model.py:487-498)."""
    fp = {k[4:]: v for k, v in p.items() if k.startswith("ffn_")}
    if cfg.ffn_kind == FFN_MLP:
        return L.mlp(fp, x), 0.0
    if cfg.ffn_kind == FFN_MOE:
        mesh_ctx = D._current()
        if mesh_ctx is not None:
            mp = D.axis_sizes(mesh_ctx[0]).get("model", 1)
            if mode in ("train", "prefill") and mp > 1 and x.dim() == 3 \
                    and x.shape[1] % mp == 0:
                from repro_torch.distributed.moe import moe_ffn_distributed
                return moe_ffn_distributed(fp, x, cfg=cfg, mesh=mesh_ctx[0],
                                           rules=mesh_ctx[1])
            # otherwise (decode: one token a row) the few tokens are
            # replicated and the dispatch runs on DTensors; the expert
            # products keep the weights where they are stored
            x = D.constrain(x, (None,) * x.dim())
        return L.moe_ffn(fp, x, num_experts=cfg.num_experts,
                         top_k=cfg.top_k,
                         capacity_factor=cfg.moe_capacity)
    return L.swiglu(fp, x), 0.0


def _gather_seq(hn):
    """Mesh site (port-side): a sequence-parallel normed residual gathered
    over the sequence ONCE before the block's projections, as XLA's CSE
    does, not once per projection (DTensor gathers each matmul's input
    on its own)."""
    return D.shard(hn, "batch", "qkv_seq", "embed")


def apply_block(kind: str, p, h, st, ctx: Ctx):
    """Returns (h, st, aux): aux is the FFN's aux loss (0.0 but for a
    MoE FFN)."""
    cfg = ctx.cfg
    hn = _gather_seq(L.rms_norm(h, p["ln1"], cfg.norm_eps))
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
    # mesh site: the residual after the mixer (ref model.py:539)
    h = D.shard(h + mix, "batch", "seq", "embed")
    if kind == SSD or cfg.ffn_kind == FFN_NONE:
        return h, st, 0.0
    hn = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    if cfg.ffn_kind != FFN_MOE:
        hn = _gather_seq(hn)
    f, aux = _ffn(p, hn, cfg, ctx.mode)
    if kind == XATTN:
        f = f * torch.tanh(p["gate_ffn"].to(f.dtype))
    # mesh site: the residual after the FFN (ref model.py:547)
    return D.shard(h + f, "batch", "seq", "embed"), st, aux


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


def _entry(fn):
    """An entry point: under ``use_rules`` it runs in DTensor's implicit
    replication (see the module docstring)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with D.implicit_replication():
            return fn(*args, **kwargs)
    return run


def has_xattn(cfg: ModelConfig) -> bool:
    """The arch has cross-attention layers (XATTN or DEC_XATTN)."""
    return XATTN in cfg.layer_pattern or DEC_XATTN in cfg.layer_pattern


def early_fusion(cfg: ModelConfig) -> bool:
    """A ``vision_stub`` frontend with no cross-attention layer: its patch
    embeddings enter through ``_embed``."""
    return cfg.frontend == "vision_stub" and not has_xattn(cfg)


def _embed(params, cfg: ModelConfig, tokens, enc_feats=None):
    if D._current() is not None:
        # mesh site: the table at its use and h (ref model.py:612-614);
        # ``F.embedding`` keeps a vocab-sharded table sharded (each rank
        # looks up its own rows, then one h-sized reduction)
        tab = D.shard(params["embed"], "vocab", "embed")
        tokens = D.shard(tokens.long(), "batch", "seq")
        h = D.shard(F.embedding(tokens, tab), "batch", "seq", "embed")
    else:
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
    # mesh site: the head and the logits (ref model.py:647-652)
    if cfg.tie_embeddings:
        tab = D.shard(params["embed"], "vocab", "embed").t()
    else:
        tab = D.shard(params["lm_head"], "embed", "vocab")
    return D.shard((h @ tab).to(F32), "batch", "seq", "vocab")


@_entry
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


@_entry
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
    _copy_into(state["lengths"], prompt_lens)
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


@_entry
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


@_entry
def decode_step(params, cfg: ModelConfig, state, tokens, kv_chunk=1024):
    """One token per sequence.  tokens [B,1] -> (logits [B,V], state)."""
    h = _embed(params, cfg, tokens)
    lengths = state["lengths"]
    ctx = Ctx(cfg, "decode", lengths[:, None], lengths, kv_chunk, 1)
    h, state, _ = _run_layers(params, h, state, ctx)
    logits = _logits(params, cfg, h)[:, 0]
    state["lengths"] = lengths + 1
    return logits, state
