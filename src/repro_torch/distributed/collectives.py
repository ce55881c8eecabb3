"""Explicit flash-decoding collective schedule (the JAX package's
``distributed/collectives.py``).

On the implicit path DTensor's sharding propagation picks the
collectives around the decode softmax over a sequence-sharded cache.
This module pins the schedule by hand, on the ranks' local blocks:

    each rank: partial online softmax over its own sequence chunk (fp32)
    combine:   all_reduce(m, MAX), all_reduce(l·corr, SUM),
               all_reduce(acc·corr, SUM)   over the ``model`` sub-group

i.e. exactly ONE [B,Hq,Dh]-sized reduction and two [B,Hq]-sized ones per
layer — the flash-decoding reduction, nothing else.  Selected by the rule
``_explicit_decode_attn`` (strategy ``fastdecode_sm``).  The local
partial is plain torch, as the reference's is jnp.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.api import (constrain, from_local,
                                         logical_to_spec, placements)

F32 = torch.float32
NEG_INF = -1e30


def _local_partial(q, kc, vc, pc, lengths, *, scale, window, sink, softcap):
    """Unnormalized attention of q [b,1,Hq,D] against the LOCAL seq chunk.
    Returns (acc [b,Hkv,G,D], l [b,Hkv,G], m [b,Hkv,G]) in fp32."""
    b, _, hq, dh = q.shape
    hkv = kc.shape[2]
    g = hq // hkv
    q32 = q[:, 0].reshape(b, hkv, g, dh).to(F32) * scale
    s = torch.einsum("bhgd,bshd->bhgs", q32, kc.to(F32))   # [b,hkv,g,S_loc]
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    qpos = lengths[:, None]
    valid = (pc >= 0) & (pc <= qpos)
    if window > 0:
        in_win = pc > qpos - window
        if sink > 0:
            in_win = in_win | (pc < sink)
        valid = valid & in_win
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)                                     # [b,hkv,g]
    p = torch.exp(s - m[..., None])
    p = torch.where(valid[:, None, None, :], p, 0.0)       # exp(NEG_INF-m)=0 anyway
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgs,bshd->bhgd", p, vc.to(F32))
    return acc, l, m


def _combine(acc, l, m, group):
    """The three all-reduces over ``group``; an all-masked row gives 0."""
    from torch.distributed import _functional_collectives as funcol
    m_g = funcol.wait_tensor(funcol.all_reduce(m, "max", group))
    corr = torch.exp(torch.clamp(m - m_g, min=-80.0))
    l_g = funcol.wait_tensor(funcol.all_reduce(l * corr, "sum", group))
    acc_g = funcol.wait_tensor(funcol.all_reduce(acc * corr[..., None],
                                                 "sum", group))
    out = acc_g / torch.clamp(l_g, min=1e-30)[..., None]
    return torch.where((m_g > NEG_INF / 2)[..., None], out, 0.0)


def decode_attention_sharded(q, kc, vc, pc, lengths, *, mesh, rules,
                             window: int = 0, sink: int = 0,
                             softcap: float = 0.0):
    """q [B,1,Hq,Dh]; kc,vc [B,S,Hkv,Dh] (cache AFTER the new-token write);
    pc [B,S]; lengths [B] (DTensors, or plain tensors taken as
    replicated).  Returns a [B,1,Hq,Dh] DTensor replicated over
    ``model``."""
    b, _, hq, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    # q is moved to the cache's batch layout at entry (activation-sized)
    q_spec = logical_to_spec(mesh, rules, q.shape,
                             ("kv_batch", None, "heads_rep", None))
    kv_spec = logical_to_spec(mesh, rules, kc.shape,
                              ("kv_batch", "cache", "kv_heads", "head_dim"))
    pc_spec = logical_to_spec(mesh, rules, pc.shape, ("kv_batch", "cache"))
    len_spec = logical_to_spec(mesh, rules, lengths.shape, ("kv_batch",))
    ql, kl, vl, pl, ll = (constrain(x, spec, mesh).to_local() for x, spec in (
        (q, q_spec), (kc, kv_spec), (vc, kv_spec), (pc, pc_spec),
        (lengths, len_spec)))
    acc, l, m = _local_partial(ql, kl, vl, pl, ll, scale=scale,
                               window=window, sink=sink, softcap=softcap)
    out = _combine(acc, l, m, mesh.get_group("model"))     # [b,hkv,g,dh]
    out = out.reshape(ql.shape[0], 1, hq, dh).to(ql.dtype)
    return from_local(out, mesh, placements(mesh, q_spec), q.shape)
