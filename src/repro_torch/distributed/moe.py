"""Distributed MoE FFN with an explicit collective schedule (the JAX
package's ``distributed/moe.py``).

The dispatch is local by construction:

  x [B@data, S@model, d]  --all-gather(model)-->  x [B@data, S, d]
  local routing + local capacity dispatch     (no cross-device indices)
  expert matmuls with ff@model weight shards  (activated FLOPs only)
  combine to y_partial [B@data, S, d]         (a partial sum over ff)
  y_partial --reduce-scatter(model)--> y [B@data, S@model, d]

Per layer the collective cost is one h-sized all-gather plus one h-sized
reduce-scatter over ``model`` — the Megatron-SP pair — while the expert
weights never move (a zero3 layout that stores them wider is gathered to
``ff@model`` first: the weight-read traffic).  Tokens over capacity fall
through to the residual.  The local routing and dispatch are
``layers.moe_ffn``'s on the rank's tokens and weight shards (its capacity
follows the local token count, as the reference's does).  Every move is
a DTensor redistribution, so autograd runs through it in train mode.

The backward: a rank's gradient of its local operands is a partial sum
wherever the ranks' work differs, over ``model`` (each holds an ff shard)
and over the batch axes that split the tokens, so the local operands
declare those ``grad_placements`` ``Partial`` and the redistributions'
backward reduce them (the all-gather of x becomes a reduce-scatter).  The
aux loss is the same on every ``model`` rank: it enters as a partial sum
of aux / (their count x the token-splitting ranks), so that its gradient
is counted once.
"""
from __future__ import annotations

from repro_torch.distributed.api import (P, axis_sizes, constrain,
                                         from_local, logical_to_spec,
                                         placements)
from repro_torch.models import layers as L


def moe_ffn_distributed(fp, x, *, cfg, mesh, rules):
    """fp: {'router','w_gate','w_up','w_down'}; x [B, S, d] (global).
    Returns (y laid out as x's ("batch", "seq", "embed") spec, the aux
    loss averaged over the batch axes, replicated)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    sizes = axis_sizes(mesh)
    names = list(sizes)
    x_spec = logical_to_spec(mesh, rules, x.shape, ("batch", "seq", "embed"))
    # x gathered over `model` on the sequence dim: the spec without it
    xg_spec = P(*(None if e == "model" else e for e in x_spec))
    xg_pl = placements(mesh, xg_spec)
    # the axes along which the ranks' work differs: the ff shards and
    # the batch axes that split the tokens
    differ = ["model"] + [ax for ax, p in zip(names, xg_pl)
                          if isinstance(p, Shard)]

    def local(t, spec):
        pl = placements(mesh, spec)
        grad = tuple(Partial() if ax in differ and not isinstance(p, Shard)
                     else p for ax, p in zip(names, pl))
        return constrain(t, spec, mesh).to_local(grad_placements=grad)

    xl = local(x, xg_spec)
    w_specs = {"router": P(None, None), "w_gate": P(None, None, "model"),
               "w_up": P(None, None, "model"), "w_down": P(None, "model", None)}
    wl = {k: local(fp[k], spec) for k, spec in w_specs.items()}
    y, aux = L.moe_ffn(wl, xl, num_experts=cfg.num_experts, top_k=cfg.top_k,
                       capacity_factor=cfg.moe_capacity)
    # y is a partial sum over the ff shards: reduce-scatter it back to
    # x's layout
    part = tuple(Partial() if ax == "model" else p
                 for ax, p in zip(names, xg_pl))
    y = from_local(y, mesh, part, x.shape)
    y = y.redistribute(mesh, placements(mesh, x_spec))
    # pmean over the batch axes (ref moe.py:50), and counted once over
    # `model`: a partial sum over every axis where the ranks differ
    n = 1
    for a in differ:
        n *= sizes[a]
    aux = from_local(aux / n, mesh, [Partial() if ax in differ
                                     else Replicate() for ax in names], ())
    aux = aux.redistribute(mesh, [Replicate()] * len(names))
    return y, aux
