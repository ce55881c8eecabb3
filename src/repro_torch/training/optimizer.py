"""AdamW and the warmup-cosine schedule over the port's dict trees: the
JAX package's ``training/optimizer.py`` in torch.

The moments are fp32 whatever the param dtype (bf16-safe); the update is
the reference's formula in its order of operations: clip by the global
norm with ``min(1, clip / (gnorm + 1e-9))``, bias correction at the
incremented step in fp32, decay ``delta + wd * p`` on leaves of two or
more dims only (on the stacked layout that includes a full period's norm
scales and per-layer constants, ``[n_full, d]``, and leaves out the
same leaves of a remainder block: the reference's rule, kept), the new
value computed in fp32 and cast back to the leaf's dtype.
``torch.optim.AdamW`` is no substitute: it keeps bf16 moments for bf16
params, adds epsilon elsewhere and decays every leaf.

The update works IN PLACE on the params and the moments (under
``no_grad``) and returns them, so a train step holds one copy of each.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.training.tree import leaves, tree_map

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar on the params' device
    mu: Any
    nu: Any


def adamw(lr: Callable[[torch.Tensor], torch.Tensor] | float,
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, grad_clip: float = 1.0):
    """Returns (init_fn, update_fn); ``update_fn(grads, state, params)``
    -> (params, state, gnorm), params and moments updated in place."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params) -> AdamWState:
        dev = leaves(params)[0].device

        def z(p):
            # zeros_like: a DTensor param gets moments of its own layout
            return torch.zeros_like(p, dtype=F32)
        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                          tree_map(z, params), tree_map(z, params))

    @torch.no_grad()
    def update(grads, state: AdamWState, params):
        step = state.step + 1
        # the global norm, summed leaf by leaf in the reference's order
        sq = torch.zeros((), dtype=F32, device=step.device)
        for g in leaves(grads):
            sq = sq + torch.square(g.to(F32)).sum()
        gnorm = torch.sqrt(sq)
        scale = (torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
                 if grad_clip > 0 else 1.0)
        t = step.to(F32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=F32, device=t.device), t)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=F32, device=t.device), t)
        lr_t = lr_fn(step)

        def upd(g, m, n, p):
            g = g.to(F32) * scale
            m.mul_(b1).add_(g * (1 - b1))
            n.mul_(b2).add_(g.square_().mul_(1 - b2))
            delta = (m / bc1).div_((n / bc2).sqrt_().add_(eps))
            if weight_decay > 0 and p.dim() >= 2:     # decay matrices only
                delta.add_(p.to(F32) * weight_decay)
            p.copy_(p.to(F32) - delta.mul_(lr_t))

        tree_map(upd, grads, state.mu, state.nu, params)
        return params, AdamWState(step, state.mu, state.nu), gnorm

    return init, update


def cosine_warmup(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1):
    """step (int tensor) -> lr (fp32 tensor): linear warmup to
    ``peak_lr``, then a cosine down to ``floor * peak_lr`` at ``total``."""
    def fn(step):
        step = torch.as_tensor(step).to(F32)
        warm = peak_lr * step / max(1, warmup)
        prog = torch.clamp((step - warmup) / max(1, total - warmup),
                           0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return fn
