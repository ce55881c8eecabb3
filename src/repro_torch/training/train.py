"""Loss and train step: the JAX package's ``training/train.py`` in torch.
The backward is autograd's over ``models.model.train_forward`` (the
reference's is ``jax.value_and_grad``'s); the step runs eager.  Under
``distributed.api.use_rules`` the params, moments and batch are DTensors
and the step runs in DTensor's implicit replication; the grads are
redistributed to ``grad_shardings`` (by default each param's own
layout) before the update, as the reference constrains them."""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from repro_torch.distributed import api as D
from repro_torch.models import model as M
from repro_torch.training.optimizer import AdamWState, adamw, cosine_warmup
from repro_torch.training.tree import leaves, tree_map

F32 = torch.float32


def loss_fn(params, cfg: ModelConfig, batch: Dict, *, q_chunk: int = 1024,
            kv_chunk: int = 1024, remat: bool = False):
    """(total, {"ce", "aux"}): the masked mean next-token cross-entropy
    (fp32 log-softmax; the mean over max(sum(mask), 1)) plus
    ``cfg.router_aux_loss`` times the blocks' aux loss.  ``batch`` holds
    tokens and targets [B, S], optional mask [B, S] and enc_feats."""
    logits, aux = M.train_forward(params, cfg, batch["tokens"],
                                  batch.get("enc_feats"), q_chunk, kv_chunk,
                                  remat=remat)
    logp = F.log_softmax(logits.to(F32), dim=-1)
    tgt = batch["targets"].long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    total = ce + cfg.router_aux_loss * aux
    return total, {"ce": ce, "aux": aux}


def loss_and_grads(params, cfg: ModelConfig, batch: Dict, **kw):
    """((total, metrics), grads): ``loss_fn`` and its gradient with
    respect to every leaf of ``params`` (a tree of the same structure; a
    leaf the loss does not reach gets zeros, as under
    ``jax.value_and_grad``).  The caller's tensors are not marked: the
    graph is built on detached aliases of them.  Under ``use_rules`` the
    backward too runs in DTensor's implicit replication."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = leaves(live)
    with D.implicit_replication():
        total, metrics = loss_fn(live, cfg, batch, **kw)
        grads = torch.autograd.grad(total, flat, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (total.detach(), metrics), tree_map(lambda p: by_id[id(p)], live)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def make_train_step(cfg: ModelConfig, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    weight_decay: float = 0.1, remat: bool = False,
                    q_chunk: int = 1024, kv_chunk: int = 1024,
                    grad_shardings=None):
    """Returns (init_state_fn, train_step).  ``train_step(state, batch)``
    -> (state, metrics): loss, backward, then the AdamW update (in place
    on the params and moments); metrics are ce, aux, loss and grad_norm
    as device scalars (reading them syncs).  Eager: no graph capture, no
    compile."""
    init_opt, update = adamw(cosine_warmup(peak_lr, warmup, total_steps),
                             weight_decay=weight_decay)

    def init_state(params) -> TrainState:
        return TrainState(params, init_opt(params))

    def constrain(g, p, sh=None):
        if not D.is_dtensor(g):
            return g
        want = sh.placements if sh is not None else p.placements
        return g if tuple(g.placements) == tuple(want) \
            else g.redistribute(g.device_mesh, want)

    def train_step(state: TrainState, batch: Dict):
        with D.implicit_replication():
            (loss, metrics), grads = loss_and_grads(
                state.params, cfg, batch, q_chunk=q_chunk,
                kv_chunk=kv_chunk, remat=remat)
            if D._current() is not None:
                grads = (tree_map(constrain, grads, state.params)
                         if grad_shardings is None else
                         tree_map(constrain, grads, state.params,
                                  grad_shardings))
            new_params, new_opt, gnorm = update(grads, state.opt,
                                                state.params)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return TrainState(new_params, new_opt), metrics

    return init_state, train_step
