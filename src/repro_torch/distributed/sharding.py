"""Sharding strategies: ``baseline`` (megatron-TP colocated serving) vs
``fastdecode`` (the paper's disaggregated KV), plus training FSDP+TP — the
JAX package's ``distributed/sharding.py`` on DeviceMesh / DTensor.

Everything is expressed as logical-axis rules (``distributed.api``); the
two serving strategies differ ONLY in where the KV-cache lives:

  baseline:   cache [B@data, S,      kvh@model, Dh]   (heads-parallel; GQA
              kvh=8 < model=16 falls back to REPLICATION — the memory
              wall of paper Fig. 1/3)
  fastdecode: cache [B@data, S@model, kvh(full),  Dh]   (sequence-chunk
              resident "R-workers" on every device; attention runs where
              the KV lives; only q/k/v/o activations + softmax partials
              cross the links)

Params: TP over ``model`` for qkvo/ffn; large models additionally shard
the same feature dims over ``data`` (ZeRO-3-style storage).

A sharding is an ``api.Sharding(mesh, spec, placements)``; the per-leaf
logical axes and the trees of layouts are ``distributed.layout``'s (it
imports nothing of the model, which lays its decode state out with it);
this module builds them over the model's trees.  ``distribute``
makes DTensors of a tree of plain tensors (every rank holds the same
global values, made from the same seed, and keeps its own slice: no
collective).  Shapes come from the ``meta`` device, so a tree of 314 B
parameters costs nothing to lay out.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.config import ModelConfig
from repro_torch.core.perfmodel import GPU_H100
from repro_torch.distributed.api import (P, Sharding, axis_sizes,
                                         named_sharding, sharding_of)
from repro_torch.distributed.layout import (_param_axes, _state_axes,
                                            _tree_shardings)
from repro_torch.models import model as M
from repro_torch.models.model import param_shapes
from repro_torch.training.tree import tree_map

BATCH_AXES = ("pod", "data")


# ---------------------------------------------------------------------------
# logical-axis rules per (strategy, mode): the reference's dicts, verbatim
# ---------------------------------------------------------------------------
def make_rules(strategy: str, mode: str, *, zero3: bool = False,
               train: bool = False) -> Dict[str, Any]:
    # Weight-dim sharding: TP over `model`; big models (zero3) extend the
    # SAME dims over (`pod`,`data`) for storage.  The stacked layer dim is
    # never sharded.
    wdims: Any = ("model", "pod", "data") if zero3 else "model"
    rules: Dict[str, Any] = {
        # params
        "vocab": wdims,
        "heads_dim": wdims,
        "ff": wdims,
        "expert": "data",
        "rnn": wdims,
        "inner": wdims,
        "embed": None,
        "layer": None,
        # activations
        "batch": BATCH_AXES,
        "kv_batch": BATCH_AXES,   # the KV/recurrent state is ALWAYS
                                  # batch-sharded over data (the R-workers)
        # Megatron-style sequence parallelism for the residual stream in
        # train/prefill: h is [B@data, S@model, D]
        "seq": "model" if mode in ("train", "prefill") else None,
        "qkv_seq": None,
        "heads": "model",
        "head_dim": None,
        "enc_seq": None,
        "ssd_heads": "model",
        "state": None,
        "cap": None,
    }
    if strategy.startswith("fastdecode") and mode == "decode":
        rules["cache"] = "model"
        rules["kv_heads"] = None
        if strategy == "fastdecode_sm":
            rules["_explicit_decode_attn"] = True
        if zero3:
            # "weights stay, activations fly": fully 2D-shard the weights
            # (d_model over `data` x ff/heads over `model`) and let the
            # per-token activations be replicated/reduced over `data`
            for k in ("vocab", "heads_dim", "ff", "rnn", "inner"):
                rules[k] = "model"
            rules["embed"] = ("pod", "data")
            rules["batch"] = None
    else:
        rules["cache"] = None
        rules["kv_heads"] = "model"
    if strategy == "dp" and mode == "train":
        # pure data parallelism over ALL axes: moves (gathered) weights +
        # grads instead of activations
        rules["batch"] = ("pod", "data", "model")
        rules["seq"] = None
        rules["heads"] = None
        rules["ssd_heads"] = None
        rules["kv_heads"] = None
    return rules


def auto_zero3(cfg: ModelConfig, mesh, hbm_bytes: float = GPU_H100.mem_cap
               ) -> bool:
    """Fully distribute weight storage (beyond TP) when TP-only weights
    would crowd the device (> 25% of its memory — the rest is needed for
    KV / activations).  The default is the H100's 80 GB (the reference's
    is the v5e's 16 GB)."""
    model_par = axis_sizes(mesh).get("model", 1)
    bytes_tp = cfg.param_count() * 2 / model_par
    return bytes_tp > 0.25 * hbm_bytes


# ---------------------------------------------------------------------------
# public: shapes, shardings, DTensors
# ---------------------------------------------------------------------------
def param_shardings(cfg: ModelConfig, mesh, rules: Dict):
    return _tree_shardings(param_shapes(cfg), mesh, rules, _param_axes)


def state_shapes(cfg: ModelConfig, batch: int, cache_len: int):
    """``init_decode_state``'s tree of ``meta`` tensors."""
    return M.plain_decode_state(cfg, batch, cache_len, device="meta")


def state_shardings(cfg: ModelConfig, mesh, rules: Dict, batch: int,
                    cache_len: int):
    return _tree_shardings(state_shapes(cfg, batch, cache_len), mesh, rules,
                           _state_axes)


def data_sharding(mesh, rules: Dict, shape, axes) -> Sharding:
    return named_sharding(mesh, rules, shape, axes)


def replicated(mesh) -> Sharding:
    return sharding_of(mesh, P())


def local_part(x, sh: Sharding):
    """This rank's slice of the global tensor ``x`` under ``sh``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        x.shape, sh.mesh, sh.placements)
    for d, (o, n) in enumerate(zip(offset, shape)):
        if n != x.shape[d]:
            x = x.narrow(d, o, n)
    return x.contiguous()


def distribute_leaf(x, sh: Sharding):
    """A DTensor of the global tensor ``x`` laid out by ``sh``; each rank
    keeps its own slice (``x`` must hold the same values on every rank)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local_part(x, sh), sh.mesh, sh.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def distribute(tree, shardings):
    """``distribute_leaf`` over a tree and its tree of shardings."""
    return tree_map(distribute_leaf, tree, shardings)
