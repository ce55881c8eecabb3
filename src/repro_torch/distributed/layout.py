"""Leaf -> logical axes of the port's param and decode-state trees, and
the trees of layouts they give (the JAX package's
``distributed/sharding.py:121-209``).

Kept apart from ``distributed.sharding``, which builds the model's trees:
this module imports nothing of the model, so ``models.model`` can lay
its decode state out under ``use_rules`` (``allocate``) without
reaching up into the layer that builds on it.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.distributed.api import named_sharding
from repro_torch.training.tree import leaves_with_path


# ---------------------------------------------------------------------------
# leaf -> logical axes
# ---------------------------------------------------------------------------
def _param_axes(name: str, ndim: int, stacked: bool) -> Tuple:
    base: Tuple
    if name == "embed":
        base = ("vocab", "embed")
    elif name == "lm_head":
        base = ("embed", "vocab")
    elif name in ("wq", "wk", "wv", "x_wq", "x_wk", "x_wv"):
        base = ("embed", "heads_dim")
    elif name in ("wo", "x_wo"):
        base = ("heads_dim", "embed")
    elif name == "ffn_router":
        base = ("embed", "expert")
    elif name in ("ffn_w_gate", "ffn_w_up"):
        base = ("expert", "embed", "ff") if ndim - int(stacked) == 3 \
            else ("embed", "ff")
    elif name == "ffn_w_down":
        base = ("expert", "ff", "embed") if ndim - int(stacked) == 3 \
            else ("ff", "embed")
    elif name in ("ffn_w_in",):
        base = ("embed", "ff")
    elif name in ("ffn_w_out",):
        base = ("ff", "embed")
    elif name in ("w_in_rnn", "w_in_gate"):
        base = ("embed", "rnn")
    elif name in ("w_a", "w_x"):
        base = ("rnn", None)
    elif name in ("b_a", "b_x", "lam"):
        base = ("rnn",)
    elif name == "w_in":
        base = ("embed", "inner")
    elif name == "w_out":
        base = ("inner", "embed") if ndim - int(stacked) == 2 else ("rnn",)
    elif name == "conv":
        base = (None, "inner")
    else:  # norms, gates, A_log, Dskip, dt_bias, gate_norm, q/k_norm ...
        base = (None,) * (ndim - int(stacked))
    if stacked:
        base = ("layer",) + base
    if len(base) != ndim:
        base = tuple(list(base) + [None] * ndim)[:ndim]
    return base


def _state_axes(name: str, ndim: int, stacked: bool) -> Tuple:
    if name in ("k", "v"):
        base = ("kv_batch", "cache", "kv_heads", "head_dim")
    elif name in ("xk", "xv"):
        base = ("kv_batch", "enc_seq", "kv_heads", "head_dim")
    elif name == "pos":
        base = ("kv_batch", "cache")
    elif name == "h":
        base = ("kv_batch", "rnn") if ndim - int(stacked) == 2 \
            else ("kv_batch", "ssd_heads", None, None)
    elif name == "conv":
        base = ("kv_batch", None, "inner")
    elif name == "lengths":
        base = ("kv_batch",)
    else:
        base = (None,) * (ndim - int(stacked))
    if stacked:
        base = ("layer_state",) + base   # state layer dim: never sharded
    if len(base) != ndim:
        base = tuple(list(base) + [None] * ndim)[:ndim]
    return base


# ---------------------------------------------------------------------------
# trees of layouts
# ---------------------------------------------------------------------------
def leaf_name(path) -> Tuple[str, bool]:
    """(the leaf's name: its path's last string key that is not a digit,
    stacked: the path runs through a ``stack``) — the reference's rule
    over ``jax.tree_util``'s key paths."""
    name = ""
    for k in reversed(path):
        if isinstance(k, str) and not k.isdigit():
            name = k
            break
    return name, any(str(k) == "stack" for k in path)


def _tree_shardings(shapes_tree, mesh, rules: Dict, axes_fn):
    """A tree of ``Sharding``s, one per leaf of ``shapes_tree`` (a tree of
    tensors, ``meta`` ones for a layout alone), from ``axes_fn``'s logical
    axes of each leaf's name."""
    specs = {}
    for path, leaf in leaves_with_path(shapes_tree):
        name, stacked = leaf_name(path)
        axes = axes_fn(name, leaf.dim(), stacked)
        specs[path] = named_sharding(mesh, rules, tuple(leaf.shape), axes)
    return _rebuild(shapes_tree, specs)


def _rebuild(tree, by_path, path=()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, by_path, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", range(len(tree)))
        out = [_rebuild(v, by_path, path + (n,)) for n, v in zip(names, tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return by_path[path]


def allocate(shapes_tree, mesh, rules: Dict, axes_fn, device,
             fill: Callable[[str], int]):
    """DTensors shaped as the ``meta`` tree ``shapes_tree`` and laid out
    by ``_tree_shardings``; each rank allocates only its own block, on
    ``device`` (``meta`` allocates nothing), filled with ``fill(name)``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    out = {}
    for path, leaf in leaves_with_path(shapes_tree):
        name, stacked = leaf_name(path)
        sh = named_sharding(mesh, rules, tuple(leaf.shape),
                            axes_fn(name, leaf.dim(), stacked))
        shape, _ = compute_local_shape_and_global_offset(
            leaf.shape, mesh, sh.placements)
        local = torch.full(shape, fill(name), dtype=leaf.dtype,
                           device=device)
        out[path] = DTensor.from_local(local, mesh, sh.placements,
                                       run_check=False, shape=leaf.shape,
                                       stride=leaf.stride())
    return _rebuild(shapes_tree, out)
