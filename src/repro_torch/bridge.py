"""Carries weights and decode state between the JAX package and the port.

The JAX side hands over its pytrees passed through ``np.asarray``.  A
bf16 leaf crosses as its exact ``uint16`` bit pattern: numpy has no
bfloat16 of its own (``np.asarray`` of a JAX bf16 array is an
``ml_dtypes.bfloat16``, which torch cannot take), so the caller views
such arrays as ``uint16`` on the JAX side and the port views them back
as ``torch.bfloat16`` here — the round trip is bit-exact.  Everything
else crosses with its own dtype.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.model import FP32_LEAVES
from repro_torch.training.optimizer import AdamWState


def tensor_from_numpy(x: np.ndarray, device, dtype=None) -> torch.Tensor:
    """One leaf: uint16 is taken as bf16 bits, anything else as is."""
    x = np.array(x, order="C")      # an owned, writable copy
    if x.dtype == np.uint16:
        t = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(x)
    t = t.to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One leaf back: bf16 leaves come out as their uint16 bit pattern."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _map(tree: Any, fn, name: str = ""):
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, name) for v in tree)
    return fn(tree, name)


def _keeps_fp32(name: str) -> bool:
    """Norm scales and ``model.FP32_LEAVES`` (the RG-LRU's and the SSD's
    gate and decay constants) stay float32 as in the JAX package."""
    return (name.startswith("ln") or name.endswith("norm")
            or name in FP32_LEAVES)


def params_from_numpy(np_params, cfg, device, dtype=None):
    """The JAX ``init_params`` pytree (numpy leaves) as the port's params
    dict, same layout.  ``dtype`` (optional) casts the weight matrices;
    norm scales and the recurrent mixers' fp32 constants stay float32 as
    in the JAX package.  ``cfg`` is accepted
    for symmetry with the reference's signatures and checks nothing
    beyond the embedding width."""
    out = _map(np_params, lambda x, name: tensor_from_numpy(
        x, device, None if _keeps_fp32(name) else dtype))
    if out["embed"].shape[-1] != cfg.d_model:
        raise ValueError(f"embed width {out['embed'].shape[-1]} != "
                         f"d_model {cfg.d_model}")
    return out


def params_to_numpy(params):
    return _map(params, lambda t, name: tensor_to_numpy(t))


def state_from_numpy(np_state, device):
    """The JAX ``init_decode_state``/``prefill`` state (numpy leaves) as
    the port's decode state."""
    return _map(np_state, lambda x, name: tensor_from_numpy(x, device))


def state_to_numpy(state):
    return _map(state, lambda t, name: tensor_to_numpy(t))


def opt_state_from_numpy(np_state, device):
    """The JAX ``AdamWState(step, mu, nu)`` (numpy leaves: the int32 step,
    fp32 moment trees) as the port's ``AdamWState``."""
    step, mu, nu = np_state
    return AdamWState(
        torch.as_tensor(np.asarray(step), dtype=torch.int32).to(device),
        _map(mu, lambda x, name: tensor_from_numpy(x, device)),
        _map(nu, lambda x, name: tensor_from_numpy(x, device)))


def opt_state_to_numpy(state):
    """(step, mu, nu) as numpy: the fields of the JAX ``AdamWState``."""
    return (np.asarray(state.step.item(), dtype=np.int32),
            _map(state.mu, lambda t, name: tensor_to_numpy(t)),
            _map(state.nu, lambda t, name: tensor_to_numpy(t)))
