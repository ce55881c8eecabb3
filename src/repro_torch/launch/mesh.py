"""Mesh construction (the JAX package's ``launch/mesh.py``) over an
initialised ``torch.distributed`` world, and the world itself.

Functions, not module-level constants: importing this module touches no
process group.  A mesh over NCCL lives on the card (``cuda``), over gloo
or the fake backend of the dry-run on the CPU.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production shapes: 16x16 = 256 ranks ('data' x
    'model'); multi-pod adds a leading 'pod' axis (2 x 16 x 16 = 512).
    The world must have exactly that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs a world of "
                         f"{math.prod(shape)} ranks, not "
                         f"{dist.get_world_size()}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(model_par: int = 1):
    """A ('data', 'model') mesh over the running world, ``model_par`` ranks
    on the 'model' axis."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if n % model_par:
        raise ValueError(f"a model axis of {model_par} does not divide the "
                         f"world size {n}")
    return init_device_mesh(_device_type(), (n // model_par, model_par),
                            mesh_dim_names=("data", "model"))


def launched_world() -> int:
    """The world size ``torchrun`` gave this process (1 without it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_world(device: torch.device) -> bool:
    """Initialise the default process group unless one is up: under
    ``torchrun`` from its environment, else a world of 1 on an in-memory
    store (no port).  NCCL on the card, gloo on the CPU; each rank on its
    own card (``LOCAL_RANK``).  Returns whether this call made the world
    (the caller then destroys it)."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {}
    if device.type == "cuda":
        kw["device_id"] = device
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    return True
