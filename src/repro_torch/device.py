"""Device and dtype resolution shared by the port's entry points.

Entry points default to ``"cuda"`` and raise when CUDA is not available,
unless the caller asked for ``"cpu"`` — the port never carries on
silently on the CPU.
"""
from __future__ import annotations

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; ``"cuda"`` without an index names the
    current card (an R-worker thread calls ``torch.cuda.set_device`` with
    it, which wants an index)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}")
    return _DTYPES[name]
