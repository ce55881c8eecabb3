"""Dispatch for the R-Part attention kernels (counterpart of
``repro/kernels/ops.py``).

``use_kernel="auto"`` is the only mode: the wrapper launches the Hopper
kernel for a CUDA tensor and runs the plain version for a CPU tensor.
The JAX package's other ops (dense and int8 flash-decode, the verify
passes) are not ported yet; see ROADMAP.md.
"""
from __future__ import annotations

from repro_torch.kernels import paged_attention as _pa


def paged_decode_attention(q, pages_k, pages_v, tables, lengths, *,
                           window: int = 0, sink: int = 0,
                           softcap: float = 0.0, use_kernel: str = "auto"):
    """Block-table decode attention.  q [B,Hq,Dh]; pages_k/v
    [P,page,Hkv,Dh]; tables [B,MP] int32; lengths [B] -> [B,Hq,Dh]."""
    if use_kernel != "auto":
        raise ValueError(f"use_kernel must be 'auto', got {use_kernel!r}")
    return _pa.paged_decode_attention(q, pages_k, pages_v, tables, lengths,
                                      window=window, sink=sink,
                                      softcap=softcap)
