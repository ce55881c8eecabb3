"""Checkpoints of the port's trees in the JAX package's npz layout
(``training/checkpoint.py``): one member per leaf, keyed by its tree
path joined with "/" (``embed``, ``stack/s0/wq``, ``rem/0/ln1``,
``encoder/stack/s0/...``), in the reference's flatten order.

A bf16 leaf is written as the reference's writer writes it: numpy has no
bfloat16, so ``np.asarray`` of a JAX bf16 array is an ``ml_dtypes``
array, stored with the descr ``<V2`` over the bf16 bits.  The port
writes the same header over the same bits (a uint16 view; no
``ml_dtypes``) and the other leaves through numpy's own writer, into a
zip laid out as ``np.savez`` lays it out, so one tree saved by either
package gives the same member bytes.  ``load`` reads such members back
as bf16 bit for bit (the reference's ``load`` cannot: numpy has no cast
from ``|V2``), checks every shape against the template and casts to
the template leaf's dtype and device.
"""
from __future__ import annotations

import os
import zipfile
from typing import Any

import numpy as np
import torch
from numpy.lib import format as npy_format

from repro_torch.training.tree import leaves_with_path, tree_map

# the npy descr of ml_dtypes' bfloat16, which the reference's files carry
_BF16_DESCR = "<V2"


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _write_leaf(f, t: torch.Tensor) -> None:
    t = t.detach().cpu().contiguous()
    if t.dtype != torch.bfloat16:
        npy_format.write_array(f, t.numpy(), allow_pickle=False)
        return
    bits = t.view(torch.int16).numpy()
    header = npy_format.header_data_from_array_1_0(bits)
    header["descr"] = _BF16_DESCR
    npy_format.write_array_header_1_0(f, header)
    f.write(bits.tobytes("C"))


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")          # an owned, writable copy
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:      # bf16 bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save(path: str, tree: Any) -> None:
    """One npz member per leaf (``.npz`` appended to ``path`` if it lacks
    it, as ``np.savez`` does)."""
    path = os.fspath(path)
    if not path.endswith(".npz"):
        path += ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for p, leaf in leaves_with_path(tree):
            # as np.savez: one stored member per array, zip64 forced
            with zf.open(_path_str(p) + ".npy", "w", force_zip64=True) as f:
                _write_leaf(f, leaf)


def load(path: str, like: Any) -> Any:
    """A tree of ``like``'s structure from the file at ``path``: KeyError
    for a leaf the file lacks, ValueError for a shape that differs."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        arrays = {}
        for p, leaf in leaves_with_path(like):
            key = _path_str(p)
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch at {key}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            arrays[id(leaf)] = _from_numpy(arr)
    return tree_map(lambda leaf: arrays[id(leaf)].to(device=leaf.device,
                                                     dtype=leaf.dtype),
                    like)
