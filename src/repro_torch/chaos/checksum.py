"""Checksummed KV transport for the port (the ``tree_digest`` /
``payload_checksum`` part of repro.chaos.checksum): blake2b digests over
array payloads.

A host-tier entry stamps a digest of its payload when it is stored and
verifies it when it streams back, so payload corruption is detected (the
row re-prefills) instead of decoding garbage.  The digest covers dtype +
shape + raw bytes of every leaf, dict keys visited in sorted order.
Leaves are numpy arrays (hashed exactly as the JAX package hashes them)
or torch tensors (on the host; bf16 has no numpy dtype, so a tensor is
hashed by its torch dtype name and its raw bytes).
"""
from __future__ import annotations

import hashlib
from typing import Any

import numpy as np
import torch

DIGEST_SIZE = 16


class ChecksumError(RuntimeError):
    """A checksummed payload failed verification (bit corruption)."""


def tree_digest(tree: Any) -> bytes:
    """Digest a nested dict/list/array payload deterministically."""
    h = hashlib.blake2b(digest_size=DIGEST_SIZE)
    _walk(tree, h)
    return h.digest()


def payload_checksum(payload: Any) -> bytes:
    """Alias used by tier entries (reads as 'checksum of the payload')."""
    return tree_digest(payload)


def _walk(node: Any, h: "hashlib._Hash") -> None:
    if isinstance(node, dict):
        for k in sorted(node, key=repr):
            h.update(repr(k).encode())
            _walk(node[k], h)
    elif isinstance(node, (list, tuple)):
        h.update(b"[%d]" % len(node))
        for v in node:
            _walk(v, h)
    elif node is None:
        h.update(b"~")
    elif isinstance(node, torch.Tensor):
        t = node.detach().to("cpu").contiguous()
        h.update(str(t.dtype).encode())
        h.update(repr(tuple(t.shape)).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    else:
        a = np.asarray(node)
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
