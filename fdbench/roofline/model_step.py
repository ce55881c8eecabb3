"""Model FLOPs of the dense decoder family's work in a window: 2 x the
matrix parameters a token passes through, plus attention at the token's
context (q.k and p.v: 4 x Hq x Dh per position attended).

A prompt of P tokens passes through every layer's matrices and attends
causally (position i over i + 1 positions); the head runs once, at its
last position (the port computes no other logits at admission).  A
decoded token passes the layers and the head and attends over its whole
context.  Padding the program adds is not counted.
"""
from __future__ import annotations

from typing import Dict


def layer_matrix_params(s: Dict) -> int:
    d, ff = s["d"], s["ff"]
    attn = d * s["hq"] * s["dh"] * 2 + d * s["hkv"] * s["dh"] * 2
    ffn = (3 if s["act"] == "silu" else 2) * d * ff
    return attn + ffn


def head_params(s: Dict) -> int:
    return s["d"] * s["vocab"]


def prefill_flops(s: Dict, prompt_len: int) -> float:
    p = prompt_len
    mats = 2.0 * layer_matrix_params(s) * s["layers"] * p
    attn = 4.0 * s["hq"] * s["dh"] * s["layers"] * p * (p + 1) / 2.0
    return mats + attn + 2.0 * head_params(s)


def decode_flops(s: Dict, context: int) -> float:
    """One decoded token attending over ``context`` positions."""
    mats = 2.0 * (layer_matrix_params(s) * s["layers"] + head_params(s))
    return mats + 4.0 * s["hq"] * s["dh"] * s["layers"] * context
