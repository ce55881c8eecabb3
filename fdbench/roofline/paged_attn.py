"""Kernel 1 (``repro_torch.kernels.paged_attention.paged_decode_attention``:
``paged_attn_kernel`` and its ``merge_splits``): the operations and bytes
one launch needs.

A launch serves the rows one R-worker holds of one micro-batch at one
layer.  Each row has one query token attending over ``valid`` positions
of the page pool (its K/V written so far, this step's included).  Bytes
count each input once and each output once: the K/V of the valid
positions in bf16, the block-table entries of their pages (int32), the
query and the output (bf16, every row of the launch, empty rows too).
Operations: q.k and p.v, 2 x Dh multiply-adds each, per query head and
position.  The partials the splits exchange are not counted: they are
the kernel's own traffic, not what the call needs.
"""
from __future__ import annotations

from typing import Sequence, Tuple

KV_ELEM_BYTES = 2          # bf16 pool
Q_ELEM_BYTES = 2
TABLE_ENTRY_BYTES = 4
PAGE = 16


def launch(hq: int, hkv: int, dh: int, valid: Sequence[int],
           rows: int) -> Tuple[float, float]:
    """(flops, bytes) of one launch over ``rows`` rows, of which the
    non-empty ones attend over ``valid`` positions each."""
    pos = float(sum(valid))
    kv = pos * 2 * hkv * dh * KV_ELEM_BYTES
    table = sum(-(-v // PAGE) for v in valid) * TABLE_ENTRY_BYTES
    qo = 2.0 * rows * hq * dh * Q_ELEM_BYTES
    return 4.0 * hq * dh * pos, kv + table + qo


def least_seconds(flops: float, nbytes: float, peak_flops: float,
                  peak_bytes_per_s: float) -> float:
    """The roofline's least time: the larger of operations over the peak
    rate and bytes over the peak bandwidth."""
    return max(flops / peak_flops, nbytes / peak_bytes_per_s)
