"""The arithmetic the metric files (``metrics/<name>.py``) share.  Each
takes the run's ``RunData`` and returns a number, or None where the run
holds nothing to read (and the metric is left out of the line)."""
from __future__ import annotations

from typing import Optional

from fdbench.roofline import model_step, paged_attn


def decode_tok_s(run) -> Optional[float]:
    """Tokens emitted in the window over the window's seconds (prefill
    steps, and the first tokens they emit, included)."""
    return run.tokens / run.window_s if run.window_s > 0 else None


def setup_s(run) -> Optional[float]:
    """Process start to window start."""
    return run.setup_s


def prefill_share_pct(run) -> Optional[float]:
    """The steps' ``prefill_wall`` (admission and monolithic prefill)
    summed over the window, as a share of the window."""
    if run.window_s <= 0:
        return None
    return 100.0 * sum(r.prefill_wall for r in run.records) / run.window_s


def hotpath_host_ms(run) -> Optional[float]:
    """The pipeline's host seconds (S-dispatch, dispatch, collect) of the
    window per decode step, in ms."""
    h = run.hotpath
    steps = h.get("steps_count", h.get("steps", 0.0))
    if steps <= 0:
        return None
    host = h.get("s_dispatch_s", 0.0) + h.get("dispatch_s", 0.0) \
        + h.get("collect_s", 0.0)
    return 1e3 * host / steps


def step_mfu_pct(run) -> Optional[float]:
    """Model FLOPs of the window's prefills and decoded tokens over the
    window's seconds and the card's bf16 peak."""
    if run.peaks is None or run.window_s <= 0:
        return None
    s = run.sizes
    flops = sum(model_step.prefill_flops(s, p) for p in run.prefills) \
        + sum(model_step.decode_flops(s, c) for c in run.decodes)
    return 100.0 * flops / (run.window_s * run.peaks["bf16_flops_per_s"])


ATTN_KERNELS = ("paged_attn_kernel", "merge_splits")


def attn_roofline(run) -> Optional[float]:
    """Kernel 1's least time by its roofline over the profiled slice's
    launches, over the device time of its kernels in that slice."""
    sl = run.slice
    if sl is None or run.peaks is None:
        return None
    dev = sum(s for name, s in sl["kernels"].items()
              if any(k in name for k in ATTN_KERNELS))
    if dev <= 0:
        return None
    pf, pb = run.peaks["bf16_flops_per_s"], run.peaks["hbm_bytes_per_s"]
    least = sum(paged_attn.least_seconds(f, b, pf, pb)
                for f, b in sl["launches"])
    return 100.0 * least / dev


def device_idle_pct(run) -> Optional[float]:
    """1 - the union of device intervals over the profiled slice's wall."""
    sl = run.slice
    if sl is None or sl["wall_s"] <= 0 or sl["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["wall_s"])
