"""FastDecode's quantitative hardware-orchestration model (§4.3, eq. 7–11),
plus the TPU re-derivation used by the roofline analysis.

Given a model and hardware, pick the two key parameters:
    𝓑  — batch size (from the S-Part latency curve 𝕋(𝓑) and the SLO, eq. 7–8)
    𝓟  — number of R-workers (eq. 10–11: R-Part latency ≈ S-Part latency)

𝕋(𝓑) and R can come from (a) the analytic roofline (compute vs weight-
bandwidth bound) or (b) a measured micro-benchmark.

The port's copy of repro.core.perfmodel: the same functions and catalog,
plus ``GPU_H100``, the card the port serves on.  Every number it returns
is a prediction from a spec sheet, never a measurement.  On that card
the port's R-workers are threads beside the S-worker: both sides share
the card's 80 GB and its 3.35 TB/s, which eq. 9–11 (a separate R-side
memory and bandwidth per worker) do not model.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.config import DEC_XATTN, ModelConfig


# ---------------------------------------------------------------------------
# hardware catalog (paper Table 1 + our TPU target)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Hardware:
    name: str
    flops: float          # peak FLOP/s (usable precision)
    mem_bw: float         # HBM/DRAM bandwidth, bytes/s
    mem_cap: float        # bytes
    link_bw: float        # interconnect bytes/s (per direction)
    tdp_w: float = 0.0


CPU_XEON = Hardware("xeon-5218", 1.3e12, 128e9, 256e9, 12.5e9, 125)   # paper
CPU_EPYC = Hardware("epyc-7452", 1.2e12, 205e9, 256e9, 12.5e9, 155)   # paper
GPU_A10 = Hardware("a10", 125e12, 600e9, 24e9, 32e9, 150)             # paper
GPU_V100 = Hardware("v100", 112e12, 900e9, 32e9, 32e9, 250)           # paper
TPU_V5E = Hardware("tpu-v5e", 197e12, 819e9, 16e9, 50e9, 200)         # target
# NVIDIA H100 Tensor Core GPU datasheet, H100 SXM column: 989 TFLOP/s
# bf16 dense (no sparsity), 80 GB of HBM3 at 3.35 TB/s, up to 700 W.
# link_bw: the port's R-workers are threads on the same card, so the only
# off-card link is PCIe Gen5 x16 to the host tier, 128 GB/s both ways as
# the datasheet gives it, 64 GB/s per direction
GPU_H100 = Hardware("h100-sxm5-80gb", 989e12, 3.35e12, 80e9, 64e9, 700)

HW = {h.name: h for h in (CPU_XEON, CPU_EPYC, GPU_A10, GPU_V100, TPU_V5E,
                          GPU_H100)}


# ---------------------------------------------------------------------------
# per-block workload terms
# ---------------------------------------------------------------------------
def s_part_params_per_block(cfg: ModelConfig) -> float:
    """Weight elements touched per token in one block's S-Part
    (MoE counts activated experts only)."""
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = d * hq * hd + 2 * d * hkv * hd + hq * hd * d     # qkvo
    if cfg.ffn_kind == "swiglu":
        p += 3 * d * f
    elif cfg.ffn_kind == "mlp":
        p += 2 * d * f
    elif cfg.ffn_kind == "moe":
        p += cfg.top_k * 3 * d * f + d * cfg.num_experts
    return float(p)


def s_part_flops_per_token(cfg: ModelConfig) -> float:
    return 2.0 * s_part_params_per_block(cfg)


def r_part_bytes_per_cached_token(cfg: ModelConfig, bytes_per_el: int = 2,
                                  page: int = 0,
                                  table_entry_bytes: int = 4) -> float:
    """Bytes the R-Part must stream per cached token per new token, one
    block (read K + read V).

    ``page > 0`` adds the paged-KV block-table overhead: one table entry
    read per page, amortized over the page's tokens.  It is tiny by
    design (4/page bytes vs hundreds of KV bytes) — the cost of paging is
    capacity rounding, not bandwidth, which is why the R-workers can
    afford it."""
    kv = 2.0 * cfg.num_kv_heads * cfg.head_dim * bytes_per_el
    if page > 0:
        kv += table_entry_bytes / page
    return kv


def paged_round_up_factor(seq_len: int, page: int) -> float:
    """Allocated/used capacity ratio of a ``seq_len``-token sequence under
    page-granular allocation — the internal-fragmentation term of the
    capacity model (eq. 9's C shrinks by this factor, worst case
    ``(seq+page-1)/seq``, vs the dense slab's ``cache_len/seq``)."""
    if seq_len <= 0:
        return 1.0
    return (-(-seq_len // page) * page) / float(seq_len)


def r_part_flops_per_cached_token(cfg: ModelConfig) -> float:
    """FLOPs of eq. 2–3 per cached token per new token per block."""
    return 2.0 * cfg.num_heads * cfg.head_dim * 2.0      # q·k and a·v


def prefix_dedup_factor(seq_len: int, prefix_len: int,
                        hit_rate: float) -> float:
    """Residency multiplier under shared-prefix KV reuse: the fraction
    of a request's resident tokens that are UNIQUE when ``hit_rate`` of
    admissions share a ``prefix_len``-token prefix with a resident copy
    (ref-counted pages store the shared prefix once, so eq. 9's C·𝓟
    capacity — and Algorithm 1's W_lim peak — only charge the unique
    remainder).  1.0 when nothing is shared; approaches
    ``1 - prefix_len/seq_len`` as every admission hits."""
    if seq_len <= 0 or prefix_len <= 0 or hit_rate <= 0:
        return 1.0
    shared_frac = min(prefix_len, seq_len) / float(seq_len)
    return max(1e-6, 1.0 - min(1.0, hit_rate) * shared_frac)


# ---------------------------------------------------------------------------
# KV lifecycle tiering: swap-vs-recompute (the DéjàVu-style tradeoff the
# admission path consults — restoring parked KV from a host tier costs
# LINEAR stream time, re-prefilling costs linear S-Part time PLUS the
# quadratic attention term, so past a break-even prefix length the tier
# always wins)
# ---------------------------------------------------------------------------
def kv_restore_time(cfg: ModelConfig, tokens: int, tier_gbps: float,
                    bytes_per_el: int = 2, page: int = 0) -> float:
    """Seconds to stream ``tokens`` of parked KV (all layers, K+V) back
    from a host tier at ``tier_gbps`` GB/s; ``page > 0`` rounds the
    byte count up to whole pages (the tier stores page granules)."""
    if tier_gbps <= 0:
        return math.inf
    if tokens <= 0:
        return 0.0
    n = tokens if page <= 0 else -(-tokens // page) * page
    return kv_cache_bytes(cfg, 1, n, bytes_per_el) / (tier_gbps * 1e9)


def kv_recompute_time(cfg: ModelConfig, hw_s: Hardware, tokens: int,
                      bytes_per_el: int = 2) -> float:
    """Seconds to re-prefill ``tokens`` from scratch on the S-worker:
    the linear S-Part roofline (t_of_b at batch ``tokens`` — prefill is
    a wide batch of one-token columns) plus the quadratic causal-
    attention FLOPs (~n²/2 cached-token visits per layer)."""
    if tokens <= 0:
        return 0.0
    lin = 2.0 * cfg.num_layers * t_of_b(cfg, hw_s, int(tokens),
                                        bytes_per_el)
    attn = (cfg.num_layers * r_part_flops_per_cached_token(cfg)
            * float(tokens) * tokens / 2.0) / hw_s.flops
    return lin + attn


def kv_restore_break_even(cfg: ModelConfig, hw_s: Hardware,
                          tier_gbps: float, bytes_per_el: int = 2,
                          page: int = 0,
                          max_tokens: int = 1 << 20) -> float:
    """Smallest prefix length at which restoring from the tier is no
    slower than recomputing it — ``inf`` when the tier cannot win below
    ``max_tokens`` (e.g. zero bandwidth).  Monotone: restore is linear
    in length while recompute grows quadratically, so once the tier
    wins it keeps winning for every longer prefix."""
    if tier_gbps <= 0:
        return math.inf
    lo, hi = 1, 1
    while kv_restore_time(cfg, hi, tier_gbps, bytes_per_el, page) \
            > kv_recompute_time(cfg, hw_s, hi, bytes_per_el):
        lo, hi = hi, hi * 2
        if hi > max_tokens:
            return math.inf
    while lo < hi:
        mid = (lo + hi) // 2
        if kv_restore_time(cfg, mid, tier_gbps, bytes_per_el, page) \
                <= kv_recompute_time(cfg, hw_s, mid, bytes_per_el):
            hi = mid
        else:
            lo = mid + 1
    return float(hi)


# ---------------------------------------------------------------------------
# 𝕋(𝓑), R, 𝔼(𝓑)  (analytic roofline forms)
# ---------------------------------------------------------------------------
def t_of_b(cfg: ModelConfig, hw: Hardware, b: int,
           bytes_per_el: int = 2) -> float:
    """Latency of one block's S-Part at batch b: max(compute, weight-BW)."""
    comp = b * s_part_flops_per_token(cfg) / hw.flops
    mem = s_part_params_per_block(cfg) * bytes_per_el / hw.mem_bw
    return max(comp, mem)


def r_per_token(cfg: ModelConfig, hw: Hardware, bytes_per_el: int = 2,
                page: int = 0) -> float:
    """R: one worker's latency to process ONE cached token of ONE new
    token's R-Part, one block (bandwidth-bound).  ``page`` adds the paged
    block-table read overhead (see r_part_bytes_per_cached_token)."""
    bw = r_part_bytes_per_cached_token(cfg, bytes_per_el, page) / hw.mem_bw
    fl = r_part_flops_per_cached_token(cfg) / hw.flops
    return max(bw, fl)


def e_of_b(cfg: ModelConfig, hw: Hardware, b: int) -> float:
    """eq. (8): 𝔼(𝓑) = 𝓑 / 𝕋(𝓑) — proportional to S-Part throughput."""
    return b / t_of_b(cfg, hw, b)


# ---------------------------------------------------------------------------
# the orchestration decisions
# ---------------------------------------------------------------------------
def max_batch_for_slo(cfg: ModelConfig, hw: Hardware, seq_len: int,
                      latency_slo: float, b_max: int = 1 << 20) -> int:
    """eq. (7): largest 𝓑 with 2·N·S·𝕋(𝓑) <= L  (pipeline-perfect)."""
    n = cfg.num_layers
    lo, hi = 1, b_max
    if 2 * n * seq_len * t_of_b(cfg, hw, 1) > latency_slo:
        return 0
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if 2 * n * seq_len * t_of_b(cfg, hw, mid) <= latency_slo:
            lo = mid
        else:
            hi = mid - 1
    return lo


def knee_batch(cfg: ModelConfig, hw: Hardware, rel_gain: float = 0.05,
               b_max: int = 1 << 20) -> int:
    """eq. (8) guidance: smallest 𝓑 where doubling it improves 𝔼(𝓑) by
    less than ``rel_gain``."""
    b = 1
    while b < b_max:
        if e_of_b(cfg, hw, 2 * b) / e_of_b(cfg, hw, b) < 1.0 + rel_gain:
            return b
        b *= 2
    return b_max


def min_workers_memory(cfg: ModelConfig, b: int, seq_len: int,
                       worker_mem: float, bytes_per_el: int = 2,
                       page: int = 0, dedup: float = 1.0) -> int:
    """eq. (9): ½·𝓑·S <= C·𝓟 with C tokens per worker memory.

    The ½·𝓑·S demand is the PAPER's model: R-side memory holds exactly
    the live tokens (average resident length S/2 under SLS, eq. 6).
    ``page > 0`` adds the only overhead paged storage pays on top of
    that ideal — the round-up to page granularity at the average length
    — so paged demand is always >= the eq. 9 ideal (equal when S/2 is
    page-aligned).  Note this ideal is what paging makes *achievable*:
    a dense per-row slab implementation actually pins 𝓑·cache_len,
    which eq. 9 does not model (see benchmarks/bench_paged.py for the
    measured gap)."""
    kv_per_tok = (2.0 * cfg.num_kv_heads * cfg.head_dim * bytes_per_el
                  * cfg.num_layers)
    c = worker_mem / kv_per_tok
    demand = 0.5 * b * seq_len * max(1e-6, min(1.0, dedup))
    if page > 0:
        demand *= paged_round_up_factor(max(1, seq_len // 2), page)
    return max(1, math.ceil(demand / c))


def optimal_workers(cfg: ModelConfig, hw_s: Hardware, hw_r: Hardware,
                    b: int, seq_len: int, bytes_per_el: int = 2,
                    t_measured: Optional[Callable[[int], float]] = None,
                    r_measured: Optional[float] = None,
                    page: int = 0) -> float:
    """eq. (10)/(11): 𝓟 ≈ 𝓑·S·R / (2·𝕋(𝓑)) = ½·S·R·𝔼(𝓑).

    Average resident length under SLS is S/2 (eq. 6), hence the ½.
    Pass measured 𝕋/R to override the analytic roofline forms; ``page``
    adds the paged block-table read to the analytic R."""
    t_b = t_measured(b) if t_measured else t_of_b(cfg, hw_s, b, bytes_per_el)
    r = r_measured if r_measured is not None else r_per_token(
        cfg, hw_r, bytes_per_el, page)
    return (b * seq_len * r) / (2.0 * t_b)


def plan(cfg: ModelConfig, hw_s: Hardware, hw_r: Hardware, seq_len: int,
         latency_slo: Optional[float] = None, worker_mem: float = 256e9,
         page: int = 0, prefix_hit_rate: float = 0.0,
         prefix_len: int = 0, tier_gbps: float = 0.0,
         spec_alpha: float = 0.0,
         spec_draft_frac: float = 0.15) -> Dict[str, float]:
    """Full §4.3 planning pass -> {batch, workers, workers_mem_min, ...}.

    ``page > 0`` plans for paged R-worker KV: R gains the amortized
    block-table read, and the eq. 9 memory bound is evaluated at the
    page-rounded average resident length (the paper's live-token ideal
    plus paging's rounding overhead — see min_workers_memory).

    ``prefix_hit_rate``/``prefix_len`` describe an expected shared-
    prefix workload (the fraction of admissions that reuse a resident
    ``prefix_len``-token prefix).  Deduplicated residency shrinks the
    eq. 9 memory demand by :func:`prefix_dedup_factor` and is exposed
    as ``w_lim_scale`` — the factor by which Algorithm 1's peak bound
    can be relaxed (shared tokens are resident once, not per row), so
    the load controller admits proportionally larger batches.

    ``tier_gbps > 0`` plans for KV lifecycle tiering: the plan gains
    the swap-vs-recompute terms (``kv_restore_s`` / ``kv_recompute_s``
    at the expected prefix length, and ``kv_restore_break_even`` — the
    shortest prefix worth restoring instead of re-prefilling) that the
    serving engine's restore gating and the LoadController's
    prefix-hit shift consult.

    ``spec_alpha > 0`` plans for speculative decoding at that expected
    per-token acceptance rate: the plan gains ``spec_k`` (the draft
    length maximizing :func:`spec_speedup` with a drafter costing
    ``spec_draft_frac`` of a target step), ``spec_accepted_per_step``
    and ``spec_speedup`` — ``ServingEngine.from_plan(spec_k="plan")``
    consumes ``spec_k``.
    """
    if latency_slo is not None:
        b = max_batch_for_slo(cfg, hw_s, seq_len, latency_slo)
    else:
        b = knee_batch(cfg, hw_s)
    dedup = prefix_dedup_factor(seq_len, prefix_len, prefix_hit_rate)
    p = optimal_workers(cfg, hw_s, hw_r, b, seq_len, page=page)
    p_mem = min_workers_memory(cfg, b, seq_len, worker_mem, page=page,
                               dedup=dedup)
    out = {
        "batch": b,
        "workers": max(1.0, math.ceil(p)),
        "workers_mem_min": p_mem,
        "t_of_b": t_of_b(cfg, hw_s, b),
        "r": r_per_token(cfg, hw_r),
        "e_of_b": e_of_b(cfg, hw_s, b),
        "tokens_per_s": b / (2 * cfg.num_layers * t_of_b(cfg, hw_s, b)),
    }
    workers = int(out["workers"])
    out["prefill_bubble_s"] = decode_bubble_per_block(
        cfg, hw_s, hw_r, b, workers, seq_len, page=page)
    out["prefill_chunk"] = optimal_prefill_chunk(
        cfg, hw_s, hw_r, b, workers, seq_len, page=page)
    out["prefix_dedup"] = dedup
    out["w_lim_scale"] = 1.0 / dedup
    if page > 0:
        out["r_paged"] = r_per_token(cfg, hw_r, page=page)
        out["paged_round_up"] = paged_round_up_factor(max(1, seq_len // 2),
                                                      page)
    if tier_gbps > 0:
        n = prefix_len if prefix_len > 0 else max(1, seq_len // 2)
        out["kv_restore_s"] = kv_restore_time(cfg, n, tier_gbps,
                                              page=page)
        out["kv_recompute_s"] = kv_recompute_time(cfg, hw_s, n)
        out["kv_restore_break_even"] = kv_restore_break_even(
            cfg, hw_s, tier_gbps, page=page)
    if spec_alpha > 0:
        sk = optimal_spec_k(spec_alpha, spec_draft_frac)
        out["spec_k"] = float(sk)
        out["spec_accepted_per_step"] = spec_accepted_per_step(
            spec_alpha, sk)
        out["spec_speedup"] = spec_speedup(spec_alpha, sk,
                                           spec_draft_frac)
    return out


# ---------------------------------------------------------------------------
# speculative decoding (draft k tokens on the S-resident drafter, verify
# them in ONE multi-token pipeline step): the R-Part streams each cached
# token ONCE per verify step instead of once per generated token, so the
# bandwidth-bound R side amortizes by the expected accepted length
# ---------------------------------------------------------------------------
def spec_accepted_per_step(alpha: float, k: int) -> float:
    """Expected committed tokens per verify step with per-token draft
    acceptance rate ``alpha`` and ``k`` drafted tokens: the truncated
    geometric mean (1 - alpha^(k+1)) / (1 - alpha) — between 1 (every
    draft rejected still commits the corrected token) and k+1 (all
    drafts accepted plus the bonus token)."""
    k = max(0, int(k))
    a = min(max(float(alpha), 0.0), 1.0)
    if k == 0:
        return 1.0
    if a >= 1.0:
        return float(k + 1)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


def spec_speedup(alpha: float, k: int, draft_frac: float = 0.15) -> float:
    """Tokens-per-wall-time ratio of speculative over vanilla decode:
    A(alpha, k) committed tokens per step, paid for with k drafter
    steps at ``draft_frac`` of a target step each plus the one verify
    step (whose S/R cost is roughly a vanilla step's — the verify
    attention sweeps the same KV once, batched over k+1 positions)."""
    return spec_accepted_per_step(alpha, k) / (1.0 + max(0, int(k))
                                               * max(0.0, draft_frac))


def optimal_spec_k(alpha: float, draft_frac: float = 0.15,
                   k_max: int = 8) -> int:
    """The draft length maximizing :func:`spec_speedup` — short when
    acceptance is poor or the drafter expensive, capped at ``k_max``
    (deep drafts hit diminishing geometric returns and grow the
    rejected-KV rollback)."""
    best_k, best = 1, -1.0
    for k in range(1, max(1, int(k_max)) + 1):
        s = spec_speedup(alpha, k, draft_frac)
        if s > best:
            best_k, best = k, s
    return best_k


# ---------------------------------------------------------------------------
# chunked-prefill overlap (temporal scheduling, §4.2 extended): prompt
# chunks execute on the S-worker inside the decode pipeline's bubbles —
# the idle S time per block transition while R-workers chew attention.
# The chunk size trades prefill latency (big chunks finish prompts in
# fewer steps) against decode interference (a chunk bigger than the
# bubble delays every resident sequence's next token).
# ---------------------------------------------------------------------------
def prefill_chunk_latency(cfg: ModelConfig, hw_s: Hardware, c: int,
                          bytes_per_el: int = 2) -> float:
    """S-side latency of a c-token prompt chunk through ONE block — the
    same roofline as t_of_b at batch c (prefill is just a wide batch of
    one-token columns to the S-Part)."""
    return t_of_b(cfg, hw_s, max(1, c), bytes_per_el)


def decode_bubble_per_block(cfg: ModelConfig, hw_s: Hardware,
                            hw_r: Hardware, b: int, workers: int,
                            seq_len: int, bytes_per_el: int = 2,
                            page: int = 0) -> float:
    """Idle S-worker time per block transition: the R-Part of a block
    (average resident length S/2 under SLS, split across the workers)
    minus the S-Part it overlaps with.  Zero when the pipeline is
    S-bound (eq. 11 balances them; fewer workers -> bigger bubble)."""
    r_lat = (b * seq_len / 2.0) * r_per_token(cfg, hw_r, bytes_per_el,
                                              page) / max(1, workers)
    return max(0.0, r_lat - t_of_b(cfg, hw_s, b, bytes_per_el))


def optimal_prefill_chunk(cfg: ModelConfig, hw_s: Hardware, hw_r: Hardware,
                          b: int, workers: int, seq_len: int,
                          bytes_per_el: int = 2, page: int = 0,
                          c_min: int = 8, c_max: int = 1024) -> int:
    """Largest power-of-two chunk whose per-block S cost still fits the
    decode bubble — such a chunk rides the pipeline for free (its FLOPs
    fill time the S-worker would have spent idle).  When the pipeline
    is S-bound (no bubble) the chunk floor ``c_min`` keeps prefill
    progressing with minimal per-step interference."""
    bubble = decode_bubble_per_block(cfg, hw_s, hw_r, b, workers, seq_len,
                                     bytes_per_el, page)
    c = c_min
    while 2 * c <= c_max \
            and prefill_chunk_latency(cfg, hw_s, 2 * c,
                                      bytes_per_el) <= bubble:
        c *= 2
    return c


# ---------------------------------------------------------------------------
# heterogeneous-fleet variants (mixed R-worker hardware, fleet/ planner)
# ---------------------------------------------------------------------------
def fleet_rates(cfg: ModelConfig, hw_rs: Sequence[Hardware],
                bytes_per_el: int = 2, page: int = 0) -> List[float]:
    """Per-worker R-Part token rates 1/R_i (cached tokens per second per
    block) for a mixed fleet — the quantity row assignment should be
    proportional to."""
    return [1.0 / r_per_token(cfg, hw, bytes_per_el, page) for hw in hw_rs]


def fleet_shares(cfg: ModelConfig, hw_rs: Sequence[Hardware],
                 bytes_per_el: int = 2, page: int = 0) -> List[float]:
    """Normalized work shares of a mixed fleet (sum to 1)."""
    rates = fleet_rates(cfg, hw_rs, bytes_per_el, page)
    tot = sum(rates)
    return [r / tot for r in rates]


def optimal_workers_hetero(cfg: ModelConfig, hw_s: Hardware,
                           hw_rs: Sequence[Hardware], b: int, seq_len: int,
                           bytes_per_el: int = 2,
                           t_measured: Optional[Callable[[int], float]] = None,
                           page: int = 0) -> int:
    """eq. (11) generalized to a mixed pool: the smallest prefix of
    ``hw_rs`` whose aggregate rate Σ 1/R_i covers the steady-state R-Part
    demand 𝓑·S/(2·𝕋(𝓑)).  If the listed pool is too small, the count
    extrapolates with the pool's LAST worker type (the marginal worker
    you would add more of)."""
    if not hw_rs:
        raise ValueError("optimal_workers_hetero needs a non-empty pool")
    t_b = t_measured(b) if t_measured else t_of_b(cfg, hw_s, b, bytes_per_el)
    demand = b * seq_len / (2.0 * t_b)
    have = 0.0
    for i, hw in enumerate(hw_rs):
        if have >= demand:
            return max(1, i)
        have += 1.0 / r_per_token(cfg, hw, bytes_per_el, page)
    if have >= demand:
        return len(hw_rs)
    tail_rate = 1.0 / r_per_token(cfg, hw_rs[-1], bytes_per_el, page)
    return len(hw_rs) + math.ceil((demand - have) / tail_rate)


def plan_hetero(cfg: ModelConfig, hw_s: Hardware,
                hw_rs: Sequence[Hardware], seq_len: int,
                latency_slo: Optional[float] = None,
                worker_mem: float = 256e9, page: int = 0) -> Dict[str, object]:
    """§4.3 planning for a heterogeneous fleet: batch 𝓑 as in
    :func:`plan`, worker count from :func:`optimal_workers_hetero`, plus
    the proportional work shares the partition planner should apply to
    the workers actually used."""
    if latency_slo is not None:
        b = max_batch_for_slo(cfg, hw_s, seq_len, latency_slo)
    else:
        b = knee_batch(cfg, hw_s)
    n = optimal_workers_hetero(cfg, hw_s, hw_rs, b, seq_len, page=page)
    used = list(hw_rs[:min(n, len(hw_rs))])
    shares = fleet_shares(cfg, used, page=page)
    p_mem = min_workers_memory(cfg, b, seq_len, worker_mem, page=page)
    return {
        "batch": b,
        "workers": n,
        "workers_mem_min": p_mem,
        "shares": shares,
        "fleet_rate": sum(fleet_rates(cfg, used, page=page)),
        "t_of_b": t_of_b(cfg, hw_s, b),
        "e_of_b": e_of_b(cfg, hw_s, b),
        "tokens_per_s": b / (2 * cfg.num_layers * t_of_b(cfg, hw_s, b)),
    }


# ---------------------------------------------------------------------------
# orchestration overhead (the decode hot path's per-step tax — what the
# paper's eq. 7-11 ignore but "Understanding Bottlenecks for Efficiently
# Serving LLM Inference With KV Offloading" shows dominates offloaded
# decode; calibrated from benchmarks/bench_hotpath.py step breakdowns)
# ---------------------------------------------------------------------------
def phases_per_layer_step(cfg: ModelConfig) -> int:
    """S<->R round-trips per micro-batch per decode step = Σ phases over
    the layers (a DEC_XATTN block takes two: self- then cross-attn —
    decompose.num_phases' rule, restated here so perfmodel stays free of
    the decompose import)."""
    return sum(2 if k == DEC_XATTN else 1 for k in cfg.pattern)


@dataclass(frozen=True)
class OrchestrationOverhead:
    """Per-layer-transition orchestration costs of the event-driven hot
    path (seconds): ``dispatch_s`` per worker enqueue, ``collect_s`` per
    buffer->device gather, ``s_dispatch_s`` per fused jitted S-call
    invocation.  All are host-side tax serialized on the S-worker's
    driver thread — they bound throughput once the R-Part itself is off
    the critical path."""
    dispatch_s: float = 0.0
    collect_s: float = 0.0
    s_dispatch_s: float = 0.0

    def per_step(self, cfg: ModelConfig, num_mb: int,
                 num_workers: int) -> float:
        """The whole-step tax: every micro-batch crosses the S<->R
        boundary once per layer phase."""
        trans = phases_per_layer_step(cfg) * max(1, num_mb)
        return trans * (self.s_dispatch_s + self.collect_s
                        + max(1, num_workers) * self.dispatch_s)


def calibrate_orchestration(step_stats: Dict[str, float], cfg: ModelConfig,
                            num_mb: int,
                            num_workers: int) -> OrchestrationOverhead:
    """Fit the per-transition terms from an engine's cumulative
    ``step_stats`` (HeteroPipelineEngine.step_stats / ServingEngine.
    hotpath_stats()) — the measured counterpart of the analytic forms."""
    steps = max(1.0, float(step_stats.get("steps", 1.0)))
    trans = float(phases_per_layer_step(cfg) * max(1, num_mb))
    return OrchestrationOverhead(
        dispatch_s=step_stats.get("dispatch_s", 0.0)
        / (steps * trans * max(1, num_workers)),
        collect_s=step_stats.get("collect_s", 0.0) / (steps * trans),
        s_dispatch_s=step_stats.get("s_dispatch_s", 0.0) / (steps * trans))


def orchestration_residuals(
        baseline: OrchestrationOverhead,
        measured: OrchestrationOverhead) -> Dict[str, Dict[str, float]]:
    """Per-field measured-vs-predicted comparison of two calibrations —
    the drift monitor's view of whether the hot path still behaves the
    way ``plan()``/``from_plan()`` assumed when the baseline was fit.
    Keys follow the stats schema (``dispatch_s`` ...); each value holds
    ``predicted``, ``measured``, ``residual`` and ``rel``."""
    out: Dict[str, Dict[str, float]] = {}
    for f in ("dispatch_s", "collect_s", "s_dispatch_s"):
        pred = getattr(baseline, f)
        meas = getattr(measured, f)
        res = meas - pred
        rel = (0.0 if res == 0.0 else float("inf")) if pred == 0.0 \
            else res / pred
        out[f] = {"predicted": pred, "measured": meas,
                  "residual": res, "rel": rel}
    return out


def tokens_per_s_with_overhead(cfg: ModelConfig, hw_s: Hardware, b: int,
                               num_mb: int, num_workers: int,
                               overhead: OrchestrationOverhead) -> float:
    """The plan() ideal rate 𝓑 / (2·N·𝕋(𝓑)) degraded by the measured
    per-step orchestration tax — what the pipeline actually sustains."""
    t_ideal = 2.0 * cfg.num_layers * t_of_b(cfg, hw_s, b)
    return b / (t_ideal + overhead.per_step(cfg, num_mb, num_workers))


# ---------------------------------------------------------------------------
# communication sizing (paper Table 3, re-derived for any link)
# ---------------------------------------------------------------------------
def activation_bytes_per_token_per_block(cfg: ModelConfig,
                                         bytes_per_el: int = 2) -> float:
    """Q,K,V shipped S->R plus O shipped R->S (the paper's 'intermediate
    vectors')."""
    hd = cfg.head_dim
    return bytes_per_el * hd * (cfg.num_heads            # Q
                                + 2 * cfg.num_kv_heads   # K,V
                                + cfg.num_heads)         # O


def comm_latency_per_step(cfg: ModelConfig, b: int, link_bw: float,
                          bytes_per_el: int = 2) -> float:
    """Per token-generation step across all layers, both directions."""
    per_block = activation_bytes_per_token_per_block(cfg, bytes_per_el)
    return b * per_block * cfg.num_layers / link_bw


def kv_cache_bytes(cfg: ModelConfig, b: int, seq_len: int,
                   bytes_per_el: int = 2) -> float:
    return (b * seq_len * cfg.num_layers
            * 2.0 * cfg.num_kv_heads * cfg.head_dim * bytes_per_el)
