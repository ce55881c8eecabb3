#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py                    # every phase, as a user would run it
    python3 chip_smoke.py --phases kernel    # only some phases
    python3 chip_smoke.py --phases kernel --parent-source OLD.cu
                         # adds the compare phase: a parent's
                         # csrc/paged_attention.cu against this tree's
    python3 chip_smoke.py --phases kernel --parent-dense-source OLD.cu
                         # adds compare_dense: a parent's
                         # csrc/decode_attention.cu against this tree's

Phases (any failure exits nonzero):

  kernel      builds the port's CUDA sources (src/repro_torch/csrc, into
              the gitignored build/ directory; no bf16-q instantiation at
              Dh 128 or 256 nor any multi-token one nor any of the
              tensor-core engine for bf16 K/V (kernels 1 and 2) may spill,
              and kernel 3's 16-row engine and the bf16 K/V engine must fit
              3 CTAs per SM: each instantiation's registers and CTAs per SM
              printed), holds kernels 1 and 2 in bf16 (kernel 2 from G 2)
              also against the plain model of their engine's order of
              operations (within 1e-5 + 2^-8 relative, each repeated
              bitwise), holds every
              kernel (paged flash-decode; dense flash-decode in bf16/fp32
              and with int8 K/V, the latter also through its paged
              entry and its multi-token paged entry, the int8 verify,
              the paged kernels at G = Hq / Hkv 1, 4, 7 and 8,
              whose T = 1 must equal the paged entry bitwise; the paged
              multi-token verify, whose T = 1 must equal paged
              flash-decode bitwise) against its plain PyTorch
              version on the card, every kernel also on long rows that
              span many splits (each repeated bitwise), and times it at
              the main path's shape and at a bandwidth shape beside its
              bound, its plain version and a library yardstick, in a host
              loop and replayed from a CUDA graph, with the split plan it
              used (kernel 1 also at llama-13b's and opt-175b's serve
              shapes; kernels 1 and 4 also at grok-1's Hq 48 / Hkv 8
              with softcap 30, G = 6, whose T = 4 verify runs two row
              groups, and llama4-scout's Hq 40 / Hkv 8, G = 5, each also
              checked with ragged rows, holes and shared pages; the
              softcap rows' yardstick is compiled flex_attention, and
              grok-1's fp32 case with the cap saturated is held against
              fp64); kernel 3's slab entry at recurrentgemma-2b's heads
              (Dh 256, Hq 10 / Hkv 1, window 2048: rings wrapped past
              the window, a window under the ring, ragged and empty rows,
              bf16 and fp32 q, fp32 also against fp64, each repeated
              bitwise; Dh 96 and 512 refused; with a bf16 q one CTA per
              row and split), its ptxas registers and
              spills, and its times at the hybrid's int8 serve shape and
              at 64 x 2048; kernel 2 as the cross-attention R-Part
              (every slot at position 0) at whisper-medium's heads (Hq =
              Hkv = 16, Dh 64, S 1500) and llama-3.2-vision-90b's (Hq 64
              / Hkv 8, Dh 128, S 1600), 2 and 64 rows, bf16 and fp32
              (fp32 also against fp64), each repeated bitwise, timed at
              2 rows (one R-worker call of the static runs) and 64,
              and at the 3, 1 and 4 rows a worker holds after
              fleet_xattn's move and restore;
              kernel 3's paged entry also at the vision heads; times
              the one-call paged-int8 op against the gather + kernel 3
              chain it replaced.
  compare     (only with --parent-source) a parent's kernels 1 and 4 (a
              csrc/paged_attention.cu of this C ABI, e.g. from a git
              archive of the parent commit) against this tree's, timed in
              turns parent, tree, SDPA, tree, parent: kernel 1 at the main
              and bandwidth shapes and at the MoE and evaluation models'
              heads; kernel 4 at T 4 and every fp32 case bitwise the
              parent's; and a sweep of split plans.
  compare_dense (only with --parent-dense-source) the same for kernels 2
              and 3: kernel 2 at the serve shapes, the cross shapes
              (vision's G 8, whisper's G 1) and the rows after a move;
              kernel 3's entries and every fp32 case bitwise the parent's.
  serve       Qwen3-8B at full width cut to 12 of its 36 layers
              (QWEN_LAYERS; every serve_* phase below serves it), random
              weights from a seeded generator, served greedily through
              ServingEngine(backend="hetero", num_r_workers=2,
              paged_kv=True), in turns eager, graphs, eager (the step
              callables op by op, then replayed from their CUDA graphs):
              every request must finish with the right token count and
              finite logits, and the paged kernel's launch count must
              equal layers x micro-batches x workers x decode steps (on
              the graph path the counts come from replays); each turn
              has a profiled window (host launches, device idle).
  serve_int8  the same model and trace with quantized_kv=True, paged and
              then dense: the same checks, on the int8 kernel's count; the
              paged run must take kernel 3's paged entry every time and
              gather no page.
  serve_spec  the same model and trace with spec_decode=SpecConfig(k=3)
              (self-speculation): the same checks, with the verify
              kernel's launches equal to layers x workers x verify works
              run and no paged flash-decode launch; acceptance and the
              share of requests equal to the spec-off serve's reported,
              and the bf16 divergence triaged: both serves again with
              every logits row logged, and at each request's first
              differing token the max logit difference and the top-2
              margin (teacher-forced: the histories agree before it).
  serve_chunked
              the same model and trace with prefill_chunk=128, paged bf16
              and paged int8: prompts stream in one chunk per step while
              the other rows decode; the same checks (the decode kernel's
              count), every request finished, and beside each run the
              monolithic serve of the same storage: the steps that ran a
              prefill chunk against the steps that admitted.
  serve_spec_int8
              the same with spec_decode=SpecConfig(k=3) and
              quantized_kv=True, paged (the multi-token int8 entry's
              launches = layers x workers x verify works, no gather) and
              dense (the int8 chunk R-Part, no kernel), each with its
              divergence from spec-off int8 triaged as serve_spec's.
  equiv       the same width at 2 layers in fp32 (TF32 off): the hetero
              paged engine (through the kernel) and the colocated engine
              (plain torch) must give the same greedy tokens, a mismatch
              counting only if the teacher-forced logits also differ
              beyond tolerance; the hetero engine's graph tokens must
              equal its eager tokens (logits within tolerance).  So in
              equiv_int8 and equiv_spec.
  equiv_int8  the same at 2 layers: hetero paged-int8 == hetero dense-int8
              (tokens, logits within 1e-4), both through the int8 kernel,
              and both within 0.5 of the colocated fp logits fed the same
              tokens (the quantization bound of tests/test_hetero.py).
  equiv_spec  the same at 2 layers: hetero paged (through the verify
              kernel) and hetero dense (no kernel) with
              spec_decode=SpecConfig(k=3) must give the colocated spec-off
              engine's greedy tokens, a flip counting only if the logits
              that chose it differ beyond tolerance.
  equiv_chunk the same at 2 layers with prefill_chunk=5: dense and paged
              (pages of 4 and 16), OoO and FIFO, == colocated monolithic;
              int8 chunked runs within 0.5 of the fp logits; the int8
              bytes the chunk writers store bit-identical to a monolithic
              load's; prefill chunks sharing steps with verify works
              (spec k = 2) == colocated spec-off.
  equiv_spec_int8
              spec k = 3 on int8 storage, paged (through the multi-token
              int8 entry) and dense == spec-off int8 of the same storage.
  serve_sampled
              the 12-request trace with every odd request sampled
              (temperature 0.8, top-k 50, top-p 0.95), paged bf16: twice
              with one seed (tokens identical), once with another, then
              with spec k = 3 (rejection sampling); every sampled token
              inside the support of target_probs of the row that chose it.
  serve_prefix
              prefix_cache=True: 12 requests sharing one 512-token prefix
              (request 0 first, the rest a step later), beside the same
              trace without the cache: hits, shared pages, peak resident
              KV, prefill wall, captures; the shared pages' bytes (a
              device-side digest) unchanged by the serve; tokens against
              the cache-off serve, triaged teacher-forced.
  serve_tier  kv_tiering=TierConfig(), preempt_after=2 and a pool cut so
              admission stalls, paged bf16 then paged int8, beside an
              uninterrupted serve with a large pool: preemptions, pages
              swapped out and restored, host bytes, the measured copy
              seconds beside the simulated ones; every restored page bit
              for bit its swapped-out bytes; tokens triaged.
  equiv_prefix
              at 2 layers, fp32 (bf16 where named): prefix-on == prefix-
              off == colocated (graphs and eager); parked-and-restored ==
              uninterrupted (bf16, int8); preempt() mid-decode ==
              uninterrupted; sampled hetero == sampled colocated (one
              seed).
  serve_plan  ServingEngine.from_plan (the §4.3 model, H100 profile;
              seq_len 1024, max_batch 8) serving a backlog of 24 requests:
              greedy without and with observability in turns (off, on,
              on, off, off, on: the overhead as the median per-step wall
              ratio), then sls and loadctl (S = 32, F = 4); the plan and
              the roofline at the engine's batch (predictions from the
              spec sheet), per run tokens/s, step p50, peak resident
              length and KV, admissions per step, TTFT / queue-wait /
              inter-token / end-to-end percentiles, the drift report, the
              span count and the Chrome trace written to --trace-out;
              checks on/off tokens equal, sls admissions on the schedule,
              loadctl under w_lim, drift calibrated, metrics in schema.
  equiv_plan  at 2 layers, fp32: sls and loadctl hetero == colocated
              (tokens, admissions per step), observability on == off,
              from_plan serves, a sim_row_cost straggler flagged by the
              drift monitor.
  serve_fleet the 12-request trace under FleetManager(skewed_fleet((2.0,
              1.0)), rebalance=True, snapshot_interval=16): the planner's
              uneven split, a sim_row_cost straggler the rebalancer
              migrates rows off, kill() of a worker before step 33,
              recovered by re-prefill and (second run) from the snapshot,
              beside an uninterrupted serve whose longest R-side capture
              must be under half the phases' suspect_after_s (SUSPECT_S);
              tokens/s before and after the kill, MTTR, each migration's
              and snapshot's seconds and bytes, graphs re-captured, spared
              workers (0), fleet_* metrics; tokens triaged.
  serve_chaos the same trace under one seeded FaultPlan (a crash of
              worker 1, a dropped completion, a pool fault, a 3 s hang),
              healed by the step supervisor: every fault fired, every
              request finished; fault_events, MTTR, re-prefilled rows and
              tokens/s beside the chaos-off serve, tokens triaged.
  serve_eval  the paper's evaluation models served as ``serve``'s graph
              run serves Qwen3-8B (same trace, engine and checks, one
              profiled window each): llama-13b at full width and depth
              (40 layers), then opt-175b at full width cut to 8 of its
              96 layers (the cut is on the phase's line); Qwen3-8B is
              freed first.
  static_eval llama-13b at full size through the static-batch API as
              the JAX package's benches drive it: HeteroPipelineEngine(
              batch=8, num_microbatches=2, num_r_workers=2, paged_kv=True,
              cache_len=1024), load_prefill of 512-token prompts per
              micro-batch, reset_step_stats, 16 steps of decode_step, of
              decode_step_legacy and of decode_step with
              profile_timing=True, beside ColocatedEngine.load_prefill + 16
              decode_steps: load wall, tokens/s, step p50, step_stats per
              step and worker busy times; kernel 1's count exact on every
              hetero run; legacy and profile_timing tokens equal the fused
              step's (a bf16 difference triaged); the §4.3 prediction
              for the same batch beside them.
  equiv_eval  fp32 at 2 layers of llama-13b's, opt-175b's and
              deepseek-coder-33b's (G = 7) width: hetero paged == colocated
              and graphs == eager in the serve; load_prefill +
              decode_step == decode_step_legacy == the two alternated ==
              ColocatedEngine.load_prefill + decode_step, graphs == eager.
  serve_moe   the mixture-of-experts models served as serve_eval serves
              (same trace, engine and checks, one profiled window each),
              bf16 at full width: grok-1 cut to 4 of 64 layers (softcap
              30, G = 6), spec-off and with spec_decode=SpecConfig(k=3)
              (kernel 4 only), then llama4-scout cut to 8 of 48 layers
              (G = 5, qk_norm), each model freed before the next; the
              share of routed (token, expert) pairs the capacity dropped
              at decode and at prefill (counted in an eager replay of the
              trace after the timed run), the weight bytes a step reads
              (every expert) and the §4.3 prediction beside them.
  equiv_moe   fp32 at 2 layers of both MoE models' width: with
              moe_capacity = experts (no drops) hetero paged == colocated
              and graphs == eager; at the published 1.25 graphs == eager
              bit for bit and the drops of hetero and colocated reported
              (they differ: each call's token count does); llama4-scout's
              load_prefill with 64 patch embeddings, hetero == colocated.
  equiv_fleet at 2 layers, fp32: apply_partition to an uneven split and
              back on four storages (wire payloads bit for bit, tokens ==
              colocated), re-prefill and snapshot recovery == colocated,
              and the fault matrix (crash, drop, error, hang, dup, pool,
              verify, the three tier sites, wire_corrupt on a migration and
              on a snapshot), each == colocated with its fault fired.
  serve_rglru recurrentgemma-2b at full size (26 layers: 18 RG-LRU, 8
              windowed MQA layers at Dh 256), bf16, through
              ServingEngine(backend="hetero", num_r_workers=2,
              paged_kv=True) on the 12-request trace as serve_eval serves
              (one profiled window each): as is (the windowed layers stay
              on the dense slab and attend in plain torch: no kernel),
              with quantized_kv=True (kernel 3's slab entry: launches =
              8 attention layers x 2 micro-batches x 2 workers x decode
              steps, no plain call) and with prefill_chunk=128; the step
              bound (2 x weight bytes / 3.35 TB/s) beside the p50.
  serve_ssd   mamba2-2.7b at full size (64 SSD layers), bf16, the same
              trace as is and with prefill_chunk=128: no kernel, no KV
              pool or allocator built under paged_kv.
  equiv_recurrent
              fp32 (TF32 off) at full width, the hybrid at 3 layers (one
              period) and mamba2 at 2: hetero paged == colocated,
              chunked (16) == monolithic, graphs == eager bit for bit, a
              migration and a re-prefill failover of the recurrent rows
              == colocated (wire payloads bit for bit), the hybrid's int8
              storage within 0.5 of fp on teacher-forced logits.
  static_vision
              llama-3.2-vision-90b at full width cut to 10 of its 100
              layers (VISION_LAYERS: two periods, 8 ATTN and 2 XATTN),
              bf16, through the static-batch API: HeteroPipelineEngine(
              batch=8, num_microbatches=2, num_r_workers=2, paged_kv=True,
              cache_len=1024), seeded prompts of 17-600 tokens and patch
              embeddings [8, 1600, 8192], load_prefill per micro-batch,
              32 decode_steps (XATTN_STEPS), then the same with
              quantized_kv=True: kernel 1 (int8: kernel 3's paged entry)
              = 8 x 2 x 2 x steps and kernel 2 = 2 x 2 x 2 x steps
              exactly, no plain call; tokens/s, step p50 beside the step
              bound (2 x the weights a step reads / 3.35 TB/s), a
              profiled window each (device idle, host launches).
  static_whisper
              whisper-medium at full size (24 encoder + 24 decoder
              layers, 1500 frames), bf16, the same engine (paged_kv a
              no-op: no page pool), prompts of 17-448 tokens: the fused
              step (profiled window), decode_step_legacy and
              profile_timing, 16 steps each (WHISPER_STEPS), their tokens
              equal; kernel 2 = 24 x 2 x 2 x steps on each, nothing else.
  equiv_xattn fp32 (TF32 off), seeded non-zero gates, at full width:
              vision at 5 layers (one period), whisper at 2 + 2 layers:
              hetero paged == colocated, graphs == eager bit for bit,
              legacy == fused, paged == dense (whisper bit for bit), 1
              R-worker == colocated; launches exact.
  fleet_xattn cross-attention rows through a live migration and a
              snapshot failover at static_vision's and static_whisper's
              widths, bf16, batch 8, 2 micro-batches, 2 R-workers, paged:
              an unmoved greedy run of 16 steps, then a run
              teacher-forced on its tokens that moves to 3 + 1 rows a
              micro-batch before step 4 (apply_partition) and, before
              step 8, snapshots (KVSnapshotStore), kills worker 0 and
              restores its rows onto the survivor (remove_worker(...,
              lost=)): wire bytes and seconds of each, graphs captured
              again, kernel 2's launches after each (exact), the logit
              difference against the unmoved run and whether the greedy
              tokens are equal (a flip must be a near tie); kernel 2 on
              the workers' slabs after each (3, 1 and 4 rows) against
              its plain version.
  paged_kv_api
              the single-sequence PagedKV API at Qwen3-8B's heads (Hq 32,
              Hkv 8, Dh 128), page 16, bf16: the same op sequence on the
              card and on the CPU (prefill, decode, a release and a
              regrowth), equal allocator state and pools after every op,
              no op changing its argument, r_attention_paged within the
              bf16 tolerance of the CPU; on the rows written from 0, its
              pool and tables through kernel 1 too.
  examples    repro_torch.examples' quickstart (its hetero == colocated
              assertion), serve_continuous (48 requests) and train_small
              --quick, each with no --device; no kernel counter moves
              (dense fp storage attends in plain torch).
  train       Qwen3-8B at full width cut to 4 of its 36 layers
              (TRAIN_LAYERS), bf16, seeded weights, trained through
              make_train_step (AdamW, warmup-cosine) on SyntheticLM
              batches of 4 x 1024 tokens: 8 steps without remat, then 8
              with remat from the same weights (the first losses equal
              bit for bit, the later within 2^-7); per run the first
              step, the step p50, forward + backward and the update apart
              (CUDA events), tokens/s, peak memory and the model-flops
              share; no kernel counter moves (the train path attends in
              plain torch); then ``python -m repro_torch.launch.train``
              with no --device (the card is the default; it runs on the
              launcher's own world of 1 over NCCL and its (1, 1) mesh).
  equiv_train fp32 (TF32 off) at reduced() sizes, for qwen3-8b, grok-1
              (capacity 1.25, aux on), recurrentgemma-2b, mamba2-2.7b,
              llama-3.2-vision-90b (10 layers, seeded gates) and
              whisper-medium: loss and grads on the card == on the CPU,
              remat == no remat, three train steps card == CPU (lr
              1e-2); the drift of 8 steps at lr 3e-4, reported.
  dist        the distributed layer (repro_torch.distributed) on a world
              of 1 over NCCL (a FileStore under build/) and a (1, 1)
              ('data', 'model') DeviceMesh: Qwen3-8B at full width cut
              to 4 of 36 layers (DIST_LAYERS), bf16, 8 prompts of 512
              tokens prefilled into a 1024-token cache and 16 greedy
              decode steps, with no mesh and under the rules fastdecode,
              fastdecode_sm and baseline (DTensor params and state): each
              run's tokens and logit difference against the no-mesh run,
              its eager step p50 beside the no-mesh p50, peak memory and
              the collectives of a step; in fp32 at 2 layers, fastdecode
              and baseline == no mesh within 1e-5 (relative),
              fastdecode_sm == fastdecode within 2e-4, and one train step
              with grad_shardings == the no-mesh step; no kernel counter
              moves.  More than one rank cannot share the card over NCCL:
              the CPU tests hold the 2x2 gloo world.

The serve and equiv phases run the hetero engine's CUDA graphs
(``repro_torch.core.graphs``) unless a run says eager; the serve
records give the captures made, their seconds and the graph pools'
bytes.

Earlier lines print one JSON object per phase and one ``kernels`` line;
the line before the last is the card's name and power limit; the last
line is ``{"ok": true, "device": {...}}``.  Without CUDA, or outside a
checkout of the repo, it exits nonzero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity
# every ported kernel: its source and the TPU kernel it replaces
KERNELS = {
    "paged_decode_attention": (
        "src/repro_torch/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:56"),
    "decode_attention": (
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:39"),
    "decode_attention_int8": (
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/quant_kv.py:44"),
    "paged_verify_attention": (
        "src/repro_torch/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:174"),
    # kernel 3's multi-token paged entry (the paged int8 verify): a
    # port-side entry of kernel 3, computing src/repro/kernels/ops.py:152
    "verify_int8": (
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/quant_kv.py:44"),
    # kernel 3's slab entry at recurrentgemma-2b's heads (Dh 256, G 10,
    # window 2048): the hybrid's quantized_kv decode
    "decode_attention_int8_dh256": (
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/quant_kv.py:44"),
}
# kernel vs plain version: |out - want| <= atol + rtol * |want|.  Both
# accumulate in fp32 and round once to the output dtype, so in bf16 they
# may differ by one rounding step, at most 2^-7 of |want|; one dropped
# key among 512 moves an output by ~2e-3, far beyond atol.
TOL = {"bfloat16": (1e-4, 2.0 ** -7), "float32": (1e-5, 0.0)}
# the group sizes G = Hq / Hkv the paged cases cover, each with its
# kv-head count: 1 (llama-13b, opt-175b), 4 (Qwen3-8B), 7
# (deepseek-coder-33b: no power of two) and 8 (deepseek-67b)
G_HKV = {1: 8, 4: 2, 7: 2, 8: 2}
# the MoE models' heads (Hq, Hkv, softcap): grok-1's G = 6 with its
# attention logit softcap of 30, llama4-scout's G = 5
MOE_HEADS = {"grok-1": (48, 8, 30.0), "llama4-scout": (40, 8, 0.0)}
# q scaled so that the softcap bites: at x 16 the scores reach |s| ~ 60
# and tanh(s / 30) saturates.  The fp32 cases held against the plain
# version scale q by 2 (|s| under ~8; the cap still moves the top score
# by ~0.1), because at |s| ~ 60 fp32's own rounding of the scores parts
# the plain version from fp64 by ~9e-6, the size of the fp32 tolerance
# (atol 1e-5); the saturated fp32 case (q x 16) is held against an fp64
# version instead (``_fp64_check``)
SOFTCAP_Q_SCALE = {"bfloat16": 16.0, "float32": 2.0}
SATURATED_Q_SCALE = 16.0
SOFTCAP_LIBRARY = ("torch.nn.attention.flex_attention(score_mod = softcap "
                   "tanh, block_mask = the causal mask, enable_gqa), "
                   "compiled")


def tol_check(out, want, dtype_name: str):
    """(max |out - want|, whether every element is inside TOL)."""
    atol, rtol = TOL[dtype_name]
    d = (out.float() - want.float()).abs()
    inside = bool((d <= atol + rtol * want.float().abs()).all())
    return float(d.max()), inside and bool(out.float().isfinite().all())


T0 = time.perf_counter()


def log(obj) -> None:
    """One JSON line; a phase's carries the seconds since the start."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - T0)
    print(json.dumps(obj), flush=True)


def gpu_name_and_limit() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def host_cpu() -> dict:
    """The host's CPU and torch's vector path on it: the kernel phase's
    inputs are drawn, and its models run, on the host."""
    import platform
    import torch
    info = Path("/proc/cpuinfo")
    lines = info.read_text().splitlines() if info.exists() else []
    cpu = next((x.split(":", 1)[1].strip() for key in ("model name",
                                                      "vendor_id")
                for x in lines if x.startswith(key)), platform.machine())
    return {"cpu": cpu, "cpu_capability":
            torch.backends.cpu.get_cpu_capability(),
            "torch": torch.__version__, "threads": torch.get_num_threads()}


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    calls (after ``warmup`` calls)."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, calls: int, reps: int = 10, strict: bool = True):
    """Device time of one call without the host in the way: ``calls``
    calls (fn(0) .. fn(calls-1)) captured in one CUDA graph, replayed
    ``reps`` times between CUDA events.  A library call that cannot be
    captured gives None unless ``strict``."""
    import torch
    if not strict:
        try:
            return graph_time_ms(fn, calls, reps)
        except RuntimeError as e:
            print(f"graph capture failed: {e}", file=sys.stderr, flush=True)
            return None
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------
def _paged_case(gen, *, b, hq, hkv, dh, page, mp, lengths, dtype, dev,
                unmapped_row=None, hole=None, share=None, extra_pages=1):
    """A page pool plus block tables: each row maps ceil((len+1)/page)
    distinct pages; ``unmapped_row`` gets an all -1 table, ``hole`` =
    (row, slot) sets one entry to -1, ``share`` = (row_a, row_b) makes
    row_b's first page row_a's first page."""
    import torch
    need = [-(-(int(n) + 1) // page) for n in lengths]
    n_pages = sum(need) + extra_pages
    perm = torch.randperm(n_pages, generator=gen)
    tables = torch.full((b, mp), -1, dtype=torch.int32)
    cur = 0
    for r in range(b):
        if r == unmapped_row:
            continue
        tables[r, :need[r]] = perm[cur:cur + need[r]].to(torch.int32)
        cur += need[r]
    if hole is not None:
        tables[hole[0], hole[1]] = -1
    if share is not None:
        tables[share[1], 0] = tables[share[0], 0]
    pk = torch.randn((n_pages, page, hkv, dh), generator=gen).to(dtype)
    pv = torch.randn((n_pages, page, hkv, dh), generator=gen).to(dtype)
    q = torch.randn((b, hq, dh), generator=gen).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32)
    return [t.to(dev) for t in (q, pk, pv, tables, lens)]


def kernel_checks(dev) -> dict:
    """Kernel 1 against its plain version: G 1, 4, 7 and 8, page 4 and 16, bf16
    and fp32, ragged rows, a -1 hole, a shared page and an all-unmapped
    row (exactly 0); window + sink and softcap cases; and the long
    multi-split cases of ``long_cases``, each repeated bitwise.  Every
    bf16 case (tc_decode.cuh's tensor-core engine) is also held to its
    order of operations (``ref.bf16_mma_paged_ref`` at the call's split
    plan, ``MODEL_TOL``) and repeated bitwise."""
    import torch
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 plain version
    torch.backends.cudnn.allow_tf32 = False         # runs in full fp32
    gen = torch.Generator().manual_seed(0)
    cases = []
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for g, hkv in G_HKV.items():
            for page in (4, 16):
                lengths = [37, 5, 0, 63, 20]
                cases.append(dict(
                    name=f"{dtype_name}-G{g}-page{page}", dtype=dtype,
                    kw=dict(b=5, hq=hkv * g, hkv=hkv, dh=128, page=page,
                            mp=-(-80 // page), lengths=lengths,
                            unmapped_row=2, hole=(3, 1), share=(0, 4)),
                    attn=dict()))
        cases.append(dict(
            name=f"{dtype_name}-window-sink", dtype=dtype,
            kw=dict(b=3, hq=8, hkv=2, dh=128, page=16, mp=8,
                    lengths=[100, 17, 64]),
            attn=dict(window=24, sink=4)))
        cases.append(dict(
            name=f"{dtype_name}-softcap-dh64", dtype=dtype,
            kw=dict(b=3, hq=12, hkv=4, dh=64, page=4, mp=16,
                    lengths=[50, 3, 61]),
            attn=dict(softcap=5.0)))
        cases += moe_cases(dtype_name, t=1)
        cases += long_cases(dtype_name, t=1)
    worst = 0.0
    results = []
    for c in cases:
        q, pk, pv, tables, lens = _paged_case(gen, dtype=c["dtype"], dev=dev,
                                              **c["kw"])
        q = (q * c.get("q_scale", 1.0)).to(q.dtype)
        out = PA.paged_decode_attention(q, pk, pv, tables, lens, **c["attn"])
        torch.cuda.synchronize()
        want = ref.paged_decode_attention_ref(q, pk, pv, tables, lens,
                                              **c["attn"])
        dtype_name = str(c["dtype"]).split(".")[-1]
        err, ok = tol_check(out, want, dtype_name)
        rec = {"case": c["name"], "max_abs_err": err,
               "atol_rtol": TOL[dtype_name],
               "split_plan": PA.kernel_plan(q, pk, tables)}
        if c.get("fp64"):
            rec.update(_fp64_check(out, want, q, pk, pv, tables, lens,
                                   c["attn"]))
            err, ok = rec["kernel_vs_fp64"], rec["fp64_ok"]
            rec["max_abs_err"] = err
        un = c["kw"].get("unmapped_row")
        if un is not None:
            ok = ok and bool((out[un] == 0).all())
        bf16 = c["dtype"] == torch.bfloat16
        if bf16:
            rec.update(_model_check(
                c["name"], out, ref.bf16_mma_paged_ref(
                    q, pk, pv, tables, lens,
                    pages_per_split=rec["split_plan"][0], **c["attn"]),
                "kernel 1's tensor-core engine (ref.bf16_mma_paged_ref)"))
        if c.get("long") or bf16:
            again = PA.paged_decode_attention(q, pk, pv, tables, lens,
                                              **c["attn"])
            torch.cuda.synchronize()
            rec["bitwise_repeat"] = bool(torch.equal(out, again))
            ok = ok and rec["bitwise_repeat"]
        rec["ok"] = ok
        results.append(rec)
        if not ok:
            raise AssertionError(f"kernel case {c['name']} failed: err {err} "
                                 f"(atol, rtol) {TOL[dtype_name]} (unmapped "
                                 f"row must be exactly 0; a long or bf16 "
                                 f"case must repeat bitwise; an fp64 case: "
                                 f"tol_vs_fp64): {rec}")
        if not c.get("fp64"):
            worst = max(worst, err)
    return {"cases": results, "max_abs_err": worst}


def moe_cases(dtype_name, *, t) -> list:
    """The MoE models' head layouts (``MOE_HEADS``) at Dh 128, page 16:
    grok-1 (Hq 48 / Hkv 8, G = 6) with softcap 30 and q scaled so that
    the cap bites, llama4-scout (Hq 40 / Hkv 8, G = 5); ragged rows, a -1
    hole, a shared page and an all-unmapped row.  A verify at T = 4 holds
    T*G = 24 and 20 query rows: two row groups of a 16-row CTA.  In fp32
    grok-1's layout runs twice: q x 2 against the plain version, and q x
    16 (the cap saturated) against fp64 (``fp64``: ``_fp64_check``)."""
    import torch
    cases = []
    for name, (hq, hkv, cap) in MOE_HEADS.items():
        scales = [(SOFTCAP_Q_SCALE[dtype_name] if cap else 1.0, False)]
        if cap and dtype_name == "float32":
            scales.append((SATURATED_Q_SCALE, True))
        for q_scale, fp64 in scales:
            cases.append(dict(
                name=f"{dtype_name}-T{t}-{name}-G{hq // hkv}"
                     + (f"-softcap{cap:g}" if cap else "")
                     + (f"-q{q_scale:g}-fp64" if fp64 else ""),
                dtype=getattr(torch, dtype_name), t=t, q_scale=q_scale,
                fp64=fp64,
                kw=dict(b=5, hq=hq, hkv=hkv, dh=128, page=16,
                        mp=-(-84 // 16), lengths=[37, 5, 0, 63, 20],
                        unmapped_row=2, hole=(3, 1), share=(0, 4)),
                attn=dict(softcap=cap) if cap else dict()))
    return cases


def _paged_fp64(q, pk, pv, tables, lengths, *, softcap=0.0):
    """Paged attention computed in fp64 (no window or sink): q [B,Hq,Dh]
    (query at lengths) or [B,T,Hq,Dh] (query t at lengths + t) -> the
    same shape in fp64; a query with no valid key gives 0."""
    import math
    import torch
    from repro_torch.kernels import ref
    f64 = torch.float64
    q4 = q[:, None] if q.dim() == 3 else q
    b, t, hq, dh = q4.shape
    k, kpos = ref.paged_gather(pk, tables)
    v, _ = ref.paged_gather(pv, tables)
    hkv = k.shape[2]
    qg = q4.to(f64).reshape(b, t, hkv, hq // hkv, dh) / math.sqrt(dh)
    s = torch.einsum("bthgd,bshd->bthgs", qg, k.to(f64))
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    qpos = lengths[:, None].long() + torch.arange(t, device=q.device)
    msk = ((kpos[:, None, :] >= 0)
           & (kpos[:, None, :] <= qpos[:, :, None]))[:, :, None, None, :]
    s = torch.where(msk, s, torch.tensor(float("-inf"), dtype=f64,
                                         device=q.device))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    o = torch.einsum("bthgs,bshd->bthgd", p, v.to(f64)).reshape(b, t, hq,
                                                                 dh)
    return o[:, 0] if q.dim() == 3 else o


def _fp64_check(out, plain, q, pk, pv, tables, lengths, attn) -> dict:
    """A saturated fp32 case: the kernel's and the plain version's
    distance to fp64.  The kernel passes when its distance is at most
    atol plus the plain version's own: what |kernel - plain| <= atol
    implies by the triangle inequality, with fp64 in the plain version's
    place."""
    want = _paged_fp64(q, pk, pv, tables, lengths, **attn)
    d_plain = float((plain.double() - want).abs().max())
    d_kern = float((out.double() - want).abs().max())
    atol = TOL["float32"][0]
    return {"kernel_vs_fp64": d_kern, "plain_vs_fp64": d_plain,
            "kernel_vs_plain": float((out - plain).abs().max()),
            "tol_vs_fp64": atol + d_plain,
            "fp64_ok": d_kern <= atol + d_plain
            and bool(out.isfinite().all())}


def long_cases(dtype_name, *, t) -> list:
    """Cases whose rows span many splits of the kernels' split plan: 4096
    table positions, lengths from 0 to 4095 (the pages hold the last
    candidate of a T-token verify), an all-unmapped row (exactly 0), a -1
    hole and a shared page, G 1 and 4, page 4 and 16; and window + sink
    at long lengths, which leaves the middle splits empty (plus Dh 64 for
    the verify).  Each must also repeat bitwise on a second launch."""
    import torch
    dtype = getattr(torch, dtype_name)
    # the verify's base: its pages hold up to base + t - 1 <= 4095
    lengths = [1000, 17, 0, 513, 4095 - (t - 1), 300]
    cases = []
    for g in (1, 4):
        for page in ((4, 16) if t == 1 else (16,)):
            hkv = 8 // g
            cases.append(dict(
                name=f"{dtype_name}-T{t}-long-G{g}-page{page}", dtype=dtype,
                t=t, long=True,
                kw=dict(b=6, hq=hkv * g, hkv=hkv, dh=128, page=page,
                        mp=4096 // page, lengths=lengths, unmapped_row=5,
                        hole=(3, 2), share=(0, 4)),
                attn=dict()))
    cases.append(dict(
        name=f"{dtype_name}-T{t}-long-window-sink", dtype=dtype, t=t,
        long=True,
        kw=dict(b=3, hq=8, hkv=2, dh=128, page=16, mp=256,
                lengths=[3000, 1500, 40], unmapped_row=None),
        attn=dict(window=256, sink=16)))
    if t > 1:
        cases.append(dict(
            name=f"{dtype_name}-T{t}-long-dh64-softcap", dtype=dtype, t=t,
            long=True,
            kw=dict(b=6, hq=16, hkv=4, dh=64, page=16, mp=256,
                    lengths=lengths, unmapped_row=5, hole=(3, 2),
                    share=(0, 4)),
            attn=dict(softcap=5.0)))
    return cases


def verify_checks(dev) -> dict:
    """Kernel 4 against its plain version: T 1, 2 and 4 candidate tokens,
    G 1, 4, 7 and 8, page 4 and 16, Dh 64 and 128, bf16 and fp32, with ragged
    rows, a -1 hole, a shared page and an all-unmapped row (no valid key:
    exactly 0); window + sink and softcap cases; the long multi-split
    cases of ``long_cases`` at T 1 and 4, each repeated bitwise; and T = 1
    against kernel 1 on the same inputs, which must be bitwise equal (one
    template, the same instantiation and split plan)."""
    import torch
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(5)
    cases = []
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for t in (1, 2, 4):
            for g, hkv in G_HKV.items():
                for page in (4, 16):
                    for dh in (64, 128):
                        cases.append(dict(
                            name=f"{dtype_name}-T{t}-G{g}-page{page}-dh{dh}",
                            dtype=dtype, t=t,
                            kw=dict(b=5, hq=hkv * g, hkv=hkv, dh=dh,
                                    page=page, mp=-(-84 // page),
                                    lengths=[37, 5, 0, 63, 20],
                                    unmapped_row=2, hole=(3, 1),
                                    share=(0, 4)),
                            attn=dict()))
        for t in (1, 4):
            cases.append(dict(
                name=f"{dtype_name}-T{t}-window-sink", dtype=dtype, t=t,
                kw=dict(b=3, hq=8, hkv=2, dh=128, page=16, mp=8,
                        lengths=[100, 17, 64], unmapped_row=None),
                attn=dict(window=24, sink=4)))
            cases.append(dict(
                name=f"{dtype_name}-T{t}-softcap-dh64", dtype=dtype, t=t,
                kw=dict(b=3, hq=12, hkv=4, dh=64, page=4, mp=18,
                        lengths=[50, 3, 61], unmapped_row=None),
                attn=dict(softcap=5.0)))
            cases += moe_cases(dtype_name, t=t)
            cases += long_cases(dtype_name, t=t)
    worst = 0.0
    results = []
    t1_equal = []
    for c in cases:
        t = c["t"]
        kw = dict(c["kw"])
        # the pages hold the last candidate: position base + t - 1
        kw["lengths"] = [n + t - 1 for n in kw["lengths"]]
        _, pk, pv, tables, lens = _paged_case(gen, dtype=c["dtype"], dev=dev,
                                              **kw)
        base = (lens - (t - 1)).contiguous()
        q = (torch.randn((kw["b"], t, kw["hq"], kw["dh"]), generator=gen)
             * c.get("q_scale", 1.0)).to(c["dtype"]).to(dev)
        out = PA.paged_verify_attention(q, pk, pv, tables, base, **c["attn"])
        torch.cuda.synchronize()
        want = ref.paged_verify_attention_ref(q, pk, pv, tables, base,
                                              **c["attn"])
        dtype_name = str(c["dtype"]).split(".")[-1]
        err, ok = tol_check(out, want, dtype_name)
        rec = {"case": c["name"], "max_abs_err": err,
               "atol_rtol": TOL[dtype_name],
               "split_plan": PA.kernel_plan(q, pk, tables, t),
               "row_groups": PA.row_groups(t, kw["hq"] // kw["hkv"])}
        if c.get("fp64"):
            rec.update(_fp64_check(out, want, q, pk, pv, tables, base,
                                   c["attn"]))
            err, ok = rec["kernel_vs_fp64"], rec["fp64_ok"]
            rec["max_abs_err"] = err
        un = kw.get("unmapped_row")
        if un is not None:
            ok = ok and bool((out[un] == 0).all())
        rec["ok"] = ok
        if c.get("long"):
            again = PA.paged_verify_attention(q, pk, pv, tables, base,
                                              **c["attn"])
            torch.cuda.synchronize()
            rec["bitwise_repeat"] = bool(torch.equal(out, again))
            ok = ok and rec["bitwise_repeat"]
            rec["ok"] = ok
        if t == 1:
            dec = PA.paged_decode_attention(q[:, 0].contiguous(), pk, pv,
                                            tables, base, **c["attn"])
            torch.cuda.synchronize()
            rec["equal_to_kernel_1"] = bool(torch.equal(out[:, 0], dec))
            t1_equal.append(rec["equal_to_kernel_1"])
            ok = ok and rec["equal_to_kernel_1"]
            rec["ok"] = ok
        results.append(rec)
        if not ok:
            raise AssertionError(
                f"verify kernel case {c['name']} failed: err {err} (atol, "
                f"rtol) {TOL[dtype_name]} (unmapped row must be exactly 0; "
                f"T = 1 must equal kernel 1 bitwise; a long case must "
                f"repeat bitwise; an fp64 case: tol_vs_fp64): {rec}")
        if not c.get("fp64"):
            worst = max(worst, err)
    return {"cases": results, "max_abs_err": worst,
            "t1_bitwise_equal_to_kernel_1": all(t1_equal)}


def _timing_case(dev, *, b, n_tok, hq, hkv, dh, page, cache_len, copies,
                 t):
    """The inputs of ``kernel_timing``: ``copies`` pools, tables, q and
    lengths (bf16), the K/V already laid out per head for SDPA, and
    kernel 4's SDPA mask."""
    import torch
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(1)
    mp = -(-(cache_len or n_tok) // page)
    per_row = -(-n_tok // page)
    n_pages = b * mp + 1
    nq = t or 1
    qshape = (b, t, hq, dh) if t else (b, hq, dh)
    lens_val = n_tok - nq
    bufs = []
    for _ in range(copies):
        pk = torch.randn((n_pages, page, hkv, dh), generator=gen,
                         device=dev).to(torch.bfloat16)
        pv = torch.randn((n_pages, page, hkv, dh), generator=gen,
                         device=dev).to(torch.bfloat16)
        q = torch.randn(qshape, generator=gen,
                        device=dev).to(torch.bfloat16)
        ids = torch.randperm(b * mp, generator=gen, device=dev)
        tables = torch.full((b, mp), -1, dtype=torch.int32, device=dev)
        tables[:, :per_row] = ids[:b * per_row].reshape(b, per_row).to(
            torch.int32)
        if t:
            used = 1
            while used < per_row:
                used *= 2
            tables = tables[:, :min(used, mp)].contiguous()
        lens = torch.full((b,), lens_val, dtype=torch.int32, device=dev)
        # the library yardstick reads the already-gathered K/V (the gather
        # is excluded from its time); all n_tok positions are valid for
        # the last query, query i of kernel 4 sees base + i + 1
        kg, _ = ref.paged_gather(pk, tables[:, :per_row])
        vg, _ = ref.paged_gather(pv, tables[:, :per_row])
        kg = kg[:, :n_tok].permute(0, 2, 1, 3).contiguous()
        vg = vg[:, :n_tok].permute(0, 2, 1, 3).contiguous()
        bufs.append((q, pk, pv, tables, lens, kg, vg))
    mask = None
    if t:
        qp = lens_val + torch.arange(t, device=dev)
        mask = (torch.arange(n_tok, device=dev)[None, :]
                <= qp[:, None])[None, None].expand(b, 1, t, n_tok)
    return bufs, mask, lens_val


def _sdpa(q, kg, vg, mask, t):
    import torch.nn.functional as F
    if t:
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kg, vg, attn_mask=mask,
            enable_gqa=True).transpose(1, 2)
    return F.scaled_dot_product_attention(q[:, :, None], kg, vg,
                                          enable_gqa=True)[:, :, 0]


def _flex_softcap(dev, *, n_tok, t, lens_val, softcap):
    """The library yardstick of a softcap row: ``flex_attention`` with
    the tanh softcap as its score_mod (and, for kernel 4, the causal mask
    to lens_val + i as a block mask), compiled once for this shape; takes
    the arguments of ``_sdpa``."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    flex = torch.compile(flex_attention, dynamic=False)

    def score_mod(s, b, h, qi, kj):
        return softcap * torch.tanh(s / softcap)

    def mask_mod(b, h, qi, kj):
        return kj <= lens_val + qi
    block_mask = (create_block_mask(mask_mod, None, None, t, n_tok,
                                    device=dev) if t else None)

    def run(q, kg, vg, mask, t_):
        q4 = q.transpose(1, 2) if t_ else q[:, :, None]
        o = flex(q4, kg, vg, score_mod=score_mod, block_mask=block_mask,
                 enable_gqa=True)
        return o.transpose(1, 2) if t_ else o[:, :, 0]
    return run


def kernel_timing(dev, name, *, b, n_tok, hq=32, hkv=8, dh=128, page=16,
                  cache_len=None, copies=1, iters=50, t=None,
                  softcap=0.0) -> dict:
    """Kernel 1 (``t`` None) or kernel 4 (``t`` candidate tokens), its
    plain version and the library yardstick at one shape, bf16: SDPA, or
    with ``softcap`` (q scaled so the cap bites) compiled flex_attention
    (``_flex_softcap``; SDPA has no tanh softcap).  Every row
    holds ``n_tok`` valid tokens: kernel 1's query sits at n_tok - 1;
    kernel 4's base is n_tok - t, so its last candidate sits at n_tok - 1.
    Kernel 4's tables are cut to the power of two of the used pages, as
    the verify R-Part cuts them.  ``copies`` distinct pools are cycled so
    the working set exceeds the 50 MB L2.  Records the split plan the
    kernel used, its CTAs and the CTAs that fit on one SM."""
    import torch
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ref
    bufs, mask, lens_val = _timing_case(
        dev, b=b, n_tok=n_tok, hq=hq, hkv=hkv, dh=dh, page=page,
        cache_len=cache_len, copies=copies, t=t)
    if softcap:
        bufs = [((x[0] * SOFTCAP_Q_SCALE["bfloat16"]).to(x[0].dtype),)
                + tuple(x[1:]) for x in bufs]
    nq = t or 1
    attn = dict(softcap=softcap) if softcap else {}
    library = (_flex_softcap(dev, n_tok=n_tok, t=t, lens_val=lens_val,
                             softcap=softcap) if softcap else _sdpa)

    def kern(i):
        q, pk, pv, tables, lens = bufs[i % copies][:5]
        if t:
            return PA.paged_verify_attention(q, pk, pv, tables, lens, **attn)
        return PA.paged_decode_attention(q, pk, pv, tables, lens, **attn)

    def plain(i):
        q, pk, pv, tables, lens = bufs[i % copies][:5]
        if t:
            return ref.paged_verify_attention_ref(q, pk, pv, tables, lens,
                                                  **attn)
        return ref.paged_decode_attention_ref(q, pk, pv, tables, lens,
                                              **attn)

    def lib(i):
        q, kg, vg = bufs[i % copies][0], bufs[i % copies][5], \
            bufs[i % copies][6]
        return library(q, kg, vg, mask, t)

    q, pk, pv, tables, lens, kg, vg = bufs[0]
    groups = PA.row_groups(nq, hq // hkv)
    got = kern(0)
    err, ok = tol_check(got, plain(0), "bfloat16")
    if not ok:
        raise AssertionError(f"kernel at the {name} shape: max err {err} "
                             f"against the plain version, (atol, rtol) "
                             f"{TOL['bfloat16']}")
    ms = cuda_time_ms(kern, iters)
    plain_ms = cuda_time_ms(plain, max(3, iters // 10), warmup=1)
    # the same calls replayed from a CUDA graph: device time alone
    device_ms = graph_time_ms(kern, copies * max(1, 16 // copies))
    # the library call's first call compiles (flex_attention), outside
    # the timed loops
    lib_err = float((got.float() - lib(0).float()).abs().max())
    library_ms = cuda_time_ms(lib, iters)
    library_device_ms = graph_time_ms(
        lib, copies * max(1, 16 // copies), strict=False)
    pps, n_splits = PA.kernel_plan(q, pk, tables, nq)
    elt = 2
    kv_bytes = 2 * b * n_tok * hkv * dh * elt
    io_bytes = 2 * b * nq * hq * dh * elt + tables.numel() * 4 + b * 4
    bytes_moved = kv_bytes + io_bytes
    # query i attends lens + i + 1 positions
    flops = 4 * b * hq * dh * sum(lens_val + i + 1 for i in range(nq))
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    return {"shape": name, "B": b, "T": nq, "tokens_per_row": n_tok,
            "Hq": hq, "Hkv": hkv, "Dh": dh, "page": page, "softcap": softcap,
            "library": SOFTCAP_LIBRARY if softcap else
            "torch.nn.functional.scaled_dot_product_attention(enable_gqa)",
            "row_groups": groups,
            "table_pages": tables.shape[1], "dtype": "bfloat16",
            "pool_copies": copies, "max_abs_err": err,
            "atol_rtol": TOL["bfloat16"], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_err": lib_err,
            "device_ms": device_ms, "library_device_ms": library_device_ms,
            "split_plan": {"pages_per_split": pps, "num_splits": n_splits},
            "ctas": n_splits * hkv * b * groups,
            "ctas_per_sm": PA.ctas_per_sm(nq, hq, hkv, dh, torch.bfloat16,
                                          pps),
            "merge_launches_per_call": int(n_splits > 1),
            "bytes": bytes_moved, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "achieved_GBps": bytes_moved / (ms * 1e-3) / 1e9}


# kernels 2 and 3: dense slabs with positions, -1 holes and ring order
SLAB_S = 300            # no multiple of any tile of the kernels
SLAB_ROWS = [("prefix", 257, (3, 100, 200)), ("ring", 400, 700),
             ("prefix", 5, ()), ("empty",)]
SLAB_LENGTHS = [256, 699, 4, 9]     # row 3 has no valid slot: output 0


def _slab_pos(s, layout):
    """pos [S] int32 of one row: ("prefix", n, holes) holds positions
    0..n-1 in slots 0..n-1 with -1 at ``holes``; ("ring", lo, hi) holds
    positions lo..hi-1 at slot pos % S (a wrapped ring); ("empty",) has
    no valid slot."""
    import torch
    pos = torch.full((s,), -1, dtype=torch.int32)
    if layout[0] == "prefix":
        pos[:layout[1]] = torch.arange(layout[1], dtype=torch.int32)
        pos[list(layout[2])] = -1
    elif layout[0] == "ring":
        p = torch.arange(layout[1], layout[2], dtype=torch.int32)
        pos[p.long() % s] = p
    return pos


# long slabs that span many splits of the kernels' split plan: holes every
# 97 slots, a full ring under window + sink, a short row (its later splits
# hold no valid slot), a row with no valid slot (exactly 0), a full row
# and a half-wrapped ring
LONG_SLAB_S = 4096
LONG_SLAB_ROWS = [("prefix", 3000, tuple(range(5, 3000, 97))),
                  ("ring", 5000, 9096), ("prefix", 17, ()), ("empty",),
                  ("prefix", 4096, ()), ("ring", 3000, 6000)]
LONG_SLAB_LENGTHS = [2999, 9095, 16, 5, 4095, 5999]


def _check_case(kernel, name, dtype_name, got, want, *, empty_row,
                again=None, plan=None):
    """One kernel case against its plain version: the tolerance, the
    output dtype, the row with no valid key exactly 0 and, when
    ``again`` (a second launch) is given, a bitwise repeat."""
    import torch
    torch.cuda.synchronize()
    err, ok = tol_check(got, want, dtype_name)
    ok = ok and got.dtype == getattr(torch, dtype_name) \
        and bool((got[empty_row] == 0).all())
    rec = {"case": name, "max_abs_err": err, "atol_rtol": TOL[dtype_name]}
    if plan is not None:
        rec["split_plan"] = plan
    if again is not None:
        rec["bitwise_repeat"] = bool(torch.equal(got, again))
        ok = ok and rec["bitwise_repeat"]
    rec["ok"] = ok
    if not ok:
        raise AssertionError(
            f"{kernel} case {name} failed: err {err} (atol, rtol) "
            f"{TOL[dtype_name]} (the row with no valid key must be exactly "
            f"0, dtype {got.dtype}; a long case must repeat bitwise): {rec}")
    return rec


def slab_checks(dev) -> dict:
    """Kernels 2 and 3 against their plain versions: G 1 and 4, Dh 64 and
    128, ragged rows, -1 holes, a ring-ordered row under window + sink,
    softcap, S = 300, and one row with no valid slot (exactly 0); then
    long slabs (S = 4096, ``LONG_SLAB_ROWS``) over many splits, with
    window + sink (the middle splits of a ring empty), softcap and Dh 64,
    each repeated bitwise; G 7 and 8 at Dh 128 too.  For kernel 3 with a
    bf16 q the plain version runs on q.float(), so the dequantized K/V stay
    fp32 there as in the kernel.  Kernel 2 with a bf16 q is repeated
    bitwise in every case and, on tc_decode.cuh's tensor-core engine (G 2
    and up), also held to its order of operations (``ref.bf16_mma_slab_ref``
    at the call's split plan, ``MODEL_TOL``)."""
    import torch
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import quant_kv as QK
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(3)
    out = {"decode_attention": [], "decode_attention_int8": []}
    for long in (False, True):
        s = LONG_SLAB_S if long else SLAB_S
        rows = LONG_SLAB_ROWS if long else SLAB_ROWS
        pos = torch.stack([_slab_pos(s, r) for r in rows]).to(dev)
        lens = torch.tensor(LONG_SLAB_LENGTHS if long else SLAB_LENGTHS,
                            dtype=torch.int32, device=dev)
        empty = rows.index(("empty",))
        b = len(rows)
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            if long:
                cases = [(g, 128, a) for g in (1, 4)
                         for a in ({}, dict(window=256, sink=16),
                                   dict(softcap=5.0))]
                cases.append((8, 64, dict(window=256, sink=16)))
            else:
                cases = [(g, dh, {}) for g in (1, 4) for dh in (64, 128)]
                cases += [(4, 128, dict(window=64, sink=4)),
                          (1, 64, dict(softcap=5.0)), (7, 128, {}),
                          (8, 128, {})]
            for g, dh, attn in cases:
                hkv = 2
                q = torch.randn((b, hkv * g, dh), generator=gen).to(dev)
                k = torch.randn((b, s, hkv, dh), generator=gen).to(dev)
                v = torch.randn((b, s, hkv, dh), generator=gen).to(dev)
                kq, ks = QK.quantize_kv(k)
                vq, vs = QK.quantize_kv(v)
                q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
                name = f"{dtype_name}-{'long-' if long else ''}G{g}-dh{dh}" \
                    + "".join(f"-{a}{b}" for a, b in attn.items())
                plan = DA.kernel_plan(q, k)

                def k2():
                    return DA.decode_attention(q, k, v, pos, lens, **attn)

                def k3():
                    return QK.decode_attention_int8(q, kq, ks, vq, vs, pos,
                                                    lens, **attn)
                bf16 = dtype == torch.bfloat16
                got = k2()
                rec = _check_case(
                    "decode_attention", name, dtype_name, got,
                    ref.decode_attention_ref(q, k, v, pos, lens, **attn),
                    empty_row=empty, again=k2() if long or bf16 else None,
                    plan=plan)
                if _k2_on_tensor_cores(q, k, plan):
                    rec.update(_model_check(
                        name, got, ref.bf16_mma_slab_ref(
                            q, k, v, pos, lens, slots_per_split=plan[0],
                            **attn),
                        "kernel 2's tensor-core engine "
                        "(ref.bf16_mma_slab_ref)"))
                out["decode_attention"].append(rec)
                out["decode_attention_int8"].append(_check_case(
                    "decode_attention_int8", name, dtype_name, k3(),
                    ref.decode_attention_int8_ref(q.float(), kq, ks, vq, vs,
                                                  pos, lens, **attn),
                    empty_row=empty, again=k3() if long else None,
                    plan=QK.slab_plan(q, kq)))
                del k, v, kq, vq
    return {k: {"cases": v, "max_abs_err": max(c["max_abs_err"] for c in v)}
            for k, v in out.items()}


# recurrentgemma-2b's windowed MQA layers: Hq 10 / Hkv 1 (G 10: one CTA
# of the 16-row tensor-core engine with a bf16 q, two row groups of 8 and 2
# on the CUDA cores with an fp32 q), Dh 256, window 2048, ring-ordered slabs
# of S = min(cache_len, window) slots
HYBRID_HEADS = dict(hq=10, hkv=1, dh=256)
HYBRID_WINDOW = 2048
# (name, S, rows, lengths, window): a ring wrapped past its size twice
# (every slot valid, the window the ring's), the same ring under a window
# of 512 (three quarters masked), the serve's S = 1024 < window wrapped
# once, and ragged rows: a prefix, a short row, a stale slot past its
# length, a row with no valid slot (exactly 0)
DH256_CASES = [
    ("ring-S2048", 2048, [("ring", 1000, 3048), ("ring", 2500, 4548),
                          ("prefix", 700, (3, 99)), ("empty",)],
     [3047, 4547, 699, 9], HYBRID_WINDOW),
    ("ring-window512", 2048, [("ring", 1000, 3048), ("ring", 2500, 4548),
                              ("prefix", 5, ()), ("empty",)],
     [3047, 4547, 4, 9], 512),
    ("serve-S1024", 1024, [("ring", 300, 1324), ("prefix", 600, ()),
                           ("prefix", 17, (16,)), ("empty",)],
     [1323, 598, 15, 3], HYBRID_WINDOW),
]


def _slab_fp64(q, k, v, pos, lengths, window):
    """Dense-slab attention in fp64: q [B,Hq,Dh] at position lengths[b],
    k, v [B,S,Hkv,Dh] (already dequantized), validity from pos (mapped,
    <= lengths, inside the window); a row with no valid slot gives 0."""
    import math
    import torch
    f64 = torch.float64
    b, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.to(f64).reshape(b, hkv, hq // hkv, dh) / math.sqrt(dh)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.to(f64))
    ln = lengths.long()[:, None]
    ok = (pos >= 0) & (pos <= ln)
    if window > 0:
        ok &= pos > ln - window
    s = torch.where(ok[:, None, None, :], s,
                    torch.tensor(float("-inf"), dtype=f64, device=q.device))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    return torch.einsum("bhgs,bshd->bhgd", p, v.to(f64)).reshape(b, hq, dh)


# a tensor-core engine (bf16 q) against a plain model of its order of
# operations in fp32, run on the CPU (``ref.int8_mma16_attention_ref`` for
# kernel 3's 16-row engine; ``ref.bf16_mma_paged_ref`` and
# ``ref.bf16_mma_slab_ref`` for kernels 1 and 2 on tc_decode.cuh's engine,
# whose sums and exponentials are fp64 rounded to fp32, the same on every
# host): the two differ by fp32 summation order and the kernel's bf16
# store (at most half a bf16 ulp, 2^-8 of the value), so the bound is
# 2^-8 of the value plus 1e-5, tighter than the bf16 tolerance against the
# plain version (TOL)
MODEL_TOL = (1e-5, 2.0 ** -8)


def _k2_on_tensor_cores(q, k, plan) -> bool:
    """Whether this kernel-2 call runs on tc_decode.cuh's tensor-core
    engine (the C side's choice: 8 rows per CTA with a bf16 q, G 2 and up;
    G 1 and an fp32 q run on the CUDA cores)."""
    import torch
    from repro_torch.kernels import decode_attention as DA
    if q.dtype != torch.bfloat16:
        return False
    rows, _ = DA.occupancy(kv_int8=False, paged=False, t=1, hq=q.shape[1],
                           hkv=k.shape[2], dh=q.shape[2], dtype=q.dtype,
                           per_split=plan[0])
    return rows == 8


def _model_check(name, got, model, engine) -> dict:
    """``got`` (a kernel's bf16 output) against ``model`` (fp32 on the
    CPU, the same shape) within ``MODEL_TOL``."""
    import torch
    atol, rtol = MODEL_TOL
    g = got.float().cpu()
    d = (g - model).abs()
    over = d - (atol + rtol * model.abs())
    rec = {"model_max_abs_err": float(d.max()), "model_atol_rtol": MODEL_TOL}
    if bool((over > 0).any()):
        i = int(torch.argmax(over))
        rec["worst"] = {
            "index": [int(x) for x in torch.unravel_index(torch.tensor(i),
                                                          d.shape)],
            "got": float(g.flatten()[i]), "model": float(model.flatten()[i]),
            "elements_over": int((over > 0).sum())}
        raise AssertionError(f"{name}: {engine} departs from its order of "
                             f"operations: {rec}")
    return rec


def _mma16_model_check(name, got, q, kq, ks, vq, vs, kpos, qpos, *,
                       slots_per_split, **attn) -> dict:
    """One 16-row engine output (``got`` [B,T,Hq,Dh] bf16) against the
    model on the same inputs (q [B,T,Hq,Dh]; the slab, or a page pool
    gathered by ``ref.paged_gather``; kpos [B,S]; qpos [B,T]) at the
    call's split size, within ``MODEL_TOL``."""
    from repro_torch.kernels import ref
    model = ref.int8_mma16_attention_ref(
        *(x.cpu() for x in (q, kq, ks, vq, vs, kpos, qpos)),
        slots_per_split=slots_per_split, **attn)
    return _model_check(name, got, model, "the 16-row engine "
                        "(ref.int8_mma16_attention_ref)")


def dh256_checks(dev) -> dict:
    """Kernel 3's slab entry at the hybrid's heads (``HYBRID_HEADS``) on
    ``DH256_CASES``: bf16 q against the plain version on q.float() (the
    kernel keeps the dequantized K/V in fp32), fp32 q against the plain
    version and against fp64 (it passes when |kernel - fp64| <= atol +
    |plain - fp64|, what |kernel - plain| <= atol implies, as the
    saturated fp32 cases of the paged kernels), each repeated bitwise;
    the row with no valid slot exactly 0; with a bf16 q (the 16-row
    engine) also against its order of operations (``_mma16_model_check``)."""
    import torch
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import quant_kv as QK
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(23)
    hq, hkv, dh = (HYBRID_HEADS[k] for k in ("hq", "hkv", "dh"))
    results = []
    for name, s, rows, lengths, window in DH256_CASES:
        pos = torch.stack([_slab_pos(s, r) for r in rows]).to(dev)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        b = len(rows)
        k = torch.randn((b, s, hkv, dh), generator=gen).to(dev)
        v = torch.randn((b, s, hkv, dh), generator=gen).to(dev)
        kq, ks = QK.quantize_kv(k)
        vq, vs = QK.quantize_kv(v)
        del k, v
        for dtype_name in ("bfloat16", "float32"):
            q = torch.randn((b, hq, dh), generator=gen).to(dev).to(
                getattr(torch, dtype_name))
            args = (q, kq, ks, vq, vs, pos, lens)
            got = QK.decode_attention_int8(*args, window=window)
            again = QK.decode_attention_int8(*args, window=window)
            plain = ref.decode_attention_int8_ref(q.float(), *args[1:],
                                                  window=window)
            rec = _check_case("decode_attention_int8",
                              f"{dtype_name}-dh256-G10-{name}", dtype_name,
                              got, plain, empty_row=rows.index(("empty",)),
                              again=again, plan=QK.slab_plan(q, kq))
            rec.update(S=s, window=window, lengths=lengths)
            if dtype_name == "bfloat16":
                rec.update(_mma16_model_check(
                    rec["case"], got[:, None], q[:, None], kq, ks, vq, vs,
                    pos, lens[:, None], slots_per_split=rec["split_plan"][0],
                    window=window))
            if dtype_name == "float32":
                want = _slab_fp64(q, QK.dequantize_kv(kq, ks),
                                  QK.dequantize_kv(vq, vs), pos, lens,
                                  window)
                d_plain = float((plain.double() - want).abs().max())
                d_kern = float((got.double() - want).abs().max())
                rec.update(kernel_vs_fp64=d_kern, plain_vs_fp64=d_plain,
                           tol_vs_fp64=TOL["float32"][0] + d_plain,
                           fp64_ok=d_kern <= TOL["float32"][0] + d_plain)
                if not rec["fp64_ok"]:
                    raise AssertionError(f"kernel 3 at Dh 256 is further "
                                         f"from fp64 than the plain "
                                         f"version allows: {rec}")
            # the C side's rows per CTA: with a bf16 q all 10 heads in one
            # CTA, so the grid is B * splits CTAs (not 2 * B * splits)
            sps, n_splits = rec["split_plan"]
            per_cta, per_sm = DA.occupancy(kv_int8=True, paged=False, t=1,
                                           hq=hq, hkv=hkv, dh=dh,
                                           dtype=q.dtype, per_split=sps)
            groups = -(-(hq // hkv) // per_cta)
            rec.update(rows_per_cta=per_cta, ctas_per_sm=per_sm,
                       ctas=n_splits * hkv * b * groups)
            if groups != QK.slab_row_groups(hq // hkv, dh, q.dtype) or (
                    dtype_name == "bfloat16" and rec["ctas"] != b * n_splits):
                raise AssertionError(f"kernel 3 at Dh 256 launches {groups} "
                                     f"row groups of {per_cta}: {rec}")
            results.append(rec)
    # a head dim or layout the entry does not take raises, with no
    # fallback to the plain version
    refused = []
    for bad_dh in (96, 512):
        q = torch.zeros((1, 10, bad_dh), dtype=torch.bfloat16, device=dev)
        kq = torch.zeros((1, 64, 1, bad_dh), dtype=torch.int8, device=dev)
        sc = torch.ones((1, 64, 1), device=dev)
        pos = torch.zeros((1, 64), dtype=torch.int32, device=dev)
        ln = torch.zeros((1,), dtype=torch.int32, device=dev)
        try:
            QK.decode_attention_int8(q, kq, sc, kq, sc, pos, ln)
        except ValueError as e:
            refused.append({"Dh": bad_dh, "error": str(e)})
        else:
            raise AssertionError(f"kernel 3 took Dh {bad_dh}")
    return {"cases": results, "refused": refused,
            "max_abs_err": max(r["max_abs_err"] for r in results)}


# the cross-attention R-Part's slabs: whisper-medium's decoder (MHA, Dh 64,
# 1500 encoder frames) and llama-3.2-vision-90b's XATTN layers (G 8, Dh
# 128, 1600 patches)
CROSS_HEADS = {"whisper": dict(hq=16, hkv=16, dh=64, s=1500),
               "vision": dict(hq=64, hkv=8, dh=128, s=1600)}


def cross_checks(dev) -> dict:
    """Kernel 2 as the cross-attention R-Part (``decompose.
    r_cross_attention``: every slot at position 0, window and softcap 0)
    at ``CROSS_HEADS``, 2 rows (one R-worker call of the static runs) and
    64, against its plain version: bf16 q within one rounding step and, on
    the tensor-core engine (vision's G 8; whisper's G 1 runs on the CUDA
    cores), against its order of operations (``ref.bf16_mma_slab_ref``,
    ``MODEL_TOL``), fp32 q within 1e-5 and against fp64 (it passes when
    |kernel - fp64| <= atol + |plain - fp64|), each repeated bitwise."""
    import torch
    from repro_torch.core import decompose as D
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(29)
    results = []
    for shape, h in CROSS_HEADS.items():
        hq, hkv, dh, s = h["hq"], h["hkv"], h["dh"], h["s"]
        for b in (2, 64):
            pos = D.cross_pos(b, s, dev)
            lens = torch.randint(0, 1024, (b,), generator=gen, device=dev,
                                 dtype=torch.int32)
            k32 = torch.randn((b, s, hkv, dh), generator=gen, device=dev)
            v32 = torch.randn((b, s, hkv, dh), generator=gen, device=dev)
            q32 = torch.randn((b, hq, dh), generator=gen, device=dev)
            for dtype_name in ("bfloat16", "float32"):
                dt = getattr(torch, dtype_name)
                q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
                got = DA.decode_attention(q, k, v, pos, lens)
                plain = ref.decode_attention_ref(q, k, v, pos, lens)
                rec = _check_case(
                    "decode_attention", f"{dtype_name}-cross-{shape}-B{b}",
                    dtype_name, got, plain, empty_row=[],
                    again=DA.decode_attention(q, k, v, pos, lens),
                    plan=DA.kernel_plan(q, k))
                rec.update(B=b, S=s, Hq=hq, Hkv=hkv, Dh=dh)
                if _k2_on_tensor_cores(q, k, rec["split_plan"]):
                    rec.update(_model_check(
                        rec["case"], got, ref.bf16_mma_slab_ref(
                            q, k, v, pos, lens,
                            slots_per_split=rec["split_plan"][0]),
                        "kernel 2's tensor-core engine "
                        "(ref.bf16_mma_slab_ref)"))
                if dtype_name == "float32":
                    want = _slab_fp64(q, k, v, pos, lens, 0)
                    d_plain = float((plain.double() - want).abs().max())
                    d_kern = float((got.double() - want).abs().max())
                    rec.update(kernel_vs_fp64=d_kern, plain_vs_fp64=d_plain,
                               fp64_ok=d_kern <= TOL["float32"][0] + d_plain)
                    if not rec["fp64_ok"]:
                        raise AssertionError(f"kernel 2 at the cross shape "
                                             f"is further from fp64 than "
                                             f"the plain version allows: "
                                             f"{rec}")
                results.append(rec)
                del q, k, v
    return {"cases": results,
            "max_abs_err": max(r["max_abs_err"] for r in results)}


def paged_int8_checks(dev) -> dict:
    """Kernel 3's paged addressing against ``ref.paged_decode_attention_
    int8_ref`` (the gather chain, on q.float() for a bf16 q) on the tables
    kernel 1's cases use: G 1, 4, 7 and 8, page 4 and 16, ragged rows, a -1
    hole, a shared page and an all-unmapped row (exactly 0); window +
    sink and softcap; and the long multi-split tables of ``long_cases``
    (4096 positions, empty splits past short rows and between sink and
    window), each repeated bitwise.  bf16 and fp32 q."""
    import torch
    from repro_torch.kernels import quant_kv as QK
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(6)
    cases = []
    for g, hkv in G_HKV.items():
        for page in (4, 16):
            cases.append(dict(
                name=f"G{g}-page{page}",
                kw=dict(b=5, hq=hkv * g, hkv=hkv, dh=128, page=page,
                        mp=-(-80 // page), lengths=[37, 5, 0, 63, 20],
                        unmapped_row=2, hole=(3, 1), share=(0, 4)),
                attn=dict()))
    cases.append(dict(name="window-sink", kw=dict(
        b=3, hq=8, hkv=2, dh=128, page=16, mp=8, lengths=[100, 17, 64]),
        attn=dict(window=24, sink=4)))
    cases.append(dict(name="softcap-dh64", kw=dict(
        b=3, hq=12, hkv=4, dh=64, page=4, mp=16, lengths=[50, 3, 61]),
        attn=dict(softcap=5.0)))
    # llama-3.2-vision-90b's heads (Hq 64 / Hkv 8: G 8 over 8 kv-heads),
    # which static_vision's quantized_kv run gives this entry
    cases.append(dict(name="vision-heads-G8", kw=dict(
        b=4, hq=64, hkv=8, dh=128, page=16, mp=40,
        lengths=[600, 17, 0, 333], unmapped_row=2), attn=dict()))
    cases += [dict(c, name=c["name"].split("-T1-")[1])
              for c in long_cases("float32", t=1)]
    results = []
    for dtype_name in ("bfloat16", "float32"):
        for c in cases:
            q, pk, pv, tables, lens = _paged_case(
                gen, dtype=torch.float32, dev=dev, **c["kw"])
            pkq, pks = QK.quantize_kv(pk)
            pvq, pvs = QK.quantize_kv(pv)
            q = q.to(getattr(torch, dtype_name))
            args = (q, pkq, pks, pvq, pvs, tables, lens)
            got = QK.paged_decode_attention_int8(*args, **c["attn"])
            again = (QK.paged_decode_attention_int8(*args, **c["attn"])
                     if c.get("long") else None)
            want = ref.paged_decode_attention_int8_ref(
                q.float(), *args[1:], **c["attn"])
            un = c["kw"].get("unmapped_row")
            rec = _check_case("paged_decode_attention_int8",
                              f"{dtype_name}-{c['name']}", dtype_name, got,
                              want, empty_row=un if un is not None else [],
                              again=again,
                              plan=QK.paged_plan(q, pkq, tables))
            results.append(rec)
    return {"cases": results,
            "max_abs_err": max(r["max_abs_err"] for r in results)}


def _slab_inputs(dev, *, b, s, n_valid, hq, hkv, dh, copies, cross=False):
    """``copies`` bf16 slabs (and their int8 quantization) whose rows hold
    ``n_valid`` tokens in slots 0..n_valid-1 (lengths = n_valid - 1), the
    SDPA yardsticks' K/V already laid out per head (bf16, and the
    dequantized int8 in bf16; neither the layout nor the dequantization
    is in their time), pos and lengths.  ``cross``: the cross-attention
    R-Part's layout, every slot at position 0 (``decompose.cross_pos``)."""
    import torch
    from repro_torch.kernels import quant_kv as QK
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(2)
    pos = torch.full((b, s), -1, dtype=torch.int32, device=dev)
    pos[:, :n_valid] = torch.arange(n_valid, dtype=torch.int32, device=dev)
    if cross:
        pos.zero_()
    lens = torch.full((b,), n_valid - 1, dtype=torch.int32, device=dev)

    def heads_first(x):          # [B,S,H,Dh] valid part -> [B,H,n,Dh]
        return x[:, :n_valid].permute(0, 2, 1, 3).contiguous()

    bufs = []
    for _ in range(copies):
        q = torch.randn((b, hq, dh), generator=gen, device=dev).to(bf)
        k = torch.randn((b, s, hkv, dh), generator=gen, device=dev)
        v = torch.randn((b, s, hkv, dh), generator=gen, device=dev)
        kq, ks = QK.quantize_kv(k)
        vq, vs = QK.quantize_kv(v)
        k, v = k.to(bf), v.to(bf)
        bufs.append(dict(
            q=q, k=k, v=v, kq=kq, ks=ks, vq=vq, vs=vs,
            kl=heads_first(k), vl=heads_first(v),
            kd=heads_first(QK.dequantize_kv(kq, ks).to(bf)),
            vd=heads_first(QK.dequantize_kv(vq, vs).to(bf))))
        del k, v
    return bufs, pos, lens


def _sdpa_decode(q, kk, vv):
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q[:, :, None], kk, vv,
                                          enable_gqa=True)[:, :, 0]


def _slab_runs(pos, lens):
    """Kernels 2 and 3 on a buffer of ``_slab_inputs``: the kernel, its
    plain version, the reference it is checked against, SDPA."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import quant_kv as QK
    from repro_torch.kernels import ref
    return {
        "decode_attention": dict(
            kern=lambda t: DA.decode_attention(t["q"], t["k"], t["v"], pos,
                                               lens),
            plain=lambda t: ref.decode_attention_ref(t["q"], t["k"], t["v"],
                                                     pos, lens),
            check=lambda t: ref.decode_attention_ref(t["q"], t["k"], t["v"],
                                                     pos, lens),
            lib=lambda t: _sdpa_decode(t["q"], t["kl"], t["vl"])),
        "decode_attention_int8": dict(
            kern=lambda t: QK.decode_attention_int8(
                t["q"], t["kq"], t["ks"], t["vq"], t["vs"], pos, lens),
            plain=lambda t: ref.decode_attention_int8_ref(
                t["q"], t["kq"], t["ks"], t["vq"], t["vs"], pos, lens),
            check=lambda t: ref.decode_attention_int8_ref(
                t["q"].float(), t["kq"], t["ks"], t["vq"], t["vs"], pos,
                lens),
            lib=lambda t: _sdpa_decode(t["q"], t["kd"], t["vd"]))}


def slab_timing(dev, name, *, b, s, n_valid, hq=32, hkv=8, dh=128,
                copies=1, iters=50,
                kernels=("decode_attention", "decode_attention_int8"),
                cross=False) -> dict:
    """Kernels 2 and 3 (or those of ``kernels``), their plain versions
    and the SDPA yardstick at one shape, bf16 q: host-loop ms from CUDA
    events, device ms from the same calls replayed from a CUDA graph, the
    split plan, CTAs (the rows per CTA and CTAs per SM of the C side's
    instantiation) and merge launches per call.  ``copies`` distinct
    slabs are cycled so the working set exceeds the 50 MB L2; ``cross``
    as ``_slab_inputs``'s."""
    import torch
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import quant_kv as QK
    bufs, pos, lens = _slab_inputs(dev, b=b, s=s, n_valid=n_valid, hq=hq,
                                   hkv=hkv, dh=dh, copies=copies,
                                   cross=cross)
    kv_bytes_per_tok = {"decode_attention": 2 * hkv * dh * 2,
                        "decode_attention_int8": 2 * hkv * (dh + 4)}
    calls = copies * max(1, 16 // copies)

    def measure(kernel, r):
        got = r["kern"](bufs[0])
        err, ok = tol_check(got, r["check"](bufs[0]), "bfloat16")
        if not ok:
            raise AssertionError(f"{kernel} at the {name} shape: max err "
                                 f"{err} against the plain version, "
                                 f"(atol, rtol) {TOL['bfloat16']}")
        lib_err = float((got.float() - r["lib"](bufs[0]).float()).abs().max())
        kern = lambda i: r["kern"](bufs[i % copies])      # noqa: E731
        lib = lambda i: r["lib"](bufs[i % copies])        # noqa: E731
        ms = cuda_time_ms(kern, iters)
        plain_ms = cuda_time_ms(lambda i: r["plain"](bufs[i % copies]),
                                max(3, iters // 10), warmup=1)
        library_ms = cuda_time_ms(lib, iters)
        device_ms = graph_time_ms(kern, calls)
        library_device_ms = graph_time_ms(lib, calls, strict=False)
        int8 = kernel == "decode_attention_int8"
        if int8:
            sps, n_splits = QK.slab_plan(bufs[0]["q"], bufs[0]["kq"])
            groups = QK.slab_row_groups(hq // hkv, dh, torch.bfloat16)
        else:
            sps, n_splits = DA.kernel_plan(bufs[0]["q"], bufs[0]["k"])
            groups = PA.row_groups(1, hq // hkv)
        rows, per_sm = DA.occupancy(kv_int8=int8, paged=False, t=1, hq=hq,
                                    hkv=hkv, dh=dh, dtype=torch.bfloat16,
                                    per_split=sps)
        if groups != -(-(hq // hkv) // rows):
            raise AssertionError(f"{kernel}: the wrapper's {groups} row "
                                 f"groups are not the C side's (rows of "
                                 f"{rows})")
        bytes_moved = (b * n_valid * kv_bytes_per_tok[kernel] + b * s * 4
                       + 2 * b * hq * dh * 2 + b * 4)
        flops = 4 * b * n_valid * hq * dh
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        return {
            "shape": name, "B": b, "S": s, "tokens_per_row": n_valid,
            "pos": "all 0 (cross-attention)" if cross else "0..n-1",
            "Hq": hq, "Hkv": hkv, "Dh": dh, "q_dtype": "bfloat16",
            "slab_copies": copies, "max_abs_err": err,
            "atol_rtol": TOL["bfloat16"], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_err": lib_err,
            "device_ms": device_ms, "library_device_ms": library_device_ms,
            "split_plan": {"slots_per_split": sps, "num_splits": n_splits},
            "ctas": n_splits * hkv * b * groups, "rows_per_cta": rows,
            "ctas_per_sm": per_sm,
            "merge_launches_per_call": int(n_splits > 1),
            "bytes": bytes_moved, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "achieved_GBps": bytes_moved / (ms * 1e-3) / 1e9,
            "achieved_GBps_device": bytes_moved / (device_ms * 1e-3) / 1e9}

    return {kernel: measure(kernel, r)
            for kernel, r in _slab_runs(pos, lens).items()
            if kernel in kernels}


def gather_timing(dev, *, b=2, n_tok=512, cache_len=1024, hq=32, hkv=8,
                  dh=128, page=16, copies=16, iters=200) -> dict:
    """The paged-int8 op at the serve's per-worker shape on ``copies``
    pools cycled past the L2: the one-call op (kernel 3's paged entry)
    against the chain it replaced (the gather of the four int8 pool
    arrays into a slab, then kernel 3 on the slab), and kernel 3 alone on
    the gathered slab; host-loop ms and CUDA-graph device ms of each."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_kv as QK
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(4)
    mp = cache_len // page
    per_row = -(-n_tok // page)
    n_pages = b * mp + 1
    bufs = []
    for _ in range(copies):
        pool = {}
        for name in ("k", "v"):
            x = torch.randn((n_pages, page, hkv, dh), generator=gen,
                            device=dev)
            pool[f"{name}_q"], pool[f"{name}_s"] = ops.quantize_kv(x)
        ids = torch.randperm(b * mp, generator=gen, device=dev)
        tables = torch.full((b, mp), -1, dtype=torch.int32, device=dev)
        tables[:, :per_row] = ids[:b * per_row].reshape(b, per_row).to(
            torch.int32)
        q = torch.randn((b, hq, dh), generator=gen,
                        device=dev).to(torch.bfloat16)
        slab = [ref.paged_gather(pool[n], tables)
                for n in ("k_q", "k_s", "v_q", "v_s")]
        bufs.append((q, pool, tables, slab))
    lens = torch.full((b,), n_tok - 1, dtype=torch.int32, device=dev)

    def gather(i):
        _, pool, tables, _ = bufs[i % copies]
        return [ref.paged_gather(pool[n], tables)
                for n in ("k_q", "k_s", "v_q", "v_s")]

    def chain(i):
        q = bufs[i % copies][0]
        (kq, pos), (ks, _), (vq, _), (vs, _) = gather(i)
        return QK.decode_attention_int8(q, kq, ks, vq, vs, pos, lens)

    def slab_kernel(i):
        q, _, _, slab = bufs[i % copies]
        (kq, pos), (ks, _), (vq, _), (vs, _) = slab
        return QK.decode_attention_int8(q, kq, ks, vq, vs, pos, lens)

    def op(i):
        q, pool, tables, _ = bufs[i % copies]
        return ops.paged_decode_attention_int8(
            q, pool["k_q"], pool["k_s"], pool["v_q"], pool["v_s"], tables,
            lens)

    err, ok = tol_check(op(0), chain(0), "bfloat16")
    if not ok:
        raise AssertionError(f"the paged-int8 op differs from gather + "
                             f"kernel 3 by {err}")
    # the gather reads and writes every table entry's page (unmapped
    # entries read page 0), plus the derived positions
    slab = b * mp * page
    gather_bytes = 2 * slab * hkv * (2 * dh + 2 * 4) + 4 * slab * 4
    # the op reads the valid rows' int8 K/V and scales once
    op_bytes = (2 * b * n_tok * hkv * (dh + 4) + tables.numel() * 4
                + 2 * b * hq * dh * 2 + b * 4)
    calls = 16
    q, pool, tables, _ = bufs[0]
    rec = {"shape": "serve-int8", "B": b, "tokens_per_row": n_tok,
           "cache_len": cache_len, "page": page, "pool_copies": copies,
           "max_abs_err_vs_chain": err,
           "split_plan": QK.paged_plan(q, pool["k_q"], tables),
           "gather_bytes": gather_bytes,
           "gather_bound_ms": gather_bytes / HBM_BYTES_PER_S * 1e3,
           "op_bytes": op_bytes,
           "op_bound_ms": op_bytes / HBM_BYTES_PER_S * 1e3}
    for key, fn in (("gather", gather), ("chain", chain),
                    ("slab_kernel", slab_kernel), ("op", op)):
        rec[f"{key}_ms"] = cuda_time_ms(fn, iters)
        rec[f"{key}_device_ms"] = graph_time_ms(fn, calls)
    rec["op_device_over_slab_kernel"] = (rec["op_device_ms"]
                                         / rec["slab_kernel_device_ms"])
    return rec


def verify_int8_checks(dev) -> dict:
    """Kernel 3's multi-token paged entry (the int8 verify) against
    ``ref.paged_verify_attention_int8_ref`` (the gather chain, on q.float()
    for a bf16 q: the kernel keeps the dequantized K/V in fp32): bf16 and
    fp32 q; GQA 4, 7 and 8; page 4 and 16; T 1, 2, 4 and 8 candidate tokens;
    ragged rows, a -1 hole, a shared page and an all-unmapped row (no
    valid key: exactly 0); window + sink and softcap; the long multi-split
    tables of ``long_cases``, each repeated bitwise; and T = 1 against
    the decode entry on the same inputs, which must be bitwise equal (the
    same instantiation and split plan); the cases on the 16-row engine
    (bf16 q, T > 1, T·G > 8) also against its order of operations
    (``_mma16_model_check``)."""
    import torch
    from repro_torch.kernels import quant_kv as QK
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(7)
    cases = []
    for t in (1, 2, 4, 8):
        for g in (4, 7, 8):
            for page in (4, 16):
                cases.append(dict(
                    name=f"T{t}-G{g}-page{page}", t=t,
                    kw=dict(b=5, hq=2 * g, hkv=2, dh=128, page=page,
                            mp=-(-84 // page), lengths=[37, 5, 0, 63, 20],
                            unmapped_row=2, hole=(3, 1), share=(0, 4)),
                    attn=dict()))
    for t in (1, 4):
        cases.append(dict(
            name=f"T{t}-window-sink", t=t,
            kw=dict(b=3, hq=8, hkv=2, dh=128, page=16, mp=8,
                    lengths=[100, 17, 64], unmapped_row=None),
            attn=dict(window=24, sink=4)))
        cases.append(dict(
            name=f"T{t}-softcap-dh64", t=t,
            kw=dict(b=3, hq=16, hkv=4, dh=64, page=4, mp=18,
                    lengths=[50, 3, 61], unmapped_row=None),
            attn=dict(softcap=5.0)))
        cases += [dict(c, name=c["name"].split("-", 1)[1])
                  for c in long_cases("float32", t=t)]
    results, t1_equal = [], []
    for dtype_name in ("bfloat16", "float32"):
        for c in cases:
            t = c["t"]
            kw = dict(c["kw"])
            # the pages hold the last candidate: position base + t - 1
            kw["lengths"] = [n + t - 1 for n in kw["lengths"]]
            _, pk, pv, tables, lens = _paged_case(
                gen, dtype=torch.float32, dev=dev, **kw)
            base = (lens - (t - 1)).contiguous()
            q = torch.randn((kw["b"], t, kw["hq"], kw["dh"]),
                            generator=gen).to(dev).to(getattr(torch,
                                                              dtype_name))
            pkq, pks = QK.quantize_kv(pk)
            pvq, pvs = QK.quantize_kv(pv)
            args = (q, pkq, pks, pvq, pvs, tables, base)
            got = QK.paged_verify_attention_int8(*args, **c["attn"])
            again = (QK.paged_verify_attention_int8(*args, **c["attn"])
                     if c.get("long") else None)
            want = ref.paged_verify_attention_int8_ref(q.float(), *args[1:],
                                                       **c["attn"])
            un = kw.get("unmapped_row")
            rec = _check_case("verify_int8", f"{dtype_name}-{c['name']}",
                              dtype_name, got, want,
                              empty_row=un if un is not None else [],
                              again=again, plan=QK.paged_plan(q, pkq, tables))
            g = kw["hq"] // kw["hkv"]
            if dtype_name == "bfloat16" and t > 1 and t * g > 8:
                gathered = [ref.paged_gather(x, tables)
                            for x in (pkq, pks, pvq, pvs)]
                qpos = base[:, None] + torch.arange(
                    t, dtype=torch.int32, device=dev)[None, :]
                rec.update(_mma16_model_check(
                    rec["case"], got, q, *(x for x, _ in gathered),
                    gathered[0][1], qpos,
                    slots_per_split=rec["split_plan"][0] * kw["page"],
                    **c["attn"]))
            if t == 1:
                dec = QK.paged_decode_attention_int8(q[:, 0].contiguous(),
                                                     *args[1:], **c["attn"])
                torch.cuda.synchronize()
                rec["equal_to_decode_entry"] = bool(torch.equal(got[:, 0],
                                                                dec))
                t1_equal.append(rec["equal_to_decode_entry"])
                if not rec["equal_to_decode_entry"]:
                    raise AssertionError(f"verify_int8 at T = 1 differs from "
                                         f"the decode entry: {rec}")
            results.append(rec)
    return {"cases": results,
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "t1_bitwise_equal_to_decode_entry": all(t1_equal)}


def _verify_int8_inputs(dev, *, b, n_tok, t, hq, hkv, dh, page, cache_len,
                        copies, deq=True):
    """``copies`` int8 pools for ``verify_int8_timing``: (q, pk_q, pk_s,
    pv_q, pv_s, tables[, K, V dequantized to bf16 per head]) each, and
    the verify's base lengths."""
    import torch
    from repro_torch.kernels import quant_kv as QK
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(8)
    mp = -(-(cache_len or n_tok) // page)
    per_row = -(-n_tok // page)
    used = 1
    while used < per_row:
        used *= 2
    n_pages = b * mp + 1
    lens = torch.full((b,), n_tok - t, dtype=torch.int32, device=dev)
    bufs = []
    for _ in range(copies):
        pool = []
        for _kv in range(2):
            x = torch.randn((n_pages, page, hkv, dh), generator=gen,
                            device=dev)
            pool += list(QK.quantize_kv(x))
            del x
        q = torch.randn((b, t, hq, dh), generator=gen,
                        device=dev).to(torch.bfloat16)
        ids = torch.randperm(b * mp, generator=gen, device=dev)
        tables = torch.full((b, mp), -1, dtype=torch.int32, device=dev)
        tables[:, :per_row] = ids[:b * per_row].reshape(b, per_row).to(
            torch.int32)
        tables = tables[:, :min(used, mp)].contiguous()
        dq = []
        for vq, vs in ((pool[0], pool[1]), (pool[2], pool[3])) if deq \
                else ():
            g, _ = ref.paged_gather(QK.dequantize_kv(vq, vs), tables)
            dq.append(g[:, :n_tok].permute(0, 2, 1, 3).contiguous().to(
                torch.bfloat16))
        bufs.append((q, *pool, tables, *dq))
    return bufs, lens


def verify_int8_timing(dev, name, *, b, n_tok, t=4, hq=32, hkv=8, dh=128,
                       page=16, cache_len=None, copies=1,
                       iters=50) -> dict:
    """Kernel 3's multi-token paged entry, its plain version and the SDPA
    yardstick at one shape, bf16 q, int8 pools: every row holds ``n_tok``
    valid tokens, the verify's base is n_tok - t (its last candidate at
    n_tok - 1), the tables cut to the power of two of the used pages as
    the verify R-Part cuts them; ``copies`` pools cycled past the L2.
    SDPA reads K/V dequantized to bf16 and laid out per head, with a
    boolean mask (neither the dequantization nor the layout is timed)."""
    import torch
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import quant_kv as QK
    from repro_torch.kernels import ref
    bufs, lens = _verify_int8_inputs(dev, b=b, n_tok=n_tok, t=t, hq=hq,
                                     hkv=hkv, dh=dh, page=page,
                                     cache_len=cache_len, copies=copies)
    lens_val = n_tok - t
    qp = lens_val + torch.arange(t, device=dev)
    mask = (torch.arange(n_tok, device=dev)[None, :]
            <= qp[:, None])[None, None].expand(b, 1, t, n_tok)

    def kern(i):
        q, kq, ks, vq, vs, tables = bufs[i % copies][:6]
        return QK.paged_verify_attention_int8(q, kq, ks, vq, vs, tables,
                                              lens)

    def plain(i):
        q, kq, ks, vq, vs, tables = bufs[i % copies][:6]
        return ref.paged_verify_attention_int8_ref(q, kq, ks, vq, vs, tables,
                                                   lens)

    def lib(i):
        q, kd, vd = bufs[i % copies][0], bufs[i % copies][6], \
            bufs[i % copies][7]
        return _sdpa(q, kd, vd, mask, t)

    q, kq, ks, vq, vs, tables = bufs[0][:6]
    got = kern(0)
    err, ok = tol_check(got, ref.paged_verify_attention_int8_ref(
        q.float(), kq, ks, vq, vs, tables, lens), "bfloat16")
    if not ok:
        raise AssertionError(f"verify_int8 at the {name} shape: max err "
                             f"{err} against the plain version, (atol, rtol)"
                             f" {TOL['bfloat16']}")
    lib_err = float((got.float() - lib(0).float()).abs().max())
    ms = cuda_time_ms(kern, iters)
    plain_ms = cuda_time_ms(plain, max(3, iters // 10), warmup=1)
    library_ms = cuda_time_ms(lib, iters)
    calls = copies * max(1, 16 // copies)
    device_ms = graph_time_ms(kern, calls)
    library_device_ms = graph_time_ms(lib, calls, strict=False)
    pps, n_splits = QK.paged_plan(q, kq, tables)
    rows, per_sm = DA.occupancy(kv_int8=True, paged=True, t=t, hq=hq,
                                hkv=hkv, dh=dh, dtype=torch.bfloat16,
                                per_split=pps)
    groups = QK.verify_row_groups(t, hq // hkv, torch.bfloat16)
    if groups != -(-t * (hq // hkv) // rows):
        raise AssertionError(f"verify_int8: the wrapper's {groups} row groups "
                             f"are not the C side's (rows of {rows})")
    # the valid rows' int8 K/V and scales once, q and o, tables, lengths
    bytes_moved = (2 * b * n_tok * hkv * (dh + 4) + 2 * b * t * hq * dh * 2
                   + tables.numel() * 4 + b * 4)
    flops = 4 * b * hq * dh * sum(lens_val + i + 1 for i in range(t))
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    return {"shape": name, "B": b, "T": t, "tokens_per_row": n_tok,
            "Hq": hq, "Hkv": hkv, "Dh": dh, "page": page,
            "table_pages": tables.shape[1], "q_dtype": "bfloat16",
            "kv_dtype": "int8", "pool_copies": copies, "max_abs_err": err,
            "atol_rtol": TOL["bfloat16"], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_err": lib_err,
            "device_ms": device_ms, "library_device_ms": library_device_ms,
            "split_plan": {"pages_per_split": pps, "num_splits": n_splits},
            "ctas": n_splits * hkv * b * groups, "rows_per_cta": rows,
            "ctas_per_sm": per_sm,
            "merge_launches_per_call": int(n_splits > 1),
            "bytes": bytes_moved, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "achieved_GBps": bytes_moved / (ms * 1e-3) / 1e9,
            "achieved_GBps_device": bytes_moved / (device_ms * 1e-3) / 1e9}


_PTXAS_FN = re.compile(
    r"(paged_attn_kernel|merge_splits|dense_attn_kernel|dense_merge)"
    r"I(13__nv_bfloat16|f)(13__nv_bfloat16|S1_|f|a)?Li(\d+)E"
    r"(?:Li(\d+)ELb(\d)E(?:Lb(\d)E)?)?")


def ptxas_summary(text: str) -> list:
    """Registers, static shared memory and spills of every instantiation
    of a csrc source, from nvcc's ``-Xptxas -v`` report."""
    rows, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = _PTXAS_FN.search(m.group(1))
            cur = None
            if k:
                name, elt, kv, dh, gt, flag1, flag2 = k.groups()
                dtype = "bfloat16" if "bfloat16" in elt else "float32"
                cur = {"kernel": name, "dtype": dtype, "Dh": int(dh)}
                if name.startswith("dense"):
                    if kv is not None:
                        cur["kv_dtype"] = {"a": "int8", "f": "float32"}.get(
                            kv, "bfloat16")
                    if gt:
                        # a bf16 q: tensor cores (kernel 2 on tc_decode.cuh's
                        # engine, kernel 3 on MmaEngine or, 16 rows,
                        # Mma16Engine); an fp32 q: CUDA cores
                        cur.update(rows_per_cta=int(gt),
                                   entry="paged-multi-token" if flag2 == "1"
                                   else "paged" if flag1 == "1" else "slab",
                                   engine=("CUDA cores"
                                           if dtype != "bfloat16"
                                           or gt not in ("8", "16")
                                           else "tensor cores, 16 rows"
                                           if gt == "16" else "tensor cores"))
                elif gt:
                    cur.update(rows_per_cta=int(gt),
                               entry="verify" if flag1 == "1" else "decode",
                               engine="tensor cores" if flag2 == "1"
                               else "CUDA cores")
                rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    return rows


# kernels 2 and 3's instantiations on the paths (kernel, paged, T, Hq,
# Hkv, Dh, q dtype, slots or pages per split at that path's main shape):
# the dense-int8 serve's call, the hybrid's Dh 256 call (bf16 and fp32 q),
# the paged-int8 serve's call, the int8 spec serve's verify (T 4) and the
# cross-attention R-Part at vision's and whisper's heads
OCCUPANCY_CASES = [
    ("decode_attention_int8", False, 1, 32, 8, 128, "bfloat16", 64),
    ("decode_attention_int8", False, 1, 10, 1, 256, "bfloat16", 64),
    ("decode_attention_int8", False, 1, 10, 1, 256, "float32", 64),
    ("decode_attention_int8", True, 1, 32, 8, 128, "bfloat16", 4),
    ("verify_int8", True, 4, 32, 8, 128, "bfloat16", 4),
    ("verify_int8", True, 4, 16, 4, 64, "bfloat16", 4),
    ("decode_attention", False, 1, 64, 8, 128, "bfloat16", 95),
    ("decode_attention", False, 1, 16, 16, 64, "bfloat16", 167),
    ("decode_attention", False, 1, 32, 8, 128, "bfloat16", 64)]
# the rows one worker holds after fleet_xattn's move (3 + 1) and restore (4)
MOVED_ROWS = (3, 1, 4)


def dense_occupancy(ptxas_rows) -> list:
    """Each ``OCCUPANCY_CASES`` instantiation of csrc/decode_attention.cu:
    its rows per CTA and CTAs per SM (the C side's choice and the CUDA
    occupancy calculator) beside its registers and spills (ptxas); the
    16-row tensor-core engine's (Dh 256 and the multi-token entry) and
    kernel 2's (tc_decode.cuh's engine) must fit 3 CTAs per SM."""
    import torch
    from repro_torch.kernels import decode_attention as DA
    out = []
    for kernel, paged, t, hq, hkv, dh, dtype_name, per_split in \
            OCCUPANCY_CASES:
        dtype = getattr(torch, dtype_name)
        rows, per_sm = DA.occupancy(kv_int8=kernel != "decode_attention",
                                    paged=paged, t=t, hq=hq, hkv=hkv, dh=dh,
                                    dtype=dtype, per_split=per_split)
        entry = ("paged-multi-token" if t > 1 else "paged" if paged
                 else "slab")
        kv = "int8" if kernel != "decode_attention" else dtype_name
        reg = [r for r in ptxas_rows if r["kernel"] == "dense_attn_kernel"
               and r["dtype"] == dtype_name and r.get("kv_dtype") == kv
               and r["Dh"] == dh and r.get("rows_per_cta") == rows
               and r.get("entry") == entry]
        rec = {"kernel": kernel, "entry": entry, "T": t, "Hq": hq,
               "Hkv": hkv, "Dh": dh, "q_dtype": dtype_name,
               "per_split": per_split, "rows_per_cta": rows,
               "ctas_per_sm": per_sm,
               "registers": reg[0].get("registers") if reg else None,
               "spill_bytes": (reg[0].get("spill_stores", 0)
                               + reg[0].get("spill_loads", 0)) if reg
               else None}
        print(f"occupancy: {rec}", flush=True)
        if rows == 16 and kv == "int8" and dtype_name == "bfloat16" \
                and per_sm < 3:
            raise AssertionError(f"the 16-row engine fits fewer than 3 CTAs "
                                 f"per SM: {rec}")
        if kernel == "decode_attention" and per_sm < 3:
            raise AssertionError(f"kernel 2's tensor-core engine fits fewer "
                                 f"than 3 CTAs per SM: {rec}")
        out.append(rec)
    return out


def _bf16_engine_row(r) -> bool:
    """A ptxas row of the tensor-core engine for bf16 K/V
    (csrc/tc_decode.cuh): kernel 1's bf16 decode, kernel 2 with a bf16 q."""
    return (r["dtype"] == "bfloat16" and r.get("engine") == "tensor cores"
            and ((r["kernel"] == "paged_attn_kernel"
                  and r.get("entry") == "decode")
                 or (r["kernel"] == "dense_attn_kernel"
                     and r.get("kv_dtype") == "bfloat16")))


# kernel 1's bf16 decode instantiations on the paths (Hq, Hkv, Dh, pages
# per split at that path's main shape): the serve's call (Qwen3-8B's heads,
# G 4), llama4-scout's (G 5), grok-1's (G 6), llama-13b's (G 1) and the
# serve at Dh 64 (whisper's head dim, G 4)
PAGED_OCCUPANCY_CASES = [(32, 8, 128, 4), (40, 8, 128, 4), (48, 8, 128, 4),
                         (40, 40, 128, 4), (32, 8, 64, 4)]


def paged_occupancy(ptxas_rows) -> list:
    """Each ``PAGED_OCCUPANCY_CASES`` instantiation of kernel 1 in bf16:
    its CTAs per SM (the CUDA occupancy calculator) beside its registers
    and spills (ptxas); the tensor-core engine must fit 3 CTAs per SM."""
    import torch
    from repro_torch.kernels import paged_attention as PA
    out = []
    for hq, hkv, dh, pps in PAGED_OCCUPANCY_CASES:
        per_sm = PA.ctas_per_sm(1, hq, hkv, dh, torch.bfloat16, pps)
        reg = [r for r in ptxas_rows if r["kernel"] == "paged_attn_kernel"
               and r["dtype"] == "bfloat16" and r["Dh"] == dh
               and r.get("entry") == "decode"
               and r.get("rows_per_cta") == PA.MAX_ROWS_DECODE]
        rec = {"kernel": "paged_decode_attention", "Hq": hq, "Hkv": hkv,
               "Dh": dh, "q_dtype": "bfloat16", "pages_per_split": pps,
               "rows_per_cta": PA.MAX_ROWS_DECODE, "ctas_per_sm": per_sm,
               "engine": reg[0].get("engine") if reg else None,
               "registers": reg[0].get("registers") if reg else None,
               "spill_bytes": (reg[0].get("spill_stores", 0)
                               + reg[0].get("spill_loads", 0)) if reg
               else None}
        print(f"occupancy: {rec}", flush=True)
        if per_sm < 3:
            raise AssertionError(f"kernel 1's bf16 decode fits fewer than "
                                 f"3 CTAs per SM: {rec}")
        out.append(rec)
    return out


def phase_kernel(dev) -> dict:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    report = build.report()
    for stem, text in report.items():
        print(f"ptxas report of {stem}:\n{text}", flush=True)
    ptxas = {stem: ptxas_summary(report[stem])
             for stem in ("paged_attention", "decode_attention")}
    # no bf16-q instantiation at Dh 128 or 256 may spill (decode_attention's:
    # bf16 and int8 K/V), nor any multi-token one (Dh 64 included), nor any
    # of the tensor-core engine for bf16 K/V (kernel 1's decode, kernel 2;
    # Dh 64 included)
    spills = [r for rows in ptxas.values() for r in rows
              if r["dtype"] == "bfloat16"
              and (r["Dh"] in (128, 256)
                   or r.get("entry") == "paged-multi-token"
                   or _bf16_engine_row(r))
              and r.get("spill_stores", 0) + r.get("spill_loads", 0)]
    if spills or not all(ptxas.values()):
        raise AssertionError(f"bf16 Dh 128 / 256, multi-token or bf16-K/V "
                             f"tensor-core instantiations spill (or no "
                             f"report): {spills}")
    occupancy = dense_occupancy(ptxas["decode_attention"])
    occupancy_paged = paged_occupancy(ptxas["paged_attention"])
    checks = kernel_checks(dev)
    # main path: one R-worker call = 2 rows of a micro-batch (batch 8, two
    # micro-batches, two workers) over ~512 tokens, pool sized for
    # cache_len 1024; 16 pools cycled to defeat the L2
    main = kernel_timing(dev, "main-path", b=2, n_tok=512, cache_len=1024,
                         copies=16, iters=200)
    bw = kernel_timing(dev, "bandwidth", b=64, n_tok=4096, copies=1,
                       iters=20)
    # the same R-worker call at the evaluation models' widths (MHA, G 1):
    # llama-13b's 40 heads and opt-175b's 96
    evals = [kernel_timing(dev, f"main-path-{name}", b=2, n_tok=512,
                           cache_len=1024, hq=h, hkv=h, copies=16, iters=200)
             for name, h in (("llama-13b", 40), ("opt-175b", 96))]
    # and at the MoE models' (grok-1: G 6 with softcap 30; llama4-scout:
    # G 5): kernel 1, and kernel 4 at T = 4 (24 and 20 query rows, two
    # row groups)
    moe = {name: [kernel_timing(dev, f"main-path-{name}", b=2, n_tok=512,
                                cache_len=1024, hq=hq, hkv=hkv, copies=16,
                                iters=200, softcap=cap, t=t)
                  for t in (None, 4)]
           for name, (hq, hkv, cap) in MOE_HEADS.items()}
    # flex_attention's compile started inductor's worker processes: stop
    # them before the serve phases time the host
    from torch._inductor.async_compile import shutdown_compile_workers
    shutdown_compile_workers()
    vchecks = verify_checks(dev)
    # kernel 4 at the spec serve's per-worker verify call (2 rows, the
    # last of 4 candidates at position 511) and at 64 x 4096
    v_main = kernel_timing(dev, "main-path", b=2, n_tok=512, cache_len=1024,
                           copies=16, iters=200, t=4)
    v_bw = kernel_timing(dev, "bandwidth", b=64, n_tok=4096, copies=1,
                         iters=20, t=4)
    slab = slab_checks(dev)
    pchecks = paged_int8_checks(dev)
    # kernels 2 and 3 at the int8 serve's per-worker shape (2 rows, the
    # dense slab of cache_len = 1024 slots, 512 valid) and at 64 x 4096
    s_main = slab_timing(dev, "main-path", b=2, s=1024, n_valid=512,
                         copies=16, iters=200)
    s_bw = slab_timing(dev, "bandwidth", b=64, s=4096, n_valid=4096,
                       copies=1, iters=20)
    # kernel 3's slab entry at recurrentgemma-2b's windowed MQA heads (Dh
    # 256, G 10): its checks, then one R-worker call of the hybrid's int8
    # serve (2 rows, S = min(cache_len 1024, window 2048), 512 valid) and
    # 64 rows x a full window
    d256 = dh256_checks(dev)
    s256 = [slab_timing(dev, name, hq=10, hkv=1, dh=256, copies=c,
                        iters=it, kernels=("decode_attention_int8",),
                        **kw)["decode_attention_int8"]
            for name, kw, c, it in (
                ("main-path-recurrentgemma", dict(b=2, s=1024, n_valid=512),
                 16, 200),
                ("bandwidth-recurrentgemma",
                 dict(b=64, s=HYBRID_WINDOW, n_valid=HYBRID_WINDOW), 1, 20))]
    # kernel 2 as the cross-attention R-Part: its checks at whisper-
    # medium's and llama-3.2-vision-90b's heads, then one R-worker call of
    # each static run (2 rows over the whole slab) and 64 rows
    xchecks = cross_checks(dev)
    xtiming = [slab_timing(dev, f"{run}-{shape}", b=b, s=h["s"],
                           n_valid=h["s"], hq=h["hq"], hkv=h["hkv"],
                           dh=h["dh"], copies=c, iters=it, cross=True,
                           kernels=("decode_attention",))["decode_attention"]
               for shape, h in CROSS_HEADS.items()
               for run, b, c, it in (("main", 2, 16, 200),
                                     ("bw", 64, 1, 20))]
    # and on the rows one worker holds after fleet_xattn's move (3, 1) and
    # its snapshot restore (4)
    xmoved = [slab_timing(dev, f"moved-{b}rows-{shape}", b=b, s=h["s"],
                          n_valid=h["s"], hq=h["hq"], hkv=h["hkv"],
                          dh=h["dh"], copies=16, iters=200, cross=True,
                          kernels=("decode_attention",))["decode_attention"]
              for shape, h in CROSS_HEADS.items() for b in MOVED_ROWS]
    v8checks = verify_int8_checks(dev)
    # kernel 3's multi-token entry at the int8 spec serve's per-worker
    # verify call (2 rows, the last of 4 candidates at position 511) and
    # at 64 x 4096
    v8_main = verify_int8_timing(dev, "main-path", b=2, n_tok=512,
                                 cache_len=1024, copies=16, iters=200)
    v8_bw = verify_int8_timing(dev, "bandwidth", b=64, n_tok=4096,
                               copies=1, iters=20)
    kernels = {"paged_decode_attention": {
        "checks": checks["cases"], "timing": [main, bw],
        "occupancy": occupancy_paged,
        "timing_eval_models": evals,
        "timing_moe_models": [r[0] for r in moe.values()],
        "max_abs_err": max([checks["max_abs_err"], main["max_abs_err"],
                            bw["max_abs_err"]]
                           + [e["max_abs_err"] for e in evals]
                           + [r[0]["max_abs_err"] for r in moe.values()])}}
    for name in ("decode_attention", "decode_attention_int8"):
        t = [s_main[name], s_bw[name]]
        kernels[name] = {"checks": slab[name]["cases"], "timing": t,
                         "max_abs_err": max([slab[name]["max_abs_err"]]
                                            + [x["max_abs_err"] for x in t])}
    kernels["decode_attention"]["cross_checks"] = xchecks["cases"]
    kernels["decode_attention"]["timing_cross"] = xtiming
    kernels["decode_attention"]["timing_cross_moved"] = xmoved
    kernels["decode_attention"]["ptxas"] = [
        r for r in ptxas["decode_attention"]
        if r["kernel"] == "dense_attn_kernel"
        and r.get("kv_dtype") != "int8" and r["Dh"] in (64, 128)]
    kernels["decode_attention"]["occupancy"] = [
        r for r in occupancy if r["kernel"] == "decode_attention"]
    kernels["decode_attention"]["max_abs_err"] = max(
        [kernels["decode_attention"]["max_abs_err"], xchecks["max_abs_err"]]
        + [x["max_abs_err"] for x in xtiming + xmoved])
    kernels["decode_attention_int8"]["paged_checks"] = pchecks["cases"]
    kernels["decode_attention_int8"]["max_abs_err"] = max(
        kernels["decode_attention_int8"]["max_abs_err"],
        pchecks["max_abs_err"])
    kernels["decode_attention_int8_dh256"] = {
        "checks": d256["cases"], "refused": d256["refused"],
        "timing": s256,
        "ptxas": [r for r in ptxas["decode_attention"] if r["Dh"] == 256],
        "occupancy": [r for r in occupancy if r["Dh"] == 256],
        "max_abs_err": max([d256["max_abs_err"]]
                           + [x["max_abs_err"] for x in s256])}
    kernels["paged_verify_attention"] = {
        "checks": vchecks["cases"], "timing": [v_main, v_bw],
        "timing_moe_models": [r[1] for r in moe.values()],
        "t1_bitwise_equal_to_kernel_1":
            vchecks["t1_bitwise_equal_to_kernel_1"],
        "max_abs_err": max([vchecks["max_abs_err"], v_main["max_abs_err"],
                            v_bw["max_abs_err"]]
                           + [r[1]["max_abs_err"] for r in moe.values()])}
    kernels["verify_int8"] = {
        "checks": v8checks["cases"], "timing": [v8_main, v8_bw],
        "t1_bitwise_equal_to_decode_entry":
            v8checks["t1_bitwise_equal_to_decode_entry"],
        "ptxas": [r for r in ptxas["decode_attention"]
                  if r.get("entry") == "paged-multi-token"],
        "occupancy": [r for r in occupancy
                      if r["entry"] == "paged-multi-token"],
        "max_abs_err": max(v8checks["max_abs_err"], v8_main["max_abs_err"],
                           v8_bw["max_abs_err"])}
    return {"phase": "kernel", "ok": True, "host": host_cpu(),
            "build_s": build_s,
            "ptxas": ptxas, "occupancy": occupancy,
            "occupancy_paged": occupancy_paged, "kernels": kernels,
            "paged_int8_op": gather_timing(dev)}


def _parent_fns(source: Path, module) -> dict:
    """Build a parent's csrc source (this tree's C ABI: the same entry
    points and arguments; its headers read from its own directory) with
    the port's nvcc flags into build/parent_build/ and declare its entry
    points as ``module`` (kernels/decode_attention.py or
    kernels/paged_attention.py) declares this tree's."""
    import ctypes
    from repro_torch.kernels import build
    out = ROOT / "build" / "parent_build"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"lib{source.stem}.so"
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                          str(source)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stdout}"
                           f"{res.stderr}")
    cdll = ctypes.CDLL(str(lib))
    names = (list(module._ENTRIES) + [module._OCCUPANCY]
             if hasattr(module, "_ENTRIES") else list(module.ENTRIES))
    return {n: module.declare(cdll, n) for n in names}


@contextlib.contextmanager
def _library(module, fns):
    """Inside: ``module``'s wrappers launch ``fns`` (a parent's library)
    in place of this tree's, with this tree's split plans."""
    saved = dict(module._fns)
    module._fns.clear()
    module._fns.update(fns)
    try:
        yield
    finally:
        module._fns.clear()
        module._fns.update(saved)


def _compare_row(kernel, shape, fn, want, parent, *, iters, calls,
                 lib=None, bitwise=False) -> dict:
    """One shape of a compare phase: ``fn(i)`` launched through the
    parent's library (the ``parent`` context) and this tree's, outputs
    bitwise equal (``bitwise``: a kernel this tree leaves as it was) or
    each within the bf16 tolerance of ``want``; then host-loop ms and
    CUDA-graph device ms in turns parent, tree, [library,] tree, parent,
    each version's device ms the mean of its two turns."""
    import torch
    outs = {}
    with parent():
        outs["parent"] = fn(0)
    outs["tree"] = fn(0)
    torch.cuda.synchronize()
    rec = {"kernel": kernel, "shape": shape}
    if bitwise:
        rec["bitwise_equal_to_parent"] = bool(torch.equal(outs["parent"],
                                                          outs["tree"]))
        if not rec["bitwise_equal_to_parent"]:
            raise AssertionError(f"{kernel} at {shape}: this tree's output "
                                 f"is not the parent's bit for bit")
    else:
        rec["max_abs_err"] = {}
        for ver, out in outs.items():
            rec["max_abs_err"][ver], ok = tol_check(out, want, "bfloat16")
            if not ok:
                raise AssertionError(f"{ver} {kernel} at {shape}: max err "
                                     f"{rec['max_abs_err'][ver]}")
    same = contextlib.nullcontext
    order = [("parent", fn, parent), ("tree", fn, same)]
    order += [("sdpa", lib, same)] if lib else []
    order += [("tree", fn, same), ("parent", fn, parent)]
    turns, dev_turns = [], []
    for ver, f, ctx in order:
        with ctx():
            turns.append((ver, cuda_time_ms(f, iters)))
    for ver, f, ctx in order:
        with ctx():
            dev_turns.append((ver, graph_time_ms(f, calls,
                                                 strict=ver != "sdpa")))
    mean = {ver: sum(t for v, t in dev_turns if v == ver)
            / sum(v == ver for v, _ in dev_turns)
            for ver in ("parent", "tree")}
    rec.update(turns_ms=turns, device_turns_ms=dev_turns,
               device_ms_parent=mean["parent"], device_ms_tree=mean["tree"],
               tree_over_parent=mean["tree"] / mean["parent"])
    print(f"compare: {kernel} {shape} device ms parent "
          f"{mean['parent']:.5f} tree {mean['tree']:.5f} "
          f"({rec['tree_over_parent']:.3f}x)", flush=True)
    return rec


def _bitwise_rows(kernel, cases, parent) -> list:
    """``cases`` = [(name, fn)] launched through the parent's library and
    this tree's: each output bitwise equal (untimed)."""
    import torch
    rows = []
    for name, fn in cases:
        with parent():
            want = fn()
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{kernel} {name}: this tree's output is "
                                 f"not the parent's bit for bit")
        rows.append({"kernel": kernel, "case": name,
                     "bitwise_equal_to_parent": True})
    return rows


def phase_compare_dense(dev, parent_source: Path) -> dict:
    """A parent's csrc/decode_attention.cu (``parent_source``, this tree's
    C ABI, built here) against this tree's in one process on one card,
    with this tree's split plans.  Kernel 2 with a bf16 q (tc_decode.cuh's
    engine here) at the dense serve's call (2 rows, 1024 slots, 512 valid)
    and 64 x 4096, as the cross-attention R-Part at vision's G 8 and
    whisper's G 1 (2 rows and 64) and on the 3, 1 and 4 rows a worker holds
    after fleet_xattn's move and restore: both versions held to the plain
    version, then timed in turns parent, tree, SDPA, tree, parent (host
    loop and device time).  Kernel 3's entries (the slab decode at the
    serve shape and 64 x 4096, at Dh 256 / G 10, with bf16 and fp32 q; the
    paged decode and the multi-token verify T 4 at 2 x 512 and 64 x 4096)
    and kernel 2 with an fp32 q: this tree's outputs bitwise the
    parent's, kernel 3's bf16 rows timed in the same turns."""
    import torch
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import quant_kv as QK
    fns = _parent_fns(parent_source, DA)
    parent = functools.partial(_library, DA, fns)
    rows, bitwise = [], []
    k2_shapes = [("main-path", dict(b=2, s=1024, n_valid=512, hq=32, hkv=8,
                                    dh=128), 16, False),
                 ("bandwidth", dict(b=64, s=4096, n_valid=4096, hq=32,
                                    hkv=8, dh=128), 1, False)]
    for shape, h in CROSS_HEADS.items():
        k2_shapes += [(f"{run}-{shape}", dict(b=b, s=h["s"], n_valid=h["s"],
                                              hq=h["hq"], hkv=h["hkv"],
                                              dh=h["dh"]), c, True)
                      for run, b, c in (("main", 2, 16), ("bw", 64, 1))
                      + tuple((f"moved-{n}rows", n, 16)
                              for n in MOVED_ROWS)]
    for shape, kw, copies, cross in k2_shapes:
        bufs, pos, lens = _slab_inputs(dev, copies=copies, cross=cross, **kw)
        runs = _slab_runs(pos, lens)
        iters = 200 if copies > 1 else 20
        calls = copies * max(1, 16 // copies)
        kernels = (("decode_attention", "decode_attention_int8")
                   if shape in ("main-path", "bandwidth")
                   else ("decode_attention",))
        for kernel in kernels:
            r = runs[kernel]
            rows.append(_compare_row(
                kernel, shape, lambda i, r=r: r["kern"](bufs[i % copies]),
                r["check"](bufs[0]), parent, iters=iters, calls=calls,
                lib=(lambda i, r=r: r["lib"](bufs[i % copies])),
                bitwise=kernel == "decode_attention_int8"))
        # fp32 q (kernel 2 over fp32 K/V, kernel 3 over int8): untimed
        t0 = {n: (x.float() if n in ("q", "k", "v") else x)
              for n, x in bufs[0].items()}
        cases = [(f"float32-{shape}", lambda t=t0: DA.decode_attention(
            t["q"], t["k"], t["v"], pos, lens))]
        if not cross:
            cases.append((f"float32-q-{shape}", lambda t=t0:
                          QK.decode_attention_int8(t["q"], t["kq"], t["ks"],
                                                   t["vq"], t["vs"], pos,
                                                   lens)))
        bitwise += _bitwise_rows("dense", cases, parent)
        del bufs, t0
        torch.cuda.empty_cache()
    # kernel 3's Dh 256 slab entry (recurrentgemma-2b's heads)
    for shape, kw, copies in (("main-path-recurrentgemma",
                               dict(b=2, s=1024, n_valid=512), 16),
                              ("bandwidth-recurrentgemma",
                               dict(b=64, s=HYBRID_WINDOW,
                                    n_valid=HYBRID_WINDOW), 1)):
        bufs, pos, lens = _slab_inputs(dev, hq=10, hkv=1, dh=256,
                                       copies=copies, **kw)
        r = _slab_runs(pos, lens)["decode_attention_int8"]
        rows.append(_compare_row(
            "decode_attention_int8_dh256", shape,
            lambda i, r=r: r["kern"](bufs[i % copies]), None, parent,
            iters=200 if copies > 1 else 20,
            calls=copies * max(1, 16 // copies), bitwise=True))
        t = bufs[0]
        bitwise += _bitwise_rows("decode_attention_int8_dh256", [(
            f"float32-q-{shape}", lambda: QK.decode_attention_int8(
                t["q"].float(), t["kq"], t["ks"], t["vq"], t["vs"], pos,
                lens))], parent)
        del bufs, t
        torch.cuda.empty_cache()
    # kernel 3's paged entry and its multi-token entry (T 4)
    for shape, b, n_tok, copies in (("main-path", 2, 512, 16),
                                    ("bandwidth", 64, 4096, 1)):
        for t in (1, 4):
            bufs, lens = _verify_int8_inputs(
                dev, b=b, n_tok=n_tok, t=t, hq=32, hkv=8, dh=128, page=16,
                cache_len=1024 if b == 2 else None, copies=copies,
                deq=False)
            if t == 1:
                bufs = [(x[0][:, 0].contiguous(), *x[1:]) for x in bufs]
                fn = (lambda i, bb=bufs:
                      QK.paged_decode_attention_int8(*bb[i % len(bb)], lens))
            else:
                fn = (lambda i, bb=bufs:
                      QK.paged_verify_attention_int8(*bb[i % len(bb)], lens))
            rows.append(_compare_row(
                "decode_attention_int8" if t == 1 else "verify_int8",
                f"paged-{shape}", fn, None, parent,
                iters=200 if copies > 1 else 20,
                calls=copies * max(1, 16 // copies), bitwise=True))
            del bufs
            torch.cuda.empty_cache()
    return {"phase": "compare_dense", "ok": True,
            "parent_source": str(parent_source), "rows": rows,
            "bitwise": bitwise}


def phase_compare(dev, parent_source: Path) -> dict:
    """A parent's csrc/paged_attention.cu (``parent_source``, this tree's C
    ABI, built here) against this tree's in one process on one card, with
    this tree's split plans.  Kernel 1 in bf16 (tc_decode.cuh's engine
    here) at the main path's shape and the bandwidth shape and at the main
    shape with llama4-scout's (G 5), grok-1's (G 6, softcap 30),
    llama-13b's and opt-175b's (G 1) heads: both versions held to the plain
    version, then timed in turns parent, tree, SDPA (none with softcap),
    tree, parent.  Kernel 4 at T 4 (main and bandwidth, grok-1's and
    llama4-scout's heads) and every fp32 case of kernels 1 and 4: this
    tree's outputs bitwise the parent's, kernel 4's bf16 rows timed in the
    same turns.  Then this tree at the main shape under other split plans
    (pages per split), the data for the plan's rule."""
    import torch
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ref
    fns = _parent_fns(parent_source, PA)
    parent = functools.partial(_library, PA, fns)
    rows = []
    main = dict(b=2, n_tok=512, cache_len=1024, copies=16)
    shapes = [("main-path", main, 32, 8, 0.0),
              ("bandwidth", dict(b=64, n_tok=4096, cache_len=None,
                                 copies=1), 32, 8, 0.0)]
    shapes += [(f"main-path-{name}", main, hq, hkv, cap)
               for name, (hq, hkv, cap) in MOE_HEADS.items()]
    shapes += [(f"main-path-{name}", main, h, h, 0.0)
               for name, h in (("llama-13b", 40), ("opt-175b", 96))]
    for shape, kw, hq, hkv, cap in shapes:
        for t in ((None, 4) if hq != hkv else (None,)):
            bufs, mask, _ = _timing_case(dev, hq=hq, hkv=hkv, dh=128,
                                         page=16, t=t, **kw)
            if cap:
                bufs = [((x[0] * SOFTCAP_Q_SCALE["bfloat16"]).to(x[0].dtype),)
                        + tuple(x[1:]) for x in bufs]
            attn = dict(softcap=cap) if cap else {}
            copies = kw["copies"]
            run = (PA.paged_verify_attention if t
                   else PA.paged_decode_attention)
            want = (ref.paged_verify_attention_ref if t else
                    ref.paged_decode_attention_ref)(*bufs[0][:5], **attn)
            rows.append(_compare_row(
                "paged_verify_attention" if t else "paged_decode_attention",
                shape, lambda i, bb=bufs, f=run, a=attn:
                f(*bb[i % len(bb)][:5], **a), want, parent,
                iters=200 if copies > 1 else 20,
                calls=copies * max(1, 16 // copies),
                lib=None if cap else (lambda i, bb=bufs, m=mask, tt=t:
                                      _sdpa(*(bb[i % len(bb)][j]
                                              for j in (0, 5, 6)), m, tt)),
                bitwise=t is not None))
            if t is None:
                rows[-1]["split_plan"] = PA.kernel_plan(*bufs[0][:2],
                                                        bufs[0][3])
            del bufs
            torch.cuda.empty_cache()
    # every fp32 case of kernel_checks and verify_checks (T 2 and 4): bitwise
    gen = torch.Generator().manual_seed(11)
    cases = []
    for c in _fp32_paged_cases():
        for t in (1, 2, 4):
            kw = dict(c["kw"])
            kw["lengths"] = [n + t - 1 for n in kw["lengths"]]
            _, pk, pv, tables, lens = _paged_case(gen, dtype=torch.float32,
                                                  dev=dev, **kw)
            base = (lens - (t - 1)).contiguous()
            q = (torch.randn((kw["b"], t, kw["hq"], kw["dh"]), generator=gen)
                 * c.get("q_scale", 1.0)).to(dev)
            if t == 1:
                cases.append((f"{c['name']}-T1", lambda q=q, a=(
                    pk, pv, tables, base), at=c["attn"]:
                    PA.paged_decode_attention(q[:, 0].contiguous(), *a,
                                              **at)))
            cases.append((f"{c['name']}-T{t}-verify", lambda q=q, a=(
                pk, pv, tables, base), at=c["attn"]:
                PA.paged_verify_attention(q, *a, **at)))
    bitwise = _bitwise_rows("paged (float32)", cases, parent)
    sweep = []
    for kernel, t in (("paged_decode_attention", None),
                      ("paged_verify_attention", 4)):
        bufs, _, _ = _timing_case(dev, b=2, n_tok=512, hq=32, hkv=8, dh=128,
                                  page=16, cache_len=1024, copies=16, t=t)
        q, pk, pv, tables, lens = bufs[0][:5]
        mp = tables.shape[1]
        own = PA.kernel_plan
        try:
            for pps in (1, 2, 4, 8, 16, 32, 64):
                if pps > mp:
                    continue
                plan = (pps, -(-mp // pps))
                PA.kernel_plan = lambda *a, _p=plan: _p
                fn = (lambda i: PA.paged_verify_attention(
                    *bufs[i % 16][:5])) if t else (
                    lambda i: PA.paged_decode_attention(*bufs[i % 16][:5]))
                sweep.append({"kernel": kernel, "table_pages": mp,
                              "pages_per_split": pps,
                              "num_splits": plan[1],
                              "ms": cuda_time_ms(fn, 200),
                              "device_ms": graph_time_ms(fn, 16)})
        finally:
            PA.kernel_plan = own
        del bufs
    return {"phase": "compare", "ok": True,
            "parent_source": str(parent_source), "rows": rows,
            "bitwise": bitwise, "split_sweep_main_path": sweep}


def _fp32_paged_cases() -> list:
    """The fp32 cases of kernel_checks and verify_checks: G 1, 4, 7 and 8
    (page 4 and 16), window + sink, softcap at Dh 64, the MoE heads and
    the long rows (their pages hold a T = 4 verify's last candidate)."""
    cases = [dict(name=f"float32-G{g}-page{page}", attn={},
                  kw=dict(b=5, hq=hkv * g, hkv=hkv, dh=128, page=page,
                          mp=-(-84 // page), lengths=[37, 5, 0, 63, 20],
                          unmapped_row=2, hole=(3, 1), share=(0, 4)))
             for g, hkv in G_HKV.items() for page in (4, 16)]
    cases.append(dict(name="float32-window-sink",
                      attn=dict(window=24, sink=4),
                      kw=dict(b=3, hq=8, hkv=2, dh=128, page=16, mp=8,
                              lengths=[100, 17, 64])))
    cases.append(dict(name="float32-softcap-dh64", attn=dict(softcap=5.0),
                      kw=dict(b=3, hq=12, hkv=4, dh=64, page=4, mp=18,
                              lengths=[50, 3, 61])))
    return cases + moe_cases("float32", t=1) + long_cases("float32", t=4)


# ---------------------------------------------------------------------------
# serve phase: the main path at full width
# ---------------------------------------------------------------------------
def _requests(rng, n, p_lo, p_hi, new_lo, new_hi, vocab):
    from repro_torch.serving.request import Request
    return [Request(rid=i,
                    prompt=rng.integers(1, vocab, int(rng.integers(
                        p_lo, p_hi + 1))).astype(np.int32),
                    max_new_tokens=int(rng.integers(new_lo, new_hi + 1)))
            for i in range(n)]


QWEN_LAYERS = 12        # Qwen3-8B's depth in the serve phases (of 36)


def serve_model(dev):
    """Qwen3-8B at full width cut to ``QWEN_LAYERS`` of its 36 layers (so
    that the whole run keeps to half its time limit on a slow host),
    bf16, random weights from a seeded generator (shared by the serve
    phases)."""
    import dataclasses
    import torch
    from repro_torch.core.config import get_arch
    from repro_torch.models.model import init_params
    from repro_torch.serving.kv_cache import cache_bytes
    from repro_torch.kernels import build
    cfg = dataclasses.replace(get_arch("qwen3-8b"), num_layers=QWEN_LAYERS)
    t0 = time.perf_counter()
    build.build()       # so that no serve's first step pays for nvcc
    t1 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    return {"cfg": cfg, "params": params, "build_s": t1 - t0,
            "init_s": time.perf_counter() - t1,
            "weight_bytes": cache_bytes(params),
            "full_layers": get_arch("qwen3-8b").num_layers}


def _counters():
    """{kernel name: (launch counter, plain-call counter)} of every ported
    kernel."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import quant_kv as QK
    return {"paged_decode_attention": (PA.launches, PA.plain_calls),
            "decode_attention": (DA.launches, DA.plain_calls),
            "decode_attention_int8": (QK.launches, QK.plain_calls),
            "paged_verify_attention": (PA.verify_launches,
                                       PA.verify_plain_calls),
            "verify_int8": (QK.verify_launches, QK.verify_plain_calls)}


def _reset_counters() -> None:
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import quant_kv as QK
    for launched, plain in _counters().values():
        launched.reset()
        plain.reset()
    for c in (PA.merge_launches, DA.merge_launches, QK.paged_launches):
        c.reset()


class _GatherCount:
    """Counts calls of ``kernels.ref.paged_gather`` while active: the
    int8 pages' gather, which the paged-int8 op no longer runs on the
    card."""

    def __enter__(self):
        from repro_torch.kernels import ref
        self.calls, self._own = 0, ref.paged_gather

        def counted(*a, **kw):
            self.calls += 1
            return self._own(*a, **kw)
        ref.paged_gather = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ref
        ref.paged_gather = self._own


def graph_memory(eng) -> dict:
    """The engine's CUDA graphs: how many, the bytes of their pools
    (segments of the caching allocator tagged with a pool of the engine:
    the S-worker's and each R-worker's) and of their static output
    buffers."""
    import torch
    het = eng.engine
    gs = list(het._s_graphs.values()) + [
        g for w in het.workers for g in w._graphs.values()]
    gs += [g for g in (getattr(eng, "_draft_graph", None),
                       getattr(eng, "_commit_graph", None)) if g is not None]
    pools = {tuple(p.handle) for p in [het._s_pool]
             + [w._pool for w in het.workers] if p.handle is not None}
    segs = torch.cuda.memory_snapshot()
    pool_bytes = (sum(s["total_size"] for s in segs
                      if tuple(s.get("segment_pool_id", ())) in pools)
                  if segs and "segment_pool_id" in segs[0] else None)
    return {"graphs": len(gs),
            "graphs_s": len(het._s_graphs),
            "graphs_r": [len(w._graphs) for w in het.workers],
            # a prefill chunk's: its S-side start and transitions, its
            # R-Parts per (layer, C, table width)
            "graphs_chunk_s": sum(1 for k in het._s_graphs
                                  if k[0].startswith("chunk") and not k[2]),
            "graphs_chunk_r": [sum(1 for k in w._graphs if k[0] == "c")
                               for w in het.workers],
            "graph_pool_bytes": pool_bytes,
            "graph_static_bytes": sum(g.static_bytes() for g in gs)}


def serve_run(dev, model, out: Path, *, kernel, paged: bool,
              quantized: bool, spec_k: int = 0, prefill_chunk: int = 0,
              profile: str = "", trace: bool = False,
              eager: bool = False, **run_kw) -> dict:
    """Serve the 12-request trace through ServingEngine(backend="hetero",
    num_r_workers=2) with the given storage, speculative decoding with
    ``spec_k`` drafts per row when nonzero, chunked prefill with
    ``prefill_chunk`` tokens per chunk when nonzero: through the CUDA
    graphs of the step callables, or op by op with ``eager``.  Every
    count is set to 0 just before the counted run and read just after it:
    ``kernel``'s launches must equal layers x workers x (micro-batches x
    decode steps, or the verify works run with spec decoding), no other
    kernel may run (``kernel`` None: none at all), and no plain version
    may run; on the graph path the counts come from replays.  ``profile``
    names a profiled window of 3 steps afterwards (written to ``out``).

    ``run_kw``: ``reqs`` (another trace), ``arrive`` ({rid: step}: submit
    before that step, default 0), ``engine_kw`` (more ServingEngine
    options: seed, prefix_cache, kv_tiering, preempt_after,
    pages_per_worker, admission, observability), ``plan`` (build the
    engine with ``ServingEngine.from_plan(seq_len=1024, max_batch=8)``:
    batch, micro-batches and R-workers come from the plan), ``rows`` (a
    dict that receives the logits row that chose every token, keyed (rid,
    token index)), ``check_support`` (every token a sampled request
    commits must have probability > 0 under ``sampler.target_probs`` of
    the row that chose it), ``on_step`` (called with the engine after
    every step), ``after`` (called with the engine after the counted run,
    before it closes; its result is the record's ``after``) and
    ``max_steps``."""
    from repro_torch.core import graphs
    with (graphs.eager() if eager else contextlib.nullcontext()):
        return _serve_run(dev, model, out, kernel=kernel, paged=paged,
                          quantized=quantized, spec_k=spec_k,
                          prefill_chunk=prefill_chunk, profile=profile,
                          trace=trace, eager=eager, **run_kw)


class _GCTime:
    """While active, the pauses of Python's cyclic garbage collector (in
    whichever thread collects; collections never overlap): seconds and
    collections per generation, from ``gc.callbacks``."""

    def __enter__(self):
        self.s, self.collections, self._t0 = 0.0, [0, 0, 0], None
        gc.callbacks.append(self._cb)
        return self

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.s += time.perf_counter() - self._t0
            self.collections[info["generation"]] += 1
            self._t0 = None

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)


class _TokenLog:
    """While active, sees every token the engine commits, with the logits
    row that chose it: the engine's ``_sample_tokens`` (prefill and decode
    rows, each named by its request) and the accept walk of a spec step
    (``sampler.spec_accept`` as the engine module calls it, one call per
    live row in ``_spec_rows`` order; committed token i of a call comes
    from logits row i).  ``rows`` (a dict) receives each row on the host,
    keyed (rid, token index); with ``support`` a sampled request's token
    must have probability > 0 under ``target_probs`` of its row (checked
    on the device; ``support_checked`` / ``support_violations``)."""

    def __init__(self, eng, rows=None, support=False):
        self.eng, self.rows, self.support = eng, rows, support
        self.support_checked = self.support_violations = 0

    def _note(self, r, j, row, tok):
        if self.rows is not None:
            self.rows[(r.rid, j)] = row.float().cpu()
        if self.support and r.temperature > 0.0:
            from repro_torch.serving.sampler import target_probs
            p = target_probs(row[None], r.temperature, r.top_k, r.top_p)
            self.support_checked += 1
            self.support_violations += int(float(p[0, tok]) <= 0.0)

    def __enter__(self):
        from repro_torch.serving import engine as E
        eng = self.eng
        own_sample, self._own_accept = eng._sample_tokens, E.spec_accept
        own_rows, live, calls = eng._spec_rows, [], [0]

        def sample(logits, reqs):
            toks = own_sample(logits, reqs)
            for i, r in enumerate(reqs):
                if r is not None:
                    self._note(r, len(r.generated), logits[i], int(toks[i]))
            return toks

        def spec_rows():
            live[:] = own_rows()
            calls[0] = 0
            return list(live)

        def accept(logits, draft, *a, **kw):
            toks, acc = self._own_accept(logits, draft, *a, **kw)
            r = live[calls[0]][1]
            calls[0] += 1
            for i, t in enumerate(toks):
                self._note(r, len(r.generated) + i, logits[i], int(t))
            return toks, acc
        eng._sample_tokens, eng._spec_rows = sample, spec_rows
        E.spec_accept = accept
        return self

    def __exit__(self, *exc):
        from repro_torch.serving import engine as E
        E.spec_accept = self._own_accept
        for name in ("_sample_tokens", "_spec_rows"):
            self.eng.__dict__.pop(name, None)


def _referenced_bytes(eng) -> float:
    """KV bytes of the pool pages some row maps, over every paged layer
    (``paged_resident_bytes`` adds the refcount-zero cached and parked
    pages, which hold KV until the ladder reclaims them)."""
    from repro_torch.serving import paged_cache as PC
    if eng.backend != "hetero":
        return 0.0
    return sum(w.allocators[lk // w.cfg.num_layers].used_pages()
               * w.page_size * PC.page_pool_token_bytes(w.state[lk])
               for w in eng.engine.workers for lk in w.paged_keys)


def _serve_run(dev, model, out, *, kernel, paged, quantized, spec_k,
               prefill_chunk, profile, trace, eager, reqs=None, arrive=None,
               engine_kw=None, rows=None, check_support=False,
               on_step=None, after=None, plan=False,
               max_steps=200, retries_ok=False) -> dict:
    import torch
    from repro_torch.core import graphs
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import quant_kv as QK
    from repro_torch.serving import kv_cache as KV
    from repro_torch.serving.engine import ServingEngine, SpecConfig
    cfg, params = model["cfg"], model["params"]
    counters = _counters()
    kw = dict(backend="hetero", paged_kv=paged, quantized_kv=quantized,
              page_size=16, device=dev, prefill_chunk=prefill_chunk,
              spec_decode=SpecConfig(k=spec_k) if spec_k else None,
              **(engine_kw or {}))
    if plan:
        eng = ServingEngine.from_plan(params, cfg, seq_len=1024, max_batch=8,
                                      **kw)
    else:
        eng = ServingEngine(params, cfg, num_r_workers=2, num_microbatches=2,
                            batch=8, cache_len=1024, **kw)
    batch, n_mb, n_workers = eng.batch, eng.num_mb, len(eng.engine.workers)
    arrive = arrive or {}
    try:
        if reqs is None:
            reqs = _requests(np.random.default_rng(0), 12, 17, 600, 16, 32,
                             cfg.vocab_size)
        pending = sorted(reqs, key=lambda r: arrive.get(r.rid, 0))
        while pending and arrive.get(pending[0].rid, 0) <= 0:
            eng.submit(pending.pop(0))
        torch.cuda.synchronize()
        _reset_counters()
        graphs.captures.reset()
        nonfinite = 0
        peak_resident = peak_referenced = 0.0
        verify_works = row_verifies = prefill_works = 0
        step_tokens = []        # decode (or verify) tokens of each step
        # R-workers after each step (a fleet fails one over before a step)
        workers_per_step = []
        # steps that admitted (monolithic) or ran a prefill chunk
        prefill_steps = []
        step_capture = []       # capture seconds inside each step
        seen = eng.engine.prefill_results
        heap_objects = len(gc.get_objects())
        with _GatherCount() as gathers, _GCTime() as gct, \
                _TokenLog(eng, rows, check_support) as toklog:
            while pending or eng.queue \
                    or any(s is not None for s in eng.slots):
                while pending and arrive.get(pending[0].rid, 0) \
                        <= eng.step_idx:
                    eng.submit(pending.pop(0))
                n0 = sum(len(r.generated) for r in reqs)
                first0 = sum(not r.generated for r in reqs)
                cap0 = graphs.captures.capture_s
                rec_ = eng.step()
                step_capture.append(graphs.captures.capture_s - cap0)
                # a request's token 0 comes from its prefill's logits
                first = first0 - sum(not r.generated for r in reqs)
                step_tokens.append(sum(len(r.generated) for r in reqs)
                                   - n0 - first)
                fills = 0
                # a step with no live row or chunk runs no chunk work (the
                # list stays)
                if eng.engine.prefill_results is not seen:
                    seen = eng.engine.prefill_results
                    for wk in seen:
                        if wk.verify:
                            verify_works += 1
                            row_verifies += len(wk.rows)
                        else:
                            fills += 1
                        nonfinite += int((~torch.isfinite(wk.logits)).sum())
                prefill_works += fills
                prefill_steps.append(bool(fills or rec_.admitted))
                if not spec_k:
                    nonfinite += int((~torch.isfinite(eng.last_logits)).sum())
                workers_per_step.append(len(eng.engine.workers))
                peak_resident = max(peak_resident, eng.paged_resident_bytes())
                peak_referenced = max(peak_referenced,
                                      _referenced_bytes(eng))
                if on_step is not None:
                    on_step(eng)
                if eng.step_idx > max_steps:
                    raise AssertionError(f"serve did not drain in "
                                         f"{max_steps} steps")
            torch.cuda.synchronize()
        capture = {"capture_count": graphs.captures.capture_count,
                   "capture_s": graphs.captures.capture_s}
        mem = graph_memory(eng)
        launches = {n: c[0].value for n, c in counters.items()}
        plain = {n: c[1].value for n, c in counters.items()}
        merges = PA.merge_launches.value
        dense_merges = DA.merge_launches.value
        paged_int8 = QK.paged_launches.value
        steps = eng.step_idx
        # the counted run's step records (``after`` and the profiled
        # window step the engine on)
        recs = list(eng.records)
        spec_stats = dict(eng.spec_stats)
        kv_bytes = sum(KV.cache_bytes(w.state) for w in eng.engine.workers)
        pool_bytes = sum(w.pool_bytes() for w in eng.engine.workers)
        hot = eng.hotpath_stats()
        busy = eng.engine.worker_busy_times()
        done = {r.rid: r for r in eng.finished}
        prefix_stats = (dict(eng.prefix_cache_stats()) if eng.prefix_cache
                        else None)
        tier_stats = dict(eng.tiering_stats()) or None
        after_rec = after(eng) if after is not None else None
        prof = None
        if profile:
            # a separate window on the warm engine (not part of the
            # counted run above): 8 fresh ~512-token rows, 3 decode steps
            for r in _requests(np.random.default_rng(1), 8, 500, 520, 32,
                               32, cfg.vocab_size):
                r.rid += 100
                eng.submit(r)
            eng.step()                  # admission + prefill + one decode
            prof = _profile_steps(eng, 3, out, profile, trace)
    finally:
        eng.close()
    if sorted(done) != list(range(len(reqs))):
        raise AssertionError(f"finished {sorted(done)}, submitted "
                             f"{len(reqs)}")
    for r in reqs:
        if len(done[r.rid].generated) != r.max_new_tokens \
                or done[r.rid].finish_reason != "length":
            raise AssertionError(
                f"request {r.rid}: {len(done[r.rid].generated)} tokens, "
                f"wanted {r.max_new_tokens}")
    if nonfinite:
        raise AssertionError(f"{nonfinite} non-finite logits")
    # each decode step launches once per layer, micro-batch and R-worker
    # (a step a fleet ran with fewer workers, fewer); with ``retries_ok``
    # a supervised retry relaunches what its aborted attempt launched
    calls = (n_workers * verify_works if spec_k
             else n_mb * sum(workers_per_step))
    # only attention layers launch a kernel (the RG-LRU and SSD R-Parts
    # are plain torch)
    n_attn = sum(k == "attn" for k in cfg.pattern)
    want = n_attn * calls
    others = {n: v for n, v in launches.items() if n != kernel}
    # the paged int8 decode is one call of kernel 3's paged entry, no
    # gather (the int8 verify: one call of its multi-token entry); a
    # windowed arch keeps the dense slab under paged_kv
    pageable = paged and cfg.window == 0
    want_paged = want if pageable and quantized and not spec_k else 0
    got = launches[kernel] if kernel else 0
    launch_ok = (got >= want if retries_ok and kernel
                 else got == (want if kernel else 0))
    if not launch_ok or any(plain.values()) \
            or any(others.values()) or paged_int8 != want_paged \
            or gathers.calls or (prefill_chunk and not prefill_works):
        raise AssertionError(
            f"{kernel} launches {got} != layers x workers x "
            f"{'verify works' if spec_k else 'micro-batches x decode steps'}"
            f" = {want} (other kernels {others}, plain calls "
            f"{plain}; kernel 3's paged launches {paged_int8}, want "
            f"{want_paged}; page gathers {gathers.calls}, want 0; prefill "
            f"works {prefill_works} at prefill_chunk {prefill_chunk})")
    dec = [rec.decode_wall for rec in recs]
    wall = [rec.wall for rec in recs]
    # tokens emitted by decode (or verify) steps (token 0 of a request
    # comes from its prefill logits, inside prefill_wall)
    dec_tokens = sum(len(r.generated) - 1 for r in reqs)
    rec = {"storage": ("paged-" if paged else "dense-")
           + ("int8" if quantized else cfg.dtype),
           "mode": "eager" if eager else "graphs",
           "prefill_chunk": prefill_chunk,
           "model": cfg.name, "layers": cfg.num_layers,
           "attention_layers": n_attn,
           "full_layers": model.get("full_layers", cfg.num_layers),
           "d_model": cfg.d_model, "heads": [cfg.num_heads,
                                             cfg.num_kv_heads],
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
           "weight_bytes": model["weight_bytes"], "init_s": model["init_s"],
           "build_s": model["build_s"],
           "requests": len(reqs), "decode_steps": steps,
           "batch": batch, "micro_batches": n_mb, "r_workers": n_workers,
           "r_workers_per_step": workers_per_step,
           "decode_tokens_per_step": step_tokens,
           "kernel_launches_expected": want if kernel else 0,
           "page_size": 16, "cache_len": eng.cache_len,
           "prompt_tokens": sum(r.prompt_len for r in reqs),
           "decode_tokens": dec_tokens,
           "decode_tokens_per_s": dec_tokens / sum(dec),
           # the first step captures the graphs (and, eager, warms up)
           "decode_tokens_per_s_after_first_step":
               sum(step_tokens[1:]) / sum(dec[1:]),
           "first_step_s": dec[0],
           "decode_step_s_p50": float(np.median(dec)),
           "decode_step_s_max": float(np.max(dec)),
           # whole steps (prefill + decode wall): all, and those that
           # admitted (monolithic) or ran a prefill chunk
           "step_wall_s_p50": float(np.median(wall)),
           "step_wall_s_max": float(np.max(wall)),
           "prefill_steps": int(sum(prefill_steps)),
           "prefill_step_wall_s_max": max(
               (w for w, f in zip(wall, prefill_steps) if f), default=None),
           "prefill_step_wall_s_max_after_first_step": max(
               (w for w, f in zip(wall[1:], prefill_steps[1:]) if f),
               default=None),
           # the same without the steps that captured graphs (a chunk
           # R-Part's new table width is captured mid-serve)
           "prefill_step_wall_s_max_without_captures": max(
               (w for w, f, c in zip(wall, prefill_steps, step_capture)
                if f and c == 0.0), default=None),
           "steps_with_captures": int(sum(c > 0.0 for c in step_capture)),
           "capture_s_after_first_step": sum(step_capture[1:]),
           "prefill_works": prefill_works,
           "prefill_s_total": sum(rec.prefill_wall for rec in recs),
           "decode_s_total": sum(dec),
           "kv_bytes": kv_bytes, "page_pool_bytes": pool_bytes,
           "paged_resident_bytes_peak": peak_resident,
           # pages some row maps (cached and parked pages left out)
           "paged_referenced_bytes_peak": peak_referenced,
           # the engine's own per-step records: requests admitted, and the
           # resident length (prompt + generated tokens of the slot rows)
           "admitted_per_step": [rec.admitted for rec in recs],
           "decode_wall_per_step": dec,
           "resident_len_per_step": [rec.resident_len for rec in recs],
           "resident_len_peak": max(rec.resident_len for rec in recs),
           "capture_steps": [i for i, c in enumerate(step_capture)
                             if c > 0.0],
           # Python's cyclic GC during the counted run, and the objects it
           # tracked when the run began
           "gc_s": gct.s, "gc_collections": gct.collections,
           "gc_heap_objects": heap_objects,
           "kernel": kernel, "kernel_launches": got,
           "launches": launches, "plain_calls": plain,
           "paged_merge_launches": merges,
           "dense_merge_launches": dense_merges,
           "int8_paged_launches": paged_int8, "page_gathers": gathers.calls,
           "hotpath": hot, "r_worker_busy_s": busy, "trace": prof,
           **capture, **mem,
           "tokens": {r.rid: list(done[r.rid].generated) for r in reqs}}
    if after is not None:
        rec["after"] = after_rec
    if prefix_stats is not None:
        rec["prefix_cache"] = prefix_stats
    if tier_stats is not None:
        rec["tiering"] = tier_stats
    if check_support:
        rec["support_checked"] = toklog.support_checked
        rec["support_violations"] = toklog.support_violations
    if spec_k:
        rec.update({
            "spec_k": spec_k, "spec_stats": spec_stats,
            "verify_works": verify_works, "row_verifies": row_verifies,
            "acceptance_rate": spec_stats["accepted_tokens"]
            / max(1, spec_stats["drafted_tokens"]),
            "accepted_per_verify_step": spec_stats["accepted_tokens"]
            / max(1, spec_stats["steps"]),
            "tokens_per_row_verify": dec_tokens / max(1, row_verifies)})
    return rec


SUMMARY_KEYS = ("mode", "decode_tokens_per_s",
                "decode_tokens_per_s_after_first_step", "first_step_s",
                "decode_step_s_p50", "decode_step_s_max", "hotpath",
                "r_worker_busy_s", "capture_count", "capture_s",
                "kernel_launches")


def phase_serve(dev, model, out: Path) -> dict:
    """The paged bf16 serve in turns, eager, graphs, eager (the same
    engine settings and trace; the graph run is the phase's record, the
    eager runs sit beside it with their profiled windows)."""
    kw = dict(kernel="paged_decode_attention", paged=True, quantized=False)
    eager1 = serve_run(dev, model, out, profile="serve_eager1", eager=True,
                       **kw)
    rec = serve_run(dev, model, out, profile="serve", trace=True, **kw)
    eager2 = serve_run(dev, model, out, profile="serve_eager2", eager=True,
                       **kw)
    turns = []
    for r in (eager1, rec, eager2):
        t = {k: r[k] for k in SUMMARY_KEYS}
        t["window"] = {k: r["trace"][k] for k in (
            "wall_s", "device_idle_ratio", "host_launches",
            "kernel_launches_host", "graph_launches_host", "runtime_calls")}
        turns.append(t)
    rec["turns"] = turns
    # bf16 replays run the eager path's kernels in its order: reported
    rec["tokens_equal_to_eager"] = (rec["tokens"] == eager1["tokens"]
                                    == eager2["tokens"])
    return {"phase": "serve", "ok": True, **rec}


def phase_serve_int8(dev, model, out: Path) -> dict:
    """The same trace on int8 storage: paged (kernel 3's paged entry over
    the pools, no gather) and then dense (kernel 3 over the slab)."""
    paged = serve_run(dev, model, out, kernel="decode_attention_int8",
                      paged=True, quantized=True, profile="serve_int8")
    dense = serve_run(dev, model, out, kernel="decode_attention_int8",
                      paged=False, quantized=True)
    return {"phase": "serve_int8", "ok": True, "runs": [paged, dense],
            "kernel_launches": paged["kernel_launches"]}


def phase_serve_spec(dev, model, out: Path, spec_off=None) -> dict:
    """The same trace through spec_decode=SpecConfig(k=3), self-
    speculation: every verify through kernel 4, none through kernel 1.
    In bf16 the verify logits (a C-token product) and the drafter's (a
    one-token product) sum in different orders, so near-ties may flip:
    equality with the spec-off serve's tokens is reported, not
    required."""
    rec = serve_run(dev, model, out, kernel="paged_verify_attention",
                    paged=True, quantized=False, spec_k=3,
                    profile="serve_spec")
    rec["triage"] = spec_triage(dev, model, rec, spec_off)
    if spec_off is not None:
        same = [rid for rid, toks in rec["tokens"].items()
                if spec_off["tokens"][rid] == toks]
        rec["requests_equal_to_spec_off"] = len(same) / len(rec["tokens"])
        # where each request's tokens first part from the spec-off serve's
        rec["first_diff_vs_spec_off"] = {
            rid: next((i for i, (a, b) in enumerate(
                zip(toks, spec_off["tokens"][rid])) if a != b), None)
            for rid, toks in rec["tokens"].items()}
        rec["tokens_per_s_ratio_to_spec_off"] = (
            rec["decode_tokens_per_s"] / spec_off["decode_tokens_per_s"])
    return {"phase": "serve_spec", "ok": True, **rec}


CHUNK = 128          # serve_chunked's prefill_chunk
COMPARE_KEYS = ("decode_tokens_per_s", "decode_tokens_per_s_after_first_step",
                "decode_step_s_p50", "decode_step_s_max", "step_wall_s_p50",
                "step_wall_s_max", "prefill_step_wall_s_max",
                "prefill_step_wall_s_max_after_first_step",
                "prefill_step_wall_s_max_without_captures",
                "steps_with_captures", "capture_s_after_first_step",
                "prefill_s_total", "decode_s_total")


def phase_serve_chunked(dev, model, out: Path, mono=None) -> dict:
    """The same trace with prefill_chunk=128 on graphs: paged bf16 (decode
    rows through kernel 1) and paged int8 (kernel 3's paged entry); each
    admitted prompt streams in one 128-token chunk per step inside the
    pipelined step (the chunk R-Parts are plain torch, as in the JAX
    package) while the other rows decode.  ``mono`` (the monolithic
    serves of this call, paged bf16 and paged int8) sit beside each run:
    the steps that ran a prefill chunk against the steps that admitted."""
    runs = []
    for quantized, kernel, prof in (
            (False, "paged_decode_attention", "serve_chunked"),
            (True, "decode_attention_int8", "serve_chunked_int8")):
        runs.append(serve_run(dev, model, out, kernel=kernel, paged=True,
                              quantized=quantized, prefill_chunk=CHUNK,
                              profile=prof))
    for r, m in zip(runs, mono or (None, None)):
        if m is not None:
            r["vs_monolithic"] = {k: [r[k], m[k]] for k in COMPARE_KEYS}
            r["tokens_equal_to_monolithic"] = r["tokens"] == m["tokens"]
    return {"phase": "serve_chunked", "ok": True, "runs": runs,
            "kernel_launches": runs[0]["kernel_launches"]}


def phase_serve_spec_int8(dev, model, out: Path, spec_off=None,
                          spec_bf16=None) -> dict:
    """The same trace with spec_decode=SpecConfig(k=3) and quantized_kv=
    True, paged (every verify through kernel 3's multi-token entry,
    reading the int8 pools in place: no gather; no decode kernel) and
    dense (the int8 chunk R-Part, plain torch: no kernel at all).  Beside
    each run: the spec-off int8 serve of the same storage (``spec_off``:
    tokens equal, reported, not required, as in bf16), the bf16 spec
    serve (``spec_bf16``: tokens/s), and the divergence from spec-off int8
    triaged teacher-forced (``spec_triage``: first differing token, top-2
    margin, max logit difference)."""
    paged = serve_run(dev, model, out, kernel="verify_int8", paged=True,
                      quantized=True, spec_k=3, profile="serve_spec_int8")
    dense = serve_run(dev, model, out, kernel=None, paged=False,
                      quantized=True, spec_k=3)
    for r, off in zip((paged, dense), spec_off or (None, None)):
        if off is None:
            continue
        same = [rid for rid, toks in r["tokens"].items()
                if off["tokens"][rid] == toks]
        r["requests_equal_to_spec_off"] = len(same) / len(r["tokens"])
        r["first_diff_vs_spec_off"] = {
            rid: next((i for i, (a, b) in enumerate(
                zip(toks, off["tokens"][rid])) if a != b), None)
            for rid, toks in r["tokens"].items()}
        r["tokens_per_s_ratio_to_spec_off"] = (
            r["decode_tokens_per_s"] / off["decode_tokens_per_s"])
    if spec_bf16 is not None:
        paged["tokens_per_s_ratio_to_bf16_spec"] = (
            paged["decode_tokens_per_s"] / spec_bf16["decode_tokens_per_s"])
    # the int8 spec-on/spec-off divergence at the serve's depth, triaged
    # teacher-forced as the bf16 one is (serve_spec)
    for r, off, is_paged in zip((paged, dense), spec_off or (None, None),
                                (True, False)):
        r["triage"] = spec_triage(dev, model, r, off, quantized=True,
                                  paged=is_paged)
    return {"phase": "serve_spec_int8", "ok": True, "runs": [paged, dense],
            "kernel_launches": paged["kernel_launches"]}


def spec_triage(dev, model, spec_rec, off_rec, quantized=False,
                paged=True) -> dict:
    """The spec-on/spec-off divergence of one storage (bf16 paged by
    default; ``quantized``: int8, paged or dense), teacher-forced: the
    spec-off and spec-on engines (graphs) serve the counted trace again,
    every logits row that chose a token logged.  Where a request's tokens first
    differ, both histories agree before that token, so the two rows that
    chose it were fed the same tokens: their max difference and the
    spec-off row's top-2 margin say whether a near-tie flipped (margin
    below the difference) or the computations part (a fault).  Beside
    them, the largest difference on tokens before any divergence: how far
    a C-token verify and a one-token decode part in bf16.  The port
    functions compared: the verify path (``_chunk_*`` transitions and the
    verify R-Part) against the decode path (``_advance`` and the decode
    R-Part), both of the port, named in ``functions``."""
    from repro_torch.serving.engine import ServingEngine, SpecConfig
    cfg, params = model["cfg"], model["params"]
    logs = {}
    for name, spec in (("off", None), ("spec", SpecConfig(k=3))):
        eng = ServingEngine(params, cfg, backend="hetero", num_r_workers=2,
                            num_microbatches=2, paged_kv=paged,
                            quantized_kv=quantized, page_size=16,
                            batch=8, cache_len=1024, device=dev,
                            spec_decode=spec)
        try:
            logs[name], _ = _serve_logged(eng, _requests(
                np.random.default_rng(0), 12, 17, 600, 16, 32,
                cfg.vocab_size))
        finally:
            eng.close()
    before, parted, same_logits, _ = _compare(logs["spec"], logs["off"],
                                              0.0)
    parted += same_logits
    flips = sum(1 for r in parted if r["logit_diff"] is not None
                and r["top2_margin"] < r["logit_diff"])
    same_as_counted = (
        {rid: t for rid, (t, _) in logs["spec"].items()}
        == spec_rec["tokens"]
        and (off_rec is None or {rid: t for rid, (t, _)
                                 in logs["off"].items()}
             == off_rec["tokens"]))
    verify = ("kernel 3 multi-token paged entry (paged_cache."
              "r_attention_paged_verify)" if quantized and paged
              else "kv_cache.r_attention_int8_chunk" if quantized
              else "kernel 4 (paged_cache.r_attention_paged_verify)")
    decode = ("kernel 3 paged entry (paged_cache.r_attention_paged_tables)"
              if quantized and paged else "kernel 3 (kv_cache."
              "r_attention_int8)" if quantized
              else "kernel 1 (paged_cache.r_attention_paged_tables)")
    return {"storage": ("paged-" if paged else "dense-")
            + ("int8" if quantized else cfg.dtype),
            "functions": {"spec_on": "HeteroPipelineEngine._chunk_start/"
                          "_chunk_advance + " + verify,
                          "spec_off": "HeteroPipelineEngine._start/_advance "
                          "+ " + decode},
            "diverging_requests": len(parted), "requests": len(logs["off"]),
            "first_diffs": sorted(parted, key=lambda r: r["rid"]),
            "max_logit_diff_before_divergence": before,
            "max_logit_diff_at_first_diff": max(
                (r["logit_diff"] for r in parted
                 if r["logit_diff"] is not None), default=None),
            "near_tie_flips": flips,
            "tokens_equal_to_counted_runs": same_as_counted}


def _profile_steps(eng, n_steps: int, out: Path, name: str,
                   trace: bool) -> dict:
    """torch.profiler over ``n_steps`` decode steps: the device's busy
    share of the wall window (union of kernel and copy intervals over all
    streams), device time by kernel, and host time by op.  The full
    table (and, with ``trace``, the Chrome trace) go to ``out`` as
    ``<name>_profile.txt`` / ``<name>_trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in dev_events)
    # the sink's round trip on the device: D2H of r_out, H2D of gather
    memcpy_us = sum(e.time_range.end - e.time_range.start
                    for e in dev_events if "Memcpy" in e.name)
    busy_us, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy_us += cur_e - cur_s

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    top_dev = [{"name": e.key[:80], "count": e.count,
                "device_ms": dev(e) / 1e3}
               for e in sorted(ka, key=dev, reverse=True)[:10]]
    top_cpu = [{"name": e.key[:80], "count": e.count,
                "cpu_self_ms": e.self_cpu_time_total / 1e3}
               for e in sorted(ka, key=lambda e: e.self_cpu_time_total,
                               reverse=True)[:10]]
    # the attention kernels and their merge kernels, by name
    attn = {}
    for e in ka:
        for kname in ("paged_attn_kernel", "merge_splits",
                      "dense_attn_kernel", "dense_merge"):
            if kname in e.key and dev(e) > 0:
                c, ms = attn.get(kname, (0, 0.0))
                attn[kname] = (c + e.count, ms + dev(e) / 1e3)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}_profile.txt").write_text(ka.table(
        sort_by="self_cpu_time_total", row_limit=60))
    if trace:
        prof.export_chrome_trace(str(out / f"{name}_trace.json"))
    # CUDA runtime calls by name; a host launch is a kernel launch or a
    # graph launch (a replay is one call however many kernels it holds)
    runtime = {e.key: e.count for e in ka if e.key.startswith("cuda")}
    launch_names = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cudaGraphLaunch")
    return {"steps": n_steps, "wall_s": wall_s,
            "device_busy_s": busy_us / 1e6,
            "device_idle_ratio": 1.0 - busy_us / 1e6 / wall_s,
            "memcpy_device_s": memcpy_us / 1e6,
            "host_launches": sum(runtime.get(n, 0) for n in launch_names),
            "graph_launches_host": runtime.get("cudaGraphLaunch", 0),
            "runtime_calls": runtime,
            "kernel_launches_host": sum(e.count for e in ka
                                        if e.key == "cudaLaunchKernel"),
            "attention_device": {
                kname: {"count": c, "device_ms": ms}
                for kname, (c, ms) in attn.items()},
            "top_device": top_dev, "top_host": top_cpu}


# ---------------------------------------------------------------------------
# equiv phases: fp32 at 2 layers, TF32 off
# ---------------------------------------------------------------------------
EQUIV_LOGIT_TOL = 1e-4     # fp32 logits, TF32 off
QUANT_BOUND = 0.5          # int8 vs fp logits, as tests/test_hetero.py holds


def _serve_logged(eng, reqs, forced=None, on_step=None, arrive=None,
                  rows=None):
    """Serve ``reqs`` step by step.  Returns ({rid: (tokens, [logits of
    each decode step that sampled a token of it, on the host])}, the
    token array of every sampling call).  With ``forced`` the engine is
    fed other tokens in place of its own choice, so its logits are
    teacher-forced: a list of such token arrays from another run of the
    same engine, call by call, or a dict {rid: tokens} from any run of
    the same requests (each sampling call names the request of each of
    its rows).  ``arrive`` ({rid: step}) submits a request before that
    step (default 0); ``rows`` (a dict), when given, receives the logits
    row that chose every token, prefill and decode alike, keyed (rid,
    token index; ``_TokenLog``).  ``on_step(eng)`` runs after every
    step."""
    import torch
    toklog = _TokenLog(eng, rows).__enter__()
    sampled = []
    logs = {r.rid: [] for r in reqs}
    own_sample, own_decode = eng._sample_tokens, eng.engine.decode_step
    in_decode = [False]

    def decode_step(*args):
        # a chunk-only step (a spec verify) samples nothing: its logits
        # are logged at the accept walk, and the next sampling call may
        # be an admission's prefill
        in_decode[0] = args[0] is not None
        return own_decode(*args)

    def sample(logits, reqs_):
        toks = own_sample(logits, reqs_)
        if isinstance(forced, dict):
            toks = toks.copy()
            for i, r in enumerate(reqs_):
                if r is not None:
                    toks[i] = forced[r.rid][len(r.generated)]
        elif forced is not None:
            toks = forced[len(sampled)].copy()
        if in_decode[0]:        # the RUNNING rows of a decode step
            lg = logits.float().cpu()
            for i, r in enumerate(reqs_):
                if r is not None:
                    logs[r.rid].append(lg[i])
        in_decode[0] = False
        sampled.append(toks)
        return toks

    eng._sample_tokens, eng.engine.decode_step = sample, decode_step
    # a spec step chooses its tokens in sampler.spec_accept, one call per
    # live row in _spec_rows order: the logits row that chose committed
    # token i of a call is logits[i]
    from repro_torch.serving import engine as E
    own_accept = E.spec_accept
    if eng.spec is not None:
        if forced is not None:
            raise ValueError("teacher forcing is not wired for spec steps")
        own_rows, live, calls = eng._spec_rows, [], [0]

        def spec_rows():
            live[:] = own_rows()
            calls[0] = 0
            return list(live)

        def accept(logits, draft, *a, **kw):
            toks, acc = own_accept(logits, draft, *a, **kw)
            r = live[calls[0]][1]
            calls[0] += 1
            lg = logits.float().cpu()
            logs[r.rid].extend(lg[i] for i in range(len(toks)))
            return toks, acc
        eng._spec_rows, E.spec_accept = spec_rows, accept
    arrive = arrive or {}
    pending = sorted(reqs, key=lambda r: arrive.get(r.rid, 0))
    try:
        while pending or eng.queue \
                or any(s is not None for s in eng.slots):
            while pending and arrive.get(pending[0].rid, 0) <= eng.step_idx:
                eng.submit(pending.pop(0))
            eng.step()
            if on_step is not None:
                on_step(eng)
            if eng.step_idx > 400:
                raise AssertionError("equiv serve did not drain in 400 "
                                     "steps")
    finally:
        E.spec_accept = own_accept
        toklog.__exit__(None, None, None)
    torch.cuda.synchronize()
    return ({r.rid: (list(r.generated), logs[r.rid]) for r in eng.finished
             if r.rid in logs}, sampled)


def _compare(got, want, tol):
    """Greedy tokens and decode logits of two runs of the same requests.
    A token mismatch is a fault unless the logits that chose it (both
    histories agree up to it, so they are teacher-forced) are within
    ``tol``.  Returns (max logit diff, mismatches, near-tie flips, min
    top-2 margin of ``want``)."""
    max_diff, mismatches, ties = 0.0, [], []
    margins = [float(v[0] - v[1]) for _, logs in want.values()
               for v in (lg.topk(2).values for lg in logs)]
    for rid, (toks_w, logs_w) in want.items():
        toks_g, logs_g = got[rid]
        first = next((i for i, (a, b) in enumerate(zip(toks_g, toks_w))
                      if a != b), None)
        # token j comes from decode step j-1 (token 0 from prefill);
        # after a flip the histories differ and the logits do not compare
        n = min(len(logs_w), len(logs_g))
        if first is not None:
            n = min(n, first)
        for j in range(n):
            max_diff = max(max_diff,
                           float((logs_g[j] - logs_w[j]).abs().max()))
        if first is not None:
            j = first
            lg = logs_w[j - 1] if j >= 1 else None
            top2 = (float(lg.topk(2).values[0] - lg.topk(2).values[1])
                    if lg is not None else None)
            d = (float((logs_g[j - 1] - logs_w[j - 1]).abs().max())
                 if j >= 1 else None)
            rec = {"rid": rid, "first_diff": j, "top2_margin": top2,
                   "logit_diff": d}
            if d is not None and d <= tol:
                ties.append(rec)        # a near-tie flipped: not a fault
            else:
                mismatches.append(rec)
    return max_diff, mismatches, ties, min(margins)


def _equiv_model(dev, seed):
    import dataclasses
    import torch
    from repro_torch.core.config import get_arch
    from repro_torch.models.model import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = dataclasses.replace(get_arch("qwen3-8b"), num_layers=2,
                              dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         device=dev)
    spec = dict(n=6, p_lo=17, p_hi=200, new_lo=6, new_hi=10,
                vocab=cfg.vocab_size)
    return cfg, params, spec


def _equiv_serve(dev, cfg, params, spec, forced=None, stats=None,
                 eager=False, on_step=None, reqs=None, arrive=None,
                 rows=None, batch=4, **kw):
    """``stats`` (a dict), when given, receives the engine's spec_stats;
    ``eager`` runs the step callables op by op instead of replaying their
    graphs; ``on_step(eng)`` runs after every step; ``reqs`` (made anew
    for each serve: a function of no argument) replaces the trace of
    ``spec``, ``arrive`` and ``rows`` go to ``_serve_logged``.  Hetero
    engines have 2 R-workers, 2 micro-batches and pages of 16 unless
    ``kw`` says otherwise; ``batch`` rows (4)."""
    from repro_torch.core import graphs
    from repro_torch.serving.engine import ServingEngine
    hetero = kw.get("backend") == "hetero"
    if hetero:
        kw = dict(dict(num_r_workers=2, num_microbatches=2, page_size=16),
                  **kw)
    eng = ServingEngine(params, cfg, batch=batch, cache_len=256, device=dev,
                        **kw)
    try:
        with (graphs.eager() if eager else contextlib.nullcontext()):
            return _serve_logged(
                eng, reqs() if reqs is not None else _requests(
                    np.random.default_rng(2), **spec), forced, on_step,
                arrive, rows)
    finally:
        eng.close()
        if stats is not None:
            stats.update(eng.spec_stats)


def _graphs_equal_eager(name, got, eager) -> float:
    """Graph tokens must equal eager tokens, every logit within
    EQUIV_LOGIT_TOL (fp32: the replays run the eager path's kernels).
    Returns the max logit difference."""
    max_diff, mismatches, ties, _ = _compare(got, eager, EQUIV_LOGIT_TOL)
    if mismatches or ties or max_diff > EQUIV_LOGIT_TOL:
        raise AssertionError(
            f"{name}: graphs != eager: mismatches {mismatches}, near-tie "
            f"flips {ties}, max logit diff {max_diff} (tol "
            f"{EQUIV_LOGIT_TOL})")
    return max_diff


def phase_equiv(dev) -> dict:
    from repro_torch.kernels import paged_attention as PA
    cfg, params, spec = _equiv_model(dev, 1)
    PA.launches.reset()
    got, _ = _equiv_serve(dev, cfg, params, spec, backend="hetero",
                          paged_kv=True)
    launches = PA.launches.value
    eager, _ = _equiv_serve(dev, cfg, params, spec, eager=True,
                            backend="hetero", paged_kv=True)
    vs_eager = _graphs_equal_eager("hetero-paged", got, eager)
    want, _ = _equiv_serve(dev, cfg, params, spec, backend="colocated")
    max_diff, mismatches, ties, margin = _compare(got, want, EQUIV_LOGIT_TOL)
    if mismatches or max_diff > EQUIV_LOGIT_TOL or launches == 0:
        raise AssertionError(
            f"hetero-paged != colocated: mismatches {mismatches}, max "
            f"logit diff {max_diff} (tol {EQUIV_LOGIT_TOL}), kernel "
            f"launches {launches}")
    return {"phase": "equiv", "ok": True, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "dtype": "float32", "tf32": False,
            "requests": len(want), "tokens_equal": not ties,
            "near_tie_flips": ties, "max_logit_diff": max_diff,
            "min_top2_margin": margin, "graphs_equal_eager": True,
            "max_logit_diff_vs_eager": vs_eager,
            "logit_tol": EQUIV_LOGIT_TOL, "kernel_launches": launches}


def phase_equiv_int8(dev) -> dict:
    """Hetero paged-int8 (gather + kernel 3) == hetero dense-int8 (kernel
    3 over the slab), both launching kernel 3, and both within the
    quantization bound of the colocated fp engine fed the same tokens."""
    from repro_torch.kernels import quant_kv as QK
    cfg, params, spec = _equiv_model(dev, 1)
    runs, launches = {}, {}
    vs_eager = {}
    for name, paged in (("paged-int8", True), ("dense-int8", False)):
        QK.launches.reset()
        runs[name] = _equiv_serve(dev, cfg, params, spec, backend="hetero",
                                  paged_kv=paged, quantized_kv=True)
        launches[name] = QK.launches.value
        eager, _ = _equiv_serve(dev, cfg, params, spec, eager=True,
                                backend="hetero", paged_kv=paged,
                                quantized_kv=True)
        vs_eager[name] = _graphs_equal_eager(name, runs[name][0], eager)
    (paged, sampled), (dense, _) = runs["paged-int8"], runs["dense-int8"]
    max_diff, mismatches, ties, margin = _compare(paged, dense,
                                                  EQUIV_LOGIT_TOL)
    if mismatches or ties or max_diff > EQUIV_LOGIT_TOL \
            or min(launches.values()) == 0:
        raise AssertionError(
            f"hetero paged-int8 != dense-int8: mismatches {mismatches}, "
            f"near-tie flips {ties}, max logit diff {max_diff} (tol "
            f"{EQUIV_LOGIT_TOL}), kernel-3 launches {launches}")
    # the fp colocated engine, teacher-forced on the int8 runs' tokens
    fp, _ = _equiv_serve(dev, cfg, params, spec, forced=sampled,
                         backend="colocated")
    quant = {}
    for name, (run, _) in runs.items():
        quant[name] = max(float((a - b).abs().max())
                          for rid, (_, logs) in run.items()
                          for a, b in zip(logs, fp[rid][1]))
    if max(quant.values()) > QUANT_BOUND:
        raise AssertionError(f"int8 logits differ from the fp engine's by "
                             f"{quant} > {QUANT_BOUND}")
    return {"phase": "equiv_int8", "ok": True, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "dtype": "float32", "tf32": False,
            "requests": len(paged), "tokens_equal": True,
            "max_logit_diff": max_diff, "min_top2_margin": margin,
            "logit_tol": EQUIV_LOGIT_TOL, "kernel_launches": launches,
            "max_logit_diff_vs_fp": quant, "quant_bound": QUANT_BOUND,
            "graphs_equal_eager": True, "max_logit_diff_vs_eager": vs_eager}


def phase_equiv_spec(dev) -> dict:
    """Speculative decoding (self-speculation, k = 3) at 2 layers, fp32,
    TF32 off: hetero paged (every verify through kernel 4) and hetero
    dense (plain torch, no kernel at all) must each give the colocated
    spec-off engine's greedy tokens, a flip counting only if the
    teacher-forced logits that chose it differ beyond tolerance."""
    from repro_torch.serving.engine import SpecConfig
    cfg, params, spec = _equiv_model(dev, 1)
    want, _ = _equiv_serve(dev, cfg, params, spec, backend="colocated")
    runs = {}
    for name, paged in (("paged", True), ("dense", False)):
        _reset_counters()
        stats = {}
        got, _ = _equiv_serve(dev, cfg, params, spec, stats=stats,
                              backend="hetero", paged_kv=paged,
                              spec_decode=SpecConfig(k=3))
        launches = {n: c[0].value for n, c in _counters().items()}
        eager, _ = _equiv_serve(dev, cfg, params, spec, eager=True,
                                backend="hetero", paged_kv=paged,
                                spec_decode=SpecConfig(k=3))
        vs_eager = _graphs_equal_eager(f"spec {name}", got, eager)
        max_diff, mismatches, ties, margin = _compare(got, want,
                                                      EQUIV_LOGIT_TOL)
        want_kernels = ({"paged_verify_attention"} if paged else set())
        launched = {n for n, v in launches.items() if v}
        if mismatches or max_diff > EQUIV_LOGIT_TOL \
                or launched != want_kernels:
            raise AssertionError(
                f"spec hetero-{name} != colocated spec-off: mismatches "
                f"{mismatches}, max logit diff {max_diff} (tol "
                f"{EQUIV_LOGIT_TOL}), kernel launches {launches} (want "
                f"only {sorted(want_kernels)})")
        runs[name] = {"tokens_equal": not ties, "near_tie_flips": ties,
                      "max_logit_diff": max_diff, "min_top2_margin": margin,
                      "kernel_launches": launches, "spec_stats": stats,
                      "graphs_equal_eager": True,
                      "max_logit_diff_vs_eager": vs_eager,
                      "acceptance_rate": stats["accepted_tokens"]
                      / max(1, stats["drafted_tokens"])}
    return {"phase": "equiv_spec", "ok": True, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "dtype": "float32", "tf32": False,
            "spec_k": 3, "requests": len(want),
            "logit_tol": EQUIV_LOGIT_TOL, "runs": runs}


def _int8_storage_check(dev, cfg, params) -> dict:
    """The int8 K/V and scales that the chunk R-Parts write chunk by chunk
    (5 tokens a chunk, dense slab and paged pool with pages of 16) against
    those a monolithic load writes (``kv_cache.quantize_attn_state``, as
    ``RWorker.write_rows`` stores an admitted prefill, and
    ``paged_cache.dense_rows_to_pages``), on the same fp32 K/V: every
    layer's of the model's prefill of four prompts of 17-200 tokens.  They
    must be bit-identical (quantization per (token, head), whatever the
    chunking).  In a serve the K/V themselves differ past layer 0: chunk
    attention reads the earlier chunks' dequantized keys, a monolithic
    prefill fp ones (as in the JAX package)."""
    import torch
    from repro_torch.core.config import ATTN
    from repro_torch.core.decompose import split_block_state
    from repro_torch.core.hetero import per_layer_state
    from repro_torch.kernels import ref
    from repro_torch.models.model import prefill
    from repro_torch.serving import kv_cache as KV
    from repro_torch.serving import paged_cache as PC
    rng = np.random.default_rng(5)
    plens = [17, 200, 64, 131]
    n, cache, c, page = len(plens), 256, 5, 16
    toks = np.zeros((n, cache), np.int32)
    for i, ln in enumerate(plens):
        toks[i, :ln] = rng.integers(1, cfg.vocab_size, ln)
    _, state = prefill(params, cfg, torch.from_numpy(toks).to(dev),
                       torch.tensor(plens, dtype=torch.int32, device=dev),
                       cache)
    names = ("k_q", "k_s", "v_q", "v_s")
    compared = 0
    for li, layer in enumerate(per_layer_state(state, cfg)):
        st, _ = split_block_state(ATTN, layer)
        hkv, dh = st["k"].shape[2:]
        mono = KV.quantize_attn_state(st)
        slab = {"k_q": torch.zeros_like(mono["k_q"]),
                "k_s": torch.zeros_like(mono["k_s"]),
                "v_q": torch.zeros_like(mono["v_q"]),
                "v_s": torch.zeros_like(mono["v_s"]),
                "pos": torch.full_like(mono["pos"], -1)}
        mp = cache // page
        pools, allocs = [], []
        for _ in range(2):
            allocs.append(PC.PagedAllocator(n, n * mp, page, mp,
                                            device=dev))
            pools.append(PC.init_page_pool(n * mp, page, hkv, dh,
                                           quantized=True, device=dev))
        PC.dense_rows_to_pages(pools[0], allocs[0], np.arange(n), st)
        lens = torch.tensor(plens, device=dev)
        for c0 in range(0, max(plens), c):
            off = torch.arange(c0, c0 + c, device=dev)
            r_in = {"q": torch.zeros((n, c, cfg.num_heads, dh), device=dev),
                    "k": st["k"][:, c0:c0 + c], "v": st["v"][:, c0:c0 + c],
                    "lengths": torch.full((n,), c0, dtype=torch.int32,
                                          device=dev),
                    "valid": off[None, :] < lens[:, None]}
            KV.r_attention_int8_chunk(r_in, slab, window=0, softcap=0.0)
            counts = r_in["valid"].sum(dim=1).cpu().numpy()
            allocs[1].append_chunk(np.full(n, c0), counts)
            PC.r_attention_paged_chunk(r_in, pools[1],
                                       allocs[1].tables_device())
        ok = mono["pos"] >= 0
        if not torch.equal(slab["pos"], mono["pos"]):
            raise AssertionError(f"layer {li}: chunked slab positions differ")
        for name in names:
            if not torch.equal(slab[name][ok], mono[name][ok]):
                raise AssertionError(f"layer {li}: the dense chunk writer's "
                                     f"{name} differs from the monolithic "
                                     f"load's")
            got = ref.paged_gather(pools[1][name],
                                   allocs[1].tables_device())[0]
            want = ref.paged_gather(pools[0][name],
                                    allocs[0].tables_device())[0]
            for i, ln in enumerate(plens):
                if not torch.equal(got[i, :ln], want[i, :ln]):
                    raise AssertionError(
                        f"layer {li} row {i}: the paged chunk writer's "
                        f"{name} differs from the monolithic load's")
        compared += int(ok.sum())
    return {"layers": cfg.num_layers, "prompt_tokens": plens, "chunk": c,
            "page": page, "token_slots_compared_per_storage": compared,
            "bit_identical": True}


def phase_equiv_chunk(dev) -> dict:
    """Chunked prefill at 2 layers, fp32, TF32 off: hetero
    prefill_chunk=5 on dense storage and on paged storage with pages of 4
    and 16, OoO and FIFO, must give the colocated monolithic engine's
    greedy tokens (a flip counting only if the teacher-forced logits that
    chose it differ beyond tolerance), the paged OoO run at pages of 16
    also its eager run's; int8 chunked runs (dense, paged) stay within
    the quantization bound of the colocated fp engine fed their tokens,
    and the chunk writers store the int8 bytes a monolithic load stores
    (``_int8_storage_check``); and prefill chunks sharing chunk-only steps
    with verify works (paged, prefill_chunk=5, spec k = 2) give the
    colocated spec-off tokens."""
    from repro_torch.serving.engine import SpecConfig
    cfg, params, spec = _equiv_model(dev, 1)
    want, _ = _equiv_serve(dev, cfg, params, spec, backend="colocated")
    runs = {}
    for name, storage in (("dense", {}),
                          ("paged4", dict(paged_kv=True, page_size=4)),
                          ("paged16", dict(paged_kv=True, page_size=16))):
        for schedule in ("ooo", "fifo"):
            _reset_counters()
            got, _ = _equiv_serve(dev, cfg, params, spec, backend="hetero",
                                  prefill_chunk=5, schedule=schedule,
                                  **storage)
            launches = {n: c[0].value for n, c in _counters().items()}
            max_diff, mismatches, ties, margin = _compare(got, want,
                                                          EQUIV_LOGIT_TOL)
            want_kernels = ({"paged_decode_attention"} if storage
                            else set())
            launched = {n for n, v in launches.items() if v}
            if mismatches or max_diff > EQUIV_LOGIT_TOL \
                    or launched != want_kernels:
                raise AssertionError(
                    f"chunked hetero-{name}-{schedule} != colocated: "
                    f"mismatches {mismatches}, max logit diff {max_diff} "
                    f"(tol {EQUIV_LOGIT_TOL}), kernel launches {launches}")
            rec = {"tokens_equal": not ties, "near_tie_flips": ties,
                   "max_logit_diff": max_diff, "min_top2_margin": margin,
                   "kernel_launches": launches}
            if name == "paged16" and schedule == "ooo":
                eager, _ = _equiv_serve(dev, cfg, params, spec, eager=True,
                                        backend="hetero", prefill_chunk=5,
                                        **storage)
                rec["max_logit_diff_vs_eager"] = _graphs_equal_eager(
                    "chunked paged16", got, eager)
            runs[f"{name}-{schedule}"] = rec
    # int8: within the quantization bound of fp, teacher-forced
    int8 = {}
    for name, paged in (("dense-int8", False), ("paged-int8", True)):
        got, _ = _equiv_serve(dev, cfg, params, spec, backend="hetero",
                              prefill_chunk=5, quantized_kv=True,
                              paged_kv=paged)
        fp, _ = _equiv_serve(dev, cfg, params, spec, backend="colocated",
                             forced={rid: t for rid, (t, _) in got.items()})
        quant = max(float((a - b).abs().max())
                    for rid, (_, logs) in got.items()
                    for a, b in zip(logs, fp[rid][1]))
        if quant > QUANT_BOUND:
            raise AssertionError(f"chunked {name} logits differ from the fp "
                                 f"engine's by {quant} > {QUANT_BOUND}")
        same = sum(t == want[rid][0] for rid, (t, _) in got.items())
        int8[name] = {"max_logit_diff_vs_fp": quant,
                      "requests_equal_to_fp": same / len(got)}
    storage = _int8_storage_check(dev, cfg, params)
    # prefill chunks and verify works sharing chunk-only steps
    shared = [0]

    def count_shared(eng):
        works = eng.engine.prefill_results
        fills = {wk.mb for wk in works if not wk.verify}
        shared[0] += bool(fills & {wk.mb for wk in works if wk.verify})
    got, _ = _equiv_serve(dev, cfg, params, spec, backend="hetero",
                          paged_kv=True, prefill_chunk=5,
                          spec_decode=SpecConfig(k=2), on_step=count_shared)
    max_diff, mismatches, ties, margin = _compare(got, want, EQUIV_LOGIT_TOL)
    if mismatches or max_diff > EQUIV_LOGIT_TOL or not shared[0]:
        raise AssertionError(
            f"spec k=2 + chunked paged != colocated spec-off: mismatches "
            f"{mismatches}, max logit diff {max_diff}, steps sharing a "
            f"micro-batch {shared[0]}")
    runs["spec2-chunked-paged16"] = {
        "tokens_equal": not ties, "near_tie_flips": ties,
        "max_logit_diff": max_diff, "min_top2_margin": margin,
        "steps_sharing_a_micro_batch": shared[0]}
    return {"phase": "equiv_chunk", "ok": True, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "dtype": "float32", "tf32": False,
            "prefill_chunk": 5, "requests": len(want),
            "logit_tol": EQUIV_LOGIT_TOL, "runs": runs, "int8": int8,
            "quant_bound": QUANT_BOUND, "int8_storage": storage}


def phase_equiv_spec_int8(dev) -> dict:
    """Speculative decoding on int8 storage (self-speculation, k = 3) at
    2 layers, fp32, TF32 off: hetero paged-int8 (every verify through
    kernel 3's multi-token entry) and dense-int8 (the int8 chunk R-Part,
    no kernel) must each give the spec-off int8 engine's greedy tokens of
    the same storage, a flip counting only if the teacher-forced logits
    that chose it differ beyond tolerance; the paged run's graphs also its
    eager run's.  The tolerance is the int8 bound, not fp32's: the verify
    computes K/V in products of C tokens where a decode computes them one
    token at a time, and a last-bit difference that crosses a rounding
    boundary of the quantization moves a stored value by one int8 step
    (and the dense chunk R-Part, as the JAX package's, attends the
    candidates' own K/V in fp where a decode reads them back
    quantized)."""
    from repro_torch.serving.engine import SpecConfig
    cfg, params, spec = _equiv_model(dev, 1)
    runs = {}
    for name, paged in (("paged-int8", True), ("dense-int8", False)):
        want, _ = _equiv_serve(dev, cfg, params, spec, backend="hetero",
                               paged_kv=paged, quantized_kv=True)
        _reset_counters()
        stats = {}
        got, _ = _equiv_serve(dev, cfg, params, spec, stats=stats,
                              backend="hetero", paged_kv=paged,
                              quantized_kv=True, spec_decode=SpecConfig(k=3))
        launches = {n: c[0].value for n, c in _counters().items()}
        tol = QUANT_BOUND
        max_diff, mismatches, ties, margin = _compare(got, want, tol)
        want_kernels = {"verify_int8"} if paged else set()
        launched = {n for n, v in launches.items() if v}
        if mismatches or max_diff > tol or launched != want_kernels:
            raise AssertionError(
                f"spec {name} != spec-off {name}: mismatches {mismatches}, "
                f"max logit diff {max_diff} (tol {tol}), kernel "
                f"launches {launches} (want only {sorted(want_kernels)})")
        rec = {"logit_tol": tol, "tokens_equal": not ties,
               "near_tie_flips": ties,
               "max_logit_diff": max_diff, "min_top2_margin": margin,
               "kernel_launches": launches, "spec_stats": stats,
               "acceptance_rate": stats["accepted_tokens"]
               / max(1, stats["drafted_tokens"])}
        if paged:
            eager, _ = _equiv_serve(dev, cfg, params, spec, eager=True,
                                    backend="hetero", paged_kv=True,
                                    quantized_kv=True,
                                    spec_decode=SpecConfig(k=3))
            rec["max_logit_diff_vs_eager"] = _graphs_equal_eager(
                f"spec {name}", got, eager)
        runs[name] = rec
    return {"phase": "equiv_spec_int8", "ok": True, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "dtype": "float32", "tf32": False,
            "spec_k": 3, "requests": spec["n"], "runs": runs}


# ---------------------------------------------------------------------------
# sampled decoding, the prefix cache, tiering and preemption
# ---------------------------------------------------------------------------
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)


def _sampled(reqs):
    """Every odd request of a trace samples (``SAMPLING``); the even ones
    stay greedy."""
    for r in reqs:
        if r.rid % 2:
            r.temperature, r.top_k, r.top_p = (SAMPLING["temperature"],
                                               SAMPLING["top_k"],
                                               SAMPLING["top_p"])
    return reqs


def _compare_rows(got, want, rows_g, rows_w, tol):
    """Tokens of two runs of the same requests with the logits row that
    chose every token (``rows``: (rid, token index) -> row, prefill,
    resume and decode alike).  A token mismatch is a fault unless the
    rows that chose it (both histories agree up to it: teacher-forced)
    are within ``tol``.  Returns (max row difference before any
    divergence, mismatches, near-tie flips, min top-2 margin of
    ``want``'s rows)."""
    max_diff, mismatches, ties, margins = 0.0, [], [], []
    for rid, toks_w in want.items():
        toks_g = got[rid]
        first = next((i for i, (a, b) in enumerate(zip(toks_g, toks_w))
                      if a != b), None)
        n = len(toks_w) if first is None else first
        for j in range(n):
            a, b = rows_g.get((rid, j)), rows_w.get((rid, j))
            if a is None or b is None:
                continue
            max_diff = max(max_diff, float((a - b).abs().max()))
            top = b.topk(2).values
            margins.append(float(top[0] - top[1]))
        if first is None:
            continue
        a, b = rows_g.get((rid, first)), rows_w.get((rid, first))
        top = b.topk(2).values if b is not None else None
        rec = {"rid": rid, "first_diff": first,
               "top2_margin": None if top is None
               else float(top[0] - top[1]),
               "logit_diff": None if a is None or b is None
               else float((a - b).abs().max())}
        if rec["logit_diff"] is not None and rec["logit_diff"] <= tol:
            ties.append(rec)
        else:
            mismatches.append(rec)
    return max_diff, mismatches, ties, min(margins, default=None)


def _triage(got, want, rows_g, rows_w) -> dict:
    """The ROADMAP §3 rule on two bf16 full-depth runs of one trace: at
    each request's first differing token (teacher-forced: the histories
    agree before it) the max logit difference of the rows that chose it
    and the top-2 margin of ``want``'s row, beside the largest difference
    on tokens before any divergence (how far the two paths part on
    agreeing tokens).  A flip whose difference is within that is a
    near-tie flip of bf16 rounding."""
    before, parted, _, margin = _compare_rows(got, want, rows_g, rows_w,
                                              -1.0)
    flips = [r for r in parted if r["logit_diff"] is not None
             and r["logit_diff"] <= before]
    return {"requests": len(want),
            "requests_equal": sum(got[rid] == t for rid, t in want.items()),
            "first_diffs": sorted(parted, key=lambda r: r["rid"]),
            "max_logit_diff_before_divergence": before,
            "min_top2_margin": margin,
            "near_tie_flips": len(flips),
            "not_near_tie": [r["rid"] for r in parted if r not in flips]}


def phase_serve_sampled(dev, model, out: Path, greedy=None) -> dict:
    """The 12-request trace with every odd request sampled (temperature
    0.8, top-k 50, top-p 0.95; the even ones greedy), paged bf16 on
    graphs: twice with seed 0 (tokens identical) and once with seed 1,
    then with spec_decode=SpecConfig(k=3) (rejection sampling against the
    greedy self-drafter).  Every sampled token must lie in the support of
    ``target_probs`` of the logits row that chose it; the greedy rows are
    compared with the greedy serve's (``greedy``), reported."""
    def reqs():
        return _sampled(_requests(np.random.default_rng(0), 12, 17, 600,
                                  16, 32, model["cfg"].vocab_size))
    kw = dict(kernel="paged_decode_attention", paged=True, quantized=False,
              check_support=True)
    runs = [serve_run(dev, model, out, reqs=reqs(), engine_kw=dict(seed=s),
                      **kw) for s in (0, 0, 1)]
    spec = serve_run(dev, model, out, reqs=reqs(), engine_kw=dict(seed=0),
                     **dict(kw, kernel="paged_verify_attention", spec_k=3))
    same = runs[0]["tokens"] == runs[1]["tokens"]
    sampled = [rid for rid in runs[0]["tokens"] if rid % 2]
    other = sum(runs[0]["tokens"][rid] != runs[2]["tokens"][rid]
                for rid in sampled)
    bad = {i: r["support_violations"] for i, r in
           enumerate(runs + [spec]) if r["support_violations"]}
    if not same or bad or not other \
            or not all(r["support_checked"] for r in runs + [spec]):
        raise AssertionError(
            f"sampled serve: same-seed runs equal {same}; sampled requests "
            f"that differ under another seed {other}; tokens outside the "
            f"target support {bad}")
    rec = {"phase": "serve_sampled", "ok": True, "sampling": SAMPLING,
           "sampled_requests": len(sampled), "seeds": [0, 0, 1],
           "same_seed_tokens_equal": same,
           "sampled_requests_differing_under_seed_1": other,
           "support_checked": [r["support_checked"] for r in runs + [spec]],
           "support_violations": 0,
           "runs": [{k: r[k] for k in SUMMARY_KEYS} for r in runs],
           "spec": {k: spec[k] for k in SUMMARY_KEYS + (
               "acceptance_rate", "tokens_per_row_verify", "spec_stats")},
           "kernel_launches": runs[0]["kernel_launches"]}
    if greedy is not None:
        rec["greedy_rows_equal_to_greedy_serve"] = sum(
            runs[0]["tokens"][rid] == greedy["tokens"][rid]
            for rid in runs[0]["tokens"] if rid % 2 == 0)
    return rec


def _prefix_requests(vocab, n=12, prefix=512):
    """``n`` requests sharing one ``prefix``-token prefix, each with a
    distinct 17-88-token suffix and 16-32 new tokens; request 0 arrives
    at step 0, the rest one step later."""
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(3)
    shared = rng.integers(1, vocab, prefix).astype(np.int32)
    reqs = [Request(rid=i, prompt=np.concatenate(
                [shared, rng.integers(1, vocab, int(rng.integers(17, 89)))
                 .astype(np.int32)]),
                    max_new_tokens=int(rng.integers(16, 33)))
            for i in range(n)]
    return reqs, {r.rid: int(r.rid > 0) for r in reqs}, shared


def _pages_digest(w, mb: int, ids) -> list:
    """A device-side digest of pages ``ids`` in every paged layer pool of
    worker ``w``'s micro-batch ``mb``: per pool array the sum and a
    position-weighted sum of its bytes, folded over the arrays (int64;
    one copy of two numbers to the host)."""
    import torch
    idx = torch.as_tensor(list(ids), dtype=torch.long, device=w.device)
    acc = None
    for lk in sorted(k for k in w.paged_keys
                     if k // w.cfg.num_layers == mb):
        for name in sorted(w.state[lk]):
            b = w.state[lk][name].index_select(0, idx).contiguous().view(
                torch.uint8).reshape(-1).to(torch.int64)
            wts = torch.arange(1, b.numel() + 1, device=b.device) % 65521
            d = torch.stack([b.sum(), (b * wts).sum()])
            acc = d if acc is None else acc * 31 + d
    return [int(x) for x in acc.tolist()]


class _SharedPages:
    """The ``on_step`` hook of serve_prefix: after the first step, the
    prefix pages of request 0 (its row's first ``n_pages`` table slots)
    and their digest; after every later step, while the prefix index
    still maps the prefix's chain to those pages, their digest again, and
    the most pages shared by > 1 row at once (every pool).  The serve
    must leave the shared pages' bytes unchanged."""

    def __init__(self, shared, page):
        from repro_torch.serving.paged_cache import _block_digest
        self.n_pages = len(shared) // page
        self.chain, d = [], b""
        for i in range(self.n_pages):
            d = _block_digest(d, shared[i * page:(i + 1) * page])
            self.chain.append(d)
        self.before = self.after = None
        self.checks = 0
        self.max_refcount = self.peak_shared_pages = 0

    def __call__(self, eng):
        self.peak_shared_pages = max(
            self.peak_shared_pages,
            eng.engine.prefix_cache_stats()["shared_pages"])
        if self.before is None:
            r = next(r for r in eng.slots if r is not None and r.rid == 0)
            self.w, self.mb, local = eng.engine.worker_for(r.slot)
            self.alloc = self.w.allocators[self.mb]
            self.ids = [int(p) for p in
                        self.alloc.tables[local][:self.n_pages]]
            self.before = _pages_digest(self.w, self.mb, self.ids)
            return
        entries = self.alloc.prefix.entries
        if [entries.get(d) for d in self.chain] == self.ids:
            self.after = _pages_digest(self.w, self.mb, self.ids)
            self.checks += 1
            self.max_refcount = max(self.max_refcount, int(
                self.alloc.refcount[self.ids].max()))


def phase_serve_prefix(dev, model, out: Path) -> dict:
    """The same model with prefix_cache=True: 12 requests share one
    512-token prefix (distinct 17-88-token suffixes; request 0 at step 0,
    the rest a step later).  A hit adopts the cached pages and prefills
    only its suffix, as one pow2-padded chunk.  Beside it the same trace
    with the cache off (peak resident KV, prefill wall, tokens/s).  The
    shared pages' bytes (a device-side digest) are unchanged by the
    serve; tokens are compared with the prefix-off run, a mismatch
    triaged teacher-forced (``_triage``)."""
    cfg = model["cfg"]
    reqs, arrive, shared = _prefix_requests(cfg.vocab_size)
    hook = _SharedPages(shared, 16)
    rows_on, rows_off = {}, {}
    kw = dict(kernel="paged_decode_attention", paged=True, quantized=False,
              arrive=arrive)
    on = serve_run(dev, model, out, reqs=reqs, rows=rows_on, on_step=hook,
                   engine_kw=dict(prefix_cache=True), **kw)
    off = serve_run(dev, model, out, reqs=_prefix_requests(
        cfg.vocab_size)[0], rows=rows_off, **kw)
    st = on["prefix_cache"]
    if hook.before is None or hook.after != hook.before or not hook.checks \
            or st["hits_count"] < 1 or hook.max_refcount < 2:
        raise AssertionError(
            f"serve_prefix: shared-page digest before {hook.before}, after "
            f"{hook.after} ({hook.checks} checks, max refcount "
            f"{hook.max_refcount}); prefix stats {st}")
    triage = _triage(on["tokens"], off["tokens"], rows_on, rows_off)
    keys = COMPARE_KEYS + ("paged_resident_bytes_peak",
                           "paged_referenced_bytes_peak", "capture_count",
                           "capture_s", "kernel_launches", "prefill_works",
                           "graphs_chunk_r")
    return {"phase": "serve_prefix", "ok": True, "requests": len(reqs),
            "prefix_tokens": len(shared),
            "prompt_tokens": on["prompt_tokens"], "prefix_cache": st,
            "shared_pages_digest": {"before": hook.before,
                                    "after": hook.after,
                                    "checks": hook.checks,
                                    "max_refcount": hook.max_refcount,
                                    "pages": hook.n_pages},
            "peak_shared_pages": hook.peak_shared_pages,
            "vs_prefix_off": {k: [on[k], off[k]] for k in keys},
            "resident_bytes_ratio": on["paged_resident_bytes_peak"]
            / off["paged_resident_bytes_peak"],
            "referenced_bytes_ratio": on["paged_referenced_bytes_peak"]
            / off["paged_referenced_bytes_peak"],
            "triage_vs_prefix_off": triage,
            "kernel_launches": on["kernel_launches"], "on": on, "off": off}


class _RestoreCheck:
    """While active, every restore the engine writes into a pool
    (``paged_cache.restore_pool_pages``, as hetero calls it) is read back
    on the same stream and held against its host payload bit for bit,
    per layer and array; the payload equals the swapped-out device bytes
    (the tier verified its checksum when the entry streamed back).  The
    read-back runs inside the engine's timed restore: its seconds
    (``check_s``) are reported beside ``restore_copy_s``."""

    def __enter__(self):
        import torch
        from repro_torch.serving import paged_cache as PC
        self._own = own = PC.restore_pool_pages
        self.page_layers = self.mismatches = 0
        self.bytes = 0
        self.check_s = 0.0

        def restore(pool, restores, layer_idx):
            out = own(pool, restores, layer_idx)
            t0 = time.perf_counter()
            for entry, dst in restores:
                if layer_idx not in entry.payload:
                    continue
                self.page_layers += 1
                for name, arr in pool.items():
                    got = arr[dst].to("cpu")
                    want = entry.payload[layer_idx][name]
                    self.bytes += want.numel() * want.element_size()
                    self.mismatches += int(not torch.equal(got, want))
            self.check_s += time.perf_counter() - t0
            return out
        PC.restore_pool_pages = restore
        return self

    def __exit__(self, *exc):
        from repro_torch.serving import paged_cache as PC
        PC.restore_pool_pages = self._own


TIER_PAGES = 64        # pages per (worker, micro-batch) pool in serve_tier


def phase_serve_tier(dev, model, out: Path) -> dict:
    """KV tiering with preemption at full width: kv_tiering=TierConfig(),
    preempt_after=2, pages_per_worker cut to ``TIER_PAGES`` (a row may
    need 40) so admission stalls, paged bf16 and then paged int8, each
    beside an uninterrupted serve of the same storage with the default
    (large) pool.  Finished and preempted rows park; the eviction ladder
    swaps parked pages out to host memory (D2H on the owning worker's
    stream) and a readmission's probe restores them (H2D).  Every
    restored page must equal its swapped-out bytes bit for bit
    (``_RestoreCheck``), with preemptions >= 1 and restores >= 1; tokens
    are compared with the uninterrupted serve, a mismatch triaged
    teacher-forced (``_triage``)."""
    from repro_torch.serving.paged_cache import TierConfig
    runs = {}
    for name, quantized, kernel in (
            ("paged-bf16", False, "paged_decode_attention"),
            ("paged-int8", True, "decode_attention_int8")):
        rows_t, rows_u = {}, {}
        kw = dict(kernel=kernel, paged=True, quantized=quantized)
        with _RestoreCheck() as chk:
            tier = serve_run(dev, model, out, rows=rows_t, max_steps=400,
                             engine_kw=dict(kv_tiering=TierConfig(),
                                            preempt_after=2,
                                            pages_per_worker=TIER_PAGES),
                             **kw)
        plain = serve_run(dev, model, out, rows=rows_u, **kw)
        ts = tier["tiering"]
        if ts["preemptions_count"] < 1 or ts["restore_count"] < 1 \
                or chk.mismatches or chk.page_layers < 1 \
                or ts["corrupt_count"]:
            raise AssertionError(
                f"serve_tier {name}: tiering {ts}; restored page layers "
                f"checked {chk.page_layers}, mismatching {chk.mismatches}")
        runs[name] = {
            "tiering": ts, "restored_page_layers_checked": chk.page_layers,
            "restored_bytes_checked": chk.bytes,
            "restore_check_s": chk.check_s,
            "restored_bytes_equal_swapped_out": True,
            "pages_per_worker": TIER_PAGES,
            "vs_uninterrupted": {k: [tier[k], plain[k]] for k in
                                 COMPARE_KEYS + ("decode_steps",
                                                 "paged_resident_bytes_peak",
                                                 "kernel_launches")},
            "triage_vs_uninterrupted": _triage(tier["tokens"],
                                               plain["tokens"], rows_t,
                                               rows_u),
            "tier": tier, "uninterrupted": plain}
    return {"phase": "serve_tier", "ok": True, "runs": runs,
            "kernel_launches": runs["paged-bf16"]["tier"]["kernel_launches"]}


def _equiv_prefix_requests(vocab):
    """Six requests at equiv scale: five share a 40-token prefix (2.5
    pages of 16: an adopted partial tail page is CoW-cloned), one of them
    twice (the later copy adopts the whole prompt), one is unrelated;
    arrivals spread over steps 0-3."""
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(4)
    shared = rng.integers(1, vocab, 40).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(1, vocab, int(n))
                               .astype(np.int32)])
               for n in rng.integers(5, 31, 4)]
    prompts.insert(3, rng.integers(1, vocab, 23).astype(np.int32))
    prompts.append(prompts[0].copy())
    news = rng.integers(6, 11, len(prompts))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=int(m))
            for i, (p, m) in enumerate(zip(prompts, news))]
    return reqs, dict(zip(range(6), (0, 1, 1, 2, 3, 3)))


def phase_equiv_prefix(dev) -> dict:
    """The slice's equivalences at 2 layers, fp32, TF32 off (bf16 where
    named):

    * prefix cache: hetero paged (one R-worker, so two rows share a pool)
      with prefix_cache=True == prefix-off == colocated, tokens exact and
      every logits row within 1e-4, on graphs and eager;
    * parked and restored == uninterrupted: kv_tiering, preempt_after=2,
      a pool of 10 pages of 16 (stalls, preemptions, swap-outs,
      restores), fp pools (fp32, within 1e-4) and int8 pools (held to the
      int8 bound, as equiv_spec_int8: a resumed token is recomputed
      through a chunk, whose K/V may round one int8 step apart); bf16
      pools reported with the triage of ``_triage`` (the recomputed
      tokens run other GEMM shapes, which round apart in bf16);
    * ``preempt()`` of a running request mid-decode == uninterrupted
      (fp32, paged with tiering; within 1e-4);
    * sampled hetero == sampled colocated for one seed (tokens exact).
    A flip counts only if the teacher-forced rows differ beyond the
    tolerance (``_compare_rows``)."""
    import dataclasses
    import torch
    from repro_torch.models.model import init_params
    cfg, params, spec = _equiv_model(dev, 1)
    out = {}

    def reqs():
        return _equiv_prefix_requests(cfg.vocab_size)[0]
    arrive = _equiv_prefix_requests(cfg.vocab_size)[1]

    def check(name, got, want, rows_g, rows_w, tol, extra=""):
        max_diff, mismatches, ties, margin = _compare_rows(
            {rid: t for rid, (t, _) in got.items()},
            {rid: t for rid, (t, _) in want.items()}, rows_g, rows_w, tol)
        if mismatches or max_diff > tol:
            raise AssertionError(
                f"{name}: mismatches {mismatches}, max logit diff "
                f"{max_diff} (tol {tol}) {extra}")
        return {"tokens_equal": not ties, "near_tie_flips": ties,
                "max_logit_diff": max_diff, "min_top2_margin": margin,
                "logit_tol": tol}

    # 1. prefix cache on/off/colocated, graphs and eager
    rows = {k: {} for k in ("col", "off", "on", "on_eager")}
    shared = [0]

    def count_shared(eng):
        shared[0] = max(shared[0], eng.prefix_cache_stats()["shared_pages"])
    col, _ = _equiv_serve(dev, cfg, params, spec, reqs=reqs, arrive=arrive,
                          rows=rows["col"], backend="colocated")
    hkw = dict(backend="hetero", paged_kv=True, num_r_workers=1,
               reqs=reqs, arrive=arrive)
    off, _ = _equiv_serve(dev, cfg, params, spec, rows=rows["off"], **hkw)
    _reset_counters()
    stats = {}

    def note(eng):
        count_shared(eng)
        stats.update(eng.prefix_cache_stats())
    on, _ = _equiv_serve(dev, cfg, params, spec, rows=rows["on"],
                         prefix_cache=True, on_step=note, **hkw)
    launches = {n: c[0].value for n, c in _counters().items()}
    on_eager, _ = _equiv_serve(dev, cfg, params, spec, eager=True,
                               rows=rows["on_eager"], prefix_cache=True,
                               **hkw)
    out["prefix_on_vs_colocated"] = check(
        "prefix-on != colocated", on, col, rows["on"], rows["col"],
        EQUIV_LOGIT_TOL)
    out["prefix_off_vs_colocated"] = check(
        "prefix-off != colocated", off, col, rows["off"], rows["col"],
        EQUIV_LOGIT_TOL)
    out["prefix_on_vs_off"] = check(
        "prefix-on != prefix-off", on, off, rows["on"], rows["off"],
        EQUIV_LOGIT_TOL)
    out["prefix_on_graphs_vs_eager"] = check(
        "prefix-on graphs != eager", on, on_eager, rows["on"],
        rows["on_eager"], EQUIV_LOGIT_TOL)
    if stats.get("hits_count", 0) < 2 or shared[0] < 1 \
            or {n for n, v in launches.items() if v} \
            != {"paged_decode_attention"}:
        raise AssertionError(f"prefix-on: stats {stats}, max shared pages "
                             f"{shared[0]}, kernel launches {launches}")
    out["prefix_cache"] = dict(stats, max_shared_pages=shared[0],
                               kernel_launches=launches)

    # 2. parked and restored == uninterrupted: fp pools (fp32) and int8
    # pools held to their bounds; bf16 pools reported, triaged
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    bparams = init_params(bcfg, torch.Generator(device=dev).manual_seed(1),
                          device=dev)
    tspec = dict(spec, p_lo=40, p_hi=90, new_lo=20, new_hi=30)
    for name, c, p, q, tol in (("fp32", cfg, params, False,
                                EQUIV_LOGIT_TOL),
                               ("int8", cfg, params, True, QUANT_BOUND),
                               ("bf16", bcfg, bparams, False, None)):
        rows_u, rows_t, tstats = {}, {}, {}
        base = dict(backend="hetero", paged_kv=True, num_r_workers=1,
                    quantized_kv=q)
        want, _ = _equiv_serve(dev, c, p, tspec, rows=rows_u, **base)
        got, _ = _equiv_serve(
            dev, c, p, tspec, rows=rows_t, kv_tiering=True, preempt_after=2,
            pages_per_worker=10,
            on_step=lambda eng: tstats.update(eng.tiering_stats()), **base)
        if tstats.get("preemptions_count", 0) < 1 \
                or tstats.get("restore_count", 0) < 1:
            raise AssertionError(f"parked-and-restored {name}: no "
                                 f"preemption or restore: {tstats}")
        if tol is None:
            # a resumed row recomputes its last token (and whatever of its
            # chain was not restorable) through a chunk or a prefill: other
            # GEMM shapes than the decode steps that wrote it, which round
            # apart in bf16 (as the bf16 spec divergence)
            rec = _triage({rid: t for rid, (t, _) in got.items()},
                          {rid: t for rid, (t, _) in want.items()},
                          rows_t, rows_u)
        else:
            rec = check(f"parked-and-restored {name} != uninterrupted",
                        got, want, rows_t, rows_u, tol,
                        extra=f"tiering {tstats}")
        out[f"parked_and_restored_{name}"] = dict(rec, tiering=tstats)

    # 3. preempt() mid-decode (fp32, paged with tiering)
    preempted = []

    def preempt_once(eng):
        if preempted or eng.step_idx < 3:
            return
        r = next((r for r in eng.slots if r is not None
                  and len(r.generated) >= 2), None)
        if r is not None and eng.preempt(r.rid):
            preempted.append(r.rid)
    rows_p = {}
    got, _ = _equiv_serve(dev, cfg, params, spec, rows=rows_p,
                          backend="hetero", paged_kv=True, kv_tiering=True,
                          on_step=preempt_once)
    rows_c = {}
    want, _ = _equiv_serve(dev, cfg, params, spec, rows=rows_c,
                           backend="colocated")
    if not preempted:
        raise AssertionError("preempt(): no running request to preempt")
    out["preempt_mid_decode"] = dict(check(
        "preempt() != uninterrupted", got, want, rows_p, rows_c,
        EQUIV_LOGIT_TOL), preempted=preempted)

    # 4. sampled hetero == sampled colocated, one seed
    def sreqs():
        return _sampled(_requests(np.random.default_rng(2), **spec))
    sh, _ = _equiv_serve(dev, cfg, params, spec, reqs=sreqs, seed=5,
                         backend="hetero", paged_kv=True)
    sc, _ = _equiv_serve(dev, cfg, params, spec, reqs=sreqs, seed=5,
                         backend="colocated")
    sh_t = {rid: t for rid, (t, _) in sh.items()}
    sc_t = {rid: t for rid, (t, _) in sc.items()}
    if sh_t != sc_t:
        raise AssertionError(f"sampled hetero {sh_t} != sampled colocated "
                             f"{sc_t} (seed 5)")
    out["sampled_hetero_vs_colocated"] = {"tokens_equal": True, "seed": 5,
                                          "sampling": SAMPLING,
                                          "requests": len(sh_t)}
    return {"phase": "equiv_prefix", "ok": True, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "dtype": "float32", "tf32": False,
            **out}


PLAN_TARGET, PLAN_INTERVAL = 32, 4     # the sls / loadctl S and F
# drift warmup past the graph captures: a serve with monolithic prefill
# captures its decode graphs in its first step only
PLAN_DRIFT_WARMUP = 3


def _plan_requests(vocab):
    """A backlog of 24 requests (3x the batch, as a loaded server holds):
    prompts of 17-600 tokens, 16-32 new tokens each, all queued at step
    0, from the phase's seed."""
    return _requests(np.random.default_rng(19), 24, 17, 600, 16, 32, vocab)


def _plan_after(name: str, trace_out: Path):
    """The ``after`` hook of a serve_plan run: the engine's plan and, with
    observability on, its metrics (schema-checked), drift report, span
    count and exported Chrome trace."""
    def after(eng):
        rec = {"plan": dict(eng.plan)}
        if eng.obs is None:
            return rec
        from repro_torch.obs import assert_conforms
        m = eng.metrics()
        assert_conforms(m)
        rep = eng.drift_report()
        trace_out.mkdir(parents=True, exist_ok=True)
        path = Path(eng.export_trace(str(trace_out / f"serve_plan_{name}"
                                         ".json")))
        tracer = eng.obs.tracer
        rec.update({
            "metrics": {k: m[k] for k in sorted(m) if k.startswith((
                "ttft_s", "queue_wait_s", "inter_token_s", "e2e_s"))
                or k.endswith("_count") and not k.startswith("hotpath_")},
            "drift": {"calibrated": rep.calibrated,
                      "watch_steps": rep.steps_count,
                      "records": [{"key": r.key, "predicted": r.predicted,
                                   "measured": r.measured, "rel": r.rel}
                                  for r in rep.records],
                      "flagged": rep.flagged,
                      "warmup_steps": eng.obs.drift.warmup_steps,
                      "calibration_steps": eng.obs.drift.calibration_steps},
            "spans": tracer.added, "spans_dropped": tracer.dropped,
            "trace": str(path), "trace_bytes": path.stat().st_size})
        return rec
    return after


PLAN_RUN_KEYS = ("decode_tokens_per_s", "decode_tokens_per_s_after_first_step",
                 "decode_step_s_p50", "decode_steps", "resident_len_peak",
                 "paged_referenced_bytes_peak", "admitted_per_step",
                 "prefill_step_wall_s_max", "capture_count", "capture_s",
                 "kernel_launches", "hotpath", "r_worker_busy_s", "gc_s",
                 "gc_collections", "gc_heap_objects")


def phase_serve_plan(dev, model, out: Path, trace_out: Path) -> dict:
    """The paper's planner and schedules with observability, on the card:
    ``ServingEngine.from_plan(seq_len=1024, max_batch=8, backend="hetero",
    paged_kv=True, page_size=16)`` (H100 profile) serving a backlog of 24
    requests (``_plan_requests``) in turns greedy without and with
    observability (off, on, on, off, off, on: a paired overhead figure;
    step i does the same device work in every greedy run, so the median
    over steps of the per-step ratio on / off is the robust one), then
    ``sls`` and ``loadctl`` (S = 32, F = 4; loadctl's w_lim half the first
    greedy run's peak resident length), both observed.  Checks: every
    request finishes with its count (``_serve_run``); observed tokens ==
    unobserved; every sls admission on a step = 0 mod F, at most M =
    microbatch_size(batch, S, F); loadctl's peak resident length <= w_lim;
    each observed run's drift monitor calibrated with dispatch_s and
    tokens_per_s among its records; metrics() schema-conformant.  sls and
    loadctl tokens that differ from greedy's are triaged teacher-forced
    (both runs again with every logits row logged, ``_triage``) and
    counted, not failed."""
    from repro_torch.core import perfmodel as P
    from repro_torch.core.schedule import microbatch_size
    from repro_torch.obs import ObsConfig
    cfg = model["cfg"]
    ocfg = ObsConfig(drift_warmup_steps=PLAN_DRIFT_WARMUP)
    base = dict(kernel="paged_decode_attention", paged=True, quantized=False,
                plan=True, max_steps=400)
    sched = dict(target_len=PLAN_TARGET, interval=PLAN_INTERVAL)

    def run(name, rows=None, **engine_kw):
        return serve_run(dev, model, out, reqs=_plan_requests(cfg.vocab_size),
                         engine_kw=engine_kw, rows=rows,
                         after=_plan_after(name, trace_out), **base)
    runs = {}
    for i, on in enumerate((False, True, True, False, False, True)):
        name = f"greedy_{'on' if on else 'off'}_{i // 2 + 1}"
        runs[name] = run(name, **(dict(observability=ocfg) if on else {}))
    runs["sls"] = run("sls", admission="sls", observability=ocfg, **sched)
    w_lim = 0.5 * runs["greedy_off_1"]["resident_len_peak"]
    runs["loadctl"] = run("loadctl", admission="loadctl", w_lim=w_lim,
                          observability=ocfg, **sched)
    ref = runs["greedy_off_1"]
    plan = ref["after"]["plan"]
    b = ref["batch"]
    m = microbatch_size(b, PLAN_TARGET, PLAN_INTERVAL)
    faults = []
    greedy = [n for n in runs if n.startswith("greedy_")]
    for name in greedy[1:]:
        if runs[name]["tokens"] != ref["tokens"]:
            faults.append(f"{name} tokens != greedy_off_1's")
    bad = [(i, a) for i, a in enumerate(runs["sls"]["admitted_per_step"])
           if a and (i % PLAN_INTERVAL or a > m)]
    if bad:
        faults.append(f"sls admissions off the schedule (step, n): {bad}")
    if runs["loadctl"]["resident_len_peak"] > w_lim:
        faults.append(f"loadctl peak resident length "
                      f"{runs['loadctl']['resident_len_peak']} > w_lim "
                      f"{w_lim}")
    observed = [n for n, r in runs.items() if "drift" in r["after"]]
    for name in observed:
        d = runs[name]["after"]["drift"]
        keys = {r["key"] for r in d["records"]}
        if not d["calibrated"] or not {"dispatch_s", "tokens_per_s"} <= keys:
            faults.append(f"{name}: drift not calibrated or records {keys}")
    if faults:
        raise AssertionError("serve_plan: " + "; ".join(faults))
    # triage of the schedules' tokens against greedy's, only where they
    # differ (the logged runs perturb the timing, so they are extra runs)
    triage = {}
    differ = [n for n in ("sls", "loadctl")
              if runs[n]["tokens"] != ref["tokens"]]
    if differ:
        rows_ref = {}
        run("greedy_rows", rows=rows_ref)
        for name in differ:
            rows = {}
            kw = dict(admission=name, **sched)
            if name == "loadctl":
                kw["w_lim"] = w_lim
            again = run(f"{name}_rows", rows=rows, **kw)
            triage[name] = _triage(again["tokens"], ref["tokens"], rows,
                                   rows_ref)
    summary = {}
    for name, r in runs.items():
        s_ = {k: r[k] for k in PLAN_RUN_KEYS}
        s_["admissions"] = {"steps_admitting": sum(
            1 for a in r["admitted_per_step"] if a),
            "max_per_step": max(r["admitted_per_step"])}
        if "drift" in r["after"]:
            a = r["after"]
            ws = a["drift"]["warmup_steps"]
            cs = a["drift"]["calibration_steps"]
            s_.update({k: a[k] for k in ("metrics", "drift", "spans",
                                         "spans_dropped", "trace",
                                         "trace_bytes")})
            s_["captures_in_calibration"] = sum(
                1 for i in r["capture_steps"] if ws <= i < ws + cs)
        s_["tokens_equal_greedy"] = r["tokens"] == ref["tokens"]
        summary[name] = s_

    def mean(names, key):
        return float(np.mean([runs[n][key] for n in names]))
    on = [n for n in greedy if "_on_" in n]
    off = [n for n in greedy if "_off_" in n]
    overhead = {
        key: {"on": mean(on, key), "off": mean(off, key),
              "on_over_off": mean(on, key) / mean(off, key)}
        for key in ("decode_tokens_per_s",
                    "decode_tokens_per_s_after_first_step",
                    "decode_step_s_p50")}
    # per step after the first (which captures): the median wall of the
    # observed runs over that of the unobserved ones
    walls = {n: runs[n]["decode_wall_per_step"] for n in greedy}
    ratios = [float(np.median([walls[n][i] for n in on])
                    / np.median([walls[n][i] for n in off]))
              for i in range(1, len(walls[greedy[0]]))]
    overhead["step_wall_on_over_off"] = {
        "steps": len(ratios), "median": float(np.median(ratios)),
        "q1": float(np.percentile(ratios, 25)),
        "q3": float(np.percentile(ratios, 75))}
    t_b = P.t_of_b(cfg, P.GPU_H100, b)
    return {"phase": "serve_plan", "ok": True, "model": "qwen3-8b",
            "layers": cfg.num_layers, "requests": len(ref["tokens"]),
            "prompt_tokens": ref["prompt_tokens"],
            "engine": {"batch": b, "micro_batches": ref["micro_batches"],
                       "r_workers": ref["r_workers"],
                       "cache_len": ref["cache_len"], "page_size": 16},
            # predictions from the H100 spec sheet, not measurements
            "plan": {k: plan.get(k) for k in (
                "batch", "workers", "t_of_b", "tokens_per_s",
                "prefill_chunk", "w_lim_scale", "workers_mem_min")},
            "roofline_at_engine_batch": {
                "batch": b, "t_of_b": t_b,
                "tokens_per_s": b / (2 * cfg.num_layers * t_b)},
            "schedule": {"target_len": PLAN_TARGET,
                         "interval": PLAN_INTERVAL, "microbatch": m,
                         "w_lim": w_lim},
            "observability_overhead": overhead,
            "runs": summary, "triage_vs_greedy": triage,
            "kernel_launches": ref["kernel_launches"]}


def phase_equiv_plan(dev) -> dict:
    """At 2 layers, fp32, TF32 off: hetero paged (through kernel 1) ==
    colocated under ``sls`` and under ``loadctl`` (tokens; the same
    admissions and resident length every step); observability on ==
    off (tokens exact, logits within 1e-4); ``from_plan`` serves
    (== the hand-sized hetero engine); and a worker made a straggler
    with ``sim_row_cost`` after the drift monitor calibrated is flagged
    ``tokens_per_s`` by ``drift_report()``."""
    from repro_torch.core import graphs
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.obs import ObsConfig
    from repro_torch.serving.engine import ServingEngine
    cfg, params, spec = _equiv_model(dev, 4)
    res = {}
    hetero = dict(backend="hetero", paged_kv=True)
    schedules = {"sls": dict(admission="sls", target_len=8, interval=2),
                 "loadctl": dict(admission="loadctl", target_len=8,
                                 interval=2, w_lim=400.0)}
    for name, akw in schedules.items():
        steps = {"hetero": [], "colocated": []}

        def record(key):
            return lambda eng: steps[key].append(
                (eng.records[-1].admitted, eng.records[-1].resident_len))
        PA.launches.reset()
        got, _ = _equiv_serve(dev, cfg, params, spec, on_step=record(
            "hetero"), **hetero, **akw)
        launches = PA.launches.value
        want, _ = _equiv_serve(dev, cfg, params, spec, on_step=record(
            "colocated"), backend="colocated", **akw)
        max_diff, mismatches, ties, margin = _compare(got, want,
                                                      EQUIV_LOGIT_TOL)
        if mismatches or max_diff > EQUIV_LOGIT_TOL or launches == 0 \
                or steps["hetero"] != steps["colocated"]:
            raise AssertionError(
                f"{name}: hetero-paged != colocated: mismatches "
                f"{mismatches}, max logit diff {max_diff} (tol "
                f"{EQUIV_LOGIT_TOL}), kernel launches {launches}, "
                f"(admitted, resident) per step {steps}")
        res[name] = {"tokens_equal": not ties, "near_tie_flips": ties,
                     "max_logit_diff": max_diff, "min_top2_margin": margin,
                     "kernel_launches": launches,
                     "admitted_per_step": [a for a, _ in steps["hetero"]]}
    off, _ = _equiv_serve(dev, cfg, params, spec, **hetero)
    on, _ = _equiv_serve(dev, cfg, params, spec, observability=True,
                         **hetero)
    max_diff, mismatches, ties, _ = _compare(on, off, EQUIV_LOGIT_TOL)
    if mismatches or ties or max_diff > EQUIV_LOGIT_TOL:
        raise AssertionError(
            f"observability on != off: mismatches {mismatches}, near-tie "
            f"flips {ties}, max logit diff {max_diff}")
    res["observability"] = {"tokens_equal": True, "max_logit_diff": max_diff}
    eng = ServingEngine.from_plan(params, cfg, seq_len=256, max_batch=4,
                                  page_size=16, device=dev, **hetero)
    try:
        planned, _ = _serve_logged(eng, _requests(np.random.default_rng(2),
                                                  **spec))
        sized = (eng.batch, len(eng.engine.workers), eng.num_mb)
        plan = {k: eng.plan[k] for k in ("batch", "workers", "tokens_per_s")}
    finally:
        eng.close()
    max_diff, mismatches, ties, _ = _compare(planned, off, EQUIV_LOGIT_TOL)
    if mismatches or max_diff > EQUIV_LOGIT_TOL:
        raise AssertionError(
            f"from_plan serve != hetero serve: mismatches {mismatches}, max "
            f"logit diff {max_diff}")
    res["from_plan"] = {"batch_workers_micro_batches": sized, "plan": plan,
                        "tokens_equal": not ties,
                        "max_logit_diff": max_diff}
    # the straggler: calibrate on a healthy pair of workers, then slow one
    ocfg = ObsConfig(drift_warmup_steps=3, drift_calibration_steps=6,
                     drift_tolerance=0.5)
    eng = ServingEngine(params, cfg, batch=4, cache_len=256,
                        num_r_workers=2, num_microbatches=2, page_size=16,
                        device=dev, observability=ocfg, **hetero)
    try:
        for r in _requests(np.random.default_rng(6), 4, 17, 40, 40, 40,
                           cfg.vocab_size):
            eng.submit(r)
        capture_steps = []
        for i in range(17):
            if i == 9:
                rep0 = eng.drift_report()
                eng.engine.workers[0].sim_row_cost = 0.05
            n0 = graphs.captures.capture_count
            eng.step()
            if graphs.captures.capture_count > n0:
                capture_steps.append(i)
        rep = eng.drift_report()
    finally:
        eng.close()
    tps = rep.record("tokens_per_s")
    if not rep0.calibrated or tps is None or "tokens_per_s" not in \
            rep.flagged or not tps.rel < -0.5:
        raise AssertionError(f"straggler not flagged: calibrated "
                             f"{rep0.calibrated}, report {rep}")
    res["straggler"] = {
        "sim_row_cost_s": 0.05, "flagged": rep.flagged,
        "tokens_per_s": {"predicted": tps.predicted,
                         "measured": tps.measured, "rel": tps.rel},
        "watch_steps": rep.steps_count, "capture_steps": capture_steps,
        "captures_in_calibration": sum(1 for i in capture_steps
                                       if 3 <= i < 9)}
    return {"phase": "equiv_plan", "ok": True, "layers": cfg.num_layers,
            "dtype": "float32", "tf32": False, "logit_tol": EQUIV_LOGIT_TOL,
            **res}


# ---------------------------------------------------------------------------
# fleet management and chaos: serve_fleet, serve_chaos, equiv_fleet
# ---------------------------------------------------------------------------
# suspect_after_s of these phases: each phase fails unless the longest
# single R-side item that captured a graph took under half of it (a
# capturing worker must never read as hung: a false suspicion costs a
# re-prefill of every live row)
SUSPECT_S = 2.0
HANG_S = 8.0           # equiv_fleet's hang: detected (<= 2 polls) and
#                        outlasting the grace window (SUSPECT_S) after it
FLEET_KILL_STEP = 33   # serve_fleet kills right after the step-32 snapshot
STRAGGLE = (5, 20, 0.002)   # steps [5, 20): s/row on worker 0


def _fleet_after(eng) -> dict:
    """What a fleet or chaos run leaves, read before the engine closes:
    the longest R-side first call (a graph's warm-up and capture), the
    re-captures after topology changes, the supervisor's faults and
    spared workers, the fleet's events and ``fleet_*`` metrics, the plan's
    fired faults."""
    het = eng.engine
    ws = list(het.workers) + list(het._retired)
    out = {"slices": [list(sl) for sl in het.slices],
           "capture_max_s": max(w.capture_max_s for w in ws),
           "spared_workers": eng.spared_workers,
           "replayed_rows": eng.replayed_rows,
           "fault_count": eng.faults, "recovered_count": eng.recoveries,
           "fault_events": [{k: v for k, v in ev.items() if k != "msg"}
                            for ev in eng.fault_events],
           "fault_msgs": [ev["msg"][:240] for ev in eng.fault_events
                          if "msg" in ev],
           "topology_changes": het.topology_changes,
           **het.recapture_stats()}
    if eng.fleet is not None:
        tel = eng.fleet.telemetry
        out["fleet_metrics"] = {k: v for k, v in eng.metrics().items()
                                if k.startswith("fleet_")}
        out["planned"] = [list(sl) for sl in eng.fleet.planner.plan(
            eng.mb_size)]
        out["events"] = [dict(step=e.step, kind=e.kind, **e.detail)
                         for e in tel.events]
    if eng.chaos is not None:
        out["fired"] = [{k: v for k, v in f.items() if k != "t"}
                        for f in eng.chaos.fired]
    return out


def _rate(rec, lo, hi=None):
    """Decode tokens per second over steps [lo, hi) of a serve record."""
    dec = sum(rec["decode_wall_per_step"][lo:hi])
    return sum(rec["decode_tokens_per_step"][lo:hi]) / dec if dec else None


def phase_serve_fleet(dev, model, out: Path) -> tuple:
    """Qwen3-8B (``serve_model``), paged bf16, the 12-request trace
    under ``FleetManager(skewed_fleet((2.0, 1.0)), rebalance=True,
    snapshot_interval=16)``: the planner's uneven split (perfmodel rates
    on the H100 profile), a ``sim_row_cost`` straggler on the 3-row worker
    for steps 5-19 that the EWMA rebalancer must migrate rows off, then
    ``kill()`` of the last worker before step 33 (right after the step-32
    snapshot), recovered by re-prefill and, in a second run, from the
    snapshot.  Beside them an uninterrupted 2-worker serve: its longest
    R-side capture must be under SUSPECT_S / 2, and each fleet run's tokens
    are triaged against it (ROADMAP §3: teacher-forced logits, top-2
    margin).  Kernel 1 on every decode R-Part (launches = layers x
    micro-batches x workers of each step); no spared worker, no fault.
    Returns (record, uninterrupted run, its logits rows)."""
    from repro_torch.fleet import FleetManager, skewed_fleet
    cfg = model["cfg"]
    kw = dict(kernel="paged_decode_attention", paged=True, quantized=False)
    rows_u = {}
    plain = serve_run(dev, model, out, rows=rows_u, after=_fleet_after, **kw)
    cap = plain["after"]["capture_max_s"]
    if not 0.0 < cap < SUSPECT_S / 2 or plain["after"]["spared_workers"] \
            or plain["after"]["fault_count"]:
        raise AssertionError(f"longest R-side capture {cap} s: "
                             f"suspect_after_s {SUSPECT_S} is too short; "
                             f"{plain['after']}")
    runs, tokens, rows = {}, {}, {}
    for mode in ("reprefill", "snapshot"):
        fleet = FleetManager(skewed_fleet((2.0, 1.0)), cfg=cfg, page=16,
                             rebalance=True, snapshot_interval=16,
                             recovery=mode)
        killed, straggler = [], []

        def on_step(eng, killed=killed, straggler=straggler):
            i = eng.step_idx                 # the next step
            if i == STRAGGLE[0]:
                w = eng.engine.workers[0]
                w.sim_row_cost = STRAGGLE[2]
                straggler.append(w.hi - w.lo)
            elif i == STRAGGLE[1]:
                for w in eng.engine.workers:
                    w.sim_row_cost = 0.0
            elif i == FLEET_KILL_STEP:
                w = eng.engine.workers[-1]
                w.kill()
                w.join(timeout=30)
                killed.append((w.wid, w.is_alive()))
        rows_f = {}
        rec = serve_run(dev, model, out, rows=rows_f, on_step=on_step,
                        after=_fleet_after,
                        engine_kw=dict(fleet=fleet,
                                       suspect_after_s=SUSPECT_S), **kw)
        a = rec["after"]
        migs = [e for e in a["events"] if e["kind"] == "migration"]
        recs = [e for e in a["events"] if e["kind"] == "recovery"]
        snaps = [e for e in a["events"] if e["kind"] == "snapshot"]
        planned = a["planned"]
        # a migration while worker 0 straggles must take rows off it
        off = [e for e in migs if STRAGGLE[0] <= e["step"] < STRAGGLE[1]
               and e["slices"][0][1] - e["slices"][0][0] < straggler[0]]
        killed_ok = len(killed) == 1 and not killed[0][1]
        if planned[0][1] - planned[0][0] <= planned[1][1] - planned[1][0] \
                or not off or len(recs) != 1 or recs[0]["mode"] != mode \
                or not killed_ok or a["spared_workers"] or a["fault_count"] \
                or rec["r_workers_per_step"][-1] != 1:
            raise AssertionError(
                f"serve_fleet {mode}: planned {planned}, migrations "
                f"{migs}, recoveries {recs}, killed {killed}, spared "
                f"{a['spared_workers']}, faults {a['fault_count']}, "
                f"workers per step {rec['r_workers_per_step']}")
        k = FLEET_KILL_STEP
        tokens[mode], rows[mode] = rec["tokens"], rows_f
        runs[mode] = {
            "planned_split": planned,
            "straggler": {"steps": list(STRAGGLE[:2]),
                          "sim_row_cost_s": STRAGGLE[2],
                          "rows_when_slowed": straggler[0],
                          "rows_after_first_move_off": off[0]["slices"][0][1]
                          - off[0]["slices"][0][0],
                          "moved_off_at_step": off[0]["step"]},
            "killed_before_step": k,
            "tokens_per_s_before_kill": _rate(rec, 1, k),
            "tokens_per_s_after_kill": _rate(rec, k),
            "tokens_per_s_after_kill_step": _rate(rec, k + 1),
            "kill_step_decode_s": rec["decode_wall_per_step"][k],
            "mttr_s": recs[0]["duration_s"],
            "recovery": recs[0],
            "migrations": [{x: e.get(x) for x in (
                "step", "moved_rows", "duration_s", "export_s", "load_s",
                "wire_bytes", "skew", "slices")} for e in migs],
            "snapshots": [{x: e[x] for x in ("step", "duration_s",
                                              "wire_bytes")}
                          for e in snaps],
            "recapture_count": a["recapture_count"],
            "recapture_s": a["recapture_s"],
            "capture_max_s": a["capture_max_s"],
            "spared_workers": a["spared_workers"],
            "fleet_metrics": a["fleet_metrics"],
            "triage_vs_uninterrupted": _triage(rec["tokens"], plain["tokens"],
                                               rows_f, rows_u),
            "run": {x: rec[x] for x in SUMMARY_KEYS + (
                "decode_steps", "r_workers_per_step",
                "kernel_launches_expected", "decode_wall_per_step",
                "decode_tokens_per_step")}}
    return ({"phase": "serve_fleet", "ok": True, "card": gpu_name_and_limit(),
             "suspect_after_s": SUSPECT_S,
             "uninterrupted_capture_max_s": cap,
             "uninterrupted_spared_workers": plain["after"]["spared_workers"],
             "uninterrupted": {x: plain[x] for x in SUMMARY_KEYS},
             "runs": runs,
             # the two runs differ only in how the kill is recovered
             "snapshot_vs_reprefill": _triage(
                 tokens["snapshot"], tokens["reprefill"], rows["snapshot"],
                 rows["reprefill"]),
             "kernel_launches": runs["reprefill"]["run"]["kernel_launches"]},
            plain, rows_u)


def phase_serve_chaos(dev, model, out: Path, chaos_off=None) -> dict:
    """The same model and trace under one seeded FaultPlan: a crash of
    worker 1 on its first item after the first step (its graphs
    captured), a dropped completion, a transient pool fault and a 3 s
    hang of worker 0 (suspected after SUSPECT_S, spared by the grace
    window, or done before a poll sees it), healed by the step supervisor
    (no fleet: ``remove_worker`` with zeros + re-prefill).  Every fault
    must fire and every request finish; ``fault_events``, MTTR per
    recovery, re-prefilled rows and tokens/s are printed beside a
    chaos-off serve of the same call (``chaos_off``: serve_fleet's
    uninterrupted run and its rows, else one made here), the tokens
    triaged against it."""
    from repro_torch.chaos import FaultPlan, FaultSpec
    kw = dict(kernel="paged_decode_attention", paged=True, quantized=False)
    if chaos_off is None:
        rows_u = {}
        chaos_off = (serve_run(dev, model, out, rows=rows_u, **kw), rows_u)
    off, rows_u = chaos_off
    items = model["cfg"].num_layers * 2        # per worker and step
    plan = FaultPlan([
        FaultSpec(site="r_step", kind="crash", wid=1, after=items),
        FaultSpec(site="completion", kind="drop", after=6 * items),
        FaultSpec(site="pool", after=40),
        FaultSpec(site="r_step", kind="hang", wid=0, after=30 * items,
                  hang_s=3.0)], seed=20)
    rows_c = {}
    rec = serve_run(dev, model, out, rows=rows_c, after=_fleet_after,
                    retries_ok=True,
                    engine_kw=dict(chaos=plan, suspect_after_s=SUSPECT_S,
                                   collect_timeout_s=120.0), **kw)
    a = rec["after"]
    fired = {site: plan.count(site) for site in ("r_step", "completion",
                                                 "pool")}
    hangs = sum(1 for f in a["fired"] if f["kind"] == "hang")
    if fired["r_step"] < 2 or fired["completion"] < 1 or fired["pool"] < 1 \
            or hangs != 1 or a["fault_count"] < 3 \
            or a["recovered_count"] < 3 or rec["r_workers_per_step"][-1] != 1:
        raise AssertionError(f"serve_chaos: fired {a['fired']}, faults "
                             f"{a['fault_events']}")
    return {"phase": "serve_chaos", "ok": True, "card": gpu_name_and_limit(),
            "suspect_after_s": SUSPECT_S, "fired": a["fired"],
            "fault_events": a["fault_events"], "fault_msgs": a["fault_msgs"],
            "mttr_s": [ev["mttr_s"] for ev in a["fault_events"]
                       if ev["kind"] == "recovered"],
            "replayed_rows": a["replayed_rows"],
            "spared_workers": a["spared_workers"],
            "recapture_count": a["recapture_count"],
            "recapture_s": a["recapture_s"],
            "decode_tokens_per_s": [rec["decode_tokens_per_s"],
                                    off["decode_tokens_per_s"]],
            "decode_tokens_per_s_after_first_step": [
                rec["decode_tokens_per_s_after_first_step"],
                off["decode_tokens_per_s_after_first_step"]],
            "decode_step_s_max": [rec["decode_step_s_max"],
                                  off["decode_step_s_max"]],
            "triage_vs_chaos_off": _triage(rec["tokens"], off["tokens"],
                                           rows_c, rows_u),
            "kernel_launches": rec["kernel_launches"],
            "kernel_launches_expected": rec["kernel_launches_expected"],
            "run": {x: rec[x] for x in SUMMARY_KEYS + (
                "decode_steps", "r_workers_per_step",
                "decode_wall_per_step")}}


def _wire(eng) -> dict:
    """{layer key: the whole micro-batch's wire payload} over the engine's
    workers."""
    out = {}
    for lk in sorted({k for w in eng.engine.workers for k in w.state}):
        parts = [w.export_rows(lk, np.arange(w.hi - w.lo))
                 for w in eng.engine.workers]
        out[lk] = {k: np.concatenate([p[k] for p in parts])
                   for k in parts[0]}
    return out


def _wire_equal(a, b) -> bool:
    return sorted(a) == sorted(b) and all(
        sorted(a[lk]) == sorted(b[lk])
        and all(a[lk][k].dtype == b[lk][k].dtype
                and a[lk][k].tobytes() == b[lk][k].tobytes()
                for k in a[lk]) for lk in a)


def _equal_or_raise(name, got, want, extra=None) -> dict:
    max_diff, mismatches, ties, margin = _compare(got, want, EQUIV_LOGIT_TOL)
    if mismatches or max_diff > EQUIV_LOGIT_TOL:
        raise AssertionError(f"equiv_fleet {name}: mismatches {mismatches},"
                             f" max logit diff {max_diff} (tol "
                             f"{EQUIV_LOGIT_TOL}); {extra}")
    return {"tokens_equal": not ties, "near_tie_flips": ties,
            "max_logit_diff": max_diff, "min_top2_margin": margin}


def _two_round_requests(vocab):
    """Round 1: four short prompts; round 2 (made from round 1's tokens):
    each prompt's whole history plus three new tokens, so its admission
    restores the history's parked pages from the host tier."""
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, vocab, int(n)).astype(np.int32)
               for n in rng.integers(20, 40, 4)]
    extras = [rng.integers(1, vocab, 3).astype(np.int32) for _ in range(4)]

    def rounds(hist=None):
        if hist is None:
            return [Request(rid=i, prompt=p, max_new_tokens=6)
                    for i, p in enumerate(prompts)]
        return [Request(rid=100 + i, prompt=np.concatenate(
            [prompts[i], np.asarray(hist[i], np.int32), extras[i]]),
            max_new_tokens=6) for i in range(4)]
    return rounds


def phase_equiv_fleet(dev) -> dict:
    """At 2 layers, fp32, TF32 off, batch 8 (2 micro-batches of 4 rows, 2
    R-workers, pages of 16) or 4 for the fault matrix:
      * ``apply_partition`` to (0, 3), (3, 4) before step 4 and back
        before step 9, on paged fp32, paged int8, dense and dense int8:
        each move leaves every wire payload bit for bit as exported before
        it, the tokens equal the colocated oracle's (int8: the unmigrated
        serve of the same storage), logits within 1e-4;
      * re-prefill and snapshot recovery after ``kill()`` == colocated;
      * the fault matrix on paged fp32, each == colocated with its fault
        fired: crash, drop, error, hang (HANG_S), dup, pool; verify with
        SpecConfig(3); tier_put, tier_get, tier_corrupt (two rounds with
        tiering, a migration between them); wire_corrupt on a migration
        and on a snapshot.
    suspect_after_s is SUSPECT_S (serve_fleet measured the captures)."""
    from repro_torch.chaos import FaultPlan, FaultSpec
    from repro_torch.fleet import FleetManager, WorkerProfile, uniform_fleet
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.serving.engine import SpecConfig, ServingEngine
    from repro_torch.serving.paged_cache import TierConfig
    cfg, params, spec = _equiv_model(dev, 5)
    sup = dict(suspect_after_s=SUSPECT_S, collect_timeout_s=120.0)
    res = {"phase": "equiv_fleet", "ok": True, "card": gpu_name_and_limit(),
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "dtype": "float32", "tf32": False, "logit_tol": EQUIV_LOGIT_TOL,
           "suspect_after_s": SUSPECT_S}
    want8, _ = _equiv_serve(dev, cfg, params, spec, backend="colocated",
                            batch=8)
    want4, _ = _equiv_serve(dev, cfg, params, spec, backend="colocated")
    storages = {"paged-fp32": dict(paged_kv=True),
                "paged-int8": dict(paged_kv=True, quantized_kv=True),
                "dense-fp32": {}, "dense-int8": dict(quantized_kv=True)}
    mig = {}
    for name, skw in storages.items():
        moves = []

        def on_step(eng, moves=moves):
            if eng.step_idx in (4, 9):
                before = _wire(eng)
                eng.engine.apply_partition(
                    [(0, 3), (3, 4)] if eng.step_idx == 4
                    else [(0, 2), (2, 4)])
                moves.append(_wire_equal(before, _wire(eng)))
        got, _ = _equiv_serve(dev, cfg, params, spec, batch=8,
                              on_step=on_step, backend="hetero", **skw)
        ref = want8
        if "int8" in name:
            ref, _ = _equiv_serve(dev, cfg, params, spec, batch=8,
                                  backend="hetero", **skw)
        if moves != [True, True]:
            raise AssertionError(f"equiv_fleet migration {name}: wire "
                                 f"payloads equal after each move {moves}")
        mig[name] = dict(_equal_or_raise(f"migration {name}", got, ref),
                         wire_bitwise_equal=True,
                         against="colocated" if ref is want8
                         else "unmigrated " + name)
    res["migration"] = mig
    rec_ = {}
    for mode in ("reprefill", "snapshot"):
        fleet = FleetManager(uniform_fleet(2), recovery=mode,
                             snapshot_interval=1 if mode == "snapshot" else 0)

        def kill(eng):
            if eng.step_idx == 6:
                w = eng.engine.workers[1]
                w.kill()
                w.join(timeout=30)
        got, _ = _equiv_serve(dev, cfg, params, spec, batch=8, on_step=kill,
                              backend="hetero", paged_kv=True, fleet=fleet,
                              **sup)
        ev = fleet.telemetry.events_of("recovery")
        if len(ev) != 1 or ev[0].detail["mode"] != mode:
            raise AssertionError(f"equiv_fleet recovery {mode}: {ev}")
        rec_[mode] = dict(_equal_or_raise(f"recovery {mode}", got, want8),
                          duration_s=ev[0].detail["duration_s"],
                          rows=ev[0].detail["rows"])
    res["recovery"] = rec_
    # the fault matrix (batch 4: per worker and step 4 R-Parts, 8
    # completions and 4 pool growths over the fleet)
    matrix = {
        "crash": [FaultSpec(site="r_step", kind="crash", wid=1, after=8)],
        "drop": [FaultSpec(site="completion", kind="drop", after=16)],
        "error": [FaultSpec(site="r_step", kind="error", wid=1, after=8)],
        "hang": [FaultSpec(site="r_step", kind="hang", wid=1, after=8,
                           hang_s=HANG_S)],
        "dup": [FaultSpec(site="completion", kind="dup", after=16)],
        "pool": [FaultSpec(site="pool", after=8)],
        "verify": [FaultSpec(site="verify", after=3, times=2)],
    }
    faults = {}
    for name, specs in matrix.items():
        plan = FaultPlan(specs)
        box = {}
        extra = dict(spec_decode=SpecConfig(k=3)) if name == "verify" else {}
        PA.launches.reset()
        PA.verify_launches.reset()
        got, _ = _equiv_serve(
            dev, cfg, params, spec, backend="hetero", paged_kv=True,
            chaos=plan, on_step=lambda e, box=box: box.update(
                faults=e.faults, recoveries=e.recoveries,
                dups=e.engine.step_stats.get("dup_completion_count", 0.0),
                workers=len(e.engine.workers), spared=e.spared_workers,
                mttr=[ev["mttr_s"] for ev in e.fault_events
                      if ev["kind"] == "recovered"]), **extra, **sup)
        launches = PA.launches.value + PA.verify_launches.value
        healed = box["dups"] >= 1 if name == "dup" else (
            box["faults"] >= 1 and box["recoveries"] >= 1)
        if plan.count() < 1 or not healed or launches == 0:
            raise AssertionError(f"equiv_fleet {name}: fired "
                                 f"{plan.count()}, {box}, launches "
                                 f"{launches}")
        faults[name] = dict(_equal_or_raise(name, got, want4, box),
                            fired=plan.count(), kernel_launches=launches,
                            **box)
    # host-tier sites: round 1, a migration that flushes every parked page
    # to the tier, round 2 restoring the histories
    rounds = _two_round_requests(cfg.vocab_size)
    colo = ServingEngine(params, cfg, batch=4, cache_len=256, device=dev)
    try:
        w1 = _serve_logged(colo, rounds())[0]
        hist = [w1[i][0] for i in range(4)]
        w2 = _serve_logged(colo, rounds(hist))[0]
    finally:
        colo.close()
    for site in ("tier_put", "tier_get", "tier_corrupt"):
        plan = FaultPlan([FaultSpec(site=site)])
        eng = ServingEngine(params, cfg, batch=4, cache_len=256, device=dev,
                            backend="hetero", num_r_workers=2,
                            paged_kv=True, page_size=16,
                            kv_tiering=TierConfig(), chaos=plan, **sup)
        try:
            g1 = _serve_logged(eng, rounds())[0]
            eng.engine.apply_partition([(0, 2), (2, 2)])
            g2 = _serve_logged(eng, rounds(hist))[0]
            st = dict(eng.tiering_stats())
        finally:
            eng.close()
        r1 = _equal_or_raise(f"{site} round 1", g1, w1)
        r2 = _equal_or_raise(f"{site} round 2", g2, w2, st)
        if plan.count(site) != 1 or st["restore_count"] < 1:
            raise AssertionError(f"equiv_fleet {site}: fired "
                                 f"{plan.count(site)}, tiering {st}")
        faults[site] = dict(r2, round1_tokens_equal=r1["tokens_equal"],
                            fired=1, tiering={k: st[k] for k in (
                                "swap_out_count", "restore_count",
                                "put_failed_count", "get_failed_count",
                                "corrupt_count")})
    # wire corruption: on a forced migration, and on every snapshot
    plan = FaultPlan([FaultSpec(site="wire_corrupt", where="migration")])
    fleet = FleetManager([WorkerProfile(name="a"), WorkerProfile(name="b")])
    done = []

    def migrate(eng):
        if not done and eng.slots[0] is not None:
            fleet.rebalance_now([(0, 2), (2, 2)])
            done.append(eng.step_idx)
    got, _ = _equiv_serve(dev, cfg, params, spec, backend="hetero",
                          paged_kv=True, fleet=fleet, chaos=plan,
                          on_step=migrate, **sup)
    ev = fleet.telemetry.events_of("corruption")
    if plan.count() != 1 or not ev or ev[0].detail["replayed"] < 1:
        raise AssertionError(f"equiv_fleet wire_corrupt migration: {ev}")
    faults["wire_corrupt_migration"] = dict(
        _equal_or_raise("wire_corrupt migration", got, want4), fired=1,
        corruption=ev[0].detail)
    plan = FaultPlan([FaultSpec(site="wire_corrupt", where="snapshot",
                                times=-1),
                      FaultSpec(site="r_step", kind="crash", wid=0,
                                after=8)])
    fleet = FleetManager([WorkerProfile(name="a"), WorkerProfile(name="b")],
                         snapshot_interval=2, recovery="snapshot")
    got, _ = _equiv_serve(dev, cfg, params, spec, backend="hetero",
                          paged_kv=True, fleet=fleet, chaos=plan, **sup)
    ev = fleet.telemetry.events_of("corruption")
    rec = fleet.telemetry.events_of("recovery")
    if plan.count("wire_corrupt") < 1 or not ev \
            or ev[0].detail["source"] != "snapshot" \
            or not rec or rec[-1].detail["mode"] != "reprefill":
        raise AssertionError(f"equiv_fleet wire_corrupt snapshot: {ev}, "
                             f"{rec}")
    faults["wire_corrupt_snapshot"] = dict(
        _equal_or_raise("wire_corrupt snapshot", got, want4),
        fired=plan.count(), recovery_mode="reprefill")
    res["faults"] = faults
    return res


# ---------------------------------------------------------------------------
# the paper's evaluation models and the static-batch API
# ---------------------------------------------------------------------------
OPT_LAYERS = 8          # opt-175b's depth on one card (of 96)


def _free_device() -> None:
    """Return dropped models' and engines' device memory: an engine's
    graphs and workers form reference cycles with it (and its params),
    which only the cyclic collector frees."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
STATIC_STEPS = 16       # decode steps per static_eval run
STATIC_PROMPT = 512     # static_eval's prompt tokens per row


def eval_model(dev, arch: str, layers=None) -> dict:
    """One of the paper's evaluation models at full width, bf16, random
    weights from a seeded generator; ``layers`` cuts its depth.  Builds
    the kernels first (a no-op once built), so that no serve's first step
    pays for nvcc."""
    import dataclasses
    import torch
    from repro_torch.core.config import get_arch
    from repro_torch.kernels import build
    from repro_torch.models.model import init_params
    from repro_torch.serving.kv_cache import cache_bytes
    cfg = get_arch(arch)
    full = cfg.num_layers
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    t0 = time.perf_counter()
    build.build()
    t1 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    return {"cfg": cfg, "params": params, "build_s": t1 - t0,
            "init_s": time.perf_counter() - t1,
            "weight_bytes": cache_bytes(params), "full_layers": full}


def serve_eval_run(dev, model, out: Path, spec_k: int = 0,
                   phase: str = "serve_eval", after=None) -> dict:
    """The 12-request trace through ServingEngine(backend="hetero",
    num_r_workers=2, paged_kv=True) on an evaluation model, with graphs,
    counted as ``serve``'s graph run (launches of kernel 1 = layers x
    micro-batches x workers x decode steps; with ``spec_k``, kernel 4 =
    layers x workers x verify works and no kernel 1; no plain version),
    with a profiled window; ``after`` goes to ``serve_run``."""
    cfg = model["cfg"]
    t0 = time.perf_counter()
    tag = f"{phase}_{cfg.name}" + (f"_spec{spec_k}" if spec_k else "")
    rec = serve_run(dev, model, out, paged=True, quantized=False,
                    spec_k=spec_k, kernel="paged_verify_attention" if spec_k
                    else "paged_decode_attention", profile=tag, after=after)
    keys = SUMMARY_KEYS + (
        "model", "layers", "d_model", "heads", "d_ff", "vocab",
        "weight_bytes", "init_s", "decode_steps", "requests",
        "kernel_launches_expected", "launches", "plain_calls",
        "decode_tokens", "prompt_tokens", "page_pool_bytes",
        "graph_pool_bytes", "prefill_step_wall_s_max", "prefill_steps",
        "tokens")
    if spec_k:
        keys += ("spec_k", "verify_works", "acceptance_rate", "spec_stats")
    run = {k: rec[k] for k in keys}
    run["full_layers"] = model["full_layers"]
    run["depth_cut"] = (None if cfg.num_layers == model["full_layers"]
                        else f"{cfg.num_layers} of {model['full_layers']} "
                             f"layers (full width)")
    run["window"] = {k: rec["trace"][k] for k in (
        "wall_s", "device_idle_ratio", "host_launches",
        "kernel_launches_host", "graph_launches_host")}
    run["seconds"] = time.perf_counter() - t0
    print(f"{tag}: {cfg.num_layers} layers"
          + (f" (cut from {model['full_layers']})" if run["depth_cut"]
             else " (full depth)")
          + f", {rec['decode_tokens_per_s']:.2f} tokens/s, step p50 "
            f"{rec['decode_step_s_p50']:.4f} s", flush=True)
    return run


def _static_prompts(cfg, batch: int, p_len: int, seed: int, ragged=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (batch, p_len)).astype(np.int32)
    plens = (rng.integers(17, p_len + 1, batch) if ragged
             else np.full((batch,), p_len)).astype(np.int32)
    return toks, plens


def _static_run(dev, cfg, params, toks, plens, *, how: str, steps: int,
                batch: int, cache_len: int, num_mb: int = 2,
                workers: int = 2, eager: bool = False, engine_kw=None,
                enc_feats=None, paged: bool = True, expect=None,
                profile=None, out=None, after=None):
    """repro's static-batch bench loop on the port: ``load_prefill`` of
    every micro-batch (``ColocatedEngine.load_prefill`` of the batch for
    ``how`` "colocated"), ``reset_step_stats``, then ``steps`` greedy
    steps of ``decode_step`` ("fused"), ``decode_step_legacy``
    ("legacy"), the two in turns ("alternated", legacy first) or the
    colocated step, each fed the last prompt token first (as
    examples/quickstart.py).  ``enc_feats`` [batch, n, d] (an
    early-fusion or a cross-attention arch's features) go to
    ``load_prefill``, sliced per micro-batch.  Every count is set to 0
    just before the steps and read just after, and must equal ``expect``
    ({kernel: launches}; default kernel 1 = layers x micro-batches x
    workers x steps on a hetero run, nothing on a colocated one) with no
    plain call.  ``profile`` (a name): 3 more steps in a profiled window
    after the counted ones (tables to ``out``); ``after(eng)`` adds to
    the record before the engine closes.  Returns (record, {row: tokens},
    {(row, step): the logits row that chose the token, on the host})."""
    import torch
    from repro_torch.core import graphs
    from repro_torch.core.hetero import ColocatedEngine, HeteroPipelineEngine
    from repro_torch.kernels import quant_kv as QK
    pc = time.perf_counter
    mb = batch // num_mb
    tt = torch.from_numpy(toks).to(dev)
    pp = torch.from_numpy(plens).to(dev)
    colo = how == "colocated"
    feats = [None] * num_mb if enc_feats is None else [
        enc_feats[m * mb:(m + 1) * mb] for m in range(num_mb)]
    with (graphs.eager() if eager else contextlib.nullcontext()):
        if colo:
            eng = ColocatedEngine(params, cfg, batch=batch,
                                  cache_len=cache_len, device=dev)
        else:
            eng = HeteroPipelineEngine(
                params, cfg, batch=batch, cache_len=cache_len,
                num_r_workers=workers, num_microbatches=num_mb,
                paged_kv=paged, device=dev, **(engine_kw or {}))
        try:
            torch.cuda.synchronize()
            t0 = pc()
            if colo:
                eng.load_prefill(tt, pp, enc_feats=enc_feats)
            else:
                for m in range(num_mb):
                    eng.load_prefill(m, tt[m * mb:(m + 1) * mb],
                                     pp[m * mb:(m + 1) * mb],
                                     enc_feats=feats[m])
            torch.cuda.synchronize()
            load_s = pc() - t0
            if not colo:
                eng.reset_step_stats()
            tok = tt[torch.arange(batch, device=dev), pp.long() - 1][:, None]
            counters = _counters()
            _reset_counters()
            graphs.captures.reset()
            tokens = {r: [] for r in range(batch)}
            rows, step_s, stats = {}, [], []
            for i in range(steps):
                t0 = pc()
                if colo:
                    logits = eng.decode_step(tok)
                else:
                    legacy = how == "legacy" or (how == "alternated"
                                                 and i % 2 == 0)
                    fn = eng.decode_step_legacy if legacy else eng.decode_step
                    logits = torch.cat(fn([tok[m * mb:(m + 1) * mb]
                                           for m in range(num_mb)]))
                tok = logits.argmax(-1)[:, None].to(torch.int32)
                host = tok[:, 0].cpu().tolist()     # the step's sync
                step_s.append(pc() - t0)
                lg = logits.float().cpu()
                for r in range(batch):
                    tokens[r].append(host[r])
                    rows[(r, i)] = lg[r]
                if not colo:
                    stats.append(dict(eng.last_step_stats))
            torch.cuda.synchronize()
            launches = {n: c[0].value for n, c in counters.items()}
            plain = {n: c[1].value for n, c in counters.items()}
            paged_int8 = QK.paged_launches.value
            rec = {"how": how, "mode": "eager" if eager else "graphs",
                   "engine": ("ColocatedEngine" if colo else
                              f"HeteroPipelineEngine(paged_kv={paged}, "
                              f"num_r_workers={workers})"),
                   "load_prefill_s": load_s, "steps": steps,
                   "tokens_per_s": batch * steps / sum(step_s),
                   "tokens_per_s_after_first_step":
                       batch * (steps - 1) / sum(step_s[1:]),
                   "first_step_s": step_s[0],
                   "step_s_p50": float(np.median(step_s)),
                   "step_s": step_s, "kernel_launches": launches,
                   "int8_paged_launches": paged_int8,
                   "plain_calls": plain,
                   "capture_count": graphs.captures.capture_count,
                   "capture_s": graphs.captures.capture_s}
            if not colo:
                rec.update({"step_stats": stats,
                            "step_stats_total": dict(eng.step_stats),
                            "r_worker_busy_s": eng.worker_busy_times(),
                            "kernel_launches_expected": expect or {
                                "paged_decode_attention": cfg.num_layers
                                * num_mb * len(eng.workers) * steps}})
                if engine_kw:
                    rec["engine_kw"] = {k: str(v)
                                        for k, v in engine_kw.items()}
            if profile:
                def step():
                    nonlocal tok
                    lg = torch.cat(eng.decode_step(
                        [tok[m * mb:(m + 1) * mb] for m in range(num_mb)]))
                    tok = lg.argmax(-1)[:, None].to(torch.int32)
                # _profile_steps drives eng.step()
                rec["window"] = _profile_steps(
                    types.SimpleNamespace(step=step), 3, out, profile,
                    trace=False)
            if after is not None:
                rec.update(after(eng))
        finally:
            if not colo:
                eng.close()
    want = rec.get("kernel_launches_expected") or {}
    bad = {n: (v, want.get(n, 0)) for n, v in launches.items()
           if v != want.get(n, 0)}
    if bad or any(plain.values()):
        raise AssertionError(
            f"static {how} run: launches (got, expected) {bad} (expected "
            f"{want}), plain calls {plain}")
    return rec, tokens, rows


def phase_static_eval(dev, model) -> dict:
    """llama-13b at full size through the static-batch API, as repro's
    benches drive it: batch 8 in 2 micro-batches, 2 R-workers, paged,
    cache_len 1024, 512-token prompts; 16 steps each of the fused step,
    the legacy step and the fused step with profile_timing (each on a
    fresh engine after load_prefill and reset_step_stats), beside the
    colocated engine at the same batch.  The legacy and profile_timing
    tokens must equal the fused step's, any bf16 difference a near-tie
    flip by the ROADMAP §3 rule; the colocated tokens are reported,
    triaged the same way.  Beside the measurements, the §4.3 model's
    prediction for the same batch on GPU_H100 (from the spec sheet)."""
    import torch
    from repro_torch.core import perfmodel as P
    t_phase = time.perf_counter()
    cfg, params = model["cfg"], model["params"]
    toks, plens = _static_prompts(cfg, 8, STATIC_PROMPT, 3)
    kw = dict(steps=STATIC_STEPS, batch=8, cache_len=1024)
    runs, logs = {}, {}
    for name, how, ekw in (("fused", "fused", None),
                           ("legacy", "legacy", None),
                           ("profile_timing", "fused",
                            {"profile_timing": True}),
                           ("colocated", "colocated", None)):
        rec, tokens, rows = _static_run(dev, cfg, params, toks, plens,
                                        how=how, engine_kw=ekw, **kw)
        runs[name], logs[name] = rec, (tokens, rows)
        _free_device()
    want, rows_w = logs["fused"]
    triage = {n: _triage(logs[n][0], want, logs[n][1], rows_w)
              for n in ("legacy", "profile_timing", "colocated")}
    bad = {n: triage[n]["not_near_tie"] for n in ("legacy", "profile_timing")
           if triage[n]["not_near_tie"]}
    if bad:
        raise AssertionError(f"static_eval: tokens part from the fused "
                             f"step's beyond a near-tie flip: {bad}")
    b = kw["batch"]
    t_b = P.t_of_b(cfg, P.GPU_H100, b)
    plan = P.plan(cfg, P.GPU_H100, P.GPU_H100, seq_len=1024, page=16)
    prediction = {
        "source": "core/perfmodel.py (§4.3) on GPU_H100, from the spec "
                  "sheet: a prediction, not a measurement",
        "batch": b, "t_of_b": t_b,
        "tokens_per_s": b / (2 * cfg.num_layers * t_b),
        "plan": {k: plan.get(k) for k in ("batch", "workers", "t_of_b",
                                          "tokens_per_s")}}
    print(f"static_eval {cfg.name}: fused {runs['fused']['tokens_per_s']:.2f}"
          f" tokens/s, legacy {runs['legacy']['tokens_per_s']:.2f}, "
          f"profile_timing {runs['profile_timing']['tokens_per_s']:.2f}, "
          f"colocated {runs['colocated']['tokens_per_s']:.2f}; predicted "
          f"(perfmodel, GPU_H100, batch {b}) "
          f"{prediction['tokens_per_s']:.1f}", flush=True)
    return {"phase": "static_eval", "ok": True, "model": cfg.name,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "heads": [cfg.num_heads, cfg.num_kv_heads], "dtype": cfg.dtype,
            "batch": b, "micro_batches": 2, "r_workers": 2,
            "cache_len": 1024, "page_size": 16,
            "prompt_tokens_per_row": STATIC_PROMPT, "runs": runs,
            "triage_vs_fused": triage, "prediction": prediction,
            "kernel_launches": runs["fused"]["kernel_launches"][
                "paged_decode_attention"],
            "seconds": time.perf_counter() - t_phase}


EVAL_EQUIV_ARCHS = (("llama-13b", "G 1, 40 heads"),
                    ("opt-175b", "G 1, 96 heads, GELU MLP"),
                    ("deepseek-coder-33b", "G 7"))


def _static_equal(name, got, want, tol) -> dict:
    """Two static runs' tokens and rows: token-exact, a flip counting
    only if the teacher-forced rows that chose it are within ``tol``;
    every row before any divergence within ``tol``."""
    max_diff, mismatches, ties, margin = _compare_rows(
        got[0], want[0], got[1], want[1], tol)
    if mismatches or max_diff > tol:
        raise AssertionError(
            f"equiv_eval {name}: mismatches {mismatches}, max logit diff "
            f"{max_diff} (tol {tol})")
    return {"tokens_equal": not ties, "near_tie_flips": ties,
            "max_logit_diff": max_diff, "min_top2_margin": margin}


def phase_equiv_eval(dev) -> dict:
    """fp32, TF32 off, 2 layers at the full width of llama-13b, opt-175b
    and deepseek-coder-33b (G = 7): the serve (hetero paged through
    kernel 1 == colocated, graphs == eager) and the static-batch API
    (load_prefill + decode_step == + decode_step_legacy == the two
    alternated == ColocatedEngine.load_prefill + decode_step, and the
    fused step's graphs == its eager run)."""
    import dataclasses
    import torch
    from repro_torch.core.config import get_arch
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models.model import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t_phase = time.perf_counter()
    cases = {}
    for arch, note in EVAL_EQUIV_ARCHS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_arch(arch), num_layers=2,
                                  dtype="float32")
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(4),
                             device=dev)
        spec = dict(n=6, p_lo=17, p_hi=200, new_lo=6, new_hi=10,
                    vocab=cfg.vocab_size)
        PA.launches.reset()
        got, _ = _equiv_serve(dev, cfg, params, spec, backend="hetero",
                              paged_kv=True)
        launches = PA.launches.value
        eager, _ = _equiv_serve(dev, cfg, params, spec, eager=True,
                                backend="hetero", paged_kv=True)
        vs_eager = _graphs_equal_eager(f"{arch} serve", got, eager)
        want, _ = _equiv_serve(dev, cfg, params, spec, backend="colocated")
        max_diff, mismatches, ties, margin = _compare(got, want,
                                                      EQUIV_LOGIT_TOL)
        if mismatches or max_diff > EQUIV_LOGIT_TOL or launches == 0:
            raise AssertionError(
                f"equiv_eval {arch}: hetero-paged != colocated: mismatches "
                f"{mismatches}, max logit diff {max_diff} (tol "
                f"{EQUIV_LOGIT_TOL}), kernel launches {launches}")
        rec = {"note": note, "heads": [cfg.num_heads, cfg.num_kv_heads],
               "d_model": cfg.d_model, "d_ff": cfg.d_ff,
               "ffn": cfg.ffn_kind,
               "serve": {"requests": len(want), "tokens_equal": not ties,
                         "near_tie_flips": ties, "max_logit_diff": max_diff,
                         "min_top2_margin": margin,
                         "max_logit_diff_vs_eager": vs_eager,
                         "kernel_launches": launches}}
        toks, plens = _static_prompts(cfg, 4, 200, 5, ragged=True)
        kw = dict(steps=8, batch=4, cache_len=256)
        static = {}
        for name, how, eager_ in (("fused", "fused", False),
                                  ("fused_eager", "fused", True),
                                  ("legacy", "legacy", False),
                                  ("alternated", "alternated", False),
                                  ("colocated", "colocated", False)):
            r, tokens, rows = _static_run(dev, cfg, params, toks, plens,
                                          how=how, eager=eager_, **kw)
            static[name] = ((tokens, rows), r)
        ref = static["colocated"][0]
        rec["static"] = {
            name: dict(_static_equal(f"{arch} static {name}", static[name][0],
                                     ref, EQUIV_LOGIT_TOL),
                       kernel_launches=static[name][1]["kernel_launches"][
                           "paged_decode_attention"])
            for name in ("fused", "fused_eager", "legacy", "alternated")}
        for name in ("fused_eager", "legacy", "alternated"):
            rec["static"][name]["vs_fused"] = _static_equal(
                f"{arch} static {name} vs fused", static[name][0],
                static["fused"][0], EQUIV_LOGIT_TOL)
        rec["seconds"] = time.perf_counter() - t0
        cases[arch] = rec
        del params, static
        _free_device()
    return {"phase": "equiv_eval", "ok": True, "layers": 2,
            "dtype": "float32", "tf32": False, "logit_tol": EQUIV_LOGIT_TOL,
            "cases": cases, "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# the mixture-of-experts models
# ---------------------------------------------------------------------------
GROK_LAYERS = 4         # grok-1-314b's depth on one card (of 64)
SCOUT_LAYERS = 8        # llama4-scout-17b-a16e's (of 48)


class _DropCount:
    """While active, every MoE routing call (``layers.moe_route``) adds
    its dropped and its routed (token, expert) pairs to counters on the
    card: the calls inside a monolithic prefill (``model.prefill``) to
    ``counts["prefill"]``, all others (the decode micro-batches' S-Part
    bodies; with spec decoding the drafter's and the verify's too) to
    ``counts["decode"]``.  A graph captured while it is active carries
    the adds, so its replays count: two in-place adds per MoE call."""

    def __init__(self, dev):
        self.dev = dev

    def __enter__(self):
        import threading
        import torch
        from repro_torch.models import layers, model
        self.counts = {k: torch.zeros(2, dtype=torch.int64, device=self.dev)
                       for k in ("decode", "prefill")}
        self._route, self._prefill = layers.moe_route, model.prefill
        flag = threading.local()

        def route(probs, **kw):
            out = self._route(probs, **kw)
            keep = out[3]
            c = self.counts["prefill" if getattr(flag, "on", False)
                            else "decode"]
            c[0] += (~keep).sum()
            c[1] += keep.numel()
            return out

        def prefill(*a, **kw):
            flag.on = True
            try:
                return self._prefill(*a, **kw)
            finally:
                flag.on = False
        layers.moe_route, model.prefill = route, prefill
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers, model
        layers.moe_route, model.prefill = self._route, self._prefill

    def read(self) -> dict:
        """{"decode" | "prefill": {dropped, routed, dropped_share}}."""
        out = {}
        for k, c in self.counts.items():
            dropped, routed = c.tolist()
            out[k] = {"dropped": dropped, "routed": routed,
                      "dropped_share": dropped / routed if routed else None}
        return out


REPLAY_RID = 200        # rid offset of the drop-counting replay


def _replay_drops(dev, eng) -> dict:
    """The ``after`` hook of a MoE serve: the counted trace once more on
    the warm engine, op by op (``graphs.eager``) under ``_DropCount``, so
    the timed run's graphs carry no counter.  The drops, and the share of
    requests whose tokens equal the timed run's (the eager bodies compute
    what the graphs replay, so the replay routes the same tokens)."""
    import torch
    from repro_torch.core import graphs
    timed = {r.rid: list(r.generated) for r in eng.finished}
    reqs = _requests(np.random.default_rng(0), 12, 17, 600, 16, 32,
                     eng.cfg.vocab_size)
    for r in reqs:
        r.rid += REPLAY_RID
        eng.submit(r)
    with graphs.eager(), _DropCount(dev) as drops:
        while eng.queue or any(s is not None for s in eng.slots):
            eng.step()
        torch.cuda.synchronize()
    rec = drops.read()
    rec["requests_equal_to_timed_run"] = sum(
        list(r.generated) == timed[r.rid - REPLAY_RID] for r in reqs) \
        / len(reqs)
    return rec


def moe_weight_bytes(cfg) -> dict:
    """Bytes of bf16 weights one decode micro-batch reads a step: every
    layer's attention and ALL its experts (the capacity dispatch runs
    each expert's products on its [cap, d] slots, empty or not), the
    router, and the lm head; beside the §4.3 model's count, which takes
    the top-k experts per token (``perfmodel.s_part_params_per_block``)."""
    import dataclasses
    from repro_torch.core import perfmodel as P
    d, f, e, k = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.top_k
    attn = P.s_part_params_per_block(dataclasses.replace(cfg,
                                                         ffn_kind="none"))
    layer = attn + e * 3 * d * f + d * e
    model_layer = P.s_part_params_per_block(cfg)
    head = d * cfg.vocab_size
    return {"layer_bytes": 2 * layer,
            "perfmodel_layer_bytes": 2 * model_layer,
            "perfmodel_undercount": layer / model_layer,
            "expert_ratio_e_over_k": e / k,
            "micro_batch_step_bytes": 2 * (cfg.num_layers * layer + head),
            "step_bytes_two_micro_batches":
                2 * 2 * (cfg.num_layers * layer + head),
            "step_bound_s": 2 * 2 * (cfg.num_layers * layer + head)
            / HBM_BYTES_PER_S}


def moe_serve_run(dev, model, out: Path, spec_k: int = 0) -> dict:
    """``serve_eval_run`` on a MoE model, with the capacity's drops at
    decode and at prefill (counted in an eager replay of the trace after
    the timed run: ``_replay_drops``), the weight bytes a step reads and
    the §4.3 model's prediction."""
    from repro_torch.core import perfmodel as P
    cfg = model["cfg"]
    snap = {}
    run = serve_eval_run(dev, model, out, spec_k=spec_k, phase="serve_moe",
                         after=lambda eng: snap.update(_replay_drops(dev,
                                                                     eng)))
    t_b = P.t_of_b(cfg, P.GPU_H100, 8)
    run.update({
        "experts": cfg.num_experts, "top_k": cfg.top_k,
        "moe_capacity": cfg.moe_capacity,
        "softcap": cfg.attn_logit_softcap, "qk_norm": cfg.qk_norm,
        "drops": snap, "weights": moe_weight_bytes(cfg),
        "prediction": {
            "source": "core/perfmodel.py (§4.3) on GPU_H100, from the "
                      "spec sheet: a prediction, not a measurement",
            "batch": 8, "t_of_b": t_b,
            "tokens_per_s": 8 / (2 * cfg.num_layers * t_b)}})
    print(f"serve_moe {cfg.name}: dropped {snap['decode']['dropped_share']}"
          f" (decode), {snap['prefill']['dropped_share']} (prefill)",
          flush=True)
    return run


def phase_serve_moe(dev, out: Path) -> dict:
    """grok-1 (4 of 64 layers) served spec-off then with
    spec_decode=SpecConfig(k=3), then llama4-scout (8 of 48 layers), each
    at full width in bf16 from seeded random weights, each model freed
    before the next."""
    t_phase = time.perf_counter()
    runs = []
    grok = eval_model(dev, "grok-1-314b", layers=GROK_LAYERS)
    runs.append(moe_serve_run(dev, grok, out))
    runs.append(moe_serve_run(dev, grok, out, spec_k=3))
    del grok
    _free_device()
    scout = eval_model(dev, "llama4-scout-17b-a16e", layers=SCOUT_LAYERS)
    runs.append(moe_serve_run(dev, scout, out))
    del scout
    _free_device()
    off, on = runs[0]["tokens"], runs[1]["tokens"]
    runs[1]["requests_equal_to_spec_off"] = sum(
        on[r] == off[r] for r in off) / len(off)
    return {"phase": "serve_moe", "ok": True, "runs": runs,
            "kernel_launches": {
                "paged_decode_attention": {
                    r["model"]: r["kernel_launches"] for r in runs
                    if "spec_k" not in r},
                "paged_verify_attention": runs[1]["kernel_launches"]},
            "seconds": time.perf_counter() - t_phase}


def _moe_equiv_model(dev, arch: str, capacity=None):
    """2 layers of ``arch`` at full width, fp32 (TF32 off), seeded random
    weights; ``capacity`` (None: the published 1.25) sets moe_capacity."""
    import dataclasses
    import torch
    from repro_torch.core.config import get_arch
    from repro_torch.models.model import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = dataclasses.replace(get_arch(arch), num_layers=2, dtype="float32")
    if capacity is not None:
        cfg = dataclasses.replace(cfg, moe_capacity=float(capacity))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(6),
                         device=dev)
    return cfg, params


def _bitwise_equal(name, got, want) -> dict:
    """Two runs of one trace: equal tokens and every logits row equal
    bit for bit."""
    rows = 0
    for rid, (toks_w, logs_w) in want.items():
        toks_g, logs_g = got[rid]
        if toks_g != toks_w or len(logs_g) != len(logs_w) or not all(
                bool((a == b).all()) for a, b in zip(logs_g, logs_w)):
            raise AssertionError(f"{name}: graphs != eager bitwise on "
                                 f"request {rid}")
        rows += len(logs_w)
    return {"requests": len(want), "logit_rows": rows, "bitwise": True}


def phase_equiv_moe(dev) -> dict:
    """fp32 at 2 layers of grok-1's and llama4-scout's full width: with
    moe_capacity = num_experts (no drops) hetero paged (kernel 1) ==
    colocated, graphs == eager; at the published 1.25, graphs == eager
    bitwise on the hetero path, and the drops of hetero and colocated
    reported (they differ, as in the JAX package: t differs); and
    llama4-scout's load_prefill with 64 patch embeddings: hetero ==
    colocated logits (no drops)."""
    import torch
    from repro_torch.kernels import paged_attention as PA
    t_phase = time.perf_counter()
    spec = dict(n=6, p_lo=17, p_hi=200, new_lo=6, new_hi=10)
    cases = {}
    for arch in ("grok-1-314b", "llama4-scout-17b-a16e"):
        t0 = time.perf_counter()
        rec = {}
        cfg, params = _moe_equiv_model(dev, arch)
        sp = dict(spec, vocab=cfg.vocab_size)
        # the published capacity: graphs == eager bitwise (hetero), and
        # the two engines' drops
        with _DropCount(dev) as dh:
            got, _ = _equiv_serve(dev, cfg, params, sp, backend="hetero",
                                  paged_kv=True)
        with _DropCount(dev) as dh_eager:
            eager, _ = _equiv_serve(dev, cfg, params, sp, eager=True,
                                    backend="hetero", paged_kv=True)
        with _DropCount(dev) as dc:
            colo, _ = _equiv_serve(dev, cfg, params, sp,
                                   backend="colocated")
        max_diff, mism, ties, _ = _compare(got, colo, EQUIV_LOGIT_TOL)
        rec["capacity_1.25"] = {
            "graphs_vs_eager": _bitwise_equal(f"{arch} capacity 1.25", got,
                                              eager),
            "drops_hetero": dh.read(), "drops_hetero_eager": dh_eager.read(),
            "drops_colocated": dc.read(),
            "vs_colocated": {"requests_equal": sum(
                got[r][0] == colo[r][0] for r in colo),
                "first_diffs": mism + ties, "max_logit_diff_before": max_diff}}
        if rec["capacity_1.25"]["drops_hetero"] \
                != rec["capacity_1.25"]["drops_hetero_eager"]:
            raise AssertionError(f"{arch}: graph and eager drops differ")
        del params
        _free_device()
        # no drops: hetero paged == colocated
        cfg, params = _moe_equiv_model(dev, arch, capacity=cfg.num_experts)
        PA.launches.reset()
        with _DropCount(dev) as dn:
            got, _ = _equiv_serve(dev, cfg, params, sp, backend="hetero",
                                  paged_kv=True)
        launches = PA.launches.value
        eager, _ = _equiv_serve(dev, cfg, params, sp, eager=True,
                                backend="hetero", paged_kv=True)
        vs_eager = _graphs_equal_eager(f"{arch} no drops", got, eager)
        want, _ = _equiv_serve(dev, cfg, params, sp, backend="colocated")
        max_diff, mism, ties, margin = _compare(got, want, EQUIV_LOGIT_TOL)
        nodrop = dn.read()
        if mism or max_diff > EQUIV_LOGIT_TOL or launches == 0 \
                or nodrop["decode"]["dropped"] or nodrop["prefill"]["dropped"]:
            raise AssertionError(
                f"equiv_moe {arch}: hetero-paged != colocated at capacity "
                f"= experts: mismatches {mism}, max logit diff {max_diff} "
                f"(tol {EQUIV_LOGIT_TOL}), kernel launches {launches}, "
                f"drops {nodrop}")
        rec["capacity_experts"] = {
            "requests": len(want), "tokens_equal": not ties,
            "near_tie_flips": ties, "max_logit_diff": max_diff,
            "min_top2_margin": margin, "max_logit_diff_vs_eager": vs_eager,
            "kernel_launches": launches, "drops": nodrop}
        if cfg.frontend == "vision_stub":
            # early fusion through load_prefill: 64 patch embeddings
            toks, plens = _static_prompts(cfg, 4, 200, 7, ragged=True)
            plens = np.maximum(plens, cfg.encoder_seq + 1).astype(np.int32)
            feats = torch.randn((4, cfg.encoder_seq, cfg.d_model),
                                generator=torch.Generator(
                                    device=dev).manual_seed(8),
                                device=dev)
            kw = dict(steps=8, batch=4, cache_len=256, enc_feats=feats)
            runs = {}
            for how in ("fused", "colocated"):
                r, tokens, rows = _static_run(dev, cfg, params, toks, plens,
                                              how=how, **kw)
                runs[how] = (tokens, rows)
            plain, _, rows_plain = _static_run(dev, cfg, params, toks, plens,
                                               how="colocated", steps=2,
                                               batch=4, cache_len=256)
            moved = float((rows_plain[(0, 0)]
                           - runs["colocated"][1][(0, 0)]).abs().max())
            rec["load_prefill_enc_feats"] = dict(
                _static_equal(f"{arch} load_prefill(enc_feats)",
                              runs["fused"], runs["colocated"],
                              EQUIV_LOGIT_TOL),
                patch_embeddings=cfg.encoder_seq,
                max_logit_change_from_features=moved)
            if moved <= EQUIV_LOGIT_TOL:
                raise AssertionError(f"{arch}: the patch embeddings did "
                                     f"not reach the logits")
        rec["seconds"] = time.perf_counter() - t0
        cases[arch] = rec
        del params
        _free_device()
    return {"phase": "equiv_moe", "ok": True, "layers": 2,
            "dtype": "float32", "tf32": False, "logit_tol": EQUIV_LOGIT_TOL,
            "cases": cases, "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# the recurrent models: recurrentgemma-2b (RG-LRU + windowed MQA) and
# mamba2-2.7b (SSD), full size
# ---------------------------------------------------------------------------
RECURRENT_CHUNK = 128   # serve_rglru's and serve_ssd's prefill_chunk


def recurrent_serve_run(dev, model, out: Path, *, quantized=False,
                        prefill_chunk=0, phase: str) -> dict:
    """The 12-request trace through ServingEngine(backend="hetero",
    num_r_workers=2, paged_kv=True) on a recurrent model, with graphs and
    a profiled window, counted as ``serve``'s graph run.  Only attention
    layers launch a kernel: with ``quantized`` kernel 3's slab entry
    (the windowed layers stay dense under paged_kv) = attention layers x
    micro-batches x workers x decode steps; else none at all; no plain
    version.  The record adds the step bound (the weights read once per
    micro-batch: 2 x weight bytes / 3.35 TB/s) and the R-state's bytes."""
    cfg = model["cfg"]
    t0 = time.perf_counter()
    tag = (f"{phase}_{cfg.name}" + ("_int8" if quantized else "")
           + (f"_chunk{prefill_chunk}" if prefill_chunk else ""))
    state = {}

    def after(eng):
        ws = eng.engine.workers
        state.update(
            allocators=sum(len(w.allocators) for w in ws),
            paged_keys=sum(len(w.paged_keys) for w in ws),
            recurrent_state_bytes=sum(
                v.numel() * v.element_size() for w in ws
                for st in w.state.values() if set(st) == {"h"}
                for v in st.values()),
            attention_state_bytes=sum(
                v.numel() * v.element_size() for w in ws
                for st in w.state.values() if set(st) != {"h"}
                for v in st.values()),
            s_conv_bytes=sum(v.numel() * v.element_size()
                             for mb in eng.engine.s_states for st in mb
                             for v in st.values()))
    rec = serve_run(dev, model, out, paged=True, quantized=quantized,
                    prefill_chunk=prefill_chunk,
                    kernel="decode_attention_int8" if quantized else None,
                    profile=tag, after=after)
    keys = SUMMARY_KEYS + (
        "model", "layers", "attention_layers", "d_model", "heads", "d_ff",
        "vocab", "weight_bytes", "init_s", "decode_steps", "requests",
        "kernel_launches_expected", "launches", "plain_calls",
        "dense_merge_launches", "decode_tokens", "prompt_tokens",
        "page_pool_bytes", "kv_bytes", "graph_pool_bytes",
        "graphs_chunk_s", "graphs_chunk_r", "prefill_step_wall_s_max",
        "prefill_step_wall_s_max_without_captures", "prefill_steps",
        "prefill_works", "prefill_chunk", "storage", "tokens")
    run = {k: rec[k] for k in keys}
    run["full_layers"] = model["full_layers"]
    run["state"] = state
    run["step_bound_s"] = 2 * model["weight_bytes"] / HBM_BYTES_PER_S
    run["p50_over_step_bound"] = (rec["decode_step_s_p50"]
                                  / run["step_bound_s"])
    run["window"] = {k: rec["trace"][k] for k in (
        "wall_s", "device_idle_ratio", "host_launches",
        "kernel_launches_host", "graph_launches_host",
        "attention_device")}
    run["seconds"] = time.perf_counter() - t0
    print(f"{tag}: {cfg.num_layers} layers, "
          f"{rec['decode_tokens_per_s']:.2f} tokens/s, step p50 "
          f"{rec['decode_step_s_p50']:.4f} s (bound "
          f"{run['step_bound_s']:.5f} s), idle "
          f"{run['window']['device_idle_ratio']:.3f}", flush=True)
    return run


def _chunk_triage(dev, model, out: Path) -> dict:
    """The bf16 chunked serve against the monolithic one, by the ROADMAP
    §3 rule (``_triage``): both served again with the logits row that
    chose every token logged (host copies: these runs are not timed)."""
    rows_m, rows_c = {}, {}
    mono = serve_run(dev, model, out, paged=True, quantized=False,
                     kernel=None, rows=rows_m)
    chunk = serve_run(dev, model, out, paged=True, quantized=False,
                      kernel=None, prefill_chunk=RECURRENT_CHUNK,
                      rows=rows_c)
    return _triage(chunk["tokens"], mono["tokens"], rows_c, rows_m)


def phase_serve_rglru(dev, out: Path) -> dict:
    """recurrentgemma-2b at full size (26 layers: 8 windowed MQA layers,
    Dh 256, Hq 10 / Hkv 1, window 2048, and 18 RG-LRU layers), bf16,
    served as is, with quantized_kv=True (kernel 3's slab entry at Dh
    256 on every decode R-Part of the attention layers) and with
    prefill_chunk=128, the chunked tokens triaged against the monolithic
    ones; the model freed after."""
    t_phase = time.perf_counter()
    model = eval_model(dev, "recurrentgemma-2b")
    runs = [recurrent_serve_run(dev, model, out, phase="serve_rglru"),
            recurrent_serve_run(dev, model, out, quantized=True,
                                phase="serve_rglru"),
            recurrent_serve_run(dev, model, out,
                                prefill_chunk=RECURRENT_CHUNK,
                                phase="serve_rglru")]
    runs[2]["triage_vs_monolithic"] = _chunk_triage(dev, model, out)
    del model
    _free_device()
    base = runs[0]["tokens"]
    for r in runs[1:]:
        r["requests_equal_to_bf16"] = sum(
            r["tokens"][k] == base[k] for k in base) / len(base)
    return {"phase": "serve_rglru", "ok": True, "runs": runs,
            "seconds": time.perf_counter() - t_phase}


def phase_serve_ssd(dev, out: Path) -> dict:
    """mamba2-2.7b at full size (64 SSD layers, no attention: no KV pool
    is built under paged_kv), bf16, served as is and with
    prefill_chunk=128, the chunked tokens triaged against the monolithic
    ones; the model freed after."""
    t_phase = time.perf_counter()
    model = eval_model(dev, "mamba2-2.7b")
    runs = [recurrent_serve_run(dev, model, out, phase="serve_ssd"),
            recurrent_serve_run(dev, model, out,
                                prefill_chunk=RECURRENT_CHUNK,
                                phase="serve_ssd")]
    runs[1]["triage_vs_monolithic"] = _chunk_triage(dev, model, out)
    cfg = model["cfg"]
    del model
    _free_device()
    for r in runs:
        st = r["state"]
        if st["allocators"] or st["paged_keys"] or r["page_pool_bytes"] \
                or st["attention_state_bytes"]:
            raise AssertionError(f"serve_ssd built KV storage: {st}, pool "
                                 f"bytes {r['page_pool_bytes']}")
    runs[1]["requests_equal_to_monolithic"] = sum(
        runs[1]["tokens"][k] == runs[0]["tokens"][k]
        for k in runs[0]["tokens"]) / len(runs[0]["tokens"])
    return {"phase": "serve_ssd", "ok": True, "runs": runs,
            "kv_pool_built": False,
            "r_state_bytes_per_row_and_layer":
                cfg.ssd_heads * cfg.ssd_head_dim * cfg.ssm_state * 4,
            "seconds": time.perf_counter() - t_phase}


def _recurrent_equiv_model(dev, arch: str, layers: int):
    """``layers`` of ``arch`` at full width, fp32 (TF32 off), seeded
    random weights."""
    import dataclasses
    import torch
    from repro_torch.core.config import get_arch
    from repro_torch.models.model import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = dataclasses.replace(get_arch(arch), num_layers=layers,
                              dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(7),
                         device=dev)
    return cfg, params


def phase_equiv_recurrent(dev) -> dict:
    """fp32, TF32 off, at full width: recurrentgemma-2b at 3 layers (one
    period: rglru, rglru, windowed attention) and mamba2-2.7b at 2.
    Hetero paged (2 workers) == colocated; prefill_chunk=16 == monolithic;
    graphs == eager bit for bit; a live migration (apply_partition to (0,
    3), (3, 4) and back, batch 8) leaves every wire payload bit for bit
    and the colocated tokens, as does a re-prefill failover after a
    kill(); the hybrid's int8 storage (kernel 3 at Dh 256) within 0.5 of
    fp on teacher-forced logits."""
    from repro_torch.fleet import FleetManager, uniform_fleet
    t_phase = time.perf_counter()
    spec = dict(n=6, p_lo=17, p_hi=200, new_lo=6, new_hi=10)
    cases = {}
    for arch, layers in (("recurrentgemma-2b", 3), ("mamba2-2.7b", 2)):
        t0 = time.perf_counter()
        cfg, params = _recurrent_equiv_model(dev, arch, layers)
        sp = dict(spec, vocab=cfg.vocab_size)
        rec = {"layers": layers, "pattern": list(cfg.pattern)}
        want, _ = _equiv_serve(dev, cfg, params, sp, backend="colocated")
        _reset_counters()
        got, _ = _equiv_serve(dev, cfg, params, sp, backend="hetero",
                              paged_kv=True)
        launches = {n: c[0].value for n, c in _counters().items()}
        rec["hetero_vs_colocated"] = _equal_or_raise(
            f"equiv_recurrent {arch} hetero", got, want)
        rec["hetero_launches"] = launches
        if any(launches.values()):
            raise AssertionError(f"{arch}: a kernel ran on an fp path "
                                 f"with no pageable layer: {launches}")
        eager, _ = _equiv_serve(dev, cfg, params, sp, eager=True,
                                backend="hetero", paged_kv=True)
        rec["graphs_vs_eager"] = _bitwise_equal(f"{arch} graphs", got, eager)
        chunked, _ = _equiv_serve(dev, cfg, params, sp, backend="hetero",
                                  paged_kv=True, prefill_chunk=16)
        rec["chunked_vs_monolithic"] = _equal_or_raise(
            f"equiv_recurrent {arch} chunked", chunked, got)
        want8, _ = _equiv_serve(dev, cfg, params, sp, backend="colocated",
                                batch=8)
        moves = []

        def on_step(eng, moves=moves):
            if eng.step_idx in (4, 9):
                before = _wire(eng)
                eng.engine.apply_partition(
                    [(0, 3), (3, 4)] if eng.step_idx == 4
                    else [(0, 2), (2, 4)])
                moves.append(_wire_equal(before, _wire(eng)))
        mig, _ = _equiv_serve(dev, cfg, params, sp, batch=8, on_step=on_step,
                              backend="hetero", paged_kv=True)
        if moves != [True, True]:
            raise AssertionError(f"{arch} migration: wire payloads equal "
                                 f"after each move {moves}")
        rec["migration"] = dict(_equal_or_raise(f"{arch} migration", mig,
                                                want8),
                                wire_bitwise_equal=True)
        fleet = FleetManager(uniform_fleet(2), recovery="reprefill")

        def kill(eng):
            if eng.step_idx == 6:
                w = eng.engine.workers[1]
                w.kill()
                w.join(timeout=30)
        fo, _ = _equiv_serve(dev, cfg, params, sp, batch=8, on_step=kill,
                             backend="hetero", paged_kv=True, fleet=fleet,
                             suspect_after_s=SUSPECT_S,
                             collect_timeout_s=120.0)
        ev = fleet.telemetry.events_of("recovery")
        if len(ev) != 1 or ev[0].detail["mode"] != "reprefill":
            raise AssertionError(f"{arch} failover: {ev}")
        rec["failover_reprefill"] = dict(
            _equal_or_raise(f"{arch} failover", fo, want8),
            rows=ev[0].detail["rows"], duration_s=ev[0].detail["duration_s"])
        if "attn" in cfg.pattern:
            forced = {r: t for r, (t, _) in got.items()}
            k3, k3_plain = _counters()["decode_attention_int8"]
            _reset_counters()
            q8, _ = _equiv_serve(dev, cfg, params, sp, forced=forced,
                                 backend="hetero", paged_kv=True,
                                 quantized_kv=True)
            n8, plain8 = k3.value, k3_plain.value
            d = max(float((a - b).abs().max())
                    for r in got for a, b in zip(q8[r][1], got[r][1]))
            if not 0.0 < d <= QUANT_BOUND or n8 == 0 or plain8:
                raise AssertionError(
                    f"{arch} int8: max logit diff {d} (bound "
                    f"{QUANT_BOUND}), kernel 3 launches {n8}, plain "
                    f"{plain8}")
            rec["int8_vs_fp"] = {"max_logit_diff": d,
                                 "bound": QUANT_BOUND,
                                 "kernel3_launches": n8}
        rec["seconds"] = time.perf_counter() - t0
        cases[arch] = rec
        del params
        _free_device()
    return {"phase": "equiv_recurrent", "ok": True, "dtype": "float32",
            "tf32": False, "logit_tol": EQUIV_LOGIT_TOL, "cases": cases,
            "seconds": time.perf_counter() - t_phase}



# ---------------------------------------------------------------------------
# cross-attention: the vision model and the encoder-decoder
# ---------------------------------------------------------------------------
VISION_LAYERS = 10      # llama-3.2-vision-90b's depth on one card (of 100):
                        # two periods, 8 ATTN and 2 XATTN layers
XATTN_STEPS = 32        # decode steps per static_vision run
WHISPER_STEPS = 16      # per static_whisper run: its legacy step takes
                        # ~0.7 s, and the whole run keeps near its budget
WHISPER_PROMPT = 448    # whisper's decoder context (arXiv:2212.04356)


def _features(dev, cfg, batch: int, seed: int, dtype=None):
    """Seeded stub-frontend features [batch, encoder_seq, encoder_d_model]
    made on the card: patch embeddings (vision) or frame embeddings
    (whisper's encoder input)."""
    import torch
    from repro_torch.device import torch_dtype
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((batch, cfg.encoder_seq, cfg.encoder_d_model),
                       generator=gen, device=dev,
                       dtype=dtype or torch_dtype(cfg.dtype))


def _xattn_expect(cfg, workers: int, steps: int, *, paged=True,
                  quantized=False, num_mb: int = 2) -> dict:
    """Each kernel's launches in a static run: kernel 2 on every
    cross-attention R-Part (XATTN layers, DEC_XATTN phases 1), the ATTN
    layers through kernel 1 when paged, kernel 3 with int8 storage (its
    paged entry when paged); a DEC_XATTN block's self-attention is plain
    torch on its dense slab, as in repro."""
    per = num_mb * workers * steps
    n_attn = cfg.pattern.count("attn")
    out = {"decode_attention": per * sum(k in ("xattn", "dec_xattn")
                                         for k in cfg.pattern)}
    if n_attn and quantized:
        out["decode_attention_int8"] = n_attn * per
    elif n_attn and paged:
        out["paged_decode_attention"] = n_attn * per
    return out


def _step_bytes(model) -> float:
    """The weight bytes one decode step reads per micro-batch: every
    weight but the embedding table (a step gathers B rows of it; a tied
    head reads it whole, so then it counts) and the encoder (it runs at
    load_prefill only)."""
    params, cfg = model["params"], model["cfg"]
    skip = 0 if cfg.tie_embeddings else params["embed"].numel() * \
        params["embed"].element_size()
    if "encoder" in params:
        skip += sum(v.numel() * v.element_size()
                    for v in params["encoder"]["stack"]["s0"].values())
    return model["weight_bytes"] - skip


def _storage_counts(eng) -> dict:
    """Paged layer keys and allocators over the engine's workers, and the
    bytes of the cross-attention K/V they hold."""
    return {"paged_keys": sum(len(w.paged_keys) for w in eng.workers),
            "allocators": sum(len(w.allocators) for w in eng.workers),
            "cross_state_bytes": sum(
                v.numel() * v.element_size() for w in eng.workers
                for st in w.state.values() if "xk" in st
                for k, v in st.items() if k in ("xk", "xv"))}


def _xattn_static(dev, model, out: Path, *, phase, toks, plens, feats,
                  runs, steps) -> tuple:
    """``runs``: (name, how, engine_kw) static runs of ``model`` (batch 8,
    2 micro-batches, 2 R-workers, paged_kv, cache_len 1024, ``steps``
    steps, each on a fresh engine), counted against ``_xattn_expect``,
    the fused and int8 runs with a profiled window.  Returns ({name:
    record, with the step bound 2 x ``_step_bytes`` / 3.35 TB/s beside
    the p50}, {name: (tokens, logits rows)})."""
    cfg, params = model["cfg"], model["params"]
    bound = 2 * _step_bytes(model) / HBM_BYTES_PER_S
    recs, logs = {}, {}
    for name, how, ekw in runs:
        q = bool((ekw or {}).get("quantized_kv"))
        rec, tokens, rows = _static_run(
            dev, cfg, params, toks, plens, how=how, steps=steps,
            batch=8, cache_len=1024, engine_kw=ekw, enc_feats=feats,
            expect=_xattn_expect(cfg, 2, steps, quantized=q),
            profile=f"{phase}_{name}" if name in ("fused", "int8") else None,
            out=out, after=_storage_counts)
        if q and rec["int8_paged_launches"] != rec["kernel_launches"][
                "decode_attention_int8"]:
            raise AssertionError(f"{phase} {name}: kernel 3 launches did not "
                                 f"all go through its paged entry: {rec}")
        rec["step_bound_s"] = bound
        rec["p50_over_step_bound"] = rec["step_s_p50"] / bound
        recs[name], logs[name] = rec, (tokens, rows)
        w = rec.get("window", {})
        print(f"{phase} {name}: {rec['tokens_per_s']:.2f} tokens/s "
              f"({rec['tokens_per_s_after_first_step']:.2f} after the "
              f"first), step p50 {rec['step_s_p50']:.4f} s (bound "
              f"{bound:.5f} s)"
              + (f", idle {w['device_idle_ratio']:.3f}" if w else ""),
              flush=True)
        _free_device()
    return recs, logs


def phase_static_vision(dev, out: Path) -> dict:
    """llama-3.2-vision-90b at full width cut to VISION_LAYERS of its 100
    layers (two periods: 8 ATTN, 2 XATTN), bf16, through the static-batch
    API: batch 8 in 2 micro-batches, 2 R-workers, paged_kv (page 16),
    cache_len 1024, seeded prompts of 17-600 tokens and patch embeddings
    [8, 1600, 8192], load_prefill per micro-batch, XATTN_STEPS fused
    decode_steps; kernel 1 on every ATTN layer and kernel 2 on every
    XATTN layer, exactly; then the same with quantized_kv=True (kernel 3's
    paged entry on the ATTN layers, kernel 2 unchanged).  The model is
    freed after."""
    t_phase = time.perf_counter()
    model = eval_model(dev, "llama-3.2-vision-90b", layers=VISION_LAYERS)
    cfg = model["cfg"]
    toks, plens = _static_prompts(cfg, 8, 600, 13, ragged=True)
    feats = _features(dev, cfg, 8, 14)
    recs, logs = _xattn_static(
        dev, model, out, phase="static_vision", toks=toks, plens=plens,
        feats=feats, steps=XATTN_STEPS,
        runs=(("fused", "fused", None),
              ("int8", "fused", {"quantized_kv": True}),
              ("fused_again", "fused", None)))
    triage = _triage(logs["int8"][0], logs["fused"][0], logs["int8"][1],
                     logs["fused"][1])
    rec = {"phase": "static_vision", "ok": True, "model": cfg.name,
           "layers": cfg.num_layers, "full_layers": model["full_layers"],
           "depth_cut": f"{cfg.num_layers} of {model['full_layers']} layers "
                        f"(full width)",
           "pattern": list(cfg.pattern), "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads],
           "patches": cfg.encoder_seq, "dtype": cfg.dtype,
           "weight_bytes": model["weight_bytes"],
           "step_bytes": _step_bytes(model), "init_s": model["init_s"],
           "batch": 8, "micro_batches": 2, "r_workers": 2,
           "cache_len": 1024, "page_size": 16,
           "prompt_tokens": plens.tolist(), "runs": recs,
           "int8_vs_bf16": triage,
           "kernel_launches": {n: r["kernel_launches"]
                               for n, r in recs.items()},
           "seconds": time.perf_counter() - t_phase}
    del model, feats
    _free_device()
    return rec


def phase_static_whisper(dev, out: Path) -> dict:
    """whisper-medium at full size (24 encoder and 24 decoder layers, d
    1024, 1500 frames), bf16, through the static-batch API as
    static_vision (paged_kv is a no-op: the DEC_XATTN slabs stay dense,
    no page is made), seeded prompts of 17-448 tokens and frame
    embeddings [8, 1500, 1024]: the fused step (a profiled window after),
    the legacy step and the fused step with profile_timing, each
    WHISPER_STEPS steps on a fresh engine, their tokens equal (a bf16
    difference only as a near-tie flip by the ROADMAP §3 rule); kernel 2
    on every DEC_XATTN phase 1 (24 x 2 x 2 x steps), nothing else."""
    t_phase = time.perf_counter()
    model = eval_model(dev, "whisper-medium")
    cfg = model["cfg"]
    toks, plens = _static_prompts(cfg, 8, WHISPER_PROMPT, 15, ragged=True)
    feats = _features(dev, cfg, 8, 16)
    recs, logs = _xattn_static(
        dev, model, out, phase="static_whisper", toks=toks, plens=plens,
        feats=feats, steps=WHISPER_STEPS,
        runs=(("fused", "fused", None), ("legacy", "legacy", None),
              ("profile_timing", "fused", {"profile_timing": True})))
    for name, r in recs.items():
        if r["paged_keys"] or r["allocators"]:
            raise AssertionError(f"static_whisper {name}: paged_kv paged a "
                                 f"DEC_XATTN slab: {r}")
    want, rows_w = logs["fused"]
    triage = {n: _triage(logs[n][0], want, logs[n][1], rows_w)
              for n in ("legacy", "profile_timing")}
    bad = {n: t["not_near_tie"] for n, t in triage.items()
           if t["not_near_tie"]}
    if bad:
        raise AssertionError(f"static_whisper: tokens part from the fused "
                             f"step's beyond a near-tie flip: {bad}")
    rec = {"phase": "static_whisper", "ok": True, "model": cfg.name,
           "layers": cfg.num_layers, "encoder_layers": cfg.encoder_layers,
           "frames": cfg.encoder_seq, "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads], "dtype": cfg.dtype,
           "weight_bytes": model["weight_bytes"],
           "step_bytes": _step_bytes(model), "init_s": model["init_s"],
           "batch": 8, "micro_batches": 2, "r_workers": 2,
           "cache_len": 1024, "paged_kv": "no-op (no page pool)",
           "prompt_tokens": plens.tolist(), "runs": recs,
           "tokens_equal": {n: t["requests_equal"] == t["requests"]
                            for n, t in triage.items()},
           "triage_vs_fused": triage,
           "kernel_launches": {n: r["kernel_launches"]
                               for n, r in recs.items()},
           "seconds": time.perf_counter() - t_phase}
    del model, feats
    _free_device()
    return rec


def _xattn_equiv_model(dev, arch: str, **cut):
    """``arch`` at full width cut by ``cut`` (layers), fp32 (TF32 off),
    seeded weights and seeded non-zero XATTN gates (their init is 0: the
    block would be the identity)."""
    import dataclasses
    import torch
    from repro_torch.core.config import get_arch
    from repro_torch.models.model import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = dataclasses.replace(get_arch(arch), dtype="float32", **cut)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(9),
                         device=dev)
    gen = torch.Generator(device=dev).manual_seed(10)
    for blk in list(params["stack"].values()) + params["rem"]:
        for k in ("gate_attn", "gate_ffn"):
            if k in blk:
                blk[k].copy_(0.3 + torch.rand(blk[k].shape, generator=gen,
                                              device=dev))
    return cfg, params


def _static_bitwise(name, got, want) -> dict:
    """Two static runs' tokens and every logits row, bit for bit."""
    import torch
    if got[0] != want[0] or any(not torch.equal(got[1][k], v)
                                for k, v in want[1].items()):
        raise AssertionError(f"equiv_xattn {name}: not bit for bit")
    return {"tokens_equal": True, "bitwise": True, "rows": len(want[1])}


def _colocated_halves(dev, cfg, params, toks, plens, feats, **kw):
    """The colocated engine run on each half of the batch apart (batch 2,
    the rows a hetero micro-batch holds): ({row: tokens}, {(row, step):
    logits row}) of the whole batch.  Against the batch-4 run it gives
    the reference's own fp32 spread under the hetero engine's row
    split (other matrix shapes, other summation orders)."""
    tokens, rows = {}, {}
    h = toks.shape[0] // 2
    for half in range(2):
        sl = slice(half * h, (half + 1) * h)
        _, t, r = _static_run(dev, cfg, params, toks[sl], plens[sl],
                              how="colocated", batch=h,
                              enc_feats=feats[sl], **kw)
        tokens.update({half * h + k: v for k, v in t.items()})
        rows.update({(half * h + a, i): v for (a, i), v in r.items()})
    return tokens, rows


def phase_equiv_xattn(dev) -> dict:
    """fp32, TF32 off, seeded non-zero gates, at full width:
    llama-3.2-vision-90b at 5 layers (one period: 4 ATTN, 1 XATTN) and
    whisper-medium at 2 decoder + 2 encoder layers, through the
    static-batch API (batch 4, ragged prompts of 17-200 tokens, 6
    steps): hetero paged (2 R-workers) == colocated; graphs == eager bit
    for bit; the legacy step == the fused step; paged == dense (whisper:
    bit for bit, paged_kv is a no-op; vision within tolerance); 1 R-worker
    == colocated; every hetero run's launches exact.  The tolerance is
    EQUIV_LOGIT_TOL over the colocated engine's own spread when its batch
    is split as the hetero engine's micro-batches (``_colocated_halves``;
    the rule of the kernel checks' fp64 comparison: atol + the
    reference's own distance): at width 8192 over 5 layers that spread
    alone is near 1e-4."""
    t_phase = time.perf_counter()
    cases = {}
    for arch, cut in (("llama-3.2-vision-90b", dict(num_layers=5)),
                      ("whisper-medium", dict(num_layers=2,
                                              encoder_layers=2))):
        t0 = time.perf_counter()
        cfg, params = _xattn_equiv_model(dev, arch, **cut)
        toks, plens = _static_prompts(cfg, 4, 200, 17, ragged=True)
        feats = _features(dev, cfg, 4, 18)
        kw = dict(steps=6, batch=4, cache_len=256, enc_feats=feats)
        halves = _colocated_halves(dev, cfg, params, toks, plens, feats,
                                   steps=6, cache_len=256)
        runs = {}
        for name, how, workers, paged, eager in (
                ("colocated", "colocated", 2, True, False),
                ("fused", "fused", 2, True, False),
                ("fused_eager", "fused", 2, True, True),
                ("legacy", "legacy", 2, True, False),
                ("dense", "fused", 2, False, False),
                ("one_worker", "fused", 1, True, False)):
            rec, tokens, rows = _static_run(
                dev, cfg, params, toks, plens, how=how, workers=workers,
                paged=paged, eager=eager,
                expect=None if how == "colocated" else _xattn_expect(
                    cfg, workers, kw["steps"], paged=paged), **kw)
            runs[name] = ((tokens, rows), rec)
        ref = runs["colocated"][0]
        spread, flips, ties, _ = _compare_rows(halves[0], ref[0], halves[1],
                                               ref[1], 1.0)
        if flips:
            raise AssertionError(f"equiv_xattn {arch}: the colocated engine "
                                 f"on the batch's halves parts from itself "
                                 f"beyond 1.0: {flips}")
        tol = EQUIV_LOGIT_TOL + spread
        res = {"layers": cfg.num_layers,
               "encoder_layers": cfg.encoder_layers,
               "pattern": list(cfg.pattern),
               "colocated_halves_spread": spread,
               "colocated_halves_near_tie_flips": ties,
               "logit_tol": tol,
               "max_abs_logit": max(float(v.abs().max())
                                    for v in ref[1].values()),
               "launches": {n: r[1]["kernel_launches"]
                            for n, r in runs.items() if n != "colocated"}}
        for name in ("fused", "legacy", "dense", "one_worker"):
            res[f"{name}_vs_colocated"] = _static_equal(
                f"equiv_xattn {arch} {name}", runs[name][0], ref, tol)
        res["graphs_vs_eager"] = _static_bitwise(
            f"{arch} graphs", runs["fused"][0], runs["fused_eager"][0])
        res["legacy_vs_fused"] = _static_equal(
            f"equiv_xattn {arch} legacy vs fused", runs["legacy"][0],
            runs["fused"][0], tol)
        if cfg.is_encdec:
            res["paged_vs_dense"] = _static_bitwise(
                f"{arch} paged (a no-op) vs dense", runs["fused"][0],
                runs["dense"][0])
        else:
            res["paged_vs_dense"] = _static_equal(
                f"equiv_xattn {arch} paged vs dense", runs["fused"][0],
                runs["dense"][0], tol)
        res["max_logit_diff"] = max(
            res[f"{n}_vs_colocated"]["max_logit_diff"]
            for n in ("fused", "legacy", "dense", "one_worker"))
        res["seconds"] = time.perf_counter() - t0
        cases[arch] = res
        print(f"equiv_xattn {arch}: max logit diff "
              f"{res['max_logit_diff']:.3g} against colocated (the "
              f"colocated engine's own spread {spread:.3g}, tol "
              f"{tol:.3g})", flush=True)
        del params, feats, runs
        _free_device()
    return {"phase": "equiv_xattn", "ok": True, "dtype": "float32",
            "tf32": False, "logit_atol": EQUIV_LOGIT_TOL, "cases": cases,
            "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# cross-attention rows through a live migration and a snapshot failover
# ---------------------------------------------------------------------------
FLEET_XATTN_STEPS = 16
FLEET_XATTN_MOVE = 4          # apply_partition before this step
FLEET_XATTN_RESTORE = 8       # snapshot, kill worker 0, restore: before it
FLEET_XATTN_SPLIT = [(0, 3), (3, 4)]


def _fleet_xattn_run(dev, cfg, params, toks, plens, feats, *, forced=None,
                     cache_len=1024):
    """One static run of ``cfg`` (batch 8, 2 micro-batches, 2 R-workers,
    paged_kv, ``cache_len``, FLEET_XATTN_STEPS fused steps).  Greedy
    when ``forced`` is None (the unmoved run); else teacher-forced on
    ``forced`` ({row: tokens}, the unmoved run's) with the move to
    FLEET_XATTN_SPLIT before step FLEET_XATTN_MOVE and, before step
    FLEET_XATTN_RESTORE, a KVSnapshotStore snapshot, ``kill()`` of worker 0
    and ``remove_worker(0, lost=payload())``.  Every count is set to 0
    just before the steps and read just after; kernel 2's count is also
    read at each event.  Returns (record, {row: tokens}, [step logits on
    the host], {event: [(rows, xk, xv) of one cross layer per worker]})."""
    import torch
    from repro_torch.core import graphs
    from repro_torch.core.hetero import HeteroPipelineEngine
    from repro_torch.fleet.recovery import KVSnapshotStore
    from repro_torch.kernels import decode_attention as DA
    batch, mb = 8, 4
    tt = torch.from_numpy(toks).to(dev)
    pp = torch.from_numpy(plens).to(dev)
    eng = HeteroPipelineEngine(params, cfg, batch=batch, cache_len=cache_len,
                               num_r_workers=2, num_microbatches=2,
                               paged_kv=True, device=dev)
    events, slabs, pending = {}, {}, []

    def cross_slabs():
        out = []
        for w in eng.workers:
            lk = min(k for k, st in w.state.items() if "xk" in st)
            out.append((w.hi - w.lo, w.state[lk]["xk"].clone(),
                        w.state[lk]["xv"].clone()))
        return out

    def event(name, fn):
        torch.cuda.synchronize()
        rc0 = eng.recapture_stats()
        rec = {"kernel2_before": DA.launches.value,
               "captures_before": graphs.captures.capture_count}
        t0 = time.perf_counter()
        extra = fn()
        rec.update(seconds=time.perf_counter() - t0, **extra,
                   migration=dict(eng.last_migration),
                   slices=[(w.lo, w.hi) for w in eng.workers],
                   recapture_before=rc0)
        events[name] = rec
        slabs[name] = cross_slabs()
        pending.append(name)

    def move():
        return {"moved_rows": eng.apply_partition(FLEET_XATTN_SPLIT)}

    def restore():
        t0 = time.perf_counter()
        store = KVSnapshotStore()
        store.snapshot(eng, FLEET_XATTN_RESTORE)
        snap_s = time.perf_counter() - t0
        dead = eng.workers[0]
        dead.kill()
        dead.join(timeout=30)
        t1 = time.perf_counter()
        eng.remove_worker(0, lost=store.payload())
        return {"snapshot_s": snap_s, "snapshot_bytes": store.nbytes(),
                "remove_worker_s": time.perf_counter() - t1}

    try:
        for m in range(2):
            eng.load_prefill(m, tt[m * mb:(m + 1) * mb],
                             pp[m * mb:(m + 1) * mb],
                             enc_feats=feats[m * mb:(m + 1) * mb])
        torch.cuda.synchronize()
        tok = tt[torch.arange(batch, device=dev), pp.long() - 1][:, None]
        counters = _counters()
        _reset_counters()
        graphs.captures.reset()
        tokens = {r: [] for r in range(batch)}
        logits_host, step_s = [], []
        for i in range(FLEET_XATTN_STEPS):
            if forced is not None and i == FLEET_XATTN_MOVE:
                event("move", move)
            if forced is not None and i == FLEET_XATTN_RESTORE:
                event("restore", restore)
            t0 = time.perf_counter()
            logits = torch.cat(eng.decode_step([tok[:mb], tok[mb:]]))
            nxt = logits.argmax(-1)[:, None].to(torch.int32)
            host = nxt[:, 0].cpu().tolist()
            step_s.append(time.perf_counter() - t0)
            logits_host.append(logits.float().cpu())
            for r in range(batch):
                tokens[r].append(host[r])
            if forced is None:
                tok = nxt
            else:
                tok = torch.tensor([[forced[r][i]] for r in range(batch)],
                                   dtype=torch.int32, device=dev)
            if pending:             # the first step after an event
                ev, rc = events[pending.pop()], eng.recapture_stats()
                ev["after_step"] = {
                    "captures": graphs.captures.capture_count
                    - ev.pop("captures_before"),
                    "recapture_count": rc["recapture_count"]
                    - ev["recapture_before"]["recapture_count"],
                    "recapture_s": rc["recapture_s"]
                    - ev.pop("recapture_before")["recapture_s"],
                    "step_s": step_s[-1]}
        torch.cuda.synchronize()
        launches = {n: c[0].value for n, c in counters.items()}
        plain = {n: c[1].value for n, c in counters.items()}
        for ev in events.values():
            ev["kernel2_after"] = launches["decode_attention"] \
                - ev.pop("kernel2_before")
        rec = {"launches": launches, "plain_calls": plain,
               "step_s": step_s, "step_s_p50": float(np.median(step_s)),
               "events": events,
               "workers_at_end": [(w.lo, w.hi) for w in eng.workers],
               "capture_count": graphs.captures.capture_count}
    finally:
        eng.close()
    if any(plain.values()):
        raise AssertionError(f"fleet_xattn: plain calls on the card {plain}")
    return rec, tokens, logits_host, slabs


def _fleet_xattn_expect(cfg, forced: bool) -> dict:
    """Kernel launches of a fleet_xattn run: every cross-attention R-Part
    through kernel 2 and every paged ATTN layer through kernel 1, per
    micro-batch and per worker holding rows (2, then 1 after the
    restore)."""
    n_cross = sum(k in ("xattn", "dec_xattn") for k in cfg.pattern)
    n_attn = cfg.pattern.count("attn")
    workers = [2 if not forced or i < FLEET_XATTN_RESTORE else 1
               for i in range(FLEET_XATTN_STEPS)]
    calls = 2 * sum(workers)
    out = {"decode_attention": n_cross * calls}
    if n_attn:
        out["paged_decode_attention"] = n_attn * calls
    after_move = 2 * sum(workers[FLEET_XATTN_MOVE:])
    after_restore = 2 * sum(workers[FLEET_XATTN_RESTORE:])
    return {"launches": out, "kernel2_after": {
        "move": n_cross * after_move, "restore": n_cross * after_restore}}


def _fleet_xattn_compare(got_logits, want_logits, want_tokens, lo, hi):
    """Teacher-forced logits of steps [lo, hi) against the unmoved run's:
    the max difference, and each (row, step) whose argmax differs from the
    unmoved token with its logit difference and the unmoved row's top-2
    margin (a near-tie flip by the ROADMAP §3 rule when the difference is
    within the largest one on agreeing rows)."""
    diff, flips, agree = 0.0, [], 0.0
    for i in range(lo, hi):
        d = (got_logits[i] - want_logits[i]).abs().amax(-1)
        diff = max(diff, float(d.max()))
        arg = got_logits[i].argmax(-1)
        for r in range(d.shape[0]):
            if int(arg[r]) != want_tokens[r][i]:
                top = want_logits[i][r].topk(2).values
                flips.append({"row": r, "step": i,
                              "logit_diff": float(d[r]),
                              "top2_margin": float(top[0] - top[1])})
            else:
                agree = max(agree, float(d[r]))
    for f in flips:
        f["near_tie"] = f["logit_diff"] <= agree
    return {"steps": [lo, hi], "max_logit_diff": diff,
            "tokens_equal": not flips, "flips": flips,
            "max_logit_diff_on_agreeing": agree}


def _fleet_xattn_kernel_checks(dev, cfg, slabs) -> list:
    """Kernel 2 on each worker's cross K/V slab after each event (3 and 1
    rows after the move, 4 after the restore): the wrapper against its
    plain version on a seeded bf16 query, repeated bitwise, with its
    split plan."""
    import torch
    from repro_torch.core import decompose as D
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(41)
    out = []
    for name, per_worker in slabs.items():
        for wi, (rows, k, v) in enumerate(per_worker):
            s = k.shape[1]
            q = torch.randn((rows, cfg.num_heads, cfg.head_dim),
                            generator=gen, device=dev).to(k.dtype)
            pos = D.cross_pos(rows, s, dev)
            lens = torch.full((rows,), 600, dtype=torch.int32, device=dev)
            got = DA.decode_attention(q, k, v, pos, lens)
            rec = _check_case(
                "decode_attention", f"{cfg.name}-{name}-w{wi}-B{rows}",
                "bfloat16", got, ref.decode_attention_ref(q, k, v, pos, lens),
                empty_row=[], again=DA.decode_attention(q, k, v, pos, lens),
                plan=DA.kernel_plan(q, k))
            rec.update(event=name, worker=wi, B=rows, S=s)
            out.append(rec)
    return out


def _fleet_xattn_case(dev, arch, cfg, params, toks, plens, feats,
                      cache_len=1024):
    """fleet_xattn's two runs of one model and their checks: launches
    exact in both (kernel 2 also after each event), the survivor holding
    every row, graphs captured again after each event, and every greedy
    flip against the unmoved run a near tie.  Returns (unmoved record,
    moved record, comparisons, the workers' cross slabs at each event)."""
    base, base_tokens, base_logits, _ = _fleet_xattn_run(
        dev, cfg, params, toks, plens, feats, cache_len=cache_len)
    moved, moved_tokens, moved_logits, slabs = _fleet_xattn_run(
        dev, cfg, params, toks, plens, feats, forced=base_tokens,
        cache_len=cache_len)
    for name, r, forced in (("unmoved", base, False),
                            ("moved", moved, True)):
        want = _fleet_xattn_expect(cfg, forced)
        got = {n: v for n, v in r["launches"].items() if v}
        if got != want["launches"]:
            raise AssertionError(f"fleet_xattn {arch} {name}: launches "
                                 f"{got}, expected {want['launches']}")
    want = _fleet_xattn_expect(cfg, True)["kernel2_after"]
    got = {n: e["kernel2_after"] for n, e in moved["events"].items()}
    if got != want:
        raise AssertionError(f"fleet_xattn {arch}: kernel 2 launches "
                             f"after the events {got}, expected {want}")
    if moved["workers_at_end"] != [(0, 4)]:
        raise AssertionError(f"fleet_xattn {arch}: survivor holds "
                             f"{moved['workers_at_end']}")
    for name, e in moved["events"].items():
        if e["after_step"]["recapture_count"] <= 0:
            raise AssertionError(f"fleet_xattn {arch}: no graph captured "
                                 f"again after the {name}: {e}")
    cmp = {"before": _fleet_xattn_compare(
               moved_logits, base_logits, base_tokens, 0,
               FLEET_XATTN_MOVE),
           "moved": _fleet_xattn_compare(
               moved_logits, base_logits, base_tokens, FLEET_XATTN_MOVE,
               FLEET_XATTN_RESTORE),
           "restored": _fleet_xattn_compare(
               moved_logits, base_logits, base_tokens,
               FLEET_XATTN_RESTORE, FLEET_XATTN_STEPS)}
    bad = [f for c in cmp.values() for f in c["flips"]
           if not f["near_tie"]]
    if bad:
        raise AssertionError(f"fleet_xattn {arch}: greedy tokens part "
                             f"beyond a near-tie flip: {bad}")
    return base, moved, cmp, slabs


def phase_fleet_xattn(dev) -> dict:
    """Cross-attention rows through a live migration and a snapshot
    failover at the widths of static_vision (llama-3.2-vision-90b, 10 of
    100 layers) and static_whisper (whisper-medium, full), bf16, with
    their prompts and features: an unmoved greedy run of
    FLEET_XATTN_STEPS, then a run teacher-forced on its tokens that moves
    to FLEET_XATTN_SPLIT (3 + 1 rows per micro-batch) before step
    FLEET_XATTN_MOVE and, before FLEET_XATTN_RESTORE, snapshots, kills
    worker 0 and restores its rows onto the survivor (4 rows).  Per
    event: wire bytes and seconds, snapshot bytes and seconds, graphs
    captured again in the step after, kernel 2's launches after it; the
    moved and restored steps' logit difference against the unmoved run
    and whether the greedy tokens are equal (a flip must be a near tie);
    every launch exact; kernel 2 on the workers' slabs after each event
    against its plain version.  Then the same two runs in fp32 (TF32 off,
    seeded non-zero gates) at equiv_xattn's cut (vision 5 layers, whisper
    2 + 2), cache_len 256, prompts of 17-200 tokens: the difference there.
    Each model is freed after."""
    t_phase = time.perf_counter()
    cases = {}
    for arch, layers, p_len, seed, cut in (
            ("llama-3.2-vision-90b", VISION_LAYERS, 600, 13,
             dict(num_layers=5)),
            ("whisper-medium", None, WHISPER_PROMPT, 15,
             dict(num_layers=2, encoder_layers=2))):
        t0 = time.perf_counter()
        model = eval_model(dev, arch, layers=layers)
        cfg, params = model["cfg"], model["params"]
        full_layers = model["full_layers"]
        toks, plens = _static_prompts(cfg, 8, p_len, seed, ragged=True)
        feats = _features(dev, cfg, 8, seed + 1)
        base, moved, cmp, slabs = _fleet_xattn_case(
            dev, arch, cfg, params, toks, plens, feats)
        checks = _fleet_xattn_kernel_checks(dev, cfg, slabs)
        del model, params, feats, slabs
        _free_device()
        # the same moves in fp32 (TF32 off) at equiv_xattn's cut: what the
        # bf16 difference is made of (the split plans change with the rows
        # a worker holds, and so does the order of each row's fp32 sums)
        cfg32, params32 = _xattn_equiv_model(dev, arch, **cut)
        toks32, plens32 = _static_prompts(cfg32, 8, 200, 17, ragged=True)
        feats32 = _features(dev, cfg32, 8, 18)
        _, _, cmp32, _ = _fleet_xattn_case(
            dev, arch, cfg32, params32, toks32, plens32, feats32,
            cache_len=256)
        del params32, feats32
        _free_device()
        fp32 = {"layers": cfg32.num_layers,
                "encoder_layers": cfg32.encoder_layers, "cache_len": 256,
                "prompt_tokens": plens32.tolist(), "vs_unmoved": cmp32,
                "max_logit_diff": max(c["max_logit_diff"]
                                      for c in cmp32.values()),
                "tokens_equal": all(c["tokens_equal"]
                                    for c in cmp32.values())}
        cases[arch] = {
            "layers": cfg.num_layers, "full_layers": full_layers,
            "pattern": list(cfg.pattern), "dtype": cfg.dtype,
            "encoder_seq": cfg.encoder_seq,
            "heads": [cfg.num_heads, cfg.num_kv_heads],
            "prompt_tokens": plens.tolist(), "unmoved": base,
            "moved": moved, "vs_unmoved": cmp,
            "kernel2_checks": checks, "fp32": fp32,
            "seconds": time.perf_counter() - t0}
        print(f"fleet_xattn {arch}: moved max logit diff "
              f"{cmp['moved']['max_logit_diff']:.4g} (tokens equal "
              f"{cmp['moved']['tokens_equal']}), restored "
              f"{cmp['restored']['max_logit_diff']:.4g} (tokens equal "
              f"{cmp['restored']['tokens_equal']}); move "
              f"{moved['events']['move']['migration']['wire_bytes']} B in "
              f"{moved['events']['move']['seconds']:.3f} s, restore "
              f"{moved['events']['restore']['migration']['wire_bytes']} B "
              f"in {moved['events']['restore']['seconds']:.3f} s; fp32 max "
              f"logit diff {fp32['max_logit_diff']:.3g} (tokens equal "
              f"{fp32['tokens_equal']})", flush=True)
    return {"phase": "fleet_xattn", "ok": True, "batch": 8,
            "micro_batches": 2, "r_workers": 2, "paged_kv": True,
            "cache_len": 1024, "steps": FLEET_XATTN_STEPS,
            "move_before_step": FLEET_XATTN_MOVE,
            "restore_before_step": FLEET_XATTN_RESTORE,
            "split": FLEET_XATTN_SPLIT, "cases": cases,
            "kernel_launches": {a: c["moved"]["launches"]
                                for a, c in cases.items()},
            "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# the single-sequence PagedKV API (serving/paged_cache.py's first layer)
# ---------------------------------------------------------------------------
PKV_HEADS = dict(hq=32, hkv=8, dh=128)     # Qwen3-8B's
PKV_PAGE, PKV_PAGES, PKV_MAX_PAGES = 16, 256, 64
PKV_PROMPTS = [517, 33, 900, 16]
PKV_STEPS = 6


def phase_paged_kv_api(dev) -> dict:
    """The single-sequence ``PagedKV`` API at Qwen3-8B's heads (Hq 32, Hkv
    8, Dh 128), page 16, bf16, 4 rows: the same op sequence on the card
    and on the CPU (init_paged, ensure_capacity, write_prefill per row,
    PKV_STEPS r_attention_paged steps, then release_row of row 1, a
    longer prompt on its reused pages, PKV_STEPS more): after every op
    the tables, free list, lengths and page_pos equal the CPU run's, the
    pools bit for bit, the op left its argument's tensors unchanged, and
    r_attention_paged (plain torch, as the reference attends) is within
    the bf16 tolerance of the CPU.  On the rows written contiguously from
    0 (before the release), the pool and tables also go through kernel 1
    (``ops.paged_decode_attention``, positions derived from the slot
    index), which must agree with the stored-position attention; both
    timed with CUDA events."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import paged_cache as PC
    t_phase = time.perf_counter()
    rng = np.random.default_rng(31)
    hq, hkv, dh = PKV_HEADS["hq"], PKV_HEADS["hkv"], PKV_HEADS["dh"]
    b = len(PKV_PROMPTS)
    bf = torch.bfloat16

    def data(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(bf)

    kv = {d: PC.init_paged(b, PKV_PAGES, PKV_PAGE, hkv, dh, PKV_MAX_PAGES,
                           dtype=bf, device=d) for d in (dev, "cpu")}
    ops_run, attn = [], []

    def check(name):
        g, c = kv[dev], kv["cpu"]
        if g.free != c.free:
            raise AssertionError(f"paged_kv_api {name}: free lists differ")
        for f in ("tables", "lengths", "page_pos", "pages_k", "pages_v"):
            if not torch.equal(getattr(g, f).cpu(), getattr(c, f)):
                raise AssertionError(f"paged_kv_api {name}: {f} differs")

    def op(name, *args):
        for d in (dev, "cpu"):
            old = kv[d]
            before = {k: v.clone() for k, v in vars(old).items()
                      if torch.is_tensor(v)}
            args_d = [a.to(d) if torch.is_tensor(a) else a for a in args]
            kv[d] = getattr(PC, name)(old, *args_d)
            if any(not torch.equal(getattr(old, k), v)
                   for k, v in before.items()):
                raise AssertionError(f"paged_kv_api {name}: changed its "
                                     f"argument in place on {d}")
        check(name)
        ops_run.append(name)

    def step(tag):
        lengths = kv["cpu"].lengths.clone()
        for row in range(b):
            op("ensure_capacity", row, int(lengths[row]) + 1)
        r_in = {"q": data(b, 1, hq, dh), "k": data(b, 1, hkv, dh),
                "v": data(b, 1, hkv, dh), "lengths": lengths}
        outs = {}
        for d in (dev, "cpu"):
            outs[d], kv[d] = PC.r_attention_paged(
                {k: v.to(d) for k, v in r_in.items()}, kv[d])
        check("r_attention_paged")
        err, ok = tol_check(outs[dev]["o"].cpu(), outs["cpu"]["o"],
                            "bfloat16")
        if not ok:
            raise AssertionError(f"paged_kv_api {tag}: r_attention_paged on "
                                 f"the card parts from the CPU by {err}")
        attn.append({"tag": tag, "max_abs_err_vs_cpu": err})
        return r_in, outs[dev]["o"]

    for row, n in enumerate(PKV_PROMPTS):
        op("ensure_capacity", row, n)
        op("write_prefill", row, data(n, hkv, dh), data(n, hkv, dh))
    for _ in range(PKV_STEPS):
        r_in, o = step("contiguous")
    # kernel 1 over the same pool and tables: on rows written from 0 the
    # slot index gives the stored positions
    g = kv[dev]
    q = r_in["q"][:, 0].to(dev)
    qlen = r_in["lengths"].to(dev)
    _reset_counters()
    from repro_torch.kernels import paged_attention as PA
    k1 = ops.paged_decode_attention(q, g.pages_k, g.pages_v, g.tables, qlen)
    k1_launches = PA.launches.value
    err_k1, ok = tol_check(k1, o[:, 0], "bfloat16")
    if not ok or k1_launches != 1:
        raise AssertionError(f"paged_kv_api: kernel 1 on the API's pool "
                             f"parts from r_attention_paged by {err_k1} "
                             f"(launches {k1_launches})")
    r_dev = {k: v.to(dev) for k, v in r_in.items()}
    ms_api = cuda_time_ms(lambda i: PC.r_attention_paged(r_dev, g), 10)
    ms_k1 = cuda_time_ms(lambda i: ops.paged_decode_attention(
        q, g.pages_k, g.pages_v, g.tables, qlen), 50)
    # the stored positions of these rows are the slot index's
    _, _, stored = PC.gather_views(kv["cpu"])
    slot = torch.arange(stored.shape[1], dtype=torch.int32)[None, :]
    derived = torch.where(slot < kv["cpu"].lengths[:, None], slot, -1)
    if not torch.equal(stored, derived):
        raise AssertionError("paged_kv_api: rows written from 0 store other "
                             "positions than their slot index")
    # release and regrow: row 1's new pages come back from the free list's
    # end, its stored positions no longer follow the table's page order
    op("release_row", 1)
    op("ensure_capacity", 1, 300)
    op("write_prefill", 1, data(300, hkv, dh), data(300, hkv, dh))
    for _ in range(PKV_STEPS):
        step("after_release")
    util = {d: PC.pool_utilization(kv[d]) for d in (dev, "cpu")}
    if util[dev] != util["cpu"]:
        raise AssertionError(f"paged_kv_api: pool utilization {util}")
    return {"phase": "paged_kv_api", "ok": True, **PKV_HEADS,
            "page": PKV_PAGE, "num_pages": PKV_PAGES,
            "max_pages_per_seq": PKV_MAX_PAGES, "dtype": "bfloat16",
            "prompts": PKV_PROMPTS, "steps": 2 * PKV_STEPS,
            "ops": len(ops_run), "attention": attn,
            "max_abs_err_vs_cpu": max(a["max_abs_err_vs_cpu"] for a in attn),
            "contiguous_rows_positions_derived": True,
            "kernel1_vs_api": {"max_abs_err": err_k1,
                               "launches": k1_launches,
                               "api_ms": ms_api, "kernel1_ms": ms_k1},
            "pool_utilization": util[dev],
            "free_pages": len(kv[dev].free),
            "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# the examples (repro_torch.examples), as a user runs them
# ---------------------------------------------------------------------------
def phase_examples(dev) -> dict:
    """``repro_torch.examples``' three modules on the card, each through
    its ``main`` with no --device (the card is the default):
    ``quickstart`` (its own hetero == colocated assertion), then
    ``serve_continuous`` (48 requests of 24 new tokens, loadctl, prefill
    chunks of 8) and ``train_small --quick`` (60 steps).  Every count is
    set to 0 just before each and read just after, and stays 0: the
    examples keep the reference's dense fp storage, whose R-Part attends
    in plain torch (``repro``'s in jnp), and the train path runs no
    kernel."""
    import io
    import torch
    from repro_torch.examples import quickstart, serve_continuous, train_small
    t_phase = time.perf_counter()
    recs = {}
    for name, fn in (("quickstart", lambda: quickstart.main([])),
                     ("serve_continuous", lambda: serve_continuous.main([])),
                     ("train_small", lambda: train_small.main(["--quick"]))):
        counters = _counters()
        _reset_counters()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {n: c[0].value for n, c in counters.items()}
        plain = {n: c[1].value for n, c in counters.items()}
        printed = buf.getvalue().splitlines()
        if any(plain.values()):
            raise AssertionError(f"examples {name}: plain calls {plain}")
        rec = {"seconds": seconds, "launches": launches,
               "printed_tail": printed[-8:]}
        if any(launches.values()):
            raise AssertionError(f"examples {name}: a kernel counter moved "
                                 f"on dense fp storage: {rec}")
        if name == "quickstart":
            if not printed[-1].startswith("OK"):
                raise AssertionError(f"examples quickstart: {rec}")
            rec["tokens"] = out["fastdecode"].tolist()
            rec["hetero_equals_colocated"] = True
        elif name == "serve_continuous":
            done, records = out
            n_tok = sum(len(r.generated) for r in done)
            if len(done) != 48 or n_tok != 48 * 24:
                raise AssertionError(f"examples serve_continuous: {len(done)}"
                                     f" requests, {n_tok} tokens, {rec}")
            rec.update(requests=len(done), tokens=n_tok,
                       steps=len(records),
                       tokens_per_s_host=n_tok / seconds,
                       resident_len_max=max(r.resident_len for r in records))
        else:
            losses = out["losses"]
            if len(losses) != 60 or not all(np.isfinite(losses)):
                raise AssertionError(f"examples train_small: {rec}, "
                                     f"losses {losses}")
            rec.update(argv=out["argv"], first_loss=losses[0],
                       last_loss=losses[-1])
        print(f"examples {name}: {seconds:.2f} s, launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        recs[name] = rec
        del out
        _free_device()
    return {"phase": "examples", "ok": True, "runs": recs,
            "kernel_launches": {n: r["launches"] for n, r in recs.items()},
            "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# training: train_forward with autograd's backward, AdamW, remat
# ---------------------------------------------------------------------------
TRAIN_LAYERS = 4        # Qwen3-8B's depth in the train phase (of 36)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 8
TRAIN_LR = dict(peak_lr=3e-4, warmup=2, total_steps=8)
# remat's later losses against no remat's: bf16 weights, and the
# embedding's backward accumulates with atomics on CUDA, so grads (and
# with them the updated params) are not bitwise repeatable
TRAIN_LOSS_RTOL = 2.0 ** -7
TRAIN_LAUNCHER = ["--arch", "qwen3-8b", "--reduced", "--layers", "2",
                  "--d-model", "256", "--steps", "20"]


def train_flops(cfg, batch: int, seq: int) -> dict:
    """Model flops of one train step: 6 x the matmul params (the
    projections, the FFN and the lm head; not the embedding gather) x
    tokens, plus causal attention (QK^T and PV over S^2 / 2 pairs, x 3
    for the forward and the backward)."""
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    per_layer = (d * hq * hd + 2 * d * hkv * hd + hq * hd * d
                 + 3 * d * cfg.d_ff)
    matmul = cfg.num_layers * per_layer + d * cfg.vocab_size
    tokens = batch * seq
    attn = cfg.num_layers * 3 * 2 * 2 * batch * hq * hd * seq * seq / 2
    return {"matmul_params": matmul, "tokens": tokens,
            "flops": 6 * matmul * tokens + attn, "attention_flops": attn}


class _OptEvents:
    """Puts CUDA events around the AdamW update of every train step made
    by ``make_train_step`` while active (it builds its update through
    ``training.train.adamw``): the optimizer's device time apart from the
    forward and backward's, with no sync added."""

    def __enter__(self):
        import torch
        from repro_torch.training import train as TT
        self.marks, self._own = [], TT.adamw

        def adamw(*a, **kw):
            init, update = self._own(*a, **kw)

            def timed(grads, state, params):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = update(grads, state, params)
                e1.record()
                self.marks.append((e0, e1))
                return out
            return init, timed
        TT.adamw = adamw
        return self

    def __exit__(self, *exc):
        from repro_torch.training import train as TT
        TT.adamw = self._own


def _train_run(dev, cfg, batches, *, remat: bool) -> dict:
    """``TRAIN_STEPS`` steps of ``make_train_step`` from seeded weights
    (the same seed for every run) on ``batches``: per step the host wall
    (to the step's end, synced), the forward + backward's and the
    update's device time (CUDA events), loss and grad norm; peak device
    memory over the run."""
    import torch
    from repro_torch.models.model import init_params
    from repro_torch.training.train import make_train_step
    from repro_torch.training.tree import leaves
    _free_device()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    with _OptEvents() as ev:
        init_state, train_step = make_train_step(
            cfg, remat=remat, q_chunk=min(1024, TRAIN_SEQ),
            kv_chunk=min(1024, TRAIN_SEQ), **TRAIN_LR)
    state = init_state(params)
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated()
    steps = []
    for b in batches:
        start = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, m = train_step(state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        e0, e1 = ev.marks[-1]
        steps.append({"wall_s": wall,
                      "fwd_bwd_ms": start.elapsed_time(e0),
                      "opt_ms": e0.elapsed_time(e1),
                      "loss": float(m["loss"]), "ce": float(m["ce"]),
                      "grad_norm": float(m["grad_norm"])})
    if len(ev.marks) != len(batches):
        raise AssertionError(f"train: {len(ev.marks)} timed updates for "
                             f"{len(batches)} steps")
    rec = {"remat": remat, "steps": steps,
           "params": sum(t.numel() for t in leaves(params)),
           "state_bytes": state_bytes,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "max_memory_reserved": torch.cuda.max_memory_reserved()}
    del params, state, m
    _free_device()
    return rec


def _train_summary(rec, flops) -> dict:
    later = rec["steps"][1:]
    walls = [s["wall_s"] for s in later]
    p50 = float(np.median(walls))
    bound_s = flops["flops"] / PEAK_FLOPS["bfloat16"]
    out = {"remat": rec["remat"], "params": rec["params"],
           "first_step_s": rec["steps"][0]["wall_s"],
           "step_p50_s": p50,
           "fwd_bwd_p50_ms": float(np.median([s["fwd_bwd_ms"]
                                              for s in later])),
           "opt_p50_ms": float(np.median([s["opt_ms"] for s in later])),
           "tokens_per_s_after_first": flops["tokens"] * len(later)
           / sum(walls),
           "model_flops_bound_ms": bound_s * 1e3,
           "model_flops_share": bound_s / p50,
           "state_bytes": rec["state_bytes"],
           "max_memory_allocated": rec["max_memory_allocated"],
           "max_memory_reserved": rec["max_memory_reserved"],
           "losses": [s["loss"] for s in rec["steps"]],
           "grad_norms": [s["grad_norm"] for s in rec["steps"]]}
    return out


def _train_launcher_run() -> dict:
    """``python -m repro_torch.launch.train`` with no ``--device`` (the
    card is the default), as a user starts it."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
                       + TRAIN_LAUNCHER, capture_output=True, text=True,
                       timeout=300, env=env, cwd=str(ROOT))
    lines = p.stdout.splitlines()
    if p.returncode != 0:
        raise AssertionError(f"train launcher failed ({p.returncode}): "
                             f"{p.stdout[-2000:]}{p.stderr[-2000:]}")
    steps = [ln for ln in lines if ln.startswith("step")]
    losses = [float(ln.split()[3]) for ln in steps]
    if [int(ln.split()[1]) for ln in steps] != [0, 10, 19] \
            or not all(np.isfinite(losses)):
        raise AssertionError(f"train launcher: unexpected output {lines}")
    return {"args": TRAIN_LAUNCHER, "lines": lines,
            "seconds": time.perf_counter() - t0}


def phase_train(dev) -> dict:
    """Qwen3-8B at full width cut to TRAIN_LAYERS of 36, bf16, seeded
    weights: TRAIN_STEPS steps of batch 4 x seq 1024 from SyntheticLM
    (seed 0, drawn before the timed window), without and then with remat
    from the same weights; the first remat loss must equal no remat's
    bit for bit and the later ones agree within TRAIN_LOSS_RTOL.  No
    kernel of the port runs (the train path attends in plain torch):
    every counter, launches and plain calls, stays 0.  Then the train
    launcher as a subprocess with no --device."""
    import dataclasses
    import torch
    from repro_torch.core.config import get_arch
    from repro_torch.training.data import DataConfig, SyntheticLM
    t_phase = time.perf_counter()
    # what earlier phases still hold stays out of this phase's peaks
    _free_device()
    torch.cuda.reset_peak_memory_stats()
    allocated_at_start = torch.cuda.memory_allocated()
    full = get_arch("qwen3-8b")
    cfg = dataclasses.replace(full, num_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                  seed=0)).batches()
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
               for _ in range(TRAIN_STEPS)]
    data_s = time.perf_counter() - t0
    _reset_counters()
    runs = [_train_run(dev, cfg, batches, remat=r) for r in (False, True)]
    counts = {name: (launched.value, plain.value)
              for name, (launched, plain) in _counters().items()}
    if any(a or b for a, b in counts.values()):
        raise AssertionError(f"train: a kernel counter moved: {counts}")
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    summary = [_train_summary(r, flops) for r in runs]
    for s_ in summary:
        s_["max_memory_allocated_over_start"] = (
            s_["max_memory_allocated"] - allocated_at_start)
    plain, remat = summary
    for s in summary:
        if not all(np.isfinite(s["losses"] + s["grad_norms"])):
            raise AssertionError(f"train: non-finite loss or grad norm {s}")
    if remat["losses"][0] != plain["losses"][0]:
        raise AssertionError(f"train: remat's first loss "
                             f"{remat['losses'][0]!r} != "
                             f"{plain['losses'][0]!r}")
    worst = max(abs(a - b) / abs(b)
                for a, b in zip(remat["losses"], plain["losses"]))
    if worst > TRAIN_LOSS_RTOL:
        raise AssertionError(f"train: remat's losses part from no remat's "
                             f"by {worst:.3g} (relative)")
    launcher = _train_launcher_run()
    for s in summary:
        print(f"train remat={s['remat']}: step p50 {s['step_p50_s']:.4f} s "
              f"(fwd+bwd {s['fwd_bwd_p50_ms']:.1f} ms, opt "
              f"{s['opt_p50_ms']:.1f} ms), "
              f"{s['tokens_per_s_after_first']:,.0f} tokens/s, model-flops "
              f"share {s['model_flops_share']:.3f}, peak "
              f"{s['max_memory_allocated'] / 2**30:.1f} GiB ("
              f"{allocated_at_start / 2**30:.2f} GiB held at the phase's "
              f"start)", flush=True)
    return {"phase": "train", "ok": True, "arch": full.name,
            "layers": TRAIN_LAYERS, "full_layers": full.num_layers,
            "dtype": cfg.dtype, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "steps": TRAIN_STEPS, "schedule": TRAIN_LR,
            "params": plain["params"], "data_s": data_s, **flops,
            "runs": summary, "remat_max_rel_loss_diff": worst,
            "kernel_launches": {k: v[0] for k, v in counts.items()},
            "plain_calls": {k: v[1] for k, v in counts.items()},
            "launcher": launcher, "card": gpu_name_and_limit(),
            "allocated_at_start": allocated_at_start,
            "seconds": time.perf_counter() - t_phase}


EQUIV_TRAIN_ARCHS = {"qwen3-8b": 3, "grok-1-314b": 3,
                     "recurrentgemma-2b": 3, "mamba2-2.7b": 3,
                     "llama-3.2-vision-90b": 10, "whisper-medium": 3}
EQUIV_TRAIN_LOSS_RTOL = 1e-5
EQUIV_TRAIN_GRAD_TOL = (1e-4, 1e-5)      # rtol, atol
EQUIV_TRAIN_STEP_RTOL = 1e-4
# the drift reported beside the three steps: the train phase's schedule
DRIFT_LR, DRIFT_STEPS = dict(peak_lr=3e-4, warmup=2, total_steps=8), 8


def _train_equiv_case(arch: str):
    """``arch`` at reduced() size (d_model 256, vocab 512), fp32, seeded
    weights on the CPU with seeded non-zero XATTN gates and norm scales
    (both init to 0), a masked batch of 2 x 32 and seeded features."""
    import dataclasses
    import torch
    from repro_torch.core.config import get_arch
    from repro_torch.models.model import early_fusion, init_params
    from repro_torch.training.tree import leaves_with_path
    cfg = get_arch(arch).reduced(layers=EQUIV_TRAIN_ARCHS[arch])
    if cfg.ffn_kind == "moe":
        cfg = dataclasses.replace(cfg, moe_capacity=1.25)
    gen = torch.Generator().manual_seed(25)
    params = init_params(cfg, gen, "cpu")
    for path, t in leaves_with_path(params):
        if path[-1] in ("gate_attn", "gate_ffn"):
            t.copy_(0.3 + torch.rand(t.shape, generator=gen))
        elif path[-1].startswith("ln") or path[-1].endswith("norm"):
            t.add_(0.1 * torch.randn(t.shape, generator=gen))
    b, s = 2, 32
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, dtype=torch.int32),
             "targets": torch.randint(0, cfg.vocab_size, (b, s),
                                      generator=gen, dtype=torch.int32),
             "mask": (torch.rand((b, s), generator=gen) > 0.2).float()}
    if cfg.frontend != "none":
        n = s // 2 if early_fusion(cfg) else cfg.encoder_seq
        batch["enc_feats"] = torch.randn((b, n, cfg.encoder_d_model),
                                         generator=gen)
    return cfg, params, batch


def _to(tree, dev):
    from repro_torch.training.tree import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def phase_equiv_train(dev) -> dict:
    """fp32 (TF32 off) at reduced() sizes, for one arch of each block
    kind and FFN (grok-1 at capacity 1.25 with its aux loss on; vision at
    10 layers with seeded gates): the port's loss and grads on the card
    == on the CPU (loss within EQUIV_TRAIN_LOSS_RTOL, every grad leaf
    within EQUIV_TRAIN_GRAD_TOL), remat == no remat on the card (loss
    bit for bit, grads within tolerance), and three make_train_step
    steps on the card == on the CPU from one state (losses and grad
    norms within EQUIV_TRAIN_STEP_RTOL); beside them, reported only, the
    card-vs-CPU relative drift of each of DRIFT_STEPS steps at the train
    phase's schedule (lr 3e-4)."""
    import torch
    from repro_torch.training.train import loss_and_grads, make_train_step
    from repro_torch.training.tree import leaves_with_path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t_phase = time.perf_counter()
    rtol, atol = EQUIV_TRAIN_GRAD_TOL
    cases = {}
    for arch in EQUIV_TRAIN_ARCHS:
        t0 = time.perf_counter()
        cfg, params, batch = _train_equiv_case(arch)
        kw = dict(q_chunk=16, kv_chunk=16)
        dparams, dbatch = _to(params, dev), _to(batch, dev)
        (lc, mc), gc_ = loss_and_grads(params, cfg, batch, **kw)
        (ld, md), gd = loss_and_grads(dparams, cfg, dbatch, **kw)
        (lr, _), gr = loss_and_grads(dparams, cfg, dbatch, remat=True, **kw)
        if float(lr) != float(ld):
            raise AssertionError(f"equiv_train {arch}: remat loss "
                                 f"{float(lr)!r} != {float(ld)!r}")
        rel = abs(float(ld) - float(lc)) / abs(float(lc))
        if rel > EQUIV_TRAIN_LOSS_RTOL:
            raise AssertionError(f"equiv_train {arch}: card loss "
                                 f"{float(ld)!r} vs CPU {float(lc)!r}")
        worst = {"card_vs_cpu": 0.0, "remat_vs_plain": 0.0}
        cpu = dict(leaves_with_path(gc_))
        plain = dict(leaves_with_path(gd))
        for name, got, want in (
                ("card_vs_cpu", plain, cpu),
                ("remat_vs_plain", dict(leaves_with_path(gr)), plain)):
            for path, w in want.items():
                g = got[path].float().cpu()
                w = w.float().cpu()
                err = (g - w).abs()
                if not bool((err <= atol + rtol * w.abs()).all()):
                    raise AssertionError(
                        f"equiv_train {arch} {name}: grad {path} off by "
                        f"{float(err.max()):.3g}")
                worst[name] = max(worst[name], float(err.max()))
        # three steps from one state on each side
        traj = {}
        for where, p, bt in (("cpu", params, batch),
                             ("card", dparams, dbatch)):
            init, step = make_train_step(cfg, peak_lr=1e-2, warmup=2,
                                         total_steps=6, **kw)
            st = init(_clone(p))
            out = []
            for _ in range(3):
                st, m = step(st, bt)
                out.append((float(m["loss"]), float(m["grad_norm"])))
            traj[where] = out
        step_rel = max(abs(a - b) / abs(b)
                       for x, y in zip(traj["card"], traj["cpu"])
                       for a, b in zip(x, y))
        if step_rel > EQUIV_TRAIN_STEP_RTOL:
            raise AssertionError(f"equiv_train {arch}: three steps part "
                                 f"by {step_rel:.3g}: {traj}")
        # the drift at the train phase's rate over its 8 steps, reported
        # only (no gate): card against CPU, relative, step by step
        drift = {}
        for where, p, bt in (("cpu", params, batch),
                             ("card", dparams, dbatch)):
            init, step = make_train_step(cfg, **DRIFT_LR, **kw)
            st = init(_clone(p))
            out = []
            for _ in range(DRIFT_STEPS):
                st, m = step(st, bt)
                out.append((float(m["loss"]), float(m["grad_norm"])))
            drift[where] = out
        drift_rel = [max(abs(a - b) / abs(b) for a, b in zip(x, y))
                     for x, y in zip(drift["card"], drift["cpu"])]
        cases[arch] = {"layers": cfg.num_layers, "d_model": cfg.d_model,
                       "loss": float(ld), "aux": float(md["aux"]),
                       "loss_rel_card_vs_cpu": rel,
                       "grad_max_abs": worst, "steps": traj,
                       "steps_max_rel": step_rel,
                       "drift_lr3e-4_rel_by_step": drift_rel,
                       "seconds": time.perf_counter() - t0}
        print(f"equiv_train {arch}: loss rel {rel:.3g}, grads "
              f"{worst['card_vs_cpu']:.3g} (card vs CPU), "
              f"{worst['remat_vs_plain']:.3g} (remat), steps "
              f"{step_rel:.3g}, 8 steps at 3e-4 {max(drift_rel):.3g}",
              flush=True)
    _free_device()
    return {"phase": "equiv_train", "ok": True, "dtype": "float32",
            "tf32": False, "loss_rtol": EQUIV_TRAIN_LOSS_RTOL,
            "grad_tol": EQUIV_TRAIN_GRAD_TOL,
            "step_rtol": EQUIV_TRAIN_STEP_RTOL, "cases": cases,
            "seconds": time.perf_counter() - t_phase}


def _clone(tree):
    from repro_torch.training.tree import tree_map
    return tree_map(lambda t: t.clone(), tree)


# ---------------------------------------------------------------------------
# the distributed layer: logical-axis rules on a DeviceMesh of the card
# ---------------------------------------------------------------------------
DIST_LAYERS = 4           # Qwen3-8B's depth in the dist phase (of 36)
DIST_ROWS, DIST_PROMPT, DIST_CACHE, DIST_STEPS = 8, 512, 1024, 16
DIST_STRATEGIES = ("fastdecode", "fastdecode_sm", "baseline")
DIST_EXACT_RTOL = 1e-5    # a mesh decode against the plain one (fp32)
DIST_SM_TOL = 2e-4        # fastdecode_sm against fastdecode (the reference's)
DIST_EXACT_LAYERS, DIST_EXACT_ROWS, DIST_EXACT_PROMPT = 2, 4, 128
DIST_EXACT_CACHE, DIST_EXACT_STEPS = 256, 4


@contextlib.contextmanager
def _dist_world(dev):
    """A world of 1 over NCCL on ``dev`` (a FileStore under build/, no
    network port) and its (1, 1) ('data', 'model') DeviceMesh; destroyed
    on exit.  A missing NCCL or a failed init raises."""
    import os
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    store_dir = ROOT / "build" / "dist_store"
    store_dir.mkdir(parents=True, exist_ok=True)
    path = store_dir / f"store_{os.getpid()}"
    if path.exists():
        path.unlink()
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.FileStore(str(path), 1),
                            rank=0, world_size=1, device_id=dev)
    try:
        yield init_device_mesh("cuda", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()
        if path.exists():
            path.unlink()


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _relayout(state, shardings):
    """A DTensor state moved to ``shardings`` (prefill's layout to
    decode's)."""
    from repro_torch.training.tree import tree_map
    return tree_map(lambda x, sh: x if tuple(x.placements) == sh.placements
                    else x.redistribute(sh.mesh, sh.placements),
                    state, shardings)


def _dist_serve(dev, cfg, params, mesh, strategy, tokens, plens, cache,
                steps, feed=None, time_steps=False):
    """Prefill ``tokens`` then ``steps`` greedy decode steps (or the tokens
    of ``feed``, teacher-forced), with no mesh (``strategy`` None) or under
    ``strategy``'s prefill then decode rules.  Returns the prefill logits,
    each step's logits (fp32, on the CPU), the tokens fed, each step's
    host wall (synced) and, for a mesh run, the collectives of one more
    counted step."""
    import torch
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.api import use_rules
    from repro_torch.launch.dryrun import _counter_class, collective_bytes
    from repro_torch.models import model as M
    b = tokens.shape[0]
    if strategy is None:
        rules = None
        ctx = contextlib.nullcontext
        p = params
    else:
        rules = {m: SH.make_rules(strategy, m) for m in ("prefill", "decode")}
        p = SH.distribute(params, SH.param_shardings(cfg, mesh,
                                                     rules["decode"]))

        def ctx(mode="decode"):
            return use_rules(mesh, rules[mode])
    with (ctx("prefill") if rules else ctx()):
        logits, state = M.prefill(p, cfg, tokens, plens, cache)
    if rules:
        state = _relayout(state, SH.state_shardings(cfg, mesh,
                                                    rules["decode"], b,
                                                    cache))
    first = _full(logits).float().cpu()
    tok = first.argmax(-1).to(dev)[:, None].to(torch.int32)
    out, fed, walls = [], [], []
    for i in range(steps):
        if feed is not None:
            tok = feed[i]
        fed.append(tok)
        if time_steps:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx():
            logits, state = M.decode_step(p, cfg, state, tok)
        lg = _full(logits)
        if time_steps:
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out.append(lg.float().cpu())
        tok = lg.argmax(-1)[:, None].to(torch.int32)
    colls = None
    if rules:
        counter = _counter_class()()
        with ctx(), counter:
            M.decode_step(p, cfg, state, tok)
        torch.cuda.synchronize()
        colls = collective_bytes(counter.colls)
    del state, p
    return {"prefill": first, "logits": out, "fed": fed, "walls": walls,
            "collectives": colls}


def phase_dist(dev) -> dict:
    """The distributed layer on the card: a world of 1 over NCCL (a
    FileStore under build/) and a (1, 1) ('data', 'model') DeviceMesh.
    A world of more than one rank cannot run on one card over NCCL
    (NCCL refuses two ranks on one device): the multi-rank semantics are
    held on the CPU by gloo tests (tests/test_torch_collectives.py, a
    2x2 world, and tests/test_torch_dist_launchers.py).

    Full width: Qwen3-8B cut to DIST_LAYERS of 36, bf16, seeded weights;
    8 prompts of 512 tokens prefilled into a 1024-token cache, then 16
    greedy decode steps, with no mesh and under each of DIST_STRATEGIES
    (prefill rules, then the state moved to the decode rules): greedy
    tokens and max logit difference against the no-mesh run, the eager
    step p50 beside the no-mesh p50 (DTensor's dispatch on the host),
    peak memory, the collectives of one counted step.

    Exactness (fp32, TF32 off, 2 layers at full width, teacher-forced on
    the no-mesh run's tokens): fastdecode and baseline == the no-mesh
    decode within DIST_EXACT_RTOL (relative to the logits' max), and
    fastdecode_sm == fastdecode within DIST_SM_TOL; one make_train_step
    step under the train rules with grad_shardings == the no-mesh step
    (loss within EQUIV_TRAIN_LOSS_RTOL, every grad leaf within
    EQUIV_TRAIN_GRAD_TOL).  No kernel of the port runs (the mesh paths
    attend in plain torch): every counter stays 0."""
    import dataclasses
    import torch
    from repro_torch.core.config import get_arch
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.api import use_rules
    from repro_torch.models.model import init_params
    from repro_torch.training import train as TT
    from repro_torch.training.tree import leaves_with_path
    t_phase = time.perf_counter()
    _reset_counters()
    full = get_arch("qwen3-8b")
    gen = torch.Generator().manual_seed(26)
    runs, exact = {}, {}
    with _dist_world(dev) as mesh:
        # -- full width, bf16 --
        cfg = dataclasses.replace(full, num_layers=DIST_LAYERS)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        tokens = torch.randint(0, cfg.vocab_size, (DIST_ROWS, DIST_PROMPT),
                               generator=gen, dtype=torch.int32).to(dev)
        plens = torch.full((DIST_ROWS,), DIST_PROMPT, dtype=torch.int32,
                           device=dev)
        base = None
        for strategy in (None,) + DIST_STRATEGIES:
            _free_device()
            torch.cuda.reset_peak_memory_stats()
            r = _dist_serve(dev, cfg, params, mesh, strategy, tokens, plens,
                            DIST_CACHE, DIST_STEPS, time_steps=True)
            toks = [t.cpu().flatten().tolist() for t in r["fed"]]
            rec = {"step_p50_s": float(np.median(r["walls"][1:])),
                   "first_step_s": r["walls"][0],
                   "max_memory_allocated": torch.cuda.max_memory_allocated(),
                   "collectives_per_step": r["collectives"],
                   "logits_finite": all(bool(x.isfinite().all())
                                        for x in r["logits"])}
            if not rec["logits_finite"]:
                raise AssertionError(f"dist {strategy}: non-finite logits")
            if base is None:
                base = r
                rec["tokens"] = toks
            else:
                rec["tokens_equal"] = toks == runs["none"]["tokens"]
                rec["first_token_diff_step"] = next(
                    (i for i, (a, b) in enumerate(zip(toks,
                                                      runs["none"]["tokens"]))
                     if a != b), None)
                rec["prefill_max_logit_diff"] = float(
                    (r["prefill"] - base["prefill"]).abs().max())
                rec["max_logit_diff_before_divergence"] = float(max(
                    (a - b).abs().max() for a, b in zip(
                        r["logits"][:rec["first_token_diff_step"]
                                    or DIST_STEPS], base["logits"])))
            runs[strategy or "none"] = rec
            del r
        del params
        _free_device()
        # -- exactness, fp32 --
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        cfg = dataclasses.replace(full, num_layers=DIST_EXACT_LAYERS,
                                  dtype="float32")
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                             device=dev)
        tokens = torch.randint(0, cfg.vocab_size,
                               (DIST_EXACT_ROWS, DIST_EXACT_PROMPT),
                               generator=gen, dtype=torch.int32).to(dev)
        plens = torch.randint(DIST_EXACT_PROMPT // 2, DIST_EXACT_PROMPT + 1,
                              (DIST_EXACT_ROWS,), generator=gen,
                              dtype=torch.int32).to(dev)
        ref = _dist_serve(dev, cfg, params, mesh, None, tokens, plens,
                          DIST_EXACT_CACHE, DIST_EXACT_STEPS)
        outs = {}
        for strategy in DIST_STRATEGIES:
            outs[strategy] = _dist_serve(
                dev, cfg, params, mesh, strategy, tokens, plens,
                DIST_EXACT_CACHE, DIST_EXACT_STEPS, feed=ref["fed"])
        scale = max(float(x.abs().max()) for x in ref["logits"])

        def diff(a, b):
            return max([float((x - y).abs().max())
                        for x, y in zip(a["logits"], b["logits"])]
                       + [float((a["prefill"] - b["prefill"]).abs().max())])
        for strategy in ("fastdecode", "baseline"):
            exact[strategy] = {"max_abs": diff(outs[strategy], ref),
                               "rel": diff(outs[strategy], ref) / scale}
            if exact[strategy]["rel"] > DIST_EXACT_RTOL:
                raise AssertionError(f"dist exact {strategy}: {exact}")
        exact["fastdecode_sm_vs_fastdecode"] = diff(outs["fastdecode_sm"],
                                                    outs["fastdecode"])
        if exact["fastdecode_sm_vs_fastdecode"] > DIST_SM_TOL:
            raise AssertionError(f"dist exact fastdecode_sm: {exact}")
        del outs, ref
        # one train step under the train rules, with grad_shardings
        n = min(64, DIST_EXACT_PROMPT)
        batch = {"tokens": tokens[:, :n].contiguous(),
                 "targets": torch.roll(tokens[:, :n], -1, 1).contiguous(),
                 "mask": torch.ones((DIST_EXACT_ROWS, n), device=dev)}
        grads = {}
        own = TT.adamw

        def adamw(*a, **kw):
            init, update = own(*a, **kw)

            def record(g, st, p):
                grads[where] = {k: _full(v).detach().clone()
                                for k, v in leaves_with_path(g)}
                return update(g, st, p)
            return init, record
        TT.adamw = adamw
        losses = {}
        try:
            for where in ("plain", "mesh"):
                p = _clone(params)
                if where == "plain":
                    init, step = TT.make_train_step(cfg, q_chunk=n,
                                                    kv_chunk=n)
                    st, m = step(init(p), batch)
                else:
                    rules = SH.make_rules("fastdecode", "train", train=True)
                    p_sh = SH.param_shardings(cfg, mesh, rules)
                    init, step = TT.make_train_step(
                        cfg, q_chunk=n, kv_chunk=n, grad_shardings=p_sh)
                    with use_rules(mesh, rules):
                        st = init(SH.distribute(p, p_sh))
                        b_d = {k: SH.distribute_leaf(v, SH.data_sharding(
                            mesh, rules, v.shape, ("batch", "seq")))
                               for k, v in batch.items()}
                        st, m = step(st, b_d)
                losses[where] = float(_full(m["loss"]))
                del st, m, p
        finally:
            TT.adamw = own
        rel = abs(losses["mesh"] - losses["plain"]) / abs(losses["plain"])
        if rel > EQUIV_TRAIN_LOSS_RTOL:
            raise AssertionError(f"dist train: loss {losses}")
        rtol, atol = EQUIV_TRAIN_GRAD_TOL
        worst = 0.0
        for path, w in grads["plain"].items():
            g = grads["mesh"][path]
            err = (g.float() - w.float()).abs()
            if not bool((err <= atol + rtol * w.float().abs()).all()):
                raise AssertionError(f"dist train: grad {path} off by "
                                     f"{float(err.max()):.3g}")
            worst = max(worst, float(err.max()))
        exact["train"] = {"losses": losses, "loss_rel": rel,
                          "grad_max_abs": worst}
        del params, grads
    counts = {name: (launched.value, plain.value)
              for name, (launched, plain) in _counters().items()}
    if any(a for a, _ in counts.values()):
        raise AssertionError(f"dist: a kernel launched: {counts}")
    _free_device()
    for name, rec in runs.items():
        print(f"dist {name}: step p50 {rec['step_p50_s']:.4f} s, peak "
              f"{rec['max_memory_allocated'] / 2**30:.2f} GiB, "
              f"collectives/step "
              f"{(rec['collectives_per_step'] or {}).get('counts')}",
              flush=True)
    return {"phase": "dist", "ok": True, "arch": full.name,
            "layers": DIST_LAYERS, "full_layers": full.num_layers,
            "rows": DIST_ROWS, "prompt": DIST_PROMPT, "cache": DIST_CACHE,
            "steps": DIST_STEPS, "world": 1, "mesh": {"data": 1, "model": 1},
            "backend": "nccl", "runs": runs, "exact": exact,
            "exact_rtol": DIST_EXACT_RTOL, "sm_tol": DIST_SM_TOL,
            "kernel_launches": {k: v[0] for k, v in counts.items()},
            "plain_calls": {k: v[1] for k, v in counts.items()},
            "card": gpu_name_and_limit(),
            "seconds": time.perf_counter() - t_phase}


PHASES = ("kernel", "serve", "serve_int8", "serve_spec", "serve_chunked",
          "serve_spec_int8", "serve_sampled", "serve_prefix", "serve_tier",
          "serve_plan", "serve_fleet", "serve_chaos", "equiv", "equiv_int8",
          "equiv_spec", "equiv_chunk", "equiv_spec_int8", "equiv_prefix",
          "equiv_plan", "equiv_fleet", "serve_eval", "static_eval",
          "equiv_eval", "serve_moe", "equiv_moe", "serve_rglru",
          "serve_ssd", "equiv_recurrent", "static_vision", "static_whisper",
          "equiv_xattn", "fleet_xattn", "paged_kv_api", "examples", "train",
          "equiv_train", "dist")


def kernels_line(results) -> list:
    """The ``kernels`` line: every ported kernel with its time at the
    main path's shape (null where the kernel phase did not run) and its
    launches in the counted serve run of its path: the bf16 paged serve
    for kernel 1, the paged-int8 serve for kernel 3, the spec serve for
    kernel 4, the paged int8 spec serve for kernel 3's multi-token entry
    (``verify_int8``); kernel 2, the cross-attention R-Part, the static
    runs of static_vision and static_whisper (with the serve runs' count,
    0: no serve path reaches it; null where none of these phases ran),
    its times at the cross-attention shapes beside it.  Each entry's
    ``train_launches`` is its count in the train phase: 0, the train path
    reaches no kernel (null where the phase did not run); ``dist_launches``
    its count in the dist phase: 0, the mesh paths attend in plain torch
    (null where the phase did not run).  Kernel 2's ``launches`` also
    sums fleet_xattn's runs (the cross-attention R-Part before and after
    a move and a restore; ``fleet_xattn_launches`` gives them apart);
    ``examples_launches`` is each entry's count in the examples' runs: 0,
    their dense fp R-Parts attend in plain torch, as ``repro``'s in jnp
    (null where the phase did not run)."""
    k = results.get("kernel")
    serve, serve8 = results.get("serve"), results.get("serve_int8")
    spec, spec8 = results.get("serve_spec"), results.get("serve_spec_int8")
    chunked = results.get("serve_chunked")
    rg = results.get("serve_rglru")
    sv, sw = results.get("static_vision"), results.get("static_whisper")
    runs = ([serve] if serve else []) + (serve8["runs"] if serve8 else []) \
        + ([spec] if spec else []) + (spec8["runs"] if spec8 else []) \
        + (chunked["runs"] if chunked else [])
    fx, ex = results.get("fleet_xattn"), results.get("examples")
    xruns = [{"launches": r["kernel_launches"]} for ph in (sv, sw) if ph
             for r in ph["runs"].values()]
    # fleet_xattn's unmoved and moved runs
    xruns += [{"launches": r} for c in (fx["cases"].values() if fx else ())
              for r in (c["unmoved"]["launches"], c["moved"]["launches"])]
    launches = {
        "paged_decode_attention": serve["kernel_launches"] if serve else None,
        "decode_attention": sum(r["launches"]["decode_attention"]
                                for r in runs + xruns)
        if runs or xruns else None,
        "decode_attention_int8": serve8["kernel_launches"] if serve8
        else None,
        "paged_verify_attention": spec["kernel_launches"] if spec else None,
        "verify_int8": spec8["kernel_launches"] if spec8 else None,
        "decode_attention_int8_dh256": rg["runs"][1]["kernel_launches"]
        if rg else None,
    }
    line = []
    for name, (source, replaces) in KERNELS.items():
        kk = k["kernels"][name] if k else {}
        main = kk["timing"][0] if kk else {}
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": kk.get("max_abs_err"),
                     "ms": main.get("ms"), "plain_ms": main.get("plain_ms"),
                     "bound_ms": main.get("bound_ms"),
                     "bound_by": main.get("bound_by"),
                     "library_ms": main.get("library_ms")})
    # kernel 3's launches in the paged-int8 serve went through its paged
    # entry (ops.paged_decode_attention_int8, no gather)
    line[2]["paged_launches"] = (serve8["runs"][0]["int8_paged_launches"]
                                 if serve8 else None)
    # kernel 1 in the from_plan serve (its first greedy run, counted alone)
    plan = results.get("serve_plan")
    line[0]["serve_plan_launches"] = (plan["kernel_launches"] if plan
                                      else None)
    # and in the fleet serve (re-prefill run: migrations, a failover) and
    # the chaos serve (aborted attempts included)
    for name in ("serve_fleet", "serve_chaos"):
        r = results.get(name)
        line[0][f"{name}_launches"] = r["kernel_launches"] if r else None
    # and in the evaluation models' serves and the static-batch fused run
    ev = results.get("serve_eval")
    line[0]["serve_eval_launches"] = (
        {r["model"]: r["kernel_launches"] for r in ev["runs"]} if ev
        else None)
    st = results.get("static_eval")
    line[0]["static_eval_launches"] = st["kernel_launches"] if st else None
    # and in the MoE models' serves: kernel 1 in grok-1's and
    # llama4-scout's, kernel 4 in grok-1's spec serve
    moe = results.get("serve_moe")
    line[0]["serve_moe_launches"] = (
        moe["kernel_launches"]["paged_decode_attention"] if moe else None)
    line[3]["serve_moe_launches"] = (
        moe["kernel_launches"]["paged_verify_attention"] if moe else None)
    # the cross-attention slice: kernel 2 in each static run of the vision
    # model and the encoder-decoder, kernel 1 and kernel 3's paged entry on
    # the vision model's ATTN layers
    for name, ph in (("static_vision", sv), ("static_whisper", sw)):
        line[1][f"{name}_launches"] = (
            {n: r["kernel_launches"]["decode_attention"]
             for n, r in ph["runs"].items()} if ph else None)
    # cross-attention rows through the move and the restore: kernel 2 in
    # each fleet_xattn run, and in the moved run after each event; kernel
    # 1 on the vision model's paged ATTN layers there
    line[1]["fleet_xattn_launches"] = (
        {a: {"unmoved": c["unmoved"]["launches"]["decode_attention"],
             "moved": c["moved"]["launches"]["decode_attention"],
             "after": {n: e["kernel2_after"]
                       for n, e in c["moved"]["events"].items()}}
         for a, c in fx["cases"].items()} if fx else None)
    line[0]["fleet_xattn_launches"] = (
        {a: {n: c[n]["launches"]["paged_decode_attention"]
             for n in ("unmoved", "moved")}
         for a, c in fx["cases"].items()} if fx else None)
    line[0]["static_vision_launches"] = (
        sv["runs"]["fused"]["kernel_launches"]["paged_decode_attention"]
        if sv else None)
    line[2]["static_vision_launches"] = (
        sv["runs"]["int8"]["kernel_launches"]["decode_attention_int8"]
        if sv else None)
    if k:
        line[1]["cross_attention"] = [
            {key: r[key] for key in ("shape", "B", "S", "Hq", "Hkv", "Dh",
                                     "ms", "device_ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms",
                                     "library_device_ms", "max_abs_err")}
            for r in k["kernels"]["decode_attention"]["timing_cross"]]
    # kernels 1 and 4 at the MoE models' head layouts (G 6 with softcap
    # 30, G 5): their times beside the main path's
    # the training slice: the train path attends in plain torch
    # and launches no kernel of the port; the train phase's count (the
    # Dh 256 row shares kernel 3's counter)
    tr, di = results.get("train"), results.get("dist")
    for entry in line:
        counter = ("decode_attention_int8"
                   if entry["name"] == "decode_attention_int8_dh256"
                   else entry["name"])
        entry["train_launches"] = (tr["kernel_launches"][counter] if tr
                                   else None)
        # the distributed slice attends in plain torch too
        entry["dist_launches"] = (di["kernel_launches"][counter] if di
                                  else None)
        # the examples: the entry's count in each module's run
        entry["examples_launches"] = (
            {n: r[counter] for n, r in ex["kernel_launches"].items()}
            if ex else None)
    if k:
        for i, name in ((0, "paged_decode_attention"),
                        (3, "paged_verify_attention")):
            line[i]["moe_models"] = [
                {key: r[key] for key in ("shape", "Hq", "Hkv", "T",
                                         "softcap", "ms", "device_ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "library",
                                         "max_abs_err", "row_groups")}
                for r in k["kernels"][name]["timing_moe_models"]]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "chip_smoke",
                    help="directory for the serve phases' profiler tables "
                         "and the bf16 serve's Chrome trace")
    ap.add_argument("--trace-out", type=Path, default=None,
                    help="directory for serve_plan's exported Chrome traces "
                         "of the pipeline spans (default: --out)")
    ap.add_argument("--parent-dense-source", type=Path, default=None,
                    help="a parent's csrc/decode_attention.cu of this C ABI "
                         "(its headers beside it): adds the compare_dense "
                         "phase (kernels 2 and 3 against this tree's, in "
                         "turns; kernel 3 bitwise)")
    ap.add_argument("--parent-source", type=Path, default=None,
                    help="a parent's csrc/paged_attention.cu of this C ABI "
                         "(its headers beside it): adds the compare phase "
                         "(kernels 1 and 4 against this tree's, in turns; "
                         "kernel 4 at T >= 2 and fp32 bitwise)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phase(s) {sorted(unknown)}")
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script "
              "— run it from a checkout of the repo", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda", 0)
    results = {}
    if "kernel" in phases:
        results["kernel"] = phase_kernel(dev)
        log(results["kernel"])
    if args.parent_source is not None:
        log(phase_compare(dev, args.parent_source.resolve()))
    if args.parent_dense_source is not None:
        log(phase_compare_dense(dev, args.parent_dense_source.resolve()))
    if {"serve", "serve_int8", "serve_spec", "serve_chunked",
            "serve_spec_int8", "serve_sampled", "serve_prefix",
            "serve_tier", "serve_plan", "serve_fleet",
            "serve_chaos"} & set(phases):
        model = serve_model(dev)
        if "serve" in phases:
            results["serve"] = phase_serve(dev, model, args.out)
            log(results["serve"])
        if "serve_int8" in phases:
            results["serve_int8"] = phase_serve_int8(dev, model, args.out)
            log(results["serve_int8"])
        if "serve_spec" in phases:
            results["serve_spec"] = phase_serve_spec(
                dev, model, args.out, results.get("serve"))
            log(results["serve_spec"])
        int8_runs = (results["serve_int8"]["runs"]
                     if "serve_int8" in results else (None, None))
        if "serve_chunked" in phases:
            results["serve_chunked"] = phase_serve_chunked(
                dev, model, args.out, (results.get("serve"), int8_runs[0]))
            log(results["serve_chunked"])
        if "serve_spec_int8" in phases:
            results["serve_spec_int8"] = phase_serve_spec_int8(
                dev, model, args.out, int8_runs, results.get("serve_spec"))
            log(results["serve_spec_int8"])
        if "serve_sampled" in phases:
            results["serve_sampled"] = phase_serve_sampled(
                dev, model, args.out, results.get("serve"))
            log(results["serve_sampled"])
        if "serve_prefix" in phases:
            results["serve_prefix"] = phase_serve_prefix(dev, model,
                                                         args.out)
            log(results["serve_prefix"])
        if "serve_tier" in phases:
            results["serve_tier"] = phase_serve_tier(dev, model, args.out)
            log(results["serve_tier"])
        if "serve_plan" in phases:
            results["serve_plan"] = phase_serve_plan(
                dev, model, args.out, args.trace_out or args.out)
            log(results["serve_plan"])
        chaos_off = None
        if "serve_fleet" in phases:
            results["serve_fleet"], *chaos_off = phase_serve_fleet(
                dev, model, args.out)
            log(results["serve_fleet"])
        if "serve_chaos" in phases:
            results["serve_chaos"] = phase_serve_chaos(dev, model, args.out,
                                                       chaos_off)
            log(results["serve_chaos"])
        del model, chaos_off
        _free_device()
    if {"serve_eval", "static_eval"} & set(phases):
        # Qwen3-8B is freed: llama-13b at full size, then opt-175b cut
        eval_runs = []
        llama = eval_model(dev, "llama-13b")
        if "serve_eval" in phases:
            eval_runs.append(serve_eval_run(dev, llama, args.out))
        if "static_eval" in phases:
            results["static_eval"] = phase_static_eval(dev, llama)
            log(results["static_eval"])
        del llama
        _free_device()
        if "serve_eval" in phases:
            opt = eval_model(dev, "opt-175b", layers=OPT_LAYERS)
            eval_runs.append(serve_eval_run(dev, opt, args.out))
            del opt
            _free_device()
            results["serve_eval"] = {
                "phase": "serve_eval", "ok": True, "runs": eval_runs,
                "seconds": sum(r["seconds"] for r in eval_runs)}
            log(results["serve_eval"])
    if "serve_moe" in phases:
        results["serve_moe"] = phase_serve_moe(dev, args.out)
        log(results["serve_moe"])
    if "equiv" in phases:
        results["equiv"] = phase_equiv(dev)
        log(results["equiv"])
    if "equiv_int8" in phases:
        results["equiv_int8"] = phase_equiv_int8(dev)
        log(results["equiv_int8"])
    if "equiv_spec" in phases:
        results["equiv_spec"] = phase_equiv_spec(dev)
        log(results["equiv_spec"])
    if "equiv_chunk" in phases:
        results["equiv_chunk"] = phase_equiv_chunk(dev)
        log(results["equiv_chunk"])
    if "equiv_spec_int8" in phases:
        results["equiv_spec_int8"] = phase_equiv_spec_int8(dev)
        log(results["equiv_spec_int8"])
    if "equiv_prefix" in phases:
        results["equiv_prefix"] = phase_equiv_prefix(dev)
        log(results["equiv_prefix"])
    if "equiv_plan" in phases:
        results["equiv_plan"] = phase_equiv_plan(dev)
        log(results["equiv_plan"])
    if "equiv_fleet" in phases:
        results["equiv_fleet"] = phase_equiv_fleet(dev)
        log(results["equiv_fleet"])
    if "equiv_eval" in phases:
        results["equiv_eval"] = phase_equiv_eval(dev)
        log(results["equiv_eval"])
    if "equiv_moe" in phases:
        results["equiv_moe"] = phase_equiv_moe(dev)
        log(results["equiv_moe"])
    if "serve_rglru" in phases:
        results["serve_rglru"] = phase_serve_rglru(dev, args.out)
        log(results["serve_rglru"])
    if "serve_ssd" in phases:
        results["serve_ssd"] = phase_serve_ssd(dev, args.out)
        log(results["serve_ssd"])
    if "equiv_recurrent" in phases:
        results["equiv_recurrent"] = phase_equiv_recurrent(dev)
        log(results["equiv_recurrent"])
    if "static_vision" in phases:
        results["static_vision"] = phase_static_vision(dev, args.out)
        log(results["static_vision"])
    if "static_whisper" in phases:
        results["static_whisper"] = phase_static_whisper(dev, args.out)
        log(results["static_whisper"])
    if "equiv_xattn" in phases:
        results["equiv_xattn"] = phase_equiv_xattn(dev)
        log(results["equiv_xattn"])
    if "fleet_xattn" in phases:
        results["fleet_xattn"] = phase_fleet_xattn(dev)
        log(results["fleet_xattn"])
    if "paged_kv_api" in phases:
        results["paged_kv_api"] = phase_paged_kv_api(dev)
        log(results["paged_kv_api"])
    if "examples" in phases:
        results["examples"] = phase_examples(dev)
        log(results["examples"])
    if "train" in phases:
        results["train"] = phase_train(dev)
        log(results["train"])
    if "equiv_train" in phases:
        results["equiv_train"] = phase_equiv_train(dev)
        log(results["equiv_train"])
    if "dist" in phases:
        results["dist"] = phase_dist(dev)
        log(results["dist"])
    log({"kernels": kernels_line(results)})
    print(gpu_name_and_limit(), flush=True)
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
