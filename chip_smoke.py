#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py                    # every phase, as a user would run it
    python3 chip_smoke.py --phases kernel    # only some phases

Phases (any failure exits nonzero):

  kernel  builds the port's CUDA sources (src/repro_torch/csrc, into the
          gitignored build/ directory), holds every kernel against its
          plain PyTorch version on the card, and times it at the main
          path's shape and at a bandwidth shape beside its bound, its plain
          version and a library yardstick.
  serve   Qwen3-8B at full width, random weights from a seeded generator,
          served greedily through ServingEngine(backend="hetero",
          num_r_workers=2, paged_kv=True): every request must finish with
          the right token count and finite logits, and the kernel launch
          count must equal layers x micro-batches x workers x decode steps.
  equiv   the same width at 2 layers in fp32 (TF32 off): the hetero paged
          engine (through the kernel) and the colocated engine (plain
          torch) must give the same greedy tokens, a mismatch counting only
          if the teacher-forced logits also differ beyond tolerance.

Earlier lines print one JSON object per phase and one ``kernels`` line;
the line before the last is the card's name and power limit; the last
line is ``{"ok": true, "device": {...}}``.  Without CUDA, or outside a
checkout of the repo, it exits nonzero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity
KERNEL_SOURCE = "src/repro_torch/csrc/paged_attention.cu"
KERNEL_REPLACES = "src/repro/kernels/paged_attention.py:56"
# kernel vs plain version: |out - want| <= atol + rtol * |want|.  Both
# accumulate in fp32 and round once to the output dtype, so in bf16 they
# may differ by one rounding step, at most 2^-7 of |want|; one dropped
# key among 512 moves an output by ~2e-3, far beyond atol.
TOL = {"bfloat16": (1e-4, 2.0 ** -7), "float32": (1e-5, 0.0)}


def tol_check(out, want, dtype_name: str):
    """(max |out - want|, whether every element is inside TOL)."""
    atol, rtol = TOL[dtype_name]
    d = (out.float() - want.float()).abs()
    inside = bool((d <= atol + rtol * want.float().abs()).all())
    return float(d.max()), inside and bool(out.float().isfinite().all())


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_name_and_limit() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


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
    import torch
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 plain version
    torch.backends.cudnn.allow_tf32 = False         # runs in full fp32
    gen = torch.Generator().manual_seed(0)
    cases = []
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for g in (1, 4):
            for page in (4, 16):
                hkv = 8 // g if g < 8 else 1
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
    worst = 0.0
    results = []
    for c in cases:
        q, pk, pv, tables, lens = _paged_case(gen, dtype=c["dtype"], dev=dev,
                                              **c["kw"])
        out = PA.paged_decode_attention(q, pk, pv, tables, lens, **c["attn"])
        torch.cuda.synchronize()
        want = ref.paged_decode_attention_ref(q, pk, pv, tables, lens,
                                              **c["attn"])
        dtype_name = str(c["dtype"]).split(".")[-1]
        err, ok = tol_check(out, want, dtype_name)
        un = c["kw"].get("unmapped_row")
        if un is not None:
            ok = ok and bool((out[un] == 0).all())
        results.append({"case": c["name"], "max_abs_err": err,
                        "atol_rtol": TOL[dtype_name], "ok": ok})
        if not ok:
            raise AssertionError(f"kernel case {c['name']} failed: err {err} "
                                 f"(atol, rtol) {TOL[dtype_name]} (unmapped "
                                 f"row must be exactly 0)")
        worst = max(worst, err)
    return {"cases": results, "max_abs_err": worst}


def kernel_timing(dev, name, *, b, n_tok, hq=32, hkv=8, dh=128, page=16,
                  cache_len=None, copies=1, iters=50) -> dict:
    """Kernel, plain version and SDPA yardstick at one shape, bf16.  Every
    row holds ``n_tok`` valid tokens (lengths = n_tok - 1); ``copies``
    distinct pools are cycled so the working set exceeds the 50 MB L2."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(1)
    mp = -(-(cache_len or n_tok) // page)
    per_row = -(-n_tok // page)
    n_pages = b * mp + 1
    bufs = []
    for _ in range(copies):
        pk = torch.randn((n_pages, page, hkv, dh), generator=gen,
                         device=dev).to(torch.bfloat16)
        pv = torch.randn((n_pages, page, hkv, dh), generator=gen,
                         device=dev).to(torch.bfloat16)
        q = torch.randn((b, hq, dh), generator=gen,
                        device=dev).to(torch.bfloat16)
        ids = torch.randperm(b * mp, generator=gen, device=dev)
        tables = torch.full((b, mp), -1, dtype=torch.int32, device=dev)
        tables[:, :per_row] = ids[:b * per_row].reshape(b, per_row).to(
            torch.int32)
        lens = torch.full((b,), n_tok - 1, dtype=torch.int32, device=dev)
        # the library yardstick reads the already-gathered K/V (the gather
        # is excluded from its time); all n_tok positions are valid
        kg, _ = ref.paged_gather(pk, tables[:, :per_row])
        vg, _ = ref.paged_gather(pv, tables[:, :per_row])
        kg = kg[:, :n_tok].permute(0, 2, 1, 3).contiguous()
        vg = vg[:, :n_tok].permute(0, 2, 1, 3).contiguous()
        bufs.append((q, pk, pv, tables, lens, kg, vg))

    def kern(i):
        q, pk, pv, tables, lens = bufs[i % copies][:5]
        return PA.paged_decode_attention(q, pk, pv, tables, lens)

    def plain(i):
        q, pk, pv, tables, lens = bufs[i % copies][:5]
        return ref.paged_decode_attention_ref(q, pk, pv, tables, lens)

    def lib(i):
        q, kg, vg = bufs[i % copies][0], bufs[i % copies][5], \
            bufs[i % copies][6]
        return F.scaled_dot_product_attention(q[:, :, None], kg, vg,
                                              enable_gqa=True)

    q, pk, pv, tables, lens, kg, vg = bufs[0]
    got = kern(0)
    err, ok = tol_check(got, plain(0), "bfloat16")
    if not ok:
        raise AssertionError(f"kernel at the {name} shape: max err {err} "
                             f"against the plain version, (atol, rtol) "
                             f"{TOL['bfloat16']}")
    lib_err = float((got.float() - lib(0)[:, :, 0].float()).abs().max())
    ms = cuda_time_ms(kern, iters)
    plain_ms = cuda_time_ms(plain, max(3, iters // 10), warmup=1)
    library_ms = cuda_time_ms(lib, iters)
    elt = 2
    kv_bytes = 2 * b * n_tok * hkv * dh * elt
    io_bytes = 2 * b * hq * dh * elt + tables.numel() * 4 + b * 4
    bytes_moved = kv_bytes + io_bytes
    flops = 4 * b * n_tok * hq * dh
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    return {"shape": name, "B": b, "tokens_per_row": n_tok, "Hq": hq,
            "Hkv": hkv, "Dh": dh, "page": page, "dtype": "bfloat16",
            "pool_copies": copies, "max_abs_err": err,
            "atol_rtol": TOL["bfloat16"], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_err": lib_err,
            "bytes": bytes_moved, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "achieved_GBps": bytes_moved / (ms * 1e-3) / 1e9}


def phase_kernel(dev) -> dict:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    for stem, text in build.report().items():
        print(f"ptxas report of {stem}:\n{text}", flush=True)
    checks = kernel_checks(dev)
    # main path: one R-worker call = 2 rows of a micro-batch (batch 8, two
    # micro-batches, two workers) over ~512 tokens, pool sized for
    # cache_len 1024; 16 pools cycled to defeat the L2
    main = kernel_timing(dev, "main-path", b=2, n_tok=512, cache_len=1024,
                         copies=16, iters=200)
    bw = kernel_timing(dev, "bandwidth", b=64, n_tok=4096, copies=1,
                       iters=20)
    return {"phase": "kernel", "ok": True, "build_s": build_s,
            "checks": checks, "timing": [main, bw],
            "max_abs_err": max(checks["max_abs_err"], main["max_abs_err"],
                               bw["max_abs_err"])}


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


def phase_serve(dev, out: Path) -> dict:
    import torch
    from repro_torch.core.config import get_arch
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine
    cfg = get_arch("qwen3-8b")             # full width and depth
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in _leaves(params))
    batch, n_mb, n_workers = 8, 2, 2
    eng = ServingEngine(params, cfg, backend="hetero", num_r_workers=n_workers,
                        num_microbatches=n_mb, paged_kv=True, page_size=16,
                        batch=batch, cache_len=1024, device=dev)
    try:
        reqs = _requests(np.random.default_rng(0), 12, 17, 600, 16, 32,
                         cfg.vocab_size)
        for r in reqs:
            eng.submit(r)
        torch.cuda.synchronize()
        PA.launches.reset()
        PA.plain_calls.reset()
        nonfinite = 0
        peak_resident = 0.0
        while eng.queue or any(s is not None for s in eng.slots):
            eng.step()
            nonfinite += int((~torch.isfinite(eng.last_logits)).sum())
            peak_resident = max(peak_resident, eng.paged_resident_bytes())
            if eng.step_idx > 200:
                raise AssertionError("serve did not drain in 200 steps")
        launches = PA.launches.value
        steps = eng.step_idx
        pool_bytes = sum(w.pool_bytes() for w in eng.engine.workers)
        hot = eng.hotpath_stats()
        busy = eng.engine.worker_busy_times()
        # a separate traced window on the warm engine (not part of the
        # counted run above): 8 fresh ~512-token rows, 3 decode steps
        for r in _requests(np.random.default_rng(1), 8, 500, 520, 32, 32,
                           cfg.vocab_size):
            r.rid += 100
            eng.submit(r)
        eng.step()                      # admission + prefill + one decode
        trace = _profile_steps(eng, 3, out)
    finally:
        eng.close()
    done = {r.rid: r for r in eng.finished}
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
    want = cfg.num_layers * n_mb * n_workers * steps
    if launches != want or PA.plain_calls.value != 0:
        raise AssertionError(
            f"kernel launches {launches} != layers x micro-batches x "
            f"workers x decode steps = {want} (plain calls "
            f"{PA.plain_calls.value})")
    recs = eng.records
    dec = [rec.decode_wall for rec in recs]
    # tokens emitted by decode steps (token 0 of a request comes from its
    # prefill logits, inside prefill_wall)
    dec_tokens = sum(len(r.generated) - 1 for r in reqs)
    return {"phase": "serve", "ok": True, "model": "qwen3-8b",
            "layers": cfg.num_layers, "d_model": cfg.d_model, "heads": [cfg.num_heads,
                                              cfg.num_kv_heads],
            "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
            "weight_bytes": weight_bytes, "init_s": init_s,
            "requests": len(reqs), "decode_steps": steps,
            "batch": batch, "micro_batches": n_mb, "r_workers": n_workers,
            "page_size": 16, "cache_len": 1024,
            "prompt_tokens": sum(r.prompt_len for r in reqs),
            "decode_tokens": dec_tokens,
            "decode_tokens_per_s": dec_tokens / sum(dec),
            "decode_step_s_p50": float(np.median(dec)),
            "decode_step_s_max": float(np.max(dec)),
            "prefill_s_total": sum(rec.prefill_wall for rec in recs),
            "page_pool_bytes": pool_bytes,
            "paged_resident_bytes_peak": peak_resident,
            "kernel_launches": launches,
            "hotpath": hot, "r_worker_busy_s": busy, "trace": trace}


def _profile_steps(eng, n_steps: int, out: Path) -> dict:
    """torch.profiler over ``n_steps`` decode steps: the device's busy
    share of the wall window (union of kernel and copy intervals over all
    streams), device time by kernel, and host time by op.  The full
    table and the Chrome trace go to ``out``."""
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
    out.mkdir(parents=True, exist_ok=True)
    (out / "serve_profile.txt").write_text(ka.table(
        sort_by="self_cpu_time_total", row_limit=60))
    prof.export_chrome_trace(str(out / "serve_trace.json"))
    return {"steps": n_steps, "wall_s": wall_s,
            "device_busy_s": busy_us / 1e6,
            "device_idle_ratio": 1.0 - busy_us / 1e6 / wall_s,
            "memcpy_device_s": memcpy_us / 1e6,
            "kernel_launches_host": sum(e.count for e in ka
                                        if e.key == "cudaLaunchKernel"),
            "top_device": top_dev, "top_host": top_cpu}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# equiv phase: hetero paged (kernel) == colocated (plain torch), fp32
# ---------------------------------------------------------------------------
EQUIV_LOGIT_TOL = 1e-4     # fp32 logits, TF32 off


def _serve_logged(eng, reqs):
    """Serve ``reqs`` step by step; returns {rid: (tokens, [logits of
    each decode step, on the host])}."""
    import torch
    for r in reqs:
        eng.submit(r)
    logs = {r.rid: [] for r in reqs}
    while eng.queue or any(s is not None for s in eng.slots):
        rows = {i: r.rid for i, r in enumerate(eng.slots) if r is not None}
        eng.step()
        lg = eng.last_logits.float().cpu()
        for i, rid in rows.items():
            logs[rid].append(lg[i])
        if eng.step_idx > 200:
            raise AssertionError("equiv serve did not drain in 200 steps")
    torch.cuda.synchronize()
    return {r.rid: (list(r.generated), logs[r.rid]) for r in eng.finished}


def phase_equiv(dev) -> dict:
    import dataclasses
    import torch
    from repro_torch.core.config import get_arch
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = dataclasses.replace(get_arch("qwen3-8b"), num_layers=2,
                              dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    kw = dict(batch=4, cache_len=256, device=dev)
    spec = dict(n=6, p_lo=17, p_hi=200, new_lo=6, new_hi=10,
                vocab=cfg.vocab_size)
    PA.launches.reset()
    het = ServingEngine(params, cfg, backend="hetero", num_r_workers=2,
                        num_microbatches=2, paged_kv=True, page_size=16, **kw)
    try:
        got = _serve_logged(het, _requests(np.random.default_rng(2), **spec))
    finally:
        het.close()
    launches = PA.launches.value
    col = ServingEngine(params, cfg, backend="colocated", **kw)
    want = _serve_logged(col, _requests(np.random.default_rng(2), **spec))
    max_diff, mismatches, ties = 0.0, [], []
    margins = [float(v[0] - v[1]) for _, logs in want.values()
               for v in (lg.topk(2).values for lg in logs)]
    for rid, (toks_c, logs_c) in want.items():
        toks_h, logs_h = got[rid]
        n = min(len(logs_c), len(logs_h))
        for j in range(n):
            d = float((logs_h[j] - logs_c[j]).abs().max())
            max_diff = max(max_diff, d)
        if toks_h != toks_c:
            j = next(i for i, (a, b) in enumerate(zip(toks_h, toks_c))
                     if a != b)
            # token j comes from decode step j-1 (token 0 from prefill);
            # both histories agree up to j, so those logits are
            # teacher-forced
            lg = logs_c[j - 1] if j >= 1 else None
            top2 = (float(lg.topk(2).values[0] - lg.topk(2).values[1])
                    if lg is not None else None)
            d = (float((logs_h[j - 1] - logs_c[j - 1]).abs().max())
                 if j >= 1 else None)
            rec = {"rid": rid, "first_diff": j, "top2_margin": top2,
                   "logit_diff": d}
            if d is not None and d <= EQUIV_LOGIT_TOL:
                ties.append(rec)        # a near-tie flipped: not a fault
            else:
                mismatches.append(rec)
    if mismatches or max_diff > EQUIV_LOGIT_TOL or launches == 0:
        raise AssertionError(
            f"hetero-paged != colocated: mismatches {mismatches}, max "
            f"logit diff {max_diff} (tol {EQUIV_LOGIT_TOL}), kernel "
            f"launches {launches}")
    return {"phase": "equiv", "ok": True, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "dtype": "float32", "tf32": False,
            "requests": len(want), "tokens_equal": not ties,
            "near_tie_flips": ties, "max_logit_diff": max_diff,
            "min_top2_margin": min(margins),
            "logit_tol": EQUIV_LOGIT_TOL, "kernel_launches": launches}


PHASES = ("kernel", "serve", "equiv")


def kernel_record(results) -> dict:
    """The ``kernels`` line: every ported kernel, with its time at the
    main path's shape and its launches in the serve phase's run (null
    for a phase that did not run)."""
    k = results.get("kernel")
    main = k["timing"][0] if k else {}
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
            "launches": results["serve"]["kernel_launches"]
            if "serve" in results else None,
            "max_abs_err": k["max_abs_err"] if k else None,
            "ms": main.get("ms"), "plain_ms": main.get("plain_ms"),
            "bound_ms": main.get("bound_ms"), "bound_by": main.get("bound_by"),
            "library_ms": main.get("library_ms")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "chip_smoke",
                    help="directory for the serve phase's profiler table "
                         "and Chrome trace")
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
    if "serve" in phases:
        results["serve"] = phase_serve(dev, args.out)
        log(results["serve"])
    if "equiv" in phases:
        results["equiv"] = phase_equiv(dev)
        log(results["equiv"])
    log({"kernels": [kernel_record(results)]})
    print(gpu_name_and_limit(), flush=True)
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
