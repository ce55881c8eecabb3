"""End-to-end serving on the port: batched requests through the
full FastDecode stack — continuous batching, Algorithm-1 load-controlled
admission, the heterogeneous S-/R-worker pipeline, greedy sampling —
with the per-step load trace the paper plots in Fig. 7/11.

    PYTHONPATH=src python -m repro_torch.examples.serve_continuous [--requests 48]
    PYTHONPATH=src python -m repro_torch.examples.serve_continuous --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.config import get_arch
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request

CFG = get_arch("qwen3-8b").reduced(layers=4, d_model=128, vocab=1024)


def main(argv=None, params=None):
    """Returns (the finished requests, the engine's step records).
    ``params`` replaces the seeded weights (a test passes the JAX
    package's)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--backend", default="hetero",
                    choices=["hetero", "colocated"])
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="stream prompts into the pipeline this many tokens "
                         "per step (0 = monolithic whole-prompt prefill; "
                         "hetero only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = CFG
    if params is None:
        params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               device=device)
    rng = np.random.default_rng(0)

    eng = ServingEngine(params, cfg, batch=args.batch, cache_len=128,
                        backend=args.backend, admission="loadctl",
                        target_len=8 + args.max_new, interval=6,
                        num_r_workers=2, num_microbatches=2, kv_chunk=128,
                        prefill_chunk=(args.prefill_chunk
                                       if args.backend == "hetero" else 0),
                        device=device)
    try:
        for i in range(args.requests):
            plen = int(rng.integers(4, 12))
            eng.submit(Request(rid=i,
                               prompt=rng.integers(1, cfg.vocab_size,
                                                   plen).astype(np.int32),
                               max_new_tokens=args.max_new))
        t0 = time.time()
        done = eng.run(max_steps=50_000)
        dt = time.time() - t0
    finally:
        eng.close()

    tokens = sum(len(r.generated) for r in done)
    print(f"\nserved {len(done)} requests / {tokens} tokens in {dt:.1f}s "
          f"({tokens/dt:,.0f} tok/s on this host)")
    lat = [r.finish_step - r.start_step for r in done]
    wait = [r.start_step - r.arrive_step for r in done]
    print(f"generation steps p50={int(np.median(lat))}  "
          f"admission wait p50={int(np.median(wait))} max={max(wait)}")
    print("\nper-step resident length (the paper's Fig. 7 plateau):")
    trace = [r.resident_len for r in eng.records]
    W = max(trace) or 1
    for i in range(0, len(trace), max(1, len(trace) // 24)):
        bar = "#" * int(40 * trace[i] / W)
        print(f"  step {i:4d} |{bar:<40s}| {trace[i]}")
    return done, eng.records


if __name__ == "__main__":
    main()
