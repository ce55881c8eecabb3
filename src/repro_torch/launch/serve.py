"""Serving launcher: the JAX package's ``launch/serve.py`` on the port
(same flags and printed lines, plus ``--device``), the FastDecode engine
end to end.

Example (reduced model, heterogeneous S/R pipeline + SLS, on the CPU):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \\
        --reduced --backend hetero --admission loadctl --requests 32 \\
        --batch 16 --max-new 32 --device cpu
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--backend", default="colocated",
                    choices=["colocated", "hetero"])
    ap.add_argument("--admission", default="greedy",
                    choices=["greedy", "sls", "loadctl"])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--interval", type=int, default=8)
    ap.add_argument("--r-workers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced(layers=args.layers, d_model=args.d_model)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device=device)
    rng = np.random.default_rng(args.seed)

    eng = ServingEngine(
        params, cfg, batch=args.batch, cache_len=args.cache_len,
        backend=args.backend, admission=args.admission,
        target_len=args.prompt_len + args.max_new, interval=args.interval,
        num_r_workers=args.r_workers, seed=args.seed, device=device)
    try:
        for i in range(args.requests):
            eng.submit(Request(
                rid=i,
                prompt=rng.integers(1, cfg.vocab_size,
                                    args.prompt_len).astype(np.int32),
                max_new_tokens=args.max_new))

        t0 = time.time()
        done = eng.run(max_steps=100_000)
        dt = time.time() - t0
    finally:
        eng.close()
    tokens = sum(len(r.generated) for r in done)
    lat = [r.finish_step - r.start_step for r in done]
    wait = [r.start_step - r.arrive_step for r in done]
    print(f"served {len(done)} requests, {tokens} tokens in {dt:.2f}s "
          f"({tokens/dt:,.1f} tok/s) over {eng.step_idx} steps")
    print(f"latency steps p50={int(np.median(lat))} max={max(lat)}; "
          f"wait steps p50={int(np.median(wait))} max={max(wait)}")
    peak = max(r.resident_len for r in eng.records)
    print(f"peak resident length {peak} "
          f"(w'_max would be ~{peak} under SLS; see bench_sls)")
    return done


if __name__ == "__main__":
    main()
