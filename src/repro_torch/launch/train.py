"""Training launcher: the JAX package's ``launch/train.py`` on the port
(same flags and printed lines, plus ``--device``).

Examples:
    # a tiny run on the CPU (reduced config)
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
        --reduced --steps 100 --batch 8 --seq 128 --device cpu

    # on the card (the default device)
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
        --reduced --layers 2 --d-model 256 --steps 20

One device only: ``--mesh-model`` above 1 needs the distributed slice
(model-parallel meshes), which the port does not have yet.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.config import get_arch
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import model as M
from repro_torch.training import checkpoint as CK
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.train import make_train_step
from repro_torch.training.tree import leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--save", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.mesh_model > 1:
        ap.error("--mesh-model > 1 needs the distributed slice (model-"
                 "parallel meshes), which is not ported yet")
    device = resolve_device(args.device)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced(layers=args.layers, d_model=args.d_model)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device=device)
    n_params = sum(x.numel() for x in leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M devices=1")

    init_state, train_step = make_train_step(
        cfg, peak_lr=args.lr, warmup=max(10, args.steps // 10),
        total_steps=args.steps, remat=args.remat,
        q_chunk=min(1024, args.seq), kv_chunk=min(1024, args.seq))
    state = init_state(params)

    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                  seed=args.seed)).batches()
    t0 = time.time()
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(data).items()}
        if cfg.frontend != "none":
            batch["enc_feats"] = torch.zeros(
                (args.batch, cfg.encoder_seq, cfg.encoder_d_model),
                dtype=torch_dtype(cfg.dtype), device=device)
        state, metrics = train_step(state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            tok_s = args.batch * args.seq * (i + 1) / (time.time() - t0)
            print(f"step {i:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                  f"gnorm {m['grad_norm']:.2f} tok/s {tok_s:,.0f}")
    if args.save:
        CK.save(args.save, state.params)
        print("saved", args.save)
    return state


if __name__ == "__main__":
    main()
