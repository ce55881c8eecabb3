"""Training launcher: the JAX package's ``launch/train.py`` on the port
(same flags and printed lines, plus ``--device``).

Examples:
    # a tiny run on the CPU (reduced config)
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
        --reduced --steps 100 --batch 8 --seq 128 --device cpu

    # on the card (the default device)
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
        --reduced --layers 2 --d-model 256 --steps 20

    # a 2-rank ('data' x 'model' = 1 x 2) world on the CPU over gloo
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --arch granite-3-8b --reduced \
        --mesh-model 2 --device cpu

The step runs on a ('data', 'model') mesh under the reference's
``make_rules("fastdecode", "train", train=True)``: params, moments and
batch are DTensors.  Under ``torchrun`` the world is its ``WORLD_SIZE``
(gloo on the CPU, NCCL on the cards, one card per rank); without it the
launcher makes a world of 1 itself and destroys it before it returns.
``--mesh-model`` must divide the world size.  Only rank 0 prints.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.core.config import get_arch
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.api import use_rules
from repro_torch.launch.mesh import init_world, launched_world, make_host_mesh
from repro_torch.models import model as M
from repro_torch.training import checkpoint as CK
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.train import make_train_step
from repro_torch.training.tree import leaves, tree_map


def _full(x):
    """A DTensor's global value (a collective: every rank calls it)."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


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
    if launched_world() % args.mesh_model:
        ap.error(f"--mesh-model {args.mesh_model} does not divide the world "
                 f"size {launched_world()} (run under torchrun with a "
                 f"multiple of it: python -m torch.distributed.run "
                 f"--nproc-per-node N ...)")
    device = resolve_device(args.device)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    made = init_world(device)
    try:
        return _train(args, device)
    finally:
        if made:
            dist.destroy_process_group()


def _train(args, device):
    rank = dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced(layers=args.layers, d_model=args.d_model)
    mesh = make_host_mesh(args.mesh_model)
    rules = SH.make_rules("fastdecode", "train", train=True)
    # every rank draws the same weights and keeps its own slice of them
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device=device)
    n_params = sum(x.numel() for x in leaves(params))
    say(f"arch={cfg.name} params={n_params/1e6:.1f}M "
        f"devices={mesh.size()}")
    p_sh = SH.param_shardings(cfg, mesh, rules)
    params = SH.distribute(params, p_sh)

    init_state, train_step = make_train_step(
        cfg, peak_lr=args.lr, warmup=max(10, args.steps // 10),
        total_steps=args.steps, remat=args.remat,
        q_chunk=min(1024, args.seq), kv_chunk=min(1024, args.seq),
        grad_shardings=p_sh)
    with use_rules(mesh, rules):
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
        axes = {k: ("batch", "enc_seq", None) if k == "enc_feats"
                else ("batch", "seq") for k in batch}
        batch = {k: SH.distribute_leaf(v, SH.data_sharding(
            mesh, rules, v.shape, axes[k])) for k, v in batch.items()}
        with use_rules(mesh, rules):
            state, metrics = train_step(state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            m = {k: float(_full(v)) for k, v in metrics.items()}
            tok_s = args.batch * args.seq * (i + 1) / (time.time() - t0)
            say(f"step {i:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                f"gnorm {m['grad_norm']:.2f} tok/s {tok_s:,.0f}")
    if args.save:
        full = tree_map(_full, state.params)
        if rank == 0:
            CK.save(args.save, full)
        say("saved", args.save)
    return state


if __name__ == "__main__":
    main()
