"""Quickstart: the FastDecode decomposition and engine on the port.

    PYTHONPATH=src python -m repro_torch.examples.quickstart             # the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

1. builds a reduced llama-family model,
2. shows the S-Part / R-Part split of one block (paper eq. 1-4),
3. generates text through the heterogeneous S-/R-worker pipeline and
   checks it against the plain single-device decode loop.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import decompose as D
from repro_torch.core.config import get_arch
from repro_torch.core.hetero import (ColocatedEngine, HeteroPipelineEngine,
                                     per_layer_params)
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.training.tree import leaves

CFG = get_arch("granite-3-8b").reduced(layers=4, d_model=128, vocab=512)
PROMPT = np.asarray([7, 42, 99, 12], np.int32)
GEN = 12


def main(argv=None, params=None):
    """Returns {"colocated": [B, GEN], "fastdecode": [B, GEN]} greedy
    tokens (equal, or it raises).  ``params`` replaces the seeded
    weights (a test passes the JAX package's)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = CFG
    if params is None:
        params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               device=device)
    print(f"model: {cfg.name}, "
          f"{sum(x.numel() for x in leaves(params))/1e6:.1f}M params")

    # --- 1. the decomposition ---------------------------------------------
    kind, p0 = per_layer_params(params, cfg)[0]
    h = torch.full((2, 1, cfg.d_model), 0.1, dtype=torch.float32,
                   device=device)
    lengths = torch.tensor([5, 5], dtype=torch.int32, device=device)
    ctx = M.Ctx(cfg, "decode", lengths[:, None], lengths)
    po = D.s_pre(kind, p0, h, ctx)                # S-Part: QKV projections
    print("S->R payload (activations only):",
          {k: tuple(v.shape) for k, v in po.r_in.items()})
    st = M.init_decode_state(cfg, 2, 32, device)
    st0 = {k: v[0] for k, v in st["stack"]["s0"].items()}
    r_state, _ = D.split_block_state(kind, st0)
    r_out, r_state = D.r_dispatch(kind, 0, po.r_in, r_state, cfg)  # R-Part
    print("R->S payload:", {k: tuple(v.shape) for k, v in r_out.items()},
          "(KV-cache never moved)")

    # --- 2. generate through the heterogeneous pipeline --------------------
    B, S = 2, len(PROMPT)
    tokens = torch.from_numpy(np.stack([PROMPT, PROMPT[::-1]])).to(device)
    ref = ColocatedEngine(params, cfg, batch=B, cache_len=S + GEN + 1,
                          device=device)
    ref.load_prefill(tokens, torch.full((B,), S, dtype=torch.int32,
                                        device=device))
    # one R-worker per micro-batch row here (batch 2 / 2 micro-batches =
    # 1 row each); more workers than rows is a hard error
    eng = HeteroPipelineEngine(params, cfg, batch=B, cache_len=S + GEN + 1,
                               num_r_workers=1, num_microbatches=2,
                               kv_chunk=64, device=device)
    try:
        one = torch.tensor([S], dtype=torch.int32, device=device)
        eng.load_prefill(0, tokens[:1], one)
        eng.load_prefill(1, tokens[1:], one)
        tok_ref = tok_fd = tokens[:, -1:]
        out_ref, out_fd = [], []
        for _ in range(GEN):
            lr = ref.decode_step(tok_ref)
            tok_ref = lr.argmax(-1)[:, None].to(torch.int32)
            out_ref.append(tok_ref[:, 0].cpu().numpy())
            l0, l1 = eng.decode_step([tok_fd[:1], tok_fd[1:]])
            tok_fd = torch.cat([l0, l1]).argmax(-1)[:, None].to(torch.int32)
            out_fd.append(tok_fd[:, 0].cpu().numpy())
    finally:
        eng.close()

    out = {"colocated": np.stack(out_ref).T, "fastdecode": np.stack(out_fd).T}
    print("colocated :", out["colocated"].tolist())
    print("fastdecode:", out["fastdecode"].tolist())
    assert np.array_equal(out["colocated"], out["fastdecode"])
    print("OK — heterogeneous pipeline reproduces the single-device output.")
    return out


if __name__ == "__main__":
    main()
