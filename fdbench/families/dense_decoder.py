"""A dense decoder of self-attention (MHA or GQA) and a GELU MLP or SwiGLU
FFN: how a configuration file of this family becomes the port's
``ModelConfig``, and the weights the benchmark draws for it.

The weights are the benchmark's inputs, handed alike to the port and to
the reference (``reference/dense_decoder.py``).  They are drawn on the
device from the seed in one call, in the type they are served in, as one
flat buffer that the leaves view in the layout the port's engine takes:
``embed`` [V, d], ``final_norm`` [d], ``lm_head`` [d, V], and one stack
``s0`` of [L, ...] leaves (``ln1``, ``wq``, ``wk``, ``wv``, ``wo``,
``ln2`` and the FFN's), with no remainder blocks.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

STD = 0.02
NORM_STD = 0.1          # norm scales: the port's RMSNorm gain is 1 + scale


def sizes(cfg: Dict) -> Dict:
    """The family's sizes from a configuration file, whatever the source's
    key names."""
    d = cfg["hidden_size"]
    hq = cfg["num_attention_heads"]
    return {
        "d": d, "hq": hq, "hkv": cfg.get("num_key_value_heads", hq),
        "dh": cfg.get("head_dim", d // hq),
        "ff": cfg.get("intermediate_size", cfg.get("ffn_dim")),
        "vocab": cfg["vocab_size"], "layers": cfg["num_hidden_layers"],
        "act": cfg.get("hidden_act", cfg.get("activation_function")),
        "eps": cfg.get("rms_norm_eps", 1e-6),
        "theta": cfg.get("rope_theta", 10000.0),
        "dtype": cfg.get("torch_dtype", "bfloat16"),
    }


def program_config(cfg: Dict):
    """The port's ModelConfig of this configuration."""
    from repro_torch.core.config import (ATTN, FFN_MLP, FFN_SWIGLU,
                                         ModelConfig)
    s = sizes(cfg)
    ffn = {"silu": FFN_SWIGLU, "gelu_tanh": FFN_MLP}[s["act"]]
    return ModelConfig(
        name=cfg["name"], arch_type="dense", num_layers=s["layers"],
        d_model=s["d"], num_heads=s["hq"], num_kv_heads=s["hkv"],
        head_dim=s["dh"], d_ff=s["ff"], vocab_size=s["vocab"],
        layer_pattern=(ATTN,), ffn_kind=ffn, rope_theta=s["theta"],
        norm_eps=s["eps"], tie_embeddings=False, dtype=s["dtype"],
        source=cfg["source"])


def _matrices(s: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, std) of every drawn leaf, in draw order; the output
    projections scaled down by sqrt(2L)."""
    d, L, ff = s["d"], s["layers"], s["ff"]
    qw, kw = s["hq"] * s["dh"], s["hkv"] * s["dh"]
    out_std = STD / math.sqrt(2.0 * L)
    mats = [("embed", (s["vocab"], d), STD),
            ("lm_head", (d, s["vocab"]), STD),
            ("wq", (L, d, qw), STD), ("wk", (L, d, kw), STD),
            ("wv", (L, d, kw), STD), ("wo", (L, qw, d), out_std)]
    if s["act"] == "silu":
        mats += [("ffn_w_gate", (L, d, ff), STD), ("ffn_w_up", (L, d, ff), STD),
                 ("ffn_w_down", (L, ff, d), out_std)]
    else:
        mats += [("ffn_w_in", (L, d, ff), STD),
                 ("ffn_w_out", (L, ff, d), out_std)]
    return mats


def weight_bytes(cfg: Dict) -> int:
    s = sizes(cfg)
    el = 2 if s["dtype"] == "bfloat16" else 4
    return sum(math.prod(shp) for _, shp, _ in _matrices(s)) * el


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """The weights of ``cfg`` from ``seed``, drawn on ``device`` by a
    generator there: one normal draw for every matrix, scaled in place per
    leaf, and one float32 draw for every norm scale, N(0, 0.1)."""
    s = sizes(cfg)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[s["dtype"]]
    device = torch.device(device)
    mats = _matrices(s)
    total = sum(math.prod(shp) for _, shp, _ in mats)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    leaves, off = {}, 0
    for name, shp, std in mats:
        n = math.prod(shp)
        leaves[name] = flat[off:off + n].view(shp).mul_(std)
        off += n
    d, L = s["d"], s["layers"]
    norms = torch.randn((2 * L + 1) * d, generator=gen, dtype=torch.float32,
                        device=device).mul_(NORM_STD)
    stack = {"ln1": norms[:L * d].view(L, d),
             "ln2": norms[L * d:2 * L * d].view(L, d)}
    stack.update({k: v for k, v in leaves.items()
                  if k not in ("embed", "lm_head")})
    return {"embed": leaves["embed"], "final_norm": norms[2 * L * d:],
            "lm_head": leaves["lm_head"], "stack": {"s0": stack}, "rem": []}
