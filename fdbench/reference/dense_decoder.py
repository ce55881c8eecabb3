"""The plain reference of the dense decoder family, in float32 with TF32
off: token embedding; per layer RMSNorm with a (1 + scale) gain, q/k/v
projections, RoPE over interleaved pairs, causal softmax attention with
grouped kv heads, the output projection and the residual, RMSNorm, a
tanh-GELU MLP or a SwiGLU, the residual; the final RMSNorm and the head.

It reads only the weights the benchmark drew (the same tensors the port
serves) and a configuration file's sizes, and works every state out again
from the tokens: there is no cache.  Sequences run layer by layer, each
layer's weights converted to float32 once, and attention in blocks of
queries, so that the whole fits beside the weights on one card.

``quant="fp8"`` is the control: every matrix product takes its inputs
rounded to float8 e4m3 (weights per output column, activations per row,
each scaled by its largest magnitude over 448) and multiplies in float32;
attention, norms and the embedding stay float32.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

F32 = torch.float32
E4M3_MAX = 448.0
Q_BLOCK = 256


def _sizes(cfg: Dict) -> Dict:
    d = cfg["hidden_size"]
    hq = cfg["num_attention_heads"]
    return {"d": d, "hq": hq, "hkv": cfg.get("num_key_value_heads", hq),
            "dh": cfg.get("head_dim", d // hq),
            "layers": cfg["num_hidden_layers"],
            "act": cfg.get("hidden_act", cfg.get("activation_function")),
            "eps": cfg.get("rms_norm_eps", 1e-6),
            "theta": cfg.get("rope_theta", 10000.0)}


@contextmanager
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fake_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` (float32) rounded to float8 e4m3 with one scale per slice
    along ``dim`` (the slice's largest magnitude maps to 448)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(F32) * scale


def _mm(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]):
    if quant == "fp8":
        x = fake_fp8(x, -1)
    return x @ w


def _weight(w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    w = w.to(F32)
    return fake_fp8(w, 0) if quant == "fp8" else w


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.to(F32))


def rope(x, theta: float):
    """x [T, H, Dh] at positions 0..T-1; pairs (0, 1), (2, 3), ..."""
    t, _, dh = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=F32,
                                        device=x.device) / dh))
    ang = torch.arange(t, dtype=F32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def attention(q, k, v):
    """Causal attention: q [T, Hq, Dh], k/v [T, Hkv, Dh] -> [T, Hq, Dh]."""
    t, hq, dh = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    kk = k.permute(1, 0, 2)                          # [Hkv, T, Dh]
    vv = v.permute(1, 0, 2)
    out = torch.empty_like(q)
    for lo in range(0, t, Q_BLOCK):
        hi = min(t, lo + Q_BLOCK)
        qb = q[lo:hi].reshape(hi - lo, hkv, g, dh).permute(1, 2, 0, 3)
        s = torch.matmul(qb, kk[:, None].transpose(-1, -2)[..., :hi]) \
            / math.sqrt(dh)                          # [Hkv, G, b, hi]
        mask = (torch.arange(hi, device=q.device)[None, :]
                <= torch.arange(lo, hi, device=q.device)[:, None])
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.matmul(p, vv[:, None, :hi])        # [Hkv, G, b, Dh]
        out[lo:hi] = o.permute(2, 0, 1, 3).reshape(hi - lo, hq, dh)
    return out


def _block(h, w: Dict, s: Dict, quant):
    t = h.shape[0]
    hn = rms_norm(h, w["ln1"], s["eps"])
    q = _mm(hn, w["wq"], quant).view(t, s["hq"], s["dh"])
    k = _mm(hn, w["wk"], quant).view(t, s["hkv"], s["dh"])
    v = _mm(hn, w["wv"], quant).view(t, s["hkv"], s["dh"])
    o = attention(rope(q, s["theta"]), rope(k, s["theta"]), v)
    h = h + _mm(o.reshape(t, -1), w["wo"], quant)
    hn = rms_norm(h, w["ln2"], s["eps"])
    if s["act"] == "silu":
        f = F.silu(_mm(hn, w["ffn_w_gate"], quant)) \
            * _mm(hn, w["ffn_w_up"], quant)
        f = _mm(f, w["ffn_w_down"], quant)
    else:
        f = F.gelu(_mm(hn, w["ffn_w_in"], quant), approximate="tanh")
        f = _mm(f, w["ffn_w_out"], quant)
    return h + f


def logits(params: Dict, cfg: Dict, seqs: Sequence[torch.Tensor],
           starts: Sequence[int], quant: Optional[str] = None
           ) -> List[torch.Tensor]:
    """For each token sequence ``seqs[i]`` (1-D ids, on the weights'
    device), the float32 logits [len - starts[i], V] at positions
    starts[i] .. len - 1: what each of those positions predicts next."""
    s = _sizes(cfg)
    stack = params["stack"]["s0"]
    with torch.no_grad(), no_tf32():
        hs = [params["embed"][x.long()].to(F32) for x in seqs]
        for li in range(s["layers"]):
            w = {k: (_weight(v[li], quant) if v[li].dim() == 2
                     else v[li].to(F32)) for k, v in stack.items()}
            hs = [_block(h, w, s, quant) for h in hs]
            del w
        head = _weight(params["lm_head"], quant)
        out = []
        for h, st in zip(hs, starts):
            hn = rms_norm(h[st:], params["final_norm"], s["eps"])
            out.append(_mm(hn, head, quant))
        return out
