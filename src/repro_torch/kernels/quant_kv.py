"""Int8-quantized KV (paper §5.2): the quantization helpers and the
wrapper of kernel 3 in ``csrc/decode_attention.cu``.

KV is stored as int8 with one fp32 scale per (token, kv-head), symmetric
amax/127 — the quantization the paper suggests to cut R-worker memory
traffic (2·(Dh·1 B + 4 B) per token and kv-head against 2·Dh·2 B in bf16,
~3.9x fewer bytes at Dh 128).  The kernel replaces the Pallas TPU kernel
``repro/kernels/quant_kv.py`` (``_kernel`` / ``decode_attention_int8``):
it dequantizes in fp32 and otherwise computes what kernel 2
(``kernels/decode_attention.py``) does.

A tensor on the CPU goes to the plain version (``kernels/ref.py``); a
CUDA tensor goes to the kernel or the call raises — there is no
fallback.  ``launches`` counts kernel launches and ``plain_calls`` CPU
calls of the plain version.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import LaunchCounter

launches = LaunchCounter()      # kernel launches on CUDA tensors
plain_calls = LaunchCounter()   # plain-version calls on CPU tensors


# ---------------------------------------------------------------------------
# quantization helpers (used by the serving caches)
# ---------------------------------------------------------------------------
def quantize_kv(x):
    """x [..., Dh] -> (int8 values, fp32 scales [...]), symmetric per
    vector: scale = max(amax, 1e-8) / 127, round half to even, clip to
    ±127 — bit-identical to the JAX package's on the same inputs."""
    x32 = x.to(torch.float32)
    amax = x32.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale):
    return q.to(torch.float32) * scale[..., None]


# ---------------------------------------------------------------------------
# kernel 3
# ---------------------------------------------------------------------------
def decode_attention_int8(q, k_q, k_scale, v_q, v_scale, pos, lengths, *,
                          window: int = 0, sink: int = 0,
                          softcap: float = 0.0):
    """q [B,Hq,Dh] bf16/fp32; k_q, v_q int8 [B,S,Hkv,Dh]; k_scale,
    v_scale fp32 [B,S,Hkv]; pos [B,S] int32; lengths [B] int32.  Returns
    o [B,Hq,Dh] in q.dtype.  The plain version rounds the dequantized K/V
    to q.dtype (as the JAX reference does); the kernel keeps them fp32
    (as the TPU kernel does), so in bf16 the two differ by that rounding."""
    if q.device.type == "cpu":
        plain_calls.add()
        return ref.decode_attention_int8_ref(
            q, k_q, k_scale, v_q, v_scale, pos, lengths, window=window,
            sink=sink, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _da._check(q, k_q, v_q, pos, lengths, kv_dtype=torch.int8,
               scales=(k_scale, v_scale))
    fn = _da._kernel_fn("repro_decode_attention_int8", 8)
    b, hq, dh = q.shape
    _, s_len, hkv, _ = k_q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(),
                 v_q.data_ptr(), v_scale.data_ptr(), pos.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), b, s_len, hq, hkv, dh,
                 int(window), int(sink), float(softcap), 1.0 / math.sqrt(dh),
                 _da._DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_int8 kernel launch failed "
                           f"(cudaError {err})")
    launches.add()
    return out
