"""Hopper dense flash-decode: the wrapper of kernel 2 in
``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``_kernel`` / ``decode_attention``): one query token per row against a
dense KV slab whose slots carry absolute positions (``pos``, -1 empty,
ring order for windowed caches).  The same CUDA source carries the int8
variant (``kernels/quant_kv.py``); both are bound by HBM bytes, and the
source's header describes the design.

A tensor on the CPU goes to the plain version (``kernels/ref.py``); a
CUDA tensor goes to the kernel or the call raises — there is no
fallback.  ``launches`` counts kernel launches and ``plain_calls`` CPU
calls of the plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import LaunchCounter

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# what configs/ needs; Dh 256 (recurrentgemma) is not ported
HEAD_DIMS = (64, 128)

launches = LaunchCounter()      # kernel launches on CUDA tensors
plain_calls = LaunchCounter()   # plain-version calls on CPU tensors

_fns = {}   # C entry point name -> the declared ctypes function


def _kernel_fn(name: str, n_ptrs: int):
    """A C entry point of csrc/decode_attention.cu (built on first use):
    ``n_ptrs`` pointers, then b, s, hq, hkv, dh, window, sink, softcap,
    scale, dtype and the stream."""
    if name not in _fns:
        from repro_torch.kernels import build
        fn = getattr(build.load("decode_attention"), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 7
                       + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check(q, k, v, pos, lengths, *, kv_dtype, scales=()):
    """Raise on what the dense kernels do not take.  q [B,Hq,Dh] fp32 or
    bf16; k, v [B,S,Hkv,Dh] of ``kv_dtype``; optional fp32 ``scales``
    [B,S,Hkv] (int8 storage); pos [B,S] and lengths [B] int32."""
    dev = q.device
    named = [("k", k), ("v", v), ("pos", pos), ("lengths", lengths)]
    named += [(f"scale{i}", s) for i, s in enumerate(scales)]
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} not supported (bf16 or fp32)")
    if k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise TypeError(f"k/v dtype {k.dtype}/{v.dtype} must be {kv_dtype}")
    if any(s.dtype != torch.float32 for s in scales):
        raise TypeError("scales must be float32")
    if pos.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("pos and lengths must be int32")
    if q.dim() != 3 or k.dim() != 4 or pos.dim() != 2 or lengths.dim() != 1:
        raise ValueError("expected q [B,Hq,Dh], k/v [B,S,Hkv,Dh], pos [B,S], "
                         "lengths [B]")
    b, hq, dh = q.shape
    _, s_len, hkv, dh2 = k.shape
    if v.shape != k.shape or dh2 != dh or k.shape[0] != b:
        raise ValueError(f"k/v shapes {tuple(k.shape)} / {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if pos.shape != (b, s_len) or lengths.shape != (b,):
        raise ValueError(f"pos {tuple(pos.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match [B,S]=[{b},"
                         f"{s_len}]")
    if any(s.shape != (b, s_len, hkv) for s in scales):
        raise ValueError(f"scales must be [B,S,Hkv]=[{b},{s_len},{hkv}]")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not supported by the kernel "
                         f"{HEAD_DIMS}")
    for name, t in [("q", q)] + named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # k and v are read with 16-byte vector loads; q, pos, lengths and the
    # scales with scalar loads (a worker's row slice may start anywhere)
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def decode_attention(q, k, v, pos, lengths, *, window: int = 0,
                     sink: int = 0, softcap: float = 0.0):
    """q [B,Hq,Dh]; k, v [B,S,Hkv,Dh] in q.dtype; pos [B,S] int32 (-1 =
    empty); lengths [B] int32 (position of this step's token).  Returns
    o [B,Hq,Dh] in q.dtype."""
    if q.device.type == "cpu":
        plain_calls.add()
        return ref.decode_attention_ref(q, k, v, pos, lengths, window=window,
                                        sink=sink, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, pos, lengths, kv_dtype=q.dtype)
    fn = _kernel_fn("repro_decode_attention", 6)
    b, hq, dh = q.shape
    _, s_len, hkv, _ = k.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), b, s_len, hq, hkv, dh,
                 int(window), int(sink), float(softcap), 1.0 / math.sqrt(dh),
                 _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed "
                           f"(cudaError {err})")
    launches.add()
    return out
