"""Hopper paged flash-decode and speculative-decode verify: the wrappers
of ``csrc/paged_attention.cu``.

Replace the Pallas TPU kernels of ``repro/kernels/paged_attention.py``:

* ``paged_decode_attention`` (kernel 1, ``_kernel``): one query token per
  row against a block-table KV page pool;
* ``paged_verify_attention`` (kernel 4, ``_verify_kernel``): T candidate
  tokens per row against the same pool in one sweep, query t of row b at
  position ``lengths[b] + t``.

Both run one CUDA template (one CTA per (row, kv-head, group of query
rows)), bound by HBM bytes (the K/V pages they read); split-K across
CTAs, cp.async/TMA page pipelining and several pages per tile are left to
a later PR.

A tensor on the CPU goes to the plain version (``kernels/ref.py``); a
CUDA tensor goes to the kernel or the call raises — there is no
fallback.  ``launches`` / ``verify_launches`` count kernel launches and
``plain_calls`` / ``verify_plain_calls`` CPU calls of the plain
versions, so a run can show which path it took.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from repro_torch.kernels import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class LaunchCounter:
    """A thread-safe count (R-worker threads launch concurrently)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def add(self) -> None:
        with self._lock:
            self.value += 1

    def reset(self) -> None:
        with self._lock:
            self.value = 0


launches = LaunchCounter()      # kernel 1 launches on CUDA tensors
plain_calls = LaunchCounter()   # kernel 1 plain-version calls (CPU)
verify_launches = LaunchCounter()     # kernel 4 launches on CUDA tensors
verify_plain_calls = LaunchCounter()  # kernel 4 plain-version calls (CPU)


_fn = {}    # C entry point name -> the declared function


def _kernel_fn(name: str = "repro_paged_decode_attention"):
    """A C entry point of csrc/paged_attention.cu (built on first use):
    the decode entry takes (pointers x6, b, hq, hkv, dh, page, mp,
    num_pages, window, sink, softcap, scale, dtype, stream); the verify
    entry takes T after b."""
    if name not in _fn:
        from repro_torch.kernels import build
        fn = getattr(build.load("paged_attention"), name)
        n_int = 10 if name == "repro_paged_verify_attention" else 9
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn[name] = fn
    return _fn[name]


def _check(q, pages_k, pages_v, tables, lengths, q_dims: int = 3):
    dev = q.device
    for name, t in (("pages_k", pages_k), ("pages_v", pages_v),
                    ("tables", tables), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} not supported (bf16 or fp32)")
    if pages_k.dtype != q.dtype or pages_v.dtype != q.dtype:
        raise TypeError(f"pool dtype {pages_k.dtype}/{pages_v.dtype} must "
                        f"equal q dtype {q.dtype}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("tables and lengths must be int32")
    if q.dim() != q_dims or pages_k.dim() != 4 or tables.dim() != 2 \
            or lengths.dim() != 1:
        raise ValueError(f"expected q [B,{'T,' if q_dims == 4 else ''}"
                         f"Hq,Dh], pages [P,page,Hkv,Dh], tables [B,MP], "
                         f"lengths [B]")
    b, hq, dh = q.shape[0], q.shape[-2], q.shape[-1]
    _, page, hkv, dh2 = pages_k.shape
    if pages_v.shape != pages_k.shape or dh2 != dh:
        raise ValueError(f"pool shapes {tuple(pages_k.shape)} / "
                         f"{tuple(pages_v.shape)} do not match q {tuple(q.shape)}")
    if tables.shape[0] != b or lengths.shape[0] != b:
        raise ValueError("tables/lengths batch differs from q")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if dh not in (64, 128):
        raise ValueError(f"head_dim {dh} not supported by the kernel "
                         f"(64 or 128)")
    for name, t in (("q", q), ("pages_k", pages_k), ("pages_v", pages_v),
                    ("tables", tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # q and the pool are read with 8/16-byte vector loads; tables and
    # lengths with scalar loads (a worker's row slice of lengths may start
    # at any int32)
    for name, t in (("q", q), ("pages_k", pages_k), ("pages_v", pages_v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_decode_attention(q, pages_k, pages_v, tables, lengths, *,
                           window: int = 0, sink: int = 0,
                           softcap: float = 0.0):
    """q [B,Hq,Dh]; pages_k/v [P,page,Hkv,Dh]; tables [B,MP] int32 (-1 =
    unmapped); lengths [B] int32 (position of this step's token).
    Returns o [B,Hq,Dh] in q.dtype."""
    if q.device.type == "cpu":
        plain_calls.add()
        return ref.paged_decode_attention_ref(
            q, pages_k, pages_v, tables, lengths, window=window, sink=sink,
            softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, pages_k, pages_v, tables, lengths)
    fn = _kernel_fn()
    b, hq, dh = q.shape
    n_pages, page, hkv, _ = pages_k.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, hq, hkv, dh, page, tables.shape[1], n_pages,
            int(window), int(sink), float(softcap), 1.0 / math.sqrt(dh),
            _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed "
                           f"(cudaError {err})")
    launches.add()
    return out


def paged_verify_attention(q, pages_k, pages_v, tables, lengths, *,
                           window: int = 0, sink: int = 0,
                           softcap: float = 0.0):
    """q [B,T,Hq,Dh]; pages_k/v [P,page,Hkv,Dh]; tables [B,MP] int32 (-1 =
    unmapped; MP is taken from the tables given, which may be cut to the
    used pages); lengths [B] int32 = tokens before the verify step (query
    t attends positions <= lengths[b] + t).  Returns o [B,T,Hq,Dh] in
    q.dtype."""
    if q.device.type == "cpu":
        verify_plain_calls.add()
        return ref.paged_verify_attention_ref(
            q, pages_k, pages_v, tables, lengths, window=window, sink=sink,
            softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, pages_k, pages_v, tables, lengths, q_dims=4)
    fn = _kernel_fn("repro_paged_verify_attention")
    b, t, hq, dh = q.shape
    n_pages, page, hkv, _ = pages_k.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, t, hq, hkv, dh, page, tables.shape[1], n_pages,
            int(window), int(sink), float(softcap), 1.0 / math.sqrt(dh),
            _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_verify_attention kernel launch failed "
                           f"(cudaError {err})")
    verify_launches.add()
    return out
