"""Hopper dense flash-decode: the wrapper of kernel 2 in
``csrc/decode_attention.cu``, and the launch code it shares with kernel
3's wrappers (``kernels/quant_kv.py``).

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``_kernel`` / ``decode_attention``): one query token per row against a
dense KV slab whose slots carry absolute positions (``pos``, -1 empty,
ring order for windowed caches).  The same CUDA source carries the int8
variant over a slab and over a page pool.  All are bound by HBM bytes:
split-K over the slots (``slab_plan`` chooses the split from shapes
alone, so no host sync), a cp.async ring of K/V tiles, scores per tile
(a bf16 q on the tensor cores: ``csrc/tc_decode.cuh``'s engine for bf16
K/V, kernel 1's too; an fp32 q on the CUDA cores), and, with more than
one split, a merge kernel launched by the same C call.  The source's
header has the design.

A tensor on the CPU goes to the plain version (``kernels/ref.py``); a
CUDA tensor goes to the kernel or the call raises — there is no
fallback.  ``launches`` counts kernel launches, ``plain_calls`` CPU
calls of the plain version, and ``merge_launches`` the merge kernels
that calls of this source's entries (kernels 2 and 3) added.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import LaunchCounter

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims of kernels 1, 2 and 4 and of kernel 3's paged entries;
# kernel 3's slab entry also takes recurrentgemma's 256 (its windowed
# layers stay on the dense slab, and quantized_kv reaches only that entry)
HEAD_DIMS = (64, 128)
INT8_SLAB_HEAD_DIMS = (64, 128, 256)
MAX_SPLIT_SLOTS = 8192    # pos or table entries one CTA stages (kMaxSplitIdx)

launches = LaunchCounter()      # kernel launches on CUDA tensors
plain_calls = LaunchCounter()   # plain-version calls on CPU tensors
merge_launches = LaunchCounter()  # merges added by kernels 2 and 3's calls

# C entry point -> (pointers before the output, ints between the output
# and softcap): each then takes softcap, scale, dtype, per_split,
# num_splits, scratch and the stream
_ENTRIES = {"repro_decode_attention": (5, 7),
            "repro_decode_attention_int8": (7, 7),
            "repro_paged_decode_attention_int8": (7, 9),
            "repro_paged_verify_attention_int8": (7, 10)}
_OCCUPANCY = "repro_decode_attention_occupancy"
_fns = {}   # C entry point name -> the declared ctypes function


def declare(lib, name: str):
    """The C entry point ``name`` of a library built from
    csrc/decode_attention.cu (this tree's or another of the same C ABI),
    its argument and result types declared: the entries of ``_ENTRIES``,
    and ``repro_decode_attention_occupancy``, which takes (kv_int8, paged,
    T, hq, hkv, dh, dtype, per_split, int* rows_per_cta, int*
    ctas_per_sm)."""
    fn = getattr(lib, name)
    if name == _OCCUPANCY:
        fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
    else:
        n_ptrs, n_int = _ENTRIES[name]
        fn.argtypes = ([ctypes.c_void_p] * (n_ptrs + 1)
                       + [ctypes.c_int] * n_int + [ctypes.c_float] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def _kernel_fn(name: str):
    """A C entry point of csrc/decode_attention.cu, built on first use."""
    if name not in _fns:
        from repro_torch.kernels import build
        _fns[name] = declare(build.load("decode_attention"), name)
    return _fns[name]


def occupancy(*, kv_int8: bool, paged: bool, t: int, hq: int, hkv: int,
              dh: int, dtype, per_split: int):
    """(query rows per CTA, CTAs per SM) of the instantiation such a call
    launches (kernel 2, or kernel 3's slab, paged or multi-token entry),
    from the C side's own choice and the CUDA occupancy calculator on the
    built kernel at that staged index.  Kernel 2 with a bf16 q at G 2 and
    up: 8 rows on the tensor-core engine (3 CTAs per SM at Dh 128, its ring
    2 stages of 64 rows, 64 KB; 4 at Dh 64); at G 1 and with an fp32 q the
    smallest of 1, 2, 4 and 8 that holds G (the CUDA cores)."""
    rows, ctas = ctypes.c_int(0), ctypes.c_int(0)
    err = _kernel_fn(_OCCUPANCY)(int(kv_int8), int(paged), t, hq, hkv, dh,
                                 _DTYPES[dtype], per_split,
                                 ctypes.addressof(rows),
                                 ctypes.addressof(ctas))
    if err != 0:
        raise RuntimeError(f"occupancy query failed (cudaError {err})")
    return rows.value, ctas.value


# ---------------------------------------------------------------------------
# the split plan over a slab: slots counted as pages of one, shapes only
# ---------------------------------------------------------------------------
def slab_plan(b: int, hkv: int, g: int, s_len: int, sm_count: int):
    """(slots_per_split, num_splits) of a kernel-2 call: one split when the
    b*hkv*row_groups CTAs (up to 8 query heads each, as kernel 1's
    decode) fill the SMs, else splits of >= 64 slots (one tile of the
    tensor-core engine with a bf16 q, two of the CUDA-core engine's 32
    rows with an fp32 q) for about 2 CTAs per SM
    (``paged_attention.capped_split_plan`` over pages of one slot), at
    most ``MAX_SPLIT_SLOTS`` slots each.  Kernel 3's slab entry groups its
    rows by ``quant_kv.slab_row_groups`` (``quant_kv.slab_plan``)."""
    return _pa.capped_split_plan(b, hkv, _pa.row_groups(1, g), s_len, 1,
                                 sm_count, MAX_SPLIT_SLOTS)


def kernel_plan(q, k):
    """The split plan a kernel-2 call with these tensors launches."""
    b, hq, _ = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    return slab_plan(b, hkv, hq // hkv, s_len, _pa.sm_count(q.device))


def launch(name: str, q, ptrs, ints, plan, *, window, sink, softcap):
    """One C call: the attention kernel and, with more than one split,
    the merge kernel, on the current stream of q's device; raises on a
    nonzero cudaError.  ``ptrs`` are the inputs' pointers, ``ints`` the
    shape arguments before window and sink.  Scratch for the splits'
    partials (fp32 m, l and acc[Dh] per split and query row) comes from
    the caching allocator; q is [B,Hq,Dh], or [B,T,Hq,Dh] for the
    multi-token entry."""
    dh = q.shape[-1]
    per_split, n_splits = plan
    dev = q.device
    out = torch.empty_like(q)
    scratch = (torch.empty(n_splits * q.numel() // dh * (dh + 2),
                           dtype=torch.float32, device=dev)
               if n_splits > 1 else None)
    args = (*ptrs, out.data_ptr(), *ints, int(window), int(sink),
            float(softcap), 1.0 / math.sqrt(dh), _DTYPES[q.dtype],
            per_split, n_splits,
            None if scratch is None else scratch.data_ptr())
    fn = _kernel_fn(name)
    if torch.cuda.current_device() == dev.index:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {err})")
    if n_splits > 1:
        merge_launches.add()
    return out


def _check(q, k, v, pos, lengths, *, kv_dtype, scales=(),
           head_dims=HEAD_DIMS):
    """Raise on what the dense kernels do not take.  q [B,Hq,Dh] fp32 or
    bf16 with Dh in ``head_dims``; k, v [B,S,Hkv,Dh] of ``kv_dtype``;
    optional fp32 ``scales`` [B,S,Hkv] (int8 storage); pos [B,S] and
    lengths [B] int32."""
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
    if s_len == 0:
        raise ValueError("the slab has no slot (S = 0)")
    if pos.shape != (b, s_len) or lengths.shape != (b,):
        raise ValueError(f"pos {tuple(pos.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match [B,S]=[{b},"
                         f"{s_len}]")
    if any(s.shape != (b, s_len, hkv) for s in scales):
        raise ValueError(f"scales must be [B,S,Hkv]=[{b},{s_len},{hkv}]")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if dh not in head_dims:
        raise ValueError(f"head_dim {dh} not supported by the kernel "
                         f"{head_dims}")
    for name, t in [("q", q)] + named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # k and v are copied in 16-byte pieces; q, pos, lengths and the scales
    # with element loads (a worker's row slice may start anywhere)
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
    b, hq, dh = q.shape
    _, s_len, hkv, _ = k.shape
    out = launch("repro_decode_attention", q,
                 (q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                  lengths.data_ptr()), (b, s_len, hq, hkv, dh),
                 kernel_plan(q, k), window=window, sink=sink,
                 softcap=softcap)
    launches.add()
    return out
