"""Hopper paged flash-decode and speculative-decode verify: the wrappers
of ``csrc/paged_attention.cu``.

Replace the Pallas TPU kernels of ``repro/kernels/paged_attention.py``:

* ``paged_decode_attention`` (kernel 1, ``_kernel``): one query token per
  row against a block-table KV page pool;
* ``paged_verify_attention`` (kernel 4, ``_verify_kernel``): T candidate
  tokens per row against the same pool in one sweep, query t of row b at
  position ``lengths[b] + t``.

Both run one CUDA template, bound by HBM bytes (the K/V pages they read):
split-K over the page list (``split_plan`` chooses the split from shapes
alone, so no host sync), a cp.async ring of K/V tiles in shared memory,
scores per tile (tensor cores in bf16: kernel 1 on ``csrc/tc_decode.cuh``'s
engine, shared with kernel 2, kernel 4 on its own; CUDA cores in fp32),
and, with more than one split, a merge kernel launched by the same C call.
The source note of ``csrc/paged_attention.cu`` has the design.

A tensor on the CPU goes to the plain version (``kernels/ref.py``); a
CUDA tensor goes to the kernel or the call raises — there is no
fallback.  ``launches`` / ``verify_launches`` count kernel launches (one
per wrapper call), ``merge_launches`` the merge kernels those calls
added, and ``plain_calls`` / ``verify_plain_calls`` CPU calls of the
plain versions, so a run can show which path it took.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import threading

import torch

from repro_torch.kernels import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


_tally = threading.local()


class LaunchCounter:
    """A thread-safe count (R-worker threads launch concurrently).

    Inside ``tally()`` a thread's adds go to that thread's tally instead
    (a CUDA-graph capture records launches it does not make)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def add(self, n: int = 1) -> None:
        counts = getattr(_tally, "counts", None)
        if counts is not None:
            counts[self] = counts.get(self, 0) + n
            return
        with self._lock:
            self.value += n

    def reset(self) -> None:
        with self._lock:
            self.value = 0


@contextlib.contextmanager
def tally():
    """Collect this thread's counter adds in a {counter: n} dict, applied
    to no counter; other threads count as usual."""
    prev = getattr(_tally, "counts", None)
    counts: dict = {}
    _tally.counts = counts
    try:
        yield counts
    finally:
        _tally.counts = prev


launches = LaunchCounter()      # kernel 1 launches on CUDA tensors
plain_calls = LaunchCounter()   # kernel 1 plain-version calls (CPU)
verify_launches = LaunchCounter()     # kernel 4 launches on CUDA tensors
verify_plain_calls = LaunchCounter()  # kernel 4 plain-version calls (CPU)
merge_launches = LaunchCounter()  # merge kernels launched by those calls


# ---------------------------------------------------------------------------
# the split plan (flash-decoding): from shapes only, never from lengths,
# which live on the card, so it needs no host sync
# ---------------------------------------------------------------------------
MAX_ROWS_DECODE = 8       # query rows per CTA, as csrc/paged_attention.cu
MAX_ROWS_VERIFY = 16
SPLIT_CTAS_PER_SM = 2     # aim: this many CTAs of a split grid per SM
# a split reads at least one 64-row tile of the bf16 decode's tensor-core
# engine (two 32-row tiles of kernel 4's and of the fp32 CUDA-core engine)
SPLIT_MIN_TOKENS = 64
MAX_SPLIT_PAGES = 2048    # table entries one CTA stages (kMaxSplitPages)


def row_groups(t: int, g: int) -> int:
    """CTAs per (row, kv-head) along the query rows: T*G rows, at most 8
    per CTA for a decode (T = 1: the bf16 tensor-core engine's one n8
    tile at every G; fp32 in CTAs of 1, 2, 4 or 8) and 16 for a verify."""
    cap = MAX_ROWS_DECODE if t == 1 else MAX_ROWS_VERIFY
    return -(-t * g // cap)


@functools.lru_cache(maxsize=None)
def split_plan(b: int, hkv: int, groups: int, mp: int, page: int,
               sm_count: int):
    """(pages_per_split, num_splits) for a grid of b*hkv*groups CTAs over
    ``mp`` table pages of ``page`` slots.  One split where that grid
    already fills the SMs; otherwise enough splits to put about
    ``SPLIT_CTAS_PER_SM`` CTAs on every SM, each split at least
    ``SPLIT_MIN_TOKENS`` positions long.  Split s owns table pages
    [s*pages_per_split, (s+1)*pages_per_split): every page once, and no
    split lies wholly past the table."""
    return capped_split_plan(b, hkv, groups, mp, page, sm_count,
                             MAX_SPLIT_PAGES)


@functools.lru_cache(maxsize=None)
def capped_split_plan(b: int, hkv: int, groups: int, mp: int, page: int,
                      sm_count: int, max_split: int, one_wave: bool = False):
    """``split_plan`` with at most ``max_split`` pages per split (the
    entries one CTA stages); the dense kernels count slab slots as pages
    of one (``decode_attention.slab_plan``).  ``one_wave``: at most
    ``SPLIT_CTAS_PER_SM`` CTAs per SM (splits rounded down, not up, so no
    SM takes a third CTA while others hold two)."""
    ctas = b * hkv * groups
    pps = mp
    if ctas < sm_count:
        want = (SPLIT_CTAS_PER_SM * sm_count // ctas if one_wave
                else -(-SPLIT_CTAS_PER_SM * sm_count // ctas))
        pps = max(-(-mp // want), -(-SPLIT_MIN_TOKENS // page))
    pps = max(1, min(pps, mp, max_split))
    return pps, -(-mp // pps)


_SM_COUNT = {}      # CUDA device -> multiprocessor count


def sm_count(dev: torch.device) -> int:
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SM_COUNT[dev]


def kernel_plan(q, pages_k, tables, t: int = 1):
    """The split plan a call with these tensors launches (shapes only)."""
    b, hq = q.shape[0], q.shape[-2]
    hkv, page = pages_k.shape[2], pages_k.shape[1]
    return split_plan(b, hkv, row_groups(t, hq // hkv), tables.shape[1],
                      page, sm_count(q.device))


ENTRIES = ("repro_paged_decode_attention", "repro_paged_verify_attention",
           "repro_paged_attention_ctas_per_sm")
_fns = {}   # C entry point name -> the declared function


def declare(lib, name: str):
    """The C entry point ``name`` of a library built from
    csrc/paged_attention.cu (this tree's or another of the same C ABI),
    its argument and result types declared: the decode entry takes
    (pointers x6, b, hq, hkv, dh, page, mp, num_pages, window, sink,
    softcap, scale, dtype, pages_per_split, num_splits, scratch, stream);
    the verify entry takes T after b; ``repro_paged_attention_ctas_per_sm``
    takes (T, hq, hkv, dh, dtype, pages_per_split, int* out)."""
    fn = getattr(lib, name)
    if name == "repro_paged_attention_ctas_per_sm":
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    else:
        n_int = 10 if name == "repro_paged_verify_attention" else 9
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def _kernel_fn(name: str = "repro_paged_decode_attention"):
    """A C entry point of csrc/paged_attention.cu, built on first use."""
    if name not in _fns:
        from repro_torch.kernels import build
        _fns[name] = declare(build.load("paged_attention"), name)
    return _fns[name]


def ctas_per_sm(t: int, hq: int, hkv: int, dh: int, dtype,
                pages_per_split: int) -> int:
    """CTAs of the instantiation such a call launches that fit on one SM
    (the CUDA occupancy calculator on the built kernel): the bf16 decode's
    tensor-core engine 3 at Dh 128 (a 64 KB ring) and 4 at Dh 64."""
    out = ctypes.c_int(0)
    err = _kernel_fn("repro_paged_attention_ctas_per_sm")(
        t, hq, hkv, dh, _DTYPES[dtype], pages_per_split, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"occupancy query failed (cudaError {err})")
    return out.value


def _check(q, pages_k, pages_v, tables, lengths, q_dims: int = 3):
    dev = q.device
    if not (pages_k.device == dev and pages_v.device == dev
            and tables.device == dev and lengths.device == dev):
        raise ValueError(f"pool/tables/lengths on {pages_k.device}/"
                         f"{tables.device}/{lengths.device}, q on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} not supported (bf16 or fp32)")
    if pages_k.dtype != q.dtype or pages_v.dtype != q.dtype:
        raise TypeError(f"pool dtype {pages_k.dtype}/{pages_v.dtype} must "
                        f"equal q dtype {q.dtype}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("tables and lengths must be int32")
    qs, ps, ts = q.shape, pages_k.shape, tables.shape
    if len(qs) != q_dims or len(ps) != 4 or len(ts) != 2 \
            or lengths.dim() != 1:
        raise ValueError(f"expected q [B,{'T,' if q_dims == 4 else ''}"
                         f"Hq,Dh], pages [P,page,Hkv,Dh], tables [B,MP], "
                         f"lengths [B]")
    if pages_v.shape != ps or ps[3] != qs[-1]:
        raise ValueError(f"pool shapes {tuple(ps)} / "
                         f"{tuple(pages_v.shape)} do not match q {tuple(qs)}")
    if ts[0] != qs[0] or lengths.shape[0] != qs[0]:
        raise ValueError("tables/lengths batch differs from q")
    if qs[-2] % ps[2]:
        raise ValueError(f"Hq={qs[-2]} is not a multiple of Hkv={ps[2]}")
    if qs[-1] not in (64, 128):
        raise ValueError(f"head_dim {qs[-1]} not supported by the kernel "
                         f"(64 or 128)")
    if not (q.is_contiguous() and pages_k.is_contiguous()
            and pages_v.is_contiguous() and tables.is_contiguous()
            and lengths.is_contiguous()):
        raise ValueError("q, pages_k, pages_v, tables and lengths must be "
                         "contiguous")
    # q and the pool are read with 16-byte vector loads; tables and
    # lengths with scalar loads (a worker's row slice of lengths may start
    # at any int32)
    if (q.data_ptr() | pages_k.data_ptr() | pages_v.data_ptr()) % 16:
        raise ValueError("q, pages_k and pages_v must be 16-byte aligned")


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
    out = _launch(_kernel_fn(), q, pages_k, pages_v, tables, lengths,
                  window, sink, softcap, t=1)
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
    out = _launch(_kernel_fn("repro_paged_verify_attention"), q, pages_k,
                  pages_v, tables, lengths, window, sink, softcap,
                  t=q.shape[1])
    verify_launches.add()
    return out


def _launch(fn, q, pages_k, pages_v, tables, lengths, window, sink,
            softcap, *, t: int):
    """One C call: the attention kernel and, with more than one split,
    the merge kernel, on the current stream; raises on a nonzero
    cudaError.  Scratch for the splits' partials (fp32 m, l and acc[Dh]
    per split and query row) comes from the caching allocator."""
    b, hq, dh = q.shape[0], q.shape[-2], q.shape[-1]
    n_pages, page, hkv, _ = pages_k.shape
    dev = q.device
    pps, n_splits = kernel_plan(q, pages_k, tables, t)
    out = torch.empty_like(q)
    scratch = (torch.empty(n_splits * b * t * hq * (dh + 2),
                           dtype=torch.float32, device=dev)
               if n_splits > 1 else None)
    args = (q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            *((b, t) if q.dim() == 4 else (b,)),    # verify: T after b
            hq, hkv, dh, page, tables.shape[1], n_pages, int(window),
            int(sink), float(softcap), 1.0 / math.sqrt(dh),
            _DTYPES[q.dtype], pps, n_splits,
            None if scratch is None else scratch.data_ptr())
    # the launch goes to the current stream of q's device (a worker's own
    # stream), with that device current
    if torch.cuda.current_device() == dev.index:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"paged attention kernel launch failed "
                           f"(cudaError {err})")
    if n_splits > 1:
        merge_launches.add()
    return out
