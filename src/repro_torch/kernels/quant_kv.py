"""Int8-quantized KV (paper §5.2): the quantization helpers and the
wrappers of kernel 3 in ``csrc/decode_attention.cu``, over a dense slab
and over a block-table page pool.

KV is stored as int8 with one fp32 scale per (token, kv-head), symmetric
amax/127 — the quantization the paper suggests to cut R-worker memory
traffic (2·(Dh·1 B + 4 B) per token and kv-head against 2·Dh·2 B in bf16,
~3.9x fewer bytes at Dh 128).  The kernel replaces the Pallas TPU kernel
``repro/kernels/quant_kv.py`` (``_kernel`` / ``decode_attention_int8``):
it dequantizes exactly and otherwise computes what kernel 2
(``kernels/decode_attention.py``) does.  ``paged_decode_attention_int8``
computes ``repro/kernels/ops.py``'s function of the same name (gather the
int8 pages into a slab, then kernel 3) as one call of kernel 3's paged
entry, which reads the pages and scales through the block table.
``paged_verify_attention_int8`` computes ``repro/kernels/ops.py``'s
function of the same name (the int8 pages gathered into a slab, then the
multi-token int8 reference) for T candidate tokens per row in one call of
that entry's multi-token instance, as kernel 4 is kernel 1's.

A tensor on the CPU goes to the plain version (``kernels/ref.py``); a
CUDA tensor goes to the kernel or the call raises — there is no
fallback.  ``launches`` counts the decode entries' kernel launches (both
addressings), ``paged_launches`` those of the paged one, and
``plain_calls`` CPU calls of their plain versions; ``verify_launches`` and
``verify_plain_calls`` count the multi-token entry's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import LaunchCounter

launches = LaunchCounter()      # kernel launches on CUDA tensors (both)
paged_launches = LaunchCounter()  # of those, the paged addressing's
plain_calls = LaunchCounter()   # plain-version calls on CPU tensors
verify_launches = LaunchCounter()     # multi-token entry, CUDA tensors
verify_plain_calls = LaunchCounter()  # its plain version, CPU tensors


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
    """q [B,Hq,Dh] bf16/fp32 (Dh 64, 128 or 256); k_q, v_q int8
    [B,S,Hkv,Dh]; k_scale, v_scale fp32 [B,S,Hkv]; pos [B,S] int32 (ring
    order for a windowed cache); lengths [B] int32.  Returns
    o [B,Hq,Dh] in q.dtype.  The plain version rounds the dequantized K/V
    to q.dtype (as the JAX reference does); the kernel keeps them exact
    (as the TPU kernel does), so in bf16 the two differ by that rounding."""
    if q.device.type == "cpu":
        plain_calls.add()
        return ref.decode_attention_int8_ref(
            q, k_q, k_scale, v_q, v_scale, pos, lengths, window=window,
            sink=sink, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _da._check(q, k_q, v_q, pos, lengths, kv_dtype=torch.int8,
               scales=(k_scale, v_scale),
               head_dims=_da.INT8_SLAB_HEAD_DIMS)
    b, hq, dh = q.shape
    _, s_len, hkv, _ = k_q.shape
    out = _da.launch(
        "repro_decode_attention_int8", q,
        (q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(), v_q.data_ptr(),
         v_scale.data_ptr(), pos.data_ptr(), lengths.data_ptr()),
        (b, s_len, hq, hkv, dh), slab_plan(q, k_q), window=window,
        sink=sink, softcap=softcap)
    launches.add()
    return out


def _check_paged(q, pk_q, pk_s, pv_q, pv_s, tables, lengths,
                 q_dims: int = 3):
    """Raise on what the paged int8 entries do not take: q [B,Hq,Dh]
    (``q_dims`` 4: [B,T,Hq,Dh]) fp32 or bf16; pk_q/pv_q int8
    [P,page,Hkv,Dh] and pk_s/pv_s fp32 [P,page,Hkv], contiguous, the int8
    pools 16-byte aligned; tables [B,MP] and lengths [B] int32."""
    dev = q.device
    named = [("pk_q", pk_q), ("pk_s", pk_s), ("pv_q", pv_q), ("pv_s", pv_s),
             ("tables", tables), ("lengths", lengths)]
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _da._DTYPES:
        raise TypeError(f"q dtype {q.dtype} not supported (bf16 or fp32)")
    if pk_q.dtype != torch.int8 or pv_q.dtype != torch.int8:
        raise TypeError(f"pool dtype {pk_q.dtype}/{pv_q.dtype} must be int8")
    if pk_s.dtype != torch.float32 or pv_s.dtype != torch.float32:
        raise TypeError("pool scales must be float32")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("tables and lengths must be int32")
    if q.dim() != q_dims or pk_q.dim() != 4 or tables.dim() != 2 \
            or lengths.dim() != 1:
        raise ValueError(f"expected q [B,{'T,' if q_dims == 4 else ''}"
                         f"Hq,Dh], pools [P,page,Hkv,Dh], tables [B,MP], "
                         f"lengths [B]")
    b, hq, dh = q.shape[0], q.shape[-2], q.shape[-1]
    if q_dims == 4 and q.shape[1] == 0:
        raise ValueError("q has no query token (T = 0)")
    n_pages, page, hkv, dh2 = pk_q.shape
    if pv_q.shape != pk_q.shape or dh2 != dh:
        raise ValueError(f"pool shapes {tuple(pk_q.shape)} / "
                         f"{tuple(pv_q.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if pk_s.shape != (n_pages, page, hkv) or pv_s.shape != pk_s.shape:
        raise ValueError(f"scales {tuple(pk_s.shape)} / {tuple(pv_s.shape)}"
                         f" must be [P,page,Hkv]=[{n_pages},{page},{hkv}]")
    if tables.shape[0] != b or lengths.shape != (b,) or tables.shape[1] == 0:
        raise ValueError(f"tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match B={b}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if dh not in _da.HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not supported by the kernel "
                         f"{_da.HEAD_DIMS}")
    for name, t in [("q", q)] + named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # the int8 pools are copied in 16-byte pieces; the scales in 4-byte
    # ones; q, tables and lengths with element loads
    for name, t in (("pk_q", pk_q), ("pv_q", pv_q)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_decode_attention_int8(q, pk_q, pk_s, pv_q, pv_s, tables, lengths,
                                *, window: int = 0, sink: int = 0,
                                softcap: float = 0.0):
    """q [B,Hq,Dh] bf16/fp32; pk_q, pv_q int8 [P,page,Hkv,Dh]; pk_s, pv_s
    fp32 [P,page,Hkv]; tables [B,MP] int32 (-1 = unmapped); lengths [B]
    int32.  Returns o [B,Hq,Dh] in q.dtype.  On the card, one C call of
    kernel 3's paged entry (plus its merge where split) with kernel 1's
    split plan over the table; on the CPU the gather chain
    ``ref.paged_decode_attention_int8_ref``."""
    if q.device.type == "cpu":
        plain_calls.add()
        return ref.paged_decode_attention_int8_ref(
            q, pk_q, pk_s, pv_q, pv_s, tables, lengths, window=window,
            sink=sink, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_paged(q, pk_q, pk_s, pv_q, pv_s, tables, lengths)
    out = _da.launch(
        "repro_paged_decode_attention_int8", q,
        (q.data_ptr(), pk_q.data_ptr(), pk_s.data_ptr(), pv_q.data_ptr(),
         pv_s.data_ptr(), tables.data_ptr(), lengths.data_ptr()),
        (q.shape[0], q.shape[1], pk_q.shape[2], q.shape[2], pk_q.shape[1],
         tables.shape[1], pk_q.shape[0]), paged_plan(q, pk_q, tables),
        window=window, sink=sink, softcap=softcap)
    launches.add()
    paged_launches.add()
    return out


def paged_verify_attention_int8(q, pk_q, pk_s, pv_q, pv_s, tables, lengths,
                                *, window: int = 0, sink: int = 0,
                                softcap: float = 0.0):
    """q [B,T,Hq,Dh] bf16/fp32; pools and scales as
    ``paged_decode_attention_int8``; tables [B,MP] int32 (-1 = unmapped;
    MP is taken from the tables given, which may be cut to the used
    pages); lengths [B] int32 = tokens before the verify step (query t
    attends positions <= lengths[b] + t).  Returns o [B,T,Hq,Dh] in
    q.dtype.  On the card, one C call of kernel 3's multi-token paged
    entry (plus its merge where split), reading the pools in place; T = 1
    launches the decode entry's instantiation with its plan, so it equals
    ``paged_decode_attention_int8`` bit for bit.  On the CPU the gather
    chain ``ref.paged_verify_attention_int8_ref``."""
    if q.device.type == "cpu":
        verify_plain_calls.add()
        return ref.paged_verify_attention_int8_ref(
            q, pk_q, pk_s, pv_q, pv_s, tables, lengths, window=window,
            sink=sink, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_paged(q, pk_q, pk_s, pv_q, pv_s, tables, lengths, q_dims=4)
    b, t, hq, dh = q.shape
    out = _da.launch(
        "repro_paged_verify_attention_int8", q,
        (q.data_ptr(), pk_q.data_ptr(), pk_s.data_ptr(), pv_q.data_ptr(),
         pv_s.data_ptr(), tables.data_ptr(), lengths.data_ptr()),
        (b, t, hq, pk_q.shape[2], dh, pk_q.shape[1], tables.shape[1],
         pk_q.shape[0]), paged_plan(q, pk_q, tables),
        window=window, sink=sink, softcap=softcap)
    verify_launches.add()
    return out


def _sixteen_rows(dh: int, dtype) -> bool:
    """Whether kernel 3's slab entry runs on the 16-row tensor-core engine
    (a bf16 q at Dh 256), as the C side chooses."""
    return dtype == torch.bfloat16 and dh == 256


def slab_row_groups(g: int, dh: int, dtype) -> int:
    """CTAs per (row, kv-head) of kernel 3's slab entry, as the C side
    chooses them: 16 query heads per CTA on the 16-row engine
    (recurrentgemma's G 10 in one CTA), else 8 (kernel 1's decode
    grouping)."""
    return -(-g // (16 if _sixteen_rows(dh, dtype) else 8))


def slab_plan(q, k_q):
    """The split plan of kernel 3's slab entry (shapes only): the slab
    plan of ``decode_attention.slab_plan`` for the CTAs of
    ``slab_row_groups``; the 16-row instance (bf16 q, Dh 256) keeps its
    grid to one wave of 2 CTAs per SM (at 64 rows x 2048 slots 4 splits,
    256 CTAs, where rounding up gave 5 and put a third CTA on 56 SMs)."""
    b, hq, dh = q.shape
    s_len, hkv = k_q.shape[1], k_q.shape[2]
    return _pa.capped_split_plan(b, hkv, slab_row_groups(hq // hkv, dh,
                                                         q.dtype),
                                 s_len, 1, _pa.sm_count(q.device),
                                 _da.MAX_SPLIT_SLOTS,
                                 one_wave=_sixteen_rows(dh, q.dtype))


def verify_row_groups(t: int, g: int, dtype) -> int:
    """CTAs per (row, kv-head) along the T*G query rows of a paged int8
    call, as the C side chooses them: a decode (T = 1) as kernel 1's
    (``paged_attention.row_groups``); the multi-token entry 16 rows per
    CTA with a bf16 q (two n8 tiles of the tensor-core products), 8 with
    an fp32 q."""
    if t == 1:
        return _pa.row_groups(1, g)
    cap = 16 if dtype == torch.bfloat16 else 8
    return -(-t * g // cap)


def paged_plan(q, pk_q, tables):
    """The split plan of the paged entries: kernel 1's over the table,
    for the CTAs of q's query rows (q [B,Hq,Dh], or [B,T,Hq,Dh] for the
    multi-token entry: T = 1 takes the decode plan)."""
    b, hq = q.shape[0], q.shape[-2]
    t = q.shape[1] if q.dim() == 4 else 1
    page, hkv = pk_q.shape[1], pk_q.shape[2]
    return _pa.split_plan(b, hkv, verify_row_groups(t, hq // hkv, q.dtype),
                          tables.shape[1], page, _pa.sm_count(q.device))
