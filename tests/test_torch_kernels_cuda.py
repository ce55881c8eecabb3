"""The port's Hopper kernels against their plain PyTorch versions on the
card.  Marked ``cuda``: they skip without a CUDA device.  This file
imports no JAX (the card's machine has none), so it runs there without
the JAX-importing conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py

Tolerances, |out - want| <= atol + rtol * |want|: fp32 1e-5 absolute;
bf16 1e-4 + 2^-7 * |want|.  Kernel and plain version both accumulate in
fp32 and round once to bf16, so they may differ by one rounding step (at
most 2^-7 of |want|); one dropped key among 512 moves an output by
~2e-3, far beyond the absolute part.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as TDA
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import quant_kv as TQK
from repro_torch.kernels import ref as TREF

TOL = {"float32": (1e-5, 0.0), "bfloat16": (1e-4, 2.0 ** -7)}


def _assert_within(out, want, dtype):
    atol, rtol = TOL[dtype]
    d = (out.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    assert bool(out.float().isfinite().all())
    assert bool((d <= bound).all()), float((d - bound).max())


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernels have no CPU "
                    "mode)")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in fp32


def _case(rng, *, g, page, hkv=2, dh=128, b=4, mp=6):
    """Ragged rows, a -1 hole, a page shared by two rows and one
    all-unmapped row (its output must be exactly 0)."""
    lengths = np.array([page * 3 + 1, 2, page * 5, 0], np.int32)[:b]
    need = [-(-(int(n) + 1) // page) for n in lengths]
    n_pages = sum(need) + 2
    perm = rng.permutation(n_pages).astype(np.int32)
    tables = np.full((b, mp), -1, np.int32)
    cur = 0
    for r in range(b - 1):
        tables[r, :need[r]] = perm[cur:cur + need[r]]
        cur += need[r]
    tables[2, 1] = -1
    tables[1, 0] = tables[0, 0]
    q = rng.standard_normal((b, hkv * g, dh)).astype(np.float32)
    pk = rng.standard_normal((n_pages, page, hkv, dh)).astype(np.float32)
    pv = rng.standard_normal((n_pages, page, hkv, dh)).astype(np.float32)
    return q, pk, pv, tables, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_on_card_matches_plain(dtype):
    _needs_card()
    rng = np.random.default_rng(5)
    dt = getattr(torch, dtype)
    for g in (1, 2, 4):
        for page in (4, 16):
            q, pk, pv, tables, lengths = (
                torch.from_numpy(a).cuda()
                for a in _case(rng, g=g, page=page))
            q, pk, pv = q.to(dt), pk.to(dt), pv.to(dt)
            before = TPA.launches.value
            out = TPA.paged_decode_attention(q, pk, pv, tables, lengths)
            torch.cuda.synchronize()
            assert TPA.launches.value == before + 1
            want = TREF.paged_decode_attention_ref(q, pk, pv, tables,
                                                   lengths)
            _assert_within(out, want, dtype)
            assert torch.all(out[3] == 0)


def _slab_case(rng, *, g, dh, hkv=2, s=300):
    """Four rows over an S=300 slab (no multiple of any tile): in-order
    positions with -1 holes, a ring-ordered cache, a short row, and one
    row with no valid slot (its output must be exactly 0)."""
    pos = np.full((4, s), -1, np.int32)
    pos[0, :257] = np.arange(257)
    pos[0, [3, 100, 200]] = -1
    ring = np.arange(400, 700)
    pos[1, ring % s] = ring
    pos[2, :5] = np.arange(5)
    lengths = np.array([256, 699, 4, 9], np.int32)
    q = rng.standard_normal((4, hkv * g, dh)).astype(np.float32)
    k = rng.standard_normal((4, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((4, s, hkv, dh)).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (q, k, v, pos, lengths)]


SLAB_KW = [{}, dict(window=64, sink=4), dict(softcap=5.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_kernel_on_card_matches_plain(dtype):
    _needs_card()
    rng = np.random.default_rng(6)
    dt = getattr(torch, dtype)
    for g in (1, 4, 8):
        for dh in (64, 128):
            for kw in SLAB_KW:
                q, k, v, pos, lengths = _slab_case(rng, g=g, dh=dh)
                q, k, v = q.to(dt), k.to(dt), v.to(dt)
                before = TDA.launches.value
                out = TDA.decode_attention(q, k, v, pos, lengths, **kw)
                torch.cuda.synchronize()
                assert TDA.launches.value == before + 1
                want = TREF.decode_attention_ref(q, k, v, pos, lengths, **kw)
                _assert_within(out, want, dtype)
                assert torch.all(out[3] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_kernel_on_card_matches_plain(dtype):
    """Kernel 3 dequantizes in fp32; for a bf16 q its plain version runs
    on q.float(), so the dequantized K/V stay fp32 there too, and the
    kernel's bf16 output is held to the bf16 bound."""
    _needs_card()
    rng = np.random.default_rng(7)
    dt = getattr(torch, dtype)
    for g in (1, 4, 8):
        for dh in (64, 128):
            for kw in SLAB_KW:
                q, k, v, pos, lengths = _slab_case(rng, g=g, dh=dh)
                kq, ks = TQK.quantize_kv(k)
                vq, vs = TQK.quantize_kv(v)
                q = q.to(dt)
                before = TQK.launches.value
                out = TQK.decode_attention_int8(q, kq, ks, vq, vs, pos,
                                                lengths, **kw)
                torch.cuda.synchronize()
                assert TQK.launches.value == before + 1
                assert out.dtype == dt
                want = TREF.decode_attention_int8_ref(
                    q.float(), kq, ks, vq, vs, pos, lengths, **kw)
                _assert_within(out, want, dtype)
                assert torch.all(out[3] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_verify_kernel_on_card_matches_plain(dtype):
    """Kernel 4: T candidate tokens per row, query t at lengths + t, over
    the same ragged/hole/shared/unmapped tables as kernel 1 (the pages
    hold the last candidate), with window + sink and softcap; T = 1 must
    equal kernel 1 bitwise (one template, the same instantiation)."""
    _needs_card()
    rng = np.random.default_rng(8)
    dt = getattr(torch, dtype)
    for t in (1, 2, 4):
        for g in (1, 4):
            for page in (4, 16):
                for kw in ({}, dict(window=6, sink=2), dict(softcap=3.0)):
                    _, pk, pv, tables, lengths = (
                        torch.from_numpy(a).cuda()
                        for a in _case(rng, g=g, page=page))
                    base = torch.clamp(lengths - (t - 1), min=0)
                    q = torch.from_numpy(rng.standard_normal(
                        (4, t, 2 * g, 128)).astype(np.float32)).cuda()
                    q, pk, pv = q.to(dt), pk.to(dt), pv.to(dt)
                    before = TPA.verify_launches.value
                    out = TPA.paged_verify_attention(q, pk, pv, tables, base,
                                                     **kw)
                    torch.cuda.synchronize()
                    assert TPA.verify_launches.value == before + 1
                    want = TREF.paged_verify_attention_ref(
                        q, pk, pv, tables, base, **kw)
                    _assert_within(out, want, dtype)
                    assert torch.all(out[3] == 0)
                    if t == 1:
                        dec = TPA.paged_decode_attention(
                            q[:, 0].contiguous(), pk, pv, tables, base, **kw)
                        assert torch.equal(out[:, 0], dec)


def _long_case(rng, *, t, g, page, hkv=2, dh=128, window=0):
    """Rows spanning many splits of the split plan: 4096 table positions,
    lengths 0 to 4095 (the pages hold the verify's last candidate), an
    all-unmapped row (exactly 0), a -1 hole and a shared page."""
    base = np.array([1000, 17, 0, 513, 4096 - t, 300], np.int32)
    mp = 4096 // page
    need = [-(-(int(n) + t) // page) for n in base]
    n_pages = sum(need) + 1
    perm = rng.permutation(n_pages).astype(np.int32)
    tables = np.full((6, mp), -1, np.int32)
    cur = 0
    for r in range(5):                           # row 5: all unmapped
        tables[r, :need[r]] = perm[cur:cur + need[r]]
        cur += need[r]
    tables[3, 2] = -1
    tables[4, 0] = tables[0, 0]
    q = rng.standard_normal((6, t, hkv * g, dh)).astype(np.float32)
    pk = rng.standard_normal((n_pages, page, hkv, dh)).astype(np.float32)
    pv = rng.standard_normal((n_pages, page, hkv, dh)).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (q, pk, pv, tables, base)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_long_multi_split_kernels_on_card(dtype):
    """Kernels 1 and 4 where the split plan cuts every row's table into
    many splits (empty ones past short rows, and between the sink and
    the window): within the tolerance of the plain version, exactly 0
    for the unmapped row, bitwise equal on a second launch (the merge
    sums in split order, no atomics), and kernel 4 at T = 1 bitwise equal
    to kernel 1 (the same instantiation and plan)."""
    _needs_card()
    rng = np.random.default_rng(9)
    dt = getattr(torch, dtype)
    for t in (1, 4):
        for g in (1, 4):
            for page in (4, 16):
                for kw in ({}, dict(window=256, sink=16), dict(softcap=5.0)):
                    q, pk, pv, tables, base = _long_case(rng, t=t, g=g,
                                                         page=page)
                    q, pk, pv = q.to(dt), pk.to(dt), pv.to(dt)
                    assert TPA.kernel_plan(q, pk, tables, t)[1] > 1
                    merges = TPA.merge_launches.value
                    out = TPA.paged_verify_attention(q, pk, pv, tables, base,
                                                     **kw)
                    again = TPA.paged_verify_attention(q, pk, pv, tables,
                                                       base, **kw)
                    torch.cuda.synchronize()
                    assert TPA.merge_launches.value == merges + 2
                    want = TREF.paged_verify_attention_ref(
                        q, pk, pv, tables, base, **kw)
                    _assert_within(out, want, dtype)
                    assert torch.all(out[5] == 0)
                    assert torch.equal(out, again)
                    if t == 1:
                        dec = TPA.paged_decode_attention(
                            q[:, 0].contiguous(), pk, pv, tables, base, **kw)
                        assert torch.equal(out[:, 0], dec)


def _long_slab_case(rng, *, g, dh, hkv=2, s=4096):
    """Six rows over a 4096-slot slab that the split plan cuts into many
    splits: holes every 97 slots, a full ring (positions 5000..9095 at
    slot pos % S), a short row (its later splits hold no valid slot), a
    row with no valid slot (exactly 0), a full row and a half-wrapped
    ring."""
    pos = np.full((6, s), -1, np.int32)
    pos[0, :3000] = np.arange(3000)
    pos[0, 5:3000:97] = -1
    for r, (lo, hi) in ((1, (5000, 9096)), (5, (3000, 6000))):
        ring = np.arange(lo, hi)
        pos[r, ring % s] = ring
    pos[2, :17] = np.arange(17)
    pos[4] = np.arange(s)
    lengths = np.array([2999, 9095, 16, 5, 4095, 5999], np.int32)
    q = rng.standard_normal((6, hkv * g, dh)).astype(np.float32)
    k = rng.standard_normal((6, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((6, s, hkv, dh)).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (q, k, v, pos, lengths)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_long_multi_split_dense_kernels_on_card(dtype):
    """Kernels 2 and 3 where the slab plan cuts every row into many
    splits (empty ones past the short row and between the sink and the
    window of a ring): within the tolerance of the plain version, exactly
    0 for the row with no valid slot, bitwise equal on a second launch
    (the merge sums in split order, no atomics)."""
    _needs_card()
    rng = np.random.default_rng(10)
    dt = getattr(torch, dtype)
    for g, dh in ((1, 128), (4, 128), (8, 64)):
        for kw in ({}, dict(window=256, sink=16), dict(softcap=5.0)):
            q, k, v, pos, lengths = _long_slab_case(rng, g=g, dh=dh)
            kq, ks = TQK.quantize_kv(k)
            vq, vs = TQK.quantize_kv(v)
            q, k, v = q.to(dt), k.to(dt), v.to(dt)
            assert TDA.kernel_plan(q, k)[1] > 1
            merges = TDA.merge_launches.value
            out = TDA.decode_attention(q, k, v, pos, lengths, **kw)
            again = TDA.decode_attention(q, k, v, pos, lengths, **kw)
            out8 = TQK.decode_attention_int8(q, kq, ks, vq, vs, pos,
                                             lengths, **kw)
            again8 = TQK.decode_attention_int8(q, kq, ks, vq, vs, pos,
                                               lengths, **kw)
            torch.cuda.synchronize()
            assert TDA.merge_launches.value == merges + 4
            _assert_within(out, TREF.decode_attention_ref(
                q, k, v, pos, lengths, **kw), dtype)
            _assert_within(out8, TREF.decode_attention_int8_ref(
                q.float(), kq, ks, vq, vs, pos, lengths, **kw), dtype)
            for o, a in ((out, again), (out8, again8)):
                assert torch.all(o[3] == 0)
                assert torch.equal(o, a)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_int8_entry_on_card_matches_plain(dtype):
    """Kernel 3's paged addressing (one C call, no gather) against the
    gather chain on the ragged/hole/shared/unmapped tables of kernel 1's
    cases and on long multi-split tables, with window + sink and softcap,
    each repeated bitwise; counted in ``launches`` and ``paged_launches``
    alike."""
    _needs_card()
    rng = np.random.default_rng(11)
    dt = getattr(torch, dtype)
    cases = [(_case(rng, g=g, page=page), 3) for g in (1, 4)
             for page in (4, 16)]
    cases += [(_long_case(rng, t=1, g=g, page=page), 5) for g in (1, 4)
              for page in (4, 16)]
    for args, empty in cases:
        q, pk, pv, tables, lengths = (torch.as_tensor(a).cuda() for a in args)
        q = q.reshape(q.shape[0], -1, q.shape[-1]).to(dt)
        pkq, pks = TQK.quantize_kv(pk)
        pvq, pvs = TQK.quantize_kv(pv)
        for kw in ({}, dict(window=6, sink=2), dict(softcap=3.0)):
            before = (TQK.launches.value, TQK.paged_launches.value)
            out = TQK.paged_decode_attention_int8(q, pkq, pks, pvq, pvs,
                                                  tables, lengths, **kw)
            again = TQK.paged_decode_attention_int8(q, pkq, pks, pvq, pvs,
                                                    tables, lengths, **kw)
            torch.cuda.synchronize()
            assert (TQK.launches.value, TQK.paged_launches.value) == (
                before[0] + 2, before[1] + 2)
            want = TREF.paged_decode_attention_int8_ref(
                q.float(), pkq, pks, pvq, pvs, tables, lengths, **kw)
            _assert_within(out, want, dtype)
            assert out.dtype == dt
            assert torch.all(out[empty] == 0)
            assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_verify_entry_on_card_matches_plain(dtype):
    """Kernel 3's multi-token paged entry (the int8 verify): T = 1, 2, 4
    and 8 candidate tokens, G 1 and 4, pages of 4 and 16, over the
    ragged/hole/shared/unmapped tables of kernel 1's cases (the pages hold
    the last candidate) and the long multi-split tables, with window +
    sink and softcap, against ``ref.paged_verify_attention_int8_ref`` on
    q.float() (the kernel keeps the dequantized K/V in fp32), each
    repeated bitwise and counted in ``verify_launches``; at T = 1 bitwise
    equal to the decode entry (the same instantiation and plan)."""
    _needs_card()
    rng = np.random.default_rng(12)
    dt = getattr(torch, dtype)
    cases = []
    for t in (1, 2, 4, 8):
        for g in (1, 4):
            for page in (4, 16):
                _, pk, pv, tables, lengths = (
                    torch.from_numpy(a).cuda()
                    for a in _case(rng, g=g, page=page))
                q = torch.from_numpy(rng.standard_normal(
                    (4, t, 2 * g, 128)).astype(np.float32)).cuda()
                cases.append((t, (q, pk, pv, tables,
                                  torch.clamp(lengths - (t - 1), min=0)), 3))
    cases += [(t, _long_case(rng, t=t, g=g, page=16), 5) for t in (1, 4)
              for g in (1, 4)]
    for t, (q, pk, pv, tables, base), empty in cases:
        q = q.to(dt)
        pkq, pks = TQK.quantize_kv(pk)
        pvq, pvs = TQK.quantize_kv(pv)
        args = (q, pkq, pks, pvq, pvs, tables, base)
        for kw in ({}, dict(window=6, sink=2), dict(softcap=3.0)):
            before = TQK.verify_launches.value
            out = TQK.paged_verify_attention_int8(*args, **kw)
            again = TQK.paged_verify_attention_int8(*args, **kw)
            torch.cuda.synchronize()
            assert TQK.verify_launches.value == before + 2
            want = TREF.paged_verify_attention_int8_ref(q.float(), *args[1:],
                                                        **kw)
            _assert_within(out, want, dtype)
            assert out.dtype == dt and out.shape == q.shape
            assert torch.all(out[empty] == 0)
            assert torch.equal(out, again)
            if t == 1:
                dec = TQK.paged_decode_attention_int8(
                    q[:, 0].contiguous(), *args[1:], **kw)
                torch.cuda.synchronize()
                assert torch.equal(out[:, 0], dec)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [7, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_large_groups_on_card_match_plain(dtype, g):
    """The group sizes of the DeepSeek configs (G = Hq / Hkv = 7 for
    deepseek-coder-33b, the first that is no power of two, and 8 for
    deepseek-67b) through kernel 1, kernel 4 (T 1, 2, 4: a T = 4 verify
    needs two row groups) and kernel 3's paged decode and multi-token
    entries, over the ragged/hole/shared/unmapped tables, against their
    plain versions; kernel 4 and the multi-token entry at T = 1 bitwise
    equal to their decode kernels."""
    _needs_card()
    rng = np.random.default_rng(13 + g)
    dt = getattr(torch, dtype)
    for page in (4, 16):
        _, pk, pv, tables, lengths = (torch.from_numpy(a).cuda()
                                      for a in _case(rng, g=g, page=page))
        pk, pv = pk.to(dt), pv.to(dt)
        pkq, pks = TQK.quantize_kv(pk.float())
        pvq, pvs = TQK.quantize_kv(pv.float())
        for t in (1, 2, 4):
            base = torch.clamp(lengths - (t - 1), min=0)
            q = torch.from_numpy(rng.standard_normal(
                (4, t, 2 * g, 128)).astype(np.float32)).cuda().to(dt)
            out = TPA.paged_verify_attention(q, pk, pv, tables, base)
            out8 = TQK.paged_verify_attention_int8(q, pkq, pks, pvq, pvs,
                                                   tables, base)
            torch.cuda.synchronize()
            _assert_within(out, TREF.paged_verify_attention_ref(
                q, pk, pv, tables, base), dtype)
            _assert_within(out8, TREF.paged_verify_attention_int8_ref(
                q.float(), pkq, pks, pvq, pvs, tables, base), dtype)
            assert torch.all(out[3] == 0) and torch.all(out8[3] == 0)
            if t == 1:
                q1 = q[:, 0].contiguous()
                dec = TPA.paged_decode_attention(q1, pk, pv, tables, base)
                dec8 = TQK.paged_decode_attention_int8(q1, pkq, pks, pvq,
                                                       pvs, tables, base)
                torch.cuda.synchronize()
                _assert_within(dec, TREF.paged_decode_attention_ref(
                    q1, pk, pv, tables, base), dtype)
                _assert_within(dec8, TREF.paged_decode_attention_int8_ref(
                    q1.float(), pkq, pks, pvq, pvs, tables, base), dtype)
                assert torch.all(dec[3] == 0) and torch.all(dec8[3] == 0)
                assert torch.equal(out[:, 0], dec)
                assert torch.equal(out8[:, 0], dec8)
