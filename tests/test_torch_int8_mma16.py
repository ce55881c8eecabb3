"""The order of operations of kernel 3's 16-row tensor-core engine
(``ref.int8_mma16_attention_ref``: q read as bf16, each split walked in
64-slot tiles with one max per query row over the whole tile, P' = p * v_s
under a running power-of-two scale as fp16 hi + lo, PV by quarters of the
output dims, then the split merge) against the JAX package on the same
numpy-made inputs: the slab entry at recurrentgemma-2b's windowed heads
(Dh 256, Hq 10 / Hkv 1, window 2048, ring-ordered pos) against
``repro.kernels.quant_kv.decode_attention_int8`` (the Pallas kernel in
interpret mode), and the multi-token entry at Qwen3-8B's verify (T 4, G 4)
against ``repro.kernels.ops.paged_verify_attention_int8``.  fp32 inputs, q
rounded to bf16 values for both sides (the kernel reads a bf16 q).
Tolerance 1e-5 absolute, the port's fp32 tolerance against the JAX package
(tests/test_torch_int8.py): P' = hi + lo keeps p * v_s to 2^-22 of itself
(|v| <= ~4 here: the output's bound 1e-6 if every error had one sign;
1.5e-7 on these inputs) and the rest is fp32 summation order.  The kernel
itself runs only on the card (``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro.kernels import quant_kv as JQK
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import quant_kv as TQK
from repro_torch.kernels import ref as TREF

TOL = 1e-5
S, HQ, HKV, DH, WINDOW = 2048, 10, 1, 256, 2048


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_values(x):
    """fp32 numpy values that are exactly bf16."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _ring_case(rng):
    """Rows: a ring wrapped past its size (every slot valid, the window
    the ring's), a prefix with a stale slot past its length, a short
    ring under the window's edge, and a row with no valid slot."""
    pos = np.full((4, S), -1, np.int32)
    ring = np.arange(3000 - S + 1, 3001)
    pos[0, ring % S] = ring
    pos[1, :700] = np.arange(700)
    pos[1, 650] = 5000                     # stale: past the row's length
    ring = np.arange(2300, 4400)
    pos[2, ring % S] = ring                # wraps; the window cuts it
    lengths = np.array([3000, 699, 4300, 9], np.int32)
    q = _bf16_values(rng.standard_normal((4, HQ, DH)).astype(np.float32))
    k = rng.standard_normal((4, S, HKV, DH)).astype(np.float32)
    v = rng.standard_normal((4, S, HKV, DH)).astype(np.float32)
    kq, ks = TQK.quantize_kv(torch.from_numpy(k))
    vq, vs = TQK.quantize_kv(torch.from_numpy(v))
    return q, kq, ks, vq, vs, pos, lengths


@pytest.fixture(scope="module")
def ring_case():
    q, kq, ks, vq, vs, pos, lengths = _ring_case(np.random.default_rng(28))
    want = np.asarray(JQK.decode_attention_int8(
        *(jnp.asarray(np.asarray(a)) for a in (q, kq, ks, vq, vs, pos,
                                               lengths)),
        window=WINDOW))
    return (q, kq, ks, vq, vs, pos, lengths), want


# slots per split: the hybrid's serve plan (64: one tile a split), its
# bandwidth plan at 64 rows (512), a split of tiles of 64 and a ragged last
# one (410) and one split over the whole slab
@pytest.mark.parametrize("sps", [64, 410, 512, S])
def test_mma16_model_matches_the_pallas_slab_kernel_at_dh256(ring_case,
                                                            sps):
    (q, kq, ks, vq, vs, pos, lengths), want = ring_case
    got = TREF.int8_mma16_attention_ref(
        torch.from_numpy(q)[:, None], kq, ks, vq, vs, torch.from_numpy(pos),
        torch.from_numpy(lengths)[:, None], slots_per_split=sps,
        window=WINDOW)[:, 0].numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert np.all(got[3] == 0)             # no valid slot: exactly 0
    assert np.abs(want[:3]).max() > 0.05   # the rows attend to something


def test_mma16_plan_at_the_hybrids_shapes():
    """The plans the kernel runs the model's splits at: the hybrid's
    serve call (2 rows, S 1024) 16 splits of 64 slots, 64 rows over the
    2048-slot window 4 splits of 512 (one CTA per row and split: 256
    CTAs, one wave of at most 2 per SM on 132 SMs); an fp32 q keeps two
    row groups (16 and 3 splits, rounded up as kernel 2's plan)."""
    TPA._SM_COUNT[torch.device("cpu")] = 132
    try:
        for b, s, want_bf16, want_f32 in ((2, 1024, (64, 16), (64, 16)),
                                          (64, S, (512, 4), (683, 3))):
            kq = torch.zeros((b, s, HKV, DH), dtype=torch.int8)
            for dtype, want in ((torch.bfloat16, want_bf16),
                                (torch.float32, want_f32)):
                q = torch.zeros((b, HQ, DH), dtype=dtype)
                assert TQK.slab_plan(q, kq) == want
    finally:
        del TPA._SM_COUNT[torch.device("cpu")]


def _verify_case(rng, *, t=4, g=4, hkv=2, dh=128, page=16):
    """Int8 pools whose pages hold each row's last candidate, the tables
    of ragged rows (one over several 64-slot tiles) and the verify's base
    lengths."""
    base = np.array([150, 3, 61], np.int32)
    need = [-(-(int(n) + t) // page) for n in base]
    mp = max(need) + 1
    n_pages = sum(need) + 2
    perm = rng.permutation(n_pages).astype(np.int32)
    tables = np.full((3, mp), -1, np.int32)
    cur = 0
    for r in range(3):
        tables[r, :need[r]] = perm[cur:cur + need[r]]
        cur += need[r]
    q = _bf16_values(rng.standard_normal(
        (3, t, hkv * g, dh)).astype(np.float32))
    pk = rng.standard_normal((n_pages, page, hkv, dh)).astype(np.float32)
    pv = rng.standard_normal((n_pages, page, hkv, dh)).astype(np.float32)
    pkq, pks = TQK.quantize_kv(torch.from_numpy(pk))
    pvq, pvs = TQK.quantize_kv(torch.from_numpy(pv))
    return q, pkq, pks, pvq, pvs, tables, base


# pages per split: one page a split, 4 (tiles cut at 64 slots), all
@pytest.mark.parametrize("pps", [1, 4, 64])
def test_mma16_model_matches_the_jax_int8_verify(pps):
    q, pkq, pks, pvq, pvs, tables, base = _verify_case(
        np.random.default_rng(280 + pps))
    t = q.shape[1]
    want = np.asarray(JOPS.paged_verify_attention_int8(
        *(jnp.asarray(np.asarray(a)) for a in (q, pkq, pks, pvq, pvs,
                                               tables, base))))
    tb = torch.from_numpy(tables)
    kq, kpos = TREF.paged_gather(pkq, tb)
    ks, _ = TREF.paged_gather(pks, tb)
    vq, _ = TREF.paged_gather(pvq, tb)
    vs, _ = TREF.paged_gather(pvs, tb)
    qpos = torch.from_numpy(base)[:, None] + torch.arange(t)[None, :]
    got = TREF.int8_mma16_attention_ref(
        torch.from_numpy(q), kq, ks, vq, vs, kpos, qpos.to(torch.int32),
        slots_per_split=pps * pkq.shape[1]).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert TQK.verify_row_groups(t, q.shape[2] // pkq.shape[2],
                                 torch.bfloat16) == 1
