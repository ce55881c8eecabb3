"""The int8 speculative-decode verify of the port against the JAX package
on the same numpy-made inputs: ``ops.paged_verify_attention_int8`` (on
the CPU the plain version of kernel 3's multi-token paged entry, the
gather chain ``ref.paged_verify_attention_int8_ref``) against repro's op
of the same name, over T = 1, 2 and 4 candidate tokens, GQA 1 and 4,
pages of 4 and 16, ragged rows, a -1 hole, a page shared by two rows and
an all-unmapped row (exactly 0); window + sink and softcap;
``ops.verify_attention_int8`` (dense, plain on every device) against
repro's; the split-K model of the kernel (``ref.paged_split_attention_
ref`` with the int8 scales) for T tokens against repro's op; T = 1
against the decode plain version; and the wrapper's row grouping and
refusals.  fp32; tolerance 1e-5 absolute (one fp32 online softmax,
summed in another order), exact where no float arithmetic is involved.
The kernel itself runs only on the card (tests/test_torch_kernels_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import quant_kv as TQK
from repro_torch.kernels import ref as TREF

TOL = 1e-5
_JOP = jax.jit(JOPS.paged_verify_attention_int8,
               static_argnames=("window", "sink", "softcap"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _case(rng, *, t, g, page, dh=64, hkv=2, b=4):
    """Int8 pools whose pages hold each row's last candidate (position
    base + t - 1), a -1 hole, a page shared by two rows and an
    all-unmapped last row.  Returns numpy (q, pk_q, pk_s, pv_q, pv_s,
    tables, base); the pools are quantized by the port's quantize_kv,
    bit-identical to the JAX package's."""
    base = np.array([page + 1, 2, page * 2, 0], np.int32)[:b]
    need = [-(-(int(n) + t) // page) for n in base]
    mp = max(need) + 1
    n_pages = sum(need) + 2
    perm = rng.permutation(n_pages).astype(np.int32)
    tables = np.full((b, mp), -1, np.int32)
    cur = 0
    for r in range(b - 1):                       # last row: all unmapped
        tables[r, :need[r]] = perm[cur:cur + need[r]]
        cur += need[r]
    tables[2, 1] = -1                            # a hole
    tables[1, 0] = tables[0, 0]                  # a shared page
    q = rng.standard_normal((b, t, hkv * g, dh)).astype(np.float32)
    pools = []
    for _ in range(2):
        x = rng.standard_normal((n_pages, page, hkv, dh)).astype(np.float32)
        xq, xs = TQK.quantize_kv(_t(x))
        pools += [xq.numpy(), xs.numpy()]
    return (q, *pools, tables, base)


GRID = [(t, g, page) for t in (1, 2, 4) for g in (1, 4) for page in (4, 16)]
OPTIONS = {"window-sink": dict(window=6, sink=2),
           "softcap": dict(softcap=3.0)}


def _port_vs_jax(args, **kw):
    TQK.verify_plain_calls.reset()
    got = TOPS.paged_verify_attention_int8(*(_t(a) for a in args), **kw)
    assert TQK.verify_plain_calls.value == 1       # the plain version ran
    want = np.asarray(_JOP(*(jnp.asarray(a) for a in args), **kw))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    return got


@pytest.mark.parametrize("t,g,page", GRID)
def test_plain_verify_int8_matches_jax_op(t, g, page):
    args = _case(np.random.default_rng(t * 100 + g * 10 + page),
                 t=t, g=g, page=page)
    got = _port_vs_jax(args)
    assert got.shape == args[0].shape
    assert bool((got[-1] == 0).all())              # no valid key: exactly 0


@pytest.mark.parametrize("name", sorted(OPTIONS))
@pytest.mark.parametrize("t", [1, 4])
def test_plain_verify_int8_options_match_jax_op(name, t):
    args = _case(np.random.default_rng(7 + t), t=t, g=4, page=4)
    _port_vs_jax(args, **OPTIONS[name])


def test_dense_verify_int8_matches_jax_op():
    """The dense int8 verify: slab rows with -1 holes and a row with no
    valid slot, plain torch on every device (as repro's)."""
    rng = np.random.default_rng(3)
    b, s, t, hkv, g, dh = 3, 20, 3, 2, 2, 16
    pos = np.where(np.arange(s)[None] < np.array([[14], [5], [0]]),
                   np.arange(s)[None], -1).astype(np.int32)
    pos[0, 4] = -1
    base = np.array([11, 2, 0], np.int32)
    pos[2] = -1                                     # row 2: nothing valid
    q = rng.standard_normal((b, t, hkv * g, dh)).astype(np.float32)
    slab = []
    for _ in range(2):
        xq, xs = TQK.quantize_kv(_t(rng.standard_normal(
            (b, s, hkv, dh)).astype(np.float32)))
        slab += [xq.numpy(), xs.numpy()]
    args = (q, *slab, pos, base)
    got = TOPS.verify_attention_int8(*(_t(a) for a in args), window=6,
                                     sink=1)
    want = JOPS.verify_attention_int8(*(jnp.asarray(a) for a in args),
                                      window=6, sink=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    assert bool((got[2] == 0).all())


@pytest.mark.parametrize("pps", [1, 2])
@pytest.mark.parametrize("t", [2, 4])
def test_split_model_for_t_tokens_matches_jax_op(t, pps):
    """The kernel's split-K arithmetic for T tokens over int8 pools
    (scales folded into the products, partials merged in split order)
    against repro's op."""
    q, pkq, pks, pvq, pvs, tables, base = _case(
        np.random.default_rng(40 + t + pps), t=t, g=4, page=4)
    got = TREF.paged_split_attention_ref(
        _t(q), _t(pkq), _t(pvq), _t(tables), _t(base), pages_per_split=pps,
        k_scale=_t(pks), v_scale=_t(pvs), window=6, sink=2)
    want = np.asarray(_JOP(*(jnp.asarray(a) for a in
                             (q, pkq, pks, pvq, pvs, tables, base)),
                           window=6, sink=2))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_verify_int8_t1_is_the_decode_plain_version():
    q, pkq, pks, pvq, pvs, tables, base = _case(
        np.random.default_rng(5), t=1, g=4, page=4)
    pools = [_t(a) for a in (pkq, pks, pvq, pvs, tables, base)]
    verify = TQK.paged_verify_attention_int8(_t(q), *pools)
    decode = TQK.paged_decode_attention_int8(_t(q[:, 0]), *pools)
    np.testing.assert_allclose(verify[:, 0].numpy(), decode.numpy(),
                               atol=1e-6, rtol=0)


def test_verify_row_groups_follow_the_kernel():
    """CTAs per (row, kv-head): a decode (T = 1) as kernel 1's; the
    multi-token entry 16 query rows per CTA with a bf16 q (two n8 tiles of
    the tensor-core products), 8 with an fp32 q."""
    for g in (1, 2, 4, 8):
        for dtype in (torch.bfloat16, torch.float32):
            assert TQK.verify_row_groups(1, g, dtype) == TPA.row_groups(1, g)
    assert TQK.verify_row_groups(4, 4, torch.bfloat16) == 1    # Qwen3, k=3
    assert TQK.verify_row_groups(4, 4, torch.float32) == 2
    assert TQK.verify_row_groups(8, 8, torch.bfloat16) == 4
    assert TQK.verify_row_groups(2, 1, torch.float32) == 1


def test_slab_row_groups_follow_the_kernel():
    """CTAs per (row, kv-head) of kernel 3's slab entry: recurrentgemma-2b's
    G 10 at Dh 256 is one CTA with a bf16 q (the 16-row tensor-core
    engine) and two (8 + 2 rows) with an fp32 q; Dh 64 and 128 keep kernel
    1's decode grouping (8 rows) in both dtypes."""
    assert TQK.slab_row_groups(10, 256, torch.bfloat16) == 1
    assert TQK.slab_row_groups(10, 256, torch.float32) == 2
    assert TQK.slab_row_groups(16, 256, torch.bfloat16) == 1
    assert TQK.slab_row_groups(17, 256, torch.bfloat16) == 2
    for dh in (64, 128):
        for g in (1, 2, 4, 8, 10, 16):
            for dtype in (torch.bfloat16, torch.float32):
                assert TQK.slab_row_groups(g, dh, dtype) == \
                    TPA.row_groups(1, g)


def test_verify_int8_wrapper_counts_cpu_and_refuses_other_devices():
    args = [_t(a) for a in _case(np.random.default_rng(6), t=2, g=1,
                                 page=4)]
    TQK.verify_plain_calls.reset()
    TQK.verify_launches.reset()
    TQK.paged_verify_attention_int8(*args)
    assert (TQK.verify_plain_calls.value, TQK.verify_launches.value) == (1, 0)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel for device"):
        TQK.paged_verify_attention_int8(*meta)
    with pytest.raises(ValueError, match="'auto'"):
        TOPS.paged_verify_attention_int8(*args, use_kernel="pallas")
