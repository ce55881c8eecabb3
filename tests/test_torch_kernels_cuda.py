"""The port's Hopper kernels against their plain PyTorch versions on the
card.  Marked ``cuda``: they skip without a CUDA device.  This file
imports no JAX (the card's machine has none), so it runs there without
the JAX-importing conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import ref as TREF

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


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
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in fp32
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
            torch.testing.assert_close(out.float(), want.float(),
                                       atol=TOL[dtype], rtol=0)
            assert torch.all(out[3] == 0)
