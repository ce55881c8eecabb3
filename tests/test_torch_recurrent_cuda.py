"""The recurrent slice on the card: kernel 3's slab entry at
recurrentgemma-2b's heads (Dh 256, Hq 10 / Hkv 1, window 2048, ring order
wrapped past the window) against its plain version, bf16 and fp32 q; a
head dim it does not take raises (no fallback); and a reduced hybrid and
a reduced mamba2 served through ServingEngine(backend="hetero",
num_r_workers=2, paged_kv=True): graphs == eager bit for bit, == the
colocated engine, kernel 3 on every attention decode R-Part of the
hybrid's int8 serve.  Marked ``cuda``: they skip without a CUDA device.
This file imports no JAX, so it runs on the card without the
JAX-importing conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_recurrent_cuda.py
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import graphs
from repro_torch.core.config import get_arch
from repro_torch.kernels import quant_kv as QK
from repro_torch.kernels import ref
from repro_torch.models import model as M
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request

# kernel vs plain version: |out - want| <= atol + rtol * |want| (in bf16
# one rounding step of the output, 2^-7)
TOL = {torch.bfloat16: (1e-4, 2.0 ** -7), torch.float32: (1e-5, 0.0)}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernels and CUDA graphs "
                    "have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _ring_pos(s, lo, hi):
    """positions lo..hi-1 of a ring of s slots (slot = pos % s)."""
    pos = torch.full((s,), -1, dtype=torch.int32)
    p = torch.arange(lo, hi, dtype=torch.int32)
    pos[p.long() % s] = p
    return pos


@pytest.mark.cuda
@pytest.mark.parametrize("window", [2048, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel3_dh256_ring_matches_the_plain_version(dtype, window):
    _needs_card()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    s, hq, hkv, dh = 2048, 10, 1, 256
    pos = torch.stack([_ring_pos(s, 1000, 3048), _ring_pos(s, 2500, 4548),
                       _ring_pos(s, 0, 700),
                       torch.full((s,), -1, dtype=torch.int32)]).to(dev)
    lens = torch.tensor([3047, 4547, 699, 9], dtype=torch.int32, device=dev)
    k = torch.randn((4, s, hkv, dh), generator=gen).to(dev)
    v = torch.randn((4, s, hkv, dh), generator=gen).to(dev)
    kq, ks = QK.quantize_kv(k)
    vq, vs = QK.quantize_kv(v)
    q = torch.randn((4, hq, dh), generator=gen).to(dev).to(dtype)
    n0 = QK.launches.value
    got = QK.decode_attention_int8(q, kq, ks, vq, vs, pos, lens,
                                   window=window)
    assert QK.launches.value == n0 + 1
    want = ref.decode_attention_int8_ref(q.float(), kq, ks, vq, vs, pos,
                                         lens, window=window)
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    assert got.dtype == dtype
    assert bool(((got.float() - want).abs()
                 <= atol + rtol * want.abs()).all())
    assert bool((got[3] == 0).all())                 # no valid slot
    again = QK.decode_attention_int8(q, kq, ks, vq, vs, pos, lens,
                                     window=window)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_kernel3_refuses_a_head_dim_it_does_not_take():
    _needs_card()
    dev = torch.device("cuda")
    q = torch.zeros((1, 10, 96), dtype=torch.bfloat16, device=dev)
    kq = torch.zeros((1, 64, 1, 96), dtype=torch.int8, device=dev)
    sc = torch.ones((1, 64, 1), device=dev)
    pos = torch.zeros((1, 64), dtype=torch.int32, device=dev)
    n0 = QK.plain_calls.value
    with pytest.raises(ValueError, match="head_dim 96"):
        QK.decode_attention_int8(q, kq, sc, kq, sc, pos, pos[:, 0])
    assert QK.plain_calls.value == n0


def _cfg(arch):
    """Reduced, fp32; the hybrid keeps Dh 256 (one head, MQA of 2), the
    kernel 3 shape, and a window of 32 that the serve wraps."""
    cfg = get_arch(arch).reduced(layers=3, d_model=256, vocab=512)
    if arch.startswith("recurrent"):
        cfg = dataclasses.replace(cfg, num_heads=2, num_kv_heads=1,
                                  head_dim=256, window=32)
    return cfg


def _serve(params, cfg, dev, eager=False, **kw):
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(
        1, cfg.vocab_size, int(rng.integers(5, 40))).astype(np.int32),
        max_new_tokens=6) for i in range(6)]
    eng = ServingEngine(params, cfg, batch=4, cache_len=64, device=dev,
                        **kw)
    logits = []
    try:
        with (graphs.eager() if eager else contextlib.nullcontext()):
            for r in reqs:
                eng.submit(r)
            while eng.queue or any(s is not None for s in eng.slots):
                eng.step()
                logits.append(eng.last_logits.float().cpu())
                assert eng.step_idx < 200
        torch.cuda.synchronize()
        return {r.rid: list(r.generated) for r in eng.finished}, logits
    finally:
        eng.close()


HETERO = dict(backend="hetero", num_r_workers=2, paged_kv=True,
              page_size=16)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-2.7b"])
def test_recurrent_serve_graphs_equal_eager_and_colocated(arch):
    _needs_card()
    dev = torch.device("cuda")
    cfg = _cfg(arch)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    got, got_l = _serve(params, cfg, dev, **HETERO)
    eager, eager_l = _serve(params, cfg, dev, eager=True, **HETERO)
    assert got == eager
    assert all(torch.equal(a, b) for a, b in zip(got_l, eager_l))
    want, _ = _serve(params, cfg, dev, backend="colocated")
    assert got == want
    chunked, _ = _serve(params, cfg, dev, prefill_chunk=8, **HETERO)
    assert chunked == want
    if arch.startswith("recurrent"):
        QK.launches.reset()
        QK.plain_calls.reset()
        q8, _ = _serve(params, cfg, dev, quantized_kv=True, **HETERO)
        assert QK.launches.value > 0 and QK.plain_calls.value == 0
        assert sorted(q8) == sorted(want)
