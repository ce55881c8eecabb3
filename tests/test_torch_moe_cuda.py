"""The MoE FFN and the MoE models on the card: ``layers.moe_ffn`` on CUDA
against the same call on the CPU (fp32, TF32 off: y within 1e-5, the
same routing and keep mask), a captured ``moe_ffn`` replayed against its
eager run (bit for bit: no atomics, a fixed summation order), and the
reduced grok-1 (G = 6, softcap 30) and llama4-scout (G = 5, the vision
stub) served through ServingEngine(backend="hetero", num_r_workers=2,
paged_kv=True): graphs == eager bit for bit at the published capacity,
== colocated at capacity = experts, kernel 1 on every decode R-Part and
no plain version; llama4-scout's ``load_prefill(enc_feats=...)`` hetero
== colocated.  Marked ``cuda``: they skip without a CUDA device.  This
file imports no JAX, so it runs on the card without the JAX-importing
conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_moe_cuda.py
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import graphs
from repro_torch.core.config import get_arch
from repro_torch.core.hetero import ColocatedEngine, HeteroPipelineEngine
from repro_torch.kernels import paged_attention as TPA
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request

TOL = 1e-5


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernels and CUDA graphs "
                    "have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _moe_params(gen, d, f, e, dtype, dev):
    """Expert weights at 0.05 (outputs of order 1, so fp32's reordered
    sums stay inside 1e-5; at 0.2 they reach ~100)."""
    def mk(*s, sc=0.05):
        return (torch.randn(s, generator=gen) * sc).to(dtype).to(dev)
    return {"router": mk(d, e, sc=1.0), "w_gate": mk(e, d, f),
            "w_up": mk(e, d, f), "w_down": mk(e, f, d)}


@pytest.mark.cuda
@pytest.mark.parametrize("t", [4, 13, 512])
@pytest.mark.parametrize("top_k,e", [(1, 16), (2, 8)])
def test_moe_ffn_on_the_card_equals_the_cpu(top_k, e, t):
    _needs_card()
    gen = torch.Generator().manual_seed(t)
    d, f = 256, 384
    p = _moe_params(gen, d, f, e, torch.float32, "cpu")
    x = torch.randn((t, d), generator=gen)
    dev = torch.device("cuda")
    want, want_aux = L.moe_ffn(p, x, num_experts=e, top_k=top_k,
                               capacity_factor=1.25)
    got, got_aux = L.moe_ffn({k: v.to(dev) for k, v in p.items()}, x.to(dev),
                             num_experts=e, top_k=top_k,
                             capacity_factor=1.25)
    torch.testing.assert_close(got.cpu(), want, atol=TOL, rtol=0)
    torch.testing.assert_close(got_aux.cpu(), want_aux, atol=TOL, rtol=0)
    probs = torch.softmax(x @ p["router"], -1)
    r_cpu = L.moe_route(probs, top_k=top_k, capacity_factor=1.25)
    r_dev = L.moe_route(probs.to(dev), top_k=top_k, capacity_factor=1.25)
    for a, b in zip(r_cpu[1:4], r_dev[1:4]):
        assert torch.equal(a, b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_moe_ffn_graph_replay_equals_eager_bitwise(dtype):
    _needs_card()
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(3)
    p = _moe_params(gen, 256, 512, 8, dt, dev)
    x = torch.randn((4, 256), generator=gen).to(dt).to(dev)
    eager, _ = L.moe_ffn(p, x, num_experts=8, top_k=2, capacity_factor=1.25)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        L.moe_ffn(p, x, num_experts=8, top_k=2, capacity_factor=1.25)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out, _ = L.moe_ffn(p, x, num_experts=8, top_k=2,
                           capacity_factor=1.25)
    for _ in range(3):
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def _cfg(arch, capacity=None):
    """Reduced, fp32, Dh 64 (a shape the kernels take), the published
    head ratio: grok-1 12 / 2 (G = 6, softcap 30), llama4-scout 10 / 2
    (G = 5)."""
    cfg = get_arch(arch).reduced(layers=2, d_model=640, vocab=512)
    hq = 12 if arch.startswith("grok") else 10
    cfg = dataclasses.replace(cfg, num_heads=hq, num_kv_heads=2,
                              head_dim=64)
    if capacity is not None:
        cfg = dataclasses.replace(cfg, moe_capacity=capacity)
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
@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-scout-17b-a16e"])
def test_moe_serve_graphs_equal_eager_and_colocated(arch):
    _needs_card()
    dev = torch.device("cuda")
    for capacity in (1.25, None):
        cfg = _cfg(arch, capacity)
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
            0), device=dev)
        TPA.launches.reset()
        TPA.plain_calls.reset()
        got, got_l = _serve(params, cfg, dev, **HETERO)
        assert TPA.launches.value > 0 and TPA.plain_calls.value == 0
        eager, eager_l = _serve(params, cfg, dev, eager=True, **HETERO)
        assert got == eager
        assert all(torch.equal(a, b) for a, b in zip(got_l, eager_l))
        if capacity is None:          # reduced(): capacity = experts
            want, _ = _serve(params, cfg, dev, backend="colocated")
            assert got == want


@pytest.mark.cuda
def test_load_prefill_early_fusion_hetero_equals_colocated():
    _needs_card()
    dev = torch.device("cuda")
    cfg = _cfg("llama4-scout-17b-a16e")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(1, cfg.vocab_size, (4, 40), generator=gen,
                         device=dev, dtype=torch.int32)
    plens = torch.tensor([40, 23, 31, 20], dtype=torch.int32, device=dev)
    feats = torch.randn((4, cfg.encoder_seq, cfg.d_model), generator=gen,
                        device=dev)
    het = HeteroPipelineEngine(params, cfg, batch=4, cache_len=64,
                               num_r_workers=2, num_microbatches=2,
                               paged_kv=True, device=dev)
    col = ColocatedEngine(params, cfg, batch=4, cache_len=64, device=dev)
    try:
        for m in range(2):
            het.load_prefill(m, toks[2 * m:2 * m + 2], plens[2 * m:2 * m + 2],
                             enc_feats=feats[2 * m:2 * m + 2])
        col.load_prefill(toks, plens, enc_feats=feats)
        tok = toks[torch.arange(4, device=dev), plens.long() - 1][:, None]
        for _ in range(4):
            a = torch.cat(het.decode_step([tok[:2], tok[2:]]))
            b = col.decode_step(tok)
            torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
            tok = b.argmax(-1)[:, None].to(torch.int32)
    finally:
        het.close()
