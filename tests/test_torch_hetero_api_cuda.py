"""The static-batch API on the card: ``load_prefill`` then
``decode_step`` (CUDA graphs), ``decode_step_legacy`` (eager, replies on
each R-worker's reply queue, its event waited on by the S-stream) and the
two alternated, on a 2-layer paged engine; every run must give the same
tokens and logits within 1e-5 (fp32, TF32 off), launch kernel 1 on every
layer, micro-batch and worker of every step, and run no plain version.
``profile_timing`` gives the same tokens.  Marked ``cuda``: it skips
without a CUDA device.  It imports no JAX, so it runs on the card without
the JAX-importing conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_hetero_api_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch.core.config import get_arch
from repro_torch.core.hetero import ColocatedEngine, HeteroPipelineEngine
from repro_torch.kernels import paged_attention as TPA
from repro_torch.models import model as M

TOL = 1e-5
BATCH, NUM_MB, WORKERS, STEPS = 4, 2, 2, 6


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernels and CUDA graphs "
                    "have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _setup():
    cfg = dataclasses.replace(
        get_arch("llama-13b").reduced(layers=2, d_model=512, vocab=512),
        num_kv_heads=2)
    dev = torch.device("cuda")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(1, cfg.vocab_size, (BATCH, 40), generator=gen,
                         device=dev, dtype=torch.int32)
    plens = torch.tensor([40, 17, 33, 5], dtype=torch.int32, device=dev)
    return cfg, dev, params, toks, plens


def _run(cfg, dev, params, toks, plens, how, **kw):
    mb = BATCH // NUM_MB
    eng = HeteroPipelineEngine(params, cfg, batch=BATCH, cache_len=64,
                               num_r_workers=WORKERS,
                               num_microbatches=NUM_MB, paged_kv=True,
                               device=dev, **kw)
    try:
        for m in range(NUM_MB):
            eng.load_prefill(m, toks[m * mb:(m + 1) * mb],
                             plens[m * mb:(m + 1) * mb])
        tok = toks[torch.arange(BATCH, device=dev), plens.long() - 1][:, None]
        TPA.launches.reset()
        TPA.plain_calls.reset()
        out_t, out_l = [], []
        for i in range(STEPS):
            legacy = how == "legacy" or (how == "alternated" and i % 2 == 0)
            step = eng.decode_step_legacy if legacy else eng.decode_step
            ls = step([tok[m * mb:(m + 1) * mb] for m in range(NUM_MB)])
            logits = torch.cat(ls)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            out_t.append(tok[:, 0].cpu())
            out_l.append(logits.cpu())
        torch.cuda.synchronize()
        counts = (TPA.launches.value, TPA.plain_calls.value)
    finally:
        eng.close()
    return torch.stack(out_t), torch.stack(out_l), counts


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["legacy", "alternated"])
def test_legacy_step_equals_fused_on_card(how):
    _needs_card()
    cfg, dev, params, toks, plens = _setup()
    want_t, want_l, counts = _run(cfg, dev, params, toks, plens, "fused")
    n = cfg.num_layers * NUM_MB * WORKERS * STEPS
    assert counts == (n, 0)
    got_t, got_l, counts = _run(cfg, dev, params, toks, plens, how)
    assert counts == (n, 0)
    assert torch.equal(got_t, want_t)
    torch.testing.assert_close(got_l, want_l, atol=TOL, rtol=0)
    # the colocated oracle, fed the same tokens
    colo = ColocatedEngine(params, cfg, batch=BATCH, cache_len=64,
                           device=dev)
    colo.load_prefill(toks, plens)
    tok = toks[torch.arange(BATCH, device=dev), plens.long() - 1][:, None]
    for i in range(STEPS):
        lg = colo.decode_step(tok).cpu()
        torch.testing.assert_close(lg, want_l[i], atol=1e-4, rtol=0)
        tok = want_t[i][:, None].to(dev)


@pytest.mark.cuda
def test_profile_timing_same_tokens_on_card():
    _needs_card()
    cfg, dev, params, toks, plens = _setup()
    want_t, want_l, _ = _run(cfg, dev, params, toks, plens, "fused")
    got_t, got_l, _ = _run(cfg, dev, params, toks, plens, "alternated",
                           profile_timing=True)
    assert torch.equal(got_t, want_t)
    torch.testing.assert_close(got_l, want_l, atol=TOL, rtol=0)
