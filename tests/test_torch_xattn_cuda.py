"""The cross-attention slice on the card: kernel 2 as the cross-attention
R-Part at whisper-medium's heads (Hq = Hkv = 16, Dh 64, 1500 frames) and
llama-3.2-vision-90b's (Hq 64 / Hkv 8, Dh 128, 1600 patches), bf16 and
fp32 q, against its plain version; ``r_cross_attention`` on CUDA tensors
launching it; and reduced whisper and vision models (fp32, TF32 off,
non-zero gates) through the static-batch API, HeteroPipelineEngine with
paged_kv (graphs and eager) == ColocatedEngine, with kernel 2 on every
cross-attention R-Part and kernel 1 on every paged ATTN layer.  Marked
``cuda``: they skip without a CUDA device.  This file imports no JAX, so
it runs on the card without the JAX-importing conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_xattn_cuda.py
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import decompose as D
from repro_torch.core import graphs
from repro_torch.core.config import get_arch
from repro_torch.core.hetero import ColocatedEngine, HeteroPipelineEngine
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import ref
from repro_torch.models import model as M

# kernel vs plain version: |out - want| <= atol + rtol * |want| (in bf16
# one rounding step of the output, 2^-7)
TOL = {torch.bfloat16: (1e-4, 2.0 ** -7), torch.float32: (1e-5, 0.0)}
# (Hq, Hkv, Dh, S): whisper-medium's and llama-3.2-vision-90b's
CROSS = {"whisper": (16, 16, 64, 1500), "vision": (64, 8, 128, 1600)}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernels and CUDA graphs "
                    "have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("b", [2, 9])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", sorted(CROSS))
def test_kernel2_at_the_cross_shapes(shape, dtype, b):
    _needs_card()
    dev = torch.device("cuda")
    hq, hkv, dh, s = CROSS[shape]
    gen = torch.Generator().manual_seed(b)
    q = torch.randn((b, hq, dh), generator=gen).to(dev, dtype)
    k = torch.randn((b, s, hkv, dh), generator=gen).to(dev, dtype)
    v = torch.randn((b, s, hkv, dh), generator=gen).to(dev, dtype)
    pos = D.cross_pos(b, s, dev)
    lens = torch.arange(b, dtype=torch.int32, device=dev) * 37
    n0 = DA.launches.value
    got = DA.decode_attention(q, k, v, pos, lens)
    assert DA.launches.value == n0 + 1
    want = ref.decode_attention_ref(q, k, v, pos, lens)
    atol, rtol = TOL[dtype]
    err = (got.float() - want.float()).abs()
    assert bool((err <= atol + rtol * want.float().abs()).all()), \
        float(err.max())
    assert torch.equal(got, DA.decode_attention(q, k, v, pos, lens))


@pytest.mark.cuda
def test_r_cross_attention_launches_kernel2():
    _needs_card()
    dev = torch.device("cuda")
    hq, hkv, dh, s = CROSS["whisper"]
    gen = torch.Generator(device=dev).manual_seed(0)
    st = {"xk": torch.randn((2, s, hkv, dh), generator=gen, device=dev),
          "xv": torch.randn((2, s, hkv, dh), generator=gen, device=dev)}
    r_in = {"q": torch.randn((2, 1, hq, dh), generator=gen, device=dev),
            "lengths": torch.tensor([3, 700], dtype=torch.int32, device=dev)}
    n0, p0 = DA.launches.value, DA.plain_calls.value
    out, _ = D.r_cross_attention(r_in, st)
    assert (DA.launches.value, DA.plain_calls.value) == (n0 + 1, p0)
    want = ref.decode_attention_ref(r_in["q"][:, 0], st["xk"], st["xv"],
                                    D.cross_pos(2, s, dev),
                                    r_in["lengths"])
    assert float((out["o"][:, 0] - want).abs().max()) <= 1e-5


def _model(arch, layers):
    cfg = dataclasses.replace(get_arch(arch).reduced(layers=layers),
                              dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cuda")
    gen = torch.Generator().manual_seed(2)
    for blk in list(params["stack"].values()) + params["rem"]:
        for k in ("gate_attn", "gate_ffn"):
            if k in blk:     # 0 at init: the block would be the identity
                blk[k].copy_(0.3 + torch.rand(blk[k].shape, generator=gen))
    return cfg, params


def _static(eng, toks, feats, steps, colocated=False):
    b, s = toks.shape
    plens = torch.full((b,), s, dtype=torch.int32, device="cuda")
    if colocated:
        eng.load_prefill(toks, plens, enc_feats=feats)
    else:
        h = b // 2
        for m in range(2):
            eng.load_prefill(m, toks[m * h:(m + 1) * h],
                             plens[m * h:(m + 1) * h],
                             enc_feats=feats[m * h:(m + 1) * h])
    tok = toks[:, -1:]
    out = []
    for _ in range(steps):
        lg = (eng.decode_step(tok) if colocated else
              torch.cat(eng.decode_step([tok[:b // 2], tok[b // 2:]])))
        out.append(lg.float().cpu())
        tok = lg.argmax(-1)[:, None].to(torch.int32)
    return torch.stack(out)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers", [("whisper-medium", 2),
                                         ("llama-3.2-vision-90b", 5)])
def test_hetero_equals_colocated_on_the_card(arch, layers):
    _needs_card()
    cfg, params = _model(arch, layers)
    b, s, steps = 4, 9, 4
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(1, cfg.vocab_size, (b, s), generator=gen,
                         dtype=torch.int32).cuda()
    feats = torch.randn((b, cfg.encoder_seq, cfg.encoder_d_model),
                        generator=gen).cuda()
    want = _static(ColocatedEngine(params, cfg, batch=b, cache_len=32,
                                   device="cuda"), toks, feats, steps,
                   colocated=True)
    runs = {}
    for mode in ("graphs", "eager"):
        with (graphs.eager() if mode == "eager"
              else contextlib.nullcontext()):
            eng = HeteroPipelineEngine(params, cfg, batch=b, cache_len=32,
                                       num_r_workers=2, paged_kv=True,
                                       device="cuda")
            try:
                n1, n2 = PA.launches.value, DA.launches.value
                runs[mode] = _static(eng, toks, feats, steps)
                n1, n2 = PA.launches.value - n1, DA.launches.value - n2
            finally:
                eng.close()
        n_cross = sum(k in ("xattn", "dec_xattn") for k in cfg.pattern)
        assert n2 == n_cross * 2 * 2 * steps
        assert n1 == cfg.pattern.count("attn") * 2 * 2 * steps
    assert torch.equal(runs["graphs"], runs["eager"])
    assert float((runs["graphs"] - want).abs().max()) < 1e-4
    assert np.array_equal(runs["graphs"].argmax(-1).numpy(),
                          want.argmax(-1).numpy())
