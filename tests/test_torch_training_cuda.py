"""The training slice on the card: the port's loss and grads on CUDA
against the same code on the CPU (fp32, TF32 off), remat against no
remat, AdamW on identical grads, a bf16 checkpoint round trip from the
card, and the train launcher with no ``--device`` (the card).  Marked
``cuda``: they skip without a CUDA device.  This file imports no JAX, so
it runs on the card without the JAX-importing conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_training_cuda.py
"""
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.core.config import get_arch
from repro_torch.models import model as M
from repro_torch.training import checkpoint as CK
from repro_torch.training import optimizer as O
from repro_torch.training.train import loss_and_grads, make_train_step
from repro_torch.training.tree import leaves_with_path, tree_map

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the train path's card run)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _case(arch, layers, dtype="float32", seed=0):
    cfg = dataclasses.replace(get_arch(arch).reduced(layers=layers),
                              dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    params = M.init_params(cfg, gen, "cpu")
    for path, t in leaves_with_path(params):
        if path[-1] in ("gate_attn", "gate_ffn"):
            t.copy_(0.3 + torch.rand(t.shape, generator=gen))
    b, s = 2, 32
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen),
             "targets": torch.randint(0, cfg.vocab_size, (b, s),
                                      generator=gen),
             "mask": (torch.rand((b, s), generator=gen) > 0.2).float()}
    if cfg.frontend != "none":
        n = s // 2 if M.early_fusion(cfg) else cfg.encoder_seq
        batch["enc_feats"] = torch.randn((b, n, cfg.encoder_d_model),
                                         generator=gen)
    return cfg, params, batch


def _to(tree, dev):
    return tree_map(lambda t: t.to(dev), tree)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers", [
    ("qwen3-8b", 3), ("grok-1-314b", 3), ("llama4-scout-17b-a16e", 3),
    ("recurrentgemma-2b", 3), ("mamba2-2.7b", 2),
    ("llama-3.2-vision-90b", 5), ("whisper-medium", 2)])
def test_loss_and_grads_card_vs_cpu(arch, layers):
    _needs_card()
    cfg, params, batch = _case(arch, layers)
    dev = torch.device("cuda")
    kw = dict(q_chunk=16, kv_chunk=16)
    (lc, _), gc = loss_and_grads(params, cfg, batch, **kw)
    (ld, _), gd = loss_and_grads(_to(params, dev), cfg, _to(batch, dev),
                                 **kw)
    (lr, _), gr = loss_and_grads(_to(params, dev), cfg, _to(batch, dev),
                                 remat=True, **kw)
    assert float(ld) == pytest.approx(float(lc), rel=LOSS_RTOL)
    assert float(lr) == float(ld)
    want = dict(leaves_with_path(gc))
    for name, got in (("card", gd), ("remat", gr)):
        for path, g in leaves_with_path(got):
            assert g.device.type == "cuda"
            torch.testing.assert_close(g.cpu(), want[path], **GRAD_TOL,
                                       msg=f"{name} {path}")


@pytest.mark.cuda
def test_adamw_card_vs_cpu_on_identical_grads():
    _needs_card()
    cfg, params, _ = _case("recurrentgemma-2b", 5, seed=3)
    gen = torch.Generator().manual_seed(4)
    grads = [tree_map(lambda p: torch.randn(p.shape, generator=gen)
                      * 10.0 ** float(torch.randint(-6, 1, (), generator=gen)),
                      params) for _ in range(3)]
    dev = torch.device("cuda")
    init, upd = O.adamw(O.cosine_warmup(1e-2, 2, 6))
    pc, pd = tree_map(torch.clone, params), _to(params, dev)
    sc, sd = init(pc), init(pd)
    for g in grads:
        pc, sc, nc = upd(g, sc, pc)
        pd, sd, nd = upd(_to(g, dev), sd, pd)
        assert float(nd) == pytest.approx(float(nc), rel=1e-6)
        for a, b in ((pd, pc), (sd.mu, sc.mu), (sd.nu, sc.nu)):
            for (path, x), (_, y) in zip(leaves_with_path(a),
                                         leaves_with_path(b)):
                scale = float(y.abs().max())
                torch.testing.assert_close(x.cpu(), y, rtol=1e-6,
                                           atol=1e-6 * scale,
                                           msg=str(path))


@pytest.mark.cuda
def test_bf16_train_steps_and_checkpoint_from_the_card(tmp_path):
    """bf16 on the card: finite losses, remat's first loss bit for bit
    no remat's, fp32 moments; the trained params saved and loaded back
    onto the card bit for bit."""
    _needs_card()
    dev = torch.device("cuda")
    cfg, params, batch = _case("qwen3-8b", 2, dtype="bfloat16")
    losses = {}
    for remat in (False, True):
        init, step = make_train_step(cfg, peak_lr=1e-3, warmup=1,
                                     total_steps=4, remat=remat,
                                     q_chunk=16, kv_chunk=16)
        st = init(_to(params, dev))
        out = []
        for _ in range(3):
            st, m = step(st, _to(batch, dev))
            out.append(float(m["loss"]))
        losses[remat] = out
        assert all(t.dtype == torch.float32
                   for _, t in leaves_with_path(st.opt.mu))
    assert losses[True][0] == losses[False][0]
    assert all(abs(a - b) <= 2.0 ** -7 * abs(b)
               for a, b in zip(losses[True], losses[False]))
    path = str(tmp_path / "ck.npz")
    CK.save(path, st.params)
    got = CK.load(path, st.params)
    for (p, a), (_, b) in zip(leaves_with_path(got),
                              leaves_with_path(st.params)):
        assert a.device == b.device and a.dtype == b.dtype, p
        assert torch.equal(a, b), p


@pytest.mark.cuda
def test_train_launcher_defaults_to_the_card():
    _needs_card()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-8b", "--reduced", "--layers", "2", "--d-model", "64",
         "--steps", "8", "--batch", "2", "--seq", "32", "--log-every", "4"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert p.returncode == 0, p.stdout + p.stderr
    assert len([ln for ln in p.stdout.splitlines()
                if ln.startswith("step")]) == 3
