"""The port's train mode against the JAX package on the same weights
(carried over with repro_torch.bridge) and the same numpy batches:
``training.train.loss_fn`` and its gradients (autograd over
``models.model.train_forward``) against ``jax.value_and_grad`` of
``repro.training.train.loss_fn``, for one arch of every block kind and
FFN the port serves; three ``make_train_step`` steps against the
reference's loss trajectory; remat against no remat.

Traps held here:

* XATTN gates init to zero, which makes the block the identity and
  gives every cross projection a zero gradient: every comparison sets
  seeded non-zero gates (and norm scales) on the numpy side, and the
  vision model runs 10 layers (``tiny_cfg(layers=3)`` has no XATTN layer:
  its period is 5).
* The MoE capacity depends on t = B·S.  ``reduced()`` sets it to the
  expert count (nothing drops); one grok-1 case runs the published 1.25
  at equal B·S in both packages, where the drops must be the same.
* Adam turns a rounding difference in a near-zero gradient into a
  ±lr step, so train steps are held on the loss trajectory and on the
  gradients, not on the param bits after several steps.

fp32 tiny configs; the loss within 1e-5 relative, every gradient leaf
within rtol 1e-4, atol 1e-5; losses of three steps within 1e-4
relative.  JAX results are computed once per module."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.models import model as JM
from repro.training import train as JT
from repro_torch import bridge
from repro_torch.core.config import get_arch
from repro_torch.models import model as TM
from repro_torch.training import train as TT
from repro_torch.training.tree import leaves_with_path

LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TRAJ_RTOL = 1e-4
B, S, CHUNK = 2, 16, 8
# arch -> layers (vision: two periods of 4 ATTN + 1 XATTN)
ARCHS = {"qwen3-8b": 3, "granite-3-8b": 3, "opt-175b": 3,
         "grok-1-314b": 3, "llama4-scout-17b-a16e": 3,
         "recurrentgemma-2b": 3, "mamba2-2.7b": 3,
         "llama-3.2-vision-90b": 10, "whisper-medium": 3}
TRAJ_ARCHS = ("qwen3-8b", "grok-1-314b", "recurrentgemma-2b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(tree, rng):
    """Seeded non-zero XATTN gates and norm scales (both init to 0) on
    numpy leaves."""
    if isinstance(tree, list):
        return [_perturb(v, rng) for v in tree]
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            out[k] = _perturb(v, rng)
        elif k in ("gate_attn", "gate_ffn"):
            out[k] = rng.uniform(0.3, 1.2, v.shape).astype(np.float32)
        elif k.startswith("ln") or k.endswith("norm"):
            out[k] = v + 0.1 * rng.standard_normal(v.shape).astype(v.dtype)
        else:
            out[k] = v
    return out


def _case(arch, capacity=None):
    """(JAX cfg, port cfg, numpy params, numpy batch) of ``arch``: the
    same reduced config in both packages, a masked batch and, for an
    arch with a frontend, seeded features (an early-fusion arch's patch
    embeddings, a cross-attention arch's patches, whisper's frames)."""
    layers = ARCHS[arch]
    jcfg = tiny_cfg(arch, layers=layers)
    tcfg = get_arch(arch).reduced(layers=layers, d_model=64, vocab=97)
    if capacity is not None:
        jcfg = dataclasses.replace(jcfg, moe_capacity=capacity)
        tcfg = dataclasses.replace(tcfg, moe_capacity=capacity)
    rng = np.random.default_rng(sorted(ARCHS).index(arch))
    params = _perturb(jax.tree.map(
        np.asarray, JM.init_params(jax.random.PRNGKey(1), jcfg)), rng)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)).astype(
                 np.int32),
             "targets": rng.integers(0, jcfg.vocab_size, (B, S)).astype(
                 np.int32),
             "mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    if jcfg.frontend != "none":
        # early fusion replaces the first n token embeddings: half the
        # sequence, so that the embedding table still learns
        n = S // 2 if TM.early_fusion(tcfg) else jcfg.encoder_seq
        batch["enc_feats"] = rng.standard_normal(
            (B, n, jcfg.encoder_d_model)).astype(np.float32)
    return jcfg, tcfg, params, batch


_JAX_CACHE = {}


def _jax_loss_and_grads(key, jcfg, params, batch):
    if key not in _JAX_CACHE:
        f = jax.jit(jax.value_and_grad(
            partial(JT.loss_fn, cfg=jcfg, q_chunk=CHUNK, kv_chunk=CHUNK),
            has_aux=True))
        (loss, m), g = f(jax.tree.map(jnp.asarray, params),
                         batch={k: jnp.asarray(v) for k, v in batch.items()})
        _JAX_CACHE[key] = (float(loss), {k: float(v) for k, v in m.items()},
                           dict(leaves_with_path(jax.tree.map(np.asarray,
                                                              g))))
    return _JAX_CACHE[key]


def _port_loss_and_grads(tcfg, params, batch, remat=False):
    tp = bridge.params_from_numpy(params, tcfg, "cpu")
    (loss, m), g = TT.loss_and_grads(
        tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
        q_chunk=CHUNK, kv_chunk=CHUNK, remat=remat)
    return float(loss), {k: float(v) for k, v in m.items()}, \
        {p: t.numpy() for p, t in leaves_with_path(g)}


def _grads_close(got, want):
    assert set(got) == set(want)
    for path in sorted(want):
        np.testing.assert_allclose(got[path], want[path], err_msg=str(path),
                                   **GRAD_TOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_grads_match_jax(arch):
    jcfg, tcfg, params, batch = _case(arch)
    jl, jm, jg = _jax_loss_and_grads(arch, jcfg, params, batch)
    tl, tm, tg = _port_loss_and_grads(tcfg, params, batch)
    assert tl == pytest.approx(jl, rel=LOSS_RTOL)
    assert tm["ce"] == pytest.approx(jm["ce"], rel=LOSS_RTOL)
    assert tm["aux"] == pytest.approx(jm["aux"], rel=LOSS_RTOL, abs=1e-7)
    if jcfg.ffn_kind == "moe":
        # the router's load-balance loss is live and enters the total
        assert jcfg.router_aux_loss > 0 and jm["aux"] > 0.5
        assert jl != pytest.approx(jm["ce"], rel=1e-4)
    _grads_close(tg, jg)
    # every leaf learns: a zero gradient would hide a path autograd lost
    for path, g in tg.items():
        assert np.abs(g).max() > 0, path


def test_moe_capacity_drops_match_jax():
    """grok-1 at the published capacity 1.25, equal B·S in both
    packages: the same pairs drop, so loss and grads still agree."""
    jcfg, tcfg, params, batch = _case("grok-1-314b", capacity=1.25)
    jl, jm, jg = _jax_loss_and_grads("grok-1-314b@1.25", jcfg, params, batch)
    tl, tm, tg = _port_loss_and_grads(tcfg, params, batch)
    assert tl == pytest.approx(jl, rel=LOSS_RTOL)
    assert tm["aux"] == pytest.approx(jm["aux"], rel=LOSS_RTOL)
    _grads_close(tg, jg)
    # and capacity 1.25 does drop here: the loss differs from no drops
    nl, _, _ = _port_loss_and_grads(_case("grok-1-314b")[1], params, batch)
    assert nl != pytest.approx(tl, rel=1e-6)


@pytest.mark.parametrize("arch", TRAJ_ARCHS)
def test_train_steps_track_jax(arch):
    """Three make_train_step steps from one state (warmup 2, so the lr
    ramps and then decays): the loss trajectory and the grad norms."""
    jcfg, tcfg, params, batch = _case(arch)
    kw = dict(peak_lr=1e-2, warmup=2, total_steps=6, q_chunk=CHUNK,
              kv_chunk=CHUNK)
    init, step = JT.make_train_step(jcfg, **kw)
    jstep = jax.jit(step)
    st = init(jax.tree.map(jnp.asarray, params))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = []
    for _ in range(3):
        st, m = jstep(st, jb)
        want.append((float(m["loss"]), float(m["grad_norm"])))
    init_t, step_t = TT.make_train_step(tcfg, **kw)
    ts = init_t(bridge.params_from_numpy(params, tcfg, "cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = []
    for _ in range(3):
        ts, m = step_t(ts, tb)
        got.append((float(m["loss"]), float(m["grad_norm"])))
    assert int(ts.opt.step) == 3
    for (gl, gn), (wl, wn) in zip(got, want):
        assert gl == pytest.approx(wl, rel=TRAJ_RTOL)
        assert gn == pytest.approx(wn, rel=TRAJ_RTOL)
    # the steps trained: the same batch's loss fell
    assert got[-1][0] < got[0][0]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_remat_matches_no_remat(arch):
    """Remat recomputes the same ops: the loss bit for bit, the grads
    within tolerance (twin of tests/test_training.py's, every arch)."""
    _, tcfg, params, batch = _case(arch)
    l0, _, g0 = _port_loss_and_grads(tcfg, params, batch)
    l1, _, g1 = _port_loss_and_grads(tcfg, params, batch, remat=True)
    assert l0 == l1
    _grads_close(g1, g0)


@pytest.mark.parametrize("arch,layers", [("qwen3-8b", 3),
                                         ("recurrentgemma-2b", 5)])
def test_remat_checkpoints_each_full_period(arch, layers, monkeypatch):
    """One checkpoint per full pattern period, none for the remainder
    blocks (the JAX package checkpoints its scan body only):
    recurrentgemma at 5 layers is one period of 3 and 2 remainder
    blocks."""
    tcfg = get_arch(arch).reduced(layers=layers, d_model=64, vocab=97)
    params = bridge.params_to_numpy(TM.init_params(
        tcfg, torch.Generator().manual_seed(0), "cpu"))
    batch = _case(arch)[3]
    spans = []
    real = TM.checkpoint

    def counted(fn, lo, hi, *a, **kw):
        spans.append((lo, hi))
        return real(fn, lo, hi, *a, **kw)
    monkeypatch.setattr(TM, "checkpoint", counted)
    l1, _, g1 = _port_loss_and_grads(tcfg, params, batch, remat=True)
    period = len(tcfg.layer_pattern)
    assert spans == [(i * period, (i + 1) * period)
                     for i in range(layers // period)]
    monkeypatch.setattr(TM, "checkpoint", real)
    l0, _, g0 = _port_loss_and_grads(tcfg, params, batch)
    assert l0 == l1
    _grads_close(g1, g0)


def test_train_forward_leaves_params_untouched_and_needs_features():
    """No in-place write on the train path: params are bit for bit what
    they were after a forward and backward; a cross-attention arch
    without features raises, as prefill does."""
    _, tcfg, params, batch = _case("recurrentgemma-2b")
    tp = bridge.params_from_numpy(params, tcfg, "cpu")
    before = {p: t.clone() for p, t in leaves_with_path(tp)}
    TT.loss_and_grads(tp, tcfg, {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                      q_chunk=CHUNK, kv_chunk=CHUNK)
    for p, t in leaves_with_path(tp):
        assert torch.equal(t, before[p]), p
        assert not t.requires_grad, p
    _, vcfg, vparams, vbatch = _case("whisper-medium")
    with pytest.raises(ValueError, match="enc_feats"):
        TM.train_forward(bridge.params_from_numpy(vparams, vcfg, "cpu"),
                         vcfg, torch.from_numpy(vbatch["tokens"]))
