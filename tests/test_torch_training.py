"""The port's training substrate against the JAX package, and twins of
every test in ``tests/test_training.py``:

* ``training.data``: the same batches as ``repro.training.data`` for the
  same ``DataConfig`` (the synthetic stream and the memmap ``file=``);
* ``training.optimizer``: ``adamw`` and ``cosine_warmup`` on IDENTICAL
  gradients, where the two agree to fp32 rounding (rtol 1e-6): Adam
  turns a rounding difference in a near-zero gradient into a ±lr step,
  so the optimizer is held on equal inputs, whole train steps on their
  loss trajectory (tests/test_torch_train_forward.py).  The reference
  decays by rank, which on the stacked layout decays a full period's
  norm scales and not a remainder block's: held here too;
* ``training.checkpoint``: npz members byte-identical to the
  reference's for one tree (bf16 and fp32); the port reads the
  reference's bf16 file bit for bit, beside a test showing the
  reference's own ``load`` failing on it; the reference reads the
  port's fp32 file; shape and key mismatches raise."""
import dataclasses
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.models import model as JM
from repro.training import checkpoint as JCK
from repro.training import optimizer as JO
from repro.training.data import DataConfig as JDataConfig
from repro.training.data import SyntheticLM as JSyntheticLM
from repro_torch import bridge
from repro_torch.core.config import get_arch
from repro_torch.models import model as TM
from repro_torch.training import checkpoint as CK
from repro_torch.training import optimizer as TO
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.train import loss_and_grads, make_train_step
from repro_torch.training.tree import leaves, leaves_with_path

OPT_RTOL = 1e-6
_jinit = jax.jit(JM.init_params, static_argnums=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the other port tests: the suite runs in
    several test processes at once, and torch's thread pools
    oversubscribe the cores (this file's 100-step train loop took
    minutes that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tcfg(arch, **kw):
    kw = dict(dict(layers=3, d_model=64, vocab=97), **kw)
    return get_arch(arch).reduced(**kw)


def _tparams(cfg, seed=0):
    return TM.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,seq,batch,seed", [(64, 16, 2, 7),
                                                  (97, 33, 3, 0),
                                                  (1000, 128, 4, 5)])
def test_synthetic_stream_matches_jax(vocab, seq, batch, seed):
    ours = SyntheticLM(DataConfig(vocab, seq, batch, seed=seed)).batches()
    ref = JSyntheticLM(JDataConfig(vocab, seq, batch, seed=seed)).batches()
    for _ in range(4):
        a, b = next(ours), next(ref)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_memmap_file_stream_matches_jax(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.arange(1000, dtype=np.int32).tofile(path)
    ours = SyntheticLM(DataConfig(50, 31, 3, file=path)).batches()
    ref = JSyntheticLM(JDataConfig(50, 31, 3, file=path)).batches()
    # 96 tokens a batch: the 11th batch wraps around to the file's start
    for _ in range(12):
        a, b = next(ours), next(ref)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_synthetic_data_deterministic():
    """Twin of tests/test_training.py::test_synthetic_data_deterministic."""
    a = next(SyntheticLM(DataConfig(64, 16, 2, seed=7)).batches())
    b = next(SyntheticLM(DataConfig(64, 16, 2, seed=7)).batches())
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["targets"][:, :-1])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def _opt_tree(rng):
    """A param tree of the hybrid at 5 layers (one full period of 3, two
    remainder blocks: stacked [1, d] norms and per-layer constants beside
    the remainder's [d] ones), fp32, with non-zero norm scales, and
    seeded gradients of mixed scales (tiny ones included)."""
    cfg = tiny_cfg("recurrentgemma-2b", layers=5)
    params = _np_tree(_jinit(jax.random.PRNGKey(3), cfg))
    params = jax.tree.map(
        lambda x: x + 0.05 * rng.standard_normal(x.shape).astype(x.dtype),
        params)
    grads = [jax.tree.map(
        lambda x: (rng.standard_normal(x.shape)
                   * 10.0 ** rng.integers(-6, 1)).astype(np.float32),
        params) for _ in range(3)]
    return params, grads


def _assert_tree_close(got, want, rtol=OPT_RTOL):
    """Each leaf within fp32 rounding: ``rtol`` of each element and of the
    leaf's largest magnitude (an update that cancels a param to near
    zero keeps the rounding of the operands, not of the result)."""
    want = dict(leaves_with_path(want))
    got = dict(leaves_with_path(got))
    assert set(got) == set(want)
    for p in sorted(want):
        w = np.asarray(want[p], np.float64)
        np.testing.assert_allclose(np.asarray(got[p], np.float64), w,
                                   rtol=rtol,
                                   atol=rtol * float(np.abs(w).max(
                                       initial=0.0)),
                                   err_msg=str(p))


@pytest.mark.parametrize("sched,clip,wd", [("const", 1.0, 0.1),
                                           ("cosine", 1.0, 0.1),
                                           ("cosine", 0.0, 0.0),
                                           ("const", 1e3, 0.3)])
def test_adamw_matches_jax_on_identical_grads(sched, clip, wd):
    rng = np.random.default_rng(11)
    params, grads = _opt_tree(rng)
    jlr = JO.cosine_warmup(1e-2, 2, 6) if sched == "cosine" else 1e-2
    tlr = TO.cosine_warmup(1e-2, 2, 6) if sched == "cosine" else 1e-2
    jinit, jupd = JO.adamw(jlr, weight_decay=wd, grad_clip=clip)
    jupd = jax.jit(jupd)
    tinit, tupd = TO.adamw(tlr, weight_decay=wd, grad_clip=clip)
    jp = jax.tree.map(jnp.asarray, params)
    js = jinit(jp)
    tp = jax.tree.map(_t, params)
    ts = tinit(tp)
    for g in grads:
        jp, js, jn = jupd(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tn = tupd(jax.tree.map(_t, g), ts, tp)
        assert float(tn) == pytest.approx(float(jn), rel=OPT_RTOL)
        assert int(ts.step) == int(js.step)
        _assert_tree_close(tp, _np_tree(jp))
        _assert_tree_close(ts.mu, _np_tree(js.mu))
        _assert_tree_close(ts.nu, _np_tree(js.nu))
    # the bridge carries the state across both ways
    back = bridge.opt_state_to_numpy(ts)
    assert int(back[0]) == 3
    _assert_tree_close(bridge.opt_state_from_numpy(back, "cpu").mu,
                       _np_tree(js.mu))


def test_adamw_bf16_params_keep_fp32_moments_and_their_dtype():
    """bf16 weights, fp32 norms: moments fp32 whatever the param dtype,
    each leaf back in its own dtype, params within one bf16 rounding of
    the reference (their fp32 values agree to rounding, so a bf16 cast
    may round either way at a tie)."""
    rng = np.random.default_rng(5)
    cfg = dataclasses.replace(tiny_cfg("qwen3-8b"), dtype="bfloat16")
    jp = _jinit(jax.random.PRNGKey(2), cfg)
    g = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape), x.dtype), jp)
    jinit, jupd = JO.adamw(1e-2)
    jupd = jax.jit(jupd)
    jnew, js, _ = jupd(g, jinit(jp), jp)
    tcfg = dataclasses.replace(_tcfg("qwen3-8b"), dtype="bfloat16")
    as_bits = lambda t: jax.tree.map(          # noqa: E731
        lambda x: np.asarray(x).view(np.uint16)
        if x.dtype == jnp.bfloat16 else np.asarray(x), t)
    tp = bridge.params_from_numpy(as_bits(jp), tcfg, "cpu")
    tinit, tupd = TO.adamw(1e-2)
    tnew, ts, _ = tupd(bridge.params_from_numpy(as_bits(g), tcfg, "cpu"),
                       tinit(tp), tp)
    for (path, t), (_, j) in zip(leaves_with_path(tnew),
                                 leaves_with_path(jnew)):
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32),
                                   rtol=2.0 ** -7, atol=1e-6,
                                   err_msg=str(path))
    assert all(m.dtype == torch.float32 for m in leaves(ts.mu))
    _assert_tree_close(ts.mu, _np_tree(js.mu))


def test_adamw_decays_by_rank_on_the_stacked_layout():
    """With zero gradients only the decay moves a param: a full period's
    stacked norm scales and per-layer constants ([n_full, d]) decay, a
    remainder block's ([d]) and the final norm do not, in both
    packages."""
    rng = np.random.default_rng(2)
    params, _ = _opt_tree(rng)
    zeros = jax.tree.map(np.zeros_like, params)
    jinit, jupd = JO.adamw(1e-2, weight_decay=0.5)
    jupd = jax.jit(jupd)
    jp = jax.tree.map(jnp.asarray, params)
    jnew, _, _ = jupd(jax.tree.map(jnp.asarray, zeros), jinit(jp), jp)
    tinit, tupd = TO.adamw(1e-2, weight_decay=0.5)
    tp = jax.tree.map(_t, params)
    tnew, _, _ = tupd(jax.tree.map(_t, zeros), tinit(tp), tp)
    _assert_tree_close(tnew, _np_tree(jnew))
    moved = {p for p, x in leaves_with_path(_np_tree(jnew))
             if not np.array_equal(x, dict(leaves_with_path(params))[p])}
    for name in ("ln1", "ln2", "lam", "b_a"):
        assert ("stack", "s0", name) in moved
        assert ("rem", 0, name) not in moved
    assert ("final_norm",) not in moved
    assert ("stack", "s0", "w_a") in moved and ("rem", 0, "w_a") in moved


@pytest.mark.parametrize("total", [10, 100])
def test_cosine_warmup_matches_jax(total):
    jf, tf = JO.cosine_warmup(3e-4, 10, total), TO.cosine_warmup(3e-4, 10,
                                                                total)
    for s in range(total + 5):
        want = float(jf(jnp.asarray(s, jnp.int32)))
        got = float(tf(torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=OPT_RTOL, abs=1e-12), s


def test_adamw_grad_clip():
    """Twin of tests/test_training.py::test_adamw_grad_clip."""
    init, update = TO.adamw(1e-2, grad_clip=1.0, weight_decay=0.0)
    p = {"w": torch.ones((4, 4))}
    st = init(p)
    g = {"w": torch.full((4, 4), 100.0)}
    newp, st, gnorm = update(g, st, {"w": p["w"].clone()})
    assert float(gnorm) == pytest.approx(400.0)
    assert float((newp["w"] - p["w"]).abs().max()) < 0.05


def test_cosine_warmup_shape():
    """Twin of tests/test_training.py::test_cosine_warmup_shape."""
    fn = TO.cosine_warmup(1.0, warmup=10, total=100)
    assert float(fn(torch.tensor(0))) == 0.0
    assert float(fn(torch.tensor(10))) == pytest.approx(1.0, rel=0.05)
    assert float(fn(torch.tensor(100))) == pytest.approx(0.1, rel=0.05)


# ---------------------------------------------------------------------------
# train step (twins of tests/test_training.py)
# ---------------------------------------------------------------------------
def test_loss_decreases():
    """Twin of tests/test_training.py::test_loss_decreases."""
    torch.manual_seed(0)
    cfg = _tcfg("granite-3-8b", layers=2, d_model=64, vocab=128)
    params = _tparams(cfg)
    data = SyntheticLM(DataConfig(128, 32, 8, seed=0)).batches()
    init_state, train_step = make_train_step(cfg, peak_lr=5e-3, warmup=10,
                                             total_steps=300, q_chunk=8,
                                             kv_chunk=8)
    state = init_state(params)
    losses = []
    for _ in range(100):
        b = next(data)
        state, m = train_step(state, {k: _t(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.15


def test_remat_matches_no_remat():
    """Twin of tests/test_training.py::test_remat_matches_no_remat."""
    cfg = _tcfg("granite-3-8b", layers=3, d_model=64)
    params = _tparams(cfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": _t(rng.integers(0, cfg.vocab_size, (2, 16))),
             "targets": _t(rng.integers(0, cfg.vocab_size, (2, 16))),
             "mask": torch.ones((2, 16))}
    (l1, _), g1 = loss_and_grads(params, cfg, batch, q_chunk=8, kv_chunk=8,
                                 remat=False)
    (l2, _), g2 = loss_and_grads(params, cfg, batch, q_chunk=8, kv_chunk=8,
                                 remat=True)
    assert abs(float(l1) - float(l2)) < 1e-5
    for a, b in zip(leaves(g1), leaves(g2)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------
def _members(path):
    with zipfile.ZipFile(path) as z:
        return [(i.filename, z.read(i.filename)) for i in z.infolist()]


@pytest.mark.parametrize("arch,dtype", [("grok-1-314b", "float32"),
                                        ("whisper-medium", "float32"),
                                        ("recurrentgemma-2b", "bfloat16")])
def test_checkpoint_members_byte_identical_to_jax(arch, dtype, tmp_path):
    """One tree saved by either package: the same members, in the same
    order, with the same bytes (bf16 leaves as ``|V2`` bits)."""
    cfg = dataclasses.replace(tiny_cfg(arch, layers=4), dtype=dtype)
    jp = _jinit(jax.random.PRNGKey(4), cfg)
    tcfg = dataclasses.replace(_tcfg(arch, layers=4), dtype=dtype)
    tp = bridge.params_from_numpy(jax.tree.map(
        lambda x: np.asarray(x).view(np.uint16)
        if x.dtype == jnp.bfloat16 else np.asarray(x), jp), tcfg, "cpu")
    JCK.save(str(tmp_path / "ref.npz"), jp)
    CK.save(str(tmp_path / "port.npz"), tp)
    ref, port = _members(tmp_path / "ref.npz"), _members(tmp_path / "port.npz")
    assert [n for n, _ in port] == [n for n, _ in ref]
    assert "stack/s0/wq.npy" in dict(ref) or "stack/s0/w_a.npy" in dict(ref)
    for (n, a), (_, b) in zip(port, ref):
        assert a == b, n


def test_port_loads_jax_bf16_checkpoint_bit_exactly(tmp_path):
    cfg = dataclasses.replace(tiny_cfg("qwen3-8b"), dtype="bfloat16")
    jp = _jinit(jax.random.PRNGKey(6), cfg)
    JCK.save(str(tmp_path / "ck"), jp)
    tcfg = dataclasses.replace(_tcfg("qwen3-8b"), dtype="bfloat16")
    like = _tparams(tcfg, seed=9)
    got = CK.load(str(tmp_path / "ck"), like)
    for (path, t), (_, j) in zip(leaves_with_path(got),
                                 leaves_with_path(jp)):
        assert t.dtype == like_dtype(like, path)
        want = np.asarray(j)
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16),
                want.view(np.uint16), err_msg=str(path))
        else:
            np.testing.assert_array_equal(t.numpy(), want, err_msg=str(path))


def like_dtype(tree, path):
    for p, leaf in leaves_with_path(tree):
        if p == path:
            return leaf.dtype
    raise KeyError(path)


def test_jax_load_fails_on_its_own_bf16_checkpoint(tmp_path):
    """The reference's ``load`` cannot read what its ``save`` wrote for a
    bf16 tree (numpy has no cast from ``|V2``); the port reads it (above).
    Not repaired in the reference."""
    cfg = dataclasses.replace(tiny_cfg("qwen3-8b"), dtype="bfloat16")
    jp = _jinit(jax.random.PRNGKey(6), cfg)
    JCK.save(str(tmp_path / "ck.npz"), jp)
    with pytest.raises(ValueError, match="cast"):
        JCK.load(str(tmp_path / "ck.npz"), jp)


def test_jax_loads_port_fp32_checkpoint(tmp_path):
    cfg = _tcfg("llama-3.2-vision-90b", layers=6)
    tp = _tparams(cfg, seed=3)
    CK.save(str(tmp_path / "port.npz"), tp)
    jcfg = tiny_cfg("llama-3.2-vision-90b", layers=6)
    like = _jinit(jax.random.PRNGKey(0), jcfg)
    got = JCK.load(str(tmp_path / "port.npz"), like)
    _assert_tree_close(jax.tree.map(np.asarray, got),
                       jax.tree.map(lambda t: t.numpy(), tp), rtol=0.0)


def test_checkpoint_roundtrip(tmp_path):
    """Twin of tests/test_training.py::test_checkpoint_roundtrip (nested
    stacks + MoE params), with the optimizer state too."""
    cfg = _tcfg("grok-1-314b")
    params = _tparams(cfg)
    path = str(tmp_path / "ck.npz")
    CK.save(path, params)
    p2 = CK.load(path, params)
    for a, b in zip(leaves(params), leaves(p2)):
        assert torch.equal(a, b)
    opt = TO.adamw(1e-3)[0](params)
    CK.save(str(tmp_path / "opt.npz"), opt)
    o2 = CK.load(str(tmp_path / "opt.npz"), opt)
    assert o2.step.dtype == torch.int32
    assert len(leaves(o2)) == 1 + 2 * len(leaves(params))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    """Twin of tests/test_training.py::test_checkpoint_shape_mismatch_raises:
    a wider template raises ValueError; a template with a leaf the file
    lacks raises KeyError."""
    cfg = _tcfg("granite-3-8b")
    params = _tparams(cfg)
    path = str(tmp_path / "ck.npz")
    CK.save(path, params)
    with pytest.raises(ValueError, match="shape mismatch"):
        CK.load(path, _tparams(_tcfg("granite-3-8b", d_model=128)))
    with pytest.raises(KeyError, match="missing leaf"):
        CK.load(path, _tparams(_tcfg("qwen3-8b")))
