"""The recurrent mixers in the port against the JAX package, on the same
weights (carried over with repro_torch.bridge) and the same numpy inputs:
the RG-LRU (recurrentgemma-2b) and the Mamba-2 SSD (mamba2-2.7b).

* layers: twins of ``tests/test_ssd_rglru.py`` (``ssd_chunked`` against
  ``repro``'s and the port's ``ssd_naive``, ``ssd_step`` continuing it,
  ``rglru_scan`` against a step loop, ``rglru_scan_h0``, the causal convs
  with ragged ``t_end``);
* configs, ``check_supported``, init shapes and the special inits, the
  bridge (bf16 weights keep the six fp32 leaves fp32);
* the models: prefill with ragged prompts, decode steps, chunked prefill
  against whole prefill, and the decomposition (``run_decomposed ==
  apply_block``, twin of ``tests/test_decompose.py``'s recurrent cases).

fp32 tiny configs (``tiny_cfg``: 3 layers, d_model 64).  Tolerances: 1e-5
for a layer alone (fp32 with another summation order: the port's scan is
a doubling scan where ``lax.associative_scan`` uses another tree), 1e-4
for logits through a model, as the other model twins; the serving twins
are in ``tests/test_torch_recurrent_serve.py``."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.core import decompose as JD
from repro.core.config import get_arch as jget_arch
from repro.core.hetero import per_layer_params as jper_layer_params
from repro.core.hetero import per_layer_state as jper_layer_state
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.core import decompose as TD
from repro_torch.core.config import (ModelConfig, check_supported, get_arch,
                                     list_archs)
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

TOL = 1e-5           # a layer alone
MODEL_TOL = 1e-4     # logits through a model
ARCHS = ["recurrentgemma-2b", "mamba2-2.7b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0)


# ---------------------------------------------------------------------------
# layers: twins of tests/test_ssd_rglru.py
# ---------------------------------------------------------------------------
def _ssd_inputs(rng, bb, s, h, p, n):
    x = _mk(rng, bb, s, h, p)
    dt = np.asarray(jax.nn.softplus(_mk(rng, bb, s, h)))
    return (x, dt, _mk(rng, h), _mk(rng, bb, s, n), _mk(rng, bb, s, n),
            _mk(rng, h), _mk(rng, bb, h, p, n))


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("s", [5, 16, 23])
def test_ssd_chunked_matches_jax_and_naive(chunk, s):
    rng = np.random.default_rng(100 * chunk + s)
    x, dt, a_log, b, c, d, h0 = _ssd_inputs(rng, 2, s, 3, 8, 4)
    jy, jh = JL.ssd_chunked(*map(jnp.asarray, (x, dt, a_log, b, c, d)),
                            chunk=chunk, h0=jnp.asarray(h0),
                            return_state=True)
    ty, th = TL.ssd_chunked(*map(_t, (x, dt, a_log, b, c, d)), chunk=chunk,
                            h0=_t(h0), return_state=True)
    _close(ty, jy, 3e-5)
    _close(th, jh, 3e-5)
    ny, nh = TL.ssd_naive(*map(_t, (x, dt, a_log, b, c, d)), h0=_t(h0))
    # the reference test's own tolerance for chunked against naive
    np.testing.assert_allclose(ty, ny, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(th, nh, rtol=3e-4, atol=3e-4)
    assert th.dtype == torch.float32 and ty.shape == (2, s, 3, 8)


def test_ssd_step_continues_chunked():
    """Chunked over s tokens then one step == chunked over s + 1 (and
    ``repro``'s step on the same inputs)."""
    rng = np.random.default_rng(1)
    s = 12
    x, dt, a_log, b, c, d, _ = _ssd_inputs(rng, 1, s + 1, 2, 4, 4)
    T = list(map(_t, (x, dt, a_log, b, c, d)))
    y_all, h_all = TL.ssd_chunked(*T, chunk=4, return_state=True)
    _, h_s = TL.ssd_chunked(T[0][:, :s], T[1][:, :s], T[2], T[3][:, :s],
                            T[4][:, :s], T[5], chunk=4, return_state=True)
    y_step, h_step = TL.ssd_step(T[0][:, s], T[1][:, s], T[2], T[3][:, s],
                                 T[4][:, s], T[5], h_s)
    np.testing.assert_allclose(y_step, y_all[:, s], rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(h_step, h_all, rtol=3e-4, atol=3e-4)
    jy, jh = JL.ssd_step(jnp.asarray(x[:, s]), jnp.asarray(dt[:, s]),
                         jnp.asarray(a_log), jnp.asarray(b[:, s]),
                         jnp.asarray(c[:, s]), jnp.asarray(d),
                         jnp.asarray(h_s.numpy()))
    _close(y_step, jy)
    _close(h_step, jh)


def test_ssd_decay_bounded():
    """With A = -1 and bounded inputs the state stays bounded over a long
    sequence (A < 0 makes the recurrence a contraction)."""
    rng = np.random.default_rng(2)
    s, n = 300, 8
    x = _mk(rng, 1, s, 2, 4)
    dt = np.asarray(jax.nn.softplus(_mk(rng, 1, s, 2)))
    b, c = _mk(rng, 1, s, n, scale=0.1), _mk(rng, 1, s, n)
    _, h = TL.ssd_chunked(_t(x), _t(dt), torch.zeros(2), _t(b), _t(c),
                          torch.zeros(2), chunk=16, return_state=True)
    assert bool(h.isfinite().all()) and float(h.abs().max()) < 100.0


def _rglru_params(rng, w, scale=0.3):
    return {"w_a": _mk(rng, w, w, scale=scale), "b_a": _mk(rng, w),
            "w_x": _mk(rng, w, w, scale=scale), "b_x": _mk(rng, w),
            "lam": _mk(rng, w)}


def test_rglru_scan_matches_step_loop_and_jax():
    rng = np.random.default_rng(3)
    bb, s, w = 2, 17, 12
    p = _rglru_params(rng, w)
    xc = _mk(rng, bb, s, w)
    tp = {k: _t(v) for k, v in p.items()}
    hs = TL.rglru_scan(tp, _t(xc))
    h = torch.zeros((bb, w))
    outs = []
    for i in range(s):
        o, h = TL.rglru_step(tp, _t(xc)[:, i], h)
        outs.append(o)
    np.testing.assert_allclose(hs, torch.stack(outs, 1), rtol=1e-4,
                               atol=1e-5)
    _close(hs, JL.rglru_scan({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(xc)))


def test_rglru_scan_h0_matches_jax():
    """The chunk continuation from an explicit state, with identity steps
    (a = 1, b = 0) scattered in, as a chunk tail carries them."""
    rng = np.random.default_rng(4)
    bb, s, w = 3, 11, 8
    a = rng.uniform(0.05, 0.999, (bb, s, w)).astype(np.float32)
    b = _mk(rng, bb, s, w)
    a[1, 6:], b[1, 6:] = 1.0, 0.0
    a[2], b[2] = 1.0, 0.0
    h0 = _mk(rng, bb, w)
    got = TL.rglru_scan_h0(_t(a), _t(b), _t(h0))
    _close(got, JL.rglru_scan_h0(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(h0)))
    # identity steps keep the state: row 2 all (exactly), row 1 from
    # position 5 on (up to the rounding of another association)
    np.testing.assert_array_equal(got[2], _t(h0)[2][None].expand(s, w))
    np.testing.assert_allclose(got[1, 6:], got[1, 5:6].expand(5, w),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("s", [300, 4096])
def test_rglru_scan_long_prompt_is_finite_and_matches_the_loop(s):
    """Decays near 0 and near 1 over a long prompt: the doubling scan
    multiplies and adds terms in [0, 1] only (no exp(-cumsum(log a)),
    which overflows once the summed log-decay passes ~88), and stays
    with the sequential recurrence."""
    rng = np.random.default_rng(s)
    bb, w = 1, 8
    p = _rglru_params(rng, w, scale=1.0)
    p["lam"] = np.linspace(-4, 4, w).astype(np.float32)
    tp = {k: _t(v) for k, v in p.items()}
    xc = _t(_mk(rng, bb, s, w))
    hs = TL.rglru_scan(tp, xc)
    assert bool(hs.isfinite().all())
    a, b = TL._rglru_gates(tp, xc)
    assert float(torch.log(a).sum(1).min()) < -88.0   # exp(-cumsum) = inf
    h = torch.zeros((bb, w))
    for i in range(s):
        h = a[:, i] * h + b[:, i]
    np.testing.assert_allclose(hs[:, -1], h, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cw", [1, 2, 4])
def test_causal_conv1d_matches_jax(cw):
    rng = np.random.default_rng(5 + cw)
    w, x, st = _mk(rng, cw, 6), _mk(rng, 3, 7, 6), _mk(rng, 3, cw - 1, 6)
    for state in (None, st):
        jy, js = JL.causal_conv1d(jnp.asarray(w), jnp.asarray(x),
                                  None if state is None
                                  else jnp.asarray(state))
        ty, ts = TL.causal_conv1d(_t(w), _t(x),
                                  None if state is None else _t(state))
        _close(ty, jy)
        _close(ts, js)
        assert tuple(ts.shape) == tuple(js.shape)


def test_causal_conv1d_chunk_ragged_t_end_matches_jax():
    """Per-row valid lengths 0, 1, 3 and C: each row's state is the window
    ending at its last valid position; t_end 0 keeps the old state."""
    rng = np.random.default_rng(6)
    w, x, st = _mk(rng, 4, 5), _mk(rng, 4, 6, 5), _mk(rng, 4, 3, 5)
    t_end = np.array([0, 1, 3, 6], np.int32)
    jy, js = JL.causal_conv1d_chunk(jnp.asarray(w), jnp.asarray(x),
                                    jnp.asarray(st), jnp.asarray(t_end))
    ty, ts = TL.causal_conv1d_chunk(_t(w), _t(x), _t(st), _t(t_end))
    _close(ty, jy)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ts[0], _t(st)[0])
    np.testing.assert_array_equal(ts[3], _t(x)[3, 3:])


# ---------------------------------------------------------------------------
# configs, init, bridge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_equals_jax_and_is_supported(arch):
    jc, tc = jget_arch(arch), get_arch(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert arch in list_archs()
    check_supported(tc)
    assert tc.d_inner == jc.d_inner and tc.ssd_heads == jc.ssd_heads
    for kw in ({}, dict(layers=3, d_model=64, vocab=97)):
        assert dataclasses.asdict(tc.reduced(**kw)) \
            == dataclasses.asdict(jc.reduced(**kw))


def test_published_widths_the_port_serves():
    """repro's definitions (ROADMAP §3): recurrentgemma's 26 layers are 8
    (rglru, rglru, attn) periods and two RG-LRU blocks, a plain GELU MLP,
    MQA with Dh 256 and a 2048 window; mamba2 has 80 SSD heads of 64,
    ngroups 1 (one B and C for all heads) and no FFN."""
    r, m = get_arch("recurrentgemma-2b"), get_arch("mamba2-2.7b")
    assert r.pattern.count("attn") == 8 and r.pattern[-2:] == ("rglru",) * 2
    assert (r.ffn_kind, r.num_heads, r.num_kv_heads, r.head_dim, r.window,
            r.rnn_width, r.conv_width) == ("mlp", 10, 1, 256, 2048, 2560, 4)
    assert (m.ffn_kind, m.ssd_heads, m.ssd_head_dim, m.ssm_state,
            m.d_inner, m.num_layers) == ("none", 80, 64, 128, 5120, 64)
    shapes = TM._block_param_shapes(m, "ssd")
    assert shapes["w_in"] == (2560, 2 * 5120 + 2 * 128 + 80)
    assert shapes["conv"] == (4, 5120 + 2 * 128)
    assert not any(k.startswith("ffn_") for k in shapes)


def test_check_supported_still_refuses_cross_attention_and_encdec():
    """Since the cross-attention slice ``check_supported`` admits both
    archs; it still refuses an FFN-less arch with blocks other than SSD.
    What stays refused of cross-attention and enc-dec: the ServingEngine
    on both archs and whisper with quantized_kv (its DEC_XATTN blocks
    have no int8 R-Part), each with its reason."""
    from repro_torch.core.hetero import HeteroPipelineEngine
    from repro_torch.serving.engine import ServingEngine
    for arch in ("whisper-medium", "llama-3.2-vision-90b"):
        tc = ModelConfig(**dataclasses.asdict(jget_arch(arch)))
        check_supported(tc)
        with pytest.raises(ValueError, match="static-batch API"):
            ServingEngine({}, tc.reduced(), batch=2, cache_len=8,
                          device="cpu")
    whisper = get_arch("whisper-medium").reduced()
    with pytest.raises(ValueError, match="no int8 R-Part"):
        HeteroPipelineEngine({}, whisper, batch=2, cache_len=8,
                             quantized_kv=True, device="cpu")
    bad = dataclasses.replace(get_arch("qwen3-8b"), ffn_kind="none")
    with pytest.raises(NotImplementedError, match="FFN"):
        check_supported(bad)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_and_special_inits(arch):
    """One stack per pattern slot plus the remainder blocks, the shapes of
    ``repro``'s tree; in bf16 the fp32 leaves stay fp32 with the Griffin
    and Mamba-2 inits (a in [0.9, 0.999], A in [1, 16], D = 1, zero
    biases)."""
    jc = tiny_cfg(arch, layers=5, d_model=128)
    tc = dataclasses.replace(ModelConfig(**dataclasses.asdict(jc)),
                             dtype="bfloat16")
    jp = jax.eval_shape(partial(JM.init_params, cfg=jc),
                        jax.random.PRNGKey(0))
    tp = TM.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert sorted(tp["stack"]) == sorted(jp["stack"])
    assert len(tp["rem"]) == len(jp["rem"])
    for slot in jp["stack"]:
        for k, v in jp["stack"][slot].items():
            assert tuple(tp["stack"][slot][k].shape) == tuple(v.shape), k
    for jb, tb in zip(jp["rem"], tp["rem"]):
        assert {k: tuple(v.shape) for k, v in tb.items()} \
            == {k: tuple(v.shape) for k, v in jb.items()}
    leaves = {k: v for slot in tp["stack"].values() for k, v in slot.items()}
    for k in TM.FP32_LEAVES:
        if k in leaves:
            assert leaves[k].dtype == torch.float32, k
    if arch == "recurrentgemma-2b":
        a = torch.exp(-torch.nn.functional.softplus(leaves["lam"])) \
            ** TL._LRU_C
        assert float(a.min()) >= 0.9 - 1e-4 and float(a.max()) <= 0.999
        assert float(leaves["b_a"].abs().max()) == 0.0
        assert leaves["w_a"].dtype == torch.bfloat16
    else:
        A = torch.exp(leaves["A_log"])
        assert 1.0 <= float(A.min()) and float(A.max()) <= 16.0
        assert bool((leaves["Dskip"] == 1).all())
        assert float(leaves["dt_bias"].abs().max()) == 0.0
        assert leaves["w_in"].dtype == torch.bfloat16


def _to_np(tree):
    def leaf(x):
        a = np.asarray(x)
        return a.view(np.uint16) if x.dtype == jnp.bfloat16 else a
    return jax.tree.map(leaf, tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_keeps_the_fp32_leaves_fp32(arch):
    """``params_from_numpy(dtype=bf16)`` casts the weight matrices and
    leaves the norm scales and ``lam``, ``b_a``, ``b_x``, ``A_log``,
    ``Dskip`` and ``dt_bias`` fp32, as ``repro``'s tree keeps them."""
    jc = tiny_cfg(arch)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jax.random.PRNGKey(1), jc)
    tp = bridge.params_from_numpy(_to_np(jp), tc, "cpu",
                                  dtype=torch.bfloat16)
    seen = set()
    for slot, leaves in tp["stack"].items():
        for k, v in leaves.items():
            want = jp["stack"][slot][k]
            if k in TM.FP32_LEAVES or k.startswith("ln") \
                    or k.endswith("norm"):
                seen.add(k)
                assert v.dtype == torch.float32, k
                np.testing.assert_array_equal(v.numpy(), np.asarray(want))
            else:
                assert v.dtype == torch.bfloat16, k
    assert seen >= ({"lam", "b_a", "b_x"} if arch.startswith("recurrent")
                    else {"A_log", "Dskip", "dt_bias"})


# ---------------------------------------------------------------------------
# the models against the JAX package
# ---------------------------------------------------------------------------
def _setup(arch, seed=0, **kw):
    jc = dataclasses.replace(tiny_cfg(arch), **kw)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jax.random.PRNGKey(seed), jc)
    # nonzero norm scales and gate biases, so they count
    rng = np.random.default_rng(seed + 1)
    leaves, tree = jax.tree.flatten(jax.tree.map(np.asarray, jp))
    leaves = [x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype)
              if x.dtype == np.float32 and x.ndim <= 2
              and x.shape[-1] in (jc.d_model, jc.head_dim, jc.rnn_width,
                                  jc.d_inner) else x for x in leaves]
    jp = jax.tree.map(jnp.asarray, jax.tree.unflatten(tree, leaves))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Ragged prompts (the conv window freezes at each prompt's end, h is
    taken at its last valid position), then decode steps: logits and the
    whole state (h fp32, conv, KV) against ``repro``'s."""
    jc, tc, jp, tp = _setup(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, jc.vocab_size, (3, 9)).astype(np.int32)
    plens = np.array([9, 4, 6], np.int32)
    cache = 16
    jl, js = jax.jit(partial(JM.prefill, cfg=jc, cache_len=cache))(
        jp, tokens=jnp.asarray(toks), prompt_lens=jnp.asarray(plens))
    tl, ts = TM.prefill(tp, tc, _t(toks), _t(plens), cache)
    _close(tl, jl, MODEL_TOL)
    jdecode = jax.jit(partial(JM.decode_step, cfg=jc))
    for _ in range(3):
        t1 = rng.integers(1, jc.vocab_size, (3, 1)).astype(np.int32)
        jl, js = jdecode(jp, state=js, tokens=jnp.asarray(t1))
        tl, ts = TM.decode_step(tp, tc, ts, _t(t1))
        _close(tl, jl, MODEL_TOL)
    for slot, leaves in js["stack"].items():
        for k, v in leaves.items():
            assert ts["stack"][slot][k].dtype == torch.from_numpy(
                np.asarray(v)).dtype, (slot, k)
            _close(ts["stack"][slot][k], v, MODEL_TOL)


def test_prefill_keeps_each_rows_window_in_a_ring_shorter_than_the_batch():
    """A windowed ring (8 slots) shorter than the padded batch (13): the
    port's prefill stores each row's last min(len, 8) tokens, as chunked
    prefill does in both packages, and its next decode step equals
    ``repro``'s after chunked prefill.  ``repro``'s own prefill keeps the
    last 8 positions of the PADDED batch, so the 10-token row loses
    positions 2, 3 and 4 of its window (a fault of the reference,
    repaired in the port only: ROADMAP §3)."""
    jc, tc, jp, tp = _setup("recurrentgemma-2b", window=8)
    rng = np.random.default_rng(13)
    toks = rng.integers(1, jc.vocab_size, (3, 13)).astype(np.int32)
    plens = np.array([13, 10, 5], np.int32)
    cache = 16                                # ring = min(16, window 8)
    _, ts = TM.prefill(tp, tc, _t(toks), _t(plens), cache)
    _, js = jax.jit(partial(JM.prefill, cfg=jc, cache_len=cache))(
        jp, tokens=jnp.asarray(toks), prompt_lens=jnp.asarray(plens))
    attn = [f"s{i}" for i, k in enumerate(jc.layer_pattern) if k == "attn"]
    tpos = ts["stack"][attn[0]]["pos"][0]
    jpos = np.asarray(js["stack"][attn[0]]["pos"])[0]
    for row, n in enumerate(plens):
        assert sorted(int(p) for p in tpos[row] if p >= 0) \
            == list(range(max(0, n - 8), n))
    assert sorted(int(p) for p in jpos[1] if p >= 0) == [5, 6, 7, 8, 9]
    # repro's chunked prefill fills the ring as the port's prefill does
    jst = JM.init_decode_state(jc, 3, cache)
    jchunk = jax.jit(partial(JM.prefill_chunk, cfg=jc))
    for c0 in range(0, 13, 4):
        pos = np.full((3, 4), -1, np.int32)
        tk = np.zeros((3, 4), np.int32)
        for r in range(3):
            n = max(0, min(4, plens[r] - c0))
            pos[r, :n] = np.arange(c0, c0 + n)
            tk[r, :n] = toks[r, c0:c0 + n]
        _, jst = jchunk(jp, state=jst, tokens=jnp.asarray(tk),
                        chunk_pos=jnp.asarray(pos))
    for slot in attn:
        want_pos = np.asarray(jst["stack"][slot]["pos"])
        np.testing.assert_array_equal(ts["stack"][slot]["pos"], want_pos)
        ok = (want_pos >= 0)[..., None, None]
        for k in ("k", "v"):
            _close(ts["stack"][slot][k].numpy() * ok,
                   np.asarray(jst["stack"][slot][k]) * ok, MODEL_TOL)
    t1 = rng.integers(1, jc.vocab_size, (3, 1)).astype(np.int32)
    tl, _ = TM.decode_step(tp, tc, ts, _t(t1))
    jl, _ = jax.jit(partial(JM.decode_step, cfg=jc))(
        jp, state=jst, tokens=jnp.asarray(t1))
    _close(tl, jl, MODEL_TOL)


@pytest.mark.parametrize("chunk", [4, 5])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_matches_whole_prefill_and_jax(arch, chunk):
    """Chained chunks (ragged ends, a row fed nothing in later chunks):
    the last chunk's logits and the state equal whole-prompt prefill, and
    each chunk equals ``repro``'s ``prefill_chunk``."""
    jc, tc, jp, tp = _setup(arch)
    rng = np.random.default_rng(chunk)
    toks = rng.integers(1, jc.vocab_size, (3, 11)).astype(np.int32)
    plens = np.array([11, 3, 7], np.int32)
    cache = 16
    whole, ws = TM.prefill(tp, tc, _t(toks), _t(plens), cache)
    ts = TM.init_decode_state(tc, 3, cache, "cpu")
    js = JM.init_decode_state(jc, 3, cache)
    jchunk = jax.jit(partial(JM.prefill_chunk, cfg=jc))
    last = torch.zeros_like(whole)
    for c0 in range(0, 11, chunk):
        pos = np.full((3, chunk), -1, np.int32)
        tk = np.zeros((3, chunk), np.int32)
        for r in range(3):
            n = max(0, min(chunk, plens[r] - c0))
            pos[r, :n] = np.arange(c0, c0 + n)
            tk[r, :n] = toks[r, c0:c0 + n]
        jl, js = jchunk(jp, state=js, tokens=jnp.asarray(tk),
                        chunk_pos=jnp.asarray(pos))
        tl, ts = TM.prefill_chunk(tp, tc, ts, _t(tk), _t(pos))
        fed = (pos >= 0).any(1)
        _close(tl[fed], np.asarray(jl)[fed], MODEL_TOL)
        last[fed] = tl[fed]
    _close(last, whole, MODEL_TOL)
    for slot, leaves in ws["stack"].items():
        got = ts["stack"][slot]
        if "pos" in leaves:
            # whole prefill also writes the padding's K/V (at pos -1),
            # chunks write only valid tokens: equal where a slot is valid
            np.testing.assert_array_equal(got["pos"], leaves["pos"])
            ok = (leaves["pos"] >= 0)[..., None, None]
            for k in ("k", "v"):
                _close(got[k] * ok, leaves[k] * ok, MODEL_TOL)
            continue
        for k, v in leaves.items():
            _close(got[k], v, MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decomposed_equals_fused_block_and_jax(arch):
    """Twin of tests/test_decompose.py's recurrent cases: per layer, the
    port's run_decomposed == its apply_block == ``repro``'s
    run_decomposed, outputs and new state (S-side conv, R-side h)."""
    jc, tc, jp, tp = _setup(arch)
    rng = np.random.default_rng(1)
    b, s = 2, 10
    toks = rng.integers(0, jc.vocab_size, (b, s)).astype(np.int32)
    plens = np.full((b,), s, np.int32)
    _, js = jax.jit(partial(JM.prefill, cfg=jc, cache_len=s + 4))(
        jp, tokens=jnp.asarray(toks), prompt_lens=jnp.asarray(plens))
    h = _mk(rng, b, 1, jc.d_model, scale=0.1)
    lengths = np.asarray(js["lengths"])
    jctx = JM.Ctx(jc, "decode", jnp.asarray(lengths)[:, None],
                  jnp.asarray(lengths), None, 0)
    ts = bridge.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    tl = _t(lengths)
    tctx = TM.Ctx(tc, "decode", tl[:, None], tl, 8)
    jps, jss = jper_layer_params(jp, jc), jper_layer_state(js, jc)
    for li, (kind, tpl) in enumerate(zip(tc.pattern, TM.per_layer(tp, tc))):
        jh, jnew = jax.jit(partial(JD.run_decomposed, kind, ctx=jctx))(
            jps[li][1], jnp.asarray(h), jss[li])
        st_a = {k: v.clone() for k, v in TM.per_layer(ts, tc)[li].items()}
        st_b = {k: v.clone() for k, v in st_a.items()}
        ha, st_a = TD.run_decomposed(kind, tpl, _t(h), st_a, tctx)
        hb, st_b, _ = TM.apply_block(kind, tpl, _t(h), st_b, tctx)
        np.testing.assert_array_equal(ha, hb)
        _close(ha, jh)
        assert sorted(st_a) == sorted(jnew)
        for k in st_a:
            np.testing.assert_array_equal(st_a[k], st_b[k])
            _close(st_a[k], jnew[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_r_parts_match_jax(arch):
    """``r_rglru_chunk`` / ``r_ssd_chunk`` and the chunk S-Parts around
    them against ``repro``'s, with invalid positions (identity steps) and
    a row fed nothing (its state untouched)."""
    jc, tc, jp, tp = _setup(arch)
    kind = tc.layer_pattern[0]
    rng = np.random.default_rng(2)
    b, c = 3, 5
    h = _mk(rng, b, c, jc.d_model, scale=0.5)
    valid = np.ones((b, c), bool)
    valid[1, 2:] = False
    valid[2] = False
    base = np.array([3, 0, 7], np.int32)
    qpos = np.where(valid, base[:, None] + np.arange(c), -1).astype(np.int32)
    st0 = JM._block_state(jc, kind, b, 16)
    st0 = jax.tree.map(lambda x: jnp.asarray(_mk(rng, *x.shape)
                                             ).astype(x.dtype), st0)
    jr, js = JD.split_block_state(kind, st0)
    tr = {k: _t(v) for k, v in jr.items()}
    tsd = {k: _t(v) for k, v in js.items()}
    jctx = JM.Ctx(jc, "chunk", jnp.asarray(qpos), jnp.asarray(base), None, 0)
    tctx = TM.Ctx(tc, "chunk", _t(qpos), _t(base))
    jpl = jax.tree.map(lambda x: x[0], jp["stack"]["s0"])
    tpl = TM.per_layer(tp, tc)[0]
    jpo, jns = jax.jit(partial(JD.s_pre_chunk_stateful, kind, ctx=jctx))(
        jpl, jnp.asarray(h), js, valid=jnp.asarray(valid))
    tpo, tns = TD.s_pre_chunk_stateful(kind, tpl, _t(h), tsd, tctx,
                                       _t(valid))
    for k in jpo.r_in:
        _close(tpo.r_in[k], jpo.r_in[k])
    _close(tns["conv"], jns["conv"])
    jout, jnr = jax.jit(partial(JD.r_dispatch_chunk, kind, 0, cfg=jc))(
        jpo.r_in, jr)
    tout, tnr = TD.r_dispatch_chunk(kind, 0, tpo.r_in, tr, tc)
    (key,) = jout
    _close(tout[key], jout[key], 3e-5)
    _close(tnr["h"], jnr["h"], 3e-5)
    np.testing.assert_array_equal(tnr["h"][2], np.asarray(jr["h"])[2])
    jo = jax.jit(partial(JD.s_advance_chunk, kind, 0, ctx=jctx))(
        jpl, jpo.carry, jout)
    to = TD.s_advance_chunk(kind, 0, tpl, tpo.carry, tout, tctx)
    _close(to, jo, 3e-5)
