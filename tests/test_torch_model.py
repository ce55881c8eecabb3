"""The port's model and decomposition against repro.models.model and
repro.core.decompose on the same weights (carried over with
repro_torch.bridge) and the same numpy inputs.  fp32; logits and state
within 1e-4 absolute."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.core import decompose as JD
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.core import decompose as TD
from repro_torch.core.config import ModelConfig
from repro_torch.models import model as TM

TOL = 1e-4

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one intra-op thread, and the suite's
    other workers (timing-sensitive chaos tests among them) keep the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CONFIGS = {
    "llama-7b": lambda: tiny_cfg("llama-7b"),
    "qwen3-8b": lambda: tiny_cfg("qwen3-8b"),          # qk_norm
    # reduced() caps heads at 4/4, so GQA needs explicit kv heads
    "qwen3-8b-gqa2": lambda: dataclasses.replace(tiny_cfg("qwen3-8b"),
                                                 num_kv_heads=2),
    # tied embeddings: the logits multiply by embed.T, no lm_head
    "granite-3-8b": lambda: dataclasses.replace(tiny_cfg("granite-3-8b"),
                                                num_kv_heads=2),
}


def _setup(name):
    jc = CONFIGS[name]()
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    # nonzero norm scales, so the (1 + scale) gains are exercised
    rng = np.random.default_rng(1)
    leaves, tree = jax.tree.flatten(jax.tree.map(np.asarray, jp))
    leaves = [x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype)
              if x.dtype == np.float32 and x.shape[-1] in
              (jc.d_model, jc.head_dim) and x.ndim <= 2 else x
              for x in leaves]
    jp = jax.tree.map(jnp.asarray, jax.tree.unflatten(tree, leaves))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_and_decode_match_jax(name):
    jc, tc, jp, tp = _setup(name)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, jc.vocab_size, (3, 9)).astype(np.int32)
    plens = np.array([9, 4, 6], np.int32)
    cache = 16
    # jitted: one compile per function instead of one per eager op
    jprefill = jax.jit(partial(JM.prefill, cfg=jc, cache_len=cache))
    jdecode = jax.jit(partial(JM.decode_step, cfg=jc))
    jl, js = jprefill(jp, tokens=jnp.asarray(toks),
                      prompt_lens=jnp.asarray(plens))
    tl, ts = TM.prefill(tp, tc, torch.from_numpy(toks),
                        torch.from_numpy(plens), cache)
    _close(tl, jl)
    for _ in range(4):
        t1 = rng.integers(1, jc.vocab_size, (3, 1)).astype(np.int32)
        jl, js = jdecode(jp, state=js, tokens=jnp.asarray(t1))
        tl, ts = TM.decode_step(tp, tc, ts, torch.from_numpy(t1))
        _close(tl, jl)
    for key in ("k", "v"):
        _close(ts["stack"]["s0"][key], js["stack"]["s0"][key])
    np.testing.assert_array_equal(ts["stack"]["s0"]["pos"].numpy(),
                                  np.asarray(js["stack"]["s0"]["pos"]))
    np.testing.assert_array_equal(ts["lengths"].numpy(),
                                  np.asarray(js["lengths"]))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_decomposed_equals_apply_block(name):
    """The S/R split is structural: run_decomposed == apply_block in the
    port, and both equal the JAX decomposition."""
    jc, tc, jp, tp = _setup(name)
    rng = np.random.default_rng(1)
    toks = rng.integers(1, jc.vocab_size, (2, 6)).astype(np.int32)
    plens = np.array([6, 3], np.int32)
    _, js = jax.jit(partial(JM.prefill, cfg=jc, cache_len=10))(
        jp, tokens=jnp.asarray(toks), prompt_lens=jnp.asarray(plens))
    h = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
    lengths = np.array(js["lengths"])
    jst = jax.tree.map(lambda x: x[0], js["stack"]["s0"])
    jpl = jax.tree.map(lambda x: x[0], jp["stack"]["s0"])
    jctx = JM.Ctx(jc, "decode", jnp.asarray(lengths)[:, None],
                  jnp.asarray(lengths), None, 0)
    jh, jnew = jax.jit(partial(JD.run_decomposed, "attn", ctx=jctx))(
        jpl, jnp.asarray(h), jst)

    ts = bridge.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    tpl = TM.per_layer(tp, tc)[0]
    tl = torch.from_numpy(lengths)
    tctx = TM.Ctx(tc, "decode", tl[:, None], tl)
    st_a = {k: v.clone() for k, v in TM.per_layer(ts, tc)[0].items()}
    st_b = {k: v.clone() for k, v in st_a.items()}
    ha, st_a, _ = TM.apply_block("attn", tpl, torch.from_numpy(h), st_a,
                                 tctx)
    hb, st_b = TD.run_decomposed("attn", tpl, torch.from_numpy(h), st_b,
                                 tctx)
    torch.testing.assert_close(ha, hb, atol=1e-6, rtol=0)
    for key in ("k", "v", "pos"):
        assert torch.equal(st_a[key], st_b[key])
        _close(st_b[key], jnew[key])
    _close(hb, jh)


def test_tied_embedding_logits_match_jax():
    """granite-3-8b ties its embeddings: the params carry no lm_head
    across the bridge, and the port's logits (h @ embed.T) equal
    repro.models.model._logits."""
    jc, tc, jp, tp = _setup("granite-3-8b")
    assert jc.tie_embeddings and tc.tie_embeddings
    assert "lm_head" not in jp and "lm_head" not in tp
    h = np.random.default_rng(3).standard_normal(
        (2, 3, jc.d_model)).astype(np.float32)
    _close(TM._logits(tp, tc, torch.from_numpy(h)),
           JM._logits(jp, h=jnp.asarray(h), cfg=jc))


def test_r_attention_active_gate_keeps_inactive_rows():
    jc, tc, jp, tp = _setup("qwen3-8b-gqa2")
    rng = np.random.default_rng(2)
    b, c = 3, 8
    st = {"k": rng.standard_normal((b, c, 2, jc.head_dim)).astype(np.float32),
          "v": rng.standard_normal((b, c, 2, jc.head_dim)).astype(np.float32),
          "pos": np.tile(np.arange(c, dtype=np.int32), (b, 1))}
    st["pos"][:, 5:] = -1
    r_in = {"q": rng.standard_normal((b, 1, 4, jc.head_dim)).astype(np.float32),
            "k": rng.standard_normal((b, 1, 2, jc.head_dim)).astype(np.float32),
            "v": rng.standard_normal((b, 1, 2, jc.head_dim)).astype(np.float32),
            "lengths": np.array([5, 5, 5], np.int32),
            "active": np.array([True, False, True])}
    jo, jst = JD.r_attention({k: jnp.asarray(v) for k, v in r_in.items()},
                             {k: jnp.asarray(v) for k, v in st.items()},
                             window=0, softcap=0.0)
    to, tst = TD.r_attention({k: torch.from_numpy(v) for k, v in r_in.items()},
                             {k: torch.from_numpy(v.copy())
                              for k, v in st.items()}, window=0, softcap=0.0)
    _close(to["o"], jo["o"])
    for key in ("k", "v", "pos"):
        _close(tst[key], jst[key])
    np.testing.assert_array_equal(tst["pos"][1].numpy(), st["pos"][1])


def test_init_params_shapes_and_zero_norms():
    jc = tiny_cfg("qwen3-8b")
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = TM.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    jl, jt = jax.tree.flatten(jp)
    tl, tt = jax.tree.flatten(jax.tree.map(lambda t: t, tp,
                                           is_leaf=torch.is_tensor))
    assert jt == tt
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
    for name, v in tp["stack"]["s0"].items():
        if name.startswith("ln") or name.endswith("norm"):
            assert torch.all(v == 0) and v.dtype == torch.float32
    # scales: 0.02 for q/k/v, 0.02/sqrt(2L) for the output projections
    assert abs(float(tp["stack"]["s0"]["wq"].std()) - 0.02) < 0.003
    want = 0.02 / np.sqrt(2 * jc.num_layers)
    assert abs(float(tp["stack"]["s0"]["wo"].std()) - want) < 0.002


def test_entry_points_refuse_cuda_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    tc = ModelConfig(**dataclasses.asdict(tiny_cfg("llama-7b")))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.init_params(tc, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.init_decode_state(tc, 2, 8)
