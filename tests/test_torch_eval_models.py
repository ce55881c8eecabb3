"""The paper's evaluation models (llama-13b, opt-175b with the GELU MLP
FFN) and the DeepSeek dense configs in the port, against the JAX
package on the same weights (carried over with repro_torch.bridge) and
the same numpy inputs: the full configs, the MLP layer, prefill and
decode logits and state (fp32, 1e-4), the decomposition of an MLP block,
and the ServingEngine on reduced opt-175b against
``conftest.serve_trace``."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conftest import random_spec, serve_trace, tiny_cfg
from repro.core import decompose as JD
from repro.core.config import get_arch as jget_arch
from repro.core.config import list_archs as jlist_archs
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.core import decompose as TD
from repro_torch.core.config import ModelConfig, get_arch, list_archs
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request

TOL = 1e-4
NEW_ARCHS = ["llama-13b", "opt-175b", "deepseek-67b", "deepseek-coder-33b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one intra-op thread, and the suite's
    other workers keep the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_config_equals_jax(arch):
    jc = jget_arch(arch)
    tc = get_arch(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert arch in list_archs() and arch in jlist_archs()
    assert tc.head_dim == 128
    # built and checked like the reference's (tests/test_models_smoke.py)
    TM.init_decode_state(tc.reduced(), 1, 4, "cpu")


@pytest.mark.parametrize("arch", sorted(jlist_archs()))
def test_check_supported_takes_the_dense_archs_only(arch):
    """Every reference config passes, each block with a SwiGLU, MLP or
    MoE FFN, or (mamba2) SSD blocks with none: the dense archs, since the
    MoE slice grok-1 and llama4-scout, since the recurrent slice the
    RG-LRU hybrid and mamba2, and since the cross-attention slice
    llama-3.2-vision-90b and whisper-medium (whose refusals now stand at
    the serving layer: ``tests/test_torch_xattn_serve.py``)."""
    from repro_torch.core.config import check_supported
    tc = ModelConfig(**dataclasses.asdict(jget_arch(arch)))
    assert arch in list_archs()
    assert tc.ffn_kind in ("swiglu", "mlp", "moe") \
        or set(tc.layer_pattern) == {"ssd"}
    check_supported(tc)


def test_opt_175b_keeps_the_reference_definition():
    """The port follows repro's opt-175b (RMSNorm, RoPE, a bias-free GELU
    MLP), not the published OPT's LayerNorm / learned positions / ReLU."""
    tc = get_arch("opt-175b")
    assert (tc.ffn_kind, tc.num_heads, tc.num_kv_heads, tc.d_ff) == \
        ("mlp", 96, 96, 49152)
    shapes = TM._block_param_shapes(tc.reduced())
    assert {k for k in shapes if k.startswith("ffn_")} == \
        {"ffn_w_in", "ffn_w_out"}


def _mlp_inputs(seed=0, d=48, f=96):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    p = {"w_in": (rng.standard_normal((d, f)) * 0.2).astype(np.float32),
         "w_out": (rng.standard_normal((f, d)) * 0.1).astype(np.float32)}
    return x, p


def test_mlp_matches_jax():
    x, p = _mlp_inputs()
    want = np.asarray(JL.mlp({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x)))
    got = TL.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                 torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_exact_gelu_would_fail_the_twin():
    """``jax.nn.gelu`` is the tanh approximation by default; the erf form
    parts from it by far more than the twin's 1e-6, so the ``approximate``
    flag is what makes the port match."""
    x, p = _mlp_inputs(1)
    want = np.asarray(JL.mlp({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x)))
    tx = torch.from_numpy(x)
    h = F.gelu(tx @ torch.from_numpy(p["w_in"]))
    exact = (h @ torch.from_numpy(p["w_out"])).numpy()
    assert np.abs(exact - want).max() > 1e-4


def test_init_params_mlp_shapes_and_depth_scale():
    jc = tiny_cfg("opt-175b", layers=4, d_model=128)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = TM.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    jb, tb = jp["stack"]["s0"], tp["stack"]["s0"]
    assert set(jb) == set(tb)
    for k in jb:
        assert tuple(tb[k].shape) == tuple(jb[k].shape), k
    # 0.02 / sqrt(2 L) on the MLP's output projection, as on wo
    want = 0.02 / np.sqrt(2.0 * tc.num_layers)
    assert abs(float(tb["ffn_w_out"].std()) - want) < 0.1 * want
    assert abs(float(tb["ffn_w_in"].std()) - 0.02) < 0.002


CONFIGS = {a: (lambda a=a: tiny_cfg(a)) for a in NEW_ARCHS}
# reduced() caps heads at 4/4, so GQA needs explicit kv heads
CONFIGS.update({a + "-gqa2": (lambda a=a: dataclasses.replace(
    tiny_cfg(a), num_kv_heads=2)) for a in NEW_ARCHS})


def _setup(name, seed=0):
    jc = CONFIGS[name]()
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jax.random.PRNGKey(seed), jc)
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
    jprefill = jax.jit(partial(JM.prefill, cfg=jc, cache_len=cache))
    jdecode = jax.jit(partial(JM.decode_step, cfg=jc))
    jl, js = jprefill(jp, tokens=jnp.asarray(toks),
                      prompt_lens=jnp.asarray(plens))
    tl, ts = TM.prefill(tp, tc, torch.from_numpy(toks),
                        torch.from_numpy(plens), cache)
    _close(tl, jl)
    for _ in range(3):
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


@pytest.mark.parametrize("name", ["opt-175b", "opt-175b-gqa2"])
def test_run_decomposed_mlp_block_matches(name):
    """An MLP block through the S/R split: the port's run_decomposed ==
    its apply_block == the JAX decomposition."""
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
    th = torch.from_numpy(h)
    ha, st_a = TD.run_decomposed("attn", tpl, th, st_a, tctx)
    hb, st_b, _ = TM.apply_block("attn", tpl, th, st_b, tctx)
    _close(ha, hb)
    _close(ha, jh)
    for k in ("k", "v"):
        _close(st_a[k], jnew[k])


@pytest.fixture(scope="module")
def opt_serve():
    jc = dataclasses.replace(tiny_cfg("opt-175b"), num_kv_heads=2)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    spec = random_spec(np.random.default_rng(1), jc, 6)
    return tc, tp, spec, serve_trace(jp, jc, spec)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("workers", [1, 2])
def test_opt_175b_serving_matches_jax_oracle(opt_serve, paged, workers):
    tc, tp, spec, want = opt_serve
    eng = ServingEngine(tp, tc, batch=4, cache_len=48, backend="hetero",
                        num_r_workers=workers, paged_kv=paged, page_size=4,
                        device="cpu")
    try:
        qi = 0
        order = sorted(range(len(spec)), key=lambda i: spec[i][2])
        while (qi < len(order) or eng.queue
               or any(s is not None for s in eng.slots)) \
                and eng.step_idx < 400:
            while qi < len(order) and spec[order[qi]][2] <= eng.step_idx:
                i = order[qi]
                eng.submit(Request(rid=i, prompt=spec[i][0],
                                   max_new_tokens=spec[i][1]))
                qi += 1
            eng.step()
        got = {r.rid: list(r.generated) for r in eng.finished}
    finally:
        eng.close()
    assert got == want
