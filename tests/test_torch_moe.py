"""The mixture-of-experts FFN and the two MoE models (grok-1-314b,
llama4-scout-17b-a16e) in the port, against the JAX package on the same
weights (carried over with repro_torch.bridge) and the same numpy
inputs: ``layers.moe_ffn`` (y and aux within 1e-5, the same keep mask,
at capacities that drop tokens), twins of ``tests/test_moe.py``, the
configs, init and bridge, prefill and decode logits, the decomposition,
the ServingEngine against ``conftest.serve_trace`` (capacity = experts
as ``reduced()`` sets it, and the published 1.25, where the drops
depend on the tokens of each call in both packages), hetero ==
colocated, chunked == monolithic, spec-on == spec-off on grok-1's
softcap, and llama4-scout's early fusion through ``load_prefill``.
fp32."""
import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from conftest import random_spec, serve_trace, tiny_cfg
from repro.core import decompose as JD
from repro.core import perfmodel as JP
from repro.core.config import get_arch as jget_arch
from repro.core.hetero import ColocatedEngine as JColocated
from repro.core.hetero import HeteroPipelineEngine as JHetero
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.core import decompose as TD
from repro_torch.core import perfmodel as TP
from repro_torch.core.config import ModelConfig, get_arch, list_archs
from repro_torch.core.hetero import ColocatedEngine, HeteroPipelineEngine
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving.engine import ServingEngine, SpecConfig
from test_torch_serving import serve_trace_torch

TOL = 1e-5          # moe_ffn alone
MODEL_TOL = 1e-4    # logits through a model, as the other model twins
MOE_ARCHS = ["grok-1-314b", "llama4-scout-17b-a16e"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one intra-op thread, and the suite's
    other workers keep the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# layers.moe_ffn
# ---------------------------------------------------------------------------
_jinit = jax.jit(JM.init_params, static_argnums=1)


def _params(rng, d, f, e, router_scale=1.0):
    mk = lambda *s, sc=0.2: (rng.standard_normal(s) * sc).astype(np.float32)
    return {"router": mk(d, e, sc=router_scale), "w_gate": mk(e, d, f),
            "w_up": mk(e, d, f), "w_down": mk(e, f, d)}


@partial(jax.jit, static_argnums=(2, 3, 4))
def _jax_route_fn(router, x, e, k, capacity_factor):
    xt = x.reshape(-1, x.shape[-1])
    t = xt.shape[0]
    logits = jnp.einsum("td,de->te", xt, router).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, gate_idx = lax.top_k(probs, k)
    cap = max(1, int(math.ceil(t * k / e * capacity_factor)))
    onehot = jax.nn.one_hot(gate_idx.reshape(-1), e, dtype=jnp.int32)
    pos = jnp.einsum("te,te->t", jnp.cumsum(onehot, axis=0) - onehot, onehot)
    return gate_idx, pos < cap


def _jax_route(p, x, e, k, capacity_factor):
    """(gate_idx, keep) by the JAX package's arithmetic
    (``repro.models.layers.moe_ffn``, the routing lines)."""
    idx, keep = _jax_route_fn(jnp.asarray(p["router"]), jnp.asarray(x), e, k,
                              capacity_factor)
    return np.asarray(idx), np.asarray(keep)


def _port_route(p, x, k, capacity_factor):
    tp = {a: torch.from_numpy(b) for a, b in p.items()}
    xt = torch.from_numpy(x).reshape(-1, x.shape[-1])
    probs = torch.softmax((xt @ tp["router"]).float(), dim=-1)
    _, gate_idx, _, keep, _ = TL.moe_route(probs, top_k=k,
                                           capacity_factor=capacity_factor)
    return gate_idx.numpy(), keep.numpy()


def _both(p, x, e, k, capacity_factor):
    """(port y, port aux, JAX y, JAX aux) on the same numpy inputs."""
    jy, ja = jax.jit(partial(JL.moe_ffn, num_experts=e, top_k=k,
                             capacity_factor=capacity_factor))(
        {a: jnp.asarray(b) for a, b in p.items()}, jnp.asarray(x))
    ty, ta = TL.moe_ffn({a: torch.from_numpy(b) for a, b in p.items()},
                        torch.from_numpy(x), num_experts=e, top_k=k,
                        capacity_factor=capacity_factor)
    return ty.numpy(), float(ta), np.asarray(jy), float(ja)


def _assert_twin(p, x, e, k, capacity_factor):
    ty, ta, jy, ja = _both(p, x, e, k, capacity_factor)
    np.testing.assert_allclose(ty, jy, atol=TOL, rtol=0)
    assert abs(ta - ja) <= TOL
    jidx, jkeep = _jax_route(p, x, e, k, capacity_factor)
    tidx, tkeep = _port_route(p, x, k, capacity_factor)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tkeep, jkeep)
    return jkeep


@pytest.mark.parametrize("t", [4, 8, 13])
@pytest.mark.parametrize("capacity", ["experts", 1.25, 1e-9])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_matches_jax(top_k, capacity, t):
    e, d, f = 4, 16, 24
    rng = np.random.default_rng(100 * top_k + t)
    p = _params(rng, d, f, e)
    x = rng.standard_normal((t, d)).astype(np.float32)
    cf = float(e) if capacity == "experts" else capacity
    keep = _assert_twin(p, x, e, top_k, cf)
    cap = max(1, math.ceil(t * top_k / e * cf))
    if capacity == "experts":
        assert keep.all()                  # cap = t*k: nothing drops
    if capacity == 1e-9:
        assert keep.sum() <= e * cap       # one slot per expert


@pytest.mark.parametrize("capacity", [1.0, 1.25])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_crowded_expert_drops_like_jax(top_k, capacity):
    """Most tokens pick expert 0 (a router column far larger than the
    rest, inputs all positive): the later ones in the token-major order
    overflow its capacity and are dropped, in both packages alike."""
    e, d, f, t = 4, 16, 24, 12
    rng = np.random.default_rng(7)
    p = _params(rng, d, f, e, router_scale=0.1)
    p["router"][:, 0] = 1.0
    x = np.abs(rng.standard_normal((t, d))).astype(np.float32)
    keep = _assert_twin(p, x, e, top_k, capacity)
    jidx, _ = _jax_route(p, x, e, top_k, capacity)
    assert (jidx[:, 0] == 0).all()
    cap = max(1, math.ceil(t * top_k / e * capacity))
    assert not keep.all()
    # expert 0 keeps exactly its first ``cap`` entries in token order
    first = keep.reshape(t, top_k)[:, 0]
    assert first.sum() == cap and first[:cap].all()


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_tied_router_logits_pick_the_lower_expert(top_k):
    """Experts 1 and 2 have identical router columns, and one token has
    all-zero features (every logit 0): ties everywhere, which
    ``lax.top_k`` breaks toward the lower index; the port's stable sort
    must do the same (``torch.topk`` promises no order on CUDA)."""
    e, d, f, t = 4, 16, 24, 8
    rng = np.random.default_rng(11)
    p = _params(rng, d, f, e)
    p["router"][:, 2] = p["router"][:, 1]
    x = rng.standard_normal((t, d)).astype(np.float32)
    x[3] = 0.0
    for cf in (float(e), 1.25):
        _assert_twin(p, x, e, top_k, cf)
    tidx, _ = _port_route(p, x, top_k, float(e))
    assert list(tidx[3]) == list(range(top_k))      # all tied: 0, 1, ...
    # a token whose top choice is the tied pair takes 1 before 2
    pair = [i for i in range(t) if tidx[i, 0] in (1, 2)]
    assert all(tidx[i, 0] == 1 for i in pair)
    if top_k == 2:
        assert all(tidx[i, 1] == 2 for i in pair)


def test_moe_ffn_tied_router_logits_bf16():
    """bf16 router logits tie often: a router whose columns round to
    the same bf16 values gives exact ties after the cast to fp32; the
    port's choice equals lax.top_k's."""
    e, d, t = 8, 16, 32
    rng = np.random.default_rng(12)
    r = rng.standard_normal((d, e)).astype(np.float32)
    r[:, 5] = r[:, 4]
    r[:, 7] = r[:, 0]
    x = rng.standard_normal((t, d)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    jr = jnp.asarray(r, jnp.bfloat16)
    jprobs = jax.nn.softmax(jnp.einsum("td,de->te", jx, jr).astype(
        jnp.float32), -1)
    _, jidx = lax.top_k(jprobs, 2)
    tprobs = torch.from_numpy(np.array(jprobs))
    _, tidx, _, _, _ = TL.moe_route(tprobs, top_k=2, capacity_factor=1.25)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


def test_moe_route_positions_and_capacity():
    """pos counts earlier entries of the same expert in token-major
    order; cap is a Python int from the static shape."""
    probs = torch.tensor([[.7, .2, .1], [.6, .3, .1], [.1, .2, .7],
                          [.5, .4, .1]])
    gate_w, idx, pos, keep, cap = TL.moe_route(probs, top_k=2,
                                               capacity_factor=1.0)
    assert isinstance(cap, int) and cap == 3          # ceil(4*2/3)
    assert idx.tolist() == [[0, 1], [0, 1], [2, 1], [0, 1]]
    assert pos.tolist() == [0, 0, 1, 1, 0, 2, 2, 3]
    assert keep.tolist() == [True] * 7 + [False]
    torch.testing.assert_close(gate_w.sum(-1), torch.ones(4))


# twins of tests/test_moe.py -------------------------------------------------
def test_top1_equals_selected_expert():
    rng = np.random.default_rng(0)
    d, f, e = 8, 16, 4
    p = {k: torch.from_numpy(v) for k, v in _params(rng, d, f, e).items()}
    x = torch.from_numpy(rng.standard_normal((5, 7, d)).astype(np.float32))
    y, _ = TL.moe_ffn(p, x, num_experts=e, top_k=1, capacity_factor=float(e))
    eidx = (x @ p["router"]).argmax(-1)
    ref = torch.stack([TL.swiglu({"w_gate": p["w_gate"][ei],
                                  "w_up": p["w_up"][ei],
                                  "w_down": p["w_down"][ei]}, x[i, j])
                       for (i, j), ei in np.ndenumerate(eidx.numpy())])
    torch.testing.assert_close(y, ref.reshape(5, 7, d), rtol=1e-4,
                               atol=1e-4)


def test_topk_weights_sum_to_one_effectively():
    """With top_k=E and ample capacity, output == dense mixture."""
    rng = np.random.default_rng(1)
    d, f, e = 8, 12, 3
    p = {k: torch.from_numpy(v) for k, v in _params(rng, d, f, e).items()}
    x = torch.from_numpy(rng.standard_normal((2, 4, d)).astype(np.float32))
    y, _ = TL.moe_ffn(p, x, num_experts=e, top_k=e, capacity_factor=float(e))
    probs = torch.softmax(x @ p["router"], -1)
    dense = sum(probs[..., i:i + 1] * TL.swiglu(
        {"w_gate": p["w_gate"][i], "w_up": p["w_up"][i],
         "w_down": p["w_down"][i]}, x) for i in range(e))
    torch.testing.assert_close(y, dense, rtol=1e-3, atol=1e-4)


def test_capacity_drops_tokens():
    """With capacity_factor ~0 every expert keeps one token: at most e
    rows are nonzero."""
    rng = np.random.default_rng(2)
    d, f, e = 8, 12, 4
    p = {k: torch.from_numpy(v) for k, v in _params(rng, d, f, e).items()}
    x = torch.from_numpy(rng.standard_normal((3, 5, d)).astype(np.float32))
    y, _ = TL.moe_ffn(p, x, num_experts=e, top_k=1, capacity_factor=1e-9)
    assert int((y.abs() > 1e-9).any(-1).sum()) <= e


def test_aux_loss_bounds():
    rng = np.random.default_rng(3)
    d, f, e = 8, 12, 4
    p = {k: torch.from_numpy(v) for k, v in _params(rng, d, f, e).items()}
    x = torch.from_numpy(rng.standard_normal((4, 16, d)).astype(np.float32))
    _, aux = TL.moe_ffn(p, x, num_experts=e, top_k=2, capacity_factor=2.0)
    # perfectly balanced -> 1.0; worst case -> e
    assert 0.9 <= float(aux) <= e + 1e-3


# ---------------------------------------------------------------------------
# configs, init, bridge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_full_config_equals_jax(arch):
    jc, tc = jget_arch(arch), get_arch(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert arch in list_archs()
    assert tc.ffn_kind == "moe" and tc.moe_capacity == 1.25
    TM.init_decode_state(tc.reduced(), 1, 4, "cpu")


def test_published_widths_the_port_serves():
    """grok-1: 8 experts top-2, softcap 30, G = 6; llama4-scout: 16
    experts top-1, qk_norm, G = 5, the vision stub (early fusion, 64
    patch embeddings)."""
    g, s = get_arch("grok-1-314b"), get_arch("llama4-scout-17b-a16e")
    assert (g.num_experts, g.top_k, g.attn_logit_softcap,
            g.num_heads // g.num_kv_heads, g.head_dim) == (8, 2, 30.0, 6, 128)
    assert (s.num_experts, s.top_k, s.qk_norm, s.num_heads // s.num_kv_heads,
            s.head_dim, s.frontend, s.encoder_seq) == \
        (16, 1, True, 5, 128, "vision_stub", 64)
    assert TM.early_fusion(s) and not TM.early_fusion(g)
    # no shared expert: the reference's block has none either
    assert {k for k in TM._block_param_shapes(s) if k.startswith("ffn_")} \
        == {"ffn_router", "ffn_w_gate", "ffn_w_up", "ffn_w_down"}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_params_moe_shapes_and_scales(arch):
    jc = tiny_cfg(arch, layers=4, d_model=128)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = jax.eval_shape(partial(JM.init_params, cfg=jc),
                        jax.random.PRNGKey(0))
    tp = TM.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    jb, tb = jp["stack"]["s0"], tp["stack"]["s0"]
    assert set(jb) == set(tb)
    for k in jb:
        assert tuple(tb[k].shape) == tuple(jb[k].shape), k
    e = tc.num_experts
    assert tuple(tb["ffn_w_gate"].shape) == (4, e, 128, tc.d_ff)
    want = 0.02 / np.sqrt(2.0 * tc.num_layers)
    assert abs(float(tb["ffn_w_down"].std()) - want) < 0.1 * want
    for k in ("ffn_w_gate", "ffn_w_up", "ffn_router"):
        assert abs(float(tb[k].std()) - 0.02) < 0.003, k
    # drawn one expert at a time: experts differ
    assert not torch.equal(tb["ffn_w_gate"][0, 0], tb["ffn_w_gate"][0, 1])


def _to_np(tree):
    def leaf(x):
        a = np.asarray(x)
        return a.view(np.uint16) if x.dtype == jnp.bfloat16 else a
    return jax.tree.map(leaf, tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bridge_carries_the_expert_leaves(arch, dtype):
    jc = dataclasses.replace(tiny_cfg(arch), dtype=dtype)
    tc = ModelConfig(**dataclasses.asdict(jc))
    # the JAX package's tree and leaf dtypes, filled with seeded numbers
    rng = np.random.default_rng(3)
    jp = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), a.dtype), jax.eval_shape(
            partial(JM.init_params, cfg=jc), jax.random.PRNGKey(3)))
    tp = bridge.params_from_numpy(_to_np(jp), tc, "cpu")
    want = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    for k in ("ffn_router", "ffn_w_gate", "ffn_w_up", "ffn_w_down"):
        jl, tl = jp["stack"]["s0"][k], tp["stack"]["s0"][k]
        assert tl.dtype == want and tuple(tl.shape) == tuple(jl.shape), k
        np.testing.assert_array_equal(tl.float().numpy(),
                                      np.asarray(jl, np.float32))
    back = bridge.params_to_numpy(tp)
    for k, v in _to_np(jp)["stack"]["s0"].items():
        assert np.array_equal(back["stack"]["s0"][k].view(np.uint8),
                              v.view(np.uint8)), k


# ---------------------------------------------------------------------------
# reduced models against the JAX package
# ---------------------------------------------------------------------------
CONFIGS = {a: (lambda a=a: tiny_cfg(a)) for a in MOE_ARCHS}
# reduced() caps heads at 4/4, so GQA needs explicit kv heads; and the
# published capacity factor, where tokens drop
CONFIGS.update({a + "-gqa2": (lambda a=a: dataclasses.replace(
    tiny_cfg(a), num_kv_heads=2)) for a in MOE_ARCHS})
CONFIGS.update({a + "-cap1.25": (lambda a=a: dataclasses.replace(
    tiny_cfg(a), num_kv_heads=2, moe_capacity=1.25)) for a in MOE_ARCHS})


def _setup(name, seed=0):
    jc = CONFIGS[name]()
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = _jinit(jax.random.PRNGKey(seed), jc)
    # nonzero norm scales (qk_norm's among them), so the gains count
    rng = np.random.default_rng(1)
    leaves, tree = jax.tree.flatten(jax.tree.map(np.asarray, jp))
    leaves = [x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype)
              if x.dtype == np.float32 and x.shape[-1] in
              (jc.d_model, jc.head_dim) and x.ndim <= 2 else x
              for x in leaves]
    jp = jax.tree.map(jnp.asarray, jax.tree.unflatten(tree, leaves))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def _close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


@pytest.mark.parametrize("name", sorted(
    n for n in CONFIGS if n.endswith("-cap1.25")))
def test_prefill_and_decode_match_jax(name):
    jc, tc, jp, tp = _setup(name)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, jc.vocab_size, (3, 9)).astype(np.int32)
    plens = np.array([9, 4, 6], np.int32)
    cache = 16
    jl, js = jax.jit(partial(JM.prefill, cfg=jc, cache_len=cache))(
        jp, tokens=jnp.asarray(toks), prompt_lens=jnp.asarray(plens))
    tl, ts = TM.prefill(tp, tc, torch.from_numpy(toks),
                        torch.from_numpy(plens), cache)
    _close(tl, jl)
    jdecode = jax.jit(partial(JM.decode_step, cfg=jc))
    for _ in range(3):
        t1 = rng.integers(1, jc.vocab_size, (3, 1)).astype(np.int32)
        jl, js = jdecode(jp, state=js, tokens=jnp.asarray(t1))
        tl, ts = TM.decode_step(tp, tc, ts, torch.from_numpy(t1))
        _close(tl, jl)
    for key in ("k", "v"):
        _close(ts["stack"]["s0"][key], js["stack"]["s0"][key])


def test_early_fusion_prefill_matches_jax():
    """llama4-scout's vision stub: patch embeddings replace the first n
    token embeddings in prefill, as the JAX package's ``_embed``."""
    jc, tc, jp, tp = _setup("llama4-scout-17b-a16e-gqa2")
    rng = np.random.default_rng(5)
    toks = rng.integers(1, jc.vocab_size, (2, 12)).astype(np.int32)
    plens = np.array([12, 9], np.int32)
    feats = rng.standard_normal((2, 5, jc.d_model)).astype(np.float32)
    jl, js = jax.jit(partial(JM.prefill, cfg=jc, cache_len=16))(
        jp, tokens=jnp.asarray(toks), prompt_lens=jnp.asarray(plens),
        enc_feats=jnp.asarray(feats))
    tl, ts = TM.prefill(tp, tc, torch.from_numpy(toks),
                        torch.from_numpy(plens), 16,
                        enc_feats=torch.from_numpy(feats))
    _close(tl, jl)
    _close(ts["stack"]["s0"]["k"], js["stack"]["s0"]["k"])
    plain, _ = TM.prefill(tp, tc, torch.from_numpy(toks),
                          torch.from_numpy(plens), 16)
    assert float((plain - tl).abs().max()) > 1e-3     # the features count


@pytest.mark.parametrize("name", ["grok-1-314b"])
def test_decomposed_equals_fused_block(name):
    """Twin of the grok-1 case of tests/test_decompose.py: the port's
    run_decomposed == its apply_block == the JAX decomposition."""
    jc, tc, jp, tp = _setup(name)
    rng = np.random.default_rng(1)
    b, s = 2, 10
    toks = rng.integers(0, jc.vocab_size, (b, s)).astype(np.int32)
    plens = np.full((b,), s, np.int32)
    _, js = jax.jit(partial(JM.prefill, cfg=jc, cache_len=s + 4, q_chunk=8,
                            kv_chunk=8))(jp, tokens=jnp.asarray(toks),
                                         prompt_lens=jnp.asarray(plens))
    h = (rng.standard_normal((b, 1, jc.d_model)) * 0.1).astype(np.float32)
    lengths = np.asarray(js["lengths"])
    jctx = JM.Ctx(jc, "decode", jnp.asarray(lengths)[:, None],
                  jnp.asarray(lengths), None, 0)
    ts = bridge.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    tl = torch.from_numpy(lengths)
    tctx = TM.Ctx(tc, "decode", tl[:, None], tl, 8)
    jdec = jax.jit(partial(JD.run_decomposed, "attn", ctx=jctx, kv_chunk=8))
    for li in range(jc.num_layers):
        jpl = jax.tree.map(lambda x: x[li], jp["stack"]["s0"])
        jst = jax.tree.map(lambda x: x[li], js["stack"]["s0"])
        jh, jnew = jdec(jpl, jnp.asarray(h), jst)
        tpl = TM.per_layer(tp, tc)[li]
        st_a = {k: v.clone() for k, v in TM.per_layer(ts, tc)[li].items()}
        st_b = {k: v.clone() for k, v in st_a.items()}
        ha, st_a = TD.run_decomposed("attn", tpl, torch.from_numpy(h), st_a,
                                     tctx, kv_chunk=8)
        hb, st_b, _ = TM.apply_block("attn", tpl, torch.from_numpy(h),
                                     st_b, tctx)
        _close(ha, hb)
        _close(ha, jh)
        for k in ("k", "v"):
            _close(st_a[k], jnew[k])


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------
HETERO = dict(backend="hetero", num_r_workers=2, paged_kv=True, page_size=4)


def _port_trace(tp, tc, spec, **kw):
    return serve_trace_torch(tp, tc, spec, **kw)[0]


@pytest.fixture(scope="module", params=["grok-1-314b-gqa2",
                                        "llama4-scout-17b-a16e-gqa2"])
def moe_serve(request):
    jc, tc, jp, tp = _setup(request.param)
    spec = random_spec(np.random.default_rng(1), jc, 5, p_hi=10, spread=6)
    return request.param, jc, tc, jp, tp, spec, serve_trace(jp, jc, spec,
                                                            **HETERO)


def test_hetero_paged_serve_matches_jax_oracle(moe_serve):
    _, _, tc, _, tp, spec, want = moe_serve
    assert _port_trace(tp, tc, spec, **HETERO) == want


@pytest.mark.parametrize("kw", [dict(backend="colocated"),
                                dict(HETERO, num_r_workers=1),
                                dict(backend="hetero", num_r_workers=2)],
                         ids=["colocated", "paged-1w", "dense-2w"])
def test_hetero_equals_colocated(moe_serve, kw):
    """At capacity = experts nothing drops, so every engine gives the
    hetero paged serve's tokens."""
    _, _, tc, _, tp, spec, want = moe_serve
    assert _port_trace(tp, tc, spec, **kw) == want


def test_chunked_equals_monolithic(moe_serve):
    _, _, tc, _, tp, spec, want = moe_serve
    assert _port_trace(tp, tc, spec, prefill_chunk=5, **HETERO) == want


def test_spec_on_equals_spec_off_on_grok_softcap():
    jc, tc, jp, tp = _setup("grok-1-314b-gqa2")
    assert tc.attn_logit_softcap == 30.0
    spec = random_spec(np.random.default_rng(2), jc, 6, max_new=7)
    off = _port_trace(tp, tc, spec, **HETERO)
    on = _port_trace(tp, tc, spec, spec_decode=SpecConfig(k=3), **HETERO)
    assert on == off


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_published_capacity_drops_as_jax_at_equal_t(arch):
    """At moe_capacity 1.25 the drops depend on each call's token count
    (a micro-batch's rows in the hetero S-Part, B*S in prefill): the
    port's hetero paged serve gives the JAX package's tokens.  (The
    colocated step's t, the batch, is held by the decode twin above.)"""
    jc, tc, jp, tp = _setup(arch + "-cap1.25")
    spec = random_spec(np.random.default_rng(3), jc, 5, p_hi=9, spread=4)
    assert _port_trace(tp, tc, spec, **HETERO) == serve_trace(jp, jc, spec,
                                                              **HETERO)


def test_moe_archs_take_spec_prefix_and_chunks_as_jax():
    """Pure ATTN with window 0: spec_decode, prefix_cache and
    prefill_chunk all construct, in the port as in the JAX package."""
    _, tc, _, tp = _setup("grok-1-314b")
    for kw in (dict(spec_decode=SpecConfig(k=2)), dict(prefix_cache=True),
               dict(prefill_chunk=4)):
        ServingEngine(tp, tc, batch=4, cache_len=32, device="cpu", **HETERO,
                      **kw).close()


# ---------------------------------------------------------------------------
# load_prefill with the vision stub's patch embeddings
# ---------------------------------------------------------------------------
def _static(eng_load, eng_step, batch, toks, plens, steps=4):
    eng_load()
    tok = toks[np.arange(batch), plens - 1][:, None]
    out_t, out_l = [], []
    for _ in range(steps):
        logits = np.asarray(eng_step(tok), np.float32)
        tok = logits.argmax(-1)[:, None].astype(np.int32)
        out_t.append(tok)
        out_l.append(logits)
    return np.concatenate(out_t, 1), np.stack(out_l)


def test_load_prefill_early_fusion_matches_jax_on_both_engines():
    jc, tc, jp, tp = _setup("llama4-scout-17b-a16e-gqa2")
    b, mb, cache = 4, 2, 32
    rng = np.random.default_rng(9)
    toks = rng.integers(1, jc.vocab_size, (b, 10)).astype(np.int32)
    plens = np.array([10, 8, 9, 7], np.int32)
    feats = rng.standard_normal((b, jc.encoder_seq // 4, jc.d_model)
                                ).astype(np.float32)
    T = torch.from_numpy

    def hetero_step(eng):
        return lambda tok: torch.cat(eng.decode_step(
            [T(tok[m * mb:(m + 1) * mb]) for m in range(b // mb)])).numpy()

    def jhetero_step(eng):
        return lambda tok: np.concatenate([np.asarray(x) for x in
                                           eng.decode_step(
            [jnp.asarray(tok[m * mb:(m + 1) * mb]) for m in range(b // mb)])])

    want = {}
    jh = JHetero(jp, jc, batch=b, cache_len=cache, num_r_workers=2,
                 num_microbatches=2, paged_kv=True)
    try:
        want["hetero"] = _static(lambda: [jh.load_prefill(
            m, jnp.asarray(toks[m * mb:(m + 1) * mb]),
            jnp.asarray(plens[m * mb:(m + 1) * mb]),
            enc_feats=jnp.asarray(feats[m * mb:(m + 1) * mb]))
            for m in range(2)], jhetero_step(jh), b, toks, plens)
    finally:
        jh.close()
    jcol = JColocated(jp, jc, batch=b, cache_len=cache)
    want["colocated"] = _static(
        lambda: jcol.load_prefill(jnp.asarray(toks), jnp.asarray(plens),
                                  enc_feats=jnp.asarray(feats)),
        lambda tok: np.asarray(jcol.decode_step(jnp.asarray(tok))),
        b, toks, plens)

    th = HeteroPipelineEngine(tp, tc, batch=b, cache_len=cache,
                              num_r_workers=2, num_microbatches=2,
                              paged_kv=True, device="cpu")
    try:
        got_h = _static(lambda: [th.load_prefill(
            m, T(toks[m * mb:(m + 1) * mb]), T(plens[m * mb:(m + 1) * mb]),
            enc_feats=T(feats[m * mb:(m + 1) * mb])) for m in range(2)],
            hetero_step(th), b, toks, plens)
    finally:
        th.close()
    tcol = ColocatedEngine(tp, tc, batch=b, cache_len=cache, device="cpu")
    got_c = _static(lambda: tcol.load_prefill(T(toks), T(plens),
                                              enc_feats=T(feats)),
                    lambda tok: tcol.decode_step(T(tok)).numpy(),
                    b, toks, plens)
    for name, got in (("hetero", got_h), ("colocated", got_c)):
        np.testing.assert_array_equal(got[0], want[name][0])
        _close(got[1], want[name][1])
    np.testing.assert_array_equal(got_h[0], got_c[0])
    _close(got_h[1], got_c[1])


def test_enc_feats_still_refused_without_early_fusion():
    """An arch with no frontend takes no features, on both engines; the
    cross-attention archs (no early fusion: their features feed
    cross-attention, tests/test_torch_xattn_serve.py) are refused by the
    ServingEngine, whose admissions carry no features."""
    for arch in ("whisper-medium", "llama-3.2-vision-90b"):
        tc = ModelConfig(**dataclasses.asdict(jget_arch(arch)))
        assert not TM.early_fusion(tc) and TM.has_xattn(tc)
        with pytest.raises(ValueError, match="static-batch API"):
            ServingEngine({}, tc.reduced(), batch=2, cache_len=8,
                          device="cpu")
    _, tc, _, tp = _setup("grok-1-314b")
    heng = HeteroPipelineEngine(tp, tc, batch=2, cache_len=16,
                                num_r_workers=1, device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="enc_feats"):
            heng.load_prefill(0, torch.ones((1, 4), dtype=torch.int32),
                              torch.tensor([4]),
                              enc_feats=torch.zeros((1, 2, tc.d_model)))
    finally:
        heng.close()
    eng = ColocatedEngine(tp, tc, batch=2, cache_len=16, device="cpu")
    with pytest.raises(NotImplementedError, match="enc_feats"):
        eng.load_prefill(torch.ones((2, 4), dtype=torch.int32),
                         torch.tensor([4, 4]),
                         enc_feats=torch.zeros((2, 2, tc.d_model)))


# ---------------------------------------------------------------------------
# the §4.3 model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_perfmodel_and_from_plan_on_moe(arch):
    """The copied perfmodel counts the top-k experts per token as the
    JAX package's does, and from_plan builds an engine on the arch."""
    jc, tc = jget_arch(arch), get_arch(arch)
    assert TP.s_part_params_per_block(tc) == JP.s_part_params_per_block(jc)
    jplan = JP.plan(jc, JP.TPU_V5E, JP.TPU_V5E, seq_len=1024, page=16)
    tplan = TP.plan(tc, TP.TPU_V5E, TP.TPU_V5E, seq_len=1024, page=16)
    assert tplan == jplan
    d, f, e, k = tc.d_model, tc.d_ff, tc.num_experts, tc.top_k
    assert TP.s_part_params_per_block(tc) - TP.s_part_params_per_block(
        dataclasses.replace(tc, ffn_kind="none")) == k * 3 * d * f + d * e
    _, rc, _, rp = _setup(arch)
    eng = ServingEngine.from_plan(rp, rc, seq_len=64, max_batch=4,
                                  backend="hetero", paged_kv=True,
                                  page_size=4, device="cpu")
    try:
        assert eng.plan["batch"] >= 1
    finally:
        eng.close()
