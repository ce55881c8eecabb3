"""Cross-attention and the encoder-decoder in the port, against the JAX
package on the same weights (carried over with repro_torch.bridge) and
the same numpy inputs: llama-3.2-vision-90b (a gated XATTN layer every
fifth layer, patch features) and whisper-medium (an ENC_ATTN encoder over
frame features, DEC_XATTN decoder blocks of two phases).

* the configs, ``check_supported``, the published widths (twins of
  ``tests/test_models_smoke.py``'s rows), init shapes, the bridge of the
  ``encoder`` subtree and the fp32 gates;
* ``_encode``, prefill and decode logits and states;
* the decomposition: ``num_phases``, ``r_cross_attention``'s plain
  version, ``run_decomposed == apply_block`` and against ``repro``'s
  ``run_decomposed`` (twin of ``tests/test_decompose.py``);
* ``phases_per_layer_step`` (twin of ``tests/test_perfmodel.py``).

Two traps are held here.  The JAX package inits ``gate_attn`` and
``gate_ffn`` to zero, so an XATTN block with init weights is the
identity and logits would agree with a broken cross-attention: every
comparison overwrites both gates (and the norm scales) with seeded
non-zero values on the numpy side.  And ``tiny_cfg(..., layers=3)``
gives llama-3.2-vision-90b no XATTN layer (its period is 5): the vision
cases take 5 or 10 layers.  fp32 tiny configs; 1e-5 for a layer alone,
1e-4 for logits through a model, as the other model twins."""
import dataclasses
import inspect
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.core import decompose as JD
from repro.core import perfmodel as JP
from repro.core.config import get_arch as jget_arch
from repro.core.config import list_archs as jlist_archs
from repro.core.hetero import per_layer_params as jper_layer_params
from repro.core.hetero import per_layer_state as jper_layer_state
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.core import decompose as TD
from repro_torch.core import perfmodel as TP
from repro_torch.core.config import (ModelConfig, check_supported, get_arch,
                                     list_archs)
from repro_torch.kernels import decode_attention as DA
from repro_torch.models import model as TM

TOL = 1e-5           # a layer alone
MODEL_TOL = 1e-4     # logits through a model
ARCHS = {"whisper-medium": 3, "llama-3.2-vision-90b": 10}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_jinit = jax.jit(JM.init_params, static_argnums=1)


def _perturb(tree, rng, d, hd):
    """Seeded non-zero XATTN gates (init: 0, which makes the block the
    identity) and norm scales (init: 0), on numpy leaves."""
    if isinstance(tree, list):
        return [_perturb(v, rng, d, hd) for v in tree]
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            out[k] = _perturb(v, rng, d, hd)
        elif k in ("gate_attn", "gate_ffn"):
            out[k] = rng.uniform(0.3, 1.2, v.shape).astype(np.float32)
        elif (k.startswith("ln") or k.endswith("norm")) \
                and v.shape[-1] in (d, hd):
            out[k] = v + 0.1 * rng.standard_normal(v.shape).astype(v.dtype)
        else:
            out[k] = v
    return out


def setup_xattn(arch, layers=None, seed=0):
    """(JAX cfg, port cfg, JAX params, port params) of a tiny fp32 config
    with perturbed gates and norms; the vision arch at >= 5 layers."""
    jc = tiny_cfg(arch, layers=layers or ARCHS[arch])
    tc = ModelConfig(**dataclasses.asdict(jc))
    npp = jax.tree.map(np.asarray, _jinit(jax.random.PRNGKey(seed), jc))
    npp = _perturb(npp, np.random.default_rng(seed + 1), jc.d_model,
                   jc.head_dim)
    tp = bridge.params_from_numpy(npp, tc, "cpu")
    return jc, tc, jax.tree.map(jnp.asarray, npp), tp


def feats_for(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.encoder_d_model)).astype(np.float32)


def _close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0)


def _state_close(tstate, jstate, tol=MODEL_TOL):
    jl, jt = jax.tree.flatten_with_path(jax.tree.map(np.asarray, jstate))
    tn = bridge.state_to_numpy(tstate)
    for path, want in jl:
        got = tn
        for p in path:
            got = got[p.key if hasattr(p, "key") else p.idx]
        _close(got, want, tol)


# ---------------------------------------------------------------------------
# configs, init, bridge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_match_jax(arch):
    tc, jc = get_arch(arch), jget_arch(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for kw in ({}, dict(layers=5, d_model=64, vocab=97)):
        assert dataclasses.asdict(tc.reduced(**kw)) \
            == dataclasses.asdict(jc.reduced(**kw))
    check_supported(tc)
    check_supported(tc.reduced())


def test_every_reference_config_is_registered():
    """With these two the port has all 13 of ``repro``'s configs."""
    assert set(list_archs()) == set(jlist_archs())
    assert len(list_archs()) == 13


@pytest.mark.parametrize("arch,spec", [
    ("llama-3.2-vision-90b", (100, 8192, 64, 8, 28672, 128256)),
    ("whisper-medium", (24, 1024, 16, 16, 4096, 51865))])
def test_published_widths(arch, spec):
    """Twin of ``tests/test_models_smoke.py::test_full_config_matches_
    assignment`` for the two archs, with the pattern, the encoder and
    the features: vision's 100 layers are 20 periods of four ATTN and one
    XATTN layer over 1600 patches; whisper's 24 DEC_XATTN decoder layers
    read a 24-layer encoder over 1500 frames, tied embeddings, MHA."""
    c = get_arch(arch)
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads, c.d_ff,
            c.vocab_size) == spec
    if arch == "whisper-medium":
        assert set(c.pattern) == {"dec_xattn"} and c.is_encdec
        assert (c.encoder_layers, c.encoder_seq, c.encoder_d_model,
                c.head_dim, c.ffn_kind, c.tie_embeddings,
                c.frontend) == (24, 1500, 1024, 64, "mlp", True,
                                "audio_stub")
    else:
        assert c.pattern.count("xattn") == 20 and c.pattern[4::5] \
            == ("xattn",) * 20 and not c.is_encdec
        assert (c.encoder_seq, c.encoder_d_model, c.head_dim,
                c.frontend) == (1600, 8192, 128, "vision_stub")
        assert not TM.early_fusion(c) and TM.has_xattn(c)


def test_check_supported_refuses_an_encoder_block_in_the_decoder():
    bad = dataclasses.replace(get_arch("whisper-medium"),
                              layer_pattern=("enc_attn",))
    with pytest.raises(NotImplementedError, match="encoder"):
        check_supported(bad)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_params_shapes_and_zero_gates(arch):
    """The shapes of ``repro``'s tree, the encoder subtree included; in
    bf16 the gates, ``lnx`` and the norms stay fp32, and the gates start
    at 0 as in ``repro`` (the trap the other tests avoid)."""
    jc = tiny_cfg(arch, layers=ARCHS[arch])
    tc = dataclasses.replace(ModelConfig(**dataclasses.asdict(jc)),
                             dtype="bfloat16")
    jp = jax.eval_shape(partial(JM.init_params, cfg=jc),
                        jax.random.PRNGKey(0))
    tp = TM.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda x: tuple(x.shape), jp) == jax.tree.map(
        lambda x: tuple(x.shape), bridge.params_to_numpy(tp))
    leaves = {k: v for b in list(tp["stack"].values()) + tp["rem"]
              for k, v in b.items()}
    for k in ("gate_attn", "gate_ffn", "lnx", "ln1"):
        if k in leaves:
            assert leaves[k].dtype == torch.float32, k
    if arch == "llama-3.2-vision-90b":
        assert float(leaves["gate_attn"].abs().max()) == 0.0
        assert float(leaves["gate_ffn"].abs().max()) == 0.0
    else:
        enc = tp["encoder"]["stack"]["s0"]
        assert enc["wq"].shape[0] == jc.encoder_layers
        assert leaves["x_wk"].shape[1:] == (jc.encoder_d_model,
                                        jc.num_kv_heads * jc.head_dim)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_bridge_round_trip_carries_the_encoder_and_the_gates(arch):
    _, tc, jp, _ = setup_xattn(arch)
    npp = jax.tree.map(np.asarray, jp)
    tp = bridge.params_from_numpy(npp, tc, "cpu", dtype=torch.bfloat16)
    back = bridge.params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(npp)
    for slot in tp["stack"].values():
        for k in ("gate_attn", "gate_ffn", "lnx"):
            if k in slot:
                assert slot[k].dtype == torch.float32
                np.testing.assert_array_equal(slot[k].numpy(),
                                              npp["stack"]["s4" if "gate"
                                                           in k else "s0"]
                                              [k])
    if tc.is_encdec:
        assert tp["encoder"]["stack"]["s0"]["wq"].dtype == torch.bfloat16
        assert tp["encoder"]["final_norm"].dtype == torch.float32
        np.testing.assert_array_equal(
            tp["encoder"]["final_norm"].numpy(),
            npp["encoder"]["final_norm"])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_encode_matches_jax():
    """The encoder: roped, non-causal ENC_ATTN blocks and a final norm."""
    jc, tc, jp, tp = setup_xattn("whisper-medium")
    f = feats_for(jc, 2, 3)
    want = JM._encode(jp, jc, jnp.asarray(f), None)
    got = TM._encode(tp, tc, torch.from_numpy(f))
    _close(got, want, TOL)
    # non-causal: the first frame's output depends on the last frame
    f2 = f.copy()
    f2[:, -1] += 1.0
    assert float((TM._encode(tp, tc, torch.from_numpy(f2))[:, 0]
                  - got[:, 0]).abs().max()) > 1e-6


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_decode_match_jax(arch):
    """Ragged prompts; the logits of prefill and of 3 decode steps, and
    the states (self-attention caches, the static cross K/V)."""
    jc, tc, jp, tp = setup_xattn(arch)
    rng = np.random.default_rng(5)
    toks = rng.integers(1, jc.vocab_size, (3, 9)).astype(np.int32)
    plens = np.array([9, 4, 7], np.int32)
    f = feats_for(jc, 3, 6)
    jl, js = JM.prefill(jp, jc, jnp.asarray(toks), jnp.asarray(plens), 14,
                        enc_feats=jnp.asarray(f))
    tl, ts = TM.prefill(tp, tc, torch.from_numpy(toks),
                        torch.from_numpy(plens), 14,
                        enc_feats=torch.from_numpy(f))
    _close(tl, jl)
    _state_close(ts, js)
    tok = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    for _ in range(3):
        jl, js = JM.decode_step(jp, jc, js, jnp.asarray(tok))
        tl, ts = TM.decode_step(tp, tc, ts, torch.from_numpy(tok))
        _close(tl, jl)
        tok = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    _state_close(ts, js)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_needs_the_features_and_chunks_are_refused(arch):
    _, tc, _, tp = setup_xattn(arch)
    toks = torch.ones((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="enc_feats"):
        TM.prefill(tp, tc, toks, torch.tensor([4, 4]), 8)
    _, st = TM.prefill(tp, tc, toks, torch.tensor([4, 4]), 8,
                       enc_feats=torch.from_numpy(feats_for(tc, 2, 0)))
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        TM.prefill_chunk(tp, tc, st, toks, torch.arange(4, 8).expand(2, 4))


def test_zero_gates_make_an_xattn_block_the_identity():
    """The trap, shown: with ``repro``'s init gates an XATTN block returns
    its input whatever its cross-attention computes."""
    _, tc, _, tp = setup_xattn("llama-3.2-vision-90b", layers=5)
    p = {k: (torch.zeros_like(v) if k.startswith("gate_") else v)
         for k, v in TM.per_layer(tp, tc)[4].items()}
    h = torch.randn((2, 1, tc.d_model), generator=torch.Generator()
                    .manual_seed(0))
    st = {k: torch.randn(v.shape) for k, v in TM._block_state(
        tc, "xattn", 2, 8, "cpu").items()}
    ln = torch.zeros((2,), dtype=torch.int32)
    out, _, _ = TM.apply_block("xattn", p, h, st,
                               TM.Ctx(tc, "decode", ln[:, None], ln))
    assert torch.equal(out, h)


# ---------------------------------------------------------------------------
# the decomposition
# ---------------------------------------------------------------------------
def test_num_phases_and_the_parameter_free_r_part():
    for kind in ("attn", "xattn", "dec_xattn", "rglru", "ssd"):
        assert TD.num_phases(kind) == JD.num_phases(kind)
    assert TD.num_phases("dec_xattn") == 2
    sig = inspect.signature(TD.r_cross_attention)
    assert "p" not in sig.parameters and "params" not in sig.parameters


@pytest.mark.parametrize("hq,hkv,dh,s", [(4, 4, 16, 11), (8, 2, 32, 40)])
def test_r_cross_attention_plain_version_matches_jax(hq, hkv, dh, s):
    """On CPU tensors the R-Part is kernel 2's plain version (one plain
    call), equal to ``repro``'s flash attention over the slab."""
    rng = np.random.default_rng(hq + s)
    b = 3
    q = rng.standard_normal((b, 1, hq, dh)).astype(np.float32)
    xk = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    xv = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    lengths = np.array([0, 5, 17], np.int32)
    want, _ = JD.r_cross_attention(
        {"q": jnp.asarray(q), "lengths": jnp.asarray(lengths)},
        {"xk": jnp.asarray(xk), "xv": jnp.asarray(xv)}, kv_chunk=8)
    st = {"xk": torch.from_numpy(xk), "xv": torch.from_numpy(xv)}
    DA.plain_calls.reset()
    got, st2 = TD.r_cross_attention(
        {"q": torch.from_numpy(q), "lengths": torch.from_numpy(lengths)}, st)
    assert DA.plain_calls.value == 1 and st2 is st
    _close(got["o"], want["o"], TOL)
    # a kept all-zero pos gives the same numbers
    pos = TD.cross_pos(b, s, "cpu")
    again, _ = TD.r_cross_attention(
        {"q": torch.from_numpy(q), "lengths": torch.from_numpy(lengths)}, st,
        pos=pos)
    assert torch.equal(again["o"], got["o"])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_run_decomposed_equals_apply_block_and_jax(arch):
    """Twin of ``tests/test_decompose.py``: per layer, the decomposed
    block equals the fused one (port) and ``repro``'s decomposed block;
    the DEC_XATTN chain runs two phases, the second reading the static
    cross K/V; states too."""
    jc, tc, jp, tp = setup_xattn(arch)
    rng = np.random.default_rng(7)
    b, s = 2, 10
    toks = rng.integers(0, jc.vocab_size, (b, s)).astype(np.int32)
    plens = np.full((b,), s, np.int32)
    f = feats_for(jc, b, 8)
    _, js = JM.prefill(jp, jc, jnp.asarray(toks), jnp.asarray(plens), s + 4,
                       enc_feats=jnp.asarray(f), q_chunk=8, kv_chunk=8)
    _, ts = TM.prefill(tp, tc, torch.from_numpy(toks),
                       torch.from_numpy(plens), s + 4,
                       enc_feats=torch.from_numpy(f))
    h = (rng.standard_normal((b, 1, jc.d_model)) * 0.1).astype(np.float32)
    jl = js["lengths"]
    jctx = JM.Ctx(jc, "decode", jl[:, None], jl, None, 0)
    tl = ts["lengths"]
    tctx = TM.Ctx(tc, "decode", tl[:, None], tl)
    jstates = jper_layer_state(js, jc)
    kinds = []
    for li, ((kind, jpl), tpl, tst) in enumerate(zip(
            jper_layer_params(jp, jc), TM.per_layer(tp, tc),
            TM.per_layer(ts, tc))):
        kinds.append(kind)
        fused_st = {k: v.clone() for k, v in tst.items()}
        h_fused, _, _ = TM.apply_block(kind, tpl, torch.from_numpy(h),
                                       fused_st, tctx)
        h_dec, st_dec = TD.run_decomposed(kind, tpl, torch.from_numpy(h),
                                          tst, tctx)
        _close(h_dec, h_fused, TOL)
        for k in fused_st:
            _close(st_dec[k], fused_st[k], TOL)
        jh, jst = JD.run_decomposed(kind, jpl, jnp.asarray(h), jstates[li],
                                    jctx, kv_chunk=8)
        _close(h_dec, jh, TOL)
        for k in jst:
            _close(st_dec[k], jst[k], TOL)
    assert "xattn" in kinds or "dec_xattn" in kinds


def test_phases_per_layer_step_counts_two_per_dec_xattn_block():
    """Twin of ``tests/test_perfmodel.py::test_orchestration_overhead_
    term``'s phase count: every whisper decoder block is DEC_XATTN, two
    phases each; vision's XATTN layers take one."""
    for arch in ARCHS:
        tc, jc = get_arch(arch), jget_arch(arch)
        assert TP.phases_per_layer_step(tc) == JP.phases_per_layer_step(jc)
        assert TP.phases_per_layer_step(tc) == sum(
            TD.num_phases(k) for k in tc.pattern)
    whisper = get_arch("whisper-medium")
    assert TP.phases_per_layer_step(whisper) == 2 * whisper.num_layers
    vision = get_arch("llama-3.2-vision-90b")
    assert TP.phases_per_layer_step(vision) == vision.num_layers
