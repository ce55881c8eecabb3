"""The weight/state bridge between the JAX package and the PyTorch port:
params and decode state round-trip bit-exactly, fp32 and bf16 (bf16
crosses as its uint16 bit pattern, viewed on the JAX side)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.core.config import ModelConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one intra-op thread, and the suite's
    other workers (timing-sensitive chaos tests among them) keep the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_np(tree):
    """JAX pytree -> numpy, bf16 leaves as uint16 bit views."""
    def leaf(x):
        a = np.asarray(x)
        return a.view(np.uint16) if x.dtype == jnp.bfloat16 else a
    return jax.tree.map(leaf, tree)


def _assert_bit_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_roundtrip_bit_exact(dtype):
    jc = dataclasses.replace(tiny_cfg("qwen3-8b"), dtype=dtype)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jax.random.PRNGKey(3), jc)
    np_params = _to_np(jp)
    tp = bridge.params_from_numpy(np_params, tc, "cpu")
    want = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert tp["stack"]["s0"]["wq"].dtype == want
    assert tp["final_norm"].dtype == torch.float32       # norms stay fp32
    assert tp["stack"]["s0"]["wq"].shape == \
        (jc.num_layers, jc.d_model, jc.num_heads * jc.head_dim)
    # values, not just bits: the port's bf16 equals JAX's bf16
    np.testing.assert_array_equal(
        tp["embed"].float().numpy(),
        np.asarray(jp["embed"].astype(jnp.float32)))
    _assert_bit_equal(np_params, bridge.params_to_numpy(tp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_state_roundtrip_bit_exact(dtype):
    jc = dataclasses.replace(tiny_cfg("llama-7b"), dtype=dtype)
    jp = JM.init_params(jax.random.PRNGKey(4), jc)
    toks = np.random.default_rng(0).integers(1, jc.vocab_size, (2, 7))
    _, st = JM.prefill(jp, jc, jnp.asarray(toks, jnp.int32),
                       jnp.asarray([7, 3], jnp.int32), 12)
    np_state = _to_np(st)
    ts = bridge.state_from_numpy(np_state, "cpu")
    assert ts["stack"]["s0"]["pos"].dtype == torch.int32
    assert ts["lengths"].tolist() == [7, 3]
    _assert_bit_equal(np_state, bridge.state_to_numpy(ts))


def test_params_from_numpy_casts_weights_not_norms():
    jc = tiny_cfg("qwen3-8b")
    tc = ModelConfig(**dataclasses.asdict(jc))
    tp = bridge.params_from_numpy(
        _to_np(JM.init_params(jax.random.PRNGKey(5), jc)), tc, "cpu",
        dtype=torch.bfloat16)
    assert tp["lm_head"].dtype == torch.bfloat16
    assert tp["stack"]["s0"]["q_norm"].dtype == torch.float32
    assert tp["stack"]["s0"]["ln1"].dtype == torch.float32


def test_int8_decode_state_roundtrip_bit_exact():
    """An int8 attention state (int8 values, fp32 scales, int32 positions)
    crosses with every leaf's dtype and bits unchanged."""
    from repro.serving.kv_cache import quantize_attn_state
    jc = tiny_cfg("llama-7b")
    jp = JM.init_params(jax.random.PRNGKey(6), jc)
    toks = np.random.default_rng(1).integers(1, jc.vocab_size, (2, 5))
    _, st = JM.prefill(jp, jc, jnp.asarray(toks, jnp.int32),
                       jnp.asarray([5, 2], jnp.int32), 8)
    layer = jax.tree.map(lambda x: x[0], st["stack"]["s0"])
    np_state = _to_np(quantize_attn_state(layer))
    ts = bridge.state_from_numpy(np_state, "cpu")
    assert ts["k_q"].dtype == torch.int8 and ts["k_s"].dtype == torch.float32
    assert ts["pos"].dtype == torch.int32
    _assert_bit_equal(np_state, bridge.state_to_numpy(ts))
