"""The port's layer primitives against repro.models.layers on the same
numpy inputs (fp32; tolerance 1e-5 absolute — the same math in another
summation order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one intra-op thread, and the suite's
    other workers (timing-sensitive chaos tests among them) keep the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3
    scale = rng.standard_normal((16,)).astype(np.float32) * 0.1
    want = np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    got = TL.rms_norm(_t(x), _t(scale)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_rope_matches_jax_interleaved_pairs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 3, 8)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 6)).astype(np.int32)
    want = np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    got = TL.rope(_t(x), _t(pos), 1e4).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # a half-split rotate_half RoPE would NOT match: pairs interleave
    half = np.concatenate([x[..., 0::2], x[..., 1::2]], axis=-1)
    got_half = TL.rope(_t(half), _t(pos), 1e4).numpy()
    assert np.abs(got_half - want).max() > 1e-2


ATTN_CASES = {
    "causal": dict(),
    "window-sink": dict(window=4, sink=2),
    "softcap": dict(softcap=2.5),
    "noncausal": dict(causal=False),
    "holes": dict(holes=True),
    "chunked": dict(q_chunk=4, kv_chunk=5),
}


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
@pytest.mark.parametrize("g", [1, 2])
def test_flash_attention_matches_jax(name, g):
    kw = dict(ATTN_CASES[name])
    holes = kw.pop("holes", False)
    rng = np.random.default_rng(2)
    b, sq, sk, hkv, dh = 2, 11, 13, 2, 8
    q = rng.standard_normal((b, sq, hkv * g, dh)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, dh)).astype(np.float32)
    qpos = np.tile(np.arange(2, 2 + sq, dtype=np.int32), (b, 1))
    kpos = np.tile(np.arange(sk, dtype=np.int32), (b, 1))
    if holes:
        kpos[0, 3:7] = -1
        kpos[1] = -1            # a row with no valid key -> zeros
    want = np.asarray(JL.flash_attention(*map(jnp.asarray,
                                               (q, k, v, qpos, kpos)), **kw))
    got = TL.flash_attention(*map(_t, (q, k, v, qpos, kpos)), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    naive_kw = {k_: v_ for k_, v_ in kw.items()
                if k_ not in ("q_chunk", "kv_chunk")}
    np.testing.assert_allclose(
        TL.naive_attention(*map(_t, (q, k, v, qpos, kpos)),
                           **naive_kw).numpy(),
        np.asarray(JL.naive_attention(
            *map(jnp.asarray, (q, k, v, qpos, kpos)), **naive_kw)),
        atol=TOL, rtol=0)
    if holes:
        assert np.all(got[1] == 0)


def test_swiglu_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    p = {"w_gate": rng.standard_normal((16, 24)).astype(np.float32) * 0.2,
         "w_up": rng.standard_normal((16, 24)).astype(np.float32) * 0.2,
         "w_down": rng.standard_normal((24, 16)).astype(np.float32) * 0.2}
    want = np.asarray(JL.swiglu({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x)))
    got = TL.swiglu({k: _t(v) for k, v in p.items()}, _t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
