"""The port's sampler (repro_torch.serving.sampler) against the JAX
package's on the same numpy logits, and by distribution:

* ``target_probs`` (the distribution ``sample`` draws from) equals
  repro's within 1e-6, with the same support, on ties at the k-th logit
  (all kept), ties at the top-p edge (all kept), top-k >= V, top-k and
  top-p composed, and a random sweep;
* the port's draws follow ``target_probs`` (chi-squared), and the sampled
  branch of ``spec_accept`` commits tokens distributed as a vanilla draw
  (the twin of tests/test_sampler.py's chi-squared check);
* greedy is bit-exact (argmax; the greedy accept walk equals repro's) and
  draws nothing; one generator seed gives the same draws, another seed
  others;
* through the engine: per-request temperature / top-k / top-p are
  honoured, a greedy row beside a sampled one keeps repro's greedy
  tokens, and one seed gives one serve, on the colocated and the hetero
  engine, with and without speculative decoding.

``jax.random`` streams have no torch twin, so draws are compared by
distribution only (ROADMAP.md).  fp32 on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.models import model as JM
from repro.serving import sampler as JS
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.request import Request as JRequest
from repro_torch import bridge
from repro_torch.core.config import ModelConfig
from repro_torch.serving import sampler as TS
from repro_torch.serving.engine import ServingEngine, SpecConfig
from repro_torch.serving.request import Request

PROB_TOL = 1e-6
# chi-squared bound at p ~ 1e-4 for the degrees of freedom used below
# (df <= 7: 29.9); a wrong distribution lands far above it at these n
CHI2_MAX = 30.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _ties_kth():
    # the 2nd largest logit is tied three ways: top-k 2 keeps all three
    return np.asarray([[3.0, 2.0, 2.0, 0.0, 2.0, -1.0]], np.float32), \
        dict(temperature=1.0, top_k=2)


def _ties_top_p_edge():
    # the nucleus ends inside a run of equal logits: every tie stays
    return np.asarray([[2.0, 1.0, 1.0, 1.0, 0.0, -3.0],
                       [0.5, 0.5, 0.5, 0.5, 0.5, 0.5]], np.float32), \
        dict(temperature=1.0, top_p=0.5)


CASES = {
    "ties-at-kth": _ties_kth,
    "top-p-edge-ties": _ties_top_p_edge,
    "top-k-at-vocab": lambda: (np.random.default_rng(1).standard_normal(
        (3, 9)).astype(np.float32), dict(temperature=0.7, top_k=9)),
    "top-k-past-vocab": lambda: (np.random.default_rng(2).standard_normal(
        (3, 9)).astype(np.float32), dict(temperature=1.3, top_k=50)),
    "composed": lambda: (np.random.default_rng(3).standard_normal(
        (4, 40)).astype(np.float32), dict(temperature=0.8, top_k=12,
                                          top_p=0.9)),
    "temperature-only": lambda: (np.random.default_rng(4).standard_normal(
        (2, 17)).astype(np.float32), dict(temperature=2.0)),
    "greedy": lambda: (np.random.default_rng(5).standard_normal(
        (3, 11)).astype(np.float32), dict(temperature=0.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_target_probs_matches_jax(case):
    lg, kw = CASES[case]()
    want = np.asarray(JS.target_probs(jnp.asarray(lg), **kw))
    got = TS.target_probs(torch.from_numpy(lg), **kw).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=PROB_TOL, rtol=0)
    if case == "ties-at-kth":
        assert (got[0] > 0).sum() == 4          # 3.0 and the three 2.0s
    if case == "top-p-edge-ties":
        assert (got[0] > 0).sum() == 4 and (got[1] > 0).all()


def test_target_probs_random_sweep_matches_jax():
    """Random (k, p, temperature) at one shape (every new shape costs the
    JAX side a compile)."""
    r = np.random.default_rng(0)
    b, v = 3, 24
    for _ in range(16):
        k = int(r.integers(0, v + 4))
        p = float(r.choice([0.0, round(float(r.uniform(0.2, 0.9)), 3)]))
        temp = float(r.uniform(0.3, 2.5))
        lg = r.standard_normal((b, v)).astype(np.float32)
        want = np.asarray(JS.target_probs(jnp.asarray(lg), temp, k, p))
        got = TS.target_probs(torch.from_numpy(lg), temp, k, p).numpy()
        np.testing.assert_array_equal(got > 0, want > 0)
        np.testing.assert_allclose(got, want, atol=PROB_TOL, rtol=0)


def _chi2(counts, p, n):
    exp = p * n
    assert counts[exp == 0].sum() == 0          # off-support never drawn
    m = exp > 0
    return float(((counts[m] - exp[m]) ** 2 / exp[m]).sum())


@pytest.mark.parametrize("case", ["ties-at-kth", "top-p-edge-ties",
                                  "composed", "temperature-only"])
def test_sample_draws_follow_target_probs(case):
    """n draws of each row (one batched call over n copies) against
    target_probs: chi-squared over the support."""
    lg, kw = CASES[case]()
    lg = lg[:, :8] if lg.shape[1] > 8 else lg
    n = 4000
    g = _gen(11)
    for row in range(lg.shape[0]):
        x = torch.from_numpy(np.repeat(lg[row:row + 1], n, axis=0))
        toks = TS.sample(x, g, **kw).numpy()
        counts = np.bincount(toks, minlength=lg.shape[1]).astype(float)
        p = TS.target_probs(x[:1], **kw).numpy()[0]
        assert _chi2(counts, p, n) < CHI2_MAX, (case, row, counts, p * n)


def test_spec_accept_sampled_distribution_chi_squared():
    """The twin of tests/test_sampler.py's check: whatever the drafter
    proposed, the first committed token follows the vanilla distribution
    at that position, and filtered-out tokens are never committed; the
    accept rate of a draft token is its target probability."""
    lg = np.asarray([[0.5, -0.2, 1.1, 0.0, -1.0],
                     [0.1, 0.4, -0.3, 0.8, 0.2]], np.float32)
    kw = dict(temperature=1.3, top_k=4)           # drops token 4 of row 0
    p0 = TS.target_probs(torch.from_numpy(lg[:1]), **kw).numpy()[0]
    np.testing.assert_allclose(
        p0, np.asarray(JS.target_probs(jnp.asarray(lg[:1]), **kw))[0],
        atol=PROB_TOL)
    n = 3000
    g = _gen(7)
    for d in (2, 4):    # the likeliest token, and a filtered-out token
        counts = np.zeros(lg.shape[-1])
        acc = 0
        for _ in range(n):
            toks, a = TS.spec_accept(torch.from_numpy(lg), [d], g, **kw)
            assert len(toks) == a + 1 and a in (0, 1)
            counts[toks[0]] += 1
            acc += a
        assert _chi2(counts, p0, n) < CHI2_MAX, (d, counts, p0 * n)
        # accepted with probability p(d): a binomial within 5 sigma
        sd = np.sqrt(n * p0[d] * (1 - p0[d]))
        assert abs(acc - n * p0[d]) <= 5 * sd + 0.5


def test_spec_accept_bonus_follows_last_offset():
    """A fully accepted draft (every draft token has probability 1 under
    top_k=1 at its offset) commits a bonus drawn from the last offset."""
    lg = np.asarray([[5.0, 0.0, 0.0], [0.0, 4.0, 0.0],
                     [0.3, -0.1, 0.6]], np.float32)
    kw = dict(temperature=1.0, top_k=1)
    toks, acc = TS.spec_accept(torch.from_numpy(lg), [0, 1], _gen(0), **kw)
    assert (toks, acc) == ([0, 1, 2], 2)
    kw = dict(temperature=1.0)
    p = TS.target_probs(torch.from_numpy(lg[2:]), **kw).numpy()[0]
    counts = np.zeros(3)
    g, n = _gen(3), 3000
    hard = np.asarray([[40.0, 0.0, 0.0], [0.0, 40.0, 0.0]], np.float32)
    full = torch.from_numpy(np.concatenate([hard, lg[2:]]))
    for _ in range(n):
        toks, acc = TS.spec_accept(full, [0, 1], g, **kw)
        assert acc == 2
        counts[toks[2]] += 1
    assert _chi2(counts, p, n) < CHI2_MAX


def test_greedy_is_bit_exact_and_draws_nothing():
    r = np.random.default_rng(9)
    g = _gen(5)
    state = g.get_state().clone()
    for _ in range(10):
        lg = r.standard_normal((4, 23)).astype(np.float32)
        got = TS.sample(torch.from_numpy(lg), g).numpy()
        want = np.asarray(JS.sample(jnp.asarray(lg), jax.random.PRNGKey(0)))
        np.testing.assert_array_equal(got, want)
        k = int(r.integers(0, 4))
        am = lg[:k + 1].argmax(-1)
        draft = [int(am[i]) if i < k // 2 else int((am[i] + 1) % 23)
                 for i in range(k)]
        got = TS.spec_accept(torch.from_numpy(lg[:k + 1]), draft, g)
        want = JS.spec_accept(jnp.asarray(lg[:k + 1]), draft,
                              jax.random.PRNGKey(0))
        assert got == (list(map(int, want[0])), int(want[1]))
    assert torch.equal(g.get_state(), state)
    with pytest.raises(ValueError, match="Generator"):
        TS.sample(torch.from_numpy(lg), None, temperature=1.0)


def test_same_seed_same_draws_other_seed_other_draws():
    lg = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (8, 64)).astype(np.float32))
    a = TS.sample(lg, _gen(7), temperature=1.0)
    b = TS.sample(lg, _gen(7), temperature=1.0)
    c = TS.sample(lg, _gen(8), temperature=1.0)
    assert torch.equal(a, b) and not torch.equal(a, c)
    d1 = TS.spec_accept(lg[:4], [1, 2, 3], _gen(1), temperature=0.9,
                        top_p=0.8)
    d2 = TS.spec_accept(lg[:4], [1, 2, 3], _gen(1), temperature=0.9,
                        top_p=0.8)
    assert d1 == d2


# ---------------------------------------------------------------------------
# through the engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def served_ref():
    jc = tiny_cfg("granite-3-8b", layers=2, d_model=32, vocab=64)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    prompt = np.asarray([3, 14, 15, 9, 2], np.int32)
    eng = JServingEngine(jp, jc, batch=2, cache_len=64)
    eng.submit(JRequest(rid=0, prompt=prompt, max_new_tokens=12))
    ref = eng.run(max_steps=100)[0].generated
    return tc, tp, prompt, ref


ENGINES = {
    "colocated": dict(backend="colocated"),
    "hetero-paged": dict(backend="hetero", num_r_workers=1,
                         paged_kv=True, page_size=4),
    "hetero-paged-spec": dict(backend="hetero", num_r_workers=1,
                              paged_kv=True, page_size=4,
                              spec_decode=SpecConfig(k=2)),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_per_request_sampling_params_wired(served_ref, name):
    """Request.temperature/top_k/top_p flow through the engine: a sampled
    request is seed-deterministic (same engine seed -> same tokens,
    different seed -> different), while a greedy request served beside
    it keeps repro's greedy tokens; the sampled tokens stay inside the
    request's top-k support at every step (logged logits)."""
    tc, tp, prompt, ref = served_ref

    def serve(seed):
        eng = ServingEngine(tp, tc, batch=2, cache_len=64, seed=seed,
                            device="cpu", **ENGINES[name])
        try:
            eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=8,
                               temperature=1.2, top_k=8, top_p=0.9))
            eng.submit(Request(rid=1, prompt=prompt, max_new_tokens=8))
            done = eng.run(max_steps=100)
        finally:
            eng.close()
        return {r.rid: list(r.generated) for r in done}

    a, b, c = serve(0), serve(0), serve(1)
    assert a == b                                  # seed-deterministic
    assert a[1] == ref[:8] == c[1]                 # greedy row untouched
    assert a[0] != c[0] or a[0] != a[1]            # sampling had effect


def test_sampled_hetero_equals_sampled_colocated(served_ref):
    """One seed: the hetero engine (paged) draws the colocated engine's
    tokens for the same sampled requests (the same rows draw in the same
    order from equal logits)."""
    tc, tp, prompt, _ = served_ref
    out = []
    for kw in (ENGINES["colocated"], ENGINES["hetero-paged"]):
        eng = ServingEngine(tp, tc, batch=2, cache_len=64, seed=3,
                            device="cpu", **kw)
        try:
            for rid in range(3):
                eng.submit(Request(rid=rid, prompt=prompt + rid,
                                   max_new_tokens=6, temperature=0.8,
                                   top_k=10, top_p=0.95))
            out.append({r.rid: list(r.generated)
                        for r in eng.run(max_steps=100)})
        finally:
            eng.close()
    assert out[0] == out[1]


def test_discarded_rows_draw_nothing(served_ref):
    """``_sample_tokens`` redraws only rows whose request samples: None
    rows (padding, prefilling, released) and greedy rows leave the
    generator untouched."""
    tc, tp, _, _ = served_ref
    eng = ServingEngine(tp, tc, batch=2, cache_len=64, device="cpu")
    lg = torch.randn(3, tc.vocab_size, generator=_gen(0))
    state = eng.generator.get_state().clone()
    greedy = Request(rid=0, prompt=np.ones(3, np.int32), max_new_tokens=2)
    toks = eng._sample_tokens(lg, [None, greedy, None])
    np.testing.assert_array_equal(toks, lg.argmax(-1).numpy())
    assert torch.equal(eng.generator.get_state(), state)
    hot = Request(rid=1, prompt=np.ones(3, np.int32), max_new_tokens=2,
                  temperature=1.0, top_k=1)
    toks = eng._sample_tokens(lg, [hot, None, None])
    assert toks[0] == int(lg[0].argmax())          # top_k=1: the argmax
    assert not torch.equal(eng.generator.get_state(), state)
