"""The port's single-sequence ``PagedKV`` API against the JAX package's.

A twin of every test in tests/test_paged_cache.py: each op sequence runs
through ``repro.serving.paged_cache`` and ``repro_torch.serving.
paged_cache`` side by side, and after every op the two states agree
(tables, the free list in order, lengths and page_pos exactly; the page
pools exactly, since both hold the same fp32 values), ``r_attention_paged``
agrees within 2e-5, and the op left its argument's tensors untouched
(the functional contract of ``.at[].set``).  Inputs are fp32 from numpy
seeds.  Also ``ModelConfig.kv_bytes_per_token_per_layer`` over all 13
configs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.core import config as JC
from repro.serving import paged_cache as JPC
from repro_torch.core import config as TC
from repro_torch.core import decompose as TD
from repro_torch.serving import paged_cache as TPC

B, HKV, HQ, DH, PAGE = 3, 2, 4, 16, 4
TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Twin:
    """The same PagedKV op sequence on both packages, checked after each
    op."""

    def __init__(self, num_pages=24, max_pages=6):
        self.j = JPC.init_paged(B, num_pages, PAGE, HKV, DH, max_pages)
        self.t = TPC.init_paged(B, num_pages, PAGE, HKV, DH, max_pages,
                                device="cpu")
        self.check()

    def check(self):
        j, t = self.j, self.t
        assert t.free == j.free
        for name in ("tables", "lengths", "page_pos"):
            a, b = getattr(t, name), getattr(j, name)
            assert a.dtype == torch.int32, name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
        for name in ("pages_k", "pages_v"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)),
                                          err_msg=name)
        assert t.page_size == j.page_size and t.max_pages == j.max_pages

    def op(self, name, *args, **kw):
        """Apply ``name`` to both; the port's old value must be unchanged
        and a new object returned.  Tensor args are numpy arrays here."""
        before = {k: (v.clone() if torch.is_tensor(v) else list(v))
                  for k, v in vars(self.t).items()}
        old = self.t
        jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
                 for a in args]
        targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                 for a in args]
        j_out = getattr(JPC, name)(self.j, *jargs, **kw)
        t_out = getattr(TPC, name)(self.t, *targs, **kw)
        for k, v in before.items():
            now = getattr(old, k)
            if torch.is_tensor(v):
                assert torch.equal(now, v), f"{name} changed {k} in place"
            else:
                assert now == v, f"{name} changed {k} in place"
        self.j, self.t = j_out, t_out
        assert self.t is not old
        self.check()

    def attend(self, r_in, **kw):
        old = self.t
        before = {k: v.clone() for k, v in vars(old).items()
                  if torch.is_tensor(v)}
        jo, self.j = JPC.r_attention_paged(
            {k: jnp.asarray(v) for k, v in r_in.items()}, self.j, **kw)
        to, self.t = TPC.r_attention_paged(
            {k: torch.from_numpy(v) for k, v in r_in.items()}, self.t, **kw)
        for k, v in before.items():
            assert torch.equal(getattr(old, k), v), f"attend changed {k}"
        self.check()
        np.testing.assert_allclose(to["o"].numpy(), np.asarray(jo["o"]),
                                   atol=TOL)
        return to["o"]


def _mk(rng, *s):
    return rng.standard_normal(s).astype(np.float32)


def _r_in(rng, lengths):
    return {"q": _mk(rng, B, 1, HQ, DH), "k": _mk(rng, B, 1, HKV, DH),
            "v": _mk(rng, B, 1, HKV, DH),
            "lengths": np.asarray(lengths, np.int32)}


@pytest.mark.parametrize("attn_kw", [{}, dict(window=6), dict(softcap=3.0)],
                         ids=["plain", "window", "softcap"])
def test_prefill_then_decode_matches_linear(attn_kw):
    rng = np.random.default_rng(0)
    tw = Twin()
    S = 10
    ks, vs = _mk(rng, B, S, HKV, DH), _mk(rng, B, S, HKV, DH)
    for row in range(B):
        tw.op("ensure_capacity", row, S)
        tw.op("write_prefill", row, ks[row], vs[row])
    lin = {"k": torch.zeros((B, 32, HKV, DH)),
           "v": torch.zeros((B, 32, HKV, DH)),
           "pos": torch.full((B, 32), -1, dtype=torch.int32)}
    lin["k"][:, :S] = torch.from_numpy(ks)
    lin["v"][:, :S] = torch.from_numpy(vs)
    lin["pos"][:, :S] = torch.arange(S, dtype=torch.int32)
    lengths = np.full((B,), S, np.int32)
    for step in range(5):
        r_in = _r_in(rng, lengths)
        for row in range(B):
            tw.op("ensure_capacity", row, S + step + 1)
        o = tw.attend(r_in, **attn_kw)
        out_l, lin = TD.r_attention(
            {k: torch.from_numpy(v) for k, v in r_in.items()}, lin,
            window=attn_kw.get("window", 0),
            softcap=attn_kw.get("softcap", 0.0))
        np.testing.assert_allclose(o.numpy(), out_l["o"].numpy(), atol=TOL)
        lengths = lengths + 1
    np.testing.assert_array_equal(tw.t.lengths.numpy(), lengths)


def test_release_returns_pages():
    tw = Twin(num_pages=8, max_pages=4)
    tw.op("ensure_capacity", 0, 3 * PAGE)
    assert len(tw.t.free) == 5
    tw.op("release_row", 0)
    assert len(tw.t.free) == 8
    assert int(tw.t.tables[0].max()) == -1


def test_release_resets_stored_positions_and_length():
    """release_row sets the freed pages' page_pos to -1 and the row's
    length to 0; a page reused by another row keeps no stale position."""
    rng = np.random.default_rng(1)
    tw = Twin(num_pages=8, max_pages=4)
    tw.op("ensure_capacity", 0, 6)
    tw.op("write_prefill", 0, _mk(rng, 6, HKV, DH), _mk(rng, 6, HKV, DH))
    ids = [int(p) for p in tw.t.tables[0] if p >= 0]
    assert (tw.t.page_pos[ids] >= 0).any()
    tw.op("release_row", 0)
    assert (tw.t.page_pos[ids] == -1).all()
    assert int(tw.t.lengths[0]) == 0
    tw.op("ensure_capacity", 1, 3)            # reuses row 0's last page
    assert int(tw.t.tables[1, 0]) in ids
    tw.op("write_prefill", 1, _mk(rng, 3, HKV, DH), _mk(rng, 3, HKV, DH))


def test_pool_exhaustion_raises():
    tw = Twin(num_pages=2, max_pages=6)
    tw.op("ensure_capacity", 0, 2 * PAGE)
    with pytest.raises(MemoryError):
        TPC.ensure_capacity(tw.t, 1, PAGE)
    with pytest.raises(MemoryError):
        JPC.ensure_capacity(tw.j, 1, PAGE)
    tw.check()


def test_past_max_pages_raises_value_error():
    tw = Twin(num_pages=24, max_pages=2)
    with pytest.raises(ValueError):
        TPC.ensure_capacity(tw.t, 0, 2 * PAGE + 1)
    with pytest.raises(ValueError):
        JPC.ensure_capacity(tw.j, 0, 2 * PAGE + 1)
    tw.check()


def test_no_cross_row_aliasing():
    """Two rows must never share a page."""
    tw = Twin()
    tw.op("ensure_capacity", 0, 2 * PAGE)
    tw.op("ensure_capacity", 1, 2 * PAGE)
    t = tw.t.tables.numpy()
    used0 = set(t[0][t[0] >= 0].tolist())
    used1 = set(t[1][t[1] >= 0].tolist())
    assert not (used0 & used1)


def test_attention_over_non_contiguous_stored_positions():
    """After a release and regrowth a row's pages come back in another
    order; the stored positions still say where each token sits, and the
    output equals the JAX package's."""
    rng = np.random.default_rng(2)
    tw = Twin(num_pages=10, max_pages=4)
    for row in range(B):
        tw.op("ensure_capacity", row, 5)
        tw.op("write_prefill", row, _mk(rng, 5, HKV, DH),
              _mk(rng, 5, HKV, DH))
    tw.op("release_row", 1)
    tw.op("ensure_capacity", 1, 7)
    tw.op("write_prefill", 1, _mk(rng, 7, HKV, DH), _mk(rng, 7, HKV, DH))
    lengths = tw.t.lengths.numpy().copy()
    for _ in range(3):
        for row in range(B):
            tw.op("ensure_capacity", row, int(lengths[row]) + 1)
        tw.attend(_r_in(rng, lengths))
        lengths = lengths + 1


def test_init_paged_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TPC.init_paged(B, 4, PAGE, HKV, DH, 2)


@settings(max_examples=15, deadline=None)
@given(st.lists(st.tuples(st.integers(0, B - 1), st.booleans()),
                min_size=1, max_size=25))
def test_allocator_fuzz(ops):
    """Random grow/release sequences on both packages: equal state after
    every op, free+used == total, no double-mapped page, utilization <=
    1."""
    tw = Twin(num_pages=16, max_pages=4)
    lens = [0] * B
    for row, grow in ops:
        if grow and lens[row] < 4 * PAGE:
            lens[row] += PAGE
            try:
                JPC.ensure_capacity(tw.j, row, lens[row])
            except MemoryError:
                with pytest.raises(MemoryError):
                    TPC.ensure_capacity(tw.t, row, lens[row])
                lens[row] -= PAGE
            else:
                tw.op("ensure_capacity", row, lens[row])
                tw.j = tw.j.__class__(**{
                    **tw.j.__dict__,
                    "lengths": tw.j.lengths.at[row].set(lens[row])})
                lengths = tw.t.lengths.clone()
                lengths[row] = lens[row]
                tw.t = dataclasses.replace(tw.t, lengths=lengths)
        elif not grow and lens[row]:
            tw.op("release_row", row)
            lens[row] = 0
        tw.check()
        t = tw.t.tables.numpy()
        mapped = t[t >= 0].tolist()
        assert len(mapped) == len(set(mapped))          # no aliasing
        assert len(mapped) + len(tw.t.free) == 16       # conservation
        assert TPC.pool_utilization(tw.t) == JPC.pool_utilization(tw.j)
    assert TPC.pool_utilization(tw.t) <= 1.0 + 1e-9


@pytest.mark.parametrize("arch", JC.list_archs())
@pytest.mark.parametrize("bytes_per_el", [1, 2, 4])
def test_kv_bytes_per_token_per_layer_matches_jax(arch, bytes_per_el):
    assert sorted(TC.list_archs()) == sorted(JC.list_archs())
    want = JC.get_arch(arch).kv_bytes_per_token_per_layer(bytes_per_el)
    assert TC.get_arch(arch).kv_bytes_per_token_per_layer(bytes_per_el) \
        == want
    if bytes_per_el == 2:
        assert TC.get_arch(arch).kv_bytes_per_token_per_layer() == want
