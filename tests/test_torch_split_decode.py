"""The split-K (flash-decoding) model of the paged kernels against the JAX
package and the port's unsplit plain versions, and the split plan's
properties.

``kernels/ref.paged_split_attention_ref`` computes, per split of
``pages_per_split`` table pages, the partial (m, l, acc) with the
kernel's masking, and merges the partials as the merge kernel of
``csrc/paged_attention.cu`` does.  It is held against
``repro.kernels.ref`` (decode and verify) and against
``paged_decode_attention_ref`` / ``paged_verify_attention_ref`` on the
same numpy inputs: split sizes 1, 2 and 4 pages and one split; T 1, 2
and 4; G 1 and 4; page 4 and 16; rows of length 0, unmapped entries and
shared pages; window + sink with empty middle splits; softcap; rows
whose every split is masked, which must be exactly 0.  fp32 on the CPU;
tolerance 1e-5 absolute (the same fp32 online softmax, summed in another
order).  ``split_plan`` depends on shapes alone; its properties are
checked exactly."""
import inspect

import jax
import numpy as np
import pytest
import torch

from repro.kernels import ref as JREF
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import ref as TREF

TOL = 1e-5
NEG_INF = -1e30
_JREF_VERIFY = jax.jit(JREF.paged_verify_attention_ref,
                       static_argnames=("window", "sink", "softcap"))
_JREF_DECODE = jax.jit(JREF.paged_decode_attention_ref,
                       static_argnames=("window", "sink", "softcap"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one intra-op thread, and the suite's
    other workers keep the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, *, t, g, page, dh=16, hkv=2):
    """Five rows whose pages hold the last candidate (position base + t -
    1): rows spanning several pages, a row of length 0 (only position 0),
    a -1 hole, a page shared by two rows, and an all-unmapped row (its
    output must be exactly 0); two spare table pages past every row, so
    the trailing splits are empty."""
    rng = np.random.default_rng(seed)
    base = np.array([page * 5 + 1, 2, page * 7 - t, 0, page * 3],
                    np.int32)
    need = [-(-(int(n) + t) // page) for n in base]
    mp = max(need) + 2
    n_pages = sum(need) + 1
    perm = rng.permutation(n_pages).astype(np.int32)
    tables = np.full((5, mp), -1, np.int32)
    cur = 0
    for r in range(4):                           # row 4: all unmapped
        tables[r, :need[r]] = perm[cur:cur + need[r]]
        cur += need[r]
    tables[2, 3] = -1                            # a hole
    tables[1, 0] = tables[0, 2]                  # a shared page
    q = rng.standard_normal((5, t, hkv * g, dh)).astype(np.float32)
    pk = rng.standard_normal((n_pages, page, hkv, dh)).astype(np.float32)
    pv = rng.standard_normal((n_pages, page, hkv, dh)).astype(np.float32)
    return q, pk, pv, tables, base


_JAX_CACHE = {}


def _jax_ref(key, q, pk, pv, tables, base, **kw):
    """repro.kernels.ref on the case (decode for T = 1), cached per
    ``key`` (the case's seed and options)."""
    if key not in _JAX_CACHE:
        if q.shape[1] == 1:
            out = _JREF_DECODE(q[:, 0], pk, pv, tables, base, **kw)[:, None]
        else:
            out = _JREF_VERIFY(q, pk, pv, tables, base, **kw)
        _JAX_CACHE[key] = np.asarray(out)
    return _JAX_CACHE[key]


def _split(args, pps, **kw):
    return TREF.paged_split_attention_ref(
        *map(torch.from_numpy, args), pages_per_split=pps, **kw).numpy()


@pytest.mark.parametrize("pps", [1, 2, 4, None])
@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("t", [1, 2, 4])
def test_split_model_matches_jax_and_unsplit(t, g, page, pps):
    seed = 100 * t + 10 * g + page
    args = _case(seed, t=t, g=g, page=page)
    mp = args[3].shape[1]
    got = _split(args, pps or mp)           # None: one split over the table
    want = _jax_ref(seed, *args)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    unsplit = TREF.paged_verify_attention_ref(
        *map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, unsplit, atol=TOL, rtol=0)
    assert np.all(got[4] == 0)              # all-unmapped row: exactly 0
    if t == 1:                              # the decode entry's shapes
        dec = TREF.paged_split_attention_ref(
            *map(torch.from_numpy, (args[0][:, 0],) + args[1:]),
            pages_per_split=pps or mp).numpy()
        np.testing.assert_array_equal(dec, got[:, 0])


@pytest.mark.parametrize("t", [1, 4])
def test_split_model_window_sink_empty_middle_splits(t):
    """A long row under window + sink: the splits between the sink and
    the window hold no visible position for any query (m = NEG_INF, l =
    0, acc = 0), and the merge still matches the JAX reference."""
    args = _case(7 + t, t=t, g=4, page=4)
    kw = dict(window=6, sink=3)
    m, l, acc = TREF.paged_split_partials_ref(
        *map(torch.from_numpy, args), pages_per_split=1, **kw)
    # row 0 reaches position 21 + t - 1: page 0 holds the sink, pages
    # 1..2 lie wholly between the sink and every query's window
    assert bool((m[1:3, 0] == NEG_INF).all())
    assert bool((l[1:3, 0] == 0).all()) and bool((acc[1:3, 0] == 0).all())
    assert bool((m[0, 0] > NEG_INF / 2).all())
    got = TREF.merge_split_partials_ref(m, l, acc).numpy()
    np.testing.assert_allclose(got, _jax_ref((7 + t, "ws"), *args, **kw),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(
        got, TREF.paged_verify_attention_ref(
            *map(torch.from_numpy, args), **kw).numpy(), atol=TOL, rtol=0)
    assert np.all(got[4] == 0)


@pytest.mark.parametrize("t", [1, 4])
def test_split_model_softcap(t):
    args = _case(11 + t, t=t, g=4, page=16)
    got = _split(args, 1, softcap=3.0)
    np.testing.assert_allclose(got, _jax_ref((11 + t, "sc"), *args,
                                             softcap=3.0),
                               atol=TOL, rtol=0)
    assert np.all(got[4] == 0)


def test_merge_gives_empty_partials_weight_zero():
    """A partial with m = NEG_INF weighs 0 whatever its l and acc hold
    (the first version's p = exp(0) = 1 before a row's first valid key
    left garbage there); a query whose every partial is empty gives
    exactly 0, never NaN."""
    args = _case(5, t=4, g=4, page=4)
    m, l, acc = TREF.paged_split_partials_ref(
        *map(torch.from_numpy, args), pages_per_split=2)
    clean = TREF.merge_split_partials_ref(m, l, acc)
    empty = m <= NEG_INF / 2
    assert bool(empty.any()) and bool(empty[:, 4].all())
    l2 = torch.where(empty, torch.full_like(l, 7.0), l)
    acc2 = torch.where(empty[..., None], torch.full_like(acc, float("nan")),
                       acc)
    dirty = TREF.merge_split_partials_ref(m, l2, acc2)
    assert torch.equal(dirty, clean)
    assert bool((dirty[4] == 0).all()) and bool(dirty.isfinite().all())


def test_split_model_single_position_rows():
    """Rows of length 0 (only position 0 visible to the decode query) and
    a verify whose first query sees one key, split one page per split."""
    args = _case(3, t=2, g=1, page=4)
    got = _split(args, 1)
    np.testing.assert_allclose(got, _jax_ref((3, "one"), *args), atol=TOL,
                               rtol=0)
    # row 3 (base 0): query 0 sees only position 0, so each head's output
    # is its kv-head's V row there
    _, _, pv, tables, _ = args
    np.testing.assert_allclose(got[3, 0], pv[tables[3, 0], 0], atol=TOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# the split plan
# ---------------------------------------------------------------------------
PLAN_GRID = [(b, hkv, groups, mp, page, sms)
             for b in (1, 2, 8, 64) for hkv in (1, 2, 8)
             for groups in (1, 2) for mp in (1, 3, 32, 64, 256, 5000)
             for page in (4, 16) for sms in (8, 132)]


@pytest.mark.parametrize("b,hkv,groups,mp,page,sms", PLAN_GRID[::7])
def test_split_plan_covers_every_page_once(b, hkv, groups, mp, page, sms):
    pps, n = TPA.split_plan(b, hkv, groups, mp, page, sms)
    assert 1 <= pps <= min(mp, TPA.MAX_SPLIT_PAGES)
    assert n * pps >= mp and (n - 1) * pps < mp     # no empty table split
    covered = np.zeros(mp, int)
    for s in range(n):
        covered[s * pps:(s + 1) * pps] += 1
    assert np.all(covered == 1)
    if b * hkv * groups >= sms and mp <= TPA.MAX_SPLIT_PAGES:
        assert n == 1                     # the grid already fills the SMs
    if n > 1 and mp <= TPA.MAX_SPLIT_PAGES:
        assert pps * page >= min(TPA.SPLIT_MIN_TOKENS, mp * page)


def test_split_plan_at_the_serve_and_bandwidth_shapes():
    """The serve's per-worker decode call (2 rows, 8 kv-heads, cache_len
    1024 at page 16 = 64 table pages) and its verify call (tables cut to
    the 32 used pages) split; 64 rows x 4096 tokens does not."""
    assert TPA.split_plan(2, 8, 1, 64, 16, 132) == (4, 16)
    assert TPA.split_plan(2, 8, 1, 32, 16, 132) == (4, 8)
    assert TPA.split_plan(64, 8, 1, 256, 16, 132) == (256, 1)


def test_split_plan_depends_on_shapes_only():
    """The plan takes no lengths (they live on the card), so it needs no
    host sync; the wrapper's plan reads only shapes and the SM count."""
    assert list(inspect.signature(TPA.split_plan).parameters) == [
        "b", "hkv", "groups", "mp", "page", "sm_count"]
    src = inspect.getsource(TPA.kernel_plan)
    assert "lengths" not in src and ".shape" in src
    assert TPA.split_plan(3, 2, 1, 40, 4, 132) == \
        TPA.split_plan(3, 2, 1, 40, 4, 132)


@pytest.mark.parametrize("t,g,want", [(1, 1, 1), (1, 4, 1), (1, 8, 1),
                                      (1, 16, 2), (2, 4, 1), (4, 4, 1),
                                      (4, 8, 2), (8, 8, 4)])
def test_row_groups_follow_the_kernel_caps(t, g, want):
    """At most 8 query rows per CTA for a decode, 16 for a verify (the
    tensor-core M), as csrc/paged_attention.cu launches them."""
    assert TPA.row_groups(t, g) == want
