"""The order of operations of the tokens-as-M tensor-core decode engine for
bf16 K/V (``csrc/tc_decode.cuh`` ``Bf16MmaEngine``: kernel 2 over a dense
slab, kernel 1 over a page pool) against the JAX package on the same
numpy-made inputs.

``ref.bf16_mma_slab_ref`` and ``ref.bf16_mma_paged_ref`` walk each split
in 64-row tiles (from the split's first slot; a paged split's sink part
and window part each from its own start), each warp's 16 rows with their
own online softmax: unscaled bf16 q times bf16 K in fp32, then the scale,
the softcap and the mask, p split into bf16 hi + lo for PV, the 4 warps'
merge, then the split merge.  They are held against
``repro.kernels.decode_attention.decode_attention`` (the Pallas kernel in
interpret mode) and ``repro.kernels.ops.paged_decode_attention`` (its
Pallas kernel in interpret mode): G 1, 4, 5, 7 and 8 at Dh 64 and 128;
softcap 30 with q scaled so that the cap bites; window 48 with sink 4 on a
ring-ordered row; -1 holes, unmapped table entries and a shared page;
split plans of several splits (and one split); a row with no valid key,
which must be exactly 0.  fp32 values that are exactly bf16 on both sides
(the kernel reads bf16 q, K and V).  Tolerance 1e-5 absolute, the port's
fp32 tolerance against the JAX package: hi + lo keeps p to 2^-17 of
itself (at most ~1e-6 on these outputs if every error had one sign) and
the rest is fp32 summation order.  The kernels themselves run only on the
card (``chip_smoke.py`` holds them to these models)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as JDA
from repro.kernels import ops as JOPS
from repro_torch.kernels import ref as TREF

TOL = 1e-5
S = 300                     # slab slots: no multiple of the 64-row tile
HKV = 2
GD = [(g, dh) for g in (1, 4, 5, 7, 8) for dh in (64, 128)]
OPTS = {"plain": {}, "softcap": dict(softcap=30.0),
        "window-sink": dict(window=48, sink=4)}
Q_SCALE = {"softcap": 8.0}  # scores reach |s| ~ 30-90: tanh(s / 30) bites


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_values(x):
    """fp32 numpy values that are exactly bf16."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _slab_case(g, dh, opt):
    """Rows: a prefix with -1 holes, a ring-ordered row wrapped past its
    size, a short prefix, and a row with no valid slot."""
    rng = np.random.default_rng(29 * g + dh)
    pos = np.full((4, S), -1, np.int32)
    pos[0, :257] = np.arange(257)
    pos[0, [3, 100, 200]] = -1
    ring = np.arange(400, 700)
    pos[1, ring % S] = ring
    pos[2, :5] = np.arange(5)
    lengths = np.array([256, 699, 4, 9], np.int32)
    q = _bf16_values(rng.standard_normal((4, HKV * g, dh)).astype(np.float32)
                     * Q_SCALE.get(opt, 1.0))
    k = _bf16_values(rng.standard_normal((4, S, HKV, dh)).astype(np.float32))
    v = _bf16_values(rng.standard_normal((4, S, HKV, dh)).astype(np.float32))
    return q, k, v, pos, lengths


def _paged_case(g, dh, opt, page=16):
    """Rows spanning several tiles, a row of length 0 whose table is all
    unmapped (exactly 0), a -1 hole, and a page shared by two rows."""
    rng = np.random.default_rng(290 + 29 * g + dh)
    lengths = np.array([150, 5, 0, 99, 63], np.int32)
    need = [-(-(int(n) + 1) // page) for n in lengths]
    mp = max(need) + 1
    n_pages = sum(need) + 1
    perm = rng.permutation(n_pages).astype(np.int32)
    tables = np.full((5, mp), -1, np.int32)
    cur = 0
    for r in (0, 1, 3, 4):
        tables[r, :need[r]] = perm[cur:cur + need[r]]
        cur += need[r]
    tables[3, 2] = -1                  # a hole
    tables[4, 1] = tables[0, 0]        # a shared page
    q = _bf16_values(rng.standard_normal((5, HKV * g, dh)).astype(np.float32)
                     * Q_SCALE.get(opt, 1.0))
    pk = _bf16_values(rng.standard_normal(
        (n_pages, page, HKV, dh)).astype(np.float32))
    pv = _bf16_values(rng.standard_normal(
        (n_pages, page, HKV, dh)).astype(np.float32))
    return q, pk, pv, tables, lengths


_JAX = {}


def _jax_out(kind, g, dh, opt):
    """The JAX package's Pallas kernel (interpret mode) on the case,
    cached per (kind, g, dh, opt)."""
    key = (kind, g, dh, opt)
    if key not in _JAX:
        if kind == "slab":
            args = _slab_case(g, dh, opt)
            out = JDA.decode_attention(*(jnp.asarray(a) for a in args),
                                       block_s=64, **OPTS[opt])
        else:
            args = _paged_case(g, dh, opt)
            out = JOPS.paged_decode_attention(
                *(jnp.asarray(a) for a in args), use_kernel="pallas",
                **OPTS[opt])
        _JAX[key] = (args, np.asarray(out))
    return _JAX[key]


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


# slots per split: one tile a split, splits of a tile and a ragged one
# (64 + 36 rows), one split over the whole slab
@pytest.mark.parametrize("sps", [64, 100, S])
@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("g,dh", GD)
def test_slab_engine_model_matches_the_pallas_kernel(g, dh, opt, sps):
    (q, k, v, pos, lengths), want = _jax_out("slab", g, dh, opt)
    got = TREF.bf16_mma_slab_ref(
        _bf16(q), _bf16(k), _bf16(v), torch.from_numpy(pos),
        torch.from_numpy(lengths), slots_per_split=sps,
        **OPTS[opt]).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert np.all(got[3] == 0)             # no valid slot: exactly 0
    assert np.abs(want[:3]).max() > 0.05   # the rows attend to something


# pages per split (page 16): a quarter tile, one tile, a tile and a
# quarter, one split over the whole table
@pytest.mark.parametrize("pps", [1, 4, 5, None])
@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("g,dh", GD)
def test_paged_engine_model_matches_the_pallas_kernel(g, dh, opt, pps):
    (q, pk, pv, tables, lengths), want = _jax_out("paged", g, dh, opt)
    got = TREF.bf16_mma_paged_ref(
        _bf16(q), _bf16(pk), _bf16(pv), torch.from_numpy(tables),
        torch.from_numpy(lengths), pages_per_split=pps or tables.shape[1],
        **OPTS[opt]).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert np.all(got[2] == 0)             # all unmapped: exactly 0
    assert np.abs(want[[0, 1, 3, 4]]).max() > 0.05


def test_paged_model_reads_the_sink_and_window_runs_only():
    """Under window + sink a split reads its part inside the sink, then
    its part inside the window, each in tiles from its own start: a
    position between them may hold anything (here NaN) and changes
    nothing, and a query's positions past it are never read."""
    (q, pk, pv, tables, lengths), _ = _jax_out("paged", 4, 64, "window-sink")
    kw = dict(pages_per_split=tables.shape[1], **OPTS["window-sink"])
    args = (_bf16(q), _bf16(pk), _bf16(pv), torch.from_numpy(tables),
            torch.from_numpy(lengths))
    base = TREF.bf16_mma_paged_ref(*args, **kw)
    page = pk.shape[1]
    # row 0 (length 150, window 48, sink 4): position 50 is in neither run
    pid = int(tables[0, 50 // page])
    pk2, pv2 = pk.copy(), pv.copy()
    pk2[pid, 50 % page] = np.nan
    pv2[pid, 50 % page] = np.nan
    other = TREF.bf16_mma_paged_ref(
        _bf16(q), _bf16(pk2), _bf16(pv2), *args[3:], **kw)
    assert torch.equal(base[0], other[0])




_HOST_SCRIPT = """
import sys
import numpy as np
import torch
from repro_torch.kernels import ref
a = np.load(sys.argv[1])
t = {n: torch.from_numpy(a[n]) for n in a.files}
b = {n: t[n].to(torch.bfloat16) for n in ("q", "k", "v", "pq", "pk", "pv")}
outs = [ref.bf16_mma_slab_ref(b["q"], b["k"], b["v"], t["pos"], t["lengths"],
                              slots_per_split=100, softcap=cap)
        for cap in (0.0, 30.0)]
outs += [ref.bf16_mma_paged_ref(b["pq"], b["pk"], b["pv"], t["tables"],
                                t["plen"], pages_per_split=4, softcap=cap)
         for cap in (0.0, 30.0)]
np.savez(sys.argv[2], *(o.numpy() for o in outs))
"""


# another BLAS code path; ATen's scalar path
@pytest.mark.parametrize("env", [{"MKL_ENABLE_INSTRUCTIONS": "SSE4_2"},
                                 {"ATEN_CPU_CAPABILITY": "default"}])
def test_engine_models_are_the_same_on_every_host(env, tmp_path):
    """The models take their sums and exponentials in fp64 and round them
    to fp32, so a host whose BLAS or vector unit sums in another order
    computes the same bits (``chip_smoke.py`` runs them on the card's
    host, which varies between runs; summed in fp32, the models' last bits
    followed MKL's code path).  Both runs are processes of their own, with
    their own settings."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    q, k, v, pos, lengths = _slab_case(4, 128, "softcap")
    pq, pk, pv, tables, plen = _paged_case(4, 128, "softcap")
    case = tmp_path / "case.npz"
    np.savez(case, q=q, k=k, v=v, pos=pos, lengths=lengths, pq=pq, pk=pk,
             pv=pv, tables=tables, plen=plen)
    root = Path(__file__).resolve().parents[1]
    outs = []
    for name, extra in (("here", {}), ("there", env)):
        subprocess.run(
            [sys.executable, "-c", _HOST_SCRIPT, str(case),
             str(tmp_path / f"{name}.npz")], check=True, timeout=300,
            env={**os.environ, "PYTHONPATH": str(root / "src"), **extra})
        with np.load(tmp_path / f"{name}.npz") as f:
            outs.append([f[n] for n in sorted(f.files)])
    assert all(np.array_equal(a, b) for a, b in zip(*outs))
