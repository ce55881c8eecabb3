"""Chunked prefill in the port against the JAX package on the same
weights and numpy-made inputs (the port's twins of
test_equiv_matrix.py::test_serving_matrix_matches_colocated's chunk rows,
test_spec_decode_composes_with_chunked_prefill and
test_prefill_chunked.py's pure-attention cases):

* the chunk R-Parts: ``paged_cache.r_attention_paged_chunk`` on fp and
  int8 pools and ``kv_cache.r_attention_int8_chunk`` (in
  test_torch_int8.py): outputs within 1e-5 on the valid positions,
  storage exactly equal (int8 values and scales included);
* the prefill work's logits head (each row's last valid position) and
  the verify work's (every position) against repro's jitted
  ``_chunk_step_fn`` "final", fp32 within 1e-5; ``begin_prefill_rows``
  exactly;
* whole serves: the port's greedy tokens equal JAX ``serve_trace``'s with
  ``prefill_chunk=5`` on dense, paged, int8 and paged-int8 storage (OoO)
  and paged on FIFO, and with speculative decoding (k = 2) composed with
  chunked prefill on paged and paged-int8 storage, prefill chunks and
  verify works sharing chunk-only steps; tokens exact;
* the repairs chunked prefill needed: the completion sink's buffers
  follow a virtual micro-batch's payload layout; a prefill chunk and a
  verify work of one micro-batch share a step (each with its own static
  inputs, also at equal widths); a plain chunk routes to the chunk
  R-Part, not the verify one.
Reduced granite-3-8b (tied embeddings), fp32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import STORAGE_KW, random_spec, serve_trace, tiny_cfg
from repro.core.hetero import HeteroPipelineEngine as JHeteroEngine
from repro.models import model as JM
from repro.serving import paged_cache as JPC
from repro.serving.engine import SpecConfig as JSpecConfig
from repro_torch import bridge
from repro_torch.core.config import ModelConfig
from repro_torch.core.hetero import CompletionSink, HeteroPipelineEngine
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import quant_kv as TQK
from repro_torch.models import model as TM
from repro_torch.serving import paged_cache as TPC
from repro_torch.serving.engine import ServingEngine, SpecConfig
from repro_torch.serving.request import Request, Status

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def setup():
    jc = tiny_cfg("granite-3-8b")
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    spec = random_spec(np.random.default_rng(42), jc, 6)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, spec=spec, traces={})


def _jax_trace(s, name, **kw):
    """JAX ``serve_trace`` of the module's trace, once per option set."""
    if name not in s["traces"]:
        s["traces"][name] = serve_trace(s["jp"], s["jc"], s["spec"], **kw)
    return s["traces"][name]


def _port_serve(s, **kw):
    """Serve the trace through the port; returns ({rid: tokens}, steps in
    which a prefill chunk ran while a RUNNING row decoded or verified,
    steps whose chunk-only step carried a prefill chunk and a verify work
    of one micro-batch)."""
    eng = ServingEngine(s["tp"], s["tc"], batch=4, cache_len=48,
                        backend="hetero", num_r_workers=2, device="cpu", **kw)
    overlap = shared = 0
    try:
        qi, spec = 0, s["spec"]
        order = sorted(range(len(spec)), key=lambda i: spec[i][2])
        while (qi < len(order) or eng.queue
               or any(r is not None for r in eng.slots)) \
                and eng.step_idx < 400:
            while qi < len(order) and spec[order[qi]][2] <= eng.step_idx:
                i = order[qi]
                eng.submit(Request(rid=i, prompt=spec[i][0],
                                   max_new_tokens=spec[i][1]))
                qi += 1
            decoding = any(r is not None and r.status is Status.RUNNING
                           for r in eng.slots)
            eng.step()
            works = eng.engine.prefill_results
            fills = [wk for wk in works if not wk.verify]
            overlap += bool(fills) and decoding
            shared += bool({wk.mb for wk in fills}
                           & {wk.mb for wk in works if wk.verify})
        return {r.rid: list(r.generated) for r in eng.finished}, overlap, \
            shared
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# whole serves against the JAX engine
# ---------------------------------------------------------------------------
SERVES = {"dense": ("dense", "ooo"), "paged": ("paged", "ooo"),
          "int8": ("int8", "ooo"), "paged-int8": ("paged-int8", "ooo"),
          "paged-fifo": ("paged", "fifo")}


@pytest.mark.parametrize("name", sorted(SERVES))
def test_port_chunked_serve_matches_jax(setup, name):
    storage, schedule = SERVES[name]
    kw = dict(prefill_chunk=5, **STORAGE_KW[storage])
    # the JAX engine's FIFO and OoO traces are equal (its own tests pin
    # it): FIFO is held to the OoO trace of the same storage
    want = _jax_trace(setup, storage, backend="hetero", num_r_workers=2,
                      **kw)
    kw["schedule"] = schedule
    got, overlap, _ = _port_serve(setup, **kw)
    assert got == want and len(got) == len(setup["spec"])
    # prompts streamed in while other rows decoded
    assert overlap > 0


@pytest.mark.parametrize("storage,chunk", [("paged", 5), ("paged", 3),
                                           ("paged-int8", 5)])
def test_spec_composes_with_chunked_prefill(setup, storage, chunk):
    """Verify works (k = 2, C = 3) and prefill chunks share chunk-only
    steps, one of each for a micro-batch, disjoint rows; at
    ``prefill_chunk=3`` both have the same width, so only the work's kind
    keeps their static inputs apart."""
    kw = dict(prefill_chunk=chunk, **STORAGE_KW[storage])
    want = _jax_trace(setup, f"spec-{storage}-{chunk}", backend="hetero",
                      num_r_workers=2, spec_decode=JSpecConfig(k=2), **kw)
    got, _, shared = _port_serve(setup, spec_decode=SpecConfig(k=2), **kw)
    assert got == want and len(got) == len(setup["spec"])
    assert shared > 0


def test_prefill_states_walls_and_refusals(setup):
    """A 12-token prompt at prefill_chunk=5 is PREFILLING for two steps
    (5, then 10 tokens in) and RUNNING after the third, its token 0 from
    the last chunk's logits; the other row decodes meanwhile; the chunk
    steps bill chunk time to the prefill wall; an over-length request and
    a non-hetero or non-positive prefill_chunk are refused as in the
    reference."""
    s = setup
    tp, tc = s["tp"], s["tc"]
    with pytest.raises(ValueError, match="backend='hetero'"):
        ServingEngine(tp, tc, batch=2, cache_len=8, device="cpu",
                      prefill_chunk=4)
    with pytest.raises(ValueError, match=">= 1"):
        ServingEngine(tp, tc, batch=2, cache_len=8, device="cpu",
                      backend="hetero", prefill_chunk=-1)
    eng = ServingEngine(tp, tc, batch=2, cache_len=32, device="cpu",
                        backend="hetero", num_r_workers=1, prefill_chunk=5)
    try:
        rng = np.random.default_rng(3)
        with pytest.raises(ValueError, match="prefill_chunk > 0"):
            eng.submit(Request(rid=9, prompt=np.ones(30, np.int32),
                               max_new_tokens=3))
        eng.submit(Request(rid=0, prompt=rng.integers(
            1, tc.vocab_size, 3).astype(np.int32), max_new_tokens=8))
        eng.step()
        first = eng.slots[0]
        assert first.status is Status.RUNNING and len(first.generated) == 1
        eng.submit(Request(rid=1, prompt=rng.integers(
            1, tc.vocab_size, 12).astype(np.int32), max_new_tokens=4))
        seen = []
        for _ in range(3):
            rec = eng.step()
            late = eng.slots[1]
            seen.append((late.status, late.prefill_pos, len(late.generated)))
            assert rec.prefill_wall > 0.0 and rec.decode_wall >= 0.0
            assert eng.engine.last_step_stats["prefill_s"] > 0.0
        assert seen == [(Status.PREFILLING, 5, 0), (Status.PREFILLING, 10, 0),
                        (Status.RUNNING, 12, 1)]
        assert eng.prefill_queue == []
        assert len(first.generated) == 4          # decoded all along
        eng.run(max_steps=40)
        assert sorted(len(r.generated) for r in eng.finished) == [4, 8]
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# the chunk R-Part on page pools
# ---------------------------------------------------------------------------
def _paged_chunk_case(rng, page, quantized):
    """Rows appending mid-page (an old occupant's entries past the base
    are overwritten), from offset 0 (re-admitted fresh), and not at all;
    tables cut to the power of two of the used pages."""
    b, c, hkv, dh, n_pages = 3, 5, 2, 16, 14
    base = np.array([page + 1, 0, 3], np.int32)
    counts = [5, 3, 0]
    alloc = TPC.PagedAllocator(b, n_pages, page, 6, device="cpu")
    jalloc = JPC.PagedAllocator(b, n_pages, page, 6)
    for r, n in ((0, page + 3), (1, 6), (2, 3)):
        alloc.admit(r, n)
        jalloc.admit(r, n)
    alloc.append_chunk(base, np.asarray(counts))
    jalloc.append_chunk(base, np.asarray(counts))
    np.testing.assert_array_equal(alloc.tables, jalloc.tables)
    used = int((alloc.tables >= 0).sum(axis=1).max())
    tables = alloc.tables[:, :1 << (used - 1).bit_length()].copy()
    pool = TPC.init_page_pool(n_pages, page, hkv, dh, quantized=quantized,
                              device="cpu")
    for name in ("k", "v"):
        x = _t(rng.standard_normal((n_pages, page, hkv, dh)).astype(
            np.float32))
        if quantized:
            pool[f"{name}_q"][:n_pages], pool[f"{name}_s"][:n_pages] = \
                TQK.quantize_kv(x)
        else:
            pool[name][:n_pages] = x
    valid = np.zeros((b, c), bool)
    for r, n in enumerate(counts):
        valid[r, :n] = True
    r_in = {"q": rng.standard_normal((b, c, 4, dh)).astype(np.float32),
            "k": rng.standard_normal((b, c, hkv, dh)).astype(np.float32),
            "v": rng.standard_normal((b, c, hkv, dh)).astype(np.float32),
            "lengths": base, "valid": valid}
    return r_in, pool, tables, n_pages


@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("pool_kind", ["fp", "int8"])
def test_r_attention_paged_chunk_matches_jax(pool_kind, page):
    quantized = pool_kind == "int8"
    r_in, pool, tables, n_pages = _paged_chunk_case(
        np.random.default_rng(page + quantized), page, quantized)
    jpool = {k: jnp.asarray(v[:n_pages].numpy()) for k, v in pool.items()}
    # eager, as the quantization tests run it: under jit XLA may turn the
    # scale's division into a multiplication (one ulp apart)
    jo, jpool = JPC.r_attention_paged_chunk(
        jax.tree.map(jnp.asarray, r_in), jpool, jnp.asarray(tables),
        window=0, softcap=0.0)
    TPA.verify_plain_calls.reset()
    TQK.verify_plain_calls.reset()
    to, tpool = TPC.r_attention_paged_chunk(
        {k: _t(v) for k, v in r_in.items()}, pool, _t(tables))
    assert tpool is pool                           # written in place
    # plain torch, as repro's: no verify op ran
    assert TPA.verify_plain_calls.value == TQK.verify_plain_calls.value == 0
    live = r_in["valid"]
    np.testing.assert_allclose(to["o"].numpy()[live],
                               np.asarray(jo["o"])[live], atol=TOL, rtol=0)
    for k in jpool:
        np.testing.assert_array_equal(tpool[k][:n_pages].numpy(),
                                      np.asarray(jpool[k]))


# ---------------------------------------------------------------------------
# the hetero engine's chunk pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("verify", [False, True], ids=["prefill", "verify"])
def test_chunk_logits_head_matches_repro_chunk_step_fn(setup, verify):
    """The last layer's transition of a chunk work: a prefill chunk's
    logits at each fed row's last valid position [mb_size, V], a verify
    work's at every position [mb_size, C, V], against repro's jitted
    ``_chunk_step_fn(L - 1, 0, C, verify)`` ("final") on the same inputs."""
    s = setup
    jc, tc = s["jc"], s["tc"]
    kw = dict(batch=6, cache_len=16, num_r_workers=1, num_microbatches=2)
    jeng = JHeteroEngine(s["jp"], jc, **kw)
    teng = HeteroPipelineEngine(s["tp"], tc, device="cpu", **kw)
    try:
        rng = np.random.default_rng(9)
        c, li = 4, jc.num_layers - 1
        toks = rng.integers(1, jc.vocab_size, (2, c)).astype(np.int32)
        wk = teng.queue_prefill_chunk(1, [0, 2], toks, [3, 0], [2, 4],
                                      verify=verify)
        teng._prefill_inbox.clear()
        teng._chunk_start(wk)                   # the work's static inputs
        h = rng.standard_normal((3, c, jc.d_model)).astype(np.float32)
        o = rng.standard_normal((3, c, jc.num_heads, jc.head_dim)).astype(
            np.float32)
        carry = {"h": _t(h)}
        teng._chunk_advance_graph(wk, li, 0, carry).feed({"o": _t(o)})
        none, got = teng._chunk_advance(wk, li, 0, carry)
        fn, mode = jeng._chunk_step_fn(li, 0, c, verify=verify)
        assert none is None and mode == "final"
        want = np.asarray(fn(s["jp"], jeng.layers[li][1], {"h": jnp.asarray(h)},
                             {"o": jnp.asarray(o)},
                             jnp.asarray(wk.base.numpy()),
                             jnp.asarray(wk.valid.numpy())))
        assert got.shape == ((3, c, jc.vocab_size) if verify
                             else (3, jc.vocab_size))
        fed = [0, 2]                            # row 1 was not fed
        np.testing.assert_allclose(got.numpy()[fed], want[fed], atol=TOL,
                                   rtol=0)
    finally:
        jeng.close()
        teng.close()


def test_begin_prefill_rows_matches_jax(setup):
    s = setup
    kw = dict(batch=4, cache_len=16, num_r_workers=1, num_microbatches=2)
    jeng = JHeteroEngine(s["jp"], s["jc"], **kw)
    teng = HeteroPipelineEngine(s["tp"], s["tc"], device="cpu", **kw)
    try:
        for mb, lens in enumerate(([5, 9], [7, 2])):
            jeng.mb_lengths[mb] = jnp.asarray(lens, jnp.int32)
            teng.mb_lengths[mb] = torch.tensor(lens, dtype=torch.int32)
        jeng.begin_prefill_rows([1, 2])
        teng.begin_prefill_rows([1, 2])
        for mb in range(2):
            np.testing.assert_array_equal(teng.mb_lengths[mb].numpy(),
                                          np.asarray(jeng.mb_lengths[mb]))
            np.testing.assert_array_equal(teng.mb_active[mb].numpy(),
                                          np.asarray(jeng.mb_active[mb]))
        assert [t.tolist() for t in teng.mb_lengths] == [[5, 0], [0, 2]]
    finally:
        jeng.close()
        teng.close()


# ---------------------------------------------------------------------------
# the repairs chunked prefill needed
# ---------------------------------------------------------------------------
def test_sink_buffer_follows_the_payload_layout():
    """Virtual micro-batch 2 carries a C = 5 prefill chunk and, two steps
    later (the same step parity, so the same host buffer), a C = 3 verify
    work: the buffer takes the new layout and gathers the new payload."""
    sink = CompletionSink(2, "cpu")
    tag = (0, 1, 2, 0, 0)               # epoch, parity, vmb, layer, phase
    for c in (5, 3):
        o = torch.randn(2, c, 4, 8)
        sink.post(0, tag, {"o": o[:1]}, 0, 1)
        sink.post(1, tag, {"o": o[1:]}, 1, 2)
        assert torch.equal(sink.gather(tag, {})["o"], o)
    sink.fence()


def test_plain_chunk_routes_to_the_chunk_r_part(setup):
    """A plain prompt chunk (no ``verify`` marker) on paged storage runs
    the chunk R-Part on every layer: no verify op runs, and a fresh row's
    chunk gives a whole-prompt prefill's logits; a marked one runs the
    verify op on every layer."""
    s = setup
    tp, tc = s["tp"], s["tc"]
    eng = ServingEngine(tp, tc, batch=2, cache_len=16, device="cpu",
                        backend="hetero", num_r_workers=1, paged_kv=True,
                        page_size=4)
    try:
        toks = [[5, 7, 2, 11]]
        want, _ = TM.prefill(tp, tc, torch.tensor([[5, 7, 2]],
                                                  dtype=torch.int32),
                             torch.tensor([3], dtype=torch.int32), 16)
        for verify in (False, True):
            TPA.verify_plain_calls.reset()
            wk = eng.engine.queue_prefill_chunk(0, [0], toks, [0], [3],
                                                verify=verify)
            eng.engine.decode_step(None)
            assert eng.engine.prefill_results == [wk]
            assert TPA.verify_plain_calls.value == \
                (tc.num_layers if verify else 0)
            # the last valid position's logits: the prefill work's only
            # row, the verify work's position 2
            got = wk.logits[0, 2] if verify else wk.logits[0]
            np.testing.assert_allclose(got.numpy(), want[0].numpy(),
                                       atol=TOL, rtol=0)
    finally:
        eng.close()
