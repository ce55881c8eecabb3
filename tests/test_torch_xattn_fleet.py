"""Cross-attention rows through a live migration and a snapshot failover
on the port's static-batch engine, against the JAX package's engine run
through the same moves on the same weights (``repro_torch.bridge``) and
numpy inputs: llama-3.2-vision-90b (one period: 4 ATTN + 1 XATTN layer,
its ATTN layers paged under ``paged_kv``) and whisper-medium (DEC_XATTN
slabs, for which ``paged_kv`` is a no-op), tiny fp32 configs with seeded
non-zero gates (``test_torch_xattn.setup_xattn``).

Batch 8 in 2 micro-batches of 4 rows, 2 R-workers (2 + 2 rows), GEN
steps teacher-forced.  The static ``xk`` / ``xv`` slabs travel in the
dense wire format:

* ``move``: ``apply_partition([(0, 3), (3, 4)])`` before step MOVE_AT;
* ``restore``: a ``KVSnapshotStore`` snapshot before step RESTORE_AT,
  ``kill()`` of worker 0 and ``remove_worker(0, lost=payload())``: the
  survivor takes all 4 rows of each micro-batch;
* ``both``: the move, then the restore.

The port's logits equal its own unmoved run's within 1e-6, and
``repro``'s moved run's within 2e-4 (``test_torch_xattn_serve.py``'s
TOL); each payload that moves is ``repro``'s within that tolerance, and
its blake2b digest is ``repro``'s when the port's workers hold
``repro``'s state; every cross-attention R-Part before and after each
event went through kernel 2's wrapper (its plain version here:
``decode_attention.plain_calls``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.chaos.checksum import tree_digest as jtree_digest
from repro.core.hetero import HeteroPipelineEngine as JHetero
from repro.fleet.recovery import KVSnapshotStore as JSnapshots
from repro_torch import bridge
from repro_torch.chaos.checksum import tree_digest
from repro_torch.core.hetero import HeteroPipelineEngine
from repro_torch.fleet.recovery import KVSnapshotStore
from repro_torch.kernels import decode_attention as DA
from test_torch_xattn import feats_for, setup_xattn

B, S, GEN = 8, 12, 6
MOVE_AT, RESTORE_AT = 2, 4
SPLIT = [(0, 3), (3, 4)]
SELF_TOL = 1e-6     # against the port's own unmoved run
TOL = 2e-4          # against repro, as tests/test_torch_xattn_serve.py
ARCHS = ("whisper-medium", "llama-3.2-vision-90b")
STORAGE = {"dense": {}, "paged": dict(paged_kv=True, page_size=4)}
PLANS = ("move", "restore", "both")
_SETUPS, _UNMOVED = {}, {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch):
    if arch not in _SETUPS:
        jc, tc, jp, tp = setup_xattn(
            arch, layers=5 if arch == "llama-3.2-vision-90b" else 3)
        toks = np.random.default_rng(21).integers(
            0, jc.vocab_size, (B, S + GEN)).astype(np.int32)
        _SETUPS[arch] = (jc, tc, jp, tp, toks, feats_for(jc, B, 22))
    return _SETUPS[arch]


def _wire(eng):
    """{layer key: the full micro-batch's wire payload} over the engine's
    workers, as the snapshot store assembles it."""
    out = {}
    for lk in sorted({k for w in eng.workers for k in w.state}):
        parts = [w.export_rows(lk, np.arange(w.hi - w.lo))
                 for w in eng.workers if lk in w.state]
        out[lk] = {k: np.concatenate([np.asarray(p[k]) for p in parts])
                   for k in parts[0]}
    return out


def _record(eng, wire, jax_side):
    rec = {"wire": {lk: {k: np.asarray(v) for k, v in p.items()}
                    for lk, p in wire.items()},
           "bytes": sum(np.asarray(v).nbytes for p in wire.values()
                        for v in p.values())}
    if not jax_side:          # repro keeps no migration record
        rec["wire_bytes"] = eng.last_migration["wire_bytes"]
    return rec


def _run(arch, storage, plan=None, jax_side=False):
    """load_prefill per micro-batch, then GEN teacher-forced steps with
    ``plan``'s moves between them.  Returns (logits [GEN, B, V], {event:
    record}) where a record holds the moved payload and its bytes
    (and on the port the bytes ``apply_partition`` exported), and (port)
    each step's kernel 2 plain calls beside its worker count."""
    jc, tc, jp, tp, toks, feats = _setup(arch)
    T = jnp.asarray if jax_side else torch.from_numpy
    if jax_side:
        eng = JHetero(jp, jc, batch=B, cache_len=S + GEN, num_r_workers=2,
                      num_microbatches=2, kv_chunk=8, **STORAGE[storage])
    else:
        eng = HeteroPipelineEngine(tp, tc, batch=B, cache_len=S + GEN,
                                   num_r_workers=2, num_microbatches=2,
                                   kv_chunk=8, device="cpu",
                                   **STORAGE[storage])
    events, calls, recaptures = {}, [], []
    h = B // 2
    try:
        plens = np.full((B,), S, np.int32)
        for m in range(2):
            sl = slice(m * h, (m + 1) * h)
            eng.load_prefill(m, T(toks[sl, :S]), T(plens[sl]),
                             enc_feats=T(feats[sl]))
        out = []
        for t in range(GEN):
            if plan in ("move", "both") and t == MOVE_AT:
                wire = _wire(eng)
                moved = eng.apply_partition(SPLIT)
                assert moved == 2 * 1      # row 2 of each micro-batch
                assert [(w.lo, w.hi) for w in eng.workers] == SPLIT
                events["move"] = _record(eng, wire, jax_side)
                events["move"]["exported_rows"] = h
            if plan in ("restore", "both") and t == RESTORE_AT:
                store = (JSnapshots if jax_side else KVSnapshotStore)()
                store.snapshot(eng, t)
                survivor = eng.workers[1]
                kept = survivor.hi - survivor.lo
                eng.workers[0].kill()
                eng.workers[0].join(timeout=10)
                eng.remove_worker(0, lost=store.payload())
                assert eng.workers == [survivor]
                assert (survivor.lo, survivor.hi) == (0, B // 2)
                events["restore"] = _record(eng, store.payload(), jax_side)
                events["restore"]["exported_rows"] = kept
            DA.plain_calls.reset()
            tok = toks[:, S + t:S + t + 1]
            lg = np.concatenate([np.asarray(x) for x in eng.decode_step(
                [T(tok[:h]), T(tok[h:])])])
            out.append(lg.astype(np.float32))
            calls.append((DA.plain_calls.value, len(eng.workers)))
            if not jax_side:
                recaptures.append(eng.recapture_stats()["recapture_count"])
        if not jax_side:
            events["calls"] = calls
            events["recaptures"] = recaptures
        return np.stack(out), events
    finally:
        eng.close()


def _unmoved(arch, storage):
    if (arch, storage) not in _UNMOVED:
        _UNMOVED[(arch, storage)] = _run(arch, storage)[0]
    return _UNMOVED[(arch, storage)]


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_rows_survive_move_and_failover(arch, storage, plan):
    jc = _setup(arch)[0]
    got, ev = _run(arch, storage, plan)
    base = _unmoved(arch, storage)
    assert float(np.abs(got - base).max()) <= SELF_TOL
    want, jev = _run(arch, storage, plan, jax_side=True)
    assert float(np.abs(got - want).max()) < TOL
    n_cross = sum(k in ("xattn", "dec_xattn") for k in jc.pattern)
    h = B // 2
    for name in [e for e in ("move", "restore") if e in ev]:
        # the moved payloads (cross K/V included) are repro's: the same
        # keys, shapes and dtypes, positions exactly, values within TOL
        # (bit for bit on the same state: the test below)
        got_w, want_w = ev[name]["wire"], jev[name]["wire"]
        assert sorted(got_w) == sorted(want_w)
        for lk in want_w:
            assert sorted(got_w[lk]) == sorted(want_w[lk])
            for k, w in want_w[lk].items():
                g = got_w[lk][k]
                assert g.shape == w.shape and g.dtype == w.dtype, (lk, k)
                if w.dtype == np.float32:
                    np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
                else:
                    np.testing.assert_array_equal(g, w)
        assert ev[name]["bytes"] == jev[name]["bytes"] > 0
        # the move exports every row; the restore only the survivor's
        # (the dead worker's rows come from the snapshot)
        assert ev[name]["wire_bytes"] * h \
            == ev[name]["bytes"] * ev[name]["exported_rows"]
    # every cross-attention R-Part of every step, before and after each
    # event: one call per cross layer, micro-batch and worker
    assert [c for c, _ in ev["calls"]] \
        == [n_cross * 2 * nw for _, nw in ev["calls"]]
    assert [nw for _, nw in ev["calls"]] == [
        1 if plan != "move" and t >= RESTORE_AT else 2 for t in range(GEN)]
    # graphs captured again in the step after each event, and the engine's
    # total never goes back when a removed worker is reaped
    rc = [0.0] + ev["recaptures"]
    grew = [t for t in range(GEN) if rc[t + 1] > rc[t]]
    assert grew == [t for t in (MOVE_AT, RESTORE_AT)
                    if t in {"move": [MOVE_AT], "restore": [RESTORE_AT],
                             "both": [MOVE_AT, RESTORE_AT]}[plan]]
    assert rc == sorted(rc)


@pytest.mark.parametrize("arch", ARCHS)
def test_moved_payload_keeps_cross_slabs_whole(arch):
    """The payload of an XATTN / DEC_XATTN layer key carries its cross K/V
    as ``[rows, encoder_seq, Hkv, Dh]`` slabs, and after the move each
    worker holds exactly its new rows' slabs: the same bytes as before."""
    jc, tc, _, tp, toks, feats = _setup(arch)
    eng = HeteroPipelineEngine(tp, tc, batch=B, cache_len=S + GEN,
                               num_r_workers=2, num_microbatches=2,
                               kv_chunk=8, device="cpu")
    try:
        h = B // 2
        for m in range(2):
            sl = slice(m * h, (m + 1) * h)
            eng.load_prefill(m, torch.from_numpy(toks[sl, :S]),
                             torch.full((h,), S, dtype=torch.int32),
                             enc_feats=torch.from_numpy(feats[sl]))
        before = _wire(eng)
        eng.apply_partition(SPLIT)
        after = _wire(eng)
        cross = [lk for lk, p in before.items() if "xk" in p]
        assert len(cross) == 2 * sum(k in ("xattn", "dec_xattn")
                                     for k in jc.pattern)
        for lk in cross:
            assert before[lk]["xk"].shape[:2] == (h, jc.encoder_seq)
            for k in before[lk]:
                assert after[lk][k].tobytes() == before[lk][k].tobytes()
        for w, (lo, hi) in zip(eng.workers, SPLIT):
            for lk in cross:
                assert w.state[lk]["xk"].shape[0] == hi - lo
    finally:
        eng.close()


def _digests(eng, digest):
    return {lk: digest(p) for lk, p in _wire(eng).items()}


@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("arch", ARCHS)
def test_wire_digest_equals_repros_on_the_same_state(arch, storage):
    """The port's workers given ``repro``'s prefilled R-state (its wire
    payload, installed with ``load_state``) export it with ``repro``'s
    blake2b digest, and again after both engines make the same move and
    the same snapshot failover; a step after each gives ``repro``'s
    logits within TOL."""
    jc, tc, jp, tp, toks, feats = _setup(arch)
    jeng = JHetero(jp, jc, batch=B, cache_len=S + GEN, num_r_workers=2,
                   num_microbatches=2, kv_chunk=8, **STORAGE[storage])
    teng = HeteroPipelineEngine(tp, tc, batch=B, cache_len=S + GEN,
                                num_r_workers=2, num_microbatches=2,
                                kv_chunk=8, device="cpu", **STORAGE[storage])
    h = B // 2
    try:
        for m in range(2):
            sl = slice(m * h, (m + 1) * h)
            plens = np.full((h,), S, np.int32)
            jeng.load_prefill(m, jnp.asarray(toks[sl, :S]),
                              jnp.asarray(plens),
                              enc_feats=jnp.asarray(feats[sl]))
            teng.load_prefill(m, torch.from_numpy(toks[sl, :S]),
                              torch.from_numpy(plens),
                              enc_feats=torch.from_numpy(feats[sl]))
        for lk, p in _wire(jeng).items():
            for w in teng.workers:
                w.load_state(lk, {k: bridge.tensor_from_numpy(
                    v[w.lo:w.hi], w.device) for k, v in p.items()})
        assert _digests(teng, tree_digest) == _digests(jeng, jtree_digest)

        def step(t):
            tok = toks[:, S + t:S + t + 1]
            want = np.concatenate([np.asarray(x) for x in jeng.decode_step(
                [jnp.asarray(tok[:h]), jnp.asarray(tok[h:])])])
            got = torch.cat(teng.decode_step(
                [torch.from_numpy(tok[:h]), torch.from_numpy(tok[h:])]))
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)

        step(0)
        # one step later the states differ in their last bits (each
        # package wrote its own k / v): install repro's again
        for lk, p in _wire(jeng).items():
            for w in teng.workers:
                w.load_state(lk, {k: bridge.tensor_from_numpy(
                    v[w.lo:w.hi], w.device) for k, v in p.items()})
        jeng.apply_partition(SPLIT)
        teng.apply_partition(SPLIT)
        want = _digests(jeng, jtree_digest)
        assert _digests(teng, tree_digest) == want
        jstore, tstore = JSnapshots(), KVSnapshotStore()
        jstore.snapshot(jeng, 1)
        tstore.snapshot(teng, 1)
        assert tstore.checksums == jstore.checksums
        for eng, store in ((jeng, jstore), (teng, tstore)):
            eng.workers[0].kill()
            eng.workers[0].join(timeout=10)
            eng.remove_worker(0, lost=store.payload())
        assert _digests(teng, tree_digest) == want \
            == _digests(jeng, jtree_digest)
        step(1)
    finally:
        jeng.close()
        teng.close()
