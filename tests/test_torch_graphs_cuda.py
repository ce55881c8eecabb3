"""The port's step graphs on the card: a captured S-side transition, a
captured R-Part per storage (paged fp, paged int8, dense fp, dense int8),
and a chunk work's captured pieces (its S-side start and transitions, and
its R-Part per storage: a prefill chunk's and a verify's), and a paged
R-Part after its pools changed in place under the graph (a CoW clone and
a host-tier restore), replayed against the same callable run eagerly (``graphs.eager()``) on the same
inputs.  Marked ``cuda``: they skip without a CUDA device.  This
file imports no JAX, so it runs on the card without the JAX-importing
conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_graphs_cuda.py

fp32 with TF32 off; a replay launches the eager call's kernels in its
order, so outputs and KV agree within 1e-5 absolute (exact in practice).
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import graphs
from repro_torch.core.config import get_arch
from repro_torch.core.hetero import CompletionSink, HeteroPipelineEngine, \
    RWorker
from repro_torch.models import model as M

TOL = 1e-5


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cfg():
    # Dh 64, GQA 4/2, fp32: shapes the kernels take
    return dataclasses.replace(
        get_arch("qwen3-8b").reduced(layers=2, d_model=256, vocab=512),
        num_kv_heads=2)


def _close(got, want):
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)


@pytest.mark.cuda
def test_s_transitions_replay_equals_eager():
    _needs_card()
    cfg, dev = _cfg(), torch.device("cuda")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    eng = HeteroPipelineEngine(params, cfg, batch=4, cache_len=32,
                               device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    try:
        for _ in range(3):          # capture, then replays
            toks = torch.randint(1, cfg.vocab_size, (2, 1), generator=gen,
                                 device=dev, dtype=torch.int32)
            eng.mb_lengths[0] = torch.randint(0, 20, (2,), generator=gen,
                                              device=dev, dtype=torch.int32)
            o = torch.randn((2, 1, cfg.num_heads, cfg.head_dim),
                            generator=gen, device=dev)
            runs = []
            for ctx in (contextlib.nullcontext(), graphs.eager()):
                with ctx:
                    carry, shards = eng._start(0, toks)
                    got = [carry["h"].clone()] + [
                        v.clone() for s in shards for v in s.values()]
                    nxt, shards2 = eng._advance(0, 0, 0, carry, {"o": o})
                    got += [nxt["h"].clone()] + [
                        v.clone() for s in shards2 for v in s.values()]
                    _, logits = eng._advance(0, 1, 0, nxt, {"o": o})
                    runs.append(got + [logits.clone()])
            torch.cuda.synchronize()
            for a, b in zip(*runs):
                _close(a, b)
        assert all(g._graph is not None for g in eng._s_graphs.values())
    finally:
        eng.close()


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["paged", "paged-int8", "dense",
                                     "dense-int8"])
def test_r_part_replay_equals_eager(storage):
    _needs_card()
    cfg, dev = _cfg(), torch.device("cuda")
    paged, quant = storage.startswith("paged"), storage.endswith("int8")
    hq, hkv, dh, cache = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 32
    rng = np.random.default_rng(2)
    lens = np.array([5, 9], np.int32)
    pos = np.where(np.arange(cache)[None] < lens[:, None],
                   np.arange(cache)[None], -1).astype(np.int32)
    st = {"k": rng.standard_normal((2, cache, hkv, dh)).astype(np.float32),
          "v": rng.standard_normal((2, cache, hkv, dh)).astype(np.float32),
          "pos": pos}
    workers = []
    for _ in range(2):          # one replays, one runs eagerly
        w = RWorker(0, cfg, 0, 2, quantized=quant, paged=paged, page_size=4,
                    device=dev)
        w.load_state(0, {k: torch.from_numpy(v.copy()).to(dev)
                         for k, v in st.items()})
        workers.append(w)
    sink = CompletionSink(2, dev)
    outs = ([], [])
    for step in range(3):
        r_in = {k: torch.from_numpy(rng.standard_normal(
                    (2, 1, h, dh)).astype(np.float32)).to(dev)
                for k, h in (("q", hq), ("k", hkv), ("v", hkv))}
        r_in["lengths"] = torch.from_numpy(lens + step).to(dev)
        r_in["active"] = torch.ones((2,), dtype=torch.bool, device=dev)
        for w, out, ctx in zip(workers, outs, (contextlib.nullcontext(),
                                               graphs.eager())):
            ready = torch.cuda.Event()
            ready.record()
            with ctx:
                w._run_one(((0, 0, 0, 0, 0), 0, "attn", 0, r_in, sink,
                            ready))
            _, _, err = sink.q.get_nowait()
            assert err is None, err
            out.append(sink._bufs[(0, 0, 0, 0)]["o"].clone())
    for a, b in zip(*outs):
        _close(a, b)
    assert workers[0]._graphs[("d", 0)]._graph is not None
    assert workers[1]._graphs[("d", 0)]._graph is None
    for k, v in workers[0].state[0].items():
        _close(v.float(), workers[1].state[0][k].float())


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["paged", "paged-int8"])
def test_r_part_replay_after_inplace_clone_and_restore_equals_eager(storage):
    """The paged R-Part replayed after the pools changed under its graph
    in place: between steps row 1 adopts row 0's two prefix pages (the
    next appends land in the shared tail page, so the step CoW-clones it
    into every layer's pool before the replay), and row 0's first page
    makes a host round trip (out, zeroed, restored by
    ``restore_pool_pages`` on the worker's stream).  Outputs and KV equal
    the eager worker's, and no pool tensor moved."""
    from repro_torch.serving import paged_cache as PC
    _needs_card()
    cfg, dev = _cfg(), torch.device("cuda")
    quant = storage.endswith("int8")
    hq, hkv, dh, cache = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 32
    rng = np.random.default_rng(6)
    lens = np.array([5, 9], np.int32)
    pos = np.where(np.arange(cache)[None] < lens[:, None],
                   np.arange(cache)[None], -1).astype(np.int32)
    st = {"k": rng.standard_normal((2, cache, hkv, dh)).astype(np.float32),
          "v": rng.standard_normal((2, cache, hkv, dh)).astype(np.float32),
          "pos": pos}
    workers = []
    for _ in range(2):          # one replays, one runs eagerly
        w = RWorker(0, cfg, 0, 2, quantized=quant, paged=True, page_size=4,
                    prefix_cache=True, kv_tier=PC.HostTier(), device=dev)
        w.load_state(0, {k: torch.from_numpy(v.copy()).to(dev)
                         for k, v in st.items()})
        workers.append(w)
    ptrs = {k: v.data_ptr() for k, v in workers[0].state[0].items()}
    sink = CompletionSink(2, dev)
    outs = ([], [])
    for step, step_lens in enumerate(([5, 9], [6, 6], [7, 7])):
        if step == 1:
            for w in workers:
                a = w.allocators[0]
                a.register_prefix(0, np.arange(1, 7, dtype=np.int32))
                a.adopt_prefix(1, [int(p) for p in a.tables[0][:2]], 6)
                pools = a.pool_reader()
                pid = int(a.tables[0][0])
                payload = a._read_page(pools, pid)
                for pool in pools.values():
                    for v in pool.values():
                        v[pid].zero_()
                entry = PC.TierEntry(digests={b"page"}, payload=payload)
                with PC.on_stream(w.stream):
                    for li, pool in pools.items():
                        PC.restore_pool_pages(pool, [(entry, pid)], li)
                w.stream.synchronize()
        r_in = {k: torch.from_numpy(rng.standard_normal(
                    (2, 1, h, dh)).astype(np.float32)).to(dev)
                for k, h in (("q", hq), ("k", hkv), ("v", hkv))}
        r_in["lengths"] = torch.tensor(step_lens, dtype=torch.int32,
                                       device=dev)
        r_in["active"] = torch.ones((2,), dtype=torch.bool, device=dev)
        for w, out, ctx in zip(workers, outs, (contextlib.nullcontext(),
                                               graphs.eager())):
            ready = torch.cuda.Event()
            ready.record()
            with ctx:
                w._run_one(((0, 0, 0, 0, 0), 0, "attn", 0, r_in, sink,
                            ready))
            _, _, err = sink.q.get_nowait()
            assert err is None, err
            out.append(sink._bufs[(0, 0, 0, 0)]["o"].clone())
            if step == 1:       # row 0's append CoW-cloned the shared page
                assert len(w._step_clones[(0, "d")]) == 1
    for a, b in zip(*outs):
        _close(a, b)
    assert workers[0]._graphs[("d", 0)]._graph is not None
    for k, v in workers[0].state[0].items():
        assert v.data_ptr() == ptrs[k]
        _close(v.float(), workers[1].state[0][k].float())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["c", "v"], ids=["prefill", "verify"])
@pytest.mark.parametrize("storage", ["paged", "paged-int8", "dense",
                                     "dense-int8"])
def test_chunk_r_part_replay_equals_eager(storage, mode):
    """A chunk work's R-Part, a prefill chunk (no marker) or a verify
    (``verify`` marker), replayed against eager over three chunks of 3
    tokens per row (one row fed 2, then nothing): outputs and KV."""
    _needs_card()
    cfg, dev = _cfg(), torch.device("cuda")
    paged, quant = storage.startswith("paged"), storage.endswith("int8")
    hq, hkv, dh, cache, c = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                             32, 3)
    rng = np.random.default_rng(4)
    lens = np.array([5, 9], np.int32)
    pos = np.where(np.arange(cache)[None] < lens[:, None],
                   np.arange(cache)[None], -1).astype(np.int32)
    st = {"k": rng.standard_normal((2, cache, hkv, dh)).astype(np.float32),
          "v": rng.standard_normal((2, cache, hkv, dh)).astype(np.float32),
          "pos": pos}
    workers = []
    for _ in range(2):          # one replays, one runs eagerly
        w = RWorker(0, cfg, 0, 2, quantized=quant, paged=paged, page_size=4,
                    device=dev)
        w.load_state(0, {k: torch.from_numpy(v.copy()).to(dev)
                         for k, v in st.items()})
        workers.append(w)
    sink = CompletionSink(2, dev)
    outs = ([], [])
    base = lens.copy()
    for step, counts in enumerate(([3, 3], [3, 2], [3, 0])):
        valid = np.arange(c)[None] < np.array(counts)[:, None]
        r_in = {k: torch.from_numpy(rng.standard_normal(
                    (2, c, h, dh)).astype(np.float32)).to(dev)
                for k, h in (("q", hq), ("k", hkv), ("v", hkv))}
        r_in["lengths"] = torch.from_numpy(base.copy()).to(dev)
        r_in["valid"] = torch.from_numpy(valid).to(dev)
        if mode == "v":
            r_in["verify"] = True
        for w, out, ctx in zip(workers, outs, (contextlib.nullcontext(),
                                               graphs.eager())):
            ready = torch.cuda.Event()
            ready.record()
            with ctx:
                w._run_one(((0, step % 2, 2, 0, 0), 0, "attn", 0, dict(r_in),
                            sink, ready))
            _, _, err = sink.q.get_nowait()
            assert err is None, err
            got = sink._bufs[(step % 2, 2, 0, 0)]["o"].clone()
            out.append(torch.where(r_in["valid"].cpu()[..., None, None], got,
                                   torch.zeros((), dtype=got.dtype)))
        base += np.array(counts, np.int32)
    for a, b in zip(*outs):
        _close(a, b)
    keys = [k for k in workers[0]._graphs if k[0] == mode]
    assert keys and all(workers[0]._graphs[k]._graph is not None
                        for k in keys)
    assert all(g._graph is None for g in workers[1]._graphs.values())
    for k, v in workers[0].state[0].items():
        _close(v.float(), workers[1].state[0][k].float())


@pytest.mark.cuda
@pytest.mark.parametrize("verify", [False, True], ids=["prefill", "verify"])
def test_chunk_s_transitions_replay_equals_eager(verify):
    """A chunk work's S-side start, fused transition and logits head (a
    prefill chunk's at each row's last valid position, a verify's at
    every position) replayed against eager on the same inputs."""
    _needs_card()
    cfg, dev = _cfg(), torch.device("cuda")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    eng = HeteroPipelineEngine(params, cfg, batch=4, cache_len=32,
                               device=dev)
    rng = np.random.default_rng(5)
    try:
        for _ in range(3):          # capture, then replays
            toks = rng.integers(1, cfg.vocab_size, (2, 4)).astype(np.int32)
            wk = eng.queue_prefill_chunk(
                0, [0, 1], toks, rng.integers(0, 20, 2),
                rng.integers(1, 5, 2), verify=verify)
            eng._prefill_inbox.clear()
            o = torch.from_numpy(rng.standard_normal(
                (2, 4, cfg.num_heads, cfg.head_dim)).astype(
                    np.float32)).to(dev)
            runs = []
            for ctx in (contextlib.nullcontext(), graphs.eager()):
                with ctx:
                    carry, shards = eng._chunk_start(wk)
                    got = [carry["h"].clone()] + [
                        v.clone() for s in shards for v in s.values()]
                    eng._chunk_advance_graph(wk, 0, 0, carry).feed({"o": o})
                    nxt, shards2 = eng._chunk_advance(wk, 0, 0, carry)
                    got += [nxt["h"].clone()] + [
                        v.clone() for s in shards2 for v in s.values()]
                    eng._chunk_advance_graph(wk, 1, 0, nxt).feed({"o": o})
                    _, logits = eng._chunk_advance(wk, 1, 0, nxt)
                    runs.append(got + [logits])
            torch.cuda.synchronize()
            for a, b in zip(*runs):
                _close(a, b)
            assert runs[0][-1].shape == ((2, 4, cfg.vocab_size) if verify
                                         else (2, cfg.vocab_size))
        assert all(g._graph is not None for g in eng._s_graphs.values())
    finally:
        eng.close()
