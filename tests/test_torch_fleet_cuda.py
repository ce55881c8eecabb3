"""Fleet management on the card: after ``apply_partition`` the changed
R-workers release their CUDA graphs and re-capture them, and a serve
that migrates mid-way replays what it computes eagerly
(``graphs.eager()``) on the same trace; a failed-over worker that is
still hung keeps its graphs until its thread has exited, and they are
freed after.  Marked ``cuda``: they skip without a CUDA device.  This
file imports no JAX, so it runs on the card without the JAX-importing
conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_fleet_cuda.py

fp32 with TF32 off: a replay launches the eager call's kernels in its
order, so logits agree within 1e-5 absolute and tokens exactly.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.chaos import FaultPlan, FaultSpec
from repro_torch.core import graphs
from repro_torch.core.config import get_arch
from repro_torch.core.hetero import CollectTimeout
from repro_torch.models import model as M
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request

TOL = 1e-5


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _model():
    cfg = dataclasses.replace(
        get_arch("qwen3-8b").reduced(layers=2, d_model=256, vocab=512),
        num_kv_heads=2, dtype="float32")
    dev = torch.device("cuda")
    return cfg, M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                              device=dev), dev


def _requests(cfg, n=6):
    rng = np.random.default_rng(3)
    return [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, int(p))
                    .astype(np.int32), max_new_tokens=8)
            for i, p in enumerate(rng.integers(5, 40, n))]


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [dict(paged_kv=True),
                                     dict(paged_kv=True, quantized_kv=True),
                                     dict(), dict(quantized_kv=True)],
                         ids=["paged", "paged-int8", "dense", "dense-int8"])
def test_migration_recaptures_and_replay_equals_eager(storage):
    _needs_card()
    cfg, params, dev = _model()
    runs = []
    for ctx in (contextlib.nullcontext, graphs.eager):
        eng = ServingEngine(params, cfg, batch=8, cache_len=64,
                            backend="hetero", page_size=16, device=dev,
                            **storage)
        logits, stats = [], {}
        try:
            with ctx():
                for r in _requests(cfg):
                    eng.submit(r)
                while eng.queue or any(s is not None for s in eng.slots):
                    if eng.step_idx == 3:
                        w0, w1 = eng.engine.workers
                        eng.engine.apply_partition([(0, 3), (3, 4)])
                        stats["released"] = (len(w0._graphs),
                                             len(w1._graphs))
                    eng.step()
                    logits.append(eng.last_logits.clone())
                    assert eng.step_idx < 100
                stats["recaptures"] = [w.recapture_count
                                       for w in eng.engine.workers]
                stats["graphs"] = [len(w._graphs)
                                   for w in eng.engine.workers]
            toks = {r.rid: list(r.generated) for r in eng.finished}
        finally:
            eng.close()
        runs.append((toks, logits, stats))
    (toks_g, lg_g, st_g), (toks_e, lg_e, _) = runs
    assert st_g["released"] == (0, 0)
    assert all(n > 0 for n in st_g["recaptures"])
    assert st_g["recaptures"] == st_g["graphs"]
    assert toks_g == toks_e and len(lg_g) == len(lg_e)
    for a, b in zip(lg_g, lg_e):
        torch.testing.assert_close(a, b, atol=TOL, rtol=0)


@pytest.mark.cuda
def test_failed_over_worker_frees_its_graphs_only_after_exit():
    """A worker hung in its graph-replaying loop is failed over: it keeps
    its graphs (its thread may still run) through the survivor's serve and
    the engine's close, which warns; once its thread has exited (it wakes,
    finds itself killed and returns without replaying), they are freed."""
    _needs_card()
    cfg, params, dev = _model()
    plan = FaultPlan([FaultSpec(site="r_step", kind="hang", wid=0,
                                after=2 * 2, hang_s=6.0)])
    eng = ServingEngine(params, cfg, batch=4, cache_len=64, backend="hetero",
                        paged_kv=True, page_size=16, device=dev, chaos=plan,
                        suspect_after_s=1.0, max_step_retries=0)
    for r in _requests(cfg, 4):
        eng.submit(r)
    eng.step()                               # every graph captured
    w0 = eng.engine.workers[0]
    n0 = len(w0._graphs)
    assert n0 > 0
    with pytest.raises(CollectTimeout) as ei:
        eng.step()
    assert ei.value.hung_wids == (0,)
    eng._quiesce_workers(skip=(0,))
    eng.engine.remove_worker(0)
    eng._resync_after_fault()
    eng.step()                               # the survivor serves on
    eng.engine._reap_retired()
    assert w0.is_alive() and len(w0._graphs) == n0
    with pytest.warns(RuntimeWarning, match=r"\[0\] did not exit"):
        eng.close()
    w0.join(timeout=30)
    assert not w0.is_alive()
    eng.engine._reap_retired()
    assert not w0._graphs and not eng.engine._retired
    torch.cuda.synchronize()
