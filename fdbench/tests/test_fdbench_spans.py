"""The reduction of a traced slice to the port's own spans
(``fdbench/lib/spans.py``) on synthetic intervals, and kernel 1's work
counter against the harness's reconstruction of its launches."""
import time
from types import SimpleNamespace

import pytest
import torch

from fdbench.lib import cell as C
from fdbench.lib import spans as S
from fdbench.roofline import paged_attn
from repro_torch.obs import SpanTracer
from repro_torch.obs.spans import CLOCK_EVENT

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


def _ev(name, a, b, dev):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=a, end=b))


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _tracer(spans, clock=(0.0, 1.0)):
    """A tracer holding ``spans`` (name, cat, track, a, b, kw) in seconds
    from its t0, with clock anchors at ``clock`` seconds from it."""
    tr = SpanTracer(ring=1 << 16)
    for name, cat, track, a, b, kw in spans:
        tr.add(name, cat, track, tr.t0 + a, tr.t0 + b, **kw)
    tr.clock.extend(tr.t0 + c for c in clock)
    return tr


def _clock_events(ends_us):
    return [_ev(CLOCK_EVENT, e - 3.0, e, CPU) for e in ends_us]


def test_innermost_span_wins():
    segs = S.innermost([(0, 100, "engine.step"), (10, 90, "step 3"),
                        (20, 30, "pipe.sink_wait"), (40, 50, "pipe.advance"),
                        (95, 99, "engine.emit")])
    assert segs == [(0, 10, "engine.step"), (10, 20, "step 3"),
                    (20, 30, "pipe.sink_wait"), (30, 40, "step 3"),
                    (40, 50, "pipe.advance"), (50, 90, "step 3"),
                    (90, 95, "engine.step"), (95, 99, "engine.emit"),
                    (99, 100, "engine.step")]
    # idle [15, 35]: 5 under the step, 10 waiting on the sink, 5 under
    # the step again; [100, 110] under no span
    got = S.idle_by_name([(15, 35), (100, 110)], segs)
    assert got == {"step 3": 10.0, "pipe.sink_wait": 10.0, None: 10.0}
    assert [S.part(n) for n in ("engine.admit", "step 3", "pipe.gather",
                                "pipe.sink_wait", None)] == [
        "engine", "dispatch", "dispatch", "sink_wait", "unspanned"]


def test_a_child_past_its_parent_is_cut():
    segs = S.innermost([(0, 10, "engine.step"), (2, 10.5, "engine.emit"),
                        (11, 12, "engine.step")])
    assert segs == [(0, 2, "engine.step"), (2, 10, "engine.emit"),
                    (11, 12, "engine.step")]


def test_every_gap_counts_and_the_parts_make_the_idle():
    # 1,000 gaps of 1 us between 9 us kernels, far more than the 200 the
    # breakdown names; the step span covers the first half of the slice
    dev = [_ev("k", 10.0 * i, 10.0 * i + 9.0, CUDA) for i in range(1000)]
    t0, t1 = 0.0, 10_000.0
    tr = _tracer([("engine.step", "engine", "s-worker", 0.0, 0.005, {}),
                  ("pipe.sink_wait", "pipe", "s-worker", 0.001, 0.002, {})],
                 clock=(0.0, 0.01))
    prof = _Prof(dev + _clock_events([0.0, 10_000.0]))
    sp = S.reduce(prof, t0, t1, tr)
    assert sp["wall_s"] == pytest.approx(0.01)
    assert sp["busy_s"] == pytest.approx(0.009)
    parts = sp["parts_s"]
    assert sum(parts.values()) == pytest.approx(0.001, rel=1e-9)
    assert parts["sink_wait"] == pytest.approx(100e-6)
    assert parts["engine"] == pytest.approx(400e-6)
    assert parts["unspanned"] == pytest.approx(500e-6)
    assert parts["dispatch"] == 0.0
    run = SimpleNamespace(spans=sp)
    idle = 100.0 * (1 - sp["busy_s"] / sp["wall_s"])
    total = (S.idle_engine_pct(run) + S.idle_dispatch_pct(run)
             + S.idle_sink_wait_pct(run)
             + 100.0 * parts["unspanned"] / sp["wall_s"])
    assert total == pytest.approx(idle, abs=1e-9)
    assert sp["idle_by_span_s"]["unspanned"] == pytest.approx(500e-6)


def test_the_clock_anchors_place_the_spans():
    # the profiler's clock runs 1,000 us ahead and 100 ppm fast: a span
    # at 2-3 ms of the tracer's clock covers the gap at 1,002.0002-
    # 1,003.0003 ms of the profiler's
    a0, a1 = 1_000.0, 1_000.0 + 10_000 * 1.0001
    tr = _tracer([("engine.emit", "engine", "s-worker", 0.002, 0.003, {})],
                 clock=(0.0, 0.01))
    dev = [_ev("k", 0.0, 3_000.2, CUDA), _ev("k", 4_000.3, 12_000.0, CUDA)]
    sp = S.reduce(_Prof(dev + _clock_events([a0, a1])), 0.0, 12_000.0, tr)
    assert sp["parts_s"]["engine"] == pytest.approx(1e-3 * 1.0001, rel=1e-6)
    assert sp["parts_s"]["unspanned"] == pytest.approx(0.0, abs=1e-9)
    assert sp["clock_drift_ppm"] == pytest.approx(100.0, rel=1e-6)


def test_a_dropped_span_silences_every_reader():
    tr = SpanTracer(ring=1)
    tr.add("engine.step", "engine", "s-worker", tr.t0, tr.t0 + 0.001)
    tr.add("engine.step", "engine", "s-worker", tr.t0 + 0.002, tr.t0 + 0.003)
    tr.clock.extend([tr.t0, tr.t0 + 0.01])
    sp = S.reduce(_Prof(_clock_events([0.0, 10_000.0])), 0.0, 10_000.0, tr)
    assert sp["dropped"] == 1
    run = SimpleNamespace(spans=sp)
    for read in (S.idle_engine_pct, S.idle_dispatch_pct,
                 S.idle_sink_wait_pct, S.rtt_host_ms):
        assert read(run) is None
        # and a run with no spans at all (an untraced run, or a harness
        # that attaches no tracer)
        assert read(SimpleNamespace()) is None
        assert read(SimpleNamespace(spans=None)) is None


def test_rtt_host_ms_by_hand():
    # round trip 1: 1.0 ms, its workers' syncs 0.3 and 0.5 ms -> 0.5 ms of
    # host legs; round trip 2: 2.0 ms, syncs 1.2 and 0.4 -> 0.8; round
    # trip 3 ends after the slice and is left out
    sp = [("L0.p0", "r-rtt", "mb0", 0.0, 0.001, dict(id=1)),
          ("r.sync", "r-part", "r0", 0.0002, 0.0005, dict(parent=1)),
          ("r.sync", "r-part", "r1", 0.0001, 0.0006, dict(parent=1)),
          ("L1.p0", "r-rtt", "mb0", 0.002, 0.004, dict(id=2)),
          ("r.sync", "r-part", "r0", 0.0025, 0.0037, dict(parent=2)),
          ("r.sync", "r-part", "r1", 0.0025, 0.0029, dict(parent=2)),
          ("L2.p0", "r-rtt", "mb0", 0.009, 0.011, dict(id=3)),
          ("r.sync", "r-part", "r0", 0.0095, 0.0096, dict(parent=3))]
    tr = _tracer(sp, clock=(0.0, 0.01))
    got = S.reduce(_Prof(_clock_events([0.0, 10_000.0])), 0.0, 10_000.0, tr)
    assert got["rtt_host_ms"] == pytest.approx((0.5 + 0.8) / 2)
    assert S.rtt_host_ms(SimpleNamespace(spans=got)) \
        == pytest.approx(0.65)
    s = S.samples(got)
    assert s["dropped_spans"] == 0 and s["counters_per_step"] == {}


def test_kernel1_counter_matches_the_launch_reconstruction():
    """The R-workers' ``k1.*`` counters over a few steps of a small paged
    serve on the CPU give the same ``paged_attn.launch`` totals as the
    harness's ``_launches`` over the tokens the same steps emitted."""
    cfg = {"name": "tiny", "source": "test", "family": "dense_decoder",
           "reference": "dense_decoder", "hidden_size": 64,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "head_dim": 16, "intermediate_size": 128, "vocab_size": 256,
           "num_hidden_layers": 2, "hidden_act": "silu",
           "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
           "torch_dtype": "bfloat16"}
    mix = {"name": "t", "loop": "closed", "block": 16, "start": "steady",
           "prompt": {"dist": "uniform", "lo": 8, "hi": 40},
           "output": {"dist": "uniform", "lo": 8, "hi": 40}}
    sizing = {"slots": 8, "cache_len": 96, "fill_group": 4,
              "check": {"limits": {}}}
    cell = C.Cell("tiny.closed", cfg, mix, sizing, 1)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    _, _, eng, drv = C.build_engine(cell, 2 ** 33 + 5, "cpu")
    try:
        drv.fill()
        tr = SpanTracer(ring=1 << 16)
        eng.attach_tracer(tr)
        drv.run = C.RunData(cell=cell, sizes={})
        drv.launch_log = []
        for _ in range(12):
            drv.arrivals()
            drv.launch_log.append([])
            drv.step()
        eng.attach_tracer(None)
        log = drv.launch_log
        assert sum(1 for r in eng.records[-12:] if r.admitted) >= 1
        want = C._launches(log, eng, 2, 4, 2, 16)
    finally:
        torch.set_num_threads(n)
        eng.close()
    c = tr.counters()
    assert c["k1.calls"] == len(want) == 12 * 2 * 2 * 2
    # one launch's totals are linear in (rows, tokens, pages)
    got_f = 4.0 * 4 * 16 * c["k1.tokens"]
    got_b = (c["k1.tokens"] * 2 * 2 * 16 * paged_attn.KV_ELEM_BYTES
             + c["k1.pages"] * paged_attn.TABLE_ENTRY_BYTES
             + 2.0 * c["k1.rows"] * 4 * 16 * paged_attn.Q_ELEM_BYTES)
    assert got_f == sum(f for f, _ in want)
    assert got_b == sum(b for _, b in want)


def test_mark_clock_outside_a_profile_still_anchors():
    tr = SpanTracer()
    t = tr.mark_clock()
    assert tr.clock == [t] and t <= time.perf_counter()
