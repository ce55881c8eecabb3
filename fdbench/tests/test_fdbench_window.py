"""The window's arithmetic: a rate over the whole window, and the readers
built on it; the readers of the trace read nothing without one."""
import pytest

from fdbench.lib import cell as C
from fdbench.lib import readers as R
from fdbench.lib.cell import Cell, RunData


def _run(**kw):
    run = RunData(cell=Cell("x", {}, {}, {}), sizes={})
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_rate_over_the_whole_window():
    run = _run(t0=100.0, t1=120.0, tokens=4000)
    assert R.decode_tok_s(run) == 200.0
    assert R.decode_tok_s(_run(t0=5.0, t1=5.0, tokens=3)) is None


def test_step_rate_in_fifths_of_the_window():
    # 10 steps in the first 2 s, none in the next 4, 20 in the last 4
    run = _run(t0=0.0, t1=10.0,
               step_ts=[0.1 + 0.1 * i for i in range(10)]
               + [6.1 + 0.2 * i for i in range(20)])
    assert C._fifths(run) == pytest.approx([5.0, 0.0, 0.0, 5.0, 5.0])


def test_hotpath_per_decode_step():
    run = _run(hotpath={"s_dispatch_s": 1.0, "dispatch_s": 0.5,
                        "collect_s": 0.5, "steps_count": 100.0})
    assert R.hotpath_host_ms(run) == pytest.approx(20.0)
    assert R.hotpath_host_ms(_run(hotpath={})) is None


def test_device_readers_need_a_trace():
    run = _run(t0=0.0, t1=10.0, peaks=None)
    assert R.attn_roofline(run) is None
    assert R.device_idle_pct(run) is None
    assert R.step_mfu_pct(run) is None
    run.slice = {"wall_s": 2.0, "busy_s": 1.5, "kernels": {},
                 "launches": []}
    assert R.device_idle_pct(run) == pytest.approx(25.0)
    # no kernel-1 time in the slice: no roofline share, never 0
    run.peaks = {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}
    assert R.attn_roofline(run) is None
