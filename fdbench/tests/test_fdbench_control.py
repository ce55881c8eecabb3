"""The check that decides ``correct``, driven through a whole run on the
CPU at a size a test holds (the look for a card skipped), with the cells'
own rule for the sample: the program passes its limit; the fp8 control
reads above it; and with each fault a one-card serve can have planted
under the timed path, ``correct`` comes out false on every seed tried.
The cell-size readings come from ``fdbench/run.py --seeds`` on the card;
the test marked ``cuda`` drives the same small run there."""
import time
from types import SimpleNamespace

import pytest
import torch

from fdbench.lib import cell as C
from fdbench.lib import faults as FL

LIMIT = 0.004        # this size's limit on the CPU: sound runs read
                     # 0.00005-0.0019, the fp8 control 0.0136-0.0206
CARD_LIMIT = 0.016   # the card's size (Dh 128) on the card: sound runs
                     # read 0.0038-0.0055, the control 0.044-0.097

SEEDS = (2 ** 33 + 2, 2 ** 31 + 11)


def _cell(heads=(4, 2, 16), limit: float = LIMIT) -> C.Cell:
    """A small cell, ``heads`` (Hq, Hkv, Dh): 16 slots, so that each half
    of each R-Part call's rows holds two slots and the sample takes one
    request of several there."""
    hq, hkv, dh = heads
    cfg = {"name": "tiny", "source": "test", "family": "dense_decoder",
           "reference": "dense_decoder", "hidden_size": hq * dh,
           "num_attention_heads": hq, "num_key_value_heads": hkv,
           "head_dim": dh, "intermediate_size": 128, "vocab_size": 256,
           "num_hidden_layers": 2, "hidden_act": "silu",
           "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
           "torch_dtype": "bfloat16"}
    mix = {"name": "t", "loop": "closed", "block": 16, "start": "steady",
           "prompt": {"dist": "uniform", "lo": 8, "hi": 40},
           "output": {"dist": "uniform", "lo": 8, "hi": 40}}
    sizing = {"slots": 16, "cache_len": 96, "fill_group": 4,
              "check": {"limits": {"max_gap": limit, "wrong_lengths": 0}}}
    return C.Cell("tiny.closed", cfg, mix, sizing, 1)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell, seed, fault=None, control=False, device="cpu"):
    return C.run_cell(cell, seed, 2.0, False, t_proc0=time.perf_counter(),
                      device=device, check_device=False, control=control,
                      fault=fault)


def test_sound_run_passes_and_the_control_fails():
    res = _run(_cell(), 2 ** 33 + 1, control=True)
    assert res["correct"], res["checks"]
    assert res["_counts"]["requests_checked"] >= 8
    r = res["readings"]
    assert r["max_gap"] <= LIMIT < r["control_max_gap"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", sorted(FL.FAULTS))
def test_each_fault_fails_the_check(fault, seed):
    res = _run(_cell(), seed, fault=FL.FAULTS[fault])
    assert not res["correct"], (fault, res["checks"])


def test_the_sample_covers_each_half_of_each_r_call():
    eng = SimpleNamespace(engine=SimpleNamespace(
        num_mb=2, mb_size=16, slices=[(0, 8), (8, 16)]))
    ranges = C.row_ranges(eng)
    assert [(r.start, r.stop) for r in ranges] == [
        (0, 4), (4, 8), (8, 12), (12, 16),
        (16, 20), (20, 24), (24, 28), (28, 32)]
    odd = SimpleNamespace(engine=SimpleNamespace(
        num_mb=1, mb_size=3, slices=[(0, 1), (1, 3)]))
    assert [(r.start, r.stop) for r in C.row_ranges(odd)] == [
        (0, 1), (1, 2), (2, 3)]
    # three requests finished in the window on each slot, one still
    # running there; the longest is taken, then one of each range
    reqs, slot_of, finish = {}, {}, {}
    for rid in range(4 * 32):
        slot = rid % 32
        reqs[rid] = SimpleNamespace(rid=rid, generated=[0] * (1 + rid))
        slot_of[rid] = slot
        if rid < 3 * 32:
            finish[rid] = 10.0
    drv = SimpleNamespace(reqs=reqs, slot_of=slot_of, finish=finish)
    run = SimpleNamespace(t0=5.0)
    got = C._sample(drv, run, 2 ** 33 + 3, ranges)
    assert got[0].rid == 3 * 32 - 1
    assert all(r.rid in finish for r in got)
    covered = {i for i, rows in enumerate(ranges)
               for r in got if slot_of[r.rid] in rows}
    assert covered == set(range(8))
    again = C._sample(drv, run, 2 ** 33 + 3, ranges)
    assert [r.rid for r in again] == [r.rid for r in got]
    # a range where nothing finished in the window: its longest running
    for rid in list(finish):
        if slot_of[rid] < 4:
            finish[rid] = 1.0
    got = C._sample(drv, run, 2 ** 33 + 3, ranges)
    first = [r for r in got if slot_of[r.rid] < 4]
    assert [r.rid for r in first] == [3 * 32 + 3]


def test_no_device_is_refused_before_any_work():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(C.NoDevice):
        C.run_cell(_cell(), 1, 1.0, False, t_proc0=0.0)


@pytest.mark.cuda
def test_small_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # kernel 1 on the card takes Dh 64 or 128
    res = _run(_cell(heads=(2, 1, 128), limit=CARD_LIMIT), 7, control=True,
               device="cuda")
    assert res["correct"], res["checks"]
    r = res["readings"]
    assert r["max_gap"] <= CARD_LIMIT < r["control_max_gap"]
    assert res["device"]["memory_peak_bytes"] > 0
