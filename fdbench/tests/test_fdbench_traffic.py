"""The seeded traffic generator: one seed, one schedule; lengths inside
their clips; every seed the same work in another order; a steady
start's shares."""
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from fdbench.lib import traffic as TR

MIXES = Path(__file__).resolve().parents[1] / "traffic"


def _mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


EVERY_MIX = pytest.mark.parametrize(
    "name", sorted(p.stem for p in MIXES.glob("*.json")))


@EVERY_MIX
def test_same_seed_same_schedule(name):
    a = TR.Stream(_mix(name), 3_000_000_001).take(200)
    b = TR.Stream(_mix(name), 3_000_000_001).take(200)
    c = TR.Stream(_mix(name), 3_000_000_002).take(200)
    assert a == b
    assert a != c


@EVERY_MIX
def test_lengths_inside_their_clips(name):
    mix = _mix(name)
    for s in TR.Stream(mix, 11).take(640):
        for key, n in (("prompt", s.prompt_len), ("output", s.out_len)):
            d = mix[key]
            assert d["lo"] <= n <= d["hi"]


@EVERY_MIX
def test_every_seed_offers_the_same_work(name):
    mix = _mix(name)
    blk = mix["block"]
    a = TR.Stream(mix, 1).take(3 * blk)
    b = TR.Stream(mix, 2 ** 40 + 7).take(3 * blk)
    for i in range(3):
        sa, sb = a[i * blk:(i + 1) * blk], b[i * blk:(i + 1) * blk]
        assert Counter(s.prompt_len for s in sa) \
            == Counter(s.prompt_len for s in sb)
        assert Counter(s.out_len for s in sa) == Counter(s.out_len for s in sb)


def test_uniform_quantiles_cover_the_range():
    d = {"dist": "uniform", "lo": 512, "hi": 1023}
    got = [TR.inverse_cdf(d, (j + 0.5) / 512) for j in range(512)]
    assert sorted(got) == list(range(512, 1024))
    with pytest.raises(ValueError):
        TR.inverse_cdf({"dist": "lognormal", "median": 512}, 0.5)


def test_steady_start_shares():
    mix = _mix("batch")
    first = TR.Stream(mix, 9).steady(32)
    fresh = TR.Stream(mix, 9).take(32)
    for s, f in zip(first, fresh):
        assert s.rid == f.rid
        assert s.prompt_len + s.out_len == f.prompt_len + f.out_len
        assert 1 <= s.out_len <= f.out_len
    pre = [s.prompt_len - f.prompt_len for s, f in zip(first, fresh)]
    assert all(p >= 0 for p in pre) and min(pre) < max(pre)


def test_prompt_tokens():
    a = TR.prompt_tokens(2 ** 33, 5, 300, 50272)
    assert a.dtype == np.int32 and a.shape == (300,)
    assert a.min() >= 0 and a.max() < 50272
    assert np.array_equal(a, TR.prompt_tokens(2 ** 33, 5, 300, 50272))
    assert not np.array_equal(a, TR.prompt_tokens(2 ** 33, 6, 300, 50272))
