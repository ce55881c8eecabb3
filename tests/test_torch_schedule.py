"""The port's copy of the admission schedules (repro_torch.core.schedule:
eq. 5/6, Algorithm 1's LoadController, the schedule builders and the
analytic simulator) against repro.core.schedule on the same inputs:
every function's result equal, and LoadController driven op for op by
hypothesis with equal answers and equal state after every op."""
import dataclasses
import itertools

import pytest

from _hyp import given, settings, st
from repro.core import schedule as JS
from repro_torch.core import schedule as TS

GRID = list(itertools.product((1, 4, 8, 33), (1, 16, 32, 100), (1, 4, 7)))


@pytest.mark.parametrize("B,S,F", GRID)
def test_closed_forms_match(B, S, F):
    assert TS.microbatch_size(B, S, F) == JS.microbatch_size(B, S, F)
    assert TS.w_max(B, S) == JS.w_max(B, S)
    assert TS.w_prime_max(B, S, F) == JS.w_prime_max(B, S, F)


@pytest.mark.parametrize("B,S,F", GRID)
def test_schedule_builders_match(B, S, F):
    steps = 3 * S + 5
    assert TS.big_batch_schedule(B, S, steps) == \
        JS.big_batch_schedule(B, S, steps)
    assert TS.sls_schedule(B, S, F, steps) == JS.sls_schedule(B, S, F, steps)
    for w_lim in (None, 0.5 * B * S, float(B * S)):
        assert TS.load_controlled_schedule(B, S, F, steps, w_lim) == \
            JS.load_controlled_schedule(B, S, F, steps, w_lim)


@pytest.mark.parametrize("pipelined", [True, False])
def test_simulate_and_throughput_match(pipelined):
    B, S, F, steps = 16, 24, 4, 80

    def t_s(b):
        return 0.01 + 0.002 * b

    for adm in (JS.big_batch_schedule(B, S, steps),
                JS.sls_schedule(B, S, F, steps),
                JS.load_controlled_schedule(B, S, F, steps)):
        got = TS.simulate(adm, S, steps, t_s_of_b=t_s, r_per_len=3e-4,
                          pipelined=pipelined)
        want = JS.simulate(adm, S, steps, t_s_of_b=t_s, r_per_len=3e-4,
                           pipelined=pipelined)
        assert [dataclasses.astuple(s) for s in got] == \
            [dataclasses.astuple(s) for s in want]
        assert TS.throughput(got) == JS.throughput(want)
    assert TS.throughput([]) == JS.throughput([]) == 0.0


def _state(lc):
    return [dataclasses.astuple(m) for m in lc.mbs]


_OPS = st.lists(
    st.tuples(st.sampled_from(("retire", "add", "earliest", "load")),
              st.integers(0, 6),            # step increment
              st.integers(1, 9),            # micro-batch size
              st.integers(0, 400)),         # prompt tokens
    min_size=1, max_size=40)


@settings(max_examples=60, deadline=None)
@given(st.integers(40, 4000), st.integers(1, 64), _OPS)
def test_load_controller_op_for_op(w_lim, seq_len, ops):
    """Both controllers see one op sequence (steps only move forward, as
    in a serve); each answer and the tracked micro-batches agree after
    every op."""
    got = TS.LoadController(w_lim=w_lim, seq_len=seq_len)
    want = JS.LoadController(w_lim=w_lim, seq_len=seq_len)
    t = 0
    for op, dt, m, prompt in ops:
        t += dt
        if op == "retire":
            got.retire(t)
            want.retire(t)
        elif op == "add":
            got.add_microbatch(t, m, prompt_tokens=prompt)
            want.add_microbatch(t, m, prompt_tokens=prompt)
        elif op == "earliest":
            assert got.earliest_step(t, m, prompt_tokens=prompt) == \
                want.earliest_step(t, m, prompt_tokens=prompt)
        else:
            assert got.resident_load(t) == want.resident_load(t)
        assert _state(got) == _state(want)


@settings(max_examples=30, deadline=None)
@given(st.integers(8, 64), st.integers(16, 64), st.integers(1, 8),
       st.floats(0.5, 1.5))
def test_algorithm1_admissions_match_and_bound(B, S, F, scale):
    """Admitting every micro-batch at its earliest step: the same
    admissions, and the port's resident load never over w_lim once an
    incumbent is tracked (the reference's property)."""
    w_lim = scale * JS.w_prime_max(B, S, F)
    adm = TS.load_controlled_schedule(B, S, F, 4 * S, w_lim)
    assert adm == JS.load_controlled_schedule(B, S, F, 4 * S, w_lim)
    if w_lim >= JS.microbatch_size(B, S, F) * S:
        for s in TS.simulate(adm, S, 4 * S):
            assert s.resident_len <= w_lim
