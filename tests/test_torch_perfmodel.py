"""The port's copy of the §4.3 performance model (repro_torch.core.perfmodel)
against repro.core.perfmodel: every public function and ``plan()`` for
each catalog ``Hardware`` passed explicitly (each package's own profile
object, equal fields), on the full-size configs of the archs the port
serves; plus the H100 profile's fields, its place in the catalog, and
``from_plan`` defaulting to it."""
import dataclasses
import math

import pytest

from repro.core import perfmodel as JP
from repro.core.config import get_arch as jget_arch
from repro_torch.core import perfmodel as TP
from repro_torch.core.config import ModelConfig, get_arch

ARCHS = ["qwen3-8b", "llama-7b", "granite-3-8b", "llama-13b", "opt-175b",
         "deepseek-67b", "deepseek-coder-33b", "grok-1-314b",
         "llama4-scout-17b-a16e"]
HW_NAMES = sorted(TP.HW)


def _cfgs(arch):
    jc = jget_arch(arch)
    tc = ModelConfig(**dataclasses.asdict(jc))
    assert tc == get_arch(arch)
    return jc, tc


def _hw(name):
    """(repro's profile, the port's) of one catalog name; the H100 is the
    port's only, so repro's functions get a repro Hardware of its fields."""
    t = TP.HW[name]
    j = JP.HW.get(name) or JP.Hardware(*dataclasses.astuple(t))
    assert dataclasses.astuple(j) == dataclasses.astuple(t)
    return j, t


def _same(a, b):
    if isinstance(a, float) and math.isinf(a):
        return a == b
    return a == b


def test_h100_profile():
    h = TP.GPU_H100
    assert dataclasses.astuple(h) == ("h100-sxm5-80gb", 989e12, 3.35e12,
                                      80e9, 64e9, 700)
    assert TP.HW["h100-sxm5-80gb"] is h
    # the rest of the catalog is repro's, as data
    for name, hw in JP.HW.items():
        assert dataclasses.astuple(TP.HW[name]) == dataclasses.astuple(hw)
    assert set(TP.HW) == set(JP.HW) | {h.name}


@pytest.mark.parametrize("arch", ARCHS)
def test_workload_terms_match(arch):
    jc, tc = _cfgs(arch)
    assert TP.s_part_params_per_block(tc) == JP.s_part_params_per_block(jc)
    assert TP.s_part_flops_per_token(tc) == JP.s_part_flops_per_token(jc)
    assert TP.r_part_flops_per_cached_token(tc) == \
        JP.r_part_flops_per_cached_token(jc)
    assert TP.phases_per_layer_step(tc) == JP.phases_per_layer_step(jc)
    for bpe, page in ((2, 0), (1, 16), (4, 4)):
        assert TP.r_part_bytes_per_cached_token(tc, bpe, page) == \
            JP.r_part_bytes_per_cached_token(jc, bpe, page)
        assert TP.activation_bytes_per_token_per_block(tc, bpe) == \
            JP.activation_bytes_per_token_per_block(jc, bpe)
        assert TP.kv_cache_bytes(tc, 8, 1024, bpe) == \
            JP.kv_cache_bytes(jc, 8, 1024, bpe)
        assert TP.comm_latency_per_step(tc, 64, 64e9, bpe) == \
            JP.comm_latency_per_step(jc, 64, 64e9, bpe)
    for seq, page in ((0, 16), (1, 16), (17, 16), (512, 16), (100, 4)):
        assert TP.paged_round_up_factor(seq, page) == \
            JP.paged_round_up_factor(seq, page)
    for seq, pre, hit in ((1024, 512, 0.5), (1024, 0, 0.5), (0, 4, 1.0),
                          (100, 400, 1.0), (256, 64, 0.0)):
        assert TP.prefix_dedup_factor(seq, pre, hit) == \
            JP.prefix_dedup_factor(seq, pre, hit)


@pytest.mark.parametrize("name", HW_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_and_orchestration_decisions_match(arch, name):
    jc, tc = _cfgs(arch)
    jh, th = _hw(name)
    for b in (1, 8, 64, 512):
        assert TP.t_of_b(tc, th, b) == JP.t_of_b(jc, jh, b)
        assert TP.e_of_b(tc, th, b) == JP.e_of_b(jc, jh, b)
        assert TP.prefill_chunk_latency(tc, th, b) == \
            JP.prefill_chunk_latency(jc, jh, b)
        for page in (0, 16):
            assert TP.optimal_workers(tc, th, th, b, 1024, page=page) == \
                JP.optimal_workers(jc, jh, jh, b, 1024, page=page)
            assert TP.min_workers_memory(tc, b, 1024, th.mem_cap,
                                         page=page, dedup=0.7) == \
                JP.min_workers_memory(jc, b, 1024, jh.mem_cap, page=page,
                                      dedup=0.7)
            for w in (1, 2, 4):
                assert TP.decode_bubble_per_block(
                    tc, th, th, b, w, 1024, page=page) == \
                    JP.decode_bubble_per_block(jc, jh, jh, b, w, 1024,
                                               page=page)
                assert TP.optimal_prefill_chunk(
                    tc, th, th, b, w, 1024, page=page) == \
                    JP.optimal_prefill_chunk(jc, jh, jh, b, w, 1024,
                                             page=page)
    for page in (0, 16):
        assert TP.r_per_token(tc, th, page=page) == \
            JP.r_per_token(jc, jh, page=page)
    assert TP.knee_batch(tc, th) == JP.knee_batch(jc, jh)
    assert TP.knee_batch(tc, th, rel_gain=0.2) == \
        JP.knee_batch(jc, jh, rel_gain=0.2)
    for slo in (1e-3, 0.5, 5.0, 60.0):
        assert TP.max_batch_for_slo(tc, th, 1024, slo) == \
            JP.max_batch_for_slo(jc, jh, 1024, slo)
    for tokens in (0, 16, 1000):
        assert TP.kv_recompute_time(tc, th, tokens) == \
            JP.kv_recompute_time(jc, jh, tokens)
        for gbps, page in ((0.0, 0), (25.0, 0), (25.0, 16)):
            assert _same(TP.kv_restore_time(tc, tokens, gbps, page=page),
                         JP.kv_restore_time(jc, tokens, gbps, page=page))
    for gbps, page in ((0.0, 0), (1.0, 16), (25.0, 0), (500.0, 16)):
        assert _same(TP.kv_restore_break_even(tc, th, gbps, page=page),
                     JP.kv_restore_break_even(jc, jh, gbps, page=page))


@pytest.mark.parametrize("name", HW_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_matches_for_each_catalog_hardware(arch, name):
    jc, tc = _cfgs(arch)
    jh, th = _hw(name)
    cases = [dict(),
             dict(page=16),
             dict(latency_slo=2.0, page=16),
             dict(page=16, prefix_hit_rate=0.6, prefix_len=256,
                  tier_gbps=25.0),
             dict(spec_alpha=0.7, spec_draft_frac=0.2),
             dict(worker_mem=16e9, page=4)]
    for kw in cases:
        assert TP.plan(tc, th, th, seq_len=1024, **kw) == \
            JP.plan(jc, jh, jh, seq_len=1024, **kw), kw


@pytest.mark.parametrize("arch", ARCHS)
def test_fleet_terms_match(arch):
    jc, tc = _cfgs(arch)
    names = ["a10", "v100", "h100-sxm5-80gb", "epyc-7452"]
    jhs = [_hw(n)[0] for n in names]
    ths = [_hw(n)[1] for n in names]
    for page in (0, 16):
        assert TP.fleet_rates(tc, ths, page=page) == \
            JP.fleet_rates(jc, jhs, page=page)
        assert TP.fleet_shares(tc, ths, page=page) == \
            JP.fleet_shares(jc, jhs, page=page)
        for b in (8, 256):
            assert TP.optimal_workers_hetero(tc, ths[2], ths, b, 1024,
                                             page=page) == \
                JP.optimal_workers_hetero(jc, jhs[2], jhs, b, 1024,
                                          page=page)
    got = TP.plan_hetero(tc, ths[2], ths, 1024, page=16)
    want = JP.plan_hetero(jc, jhs[2], jhs, 1024, page=16)
    assert got == want


@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.8, 1.0])
def test_spec_terms_match(alpha):
    for k in (1, 3, 8):
        assert TP.spec_accepted_per_step(alpha, k) == \
            JP.spec_accepted_per_step(alpha, k)
        assert TP.spec_speedup(alpha, k, 0.1) == \
            JP.spec_speedup(alpha, k, 0.1)
    assert TP.optimal_spec_k(alpha) == JP.optimal_spec_k(alpha)
    assert TP.optimal_spec_k(alpha, 0.4, k_max=4) == \
        JP.optimal_spec_k(alpha, 0.4, k_max=4)


@pytest.mark.parametrize("arch", ARCHS)
def test_orchestration_overhead_matches(arch):
    jc, tc = _cfgs(arch)
    stats = {"steps": 12.0, "dispatch_s": 0.36, "collect_s": 0.5,
             "s_dispatch_s": 1.25, "r_wait_s": 3.0}
    got = TP.calibrate_orchestration(stats, tc, 2, 3)
    want = JP.calibrate_orchestration(stats, jc, 2, 3)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.per_step(tc, 2, 3) == want.per_step(jc, 2, 3)
    later = TP.calibrate_orchestration(dict(stats, collect_s=0.9), tc, 2, 3)
    jlater = JP.calibrate_orchestration(dict(stats, collect_s=0.9), jc, 2, 3)
    assert TP.orchestration_residuals(got, later) == \
        JP.orchestration_residuals(want, jlater)
    zero = TP.OrchestrationOverhead()
    assert TP.orchestration_residuals(zero, later) == \
        JP.orchestration_residuals(JP.OrchestrationOverhead(), jlater)
    jh, th = _hw("h100-sxm5-80gb")
    assert TP.tokens_per_s_with_overhead(tc, th, 64, 2, 3, got) == \
        JP.tokens_per_s_with_overhead(jc, jh, 64, 2, 3, want)


def test_h100_plan_for_qwen3_8b():
    """The prediction the port's serves are read against: Qwen3-8B at
    seq_len 1024 on the H100 spec sheet (a prediction, not a
    measurement)."""
    cfg = get_arch("qwen3-8b")
    p = TP.plan(cfg, TP.GPU_H100, TP.GPU_H100, seq_len=1024, page=16)
    assert p["batch"] == 512 and p["workers"] == 2
    assert p["tokens_per_s"] == pytest.approx(35597.2, rel=1e-5)
    t8 = TP.t_of_b(cfg, TP.GPU_H100, 8)
    assert t8 == pytest.approx(1.1519e-4, rel=1e-3)
    assert 8 / (2 * cfg.num_layers * t8) == pytest.approx(964.6, rel=1e-3)
