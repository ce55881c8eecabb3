"""Each roofline and FLOP count against hand-worked shapes: OPT-175B's
(MHA, GELU MLP) from its committed file, and DeepSeek-67B's (GQA, SwiGLU)
for the family's other branch."""
import json
from pathlib import Path

import pytest

from fdbench.families import dense_decoder as FAM
from fdbench.roofline import model_step, paged_attn

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


# DeepSeek-LLM-67B's published widths at 8 of 95 layers
DEEPSEEK = {"hidden_size": 8192, "num_attention_heads": 64,
            "num_key_value_heads": 8, "head_dim": 128,
            "intermediate_size": 22016, "vocab_size": 102400,
            "num_hidden_layers": 8, "hidden_act": "silu"}


def _sizes(name):
    if name == "deepseek-67b.s8":
        return FAM.sizes(DEEPSEEK)
    return FAM.sizes(json.loads((CONFIGS / f"{name}.json").read_text()))


def test_matrix_params_by_hand():
    opt, ds = _sizes("opt-175b.s8"), _sizes("deepseek-67b.s8")
    # OPT: 4 d^2 (MHA) + 2 d ff (GELU MLP)
    assert model_step.layer_matrix_params(opt) \
        == 4 * 12288 ** 2 + 2 * 12288 * 49152 == 1_811_939_328
    # DeepSeek: 2 d^2 + 2 d (8 x 128) (GQA) + 3 d ff (SwiGLU)
    assert model_step.layer_matrix_params(ds) \
        == 2 * 8192 ** 2 + 2 * 8192 * 1024 + 3 * 8192 * 22016 == 692_060_160
    assert model_step.head_params(opt) == 12288 * 50272
    assert model_step.head_params(ds) == 8192 * 102400


def test_config_files_state_their_bytes():
    for path in sorted(CONFIGS.glob("*.json")):
        cfg = json.loads(path.read_text())
        s = FAM.sizes(cfg)
        mem = cfg["memory"]
        assert mem["layer_params"] == model_step.layer_matrix_params(s)
        assert mem["layers_bytes"] == 2 * 8 * mem["layer_params"]
        assert mem["embed_and_head_bytes"] == 2 * 2 * s["vocab"] * s["d"]
        assert mem["kv_bytes_per_token"] == 2 * s["hkv"] * s["dh"] * 2 * 8
        assert FAM.weight_bytes(cfg) \
            == mem["layers_bytes"] + mem["embed_and_head_bytes"]


def test_decode_flops_by_hand():
    opt = _sizes("opt-175b.s8")
    mats = 2 * (1_811_939_328 * 8 + 12288 * 50272)
    attn = 4 * 96 * 128 * 8 * 1000
    assert model_step.decode_flops(opt, 1000) == mats + attn \
        == 30_619_729_920
    ds = _sizes("deepseek-67b.s8")
    assert model_step.decode_flops(ds, 2000) \
        == 2 * (692_060_160 * 8 + 8192 * 102400) + 4 * 64 * 128 * 8 * 2000


def test_prefill_flops_by_hand():
    ds = _sizes("deepseek-67b.s8")
    p = 512
    want = (2 * 692_060_160 * 8 * p            # every prompt token
            + 4 * 64 * 128 * 8 * p * (p + 1) // 2   # causal attention
            + 2 * 8192 * 102400)             # the head at the last token
    assert model_step.prefill_flops(ds, p) == want


def test_kernel1_launch_by_hand():
    # OPT heads (G 1): two rows of 1000 and 24 valid positions among 16
    flops, nbytes = paged_attn.launch(96, 96, 128, [1000, 24], 16)
    assert flops == 4 * 96 * 128 * 1024 == 50_331_648
    kv = 1024 * 2 * 96 * 128 * 2
    table = (63 + 2) * 4
    qo = 2 * 16 * 96 * 128 * 2
    assert nbytes == kv + table + qo == 51_118_340
    # DeepSeek heads (G 8): one row of 2048 among 128
    flops, nbytes = paged_attn.launch(64, 8, 128, [2048], 128)
    assert flops == 67_108_864
    assert nbytes == 2048 * 2 * 8 * 128 * 2 + 128 * 4 \
        + 2 * 128 * 64 * 128 * 2 == 12_583_424
    # an empty launch still reads q and writes out
    assert paged_attn.launch(64, 8, 128, [], 128) \
        == (0.0, 2 * 128 * 64 * 128 * 2)


def test_least_time_is_the_larger_bound():
    f, b = paged_attn.launch(96, 96, 128, [1000, 24], 16)
    t = paged_attn.least_seconds(f, b, 989e12, 3.35e12)
    assert t == pytest.approx(51_118_340 / 3.35e12)
    assert paged_attn.least_seconds(1e15, 1.0, 989e12, 3.35e12) \
        == pytest.approx(1e15 / 989e12)
