"""The frozen reference against the port at a reduced float32 size of
each block family (SwiGLU with GQA; tanh-GELU MLP with MHA), on weights
the benchmark's own family code draws; the weights come in the layout
the port's engine takes; the fp8 control reads differently."""
import pytest
import torch

from fdbench.families import dense_decoder as FAM
from fdbench.reference import dense_decoder as REF
from repro_torch.models import model as M


def _cfg(act, hkv):
    return {"name": f"tiny-{act}", "source": "test", "family": "dense_decoder",
            "reference": "dense_decoder", "hidden_size": 64,
            "num_attention_heads": 4, "num_key_value_heads": hkv,
            "head_dim": 16, "intermediate_size": 96, "vocab_size": 128,
            "num_hidden_layers": 3, "hidden_act": act,
            "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
            "torch_dtype": "float32"}


@pytest.mark.parametrize("act,hkv", [("silu", 2), ("gelu_tanh", 4)])
def test_reference_matches_the_port_in_fp32(act, hkv):
    cfg = _cfg(act, hkv)
    params = FAM.make_weights(cfg, 12345, "cpu")
    mcfg = FAM.program_config(cfg)
    tokens = torch.randint(0, 128, (2, 37), generator=torch.Generator()
                           .manual_seed(0))
    with torch.no_grad():
        want, _ = M.train_forward(params, mcfg, tokens)
    got = REF.logits(params, cfg, list(tokens), [0, 5])
    assert torch.allclose(got[0], want[0], atol=2e-5, rtol=1e-4)
    assert torch.allclose(got[1], want[1, 5:], atol=2e-5, rtol=1e-4)
    fp8 = REF.logits(params, cfg, list(tokens), [0, 0], quant="fp8")
    assert (fp8[0] - got[0]).abs().max() > 1e-3


@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
def test_weights_in_the_engines_layout(act):
    cfg = dict(_cfg(act, 2), torch_dtype="bfloat16")
    params = FAM.make_weights(cfg, 1, "cpu")
    want = M.param_shapes(FAM.program_config(cfg))

    def flat(t, pre=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from flat(v, pre + "/" + k)
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from flat(v, f"{pre}/{i}")
        else:
            yield pre, (tuple(t.shape), t.dtype)
    assert dict(flat(params)) == dict(flat(want))


def test_weights_repeat_by_seed():
    cfg = dict(_cfg("silu", 2), torch_dtype="bfloat16")
    a = FAM.make_weights(cfg, 2 ** 40 + 3, "cpu")
    b = FAM.make_weights(cfg, 2 ** 40 + 3, "cpu")
    c = FAM.make_weights(cfg, 2 ** 40 + 4, "cpu")
    assert torch.equal(a["stack"]["s0"]["wq"], b["stack"]["s0"]["wq"])
    assert not torch.equal(a["stack"]["s0"]["wq"], c["stack"]["s0"]["wq"])
    std = a["stack"]["s0"]["wq"].float().std().item()
    assert 0.018 < std < 0.022
