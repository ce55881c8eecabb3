"""RecurrentGemma-2B — hybrid RG-LRU + local attention, 2:1 [arXiv:2402.19427].

Pattern: (rglru, rglru, attn) repeating; local attention window 2048;
single KV head (MQA).  26 layers = 8 full periods + a 2-layer remainder
(rglru, rglru), matching the released model's trailing recurrent blocks.
"""
from repro_torch.core.config import (ModelConfig, register_arch, ATTN, RGLRU,
                               FFN_MLP)

CONFIG = register_arch(ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,          # MQA
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    layer_pattern=(RGLRU, RGLRU, ATTN),
    ffn_kind=FFN_MLP,        # gemma uses geglu; plain gelu MLP here
    window=2048,             # local attention window
    rnn_width=2560,
    conv_width=4,
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="arXiv:2402.19427",
))
