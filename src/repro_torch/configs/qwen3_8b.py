"""Qwen3-8B — dense GQA with QK-norm [hf:Qwen/Qwen3-8B]."""
from repro_torch.core.config import ATTN, FFN_SWIGLU, ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="qwen3-8b",
    arch_type="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    layer_pattern=(ATTN,),
    ffn_kind=FFN_SWIGLU,
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
))
