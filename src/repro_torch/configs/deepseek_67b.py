"""DeepSeek-67B — dense llama-arch [arXiv:2401.02954]."""
from repro_torch.core.config import ATTN, FFN_SWIGLU, ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="deepseek-67b",
    arch_type="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,          # GQA
    d_ff=22016,
    vocab_size=102400,
    layer_pattern=(ATTN,),
    ffn_kind=FFN_SWIGLU,
    rope_theta=10_000.0,
    source="arXiv:2401.02954",
))
