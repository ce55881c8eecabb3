"""DeepSeek-Coder-33B — dense llama-arch [arXiv:2401.14196]."""
from repro_torch.core.config import ATTN, FFN_SWIGLU, ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="deepseek-coder-33b",
    arch_type="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    layer_pattern=(ATTN,),
    ffn_kind=FFN_SWIGLU,
    rope_theta=100_000.0,
    source="arXiv:2401.14196",
))
