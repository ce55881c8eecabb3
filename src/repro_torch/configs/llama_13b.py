"""Llama-13B — the paper's second evaluation model [arXiv:2302.13971]."""
from repro_torch.core.config import ATTN, FFN_SWIGLU, ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="llama-13b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=13824,
    vocab_size=32000,
    layer_pattern=(ATTN,),
    ffn_kind=FFN_SWIGLU,
    source="arXiv:2302.13971 (paper eval model)",
))
