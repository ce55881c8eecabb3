"""Llama-7B — the paper's main evaluation model [arXiv:2302.13971]."""
from repro_torch.core.config import ATTN, FFN_SWIGLU, ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="llama-7b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    layer_pattern=(ATTN,),
    ffn_kind=FFN_SWIGLU,
    source="arXiv:2302.13971 (paper eval model)",
))
