"""Granite-3.0-8B — dense GQA with tied embeddings
[hf:ibm-granite/granite-3.0-2b-base family]."""
from repro_torch.core.config import ATTN, FFN_SWIGLU, ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="granite-3-8b",
    arch_type="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    layer_pattern=(ATTN,),
    ffn_kind=FFN_SWIGLU,
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base",
))
