"""Llama-3.2-Vision-90B — VLM with cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision, scaled].

The vision encoder is a STUB: the caller gives precomputed patch
embeddings [B, encoder_seq, d_model]; every 5th layer is a gated
cross-attention layer reading them (static KV, computed once at prefill,
never grows, held on the R-side like a frozen KV-cache prefix).
"""
from repro_torch.core.config import (ATTN, FFN_SWIGLU, XATTN, ModelConfig,
                                     register_arch)

CONFIG = register_arch(ModelConfig(
    name="llama-3.2-vision-90b",
    arch_type="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    # period of 5: four self-attn layers then one cross-attn layer
    layer_pattern=(ATTN, ATTN, ATTN, ATTN, XATTN),
    ffn_kind=FFN_SWIGLU,
    rope_theta=500_000.0,
    frontend="vision_stub",
    encoder_seq=1600,        # patch embeddings from the stub ViT
    source="hf:meta-llama/Llama-3.2-11B-Vision",
))
