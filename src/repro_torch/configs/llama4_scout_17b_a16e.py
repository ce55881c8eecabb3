"""Llama-4-Scout 17B-active / 16 experts — MoE top-1, early-fusion multimodal
[hf:meta-llama/Llama-4-Scout-17B-16E].

Early fusion: the vision frontend is a STUB — ``input_specs`` provides patch
embeddings that are concatenated with token embeddings at the model input
(no cross-attention layers).
"""
from repro_torch.core.config import ATTN, FFN_MOE, ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    layer_pattern=(ATTN,),
    ffn_kind=FFN_MOE,
    num_experts=16,
    top_k=1,
    moe_capacity=1.25,   # production capacity factor
    router_aux_loss=0.01,
    qk_norm=True,
    rope_theta=500_000.0,
    frontend="vision_stub",  # early fusion: embeddings prepended to tokens
    encoder_seq=64,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))
