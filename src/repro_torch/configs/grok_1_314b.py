"""Grok-1 314B — MoE, 8 experts top-2, attention logit soft-capping
[hf:xai-org/grok-1]."""
from repro_torch.core.config import ATTN, FFN_MOE, ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    layer_pattern=(ATTN,),
    ffn_kind=FFN_MOE,
    num_experts=8,
    top_k=2,
    moe_capacity=1.25,   # production capacity factor
    router_aux_loss=0.01,
    attn_logit_softcap=30.0,
    rope_theta=10_000.0,
    source="hf:xai-org/grok-1",
))
