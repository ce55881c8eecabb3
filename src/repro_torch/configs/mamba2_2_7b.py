"""Mamba2-2.7B — attention-free SSM with SSD (state-space duality)
[arXiv:2405.21060]."""
from repro_torch.core.config import ModelConfig, register_arch, SSD, FFN_NONE

CONFIG = register_arch(ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,             # attention-free
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=(SSD,),
    ffn_kind=FFN_NONE,
    ssm_state=128,           # N
    ssd_head_dim=64,         # P  -> heads = 2*2560/64 = 80
    ssd_expand=2,
    ssd_chunk=256,
    conv_width=4,
    tie_embeddings=True,
    source="arXiv:2405.21060",
))
