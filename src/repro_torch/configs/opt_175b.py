"""OPT-175B — the paper's large evaluation model [arXiv:2205.01068]."""
from repro_torch.core.config import ATTN, FFN_MLP, ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="opt-175b",
    arch_type="dense",
    num_layers=96,
    d_model=12288,
    num_heads=96,
    num_kv_heads=96,
    d_ff=49152,
    vocab_size=50272,
    layer_pattern=(ATTN,),
    ffn_kind=FFN_MLP,
    source="arXiv:2205.01068 (paper eval model)",
))
