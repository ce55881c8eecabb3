"""Whisper-medium — encoder-decoder audio backbone [arXiv:2212.04356].

The mel-spectrogram + conv feature extractor is a STUB: the caller gives
precomputed frame embeddings [B, 1500, d_model] to the encoder.  The
decoder (the part the pipeline serves) has per-layer self-attention
(with a KV cache) and cross-attention to the encoder output (a static
KV slab held R-side).  kv_heads == num_heads (MHA).
"""
from repro_torch.core.config import (DEC_XATTN, FFN_MLP, ModelConfig,
                                     register_arch)

CONFIG = register_arch(ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    num_layers=24,           # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,         # MHA
    d_ff=4096,
    vocab_size=51865,
    layer_pattern=(DEC_XATTN,),
    ffn_kind=FFN_MLP,
    encoder_layers=24,
    encoder_seq=1500,
    frontend="audio_stub",
    rope_theta=10_000.0,     # backbone uses rope here (orig: learned abs pos)
    tie_embeddings=True,
    source="arXiv:2212.04356",
))
