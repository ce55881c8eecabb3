"""Model configuration of the port (its own copy of repro.core.config).

The fields, ``reduced()`` and the registry match the JAX package's, so a
config built from ``dataclasses.asdict`` of a reference config is the
same config here.  It registers the dense pure-attention archs the port
serves: ``qwen3-8b``, ``llama-7b``, ``granite-3-8b``, the paper's
evaluation models ``llama-13b`` and ``opt-175b``, ``deepseek-67b`` and
``deepseek-coder-33b``, the mixture-of-experts models ``grok-1-314b``
and ``llama4-scout-17b-a16e``, and the recurrent models
``recurrentgemma-2b`` (RG-LRU blocks with windowed attention every third
layer) and ``mamba2-2.7b`` (SSD blocks), and the cross-attention models
``llama-3.2-vision-90b`` (a gated XATTN layer every fifth) and
``whisper-medium`` (an encoder and DEC_XATTN decoder blocks): all 13 of
the JAX package's configs.  The model runs the ATTN mixer with a SwiGLU,
a GELU MLP or a capacity-dispatched MoE FFN, the RG-LRU and SSD mixers,
and cross-attention against static encoder or patch features.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Dict, List, Tuple

ATTN = "attn"          # causal self attention (GQA, optional qk_norm / window)
XATTN = "xattn"
RGLRU = "rglru"
SSD = "ssd"
ENC_ATTN = "enc_attn"
DEC_XATTN = "dec_xattn"

MIXER_KINDS = (ATTN, XATTN, RGLRU, SSD, ENC_ATTN, DEC_XATTN)

FFN_MLP = "mlp"
FFN_SWIGLU = "swiglu"
FFN_MOE = "moe"
FFN_NONE = "none"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // num_heads
    layer_pattern: Tuple[str, ...] = (ATTN,)
    ffn_kind: str = FFN_SWIGLU
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: int = 0                    # 0 = full causal; >0 = sliding window
    attn_logit_softcap: float = 0.0
    num_experts: int = 0
    top_k: int = 0
    router_aux_loss: float = 0.0
    moe_capacity: float = 2.0
    rnn_width: int = 0
    conv_width: int = 4
    ssm_state: int = 0
    ssd_head_dim: int = 64
    ssd_expand: int = 2
    ssd_chunk: int = 256
    encoder_layers: int = 0
    encoder_seq: int = 0
    encoder_d_model: int = 0
    frontend: str = "none"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.rnn_width == 0:
            object.__setattr__(self, "rnn_width", self.d_model)
        if self.encoder_d_model == 0:
            object.__setattr__(self, "encoder_d_model", self.d_model)
        if self.ffn_kind not in (FFN_MLP, FFN_SWIGLU, FFN_MOE, FFN_NONE):
            raise ValueError(f"unknown ffn_kind {self.ffn_kind!r}")
        for k in self.layer_pattern:
            if k not in MIXER_KINDS:
                raise ValueError(f"unknown mixer kind {k!r}")

    @property
    def pattern(self) -> Tuple[str, ...]:
        """Per-layer mixer kinds, length == num_layers."""
        p = self.layer_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def d_inner(self) -> int:          # mamba2
        return self.ssd_expand * self.d_model

    @property
    def ssd_heads(self) -> int:
        return self.d_inner // self.ssd_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS=6ND)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd, nh, nkv = self.head_dim, self.num_heads, self.num_kv_heads
        total = v * d                                   # embed
        if not self.tie_embeddings:
            total += v * d                              # lm head
        for kind in self.pattern:
            if kind in (ATTN, ENC_ATTN):
                total += d * nh * hd + 2 * d * nkv * hd + nh * hd * d
            elif kind == XATTN:
                total += d * nh * hd + 2 * d * nkv * hd + nh * hd * d
            elif kind == DEC_XATTN:
                total += 2 * (d * nh * hd + 2 * d * nkv * hd + nh * hd * d)
            elif kind == RGLRU:
                w = self.rnn_width
                total += 2 * d * w + w * d + self.conv_width * w + 2 * w * w + 2 * w
            elif kind == SSD:
                di, n, h = self.d_inner, self.ssm_state, self.ssd_heads
                total += d * (2 * di + 2 * n + h) + di * d + self.conv_width * (di + 2 * n)
            if kind == SSD or self.ffn_kind == FFN_NONE:
                continue
            if self.ffn_kind == FFN_SWIGLU:
                total += 3 * d * f
            elif self.ffn_kind == FFN_MLP:
                total += 2 * d * f
            elif self.ffn_kind == FFN_MOE:
                total += self.num_experts * 3 * d * f + d * self.num_experts
        if self.encoder_layers:
            ed = self.encoder_d_model
            total += self.encoder_layers * (4 * ed * ed + 2 * ed * self.d_ff)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE uses top_k of num_experts)."""
        if self.ffn_kind != FFN_MOE:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense = self.param_count() - self.num_layers * self.num_experts * 3 * d * f
        return dense + self.num_layers * self.top_k * 3 * d * f

    def reduced(self, layers: int = 2, d_model: int = 256,
                experts: int = 4, vocab: int = 512) -> "ModelConfig":
        """Tiny same-family variant for CPU tests (the reference's rule:
        heads capped at 4/4, so GQA needs an explicit num_kv_heads)."""
        ratio = d_model / self.d_model
        nh = max(2, min(self.num_heads, 4))
        nkv = max(1, min(self.num_kv_heads, nh))
        while nh % nkv:
            nkv -= 1
        layers = max(layers, len(self.layer_pattern))
        kw: Dict = dict(
            name=self.name + "-smoke",
            num_layers=layers,
            d_model=d_model,
            num_heads=nh,
            num_kv_heads=nkv,
            head_dim=d_model // nh,
            d_ff=max(64, int(self.d_ff * ratio)) if self.d_ff else 0,
            vocab_size=vocab,
            rnn_width=d_model,
            window=min(self.window, 64) if self.window else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssd_head_dim=min(self.ssd_head_dim, 32),
            ssd_chunk=16,
            num_experts=min(self.num_experts, experts) if self.num_experts else 0,
            top_k=min(self.top_k, min(self.num_experts, experts)) if self.top_k else 0,
            moe_capacity=float(max(1, min(self.num_experts, experts))),
            encoder_layers=min(self.encoder_layers, 2) if self.encoder_layers else 0,
            encoder_seq=min(self.encoder_seq, 16) if self.encoder_seq else 0,
            encoder_d_model=d_model if self.encoder_layers else 0,
            dtype="float32",
        )
        return replace(self, **kw)


def check_supported(cfg: ModelConfig) -> None:
    """The port runs every decoder kind (self-attention, RG-LRU, SSD, the
    gated XATTN and the DEC_XATTN blocks) and an encoder of ENC_ATTN
    blocks; every block but an SSD one needs an FFN (SwiGLU, MLP or
    MoE).  An encoder layer inside the decoder's pattern is refused, as
    the JAX package only builds it under ``params["encoder"]``."""
    if ENC_ATTN in cfg.layer_pattern:
        raise NotImplementedError(
            f"{cfg.name}: ENC_ATTN blocks run only in the encoder "
            f"(encoder_layers), not in the decoder's layer_pattern")
    if cfg.ffn_kind == FFN_NONE and any(k != SSD for k in cfg.layer_pattern):
        raise NotImplementedError(
            f"{cfg.name}: only SSD blocks run without an FFN")


@dataclass(frozen=True)
class ShapeConfig:
    """An input shape of the dry-run: one entry point at one size."""
    name: str
    seq_len: int
    global_batch: int
    mode: str            # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


_ARCHS: Dict[str, ModelConfig] = {}
_ARCH_MODULES = [
    "deepseek_67b", "granite_3_8b", "deepseek_coder_33b", "qwen3_8b",
    # the paper's own evaluation models
    "llama_7b", "llama_13b", "opt_175b",
    # mixture of experts
    "grok_1_314b", "llama4_scout_17b_a16e",
    # recurrent mixers
    "recurrentgemma_2b", "mamba2_2_7b",
    # cross-attention: a vision model and an encoder-decoder
    "llama_3_2_vision_90b", "whisper_medium",
]


def register_arch(cfg: ModelConfig) -> ModelConfig:
    _ARCHS[cfg.name] = cfg
    return cfg


def _ensure_loaded() -> None:
    if _ARCHS:
        return
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def get_arch(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_ARCHS)}")
    return _ARCHS[name]


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_ARCHS)


# the dry-run's archs (the paper's three evaluation models are not among
# them) and the (arch, shape) pairs it skips, with the reason
ASSIGNED_ARCHS = [
    "deepseek-67b", "granite-3-8b", "deepseek-coder-33b", "llama-3.2-vision-90b",
    "qwen3-8b", "grok-1-314b", "recurrentgemma-2b", "mamba2-2.7b",
    "llama4-scout-17b-a16e", "whisper-medium",
]

SKIPS: Dict[Tuple[str, str], str] = {
    ("whisper-medium", "long_500k"):
        "enc-dec full-attention decoder; 524k generated tokens is semantically "
        "void for ASR",
}
