"""Token selection for the port's serving engine: greedy decoding and
stop-token handling (counterpart of repro.serving.sampler).

Sampled decoding (temperature / top-k / top-p) and the speculative
rejection sampler are not ported yet; see ROADMAP.md.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch


def sample(logits, temperature: float = 0.0) -> torch.Tensor:
    """logits [B, V] -> greedy tokens [B] int32."""
    if temperature > 0.0:
        raise NotImplementedError(
            "sampled decoding is not ported yet (see ROADMAP.md); use "
            "temperature=0 (greedy)")
    return torch.argmax(logits, dim=-1).to(torch.int32)


def is_stop_token(token: int, eos_token: Optional[int] = None,
                  stop_tokens: Iterable[int] = ()) -> bool:
    """Whether ``token`` terminates generation: the model's EOS or any
    per-request stop token."""
    if eos_token is not None and token == eos_token:
        return True
    return token in stop_tokens if stop_tokens else False
