"""Token selection for the port's serving engine: greedy decoding, the
greedy speculative-decode accept walk and stop-token handling
(counterpart of repro.serving.sampler).

Sampled decoding (temperature / top-k / top-p) and the sampled branch of
the speculative rejection sampler are not ported yet; see ROADMAP.md.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch


def sample(logits, temperature: float = 0.0) -> torch.Tensor:
    """logits [B, V] -> greedy tokens [B] int32."""
    if temperature > 0.0:
        raise NotImplementedError(
            "sampled decoding is not ported yet (see ROADMAP.md); use "
            "temperature=0 (greedy)")
    return torch.argmax(logits, dim=-1).to(torch.int32)


def spec_accept(logits, draft: Sequence[int], temperature: float = 0.0
                ) -> Tuple[List[int], int]:
    """The speculative-decode accept walk for a greedy request: draft token
    d_j is kept iff it is the argmax of the target logits at offset j;
    the first mismatch commits the target's argmax in its place, and a
    fully accepted draft commits one bonus token from the last offset.
    Bit-exact with non-speculative greedy decoding.

    logits [k+1, V] (offset j scores the token after d_1..d_j); draft
    [k].  Returns (tokens, accepted): ``tokens`` (length accepted + 1) is
    the committed continuation, ``accepted`` the kept draft tokens."""
    if temperature > 0.0:
        raise NotImplementedError(
            "sampled speculative acceptance is not ported yet (see "
            "ROADMAP.md); use temperature=0 (greedy)")
    am = [int(t) for t in torch.argmax(torch.as_tensor(logits),
                                       dim=-1).tolist()]
    tokens: List[int] = []
    for j, d in enumerate(draft):
        if am[j] != int(d):
            return tokens + [am[j]], j
        tokens.append(int(d))
    return tokens + [am[len(draft)]], len(draft)


def is_stop_token(token: int, eos_token: Optional[int] = None,
                  stop_tokens: Iterable[int] = ()) -> bool:
    """Whether ``token`` terminates generation: the model's EOS or any
    per-request stop token."""
    if eos_token is not None and token == eos_token:
        return True
    return token in stop_tokens if stop_tokens else False
