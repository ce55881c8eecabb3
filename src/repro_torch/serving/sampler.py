"""Token sampling (greedy / temperature / top-k / top-p), the speculative-
decode rejection sampler and stop-token handling for the port's serving
engine (counterpart of repro.serving.sampler).

``top_p`` (nucleus sampling, Holtzman et al. 2019) keeps the smallest
set of tokens whose cumulative probability reaches ``p`` and renormalizes
over it, composing with ``top_k`` (k-filter first, then the nucleus) and
``temperature`` (applied before both).

Every draw comes from an explicit ``torch.Generator`` that the caller
passes (the serving engine owns one, seeded by its ``seed``): no global
RNG is touched.  A categorical draw is Gumbel-max over the filtered
logits (``jax.random.categorical``'s method), one uniform per (row,
token); the draws are exact in distribution, not the JAX streams.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch


def _filter_logits(logits, top_k: int, top_p: float):
    """Apply the top-k then top-p filters to (already temperature-scaled)
    logits [B, V], marking dropped tokens -inf.

    top-k keeps EVERY token whose logit equals the k-th largest (so more
    than k may stay; ``top_k >= V`` keeps everything).  top-p keeps a
    token iff its logit is >= the smallest logit of the nucleus (the
    descending prefix whose exclusive cumulative mass is < p): ties at
    the nucleus edge all stay.  Both compare logit VALUES, never sorted
    positions, so the result does not depend on how a sort orders
    ties."""
    v = logits.shape[-1]
    if top_k > 0:
        k = min(int(top_k), v)
        kth = torch.sort(logits, dim=-1).values[:, v - k][:, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if 0.0 < top_p < 1.0:
        desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # the argmax token is always kept: its exclusive mass is 0
        keep = (cum - probs) < top_p
        thresh = torch.where(keep, desc, float("inf")).amin(dim=-1,
                                                            keepdim=True)
        logits = torch.where(logits < thresh, float("-inf"), logits)
    return logits


def _gumbel_argmax(logits, generator: Optional[torch.Generator]):
    """One categorical draw per row of ``logits`` [B, V] (-inf = never):
    argmax of logits + Gumbel noise from ``generator``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    g = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() + g, dim=-1)


def sample(logits, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0, top_k: int = 0,
           top_p: float = 0.0) -> torch.Tensor:
    """logits [B, V] -> tokens [B] int32.

    temperature <= 0 is greedy (argmax; ``generator`` unused); otherwise
    logits/temperature are filtered by top-k and top-p
    (:func:`_filter_logits`) and one token per row is drawn from
    ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("sampled decoding needs a torch.Generator")
    lg = _filter_logits(logits.float() / temperature, top_k, top_p)
    return _gumbel_argmax(lg, generator).to(torch.int32)


def target_probs(logits, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0) -> torch.Tensor:
    """The exact distribution :func:`sample` draws from, as probabilities
    [B, V] float32: the rejection sampler's target.  temperature <= 0 is
    a one-hot at the argmax."""
    if temperature <= 0.0:
        return torch.nn.functional.one_hot(
            torch.argmax(logits, dim=-1), logits.shape[-1]).to(torch.float32)
    lg = _filter_logits(logits.float() / temperature, top_k, top_p)
    return torch.softmax(lg, dim=-1)


def spec_accept(logits, draft: Sequence[int],
                generator: Optional[torch.Generator] = None,
                temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0
                ) -> Tuple[List[int], int]:
    """Modified rejection sampling for speculative decoding (Leviathan et
    al. 2023) against a GREEDY drafter (the draft distribution is a point
    mass at each drafted token):

      * draft token d_j is accepted with probability p(d_j), p being the
        request's sampling distribution (temperature/top-k/top-p);
      * on rejection the committed token is drawn from the residual, p
        with d_j removed and renormalized;
      * a fully accepted draft commits one bonus token drawn from p at
        the last offset.

    Each committed token is distributed exactly as a :func:`sample` call
    at its position.  Greedy requests (temperature <= 0) take the
    deterministic walk: d_j kept iff it is the argmax at offset j, the
    first mismatch commits the argmax, bit-exact with spec-off greedy
    decoding, and ``generator`` is not touched.

    The sampled walk draws a fixed set from ``generator`` on the logits'
    device, in one go: k uniforms for the accept tests, then Gumbel noise
    [k+1, V] for the k residual draws and the bonus; one copy brings the
    outcomes to the host, and the walk uses the ones it needs.

    logits [k+1, V] (offset j scores the token after d_1..d_j); draft
    [k].  Returns (tokens, accepted): ``tokens`` (length accepted + 1) is
    the committed continuation, ``accepted`` the kept draft tokens."""
    logits = torch.as_tensor(logits)
    k = len(draft)
    if temperature <= 0.0:
        am = [int(t) for t in torch.argmax(logits, dim=-1).tolist()]
        tokens: List[int] = []
        for j, d in enumerate(draft):
            if am[j] != int(d):
                return tokens + [am[j]], j
            tokens.append(int(d))
        return tokens + [am[k]], k
    if generator is None:
        raise ValueError("sampled speculative acceptance needs a "
                         "torch.Generator")
    p = target_probs(logits, temperature, top_k, top_p)      # [k+1, V]
    dev = p.device
    d = torch.as_tensor([int(t) for t in draft], dtype=torch.long,
                        device=dev)
    rows = torch.arange(k, device=dev)
    accept = torch.rand((k,), generator=generator, device=dev) < p[rows, d]
    resid = p.clone()
    resid[rows, d] = 0.0
    # rows 0..k-1: a residual draw each; row k: the bonus from p
    alt = _gumbel_argmax(torch.log(resid), generator)
    acc_h, alt_h = accept.tolist(), alt.tolist()
    tokens = []
    for j in range(k):
        if acc_h[j]:
            tokens.append(int(draft[j]))
            continue
        return tokens + [int(alt_h[j])], j
    return tokens + [int(alt_h[k])], k


def is_stop_token(token: int, eos_token: Optional[int] = None,
                  stop_tokens: Iterable[int] = ()) -> bool:
    """Whether ``token`` terminates generation: the model's EOS or any
    per-request stop token."""
    if eos_token is not None and token == eos_token:
        return True
    return token in stop_tokens if stop_tokens else False
