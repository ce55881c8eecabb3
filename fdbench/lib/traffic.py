"""The one traffic generator: reads a mix file's parameters and makes the
requests of a run from ``--seed``.

Lengths are stratified: each block of ``block`` requests holds the same
``block`` quantiles of the mix's prompt and output distributions, in an
order drawn from the seed.  So every seed offers the same work and
differs only in the order, and a window sees the distributions whole.
Token ids are uniform over the vocabulary, drawn per request.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass
class Spec:
    """One request: ``prompt_len`` tokens in, ``out_len`` out."""
    rid: int
    prompt_len: int
    out_len: int


def inverse_cdf(dist: Dict, u: float) -> int:
    """The length at quantile ``u`` (0 < u < 1) of a ``uniform`` length
    distribution over [lo, hi]."""
    if dist["dist"] != "uniform":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return int(dist["lo"] + math.floor(u * (dist["hi"] - dist["lo"] + 1)))


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


class Stream:
    """The seeded, endless list of a mix's requests, made block by block."""

    def __init__(self, mix: Dict, seed: int):
        self.mix = mix
        self.block = int(mix.get("block", 64))
        self.rng = np.random.default_rng([int(seed), 0x7AFF1C])
        self._buf: List[Spec] = []
        self._rid = 0

    def _fill(self) -> None:
        u = _quantiles(self.block)
        plen = [inverse_cdf(self.mix["prompt"], x)
                for x in self.rng.permutation(u)]
        olen = [inverse_cdf(self.mix["output"], x)
                for x in self.rng.permutation(u)]
        for p, o in zip(plen, olen):
            self._buf.append(Spec(self._rid, p, o))
            self._rid += 1

    def next(self) -> Spec:
        if not self._buf:
            self._fill()
        return self._buf.pop(0)

    def take(self, n: int) -> List[Spec]:
        return [self.next() for _ in range(n)]

    def steady(self, n: int) -> List[Spec]:
        """``n`` requests for a closed loop's first rows, started in steady
        state: each prompt already holds a share of its output (shares at
        stratified quantiles, in a seeded order), and the request
        generates the rest."""
        out = []
        for s, share in zip(self.take(n), self.rng.permutation(_quantiles(n))):
            pre = min(int(share * s.out_len), s.out_len - 1)
            out.append(Spec(s.rid, s.prompt_len + pre, s.out_len - pre))
        return out


def prompt_tokens(seed: int, rid: int, n: int, vocab: int) -> np.ndarray:
    """The prompt of request ``rid``: ``n`` ids uniform over [0, vocab)."""
    rng = np.random.default_rng([int(seed), 0x70C3, int(rid)])
    return rng.integers(0, vocab, size=n, dtype=np.int64).astype(np.int32)
