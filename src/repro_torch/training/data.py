"""Deterministic synthetic LM data pipeline (no corpora needed): a copy of
the JAX package's ``training/data.py`` (numpy only), same batches for
the same ``DataConfig``.

The stream is learnable-but-nontrivial: a mixture of
  * a Zipf-ish unigram distribution (captures the easy mass),
  * first-order Markov structure (bigram table),
  * periodic copy/induction patterns (rewards real sequence modeling),
so a 100M-scale model's loss drops well below the unigram entropy within a
few hundred steps — giving the training example something real to show.

Also supports memory-mapped token files for real corpora (``file=``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    file: Optional[str] = None         # optional np.memmap int32 token file


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # zipf unigram
        ranks = np.arange(1, v + 1)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # sparse-ish bigram: each token has ~8 likely successors
        self.succ = rng.integers(0, v, size=(v, 8))
        self.rng = rng

    def _gen_doc(self, n: int) -> np.ndarray:
        rng = self.rng
        out = np.empty(n, np.int32)
        t = int(rng.choice(self.cfg.vocab_size, p=self.unigram))
        i = 0
        while i < n:
            mode = rng.random()
            if mode < 0.15 and i > 16:
                # induction: copy a recent span
                span = int(rng.integers(4, 12))
                start = int(rng.integers(max(0, i - 16), max(1, i - span)))
                span = min(span, n - i, i - start)
                out[i:i + span] = out[start:start + span]
                i += span
                t = int(out[i - 1])
            else:
                if mode < 0.75:
                    t = int(self.succ[t, rng.integers(0, 8)])
                else:
                    t = int(rng.choice(self.cfg.vocab_size, p=self.unigram))
                out[i] = t
                i += 1
        return out

    def batches(self) -> Iterator[dict]:
        cfg = self.cfg
        if cfg.file is not None:
            stream = np.memmap(cfg.file, dtype=np.int32, mode="r")
            pos = 0
        need = cfg.batch_size * (cfg.seq_len + 1)
        while True:
            if cfg.file is not None:
                if pos + need > len(stream):
                    pos = 0
                chunk = np.asarray(stream[pos:pos + need])
                pos += need
            else:
                chunk = self._gen_doc(need)
            x = chunk.reshape(cfg.batch_size, cfg.seq_len + 1)
            yield {"tokens": x[:, :-1].astype(np.int32),
                   "targets": x[:, 1:].astype(np.int32),
                   "mask": np.ones((cfg.batch_size, cfg.seq_len), np.float32)}
