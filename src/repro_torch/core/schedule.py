"""Sequence-level load-stabilizing schedule (FastDecode §4.2).

The R-Part workload at a step is the total length of all resident
sequences; with one monolithic batch it ramps from 0 to W_max = B·S.
SLS staggers admission into micro-batches of size M = B·F/S every F steps
(eq. 5) so the resident length stabilizes at W'_max = B(S+F)/2 ≈ W_max/2
(eq. 6).  ``LoadController`` is the paper's Algorithm 1 — the generalized
admission rule under a load limit W_lim.

Also contains the analytic schedule simulator (total work
conservation, peak halving, waiting-time reduction).

The port's copy of repro.core.schedule (pure Python, no change): the
serving engine's ``sls`` and ``loadctl`` admissions run on it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# eq. 5 / 6 closed forms
# ---------------------------------------------------------------------------
def microbatch_size(B: int, S: int, F: int) -> int:
    """eq. (5): M = B·F/S (rounded up so the target batch is reached)."""
    return max(1, math.ceil(B * F / S))


def w_max(B: int, S: int) -> int:
    return B * S


def w_prime_max(B: int, S: int, F: int) -> float:
    """eq. (6): steady-state peak resident length under SLS."""
    return B * (S + F) / 2.0


# ---------------------------------------------------------------------------
# Algorithm 1 — load-control admission
# ---------------------------------------------------------------------------
@dataclass
class _Mb:
    size: int          # M[i]
    end: int           # E[i] — step index at which this micro-batch finishes
    w_at_end: int      # W[i] — total resident length at step E[i]
    prompt: int = 0    # P[i] — prompt tokens resident for its lifetime


@dataclass
class LoadController:
    """Decides the earliest step at which a new micro-batch may start so
    that the resident-length peak at every current micro-batch's final
    step stays under ``w_lim``.  Faithful to Algorithm 1, plus the
    retirement of finished micro-batches (implicit in the paper).

    ``prompt_tokens`` extends Algorithm 1 to be prefill-cost-aware: a
    micro-batch's sequences carry their prompt KV from admission, so
    they contribute ``prompt_tokens`` of R-Part load immediately (a
    constant for the micro-batch's lifetime) on top of the 1-token-per-
    step generation ramp the paper models.  The paper's schedule (whose
    W counts generated tokens only) is the ``prompt_tokens=0`` special
    case — admission policies that ignore prompts overload the
    R-workers exactly when long-prompt traffic arrives."""
    w_lim: float
    seq_len: int                       # S — target generated length
    mbs: List[_Mb] = field(default_factory=list)

    def retire(self, t: int) -> None:
        self.mbs = [m for m in self.mbs if m.end > t]

    def add_microbatch(self, t: int, m: int, prompt_tokens: int = 0) -> None:
        """ADDMICROBATCH: start a micro-batch of m sequences (carrying
        ``prompt_tokens`` of prompt KV) at step t."""
        s = self.seq_len
        for mb in self.mbs:
            if mb.end > t:
                mb.w_at_end += (mb.end - t) * m + prompt_tokens
        self.mbs.append(_Mb(size=m, end=t + s, w_at_end=m * s + prompt_tokens,
                            prompt=prompt_tokens))

    def earliest_step(self, t: int, m: int, prompt_tokens: int = 0) -> int:
        """GETEARLIESTSTEP: first step >= t at which a micro-batch of m
        sequences carrying ``prompt_tokens`` of prompt KV can start
        without pushing any tracked peak over w_lim."""
        self.retire(t)
        r = t
        for mb in self.mbs:
            # (E[i] - t + 1)*m + P <= w_lim - W[i]  ->  solve for t.
            # (A micro-batch started at t holds t'-t+1 tokens/seq at t';
            # W[i] is the recorded load at the incumbent's LAST ACTIVE
            # step E[i]-1, so evaluating the newcomer at E[i] makes this
            # check one step conservative — peaks never exceed w_lim.)
            x = math.floor((self.w_lim - mb.w_at_end - prompt_tokens) / m)
            r = max(r, mb.end - x + 1)
        return r

    def resident_load(self, t: int) -> int:
        """Total resident length at step t (for monitoring/tests)."""
        tot = 0
        for mb in self.mbs:
            start = mb.end - self.seq_len
            if start <= t < mb.end:
                tot += mb.size * (t - start + 1) + mb.prompt
        return tot


# ---------------------------------------------------------------------------
# schedule construction + analytic simulation
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class StepStats:
    step: int
    resident_seqs: int       # batch at this step (S-Part load)
    resident_len: int        # total length (R-Part load)
    latency: float           # per-step latency under the latency model


def big_batch_schedule(B: int, S: int, steps: int) -> List[Tuple[int, int]]:
    """(start_step, size) admissions for the monolithic baseline: everything
    at step 0, re-admitted every S steps (continuous serving)."""
    return [(k * S, B) for k in range(math.ceil(steps / S) + 1)]


def sls_schedule(B: int, S: int, F: int, steps: int) -> List[Tuple[int, int]]:
    """Fixed-interval SLS admissions (cold start uses fixed F per §4.2)."""
    m = microbatch_size(B, S, F)
    return [(k * F, m) for k in range(math.ceil(steps / F) + 1)]


def load_controlled_schedule(B: int, S: int, F: int, steps: int,
                             w_lim: Optional[float] = None
                             ) -> List[Tuple[int, int]]:
    """Admissions produced by Algorithm 1 with micro-batches of size M."""
    if w_lim is None:
        w_lim = w_prime_max(B, S, F)
    m = microbatch_size(B, S, F)
    lc = LoadController(w_lim=w_lim, seq_len=S)
    out = []
    t = 0
    while t <= steps:
        r = lc.earliest_step(t, m)
        if r > steps:
            break
        lc.add_microbatch(r, m)
        out.append((r, m))
        t = r + 1
    return out


def simulate(admissions: Sequence[Tuple[int, int]], S: int, steps: int,
             *, t_s_of_b=None, r_per_len: float = 0.0,
             pipelined: bool = True) -> List[StepStats]:
    """Replay an admission schedule; per step compute resident seqs/length
    and a latency from the perf model:

        lat_S = t_s_of_b(resident_seqs)      (S-Part, batch-dependent)
        lat_R = r_per_len * resident_len     (R-Part, length-dependent)
        lat   = max(lat_S, lat_R)  if pipelined else lat_S + lat_R
    """
    stats = []
    for t in range(steps):
        seqs = 0
        tot_len = 0
        for (t0, m) in admissions:
            if t0 <= t < t0 + S:
                seqs += m
                tot_len += m * (t - t0 + 1)
        ls = float(t_s_of_b(seqs)) if t_s_of_b else 0.0
        lr = r_per_len * tot_len
        lat = max(ls, lr) if pipelined else ls + lr
        stats.append(StepStats(t, seqs, tot_len, lat))
    return stats


def throughput(stats: Sequence[StepStats]) -> float:
    """Generated tokens per unit latency over the simulated horizon."""
    tot_time = sum(s.latency for s in stats)
    tot_tokens = sum(s.resident_seqs for s in stats)
    return tot_tokens / tot_time if tot_time > 0 else 0.0
