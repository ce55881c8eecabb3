"""Faults planted under the timed path, for the test that sees ``correct``
come out false for each: each takes the engine before its fill and
returns a function that undoes it.  A one-card serve has no exchange
between chips, so that fault has no entry here."""
from __future__ import annotations

import numpy as np


def token_altered(eng):
    """Every third sampling call emits each row's token plus one."""
    own = eng._sample_tokens
    calls = [0]

    def sample(logits, reqs):
        toks = own(logits, reqs)
        calls[0] += 1
        if calls[0] % 3 == 0:
            toks = (np.asarray(toks) + 1) % logits.shape[-1]
        return toks
    eng._sample_tokens = sample

    def undo():
        eng._sample_tokens = own
    return undo


def state_unchanged(eng):
    """The decode step's KV append writes nothing: every step returns the
    R-state it was given."""
    from repro_torch.serving import paged_cache as PC
    own = PC.write_token_paged
    PC.write_token_paged = lambda pool, *a, **kw: pool

    def undo():
        PC.write_token_paged = own
    return undo


def half_batch(eng):
    """Each R-Part call attends for the first half of its rows only; the
    other half's attention output is left out (zero)."""
    from repro_torch.serving import paged_cache as PC
    own = PC.r_attention_paged_tables

    def attend(r_in, pool, tables, **kw):
        out, pool = own(r_in, pool, tables, **kw)
        o = out["o"].clone()
        o[o.shape[0] - o.shape[0] // 2:] = 0
        return {"o": o}, pool
    PC.r_attention_paged_tables = attend

    def undo():
        PC.r_attention_paged_tables = own
    return undo


FAULTS = {"token_altered": token_altered, "state_unchanged": state_unchanged,
          "half_batch": half_batch}
