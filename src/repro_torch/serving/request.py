"""Request lifecycle for the port's serving engine (counterpart of
repro.serving.request)."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving.sampler import is_stop_token


class Status(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"    # admitted; prompt streaming in chunk-wise
    RUNNING = "running"
    DONE = "done"


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                       # [S_p] int32
    max_new_tokens: int
    eos_token: Optional[int] = None
    stop_tokens: Optional[Sequence[int]] = None
    temperature: float = 0.0                 # 0 = greedy
    top_k: int = 0
    top_p: float = 0.0                       # 0/1 = disabled
    status: Status = Status.QUEUED
    generated: List[int] = field(default_factory=list)
    finish_reason: Optional[str] = None      # "stop" | "length"
    arrive_step: int = 0
    start_step: int = -1
    finish_step: int = -1
    slot: int = -1                           # batch row once scheduled; -1
                                             # queued (also after preemption)
    prefill_pos: int = 0                     # feed tokens prefilled so far
                                             # (chunked prefill progress; a
                                             # prefix hit starts past 0)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def target_len(self) -> int:
        return self.prompt_len + self.max_new_tokens

    @property
    def feed_tokens(self) -> np.ndarray:
        """The token history a (re-)prefill must feed: the prompt plus
        everything generated so far.  A preempted request keeps its
        generated tokens and resumes by prefilling this whole feed: its
        last position's logits predict the next new token, as the
        prompt's last token seeds generation on first admission."""
        if not self.generated:
            return np.asarray(self.prompt, np.int32)
        return np.concatenate([np.asarray(self.prompt, np.int32),
                               np.asarray(self.generated, np.int32)])

    @property
    def feed_len(self) -> int:
        return self.prompt_len + len(self.generated)

    def finish_reason_for(self, last_token: int) -> Optional[str]:
        """The single reason ``last_token`` (already appended) ends this
        request, or None; a stop token on the final allowed step reports
        "stop", not "length"."""
        if is_stop_token(last_token, self.eos_token,
                         self.stop_tokens or ()):
            return "stop"
        if len(self.generated) >= self.max_new_tokens:
            return "length"
        return None

    def is_finished(self, last_token: int) -> bool:
        return self.finish_reason_for(last_token) is not None
