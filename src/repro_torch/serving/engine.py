"""Continuous-batching serving engine of the port (counterpart of
repro.serving.engine), greedy admission.

A fixed pool of ``batch`` sequence slots is decoded every step; a
finished sequence frees its slot and a queued request takes any free
slot at once (the paper's baseline, vLLM/Orca-style continuous
batching).  Backends: ``colocated`` (single-device decode, the vanilla
baseline) or ``hetero`` (the S-/R-worker pipeline of core.hetero).  With
``paged_kv=True`` (hetero only) the R-workers store attention KV
block-granular: admission allocates only the pages a prompt needs,
decode grows tables page by page, and a finished sequence's pages are
freed the step it completes.  ``quantized_kv=True`` (hetero only)
stores the R-workers' KV as int8 + per-(token, head) fp32 scales, dense
or paged (§5.2).

Not in this slice (see ROADMAP.md): the ``sls``/``loadctl`` admission
schedules, ``from_plan``, sampled decoding, chunked prefill, the prefix
cache, tiering/preemption, speculative decoding, fleet management, chaos
supervision and observability.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import decompose as D
from repro_torch.core.config import ModelConfig
from repro_torch.core.hetero import (ColocatedEngine, HeteroPipelineEngine,
                                     batch_slice, per_layer_state)
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.request import Request, Status
from repro_torch.serving.sampler import sample

# ServingEngine options of the JAX package that this slice does not port
_NOT_IN_SLICE = ("prefill_chunk", "prefix_cache", "kv_tiering",
                 "spec_decode", "preempt_after", "fleet", "chaos",
                 "observability", "target_len", "interval", "w_lim")


def _pad_pow2(n: int, lo: int = 1) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


@dataclass
class StepRecord:
    """Per-step accounting: ``prefill_wall`` is admission + prefill,
    ``decode_wall`` the decode step and its sampling."""
    step: int
    prefill_wall: float
    decode_wall: float
    active: int
    resident_len: int
    admitted: int

    @property
    def wall(self) -> float:
        return self.prefill_wall + self.decode_wall


class ServingEngine:
    def __init__(self, params, cfg: ModelConfig, *, batch: int,
                 cache_len: int, backend: str = "colocated",
                 admission: str = "greedy", num_r_workers: int = 2,
                 num_microbatches: int = 2, kv_chunk: int = 1024,
                 quantized_kv: bool = False, paged_kv: bool = False,
                 page_size: int = 16,
                 pages_per_worker: Optional[int] = None,
                 schedule: str = "ooo", collect_timeout_s: float = 600.0,
                 device=None, **not_ported):
        unknown = set(not_ported) - set(_NOT_IN_SLICE)
        if unknown:
            raise TypeError(f"unexpected keyword argument(s) "
                            f"{sorted(unknown)}")
        asked = sorted(k for k, v in not_ported.items() if v)
        if asked:
            raise NotImplementedError(
                f"{asked} not ported yet — queued in ROADMAP.md")
        if admission != "greedy":
            raise NotImplementedError(
                f"admission={admission!r} is not ported yet (only 'greedy'; "
                f"the sls/loadctl schedules are queued in ROADMAP.md)")
        if backend not in ("colocated", "hetero"):
            raise ValueError(
                f"backend must be 'colocated' or 'hetero', got {backend!r}")
        if batch < 1 or cache_len < 1:
            raise ValueError(
                f"batch ({batch}) and cache_len ({cache_len}) must be >= 1")
        if backend == "hetero" and batch % num_microbatches != 0:
            raise ValueError(
                f"batch ({batch}) must be divisible by num_microbatches "
                f"({num_microbatches}); round batch up to "
                f"{-(-batch // num_microbatches) * num_microbatches} or "
                f"change num_microbatches")
        self.device = resolve_device(device)
        self.params, self.cfg = params, cfg
        self.batch, self.cache_len = batch, cache_len
        self.backend = backend
        self.paged_kv = paged_kv and backend == "hetero"
        self.admission = admission
        self.queue: deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * batch
        self.step_idx = 0
        self.records: List[StepRecord] = []
        self.finished: List[Request] = []
        self._last_tok = np.zeros((batch,), np.int32)
        # the logits [batch, vocab] of the last decode step (for checks)
        self.last_logits: Optional[torch.Tensor] = None
        if backend == "hetero":
            self.engine = HeteroPipelineEngine(
                params, cfg, batch=batch, cache_len=cache_len,
                num_r_workers=num_r_workers,
                num_microbatches=num_microbatches, kv_chunk=kv_chunk,
                quantized_kv=quantized_kv, paged_kv=paged_kv,
                page_size=page_size,
                pages_per_worker=pages_per_worker, schedule=schedule,
                collect_timeout_s=collect_timeout_s, device=self.device)
            self.num_mb = num_microbatches
            self.mb_size = batch // num_microbatches
            for mb in range(self.num_mb):
                self._hetero_init_empty(mb)
        else:
            self.engine = ColocatedEngine(params, cfg, batch=batch,
                                          cache_len=cache_len,
                                          device=self.device)
            self.num_mb = 1
            self.mb_size = batch

    def _hetero_init_empty(self, mb: int) -> None:
        state = M.init_decode_state(self.cfg, self.mb_size, self.cache_len,
                                    self.device)
        for li, st in enumerate(per_layer_state(state, self.cfg)):
            r_st, s_st = D.split_block_state(self.engine.layers[li][0], st)
            for w in self.engine.workers:
                w.load_state(self.engine._lkey(mb, li),
                             batch_slice(r_st, w.lo, w.hi))
            self.engine.s_states[mb][li] = s_st

    # ------------------------------------------------------------------ #
    def _paged_pool_min(self) -> Optional[int]:
        """Pages in the scarcest per-(worker, micro-batch) pool, or None
        when nothing is paged."""
        pools = [a.num_pages for w in self.engine.workers
                 for a in w.allocators.values()]
        return min(pools) if pools else None

    def _length_cap_reason(self) -> Optional[str]:
        """Why prompt + max_new_tokens must fit cache_len here, or None
        when the dense ring may legally wrap."""
        if self.paged_kv and self._paged_pool_min() is not None:
            return "the paged path would drop tokens past capacity"
        return None

    def submit(self, req: Request) -> None:
        if req.temperature > 0.0:
            raise NotImplementedError(
                f"request {req.rid}: sampled decoding (temperature > 0) is "
                f"not ported yet — see ROADMAP.md")
        reason = self._length_cap_reason()
        if reason is not None \
                and req.prompt_len + req.max_new_tokens > self.cache_len:
            raise ValueError(
                f"request {req.rid}: prompt ({req.prompt_len}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds cache_len "
                f"({self.cache_len}) — {reason}")
        pool_min = self._paged_pool_min() if self.paged_kv else None
        if pool_min is not None:
            need = self._paged_pages_for(req)
            if need > pool_min:
                raise ValueError(
                    f"request {req.rid} needs {need} pages, more than a "
                    f"worker pool holds — raise pages_per_worker")
        req.arrive_step = self.step_idx
        self.queue.append(req)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def resident_len(self) -> int:
        return sum(r.prompt_len + len(r.generated)
                   for r in self.slots if r is not None)

    # ------------------------------------------------------------------ #
    def _paged_pages_for(self, req: Request) -> int:
        """Worst-case pages a request will ever hold (prompt +
        max_new_tokens, page-rounded)."""
        return -(-min(req.target_len, self.cache_len)
                 // self.engine.page_size)

    def _paged_admit_cap(self, n: int) -> int:
        """Page-aware admission backpressure: every resident request owes
        (full-target pages - pages already mapped) of future growth, and
        a queued request is admitted only if its worst case fits its
        prospective (worker, micro-batch) pool on top of those debts, so
        decode-time growth never exhausts a pool."""
        if self._paged_pool_min() is None:
            return n
        budget: Dict[Tuple[int, int], int] = {}
        for w in self.engine.workers:
            for mb, a in w.allocators.items():
                budget[(w.wid, mb)] = a.available_pages()
        for row, req in enumerate(self.slots):
            if req is None:
                continue
            w, mb, local = self.engine.worker_for(row)
            debt = self._paged_pages_for(req) \
                - w.allocators[mb].mapped_pages(local)
            budget[(w.wid, mb)] -= max(0, debt)
        m = 0
        free = self._free_slots()
        for row, r in zip(free, list(self.queue)[:n]):
            w, mb, _ = self.engine.worker_for(row)
            need = self._paged_pages_for(r)
            if need > budget[(w.wid, mb)]:
                break
            budget[(w.wid, mb)] -= need
            m += 1
        return m

    def _admit_count(self) -> int:
        """How many queued requests start THIS step (greedy)."""
        avail = min(len(self._free_slots()), len(self.queue))
        if self.paged_kv and avail > 0:
            avail = self._paged_admit_cap(avail)
        return avail

    # ------------------------------------------------------------------ #
    def _sample_tokens(self, logits) -> np.ndarray:
        """Greedy: one batch argmax on the device, one copy to the host."""
        return sample(logits).cpu().numpy()

    def _finish_row(self, row: int, r: Request, reason: str) -> None:
        """THE finish site: status, step, reason, slot release and page
        retirement happen here exactly once per request.  The freed row
        keeps being stepped (its table is all -1: its writes are dropped
        and its attention output is zero) until readmission."""
        r.status = Status.DONE
        r.finish_step = self.step_idx
        r.finish_reason = reason
        self.finished.append(r)
        self.slots[row] = None
        self._retire_row(row)

    def _retire_row(self, row: int) -> None:
        if self.paged_kv:
            self.engine.release_row(row)

    def _place_monolithic(self, reqs: List[Request],
                          rows: List[int]) -> None:
        max_p = max(r.feed_len for r in reqs)
        n_pad = _pad_pow2(len(reqs))
        s_pad = _pad_pow2(max_p, 8)
        toks = np.zeros((n_pad, s_pad), np.int32)
        plens = np.zeros((n_pad,), np.int32)
        for i, r in enumerate(reqs):
            toks[i, :r.feed_len] = r.feed_tokens
            plens[i] = r.feed_len
        last_logits, sub = M.prefill(
            self.params, self.cfg, torch.from_numpy(toks).to(self.device),
            torch.from_numpy(plens).to(self.device), self.cache_len)
        rows_np = np.asarray(rows)
        sub_rows = np.arange(len(reqs))
        if self.backend == "hetero":
            self._hetero_scatter(rows_np, sub, sub_rows)
        else:
            self.engine.state = M.scatter_rows(self.engine.state, sub,
                                               rows_np, sub_rows)
        # the prefill's last-token logits ARE the first generation step
        tok0 = self._sample_tokens(last_logits)
        for i, r in enumerate(reqs):
            r.status = Status.RUNNING
            r.start_step = self.step_idx
            r.slot = rows[i]
            t0 = int(tok0[i])
            r.generated.append(t0)
            self._last_tok[rows[i]] = t0
            reason = r.finish_reason_for(t0)
            if reason is not None:
                self._finish_row(rows[i], r, reason)
            else:
                self.slots[rows[i]] = r

    def _hetero_scatter(self, rows: np.ndarray, sub, sub_rows: np.ndarray):
        eng = self.engine
        # group admitted rows by owning (worker, micro-batch) so each
        # layer issues ONE write_rows (one pool scatter) per group
        groups: Dict[Tuple[int, int], Tuple[object, list, list]] = {}
        for gi, row in zip(sub_rows, rows):
            w, mb, local = eng.worker_for(int(row))
            _, locs, gis = groups.setdefault((w.wid, mb), (w, [], []))
            locs.append(local)
            gis.append(int(gi))
        for li, st in enumerate(per_layer_state(sub, self.cfg)):
            r_st, _ = D.split_block_state(eng.layers[li][0], st)
            for (wid, mb), (w, locs, gis) in groups.items():
                idx = torch.as_tensor(gis, dtype=torch.long,
                                      device=self.device)
                w.write_rows(eng._lkey(mb, li), np.asarray(locs),
                             {k: v[idx] for k, v in r_st.items()})
        lens = sub["lengths"].cpu().numpy()
        for gi, row in zip(sub_rows, rows):
            eng.set_row_length(int(row), int(lens[gi]))

    # ------------------------------------------------------------------ #
    def step(self) -> StepRecord:
        pc = time.perf_counter
        t0 = pc()
        n = self._admit_count()
        if n > 0:
            reqs = [self.queue.popleft() for _ in range(n)]
            self._place_monolithic(reqs, self._free_slots()[:n])
        prefill_wall = pc() - t0

        t0 = pc()
        toks = torch.from_numpy(self._last_tok[:, None].copy()).to(
            self.device)
        if self.backend == "hetero":
            parts = self.engine.decode_step(
                [toks[m * self.mb_size:(m + 1) * self.mb_size]
                 for m in range(self.num_mb)])
            logits = torch.cat(parts, dim=0)
        else:
            logits = self.engine.decode_step(toks)
        self.last_logits = logits
        new_tok = self._sample_tokens(logits)
        decode_wall = pc() - t0

        for i, r in enumerate(self.slots):
            if r is None or r.status is not Status.RUNNING:
                continue
            tok = int(new_tok[i])
            r.generated.append(tok)
            self._last_tok[i] = tok
            reason = r.finish_reason_for(tok)
            if reason is not None:
                self._finish_row(i, r, reason)
        rec = StepRecord(self.step_idx, prefill_wall, decode_wall,
                         sum(r is not None for r in self.slots),
                         self.resident_len(), n)
        self.records.append(rec)
        self.step_idx += 1
        return rec

    def paged_resident_bytes(self) -> float:
        """Current page-backed KV bytes on the R-workers (paged_kv only)."""
        return self.engine.paged_resident_bytes() if self.paged_kv else 0.0

    def hotpath_stats(self) -> Dict[str, float]:
        """Cumulative decode hot-path breakdown of the pipelined engine
        (dispatch / collect / S-dispatch / R-wait seconds, step count);
        empty for the colocated backend."""
        return dict(getattr(self.engine, "step_stats", {}) or {})

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Serve until the queue and slots drain, or ``max_steps`` more
        steps have run."""
        end_step = self.step_idx + max_steps
        while (self.queue or any(r is not None for r in self.slots)) \
                and self.step_idx < end_step:
            self.step()
        return self.finished

    def close(self) -> None:
        if self.backend == "hetero":
            self.engine.close()
