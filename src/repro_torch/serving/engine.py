"""Continuous-batching serving engine of the port (counterpart of
repro.serving.engine) with the paper's admission schedules.

A fixed pool of ``batch`` sequence slots is decoded every step; finished
sequences free their slot and the admission policy decides *when*
queued requests may take one:

  * ``greedy``  — fill any free slot at once (vLLM/Orca-style continuous
                  batching; the paper's baseline behaviour).
  * ``sls``     — fixed-interval micro-batches of M = B·F/S every F steps
                  (FastDecode §4.2, ``target_len`` S, ``interval`` F).
  * ``loadctl`` — Algorithm 1: the earliest step under the W_lim peak
                  bound (``w_lim``; default eq. 6's W'_max), with the
                  candidates' prompt tokens counted against it.

``ServingEngine.from_plan`` sizes the batch and the R-worker count with
the §4.3 performance model (``core.perfmodel``; H100 by default).
Backends: ``colocated`` (single-device decode, the vanilla
baseline) or ``hetero`` (the S-/R-worker pipeline of core.hetero).  With
``paged_kv=True`` (hetero only) the R-workers store attention KV
block-granular: admission allocates only the pages a prompt needs,
decode grows tables page by page, and a finished sequence's pages are
freed the step it completes.  ``quantized_kv=True`` (hetero only)
stores the R-workers' KV as int8 + per-(token, head) fp32 scales, dense
or paged (§5.2).  ``spec_decode=SpecConfig(k)`` (hetero) drafts k tokens
per row on an S-resident drafter and verifies all k+1 candidates in one
pipelined chunk-only step, on any storage.  ``prefill_chunk=C`` (hetero)
admits a prompt as PREFILLING and streams it in C-token chunks, one per
step, inside the pipelined decode step while the other rows decode; the
step its last chunk lands, its first token is sampled from that chunk's
logits and the row joins the decode batch.

Sampling: a request with ``temperature > 0`` draws its tokens (with its
``top_k`` / ``top_p``) from one engine-owned ``torch.Generator`` seeded
by ``seed``; greedy rows ride one batch argmax.  Sampling runs eagerly
after the logits head, never inside a captured graph.

``prefix_cache=True`` (hetero + paged, pure self-attention) shares
prompt prefixes across requests: refcounted copy-on-write pages and a
per-(worker, micro-batch) prefix index; a queued request takes the free
slot whose pool caches the longest prefix of its prompt, the page budget
credits adopted pages, and a hit prefills only the uncached suffix
through the chunk machinery.  ``kv_tiering`` (True, a ``TierConfig`` or
a ``HostTier``; implies the prefix cache) parks a finished sequence's
pages, swaps parked pages out to host memory under pressure and restores
them on a probe; ``preempt(rid)`` and ``preempt_after=N`` (park the
least-finished row after N steps of page-blocked admission) requeue a
running request, which resumes token-exactly.

``observability=True`` (or an ``obs.ObsConfig``) turns on the metrics
registry (TTFT, queue-wait, inter-token and end-to-end histograms,
lifecycle counters: ``metrics()``), per-request timelines
(``request_timeline``), the pipeline span tracer (``export_trace``: Chrome
trace events) and the perfmodel drift monitor (``drift_report``).  Off,
every hook is one ``self.obs is None`` test.  The hooks run on the host
between graph replays: they add no device synchronisation.

With ``fleet=FleetManager(...)`` (hetero only) the R-worker pool is
fleet-managed: heterogeneity-aware partition planning, straggler
rebalancing by live KV migration, and failure recovery run around each
step (``pre_step`` / ``post_step``), lost rows are re-prefilled exactly
from the token history (``_replay_rows``), and admission is re-costed
after a topology change (``_recost_admission``).

The step supervisor (``_decode_supervised``, and the verify step's
healer) catches a ``StepFault`` from the pipelined step (a dead, hung or
silent worker, a worker's error post, a transient pool or tier fault),
heals it (a grace window for a suspected worker, then quiesce, fail over
the dead and hung, re-prefill every live row from token history) and
retries the same step with the same tokens: sampling draws only after a
step returns, so the retry is token-exact.  ``chaos=FaultPlan(...)``
injects faults at the named sites of ``chaos.FAULT_SITES``;
``fault_events``, ``fault_count`` / ``recovered_count`` and ``mttr_s``
record them.  On the card ``suspect_after_s`` must exceed the longest
R-side graph capture of a step, or a capturing worker reads as hung.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import decompose as D
from repro_torch.core import graphs
from repro_torch.core import perfmodel as P
from repro_torch.core.config import (ATTN, DEC_XATTN, XATTN, ModelConfig,
                                     check_supported)
from repro_torch.core.hetero import (ColocatedEngine, HeteroPipelineEngine,
                                     StepFault, per_layer_state)
from repro_torch.core.schedule import (LoadController, microbatch_size,
                                       w_prime_max)
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.obs import Observability, coerce_obs_config, schema
from repro_torch.obs.drift import DriftMonitor
from repro_torch.serving.paged_cache import HostTier, TierConfig
from repro_torch.serving.request import Request, Status
from repro_torch.serving.sampler import sample, spec_accept

_ADMISSIONS = ("greedy", "sls", "loadctl")


def _pad_pow2(n: int, lo: int = 1) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


@dataclass
class StepRecord:
    """Per-step accounting: ``prefill_wall`` is admission + prefill (with
    chunked prefill: queueing the chunks, the chunk work inside the
    pipelined step that held no decode micro-batch back, and the landing
    of the chunks' results), ``decode_wall`` the decode step and its
    sampling (a supervised retry's healing included), ``fleet_wall`` the
    fleet's pre- and post-step hooks (recovery, migration, snapshots)."""
    step: int
    prefill_wall: float
    decode_wall: float
    fleet_wall: float
    active: int
    resident_len: int
    admitted: int

    @property
    def wall(self) -> float:
        return self.prefill_wall + self.decode_wall + self.fleet_wall


@dataclass
class SpecConfig:
    """Speculative decoding through the hetero pipeline.

    Each serving step drafts ``k`` tokens per row GREEDILY on an
    S-resident drafter (a plain dense-state model, no R-worker round
    trips), then verifies all k+1 candidates (the pending token plus the
    drafts) in ONE pipelined step as a verify chunk: the R-Part sweeps
    each row's cached KV once for the whole candidate block instead of
    once per token.  The accepted prefix commits through
    ``sampler.spec_accept`` (greedy rows: the argmax walk, bit-exact with
    spec-off greedy decoding; sampled rows: rejection sampling, exact in
    distribution) and the rejected tail's KV is rolled back
    (``HeteroPipelineEngine.truncate_rows``).

    ``draft_cfg``/``draft_params`` select the drafter model; both None
    means SELF-speculation (the target drafts for itself)."""
    k: int = 4
    draft_cfg: Optional[ModelConfig] = None
    draft_params: Any = None


class ServingEngine:
    @classmethod
    def from_plan(cls, params, cfg, *, seq_len: int, hw_s=None, hw_r=None,
                  latency_slo: Optional[float] = None, max_batch: int = 4096,
                  **kw):
        """Size the engine with the paper's §4.3 performance model: batch
        from eq. 7/8, R-worker count from eq. 11.  ``hw_s`` / ``hw_r``
        default to ``perfmodel.GPU_H100`` (the JAX package defaults to its
        TPU profile).  ``eng.plan`` holds the plan; its ``tokens_per_s``
        is the model's rate at the PLANNED batch, not at the clamped
        one."""
        hw_s = hw_s or P.GPU_H100
        hw_r = hw_r or P.GPU_H100
        # windowed archs keep dense KV at runtime (RWorker._pageable), so
        # they are not planned with paged terms either
        page = (kw.get("page_size", 16)
                if kw.get("paged_kv") and cfg.window == 0 else 0)
        # the expected shared-prefix workload (the fraction of admissions
        # that hit the cache, and the shared prefix's length): they shrink
        # eq. 9's residency demand and scale w_lim
        prefix_hit = kw.pop("prefix_hit_rate", 0.0)
        prefix_len = kw.pop("prefix_len", 0)
        if not kw.get("prefix_cache"):
            prefix_hit = 0.0        # no cache, no dedup to plan for
        # spec_k="plan" lets the model pick the draft length maximizing
        # spec_speedup at the expected acceptance rate (spec_alpha); an int
        # passes through
        spec_k = kw.pop("spec_k", None)
        spec_alpha = kw.pop("spec_alpha", 0.8)
        plan = P.plan(cfg, hw_s, hw_r, seq_len=seq_len,
                      latency_slo=latency_slo, page=page,
                      prefix_hit_rate=prefix_hit, prefix_len=prefix_len,
                      spec_alpha=spec_alpha if spec_k == "plan" else 0.0)
        if spec_k == "plan":
            kw["spec_decode"] = SpecConfig(k=int(plan["spec_k"]))
        elif spec_k:
            kw["spec_decode"] = SpecConfig(k=int(spec_k))
        batch = int(min(max_batch, max(2, plan["batch"])))
        if batch % 2:
            batch += 1
        # one row per worker within a micro-batch at least (the
        # constructor's floor: a clamped batch can undercut an eq. 11
        # worker count computed for the full one)
        mb_size = batch // kw.get("num_microbatches", 2)
        workers = int(max(1, min(8, mb_size, plan["workers"])))
        if kw.get("prefill_chunk") == "plan":
            # the largest pow2 chunk whose S-cost fits the decode bubble,
            # at most the prompt budget
            kw["prefill_chunk"] = int(min(plan["prefill_chunk"], seq_len))
        if kw.get("admission") == "loadctl" and kw.get("w_lim") is None \
                and plan.get("w_lim_scale", 1.0) != 1.0 \
                and kw.get("target_len"):
            # credit deduplicated residency against Algorithm 1's peak
            # bound: shared prefix tokens are resident once, not per row
            s = max(1, kw["target_len"])
            f = max(1, kw.get("interval", 1) or 1)
            kw["w_lim"] = w_prime_max(batch, s, f) * plan["w_lim_scale"]
        eng = cls(params, cfg, batch=batch, cache_len=seq_len,
                  backend=kw.pop("backend", "hetero"),
                  num_r_workers=workers, **kw)
        eng.plan = plan
        if eng._obs_obj is not None and eng._obs_obj.drift is not None:
            # the drift monitor reports measured tokens/s against the
            # plan's promise too
            eng._obs_obj.drift.plan = plan
        return eng

    def __init__(self, params, cfg: ModelConfig, *, batch: int,
                 cache_len: int, backend: str = "colocated",
                 admission: str = "greedy", target_len: int = 0,
                 interval: int = 0, w_lim: Optional[float] = None,
                 num_r_workers: int = 2,
                 num_microbatches: int = 2, kv_chunk: int = 1024,
                 quantized_kv: bool = False, paged_kv: bool = False,
                 page_size: int = 16,
                 pages_per_worker: Optional[int] = None, seed: int = 0,
                 schedule: str = "ooo", collect_timeout_s: float = 600.0,
                 prefill_chunk: int = 0, prefix_cache: bool = False,
                 kv_tiering=None, spec_decode: Optional[SpecConfig] = None,
                 preempt_after: int = 0, observability=False,
                 fleet=None, chaos=None, suspect_after_s: float = 120.0,
                 suspect_strikes: int = 2, max_step_retries: int = 4,
                 retry_backoff_s: float = 0.02, device=None):
        if admission not in _ADMISSIONS:
            raise ValueError(f"admission must be one of {_ADMISSIONS}, got "
                             f"{admission!r}")
        if backend not in ("colocated", "hetero"):
            raise ValueError(
                f"backend must be 'colocated' or 'hetero', got {backend!r}")
        if fleet is not None and backend != "hetero":
            raise ValueError("fleet management requires backend='hetero'")
        # KV lifecycle tiering: True (default TierConfig), a TierConfig, or
        # a ready HostTier.  Implies prefix_cache: the tier is keyed by its
        # digest chains
        self.kv_tier: Optional[HostTier] = None
        if kv_tiering:
            if backend != "hetero" or not paged_kv:
                raise ValueError(
                    "kv_tiering requires backend='hetero' with "
                    "paged_kv=True — the tier swaps paged R-worker pool "
                    "pages")
            if isinstance(kv_tiering, HostTier):
                self.kv_tier = kv_tiering
            elif isinstance(kv_tiering, TierConfig):
                self.kv_tier = HostTier(kv_tiering)
            else:
                self.kv_tier = HostTier()
            prefix_cache = True
        if prefix_cache:
            if backend != "hetero" or not paged_kv:
                raise ValueError(
                    "prefix_cache=True requires backend='hetero' with "
                    "paged_kv=True — shared prefixes live in the paged "
                    "R-worker pools")
            if any(k != ATTN for k in cfg.layer_pattern) \
                    or cfg.window > 0 or cfg.is_encdec:
                raise ValueError(
                    "prefix_cache=True requires a pure self-attention "
                    "arch with window=0: recurrent/windowed/cross-"
                    "attention R-state cannot be shared page-wise, so "
                    "the skipped-prefill admission would be wrong")
        if spec_decode is not None:
            if backend != "hetero":
                raise ValueError(
                    "spec_decode requires backend='hetero' — the verify "
                    "step rides the pipelined chunk machinery")
            if spec_decode.k < 1:
                raise ValueError(
                    f"spec_decode.k must be >= 1, got {spec_decode.k}")
            if any(kk != ATTN for kk in cfg.layer_pattern) \
                    or cfg.window > 0 or cfg.is_encdec:
                raise ValueError(
                    "spec_decode requires a pure self-attention arch "
                    "with window=0: rejected-KV rollback is positional "
                    "truncation, which recurrent/windowed/cross-"
                    "attention R-state does not support")
            if (spec_decode.draft_cfg is None) \
                    != (spec_decode.draft_params is None):
                raise ValueError(
                    "spec_decode needs BOTH draft_cfg and draft_params "
                    "(or neither, for self-speculation)")
        if prefill_chunk:
            if backend != "hetero":
                raise ValueError(
                    "prefill_chunk requires backend='hetero' — the "
                    "colocated engine keeps the monolithic prefill "
                    "(it IS the A/B baseline)")
            if prefill_chunk < 1:
                raise ValueError(
                    f"prefill_chunk must be >= 1 (0 disables), got "
                    f"{prefill_chunk}")
            if cfg.is_encdec or DEC_XATTN in cfg.layer_pattern \
                    or XATTN in cfg.layer_pattern:
                raise ValueError(
                    "chunked prefill does not support cross-attention "
                    "archs (enc-dec / vision) — use prefill_chunk=0")
        if batch < 1 or cache_len < 1:
            raise ValueError(
                f"batch ({batch}) and cache_len ({cache_len}) must be >= 1")
        if backend == "hetero" and batch % num_microbatches != 0:
            raise ValueError(
                f"batch ({batch}) must be divisible by num_microbatches "
                f"({num_microbatches}); round batch up to "
                f"{-(-batch // num_microbatches) * num_microbatches} or "
                f"change num_microbatches")
        if cfg.is_encdec or M.has_xattn(cfg):
            # repro's ServingEngine takes these archs and fails at the
            # first admission: its prefill gets no encoder features
            raise ValueError(
                f"ServingEngine does not serve {cfg.name}: its cross-"
                f"attention needs encoder or patch features, which no "
                f"admission carries; serve it through the static-batch "
                f"API, HeteroPipelineEngine or ColocatedEngine "
                f".load_prefill(..., enc_feats=...) then decode_step")
        self.device = resolve_device(device)
        self.params, self.cfg = params, cfg
        self.batch, self.cache_len = batch, cache_len
        self.backend = backend
        self.paged_kv = paged_kv and backend == "hetero"
        self.admission = admission
        self.target_len = target_len            # S in the paper's schedule
        self.interval = interval                # F
        self.plan: Optional[Dict[str, float]] = None   # set by from_plan
        self.spec = spec_decode
        self.prefill_chunk = int(prefill_chunk)
        self.prefix_cache = bool(prefix_cache)
        # chunked prefill, prefix-cache hits (one whole-suffix chunk) and
        # spec decode's verify steps are chunk work: prefilling and freed
        # rows are gated decode-inactive
        self._uses_chunks = bool(prefill_chunk) or self.prefix_cache \
            or self.spec is not None
        self.prefix_stats = {"hits": 0, "misses": 0, "cached_tokens": 0,
                             "prompt_tokens": 0}
        # auto-preemption: after this many consecutive steps in which the
        # page budget blocked a queued request despite free slots, the
        # least-finished RUNNING row is parked and requeued (0 disables);
        # restores are consulted only when the tier streams at all
        self.preempt_after = int(preempt_after)
        self._stall_steps = 0
        self.preemptions = 0
        self._restore_ok = (self.kv_tier is not None
                            and self.kv_tier.cfg.dram_gbps > 0)
        self._choice_cache: Tuple[int, list] = (-1, [])
        # every sampled draw comes from this generator, on the device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self.queue: deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * batch
        self.step_idx = 0
        self.records: List[StepRecord] = []
        self.finished: List[Request] = []
        self._last_tok = np.zeros((batch,), np.int32)
        # the logits [batch, vocab] of the last decode step (for checks;
        # None after a speculative step, whose logits are those of the
        # verify works, engine.prefill_results)
        self.last_logits: Optional[torch.Tensor] = None
        self.fleet = fleet
        # self-healing supervision: chaos is the (optional) fault plan
        # injected into every layer below; the retry / failover loop runs
        # regardless (real faults need no plan)
        self.chaos = chaos
        self.max_step_retries = max(0, int(max_step_retries))
        self.retry_backoff_s = max(0.0, float(retry_backoff_s))
        self.faults = 0
        self.recoveries = 0
        # one dict per detected fault ({step, attempt, kind, implicated,
        # lost, transient, msg}) and per recovery ({step, kind
        # "recovered", attempts, mttr_s}); workers the grace window spared
        self.fault_events: List[Dict[str, Any]] = []
        self.spared_workers = 0
        self.replayed_rows = 0          # rows re-prefilled by recoveries
        if self.kv_tier is not None and chaos is not None:
            self.kv_tier.chaos = chaos
        if backend == "hetero":
            self.engine = HeteroPipelineEngine(
                params, cfg, batch=batch, cache_len=cache_len,
                num_r_workers=num_r_workers,
                num_microbatches=num_microbatches, kv_chunk=kv_chunk,
                quantized_kv=quantized_kv, paged_kv=paged_kv,
                page_size=page_size,
                pages_per_worker=pages_per_worker, schedule=schedule,
                collect_timeout_s=collect_timeout_s,
                prefix_cache=self.prefix_cache, kv_tier=self.kv_tier,
                fleet=fleet, chaos=chaos, suspect_after_s=suspect_after_s,
                suspect_strikes=suspect_strikes, device=self.device)
            self.num_mb = num_microbatches
            self.mb_size = batch // num_microbatches
            # stall messages name the in-flight rids of each micro-batch
            self.engine.rids_of = self._rids_of_mb
            for mb in range(self.num_mb):
                self._hetero_init_empty(mb)
        else:
            self.engine = ColocatedEngine(params, cfg, batch=batch,
                                          cache_len=cache_len,
                                          device=self.device)
            self.num_mb = 1
            self.mb_size = batch

        # speculative decoding: the S-resident drafter, a plain dense-state
        # model run with the single-device functions.  Capacity cache_len
        # + k, so drafting near capacity never wraps the ring.  A row is
        # dirty when its token history changed outside the commit path
        # (admission) and is re-fed feed_tokens[:-1] before its next draft.
        self._spec_dirty: set = set()
        self.spec_stats = {"drafted_tokens": 0, "accepted_tokens": 0,
                           "steps": 0}
        if self.spec is not None:
            self._spec_cfg = self.spec.draft_cfg or cfg
            check_supported(self._spec_cfg)
            self._spec_params = (params if self.spec.draft_params is None
                                 else self.spec.draft_params)
            self._spec_cache = cache_len + self.spec.k
            self._spec_state = M.init_decode_state(
                self._spec_cfg, batch, self._spec_cache, self.device)
            self._draft_graph: Optional[graphs.StepGraph] = None
            self._commit_graph: Optional[graphs.StepGraph] = None

        if admission == "loadctl":
            s = max(1, target_len)
            if w_lim is None:
                w_lim = w_prime_max(batch, s, max(1, interval))
            self.load_ctl: Optional[LoadController] = LoadController(
                w_lim=w_lim, seq_len=s)
        else:
            self.load_ctl = None
        self._w_lim0 = w_lim if self.load_ctl is not None else None
        self._topo_seen = (tuple(self.engine.slices)
                           if backend == "hetero" else None)

        # the span tracer (attach_tracer, or observability's): None costs
        # one test per span site
        self.tracer = None
        # (tracer only) the ids of this step's engine.step and engine.admit
        self._step_span: Optional[int] = None
        self._admit_span: Optional[int] = None
        # observability: off by default, and then every hook is one
        # ``self.obs is None`` test.  True enables the defaults; an ObsConfig
        # tunes the span ring and the drift calibration
        self._obs_obj: Optional[Observability] = None
        self.obs: Optional[Observability] = None
        ocfg = coerce_obs_config(observability)
        if ocfg is not None:
            self._obs_obj = Observability(ocfg)
            if ocfg.drift and backend == "hetero":
                self._obs_obj.drift = DriftMonitor(
                    cfg, self.num_mb, len(self.engine.workers),
                    calibration_steps=ocfg.drift_calibration_steps,
                    tolerance=ocfg.drift_tolerance,
                    warmup_steps=ocfg.drift_warmup_steps)
            self.set_observability(True)
        # each row's previous token time, for the inter-token histogram
        self._tok_t: List[float] = [0.0] * batch
        # the tier's restore counter as last seen, to attribute "restored"
        # timeline events to the admissions whose probe restored pages
        self._restored_seen = 0

    def set_observability(self, on: bool) -> None:
        """Toggle observability on an engine constructed with it (a paired
        overhead measurement flips this between runs).  A no-op if the
        engine was built with observability=False."""
        if self._obs_obj is None:
            if on:
                raise RuntimeError(
                    "engine was constructed with observability=False — "
                    "pass observability=True|ObsConfig() to enable")
            return
        self.obs = self._obs_obj if on else None
        self.attach_tracer(self._obs_obj.tracer if on else None)

    def attach_tracer(self, tracer) -> None:
        """Record spans and counters on ``tracer`` (an
        ``obs.SpanTracer``), or stop with None: the engine's own spans
        (``engine.step`` and its children ``engine.admit``,
        ``engine.prefill``, ``engine.upload``, ``engine.sample``,
        ``engine.emit``, ``engine.fleet``), the pipeline's (``step N``,
        ``pipe.*``, ``r-rtt``) and the R-workers' (busy windows,
        ``r.*``), and the counters of graphs, protocol bytes and kernel
        1's work.  It wires no metrics registry, timeline or drift
        monitor (``set_observability`` does, with its own tracer)."""
        self.tracer = tracer
        if self.backend == "hetero":
            self.engine.attach_tracer(tracer)

    def _span(self, name: str, t_start: float, t_end: float,
              sid: Optional[int] = None, parent: Optional[int] = None
              ) -> None:
        """An ``engine.*`` span of the current step (tracer attached), a
        child of its ``engine.step`` unless ``parent`` says otherwise."""
        self.tracer.add(name, "engine", "s-worker", t_start, t_end, id=sid,
                        parent=self._step_span if parent is None else parent,
                        step=self.step_idx)

    def _hetero_init_empty(self, mb: int) -> None:
        self.engine.load_mb_state(mb, M.init_decode_state(
            self.cfg, self.mb_size, self.cache_len, self.device))

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
        if self.spec is not None:
            return ("speculative decoding rolls rejected tokens back "
                    "by positional KV truncation, which a wrapped ring "
                    "would corrupt")
        if self.prefill_chunk and self.cfg.window == 0:
            # chunked prefill streams KV incrementally and relies on the
            # ring never wrapping (windowed archs wrap by design)
            return "required with prefill_chunk > 0"
        if self.paged_kv and self._paged_pool_min() is not None:
            return "the paged path would drop tokens past capacity"
        return None

    def submit(self, req: Request) -> None:
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
        if self.obs is not None:
            req.mark("submitted", self.step_idx)
            self.obs.submitted.inc()
        self.queue.append(req)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    @property
    def prefill_queue(self) -> List[Request]:
        """Sequences mid-chunked-prefill (PREFILLING, slot-resident,
        advancing one chunk per step), in row order."""
        return [r for r in self.slots
                if r is not None and r.status is Status.PREFILLING]

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
        """Page-aware admission backpressure from live allocator state:
        every resident request owes (full-target pages - pages already
        mapped) of future growth, plus one potential CoW clone while any
        of its pages is shared, and a queued request is admitted only if
        its worst case, net of the prefix pages it would adopt, fits its
        prospective (worker, micro-batch) pool on top of those debts, so
        decode-time growth never exhausts a pool.  Without prefix sharing
        this is the full-reservation rule; with it, adopted pages held by
        another resident cost nothing and refcount-zero cached and parked
        pages count as available."""
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
            a = w.allocators[mb]
            debt = self._paged_pages_for(req) - a.mapped_pages(local)
            ids = a.tables[local][a.tables[local] >= 0]
            if len(ids) and bool((a.refcount[ids] > 1).any()):
                debt += 1             # a divergence may CoW one clone
            budget[(w.wid, mb)] -= max(0, debt)
        m = 0
        for row, r, ids, eff in self._choose_rows(list(self.queue)[:n]):
            w, mb, _ = self.engine.worker_for(row)
            a = w.allocators.get(mb)
            need = self._paged_pages_for(r)
            if eff > 0 and a is not None:
                held = sum(1 for pid in ids if a.refcount[pid] > 0)
                # pages held by a resident sharer are free to adopt; +1
                # covers the boundary page's CoW clone
                need += 1 - held
            if need > budget[(w.wid, mb)]:
                break
            budget[(w.wid, mb)] -= need
            m += 1
        return m

    def _admit_count(self) -> int:
        """How many queued requests may start THIS step, per policy."""
        avail = min(len(self._free_slots()), len(self.queue))
        if self.paged_kv and avail > 0:
            # cap BEFORE the policy, so loadctl records only admissions
            # that happen
            avail = self._paged_admit_cap(avail)
        if avail == 0 or self.admission == "greedy":
            return avail
        f = max(1, self.interval)
        mb = microbatch_size(self.batch, max(1, self.target_len), f)
        if self.admission == "sls":
            return min(avail, mb) if self.step_idx % f == 0 else 0
        # loadctl: Algorithm 1, one micro-batch of up to M at a time
        m = 0
        lc = self.load_ctl
        queued = list(self.queue)
        while m < avail:
            chunk = min(mb, avail - m)     # the queue's tail may be < M
            # prefill-cost-aware: the candidates' prompt tokens are
            # resident KV from their first step and count against w_lim.
            # With chunked prefill generation starts only once the prompt
            # has streamed in: the micro-batch is tracked at its true
            # generation span, shifted by the prefill delay d, so the
            # controller does not retire it d steps early
            cand = queued[m:m + chunk]
            ptoks = sum(r.prompt_len for r in cand)
            d = 0
            if self.prefill_chunk:
                d = -(-max(r.prompt_len for r in cand) // self.prefill_chunk)
            elif self.prefix_cache:
                # a prefix hit streams its whole suffix as ONE chunk and
                # generates a step later (misses shift too: conservative)
                d = 1
            t = self.step_idx + d
            if lc.earliest_step(t, chunk, prompt_tokens=ptoks) > t:
                break
            lc.add_microbatch(t, chunk, prompt_tokens=ptoks)
            m += chunk
        return m

    # ------------------------------------------------------------------ #
    def _sample_tokens(self, logits, reqs) -> np.ndarray:
        """One token per row of ``logits``; ``reqs`` aligns a Request (or
        None) with each row: None for rows whose token is DISCARDED
        (mid-prefill, released, padding), so they draw nothing and the
        surviving rows' draws do not depend on unrelated rows.  Greedy
        rows ride one batch argmax (one copy to the host); each row whose
        request sets temperature > 0 is redrawn from the engine's
        generator with its own temperature / top_k / top_p."""
        toks = sample(logits).cpu().numpy().copy()
        for i, r in enumerate(reqs):
            if r is None or r.temperature <= 0.0:
                continue
            toks[i] = int(sample(logits[i:i + 1], self.generator,
                                 temperature=r.temperature, top_k=r.top_k,
                                 top_p=r.top_p)[0])
        return toks

    # -- finish / retire / park / preempt ---------------------------------- #
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
        self._retire_row(row, r)
        if self.obs is not None:
            self._obs_finish(r)
        if self._uses_chunks:
            # a freed slot stops decoding (no KV append, no length bump)
            # until readmission
            self.engine.set_row_active(row, False)

    def _retire_row(self, row: int, req: Request) -> None:
        """A finished sequence's pages: with tiering, PARK the written
        chain (prompt + generated minus the never-appended last token) so
        a later same-history request restores it without re-prefill;
        otherwise free them."""
        if not self.paged_kv:
            return
        if self.kv_tier is not None:
            chain = req.feed_tokens[:-1] if req.generated \
                else req.feed_tokens
            if self.engine.park_row(row, chain):
                return
        self.engine.release_row(row)

    def _preempt_row(self, row: int) -> None:
        """Evict a resident request back to the queue: its written KV
        chain is parked (tiering) or dropped (readmission re-prefills it),
        the slot freed, and the request requeued at the BACK with its
        generated tokens kept; resume prefills ``feed_tokens`` and goes on
        token-exactly (greedy decoding is a function of the history)."""
        r = self.slots[row]
        if r is None:
            return
        parked = False
        if self.paged_kv:
            if r.status is Status.PREFILLING:
                chain = r.feed_tokens[:r.prefill_pos]
            else:
                chain = r.feed_tokens[:-1] if r.generated \
                    else r.feed_tokens
            parked = bool(self.kv_tier is not None and len(chain)
                          and self.engine.park_row(row, chain))
            if not parked:
                self.engine.release_row(row)
        self.slots[row] = None
        if self._uses_chunks:
            self.engine.set_row_active(row, False)
        r.status = Status.QUEUED
        r.slot = -1
        r.prefill_pos = 0
        self.preemptions += 1
        if self.obs is not None:
            r.mark("preempted", self.step_idx)
            self.obs.preempted.inc()
            if parked:
                r.mark("parked", self.step_idx)
        self.queue.append(r)

    def preempt(self, rid: int) -> bool:
        """Preempt the resident request with id ``rid`` (False if it is
        not slot-resident).  Call between steps."""
        for row, r in enumerate(self.slots):
            if r is not None and r.rid == rid:
                self._preempt_row(row)
                return True
        return False

    def _auto_preempt(self) -> None:
        """Admission has been page-blocked for ``preempt_after``
        consecutive steps: park the least-finished RUNNING row (most
        generation budget left: it holds its pages longest)."""
        best, best_rem = -1, -1
        for row, r in enumerate(self.slots):
            if r is None or r.status is not Status.RUNNING:
                continue
            rem = r.max_new_tokens - len(r.generated)
            if rem > best_rem:
                best, best_rem = row, rem
        if best >= 0:
            self._preempt_row(best)

    # -- shared-prefix probing --------------------------------------------- #
    def _probe_prefix(self, row: int, req: Request):
        """(page_ids, cached_eff) for ``req`` landing on ``row``, clamped
        so at least the feed's LAST token is recomputed: its logits seed
        generation, and recomputing it through the chunk path forces the
        shared partial tail page onto a private CoW clone before this
        sequence writes into it.  With tiering the probe also restores
        swapped-out pages from the host tier."""
        if not self.prefix_cache:
            return [], 0
        ids, cached = self.engine.probe_prefix(row, req.feed_tokens,
                                               restore=self._restore_ok)
        eff = min(int(cached), req.feed_len - 1)
        if eff <= 0:
            return [], 0
        return ids[:-(-eff // self.engine.page_size)], eff

    def _note_prefix(self, req: Request, eff: int) -> None:
        st = self.prefix_stats
        st["hits" if eff else "misses"] += 1
        st["cached_tokens"] += eff
        st["prompt_tokens"] += req.feed_len
        obs = self.obs
        if obs is not None and eff > 0:
            req.mark("prefix_hit", self.step_idx, extra=eff)
            obs.prefix_hits.inc()
            if self.kv_tier is not None:
                # the probe restores swapped pages as a side effect:
                # attribute the tier's restore counter's advance to this
                # admission's timeline
                restored = int(self.kv_tier.stats.get("restored", 0))
                if restored > self._restored_seen:
                    self._restored_seen = restored
                    req.mark("restored", self.step_idx)
                    obs.restores.inc()

    # -- lifecycle observation (every hook is obs-gated by the caller) ----- #
    def _obs_admit(self, reqs: List[Request]) -> None:
        obs = self.obs
        t = time.perf_counter()
        for r in reqs:
            r.mark("admitted", self.step_idx, t)
            obs.admitted.inc()
            # queue wait restarts at preemption: a requeued request waits
            # from its preemption, not from its first arrival
            t0 = r.event_t("preempted", last=True)
            if t0 is None:
                t0 = r.event_t("submitted")
            if t0 is not None:
                obs.queue_wait.observe(t - t0)

    def _obs_first_token(self, r: Request, row: int) -> None:
        obs = self.obs
        t = r.mark("first_token", self.step_idx)
        obs.generated.inc()
        t0 = r.event_t("submitted")
        if t0 is not None:
            obs.ttft.observe(t - t0)
        self._tok_t[row] = t

    def _obs_finish(self, r: Request) -> None:
        obs = self.obs
        t = r.mark("finished", self.step_idx)
        obs.finished.inc()
        t0 = r.event_t("submitted")
        if t0 is not None:
            obs.e2e.observe(t - t0)

    def _obs_token(self, r: Request, row: int, t_now: float) -> None:
        """A decode token of ``r`` (row ``row``) committed at ``t_now``."""
        obs = self.obs
        r.mark("token", self.step_idx, t_now)
        obs.generated.inc()
        prev = self._tok_t[row]
        if prev > 0.0:
            obs.inter_token.observe(t_now - prev)
        self._tok_t[row] = t_now

    def _choose_rows(self, reqs: List[Request]):
        """Prefix-aware row assignment: a cached prefix is only adoptable
        by rows of the (worker, micro-batch) pool that holds it, so each
        request takes the free slot whose pool caches the longest prefix
        of its prompt (misses, and the prefix-cache-off path, take the
        first free slot).  Returns [(row, req, page_ids, cached_eff)] in
        queue order: the choice ``_paged_admit_cap`` budgets against,
        memoized per step so placement does not probe again.

        The pages each choice will adopt are held off the eviction ladder
        while the later requests probe (their restores take pages): the
        JAX package does not hold them, and under pool pressure a later
        probe there swaps out or evicts pages an earlier request then
        adopts, after they were reused (ROADMAP.md §3).  Nothing takes a
        page between the end of the probes and the adoptions in
        ``_place``, so the holds end with this call."""
        step, cached = self._choice_cache
        if step == self.step_idx and len(cached) >= len(reqs) \
                and all(c[1] is r for c, r in zip(cached, reqs)):
            return cached[:len(reqs)]
        free = self._free_slots()
        out = []
        for r in reqs:
            if not free:
                break
            best, best_ids, best_eff = free[0], [], 0
            if self.prefix_cache:
                seen: Dict[Tuple[int, int], Tuple[list, int]] = {}
                for row in free:
                    w, mb, _ = self.engine.worker_for(row)
                    key = (w.wid, mb)
                    if key not in seen:      # one probe per pool
                        seen[key] = self._probe_prefix(row, r)
                    ids, eff = seen[key]
                    if eff > best_eff:
                        best, best_ids, best_eff = row, ids, eff
            out.append((best, r, best_ids, best_eff))
            free.remove(best)
            if best_eff > 0:
                self.engine.hold_prefix(best, best_ids)
        if self.prefix_cache:
            self.engine.release_prefix_holds()
        self._choice_cache = (self.step_idx, out)
        return out

    def _place(self, reqs: List[Request]) -> None:
        if self.prefill_chunk:
            self._place_chunked(reqs)
            return
        if self.prefix_cache:
            # prefix hits stream their (suffix-only) prefill through the
            # chunk machinery, one whole-suffix chunk riding the next
            # step; misses keep the monolithic same-step prefill
            hit_reqs, hit_rows, miss_reqs, miss_rows = [], [], [], []
            for row, r, ids, eff in self._choose_rows(reqs):
                self._note_prefix(r, eff)
                if eff > 0:
                    self.engine.adopt_prefix(row, ids, eff)
                    r.prefill_pos = eff
                    hit_reqs.append(r)
                    hit_rows.append(row)
                else:
                    miss_reqs.append(r)
                    miss_rows.append(row)
            if hit_reqs:
                self._begin_chunked(hit_reqs, hit_rows)
            if miss_reqs:
                self._place_monolithic(miss_reqs, miss_rows)
            return
        self._place_monolithic(reqs, self._free_slots()[:len(reqs)])

    def _place_monolithic(self, reqs: List[Request],
                          rows: List[int]) -> None:
        t_pre = time.perf_counter() if self.tracer is not None else 0.0
        if self.obs is not None:
            self._obs_admit(reqs)
        max_p = max(r.feed_len for r in reqs)
        n_pad = _pad_pow2(len(reqs))
        s_pad = _pad_pow2(max_p, 8)
        toks = np.zeros((n_pad, s_pad), np.int32)
        plens = np.zeros((n_pad,), np.int32)
        for i, r in enumerate(reqs):
            # feed_tokens == prompt for a fresh request; a preempted one
            # resumes by prefilling its whole history
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
        tok0 = self._sample_tokens(
            last_logits, reqs + [None] * (n_pad - len(reqs)))
        for i, r in enumerate(reqs):
            r.status = Status.RUNNING
            r.start_step = self.step_idx
            r.slot = rows[i]
            t0 = int(tok0[i])
            r.generated.append(t0)
            self._last_tok[rows[i]] = t0
            if self.obs is not None:
                self._obs_first_token(r, rows[i])
            reason = r.finish_reason_for(t0)
            if reason is not None:
                self._finish_row(rows[i], r, reason)
            else:
                self.slots[rows[i]] = r
                if self._uses_chunks:
                    # a slot freed by a finished sequence was marked
                    # inactive: this readmission re-activates it
                    self.engine.set_row_active(rows[i], True)
                if self.spec is not None:
                    # the drafter has no KV for this fresh history yet
                    self._spec_dirty.add(rows[i])
        if self.prefix_cache:
            for row, r in zip(rows, reqs):
                if self.slots[row] is not None:
                    self.engine.register_prefix(row, r.feed_tokens)
        if self.tracer is not None:
            self._span("engine.prefill", t_pre, time.perf_counter(),
                       parent=self._admit_span)

    # ------------------------------------------------------------------ #
    # chunked prefill: an admitted prompt is PREFILLING and streams in
    # ``prefill_chunk``-token chunks (a prefix-cache hit on a monolithic
    # engine: its whole uncached suffix as one chunk), one per step,
    # queued as chunk work of the pipelined decode step (its KV goes to
    # the owning R-worker layer by layer).  It turns RUNNING the step its
    # last chunk lands (token 0 sampled from that chunk's last-valid
    # logits): decode for the rest of the batch never stalls on a prompt.
    # ------------------------------------------------------------------ #
    def _place_chunked(self, reqs: List[Request]) -> None:
        rows = []
        for row, r, ids, eff in self._choose_rows(reqs):
            if self.prefix_cache:
                self._note_prefix(r, eff)
            if eff > 0:
                # map the cached prefix pages (refcount++, no KV moves):
                # chunking resumes at the uncached suffix
                self.engine.adopt_prefix(row, ids, eff)
            r.prefill_pos = eff
            rows.append(row)
        self._begin_chunked(reqs, rows)

    def _begin_chunked(self, reqs: List[Request], rows: List[int]) -> None:
        if self.obs is not None:
            self._obs_admit(reqs)
        for row, r in zip(rows, reqs):
            r.status = Status.PREFILLING
            r.slot = row
            r.start_step = self.step_idx
            self.slots[row] = r
        self.engine.begin_prefill_rows(rows)

    def _queue_prefill_chunks(self) -> None:
        """Queue one chunk per prefilling sequence (one work per
        micro-batch) for the coming step.  With ``prefill_chunk=0`` (prefix
        hits on an otherwise monolithic engine) the chunk spans the whole
        remaining suffix, pow2-padded so the chunk graphs number O(log),
        not one per suffix length."""
        per_mb: Dict[int, List[int]] = {}
        for row, r in enumerate(self.slots):
            if r is not None and r.status is Status.PREFILLING:
                per_mb.setdefault(row // self.mb_size, []).append(row)
        for mb, rows in per_mb.items():
            c = self.prefill_chunk or _pad_pow2(
                max(self.slots[row].feed_len - self.slots[row].prefill_pos
                    for row in rows), 8)
            toks = np.zeros((len(rows), c), np.int32)
            bases, counts, locs = [], [], []
            for i, row in enumerate(rows):
                r = self.slots[row]
                base = r.prefill_pos
                cnt = min(c, r.feed_len - base)
                toks[i, :cnt] = r.feed_tokens[base:base + cnt]
                locs.append(row % self.mb_size)
                bases.append(base)
                counts.append(cnt)
            self.engine.queue_prefill_chunk(mb, locs, toks, bases, counts)

    def _process_prefill_results(self) -> None:
        """Advance prefill progress from the chunks that landed in the step
        just run; a sequence whose last chunk arrived samples token 0 from
        its logits and joins the decode batch."""
        for wk in self.engine.prefill_results:
            if wk.verify:
                continue          # a verify work: _spec_step's
            sampled = None
            for i, local in enumerate(wk.rows):
                row = wk.mb * self.mb_size + int(local)
                r = self.slots[row]
                if r is None or r.status is not Status.PREFILLING:
                    continue
                r.prefill_pos = int(wk.new_lens[i])
                if self.obs is not None:
                    r.mark("prefill_chunk", self.step_idx,
                           extra=r.prefill_pos)
                if r.prefill_pos < r.feed_len:
                    continue
                # the last chunk's last-token logits ARE the first
                # generation step (as the monolithic placement's)
                if sampled is None:
                    # the rows of this work whose last chunk just landed
                    # draw; every other row's logits are discarded
                    base = wk.mb * self.mb_size
                    elig = [None] * wk.logits.shape[0]
                    for j, loc in enumerate(wk.rows):
                        rr = self.slots[base + int(loc)]
                        if rr is not None \
                                and rr.status is Status.PREFILLING \
                                and int(wk.new_lens[j]) >= rr.feed_len:
                            elig[int(loc)] = rr
                    sampled = self._sample_tokens(wk.logits, elig)
                tok0 = int(sampled[int(local)])
                r.status = Status.RUNNING
                r.generated.append(tok0)
                self._last_tok[row] = tok0
                if self.obs is not None:
                    self._obs_first_token(r, row)
                reason = r.finish_reason_for(tok0)
                if reason is not None:
                    self._finish_row(row, r, reason)
                else:
                    self.engine.set_row_active(row, True)
                    if self.spec is not None:
                        # streamed straight to the R-workers: the drafter
                        # never saw this history
                        self._spec_dirty.add(row)
                    if self.prefix_cache:
                        # the written chain's pages are complete: index
                        # them for later admissions (token 0 was appended
                        # but never written to KV, hence the [:-1])
                        self.engine.register_prefix(row,
                                                    r.feed_tokens[:-1])

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
            r_st, s_st = D.split_block_state(eng.layers[li][0], st)
            for (wid, mb), (w, locs, gis) in groups.items():
                idx = torch.as_tensor(gis, dtype=torch.long,
                                      device=self.device)
                w.write_rows(eng._lkey(mb, li), np.asarray(locs),
                             {k: v[idx] for k, v in r_st.items()})
                # a recurrent block's conv window stays S-side
                eng.write_s_rows(mb, li, np.asarray(locs) + w.lo,
                                 {k: v[idx] for k, v in s_st.items()})
        lens = sub["lengths"].cpu().numpy()
        for gi, row in zip(sub_rows, rows):
            eng.set_row_length(int(row), int(lens[gi]))

    # ------------------------------------------------------------------ #
    # speculative decoding: each serving step drafts up to k tokens per
    # RUNNING row on the S-resident drafter, scores all k+1 candidates in
    # ONE pipelined verify chunk (their KV appended on the R-workers by
    # the verify op), commits the accepted prefix and truncates the
    # rejected tail's KV.  The drafter's own KV never holds a rejected
    # token where it is read: see _spec_draft.
    # ------------------------------------------------------------------ #
    def _spec_rows(self) -> List[Tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self.slots)
                if r is not None and r.status is Status.RUNNING]

    def _spec_sync_rows(self, live) -> None:
        """Re-feed dirty rows' WRITTEN history (feed_tokens[:-1], the chain
        the R-workers hold) through the drafter, so its KV agrees with the
        target's before drafting resumes."""
        rows = [row for row, _ in live if row in self._spec_dirty]
        if not rows:
            return
        lens = [self.slots[row].feed_len - 1 for row in rows]
        n_pad = _pad_pow2(len(rows))
        s_pad = _pad_pow2(max(lens), 8)
        toks = np.zeros((n_pad, s_pad), np.int32)
        plens = np.zeros((n_pad,), np.int32)
        for i, (row, ln) in enumerate(zip(rows, lens)):
            toks[i, :ln] = self.slots[row].feed_tokens[:ln]
            plens[i] = ln
        _, sub = M.prefill(self._spec_params, self._spec_cfg,
                           torch.from_numpy(toks).to(self.device),
                           torch.from_numpy(plens).to(self.device),
                           self._spec_cache)
        self._spec_state = M.scatter_rows(self._spec_state, sub,
                                          np.asarray(rows),
                                          np.arange(len(rows)))
        self._spec_dirty.difference_update(rows)

    def _spec_draft(self, live):
        """Greedy-draft up to k tokens per live row on the drafter.

        ``M.decode_step`` writes the drafter's KV IN PLACE (the JAX engine
        drafts on a throwaway copy, free under immutability; a copy here
        would move the whole drafter cache every step).  So drafting keeps
        the state and leaves its ``lengths`` as they were: draft j of a row
        of length L sits at position L+j, in a cache of cache_len + k slots
        that never wraps.  Until the commit (or the next draft) writes
        position L+j again, that entry is masked by causality: every later
        query of the row sits at a position below L+j or writes L+j first,
        and the commit's chunk attention masks stored positions >= its
        base.  Per-row draft length is capped so the committed chain never
        exceeds prompt + max_new_tokens (<= cache_len).

        One drafter decode step (with its argmax) is a graph over the
        static inputs ``cur``, ``lengths`` (a copy: the state's own stay),
        ``j`` and ``drafts``; it is replayed up to k times, each replay
        writing its token into column j of ``drafts`` and feeding it back
        as ``cur``."""
        k = self.spec.k
        k_row = {row: max(0, min(k, r.max_new_tokens
                                 - len(r.generated) - 1))
                 for row, r in live}
        drafts: Dict[int, List[int]] = {row: [] for row, _ in live}
        kmax = max(k_row.values())
        if kmax == 0:
            return drafts
        g = self._draft_graph
        if g is None:
            g = self._draft_graph = graphs.StepGraph(
                self._draft_body(), {
                    "j": torch.zeros((1,), dtype=torch.long,
                                     device=self.device),
                    "drafts": torch.zeros((self.batch, k),
                                          dtype=torch.int32,
                                          device=self.device)},
                self.engine._s_pool)
        g.feed({"cur": torch.from_numpy(self._last_tok[:, None].copy()),
                "lengths": self._spec_state["lengths"]})
        g.inputs["j"].zero_()
        for _ in range(kmax):
            g()
        nxt = g.inputs["drafts"][:, :kmax].cpu().numpy()
        for row, _ in live:
            drafts[row] = [int(t) for t in nxt[row, :k_row[row]]]
        return drafts

    def _draft_body(self):
        params, cfg, state = self._spec_params, self._spec_cfg, \
            self._spec_state

        def body(ins):
            st = {"stack": state["stack"], "rem": state["rem"],
                  "lengths": ins["lengths"]}
            logits, st = M.decode_step(params, cfg, st, ins["cur"])
            nxt = sample(logits)[:, None]
            ins["cur"].copy_(nxt)
            ins["lengths"].copy_(st["lengths"])
            ins["drafts"].index_copy_(1, ins["j"], nxt)
            ins["j"].add_(1)
            return {}
        return body

    def _spec_queue_verify(self, live, drafts) -> None:
        """Queue one verify chunk per micro-batch with live rows:
        candidates [pending token, draft_1..draft_kr] appended at the
        row's current KV length, in a chunk of the FIXED width k+1."""
        per_mb: Dict[int, List[int]] = {}
        for row, _r in live:
            per_mb.setdefault(row // self.mb_size, []).append(row)
        c = self.spec.k + 1
        for mb, rows in per_mb.items():
            toks = np.zeros((len(rows), c), np.int32)
            bases, counts, locs = [], [], []
            for i, row in enumerate(rows):
                cand = [int(self._last_tok[row])] + drafts[row]
                toks[i, :len(cand)] = cand
                locs.append(row % self.mb_size)
                bases.append(self.slots[row].feed_len - 1)
                counts.append(len(cand))
            self.engine.queue_prefill_chunk(mb, locs, toks, bases,
                                            counts, verify=True)

    def _spec_verify(self, live, drafts) -> List:
        """Run the queued verify (and any prefill) chunks in one chunk-only
        pipelined step under the step supervisor; returns the verify works
        (their logits [mb_size, k+1, V]).  On a StepFault the healer
        re-prefills every live row from token history (discarding any
        orphaned candidate appends) and the verify work is re-queued and
        re-run token-exactly: drafts are fixed by the drafter state and the
        sampling generator is untouched until commit.  The ``verify`` chaos
        site aborts after the candidates' KV append, before commit."""
        attempt, t_first = 0, 0.0
        while True:
            if live:
                self._spec_queue_verify(live, drafts)
            try:
                self.engine.decode_step(None)
                if self.chaos is not None and live \
                        and self.chaos.fire("verify", step=self.step_idx):
                    raise StepFault(
                        "chaos: verify step aborted before commit",
                        transient=True, step_no=self.step_idx)
            except StepFault as fault:
                if attempt == 0:
                    t_first = time.monotonic()
                attempt += 1
                self._heal_step_fault(fault, attempt)
                continue
            if attempt:
                self._note_recovered(attempt, time.monotonic() - t_first)
            return [wk for wk in self.engine.prefill_results if wk.verify]

    def _spec_commit_drafter(self, feeds: Dict[int, List[int]]) -> None:
        """Advance the drafter through each surviving row's committed
        tokens with one batched ragged ``prefill_chunk`` (rows fed no
        token are untouched), fixed width k+1: a graph over the static
        inputs ``tokens`` [batch, k+1] and ``counts`` [batch]; the chunk
        positions come from the drafter's lengths on the device."""
        c = self.spec.k + 1
        toks = np.zeros((self.batch, c), np.int32)
        counts = np.zeros((self.batch,), np.int32)
        for row, feed in feeds.items():
            toks[row, :len(feed)] = feed
            counts[row] = len(feed)
        if self._commit_graph is None:
            self._commit_graph = graphs.StepGraph(
                self._commit_body(c), {}, self.engine._s_pool)
        self._commit_graph.feed({"tokens": torch.from_numpy(toks),
                                 "counts": torch.from_numpy(counts)})
        self._commit_graph()

    def _commit_body(self, c: int):
        """The drafter's ``lengths`` tensor is itself the static buffer:
        the commit writes the new lengths into it in place."""
        params, cfg, state = self._spec_params, self._spec_cfg, \
            self._spec_state

        def body(ins):
            lengths = state["lengths"]
            off = torch.arange(c, dtype=torch.int32, device=lengths.device)
            pos = torch.where(off[None, :] < ins["counts"][:, None],
                              lengths[:, None] + off[None, :], -1)
            st = {"stack": state["stack"], "rem": state["rem"],
                  "lengths": lengths}
            _, st = M.prefill_chunk(params, cfg, st, ins["tokens"], pos)
            lengths.copy_(st["lengths"])
            return {}
        return body

    def _spec_step(self) -> int:
        """One speculative serving step: sync -> draft -> verify ->
        accept/commit -> truncate.  Returns tokens committed batch-wide
        (greedy rows bit-exact with non-speculative greedy decoding,
        sampled rows through rejection sampling, exact in
        distribution)."""
        live = self._spec_rows()
        if not live and not self.engine._prefill_inbox:
            return 0
        drafts: Dict[int, List[int]] = {}
        if live:
            self._spec_sync_rows(live)
            drafts = self._spec_draft(live)
        obs = self.obs
        if obs is not None:
            for row, r in live:
                r.mark("draft", self.step_idx, extra=len(drafts[row]))
                obs.spec_drafted.inc(len(drafts[row]))
        vworks = self._spec_verify(live, drafts)
        lg_of: Dict[int, torch.Tensor] = {}
        for wk in vworks:
            for local in wk.rows:
                row = wk.mb * self.mb_size + int(local)
                cnt = len(drafts.get(row, ())) + 1
                lg_of[row] = wk.logits[int(local), :cnt]
        t_now = time.perf_counter() if obs is not None else 0.0
        emitted = 0
        trunc_rows: List[int] = []
        trunc_lens: List[int] = []
        finish: List[Tuple[int, Request, str]] = []
        feeds: Dict[int, List[int]] = {}
        for row, r in live:
            d = drafts[row]
            base = r.feed_len - 1              # KV length before verify
            # a greedy row draws nothing from the generator
            toks, acc = spec_accept(
                lg_of[row], d,
                self.generator if r.temperature > 0.0 else None,
                temperature=r.temperature, top_k=r.top_k, top_p=r.top_p)
            self.spec_stats["drafted_tokens"] += len(d)
            self.spec_stats["accepted_tokens"] += acc
            if obs is not None:
                r.mark("verify", self.step_idx, extra=len(d) + 1)
                r.mark("accept", self.step_idx, extra=acc)
                obs.spec_accepted.inc(acc)
            c0 = int(self._last_tok[row])
            m, reason, walked = 0, None, []
            for t in toks:
                r.generated.append(t)
                walked.append(t)
                m += 1
                emitted += 1
                if obs is not None:
                    r.mark("token", self.step_idx, t_now)
                    obs.generated.inc()
                reason = r.finish_reason_for(t)
                if reason is not None:
                    break                      # stop token outranks cap
            if obs is not None:
                # one gap per row and step: a burst of up to k+1 tokens
                prev = self._tok_t[row]
                if prev > 0.0:
                    obs.inter_token.observe(t_now - prev)
                self._tok_t[row] = t_now
            # the committed chain's KV = feed_tokens[:-1]: positions
            # base..base+m-1 hold [c0, accepted drafts]; the rest goes
            trunc_rows.append(row)
            trunc_lens.append(base + m)
            if reason is not None:
                finish.append((row, r, reason))
            else:
                self._last_tok[row] = walked[-1]
                feeds[row] = [c0] + walked[:-1]
        if trunc_rows:
            # BEFORE retiring finished rows: parking indexes the written
            # chain, so the rejected tail must already be gone
            self.engine.truncate_rows(trunc_rows, trunc_lens)
        for row, r, reason in finish:
            self._finish_row(row, r, reason)
        if feeds:
            self._spec_commit_drafter(feeds)
        self.spec_stats["steps"] += 1
        return emitted

    # ------------------------------------------------------------------ #
    # fleet hooks: exact re-prefill of lost rows, admission re-costing and
    # prefix re-indexing after a topology change
    # ------------------------------------------------------------------ #
    def _replay_rows(self, rows) -> int:
        """Recompute lost R-state exactly by running prefill on the token
        history of the live sequences among global ``rows`` (the lost KV
        is a deterministic function of it), through ``write_rows``, which
        resets each row's table and length (paged) or its whole slab row
        (dense).  The last sampled token stays in ``_last_tok``: it has not
        been appended to any KV yet.  A half-prefilled sequence replays
        its streamed prefix (``prefill_pos`` tokens)."""
        live = [(int(r), self.slots[int(r)]) for r in rows
                if self.slots[int(r)] is not None]
        live = [(r, req) for r, req in live
                if req.status is not Status.PREFILLING
                or req.prefill_pos > 0]       # nothing streamed yet
        if not live or self.backend != "hetero":
            return 0
        lens = [req.prefill_pos if req.status is Status.PREFILLING
                else req.feed_len - 1 for _, req in live]
        n_pad = _pad_pow2(len(live))
        s_pad = _pad_pow2(max(lens), 8)
        toks = np.zeros((n_pad, s_pad), np.int32)
        plens = np.zeros((n_pad,), np.int32)
        for i, ((_, req), ln) in enumerate(zip(live, lens)):
            toks[i, :ln] = req.feed_tokens[:ln]
            plens[i] = ln
        _, sub = M.prefill(
            self.params, self.cfg, torch.from_numpy(toks).to(self.device),
            torch.from_numpy(plens).to(self.device), self.cache_len)
        self._hetero_scatter(np.asarray([r for r, _ in live]), sub,
                             np.arange(len(live)))
        self.replayed_rows += len(live)
        return len(live)

    def _recost_admission(self, weight_frac: float) -> None:
        """The surviving fleet does R-Part work at ``weight_frac`` of the
        planned rate: scale Algorithm 1's peak bound with it (paged page
        budgets re-cost themselves from the live allocators)."""
        if self.load_ctl is not None and self._w_lim0 is not None:
            self.load_ctl.w_lim = self._w_lim0 * max(0.0, weight_frac)

    def _reregister_prefixes(self) -> None:
        """A migration or recovery rebuilt the changed workers'
        allocators, dropping their prefix indexes (the per-row wire format
        un-shares pages): re-index every live row's written chain so later
        admissions share again."""
        for row, r in enumerate(self.slots):
            if r is None:
                continue
            n = (r.prefill_pos if r.status is Status.PREFILLING
                 else r.feed_len - 1)   # the last sampled token is unwritten
            if n > 0:
                self.engine.register_prefix(row, r.feed_tokens[:n])

    # ------------------------------------------------------------------ #
    # the step supervisor: decode_step aborts with a typed StepFault after
    # fencing the sink; this layer owns the token history, so it rebuilds
    # a consistent KV state and retries the SAME step with the SAME tokens
    # (the sampling generator is drawn from only after a step returns)
    # ------------------------------------------------------------------ #
    def _rids_of_mb(self, mb: int) -> List[int]:
        """Request ids resident in micro-batch ``mb`` (for the pipelined
        engine's stall messages)."""
        lo = int(mb) * self.mb_size
        return [r.rid for r in self.slots[lo:lo + self.mb_size]
                if r is not None]

    def _decode_supervised(self, toks) -> torch.Tensor:
        """The pipelined decode step under the supervisor: on a StepFault,
        heal and retry until the step lands or the retry budget is spent.
        Other exceptions propagate untouched: they are bugs, not faults."""
        split = [toks[m * self.mb_size:(m + 1) * self.mb_size]
                 for m in range(self.num_mb)]
        attempt, t_first = 0, 0.0
        while True:
            try:
                parts = self.engine.decode_step(split)
            except StepFault as fault:
                if attempt == 0:
                    t_first = time.monotonic()
                attempt += 1
                self._heal_step_fault(fault, attempt)
                continue
            if attempt:
                self._note_recovered(attempt, time.monotonic() - t_first)
            return torch.cat(parts, dim=0)

    def _heal_step_fault(self, fault: StepFault, attempt: int) -> None:
        """One recovery round for an aborted step.  Re-raises when the
        fault cannot be healed (a deterministic worker error, no survivor
        to adopt rows, the retry budget spent)."""
        self.faults += 1
        implicated = tuple(sorted(set(fault.dead_wids)
                                  | set(fault.hung_wids)))
        self.fault_events.append({
            "step": self.step_idx, "attempt": attempt,
            "kind": type(fault).__name__, "implicated": list(implicated),
            "lost": list(fault.lost_wids),
            "transient": bool(fault.transient), "msg": str(fault)})
        if self.obs is not None:
            self.obs.faults.inc()
            for r in self.slots:
                if r is not None:
                    r.mark("fault", self.step_idx)
        if self.fleet is not None:
            self.fleet.telemetry.record_event(
                self.step_idx, "fault", fault_kind=type(fault).__name__,
                attempt=attempt, implicated=list(implicated),
                transient=bool(fault.transient))
        # a deterministic worker-side error (no dead or hung worker, not
        # transient) would fail the same way again: surface it
        if fault.wid is not None and not fault.transient \
                and not implicated:
            raise fault
        if attempt > self.max_step_retries:
            raise fault
        # suspicion is not conviction: a worker flagged hung may only be
        # stalled on one slow item.  Grant a grace window, which a real
        # hang outlasts and a straggler does not, and spare a worker that
        # finishes its item or shows a fresh heartbeat: that costs the
        # step's retry, not a failover
        to_remove = []
        grace = max(self.engine.suspect_after_s, 0.05)
        for wid in implicated:
            w = next((w for w in self.engine.workers if w.wid == wid), None)
            if w is None:
                continue                    # already failed over
            if wid in fault.hung_wids and w.is_alive():
                deadline = time.monotonic() + grace
                spared = False
                while time.monotonic() < deadline:
                    if not w.processing or (time.monotonic()
                                            - w.heartbeat) <= grace:
                        spared = True
                        break
                    time.sleep(0.01)
                if spared:
                    self.spared_workers += 1
                    continue
            to_remove.append(wid)
        # survivors may still run stale items of the aborted step: their
        # posts are fenced off, their KV appends are not, so wait for
        # quiescence before exporting or overwriting any state
        self._quiesce_workers(skip=to_remove)
        for wid in to_remove:
            widx = next((i for i, w in enumerate(self.engine.workers)
                         if w.wid == wid), None)
            if widx is None:
                continue
            self.engine.workers[widx].kill()
            if len(self.engine.workers) <= 1:
                raise fault      # no survivor to adopt its rows
            if self.fleet is not None:
                self.fleet.handle_failure(
                    widx, reprefill=self._replay_rows,
                    on_topology=self._recost_admission)
            else:
                self.engine.remove_worker(widx)
        if not to_remove:
            # transient (a dropped completion, a pool or tier hiccup, a
            # spared straggler): a short escalating backoff
            time.sleep(min(0.5,
                           self.retry_backoff_s * (2 ** (attempt - 1))))
        self._resync_after_fault()

    def _quiesce_workers(self, skip=(), timeout_s: float = 5.0) -> None:
        """Wait (bounded) until the live workers have drained their inboxes
        and stepped off any item; each worker finishes its stream before it
        posts or fails, so then no device work of theirs is in flight.
        Implicated workers are skipped: a hung one would pin the wait."""
        deadline = time.monotonic() + timeout_s
        for w in self.engine.workers:
            if w.wid in skip or not w.is_alive():
                continue
            while ((not w.inq.empty() or w.processing)
                   and time.monotonic() < deadline):
                time.sleep(0.001)

    def _resync_after_fault(self) -> None:
        """Rebuild a cross-layer-consistent KV state after an aborted step
        (some layers hold its append, some not): re-prefill EVERY live row
        from token history (orphaned appends overwritten, tables and
        lengths reset), then re-arm chunked prefill from each sequence's
        streamed position."""
        rows = [r for r, req in enumerate(self.slots) if req is not None]
        if rows:
            self._replay_rows(rows)
        if self.spec is not None:
            # the drafter (S-side) was not touched by the fault; a resync
            # of every row keeps draft and verify on the same histories
            self._spec_dirty.update(rows)
        fresh = [r for r, req in enumerate(self.slots)
                 if req is not None and req.status is Status.PREFILLING
                 and req.prefill_pos == 0]
        if fresh:
            self.engine.begin_prefill_rows(fresh)
        if self._uses_chunks:
            # the aborted step consumed the queued chunks without applying
            # their progress: requeue from prefill_pos
            self.engine._prefill_inbox.clear()
            self._queue_prefill_chunks()

    def _note_recovered(self, attempts: int, mttr_s: float) -> None:
        self.recoveries += 1
        self.fault_events.append({
            "step": self.step_idx, "kind": "recovered",
            "attempts": attempts, "mttr_s": mttr_s})
        if self.obs is not None:
            self.obs.recovered.inc()
            self.obs.mttr.observe(mttr_s)
            for r in self.slots:
                if r is not None:
                    r.mark("recovered", self.step_idx)
        if self.fleet is not None:
            self.fleet.telemetry.record_event(
                self.step_idx, "recovered", attempts=attempts,
                mttr_s=mttr_s)

    # ------------------------------------------------------------------ #
    def step(self) -> StepRecord:
        pc = time.perf_counter
        tracer = self.tracer
        t_step = pc()
        if tracer is not None:
            # the id every span of this step names as its (grand)parent
            self._step_span = tracer.next_id()
            self._admit_span = tracer.next_id()
            if self.backend == "hetero":
                self.engine.span_parent = self._step_span
        fleet_wall = 0.0
        if self.fleet is not None:
            t0 = pc()
            self.fleet.pre_step(reprefill=self._replay_rows,
                                on_topology=self._recost_admission)
            t1 = pc()
            fleet_wall += t1 - t0
            if tracer is not None:
                self._span("engine.fleet", t0, t1)
        if self.backend == "hetero":
            topo = tuple(self.engine.slices)
            if topo != self._topo_seen:
                self._topo_seen = topo
                if self.prefix_cache:
                    # a migration or recovery rebuilt allocators: re-index
                    # live rows' prompts before this step's probes
                    self._reregister_prefixes()
                if self.obs is not None:
                    for r in self.slots:
                        if r is not None:
                            r.mark("migrated", self.step_idx)
                            self.obs.migrated.inc()
        t_admit = pc()
        n = self._admit_count()
        if self.preempt_after and self.paged_kv:
            # admission pressure: queued work, free slots, but the page
            # budget said no: after preempt_after such steps, park the
            # least-finished row so its pages (restorable) make room; the
            # victim requeues and resumes token-exactly
            if n == 0 and self.queue and self._free_slots():
                self._stall_steps += 1
                if self._stall_steps >= self.preempt_after:
                    self._auto_preempt()
                    self._stall_steps = 0
            else:
                self._stall_steps = 0
        if n > 0:
            reqs = [self.queue.popleft() for _ in range(n)]
            self._place(reqs)
        if self._uses_chunks:
            self._queue_prefill_chunks()
        # one stamp ends the admission and starts the decode
        t_up = pc()
        prefill_wall = t_up - t_admit
        if tracer is not None:
            self._span("engine.admit", t_admit, t_up, sid=self._admit_span)

        if self.spec is not None:
            # speculative decoding replaces decode + sample wholesale:
            # draft on the S-resident drafter, score the candidates in one
            # chunk-only pipelined step (queued prefill chunks ride it and
            # count as decode time here, as in the JAX engine), commit the
            # accepted prefix
            emitted = self._spec_step()
            self.last_logits = None
            decode_wall = pc() - t_up
            prefill_wall += self._land_prefill_chunks()
            return self._record(n, prefill_wall, decode_wall, emitted,
                                fleet_wall, t_step)
        toks = torch.from_numpy(self._last_tok[:, None].copy()).to(
            self.device)
        if tracer is not None:
            self._span("engine.upload", t_up, pc())
        if self.backend == "hetero":
            logits = self._decode_supervised(toks)
        else:
            logits = self.engine.decode_step(toks)
        self.last_logits = logits
        t_sample = pc() if tracer is not None else 0.0
        new_tok = self._sample_tokens(
            logits, [r if r is not None and r.status is Status.RUNNING
                     else None for r in self.slots])
        t_emit = pc()
        decode_wall = t_emit - t_up
        if tracer is not None:
            self._span("engine.sample", t_sample, t_emit)
        if self.backend == "hetero":
            # chunk work inside the pipelined step (S-side chunk time that
            # held no decode micro-batch back, and waits that served only
            # chunk work) is prefill time, not decode time
            chunk_s = self.engine.last_step_stats.get("prefill_s", 0.0)
            decode_wall -= min(chunk_s, decode_wall)
            prefill_wall += chunk_s

        t_now = t_emit
        emitted = 0
        for i, r in enumerate(self.slots):
            if r is None or r.status is not Status.RUNNING:
                continue            # PREFILLING rows own no decode token
            tok = int(new_tok[i])
            r.generated.append(tok)
            self._last_tok[i] = tok
            emitted += 1
            if self.obs is not None:
                self._obs_token(r, i, t_now)
            reason = r.finish_reason_for(tok)
            if reason is not None:
                self._finish_row(i, r, reason)
        prefill_wall += self._land_prefill_chunks()
        if tracer is not None:
            self._span("engine.emit", t_emit, pc())
        return self._record(n, prefill_wall, decode_wall, emitted,
                            fleet_wall, t_step)

    def _land_prefill_chunks(self) -> float:
        """After the token loop (a sequence whose last chunk landed this
        step decodes its first real token NEXT step: this step's logits
        for its row predate the transition), the seconds it took."""
        if not self._uses_chunks:
            return 0.0
        t0 = time.perf_counter()
        self._process_prefill_results()
        return time.perf_counter() - t0

    def _record(self, admitted: int, prefill_wall: float,
                decode_wall: float, emitted: int,
                fleet_wall: float, t_step: float) -> StepRecord:
        tracer = self.tracer
        if self.fleet is not None:
            t0 = time.perf_counter()
            self.fleet.post_step(self.step_idx)
            t1 = time.perf_counter()
            fleet_wall += t1 - t0
            if tracer is not None:
                self._span("engine.fleet", t0, t1)
        obs = self.obs
        if obs is not None and obs.drift is not None:
            obs.drift.observe_step(
                wall_s=decode_wall, tokens=emitted,
                step_stats=self.engine.step_stats,
                num_workers=len(self.engine.workers))
        rec = StepRecord(self.step_idx, prefill_wall, decode_wall,
                         fleet_wall, sum(r is not None for r in self.slots),
                         self.resident_len(), admitted)
        self.records.append(rec)
        if tracer is not None:
            tracer.add("engine.step", "engine", "s-worker", t_step,
                       time.perf_counter(), id=self._step_span,
                       step=self.step_idx)
        self.step_idx += 1
        return rec

    def paged_resident_bytes(self) -> float:
        """Current page-backed KV bytes on the R-workers (paged_kv only):
        referenced, cached and parked pages."""
        return self.engine.paged_resident_bytes() if self.paged_kv else 0.0

    def hotpath_stats(self) -> Dict[str, float]:
        """Cumulative decode hot-path breakdown of the pipelined engine
        (dispatch / collect / S-dispatch / R-wait seconds, step count);
        empty for the colocated backend.  Schema keys (``steps_count``
        ...), the legacy spellings (``steps``, ``ooo_advances``) still
        resolve.  After a topology change it also counts the graphs the
        changed workers re-captured and their seconds (``recapture_count``,
        ``recapture_s``)."""
        out = dict(getattr(self.engine, "step_stats", {}) or {})
        if self.backend == "hetero" and self.engine.topology_changes:
            out.update(self.engine.recapture_stats())
        return schema.normalize(out)

    def prefix_cache_stats(self) -> Dict[str, float]:
        """Admission-level hit counters plus allocator-level sharing state
        (pages shared by > 1 row, refcount-zero cached and parked pages).
        Schema keys (``hits_count`` ...), the legacy spellings (``hits``
        ...) still resolve."""
        out: Dict[str, float] = dict(self.prefix_stats)
        if self.backend == "hetero":
            out.update(self.engine.prefix_cache_stats())
        denom = max(1, out.get("prompt_tokens", 0))
        out["token_hit_rate"] = out.get("cached_tokens", 0) / denom
        return schema.normalize(out)

    def tiering_stats(self) -> Dict[str, float]:
        """Host-tier traffic counters (swap-outs, restores, simulated
        stream seconds) plus engine-side preemptions and the seconds the
        port's real page copies took (``swap_out_copy_s``: device to host
        at swap-out, ``restore_copy_s``: host to device at a restore);
        empty when tiering is off.  Schema keys (``restore_count`` ...),
        the legacy spellings (``restored`` ...) still resolve."""
        if self.kv_tier is None:
            return {}
        out: Dict[str, float] = dict(self.kv_tier.stats)
        out["swapped_pages"] = self.kv_tier.swapped_pages()
        out["host_bytes"] = self.kv_tier.nbytes()
        out["preemptions"] = self.preemptions
        for key in ("swap_out_copy_s", "restore_copy_s"):
            out[key] = sum(a.copy_stats[key] for w in self.engine.workers
                           for a in w.allocators.values())
        return schema.normalize(out)

    # -- the observability surface ----------------------------------------- #
    def metrics(self) -> Dict[str, float]:
        """One flat snapshot of what the engine measures: the registry's
        metrics (TTFT / queue-wait / inter-token / end-to-end histograms
        with p50/p90/p99, lifecycle counters) plus every stats surface
        under a namespace prefix (``hotpath_``, ``prefix_``, ``tier_``,
        ``drift_``).  All keys follow ``obs.schema``; with observability
        off the registry part is absent."""
        out: Dict[str, float] = {}
        if self.obs is not None:
            out.update(self.obs.registry.snapshot())
            if self.obs.tracer is not None:
                out["trace_spans_count"] = float(self.obs.tracer.added)
            if self.obs.drift is not None:
                out.update(self.obs.drift.report().as_metrics())
        out["steps_count"] = float(self.step_idx)
        out["queue_depth_count"] = float(len(self.queue))
        out["active_count"] = float(sum(r is not None for r in self.slots))
        out["resident_tokens"] = float(self.resident_len())
        out["preemptions_count"] = float(self.preemptions)
        out["fault_count"] = float(self.faults)
        out["recovered_count"] = float(self.recoveries)
        for k, v in self.hotpath_stats().items():
            out[f"hotpath_{k}"] = float(v)
        if self.prefix_cache:
            for k, v in self.prefix_cache_stats().items():
                out[f"prefix_{k}"] = float(v)
        if self.kv_tier is not None:
            for k, v in self.tiering_stats().items():
                out[f"tier_{k}"] = float(v)
        if self.fleet is not None:
            for k, v in schema.normalize(
                    self.fleet.telemetry.summary()).items():
                out[f"fleet_{k}"] = float(0.0 if v is None else v)
        return schema.StatsDict(out)

    def export_trace(self, path: str) -> str:
        """Write the pipeline span trace as Chrome trace-event JSON (open
        in Perfetto or chrome://tracing).  Needs observability with spans
        on."""
        if self._obs_obj is None or self._obs_obj.tracer is None:
            raise RuntimeError(
                "no span tracer — construct the engine with "
                "observability=True (or ObsConfig(spans=True))")
        return self._obs_obj.tracer.export(path)

    def drift_report(self):
        """The perfmodel drift monitor's measured-vs-predicted residuals
        (``obs.drift.DriftReport``); needs observability with drift on,
        on the hetero backend."""
        if self._obs_obj is None or self._obs_obj.drift is None:
            raise RuntimeError(
                "no drift monitor — construct a hetero engine with "
                "observability=True (or ObsConfig(drift=True))")
        return self._obs_obj.drift.report()

    def request_timeline(self, rid: int) -> List[Tuple]:
        """The lifecycle events of a finished, resident or queued request
        (empty unless observability was on while it ran)."""
        for r in self.finished:
            if r.rid == rid:
                return list(r.events)
        for r in list(self.slots) + list(self.queue):
            if r is not None and r.rid == rid:
                return list(r.events)
        raise KeyError(f"unknown request id {rid}")

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
        if self.spec is not None:
            with graphs.dropping():
                self._draft_graph = self._commit_graph = None
