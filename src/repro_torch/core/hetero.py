"""The FastDecode heterogeneous runtime for the port (§4.1, Fig. 4-5;
counterpart of repro.core.hetero).

One S-worker (the caller's thread, on the device's current stream) owns
all weights and computes the S-Part of every layer; ``num_r_workers``
R-workers (threads) own the per-sequence KV (or a recurrent block's
state h) of a contiguous slice of each micro-batch and compute the
parameter-free R-Part near it.  Per layer and token step only
activations cross: q, k, v out, o back (q out, o back for a
cross-attention; a, b -> h for an RG-LRU block; x, dt, B, C -> y for an
SSD block).  A block is a chain of phases (``decompose.num_phases``): a
DEC_XATTN block's self-attention phase is followed by its
cross-attention phase on the same layer before the next layer starts.
Two or more micro-batches are in flight, so while the R-workers attend
for micro-batch A the S-worker advances micro-batch B.

The hot path is event-driven: every R-worker posts finished work to one
shared :class:`CompletionSink` and the S-worker advances whichever
micro-batch completes first (``schedule="ooo"``) or in issue order
(``"fifo"``).  On the card each R-worker issues its work on a CUDA
stream of its own.  A dispatch records an event on the S-stream after
the payload is computed and the worker waits on it before touching the
payload; the worker keeps the payload alive until its own stream has
finished with it (it synchronises before posting), so memory made on
the S-stream is never reused under a running R-Part.  Results travel
device -> pinned host -> device through the sink: that round trip is the
protocol of the design (R-workers may be remote), and its cost is
measured rather than short-cut.

Each fixed-shape step callable is a CUDA graph on the card
(``core/graphs.StepGraph``, the role ``jax.jit`` plays in repro): the
S-side start, the fused ``s_advance(li) -> s_pre(li+1)`` transitions (a
DEC_XATTN layer's phase-0 -> phase-1 transition too) and the logits head
per micro-batch, and each R-worker's R-Part per (micro-batch, layer,
phase) (and per table width for a paged verify).  Graphs
are captured on first use and replayed over static buffers: the
gathered r_out lands in a transition's own input, payload shards are
row views of its outputs, and the block tables live in one fixed device
buffer per allocator.  Host work (table growth, the D2H copy and the
synchronise before posting) stays outside the graphs.

Chunk work (``queue_prefill_chunk``) rides the same machinery: a queued
work item runs inside the next ``decode_step`` as a virtual micro-batch
``num_mb + i``, through the same tags, sink and event loop; its payloads
carry a ``valid`` mask [rows, C].  A plain chunk is chunked prefill: C
prompt tokens per row streamed to the R-workers layer by layer while the
other rows decode, the last layer returning each row's logits at its
last valid position.  A verify work (``verify=True``, its payloads
marked ``verify``) is the speculative-decode scoring step: C candidate
tokens per row, every position's logits back (``decode_step(None)`` runs
a chunk-only step).  Paged storage runs a prefill chunk through
``paged_cache.r_attention_paged_chunk`` and a verify through the
multi-token verify kernels; dense storage runs both through
``decompose.r_dispatch_chunk`` (``kv_cache.r_attention_int8_chunk`` on
int8 storage).

Shared-prefix KV reuse and tiering (paged storage): each (worker,
micro-batch) allocator counts references per page, so one resident page
can back the prompt prefix of many rows (``probe_prefix`` /
``adopt_prefix`` / ``register_prefix``), and a write landing in a shared
page first clones it: the allocator hands the step's (src, dst) pairs
out once, and the worker copies them into every paged layer's pool on
its own stream, after the host grow and before the replay.  With a
``kv_tier`` a finished or preempted row parks its pages (``park_row``),
the eviction ladder swaps parked pages out to host memory, and a probe
restores them; every page copy runs on the owning worker's stream, and
the pools are written in place (the R-Part graphs baked their
addresses).

Observability (``attach_tracer``): with a ``SpanTracer`` attached, the
S-worker records one span per (step, micro-batch, layer, phase) R-Part
round trip (dispatch -> last worker's completion) and one per step, and
each R-worker its busy windows.  Spans are host times around dispatches,
replays and the sink's waits, recorded outside every captured graph body;
they add no device synchronisation, and with no tracer attached the cost
is one attribute read per step.

Fleet management and fault supervision (``fleet=``, ``chaos=``): each
R-worker keeps a heartbeat and a ``processing`` flag; the collect loop
polls the sink in short slices and, on every empty window, suspects the
workers that still owe completions (dead, hung past ``suspect_after_s``,
or idle with an empty inbox for ``suspect_strikes`` windows: a lost
message) and aborts the step with a typed :class:`StepFault` after
fencing the sink; a worker's error post becomes a :class:`WorkerStepError`.
The serving layer heals them.  ``apply_partition`` live-migrates rows in
the dense wire format (``RWorker.export_rows``: numpy arrays, bf16 as its
``uint16`` bit pattern, gathered from the pages on the device in one
``index_select`` per pool array and copied to pinned host memory once),
checksummed and verified; ``remove_worker`` fails a worker over.  A
worker whose rows change releases its R-Part graphs and their pool
(``RWorker.reassign``) and re-captures them on its next step.  No S-side
graph bakes the partition: the shards are row views of a transition's
outputs, cut on the host per call.  A removed worker's graphs are freed
only once its thread has exited (``_reap_retired``, or ``close``): a
hung worker wakes, finds itself killed and returns without replaying.
"""
from __future__ import annotations

import queue
import threading
import time
import warnings
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.chaos.checksum import tree_digest
from repro_torch.chaos.plan import ChaosComputeError
from repro_torch.core import decompose as D
from repro_torch.core import graphs
from repro_torch.core.config import (ATTN, DEC_XATTN, RGLRU, SSD, XATTN,
                                     ModelConfig, check_supported)
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving import kv_cache as KV
from repro_torch.serving import paged_cache as PC


# ---------------------------------------------------------------------------
# step faults: typed aborts the serving supervisor can heal
# ---------------------------------------------------------------------------
class StepFault(RuntimeError):
    """A decode step aborted mid-flight.

    Raised from the collect loop after the sink has been fenced (the epoch
    bump makes every in-flight completion of the aborted step stale), so
    the engine is quiescent but its per-layer state is inconsistent
    across layers: some layers appended this step's KV, some did not.
    The serving layer's supervisor heals that by re-prefilling every live
    row from token history and retrying the step with the same tokens.

    ``dead_wids`` / ``hung_wids`` name workers to fail over; ``lost_wids``
    workers suspected of a dropped completion (retry without removal);
    ``transient`` marks the fault safe to retry as is."""

    def __init__(self, msg: str, *, dead_wids: Sequence[int] = (),
                 hung_wids: Sequence[int] = (),
                 lost_wids: Sequence[int] = (),
                 wid: Optional[int] = None,
                 transient: bool = False, step_no: int = -1):
        super().__init__(msg)
        self.dead_wids = tuple(dead_wids)
        self.hung_wids = tuple(hung_wids)
        self.lost_wids = tuple(lost_wids)
        self.wid = wid
        self.transient = bool(transient)
        self.step_no = int(step_no)


class CollectTimeout(StepFault):
    """The collect loop gave up waiting: a pending worker is dead, hung
    past the suspicion threshold, or its completions went missing."""


class WorkerStepError(StepFault):
    """An R-worker posted an exception for this step (``__cause__``
    carries the original, with its ``r_worker_context`` coordinates)."""


# ---------------------------------------------------------------------------
# params / state layout helpers
# ---------------------------------------------------------------------------
def per_layer_params(params, cfg: ModelConfig) -> List[Tuple[str, Any]]:
    """[(kind, layer_params)] in layer order (views of the stack)."""
    return list(zip(cfg.pattern, M.per_layer(params, cfg)))


def per_layer_state(state, cfg: ModelConfig) -> List[Any]:
    return M.per_layer(state, cfg)


def batch_slice(tree: Dict, lo: int, hi: int) -> Dict:
    return {k: v[lo:hi] for k, v in tree.items()}


def rin_slice(r_in: dict, lo: int, hi: int) -> dict:
    """Rows [lo, hi) of a payload; the per-head constants
    (``decompose.RIN_BROADCAST``) go whole."""
    return {k: (v if k in D.RIN_BROADCAST else v[lo:hi])
            for k, v in r_in.items()}


def shard_rin(r_in: dict, slices) -> tuple:
    """Per-worker ``r_in`` shards (row-slice views, no copies)."""
    return tuple(rin_slice(r_in, lo, hi) for lo, hi in slices)


def _frontend_feats(cfg: ModelConfig, enc_feats, device):
    """``enc_feats`` for ``load_prefill`` on ``device``: an early-fusion
    arch's patch embeddings, a cross-attention arch's patch or frame
    embeddings (``M.prefill``); an arch with no frontend refuses them."""
    if enc_feats is None:
        return None
    if cfg.frontend == "none":
        raise NotImplementedError(
            f"enc_feats: {cfg.name} has no frontend (neither early fusion "
            f"nor cross-attention) to take features")
    return torch.as_tensor(enc_feats, device=device)


def mask_rows(new: Dict, old: Dict, active) -> Dict:
    """Row-gated state update: rows with active=False keep their old
    value."""
    return {k: torch.where(active.reshape((-1,) + (1,) * (n.dim() - 1)),
                           n, old[k]) for k, n in new.items()}


# a transition's outputs that stay S-side: the block's carry (the residual
# ``h``, and a recurrent block's ``gate`` or ``z``), named apart from the
# payload
_CARRY = "carry."


def _graph_carry(carry: Dict) -> Dict:
    """A carry as a transition graph's inputs: the residual as ``resid``
    (an RG-LRU's R result is ``h`` too)."""
    return {("resid" if k == "h" else k): v for k, v in carry.items()}


def _carry_of(ins: Dict, carry: Dict) -> Dict:
    """The carry ``D.s_advance`` takes (the keys of ``carry``), from a
    transition graph's inputs ``ins``."""
    return {k: ins["resid" if k == "h" else k] for k in carry}


def _phase_out(po: "D.PhaseOut") -> Dict:
    """A phase's outputs as a transition graph returns them: the payload
    without its statics (lengths, valid) and the carry under ``_CARRY``
    names."""
    out = {k: v for k, v in po.r_in.items() if k not in ("lengths", "valid")}
    out.update({_CARRY + k: v for k, v in po.carry.items()})
    return out


def _r_out_of(ins: Dict, kind: str) -> Dict:
    """The R result of a ``kind`` block from a graph's inputs: attention's
    ``o``, the RG-LRU's fp32 ``h`` [B, W] or the SSD's fp32 ``y``
    [B, H, P] (with a chunk dimension in chunk works)."""
    key = D.R_OUT_KEY[kind]
    return {key: ins[key]}


class CompletionSink:
    """The single completion channel shared by the R-workers of one
    engine.

    A worker finishing ``(mb, layer, phase)`` copies its ``r_out`` shard
    to host memory on its own thread, scatters it into a preallocated
    per-(step parity, micro-batch, layer, phase) host buffer at its row
    slice, and posts a small ``(wid, tag, err)`` token to one queue.  The
    S-worker pops tokens in completion order; ``gather`` copies the
    assembled buffer into the consuming graph's r_out input.  On the card
    the buffers are pinned host memory.  They are double-buffered on step
    parity, and ``epoch`` fences aborted steps: posts of an older epoch
    are dropped before they touch a buffer.
    """

    def __init__(self, mb_size: int, device):
        self.mb_size = int(mb_size)
        self.device = torch.device(device)
        self.pin = self.device.type == "cuda"
        self.q: "queue.Queue" = queue.Queue()
        self.epoch = 0
        self._lock = threading.Lock()
        self._bufs: Dict[Tuple, Dict[str, torch.Tensor]] = {}

    def _buffer(self, key, host: Dict[str, torch.Tensor]):
        # caller (post) holds self._lock.  A key's payload layout may change
        # between the steps that share its parity: a virtual micro-batch
        # carries [rows, prefill_chunk, ...] for a prefill work in one step
        # and [rows, k+1, ...] for a verify work two steps later, so a
        # buffer of another layout is replaced (every worker of one step
        # posts the same layout; the old buffer's last gather ran two steps
        # ago)
        buf = self._bufs.get(key)
        if buf is None or any(
                k not in buf or buf[k].shape[1:] != v.shape[1:]
                or buf[k].dtype != v.dtype for k, v in host.items()):
            buf = {k: torch.empty((self.mb_size,) + tuple(v.shape[1:]),
                                  dtype=v.dtype, pin_memory=self.pin)
                   for k, v in host.items()}
            self._bufs[key] = buf
        return buf

    def post(self, wid: int, tag, host: Dict[str, torch.Tensor],
             lo: int, hi: int) -> None:
        epoch, parity, mb, li, phase = tag
        # the epoch check and the buffer write are one critical section
        # with fence(); only the small host memcpy is under the lock
        with self._lock:
            if epoch != self.epoch:
                return                   # fenced-off straggler
            buf = self._buffer((parity, mb, li, phase), host)
            for k, v in host.items():
                buf[k][lo:hi].copy_(v)
        self.q.put((wid, tag, None))

    def post_error(self, wid: int, tag, err: BaseException) -> None:
        with self._lock:
            if tag[0] != self.epoch:
                return
        self.q.put((wid, tag, err))

    def gather(self, tag, into: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """Copy the assembled r_out of ``tag`` into ``into`` (a graph's
        static r_out inputs; one copy per leaf on the caller's stream, and
        a new device tensor for a leaf ``into`` lacks).  The
        double-buffered host buffer is not rewritten before this copy has
        run: it is reused two steps later, after every R-worker has waited
        on work issued behind it."""
        _, parity, mb, li, phase = tag
        buf = self._bufs[(parity, mb, li, phase)]
        for k, v in buf.items():
            if k in into:
                into[k].copy_(v, non_blocking=True)
            else:
                into[k] = v.to(self.device, non_blocking=True, copy=True)
        return into

    def fence(self) -> None:
        """Invalidate all in-flight work: bump the epoch and drain the
        already-posted completions."""
        with self._lock:
            self.epoch += 1
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                return


# ---------------------------------------------------------------------------
# R-worker
# ---------------------------------------------------------------------------
class RWorker(threading.Thread):
    """Owns the R-Part state of batch rows [lo, hi) of every micro-batch,
    for every layer.

    ``quantized=True`` stores attention KV as int8 + per-(token, head)
    fp32 scales (paper §5.2): ~3.9x less R-side memory traffic at Dh 128,
    attention still accumulated in fp32 (kv_cache.r_attention_int8 on
    dense storage, int8 page pools on paged storage).

    ``paged=True`` stores attention KV block-granular: per micro-batch one
    host-side ``PagedAllocator`` (one block table for all the layers) and
    one device page pool per layer.  ``num_pages`` sizes ONE pool; pools
    are replicated per (attention layer, micro-batch).  Windowed attention
    stays dense (its rotated ring cannot be expressed in derived
    positions).  Composes with ``quantized`` (int8 page pools).
    ``prefix_cache`` makes the allocators refcounted copy-on-write with a
    prefix index; ``kv_tier`` (the engine-global ``paged_cache.HostTier``)
    adds park / swap-out / restore and implies the prefix index.

    ``sim_row_cost`` (seconds per row per call, settable while serving)
    makes a deterministic bandwidth-bound straggler: after each R-Part the
    worker sleeps that long per row it owns, on the host, outside the
    replayed graph; ``slowdown`` stretches each item to that multiple of
    its time, ``sim_deliver_jitter`` delays each post by a seeded uniform
    [0, j) seconds without holding the worker (``fleet.WorkerProfile``'s
    knobs).  ``chaos`` (a ``chaos.FaultPlan``) arms the ``r_step`` and
    ``completion`` sites and, through the allocators, ``pool``.

    Liveness for the collect loop's suspicion check: ``heartbeat``
    advances on every inbox wake and item boundary and ``processing`` is
    True while an item runs, so a stale heartbeat with ``processing`` set
    reads as hung mid-item, and ``processing`` False with an empty inbox
    but completions owed as a message lost in flight.

    An item with no sink is a legacy request (``decode_step_legacy``):
    its R-Part runs eager, never as a graph, and the device ``r_out``
    goes back on ``outq`` with an event recorded after it on this
    worker's stream.  ``profile_timing`` synchronises that stream after
    each R-Part, before the D2H copy or the reply, so ``busy_time``
    holds the R-Part's device time (without it a legacy item's
    ``busy_time`` is its host enqueue only).
    """

    def __init__(self, wid: int, cfg: ModelConfig, lo: int, hi: int,
                 kv_chunk: int = 1024, quantized: bool = False,
                 paged: bool = False,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 max_pages_per_seq: Optional[int] = None,
                 prefix_cache: bool = False, kv_tier: Any = None,
                 profile: Any = None, slowdown: float = 1.0,
                 sim_row_cost: float = 0.0, sim_deliver_jitter: float = 0.0,
                 chaos: Any = None, profile_timing: bool = False,
                 device=None):
        super().__init__(daemon=True, name=f"r-worker-{wid}")
        self.wid, self.cfg, self.lo, self.hi = wid, cfg, lo, hi
        self.kv_chunk = kv_chunk
        self.quantized = quantized
        self.paged = paged
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self.num_pages = num_pages
        self.kv_tier = kv_tier
        self.prefix_cache = prefix_cache or kv_tier is not None
        self.device = resolve_device(device)
        # the worker's own CUDA stream; None on the CPU
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._stage: Dict[Tuple, torch.Tensor] = {}   # pinned D2H staging
        # the R-Part graphs, keyed by ("d", layer) for a decode, and by
        # ("c", layer, C[, table width]) for a prefill chunk and ("v",
        # layer, C[, table width]) for a verify (the width on paged
        # storage), in one pool on the worker's stream
        self._pool = graphs.GraphPool(self.device, self.stream)
        self._graphs: Dict[Tuple, graphs.StepGraph] = {}
        # (rows, S) -> the all-zero key positions of a cross-attention
        # slab (``D.cross_pos``): made once outside any capture, read by
        # every cross-attention R-Part graph of that shape
        self._cross_pos: Dict[Tuple[int, int], torch.Tensor] = {}
        self._cache_len = 0                      # set at first state load
        self.state: Dict[int, Any] = {}          # layer key -> r_state
        self.paged_keys: set = set()             # layer keys stored paged
        self.allocators: Dict[int, PC.PagedAllocator] = {}   # mb -> alloc
        self._first_paged: Dict[int, Any] = {}   # mb -> min paged key
        # (mb, "c" or "v") -> the table width (a power of two of pages) of
        # this step's prefill chunk or verify work: one step may carry both
        # for one micro-batch, on disjoint rows, each with its own width
        self._chunk_width: Dict[Tuple[int, str], int] = {}
        # (mb, "d" | "c" | "v") -> this step's CoW (src, dst) pairs, taken
        # from the allocator on the micro-batch's first paged layer and
        # applied to every paged layer's pool
        self._step_clones: Dict[Tuple[int, str], list] = {}
        self.inq: "queue.Queue" = queue.Queue()
        # legacy (FIFO) replies: (tag, r_out on the device, event), or
        # (tag, exception, None)
        self.outq: "queue.Queue" = queue.Queue()
        self.profile_timing = bool(profile_timing)
        self.busy_time = 0.0
        self.profile = profile                   # fleet.WorkerProfile
        self.slowdown = max(1.0, float(slowdown))
        self.sim_row_cost = max(0.0, float(sim_row_cost))  # s/row/call
        self.sim_deliver_jitter = max(0.0, float(sim_deliver_jitter))
        self._jitter_rng = np.random.default_rng(0xD15C0 + wid)
        # set via HeteroPipelineEngine.attach_tracer, never constructed here
        self.tracer = None
        self.chaos = chaos
        self._killed = False
        self.heartbeat = time.monotonic()
        self.processing = False
        # a graph's first call (on the card its warm-up and capture): the
        # longest, which suspect_after_s must exceed, and those after a
        # topology change released this worker's graphs (``reassign``)
        self.capture_max_s = 0.0
        self._released = False
        self.recapture_count = 0
        self.recapture_s = 0.0

    # -- paged storage helpers ----------------------------------------------
    def _pageable(self, st) -> bool:
        # a payload from a quantized worker carries k_q instead of k; a
        # DEC_XATTN state (with its cross-KV "xk") keeps the dense slab,
        # as in repro
        return (self.paged and self.cfg.window == 0 and isinstance(st, dict)
                and ("k" in st or "k_q" in st) and "pos" in st
                and "xk" not in st)

    def _alloc(self, mb: int) -> PC.PagedAllocator:
        if mb not in self.allocators:
            rows = self.hi - self.lo
            mp = self.max_pages_per_seq or -(-self._cache_len
                                             // self.page_size)
            alloc = PC.PagedAllocator(
                rows, self.num_pages or rows * mp, self.page_size, mp,
                prefix_cache=self.prefix_cache, tier=self.kv_tier,
                chaos=self.chaos, device=self.device)
            # a swap-out reads this micro-batch's layer pools, on this
            # worker's stream
            alloc.pool_reader = lambda mb=mb: {
                lk % self.cfg.num_layers: self.state[lk]
                for lk in self.paged_keys
                if lk // self.cfg.num_layers == mb}
            alloc.stream = self.stream
            self.allocators[mb] = alloc
        return self.allocators[mb]

    def _to_pages(self, layer: int, rows: np.ndarray, r_state_rows):
        mb = layer // self.cfg.num_layers
        alloc = self._alloc(mb)
        if layer not in self.paged_keys:
            fp = "k" in r_state_rows
            ref = r_state_rows["k"] if fp else r_state_rows["k_q"]
            hkv, dh = ref.shape[2:]
            self.state[layer] = PC.init_page_pool(
                alloc.num_pages, self.page_size, hkv, dh,
                dtype=ref.dtype if fp else torch.float32,
                device=self.device, quantized=self.quantized)
            self.paged_keys.add(layer)
            self._first_paged[mb] = None         # recompute lazily
        self.state[layer] = PC.dense_rows_to_pages(
            self.state[layer], alloc, rows, r_state_rows)

    def release_rows(self, mb: int, rows) -> None:
        """Return finished rows' pages to the pool (continuous batching)."""
        alloc = self.allocators.get(mb)
        if alloc is not None:
            for r in rows:
                alloc.release(int(r))

    def paged_resident_bytes(self) -> float:
        """Bytes of KV occupying pool pages (all layers): row-referenced
        pages plus refcount-zero cached and parked pages, which hold live
        KV until the ladder reclaims them."""
        total = 0.0
        for layer in self.paged_keys:
            alloc = self.allocators[layer // self.cfg.num_layers]
            total += ((alloc.used_pages() + alloc.cached_pages()
                       + alloc.parked_pages()) * self.page_size
                      * PC.page_pool_token_bytes(self.state[layer]))
        return total

    def pool_bytes(self) -> int:
        """Device bytes of every page pool this worker holds (allocated
        capacity, scratch pages included)."""
        return sum(t.numel() * t.element_size()
                   for layer in self.paged_keys
                   for t in self.state[layer].values())

    # -- state loading (S-worker thread, between decode steps) ---------------
    def _coerce_storage(self, st):
        """(De)quantize an attention payload to this worker's storage
        format: a quantized worker stores an fp payload as int8 + scales
        and keeps an int8 payload verbatim; an fp worker dequantizes an
        int8 payload."""
        if self.quantized and "k" in st:
            return KV.quantize_attn_state(st)
        if not self.quantized and "k_q" in st:
            return KV.dequantize_attn_state(st)
        return st

    def load_state(self, layer: int, r_state_slice) -> None:
        # a graph of this layer read the buffers this load replaces
        with graphs.dropping():
            self._graphs = {k: g for k, g in self._graphs.items()
                            if k[1] != layer}
        if self._pageable(r_state_slice):
            if "k_q" in r_state_slice and not self.quantized:
                r_state_slice = KV.dequantize_attn_state(r_state_slice)
            ref = r_state_slice.get("k", r_state_slice.get("k_q"))
            self._cache_len = ref.shape[1]
            self._to_pages(layer, np.arange(ref.shape[0]), r_state_slice)
            return
        r_state_slice = self._coerce_storage(r_state_slice)
        self.state[layer] = {k: v.clone() for k, v in r_state_slice.items()}

    def write_rows(self, layer: int, rows: np.ndarray, r_state_rows) -> None:
        """Continuous batching: replace finished rows with fresh prefixes."""
        if layer in self.paged_keys and self._pageable(r_state_rows):
            self._to_pages(layer, rows, r_state_rows)
            return
        r_state_rows = self._coerce_storage(r_state_rows)
        idx = torch.as_tensor(rows, dtype=torch.long, device=self.device)
        for k, v in r_state_rows.items():
            self.state[layer][k][idx] = v

    # -- migration wire format (live migration, KV snapshots) ----------------
    def export_rows(self, layer: int, local_rows: np.ndarray
                    ) -> Dict[str, np.ndarray]:
        """``local_rows``' R-state of ``layer`` as host numpy arrays in the
        dense wire format: what a dense worker stores per row ({k, v,
        pos}, or {k_q, k_s, v_q, v_s, pos} from a quantized worker), bf16
        as its ``uint16`` bit pattern.  Paged rows come back as contiguous
        ``[row, cache_len, ...]`` slabs with derived positions, so any
        worker can install the payload with ``load_state`` whatever its
        own storage.  Runs between steps on the engine thread; the reads
        are ordered on this worker's stream, which is then finished."""
        local_rows = np.asarray(local_rows)
        with PC.on_stream(self.stream):
            if layer in self.paged_keys:
                dev = self._pages_to_dense(layer, local_rows)
            else:
                idx = torch.as_tensor(local_rows, dtype=torch.long,
                                      device=self.device)
                dev = {k: v.index_select(0, idx)
                       for k, v in self.state[layer].items()}
            host = {k: (torch.empty(v.shape, dtype=v.dtype,
                                    pin_memory=True).copy_(v)
                        if self.stream is not None else v)
                    for k, v in dev.items()}
        if self.stream is not None:
            self.stream.synchronize()
        return {k: bridge.tensor_to_numpy(v) for k, v in host.items()}

    def _pages_to_dense(self, layer: int, rows: np.ndarray
                        ) -> Dict[str, torch.Tensor]:
        """The rows' pages of ``layer`` gathered on the device into dense
        slabs: one ``index_select`` per pool array over every row's page
        list, positions past a row's length zeroed (``pos`` -1) as the JAX
        package's host loop leaves them.  An inactive row exports nothing;
        a degraded (pool-exhausted) row its stored prefix."""
        alloc = self.allocators[layer // self.cfg.num_layers]
        pool = self.state[layer]
        page, cap = self.page_size, self._cache_len
        n_pg = -(-cap // page)
        ids = np.zeros((len(rows), n_pg), np.int64)
        lens = np.zeros((len(rows),), np.int64)
        for i, row in enumerate(rows):
            row = int(row)
            if not alloc.active[row]:
                continue
            mapped = int((alloc.tables[row] >= 0).sum())
            length = min(int(alloc.lengths[row]), mapped * page, cap)
            if length <= 0:
                continue
            used = -(-length // page)
            ids[i, :used] = alloc.tables[row, :used]
            lens[i] = length
        dev = PC._any_pages(pool).device
        idx = torch.from_numpy(ids.reshape(-1)).to(dev)
        lens_t = torch.from_numpy(lens).to(dev)
        ar = torch.arange(cap, device=dev)
        keep = ar[None, :] < lens_t[:, None]                   # [R, cap]
        out = {}
        for k, v in pool.items():
            g = v.index_select(0, idx).reshape(
                (len(rows), n_pg * page) + tuple(v.shape[2:]))[:, :cap]
            m = keep.reshape(keep.shape + (1,) * (g.dim() - 2))
            out[k] = torch.where(m, g, torch.zeros((), dtype=g.dtype,
                                                   device=dev))
        out["pos"] = torch.where(keep, ar[None, :].to(torch.int32),
                                 torch.full((), -1, dtype=torch.int32,
                                            device=dev))
        return out

    def reassign(self, lo: int, hi: int) -> None:
        """Adopt a new row slice: drop ALL row-indexed storage (state,
        page pools, allocators) and the R-Part graphs with their pool,
        which baked this slice's buffers; the next step re-captures them.
        The caller (``apply_partition``) re-installs every layer's rows
        with ``load_state`` right after; runs between steps.  Parked
        pages are flushed to the host tier first, so park / restore
        survives the move."""
        for alloc in self.allocators.values():
            alloc.swap_out_all_parked()
        if self.stream is not None:
            self.stream.synchronize()
        self.lo, self.hi = int(lo), int(hi)
        self.state.clear()
        self.paged_keys.clear()
        self.allocators.clear()
        self._first_paged.clear()
        self._chunk_width.clear()
        self._step_clones.clear()
        self._cross_pos.clear()
        self.release_graphs()
        self._pool = graphs.GraphPool(self.device, self.stream)
        self._released = True

    def release_graphs(self) -> None:
        """Free this worker's R-Part graphs and staging buffers, on the
        calling thread, which must not be capturing (and this worker must
        not be running an item)."""
        with graphs.dropping():
            self._graphs.clear()
        self._stage.clear()

    def kill(self) -> None:
        """An abrupt crash (tests, chip runs): the thread exits without
        draining its queue; ``is_alive()`` turning False is what the fleet
        health check detects.  A worker asleep in a hang wakes, finds
        itself killed and returns without replaying."""
        self._killed = True
        self.inq.put(None)

    # -- the R-Part ------------------------------------------------------------
    def _first_paged_key(self, mb: int) -> int:
        if self._first_paged.get(mb) is None:
            self._first_paged[mb] = min(
                k for k in self.paged_keys
                if k // self.cfg.num_layers == mb)
        return self._first_paged[mb]

    def _apply_clones(self, layer: int, mb: int, mode: str) -> None:
        """Copy this step's CoW pairs of (mb, mode) into ``layer``'s pool,
        in place, on the current (this worker's) stream: before the
        replay that writes the fresh pages."""
        clones = self._step_clones.get((mb, mode))
        if clones:
            PC.clone_pool_pages(self.state[layer], clones)

    def _grow_paged(self, layer: int, r_in) -> None:
        """Host side of a paged decode, outside the graph.  All of a
        micro-batch's layers share one allocator and equal lengths, so the
        table grow — and with it the one device->host sync of the lengths
        — runs only on the micro-batch's FIRST paged layer each step (its
        CoW clones are taken there and applied to every layer); the table
        upload (``tables_device``, a copy into the fixed device buffer on
        this worker's stream) only after a host mutation."""
        mb = layer // self.cfg.num_layers
        alloc = self.allocators[mb]
        if layer == self._first_paged_key(mb):
            act = r_in.get("active")
            alloc.ensure_lengths(r_in["lengths"].cpu().numpy() + 1,
                                 mask=None if act is None
                                 else act.cpu().numpy())
            self._step_clones[(mb, "d")] = alloc.take_clones()
        self._apply_clones(layer, mb, "d")
        alloc.tables_device()

    def _grow_paged_chunk(self, layer: int, r_in, mode: str) -> int:
        """Host side of a chunk work on paged storage, a prefill chunk
        (``mode`` "c", repro's ``_step_paged_chunk``) or a speculative-
        decode verify ("v", ``_step_paged_verify``): on the micro-batch's
        first paged layer, grow the shared block tables for the chunk's
        tokens (one device->host sync of the payload's lengths and mask; a
        row starting at offset 0 is re-admitted fresh) and choose the power
        of two of the used pages as the table width the R-Part sweeps (a
        row's pages are a contiguous table prefix, so later columns are
        unmapped: the sweep then costs O(longest row), not O(capacity), at
        the price of one graph per width).  The width is kept per (mb,
        mode): a step may carry a prefill chunk and a verify work of one
        micro-batch.  Returns that width."""
        mb = layer // self.cfg.num_layers
        alloc = self.allocators[mb]
        if layer == self._first_paged_key(mb):
            alloc.append_chunk(r_in["lengths"].cpu().numpy(),
                               r_in["valid"].cpu().numpy().sum(axis=1))
            self._step_clones[(mb, mode)] = alloc.take_clones()
            used = int((alloc.tables >= 0).sum(axis=1).max())
            k = 1
            while k < used:
                k *= 2
            self._chunk_width[(mb, mode)] = min(k, alloc.max_pages)
        self._apply_clones(layer, mb, mode)
        alloc.tables_device()
        return self._chunk_width[(mb, mode)]

    def _r_body(self, key, kind: str, phase: int):
        """The R-Part of ``key`` as a graph body over its payload: the
        storage's append + attend, KV updated in place (a
        cross-attention's read of its static slab, through kernel 2 on
        the card)."""
        layer = key[1]
        st, cfg = self.state[layer], self.cfg
        win, cap = cfg.window, cfg.attn_logit_softcap
        if layer in self.paged_keys:
            tables = self.allocators[layer // cfg.num_layers].tables_device()
            if key[0] == "v":
                width = key[3]

                def body(r_in):
                    return PC.r_attention_paged_verify(
                        r_in, st, tables[:, :width].contiguous(),
                        window=win, softcap=cap)[0]
            elif key[0] == "c":
                width = key[3]

                def body(r_in):
                    return PC.r_attention_paged_chunk(
                        r_in, st, tables[:, :width].contiguous(),
                        window=win, softcap=cap, kv_chunk=self.kv_chunk)[0]
            else:
                def body(r_in):
                    return PC.r_attention_paged_tables(
                        r_in, st, tables, window=win, softcap=cap)[0]
        elif key[0] != "d" and self.quantized and kind == ATTN:
            def body(r_in):
                return KV.r_attention_int8_chunk(
                    r_in, st, window=win, softcap=cap,
                    kv_chunk=self.kv_chunk)[0]
        elif key[0] != "d":
            def body(r_in):
                return D.r_dispatch_chunk(kind, phase, r_in, st, cfg,
                                          self.kv_chunk)[0]
        elif self.quantized and kind == ATTN:
            def body(r_in):
                return KV.r_attention_int8(r_in, st, window=win,
                                           softcap=cap)[0]
        else:
            pos = None
            if kind == XATTN or (kind == DEC_XATTN and phase == 1):
                rows, s_enc = st["xk"].shape[:2]
                pos = self._cross_pos.get((rows, s_enc))
                if pos is None:
                    pos = self._cross_pos[(rows, s_enc)] = D.cross_pos(
                        rows, s_enc, self.device)

            def body(r_in):
                return D.r_dispatch(kind, phase, r_in, st, cfg,
                                    self.kv_chunk, pos)[0]
        return body

    def _to_host(self, r_out: Dict[str, torch.Tensor]):
        if self.stream is None:
            return r_out
        host = {}
        for k, v in r_out.items():
            key = (k, tuple(v.shape), v.dtype)
            buf = self._stage.get(key)
            if buf is None:
                buf = self._stage[key] = torch.empty(
                    v.shape, dtype=v.dtype, pin_memory=True)
            buf.copy_(v, non_blocking=True)
            host[k] = buf
        # the payload (r_in, made on the S-stream) and every tensor of this
        # item stay referenced until here, so no stream reuses them early
        self.stream.synchronize()
        return host

    def run(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._killed:
            # a bounded wait, not a bare get(): the idle heartbeat tick
            # tells "alive but idle" from "hung mid-item"
            try:
                items = [self.inq.get(timeout=0.25)]
            except queue.Empty:
                self.heartbeat = time.monotonic()
                continue
            # one wake serves everything already queued; ``processing``
            # stays set until the whole batch is done, so an empty inbox
            # with ``processing`` clear means no item is left to run (the
            # supervisor's quiescence test)
            while True:
                try:
                    items.append(self.inq.get_nowait())
                except queue.Empty:
                    break
            self.processing = True
            try:
                for item in items:
                    if item is None or self._killed:
                        return
                    self.heartbeat = time.monotonic()
                    self._run_one(item)
                    self.heartbeat = time.monotonic()
            finally:
                self.processing = False
                self.heartbeat = time.monotonic()

    def _chaos_r_step(self, tag, layer, kind, phase, sink):
        """The ``r_step`` and ``completion`` sites of one item: returns
        None when the item must not run (crashed, errored, killed while
        hung), else the completion fault's kind ("drop", "dup" or "")."""
        spec = self.chaos.fire("r_step", wid=self.wid, layer=layer,
                               phase=phase)
        if spec is not None:
            if spec.kind == "crash":
                # abrupt death mid-item: no completion, no error post
                self._killed = True
                return None
            if spec.kind == "error":
                e = ChaosComputeError("injected R-step compute fault")
                e.r_worker_context = (self.wid, layer, kind, phase)
                self._post_error(sink, tag, e)
                return None
            if spec.kind == "hang":
                # stall with processing set and a stale heartbeat; a
                # worker failed over meanwhile returns without replaying
                # (its pools are no longer the engine's), a short hang
                # completes late
                time.sleep(spec.hang_s)
                if self._killed:
                    return None
        spec = self.chaos.fire("completion", wid=self.wid, layer=layer,
                               phase=phase)
        return "" if spec is None else spec.kind

    def _post_error(self, sink, tag, err: BaseException) -> None:
        if sink is None:
            self.outq.put((tag, err, None))
        else:
            sink.post_error(self.wid, tag, err)

    def _run_legacy(self, key, kind: str, phase: int, r_in):
        """A legacy item's R-Part, eager on this worker's stream: returns
        the device r_out and an event recorded after it (None on the
        CPU).  The payload, made on the S-stream, is marked in use by this
        stream so its memory outlives the R-Part."""
        out = self._r_body(key, kind, phase)(r_in)
        if self.stream is None:
            return out, None
        for v in r_in.values():
            v.record_stream(self.stream)
        done = torch.cuda.Event()
        done.record(self.stream)
        return out, done

    def _run_one(self, item) -> None:
        tag, layer, kind, phase, r_in, sink, ready = item
        fault = ""
        if self.chaos is not None:
            fault = self._chaos_r_step(tag, layer, kind, phase, sink)
            if fault is None:
                return
        try:
            t0 = time.perf_counter()
            ctx = (torch.cuda.stream(self.stream) if self.stream is not None
                   else nullcontext())
            with ctx:
                if ready is not None:
                    self.stream.wait_event(ready)
                # a chunk payload carries its validity mask; a verify
                # payload also the ``verify`` marker (as in repro), which
                # routes it to the verify R-Part
                if "valid" in r_in:
                    mode = "v" if "verify" in r_in else "c"
                    r_in = {k: v for k, v in r_in.items() if k != "verify"}
                    key = (mode, layer, r_in["valid"].shape[1])
                    if layer in self.paged_keys:
                        key += (self._grow_paged_chunk(layer, r_in, mode),)
                else:
                    # a later phase of the layer (DEC_XATTN's
                    # cross-attention) has a graph of its own
                    key = ("d", layer) + ((phase,) if phase else ())
                    if layer in self.paged_keys:
                        self._grow_paged(layer, r_in)
                if sink is None:
                    out, done = self._run_legacy(key, kind, phase, r_in)
                elif key not in self._graphs:
                    g = self._graphs[key] = graphs.StepGraph(
                        self._r_body(key, kind, phase), r_in, self._pool)
                    tc = time.perf_counter()
                    out = g()
                    tc = time.perf_counter() - tc
                    self.capture_max_s = max(self.capture_max_s, tc)
                    if self._released:
                        self.recapture_count += 1
                        self.recapture_s += tc
                else:
                    g = self._graphs[key]
                    g.feed(r_in)
                    out = g()
                if self.profile_timing and self.stream is not None:
                    # outside any capture: the graph call has returned
                    self.stream.synchronize()
                host = None if sink is None else self._to_host(out)
            dt = time.perf_counter() - t0
            if self.slowdown > 1.0:
                # a worker with 1/slowdown the bandwidth takes slowdown x
                # as long for the same rows
                time.sleep(dt * (self.slowdown - 1.0))
                dt *= self.slowdown
            if self.sim_row_cost > 0.0:
                # deterministic bandwidth-bound service time: streams its
                # rows' KV at sim_row_cost seconds per row
                extra = self.sim_row_cost * (self.hi - self.lo)
                time.sleep(extra)
                dt += extra
            self.busy_time += dt
            tracer = self.tracer
            if tracer is not None:
                # busy window on this worker's own track (the straggler's
                # sleep included, so it renders as a longer span)
                tracer.add(f"L{layer}.p{phase}", "r-worker",
                           f"r{self.wid}", t0, t0 + dt,
                           {"layer": layer, "phase": phase, "kind": kind})
            if sink is None:
                self.outq.put((tag, out, done))
            elif fault == "drop":
                # the KV append above is DONE (and the allocator grown);
                # only the completion is lost: the supervisor's resync
                # re-prefills the rows, overwriting the orphaned append
                pass
            elif fault == "dup":
                # duplicated delivery: the scatter is idempotent and the
                # collect loop tolerates the second token
                sink.post(self.wid, tag, host, self.lo, self.hi)
                sink.post(self.wid, tag, host, self.lo, self.hi)
            elif self.sim_deliver_jitter > 0.0:
                # a late delivery over a jittery link: the worker moves on
                # (its staging buffers with it, so the post gets a copy)
                delay = float(self._jitter_rng.uniform(
                    0.0, self.sim_deliver_jitter))
                late = {k: v.clone() for k, v in host.items()}
                t = threading.Timer(delay, sink.post,
                                    args=(self.wid, tag, late, self.lo,
                                          self.hi))
                t.daemon = True
                t.start()
            else:
                sink.post(self.wid, tag, host, self.lo, self.hi)
        except Exception as e:  # surface to the S-worker, don't deadlock
            if self.stream is not None:
                # what this item enqueued finishes before the supervisor
                # may read or overwrite the pools
                self.stream.synchronize()
            e.r_worker_context = (self.wid, layer, kind, phase)
            self._post_error(sink, tag, e)

    def stop(self) -> None:
        self.inq.put(None)


# ---------------------------------------------------------------------------
# the pipelined engine
# ---------------------------------------------------------------------------
@dataclass
class _PrefillChunk:
    """One queued chunk of work for micro-batch ``mb``.

    Full-micro-batch tensors (rows not fed carry valid=False everywhere:
    they write nothing, their compute is discarded), so the chunk rides
    the same per-layer S-steps and CompletionSink tags as a decode
    micro-batch: it IS a decode step with a sequence dimension.  ``vmb``
    is the virtual micro-batch id routing its completions (>= num_mb,
    assigned per decode_step).  A plain work is a chunked-prefill chunk:
    the last layer returns each row's logits at its last valid position,
    [mb_size, V].  ``verify`` marks speculative-decode scoring: the last
    layer returns every position's logits [mb_size, C, V]."""
    mb: int
    tokens: torch.Tensor         # [mb_size, C] int32
    base: torch.Tensor           # [mb_size] int32: per-row KV offset
    valid: torch.Tensor          # [mb_size, C] bool
    rows: np.ndarray             # local rows being fed
    new_lens: np.ndarray         # base + count per entry of rows
    logits: Any = None           # set once the last layer lands
    vmb: int = -1
    verify: bool = False


class HeteroPipelineEngine:
    """S-worker + R-workers, ``num_microbatches`` in flight (Fig. 5b)."""

    def __init__(self, params, cfg: ModelConfig, *, batch: int,
                 cache_len: int, num_r_workers: int = 2,
                 num_microbatches: int = 2, kv_chunk: int = 1024,
                 quantized_kv: bool = False, paged_kv: bool = False,
                 page_size: int = 16, pages_per_worker: Optional[int] = None,
                 schedule: str = "ooo", collect_timeout_s: float = 600.0,
                 prefix_cache: bool = False, kv_tier: Any = None,
                 fleet: Any = None, chaos: Any = None,
                 suspect_after_s: float = 120.0, suspect_strikes: int = 2,
                 profile_timing: bool = False, device=None):
        if num_microbatches < 1:
            raise ValueError(
                f"num_microbatches must be >= 1, got {num_microbatches}")
        if schedule not in ("ooo", "fifo"):
            raise ValueError(
                f"schedule must be 'ooo' (advance whichever micro-batch "
                f"completes first) or 'fifo' (advance in issue order), "
                f"got {schedule!r}")
        if collect_timeout_s <= 0:
            raise ValueError(
                f"collect_timeout_s must be > 0, got {collect_timeout_s}")
        if batch < 1 or cache_len < 1:
            raise ValueError(
                f"batch ({batch}) and cache_len ({cache_len}) must be >= 1")
        if batch % num_microbatches != 0:
            raise ValueError(
                f"batch ({batch}) must be divisible by num_microbatches "
                f"({num_microbatches}); round batch up to "
                f"{-(-batch // num_microbatches) * num_microbatches} or "
                f"change num_microbatches")
        check_supported(cfg)
        if quantized_kv and DEC_XATTN in cfg.layer_pattern:
            # repro takes the option and fails at the first decode step:
            # the int8 storage quantizes the DEC_XATTN state's k / v, and
            # only ATTN blocks reach the int8 R-Part, so the plain
            # self-attention phase finds no k
            raise ValueError(
                f"quantized_kv=True does not support {cfg.name}: its "
                f"DEC_XATTN blocks' self-attention has no int8 R-Part "
                f"(only ATTN blocks do); serve it with quantized_kv=False")
        self.device = resolve_device(device)
        self.params, self.cfg = params, cfg
        self.batch = batch
        self.mb_size = batch // num_microbatches
        self.num_mb = num_microbatches
        self.cache_len = cache_len
        self.paged_kv = paged_kv
        self.page_size = page_size
        # the engine-global host tier every (worker, micro-batch) allocator
        # swaps to; it implies the prefix index (its key space)
        self.kv_tier = kv_tier if paged_kv else None
        self.prefix_cache = (prefix_cache or self.kv_tier is not None) \
            and paged_kv
        self.layers = per_layer_params(params, cfg)
        self.num_layers = cfg.num_layers
        self.schedule = schedule
        self.collect_timeout_s = float(collect_timeout_s)
        self.fleet = fleet
        # fault injection and suspicion: a pending worker that is dead,
        # hung past suspect_after_s (stale heartbeat while processing), or
        # idle with an empty inbox for suspect_strikes consecutive polls
        # (a completion lost in flight) aborts the step with a StepFault;
        # collect_timeout_s stays the absolute backstop.  suspect_after_s
        # must exceed the longest single R-side item, graph captures
        # included, or a healthy worker is failed over (correct, wasteful)
        self.chaos = chaos
        self.suspect_after_s = float(suspect_after_s)
        self.suspect_strikes = max(1, int(suspect_strikes))
        # serving-layer hook: mb -> in-flight request ids, for the stall
        # messages
        self.rids_of = None
        # global rows whose migration payload failed its checksum in the
        # last apply_partition (installed from `lost`; the serving layer
        # re-prefills them)
        self.corrupt_rows: List[int] = []
        # the last topology change: rows moved, wire bytes, seconds
        self.last_migration: Dict[str, float] = {}
        self.topology_changes = 0
        # workers removed from the fleet whose threads may still run (a
        # hung one wakes later): their graphs are freed once they exit
        self._retired: List[RWorker] = []
        # re-captures of removed workers whose graphs were freed: kept
        # after they leave ``_retired`` so the totals never go back
        self._reaped_recaptures = [0, 0.0]
        self._worker_kwargs = dict(
            kv_chunk=kv_chunk, quantized=quantized_kv, paged=paged_kv,
            page_size=page_size, num_pages=pages_per_worker,
            max_pages_per_seq=-(-cache_len // page_size),
            prefix_cache=self.prefix_cache, kv_tier=self.kv_tier,
            chaos=chaos, profile_timing=profile_timing, device=self.device)
        if fleet is not None:
            # the fleet owns worker construction: profiles -> planned
            # (possibly uneven) partition -> RWorkers
            self.workers, self.slices = fleet.spawn_workers(
                cfg, self.mb_size, self._worker_kwargs)
        else:
            if num_r_workers < 1:
                raise ValueError(
                    f"num_r_workers must be >= 1, got {num_r_workers}")
            if num_r_workers > self.mb_size:
                raise ValueError(
                    f"num_r_workers ({num_r_workers}) exceeds the "
                    f"micro-batch size ({self.mb_size} = batch {batch} / "
                    f"{num_microbatches} micro-batches) — every R-worker "
                    f"needs at least one row")
            bounds = np.linspace(0, self.mb_size,
                                 num_r_workers + 1).astype(int)
            self.slices = [(int(bounds[i]), int(bounds[i + 1]))
                           for i in range(num_r_workers)]
            self.workers = [RWorker(w, cfg, lo, hi, **self._worker_kwargs)
                            for w, (lo, hi) in enumerate(self.slices)]
        for w in self.workers:
            w.start()
        if fleet is not None:
            fleet.attach(self)
        # S-side per-layer state, per micro-batch: a recurrent block's conv
        # window ({} for attention), allocated once here so that the S-side
        # graphs capture these buffers; every load and reset writes them in
        # place
        self.s_states: List[List[Any]] = [
            [self._fresh_recurrent(kind, self.mb_size)[1]
             for kind, _ in self.layers] for _ in range(self.num_mb)]
        self.mb_lengths = [torch.zeros((self.mb_size,), dtype=torch.int32,
                                       device=self.device)
                           for _ in range(self.num_mb)]
        # inactive rows get no KV append and no length bump
        self.mb_active = [torch.ones((self.mb_size,), dtype=torch.bool,
                                     device=self.device)
                          for _ in range(self.num_mb)]
        # the S-side graphs (layer transitions of decode and of verify
        # chunks), in one pool: they all replay on the S-stream.  Each
        # micro-batch's lengths and active mask are static inputs shared
        # by its decode graphs, refreshed by copy as each step starts
        self._s_pool = graphs.GraphPool(self.device)
        self._s_graphs: Dict[Tuple, graphs.StepGraph] = {}
        self._mb_in = [{"lengths": torch.zeros_like(self.mb_lengths[mb]),
                        "active": torch.ones_like(self.mb_active[mb])}
                       for mb in range(self.num_mb)]
        self._sink = CompletionSink(self.mb_size, self.device)
        self._parity = 0
        # queued chunk works run inside the next decode_step and land in
        # prefill_results after it
        self._prefill_inbox: deque = deque()
        self.prefill_results: List[_PrefillChunk] = []
        self.step_stats: Dict[str, float] = {}
        self.last_step_stats: Dict[str, float] = {}
        # optional obs.SpanTracer (attach_tracer); None costs one attribute
        # read per step
        self.tracer = None
        self._step_no = 0

    def attach_tracer(self, tracer) -> None:
        """Wire (or detach, with ``None``) a span tracer into the
        dispatch/collect path and every worker thread."""
        self.tracer = tracer
        for w in self.workers:
            w.tracer = tracer

    def _lkey(self, mb: int, layer: int) -> int:
        return mb * self.num_layers + layer

    def _fresh_recurrent(self, kind: str, rows: int) -> Tuple[Dict, Dict]:
        """(r_state, s_state) of ``rows`` fresh rows of a recurrent block
        (zero h and conv window); ({}, {}) for attention."""
        if kind not in (RGLRU, SSD):
            return {}, {}
        return D.split_block_state(kind, M._block_state(
            self.cfg, kind, rows, self.cache_len, self.device))

    # -- state loading (between decode steps) ----------------------------------
    def load_mb_state(self, mb: int, state) -> None:
        """Install a full-micro-batch decode state (``M.prefill``'s or
        ``M.init_decode_state``'s) for micro-batch ``mb``: each layer's
        R-state slice goes to its R-worker (``RWorker.load_state``, which
        drops the R-Part graphs that read the replaced buffers), S-side
        state is written into the buffers the S-side graphs captured."""
        for li, st in enumerate(per_layer_state(state, self.cfg)):
            r_st, s_st = D.split_block_state(self.layers[li][0], st)
            for w in self.workers:
                w.load_state(self._lkey(mb, li), batch_slice(r_st, w.lo, w.hi))
            for k, v in s_st.items():
                self.s_states[mb][li][k].copy_(v)

    def write_s_rows(self, mb: int, li: int, rows, s_state_rows) -> None:
        """Continuous batching: write micro-batch-local ``rows`` of layer
        ``li``'s S-side state (a recurrent block's conv window), in
        place."""
        if not s_state_rows:
            return
        idx = torch.as_tensor(np.asarray(rows), dtype=torch.long,
                              device=self.device)
        for k, v in s_state_rows.items():
            self.s_states[mb][li][k][idx] = v

    def load_prefill(self, mb: int, tokens, prompt_lens, enc_feats=None):
        """Run prefill for micro-batch ``mb`` on the S-worker and ship each
        layer's R-state slice to its R-worker (once per admission: the
        steady state never moves KV again).  ``tokens`` [mb_size, S]
        right-padded, ``prompt_lens`` [mb_size].  Every row becomes active
        at its prompt length; the decode graphs read lengths and the
        active mask from static buffers that each step refreshes by copy,
        and the block tables from the allocator's fixed device buffer, so
        nothing a captured graph holds is reallocated here.
        ``enc_feats`` [mb_size, n, d]: an early-fusion arch's patch
        embeddings, or a cross-attention arch's patch or frame embeddings,
        which that arch requires (``M.prefill``); the cross-attention
        K/V they give go to the R-workers once, with the rest of the
        state."""
        enc_feats = _frontend_feats(self.cfg, enc_feats, self.device)
        tokens = torch.as_tensor(tokens, dtype=torch.int32,
                                 device=self.device)
        prompt_lens = torch.as_tensor(prompt_lens, dtype=torch.int32,
                                      device=self.device)
        if tokens.shape[0] != self.mb_size:
            raise ValueError(f"{tokens.shape[0]} token rows for a "
                             f"micro-batch of {self.mb_size}")
        _, state = M.prefill(self.params, self.cfg, tokens, prompt_lens,
                             self.cache_len, enc_feats)
        self.load_mb_state(mb, state)
        self.mb_lengths[mb] = prompt_lens.clone()
        self.mb_active[mb] = torch.ones((self.mb_size,), dtype=torch.bool,
                                        device=self.device)

    def reset_step_stats(self) -> None:
        self.step_stats = {}
        self.last_step_stats = {}

    def set_row_length(self, row: int, length: int) -> None:
        """Set a global batch row's decode position (admission)."""
        mb, local = divmod(int(row), self.mb_size)
        lens = self.mb_lengths[mb].clone()    # in-flight payloads keep
        lens[local] = int(length)             # the old tensor
        self.mb_lengths[mb] = lens

    def set_row_active(self, row: int, flag: bool) -> None:
        """Gate a global batch row's decode participation (False while its
        slot is released).  Replaces the tensor: in-flight payloads keep
        the old one."""
        mb, local = divmod(int(row), self.mb_size)
        act = self.mb_active[mb].clone()
        act[local] = bool(flag)
        self.mb_active[mb] = act

    def queue_prefill_chunk(self, mb: int, rows, tokens, bases, counts,
                            verify: bool = False) -> _PrefillChunk:
        """Queue one chunk for local ``rows`` of micro-batch ``mb``:
        ``tokens`` [n, C] right-padded, ``bases`` [n] per-row KV offsets
        (tokens already prefilled), ``counts`` [n] valid tokens (<= C; the
        tail chunk of a prompt is shorter).  The chunk runs INSIDE the
        next decode_step, pipelined through the same per-layer tags as
        the decode micro-batches, its KV streamed to the owning R-workers
        layer by layer, and the work item (with its logits: per row at
        the last valid position, or every position with ``verify``)
        appears in ``prefill_results`` after that step.  ``verify=True``
        is speculative-decode scoring.  A step takes at most one work per
        (micro-batch, verify).  Cross-attention archs are refused, as
        ``repro``'s chunk mode refuses them."""
        if M.has_xattn(self.cfg):
            raise NotImplementedError(
                f"chunk work does not support {self.cfg.name}'s "
                f"cross-attention blocks: use load_prefill")
        rows = np.asarray(rows, np.int64)
        tokens = np.asarray(tokens, np.int32)
        n, c = tokens.shape
        if n != len(rows):
            raise ValueError(f"{len(rows)} rows vs {n} token rows")
        tok = np.zeros((self.mb_size, c), np.int32)
        val = np.zeros((self.mb_size, c), bool)
        base = self.mb_lengths[mb].cpu().numpy().astype(np.int32)
        for i, r in enumerate(rows):
            r = int(r)
            tok[r] = tokens[i]
            base[r] = int(bases[i])
            val[r, :int(counts[i])] = True
        dev = self.device
        work = _PrefillChunk(
            mb=int(mb), tokens=torch.from_numpy(tok).to(dev),
            base=torch.from_numpy(base).to(dev),
            valid=torch.from_numpy(val).to(dev), rows=rows,
            new_lens=np.asarray(bases, np.int64)
            + np.asarray(counts, np.int64), verify=bool(verify))
        self._prefill_inbox.append(work)
        return work

    def begin_prefill_rows(self, rows) -> None:
        """Prepare global batch rows for chunked prefill: mark them
        decode-inactive, zero their lengths, and zero their recurrent
        (RG-LRU / SSD) R-side h and S-side conv rows, in place, so chunk 0
        continues from h0 = 0 (repro's reset).  Attention rows need no
        reset: chunk appends are write-then-attend, and a previous
        occupant's stale entries are masked by position.  Must run between
        decode steps."""
        by_mb: Dict[int, List[int]] = {}
        for row in rows:
            mb, local = divmod(int(row), self.mb_size)
            by_mb.setdefault(mb, []).append(local)
            self.set_row_active(int(row), False)
        for mb, locs in by_mb.items():
            lens = self.mb_lengths[mb].clone()    # in-flight payloads keep
            lens[locs] = 0                        # the old tensor
            self.mb_lengths[mb] = lens
            locs = np.asarray(sorted(locs))
            for li, (kind, _) in enumerate(self.layers):
                r_st, s_st = self._fresh_recurrent(kind, len(locs))
                if not r_st:
                    continue
                for w in self.workers:
                    sel = np.flatnonzero((locs >= w.lo) & (locs < w.hi))
                    if len(sel):
                        w.write_rows(self._lkey(mb, li), locs[sel] - w.lo,
                                     batch_slice(r_st, 0, len(sel)))
                self.write_s_rows(mb, li, locs, s_st)

    def truncate_rows(self, rows, new_lens) -> None:
        """Roll global batch rows back to ``new_lens`` tokens: the
        speculative-decode rejection path (a verify step appended C
        candidates, the accept walk committed a prefix).  Paged storage
        returns the pages of only-rejected positions
        (``PagedAllocator.truncate``); dense storage only lowers
        ``mb_lengths``: stale ring entries past the new length sit
        outside every chunk read mask (pos >= base) and the next verify
        step writes over them.  Must run between decode steps."""
        by_mb: Dict[int, List[Tuple[int, int]]] = {}
        for row, nl in zip(rows, new_lens):
            mb, local = divmod(int(row), self.mb_size)
            by_mb.setdefault(mb, []).append((local, int(nl)))
            if self.paged_kv:
                w, _, wlocal = self.worker_for(int(row))
                alloc = w.allocators.get(mb)
                if alloc is not None:
                    alloc.truncate(wlocal, int(nl))
        for mb, pairs in by_mb.items():
            lens = self.mb_lengths[mb].clone()    # in-flight payloads keep
            for local, nl in pairs:               # the old tensor
                lens[local] = nl
            self.mb_lengths[mb] = lens

    # -- S-side pieces (each a StepGraph: repro's jitted callables) ----------
    # A graph's outputs are the carry ``h`` and the payload (q, k, v), or
    # the logits after the last layer; its inputs are the previous
    # transition's ``h`` (that graph's output buffer: no copy), the
    # gathered r_out, and the micro-batch's lengths and mask (decode) or
    # base and validity (chunk).  Payload shards are row views of the
    # outputs, so an R-worker's graph reads them in place.
    def _ctx(self, lengths):
        return M.Ctx(self.cfg, "decode", lengths[:, None], lengths)

    def _s_graph(self, key, make_body, inputs) -> graphs.StepGraph:
        g = self._s_graphs.get(key)
        if g is None:
            g = self._s_graphs[key] = graphs.StepGraph(make_body(), inputs,
                                                       self._s_pool)
        return g

    def _s_out(self, out, statics) -> Tuple[Dict, tuple]:
        """(carry, per-worker r_in shards) of a transition's outputs.  The
        carry is the residual ``h`` and a recurrent block's S-side operand
        of its advance (RG-LRU ``gate``, SSD ``z``)."""
        carry = {k[len(_CARRY):]: v for k, v in out.items()
                 if k.startswith(_CARRY)}
        r_in = {k: v for k, v in out.items() if not k.startswith(_CARRY)}
        r_in.update(statics)
        return carry, shard_rin(r_in, self.slices)

    def _pre(self, kind, p, h, s_state, ctx, gate=None, valid=None):
        """s_pre(li) inside a graph body: S-side state written in place
        (row-gated by ``gate`` in decode), payload without its statics,
        and the carry under ``_CARRY`` names."""
        if valid is None:
            po, new_s = D.s_pre_stateful(kind, p, h, s_state, ctx)
            new_s = mask_rows(new_s, s_state, gate)
        else:
            po, new_s = D.s_pre_chunk_stateful(kind, p, h, s_state, ctx,
                                               valid)
        for k, v in new_s.items():
            s_state[k].copy_(v)
        return _phase_out(po)

    def _start(self, mb: int, tokens):
        """embed -> s_pre(0), emitting the per-worker r_in shards; also
        refreshes the micro-batch's static lengths and mask."""
        def make():
            kind, p = self.layers[0]
            s_state = self.s_states[mb][0]

            def body(ins):
                h = self.params["embed"][ins["tokens"].long()]
                return self._pre(kind, p, h, s_state,
                                 self._ctx(ins["lengths"]), ins["active"])
            return body
        statics = self._mb_in[mb]
        g = self._s_graph(("start", mb), make, statics)
        g.feed({"tokens": tokens, "lengths": self.mb_lengths[mb],
                "active": self.mb_active[mb]})
        return self._s_out(g(), statics)

    def _more_phases(self, li: int, phase: int) -> bool:
        """Layer ``li`` has a phase after ``phase`` (DEC_XATTN's 0)."""
        return phase + 1 < D.num_phases(self.layers[li][0])

    def _advance_graph(self, mb: int, li: int, phase: int, carry):
        def make():
            kind, p = self.layers[li]
            more = self._more_phases(li, phase)
            last = li + 1 >= self.num_layers
            kind2, p2 = self.layers[min(li + 1, self.num_layers - 1)]
            s2 = self.s_states[mb][min(li + 1, self.num_layers - 1)]

            def body(ins):
                ctx = self._ctx(ins["lengths"])
                h = D.s_advance(kind, phase, p, _carry_of(ins, carry),
                                _r_out_of(ins, kind), ctx)
                if more:
                    # the same layer's next phase: its payload out
                    return _phase_out(h)
                if last:
                    return {"logits": M._logits(self.params, self.cfg,
                                                h)[:, 0]}
                return self._pre(kind2, p2, h, s2, ctx, ins["active"])
            return body
        return self._s_graph(("step", mb, li, phase), make,
                             dict(self._mb_in[mb], **_graph_carry(carry)))

    def _advance(self, mb: int, li: int, phase: int, carry, r_out=None):
        """s_advance(li, phase) fused with s_pre(li+1) (shards out), with
        the layer's next phase's payload (shards out), or with the logits
        head after the last layer (logits out: the graph's buffer, valid
        until the micro-batch's next step).  ``r_out`` None: the step
        already gathered it into the graph's inputs."""
        g = self._advance_graph(mb, li, phase, carry)
        g.feed(dict(r_out or {}, **_graph_carry(carry)))
        out = g()
        if li + 1 >= self.num_layers and not self._more_phases(li, phase):
            return None, out["logits"]
        return self._s_out(out, self._mb_in[mb])

    def _chunk_ctx(self, base, c: int):
        qpos = (base[:, None]
                + torch.arange(c, dtype=torch.int32,
                               device=base.device)[None, :])
        return M.Ctx(self.cfg, "chunk", qpos, base)

    def _chunk_start(self, wk: _PrefillChunk):
        """embed -> s_pre_chunk(0) of a chunk work, shards out.  The
        work's tokens, base and validity become the static chunk inputs
        of its (micro-batch, verify, C): a prefill chunk and a verify work
        of one micro-batch in one step each have their own."""
        c = wk.tokens.shape[1]

        def make():
            kind, p = self.layers[0]
            s_state = self.s_states[wk.mb][0]

            def body(ins):
                h = self.params["embed"][ins["tokens"].long()]
                return self._pre(kind, p, h, s_state,
                                 self._chunk_ctx(ins["base"], c),
                                 valid=ins["valid"])
            return body
        g = self._s_graph(("chunk_start", wk.mb, wk.verify, c), make, {})
        g.feed({"tokens": wk.tokens, "base": wk.base, "valid": wk.valid})
        return self._s_out(g(), self._chunk_statics(wk))

    def _chunk_statics(self, wk: _PrefillChunk):
        ins = self._s_graphs[("chunk_start", wk.mb, wk.verify,
                              wk.tokens.shape[1])].inputs
        return {"lengths": ins["base"], "valid": ins["valid"]}

    def _chunk_advance_graph(self, wk: _PrefillChunk, li: int, phase: int,
                             carry):
        c, verify = wk.tokens.shape[1], wk.verify
        st = self._chunk_statics(wk)

        def make():
            kind, p = self.layers[li]
            last = li + 1 >= self.num_layers
            kind2, p2 = self.layers[min(li + 1, self.num_layers - 1)]
            s2 = self.s_states[wk.mb][min(li + 1, self.num_layers - 1)]

            def body(ins):
                ctx = self._chunk_ctx(ins["lengths"], c)
                h = D.s_advance_chunk(kind, phase, p, _carry_of(ins, carry),
                                      _r_out_of(ins, kind), ctx)
                if last and verify:
                    return {"logits": M._logits(self.params, self.cfg, h)}
                if last:
                    # each row's last valid position (a row fed nothing
                    # gives position 0's, which the caller ignores)
                    cnt = ins["valid"].sum(dim=1)
                    idx = torch.clamp(cnt - 1, 0, c - 1)
                    rows = torch.arange(h.shape[0], device=h.device)
                    hsel = h[rows, idx][:, None]
                    return {"logits": M._logits(self.params, self.cfg,
                                                hsel)[:, 0]}
                return self._pre(kind2, p2, h, s2, ctx, valid=ins["valid"])
            return body
        return self._s_graph(("chunk_step", wk.mb, verify, li, phase, c),
                             make, dict(st, **_graph_carry(carry)))

    def _chunk_advance(self, wk: _PrefillChunk, li: int, phase: int, carry):
        """s_advance_chunk(li) fused with s_pre_chunk(li+1) (shards out),
        or with the logits head after the last layer: a verify work's
        logits at every position, [mb_size, C, V], or a prefill chunk's at
        each row's last valid position, [mb_size, V] (repro's
        ``_chunk_step_fn`` "final"), copied out of the graph's buffer (the
        work outlives the step).  The step has gathered r_out into the
        graph's inputs."""
        g = self._chunk_advance_graph(wk, li, phase, carry)
        g.feed(_graph_carry(carry))
        out = g()
        if li + 1 >= self.num_layers:
            return None, out["logits"].clone()
        return self._s_out(out, self._chunk_statics(wk))

    # -- stall detection ---------------------------------------------------------
    def _pending_desc(self, pending, works) -> str:
        """The outstanding work of a stalled step, with the in-flight
        request ids of each micro-batch (``rids_of``) so operators can
        correlate a stall with request timelines."""
        parts = []
        for (mb, li, ph), ws in sorted(pending.items()):
            d = (f"micro-batch {mb} layer {li} ({self.layers[li][0]}) "
                 f"phase {ph} from worker(s) {sorted(ws)}")
            real_mb = mb if mb < self.num_mb else works[mb - self.num_mb].mb
            if self.rids_of is not None:
                rids = list(self.rids_of(real_mb))
                if rids:
                    d += f" [in-flight rids: {rids}]"
            parts.append(d)
        return "; ".join(parts)

    def _check_stall(self, pending, works, strikes, waited, step_no) -> None:
        """Classify the workers still owing completions after an empty poll
        window; abort the step with a CollectTimeout when one is dead, hung
        past the suspicion threshold, or struck out as idle with
        completions owed (a lost message), or when the backstop ran out."""
        owing: set = set()
        for ws in pending.values():
            owing |= ws
        by_wid = {w.wid: w for w in self.workers}
        now = time.monotonic()
        dead: List[int] = []
        hung: List[int] = []
        lost: List[int] = []
        for wid in sorted(owing):
            w = by_wid.get(wid)
            if w is None or not w.is_alive():
                dead.append(wid)
            elif w.processing and now - w.heartbeat > self.suspect_after_s:
                hung.append(wid)
            elif not w.processing and w.inq.empty():
                lost.append(wid)
        if not dead and not hung:
            for wid in lost:
                strikes[wid] = strikes.get(wid, 0) + 1
            lost = [wid for wid in lost
                    if strikes[wid] >= self.suspect_strikes]
            if not lost and waited <= self.collect_timeout_s:
                return
        raise CollectTimeout(
            f"decode step timed out after {waited:.1f}s waiting for "
            f"R-worker results — "
            + (f"dead worker(s) {dead}; " if dead else "")
            + (f"hung worker(s) {hung} (heartbeat stale > "
               f"{self.suspect_after_s:.1f}s); " if hung else "")
            + (f"worker(s) {lost} idle with completions owed "
               f"(message lost in flight?); " if lost else "")
            + f"outstanding: {self._pending_desc(pending, works) or 'none'}",
            dead_wids=dead, hung_wids=hung, lost_wids=lost,
            transient=not dead and not hung, step_no=step_no) from None

    # -- the pipelined decode step ----------------------------------------------
    def decode_step(self, tokens_per_mb: Optional[Sequence[torch.Tensor]]):
        """One new token for every row of every micro-batch, event-driven:
        advance whichever micro-batch's R-results land first (``"ooo"``) or
        in issue order (``"fifo"``).  tokens_per_mb: list of [mb_size, 1]
        int32, or None for a CHUNK-ONLY step (the speculative-decode
        verify: the queued works run, no decode micro-batch starts and no
        decode length moves).  Queued chunk works ride the step as virtual
        micro-batches ``num_mb + i``, exempt from FIFO pinning (they have
        no emission order to keep).  Returns a list of logits
        [mb_size, vocab] (of None when chunk-only)."""
        run_decode = tokens_per_mb is not None
        if run_decode and len(tokens_per_mb) != self.num_mb:
            raise ValueError(f"{len(tokens_per_mb)} token groups for "
                             f"{self.num_mb} micro-batches")
        pc = time.perf_counter
        # prefill_s: the S-side time of chunk work that delayed no decode
        # micro-batch, and the event-loop waits that served only chunk
        # work (repro's accounting; the serving layer moves it from the
        # decode wall to the prefill wall)
        self._reap_retired()
        stats = {"dispatch_s": 0.0, "collect_s": 0.0, "s_dispatch_s": 0.0,
                 "r_wait_s": 0.0, "ooo_advances": 0.0, "prefill_s": 0.0,
                 "dup_completion_count": 0.0}
        t_step0 = pc()
        tracer = self.tracer
        step_no = self._step_no
        self._step_no += 1
        # dispatch times for the spans (tracer only): a span is dispatch ->
        # the last worker's completion of that tag
        disp_t: Dict[Tuple[int, int, int], float] = {}
        sink = self._sink
        self._parity ^= 1
        parity, epoch = self._parity, sink.epoch
        cuda = self.device.type == "cuda"
        pending: Dict[Tuple[int, int, int], set] = {}
        issue_seq: Dict[Tuple[int, int, int], int] = {}
        fifo: List[Tuple[int, int, int]] = []
        ready: set = set()
        carries: List[Any] = [None] * self.num_mb
        logits_out: List[Any] = [None] * self.num_mb
        emit_at = [0.0] * self.num_mb
        works: List[_PrefillChunk] = []
        while self._prefill_inbox:
            wk = self._prefill_inbox.popleft()
            wk.vmb = self.num_mb + len(works)
            works.append(wk)
        if len({(wk.mb, wk.verify) for wk in works}) != len(works):
            # a work's tokens, base and mask are the static chunk inputs of
            # its (micro-batch, verify) for the whole step
            raise ValueError("at most one prefill chunk and one verify work "
                             "per micro-batch and step")
        self.prefill_results = []
        chunk_carries: Dict[int, Any] = {}
        active = (self.num_mb if run_decode else 0) + len(works)

        def dispatch(mb: int, li: int, phase: int, shards) -> None:
            t0 = pc()
            tag = (epoch, parity, mb, li, phase)
            pending[(mb, li, phase)] = {w.wid for w in self.workers}
            issue_seq[(mb, li, phase)] = len(issue_seq)
            real_mb = mb
            if mb >= self.num_mb:
                real_mb = works[mb - self.num_mb].mb
            elif self.schedule == "fifo":
                fifo.append((mb, li, phase))
            # the R-workers' streams wait for the payload's S-side work
            ev = None
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
            if mb >= self.num_mb and works[mb - self.num_mb].verify:
                # the marker routes the shards to the verify R-Part
                shards = tuple(dict(sh, verify=True) for sh in shards)
            kind = self.layers[li][0]
            lkey = self._lkey(real_mb, li)
            for w, shard in zip(self.workers, shards):
                w.inq.put((tag, lkey, kind, phase, shard, sink, ev))
            stats["dispatch_s"] += pc() - t0
            if tracer is not None:
                disp_t[(mb, li, phase)] = t0

        def advance(mb: int, li: int, phase: int) -> None:
            nonlocal active
            me = issue_seq[(mb, li, phase)]
            if any(issue_seq[t] < me for t in pending):
                stats["ooo_advances"] += 1.0
            t0 = pc()
            sink.gather((epoch, parity, mb, li, phase),
                        self._advance_graph(mb, li, phase,
                                            carries[mb]).inputs)
            t1 = pc()
            stats["collect_s"] += t1 - t0
            carry, out = self._advance(mb, li, phase, carries[mb])
            stats["s_dispatch_s"] += pc() - t1
            if carry is None:
                logits_out[mb] = out
                emit_at[mb] = pc() - t_step0
                active -= 1
            else:
                carries[mb] = carry
                if self._more_phases(li, phase):
                    dispatch(mb, li, phase + 1, out)
                else:
                    dispatch(mb, li + 1, 0, out)

        def advance_chunk(vmb: int, li: int, phase: int) -> None:
            nonlocal active
            wk = works[vmb - self.num_mb]
            # a chunk advance is prefill time only if nothing else waited
            # for the S-worker: chunk compute that holds a completed decode
            # micro-batch back is decode latency
            free_ride = (sink.q.empty()
                         or all(lg is not None for lg in logits_out))
            t0 = pc()
            sink.gather((epoch, parity, vmb, li, phase),
                        self._chunk_advance_graph(wk, li, phase,
                                                  chunk_carries[vmb]).inputs)
            t1 = pc()
            stats["collect_s"] += t1 - t0
            carry, out = self._chunk_advance(wk, li, phase,
                                             chunk_carries[vmb])
            stats["s_dispatch_s"] += pc() - t1
            if free_ride:
                stats["prefill_s"] += pc() - t0
            if carry is None:
                wk.logits = out
                active -= 1
            else:
                chunk_carries[vmb] = carry
                dispatch(vmb, li + 1, 0, out)

        for mb in range(self.num_mb if run_decode else 0):
            t0 = pc()
            carries[mb], shards = self._start(mb, tokens_per_mb[mb])
            stats["s_dispatch_s"] += pc() - t0
            dispatch(mb, 0, 0, shards)
        for wk in works:
            t0 = pc()
            chunk_carries[wk.vmb], shards = self._chunk_start(wk)
            stats["s_dispatch_s"] += pc() - t0
            stats["prefill_s"] += pc() - t0
            dispatch(wk.vmb, 0, 0, shards)

        # poll the sink in short slices (not one fatal blocking get) and
        # classify the workers still owing completions on every empty
        # window; `strikes` counts consecutive empty windows per idle
        # suspect, so a completion merely in flight between the post and
        # this get is never taken for a lost one
        strikes: Dict[int, int] = {}
        poll_s = min(max(self.suspect_after_s, 0.05),
                     self.collect_timeout_s)
        last_progress = pc()
        try:
            while active:
                t0 = pc()
                try:
                    wid, tag, err = sink.q.get(timeout=poll_s)
                except queue.Empty:
                    stats["r_wait_s"] += pc() - t0
                    self._check_stall(pending, works, strikes,
                                      pc() - last_progress, step_no)
                    continue
                last_progress = pc()
                wait = last_progress - t0
                stats["r_wait_s"] += wait
                if works and all(lg is not None for lg in logits_out):
                    # every decode micro-batch has emitted: this wait
                    # served only chunk work
                    stats["prefill_s"] += wait
                t_epoch, t_parity, mb, li, phase = tag
                if t_epoch != epoch or t_parity != parity:
                    continue  # fenced-off straggler from an older step
                kind = self.layers[li][0]
                if err is not None:
                    ctx = getattr(err, "r_worker_context", None)
                    raise WorkerStepError(
                        f"R-worker {wid} failed on micro-batch {mb}, layer "
                        f"{li} ({kind}), phase {phase}"
                        + (f" [worker context: wid={ctx[0]} lkey={ctx[1]} "
                           f"kind={ctx[2]} phase={ctx[3]}]" if ctx else ""),
                        wid=wid,
                        transient=bool(getattr(err, "transient", False)),
                        step_no=step_no) from err
                outstanding = pending.get((mb, li, phase))
                if outstanding is None or wid not in outstanding:
                    if (mb, li, phase) in issue_seq:
                        # a duplicated delivery of a tag this step did
                        # dispatch: the scatter is idempotent
                        stats["dup_completion_count"] += 1.0
                        continue
                    raise RuntimeError(
                        f"R-worker {wid} posted an unexpected completion for "
                        f"micro-batch {mb}, layer {li}, phase {phase}")
                outstanding.discard(wid)
                strikes.pop(wid, None)
                if outstanding:
                    continue
                del pending[(mb, li, phase)]
                if tracer is not None:
                    track = (f"mb{mb}" if mb < self.num_mb
                             else f"prefill-vmb{mb - self.num_mb}")
                    tracer.add(f"L{li}.p{phase}", "r-rtt", track,
                               disp_t.pop((mb, li, phase), t0), pc(),
                               {"step": step_no, "mb": mb, "layer": li,
                                "phase": phase})
                if mb >= self.num_mb:
                    advance_chunk(mb, li, phase)
                elif self.schedule == "fifo":
                    ready.add((mb, li, phase))
                    while fifo and fifo[0] in ready:
                        nxt = fifo.pop(0)
                        ready.discard(nxt)
                        advance(*nxt)
                else:
                    advance(mb, li, phase)
        except BaseException:
            # never let the next step consume this step's leftovers
            sink.fence()
            raise

        for mb in range(self.num_mb if run_decode else 0):
            # inactive rows did not append a token
            self.mb_lengths[mb] = (self.mb_lengths[mb]
                                   + self.mb_active[mb].to(torch.int32))
        for wk in works:
            # chunk progress lands AFTER the event loop: mb_lengths feeds
            # every in-flight S-step, so it stays frozen while the step runs
            if len(wk.rows):
                lens = self.mb_lengths[wk.mb].clone()
                lens[torch.from_numpy(wk.rows).to(lens.device)] = \
                    torch.from_numpy(wk.new_lens.astype(np.int32)).to(
                        lens.device)
                self.mb_lengths[wk.mb] = lens
            self.prefill_results.append(wk)
        stats["step_s"] = pc() - t_step0
        stats["emit_mean_s"] = sum(emit_at) / self.num_mb
        if tracer is not None:
            # the enclosing step span: every r-rtt span of this step nests
            # inside it
            tracer.add(f"step {step_no}", "step", "s-worker", t_step0,
                       t_step0 + stats["step_s"],
                       {"step": step_no, "prefill_chunks": len(works)})
        self.last_step_stats = stats
        for k, v in stats.items():
            self.step_stats[k] = self.step_stats.get(k, 0.0) + v
        self.step_stats["steps"] = self.step_stats.get("steps", 0.0) + 1.0
        return logits_out

    # -- the pre-fusion FIFO decode step (A/B baseline) -------------------------
    def _dispatch_legacy(self, mb: int, li: int, phase: int, shards) -> None:
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        kind = self.layers[li][0]
        for w, shard in zip(self.workers, shards):
            w.inq.put(((mb, li, phase), self._lkey(mb, li), kind, phase,
                       shard, None, ready))

    def _collect_legacy(self, mb: int, li: int, phase: int, stats):
        """Each worker's reply in worker order from its ``outq``, then the
        fan-in: the S-stream waits on each reply's event and takes over
        its tensors' lifetime, and the shards are concatenated."""
        pc = time.perf_counter
        kind = self.layers[li][0]
        parts = []
        for w in self.workers:
            t0 = pc()
            try:
                tag, r_out, done = w.outq.get(timeout=self.collect_timeout_s)
            except queue.Empty:
                raise CollectTimeout(
                    f"timed out after {self.collect_timeout_s:.0f}s waiting "
                    f"for R-worker {w.wid} on micro-batch {mb}, layer {li} "
                    f"({kind}), phase {phase}",
                    dead_wids=[] if w.is_alive() else [w.wid],
                    hung_wids=[w.wid] if w.is_alive() else []) from None
            stats["r_wait_s"] += pc() - t0
            if isinstance(r_out, BaseException):
                raise WorkerStepError(
                    f"R-worker {w.wid} failed on micro-batch {mb}, layer "
                    f"{li} ({kind}), phase {phase}", wid=w.wid,
                    transient=bool(getattr(r_out, "transient", False))
                ) from r_out
            if tag != (mb, li, phase):
                raise RuntimeError(
                    f"R-worker {w.wid} returned a result for (micro-batch, "
                    f"layer, phase) {tag}, expected ({mb}, {li}, {phase})")
            parts.append((r_out, done))
        t0 = pc()
        if self.device.type == "cuda":
            cur = torch.cuda.current_stream()
            for r_out, done in parts:
                cur.wait_event(done)
                for v in r_out.values():
                    v.record_stream(cur)
        out = {k: torch.cat([r[k] for r, _ in parts], dim=0)
               for k in parts[0][0]}
        stats["collect_s"] += pc() - t0
        return out

    def decode_step_legacy(self, tokens_per_mb: Sequence[torch.Tensor]):
        """The pre-fusion hot path, kept as repro keeps it: the A/B
        baseline of the fused :meth:`decode_step` and a second oracle.
        Strict FIFO collection, separate eager ``s_pre`` and ``s_advance``
        calls per layer and phase, per-worker replies on each R-worker's
        ``outq``
        and fan-in by concatenation on the device.  Nothing is captured
        or replayed, on either side.  Queued chunk works wait for the next
        ``decode_step``.  Its tokens equal ``decode_step``'s, and the two
        may alternate on one engine.  tokens_per_mb: list of [mb_size, 1]
        int32; returns a list of logits [mb_size, vocab]."""
        if len(tokens_per_mb) != self.num_mb:
            raise ValueError(f"{len(tokens_per_mb)} token groups for "
                             f"{self.num_mb} micro-batches")
        pc = time.perf_counter
        self._reap_retired()
        stats = {"dispatch_s": 0.0, "collect_s": 0.0, "s_dispatch_s": 0.0,
                 "r_wait_s": 0.0}
        t_step0 = pc()
        carries: List[Any] = [None] * self.num_mb
        last_h: List[Any] = [None] * self.num_mb
        order: List[Tuple[int, int, int]] = []

        def send(mb: int, li: int, phase: int, out, t0: float) -> None:
            carries[mb], shards = self._s_out(
                out, {"lengths": self.mb_lengths[mb],
                      "active": self.mb_active[mb]})
            t1 = pc()
            stats["s_dispatch_s"] += t1 - t0
            self._dispatch_legacy(mb, li, phase, shards)
            stats["dispatch_s"] += pc() - t1
            order.append((mb, li, phase))

        def start_layer(mb: int, li: int, h) -> None:
            kind, p = self.layers[li]
            t0 = pc()
            out = self._pre(kind, p, h, self.s_states[mb][li],
                            self._ctx(self.mb_lengths[mb]),
                            self.mb_active[mb])
            send(mb, li, 0, out, t0)

        for mb in range(self.num_mb):
            t0 = pc()
            tok = torch.as_tensor(tokens_per_mb[mb], device=self.device)
            h = self.params["embed"][tok.long()]
            stats["s_dispatch_s"] += pc() - t0
            start_layer(mb, 0, h)
        qi = 0
        while qi < len(order):
            mb, li, phase = order[qi]
            qi += 1
            kind, p = self.layers[li]
            r_out = self._collect_legacy(mb, li, phase, stats)
            t0 = pc()
            h = D.s_advance(kind, phase, p, carries[mb], r_out,
                            self._ctx(self.mb_lengths[mb]))
            if self._more_phases(li, phase):
                send(mb, li, phase + 1, _phase_out(h), t0)
                continue
            stats["s_dispatch_s"] += pc() - t0
            if li + 1 < self.num_layers:
                start_layer(mb, li + 1, h)
            else:
                last_h[mb] = h
        outs = []
        for mb in range(self.num_mb):
            t0 = pc()
            outs.append(M._logits(self.params, self.cfg, last_h[mb])[:, 0])
            stats["s_dispatch_s"] += pc() - t0
            self.mb_lengths[mb] = (self.mb_lengths[mb]
                                   + self.mb_active[mb].to(torch.int32))
        stats["step_s"] = pc() - t_step0
        self.last_step_stats = stats
        for k, v in stats.items():
            self.step_stats[k] = self.step_stats.get(k, 0.0) + v
        self.step_stats["steps"] = self.step_stats.get("steps", 0.0) + 1.0
        return outs

    # -- bookkeeping -------------------------------------------------------------
    def worker_busy_times(self) -> List[float]:
        return [w.busy_time for w in self.workers]

    def worker_for(self, row: int):
        """Map a global batch row to (worker, micro-batch, local row
        within the worker's slice)."""
        mb, local = divmod(int(row), self.mb_size)
        for w in self.workers:
            if w.lo <= local < w.hi:
                return w, mb, local - w.lo
        raise IndexError(row)

    def release_row(self, row: int) -> None:
        """A finished sequence frees its KV pages on the owning R-worker
        (dense slabs are overwritten at the next admission)."""
        if not self.paged_kv:
            return
        w, mb, local = self.worker_for(row)
        w.release_rows(mb, [local])

    def paged_resident_bytes(self) -> float:
        return sum(w.paged_resident_bytes() for w in self.workers)

    # -- shared-prefix KV reuse and tiering -------------------------------------
    def _row_allocator(self, row: int):
        w, mb, local = self.worker_for(row)
        return w.allocators.get(mb), local

    def probe_prefix(self, row: int, prompt_tokens, restore: bool = False):
        """Longest cached prefix of ``prompt_tokens`` in the allocator that
        owns global batch row ``row`` (a cached prefix is only adoptable by
        rows of the same (worker, micro-batch) pool).  Returns (page_ids,
        cached_token_count).

        With ``restore=True`` (tiering) index misses consult the host tier;
        restored page bytes are written into the owning worker's layer
        pools right here, on that worker's stream (which then finishes
        them, so the host sources may go): this runs on the engine thread
        between steps, so nothing reads a restored page before its KV
        lands."""
        w, mb, _ = self.worker_for(row)
        alloc = w.allocators.get(mb)
        if alloc is None or alloc.prefix is None:
            return [], 0
        lkeys = [k for k in w.paged_keys if k // self.num_layers == mb]
        ids, cached = alloc.probe_prefix(
            prompt_tokens, restore=restore and bool(lkeys))
        restores = alloc.take_restores()
        if restores:
            t0 = time.perf_counter()
            with PC.on_stream(w.stream):
                for lk in lkeys:
                    PC.restore_pool_pages(w.state[lk], restores,
                                          lk % self.num_layers)
            if w.stream is not None:
                w.stream.synchronize()
            alloc.copy_stats["restore_copy_s"] += time.perf_counter() - t0
        return ids, cached

    def hold_prefix(self, row: int, page_ids) -> None:
        """Keep a probed prefix that ``row`` will adopt off its pool's
        eviction ladder until :meth:`release_prefix_holds`
        (``PagedAllocator.hold``)."""
        alloc, _ = self._row_allocator(row)
        if alloc is not None:
            alloc.hold(page_ids)

    def release_prefix_holds(self) -> None:
        for w in self.workers:
            for alloc in w.allocators.values():
                alloc.release_holds()

    def park_row(self, row: int, tokens) -> bool:
        """Park-on-finish/preempt: index global batch row ``row``'s written
        chain (``tokens``) and keep its pages parked (swappable to the host
        tier) instead of freed: the tiering replacement for
        :meth:`release_row`.  Falls back to a plain release (inside the
        allocator) when the row is frozen, clamped, or there is no prefix
        index."""
        if not self.paged_kv:
            return False
        alloc, local = self._row_allocator(row)
        if alloc is None:
            return False
        return alloc.park_row(local, tokens)

    def adopt_prefix(self, row: int, page_ids, length: int) -> None:
        """Map a probed prefix into ``row``'s block table (refcount++; no
        KV moves) so only positions >= ``length`` need prefilling."""
        alloc, local = self._row_allocator(row)
        alloc.adopt_prefix(local, page_ids, length)

    def register_prefix(self, row: int, prompt_tokens) -> int:
        """Index ``row``'s pages under its prompt's block-hash chain so
        later admissions can share them."""
        alloc, local = self._row_allocator(row)
        if alloc is None or alloc.prefix is None:
            return 0
        return alloc.register_prefix(local, prompt_tokens)

    def prefix_cache_stats(self) -> Dict[str, int]:
        """Allocator-level sharing counters summed over every (worker,
        micro-batch) pool: pages shared by > 1 row, refcount-zero cached
        and parked pages, free pages (and swapped-out pages with a tier)."""
        out = {"shared_pages": 0, "cached_pages": 0, "free_pages": 0,
               "parked_pages": 0}
        for w in self.workers:
            for a in w.allocators.values():
                out["shared_pages"] += a.shared_pages()
                out["cached_pages"] += a.cached_pages()
                out["free_pages"] += a.free_pages()
                out["parked_pages"] += a.parked_pages()
        if self.kv_tier is not None:
            out["swapped_pages"] = self.kv_tier.swapped_pages()
        return out

    # -- fleet: live migration and failure recovery ----------------------------
    def zero_r_state(self) -> List[Dict[str, np.ndarray]]:
        """Fresh (empty) full-micro-batch R-state, one wire payload per
        layer: the recovery filler for rows that cannot be restored (the
        serving layer then re-prefills the live ones), int8 + scales when
        the workers are quantized so it concatenates with their exports."""
        state = M.init_decode_state(self.cfg, self.mb_size, self.cache_len,
                                    self.device)
        out = []
        for li, st in enumerate(per_layer_state(state, self.cfg)):
            r_st = D.split_block_state(self.layers[li][0], st)[0]
            if self._worker_kwargs["quantized"] and "k" in r_st:
                r_st = KV.quantize_attn_state(r_st)
            out.append({k: bridge.tensor_to_numpy(v)
                        for k, v in r_st.items()})
        return out

    def _assemble_rows(self, lkey: int, lo: int, hi: int, old_spans,
                       exports: Dict[int, Any], lost):
        """Stitch wire rows [lo, hi) of one layer key from the exporting
        old owners, falling back to the ``lost`` payload for rows no
        surviving worker held (failure recovery)."""
        pieces = []
        cur = lo
        while cur < hi:
            src = next(((s_lo, s_hi, exports[wid])
                        for wid, s_lo, s_hi in old_spans
                        if s_lo <= cur < s_hi and wid in exports), None)
            if src is not None:
                s_lo, s_hi, wire = src
                take = min(hi, s_hi)
                pieces.append({k: v[cur - s_lo:take - s_lo]
                               for k, v in wire.items()})
            else:
                nxt = [s_lo for _, s_lo, _ in old_spans if s_lo > cur]
                take = min(hi, min(nxt) if nxt else hi)
                if lost is None or lkey not in lost:
                    raise RuntimeError(
                        f"rows [{cur}, {take}) of layer key {lkey} have no "
                        f"surviving owner and no lost-rows payload — pass "
                        f"a KV snapshot or zero_r_state() filler")
                pieces.append({k: v[cur:take]
                               for k, v in lost[lkey].items()})
            cur = take
        if len(pieces) == 1:
            return pieces[0]
        return {k: np.concatenate([p[k] for p in pieces], axis=0)
                for k in pieces[0]}

    def apply_partition(self, new_slices, workers=None, lost=None) -> int:
        """Live-migrate R-state onto a new contiguous partition of the
        micro-batch rows (the fleet's rebalance and recovery primitive).

        ``new_slices``: one (lo, hi) per entry of ``workers`` (default: the
        current worker list), in order, covering [0, mb_size).  Workers
        whose slice is unchanged are untouched; the rest export their rows
        in the dense wire format, adopt the new slice (releasing their
        graphs) and re-install, so KV and page tables survive the move.
        Rows of a vanished worker come from ``lost`` ({lkey: full
        micro-batch wire payload}, e.g. a KV snapshot).  A worker given
        zero rows is stopped and dropped.  Each payload is digested at
        export and verified before install (the chaos site
        ``wire_corrupt``, ``where="migration"``, corrupts in between); a
        payload that fails is dropped, its rows installed from ``lost``
        (zeros when none) and listed in ``corrupt_rows``.

        Runs between decode steps.  Returns the number of (row,
        micro-batch) assignments that changed owner."""
        t0 = time.perf_counter()
        # fence FIRST: an in-flight tag from before the change (a late
        # delivery, an aborted step's leftovers) carries the old epoch
        self._sink.fence()
        workers = list(self.workers) if workers is None else list(workers)
        new_slices = [(int(lo), int(hi)) for lo, hi in new_slices]
        if len(workers) != len(new_slices):
            raise ValueError(f"{len(workers)} workers vs "
                             f"{len(new_slices)} slices")
        dropped = [w for w, (lo, hi) in zip(workers, new_slices) if hi <= lo]
        pairs = [(w, sl) for w, sl in zip(workers, new_slices)
                 if sl[1] > sl[0]]
        workers = [w for w, _ in pairs]
        new_slices = [sl for _, sl in pairs]
        cur = 0
        for lo, hi in new_slices:
            if lo != cur:
                raise ValueError(
                    f"partition {new_slices} is not a contiguous cover of "
                    f"[0, {self.mb_size})")
            cur = hi
        if cur != self.mb_size:
            raise ValueError(
                f"partition {new_slices} covers [0, {cur}), micro-batch "
                f"has {self.mb_size} rows")
        old_owner = {}
        for w in workers:
            for r in range(w.lo, w.hi):
                old_owner[r] = id(w)
        moved = sum(1 for w, (lo, hi) in zip(workers, new_slices)
                    for r in range(lo, hi) if old_owner.get(r) != id(w))
        changed = [w for w, sl in zip(workers, new_slices)
                   if (w.lo, w.hi) != sl]
        changed_ids = {id(w) for w in changed}
        # a worker dropped to zero rows is alive and exports before it goes
        sources = changed + dropped
        old_spans = [(id(w), w.lo, w.hi) for w in sources]
        lkeys = sorted({k for w in workers + dropped for k in w.state}
                       | (set(lost) if lost else set()))
        exports: Dict[int, Dict[int, Any]] = {lk: {} for lk in lkeys}
        sums: Dict[Tuple[int, int], bytes] = {}
        t_exp = time.perf_counter()
        for w in sources:
            for lk in lkeys:
                if lk in w.state:
                    exports[lk][id(w)] = wire = w.export_rows(
                        lk, np.arange(w.hi - w.lo))
                    sums[(lk, id(w))] = tree_digest(wire)
        export_s = time.perf_counter() - t_exp
        wire_bytes = sum(v.nbytes for per in exports.values()
                         for wire in per.values() for v in wire.values())
        if self.chaos is not None:
            for w in sources:
                for lk in lkeys:
                    if id(w) in exports[lk] and self.chaos.fire(
                            "wire_corrupt", wid=w.wid, lkey=lk,
                            where="migration"):
                        exports[lk][id(w)] = self.chaos.corrupt_tree(
                            exports[lk][id(w)])
        # a corrupted export is dropped: its rows fall back to `lost`
        # (zeros when the caller gave none) and are listed for the
        # serving layer to re-prefill: detected, never silent garbage
        self.corrupt_rows = []
        span_of = {wid_: (s_lo, s_hi) for wid_, s_lo, s_hi in old_spans}
        corrupt_lkeys = set()
        for (lk, wid_), d0 in sums.items():
            if tree_digest(exports[lk][wid_]) != d0:
                del exports[lk][wid_]
                corrupt_lkeys.add(lk)
                s_lo, s_hi = span_of[wid_]
                mb = lk // self.num_layers
                self.corrupt_rows.extend(
                    mb * self.mb_size + r for r in range(s_lo, s_hi))
        self.corrupt_rows = sorted(set(self.corrupt_rows))
        if corrupt_lkeys:
            zeros = None
            lost = dict(lost) if lost else {}
            for lk in corrupt_lkeys:
                if lk not in lost:
                    if zeros is None:
                        zeros = self.zero_r_state()
                    lost[lk] = zeros[lk % self.num_layers]
        for w, sl in zip(workers, new_slices):
            if id(w) in changed_ids:
                w.reassign(*sl)
        for w in dropped:
            # a gracefully dropped worker's parked pages cross to the
            # engine-global tier before its pools go (a killed worker gets
            # no such flush: only already-swapped entries survive)
            for alloc in w.allocators.values():
                alloc.swap_out_all_parked()
            w.stop()
            self._retired.append(w)
        t_load = time.perf_counter()
        for lk in lkeys:
            for w, (lo, hi) in zip(workers, new_slices):
                if id(w) not in changed_ids:
                    continue
                wire = self._assemble_rows(lk, lo, hi, old_spans,
                                           exports[lk], lost)
                w.load_state(lk, {k: bridge.tensor_from_numpy(v, w.device)
                                  for k, v in wire.items()})
        self.workers = workers
        self.slices = new_slices
        for w in workers:            # keep span capture across topology
            w.tracer = self.tracer   # changes (the worker list is new)
        self.topology_changes += 1
        self.last_migration = {
            "moved_rows_count": moved * self.num_mb,
            "wire_bytes": wire_bytes, "export_s": export_s,
            "load_s": time.perf_counter() - t_load,
            "duration_s": time.perf_counter() - t0}
        return moved * self.num_mb

    def remove_worker(self, widx: int, new_slices=None, lost=None):
        """Failure path: drop worker ``widx``, repartition the survivors
        (even split unless the fleet planner gives ``new_slices``), and
        refill its rows from ``lost`` wire payloads (a KV snapshot) or
        zero state (the serving layer re-prefills live rows).  The removed
        worker is killed; its graphs are freed once its thread has exited.
        Returns it."""
        if len(self.workers) <= 1:
            raise RuntimeError(
                "cannot remove the last R-worker — no survivor can adopt "
                "its rows")
        dead = self.workers[widx]
        survivors = self.workers[:widx] + self.workers[widx + 1:]
        if new_slices is None:
            bounds = np.linspace(0, self.mb_size,
                                 len(survivors) + 1).astype(int)
            new_slices = [(int(bounds[i]), int(bounds[i + 1]))
                          for i in range(len(survivors))]
        if lost is None:
            zeros = self.zero_r_state()
            keys = {k for w in self.workers for k in w.state}
            lost = {lk: zeros[lk % self.num_layers] for lk in keys}
        dead.kill()
        self._retired.append(dead)
        self.apply_partition(new_slices, workers=survivors, lost=lost)
        return dead

    def _reap_retired(self) -> None:
        """Free the graphs of removed workers whose threads have exited
        (on this thread, between steps: nothing captures here)."""
        if not self._retired:
            return
        for w in [w for w in self._retired if not w.is_alive()]:
            w.release_graphs()
            self._reaped_recaptures[0] += w.recapture_count
            self._reaped_recaptures[1] += w.recapture_s
            self._retired.remove(w)

    def recapture_stats(self) -> Dict[str, float]:
        """Graphs re-captured after topology changes, and their seconds
        (warm-up and capture), over live and removed workers."""
        ws = list(self.workers) + list(self._retired)
        count, secs = self._reaped_recaptures
        return {"recapture_count": float(count + sum(w.recapture_count
                                                     for w in ws)),
                "recapture_s": float(secs + sum(w.recapture_s
                                                for w in ws))}

    def close(self) -> None:
        """Stop every worker, join those that are not hung, and free the
        graphs of those that exited; warn (not raise: close runs in
        teardown, after deliberate kills too) with the ids of workers
        still alive.  A hung worker (stale heartbeat while processing) is
        not waited for; its daemon thread cannot block process exit."""
        ws = list(self.workers) + list(self._retired)
        for w in ws:
            w.kill()            # a hung worker then wakes to no replay
        now = time.monotonic()
        for w in ws:
            if not (w.processing
                    and now - w.heartbeat > self.suspect_after_s):
                w.join(timeout=30)
        stuck = [w.wid for w in ws if w.is_alive()]
        # free the graphs here, on the closing thread: left to the cyclic
        # GC (their bodies close over the workers), they could be
        # destroyed inside a later engine's capture
        for w in ws:
            if not w.is_alive():
                w.release_graphs()
        self._retired = [w for w in self._retired if w.is_alive()]
        with graphs.dropping():
            self._s_graphs.clear()
        if stuck:
            warnings.warn(
                f"HeteroPipelineEngine.close(): R-worker(s) {stuck} did "
                f"not exit after stop() — thread(s) leaked (hung "
                f"mid-item?)", RuntimeWarning, stacklevel=2)


# ---------------------------------------------------------------------------
# single-device colocated reference (the paper's vanilla baseline)
# ---------------------------------------------------------------------------
class ColocatedEngine:
    """R-Part and S-Part both on the S-device — the vanilla baseline and
    the correctness oracle of the pipelined engine."""

    def __init__(self, params, cfg: ModelConfig, *, batch: int,
                 cache_len: int, device=None):
        if batch < 1 or cache_len < 1:
            raise ValueError(
                f"batch ({batch}) and cache_len ({cache_len}) must be >= 1")
        check_supported(cfg)
        self.device = resolve_device(device)
        self.params, self.cfg = params, cfg
        self.cache_len = cache_len
        self.state = M.init_decode_state(cfg, batch, cache_len, self.device)

    def load_prefill(self, tokens, prompt_lens, enc_feats=None):
        """Prefill the whole batch: ``tokens`` [batch, S] right-padded,
        ``prompt_lens`` [batch]; ``enc_feats`` [batch, n, d] as
        ``HeteroPipelineEngine.load_prefill``'s."""
        enc_feats = _frontend_feats(self.cfg, enc_feats, self.device)
        tokens = torch.as_tensor(tokens, dtype=torch.int32,
                                 device=self.device)
        prompt_lens = torch.as_tensor(prompt_lens, dtype=torch.int32,
                                      device=self.device)
        _, self.state = M.prefill(self.params, self.cfg, tokens,
                                  prompt_lens, self.cache_len, enc_feats)

    def decode_step(self, tokens):
        logits, self.state = M.decode_step(self.params, self.cfg,
                                           self.state, tokens)
        return logits
