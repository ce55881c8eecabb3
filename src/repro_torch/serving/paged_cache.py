"""Paged KV storage (counterpart of repro.serving.paged_cache).

Two layers of API live here, as in the JAX package:

1. The self-contained ``PagedKV`` dataclass (single-sequence ops over
   explicit STORED positions, ``page_pos``): ``init_paged``,
   ``ensure_capacity``, ``release_row``, ``write_tokens``,
   ``write_prefill``, ``gather_views``, ``r_attention_paged`` and
   ``pool_utilization``.  Functional like the JAX original: every op
   returns a new ``PagedKV`` and leaves its argument's tensors untouched.
   Its R-Part attends through the plain ``layers.flash_attention``, as
   the reference does, not through a kernel: the paged kernels derive
   positions from the slot index, and ``release_row`` can leave stored
   positions that the slot index does not give.
2. The engine-integrated path of the port's R-workers:

* ``PagedAllocator`` — HOST-side block-table state for one worker's rows
  of one micro-batch, shared by every attention layer (a sequence's
  layers always have equal lengths); each layer owns its own page pool,
  addressed by the shared page ids.  With the prefix cache it counts
  references per page and clones a shared page before a write lands in
  it (copy-on-write); ``PrefixIndex`` maps hash chains of page-aligned
  token blocks to resident pages.  With tiering a finished or preempted
  row parks its pages, and ``HostTier`` (``TierConfig``, ``TierEntry``)
  keeps the bytes of parked pages that the eviction ladder swapped out,
  until a probe restores them.
* ``clone_pool_pages`` / ``restore_pool_pages`` — the device side of the
  clones and restores, written in place into the existing pool tensors
  (the R-Part graphs baked their addresses).
* device page pools (``init_page_pool``: fp, or int8 + scales), the
  decode append (``write_token_paged``) and the admission-time
  conversion of dense prefill rows into pages (``dense_rows_to_pages``).
* ``r_attention_paged_tables`` — the parameter-free R-Part op over
  (pool, tables), through the paged flash-decode kernel (fp pools) or
  the gather + int8 kernel (int8 pools).
* ``r_attention_paged_chunk`` — the chunked-prefill R-Part: write the
  chunk's K/V into its pages, then attend the chunk's queries against the
  gathered cache through the plain flash attention (fp or int8 pools), as
  the JAX package does.
* ``r_attention_paged_verify`` — the speculative-decode verify R-Part:
  write the C candidates' K/V, then score them in one pool sweep through
  the multi-token verify kernel (kernel 4 on fp pools, kernel 3's
  multi-token entry on int8 pools).

Layout (shared with kernels/paged_attention.py):

    pool pages  [num_pages + 1, page, Hkv, Dh]   (one pool per attn layer)
    tables      [rows, max_pages_per_seq] int32   page ids, -1 unmapped
    lengths     [rows]                            current token count

Pages of a row form a contiguous table prefix and slot k backs absolute
positions [k*page, (k+1)*page), so positions are derived, not stored.

The one difference from the JAX layout: every pool carries ONE EXTRA
SCRATCH PAGE at index ``num_pages`` that no table ever maps.  The JAX
package drops the writes of unmapped rows (released slots still being
stepped) through an out-of-range index with ``mode="drop"``; torch's
``index_put_`` has no drop mode — an out-of-range id raises, and a
clamped id would write into a live page — and filtering the rows on the
host would cost a device sync per layer.  So dropped writes land on the
scratch page, which no reader ever sees.
"""
from __future__ import annotations

import contextlib
import hashlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.chaos.checksum import ChecksumError, payload_checksum
from repro_torch.chaos.plan import ChaosIOError, ChaosPoolExhausted
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L


F32 = torch.float32


@dataclass
class PagedKV:
    pages_k: torch.Tensor       # [P, page, Hkv, Dh]
    pages_v: torch.Tensor
    page_pos: torch.Tensor      # [P, page] int32
    tables: torch.Tensor        # [B, max_pages] int32
    lengths: torch.Tensor       # [B] int32
    free: List[int]             # host-side free list (allocator state)

    @property
    def page_size(self) -> int:
        return self.pages_k.shape[1]

    @property
    def max_pages(self) -> int:
        return self.tables.shape[1]


def init_paged(batch: int, num_pages: int, page: int, hkv: int, dh: int,
               max_pages_per_seq: int, dtype=F32, device=None) -> PagedKV:
    dev = resolve_device(device)
    return PagedKV(
        pages_k=torch.zeros((num_pages, page, hkv, dh), dtype=dtype,
                            device=dev),
        pages_v=torch.zeros((num_pages, page, hkv, dh), dtype=dtype,
                            device=dev),
        page_pos=torch.full((num_pages, page), -1, dtype=torch.int32,
                            device=dev),
        tables=torch.full((batch, max_pages_per_seq), -1, dtype=torch.int32,
                          device=dev),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=dev),
        free=list(range(num_pages)),
    )


# ---------------------------------------------------------------------------
# host-side allocator (the part vLLM's scheduler owns)
# ---------------------------------------------------------------------------
def ensure_capacity(kv: PagedKV, row: int, new_len: int) -> PagedKV:
    """Map enough pages for ``row`` to hold ``new_len`` tokens."""
    need = -(-new_len // kv.page_size)
    tables = kv.tables.cpu().numpy().copy()
    have = int((tables[row] >= 0).sum())
    if need > kv.max_pages:
        raise ValueError("sequence exceeds max_pages_per_seq")
    free = list(kv.free)
    for slot in range(have, need):
        if not free:
            raise MemoryError("paged KV pool exhausted")
        tables[row, slot] = free.pop()
    return replace(kv, tables=torch.as_tensor(tables, device=kv.tables.device),
                   free=free)


def release_row(kv: PagedKV, row: int) -> PagedKV:
    """Free all pages of a finished sequence (no fragmentation — the
    paper's §2.2 point about paging)."""
    tables = kv.tables.cpu().numpy().copy()
    ids = [int(p) for p in tables[row] if p >= 0]
    tables[row] = -1
    page_pos = kv.page_pos
    if ids:
        page_pos = page_pos.clone()
        page_pos[torch.as_tensor(ids, device=page_pos.device)] = -1
    lengths = kv.lengths.clone()
    lengths[row] = 0
    return replace(kv, tables=torch.as_tensor(tables, device=kv.tables.device),
                   page_pos=page_pos, lengths=lengths,
                   free=list(kv.free) + ids)


# ---------------------------------------------------------------------------
# device-side ops (given a capacity-ensured table)
# ---------------------------------------------------------------------------
def write_tokens(kv: PagedKV, k_new, v_new) -> PagedKV:
    """Append one token per row.  k_new/v_new [B, Hkv, Dh].
    Caller must have run ensure_capacity(row, lengths+1)."""
    page = kv.page_size
    pos = kv.lengths                                    # [B]
    slot_in_page = (pos % page).long()
    page_idx = (pos // page).long()
    page_ids = torch.gather(kv.tables, 1, page_idx[:, None])[:, 0].long()
    pages_k, pages_v = kv.pages_k.clone(), kv.pages_v.clone()
    page_pos = kv.page_pos.clone()
    pages_k[page_ids, slot_in_page] = k_new.to(pages_k.dtype)
    pages_v[page_ids, slot_in_page] = v_new.to(pages_v.dtype)
    page_pos[page_ids, slot_in_page] = pos
    return replace(kv, pages_k=pages_k, pages_v=pages_v, page_pos=page_pos,
                   lengths=pos + 1)


def write_prefill(kv: PagedKV, row: int, k_seq, v_seq) -> PagedKV:
    """Write a whole prompt for one row.  k_seq/v_seq [S, Hkv, Dh]."""
    s = k_seq.shape[0]
    page = kv.page_size
    n_pages = -(-s // page)
    pad = n_pages * page - s
    kp = torch.nn.functional.pad(k_seq, (0, 0, 0, 0, 0, pad)).reshape(
        n_pages, page, *k_seq.shape[1:])
    vp = torch.nn.functional.pad(v_seq, (0, 0, 0, 0, 0, pad)).reshape(
        n_pages, page, *v_seq.shape[1:])
    ar = torch.arange(n_pages * page, dtype=torch.int32,
                      device=kv.page_pos.device)
    pos = torch.where(ar < s, ar, -1).reshape(n_pages, page)
    ids = kv.tables[row, :n_pages].long()
    pages_k, pages_v = kv.pages_k.clone(), kv.pages_v.clone()
    page_pos, lengths = kv.page_pos.clone(), kv.lengths.clone()
    pages_k[ids] = kp.to(pages_k.dtype)
    pages_v[ids] = vp.to(pages_v.dtype)
    page_pos[ids] = pos
    lengths[row] = s
    return replace(kv, pages_k=pages_k, pages_v=pages_v, page_pos=page_pos,
                   lengths=lengths)


def gather_views(kv: PagedKV):
    """[B, max_pages*page, Hkv, Dh] contiguous views + positions."""
    b = kv.tables.shape[0]
    safe = kv.tables.clamp_min(0).long()                # [B, MP]
    k = kv.pages_k[safe]                                # [B, MP, page, H, D]
    v = kv.pages_v[safe]
    pos = kv.page_pos[safe]
    mapped = (kv.tables >= 0)[:, :, None]
    pos = torch.where(mapped, pos, -1)
    mp, page = kv.tables.shape[1], kv.page_size
    k = k.reshape(b, mp * page, *k.shape[3:])
    v = v.reshape(b, mp * page, *v.shape[3:])
    return k, v, pos.reshape(b, mp * page)


def r_attention_paged(r_in, kv: PagedKV, *, window: int = 0,
                      softcap: float = 0.0) -> Tuple[dict, PagedKV]:
    """Parameter-free R-Part over the paged cache.  r_in as in
    decompose.r_attention (q/k/v [B,1,...], lengths [B])."""
    kv = write_tokens(kv, r_in["k"][:, 0], r_in["v"][:, 0])
    kc, vc, pc = gather_views(kv)
    o = L.flash_attention(r_in["q"], kc, vc, r_in["lengths"][:, None], pc,
                          causal=True, window=window, softcap=softcap,
                          kv_chunk=max(kc.shape[1], 1))
    return {"o": o}, kv


def pool_utilization(kv: PagedKV) -> float:
    used = kv.pages_k.shape[0] - len(kv.free)
    tokens = int(kv.lengths.sum())
    cap = used * kv.page_size
    return tokens / cap if cap else 1.0


# ===========================================================================
# engine-integrated path (RWorker storage format) — see module docstring
# ===========================================================================
def _block_digest(parent: bytes, tokens: np.ndarray, tail: bool = False
                  ) -> bytes:
    """Chained content hash of one page-aligned token block.  The parent
    digest rides into the hash, so a block is only reachable through the
    exact token prefix leading to it.  Tail blocks (final partial page)
    are domain-separated AND length-tagged: a tail entry matches only a
    prompt whose remaining tokens are exactly the registered ones."""
    h = hashlib.blake2b(parent, digest_size=16)
    if tail:
        h.update(b"#tail:%d" % len(tokens))
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.digest()


class PrefixIndex:
    """hash-chain-of-token-blocks -> page id, plus the LRU of refcount-
    zero pages that are kept cached instead of freed.

    The index never owns a refcount: the allocator moves a page into
    ``lru`` when its last table reference goes away and pulls it back
    out on re-adoption; eviction (free list dry) drops every digest of
    the victim page so no probe can reach recycled storage."""

    def __init__(self):
        self.entries: Dict[bytes, int] = {}            # digest -> page id
        self.page_digests: Dict[int, set] = {}         # page id -> digests
        self.lru: "OrderedDict[int, None]" = OrderedDict()  # refcount-0 cached

    def get(self, digest: bytes) -> Optional[int]:
        return self.entries.get(digest)

    def put(self, digest: bytes, page_id: int) -> bool:
        """Register; first writer wins (remapping a digest would strand
        the old page's cached marker)."""
        if digest in self.entries:
            return False
        self.entries[digest] = page_id
        self.page_digests.setdefault(page_id, set()).add(digest)
        return True

    def is_cached(self, page_id: int) -> bool:
        return bool(self.page_digests.get(page_id))

    def touch(self, page_id: int) -> None:
        if page_id in self.lru:
            self.lru.move_to_end(page_id)

    def park(self, page_id: int) -> None:
        """A cached page's refcount hit zero: LRU-park instead of free."""
        self.lru[page_id] = None
        self.lru.move_to_end(page_id)

    def unpark(self, page_id: int) -> None:
        self.lru.pop(page_id, None)

    def evict_lru(self) -> int:
        """Drop the oldest refcount-zero cached page's digests and return
        the page for reuse."""
        page_id, _ = self.lru.popitem(last=False)
        self.drop_page(page_id)
        return page_id

    def drop_page(self, page_id: int) -> None:
        for d in self.page_digests.pop(page_id, ()):
            self.entries.pop(d, None)
        self.lru.pop(page_id, None)


# ---------------------------------------------------------------------------
# KV lifecycle tiering: the host-side memory hierarchy behind the pools
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TierConfig:
    """Simulated-bandwidth host tiers.  ``dram_pages`` bounds the DRAM
    tier; entries past it spill (LRU) to the disk tier — same payload
    store, different accounted bandwidth.  0 = unbounded DRAM."""
    dram_gbps: float = 25.0      # device <-> host DRAM stream bandwidth
    disk_gbps: float = 2.0       # DRAM <-> disk spill bandwidth
    dram_pages: int = 0


@dataclass
class TierEntry:
    """One swapped-out page: every digest that reached it in some hash
    chain (aliases, e.g. a tail entry and the later full-block entry of
    the same page), plus the per-layer page bytes captured from each
    paged layer's pool at swap-out time (host tensors)."""
    digests: set
    payload: Dict[int, Dict[str, torch.Tensor]]  # layer idx -> pool arrays
    tier: str = "dram"
    tokens: int = 0
    # blake2b over the payload tree, stamped at put() and verified at
    # pop(): host-side bit rot restores as a detected miss
    checksum: bytes = b""


def _payload_nbytes(payload: Dict[int, Dict[str, torch.Tensor]]) -> int:
    return sum(a.numel() * a.element_size()
               for arrs in payload.values() for a in arrs.values())


class HostTier:
    """Content-addressed host store for swapped-out KV pages, shared by
    EVERY (worker, micro-batch) allocator of one engine.

    Keys are the chained block digests of the :class:`PrefixIndex`, so
    the store is worker-independent: a page parked on one pool restores
    into whatever pool probes its token chain later (identical digest =>
    identical tokens => identical KV).  Bandwidths are SIMULATED: the
    store accounts the seconds a real DRAM/disk stream would take
    (``stats['sim_seconds']``) instead of sleeping; the copies the port
    really makes are timed by the allocator (``copy_stats``).  Thread-
    safe: R-worker threads swap out during decode growth while the engine
    thread restores at admission.  ``chaos`` (a ``chaos.FaultPlan``)
    arms ``tier_put`` and ``tier_get`` (injected I/O failures, at the TOP
    of ``put`` / ``pop``, before any state changes) and ``tier_corrupt``
    (bit rot after the checksum is stamped)."""

    def __init__(self, cfg: Optional[TierConfig] = None, chaos: Any = None):
        self.cfg = cfg or TierConfig()
        self.entries: "OrderedDict[bytes, TierEntry]" = OrderedDict()
        self._lock = threading.RLock()
        self.chaos = chaos
        self.stats = {"swapped_out": 0, "restored": 0, "spilled": 0,
                      "dropped": 0, "bytes_out": 0, "bytes_in": 0,
                      "put_failed": 0, "get_failed": 0, "corrupt": 0,
                      "sim_seconds": 0.0}

    def _account(self, nbytes: int, tier: str) -> None:
        gbps = (self.cfg.disk_gbps if tier == "disk"
                else self.cfg.dram_gbps)
        self.stats["sim_seconds"] += nbytes / max(gbps * 1e9, 1.0)

    def put(self, entry: TierEntry) -> None:
        """Admit a swapped-out page.  First content wins per digest (two
        pools can park the same chain; identical digests carry identical
        bytes).  A full DRAM tier spills its LRU entries to disk; payloads
        are never dropped."""
        if self.chaos is not None and self.chaos.fire("tier_put"):
            with self._lock:
                self.stats["put_failed"] += 1
            raise ChaosIOError("injected host-tier write failure")
        if not entry.checksum:
            entry.checksum = payload_checksum(entry.payload)
        if self.chaos is not None and self.chaos.fire("tier_corrupt"):
            # bit rot AFTER the checksum was stamped: pop() detects it
            entry.payload = self.chaos.corrupt_tree(entry.payload)
        with self._lock:
            nbytes = _payload_nbytes(entry.payload)
            self.stats["swapped_out"] += 1
            self.stats["bytes_out"] += nbytes
            self._account(nbytes, "dram")
            fresh = [d for d in entry.digests if d not in self.entries]
            if not fresh:
                self.stats["dropped"] += 1
                return
            entry.digests = set(fresh)
            for d in fresh:
                self.entries[d] = entry
            if self.cfg.dram_pages > 0:
                dram = [e for e in self._unique_entries()
                        if e.tier == "dram"]
                for victim in dram[:max(0, len(dram)
                                        - self.cfg.dram_pages)]:
                    victim.tier = "disk"
                    self.stats["spilled"] += 1
                    self._account(_payload_nbytes(victim.payload), "disk")

    def get(self, digest: bytes) -> Optional[TierEntry]:
        with self._lock:
            return self.entries.get(digest)

    def pop(self, entry: TierEntry) -> TierEntry:
        """Stream a page back: drop every alias digest, verify the payload
        checksum, and account the restore at the entry's tier bandwidth.
        A corrupted entry is removed and raises ChecksumError (the caller
        treats it as a miss)."""
        if self.chaos is not None and self.chaos.fire("tier_get"):
            with self._lock:
                self.stats["get_failed"] += 1
            raise ChaosIOError("injected host-tier read failure")
        with self._lock:
            for d in entry.digests:
                self.entries.pop(d, None)
            if entry.checksum \
                    and payload_checksum(entry.payload) != entry.checksum:
                self.stats["corrupt"] += 1
                raise ChecksumError(
                    "host-tier entry failed its payload checksum "
                    f"({entry.tokens} tokens, tier={entry.tier}) — "
                    "dropped; the row re-prefills")
            nbytes = _payload_nbytes(entry.payload)
            self.stats["restored"] += 1
            self.stats["bytes_in"] += nbytes
            self._account(nbytes, entry.tier)
            return entry

    def _unique_entries(self) -> List[TierEntry]:
        seen, out = set(), []
        for e in self.entries.values():
            if id(e) not in seen:
                seen.add(id(e))
                out.append(e)
        return out

    def swapped_pages(self) -> int:
        with self._lock:
            return len(self._unique_entries())

    def nbytes(self) -> int:
        """Host bytes the tier currently holds (all layers, all pages)."""
        with self._lock:
            return sum(_payload_nbytes(e.payload)
                       for e in self._unique_entries())


def on_stream(stream):
    """A context running device copies on ``stream`` (an R-worker's),
    after the caller's current stream: a copy made from the engine thread
    is then ordered behind both the R-Parts that wrote the pool and any
    engine-side write before it.  A null context on the CPU."""
    if stream is None:
        return contextlib.nullcontext()
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    return torch.cuda.stream(stream)


class PagedAllocator:
    """Host-side block-table allocator for one worker's rows of one
    micro-batch, shared across that worker's attention layers.  With
    ``prefix_cache=True`` pages are reference-counted copy-on-write and a
    :class:`PrefixIndex` keeps refcount-zero prompt pages reusable; with a
    ``tier`` (a :class:`HostTier`) finished rows park and parked pages
    swap out to host memory under pressure (repro's module docstring has
    the protocol).

    The owning R-worker installs ``pool_reader`` (its pools of this
    micro-batch, {layer idx -> pool}) and ``stream`` (its CUDA stream;
    None on the CPU): a swap-out copies a page to the host on that
    stream."""

    def __init__(self, rows: int, num_pages: int, page: int,
                 max_pages_per_seq: int, prefix_cache: bool = False,
                 tier: Optional[HostTier] = None, chaos: Any = None,
                 device=None):
        self.rows, self.num_pages, self.page = rows, num_pages, page
        # a chaos.FaultPlan (or None): the "pool" site injects TRANSIENT
        # exhaustion into growth, which propagates to the worker's error
        # post and the step supervisor (not a MemoryError: the real
        # exhaustion fallback would freeze the row)
        self.chaos = chaos
        self.max_pages = max_pages_per_seq
        self.device = resolve_device(device)
        self.tables = np.full((rows, max_pages_per_seq), -1, np.int32)
        self.lengths = np.zeros((rows,), np.int64)
        self.active = np.zeros((rows,), bool)
        # a row whose decode-time grow once failed is frozen: regrowing
        # later would map pages over positions whose writes were dropped,
        # exposing stale KV inside the (pos <= qpos) valid mask
        self.frozen = np.zeros((rows,), bool)
        self.free: List[int] = list(range(num_pages))
        # one count per page = number of table slots mapping it; shared
        # prefix pages sit at > 1 and are immutable until CoW-cloned
        self.refcount = np.zeros((num_pages,), np.int32)
        self.tier = tier
        self.prefix: Optional[PrefixIndex] = (
            PrefixIndex() if prefix_cache or tier is not None else None)
        # refcount-0 pages deliberately retained whole-sequence (park-on-
        # finish), oldest first: swapped to the host tier under pressure
        self.parked: "OrderedDict[int, None]" = OrderedDict()
        self.pool_reader: Optional[Callable[[], Dict[int, Dict]]] = None
        self.stream = None
        self._clones: List[Tuple[int, int]] = []   # (src, dst) this step
        self._restores: List[Tuple[TierEntry, int]] = []
        self._pinned: set = set()      # mid-probe chain pages (no evict)
        # pages an admission chose to adopt, held off the ladder until its
        # other requests' probes are done (``hold``)
        self._held: set = set()
        # seconds of the real page copies: swap-out D2H here, restore H2D
        # by the owner (``restore_pool_pages``)
        self.copy_stats = {"swap_out_copy_s": 0.0, "restore_copy_s": 0.0}
        # the device copy of ``tables``: one fixed buffer (graphs read it
        # in place), refreshed by copy after a host mutation
        self._dev_tables: Optional[torch.Tensor] = None
        self._dirty = True

    # -- low level ---------------------------------------------------------
    def _take_page(self) -> int:
        """A fresh page, by the eviction ladder: free list → LRU-evict a
        refcount-zero cached prefix page (index entries dropped, KV lost)
        → swap the oldest parked page out to the host tier (KV kept,
        restorable).  Pages pinned by an in-flight probe or held for an
        admission are never selected; a refcount > 0 page is on no rung."""
        if self.free:
            return self.free.pop()
        if self.prefix is not None:
            keep = self._pinned | self._held
            for pid in self.prefix.lru:
                if pid not in keep:
                    self.prefix.lru.move_to_end(pid, last=False)
                    return self.prefix.evict_lru()
            for pid in self.parked:
                if pid not in keep:
                    return self._swap_out(pid)
        raise MemoryError("paged KV pool exhausted")

    def _read_page(self, pools: Dict[int, Dict], pid: int) -> Dict:
        """One page of every layer pool, copied to host tensors on the
        owning worker's stream (a synchronous copy: it has landed when
        this returns)."""
        t0 = time.perf_counter()
        with on_stream(self.stream):
            payload = {li: {name: arr[pid].to("cpu", copy=True)
                            for name, arr in pool.items()}
                       for li, pool in pools.items()}
        self.copy_stats["swap_out_copy_s"] += time.perf_counter() - t0
        return payload

    def _swap_out(self, pid: int) -> int:
        """Move a parked page's bytes to the host tier (keyed by every
        digest of its chain) and hand the device page back for reuse.
        Without a pool reader (no pools written yet) or a tier the page is
        simply dropped like a cached eviction."""
        self.parked.pop(pid, None)
        digests = set(self.prefix.page_digests.get(pid, ()))
        pools = self.pool_reader() if self.pool_reader is not None else {}
        if self.tier is not None and digests and pools:
            try:
                self.tier.put(TierEntry(digests=digests,
                                        payload=self._read_page(pools, pid),
                                        tokens=self.page))
            except Exception:
                # a failed tier write must not lose the page from both
                # sides: the device page is still reclaimed below and
                # only the host copy is lost (a later probe misses)
                pass
        self.prefix.drop_page(pid)
        return pid

    def swap_out_all_parked(self) -> int:
        """Flush every parked page to the host tier: the pre-migration
        hook (a topology change drops this allocator and its pools, so
        device-resident parked KV must cross to the engine-global tier to
        survive).  Returns the pages swapped; they land on the free list."""
        n = 0
        for pid in list(self.parked):
            self.free.append(self._swap_out(pid))
            n += 1
        return n

    def flush_parked_to_tier(self) -> int:
        """COPY every parked page's bytes to the host tier without evicting
        it: the KV-snapshot transport, so a worker that later dies abruptly
        still leaves its parked chains restorable.  Device state is
        untouched; a later real swap-out of the same digests is
        deduplicated by the tier (first content wins; a digest match
        implies the same tokens and so the same bytes)."""
        if self.tier is None or self.pool_reader is None \
                or not self.parked:
            return 0
        pools = self.pool_reader()
        if not pools:
            return 0
        n = 0
        for pid in self.parked:
            digests = set(self.prefix.page_digests.get(pid, ()))
            if not digests:
                continue
            try:
                self.tier.put(TierEntry(digests=digests,
                                        payload=self._read_page(pools, pid),
                                        tokens=self.page))
            except Exception:
                continue    # the snapshot copy is lost; the page is not
            n += 1
        return n

    def _ensure_row(self, row: int, new_len: int) -> bool:
        need = -(-new_len // self.page)
        if need > self.max_pages:
            raise ValueError(
                f"sequence needs {need} pages > max_pages_per_seq="
                f"{self.max_pages}")
        have = int((self.tables[row] >= 0).sum())
        if need > have:
            self._dirty = True          # before mutating: a mid-loop
        for slot in range(have, need):  # MemoryError must not leave a
            pid = self._take_page()     # stale device table
            self.tables[row, slot] = pid
            self.refcount[pid] = 1
        return need > have

    def _cow_row(self, row: int, start: int, new_len: int) -> None:
        """Copy-on-write: writes for ``row`` will land at positions
        [start, new_len); clone any mapped SHARED page they intersect (in
        practice the page containing ``start``).  The (src, dst) pairs
        accumulate in ``take_clones`` for the worker to apply to each
        layer's pool before the write."""
        if self.prefix is None:
            return      # sharing (refcount > 1) only exists via adoption
        if new_len <= start or not bool((self.refcount > 1).any()):
            return
        page = self.page
        s1 = min((new_len - 1) // page, self.max_pages - 1)
        for slot in range(start // page, s1 + 1):
            pid = int(self.tables[row, slot])
            if pid < 0 or self.refcount[pid] <= 1:
                continue
            fresh = self._take_page()
            self.refcount[fresh] = 1
            self.refcount[pid] -= 1
            self.tables[row, slot] = fresh
            self._dirty = True
            self._clones.append((pid, fresh))

    def take_clones(self) -> List[Tuple[int, int]]:
        """Drain the (src, dst) CoW clone pairs accumulated since the last
        call: the worker applies them to every paged layer's pool
        (:func:`clone_pool_pages`) before this step's writes."""
        out, self._clones = self._clones, []
        return out

    # -- protocol ----------------------------------------------------------
    def admit(self, row: int, length: int) -> bool:
        """Make ``row`` resident with exactly ceil(length/page) pages; a
        no-op if it already is at that length."""
        if self.active[row] and self.lengths[row] == length:
            return False
        self.release(row)
        if length > 0:
            try:
                self._ensure_row(row, length)
            except MemoryError:
                self.release(row)   # don't strand partially grabbed pages
                raise
            self.active[row] = True
            self.lengths[row] = length
        return True

    def adopt_prefix(self, row: int, page_ids: Sequence[int],
                     length: int) -> None:
        """Prefix-cache admission: map ``page_ids`` (another sequence's
        already-written prefix, ceil(length/page) of them) into ``row``'s
        table prefix, incrementing refcounts; no KV moves.  The caller
        then prefills only positions >= ``length``."""
        self.release(row)
        if length <= 0:
            return
        page_ids = [int(p) for p in page_ids]
        if len(page_ids) != -(-length // self.page):
            raise ValueError(
                f"{len(page_ids)} prefix pages for length {length} "
                f"(page={self.page})")
        self._dirty = True
        for slot, pid in enumerate(page_ids):
            self.tables[row, slot] = pid
            if self.refcount[pid] == 0 and self.prefix is not None:
                self.prefix.unpark(pid)      # cached -> referenced again
                self.parked.pop(pid, None)   # parked -> referenced again
            self.refcount[pid] += 1
        self.active[row] = True
        self.lengths[row] = length

    def _drop_ref(self, pid: int) -> None:
        """One table slot stops mapping ``pid``: at refcount zero a cached
        prefix page parks in the LRU, any other page is freed."""
        self.refcount[pid] -= 1
        if self.refcount[pid] > 0:
            return                        # another sequence still maps it
        if self.prefix is not None and self.prefix.is_cached(pid):
            self.prefix.park(pid)         # keep cached, LRU-evictable
        else:
            self.free.append(pid)

    def release(self, row: int) -> None:
        ids = self.tables[row][self.tables[row] >= 0]
        if len(ids):
            self._dirty = True
        for pid in ids:
            self._drop_ref(int(pid))
        self.tables[row] = -1
        self.active[row] = False
        self.frozen[row] = False
        self.lengths[row] = 0

    def truncate(self, row: int, new_len: int) -> int:
        """Roll ``row`` back to ``new_len`` tokens (the speculative-decode
        rejection path): table slots >= ceil(new_len/page) walk the ladder
        of :meth:`release` (refcount decrement; cached prefix pages park
        in the LRU), so admission capacity is not leaked to tokens that
        were never emitted.  The kept partial page needs no wipe:
        positions >= new_len fall outside every reader's mask, and the
        next verify step writes from ``new_len`` on before it attends.
        Frozen rows only adjust ``lengths``.  Returns the number of slots
        dropped."""
        new_len = max(0, int(new_len))
        if not self.active[row] or new_len >= int(self.lengths[row]):
            return 0
        if self.frozen[row]:
            self.lengths[row] = new_len
            return 0
        keep = -(-new_len // self.page)
        slots = [s for s in range(keep, self.max_pages)
                 if self.tables[row, s] >= 0]
        if slots:
            self._dirty = True
        for s in slots:
            pid = int(self.tables[row, s])
            self.tables[row, s] = -1
            self._drop_ref(pid)
        self.lengths[row] = new_len
        return len(slots)

    def park_row(self, row: int, tokens) -> bool:
        """Park-on-finish / park-on-preempt: index ``row``'s WRITTEN chain
        (``tokens``) and keep every refcount-zero page of it parked
        (swappable to the host tier under pressure, not LRU-dropped), so a
        later request with the same history restores without re-prefill.

        Frozen or capacity-clamped rows fall back to a plain
        :meth:`release`; so does a tier-less allocator (register, then
        cache).  Returns True when the row's chain was indexed."""
        tokens = np.asarray(tokens, np.int32)
        eligible = (self.prefix is not None and self.active[row]
                    and not self.frozen[row]
                    and int(self.lengths[row]) == len(tokens)
                    and self.mapped_pages(row) * self.page
                    >= int(self.lengths[row]))
        if eligible:
            self.register_prefix(row, tokens)
        if not eligible or self.tier is None:
            self.release(row)
            return eligible
        ids = [int(i) for i in self.tables[row][self.tables[row] >= 0]]
        if ids:
            self._dirty = True
        for pid in ids:
            self.refcount[pid] -= 1
            if self.refcount[pid] > 0:
                continue              # another sequence still maps it
            if self.prefix.is_cached(pid):
                self.prefix.unpark(pid)      # parked, not cached-LRU
                self.parked[pid] = None
                self.parked.move_to_end(pid)
            else:
                self.free.append(pid)   # digest lost to a first writer
        self.tables[row] = -1
        self.active[row] = False
        self.frozen[row] = False
        self.lengths[row] = 0
        return True

    def ensure_lengths(self, new_lengths: np.ndarray,
                       mask: Optional[np.ndarray] = None) -> bool:
        """Grow active rows to hold ``new_lengths`` tokens, right before a
        decode append; released rows stay table-less.  ``mask`` limits the
        update to rows the engine is decoding.  A decode append landing in
        a still-shared page diverges onto a private clone first.  Growth
        is clamped to the per-sequence capacity and a pool-exhausted grow
        freezes the row (its further writes are dropped) instead of
        failing the step; admission bounds make neither reachable under
        admitted load.  The ``pool`` chaos site raises
        ``ChaosPoolExhausted`` before anything changes."""
        cap = self.max_pages * self.page
        if self.chaos is not None and self.chaos.fire("pool"):
            raise ChaosPoolExhausted(
                "injected transient pool exhaustion (decode growth)")
        changed = False
        rows = self.active & ~self.frozen
        if mask is not None:
            rows = rows & np.asarray(mask, bool)
        for row in np.nonzero(rows)[0]:
            try:
                start = min(int(self.lengths[row]), cap)
                new = min(int(new_lengths[row]), cap)
                self._cow_row(int(row), start, new)
                changed |= self._ensure_row(int(row), new)
            except MemoryError:
                self.frozen[row] = True
            self.lengths[row] = int(new_lengths[row])
        return changed

    def append_chunk(self, base: np.ndarray, counts: np.ndarray) -> bool:
        """Chunk growth (a prefill chunk or a speculative-decode verify
        step): rows with counts[row] > 0 receive ``counts[row]`` tokens at
        offset ``base[row]``.  A row starting from offset 0 is
        (re-)admitted fresh: a previous occupant's pages are released
        first.  A suffix starting inside an adopted (shared) page CoWs it.
        Rows with counts == 0 are untouched.  Pool exhaustion freezes the
        row as decode-time growth does; the ``pool`` chaos site raises
        first, as there."""
        cap = self.max_pages * self.page
        if self.chaos is not None and self.chaos.fire("pool"):
            raise ChaosPoolExhausted(
                "injected transient pool exhaustion (chunk append)")
        changed = False
        for row in np.nonzero(np.asarray(counts) > 0)[0]:
            row = int(row)
            b0, cnt = int(base[row]), int(counts[row])
            if b0 == 0:
                self.release(row)
                changed = True
            self.active[row] = True
            if self.frozen[row]:
                self.lengths[row] = b0 + cnt
                continue
            try:
                self._cow_row(row, min(b0, cap), min(b0 + cnt, cap))
                changed |= self._ensure_row(row, min(b0 + cnt, cap))
            except MemoryError:
                self.frozen[row] = True
            self.lengths[row] = b0 + cnt
        return changed

    # -- shared-prefix index ------------------------------------------------
    def register_prefix(self, row: int, tokens) -> int:
        """Index ``row``'s pages under the hash chain of ``tokens`` (the
        prefix they back): one entry per full page-aligned block plus an
        exact-length tail entry for the final partial page.  First writer
        wins per digest.  Returns entries added."""
        if self.prefix is None or not self.active[row]:
            return 0
        tokens = np.asarray(tokens, np.int32)
        page = self.page
        mapped = int((self.tables[row] >= 0).sum())
        n_full = min(len(tokens) // page, mapped)
        digest, added = b"", 0
        for i in range(n_full):
            digest = _block_digest(digest, tokens[i * page:(i + 1) * page])
            if self.prefix.put(digest, int(self.tables[row, i])):
                added += 1
        tail = len(tokens) - n_full * page
        if 0 < tail and len(tokens) // page == n_full and n_full < mapped:
            d = _block_digest(digest, tokens[n_full * page:], tail=True)
            if self.prefix.put(d, int(self.tables[row, n_full])):
                added += 1
        return added

    def probe_prefix(self, tokens,
                     restore: bool = False) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``: walk the hash chain block
        by block, stopping at the first miss.  A tail entry matches only
        when the remaining tokens are exactly the registered partial page.
        Returns (page_ids, cached_tokens).

        With ``restore=True`` (and a host tier) an index miss consults the
        tier: a hit takes a device page, re-indexes the entry's digests
        onto it and queues the (entry, page) pair for the owner to apply
        to its layer pools (:meth:`take_restores`) before anything reads
        the page.  Pages touched by the walk are pinned against the
        eviction ladder until that drain."""
        if self.prefix is None:
            return [], 0
        tokens = np.asarray(tokens, np.int32)
        page = self.page
        ids: List[int] = []
        digest = b""
        restore = restore and self.tier is not None
        if restore:
            self._pinned = set()
        n_full = len(tokens) // page
        for i in range(n_full):
            d = _block_digest(digest, tokens[i * page:(i + 1) * page])
            pid = self.prefix.get(d)
            if pid is None and restore:
                pid = self._tier_restore(d)
            if pid is None:
                self._unpin_if_idle()
                self._touch(ids)
                return ids, len(ids) * page
            ids.append(pid)
            if restore:
                self._pinned.add(pid)
            digest = d
        tail = len(tokens) - n_full * page
        if tail:
            d = _block_digest(digest, tokens[n_full * page:], tail=True)
            pid = self.prefix.get(d)
            if pid is None and restore:
                pid = self._tier_restore(d)
            if pid is not None:
                ids.append(pid)
                self._unpin_if_idle()
                self._touch(ids)
                return ids, int(len(tokens))
        self._unpin_if_idle()
        self._touch(ids)
        return ids, len(ids) * page

    def _tier_restore(self, digest: bytes) -> Optional[int]:
        """Stream one block back from the host tier, if present and a
        device page can be had without disturbing the pinned chain."""
        entry = self.tier.get(digest)
        if entry is None:
            return None
        try:
            pid = self._take_page()
        except MemoryError:
            return None
        try:
            entry = self.tier.pop(entry)
        except Exception:
            # checksum corruption: hand the page back and report a miss
            self.free.append(pid)
            return None
        for d in entry.digests:
            self.prefix.put(d, pid)
        self.parked[pid] = None
        self.parked.move_to_end(pid)
        self._pinned.add(pid)
        self._restores.append((entry, pid))
        return pid

    def hold(self, page_ids: Sequence[int]) -> None:
        """Keep ``page_ids`` (a probed prefix an admission chose, not yet
        adopted) off the eviction ladder until :meth:`release_holds`.  The
        probes of one admission run one request after another, and a later
        request's restores take pages through the ladder: without the hold
        they could swap out or evict a refcount-zero page an earlier
        request was promised, which would then adopt recycled storage."""
        self._held.update(int(p) for p in page_ids)

    def release_holds(self) -> None:
        self._held = set()

    def take_restores(self) -> List[Tuple[TierEntry, int]]:
        """Drain pending (entry, page) restores: the owner applies them to
        every layer pool (:func:`restore_pool_pages`) before the next step
        reads or the ladder could recycle them; draining unpins."""
        out, self._restores = self._restores, []
        self._pinned = set()
        return out

    def _unpin_if_idle(self) -> None:
        if not self._restores:
            self._pinned = set()

    def _touch(self, ids: List[int]) -> None:
        if self.prefix is not None:
            for pid in ids:
                self.prefix.touch(pid)

    # -- accounting --------------------------------------------------------
    def used_pages(self) -> int:
        """Pages referenced by at least one table slot (cached and parked
        refcount-zero pages are neither used nor free)."""
        return (self.num_pages - len(self.free) - self.cached_pages()
                - self.parked_pages())

    def cached_pages(self) -> int:
        """Refcount-zero pages kept only for the prefix index (LRU-
        evictable on demand)."""
        return len(self.prefix.lru) if self.prefix is not None else 0

    def parked_pages(self) -> int:
        """Refcount-zero whole-sequence pages held for park/restore."""
        return len(self.parked)

    def free_pages(self) -> int:
        return len(self.free)

    def available_pages(self) -> int:
        """Pages allocatable right now: free, LRU-evictable cached, and
        parked (swappable to the host tier on demand)."""
        return len(self.free) + self.cached_pages() + self.parked_pages()

    def mapped_pages(self, row: int) -> int:
        return int((self.tables[row] >= 0).sum())

    def shared_pages(self) -> int:
        """Pages mapped by more than one table slot (the dedup win)."""
        return int((self.refcount > 1).sum())

    def resident_tokens(self) -> int:
        """Tokens actually backed by pages (a clamped or exhausted grow
        leaves lengths ahead of the allocated capacity)."""
        caps = (self.tables >= 0).sum(axis=1) * self.page
        return int(np.minimum(self.lengths, caps)[self.active].sum())

    def tables_device(self) -> torch.Tensor:
        """The block table on the device: one fixed [rows, max_pages]
        buffer, updated in place (a copy on the current stream) only
        after a host-side mutation (every one above marks it stale) — a
        row grows a page every ``page`` steps, not every layer of every
        step — so a graph that reads it stays valid."""
        if self._dev_tables is None:
            self._dev_tables = torch.from_numpy(self.tables.copy()).to(
                self.device)
        elif self._dirty:
            self._dev_tables.copy_(torch.from_numpy(self.tables))
        self._dirty = False
        return self._dev_tables


# ---------------------------------------------------------------------------
# device-side page pools (one per attention layer per worker)
# ---------------------------------------------------------------------------
def init_page_pool(num_pages: int, page: int, hkv: int, dh: int,
                   dtype=torch.float32, device=None,
                   quantized: bool = False) -> Dict:
    """fp pool: {k, v}; int8 pool (§5.2 composition): {k_q, k_s, v_q, v_s}
    with one fp32 scale per (token-slot, kv-head).  ``num_pages`` pages
    plus the scratch page (see the module docstring).  ``device`` None
    is the card (``resolve_device``)."""
    device = resolve_device(device)
    shape = (num_pages + 1, page, hkv, dh)
    if quantized:
        return {
            "k_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(shape[:3], dtype=torch.float32, device=device),
            "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_s": torch.zeros(shape[:3], dtype=torch.float32, device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _any_pages(pool: Dict) -> torch.Tensor:
    return pool["k_q"] if "k_q" in pool else pool["k"]


def pool_pages(pool: Dict) -> int:
    """Allocatable pages of a pool (the scratch page excluded)."""
    return _any_pages(pool).shape[0] - 1


def page_pool_token_bytes(pool: Dict) -> float:
    """Bytes one token-slot occupies in the pool (all arrays)."""
    per_page = sum(v[0].numel() * v.element_size() for v in pool.values())
    return per_page / _any_pages(pool).shape[1]


def write_token_paged(pool: Dict, tables, lengths, k_new, v_new,
                      active=None) -> Dict:
    """Append one token per row at position ``lengths[row]``, IN PLACE
    (an int8 pool quantizes it first).  Rows whose target slot is
    unmapped (released but still stepped), past the table, or with
    ``active`` False write to the scratch page instead.
    k_new/v_new [B, Hkv, Dh]."""
    scratch = pool_pages(pool)
    page = _any_pages(pool).shape[1]
    mp = tables.shape[1]
    lengths = lengths.long()
    slot = lengths % page
    pidx = lengths // page
    ids = torch.gather(tables, 1, torch.clamp(pidx, max=mp - 1)[:, None]
                       )[:, 0].long()
    ok = (ids >= 0) & (pidx < mp)
    if active is not None:
        ok = ok & active
    ids = torch.where(ok, ids, torch.full_like(ids, scratch))
    if "k_q" in pool:
        pool["k_q"][ids, slot], pool["k_s"][ids, slot] = ops.quantize_kv(
            k_new)
        pool["v_q"][ids, slot], pool["v_s"][ids, slot] = ops.quantize_kv(
            v_new)
    else:
        pool["k"][ids, slot] = k_new.to(pool["k"].dtype)
        pool["v"][ids, slot] = v_new.to(pool["v"].dtype)
    return pool


def clone_pool_pages(pool: Dict, clones: Sequence[Tuple[int, int]]) -> Dict:
    """Apply copy-on-write clones to one layer's page pool, IN PLACE: copy
    page ``src`` -> ``dst`` for every (src, dst) pair, in every array of
    the pool (an int8 pool clones values and scales verbatim).  The pool
    keeps its tensors (every R-Part graph baked their addresses).  The
    worker applies the pairs of one step (``PagedAllocator.take_clones``)
    to each paged layer on its own stream, before that layer's write."""
    if not clones:
        return pool
    dev = _any_pages(pool).device
    src = torch.as_tensor([s for s, _ in clones], dtype=torch.long,
                          device=dev)
    dst = torch.as_tensor([d for _, d in clones], dtype=torch.long,
                          device=dev)
    for v in pool.values():
        v.index_copy_(0, dst, v.index_select(0, src))
    return pool


def restore_pool_pages(pool: Dict, restores: Sequence[Tuple[TierEntry, int]],
                       layer_idx: int) -> Dict:
    """Write restored host-tier page bytes back into one layer's pool, IN
    PLACE: for every (entry, dst page) pair, ``entry.payload[layer_idx]``
    verbatim (an int8 pool gets its quantized values and scales back
    untouched: the round trip is bit-exact).  The caller orders the copy
    on the owning worker's stream."""
    restores = [(e, d) for e, d in restores if layer_idx in e.payload]
    if not restores:
        return pool
    dev = _any_pages(pool).device
    dst = torch.as_tensor([d for _, d in restores], dtype=torch.long,
                          device=dev)
    for name, arr in pool.items():
        src = torch.stack([e.payload[layer_idx][name] for e, _ in restores])
        arr.index_copy_(0, dst, src.to(dev, arr.dtype))
    return pool


def _scatter_pages(pool: Dict, ids: torch.Tensor, k_pages, v_pages) -> Dict:
    """One in-place scatter per pool array: ids [N]; k/v_pages
    [N, page, Hkv, Dh] (page-chunked, zero-padded tails), quantized first
    for an int8 pool."""
    if "k_q" in pool:
        pool["k_q"][ids], pool["k_s"][ids] = ops.quantize_kv(k_pages)
        pool["v_q"][ids], pool["v_s"][ids] = ops.quantize_kv(v_pages)
    else:
        pool["k"][ids] = k_pages.to(pool["k"].dtype)
        pool["v"][ids] = v_pages.to(pool["v"].dtype)
    return pool


def _to_page_chunks(x, page: int):
    """[S, ...] -> [ceil(S/page), page, ...] with a zero-padded tail."""
    s = x.shape[0]
    n = -(-s // page)
    pad = n * page - s
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x.reshape(n, page, *x.shape[1:])


def dense_rows_to_pages(pool: Dict, alloc: PagedAllocator,
                        rows: np.ndarray, r_state_rows: Dict) -> Dict:
    """Admit dense attention-state rows {k, v, pos} (the prefill payload)
    into allocated pages; an int8 pool quantizes them.  The dense slab's
    first L slots hold tokens 0..L-1 in order; L comes from the stored
    positions.  All rows go into ONE scatter per pool array.

    A payload that is ALREADY quantized ({k_q, k_s, v_q, v_s, pos}, the
    wire format of a quantized worker) is scattered verbatim into an int8
    pool: no re-quantization."""
    from repro_torch.core.decompose import attn_state_lengths
    quantized_payload = "k_q" in r_state_rows
    if quantized_payload and "k_q" not in pool:
        raise ValueError(
            "quantized payload into an fp page pool — dequantize first "
            "(RWorker._coerce_storage)")
    lens = attn_state_lengths(r_state_rows).cpu().numpy()
    pos_max = r_state_rows["pos"].amax(dim=1).cpu().numpy()
    any_pages = _any_pages(pool)
    page = any_pages.shape[1]
    names = (("k_q", "k_s", "v_q", "v_s") if quantized_payload
             else ("k", "v"))
    ids_all = []
    chunks: Dict[str, list] = {n: [] for n in names}
    for i, row in enumerate(rows):
        length = int(lens[i])
        if length and int(pos_max[i]) + 1 != length:
            raise ValueError(
                "paged conversion requires an unrotated dense prefix "
                "(slot i == token i); rotated ring payloads (windowed "
                "attention, prompt > cache_len) must stay dense")
        alloc.admit(int(row), length)
        if length:
            n = -(-length // page)
            ids_all.append(alloc.tables[int(row), :n])
            for name in names:
                chunks[name].append(
                    _to_page_chunks(r_state_rows[name][i, :length], page))
    if not ids_all:
        return pool
    ids = torch.from_numpy(np.concatenate(ids_all).astype(np.int64)).to(
        any_pages.device)
    if quantized_payload:
        for name in names:
            pool[name][ids] = torch.cat(chunks[name]).to(pool[name].dtype)
        return pool
    return _scatter_pages(pool, ids, torch.cat(chunks["k"]),
                          torch.cat(chunks["v"]))


# ---------------------------------------------------------------------------
# the parameter-free R-Part op over (pool, tables)
# ---------------------------------------------------------------------------
def r_attention_paged_tables(r_in: Dict, pool: Dict, tables, *,
                             window: int = 0, softcap: float = 0.0,
                             use_kernel: str = "auto"):
    """Drop-in for decompose.r_attention with block-table storage: append
    the new (k, v) at ``lengths`` (in place), then attend through the
    paged flash-decode kernel (fp pools) or the gather + int8 kernel
    (int8 pools).  r_in: q/k/v [B,1,...], lengths [B]; returns
    ({"o": [B,1,Hq,Dh]}, pool)."""
    lengths = r_in["lengths"]
    pool = write_token_paged(pool, tables, lengths, r_in["k"][:, 0],
                             r_in["v"][:, 0], active=r_in.get("active"))
    q = r_in["q"][:, 0].contiguous()
    lens = lengths.to(torch.int32).contiguous()
    if "k_q" in pool:
        o = ops.paged_decode_attention_int8(
            q, pool["k_q"], pool["k_s"], pool["v_q"], pool["v_s"], tables,
            lens, window=window, softcap=softcap, use_kernel=use_kernel)
    else:
        o = ops.paged_decode_attention(
            q, pool["k"], pool["v"], tables, lens, window=window,
            softcap=softcap, use_kernel=use_kernel)
    return {"o": o[:, None]}, pool


def _write_chunk(r_in: Dict, pool: Dict, tables):
    """Write C tokens per row (r_in k/v [B,C,Hkv,Dh] at positions
    lengths[b] + c) into their mapped pages, IN PLACE; an int8 pool
    quantizes them per (token, head) first.  Writes that are not valid,
    unmapped or past the table go to the scratch page.  Returns the
    query positions [B,C] (int64)."""
    base, valid = r_in["lengths"], r_in["valid"]
    scratch = pool_pages(pool)
    page = _any_pages(pool).shape[1]
    mp = tables.shape[1]
    c = valid.shape[1]
    qpos = (base[:, None].long()
            + torch.arange(c, device=base.device)[None, :])
    pidx = qpos // page
    ids = torch.gather(tables, 1, torch.clamp(pidx, max=mp - 1)).long()
    ok = valid & (ids >= 0) & (pidx < mp)
    ids = torch.where(ok, ids, torch.full_like(ids, scratch))
    slot = qpos % page
    if "k_q" in pool:
        pool["k_q"][ids, slot], pool["k_s"][ids, slot] = ops.quantize_kv(
            r_in["k"])
        pool["v_q"][ids, slot], pool["v_s"][ids, slot] = ops.quantize_kv(
            r_in["v"])
    else:
        pool["k"][ids, slot] = r_in["k"].to(pool["k"].dtype)
        pool["v"][ids, slot] = r_in["v"].to(pool["v"].dtype)
    return qpos


def r_attention_paged_chunk(r_in: Dict, pool: Dict, tables, *,
                            window: int = 0, softcap: float = 0.0,
                            kv_chunk: int = 1024):
    """Chunked-prefill R-Part over block tables: write the chunk's (k, v)
    into the mapped pages (already grown, see
    ``PagedAllocator.append_chunk``) at derived positions, then attend the
    chunk queries against the gathered cache: write-then-attend, so
    intra-chunk causality falls out of the position mask.  An int8 pool
    quantizes the chunk per (token, head), exactly as a whole-prompt load
    would, and the gathered view is dequantized.  The view is bounded by
    the table width given (the caller cuts it to the used pages).  Plain
    torch (``L.flash_attention``), as the JAX package's op is jnp.

    r_in: q/k/v [B,C,...], lengths [B] (KV offset), valid [B,C].  Returns
    ({"o": [B,C,Hq,Dh]}, pool)."""
    q, base, valid = r_in["q"], r_in["lengths"], r_in["valid"]
    qpos = _write_chunk(r_in, pool, tables)
    page = _any_pages(pool).shape[1]
    b, mp = tables.shape
    safe = torch.clamp(tables, min=0).long()
    if "k_q" in pool:
        kd = ops.dequantize_kv(pool["k_q"][safe], pool["k_s"][safe])
        vd = ops.dequantize_kv(pool["v_q"][safe], pool["v_s"][safe])
    else:
        kd, vd = pool["k"][safe], pool["v"][safe]   # [B, MP, page, H, Dh]
    kd = kd.reshape(b, mp * page, *kd.shape[3:])
    vd = vd.reshape(b, mp * page, *vd.shape[3:])
    new_len = base.long() + valid.sum(dim=1)
    derived = torch.arange(mp * page, device=q.device)[None, :]
    mapped = (tables >= 0).repeat_interleave(page, dim=1)
    kpos = torch.where(mapped & (derived < new_len[:, None]), derived,
                       torch.full_like(derived, -1))
    o = L.flash_attention(q, kd, vd, qpos, kpos, causal=True, window=window,
                          softcap=softcap,
                          kv_chunk=max(kd.shape[1], kv_chunk))
    return {"o": o}, pool


def r_attention_paged_verify(r_in: Dict, pool: Dict, tables, *,
                             window: int = 0, softcap: float = 0.0,
                             use_kernel: str = "auto"):
    """Speculative-decode verify R-Part over block tables: write the C
    candidate tokens' (k, v) into their mapped pages (in place; see
    ``PagedAllocator.append_chunk``), then score every candidate against
    the whole cache in ONE pool sweep through the multi-token verify
    kernel: the single KV pass that amortizes FastDecode's per-token
    R-side cost (C)-fold.  Writes that are not valid, unmapped or past
    the table go to the scratch page.

    r_in: q/k/v [B,C,...], lengths [B] (base = tokens before this step),
    valid [B,C] (all True on verified rows, all False on bystanders).
    ``tables`` may be cut to the used pages.  An int8 pool quantizes the
    candidates into their pages and scores them through kernel 3's
    multi-token paged entry (``ops.paged_verify_attention_int8``), an fp
    pool through kernel 4.  Returns ({"o": [B,C,Hq,Dh]}, pool)."""
    _write_chunk(r_in, pool, tables)
    q = r_in["q"].contiguous()
    base = r_in["lengths"].to(torch.int32).contiguous()
    if "k_q" in pool:
        o = ops.paged_verify_attention_int8(
            q, pool["k_q"], pool["k_s"], pool["v_q"], pool["v_s"], tables,
            base, window=window, softcap=softcap, use_kernel=use_kernel)
    else:
        o = ops.paged_verify_attention(
            q, pool["k"], pool["v"], tables, base, window=window,
            softcap=softcap, use_kernel=use_kernel)
    return {"o": o}, pool
