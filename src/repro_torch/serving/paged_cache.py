"""Paged KV storage for the port's R-workers (counterpart of
repro.serving.paged_cache, without the prefix index and the host tier).

* ``PagedAllocator`` — HOST-side block-table state for one worker's rows
  of one micro-batch, shared by every attention layer (a sequence's
  layers always have equal lengths); each layer owns its own page pool,
  addressed by the shared page ids.
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

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L


class PagedAllocator:
    """Host-side block-table allocator for one worker's rows of one
    micro-batch, shared across that worker's attention layers."""

    def __init__(self, rows: int, num_pages: int, page: int,
                 max_pages_per_seq: int, device=None):
        self.rows, self.num_pages, self.page = rows, num_pages, page
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
        # the device copy of ``tables``: one fixed buffer (graphs read it
        # in place), refreshed by copy after a host mutation
        self._dev_tables: Optional[torch.Tensor] = None
        self._dirty = True

    def _take_page(self) -> int:
        if self.free:
            return self.free.pop()
        raise MemoryError("paged KV pool exhausted")

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
            self.tables[row, slot] = self._take_page()   # stale table
        return need > have

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

    def release(self, row: int) -> None:
        ids = self.tables[row][self.tables[row] >= 0]
        if len(ids):
            self._dirty = True
        self.free.extend(int(i) for i in ids)
        self.tables[row] = -1
        self.active[row] = False
        self.frozen[row] = False
        self.lengths[row] = 0

    def ensure_lengths(self, new_lengths: np.ndarray,
                       mask: Optional[np.ndarray] = None) -> bool:
        """Grow active rows to hold ``new_lengths`` tokens, right before a
        decode append; released rows stay table-less.  ``mask`` limits the
        update to rows the engine is decoding.  Growth is clamped to the
        per-sequence capacity and a pool-exhausted grow freezes the row
        (its further writes are dropped) instead of failing the step;
        admission bounds make neither reachable under admitted load."""
        cap = self.max_pages * self.page
        changed = False
        rows = self.active & ~self.frozen
        if mask is not None:
            rows = rows & np.asarray(mask, bool)
        for row in np.nonzero(rows)[0]:
            try:
                changed |= self._ensure_row(int(row),
                                            min(int(new_lengths[row]), cap))
            except MemoryError:
                self.frozen[row] = True
            self.lengths[row] = int(new_lengths[row])
        return changed

    def append_chunk(self, base: np.ndarray, counts: np.ndarray) -> bool:
        """Chunk growth (a speculative-decode verify step): rows with
        counts[row] > 0 receive ``counts[row]`` tokens at offset
        ``base[row]``.  A row starting from offset 0 is (re-)admitted
        fresh: a previous occupant's pages are released first.  Rows with
        counts == 0 are untouched.  Pool exhaustion freezes the row as
        decode-time growth does."""
        cap = self.max_pages * self.page
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
                changed |= self._ensure_row(row, min(b0 + cnt, cap))
            except MemoryError:
                self.frozen[row] = True
            self.lengths[row] = b0 + cnt
        return changed

    def truncate(self, row: int, new_len: int) -> int:
        """Roll ``row`` back to ``new_len`` tokens (the speculative-decode
        rejection path): table slots >= ceil(new_len/page) return to the
        free list, so admission capacity is not leaked to tokens that were
        never emitted.  The kept partial page needs no wipe: positions >=
        new_len fall outside every reader's mask, and the next verify
        step writes from ``new_len`` on before it attends.  Frozen rows
        only adjust ``lengths``.  Returns the number of slots dropped."""
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
            self.free.append(int(self.tables[row, s]))
            self.tables[row, s] = -1
        self.lengths[row] = new_len
        return len(slots)

    def used_pages(self) -> int:
        return self.num_pages - len(self.free)

    def available_pages(self) -> int:
        return len(self.free)

    def mapped_pages(self, row: int) -> int:
        return int((self.tables[row] >= 0).sum())

    def tables_device(self) -> torch.Tensor:
        """The block table on the device: one fixed [rows, max_pages]
        buffer, updated in place (a copy on the current stream) only
        after a host-side mutation — a row grows a page every ``page``
        steps, not every layer of every step — so a graph that reads it
        stays valid."""
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
