"""Continuous-batching engine: independent sequences sharing one forward.

The engine keeps B cache *slots*, each with its own position, so requests can
join (prefill one slot while the others hold), decode together in chunks, and
leave at EOS: the scheduling core of continuous batching. Mechanics:

* positions are an i32 [B] vector: rope rows are gathered per row, KV writes
  are per-row scatters, the causal mask is per row (models/llama.forward).
* an `active` bool [B] masks cache writes: a prefill touches only the joining
  slot; finished slots stay frozen while others decode.
* sampling parameters are per-slot vectors, and each slot draws from its OWN
  counter-based generator (sampling.CounterRNG): a request's sampled
  continuation follows from its seed whatever shares the batch.
* decode state is DEVICE-RESIDENT: the per-slot vectors live as tensors
  carried chunk to chunk (the numpy mirrors refresh at admission/commit/
  release boundaries), so steady-state decode uploads nothing and reads
  nothing back. decode_dispatch/decode_consume split a chunk into a launch
  that returns at once and a wait on an event, so the serving scheduler runs
  its Python work while the card computes.
* KV layout: ``dense`` (a [seq_len] row range per slot) or ``paged`` (a global
  page pool with per-slot block tables and the refcounted PagePool
  allocator); the two give the same tokens.

Device buffers are updated in place where the JAX package donates them (the
cache or pool, the occurrence counts). Every device tensor is made on the
engine's explicit device, and every method that runs device work enters
``torch.no_grad()`` itself, so any thread may drive the engine.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from dllama_tpu_torch.engine.engine import CACHE_DTYPES, pow2_chunk
from dllama_tpu_torch.engine.kernel_select import resolve_kernels
from dllama_tpu_torch.engine.sampling import CounterRNG, apply_penalties, sample_logits
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.models.llama import KVCache, PagedKVCache, forward
from dllama_tpu_torch.ops.layers import build_rope_cache

log = logging.getLogger("dllama_tpu_torch.engine")


class AdmissionAborted(RuntimeError):
    """A cooperative abort fired between prefill chunks of add(); the slot is
    left inactive and its cached rows must not be reused."""


class PageExhausted(RuntimeError):
    """The paged KV pool cannot cover a requested allocation. The serving
    scheduler checks admission_deficit() first, so only direct callers of
    add() with an undersized pool see it."""


class PoolAuditError(RuntimeError):
    """A PagePool invariant broke: a double release, a refcount that
    disagrees with the block tables, or a free-list/live-page overlap."""


class PagePool:
    """Host-side refcounted page allocator for the paged KV cache.

    Owns the per-slot block tables (numpy mirrors of PagedKVCache.tables),
    the per-page refcounts and the free list. A slot's logical rows
    [0, n_blocks * page_size) are backed one page per block, and a page
    referenced by several tables (prefix sharing) is freed only when its last
    reference drops. Device copies that copy-on-write needs are made by the
    engine's ``copy_fn(src_page, dst_page)`` callback."""

    def __init__(self, n_pages: int, page_size: int, n_slots: int, max_blocks: int):
        if n_pages < 2:
            raise ValueError(f"kv_pages={n_pages}: the pool needs at least a prompt page "
                             "and a decode page")
        self.n_pages = n_pages
        self.page_size = page_size
        self.max_blocks = max_blocks
        self.refcount = np.zeros(n_pages, np.int32)
        self.tables = np.zeros((n_slots, max_blocks), np.int32)
        self.n_blocks = np.zeros(n_slots, np.int32)
        self._free: list[int] = list(range(n_pages - 1, -1, -1))
        #: run audit() after every release (tests turn it on)
        self.audit_on_release = False
        #: provider of (slot, first writable row) for active slots (the
        #: engine's): audit() checks those rows' pages are exclusively owned
        self.write_horizons = None

    # ----------------------------------------------------------- accounting

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def shared_count(self) -> int:
        return int(np.count_nonzero(self.refcount > 1))

    def blocks_for(self, rows: int) -> int:
        return -(-int(rows) // self.page_size)

    def covered_rows(self, slot: int) -> int:
        """Rows of `slot` with backing pages (its decode row limit)."""
        return int(self.n_blocks[slot]) * self.page_size

    def stats(self) -> dict:
        return {"total": self.n_pages, "free": self.free_count,
                "used": self.n_pages - self.free_count, "shared": self.shared_count,
                "page_size": self.page_size}

    def audit(self, raise_on_fail: bool = True) -> dict:
        """Invariant check over the refcounts, block tables and free list:
        each page's refcount equals its block-table references; the free list
        holds exactly the refcount-0 pages, once each; no negative refcount;
        rows an active slot may write next lie in exclusively owned pages.
        Returns ``{"ok", "problems", ...stats}``; raises PoolAuditError on a
        violation unless ``raise_on_fail`` is False."""
        problems: list[str] = []
        refs = np.zeros(self.n_pages, np.int64)
        for s in range(self.tables.shape[0]):
            for b in range(int(self.n_blocks[s])):
                p = int(self.tables[s, b])
                if 0 <= p < self.n_pages:
                    refs[p] += 1
                else:
                    problems.append(f"slot {s} block {b} references page {p} outside the "
                                    f"pool [0, {self.n_pages})")
        bad = np.flatnonzero(refs != self.refcount)
        for p in bad[:8]:
            problems.append(f"page {int(p)}: refcount {int(self.refcount[p])} but "
                            f"{int(refs[p])} block-table references")
        if len(bad) > 8:
            problems.append(f"... and {len(bad) - 8} more refcount mismatches")
        if self.write_horizons is not None:
            for s, row in self.write_horizons():
                for b in range(int(row) // self.page_size, int(self.n_blocks[s])):
                    p = int(self.tables[s, b])
                    if 0 <= p < self.n_pages and self.refcount[p] > 1:
                        problems.append(f"active slot {s} block {b} (page {p}, refcount "
                                        f"{int(self.refcount[p])}) is shared inside the "
                                        f"writable range (row >= {int(row)})")
        neg = np.flatnonzero(self.refcount < 0)
        if neg.size:
            problems.append(f"negative refcounts at pages {neg[:8].tolist()} (double release)")
        free = set(self._free)
        if len(free) != len(self._free):
            problems.append(f"free list holds duplicates ({len(self._free)} entries, "
                            f"{len(free)} distinct)")
        live = {p for p in range(self.n_pages) if self.refcount[p] > 0}
        if free & live:
            problems.append(f"free list overlaps live pages: {sorted(free & live)[:8]}")
        orphan = set(range(self.n_pages)) - free - live
        if orphan:
            problems.append(f"leaked pages (refcount 0 but not on the free list): "
                            f"{sorted(orphan)[:8]}")
        report = dict(self.stats(), ok=not problems, problems=problems)
        if problems and raise_on_fail:
            raise PoolAuditError("kv page-pool audit failed: " + "; ".join(problems))
        return report

    # ------------------------------------------------------------ primitives

    def _alloc_page(self) -> int:
        if not self._free:
            raise PageExhausted(f"page pool exhausted ({self.n_pages} pages of "
                                f"{self.page_size} rows, all referenced)")
        p = self._free.pop()
        self.refcount[p] = 1
        return p

    def _decref(self, p: int) -> None:
        if self.refcount[p] <= 0:
            # a double release would hand the page to two owners at once
            raise PoolAuditError(f"double release of page {p} (refcount already "
                                 f"{int(self.refcount[p])})")
        self.refcount[p] -= 1
        if self.refcount[p] == 0:
            self._free.append(p)

    def grow(self, slot: int, rows: int, best_effort: bool = False) -> bool:
        """Extend `slot`'s table until its pages cover `rows` logical rows.
        All or nothing unless best_effort (then: allocate what the free list
        holds and stop). Returns True when the table changed."""
        need = self.blocks_for(rows) - int(self.n_blocks[slot])
        if need <= 0:
            return False
        if not best_effort and need > self.free_count:
            raise PageExhausted(f"slot {slot} needs {need} pages to reach row {rows}; "
                                f"{self.free_count} free of {self.n_pages}")
        changed = False
        for _ in range(need):
            if not self._free:
                break
            self.tables[slot, self.n_blocks[slot]] = self._alloc_page()
            self.n_blocks[slot] += 1
            changed = True
        return changed

    def free_tail(self, slot: int, keep_rows: int) -> int:
        """Drop `slot`'s blocks past the one holding row keep_rows-1 (all of
        them for keep_rows == 0). Returns the pages that went back to the
        free list (a shared page only loses one reference). keep_rows past
        the covered range keeps everything: n_blocks never grows here."""
        keep = min(self.blocks_for(keep_rows), int(self.n_blocks[slot]))
        freed = 0
        for b in range(keep, int(self.n_blocks[slot])):
            before = self.free_count
            self._decref(int(self.tables[slot, b]))
            freed += self.free_count - before
            self.tables[slot, b] = 0
        self.n_blocks[slot] = keep
        return freed

    def ensure_writable(self, slot: int, row: int, copy_fn) -> None:
        """Copy-on-write: make the page holding `row` exclusively `slot`'s
        before it is (partly) rewritten; the other referents keep the
        original bytes."""
        b = int(row) // self.page_size
        if b >= int(self.n_blocks[slot]):
            return
        old = int(self.tables[slot, b])
        if self.refcount[old] <= 1:
            return
        new = self._alloc_page()
        copy_fn(old, new)
        self.refcount[old] -= 1  # > 1 before, so never frees
        self.tables[slot, b] = new

    def cow_writable(self, slot: int, start_row: int, end_row: int, copy_fn) -> bool:
        """Copy-on-write every SHARED block of `slot` covering rows
        [start_row, end_row) before a decode writes there. Returns True when
        a page was split (the block tables changed)."""
        first = int(start_row) // self.page_size
        last = min(self.blocks_for(end_row), int(self.n_blocks[slot]))
        changed = False
        for b in range(first, last):
            if self.refcount[int(self.tables[slot, b])] > 1:
                self.ensure_writable(slot, b * self.page_size, copy_fn)
                changed = True
        return changed

    def share_prefix(self, src: int, dst: int, rows: int, copy_fn) -> None:
        """Make dst's first `rows` rows alias src's pages: full pages are
        refcounted (no copy), a partial boundary page is cloned into a fresh
        page (its tail diverges at once). Drops whatever dst held."""
        self.free_tail(dst, 0)
        full, part = divmod(int(rows), self.page_size)
        for b in range(full):
            p = int(self.tables[src, b])
            self.refcount[p] += 1
            self.tables[dst, b] = p
        self.n_blocks[dst] = full
        if part:
            new = self._alloc_page()
            copy_fn(int(self.tables[src, full]), new)
            self.tables[dst, full] = new
            self.n_blocks[dst] = full + 1

    def prepare_admission(self, slot: int, start: int, end: int, copy_fn) -> None:
        """Position `slot` for a prefill of rows [start, end): drop the dead
        tail past start, copy-on-write the boundary page when it is kept and
        shared, then allocate pages through `end`."""
        self.free_tail(slot, start)
        if start % self.page_size:
            self.ensure_writable(slot, start, copy_fn)
        self.grow(slot, end)

    def admission_deficit(self, slot: int, reuse: int, total_rows: int, cross: bool) -> int:
        """Pages the pool is SHORT for admitting a `total_rows` prompt into
        `slot` with `reuse` prefix rows resolved (`cross`: the prefix comes
        by share_prefix from another slot), one decode page in reserve. 0
        means the admission fits."""
        req = self.blocks_for(total_rows) + 1  # +1 decode-page reserve
        if cross:
            kept = int(reuse) // self.page_size  # full shared blocks are free
            avail = self.free_count + self._tail_refund(slot, 0)
        else:
            kept = min(int(self.n_blocks[slot]), self.blocks_for(reuse))
            avail = self.free_count + self._tail_refund(slot, reuse)
            b = int(reuse) // self.page_size
            if (reuse % self.page_size and b < int(self.n_blocks[slot])
                    and self.refcount[int(self.tables[slot, b])] > 1):
                req += 1  # boundary copy-on-write page
        return max(0, req - kept - avail)

    def _tail_refund(self, slot: int, keep_rows: int) -> int:
        """Pages free_tail(slot, keep_rows) would return to the free list."""
        keep = self.blocks_for(keep_rows)
        return sum(1 for b in range(keep, int(self.n_blocks[slot]))
                   if self.refcount[int(self.tables[slot, b])] == 1)


def _sample_rows(logits: torch.Tensor, uniforms: torch.Tensor, temps: torch.Tensor,
                 topps: torch.Tensor) -> torch.Tensor:
    """Per-row sampling with per-row uniforms: [B, V] x [B, 2] -> [B]. The JAX
    package vmaps sample_logits over per-row keys; here sample_logits takes
    the per-row temperature and top-p vectors itself."""
    return sample_logits(logits, temps, topps, uniforms=uniforms)


@dataclass
class Admission:
    """In-flight incremental prefill of one slot (add_begin/add_step/add_commit)."""

    slot: int
    toks: np.ndarray  # i64 prompt tokens still owed rows from toks[off:]
    off: int = 0
    logits: torch.Tensor | None = None  # [1, V] of the LAST chunk, on the device
    req_id: str = ""


@dataclass
class DecodeChunk:
    """A dispatched, not yet consumed decode chunk (decode_dispatch).

    `toks` and `bad` are host tensors (pinned on a CUDA engine) that a
    non-blocking copy fills; `event` is recorded after that copy, and
    decode_consume waits on it. The numpy fields are host snapshots taken at
    dispatch, so the scheduler attributes each slot's tokens to the state the
    chunk really ran with."""

    toks: torch.Tensor  # [n, B] i64
    bad: torch.Tensor  # bool [B]: rows whose logits went non-finite
    event: object  # torch.cuda.Event, or None on the CPU
    n: int
    start_pos: np.ndarray  # i32 [B] per-slot position at dispatch
    active: np.ndarray  # bool [B] active mask at dispatch
    advance: np.ndarray  # i32 [B] rows each slot really advances
    seq: int = 0

    def nonfinite(self) -> np.ndarray | None:
        """bool [B] rows whose logits went non-finite in this chunk, or None
        when every row is clean. The scheduler fails those requests."""
        out = self.bad.numpy()
        return out.copy() if out.any() else None


class BatchEngine:
    def __init__(
        self,
        cfg: LlamaConfig,
        params: dict,
        n_slots: int = 4,
        cache_dtype=torch.bfloat16,
        max_seq_len: int | None = None,
        max_prefill_chunk: int = 256,
        seed: int = 0,
        kernels: str = "auto",  # 'auto' | 'cuda' | 'torch' (as InferenceEngine)
        kv_layout: str = "dense",  # 'dense' | 'paged'
        page_size: int = 128,  # paged: rows per page (must divide seq_len)
        kv_pages: int = 0,  # paged: pool size in pages; 0 = n_slots * seq_len / page_size
        device=None,  # default: the device the params lie on
    ):
        if cache_dtype not in CACHE_DTYPES:
            raise ValueError(f"KV cache dtype {cache_dtype} is not one of {CACHE_DTYPES}")
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else params["embedding"].device
        self.params = params  # fused wqkv/w13 when the caller's engine fused them
        self.n_slots = n_slots
        self.seq_len = min(max_seq_len or cfg.seq_len, cfg.seq_len)
        self.max_prefill_chunk = max_prefill_chunk
        self.rope_cache = build_rope_cache(cfg, self.seq_len, self.device)
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be dense|paged, got {kv_layout!r}")
        self.kv_layout = kv_layout
        self.page_size = int(page_size)
        self.cache_dtype = cache_dtype
        self.pool: PagePool | None = None
        if kv_layout == "paged":
            if self.page_size <= 0 or self.seq_len % self.page_size:
                raise ValueError(f"page_size {self.page_size} must divide the context "
                                 f"length {self.seq_len} (the logical view keeps the dense "
                                 "cache's shape, which is what makes it bit-exact)")
            max_blocks = self.seq_len // self.page_size
            n_pages = int(kv_pages) or max_blocks * n_slots
            self.pool = PagePool(n_pages, self.page_size, n_slots, max_blocks)
            self.pool.write_horizons = self._write_horizons
            self.cache = PagedKVCache.create(cfg, n_slots, n_pages, self.page_size,
                                             cache_dtype, max_blocks, self.device)
        else:
            self.cache = KVCache.create(cfg, n_slots, cache_dtype, self.seq_len, self.device)
        sel = resolve_kernels(cfg, kernels, self.device, paged=self.pool is not None,
                              page_size=self.page_size, cache_dtype=cache_dtype)
        self.mm, self.attn_fn = sel.mm, sel.attn_fn
        self.backend, self.attn_route = sel.backend, sel.attn_route

        # host mirrors (the scheduler's view)
        self.pos = np.zeros(n_slots, np.int32)  # next cache row per slot
        self.active = np.zeros(n_slots, bool)
        self.last_token = np.zeros(n_slots, np.int64)
        self.temperature = np.zeros(n_slots, np.float32)
        self.topp = np.full(n_slots, 0.9, np.float32)
        self.presence = np.zeros(n_slots, np.float32)
        self.frequency = np.zeros(n_slots, np.float32)
        self.seeds = np.zeros(n_slots, np.int64)  # each slot's request seed (commit record)
        self.seed = int(seed)
        self._admissions = 0
        self.chunk_seq = 0
        self.forwards = 0  # forward passes run (a decode step or a prefill chunk)

        # device-resident decode state. pos, last token and the generator are
        # device-authoritative (the decode loop moves them); host mutation
        # sites write their slot's row in place. The other vectors are
        # host-authoritative: re-uploaded (as NEW tensors, so a chunk in
        # flight keeps reading the old ones) when _vec_dirty is set, i.e. at
        # boundaries only.
        self._vec_dirty = True
        self._pos_dev = torch.zeros(n_slots, dtype=torch.int32, device=self.device)
        self._last_dev = torch.zeros(n_slots, dtype=torch.int64, device=self.device)
        self.rng = CounterRNG(n_slots, self.device)
        self._active_dev = self._temps_dev = self._topp_dev = None
        self._pres_dev = self._freq_dev = self._limit_dev = None
        self._counts: torch.Tensor | None = None  # i32 [B, V], on the first penalized request
        self._rows = torch.arange(n_slots, device=self.device)

    # ------------------------------------------------------------- helpers

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """A NEW device tensor holding a copy of `arr`. On a CUDA device the
        copy goes through pinned memory and does not block the host (a
        pageable copy would wait for every launch queued before it, which
        serializes the overlapped pipeline); `arr` may be mutated at once."""
        t = torch.from_numpy(np.array(arr, copy=True))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _fwd(self, tokens: torch.Tensor, pos, cache, active=None) -> torch.Tensor:
        """One forward; returns last-position logits f32 [B, V]."""
        self.forwards += 1
        logits, _ = forward(self.cfg, self.params, tokens, pos, cache, self.rope_cache,
                            self.attn_fn, self.mm, last_only=True, active=active)
        return logits[:, -1]

    # ------------------------------------------------------- paged-layout api

    @torch.no_grad()
    def _pool_page_copy(self, src_page: int, dst_page: int) -> None:
        """PagePool's device-copy callback: clone pool page src into dst in
        every layer (k and v), in place."""
        self.cache.k[:, dst_page] = self.cache.k[:, src_page]
        self.cache.v[:, dst_page] = self.cache.v[:, src_page]

    def _row_limit(self) -> np.ndarray:
        """i32 [B] per-slot decode row limit: seq_len on dense; min(seq_len,
        allocated pages * page_size) on paged."""
        if self.pool is None:
            return np.full(self.n_slots, self.seq_len, np.int32)
        return np.minimum(self.seq_len, self.pool.n_blocks.astype(np.int64)
                          * self.page_size).astype(np.int32)

    def _alloc_decode_rows(self, n: int) -> None:
        """Paged: best-effort top-up before a decode dispatch, extending each
        active slot's table to cover n more rows (at most seq_len); slots
        the pool cannot serve keep their limit and freeze per row. Also the
        copy-on-write gate: a SHARED page covering the rows [pos, pos+n) a
        slot writes next is split first."""
        if self.pool is None:
            return
        changed = False
        for s in np.flatnonzero(self.active):
            want = min(self.seq_len, int(self.pos[s]) + n)
            changed |= self.pool.grow(int(s), want, best_effort=True)
            changed |= self.pool.cow_writable(int(s), int(self.pos[s]), want,
                                              self._pool_page_copy)
        if changed:
            self._vec_dirty = True

    def _write_horizons(self) -> list[tuple[int, int]]:
        """PagePool.audit() provider: (slot, first writable row) of every
        active slot."""
        return [(int(s), int(self.pos[s])) for s in np.flatnonzero(self.active)]

    def page_starved(self) -> np.ndarray:
        """bool [B]: active slots whose next decode row has no backing page
        even after a top-up: frozen by pool exhaustion, not by the context
        edge. The scheduler breaks the all-starved livelock with it."""
        if self.pool is None:
            return np.zeros(self.n_slots, bool)
        self._alloc_decode_rows(1)
        limit = self._row_limit()
        return (self.active & (self.pos >= limit) & (self.pos < self.seq_len)
                & (self.pool.free_count == 0))

    def admission_deficit(self, slot: int, reuse: int, prompt_len: int, cross: bool) -> int:
        """Pages SHORT for admitting `prompt_len` rows into `slot` (0 on the
        dense layout or when it fits)."""
        if self.pool is None:
            return 0
        return self.pool.admission_deficit(slot, reuse, prompt_len, cross)

    def min_pages_for(self, prompt_len: int) -> int:
        """Pages an admission of `prompt_len` rows needs from an empty pool,
        the decode reserve included: above the pool total it can never fit."""
        if self.pool is None:
            return 0
        return self.pool.blocks_for(prompt_len) + 1

    def drop_slot_pages(self, slot: int) -> int:
        """Evict an idle slot's cached pages (prefix-cache reclaim under pool
        pressure). Returns the pages that went back to the free list."""
        if self.active[slot]:
            raise ValueError(f"slot {slot} is busy")
        if self.pool is None:
            return 0
        freed = self.pool.free_tail(slot, 0)
        self.pos[slot] = 0
        self._pos_dev[slot] = 0
        self._vec_dirty = True
        return freed

    def kv_page_stats(self) -> dict | None:
        """Pool occupancy for /health and latency_summary(); None on dense."""
        return None if self.pool is None else self.pool.stats()

    # ------------------------------------------------------------------- api

    @torch.no_grad()
    def copy_prefix_rows(self, src_slot: int, dst_slot: int, rows: int) -> None:
        """Cross-slot prefix share: make dst_slot's first `rows` KV rows equal
        to src_slot's, so an admission into dst starts at rows. Dense: one
        on-device row copy. Paged: full pages are SHARED by refcount and only
        a partial boundary page is cloned; divergence later copies on write."""
        if self.active[dst_slot]:
            raise ValueError(f"dst slot {dst_slot} is busy")
        if self.pool is not None:
            self.pool.share_prefix(src_slot, dst_slot, rows, self._pool_page_copy)
        else:
            for buf in (self.cache.k, self.cache.v):
                buf[:, dst_slot, :, :rows] = buf[:, src_slot, :, :rows]
        self.pos[dst_slot] = rows
        self._pos_dev[dst_slot] = int(rows)
        self._vec_dirty = True

    def free_slot(self) -> int | None:
        idle = np.flatnonzero(~self.active)
        return int(idle[0]) if idle.size else None

    @torch.no_grad()
    def add_begin(self, slot: int, prompt_tokens, start_pos: int = 0,
                  req_id: str = "") -> Admission:
        """Start an incremental admission: validate and position the slot and
        return the handle to pump with add_step / add_commit. The slot stays
        inactive (decode leaves it frozen) until add_commit."""
        if self.active[slot]:
            raise ValueError(f"slot {slot} is busy")
        n = len(prompt_tokens)
        if n == 0:
            raise ValueError("prompt must be non-empty")
        if start_pos + n >= self.seq_len:
            raise ValueError(f"prompt ({start_pos}+{n}) exceeds seq_len {self.seq_len}")
        if self.pool is not None:
            # drop the dead tail, copy-on-write a shared boundary page, back
            # every prompt row with a page (PageExhausted when it cannot)
            self.pool.prepare_admission(slot, start_pos, start_pos + n, self._pool_page_copy)
        self.pos[slot] = start_pos
        self._pos_dev[slot] = int(start_pos)
        self._vec_dirty = True
        return Admission(slot=slot, toks=np.asarray(prompt_tokens, np.int64), req_id=req_id)

    @torch.no_grad()
    def add_step(self, adm: Admission) -> bool:
        """Prefill ONE power-of-two chunk of the admission's prompt at B=1;
        returns True when every prompt token's KV row is written."""
        n, off, slot = len(adm.toks), adm.off, adm.slot
        c = pow2_chunk(n - off, self.max_prefill_chunk)
        if self.pool is not None:
            # the slot's block table changed at add_begin: refresh the device
            # copy before the chunk reads it
            self._sync_vectors()
            sub = PagedKVCache(self.cache.k, self.cache.v, self.cache.tables[slot : slot + 1])
        else:
            sub = KVCache(self.cache.k[:, slot : slot + 1], self.cache.v[:, slot : slot + 1])
        toks = self._h2d(adm.toks[None, off : off + c])
        adm.logits = self._fwd(toks, int(self.pos[slot]), sub)
        self.pos[slot] += c
        adm.off += c
        self._vec_dirty = True
        return adm.off >= n

    def _request_seed(self, seed: int | None) -> int:
        """The request's seed, or one derived from the engine seed and the
        admission count for requests without one."""
        if seed is not None:
            return int(seed)
        return (self.seed * 0x9E3779B97F4A7C15 + self._admissions + 1) & ((1 << 63) - 1)

    @torch.no_grad()
    def add_commit(self, adm: Admission, temperature: float = 0.8, topp: float = 0.9,
                   seed: int | None = None, presence: float = 0.0,
                   frequency: float = 0.0) -> int:
        """Sample the first token from the finished admission (counter 0 of
        the slot's generator) and activate the slot. Must follow add_step
        returning True."""
        if adm.off < len(adm.toks) or adm.logits is None:
            raise ValueError("admission not pumped")
        slot = adm.slot
        seed = self._request_seed(seed)
        self._admissions += 1
        self.seeds[slot] = seed
        self.rng.reset(slot, seed)
        u = self.rng.uniforms(1, rows=[slot])[0]
        first = int(sample_logits(adm.logits, float(temperature), float(topp), uniforms=u)[0])
        self.rng.advance_row(slot, 1)
        self.active[slot] = True
        self.last_token[slot] = first
        self.temperature[slot] = temperature
        self.topp[slot] = topp
        self.presence[slot] = presence
        self.frequency[slot] = frequency
        self._vec_dirty = True
        self._last_dev[slot] = first
        self._pos_dev[slot] = int(self.pos[slot])
        if presence or frequency:
            if self._counts is None:
                self._counts = torch.zeros((self.n_slots, self.cfg.vocab_size),
                                           dtype=torch.int32, device=self.device)
            # a fresh request has sampled nothing yet (OpenAI counts exclude
            # the prompt); slots without penalties never read their row
            self._counts[slot] = 0
        return first

    def add(self, slot: int, prompt_tokens, temperature: float = 0.8, topp: float = 0.9,
            start_pos: int = 0, seed: int | None = None, presence: float = 0.0,
            frequency: float = 0.0, abort=None) -> int:
        """Prefill `prompt_tokens` into `slot` (rows from start_pos: a cached
        prefix length reuses earlier rows) and sample the first token; other
        slots are untouched. `seed` pins the slot's stream. `abort` (a
        zero-argument callable) is polled between prefill chunks and raises
        AdmissionAborted. One-shot wrapper over add_begin/add_step/add_commit."""
        adm = self.add_begin(slot, prompt_tokens, start_pos)
        while not self.add_step(adm):
            if abort is not None and abort():
                raise AdmissionAborted(f"admission into slot {slot} aborted at "
                                       f"{adm.off}/{len(adm.toks)} prompt tokens")
        return self.add_commit(adm, temperature, topp, seed, presence=presence,
                               frequency=frequency)

    def _sync_vectors(self) -> None:
        """Refresh the device copies of the host-authoritative per-slot
        vectors (and the paged block tables), as new tensors on the same
        stream: a chunk already in flight keeps reading the old copies. A
        no-op in steady-state decode."""
        if not self._vec_dirty:
            return
        self._active_dev = self._h2d(self.active)
        self._temps_dev = self._h2d(self.temperature)
        self._topp_dev = self._h2d(self.topp)
        self._pres_dev = self._h2d(self.presence)
        self._freq_dev = self._h2d(self.frequency)
        self._limit_dev = self._h2d(self._row_limit())
        if self.pool is not None:
            self.cache = PagedKVCache(self.cache.k, self.cache.v, self._h2d(self.pool.tables))
        self._vec_dirty = False

    @torch.no_grad()
    def decode_dispatch(self, n: int) -> DecodeChunk:
        """Launch one n-step decode chunk across the active slots WITHOUT
        waiting for it. Tokens feed back on the device; the freeze, the
        generator's advance and the NaN guard are computed there; the chunk's
        tokens and flags go to host memory by a non-blocking copy with an
        event behind it. Nothing here reads a device value.

        A slot that reaches its row limit mid-chunk (seq_len, or the end of
        its allocated pages) freezes per row while its batch-mates keep the
        whole chunk; `DecodeChunk.advance` holds each slot's real count.
        Raises only when no active slot has any room."""
        if not self.active.any():
            raise ValueError("no active slots")
        self._alloc_decode_rows(n)
        limit = self._row_limit()
        room = limit[self.active] - self.pos[self.active]
        n = min(n, int(room.max()))
        if n <= 0:
            raise ValueError("every active slot is at its row limit (seq_len, or an "
                             "exhausted page pool); release first")
        self._sync_vectors()
        live = self.active
        sampled = bool((self.temperature[live] != 0.0).any())
        penalized = self._counts is not None and bool(
            ((self.presence[live] != 0.0) | (self.frequency[live] != 0.0)).any())
        act0, lim = self._active_dev, self._limit_dev
        lim_last = (lim - 1).clamp(min=0)
        p0 = p = self._pos_dev
        tok = self._last_dev
        bad = torch.zeros(self.n_slots, dtype=torch.bool, device=self.device)
        u = self.rng.uniforms(n) if sampled else None
        steps = []
        for i in range(n):
            # per-row freeze: frozen rows behave like inactive ones (writes
            # masked, token repeats, generator held); pos is clamped only for
            # their rope/cache indexing
            act = act0 & (p < lim)
            logits = self._fwd(tok[:, None], torch.minimum(p, lim_last), self.cache,
                               active=act)
            bad |= act & ~torch.isfinite(logits).all(dim=-1)
            if penalized:
                # the fed token counts before its successor is sampled
                self._counts.index_put_((self._rows, tok), act.to(torch.int32),
                                        accumulate=True)
                logits = apply_penalties(logits, self._counts, self._pres_dev,
                                         self._freq_dev)
            if sampled:
                nxt = _sample_rows(logits, u[i], self._temps_dev, self._topp_dev)
            else:
                nxt = torch.argmax(logits, dim=-1)
            tok = torch.where(act, nxt, tok)
            steps.append(tok)
            p = p + act.to(p.dtype)
        self.rng.advance((p - p0).to(torch.int64))  # one draw per active step
        self._pos_dev, self._last_dev = p, tok
        toks = torch.stack(steps)
        event = None
        if self.device.type == "cuda":
            host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
            host.copy_(toks, non_blocking=True)
            bad_host = torch.empty(bad.shape, dtype=torch.bool, pin_memory=True)
            bad_host.copy_(bad, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            toks, bad = host, bad_host
        start_pos = self.pos.copy()
        active = self.active.copy()
        advance = np.where(active, np.clip(limit - start_pos, 0, n), 0).astype(np.int32)
        # the host pos mirror advances arithmetically, exactly as the loop did
        self.pos += advance
        self.chunk_seq += 1
        return DecodeChunk(toks=toks, bad=bad, event=event, n=n, start_pos=start_pos,
                           active=active, advance=advance, seq=self.chunk_seq)

    def decode_consume(self, chunk: DecodeChunk) -> np.ndarray:
        """Wait for the chunk's tokens on the host; fold them into the host
        mirrors. Returns tokens [n, B] (frozen rows repeat their last token;
        callers use chunk.advance for per-slot counts)."""
        if chunk.event is not None:
            chunk.event.synchronize()
        toks = chunk.toks.numpy().copy()
        self.last_token[chunk.active] = toks[-1, chunk.active]
        return toks

    def decode(self, n: int) -> np.ndarray:
        """n decode steps across the active slots; returns tokens [n', B] with
        n' = min(n, the roomiest active slot's room). Lockstep wrapper over
        decode_dispatch/decode_consume."""
        return self.decode_consume(self.decode_dispatch(n))

    def release(self, slot: int, keep_rows: int | None = None) -> None:
        """Free a slot. keep_rows rewinds pos to the valid prefix (a stop
        mid-chunk, including rows a dispatched chunk overran), keeping the
        slot's cache for prefix reuse; on the paged layout the rewind also
        RETURNS the tail pages past the kept prefix (a shared page only
        loses this slot's reference). keep_rows=None means the rows are
        unspecified: every page goes back."""
        self.active[slot] = False
        self.presence[slot] = self.frequency[slot] = 0.0
        if keep_rows is not None:
            self.pos[slot] = keep_rows
            if self.pool is not None:
                self.pool.free_tail(slot, keep_rows)
        elif self.pool is not None:
            self.pool.free_tail(slot, 0)
            self.pos[slot] = 0
        self._pos_dev[slot] = int(self.pos[slot])
        if self.pool is not None and self.pool.audit_on_release:
            self.pool.audit()
        self._vec_dirty = True
