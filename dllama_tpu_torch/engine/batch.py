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
* decode state is DEVICE-RESIDENT: the per-slot vectors live in tensors
  made once and updated in place chunk to chunk (the numpy mirrors refresh
  at admission/commit/release boundaries), so steady-state decode uploads
  nothing and reads nothing back. decode_dispatch/decode_consume split a
  chunk into a launch that returns at once and a wait on an event, so the
  serving scheduler runs its Python work while the card computes.
* each n-step chunk is a decode program (engine/graphs.py) over those
  tensors, and each prompt chunk of one slot a prefill program of its
  token width, with the slot and its position as device inputs: on a CUDA
  device one CUDA graph per (variant, n) and per width, replayed;
  ``capture=False`` launches the same bodies from Python instead. warmup()
  captures every program the scheduler can ask for at boot.
* hybrid chunked prefill: hybrid_dispatch replays one prefill program of
  the admitting slot and then the decode program, back to back on one
  stream with no host read between them, so a joining prompt rides the
  decode chunks in slices instead of stalling them.
* KV layout: ``dense`` (a [seq_len] row range per slot) or ``paged`` (a global
  page pool with per-slot block tables and the refcounted PagePool
  allocator); the two give the same tokens.
* on the paged layout, the cross-request radix prefix tree
  (engine/radix.py, ``radix_cache``) and its host-RAM spill tier
  (HostKVPool, ``kv_host_pages``) act through the radix_* methods the
  serving scheduler drives; direct add/decode/release use is the same
  either way. resume_commit re-activates a preempted request's slot with
  its last token and generator counter, sampling nothing.
* batched speculative decoding (``spec`` = K, the JAX package's
  ``_spec_cycle_core``): a device history [B, seq_len+1] per slot feeds the
  n-gram proposer (engine/speculative.py), written wherever a slot's tokens
  are (prompt chunks and decode tokens inside their programs, commits,
  prefix copies and tree maps). decode_dispatch(n, spec=True) replays a
  spec program of n verify cycles: each greedy slot accepts up to its own
  draft length (``spec_k`` at commit, at most K), every other active slot
  takes one exact token a cycle, and eligibility, the draft clamp, the
  write mask and the positions are computed on the device every cycle, so
  the advance is data-dependent and the host mirrors settle at
  decode_consume.

Device buffers are updated in place where the JAX package donates them (the
cache or pool, the occurrence counts). Every device tensor is made on the
engine's explicit device, and every method that runs device work enters
``torch.no_grad()`` itself, so any thread may drive the engine.
"""

from __future__ import annotations

import logging
import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from dllama_tpu_torch.engine.engine import CACHE_DTYPES, _mesh_setup, pow2_chunk
from dllama_tpu_torch.engine.graphs import SPEC_VARIANTS, VARIANTS, Programs
from dllama_tpu_torch.engine.kernel_select import resolve_kernels, resolve_moe_impl
from dllama_tpu_torch.engine.radix import RadixCache
from dllama_tpu_torch.engine.sampling import CounterRNG, apply_penalties, sample_logits
from dllama_tpu_torch.engine.speculative import SPEC_NGRAM, masked_put, propose_ngram
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.models.llama import KVCache, PagedKVCache, forward
from dllama_tpu_torch.obs import compile as compile_obs
from dllama_tpu_torch.obs import instruments as ins
from dllama_tpu_torch.obs import trace
from dllama_tpu_torch.ops.layers import build_rope_cache
from dllama_tpu_torch.parallel.collectives import resolve_sync
from dllama_tpu_torch.parallel.multihost import mirrored
from dllama_tpu_torch.utils import faults, locks

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
    referenced by several tables (prefix sharing) or by the radix tree is
    freed only when its last reference drops. Device copies that
    copy-on-write needs are made by the engine's ``copy_fn(src_page,
    dst_page)`` callback. The methods that read or change the tables and
    refcounts hold one reentrant lock (``_mu``, shared with the radix tree
    and the host tier): the scheduler's worker is the only writer, and
    audit() and stats() are also read from HTTP handler threads."""

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
        self._mu = locks.make_rlock("engine.pool")
        #: run audit() after every release (tests turn it on)
        self.audit_on_release = False
        #: provider of per-page TREE reference counts and the tree's own
        #: problems (radix.RadixCache.audit_refs): audit() reconciles
        #: refcount == table refs + tree refs
        self.radix_refs = None
        #: provider of (slot, first writable row) for active slots (the
        #: engine's): audit() checks those rows' pages are exclusively owned,
        #: which under the tree is what proves no shared page is written
        self.write_horizons = None
        #: the host-RAM spill tier (HostKVPool), audited beside the pages
        self.host: HostKVPool | None = None
        self._publish()

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
        with self._mu:
            return {"total": self.n_pages, "free": self.free_count,
                    "used": self.n_pages - self.free_count, "shared": self.shared_count,
                    "page_size": self.page_size}

    def audit(self, raise_on_fail: bool = True) -> dict:
        """Invariant check over the refcounts, block tables and free list:
        each page's refcount equals its block-table references plus its
        radix-tree references; the free list holds exactly the refcount-0
        pages, once each; no negative refcount; rows an active slot may
        write next lie in exclusively owned pages; the host tier's own
        invariants hold. Returns ``{"ok", "problems", "radix_pages",
        ...stats}`` (and ``"host"`` with the tier on); raises PoolAuditError
        on a violation unless ``raise_on_fail`` is False."""
        with self._mu:
            report = self._audit()
        if report["problems"]:
            ins.KV_AUDIT_FAILURES.inc()
            if raise_on_fail:
                raise PoolAuditError("kv page-pool audit failed: "
                                     + "; ".join(report["problems"]))
        return report

    def _publish(self) -> None:
        """The dllama_kv_pages_{total,used,shared} gauges (the caller holds
        the lock or owns the pool); every mutation of the tables or
        refcounts ends here."""
        ins.KV_PAGES_TOTAL.set(self.n_pages)
        ins.KV_PAGES_USED.set(self.n_pages - self.free_count)
        ins.KV_PAGES_SHARED.set(self.shared_count)

    def _audit(self) -> dict:
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
        radix_pages = 0
        if self.radix_refs is not None:
            # a node reference the tree forgot (leak) or counted twice shows
            # up as the same mismatch a corrupt table would
            tree_refs, tree_problems = self.radix_refs()
            problems.extend(tree_problems)
            for p, c in tree_refs.items():
                if 0 <= p < self.n_pages:
                    refs[p] += c
                    radix_pages += c
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
        if self.host is not None:
            problems.extend(self.host.audit_problems())
        report = dict(self.stats(), ok=not problems, problems=problems, radix_pages=radix_pages)
        if self.host is not None:
            report["host"] = self.host.stats()
        return report

    def reset(self) -> None:
        """Every page free and every block table empty (a warm restart):
        the object, its lock and its hooks stay, so the engine's device
        tables keep their address."""
        with self._mu:
            self.refcount[:] = 0
            self.tables[:] = 0
            self.n_blocks[:] = 0
            self._free = list(range(self.n_pages - 1, -1, -1))
            self._publish()

    # ------------------------------------------------------------ primitives

    def _alloc_page(self) -> int:
        faults.fire("pool.alloc")
        if not self._free:
            raise PageExhausted(f"page pool exhausted ({self.n_pages} pages of "
                                f"{self.page_size} rows, all referenced)")
        p = self._free.pop()
        self.refcount[p] = 1
        return p

    def _decref(self, p: int) -> None:
        if self.refcount[p] <= 0:
            # a double release would hand the page to two owners at once
            ins.KV_AUDIT_FAILURES.inc()
            raise PoolAuditError(f"double release of page {p} (refcount already "
                                 f"{int(self.refcount[p])})")
        self.refcount[p] -= 1
        if self.refcount[p] == 0:
            self._free.append(p)

    def grow(self, slot: int, rows: int, best_effort: bool = False) -> bool:
        """Extend `slot`'s table until its pages cover `rows` logical rows.
        All or nothing unless best_effort (then: allocate what the free list
        holds and stop). Returns True when the table changed."""
        with self._mu:
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
            if changed:
                self._publish()
            return changed

    def free_tail(self, slot: int, keep_rows: int) -> int:
        """Drop `slot`'s blocks past the one holding row keep_rows-1 (all of
        them for keep_rows == 0). Returns the pages that went back to the
        free list (a shared page only loses one reference). keep_rows past
        the covered range keeps everything: n_blocks never grows here."""
        with self._mu:
            keep = min(self.blocks_for(keep_rows), int(self.n_blocks[slot]))
            freed = 0
            for b in range(keep, int(self.n_blocks[slot])):
                before = self.free_count
                self._decref(int(self.tables[slot, b]))
                freed += self.free_count - before
                self.tables[slot, b] = 0
            self.n_blocks[slot] = keep
            self._publish()
            return freed

    def ensure_writable(self, slot: int, row: int, copy_fn) -> None:
        """Copy-on-write: make the page holding `row` exclusively `slot`'s
        before it is (partly) rewritten; the other referents (slots, the
        tree) keep the original bytes."""
        with self._mu:
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
            self._publish()

    def cow_writable(self, slot: int, start_row: int, end_row: int, copy_fn) -> bool:
        """Copy-on-write every SHARED block of `slot` covering rows
        [start_row, end_row) before a decode writes there. Returns True when
        a page was split (the block tables changed)."""
        with self._mu:
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
        with self._mu:
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
            self._publish()

    def adopt_prefix(self, slot: int, pages: list[int]) -> None:
        """Point `slot`'s first blocks at `pages` BY REFERENCE, the radix
        tree's mapping primitive: refcounts bump, no device copy (a shared
        partial boundary page among `pages` is copy-on-written later by
        prepare_admission, before its divergent rows are written). Drops
        whatever the slot held."""
        with self._mu:
            self.free_tail(slot, 0)
            for i, p in enumerate(pages):
                self.refcount[p] += 1
                self.tables[slot, i] = p
            self.n_blocks[slot] = len(pages)
            self._publish()

    def prepare_admission(self, slot: int, start: int, end: int, copy_fn) -> None:
        """Position `slot` for a prefill of rows [start, end): drop the dead
        tail past start, copy-on-write the boundary page when it is kept and
        shared, then allocate pages through `end`."""
        with self._mu:
            self.free_tail(slot, start)
            if start % self.page_size:
                self.ensure_writable(slot, start, copy_fn)
            self.grow(slot, end)

    def admission_deficit(self, slot: int, reuse: int, total_rows: int, cross: bool) -> int:
        """Pages the pool is SHORT for admitting a `total_rows` prompt into
        `slot` with `reuse` prefix rows resolved (`cross`: the prefix comes
        by share_prefix from another slot), one decode page in reserve. 0
        means the admission fits."""
        with self._mu:
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


class HostKVPool:
    """Host-RAM KV spill tier behind :class:`PagePool` (``--kv-host-pages``):
    a bounded LRU of page payloads keyed by the FULL token-id prefix the
    page's rows encode. When radix eviction drops the last reference to a
    cold page, the engine copies its KV rows device-to-host into this tier
    instead of discarding them; a later admission whose prompt walks past
    the tree's resident prefix copies matching pages back (restore-on-hit),
    so a returning multi-turn chat re-prefills only its partial boundary
    page. Keying by the token path, not the page id, keeps an entry
    meaningful whatever page it is restored into.

    The payloads live in ONE slab a tensor, K and V each
    [n_pages, L, H_kv, page, head] of the cache's dtype, made at
    construction (pinned on a CUDA engine: a copy into it is asynchronous,
    and a fresh pinned allocation a spill would cost milliseconds). An
    entry is a slab row and the event recorded after the copy into it:
    the copies run in stream order with the chunks, so the host never
    waits for them, and reads a row's bytes (``read``) only after its
    event. Shares the pool's reentrant lock: spills run under radix
    eviction, restores under admission lookup, and audit_problems() under
    PagePool.audit()."""

    def __init__(self, n_pages: int, page_size: int, mu, page_shape: tuple, dtype,
                 pin: bool = False):
        if n_pages < 1:
            raise ValueError(f"kv_host_pages={n_pages}: the host tier needs at least one "
                             "page slot")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._mu = mu
        self.k = torch.empty((self.n_pages, *page_shape), dtype=dtype, pin_memory=pin)
        self.v = torch.empty((self.n_pages, *page_shape), dtype=dtype, pin_memory=pin)
        # token-path key (len % page_size == 0; the last page_size ids are
        # the page's rows) -> (slab row, event after the copy into it)
        self._entries: OrderedDict[tuple, tuple[int, object]] = OrderedDict()
        self._free: list[int] = list(range(self.n_pages - 1, -1, -1))
        # cumulative accounting
        self.spilled = 0
        self.restored = 0
        self.dropped = 0  # LRU evictions of the host tier itself
        self.discarded = 0  # spills lost to a copy error (the page is dropped)
        self.spill_s = 0.0  # host seconds spent in put(), copies enqueued
        self._publish()

    def _publish(self) -> None:
        """The dllama_kv_host_pages_{total,used} gauges."""
        ins.KV_HOST_PAGES_TOTAL.set(self.n_pages)
        ins.KV_HOST_PAGES_USED.set(len(self._entries))

    @property
    def used(self) -> int:
        with self._mu:
            return len(self._entries)

    def put(self, key: tuple, write) -> bool:
        """Admit one spilled page: take a free slab row (the coldest entry
        makes room when the tier is full: losing ITS coldest page only
        restores the discard for that prefix) and call ``write(k_row,
        v_row)``, which queues the copies into it and returns the event
        recorded after them (None where copies are synchronous). A copy
        error gives the row back and counts a discard; returns False."""
        t0 = time.perf_counter()
        with self._mu:
            key = tuple(int(t) for t in key)
            old = self._entries.pop(key, None)
            if old is not None:
                self._free.append(old[0])
            if not self._free:
                _, (row, _) = self._entries.popitem(last=False)
                self._free.append(row)
                self.dropped += 1
            row = self._free.pop()
            try:
                event = write(self.k[row], self.v[row])
            except Exception:  # a copy error: the page is discarded, and counted
                log.exception("kv spill of a %d-token prefix failed; page discarded", len(key))
                self._free.append(row)
                self.discarded += 1
                return False
            self._entries[key] = (row, event)
            self.spilled += 1
            self.spill_s += time.perf_counter() - t0
            self._publish()
            return True

    def peek(self, key: tuple) -> int | None:
        """The slab row of `key` without removing it (restore copies first,
        then commits the take)."""
        with self._mu:
            entry = self._entries.get(tuple(int(t) for t in key))
            return None if entry is None else entry[0]

    def take(self, key: tuple) -> None:
        """Commit a restore: the page is device-resident (tree-owned) again,
        so the host copy retires and its row is free (a later spill's copy
        into the row runs after the restore's copy out of it, in stream
        order)."""
        with self._mu:
            entry = self._entries.pop(tuple(int(t) for t in key), None)
            if entry is not None:
                self._free.append(entry[0])
                self.restored += 1
                self._publish()

    def read(self, key: tuple) -> tuple[torch.Tensor, torch.Tensor] | None:
        """Host copies of `key`'s K and V rows, after its copy's event (for
        audits and tests: the serving path never reads the slab)."""
        with self._mu:
            entry = self._entries.get(tuple(int(t) for t in key))
        if entry is None:
            return None
        row, event = entry
        if event is not None:
            event.synchronize()
        return self.k[row].clone(), self.v[row].clone()

    def clear(self) -> int:
        with self._mu:
            n = len(self._entries)
            self._free.extend(row for row, _ in self._entries.values())
            self._entries.clear()
            self._publish()
            return n

    def reset(self) -> None:
        """Drop every entry and free every slab row (a warm restart: a
        half-poisoned chunk may have corrupted the very rows a spill kept).
        The pinned slab stays where it is; the counts start again at zero,
        as the JAX package's restart starts a new tier, so spilled = used +
        restored + dropped holds across restarts."""
        with self._mu:
            self._entries.clear()
            self._free = list(range(self.n_pages - 1, -1, -1))
            self.spilled = self.restored = self.dropped = self.discarded = 0
            self.spill_s = 0.0
            self._publish()

    def stats(self) -> dict:
        with self._mu:
            return {"total": self.n_pages, "used": len(self._entries),
                    "page_size": self.page_size, "spilled": self.spilled,
                    "restored": self.restored, "dropped": self.dropped,
                    "discarded": self.discarded, "spill_s": self.spill_s,
                    "slab_bytes": 2 * self.k.numel() * self.k.element_size()}

    def audit_problems(self) -> list[str]:
        """Invariant recount for PagePool.audit(): capacity respected, keys
        page-aligned, every slab row either free or held by exactly one
        entry (a row in neither is a leaked host page), the slab's geometry
        intact."""
        with self._mu:
            problems: list[str] = []
            if len(self._entries) > self.n_pages:
                problems.append(f"host tier holds {len(self._entries)} pages over its "
                                f"{self.n_pages}-page capacity")
            if any(not key or len(key) % self.page_size for key in self._entries):
                problems.append(f"host tier key not page-aligned (page_size "
                                f"{self.page_size})")
            rows = [row for row, _ in self._entries.values()]
            held, free = set(rows), set(self._free)
            if len(held) != len(rows) or len(free) != len(self._free) or held & free:
                problems.append("host tier slab row held twice (by two entries, or by an "
                                "entry and the free list)")
            leaked = set(range(self.n_pages)) - held - free
            if leaked:
                problems.append(f"leaked host pages (neither free nor held): "
                                f"{sorted(leaked)[:8]}")
            if any(not 0 <= r < self.n_pages for r in held | free):
                problems.append(f"host tier row outside the slab [0, {self.n_pages})")
            if self.k.shape[-2] != self.page_size or self.k.shape != self.v.shape:
                problems.append("host tier slab geometry corrupt (expected K and V of "
                                f"{self.page_size} rows a page)")
            return problems


def _set_row(dev: torch.Tensor, row: int, value: int) -> None:
    """dev[row] = value as a fill of a one-row slice: a kernel with the value
    as its argument, in stream order. (``dev[row] = value`` on a CUDA tensor
    copies a host scalar into the card, which waits for every launch queued
    before it.)"""
    row = int(row)
    dev[row : row + 1].fill_(int(value))


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
    hybrid_slot: int = -1  # the admitting slot a hybrid chunk prefilled, or -1
    hybrid_tokens: int = 0  # prompt tokens that chunk prefilled
    t0: float = 0.0  # dispatch (time.perf_counter; DECODE_CHUNK_SECONDS' clock)
    t_disp: float = 0.0  # dispatch on the tracer's clock (the decode.device span)
    # the chunk's exclusive window, stamped at consumption: from the later of
    # its dispatch and the previous chunk's consumption to its tokens on the
    # host (the roofline gauge's denominator)
    device_s: float = 0.0
    # a spec chunk of `n` verify cycles: `toks` is the per-cycle emit tensor
    # [n, B, K+1], `advance` a host lower bound at dispatch (1 an active
    # row) and `start_pos` the host mirror; decode_consume overwrites both
    # from the device's per-cycle counts (`adv_host` i32 [n, B]), drafts
    # verified (`drafted_host` i32 [n, B]) and start positions
    # (`start_host` i32 [B]), and keeps the counts in `adv_cycles`
    spec: bool = False
    adv_host: torch.Tensor | None = None
    drafted_host: torch.Tensor | None = None
    start_host: torch.Tensor | None = None
    adv_cycles: np.ndarray | None = None
    # the decode.nan fault's overlay (utils/faults.py): a host-side mask
    # OR-ed into the device's `bad` rows, set at dispatch
    bad_inject: np.ndarray | None = None

    def nonfinite(self) -> np.ndarray | None:
        """bool [B] rows whose logits went non-finite in this chunk, or None
        when every row is clean. The scheduler fails those requests."""
        out = self.bad.numpy()
        compile_obs.note_transfer("d2h", "nan_guard", int(out.nbytes))
        if self.bad_inject is not None:
            out = out | self.bad_inject
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
        capture: bool | None = None,  # chunks as CUDA graphs (None: on a CUDA device)
        radix_cache: str = "auto",  # 'auto' | 'on' | 'off': the radix prefix tree
        # over the page pool; auto = on whenever the layout is paged
        kv_host_pages: int = 0,  # host-RAM spill tier: page slots radix eviction
        # copies cold pages into, restored on a prefix hit; 0 = off, > 0 needs
        # the paged layout with the tree on (its token paths are the keys)
        spec: int = 0,  # K-token prompt-lookup speculative decoding for the
        # batch (decode_dispatch(spec=True)); 0 = off. Greedy slots emit 1..K+1
        # exact-argmax tokens a verify forward; sampled slots advance exactly 1
        transfer_guard: str = "off",  # 'off' | 'log' | 'strict' (--transfer-guard):
        # the steady-state replays run under torch.cuda.set_sync_debug_mode, so a
        # synchronizing operation there warns or raises (obs/compile.h2d_guard)
        moe_impl: str = "auto",  # 'auto' | 'dispatch' | 'sort' | 'dense' (ops.layers.moe_ffn):
        # every program body runs it; fixed per engine, so no program key names it
        shardings=None,  # parallel/sharding.LlamaShardings: one rank of a tp/dp/ep mesh
        # (dense layout only, as in the JAX package; see InferenceEngine). On dp
        # a replica holds its block of the slots (``block``): their cache, and
        # it runs and samples their rows; the tokens are all-gathered over dp.
        # On ep every rank holds every slot and the whole cache, runs the same
        # forward with its own experts (their partials summed over ep) and
        # samples the same bits
        sync: str = "bf16",  # the tp exchange: 'bf16' | 'q80' | 'auto'
    ):
        if cache_dtype not in CACHE_DTYPES:
            raise ValueError(f"KV cache dtype {cache_dtype} is not one of {CACHE_DTYPES}")
        if transfer_guard not in compile_obs.TRANSFER_GUARD_MODES:
            raise ValueError(f"transfer_guard must be one of "
                             f"{compile_obs.TRANSFER_GUARD_MODES}, got {transfer_guard!r}")
        self.transfer_guard = transfer_guard
        self.device = torch.device(device) if device is not None else params["embedding"].device
        self.shardings = shardings
        self.sync = resolve_sync(sync, shardings)
        if shardings is not None and (shardings.sp > 1 or shardings.mesh.shape["pp"] > 1):
            # per-slot vector positions don't fit the sp masks or the GPipe
            # schedule; continuous batching serves tp/dp meshes (the JAX
            # package's refusal)
            raise ValueError("BatchEngine supports tp/dp meshes (not sp/pp)")
        if int(spec) and shardings is not None and shardings.dp > 1:
            # history rows are slot-indexed on the host admission path; a dp
            # mesh shards the slot axis
            raise ValueError("spec batching supports unsharded/tp engines")
        self.exchange, capture = _mesh_setup(self, shardings, capture)
        if shardings is not None:
            if kv_layout == "paged":
                raise ValueError(
                    "paged KV cache requires an unsharded engine (the page pool has no "
                    "slot axis for a mesh to shard); use kv_layout='dense' on meshes")
            cfg, params = shardings.local_config(), shardings.put_params(params, self.device)
        self.cfg = cfg
        self.params = params  # fused wqkv/w13 when the caller's engine fused them
        self.n_slots = n_slots
        # the slots [lo, hi) whose cache and forward this rank holds: a dp
        # replica's block, or every slot (parallel/sharding.batch_block)
        self.block = (0, n_slots) if shardings is None else shardings.batch_block(n_slots)
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
            self.cache = KVCache.create(cfg, self.block[1] - self.block[0], cache_dtype,
                                        self.seq_len, self.device)
        if radix_cache not in ("auto", "on", "off"):
            raise ValueError(f"radix_cache must be auto|on|off, got {radix_cache!r}")
        if radix_cache == "on" and self.pool is None:
            raise ValueError("--radix-cache on requires the paged KV layout (the tree's "
                             "nodes own page-pool references)")
        self.radix: RadixCache | None = None
        if self.pool is not None and radix_cache != "off":
            self.radix = RadixCache(self.pool)
        self.kv_host_pages = int(kv_host_pages)
        if self.kv_host_pages > 0:
            if self.radix is None:
                raise ValueError("kv_host_pages > 0 requires the paged KV layout with the "
                                 "radix cache on (host-tier pages are keyed by the tree's "
                                 "token paths)")
            self.pool.host = HostKVPool(
                self.kv_host_pages, self.page_size, self.pool._mu,
                (cfg.n_layers, cfg.n_kv_heads, self.page_size, cfg.head_size), cache_dtype,
                pin=self.device.type == "cuda")
            self.radix.spill = self._host_spill
        self.moe_impl = resolve_moe_impl(moe_impl, shardings)
        sel = resolve_kernels(cfg, kernels, self.device, paged=self.pool is not None,
                              page_size=self.page_size, cache_dtype=cache_dtype)
        self.mm, self.attn_fn, self.norm = sel.mm, sel.attn_fn, sel.norm
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
        # per-request speculation: each slot's own draft length, set at commit
        # from the request's spec_k (clamped to K); 0 = the slot rides spec
        # cycles one token a cycle, as sampled slots always do
        self.spec_k_slot = np.zeros(n_slots, np.int32)
        self.seed = int(seed)
        self._admissions = 0
        self.chunk_seq = 0
        self.forwards = 0  # forward passes run (a decode step or a prefill chunk)

        # device-resident decode state: tensors made once and only ever
        # updated in place, since the decode programs read and write them
        # where they were when captured. pos, last token and the generator
        # are device-authoritative (the decode loop moves them); host
        # mutation sites write their slot's row in place. The other vectors
        # (and the paged block tables) are host-authoritative: copied in, in
        # stream order after any chunk in flight, when _vec_dirty is set,
        # i.e. at boundaries only.
        self._vec_dirty = True
        self._pos_dev = torch.zeros(n_slots, dtype=torch.int32, device=self.device)
        self._last_dev = torch.zeros(n_slots, dtype=torch.int64, device=self.device)
        self.rng = CounterRNG(n_slots, self.device)
        self._active_dev = torch.zeros(n_slots, dtype=torch.bool, device=self.device)
        self._limit_dev = torch.zeros(n_slots, dtype=torch.int32, device=self.device)
        self._temps_dev, self._topp_dev, self._pres_dev, self._freq_dev = torch.zeros(
            (4, n_slots), dtype=torch.float32, device=self.device)
        self._counts: torch.Tensor | None = None  # i32 [B, V], on the first penalized request
        self._rows = torch.arange(n_slots, device=self.device)
        # the prefill programs' device inputs: [slot, position] of the chunk,
        # and on the paged layout the slot's block-table row, gathered
        # inside the program from the device tables
        self._pf_in = torch.zeros(2, dtype=torch.int64, device=self.device)
        self._pf_table = (torch.zeros((1, self.cache.tables.shape[1]), dtype=torch.int32,
                                      device=self.device) if self.pool is not None else None)
        self.programs = Programs(self.device, capture)
        # batched speculation: K (the verify forward is K+1 rows wide), the
        # device history (made once: the programs write it where it was when
        # captured; unknown rows hold -1, which never matches a token), each
        # slot's draft length on the device, the cumulative acceptance
        # accounting (spec_stats; the dllama_spec_* series' mirror), where
        # its emitted tokens went (spec_rows) and the dispatched, unconsumed
        # spec chunks (while one is in flight the host pos mirror lags the
        # device's, so a dispatch tops up pages for both)
        self.spec_k = int(spec)
        self._spec_totals = {"cycles": 0, "drafted": 0, "accepted": 0, "emitted": 0}
        self._spec_rows = {"slot_cycles": 0, "discarded_tokens": 0, "discarded_cycles": 0}
        self._spec_inflight = 0
        self.history: torch.Tensor | None = None
        self._speck_dev = torch.zeros(n_slots, dtype=torch.int32, device=self.device)
        if self.spec_k:
            self.history = torch.full((n_slots, self.seq_len + 1), -1, dtype=torch.int64,
                                      device=self.device)
        # the capture ledger's shape contract (obs/compile): the engine
        # declares its prefill widths, the serving scheduler its decode
        # chunk (declare_serving_buckets); a capture outside it is counted,
        # logged and traced as unexpected
        self.contract = compile_obs.ShapeContract()
        for w in self._prefill_widths():
            self.contract.declare("prefill_chunk", f"m{w}")
        compile_obs.LEDGER.install_contract(self.contract)
        # DECODE_CHUNK_SECONDS' clock: the previous chunk's consumption
        self._t_last_consume: float | None = None

    # ------------------------------------------------------------- helpers

    def _pinned(self, arr: np.ndarray) -> torch.Tensor:
        """A fresh host copy of `arr`, pinned on a CUDA engine: a copy from
        it to the device does not block the host (a pageable copy would
        wait for every launch queued before it, which serializes the
        overlapped pipeline), and `arr` may be mutated at once."""
        t = torch.from_numpy(np.array(arr, copy=True))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _logits(self, tokens: torch.Tensor, pos, cache, active=None) -> torch.Tensor:
        """One forward; returns last-position logits f32 [B, V]. The caller
        counts it in ``forwards``."""
        logits, _ = forward(self.cfg, self.params, tokens, pos, cache, self.rope_cache,
                            self.attn_fn, self.mm, last_only=True, active=active,
                            moe_impl=self.moe_impl, exchange=self.exchange, norm=self.norm)
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

    @mirrored
    def drop_slot_pages(self, slot: int) -> int:
        """Evict an idle slot's cached pages (prefix-cache reclaim under pool
        pressure). Returns the pages that went back to the free list."""
        if self.active[slot]:
            raise ValueError(f"slot {slot} is busy")
        if self.pool is None:
            return 0
        freed = self.pool.free_tail(slot, 0)
        self.pos[slot] = 0
        _set_row(self._pos_dev, slot, 0)
        self._vec_dirty = True
        return freed

    def kv_page_stats(self) -> dict | None:
        """Pool occupancy for /health and latency_summary(); None on dense.
        Gains a "host" sub-dict with the spill tier on."""
        if self.pool is None:
            return None
        st = self.pool.stats()
        if self.pool.host is not None:
            st["host"] = self.pool.host.stats()
        return st

    # ------------------------------------------------------ radix prefix api
    # (engine/radix.RadixCache over the page pool; the serving scheduler is
    # their only caller, and they are no-ops or zeros with the tree off)

    def radix_lookup(self, toks) -> tuple[int, object | None]:
        """(reusable rows, hit handle) for `toks` against the tree; (0, None)
        with the tree off. With the host tier on, a walk that ends short of
        the prompt first grafts spilled pages back (restore-on-hit, copies
        host-to-device), then walks again."""
        if self.radix is None:
            return 0, None
        hit = self.radix.lookup(toks)
        host = self.pool.host
        if host is not None and host.used and hit.rows < len(toks) - 1:
            if self.radix.restore_prefix(toks, host.peek, self._host_restore_install,
                                         host.take):
                hit = self.radix.lookup(toks, count=False)
        return hit.rows, hit

    @mirrored
    def radix_map(self, slot: int, hit) -> None:
        """Map a lookup hit into `slot`: the matched full pages enter its
        block table BY REFERENCE, and a partial boundary page is mapped
        shared too; the following add_begin's prepare_admission
        copy-on-writes it before any divergent row is written. Positions
        the slot at the reused row count, as copy_prefix_rows does."""
        if self.active[slot]:
            raise ValueError(f"slot {slot} is busy")
        pages = list(hit.pages) + ([hit.boundary] if hit.part else [])
        self.pool.adopt_prefix(slot, pages)
        self.pos[slot] = hit.rows
        _set_row(self._pos_dev, slot, hit.rows)
        if self.spec_k and hit.rows:
            # the mapped prefix's token ids feed the n-gram proposer, as a
            # prefilled prompt's do
            toks = np.asarray(hit.tokens, np.int64)
            self.history[slot, : toks.shape[0]].copy_(self._pinned(toks), non_blocking=True)
            compile_obs.note_transfer("h2d", "history", int(toks.nbytes))
        self._vec_dirty = True

    @mirrored
    def radix_insert(self, slot: int, toks) -> int:
        """Insert the full-page prefix of `toks` (rows already written in
        `slot`: the prompt at commit, the emitted prefix at release) into
        the tree; adopted pages gain a tree reference that outlives the
        slot. Returns the pages adopted (0 with the tree off)."""
        if self.radix is None or not len(toks):
            return 0
        full = min(len(toks) // self.page_size, int(self.pool.n_blocks[slot]))
        if full <= 0:
            return 0
        return self.radix.insert(list(toks)[: full * self.page_size],
                                 self.pool.tables[slot, :full])

    @mirrored
    def radix_evict(self, need: int, protect=None) -> int:
        """Reclaim up to `need` pool pages from the tree (LRU leaves, coldest
        first); `protect` pins an admission's matched path. Returns the
        pages freed."""
        return 0 if self.radix is None else self.radix.evict(need, protect)

    def radix_admission_deficit(self, total_rows: int, reuse_rows: int) -> int:
        """Pages SHORT for a radix admission of `total_rows` rows with
        `reuse_rows` mapped from the tree (the slot is empty: the tree, not
        idle slots, holds the cache), the decode reserve page included; the
        boundary copy-on-write page costs what a fresh page would."""
        pool = self.pool
        with pool._mu:
            full = int(reuse_rows) // self.page_size
            return max(0, pool.blocks_for(total_rows) + 1 - full - pool.free_count)

    def radix_stats(self) -> dict | None:
        """Tree occupancy and cumulative hit accounting; None with the tree off."""
        return None if self.radix is None else self.radix.stats()

    # --------------------------------------------------- host KV spill tier

    def _event(self):
        """An event recorded on the engine's stream (None on the CPU, where
        copies are synchronous)."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    @torch.no_grad()
    def _host_spill(self, key: tuple, page: int) -> bool:
        """RadixCache.spill hook, called under the pool lock right before an
        evicted leaf's last-reference page is dropped: copy the page's KV
        rows (every layer) device-to-host into the host tier, keyed by the
        full token path. The copies are queued on the stream the programs
        replay on, behind any chunk in flight, and the host does not wait
        for them. A copy error discards the page (the tier counts it)."""

        def write(k_row, v_row):
            k_row.copy_(self.cache.k[:, page], non_blocking=True)
            v_row.copy_(self.cache.v[:, page], non_blocking=True)
            return self._event()

        try:
            # an armed pool.spill degrades the eviction to the discard: the
            # prefix re-prefills when it returns, which is always correct
            faults.fire("pool.spill")
        except faults.InjectedFault:
            return False
        if not self.pool.host.put(key, write):
            return False
        compile_obs.note_transfer("d2h", "kv_spill", self._page_nbytes())
        ins.KV_SPILL.labels(direction="out").inc()
        return True

    def _page_nbytes(self) -> int:
        """Bytes of one pool page's K and V rows over every layer."""
        k = self.cache.k
        return 2 * (k[:, 0].numel() * k.element_size())

    @torch.no_grad()
    def _host_restore_install(self, row: int) -> int | None:
        """restore_prefix's install callback: allocate a pool page and copy
        the host tier's slab row `row` into it (host-to-device, in stream
        order). Returns the page the tree grafts, or None when the pool has
        no free page (the suffix then prefills as before; the host copy
        stays until take())."""
        pool, host = self.pool, self.pool.host
        try:
            # an armed pool.restore leaves the host copy where it is and the
            # suffix re-prefills, as with no free page
            faults.fire("pool.restore")
            with pool._mu:
                if not pool._free:
                    return None
                page = pool._alloc_page()
        except faults.InjectedFault:
            return None
        self.cache.k[:, page].copy_(host.k[row], non_blocking=True)
        self.cache.v[:, page].copy_(host.v[row], non_blocking=True)
        compile_obs.note_transfer("h2d", "kv_restore", self._page_nbytes())
        ins.KV_SPILL.labels(direction="in").inc()
        return page

    def read_page(self, page: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Host copies of pool page `page`'s K and V rows [L, H_kv, page,
        head] (audits and tests; waits for the work queued before it)."""
        return (self.cache.k[:, page].to("cpu", copy=True),
                self.cache.v[:, page].to("cpu", copy=True))

    # ------------------------------------------------------------------- api

    @mirrored
    @torch.no_grad()
    def copy_prefix_rows(self, src_slot: int, dst_slot: int, rows: int) -> None:
        """Cross-slot prefix share: make dst_slot's first `rows` KV rows equal
        to src_slot's, so an admission into dst starts at rows. Dense: one
        on-device row copy. Paged: full pages are SHARED by refcount and only
        a partial boundary page is cloned; divergence later copies on write.
        Not on a dp mesh (supports_cross_slot_copy)."""
        if not self.supports_cross_slot_copy:
            raise ValueError("cross-slot copy crosses dp shards; not supported on "
                             "batch-sharded meshes")
        if self.active[dst_slot]:
            raise ValueError(f"dst slot {dst_slot} is busy")
        if self.pool is not None:
            self.pool.share_prefix(src_slot, dst_slot, rows, self._pool_page_copy)
        else:
            for buf in (self.cache.k, self.cache.v):
                buf[:, dst_slot, :, :rows] = buf[:, src_slot, :, :rows]
        if self.spec_k:
            # the shared prefix's token ids come along, so the n-gram proposer
            # drafts from it in the new slot too
            self.history[dst_slot, :rows] = self.history[src_slot, :rows]
        self.pos[dst_slot] = rows
        _set_row(self._pos_dev, dst_slot, rows)
        self._vec_dirty = True

    def free_slot(self) -> int | None:
        idle = np.flatnonzero(~self.active)
        return int(idle[0]) if idle.size else None

    @mirrored
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
        _set_row(self._pos_dev, slot, start_pos)
        self._vec_dirty = True
        return Admission(slot=slot, toks=np.asarray(prompt_tokens, np.int64), req_id=req_id)

    @mirrored
    @torch.no_grad()
    def add_step(self, adm: Admission) -> bool:
        """Prefill ONE power-of-two chunk of the admission's prompt at B=1;
        returns True when every prompt token's KV row is written. Observes
        dllama_prefill_chunk_seconds: the launch alone unless the caller
        syncs (the scheduler syncs whenever decoders would stall)."""
        faults.fire("engine.prefill")
        t0 = time.perf_counter()
        self._prefill_slice(adm, pow2_chunk(len(adm.toks) - adm.off, self.max_prefill_chunk))
        ins.PREFILL_CHUNK_SECONDS.observe(time.perf_counter() - t0)
        return adm.off >= len(adm.toks)

    def _prefill_layout(self, slot: int):
        """The prefill programs' layout key of `slot`: one set of programs
        serves every slot of the page pool (the slot's table row is gathered
        inside the program); on the dense layout each slot's cache rows are
        a view whose address a graph fixes, so each slot has its own."""
        return "paged" if self.pool is not None else ("dense", int(slot))

    def _make_prefill(self, width: int, layout):
        """(body, buffers, state) of the prefill program of `width` tokens on
        `layout` (_prefill_layout): one B=1 forward of ``buffers["toks"]``
        at the device position ``_pf_in[1]`` into the slot ``_pf_in[0]``
        (paged: its table row, gathered from the device tables; dense: the
        slot the layout names). The last position's logits go to
        ``buffers["logits"]`` [1, V]. With speculation on, the chunk's
        tokens also go to the slot's history at their positions (the n-gram
        proposer drafts from the prompt). It moves no other engine state:
        the slot's positions and activity are the host's to set
        (add_commit)."""
        toks = torch.zeros((1, width), dtype=torch.int64, device=self.device)
        out = torch.zeros((1, self.cfg.vocab_size), dtype=torch.float32, device=self.device)
        pos = self._pf_in[1:]
        if layout == "paged":
            table, slot = self._pf_table, self._pf_in[:1]
            sub = PagedKVCache(self.cache.k, self.cache.v, table)

            def forward_chunk():
                table.copy_(self.cache.tables.index_select(0, slot))
                out.copy_(self._logits(toks, pos, sub))
        else:
            s = layout[1] - self.block[0]  # the slot's row of this rank's cache
            sub = KVCache(self.cache.k[:, s : s + 1], self.cache.v[:, s : s + 1])

            def forward_chunk():
                out.copy_(self._logits(toks, pos, sub))

        if not self.spec_k:
            return forward_chunk, {"toks": toks, "logits": out}, ()
        hist = self.history.view(-1)
        offs = torch.arange(width, device=self.device)

        def body():
            forward_chunk()
            at = self._pf_in[0] * self.history.shape[1] + self._pf_in[1] + offs
            hist.index_copy_(0, at, toks[0])

        return body, {"toks": toks, "logits": out}, (self.history,)

    def _prefill_slice(self, adm: Admission, c: int) -> None:
        """Run the next `c` prompt tokens of `adm` through the prefill
        program of width `c`: load its tokens and [slot, position] (copies
        in stream order, from pinned memory), replay, and copy the logits
        out before another replay can overwrite them. adm.off, adm.logits
        and the slot's host pos advance."""
        slot, off = adm.slot, adm.off
        # add_begin may have changed the slot's block table: the device copy
        # is refreshed, in stream order, before the program gathers its row
        self._sync_vectors()
        lo, hi = self.block
        if lo <= slot < hi:
            prog = self.programs.prefill(c, self._prefill_layout(slot), self._make_prefill)
            prog.buffers["toks"].copy_(self._pinned(adm.toks[None, off : off + c]),
                                       non_blocking=True)
            self._pf_in.copy_(self._pinned(np.array([slot, self.pos[slot]], np.int64)),
                              non_blocking=True)
            compile_obs.note_transfer("h2d", "prefill", 8 * (c + 2))
            prog.run()
            self.forwards += 1
            adm.logits = prog.buffers["logits"].clone()
        else:  # another replica's slot: its logits arrive below
            adm.logits = torch.empty((1, self.cfg.vocab_size), dtype=torch.float32,
                                     device=self.device)
        if hi - lo < self.n_slots:
            # the replica that holds the slot ran its B=1 prefill; every rank
            # takes its logits, so each samples the same first token
            self.exchange.dp.broadcast(adm.logits, slot // (hi - lo))
        ins.PREFILL_TOKENS.inc(c)
        self.pos[slot] += c
        adm.off += c

    def _request_seed(self, seed: int | None) -> int:
        """The request's seed, or one derived from the engine seed and the
        admission count for requests without one."""
        if seed is not None:
            return int(seed)
        return (self.seed * 0x9E3779B97F4A7C15 + self._admissions + 1) & ((1 << 63) - 1)

    @mirrored
    @torch.no_grad()
    def add_commit(self, adm: Admission, temperature: float = 0.8, topp: float = 0.9,
                   seed: int | None = None, presence: float = 0.0,
                   frequency: float = 0.0, spec_k: int | None = None) -> int:
        """Sample the first token from the finished admission (counter 0 of
        the slot's generator) and activate the slot. Must follow add_step
        returning True. `spec_k` is the slot's draft length under batched
        speculation, clamped to K (None: K; 0 opts the slot out)."""
        if adm.off < len(adm.toks) or adm.logits is None:
            raise ValueError("admission not pumped")
        slot = adm.slot
        seed = self._request_seed(seed)
        self._admissions += 1
        self.seeds[slot] = seed
        self.rng.reset(slot, seed)
        u = self.rng.uniforms(1, rows=[slot])[0]
        first = int(sample_logits(adm.logits, float(temperature), float(topp), uniforms=u)[0])
        compile_obs.note_transfer("d2h", "commit", 8)
        self.rng.advance_row(slot, 1)
        self.active[slot] = True
        self.last_token[slot] = first
        self.temperature[slot] = temperature
        self.topp[slot] = topp
        self.presence[slot] = presence
        self.frequency[slot] = frequency
        self._vec_dirty = True
        _set_row(self._last_dev, slot, first)
        _set_row(self._pos_dev, slot, self.pos[slot])
        self._commit_spec(slot, first, spec_k)
        if presence or frequency:
            self._ensure_counts()
            # a fresh request has sampled nothing yet (OpenAI counts exclude
            # the prompt); slots without penalties never read their row
            self._counts[slot] = 0
        return first

    def _commit_spec(self, slot: int, token: int, spec_k: int | None) -> None:
        """The slot's draft length (clamped to K), and with speculation on
        its unfed token at its position in the history (a fill, in stream
        order)."""
        self.spec_k_slot[slot] = (min(int(spec_k), self.spec_k) if spec_k is not None
                                  else self.spec_k)
        if self.spec_k:
            _set_row(self.history[slot], self.pos[slot], token)

    @mirrored
    @torch.no_grad()
    def resume_commit(self, adm: Admission, last_token: int, seed: int, counter: int,
                      temperature: float = 0.8, topp: float = 0.9, presence: float = 0.0,
                      frequency: float = 0.0, counted=None, spec_k: int | None = None) -> None:
        """Re-activate a slot for a resumed (preempted) request. The
        admission re-prefilled the rows the request had written, prompt and
        every emitted token but the last (a sampled token's row exists only
        once it is fed back); this commit installs that last token as the
        one to feed and the request's generator at (`seed`, `counter`) as
        it stood at the interruption, WITHOUT sampling: the resumed stream's
        next token is the one the uninterrupted run would have drawn.
        `counted` (penalized requests) lists the tokens fed so far, whose
        occurrence counts are rebuilt; `spec_k` is add_commit's. Every device
        write is a one-row in-place update, in stream order."""
        if adm.off < len(adm.toks):
            raise ValueError("admission not pumped")
        slot = adm.slot
        self.seeds[slot] = int(seed)
        self.rng.reset(slot, int(seed), int(counter))
        self.active[slot] = True
        self.last_token[slot] = int(last_token)
        self.temperature[slot] = temperature
        self.topp[slot] = topp
        self.presence[slot] = presence
        self.frequency[slot] = frequency
        self._vec_dirty = True
        _set_row(self._last_dev, slot, int(last_token))
        _set_row(self._pos_dev, slot, self.pos[slot])
        self._commit_spec(slot, int(last_token), spec_k)
        if presence or frequency:
            self._ensure_counts()
            row = np.zeros((1, self.cfg.vocab_size), np.int32)
            if counted:
                np.add.at(row[0], np.asarray(counted, np.int64), 1)
            self._counts[slot : slot + 1].copy_(self._pinned(row), non_blocking=True)

    @mirrored
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
        """Copy the host-authoritative per-slot vectors (and the paged block
        tables) into their device tensors, in place, from fresh pinned
        copies: the copies run in stream order, after any chunk already in
        flight has read the old values. A no-op in steady-state decode."""
        if not self._vec_dirty:
            return
        nbytes = 0
        pairs = [(self._active_dev, self.active), (self._temps_dev, self.temperature),
                 (self._topp_dev, self.topp), (self._pres_dev, self.presence),
                 (self._freq_dev, self.frequency), (self._limit_dev, self._row_limit())]
        if self.spec_k:
            pairs.append((self._speck_dev, self.spec_k_slot))
        for dev, host in pairs:
            dev.copy_(self._pinned(host), non_blocking=True)
            nbytes += host.nbytes
        if self.pool is not None:
            self.cache.tables.copy_(self._pinned(self.pool.tables), non_blocking=True)
            nbytes += self.pool.tables.nbytes
        self._vec_dirty = False
        compile_obs.note_transfer("h2d", "vectors", nbytes)

    def _ensure_counts(self) -> None:
        if self._counts is None:
            self._counts = torch.zeros((self.n_slots, self.cfg.vocab_size),
                                       dtype=torch.int32, device=self.device)

    def _make_program(self, variant: str, n: int):
        """(body, buffers, state) of the n-step decode program `variant`
        (engine/graphs.py) over the engine's device state: the tokens of
        each step go to ``buffers["toks"]`` [n, B], the rows whose logits
        went non-finite to ``buffers["bad"]`` [B]."""
        toks = torch.zeros((n, self.n_slots), dtype=torch.int64, device=self.device)
        bad = torch.zeros(self.n_slots, dtype=torch.bool, device=self.device)
        penalized = variant == "penalized"
        offs = torch.arange(1, n + 1, device=self.device)
        # a dp replica runs and samples its block's rows; the tokens and the
        # NaN-guard flags of every row are all-gathered over dp, so each rank
        # moves the whole batch's state alike (rows [lo, hi) are every row
        # off dp)
        lo, hi = self.block
        dp = self.exchange.dp if hi - lo < self.n_slots else None
        bad_l = bad[lo:hi] if dp is None else torch.zeros(hi - lo, dtype=torch.bool,
                                                          device=self.device)

        def body():
            act0, lim = self._active_dev, self._limit_dev
            lim_last = (lim - 1).clamp(min=0)
            p0 = p = self._pos_dev
            tok = self._last_dev
            bad_l.zero_()
            u = self.rng.uniforms(n) if variant != "greedy" else None
            for i in range(n):
                # per-row freeze: frozen rows behave like inactive ones (writes
                # masked, token repeats, generator held); pos is clamped only
                # for their rope/cache indexing
                act = act0 & (p < lim)
                if dp is not None:
                    self.exchange.open_forward()  # the gather counts with the step
                logits = self._logits(tok[lo:hi, None], torch.minimum(p, lim_last)[lo:hi],
                                      self.cache, active=act[lo:hi])
                bad_l.logical_or_(act[lo:hi] & ~torch.isfinite(logits).all(dim=-1))
                if penalized:
                    # the fed token counts before its successor is sampled
                    self._counts.index_put_((self._rows, tok), act.to(torch.int32),
                                            accumulate=True)
                    logits = apply_penalties(logits, self._counts[lo:hi],
                                             self._pres_dev[lo:hi], self._freq_dev[lo:hi])
                if u is None:
                    nxt = torch.argmax(logits, dim=-1)
                else:
                    nxt = _sample_rows(logits, u[i][lo:hi], self._temps_dev[lo:hi],
                                       self._topp_dev[lo:hi])
                if dp is not None:
                    nxt = dp.all_gather(nxt).reshape(-1)
                    self.exchange.close_forward(self.n_slots, 1)
                tok = torch.where(act, nxt, tok)
                toks[i].copy_(tok)
                p = p + act.to(p.dtype)
            if self.spec_k:
                # the chunk's tokens backfill the history at pos+1..pos+n, so
                # later spec cycles draft from them; a row whose whole chunk
                # would pass the history's end (a slot frozen at seq_len,
                # where spec cycles freeze it anyway) is skipped
                fits = act0 & (p0 + 1 + n <= self.seq_len + 1)
                masked_put(self.history, p0.to(torch.int64)[:, None] + offs, toks.T,
                           fits[:, None])
            self.rng.advance((p - p0).to(torch.int64))  # one draw per active step
            self._pos_dev.copy_(p)
            self._last_dev.copy_(tok)
            if dp is not None:
                bad.copy_(dp.all_gather(bad_l.to(torch.uint8)).reshape(-1) != 0)

        state = (self._pos_dev, self._last_dev, self.rng.counter)
        if self.spec_k:
            state += (self.history,)
        return body, {"toks": toks, "bad": bad}, state + ((self._counts,) if penalized else ())

    def _make_spec_program(self, variant: str, n: int):
        """(body, buffers, state) of the spec program of n verify cycles,
        variant ``spec`` or ``spec_pen`` (the JAX package's
        ``_spec_cycle_core`` under ``_spec_step_impl`` /
        ``_spec_step_pen_impl``). Each cycle, on the device: a slot takes part
        (``eff``) when it is active with a (K+1)-row window below its row
        limit; the frozen rest write nothing and hold their position, token
        and generator. Greedy rows (not penalized, in ``spec_pen``) accept up
        to min(their draft length, K) drafts; every other row takes one
        token a cycle from its offset-0 logits (``spec_pen``: penalized,
        its fed token counted first). The generator keeps counter = tokens
        emitted: a sampled row draws at its counter and advances it by 1, a
        greedy row advances it by its a + 1 tokens and draws nothing. The
        emitted tokens, and so each slot's next history rows, are written
        for the taking-part rows. Outputs: ``toks`` [n, B, K+1] (each
        cycle's emit rows), ``adv`` and ``drafted`` i32 [n, B] (tokens each
        slot emitted, drafts it verified), ``start`` i32 [B] (the positions
        the chunk started from) and ``bad`` [B] (non-finite logits of a
        taking-part row, sticky over the chunk)."""
        k, b = self.spec_k, self.n_slots
        dev = self.device
        emits = torch.zeros((n, b, k + 1), dtype=torch.int64, device=dev)
        advs = torch.zeros((n, b), dtype=torch.int32, device=dev)
        drafts = torch.zeros((n, b), dtype=torch.int32, device=dev)
        start = torch.zeros(b, dtype=torch.int32, device=dev)
        bad = torch.zeros(b, dtype=torch.bool, device=dev)
        penalized = variant == "spec_pen"
        offs = torch.arange(1, k + 2, device=dev)

        def body():
            act0, lim = self._active_dev, self._limit_dev.to(torch.int64)
            speck, temps = self._speck_dev.to(torch.int64), self._temps_dev
            accept_mask = temps == 0.0
            if penalized:
                # a penalized greedy row samples its penalized argmax instead
                accept_mask = accept_mask & (self._pres_dev == 0.0) & (self._freq_dev == 0.0)
            pos, cur = self._pos_dev, self._last_dev
            start.copy_(pos)
            bad.zero_()
            for c in range(n):
                p = pos.to(torch.int64)
                eff = act0 & (p + k + 1 <= lim)
                accept = accept_mask & eff
                k_eff = torch.where(accept, torch.minimum(speck, lim - p - 1).clamp(0, k), 0)
                draft, _ = propose_ngram(self.history, p + 1, k, SPEC_NGRAM)  # [B, K]
                toks = torch.cat([cur[:, None], draft], dim=1)  # [B, K+1]
                # frozen rows still flow through the forward (writes masked):
                # clamp their rope and cache rows so the window stays in range
                p_cl = torch.minimum(p, (lim - (k + 1)).clamp(min=0)).to(torch.int32)
                logits, _ = forward(self.cfg, self.params, toks, p_cl, self.cache,
                                    self.rope_cache, self.attn_fn, self.mm, last_only=False,
                                    active=eff, moe_impl=self.moe_impl,
                                    exchange=self.exchange, norm=self.norm)  # [B, K+1, V]
                g = torch.argmax(logits, dim=-1)
                agree = torch.cumprod((draft == g[:, :k]).to(torch.int64), dim=1)
                a = torch.minimum(agree.sum(dim=1), k_eff)
                bad.logical_or_(eff & ~torch.isfinite(logits).all(dim=-1).all(dim=-1))
                first = logits[:, 0]
                if penalized:
                    # the fed token counts before its successor is sampled
                    self._counts.index_put_((self._rows, cur), eff.to(torch.int32),
                                            accumulate=True)
                    first = apply_penalties(first, self._counts, self._pres_dev,
                                            self._freq_dev)
                samp = _sample_rows(first, self.rng.uniforms(1)[0], temps, self._topp_dev)
                emit = torch.where(accept[:, None], g, torch.cat([samp[:, None], g[:, 1:]], 1))
                # the emitted tokens are also the history at pos+1..pos+K+1
                # (entries past the new position are never read before they
                # are written again)
                masked_put(self.history, p[:, None] + offs, emit, eff[:, None])
                adv = torch.where(eff, a + 1, 0)
                cur = torch.where(eff, emit.gather(1, a[:, None])[:, 0], cur)
                self.rng.advance(adv)
                emits[c].copy_(emit)
                advs[c].copy_(adv)
                drafts[c].copy_(k_eff)
                pos = pos + adv.to(pos.dtype)
            self._pos_dev.copy_(pos)
            self._last_dev.copy_(cur)

        state = (self._pos_dev, self._last_dev, self.rng.counter, self.history)
        buffers = {"toks": emits, "adv": advs, "drafted": drafts, "start": start, "bad": bad}
        return body, buffers, state + ((self._counts,) if penalized else ())

    def _program(self, variant: str, n: int):
        if variant in ("penalized", "spec_pen"):
            self._ensure_counts()
        make = self._make_spec_program if variant in SPEC_VARIANTS else self._make_program
        return self.programs.get(variant, n, make)

    @mirrored
    @torch.no_grad()
    def decode_dispatch(self, n: int, spec: bool = False) -> DecodeChunk:
        """Launch one n-step decode chunk across the active slots WITHOUT
        waiting for it. Tokens feed back on the device; the freeze, the
        generator's advance and the NaN guard are computed there; the chunk's
        tokens and flags go to host memory by a non-blocking copy with an
        event behind it. Nothing here reads a device value.

        A slot that reaches its row limit mid-chunk (seq_len, or the end of
        its allocated pages) freezes per row while its batch-mates keep the
        whole chunk; `DecodeChunk.advance` holds each slot's real count.
        Raises only when no active slot has any room.

        ``spec=True`` replays the spec program of n verify cycles instead
        (_spec_dispatch): its counts are data-dependent and settle at
        decode_consume, so a chunk dispatched off an unconsumed spec chunk
        must itself be spec (the serving scheduler drains on a switch)."""
        faults.fire("engine.decode")
        if spec:
            if not self.spec_k:
                raise ValueError("engine built with spec=0")
            if not self.active.any():
                raise ValueError("no active slots")
            return self._spec_dispatch(max(1, int(n)))
        n, limit = self._decode_rows(n)
        self._sync_vectors()
        return self._decode_launch(n, limit)

    def _decode_rows(self, n: int) -> tuple[int, np.ndarray]:
        """(n clipped to the roomiest active slot's room, the row limits)
        after the paged top-up; raises when no active slot has any room."""
        if not self.active.any():
            raise ValueError("no active slots")
        self._alloc_decode_rows(n)
        limit = self._row_limit()
        room = limit[self.active] - self.pos[self.active]
        n = min(n, int(room.max()))
        if n <= 0:
            raise ValueError("every active slot is at its row limit (seq_len, or an "
                             "exhausted page pool); release first")
        return n, limit

    def _decode_launch(self, n: int, limit: np.ndarray) -> DecodeChunk:
        """Replay the n-step decode program of the active slots' variant and
        queue the copy of its outputs to the host (decode_dispatch's body,
        after the vectors are synced)."""
        variant = ("penalized" if self._penalized_live() else "sampled"
                   if (self.temperature[self.active] != 0.0).any() else "greedy")
        prog = self._program(variant, n)
        t0, t_disp = time.perf_counter(), trace.TRACER.now()
        with compile_obs.h2d_guard(self.transfer_guard, self.device):
            prog.run()
            (toks, bad), event = self._outputs_to_host(prog.buffers["toks"],
                                                       prog.buffers["bad"])
        self.forwards += n
        start_pos = self.pos.copy()
        active = self.active.copy()
        advance = np.where(active, np.clip(limit - start_pos, 0, n), 0).astype(np.int32)
        # the host pos mirror advances arithmetically, exactly as the loop did
        self.pos += advance
        self.chunk_seq += 1
        return DecodeChunk(toks=toks, bad=bad, event=event, n=n, start_pos=start_pos,
                           active=active, advance=advance, seq=self.chunk_seq, t0=t0,
                           t_disp=t_disp, bad_inject=self._nan_drill(active))

    def _nan_drill(self, active: np.ndarray) -> np.ndarray | None:
        """The decode.nan fault at dispatch: a host mask flagging the lowest
        active slot as if its logits went non-finite (the scheduler's NaN
        guard then fails that request), or None when it does not fire."""
        if not faults.flag("decode.nan") or not active.any():
            return None
        out = np.zeros(self.n_slots, bool)
        out[int(np.flatnonzero(active)[0])] = True
        return out

    def _outputs_to_host(self, *bufs: torch.Tensor) -> tuple[list[torch.Tensor], object]:
        """Host copies of a program's outputs and the event behind them: on a
        CUDA engine non-blocking copies into fresh pinned tensors, enqueued
        before the next replay can rewrite the outputs; on the CPU clones
        (event None)."""
        if self.device.type != "cuda":
            return [b.clone() for b in bufs], None
        host = [torch.empty(b.shape, dtype=b.dtype, pin_memory=True) for b in bufs]
        for h, b in zip(host, bufs):
            h.copy_(b, non_blocking=True)  # dllama: allow[transfer-note] noted where the host reads it: decode_tokens, spec_counts, nan_guard
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return host, event

    def _penalized_live(self) -> bool:
        """Whether an active slot has repetition penalties (its chunks take
        the program that carries the occurrence counts)."""
        live = self.active
        return self._counts is not None and bool(
            ((self.presence[live] != 0.0) | (self.frequency[live] != 0.0)).any())

    def _spec_dispatch(self, n: int) -> DecodeChunk:
        """decode_dispatch(n, spec=True)'s body (the JAX package's
        _spec_dispatch): top up pages and split shared ones for n cycles of
        K+1 rows (twice that while another spec chunk is unconsumed: the
        host pos mirror then lags the device's by its rows; a row the pool
        cannot back freezes on the device), replay the spec program, and
        queue its outputs' copy to the host. The host pos mirror does not
        move here: `advance` is the lower bound of 1 an active row, and both
        it and `start_pos` are overwritten in decode_consume."""
        k = self.spec_k
        lag = 2 if self._spec_inflight else 1
        self._alloc_decode_rows(lag * n * (k + 1))
        if not self.spec_eligible().any():
            raise ValueError("no active slot is spec-eligible (needs room for K+1 rows); use "
                             "decode() or release the full slots")
        self._sync_vectors()
        prog = self._program("spec_pen" if self._penalized_live() else "spec", n)
        t0, t_disp = time.perf_counter(), trace.TRACER.now()
        b = prog.buffers
        with compile_obs.h2d_guard(self.transfer_guard, self.device):
            prog.run()
            (toks, bad, adv, drafted, start), event = self._outputs_to_host(
                b["toks"], b["bad"], b["adv"], b["drafted"], b["start"])
        self.forwards += n
        self._spec_inflight += 1
        active = self.active.copy()
        self.chunk_seq += 1
        return DecodeChunk(toks=toks, bad=bad, event=event, n=n, start_pos=self.pos.copy(),
                           active=active, advance=active.astype(np.int32), seq=self.chunk_seq,
                           t0=t0, t_disp=t_disp, spec=True, adv_host=adv,
                           drafted_host=drafted, start_host=start,
                           bad_inject=self._nan_drill(active))

    @property
    def supports_hybrid(self) -> bool:
        """Whether hybrid_dispatch can run: not on a dp mesh, whose replicas
        hold blocks of the slots (the JAX package's gate, _use_slot_prefill);
        the scheduler then admits phase-split."""
        return self.shardings is None or self.shardings.dp == 1

    @property
    def supports_cross_slot_copy(self) -> bool:
        """False on dp meshes: the batch axis is sharded, so a slot-to-slot
        row copy would gather across shards (the JAX package's gate)."""
        return self.shardings is None or self.shardings.dp == 1

    @mirrored
    @torch.no_grad()
    def hybrid_dispatch(self, n: int, adm: Admission, budget: int) -> DecodeChunk:
        """Dispatch ONE hybrid step (the JAX package's fused
        ``hybrid_dispatch``): up to `budget` prompt tokens of the in-flight
        admission `adm`, then the n-step decode program of the active slots,
        replayed back to back on one stream with no host read between them.
        The prompt tokens run as the JAX package's slice,
        ``pow2_chunk(min(budget, remaining), max_prefill_chunk)`` tokens
        through the prefill program of that width, followed, while budget
        and prompt are left, by further power-of-two slices of the same
        prompt (JAX leaves that budget unused: an 85-token prompt at budget
        64 is admitted in 2 chunks, 64 | 16 + 4 + 1, not 4). ``adm.off``,
        ``adm.logits`` and the slot's host pos advance exactly as add_steps
        of the same sizes would, so add_commit works unchanged once the
        admission is fully pumped. The admitting slot is inactive in the
        decode mask and every attention read is per slot, so the decode
        rows' tokens are those of a plain decode_dispatch. Returns the
        DecodeChunk, with hybrid_slot / hybrid_tokens recording the prompt
        tokens it prefilled."""
        # both drills fire before any state moves: an engine.prefill fault
        # leaves the engine clean, so the scheduler fails only the joiner
        faults.fire("engine.decode")
        faults.fire("engine.prefill")
        if not self.supports_hybrid:
            raise ValueError("hybrid step needs an unsharded batch axis "
                             "(dp meshes keep phase-split admission)")
        slot = adm.slot
        if self.active[slot]:
            raise ValueError(f"slot {slot} is busy")
        if not self.active.any():
            raise ValueError("no active slots to fuse with; pump the admission with "
                             "add_step instead")
        if adm.off >= len(adm.toks):
            raise ValueError("admission already fully pumped")
        n, limit = self._decode_rows(n)
        left, start = max(1, int(budget)), adm.off
        while left > 0 and adm.off < len(adm.toks):
            c = pow2_chunk(min(left, len(adm.toks) - adm.off), self.max_prefill_chunk)
            self._prefill_slice(adm, c)  # syncs the vectors and the tables first
            left -= c
        chunk = self._decode_launch(n, limit)
        chunk.hybrid_slot, chunk.hybrid_tokens = slot, adm.off - start
        return chunk

    @mirrored
    def declare_serving_buckets(self, chunk: int) -> None:
        """Declare the serving scheduler's decode programs into this
        engine's contract (idempotent): every variant at n in 1..chunk,
        the counts a chunk can carry once the row limit clamps n. A hybrid
        chunk is a prefill program and a decode program, both declared.
        With speculation on, the spec programs at n in {1, chunk}: the
        scheduler's spec launches (the row limit never clamps their n)."""
        for fn in ("decode", "decode_pen"):
            for n in range(1, max(1, int(chunk)) + 1):
                self.contract.declare(fn, f"n{n}")
        for fn in SPEC_VARIANTS if self.spec_k else ():
            for n in self._spec_counts(chunk):
                self.contract.declare(fn, f"n{n}")

    @staticmethod
    def _spec_counts(chunk: int) -> list[int]:
        """The cycle counts of the scheduler's spec launches: 1 (the tail
        clamp) and the chunk."""
        return sorted({1, max(1, int(chunk))})

    def chunk_cost_model(self):
        """Frozen obs/perf.ChunkCostModel pricing this engine's decode steps
        (the scheduler's roofline-attainment feed): the JAX package's byte
        formula with ``weight_bytes`` = the resident parameter bytes. The
        paged route prices the kernel's per-page reads (the K9 route) or
        the plain gather's full view."""
        from dllama_tpu_torch.obs.perf import ChunkCostModel
        from dllama_tpu_torch.utils.profiling import params_nbytes

        cfg = self.cfg
        return ChunkCostModel(
            n_layers=cfg.n_layers, dim=cfg.dim, hidden_dim=cfg.hidden_dim,
            kv_dim=cfg.kv_dim, head_size=cfg.head_size, n_kv_heads=cfg.n_kv_heads,
            vocab_size=cfg.vocab_size, seq_len=self.seq_len,
            weight_bytes=int(params_nbytes(self.params)),
            cache_bytes_per_el=int(self.cache.k.element_size()),
            paged=self.kv_layout == "paged", page_size=self.page_size,
            paged_impl="gather" if self.attn_route == "paged_gather" else "kernel")

    def _prefill_widths(self) -> list[int]:
        """Every token width add_step and hybrid_dispatch can run: the powers
        of two up to min(max_prefill_chunk, seq_len)."""
        widths, w = [], 1
        while w <= min(self.max_prefill_chunk, self.seq_len):
            widths.append(w)
            w *= 2
        return widths

    @mirrored
    @torch.no_grad()
    def warmup(self, chunk: int = 4, hybrid_budget_hi: int = 0) -> dict:
        """``--warmup auto`` boot pass (the JAX package's BatchEngine.warmup):
        capture every program the serving scheduler can ask for, so the
        first request finds its graphs captured and the kernel libraries
        loaded: the decode programs, n in 1..chunk times VARIANTS, with
        speculation on the spec programs at n in {1, chunk} times
        SPEC_VARIANTS, and the prefill program of each power-of-two width
        (per slot on the dense layout). A hybrid slice of at most ``hybrid_budget_hi`` tokens runs
        one of those widths, so the pass covers hybrid chunks too. Every
        operand is inert: with every slot inactive a decode program freezes
        each row (cache writes masked, positions, tokens and generator
        counters held), and a prefill program is captured without a replay,
        its warm-up writing into the trash page (paged: slot 0's device
        table row points there meanwhile) or into rows put back afterwards
        (dense). Must run before any slot is active. Returns the report,
        under the JAX report's keys where the port has the field, with the
        count of graphs captured."""
        if self.active.any():
            raise RuntimeError("warmup must run before any slot is active")
        t0 = time.perf_counter()
        self._ensure_counts()  # the penalized programs capture the counts
        self._sync_vectors()
        graphs0 = self.programs.stats()["graphs"]
        self.declare_serving_buckets(chunk)
        with compile_obs.LEDGER.warmup_phase():
            per_fn, cached, widths, layouts = self._warm_programs(chunk)
        report = {
            "mode": "auto",
            "buckets": sum(per_fn.values()),
            "graphs_captured": self.programs.stats()["graphs"] - graphs0,
            "cached": cached,
            "per_fn": per_fn,
            "hybrid_budget_hi": int(hybrid_budget_hi),
            "seconds": round(time.perf_counter() - t0, 3),
            "full_coverage": all(self.programs.ready(v, n) for n in range(1, chunk + 1)
                                 for v in VARIANTS)
                             and all(self.programs.ready(v, n) for n in self._spec_counts(chunk)
                                     for v in (SPEC_VARIANTS if self.spec_k else ()))
                             and all(self.programs.prefill_ready(w, lay) for w in widths
                                     for lay in layouts),
        }
        compile_obs.LEDGER.warmup_report = report
        log.info("warmup: %d decode programs and %d prefill programs (%d graphs captured, "
                 "%d cached) in %.2fs; %s",
                 report["buckets"] - per_fn["prefill_chunk"], per_fn["prefill_chunk"],
                 report["graphs_captured"], cached, report["seconds"],
                 "full coverage" if report["full_coverage"] else "coverage INCOMPLETE")
        return report

    def _warm_programs(self, chunk: int):
        """warmup()'s captures -> (per_fn, cached, widths, layouts): the
        decode programs, then the prefill program of every width on every
        prefill layout, with inert operands."""
        per_fn: dict[str, int] = {}
        cached = 0
        fn_names = {"greedy": "decode", "sampled": "decode_sampled", "penalized": "decode_pen",
                    "spec": "spec", "spec_pen": "spec_pen"}
        work = [(v, n) for n in range(1, chunk + 1) for v in VARIANTS]
        if self.spec_k:
            work += [(v, n) for n in self._spec_counts(chunk) for v in SPEC_VARIANTS]
        for variant, n in work:
            cached += self.programs.ready(variant, n)  # captured before this pass
            self._program(variant, n).run()
            per_fn[fn_names[variant]] = per_fn.get(fn_names[variant], 0) + 1
        widths = self._prefill_widths()
        layouts = ([self._prefill_layout(0)] if self.pool is not None
                   else [self._prefill_layout(s) for s in range(*self.block)])
        saved = None
        if self.programs.capture:  # a capture's warm-up writes KV rows
            self._pf_in.zero_()  # slot 0, position 0
            if self.pool is not None:
                self.cache.tables[0].fill_(self.pool.n_pages)  # the trash page
            else:
                saved = [buf[:, :, :, : widths[-1]].clone()
                         for buf in (self.cache.k, self.cache.v)]
        for layout in layouts:
            for width in widths:
                cached += self.programs.prefill_ready(width, layout)
                self.programs.prefill(width, layout, self._make_prefill).prepare()
                per_fn["prefill_chunk"] = per_fn.get("prefill_chunk", 0) + 1
        if saved is not None:
            for buf, old in zip((self.cache.k, self.cache.v), saved):
                buf[:, :, :, : widths[-1]] = old
        self._vec_dirty = True  # slot 0's table row goes back
        self._sync_vectors()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return per_fn, cached, widths, layouts

    @mirrored
    def decode_consume(self, chunk: DecodeChunk) -> np.ndarray:
        """Wait for the chunk's tokens on the host; fold them into the host
        mirrors. Returns tokens [n, B] (frozen rows repeat their last token;
        callers use chunk.advance for per-slot counts).

        A spec chunk's per-slot counts settle here: each slot's accepted runs
        are flattened, cycle by cycle, into the same [rows, B] layout;
        `advance`, `start_pos` and `adv_cycles` get the device's values; the
        host pos and last-token mirrors move, except for slots released while
        the chunk was in flight (their rows are the discarded overrun); and
        the acceptance is recorded (dllama_spec_*, spec_stats())."""
        if chunk.event is not None:
            chunk.event.synchronize()
        toks = chunk.toks.numpy().copy()
        compile_obs.note_transfer("d2h", "decode_tokens", int(toks.nbytes))
        # the wait above is the sync: the chunk's window runs from the later
        # of its dispatch and the previous chunk's consumption (a chunk
        # dispatched while its predecessor still ran is not billed the
        # predecessor's tail), to now
        now = time.perf_counter()
        start = (chunk.t0 if self._t_last_consume is None
                 else max(chunk.t0, self._t_last_consume))
        chunk.device_s = now - start
        ins.DECODE_CHUNK_SECONDS.observe(chunk.device_s)
        self._t_last_consume = now
        if chunk.spec:
            return self._spec_consume(chunk, toks)
        ins.BATCH_OCCUPANCY.observe(int(chunk.active.sum()))
        tr = trace.TRACER
        if tr.enabled:
            tr.span_at("decode.device", chunk.t_disp, tr.now(), cat="decode",
                       track="device", chunk=chunk.seq, n=chunk.n,
                       occupancy=int(chunk.active.sum()))
        self.last_token[chunk.active] = toks[-1, chunk.active]
        return toks

    def _spec_consume(self, chunk: DecodeChunk, emits: np.ndarray) -> np.ndarray:
        """decode_consume's spec half: `emits` [n, B, K+1] from the host."""
        self._spec_inflight = max(0, self._spec_inflight - 1)
        advs = chunk.adv_host.numpy().astype(np.int32)  # [n, B]
        drafted = chunk.drafted_host.numpy().astype(np.int32)
        chunk.start_pos = chunk.start_host.numpy().astype(np.int32)
        compile_obs.note_transfer("d2h", "spec_counts", int(advs.nbytes) + int(drafted.nbytes)
                                  + int(chunk.start_pos.nbytes))
        total = advs.sum(axis=0).astype(np.int32)  # [B]
        chunk.advance = total
        chunk.adv_cycles = advs
        m_cycles, b = advs.shape
        keep = np.arange(emits.shape[2])[None, None, :] < advs[:, :, None]  # [n, B, K+1]
        out = np.zeros((max(1, int(total.max(initial=0))), b), np.int64)
        for s in np.flatnonzero(total):
            out[: total[s], s] = emits[:, s, :][keep[:, s, :]]
        upd = chunk.active & self.active
        self.pos[upd] = chunk.start_pos[upd] + total[upd]
        emitted = np.flatnonzero(upd & (total > 0))
        if emitted.size:
            self.last_token[emitted] = out[total[emitted] - 1, emitted]
        # the (cycle, slot) pairs that emitted, and the share of them and of
        # the tokens that belonged to slots released in flight: the live rest
        # is what the requests' records count (spec_rows)
        gone = chunk.active & ~self.active
        self._spec_rows["slot_cycles"] += int((advs > 0).sum())
        self._spec_rows["discarded_tokens"] += int(total[gone].sum())
        self._spec_rows["discarded_cycles"] += int((advs[:, gone] > 0).sum())
        # acceptance telemetry, one site: every consumed verify cycle lands in
        # the dllama_spec_* series and the engine totals
        acc = advs - 1
        msk = drafted > 0
        n_drafted, n_acc, n_emit = int(drafted.sum()), int(acc[msk].sum()), int(total.sum())
        for key, v in (("cycles", m_cycles), ("drafted", n_drafted), ("accepted", n_acc),
                       ("emitted", n_emit)):
            self._spec_totals[key] += v
        ins.SPEC_CYCLES.inc(m_cycles)
        ins.SPEC_TOKENS.labels(kind="drafted").inc(n_drafted)
        ins.SPEC_TOKENS.labels(kind="accepted").inc(n_acc)
        ins.SPEC_TOKENS.labels(kind="emitted").inc(n_emit)
        for val, cnt in enumerate(np.bincount(acc[msk])):
            ins.SPEC_ACCEPTED_LENGTH.observe_n(val, int(cnt))
        occupancy = int((total > 0).sum())
        ins.BATCH_OCCUPANCY.observe(occupancy)
        tr = trace.TRACER
        if tr.enabled:
            tr.span_at("decode.spec", chunk.t_disp, tr.now(), cat="decode", track="device",
                       chunk=chunk.seq, cycles=m_cycles, occupancy=occupancy,
                       emitted=n_emit, accepted=n_acc)
        return out

    @mirrored
    def decode(self, n: int) -> np.ndarray:
        """n decode steps across the active slots; returns tokens [n', B] with
        n' = min(n, the roomiest active slot's room). Lockstep wrapper over
        decode_dispatch/decode_consume."""
        return self.decode_consume(self.decode_dispatch(n))

    def spec_eligible(self) -> np.ndarray:
        """bool [B], host view: slots the next spec cycle advances, the
        active ones with K+1 backed rows below their row limit (sampled,
        penalized and draft-length-0 slots advance one token a cycle; only
        slots at the context edge or an exhausted pool freeze, and the
        scheduler alternates plain chunks in for them). Exact at chunk
        boundaries; the device recomputes it every cycle."""
        return self.active & (self.pos + self.spec_k + 1 <= self._row_limit())

    def spec_draft_k(self) -> np.ndarray:
        """i32 [B], host view: each slot's draft length in the next cycle, 0
        for sampled, penalized, draft-length-0 and ineligible slots. The
        serving scheduler speculates while some live slot's entry is > 0."""
        pen = (self.presence != 0) | (self.frequency != 0)
        return np.where(self.spec_eligible() & (self.temperature == 0.0) & ~pen,
                        np.minimum(self.spec_k_slot, self.spec_k), 0).astype(np.int32)

    def spec_stats(self) -> dict | None:
        """Cumulative acceptance accounting (None when built with spec=0), the
        host mirror of the dllama_spec_* series: cycles, drafted, accepted,
        emitted, K, tokens a cycle and the mean accepted share of drafts."""
        if not self.spec_k:
            return None
        t = dict(self._spec_totals)
        t["k"] = self.spec_k
        cycles = t["cycles"]
        t["tokens_per_cycle"] = round(t["emitted"] / cycles, 3) if cycles else None
        t["accept_mean"] = round(t["accepted"] / t["drafted"], 3) if t["drafted"] else None
        return t

    def spec_rows(self) -> dict:
        """Where the spec chunks' output went, cumulative: ``slot_cycles``,
        the (cycle, slot) pairs that emitted (the sum of the requests'
        timings().spec cycles, plus the discarded ones); ``discarded_tokens``
        and ``discarded_cycles``, the tokens and (cycle, slot) pairs of
        slots released while their chunk was in flight (the overrun no
        request is credited with). spec_stats()["emitted"] is the requests'
        summed spec tokens plus ``discarded_tokens``."""
        return dict(self._spec_rows)

    @mirrored
    def spec_step(self) -> tuple[np.ndarray, np.ndarray]:
        """One speculative verify cycle across the batch, lockstep (dispatch
        and consume of decode_dispatch(1, spec=True)): returns (tokens [B,
        K+1], counts [B]), slot i having emitted tokens[i, :counts[i]] —
        1..K+1 exact-greedy tokens for a greedy slot (up to its own draft
        length), exactly one sampled or penalized token otherwise."""
        chunk = self.decode_dispatch(1, spec=True)
        toks = self.decode_consume(chunk)  # [rows, B]
        emit = np.zeros((self.n_slots, self.spec_k + 1), np.int64)
        emit[:, : toks.shape[0]] = toks.T
        return emit, chunk.advance

    def device_state(self) -> dict[str, torch.Tensor]:
        """Every engine-owned tensor a decode, prefill or spec program reads
        or writes, by name. A captured program holds their addresses, so no
        method may replace one (warm_restart refills them in place)."""
        out = {"cache.k": self.cache.k, "cache.v": self.cache.v, "pos": self._pos_dev,
               "last": self._last_dev, "rng.seed": self.rng.seed,
               "rng.counter": self.rng.counter, "active": self._active_dev,
               "limit": self._limit_dev, "temps": self._temps_dev, "topp": self._topp_dev,
               "presence": self._pres_dev, "frequency": self._freq_dev,
               "spec_k": self._speck_dev, "prefill_in": self._pf_in}
        if self.pool is not None:
            out["cache.tables"] = self.cache.tables
            out["prefill_table"] = self._pf_table
        if self._counts is not None:
            out["counts"] = self._counts
        if self.history is not None:
            out["history"] = self.history
        return out

    @mirrored(agree=True)
    @torch.no_grad()
    def warm_restart(self) -> None:
        """Crash recovery without a model reload (the JAX package's
        ``warm_restart``): everything a failed chunk may have poisoned is
        rebuilt against the resident weights: the KV cache, the page pool
        and its radix tree (rebuilt empty; the hit accounting carries
        over), the host tier, every per-slot vector, the generator rows and
        the spec history. Unlike the JAX package, which allocates fresh
        buffers, every device tensor is refilled IN PLACE: the captured
        programs hold their addresses, so they stay valid and a restart
        recaptures nothing. The host tier keeps its pinned slab and drops
        its index. On a card whose context a sticky error killed, the first
        device write here raises, and the scheduler counts that against its
        restart budget.

        On a mesh every rank makes the call and refills its own shard (its
        kv heads, its block of slots) and its device state in place; no
        communicator is made again. The ranks first agree that the world is
        in step (every last outcome rank 0's, the channel open): a world
        that a failure inside an exchange broke is not restarted, and the
        call raises (parallel/multihost.Link.agree)."""
        self.cache.k.zero_()
        self.cache.v.zero_()
        if self.pool is not None:
            self.pool.reset()
            self.cache.tables.zero_()
            self._pf_table.zero_()
            if self.radix is not None:
                spill = self.radix.spill
                self.radix = RadixCache(self.pool, carry_from=self.radix)
                self.radix.spill = spill
            if self.pool.host is not None:
                self.pool.host.reset()
        for t in (self._pos_dev, self._last_dev, self.rng.seed, self.rng.counter,
                  self._active_dev, self._limit_dev, self._temps_dev, self._pres_dev,
                  self._freq_dev, self._speck_dev, self._pf_in):
            t.zero_()
        self._topp_dev.fill_(0.9)
        if self._counts is not None:
            self._counts.zero_()
        if self.history is not None:
            self.history.fill_(-1)
        self.pos[:] = 0
        self.active[:] = False
        self.last_token[:] = 0
        self.temperature[:] = 0.0
        self.topp[:] = 0.9
        self.presence[:] = 0.0
        self.frequency[:] = 0.0
        self.seeds[:] = 0
        self.spec_k_slot[:] = 0
        self._spec_inflight = 0  # an unconsumed chunk died with the crash
        self._t_last_consume = None
        self._vec_dirty = True

    @mirrored
    def release(self, slot: int, keep_rows: int | None = None) -> None:
        """Free a slot. keep_rows rewinds pos to the valid prefix (a stop
        mid-chunk, including rows a dispatched chunk overran), keeping the
        slot's cache for prefix reuse; on the paged layout the rewind also
        RETURNS the tail pages past the kept prefix (a shared page only
        loses this slot's reference). keep_rows=None means the rows are
        unspecified: every page goes back."""
        self.active[slot] = False
        self.presence[slot] = self.frequency[slot] = 0.0
        self.spec_k_slot[slot] = 0
        if keep_rows is not None:
            self.pos[slot] = keep_rows
            if self.pool is not None:
                self.pool.free_tail(slot, keep_rows)
        elif self.pool is not None:
            self.pool.free_tail(slot, 0)
            self.pos[slot] = 0
        _set_row(self._pos_dev, slot, self.pos[slot])
        if self.pool is not None and self.pool.audit_on_release:
            self.pool.audit()
        self._vec_dirty = True
