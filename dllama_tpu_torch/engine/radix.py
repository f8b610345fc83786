"""Cross-request radix prefix cache over the paged KV pool.

A copy of the JAX package's ``engine/radix.py`` (the port imports nothing
of that package); the tree is pure host bookkeeping, so the code is the
same. SGLang-style RadixAttention (Zheng et al.) over the vLLM-style page
pool (Kwon et al.): a GLOBAL radix tree keyed on token ids whose nodes own
refcounted page references into the engine's
:class:`~dllama_tpu_torch.engine.batch.PagePool`. An admitted request walks
the tree, maps the longest shared prefix for free (block-table entries
copied, page refcounts bumped, a partial boundary page shared and then
copy-on-written by ``ensure_writable``), prefills only the suffix, and on
commit/release inserts its own prefix back so later requests hit it. Shared
system prompts, few-shot templates, multi-turn chat and agent loops that
resend their history become O(new tokens) prefill, across requests and
slots.

Design constraints the page pool imposes (and how the tree meets them):

* **Page-granular edges.** KV is allocated in ``page_size``-row pages, so
  node edges are sequences of WHOLE pages: children are keyed by their
  edge's first page-sized token tuple, and edges split only at page
  boundaries. Two prompts diverging *inside* a page hang as sibling
  children; the shared sub-page prefix is still used at lookup time as the
  *partial boundary*: the best child's first page is mapped shared and the
  admission's ``prepare_admission`` copy-on-writes it before the divergent
  rows are written, so rows ``[0, part)`` of the clone are free.
* **Immutability by construction.** Only FULL pages whose every row is
  written enter the tree (a prompt's full pages at commit, the emitted
  prefix's full pages at release). Decode writes rows strictly past the
  written prefix, the one-chunk stop overrun included, so a tree page is
  never rewritten while shared.
* **Refcount composition.** The tree holds exactly ONE pool reference per
  owned page, beside however many block-table references share it;
  ``PagePool.audit()`` reconciles ``refcount == table refs + tree refs``
  (the tree registers itself as the pool's ``radix_refs`` provider), so a
  leaked or duplicated node reference fails the audit like any allocator
  corruption.
* **Eviction composes with capacity-aware admission.** LRU over leaf nodes
  whose pages no live slot references, coldest first (smallest
  tie-break): tree pages are reclaimed BEFORE a request defers or is
  rejected, and before the all-starved decode rescue truncates a running
  request. The matched path of the admission being served is protected.
  With the host tier on, a last-reference page is copied to host memory
  (``spill``) before it is dropped.

The cumulative counts (lookups, hits, hit tokens, inserted and evicted
pages) are kept in ``stats()`` and published as the ``dllama_radix_*``
series; ``carry_from`` carries them into a tree rebuilt against a fresh
pool.

Thread-safety: the scheduler worker is the only mutator, but ``stats()``,
``dump()`` and the audit provider are read from HTTP handler threads, so
every method takes the POOL's reentrant lock, which also makes
``audit()`` calling ``audit_refs()`` reentrancy-safe.
"""

from __future__ import annotations

import heapq
import time

from dllama_tpu_torch.obs import instruments as ins


def _lcp(a, b) -> int:
    """Leading-equal count of two token sequences."""
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class RadixNode:
    """One edge of the tree: ``tokens`` (a whole number of pages worth of
    token ids, the path label from the parent) backed 1:1 by ``pages``
    (pool page ids — ``len(tokens) == len(pages) * page_size``)."""

    __slots__ = ("tokens", "pages", "children", "parent", "last_used")

    def __init__(self, tokens=(), pages=(), parent=None):
        self.tokens: tuple = tuple(tokens)
        self.pages: list[int] = list(pages)
        self.children: dict[tuple, RadixNode] = {}
        self.parent: RadixNode | None = parent
        self.last_used = time.monotonic()


class RadixHit:
    """``lookup()`` result: the mappable prefix. ``rows`` = full-page rows
    plus the partial-boundary rows; ``pages`` are the full shared pages;
    ``boundary`` (when ``part > 0``) is the tree page whose first ``part``
    rows match — mapped shared, then COW'd by the admission. ``path`` is
    the matched node chain, protected from eviction while this admission
    is being served."""

    __slots__ = ("rows", "pages", "part", "boundary", "path", "tokens")

    def __init__(self, rows, pages, part, boundary, path, tokens):
        self.rows = rows
        self.pages = pages
        self.part = part
        self.boundary = boundary
        self.path = path
        self.tokens = tokens


class RadixCache:
    """The global prefix tree over one :class:`PagePool`.

    Owns the ``dllama_radix_nodes`` / ``dllama_radix_pages`` gauges and the
    ``dllama_radix_lookups_total{outcome}`` / ``dllama_radix_hit_tokens_total``
    counters (single publication site). ``carry_from`` preserves the
    cumulative accounting of a tree this one replaces (the tree itself is
    rebuilt empty against the fresh pool)."""

    def __init__(self, pool, carry_from: "RadixCache | None" = None):
        self.pool = pool
        self.page = pool.page_size
        # the POOL's RLock: tree refs and pool refcounts mutate together,
        # and audit() -> audit_refs() re-enters it from the same thread
        self._mu = pool._mu
        self.root = RadixNode()
        self.n_nodes = 0  # excluding the root
        self.n_pages = 0
        # cumulative accounting (carried over by carry_from)
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0  # prefill rows REALLY served (counted at commit)
        self.inserted_pages = 0
        self.evicted_pages = 0
        if carry_from is not None:
            self.lookups = carry_from.lookups
            self.hits = carry_from.hits
            self.hit_tokens = carry_from.hit_tokens
            self.inserted_pages = carry_from.inserted_pages
            self.evicted_pages = carry_from.evicted_pages
        # host-tier spill hook (BatchEngine._host_spill when --kv-host-pages
        # is on): called under the pool lock with (token_path_key, page_id)
        # for each last-reference page right before eviction drops it; a
        # False/failed spill degrades to the plain discard
        self.spill = None
        pool.radix_refs = self.audit_refs  # audit reconciliation hook
        self._publish()

    # ------------------------------------------------------------- internal

    def _publish(self) -> None:
        ins.RADIX_NODES.set(self.n_nodes)
        ins.RADIX_PAGES.set(self.n_pages)

    def _iter_nodes(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            yield n

    def _split(self, parent: RadixNode, child: RadixNode, k: int) -> RadixNode:
        """Split ``child``'s edge at page ``k`` (0 < k < len(pages)): the
        new prefix node keeps the first k pages, ``child`` keeps the rest
        below it. Pure re-parenting — no refcount moves."""
        page = self.page
        prefix = RadixNode(child.tokens[: k * page], child.pages[:k], parent)
        prefix.last_used = child.last_used
        child.tokens = child.tokens[k * page:]
        child.pages = child.pages[k:]
        child.parent = prefix
        prefix.children[child.tokens[:page]] = child
        parent.children[prefix.tokens[:page]] = prefix
        self.n_nodes += 1
        return prefix

    def _abs_tokens(self, node: RadixNode) -> tuple:
        """The absolute token path from the root through ``node`` (its own
        edge included) — the host-tier key space. O(depth) parent-chain
        walk; only taken on the eviction path when a spill hook is wired."""
        parts = []
        n = node
        while n is not None and n.parent is not None:
            parts.append(n.tokens)
            n = n.parent
        out: list[int] = []
        for t in reversed(parts):
            out.extend(t)
        return tuple(out)

    def _drop(self, node: RadixNode) -> int:
        """Remove a leaf; decref its pages. Returns pages actually freed."""
        before = self.pool.free_count
        for p in node.pages:
            self.pool._decref(p)
        freed = self.pool.free_count - before
        del node.parent.children[node.tokens[:self.page]]
        self.n_nodes -= 1
        self.n_pages -= len(node.pages)
        return freed

    # ------------------------------------------------------------------ api

    def lookup(self, toks, count: bool = True) -> RadixHit:
        """Longest mappable prefix of ``toks``, capped at ``len(toks) - 1``
        (at least one token must prefill to produce logits — the same rule
        the per-slot LCP scan enforced). ``count=False`` skips the lookup /
        hit accounting — the post-restore re-walk is the same logical
        lookup, not a second one."""
        page = self.page
        toks = [int(t) for t in toks]
        cap = len(toks) - 1
        now = time.monotonic()
        with self._mu:
            if count:
                self.lookups += 1
            node, depth = self.root, 0
            pages: list[int] = []
            path = [self.root]
            boundary, part = None, 0
            mid_edge = False
            while depth + page <= cap:
                child = node.children.get(tuple(toks[depth:depth + page]))
                if child is None:
                    break
                child.last_used = now
                path.append(child)
                k = 0  # >= 1 after the loop: the dict key IS page 0's tokens
                while (k < len(child.pages)
                       and depth + (k + 1) * page <= cap
                       and tuple(child.tokens[k * page:(k + 1) * page])
                       == tuple(toks[depth + k * page:depth + (k + 1) * page])):
                    k += 1
                pages.extend(child.pages[:k])
                depth += k * page
                if k < len(child.pages):
                    # stopped inside this edge (divergence, or the prompt
                    # ran out): its next page — and ONLY it — is the
                    # boundary candidate (sibling pages live at this node's
                    # START depth, not here; offering one would map KV
                    # computed at different positions)
                    mid_edge = True
                    part = _lcp(child.tokens[k * page:(k + 1) * page],
                                toks[depth:cap])
                    if part:
                        boundary = child.pages[k]
                    break
                node = child
            if boundary is None and not mid_edge:
                # stopped at a node boundary (children's first pages cover
                # exactly rows [depth, depth+page)): the best partially-
                # matching child still yields sub-page reuse. The winner
                # joins the protected path — eviction between lookup and
                # radix_map must not free the page about to be mapped.
                best = None
                for c in node.children.values():
                    n = _lcp(c.tokens[:page], toks[depth:cap])
                    if n > part:
                        part, boundary, best = n, c.pages[0], c
                if best is not None:
                    best.last_used = now
                    path.append(best)
            rows = depth + part
            if rows > 0 and count:
                self.hits += 1
        if count:
            ins.RADIX_LOOKUPS.labels(
                outcome="hit" if rows > 0 else "miss").inc()
        return RadixHit(rows=rows, pages=pages, part=part, boundary=boundary,
                        path=tuple(path), tokens=toks[:rows])

    def note_served(self, rows: int) -> None:
        """Count ``rows`` prefix rows REALLY served from the tree — called
        at the admission's commit, so an aborted/cancelled admission never
        inflates the saved-prefill accounting."""
        if rows <= 0:
            return
        with self._mu:
            self.hit_tokens += int(rows)
        ins.RADIX_HIT_TOKENS.inc(int(rows))

    def insert(self, toks, slot_pages) -> int:
        """Insert the full-page prefix of ``toks`` — KV rows backed by
        ``slot_pages``, the owning slot's block-table pages — into the
        tree. Matched existing nodes are kept (their pages already hold
        exactly these rows); the unmatched full-page tail is adopted BY
        REFERENCE: each adopted page's pool refcount bumps, making the tree
        a first-class referent that outlives the releasing slot. Returns
        the number of pages adopted."""
        page = self.page
        toks = [int(t) for t in toks]
        full = len(toks) // page
        if full <= 0:
            return 0
        now = time.monotonic()
        with self._mu:
            node, depth = self.root, 0
            while depth < full * page:
                child = node.children.get(tuple(toks[depth:depth + page]))
                if child is None:
                    break
                child.last_used = now
                k = 0
                while (k < len(child.pages)
                       and depth + (k + 1) * page <= full * page
                       and tuple(child.tokens[k * page:(k + 1) * page])
                       == tuple(toks[depth + k * page:depth + (k + 1) * page])):
                    k += 1
                depth += k * page
                if k < len(child.pages):
                    if depth < full * page:
                        # diverged mid-edge with pages still to adopt:
                        # split at the page boundary so the tail branches
                        node = self._split(node, child, k)
                    break
                node = child
            rem = full - depth // page
            if rem <= 0:
                return 0
            adopt = [int(p) for p in slot_pages[depth // page:full]]
            new = RadixNode(tuple(toks[depth:full * page]), adopt, node)
            new.last_used = now
            node.children[new.tokens[:page]] = new
            for p in adopt:
                self.pool.refcount[p] += 1
            self.n_nodes += 1
            self.n_pages += len(adopt)
            self.inserted_pages += len(adopt)
            self.pool._publish()  # shared-pages gauge may have moved
            self._publish()
            return len(adopt)

    def evict(self, need: int, protect=None) -> int:
        """Reclaim pool pages by dropping leaves — LRU (coldest
        ``last_used``) first, smallest tie-break — until ``need`` pages
        came FREE or no reclaimable leaf remains, then stop (a one-page
        shortfall must not wipe the whole tree). Leaves whose every page
        is still referenced by a live slot free nothing and are skipped
        (they stay cached); ``protect`` (a :class:`RadixHit` or an
        iterable of nodes) pins the admission-in-progress's matched path.
        Returns pages actually freed."""
        prot = protect.path if isinstance(protect, RadixHit) else (protect or ())
        prot_ids = {id(n) for n in prot}
        freed = 0
        with self._mu:
            # one tree walk seeds the heap; a dropped victim's parent is
            # re-seeded when it just became a leaf — never a full rescan
            # per victim (the pool lock is held: reclaim must stay O(n log n))
            heap = [((n.last_used, len(n.pages), id(n)), n)
                    for n in self._iter_nodes()
                    if not n.children and id(n) not in prot_ids]
            heapq.heapify(heap)
            while freed < need and heap:
                _, victim = heapq.heappop(heap)
                if not any(self.pool.refcount[p] == 1 for p in victim.pages):
                    # every page still referenced by a live slot: dropping
                    # frees nothing — keep the cache entry (refcounts of
                    # OTHER nodes' pages never change inside this loop, so
                    # skipping is final for this call)
                    continue
                parent = victim.parent
                if self.spill is not None:
                    # host-tier capture BEFORE the drop, while the pages
                    # are still allocated and their KV rows intact. Only
                    # last-reference pages spill: a shared page lives on in
                    # some slot's block table and re-enters the tree at
                    # that slot's release. Keys are absolute token paths —
                    # page i's rows encode the prefix through its last row.
                    full = self._abs_tokens(victim)
                    start = len(full) - len(victim.tokens)
                    for i, p in enumerate(victim.pages):
                        if self.pool.refcount[p] == 1:
                            self.spill(full[: start + (i + 1) * self.page], p)
                freed += self._drop(victim)
                if (parent is not self.root and not parent.children
                        and id(parent) not in prot_ids):
                    heapq.heappush(
                        heap,
                        ((parent.last_used, len(parent.pages), id(parent)),
                         parent))
            if freed:
                self.evicted_pages += freed
                self.pool._publish()
                self._publish()
        return freed

    def restore_prefix(self, toks, peek, install, take) -> int:
        """Graft host-tier pages for ``toks`` back into the tree
        (restore-on-hit, the inverse of the eviction spill). Walks like
        :meth:`insert`; wherever the resident tree runs out but the host
        tier holds the next full page of the prompt (``peek`` by absolute
        token path), ``install`` uploads it into a fresh pool page, a
        single-page node adopts that page (the tree owns its one
        reference — ``_alloc_page`` set it), and ``take`` retires the host
        copy. Stops at the first miss or failed install (peek→install→take:
        a failed device alloc never loses the only copy). Returns pages
        grafted; the caller re-walks with ``lookup(count=False)``."""
        page = self.page
        toks = [int(t) for t in toks]
        # a grafted page only helps if lookup can map it whole, and lookup
        # caps matched rows at len(toks) - 1
        limit = ((len(toks) - 1) // page) * page
        if limit <= 0:
            return 0
        grafted = 0
        now = time.monotonic()
        with self._mu:
            node, depth = self.root, 0
            while depth < limit:
                child = node.children.get(tuple(toks[depth:depth + page]))
                if child is not None:
                    k = 0
                    while (k < len(child.pages)
                           and depth + (k + 1) * page <= limit
                           and tuple(child.tokens[k * page:(k + 1) * page])
                           == tuple(toks[depth + k * page:
                                         depth + (k + 1) * page])):
                        k += 1
                    depth += k * page
                    if k < len(child.pages):
                        if depth + page > limit:
                            break
                        # diverged mid-edge with restorable room left:
                        # split at the page boundary (k >= 1 — the dict
                        # key IS page 0) so a restored sibling can graft
                        node = self._split(node, child, k)
                        continue
                    node = child
                    continue
                key = tuple(toks[:depth + page])
                payload = peek(key)
                if payload is None:
                    break
                pg = install(payload)
                if pg is None:
                    break
                new = RadixNode(tuple(toks[depth:depth + page]), [pg], node)
                new.last_used = now
                node.children[new.tokens[:page]] = new
                self.n_nodes += 1
                self.n_pages += 1
                take(key)
                grafted += 1
                node = new
                depth += page
            if grafted:
                self.pool._publish()
                self._publish()
        return grafted

    def clear(self) -> int:
        """Drop the whole tree (drain/diagnostics). Returns pages freed back
        to the pool."""
        with self._mu:
            before = self.pool.free_count
            for node in list(self._iter_nodes()):
                for p in node.pages:
                    self.pool._decref(p)
            self.root = RadixNode()
            self.n_nodes = 0
            self.n_pages = 0
            self.pool._publish()
            self._publish()
            return self.pool.free_count - before

    # -------------------------------------------------------- observability

    def audit_refs(self) -> tuple[dict[int, int], list[str]]:
        """Audit provider (``PagePool.audit``): per-page tree reference
        counts plus the tree's OWN invariant violations — a page owned by
        two nodes (each page must enter the tree exactly once) or an
        out-of-range page id. Runs under the shared pool lock."""
        refs: dict[int, int] = {}
        problems: list[str] = []
        with self._mu:
            n_pages = 0
            for node in self._iter_nodes():
                if len(node.tokens) != len(node.pages) * self.page:
                    problems.append(
                        f"radix node holds {len(node.tokens)} tokens for "
                        f"{len(node.pages)} pages (page_size {self.page})")
                for p in node.pages:
                    n_pages += 1
                    if not 0 <= p < self.pool.n_pages:
                        problems.append(
                            f"radix node references page {p} outside the "
                            f"pool [0, {self.pool.n_pages})")
                        continue
                    refs[p] = refs.get(p, 0) + 1
                    if refs[p] > 1:
                        problems.append(
                            f"page {p} referenced by {refs[p]} radix nodes "
                            "(each page must enter the tree exactly once)")
            if n_pages != self.n_pages:
                problems.append(
                    f"radix page count drift: gauge says {self.n_pages}, "
                    f"recount found {n_pages}")
        return refs, problems

    def stats(self) -> dict:
        """Occupancy + cumulative hit accounting (latency_summary(),
        /debug/perf, /debug/radix — and the gauges' source of truth).
        ``hit_tokens`` is the saved-prefill-rows total."""
        with self._mu:
            return {
                "nodes": self.n_nodes,
                "pages": self.n_pages,
                "lookups": self.lookups,
                "hits": self.hits,
                "hit_rate": (round(self.hits / self.lookups, 4)
                             if self.lookups else None),
                "hit_tokens": self.hit_tokens,
                "inserted_pages": self.inserted_pages,
                "evicted_pages": self.evicted_pages,
                "page_size": self.page,
            }

    def dump(self, max_nodes: int = 512) -> dict:
        """Bounded JSON tree dump for ``GET /debug/radix``: nested nodes
        with their token labels (truncated past 16), page ids, and
        last-use age. ``truncated`` flags a cut-off subtree."""
        now = time.monotonic()
        budget = [max_nodes]

        def render(node: RadixNode) -> dict:
            out: dict = {
                "n_tokens": len(node.tokens),
                "tokens": list(node.tokens[:16]),
                "pages": list(node.pages),
                "age_s": round(now - node.last_used, 3),
            }
            kids = []
            for c in sorted(node.children.values(),
                            key=lambda n: -n.last_used):
                if budget[0] <= 0:
                    out["truncated"] = True
                    break
                budget[0] -= 1
                kids.append(render(c))
            if kids:
                out["children"] = kids
            return out

        with self._mu:
            kids = []
            for c in sorted(self.root.children.values(),
                            key=lambda n: -n.last_used):
                if budget[0] <= 0:
                    break
                budget[0] -= 1
                kids.append(render(c))
            return {"nodes": self.n_nodes, "pages": self.n_pages,
                    "children": kids,
                    "truncated": self.n_nodes > max_nodes}
