"""The port's radix prefix tree (``engine/radix.py``, a copy of the JAX
package's) against the JAX package on the same inputs.

* Tree core: the seven drills of ``tests/test_radix.py`` (insert and walk,
  the page-boundary split, the sub-page boundary, no false boundary after a
  mid-edge stop, the protected fallback child, LRU eviction that skips
  live pages and spares the protected path, the audit of leaked and
  duplicated node refs), each one operation script run over JAX's
  ``RadixCache`` on JAX's ``PagePool`` and over the port's: lookups (rows,
  pages, part, boundary), refcounts, ``stats()`` and audit results equal.
* Engine: a mapped hit, then copy-on-write on a divergence inside the
  shared boundary page; block tables, refcounts and greedy ids equal to
  JAX's engine.
* Scheduler: greedy, sampled and penalized streams bit-equal with the tree
  on and off, overlap on and off (port only: sampled streams are Philox in
  the port); greedy ids, ``reused_prefix_tokens`` and ``radix_stats()``
  equal to the JAX scheduler's with the tree on, for a shared system
  prompt, a multi-turn chat and an eviction that admits a deferred
  request; a clean drain audit with the tree intact.

The tiny configuration is the JAX test's: dim 64, 2 layers, 4/2 heads,
context 64, page 8.
"""

import numpy as np
import pytest
import torch

from dllama_tpu_torch.convert import params_from_numpy
from dllama_tpu_torch.engine import batch as tbatch
from dllama_tpu_torch.engine import radix as tradix
from dllama_tpu_torch.engine.batch import BatchEngine
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.serve.scheduler import Scheduler

torch.set_num_threads(1)

KW = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=96,
          seq_len=64)
CFG = LlamaConfig(**KW)
PAGE = 8


@pytest.fixture(scope="module")
def models():
    import jax
    import jax.numpy as jnp

    from dllama_tpu.models.config import LlamaConfig as JaxConfig
    from dllama_tpu.models.llama import random_params

    jcfg = JaxConfig(**KW)
    jparams = random_params(jcfg, seed=3, dtype=jnp.float32, quantize=False)
    return jcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


# --------------------------------------------------------------- tree core


def _mods(side: str):
    """(PagePool, RadixCache, PoolAuditError) of one package."""
    if side == "port":
        return tbatch.PagePool, tradix.RadixCache, tbatch.PoolAuditError
    from dllama_tpu.engine import batch as jbatch
    from dllama_tpu.engine import radix as jradix

    return jbatch.PagePool, jradix.RadixCache, jbatch.PoolAuditError


class Drill:
    """A bare pool and tree of one package, and the record of what a drill
    observes on them."""

    def __init__(self, side, n_pages=16, page=4, slots=2):
        Pool, Radix, self.AuditError = _mods(side)
        self.pool = Pool(n_pages, page, slots, max_blocks=n_pages)
        self.radix = Radix(self.pool)
        self.page = page
        self.rec: list = []

    def take(self, slot, n):
        """Allocate n fresh pages into `slot`'s table; their ids."""
        start = int(self.pool.n_blocks[slot])
        self.pool.grow(slot, (start + n) * self.page)
        return [int(p) for p in self.pool.tables[slot, start:start + n]]

    def lookup(self, toks):
        hit = self.radix.lookup(toks)
        self.rec.append(("lookup", hit.rows, [int(p) for p in hit.pages], hit.part,
                         None if hit.boundary is None else int(hit.boundary)))
        return hit

    def audit(self):
        report = self.pool.audit(raise_on_fail=False)
        self.rec.append(("audit", report["ok"], list(report["problems"]),
                         report["radix_pages"], report["free"], report["used"]))
        self.rec.append(("refcount", self.pool.refcount.tolist()))
        self.rec.append(("stats", self.radix.stats()))
        return report

    def note(self, *what):
        self.rec.append(what)


def drill_insert_walk_and_miss(d):
    toks = list(range(10, 22))  # 3 full pages of 4
    pages = d.take(0, 3)
    d.note("adopted", d.radix.insert(toks, pages))
    assert all(d.pool.refcount[p] == 2 for p in pages)
    hit = d.lookup(toks + [77, 78])
    assert hit.rows == 12 and hit.pages == pages and hit.part == 0
    hit = d.lookup(toks)  # cap 11: 2 full pages + 3 rows of the third
    assert hit.rows == 11 and hit.part == 3 and hit.boundary == pages[2]
    assert d.lookup([90, 91, 92, 93, 94]).rows == 0
    assert d.audit()["ok"]


def drill_split_mid_edge_at_page_boundary(d):
    a = list(range(1, 13))
    pages_a = d.take(0, 3)
    d.radix.insert(a, pages_a)
    b = a[:8] + [60, 61, 62, 63]
    d.radix.insert(b, pages_a[:2] + d.take(1, 1))
    assert d.radix.stats()["nodes"] == 3 and d.radix.stats()["pages"] == 4
    for toks in (a, b):
        assert d.lookup(toks + [80]).rows == 12
    assert d.audit()["ok"]


def drill_partial_boundary_within_first_page(d):
    pages_a = d.take(0, 2)
    d.radix.insert([1, 2, 3, 4, 5, 6, 7, 8], pages_a)
    hit = d.lookup([1, 2, 9, 9, 9])
    assert hit.rows == 2 and hit.pages == [] and hit.part == 2
    assert hit.boundary == pages_a[0]
    d.audit()


def drill_no_false_boundary_after_mid_edge_divergence(d):
    d.radix.insert([1, 2, 3, 4, 5, 6, 7, 8], d.take(0, 2))
    d.radix.insert([9, 10, 11, 12], d.take(1, 1))
    hit = d.lookup([1, 2, 3, 4, 9, 10, 99, 0])
    assert hit.rows == 4 and hit.part == 0 and hit.boundary is None
    d.audit()


def drill_fallback_boundary_child_survives_protected_eviction(d):
    pa = d.take(0, 2)
    d.radix.insert([1, 2, 3, 4, 5, 6, 7, 8], pa)
    d.pool.free_tail(0, 0)  # the tree is the only referent
    hit = d.lookup([1, 2, 99])
    assert hit.part == 2 and hit.boundary == pa[0]
    d.note("freed", d.radix.evict(8, protect=hit))
    assert int(d.pool.refcount[pa[0]]) == 1
    d.audit()


def drill_evict_lru_refcount_aware_and_protected(d):
    a, b, c = ([i + 1, i + 2, i + 3, i + 4] for i in (0, 10, 20))
    pa, pb, pc = d.take(0, 1), d.take(0, 1), d.take(0, 1)
    for toks, pages in ((a, pa), (b, pb), (c, pc)):
        d.radix.insert(toks, pages)
    d.pool.free_tail(0, 0)
    d.pool.adopt_prefix(1, pb)  # a live slot still shares b
    nodes = {tuple(n.tokens): n for n in d.radix._iter_nodes()}
    for toks, t in ((a, 1.0), (b, 2.0), (c, 3.0)):
        nodes[tuple(toks)].last_used = t
    hit_c = d.lookup(c + [99])
    # a (coldest) goes; b frees nothing (slot 1 holds it) and stays; c is
    # the protected match
    assert d.radix.evict(2, protect=hit_c) == 1
    d.note("left", sorted(tuple(n.tokens) for n in d.radix._iter_nodes()))
    assert d.audit()["ok"]
    d.pool.free_tail(1, 0)
    assert d.radix.evict(8) == 2
    assert d.audit()["used"] == 0


def drill_audit_fails_on_leaked_and_duplicate_node_refs(d):
    toks = [1, 2, 3, 4]
    pages = d.take(0, 1)
    d.radix.insert(toks, pages)
    assert d.audit()["radix_pages"] == 1
    node = next(iter(d.radix._iter_nodes()))
    stolen = node.pages.pop()  # a leaked node ref
    node.tokens = ()
    with pytest.raises(d.AuditError):
        d.pool.audit()
    assert not d.audit()["ok"]
    node.pages.append(stolen)
    node.tokens = tuple(toks)
    assert d.audit()["ok"]
    node.pages.append(stolen)  # the same page entering the tree twice
    node.tokens = tuple(toks + [9, 9, 9, 9])
    d.pool.refcount[stolen] += 1
    report = d.audit()
    assert not report["ok"] and any("radix nodes" in p for p in report["problems"])


DRILLS = [drill_insert_walk_and_miss, drill_split_mid_edge_at_page_boundary,
          drill_partial_boundary_within_first_page,
          drill_no_false_boundary_after_mid_edge_divergence,
          drill_fallback_boundary_child_survives_protected_eviction,
          drill_evict_lru_refcount_aware_and_protected,
          drill_audit_fails_on_leaked_and_duplicate_node_refs]


@pytest.mark.parametrize("drill", DRILLS, ids=lambda f: f.__name__[6:])
def test_tree_drill_equals_jax(drill):
    want, got = Drill("jax"), Drill("port")
    drill(want)
    drill(got)
    assert got.rec == want.rec


# ------------------------------------------------------------ engine level


def test_map_then_cow_on_divergence_inside_boundary_page(models):
    """A mapped partial boundary page is copy-on-written by the admission:
    the tree's page keeps its rows, tables and refcounts equal JAX's at each
    step, and the diverged continuation equals JAX's and an engine that
    never shared anything."""
    import jax.numpy as jnp

    from dllama_tpu.engine.batch import BatchEngine as JaxEngine

    jcfg, jparams, params = models
    jeng = JaxEngine(jcfg, jparams, n_slots=3, cache_dtype=jnp.float32, kv_layout="paged",
                     page_size=PAGE, radix_cache="on")
    eng = BatchEngine(CFG, params, n_slots=3, cache_dtype=torch.float32, kv_layout="paged",
                      page_size=PAGE, radix_cache="on")
    solo = BatchEngine(CFG, params, n_slots=3, cache_dtype=torch.float32, kv_layout="paged",
                       page_size=PAGE, radix_cache="off")
    prompt = list(range(1, 17))  # exactly 2 full pages
    div = prompt[:12] + [70, 71, 72]  # diverges inside the tree's second page

    def state(e):
        return (e.pool.tables.tolist(), e.pool.n_blocks.tolist(), e.pool.refcount.tolist(),
                e.radix_stats())

    for e in (jeng, eng):
        e.add(0, prompt, temperature=0.0, seed=0)
        e.radix_insert(0, prompt)
        e.release(0)
    assert state(eng) == state(jeng)
    assert eng.radix_stats()["pages"] == 2
    hits = []
    for e in (jeng, eng):
        rows, hit = e.radix_lookup(div)
        assert rows == 12 and hit.part == 4
        e.radix_map(1, hit)
        hits.append(int(hit.boundary))
    assert state(eng) == state(jeng)
    assert int(eng.pool.refcount[hits[1]]) == 2  # tree + slot 1
    firsts = [e.add(1, div[12:], temperature=0.0, seed=1, start_pos=12) for e in (jeng, eng)]
    assert firsts[0] == firsts[1]
    assert state(eng) == state(jeng)
    # the admission copied the shared boundary before writing: the tree's
    # page is whole again, and slot 1 holds a fresh copy
    assert int(eng.pool.refcount[hits[1]]) == 1 and int(eng.pool.tables[1, 1]) != hits[1]
    solo.add(1, div, temperature=0.0, seed=1)
    got = eng.decode(4)[:, 1]
    np.testing.assert_array_equal(got, np.asarray(jeng.decode(4))[:, 1])
    np.testing.assert_array_equal(got, solo.decode(4)[:, 1])
    assert eng.pool.audit()["ok"] and eng.pool.audit()["radix_pages"] == 2


# --------------------------------------------------------- scheduler level

SYS = list(range(1, 18))  # 17 tokens: 2 full pages + 1


def _workload(sched):
    """A shared system prompt, staggered: r1 decodes, then r2 (sampled) and
    r3 (penalized) join."""
    r1 = sched.submit(SYS + [30], 0.0, 0.9, 10, frozenset(), seed=1)
    it1 = r1.tokens()
    head = [next(it1), next(it1)]
    r2 = sched.submit(SYS + [40, 41], 1.1, 0.9, 8, frozenset(), seed=42)
    r3 = sched.submit(SYS + [50], 0.9, 0.8, 8, frozenset(), seed=7, presence=0.5,
                      frequency=0.3)
    out2, out3 = list(r2.tokens()), list(r3.tokens())
    return [(head + list(it1), r1.finish_reason), (out2, r2.finish_reason),
            (out3, r3.finish_reason)]


_RUNS: dict = {}


def _port_run(params, radix, overlap=True):
    key = (radix, overlap)
    if key not in _RUNS:
        eng = BatchEngine(CFG, params, n_slots=3, cache_dtype=torch.float32, kv_layout="paged",
                          page_size=PAGE, radix_cache=radix)
        eng.pool.audit_on_release = True
        sched = Scheduler(eng, overlap=overlap)
        try:
            streams = _workload(sched)
            summary = sched.latency_summary()
        finally:
            assert sched.drain(timeout_s=60)
        report = eng.pool.audit()
        assert report["ok"] and report["free"] == report["total"]
        _RUNS[key] = streams, summary
    return _RUNS[key]


@pytest.mark.parametrize("overlap", [True, False])
def test_streams_bit_equal_tree_on_and_off(models, overlap):
    """Greedy, sampled and penalized streams are the same with the tree on
    and off (reuse changes which rows are mapped or prefilled, never their
    values), and the tree really served the shared prompt."""
    params = models[2]
    on, summary = _port_run(params, "on", overlap)
    off, off_summary = _port_run(params, "off", overlap)
    assert on == off
    # r2 and r3 each map at least the prompt's 2 full pages (17 rows when
    # r1 finished first and left its third page for a 1-row boundary)
    assert summary["radix"]["hit_tokens"] >= 32 and off_summary["radix"] is None
    assert [n for _, n in on] == ["length", "length", "length"]
    if not overlap:
        assert on == _port_run(params, "on", True)[0]


def _jax_sched(models, n_slots=3, kv_pages=0):
    import jax.numpy as jnp

    from dllama_tpu.engine.batch import BatchEngine as JaxEngine
    from dllama_tpu.serve.scheduler import Scheduler as JaxScheduler

    jcfg, jparams, _ = models
    jeng = JaxEngine(jcfg, jparams, n_slots=n_slots, cache_dtype=jnp.float32,
                     kv_layout="paged", page_size=PAGE, kv_pages=kv_pages, radix_cache="on")
    return JaxScheduler(jeng, chunk=4, overlap=True)


def _port_sched(models, n_slots=3, kv_pages=0):
    eng = BatchEngine(CFG, models[2], n_slots=n_slots, cache_dtype=torch.float32,
                      kv_layout="paged", page_size=PAGE, kv_pages=kv_pages, radix_cache="on")
    eng.pool.audit_on_release = True
    return Scheduler(eng)


def _shared_prompt(sched):
    """r1 runs to its end, then r2 and r3 (penalized greedy) arrive
    together: the tree serves both the prompt's 2 full pages and a 1-row
    boundary from r1's third page, whatever the timing."""
    out = [list(sched.submit(SYS + [30], 0.0, 0.9, 10, frozenset(), seed=1).tokens())]
    r2 = sched.submit(SYS + [40, 41], 0.0, 0.9, 8, frozenset(), seed=42)
    r3 = sched.submit(SYS + [50], 0.0, 0.8, 8, frozenset(), seed=7, presence=0.5,
                      frequency=0.3)
    out += [list(r2.tokens()), list(r3.tokens())]
    assert sched.engine.radix_stats()["hit_tokens"] == 34
    return out


def _multi_turn(sched):
    """Turn 2 resends turn 1, its reply and two tokens: the tree serves
    every full page of turn 1's written rows."""
    turn1 = list(range(1, 14))
    gen1 = list(sched.submit(turn1, 0.0, 0.9, 6, frozenset(), seed=0).tokens())
    before = sched.engine.radix_stats()["hit_tokens"]
    turn2 = turn1 + gen1 + [7, 8]
    gen2 = list(sched.submit(turn2, 0.0, 0.9, 4, frozenset(), seed=0).tokens())
    saved = sched.engine.radix_stats()["hit_tokens"] - before
    assert saved == ((len(turn1) + len(gen1) - 1) // PAGE) * PAGE > 0
    return gen1, gen2


def _eviction(sched):
    """A pool of 8 pages: two finished prompts fill the tree, then a
    30-token prompt must evict tree leaves to be admitted."""
    outs = [list(sched.submit(list(range(base, base + 17)), 0.0, 0.9, 3, frozenset(),
                              seed=base).tokens()) for base in (1, 40)]
    assert sched.engine.radix_stats()["pages"] >= 4
    big = sched.submit(list(range(60, 90)), 0.0, 0.9, 4, frozenset(), seed=9)
    outs.append(list(big.tokens()))
    assert big.finish_reason == "length" and len(outs[-1]) == 4
    assert sched.engine.radix_stats()["evicted_pages"] >= 1
    return outs


SCRIPTS = {"shared_prompt": (dict(), _shared_prompt),
           "multi_turn": (dict(n_slots=2), _multi_turn),
           "eviction": (dict(n_slots=2, kv_pages=8), _eviction)}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_scheduler_equals_jax_with_the_tree_on(models, script):
    """Greedy ids, reused_prefix_tokens and radix_stats() equal the JAX
    scheduler's on the same request script, and the drain audits clean
    with the tree intact."""
    kw, run = SCRIPTS[script]
    out = []
    for make in (_jax_sched, _port_sched):
        sched = make(models, **kw)
        try:
            ids = run(sched)
            summary = sched.latency_summary()
            out.append((ids, summary["reused_prefix_tokens"], sched.engine.radix_stats()))
            report = sched.engine.pool.audit(raise_on_fail=False)
            assert report["ok"] and report["radix_pages"] == summary["radix"]["pages"]
        finally:
            sched.shutdown()
    assert out[1] == out[0]
