"""The port's host-RAM KV spill tier (``engine/batch.HostKVPool``,
``--kv-host-pages``) against the JAX package's.

* Spill and restore are bit-exact: radix eviction copies every tree page
  of a finished request into the host slab, a returning prompt copies
  them back, and the pool pages after the round trip equal the pages
  before it, byte for byte; the same request then repeats its stream
  through the restored pages.
* The audit catches a leaked host page (a slab row neither free nor held),
  an unaligned key and a row held twice.
* On one script (a prompt, a full eviction, the prompt again, then a tier
  smaller than the tree), the tier's spilled / restored / dropped counts
  and the tree's stats equal the JAX engine's, and no spill is discarded.

The tiny configuration is the JAX test's (``tests/test_paged_kv.py``): dim
64, 2 layers, 4/2 heads, context 64, page 8, a pool of 12 pages.
"""

import numpy as np
import pytest
import torch

from dllama_tpu_torch.convert import params_from_numpy
from dllama_tpu_torch.engine.batch import BatchEngine, PoolAuditError
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.serve.scheduler import Scheduler

torch.set_num_threads(1)

KW = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=96,
          seq_len=64)
CFG = LlamaConfig(**KW)
PAGE = 8
PROMPT = list(range(1, 18))  # 17 tokens: 2 full pages of 8


@pytest.fixture(scope="module")
def models():
    import jax
    import jax.numpy as jnp

    from dllama_tpu.models.config import LlamaConfig as JaxConfig
    from dllama_tpu.models.llama import random_params

    jcfg = JaxConfig(**KW)
    jparams = random_params(jcfg, seed=3, dtype=jnp.float32, quantize=False)
    return jcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


def _engine(params, kv_pages=12, host_pages=6, n_slots=3):
    eng = BatchEngine(CFG, params, n_slots=n_slots, cache_dtype=torch.float32,
                      kv_layout="paged", page_size=PAGE, kv_pages=kv_pages,
                      radix_cache="on", kv_host_pages=host_pages)
    eng.pool.audit_on_release = True
    return eng


def _tree_page_map(radix) -> dict:
    """{absolute token path through each page: pool page} of every page
    the tree references."""
    out = {}

    def walk(node, prefix):
        for ch in node.children.values():
            full = prefix + tuple(ch.tokens)
            for i, p in enumerate(ch.pages):
                out[full[:len(prefix) + (i + 1) * PAGE]] = p
            walk(ch, full)

    walk(radix.root, ())
    return out


def test_spill_restore_bit_exact(models):
    eng = _engine(models[2])
    sched = Scheduler(eng, overlap=False)
    try:
        out1 = list(sched.submit(PROMPT, 0.0, 0.9, 6, frozenset(), seed=1).tokens())
        before = {path: eng.read_page(p) for path, p in _tree_page_map(eng.radix).items()}
        assert len(before) == 2
        host = eng.pool.host
        assert eng.radix_evict(100) >= len(before)
        assert host.used == host.stats()["spilled"] == len(before)
        for path, (k, v) in before.items():  # the slab holds the pages' bytes
            hk, hv = host.read(path)
            assert torch.equal(hk, k) and torch.equal(hv, v)
        assert eng.pool.audit()["ok"]
        rows, _ = eng.radix_lookup(PROMPT)  # restores every full page
        assert rows == ((len(PROMPT) - 1) // PAGE) * PAGE == 16
        assert host.used == 0 and host.stats()["restored"] == len(before)
        after = _tree_page_map(eng.radix)
        assert set(after) == set(before)
        for path, p in after.items():
            k, v = eng.read_page(p)
            assert torch.equal(k, before[path][0]) and torch.equal(v, before[path][1])
        assert eng.pool.audit()["ok"]
        # the same request repeats its stream through the restored pages
        assert list(sched.submit(PROMPT, 0.0, 0.9, 6, frozenset(), seed=1).tokens()) == out1
        assert host.stats()["discarded"] == 0
    finally:
        sched.shutdown()
    assert eng.pool.audit()["ok"]


def test_audit_catches_a_leaked_host_page(models):
    eng = _engine(models[2])
    host = eng.pool.host
    assert eng.pool.audit()["ok"] and eng.pool.audit()["host"]["used"] == 0
    row = host._free.pop()  # a leaked row: neither free nor held
    with pytest.raises(PoolAuditError):
        eng.pool.audit()
    report = eng.pool.audit(raise_on_fail=False)
    assert not report["ok"] and any("leaked host pages" in p for p in report["problems"])
    host._entries[(1, 2, 3)] = (row, None)  # held again, under an unaligned key
    report = eng.pool.audit(raise_on_fail=False)
    assert any("not page-aligned" in p for p in report["problems"])
    host._free.append(row)  # now held AND free
    report = eng.pool.audit(raise_on_fail=False)
    assert any("held twice" in p for p in report["problems"])
    del host._entries[(1, 2, 3)]
    assert eng.pool.audit()["ok"]


def _script(eng, submit):
    """A prompt, a full eviction (spills), the prompt again (restores), two
    other prompts, then an eviction into a tier too small to keep them all
    (the tier's own LRU drops). Returns the tier's and the tree's counts
    after each step and the greedy ids."""
    host = eng.pool.host
    rec = []
    ids = [submit(PROMPT)]
    for step in ("evict", "again", "fill", "evict"):
        if step == "evict":
            eng.radix_evict(100)
        elif step == "again":
            ids.append(submit(PROMPT))
        else:
            ids += [submit([50 + i for i in range(17)]), submit([70 + i for i in range(17)])]
        st = host.stats()
        rec.append((step, {k: st[k] for k in ("used", "spilled", "restored", "dropped")},
                    eng.radix_stats()))
    return ids, rec


def test_spill_and_restore_counts_equal_jax(models):
    import jax.numpy as jnp

    from dllama_tpu.engine.batch import BatchEngine as JaxEngine
    from dllama_tpu.serve.scheduler import Scheduler as JaxScheduler

    jcfg, jparams, params = models
    jeng = JaxEngine(jcfg, jparams, n_slots=3, cache_dtype=jnp.float32, kv_layout="paged",
                     page_size=PAGE, kv_pages=12, radix_cache="on", kv_host_pages=5)
    out = []
    for eng, sched in ((jeng, JaxScheduler(jeng, chunk=4, overlap=False)),
                       (None, None)):
        if eng is None:
            eng = _engine(params, host_pages=5)
            sched = Scheduler(eng, overlap=False)
        try:
            out.append(_script(eng, lambda p, s=sched: list(
                s.submit(p, 0.0, 0.9, 6, frozenset(), seed=1).tokens())))
            assert eng.pool.audit()["ok"]
        finally:
            sched.shutdown()
    assert out[1] == out[0]
    rec = out[1][1]
    assert rec[0][1]["spilled"] == 2 and rec[1][1]["restored"] == 2
    assert rec[-1][1]["dropped"] > 0  # 6 tree pages spilled into 5 host slots
    assert eng.pool.host.stats()["discarded"] == 0
