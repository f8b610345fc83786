"""The continuous-batching engine against the JAX package on one tiny f32
model (weights from a seed, carried across with convert.params_from_numpy):
the paged forward (logits within 1e-4 of max|logit|, equal argmax; paged and
dense bit-equal in the port), the PagePool allocator under one seeded
sequence of operations (tables, refcounts and free list equal after each),
and BatchEngine greedy and penalized-greedy token ids, dense and paged at
page 8, across staggered joins, a release with slot reuse and a per-row
freeze at the context edge (identical). Port only: the counter-based
generator (Philox known answers, advance(n) equals n draws) and a seeded
request's sampled stream, independent of its batch-mates."""

import numpy as np
import pytest
import torch

from dllama_tpu_torch.convert import paged_cache_from_numpy, params_from_numpy
from dllama_tpu_torch.engine.batch import BatchEngine, PagePool, PoolAuditError, _sample_rows
from dllama_tpu_torch.engine.sampling import CounterRNG, philox4x32, sample_logits
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.models.llama import KVCache, forward
from dllama_tpu_torch.ops.layers import build_rope_cache

torch.set_num_threads(1)

KW = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=96,
          seq_len=64)
CFG = LlamaConfig(**KW)


@pytest.fixture(scope="module")
def models():
    import jax
    import jax.numpy as jnp

    from dllama_tpu.models.config import LlamaConfig as JaxConfig
    from dllama_tpu.models.llama import random_params

    jcfg = JaxConfig(**KW)
    jparams = random_params(jcfg, seed=9, dtype=jnp.float32, quantize=False)
    return jcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


def test_paged_forward_matches_jax_and_dense(models):
    import jax.numpy as jnp

    from dllama_tpu.models.llama import PagedKVCache as JaxPaged
    from dllama_tpu.models.llama import forward as jax_forward
    from dllama_tpu.ops.layers import build_rope_cache as jax_rope

    jcfg, jparams, params = models
    rng = np.random.default_rng(4)
    page, nb = 8, 8
    jcache = JaxPaged.create(jcfg, 2, 2 * nb, page, jnp.float32, nb)
    tables = rng.permutation(2 * nb).reshape(2, nb).astype(np.int32)
    jcache = JaxPaged(jcache.k, jcache.v, jnp.asarray(tables))
    cache = paged_cache_from_numpy(
        {"k": np.asarray(jcache.k), "v": np.asarray(jcache.v), "tables": tables})
    dense = KVCache.create(CFG, 2, torch.float32)
    rope, jrope = build_rope_cache(CFG), jax_rope(jcfg)
    toks = rng.integers(0, KW["vocab_size"], (2, 6))
    pos = np.array([0, 11], np.int32)
    steps = [(toks[:, :5], pos), (toks[:, 5:6], pos + 5)]
    for t, p in steps:
        want, jcache = jax_forward(jcfg, jparams, jnp.asarray(t, jnp.int32),
                                   jnp.asarray(p), jcache, jrope)
        got, _ = forward(CFG, params, torch.from_numpy(t), torch.from_numpy(p), cache, rope)
        got_dense, _ = forward(CFG, params, torch.from_numpy(t), torch.from_numpy(p), dense,
                               rope)
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
        np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
        assert torch.equal(got, got_dense)  # paged is bit-exact against dense
    np.testing.assert_array_equal(cache.tables.numpy(), tables)


def test_page_pool_matches_jax():
    from dllama_tpu.engine.batch import PagePool as JaxPool

    rng = np.random.default_rng(7)
    pools = [PagePool(9, 4, 3, 8), JaxPool(9, 4, 3, 8)]
    copies = [[], []]
    pools[0].audit_on_release = True
    # a scripted start (a partial-page share, a copy-on-write split, a grow
    # the pool cannot cover), then seeded random operations
    script = [(0, 0, 1, 10, False), (2, 1, 0, 10, False), (3, 0, 1, 0, False),
              (0, 2, 0, 32, False)]
    for _ in range(60):
        slot, other = rng.choice(3, 2, replace=False)
        script.append((int(rng.integers(0, 5)), int(slot), int(other),
                       int(rng.integers(0, 32)), bool(rng.integers(0, 2))))
    for op, slot, other, rows, best_effort in script:
        for pool, log in zip(pools, copies):
            def copy_fn(src, dst, log=log):
                log.append((src, dst))
            try:
                if op == 0:
                    pool.grow(slot, rows, best_effort=best_effort)
                elif op == 1:
                    pool.free_tail(slot, rows)
                elif op == 2 and pool.n_blocks[other] * 4 >= rows:
                    pool.share_prefix(other, slot, rows, copy_fn)
                elif op == 3:
                    pool.cow_writable(slot, rows, rows + 5, copy_fn)
                else:
                    pool.free_tail(slot, 0)  # a release
            except Exception as e:  # both must refuse the same operation
                log.append(type(e).__name__)
        a, b = pools
        np.testing.assert_array_equal(a.tables, b.tables)
        np.testing.assert_array_equal(a.n_blocks, b.n_blocks)
        np.testing.assert_array_equal(a.refcount, b.refcount)
        assert a._free == b._free and copies[0] == copies[1]
        assert a.audit()["ok"]
        assert a.stats() == {k: v for k, v in b.stats().items() if k in a.stats()}
    assert any(isinstance(c, tuple) for c in copies[0])  # copy-on-write ran
    assert "PageExhausted" in copies[0]  # and the pool ran dry
    a.grow(0, 4)
    a.refcount[a.tables[0, 0]] += 1  # a corrupted refcount is caught
    with pytest.raises(PoolAuditError):
        a.audit()


def _run_script(engine):
    """Staggered joins, penalized greedy, a release with slot reuse, and a
    slot frozen at the context edge (seq_len 64) while its batch-mates run.
    Few distinct chunk widths: each costs the JAX engine a compile."""
    out = [engine.add(0, [1, 2, 3, 4], temperature=0.0)]
    out.append(engine.decode(4).tolist())
    out.append(engine.add(2, [9, 8, 7, 6, 5, 4, 3, 2], temperature=0.0, presence=0.5,
                          frequency=0.3))
    out.append(engine.decode(4).tolist())
    engine.release(0, int(engine.pos[0]))
    out.append(engine.add(0, [1, 2, 3, 5], temperature=0.0))
    out.append(engine.add(1, list(range(3, 63)), temperature=0.0))  # 60 rows of 64
    out.append(engine.decode(4).tolist())
    out.append(engine.decode(4).tolist())  # slot 1 is frozen for all of it
    out.append([int(p) for p in engine.pos])
    return out


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_batch_engine_greedy_matches_jax(models, layout):
    import jax.numpy as jnp

    from dllama_tpu.engine.batch import BatchEngine as JaxEngine

    jcfg, jparams, params = models
    want = _run_script(JaxEngine(jcfg, jparams, n_slots=3, cache_dtype=jnp.float32,
                                 kv_layout=layout, page_size=8, radix_cache="off"))
    eng = BatchEngine(CFG, params, n_slots=3, cache_dtype=torch.float32, kv_layout=layout,
                      page_size=8)
    if eng.pool is not None:
        eng.pool.audit_on_release = True
    assert eng.attn_route == ("paged_gather" if layout == "paged" else "torch")
    got = _run_script(eng)
    assert got == want
    last = got[-3][-1][1]
    assert [row[1] for row in got[-2]] == [last] * 4 and got[-1][1] == 64  # frozen


def test_counter_rng_known_answers_and_replay():
    def t(x):
        return torch.tensor([x], dtype=torch.int64)

    # Random123's known-answer vector for philox4x32-10
    words = philox4x32(tuple(t(x) for x in (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344)),
                       (t(0xA4093822), t(0x299F31D0)))
    assert [int(w) for w in words] == [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]
    rng = CounterRNG(3, "cpu")
    for row, seed in enumerate((1, 2**40 + 5, 2**62 + 3)):
        rng.reset(row, seed)
    bulk = rng.uniforms(6)
    one_by_one = []
    for _ in range(6):
        one_by_one.append(rng.uniforms(1)[0])
        rng.advance(1)
    assert torch.equal(torch.stack(one_by_one), bulk)
    replay = CounterRNG(3, "cpu")
    for row, seed in enumerate((1, 2**40 + 5, 2**62 + 3)):
        replay.reset(row, seed)
    replay.advance(4)  # advance(n) == n draws
    assert torch.equal(replay.uniforms(1)[0], bulk[4])
    assert ((bulk >= 0) & (bulk < 1)).all() and bulk.dtype == torch.float32


def test_sampled_stream_independent_of_batch_mates(models):
    _, _, params = models

    def stream(mates):
        eng = BatchEngine(CFG, params, n_slots=3, cache_dtype=torch.float32, kv_layout="paged",
                          page_size=8, seed=123)
        for slot, prompt in mates:
            eng.add(slot, prompt, temperature=1.1, topp=0.95)
        first = eng.add(1, [5, 6, 7, 8], temperature=0.9, topp=0.8, seed=77)
        toks = eng.decode(10)[:, 1].tolist()
        assert int(eng.rng.counter[1]) == 1 + 10  # one draw per token
        return [first] + toks

    alone = stream([])
    assert stream([(0, [40, 41, 42]), (2, [3] * 9)]) == alone
    assert stream([(2, [11, 12])]) == alone


def test_per_row_sampling_equals_row_by_row():
    """The per-row vectors of the batched sampler give each row what the
    scalar sampler gives it alone: greedy rows, plain temperature rows
    (top-p 1) and nucleus rows in one batch."""
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((5, 300)).astype(np.float32) * 3)
    temps = torch.tensor([0.0, 0.7, 1.0, 1.3, 0.9])
    topps = torch.tensor([0.9, 1.0, 0.5, 0.95, 0.0])
    u = torch.from_numpy(rng.random((5, 2)).astype(np.float32))
    got = _sample_rows(logits, u, temps, topps)
    want = [int(sample_logits(logits[i : i + 1], float(temps[i]), float(topps[i]),
                              uniforms=u[i : i + 1])[0]) for i in range(5)]
    assert got.tolist() == want
