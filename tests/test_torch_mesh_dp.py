"""The port's dp mesh axis (replicas over the batch) against the JAX
package's dp mesh, on the CPU: a dp=2 and a dp=2 x tp=2 world (each rank
a process over gloo, module-scoped), the JAX side the test process's
virtual CPU devices with ``kernels="xla"``. The Q40 tree of
tests/test_torch_mesh.py, tiny shapes.

* ``resolve_mesh("auto")`` on 1, 2, 4 and 8 devices is JAX's
  auto_mesh_config (the rest of the cards on dp).
* The single engine (batch 1, replicated over dp) within TOL 3e-3 (JAX's
  tp bound) of JAX's engine on the same mesh and of the unsharded engine;
  a batch of 2 (divided over dp: each replica its row, the logits
  gathered) within the same bound of the unsharded engine's.
* A dense BatchEngine of 4 slots (2 a replica): greedy ids equal to JAX's
  sharded BatchEngine's and to the unsharded engine's.
* supports_hybrid, supports_cross_slot_copy and the spec refusal equal to
  JAX's on the same mesh.
* The Scheduler with phase-split admission: greedy, seeded sampled and
  penalized streams bit-equal to the unsharded engine's (dp moves no
  Philox stream), on 4 slots and on 3 (replicated over dp), with every
  rank's digest of its token results equal to rank 0's.
* Supervision: an ``engine.decode`` raise on 4 slots (2 a replica) gives
  one warm restart, whole streams equal to the uninterrupted run's, as on
  one device (tests/test_torch_mesh.supervision_case); a session of the
  single engine (batch 1, replicated) crosses both ways between the mesh
  and one device (session_case).
"""

import dataclasses
import re
import types

import numpy as np
import pytest
import torch

from dllama_tpu_torch.convert import params_from_numpy
from dllama_tpu_torch.engine.batch import BatchEngine
from dllama_tpu_torch.engine.engine import InferenceEngine
from dllama_tpu_torch.engine.loader import resolve_mesh
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.parallel import mesh as pmesh, multihost
from dllama_tpu_torch.serve.scheduler import Scheduler
from tests.test_torch_mesh import session_case, supervision_case

torch.set_num_threads(1)

KW = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
          seq_len=64)
TOL = 3e-3  # atol and rtol: JAX's own bound for a sharded engine (test_sharded_pallas.py)
PROMPT = [1, 5, 9, 33, 2, 7, 11, 4]


def jax_cfg():
    from dllama_tpu.models.config import LlamaConfig as JaxConfig

    return JaxConfig(**KW)


def jax_shardings(spec: str):
    from dllama_tpu.parallel.mesh import MeshConfig, make_mesh
    from dllama_tpu.parallel.sharding import LlamaShardings

    return LlamaShardings(make_mesh(MeshConfig.parse(spec)), jax_cfg())


def steps(eng, n_decode=2):
    """[prefill logits, decode logits...] of PROMPT, each the argmax fed."""
    eng.reset(0)
    out = [np.asarray(eng.prefill(np.asarray([PROMPT])), np.float32).reshape(-1)]
    for _ in range(n_decode):
        tok = int(np.argmax(out[-1]))
        out.append(np.asarray(eng.decode_step(np.array([[tok]])), np.float32).reshape(-1))
    return out


def close_all(a, b):
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, atol=TOL, rtol=TOL)


def test_resolve_mesh_auto_equals_jax_auto_mesh_config():
    from dllama_tpu.parallel.mesh import auto_mesh_config as jax_auto

    for n in (1, 2, 4, 8):
        for kv in (1, 2, 4, 8):
            cfg = LlamaConfig(**dict(KW, n_heads=8, n_kv_heads=kv))
            got = resolve_mesh("auto", cfg, "cpu", devices=["cpu"] * n)
            want = jax_auto(n, kv)
            if want.n_devices == 1:
                assert got is None, (n, kv)
            else:
                assert dataclasses.astuple(got) == dataclasses.astuple(want), (n, kv)


@pytest.fixture(scope="module")
def tree():
    import jax
    import jax.numpy as jnp

    from dllama_tpu.models.llama import random_params

    jp = random_params(jax_cfg(), seed=7, dtype=jnp.float32, quantize=True)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module", params=["dp=2", "dp=2,tp=2"])
def world(request, tree, tmp_path_factory):
    w = multihost.launch_tree(LlamaConfig(**KW), tree[1], pmesh.MeshConfig.parse(request.param),
                              str(tmp_path_factory.mktemp("dp")), cache_dtype=torch.float32)
    yield types.SimpleNamespace(world=w, eng=w.engine, spec=request.param)
    w.close()


def test_dp_engine_matches_jax_and_one_device(world, tree):
    import jax.numpy as jnp

    from dllama_tpu.engine.engine import InferenceEngine as JaxEngine

    eng = world.eng
    assert eng.block == (0, 1) and eng.cache.k.shape[1] == 1  # batch 1: replicated
    got = steps(eng)
    close_all(got, steps(JaxEngine(jax_cfg(), tree[0], cache_dtype=jnp.float32, kernels="xla",
                                   shardings=jax_shardings(world.spec))))
    close_all(got, steps(InferenceEngine(LlamaConfig(**KW), tree[1],
                                         cache_dtype=torch.float32)))


def test_a_divided_batch_gathers_its_rows(world, tree):
    """batch 2 on dp=2: each replica holds and runs one row, the logits are
    all-gathered over dp, and every rank holds the whole batch's."""
    eng = world.world.make("engine", batch=2, cache_dtype=torch.float32)
    one = InferenceEngine(LlamaConfig(**KW), tree[1], batch=2, cache_dtype=torch.float32)
    assert eng.block == (0, 1) and eng.cache.k.shape[1] == 1
    rows = np.asarray([PROMPT, PROMPT[::-1]])
    for e in (eng, one):
        e.reset(0)
    a, b = eng.prefill(rows), one.prefill(rows)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=TOL)
    nxt = np.argmax(b.numpy(), axis=-1)[:, None]
    np.testing.assert_allclose(eng.decode_step(nxt).numpy(), one.decode_step(nxt).numpy(),
                               atol=TOL, rtol=TOL)
    assert "dp:all-gather" in eng.measured_collective_report()["per_op"]


def _batch_ids(eng):
    prompts = [PROMPT, [9, 8, 7], list(range(3, 20)), [2, 4, 6, 8, 10]]
    first = [eng.add(s, p, temperature=0.0, seed=123 + s) for s, p in enumerate(prompts)]
    toks = eng.decode(6)
    return [[f] + [int(t) for t in toks[:, s]] for s, f in enumerate(first)]


def test_dp_batch_engine_matches_jax_sharded(world, tree):
    import jax.numpy as jnp

    from dllama_tpu.engine.batch import BatchEngine as JaxBatch

    be = world.world.make("batch", n_slots=4, cache_dtype=torch.float32)
    assert be.kv_layout == "dense" and be.cache.k.shape[1] == 2  # 2 slots a replica
    jeng = JaxBatch(jax_cfg(), tree[0], n_slots=4, cache_dtype=jnp.float32, kernels="xla",
                    shardings=jax_shardings(world.spec))
    one = BatchEngine(LlamaConfig(**KW), tree[1], n_slots=4, cache_dtype=torch.float32)
    assert _batch_ids(be) == _batch_ids(jeng) == _batch_ids(one)


def test_gates_equal_jax(world, tree):
    import jax.numpy as jnp

    from dllama_tpu.engine.batch import BatchEngine as JaxBatch

    jeng = JaxBatch(jax_cfg(), tree[0], n_slots=4, cache_dtype=jnp.float32, kernels="xla",
                    shardings=jax_shardings(world.spec))
    be = world.world.make("batch", n_slots=4, cache_dtype=torch.float32)
    assert (be.supports_hybrid, be.supports_cross_slot_copy) == \
        (jeng.supports_hybrid, jeng.supports_cross_slot_copy) == (False, False)
    with pytest.raises(ValueError) as jax_err:
        JaxBatch(jax_cfg(), tree[0], n_slots=4, cache_dtype=jnp.float32, kernels="xla",
                 shardings=jax_shardings(world.spec), spec=2)
    with pytest.raises(ValueError, match=re.escape(str(jax_err.value))):
        world.world.make("batch", n_slots=4, cache_dtype=torch.float32, spec=2)
    with pytest.raises(ValueError, match="crosses dp shards"):
        be.copy_prefix_rows(0, 1, 4)
    assert len(set(world.world.call_all("rank_digest"))) == 1  # still in step


def _workload(sched):
    reqs = [sched.submit(PROMPT * 3, 0.0, 0.9, 14, frozenset(), seed=1),
            sched.submit([9, 8, 7], 0.9, 0.9, 10, frozenset(), seed=2),
            sched.submit(list(range(3, 40)), 0.0, 0.9, 8, frozenset(), seed=3),
            sched.submit(list(range(5, 20)), 1.0, 0.8, 12, frozenset(), seed=4,
                         presence=0.5, frequency=0.3),
            sched.submit([4, 4, 2, 9], 0.7, 0.95, 9, frozenset(), seed=5)]
    try:
        return [list(r.tokens()) for r in reqs]
    finally:
        sched.shutdown()


@pytest.mark.parametrize("n_slots", [4, 3])
def test_scheduler_streams_bit_equal_to_one_device(world, tree, n_slots):
    """Phase-split admission (prefill_budget 0 on both sides) of greedy,
    seeded sampled and penalized requests: the streams are the unsharded
    engine's, token for token. 3 slots do not divide over dp=2, so every
    replica holds all three."""
    be = world.world.make("batch", n_slots=n_slots, cache_dtype=torch.float32)
    assert be.block == ((0, n_slots) if n_slots == 3 else (0, 2))
    before = world.world.call_all("rank_digest")
    got = _workload(Scheduler(be, prefill_budget=0))
    want = _workload(Scheduler(BatchEngine(LlamaConfig(**KW), tree[1], n_slots=n_slots,
                                           cache_dtype=torch.float32), prefill_budget=0))
    assert got == want and all(len(s) for s in got)
    after = world.world.call_all("rank_digest")
    assert len(set(after)) == 1 and after != before


def test_a_decode_fault_gives_one_warm_restart_on_dp(world, tree):
    """engine.decode raises on every rank at the same dispatch; each
    replica refills its block of the slots in place."""
    supervision_case(world.world, tree[1], tree[0], "engine.decode", n_slots=4)


def test_a_session_crosses_between_dp_and_one_device(world, tree, tmp_path):
    one = InferenceEngine(LlamaConfig(**KW), tree[1], cache_dtype=torch.float32)
    session_case(world.world, one, tmp_path, PROMPT, 24, TOL)
