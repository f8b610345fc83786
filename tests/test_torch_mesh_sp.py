"""The port's sp mesh axis (the KV cache's sequence rows split over ranks,
ring attention; ``parallel/ring_attention``) against the JAX package's sp
mesh, on the CPU: an sp=2 and an sp=2 x tp=2 world (each rank a process
over gloo, module-scoped), the JAX side the test process's virtual CPU
devices. f32 weights, seq_len 64 (32 rows a rank), tiny shapes.

* The single engine: a 40-token prompt (its prefill crosses the 32-row
  shard boundary), two decode steps (the LSE merge), then a rewind to
  position 27 and a 6-token chunk that straddles the boundary (the ring),
  then a 3-token chunk (ragged: the LSE merge). Every logits row within
  atol 2e-4 and rtol 1e-3 (JAX's bound, tests/test_ring_attention.py) of
  JAX's engine on the same mesh and of the port's unsharded engine.
* Greedy ids of a 16-token continuation equal on all three.
* Each rank's cache rows within the same bound of the matching slice of
  JAX's cache (its kv heads, its sequence rows), and its rows past the
  last position exactly zero.
* BatchEngine raises on an sp mesh with JAX's message.
* A session crosses both ways between the mesh and one device
  (tests/test_torch_mesh.session_case), its 56 rows across the shard
  boundary: each rank's rows gathered without its trash row, the cache
  within JAX's bound.
"""

import re
import types

import numpy as np
import pytest
import torch

from dllama_tpu_torch.convert import params_from_numpy
from dllama_tpu_torch.engine.engine import InferenceEngine
from dllama_tpu_torch.engine.sampling import Sampler
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.parallel import mesh as pmesh, multihost
from tests.test_torch_mesh import session_case

torch.set_num_threads(1)

KW = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
          seq_len=64)
ATOL, RTOL = 2e-4, 1e-3  # JAX's bound for an sp engine (tests/test_ring_attention.py)
PROMPT = [int(t) for t in np.random.default_rng(11).integers(1, KW["vocab_size"], 40)]
CHUNKS = ([5, 9, 2, 7, 1, 3], [4, 8, 6])  # at positions 27 (straddles row 32) and 33


def jax_cfg():
    from dllama_tpu.models.config import LlamaConfig as JaxConfig

    return JaxConfig(**KW)


def jax_engine(jp, config):
    import jax.numpy as jnp

    from dllama_tpu.engine.engine import InferenceEngine as JaxEngine
    from dllama_tpu.parallel.mesh import make_mesh
    from dllama_tpu.parallel.sharding import LlamaShardings

    sh = None if config is None else LlamaShardings(make_mesh(config), jax_cfg())
    return JaxEngine(jax_cfg(), jp, cache_dtype=jnp.float32, shardings=sh)


def steps(eng) -> list:
    """Logits of the prefill, two decode steps, and the two chunks after a
    rewind to position 27."""
    eng.reset(0)
    out = [np.asarray(eng.prefill(np.asarray([PROMPT])), np.float32).reshape(-1)]
    for _ in range(2):
        tok = int(np.argmax(out[-1]))
        out.append(np.asarray(eng.decode_step(np.array([[tok]])), np.float32).reshape(-1))
    eng.reset(27)
    for chunk in CHUNKS:
        out.append(np.asarray(eng.step(np.asarray([chunk])), np.float32).reshape(-1))
    return out


def greedy(eng, n=16):
    eng.reset(0)
    return [int(t) for t in eng.generate(PROMPT, n, Sampler(0.0, 0.9, 1))]


def jax_greedy(eng, n=16):
    from dllama_tpu.engine.sampling import Sampler as JaxSampler

    eng.reset(0)
    return [int(t) for t in eng.generate(PROMPT, n, JaxSampler(0.0, 0.9, 1))]


@pytest.fixture(scope="module")
def tree():
    import jax
    import jax.numpy as jnp

    from dllama_tpu.models.llama import random_params

    jp = random_params(jax_cfg(), seed=3, dtype=jnp.float32, quantize=False)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def one(tree):
    return InferenceEngine(LlamaConfig(**KW), tree[1], cache_dtype=torch.float32)


@pytest.fixture(scope="module", params=["sp=2", "sp=2,tp=2"])
def world(request, tree, tmp_path_factory):
    """The world of the mesh, JAX's engine on the same mesh, and the logits
    and caches of ``steps`` on both, taken first, on fresh engines."""
    from dllama_tpu.parallel.mesh import MeshConfig as JaxMeshConfig

    config = pmesh.MeshConfig.parse(request.param)
    w = multihost.launch_tree(LlamaConfig(**KW), tree[1], config,
                              str(tmp_path_factory.mktemp("sp")), cache_dtype=torch.float32)
    jeng = jax_engine(tree[0], JaxMeshConfig.parse(request.param))
    got, want = steps(w.engine), steps(jeng)
    yield types.SimpleNamespace(world=w, eng=w.engine, config=config, jax=jeng, got=got,
                                want=want, caches=w.call_all("rank_cache"),
                                jax_cache=(np.asarray(jeng.cache.k), np.asarray(jeng.cache.v)))
    w.close()


def test_sp_engine_matches_jax_and_one_device(world, one):
    eng = world.eng
    assert eng.attn_route == "ring" and eng.programs.capture is False
    assert eng.cache.k.shape[3] == KW["seq_len"] // world.config.sp + 1  # + the trash row
    for x, y in zip(world.got, world.want):
        np.testing.assert_allclose(x, y, atol=ATOL, rtol=RTOL)
    for x, y in zip(world.got, steps(one)):
        np.testing.assert_allclose(x, y, atol=ATOL, rtol=RTOL)


def test_sp_engine_greedy_ids_equal(world, one):
    ids = greedy(world.eng)
    assert ids == jax_greedy(world.jax) == greedy(one)
    digests = world.world.call_all("rank_digest")
    assert len(set(digests)) == 1


def test_each_rank_holds_its_slice_of_jax_cache(world):
    """After ``steps`` on fresh engines, rank r's cache is JAX's cache at its
    kv heads (tp) and sequence rows (sp), and its rows past the last
    position written (the prefill's and the two decode steps'; the chunks
    rewrite rows 27..35) are still zero."""
    jk, jv = world.jax_cache
    tp, sp = world.config.tp, world.config.sp
    hkv, rows = KW["n_kv_heads"] // tp, KW["seq_len"] // sp
    written = len(PROMPT) + 2
    for r in world.caches:
        c = r["coords"]
        h0, s0 = c["tp"] * hkv, c["sp"] * rows
        clean = min(rows, max(0, written - s0))  # the first local row never written
        for got, want in ((r["k"], jk), (r["v"], jv)):
            got = got.numpy()[:, :, :, :rows]  # the trash row is never read
            np.testing.assert_allclose(got, want[:, :, h0 : h0 + hkv, s0 : s0 + rows],
                                       atol=ATOL, rtol=RTOL)
            assert got[:, :, :, :clean].any() and not got[:, :, :, clean:].any()


def test_batch_engine_refuses_sp_with_jax_message(world, tree):
    import jax.numpy as jnp

    from dllama_tpu.engine.batch import BatchEngine as JaxBatch
    from dllama_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
    from dllama_tpu.parallel.mesh import make_mesh
    from dllama_tpu.parallel.sharding import LlamaShardings

    sh = LlamaShardings(make_mesh(JaxMeshConfig(sp=world.config.sp, tp=world.config.tp)),
                        jax_cfg())
    with pytest.raises(ValueError) as jax_err:
        JaxBatch(jax_cfg(), tree[0], n_slots=2, cache_dtype=jnp.float32, shardings=sh)
    with pytest.raises(ValueError, match=re.escape(str(jax_err.value))):
        world.world.make("batch", n_slots=2, cache_dtype=torch.float32)
    # the refusal sent nothing: the world is still in step
    assert greedy(world.eng, 4) == greedy(world.eng, 4)
    assert len(set(world.world.call_all("rank_digest"))) == 1


def test_a_session_crosses_between_sp_and_one_device(world, one, tmp_path):
    session_case(world.world, one, tmp_path, [1, 5, 9, 33, 2, 7, 11, 4], 24, 2e-4, rtol=1e-3)
