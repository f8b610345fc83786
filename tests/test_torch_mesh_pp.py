"""The port's pp mesh axis (GPipe stages over the layers,
``parallel/pipeline``) against the JAX package's pipeline, on the CPU: a
pp=2 and a tp=2 x pp=2 world (each rank a process over gloo, loaded
through ``load_model`` from one Q40 file, module-scoped), the JAX side the
test process's virtual CPU devices. Shapes of tests/test_pipeline.py's
loader case: dim 128, hidden 256, 4 layers, 8/4 heads, vocab 128, seq 64.

* The prefill logits and one decode step after it within 2e-4 (JAX's Q40
  bound for make_pp_forward, tests/test_pipeline.py) of JAX's
  make_pp_forward on the same mesh, and within 2e-3/1e-2 (its loader
  bound) of JAX's load_model on the same mesh; each stage's cache within
  2e-4 of JAX's cache at that stage's layers and kv heads. With tp the
  bf16 partial sums are reduced over tp where JAX's pipeline replicates
  the weights over tp: 3e-3 there (JAX's bound for a tp engine).
* pure pp=2 bit-equal to the port's unsharded plain path (the same layers
  in the same order; the hop and the broadcast move f32 bits); greedy ids
  equal on the mesh, on the unsharded engine and on JAX.
* pp_micro=2 at batch 2 within 2e-4/1e-3 of pp_micro=1; batch 3 raises
  JAX's message; so do n_layers % pp, pp x sp, --sync q80 with tp on pp
  and a BatchEngine on pp.
* Each stage loads only its layers (shard-direct) and one decode step's
  exchange is the bytes of its shapes.
* The CLI: ``inference --mesh pp=2`` prints the unsharded engine's text;
  ``serve --slots 2 --mesh pp=2`` exits 1 with JAX's BatchEngine message.
* A session crosses both ways between the mesh and one device
  (tests/test_torch_mesh.session_case): pure pp=2 writes one device's
  cache bytes, tp=2 x pp=2 within 3e-3.
"""

import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from dllama_tpu_torch.engine.loader import load_model
from dllama_tpu_torch.engine.sampling import Sampler
from dllama_tpu_torch.models import formats
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.ops.quant import FloatType
from tests.test_torch_mesh import session_case

torch.set_num_threads(1)

KW = dict(dim=128, hidden_dim=256, n_layers=4, n_heads=8, n_kv_heads=4, vocab_size=128,
          seq_len=64)
PP_TOL = dict(atol=2e-4, rtol=2e-4)  # JAX's Q40 bound for make_pp_forward
TP_TOL = dict(atol=3e-3, rtol=3e-3)  # JAX's bound for a tp engine (test_sharded_pallas.py)
LOADER_TOL = dict(atol=2e-3, rtol=1e-2)  # JAX's bound through load_model
PROMPT = [5, 9, 2, 7, 1, 3]
NEXT = 11


def jax_cfg():
    from dllama_tpu.models.config import LlamaConfig as JaxConfig

    return JaxConfig(**KW, weight_type=FloatType.Q40)


def jax_mesh(spec: str):
    from dllama_tpu.parallel.mesh import MeshConfig, make_mesh

    return make_mesh(MeshConfig.parse(spec))


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The Q40 file (test_pipeline.py's recipe, seed 1) and the JAX
    package's unsharded load of it."""
    import jax.numpy as jnp

    from dllama_tpu.engine.loader import load_model as jax_load

    cfg = LlamaConfig(**KW, weight_type=FloatType.Q40)
    rng = np.random.default_rng(1)
    tensors = {n: (rng.standard_normal(s) * 0.05).astype(np.float32)
               for n, s, _ in formats.tensor_plan(cfg)}
    path = str(tmp_path_factory.mktemp("pp") / "tiny.m")
    formats.save_model(path, cfg, tensors)
    return types.SimpleNamespace(path=path, cfg=cfg,
                                 jax=jax_load(path, mesh=None, cache_dtype=jnp.float32))


@pytest.fixture(scope="module")
def one(model):
    return load_model(model.path, mesh=None, cache_dtype=torch.float32, device="cpu").engine


def steps(eng) -> list:
    """[prefill logits, the decode step's after it, fed NEXT], flat f32."""
    eng.reset(0)
    out = [np.asarray(eng.prefill(np.asarray([PROMPT])), np.float32).reshape(-1)]
    out.append(np.asarray(eng.decode_step(np.array([[NEXT]])), np.float32).reshape(-1))
    return out


def jax_pipeline(model, spec: str):
    """JAX's make_pp_forward on `spec`'s mesh over the file's params: the
    last position's logits of the prefill and of the decode step, and the
    cache after both."""
    import jax
    import jax.numpy as jnp

    from dllama_tpu.models.llama import KVCache
    from dllama_tpu.ops.layers import build_rope_cache
    from dllama_tpu.parallel.pipeline import make_pp_forward, put_pp

    cfg, mesh = jax_cfg(), jax_mesh(spec)
    params, cache = put_pp(model.jax.engine.params, KVCache.create(cfg, 1, jnp.float32), mesh)
    fn = jax.jit(make_pp_forward(cfg, mesh, n_micro=1))
    rope = build_rope_cache(cfg)
    a, cache = fn(params, jnp.asarray([PROMPT], jnp.int32), jnp.int32(0), cache, rope)
    b, cache = fn(params, jnp.asarray([[NEXT]], jnp.int32), jnp.int32(len(PROMPT)), cache, rope)
    logits = [np.asarray(x, np.float32)[0, -1] for x in (a, b)]
    return logits, (np.asarray(cache.k), np.asarray(cache.v))


@pytest.fixture(scope="module", params=["pp=2", "tp=2,pp=2"])
def world(request, model):
    """The mesh's world through load_model, JAX's load_model on the same
    mesh, and ``steps`` of both taken first, with each rank's cache."""
    import jax.numpy as jnp

    from dllama_tpu.engine.loader import load_model as jax_load

    m = load_model(model.path, mesh=request.param, cache_dtype=torch.float32, device="cpu")
    jm = jax_load(model.path, mesh=request.param, cache_dtype=jnp.float32)
    got = steps(m.engine)
    yield types.SimpleNamespace(
        m=m, eng=m.engine, world=m.world, spec=request.param, config=m.world.mesh.config,
        jax=jm.engine, got=got, want=steps(jm.engine), caches=m.world.call_all("rank_cache"),
        report=m.engine.measured_collective_report())
    m.world.close()


def test_pp_logits_and_caches_match_jax(world, model):
    assert world.eng.programs.capture is False  # pp programs run eagerly
    pipe, (jk, jv) = jax_pipeline(model, world.spec)
    pp, tp = world.config.pp, world.config.tp
    tol = PP_TOL if tp == 1 else TP_TOL
    for x, y, z in zip(world.got, pipe, world.want):
        np.testing.assert_allclose(x, y, **tol)
        np.testing.assert_allclose(x, z, **LOADER_TOL)
    layers, hkv = KW["n_layers"] // pp, KW["n_kv_heads"] // tp
    rows = len(PROMPT) + 1
    for r in world.caches:
        c = r["coords"]
        l0, h0 = c["pp"] * layers, c["tp"] * hkv
        for got, want in ((r["k"], jk), (r["v"], jv)):
            got = got.numpy()
            assert got.shape[0] == layers
            np.testing.assert_allclose(got[:, :, :, :rows],
                                       want[l0 : l0 + layers, :, h0 : h0 + hkv, :rows],
                                       **tol)
            assert not got[:, :, :, rows:].any()


def test_pp_against_the_unsharded_port(world, one):
    """Pure pp runs the unsharded path's layers in the same order and moves
    f32 bits between stages: bit-equal. With tp its sums split."""
    for x, y in zip(world.got, steps(one)):
        if world.config.tp == 1:
            np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(x, y, **TP_TOL)


def test_pp_greedy_ids_equal(world, one, model):
    """Greedy ids of a 10-token continuation: the mesh's, the unsharded
    port's and the JAX package's (its unsharded engine over the file)."""
    from dllama_tpu.engine.sampling import Sampler as JaxSampler

    def ids(eng, sampler):
        eng.reset(0)
        return [int(t) for t in eng.generate(PROMPT, 10, sampler)]

    got = ids(world.eng, Sampler(0.0, 0.9, 1))
    assert got == ids(one, Sampler(0.0, 0.9, 1)) == \
        ids(model.jax.engine, JaxSampler(0.0, 0.9, 1))
    assert len(set(world.world.call_all("rank_digest"))) == 1


def test_pp_micro_batches(world, model):
    """pp_micro=2 at batch 2 within 2e-4/1e-3 of pp_micro=1
    (test_pipeline.py:172-193); batch 3 raises JAX's message, from rank 0
    before anything is sent (the world stays in step)."""
    import jax.numpy as jnp

    from dllama_tpu.engine.engine import InferenceEngine as JaxEngine
    from dllama_tpu.parallel.sharding import LlamaShardings as JaxShardings

    rows = np.asarray([[3, 1, 4, 1], [5, 9, 2, 6]])
    outs = []
    for micro in (1, 2):
        eng = world.world.make("engine", batch=2, pp_micro=micro, cache_dtype=torch.float32)
        outs.append(eng.step(rows).numpy())
        nxt = np.argmax(outs[-1], axis=-1)[:, None]
        outs.append(eng.decode_step(nxt).numpy())
    np.testing.assert_allclose(outs[0], outs[2], atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(outs[1], outs[3], atol=2e-4, rtol=1e-3)
    with pytest.raises(ValueError, match="divide") as jax_err:
        JaxEngine(jax_cfg(), model.jax.engine.params, batch=3, cache_dtype=jnp.float32,
                  shardings=JaxShardings(jax_mesh(world.spec), jax_cfg()), pp_micro=2)
    with pytest.raises(ValueError, match=re.escape(str(jax_err.value))):
        world.world.make("engine", batch=3, pp_micro=2, cache_dtype=torch.float32)
    assert len(set(world.world.call_all("rank_digest"))) == 1


@pytest.mark.parametrize("case", ["layers", "sp", "q80", "batch"])
def test_pp_refusals_raise_jax_messages(case, model):
    """n_layers % pp, pp x sp and --sync q80 with tp on pp are refused by
    load_model before a rank is spawned, and a BatchEngine on pp by its
    constructor, each with the JAX package's message."""
    import jax.numpy as jnp

    from dllama_tpu.engine.batch import BatchEngine as JaxBatch
    from dllama_tpu.engine.engine import InferenceEngine as JaxEngine
    from dllama_tpu.parallel.sharding import LlamaShardings as JaxShardings

    from dllama_tpu_torch.engine.batch import BatchEngine
    from dllama_tpu_torch.parallel import mesh as pmesh
    from dllama_tpu_torch.parallel.sharding import LlamaShardings

    spec, kw = {"layers": ("pp=3", {}), "sp": ("pp=2,sp=2", {}),
                "q80": ("tp=2,pp=2", {"sync": "q80"}), "batch": ("pp=2", {})}[case]
    jp = model.jax.engine.params
    with pytest.raises(ValueError) as jax_err:
        sh = JaxShardings(jax_mesh(spec), jax_cfg())
        if case == "batch":
            JaxBatch(jax_cfg(), jp, n_slots=2, cache_dtype=jnp.float32, shardings=sh)
        else:
            JaxEngine(jax_cfg(), jp, cache_dtype=jnp.float32, shardings=sh, **kw)
    msg = re.escape(str(jax_err.value))
    if case == "batch":
        sh = LlamaShardings(pmesh.Mesh(pmesh.MeshConfig.parse(spec)), model.cfg)
        with pytest.raises(ValueError, match=msg):
            BatchEngine(model.cfg, {}, n_slots=2, shardings=sh, device="cpu")
    else:
        with pytest.raises(ValueError, match=msg):
            load_model(model.path, mesh=spec, device="cpu", **kw)


def test_each_stage_loads_only_its_layers(world, model):
    """Shard-direct: a stage's layer leaves are n_layers // pp deep, and
    each rank decodes off the memmap only its layers' Q40 records (its tp
    shard of them) and its shard of wcls."""
    pp, tp = world.config.pp, world.config.tp
    lay = world.eng.params["layers"]
    assert {tuple(v.shape)[0] for v in lay.values()} == {KW["n_layers"] // pp}
    assert world.eng.cfg.n_layers == KW["n_layers"] // pp
    q40 = {n: FloatType.Q40.nbytes(int(np.prod(s))) for n, s, ft in
           formats.tensor_plan(model.cfg) if ft == FloatType.Q40}
    layer_bytes = sum(v for n, v in q40.items() if n.startswith("layers."))
    want = layer_bytes // (pp * tp) + q40["wcls"] // tp
    assert [r["lazy_decode_bytes"] for r in world.world.call_all("rank_report")] == \
        [want] * world.config.n_devices


def test_pp_decode_step_bytes_equal_the_shapes(world):
    """Rank 0 is stage 0: one decode step's exchange on it is its stage's
    tp all-reduces (wo and w2 a layer), the activation it sends to stage 1
    and the f32 logits broadcast from the last stage."""
    d, v = KW["dim"], KW["vocab_size"]
    x = world.eng.params["embedding"].element_size()
    want = {"pp:send": d * x, "pp:broadcast": v * 4}
    if world.config.tp > 1:
        want["all-reduce"] = 2 * (KW["n_layers"] // world.config.pp) * d * x
    assert world.report["per_op"] == want


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*argv, timeout=120):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "dllama_tpu_torch", *argv], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("mode", ["inference", "serve"])
def test_cli_on_pp(mode, tmp_path):
    """``inference --mesh pp=2`` prints the unsharded engine's greedy text
    of the golden fixture (2 layers, one a stage), as the CLI prints it;
    ``serve --slots 2 --mesh pp=2`` loads, then stops at the BatchEngine
    refusal with exit 1, the code of a load-time error."""
    from tests.test_golden import FIXTURE_M
    from tests.test_torch_isolation import _tokenizer

    tok_path = _tokenizer(tmp_path)
    argv = ["--model", FIXTURE_M, "--tokenizer", tok_path, "--device", "cpu"]
    if mode == "serve":
        out = _cli("serve", *argv, "--slots", "2", "--mesh", "pp=2")
        assert out.returncode == 1
        assert "BatchEngine supports tp/dp meshes (not sp/pp)" in out.stderr
        return
    got = _cli("inference", *argv, "--prompt", "hello there", "--steps", "8",
               "--temperature", "0", "--mesh", "pp=2", "--report")
    assert got.returncode == 0, got.stderr
    assert "'pp': 2" in got.stderr and "pp:send" in got.stderr
    m = load_model(FIXTURE_M, tok_path, mesh=None, device="cpu")
    tok = m.tokenizer
    tok.reset_decoder()
    ids = m.engine.generate(tok.encode("hello there", add_bos=True), 8, Sampler(0.0, 0.9, 0),
                            stop_fn=tok.is_eos)
    want = "".join(piece for piece in map(tok.decode, ids) if piece) + "\n"
    assert got.stdout == want and want.strip()


def test_a_session_crosses_between_pp_and_one_device(world, one, tmp_path):
    """Each stage's layers gathered to rank 0 make one device's file."""
    session_case(world.world, one, tmp_path, [1, 5, 9, 33, 2, 7, 11, 4], 24, 3e-3,
                 exact=world.spec == "pp=2")
