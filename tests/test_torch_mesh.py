"""The port's tensor parallelism (``dllama_tpu_torch/parallel``) against the
JAX package's tp mesh, on the CPU: a tp=2 world is two processes over gloo
(``parallel/multihost.launch``), the JAX side the test process's 8 virtual
CPU devices with ``kernels="xla"``. Shapes are tiny (dim 64, 2 layers, 4/2
heads); each world is module-scoped and serves every check of its config.

* Pure parity, exact: MeshConfig.parse and auto_mesh_config over a grid,
  resolve_sync, the spec of every leaf (``_sanitize`` included) at tp=2
  and tp=4, collective_bytes_per_token, and LazyQ40 / LazyQ40Stack shard
  bytes bit-equal to JAX's for row and column slices.
* The tp=2 single engine against JAX's InferenceEngine on a tp=2 mesh and
  against the port's unsharded engine: prefill logits, then two decode
  steps, within atol/rtol 3e-3 (JAX's own bound, tests/test_sharded_pallas.py);
  greedy ids of a 16-token continuation equal. For a Q40 tree, a Q80 file
  (dense bf16 on a mesh, on both sides) and a tiny MoE tree.
* ``--sync q80`` against JAX's q80 path, within one Q80 step of the logits
  (see q80_tol).
* The tp=2 BatchEngine (dense, two slots) against JAX's sharded
  BatchEngine; hybrid admission and --spec-k 2 through the Scheduler equal
  to tp=1; sampled streams equal on rank 0 and rank 1.
* The measured collective bytes of one decode step equal the formula from
  the shapes, for bf16 and q80.
* The process model: an admission outlives any number of calls on the
  followers (300 hybrid steps), every rank holds the same named objects,
  and a follower that dies breaks the world instead of leaving it to hang.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from dllama_tpu_torch.convert import params_from_numpy
from dllama_tpu_torch.engine.batch import BatchEngine
from dllama_tpu_torch.engine.engine import InferenceEngine
from dllama_tpu_torch.engine.loader import load_model
from dllama_tpu_torch.engine.sampling import Sampler
from dllama_tpu_torch.models import formats
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.ops.quant import FloatType
from dllama_tpu_torch.parallel import collectives, mesh as pmesh, multihost, sharding
from dllama_tpu_torch.serve.scheduler import Scheduler
from dllama_tpu_torch.utils import profiling

torch.set_num_threads(1)

KW = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
          seq_len=64)
MOE_KW = dict(KW, hidden_dim=128, n_experts=4, n_active_experts=2)
WIDE = dict(dim=128, hidden_dim=256, n_layers=2, n_heads=4, n_kv_heads=4, seq_len=64)
TOL = 3e-3  # atol and rtol: JAX's own bound for a tp engine (test_sharded_pallas.py)
PROMPT = [1, 5, 9, 33, 2, 7, 11, 4]


def jax_cfg(**kw):
    from dllama_tpu.models.config import LlamaConfig as JaxConfig

    return JaxConfig(**kw)


def jax_tree(kw, seed=7):
    import jax
    import jax.numpy as jnp

    from dllama_tpu.models.llama import random_params

    jp = random_params(jax_cfg(**kw), seed=seed, dtype=jnp.float32, quantize=True)
    return jp, jax.tree.map(np.asarray, jp)


def jax_shardings(kw, tp=2):
    from dllama_tpu.parallel.mesh import MeshConfig, make_mesh
    from dllama_tpu.parallel.sharding import LlamaShardings

    return LlamaShardings(make_mesh(MeshConfig(tp=tp)), jax_cfg(**kw))


def jax_engine(kw, jp, **extra):
    import jax.numpy as jnp

    from dllama_tpu.engine.engine import InferenceEngine as JaxEngine

    return JaxEngine(jax_cfg(**kw), jp, cache_dtype=jnp.float32, kernels="xla",
                     shardings=jax_shardings(kw), **extra)


def steps(eng, n_decode=2):
    """[prefill logits, decode logits...] of PROMPT, each the argmax fed."""
    out = [np.asarray(eng.prefill(np.asarray([PROMPT])), np.float32).reshape(-1)]
    for _ in range(n_decode):
        tok = int(np.argmax(out[-1]))
        out.append(np.asarray(eng.decode_step(np.array([[tok]])), np.float32).reshape(-1))
    return out


def greedy(eng, n=16):
    return [int(t) for t in eng.generate(PROMPT, n, Sampler(0.0, 0.9, 1))]


def jax_greedy(eng, n=16):
    from dllama_tpu.engine.sampling import Sampler as JaxSampler

    return [int(t) for t in eng.generate(PROMPT, n, JaxSampler(0.0, 0.9, 1))]


def close_all(a, b, tol=TOL):
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, atol=tol, rtol=tol)


# ------------------------------------------------------------- pure parity


def test_mesh_config_and_auto_mesh_match_jax():
    from dllama_tpu.parallel import mesh as jmesh

    for spec in ("tp=4", "tp=2,dp=2", "dp=8", "sp=2,tp=2,pp=2", "", "ep=4,tp=1"):
        assert dataclasses.astuple(pmesh.MeshConfig.parse(spec)) == \
            dataclasses.astuple(jmesh.MeshConfig.parse(spec))
    with pytest.raises(ValueError):
        pmesh.MeshConfig.parse("xx=2")
    for n in range(1, 9):
        for kv in (1, 2, 3, 4, 6, 8):
            for sp in (False, True):
                assert dataclasses.astuple(pmesh.auto_mesh_config(n, kv, sp)) == \
                    dataclasses.astuple(jmesh.auto_mesh_config(n, kv, sp)), (n, kv, sp)


def test_resolve_sync_matches_jax():
    from dllama_tpu.parallel.collectives import resolve_sync as jax_resolve

    for tp in (1, 2, 4, 8):
        for pp in (1, 2):
            sh = types.SimpleNamespace(mesh=types.SimpleNamespace(
                shape={"dp": 1, "pp": pp, "sp": 1, "tp": tp, "ep": 1}))
            for sync in ("auto", "bf16", "q80"):
                assert collectives.resolve_sync(sync, sh) == jax_resolve(sync, sh)
    for sync in ("auto", "bf16", "q80"):
        assert collectives.resolve_sync(sync, None) == jax_resolve(sync, None)
    with pytest.raises(ValueError):
        collectives.resolve_sync("f32", None)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kw", [dict(WIDE, vocab_size=130),
                                dict(WIDE, vocab_size=128, n_experts=4, n_active_experts=2)],
                         ids=["dense-odd-vocab", "moe"])
def test_param_specs_match_jax(kw, tp):
    """Every leaf's spec, _sanitize's replication of a dim tp does not
    divide (wcls at vocab 130 and tp=4) included; a Q40 col shard that
    splits a 32-element block (dim 64 at tp=4) raises in both."""
    jp, npt = jax_tree(kw)
    jspecs = jax_shardings(kw, tp).param_spec_tree(jp)
    mesh = pmesh.Mesh(pmesh.MeshConfig(tp=tp))
    pspecs = sharding.LlamaShardings(mesh, LlamaConfig(**kw)).param_spec_tree(
        params_from_numpy(npt))

    def norm(spec):
        spec = getattr(spec, "packed", spec)
        return tuple(spec)

    assert norm(pspecs["wcls"]) == norm(jspecs["wcls"])
    assert norm(pspecs["embedding"]) == norm(jspecs["embedding"])
    assert norm(pspecs["final_norm"]) == norm(jspecs["final_norm"])
    assert set(pspecs["layers"]) == set(jspecs["layers"])
    for name in pspecs["layers"]:
        assert norm(pspecs["layers"][name]) == norm(jspecs["layers"][name]), name
    small = dict(KW, n_kv_heads=4)
    jp, npt = jax_tree(small)
    with pytest.raises(ValueError, match="Q40 col-shard"):
        jax_shardings(small, 4).param_spec_tree(jp)
    with pytest.raises(ValueError, match="Q40 col-shard"):
        sharding.LlamaShardings(pmesh.Mesh(pmesh.MeshConfig(tp=4)), LlamaConfig(**small)) \
            .param_spec_tree(params_from_numpy(npt))


def test_collective_bytes_per_token_matches_jax():
    from dllama_tpu.utils.profiling import collective_bytes_per_token as jax_bytes

    for kw in (KW, MOE_KW, dict(KW, dim=4096, n_layers=32, vocab_size=128256)):
        for tp in (1, 2, 4, 8):
            for sp in (1, 2):
                for eb in (2.0, 34 / 32):
                    assert profiling.collective_bytes_per_token(
                        LlamaConfig(**kw), tp=tp, sp=sp, exchange_bytes=eb) == \
                        jax_bytes(jax_cfg(**kw), tp=tp, sp=sp, exchange_bytes=eb)


class _TwoRanks:
    """A stand-in for a tp=2 exchange whose all-gather returns two given
    partials (rank 0's is the argument, rank 1's is ``other`` quantized the
    same way), so the Q80 arithmetic runs without a process group."""

    def __init__(self, other):
        self.other = other
        self.calls = 0

    def _all_gather(self, x):
        self.calls += 1
        twin = collectives.quantize_q80(self.other)[self.calls % 2 == 0]
        twin = collectives._f16_wire(twin) if x.dtype == torch.float16 else twin
        return torch.stack([x, twin.to(x.dtype)])


def test_q80_collectives_match_jax_arithmetic():
    """quantize_q80 / dequantize_q80 bit-equal to JAX's jnp pair, the wire's
    f16 clamp, and q80_all_reduce / q80_all_gather of two partials equal to
    JAX's formula on the same codes."""
    import jax.numpy as jnp

    from dllama_tpu.ops.quant import dequantize_q80_jnp, quantize_q80_jnp
    from dllama_tpu.parallel.collectives import _f16_wire as jax_wire

    rng = np.random.default_rng(4)
    a = (rng.standard_normal((2, 3, 128)) * 4).astype(np.float32)
    b = (rng.standard_normal((2, 3, 128)) * 4).astype(np.float32)
    a[0, 0, :32] = 0.0  # an all-zero block: scale 0, codes 0
    a[1, 2, 32:64] *= 1e7  # a block past f16's range: its wire scale saturates
    codes, scales = collectives.quantize_q80(torch.from_numpy(a))
    jc, js = quantize_q80_jnp(jnp.asarray(a))
    assert np.array_equal(codes.numpy(), np.asarray(jc))
    assert np.array_equal(scales.numpy(), np.asarray(js))
    wire = collectives._f16_wire(scales)
    assert np.array_equal(wire.numpy(), np.asarray(jax_wire(js)))
    assert torch.isfinite(wire).all() and wire.max() == 65504.0
    deq = collectives.dequantize_q80(codes, scales)
    assert np.array_equal(deq.numpy(), np.asarray(dequantize_q80_jnp(jc, js)))

    def jax_merge(parts):
        out = 0.0
        for p in parts:
            c, sc = quantize_q80_jnp(jnp.asarray(p))
            out = out + dequantize_q80_jnp(c, jax_wire(sc).astype(jnp.float32))
        return np.asarray(out)

    x, y = torch.from_numpy(a), torch.from_numpy(b)
    got = collectives.q80_all_reduce(x, _TwoRanks(y))
    assert np.array_equal(got.numpy(), jax_merge([a, b]))
    gathered = collectives.q80_all_gather(x, _TwoRanks(y), axis=-1)
    want = np.concatenate([jax_merge([a]), jax_merge([b])], axis=-1)
    assert gathered.shape == (2, 3, 256) and np.array_equal(gathered.numpy(), want)


def test_lazy_q40_shards_equal_jax(tmp_path):
    from dllama_tpu.models import formats as jf

    rng = np.random.default_rng(3)
    n_out, k_in = 96, 128
    path = str(tmp_path / "w.bin")
    with open(path, "wb") as f:
        for _ in range(3):
            formats.write_tensor(f, rng.standard_normal((n_out, k_in)).astype(np.float32),
                                 FloatType.Q40)
    data = np.memmap(path, dtype=np.uint8, mode="r")
    per = FloatType.Q40.nbytes(n_out * k_in)
    raws = [data[i * per : (i + 1) * per] for i in range(3)]
    mine = [formats.LazyQ40(r, n_out, k_in) for r in raws]
    theirs = [jf.LazyQ40(r, n_out, k_in) for r in raws]
    full = slice(None)
    # rows (output dim) and columns (input dim, whole blocks), as tp=2 and 4 cut them
    cuts = [(full, full), (full, slice(0, 48)), (full, slice(48, 96)),
            (slice(0, 32), full), (slice(32, 64), full), (slice(16, 48), slice(24, 72))]
    for a, b in zip(mine, theirs):
        for k2, n in cuts:
            kb = slice(None if k2.start is None else k2.start // 16,
                       None if k2.stop is None else k2.stop // 16)
            pa, pb = a.packed_shard(k2, n), b.packed_shard(k2, n)
            assert pa.flags.c_contiguous and pa.dtype == np.uint8
            assert np.array_equal(pa, pb)
            sa, sb = a.scales_shard(kb, n), b.scales_shard(kb, n)
            assert sa.flags.c_contiguous and sa.view(np.uint16).tobytes() == \
                np.asarray(sb).view(np.uint16).tobytes()
    sa, sb = formats.LazyQ40Stack(mine), jf.LazyQ40Stack(theirs)
    assert sa.packed_shape == sb.packed_shape and sa.scales_shape == sb.scales_shape
    for l_sl in (full, slice(1, 3)):
        assert np.array_equal(sa.packed_shard(l_sl, full, slice(0, 48)),
                              sb.packed_shard(l_sl, full, slice(0, 48)))
        assert np.array_equal(sa.scales_shard(l_sl, slice(2, 4), full),
                              sb.scales_shard(l_sl, slice(2, 4), full))
    # the lazy leaf's shard is the eager weight's slice, and contiguous as a tensor
    mesh = pmesh.Mesh(pmesh.MeshConfig(tp=2), rank=1)
    sh = sharding.LlamaShardings(mesh, LlamaConfig(**KW))
    leaf = sh.put("layers.w2", formats.LazyQ40Stack([mine[0]]), "cpu")
    eager = mine[0].eager()
    assert leaf.packed.is_contiguous() and leaf.scales.is_contiguous()
    assert torch.equal(leaf.packed[0], eager.packed[32:64])
    assert torch.equal(leaf.scales[0], eager.scales[2:4])


@pytest.mark.parametrize("kw", [KW, MOE_KW], ids=["dense", "moe"])
def test_shard_direct_load_equals_the_sliced_tree(kw, tmp_path):
    """load_params through LlamaShardings.put (the rank's records off the
    memmap, rearranged on its device) gives each rank exactly the slices of
    the eagerly loaded tree, every Q40 leaf contiguous; no rank reads the
    whole file's Q40 bytes."""
    cfg = LlamaConfig(**kw)
    rng = np.random.default_rng(1)
    path = str(tmp_path / "m.m")
    formats.save_model(path, cfg, {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
                                   for n, s, _ in formats.tensor_plan(cfg)})
    cfg, hs = formats.read_header(path)
    full = formats.load_params(path, cfg, hs, dtype=torch.float32)
    q40_bytes = sum(FloatType.Q40.nbytes(int(np.prod(s))) for _, s, ft in
                    formats.tensor_plan(cfg) if ft == FloatType.Q40)
    for rank in (0, 1):
        sh = sharding.LlamaShardings(pmesh.Mesh(pmesh.MeshConfig(tp=2), rank=rank), cfg)
        formats.LAZY_DECODE.update(bytes=0, seconds=0.0)
        local = formats.load_params(path, cfg, hs, dtype=torch.float32,
                                    put=lambda name, leaf: sh.put(name, leaf, "cpu"))
        assert formats.LAZY_DECODE["bytes"] == q40_bytes // 2
        want = sh.put_params(full, "cpu")
        for name in ("wcls", *local["layers"]):
            a = local[name] if name == "wcls" else local["layers"][name]
            b = want[name] if name == "wcls" else want["layers"][name]
            if hasattr(a, "packed"):
                assert a.packed.is_contiguous() and a.scales.is_contiguous(), name
                assert torch.equal(a.packed, b.packed) and torch.equal(a.scales, b.scales), name
            else:
                assert torch.equal(a, b), name


# ---------------------------------------------------------------- tp worlds


@pytest.fixture(scope="class")
def q40(tmp_path_factory):
    """The Q40 tree's tp=2 world (rank 0's engine drives), the port's
    unsharded engine, and JAX's tp=2 engine over the same tree."""
    jp, npt = jax_tree(KW)
    tree = params_from_numpy(npt)
    world = multihost.launch_tree(LlamaConfig(**KW), tree, pmesh.MeshConfig(tp=2),
                                  str(tmp_path_factory.mktemp("q40")),
                                  cache_dtype=torch.float32)
    one = InferenceEngine(LlamaConfig(**KW), tree, cache_dtype=torch.float32)
    yield types.SimpleNamespace(world=world, eng=world.engine, one=one, jp=jp, tree=tree)
    world.close()


class TestQ40World:
    """The Q40 tree's tp=2 world: the single engine, --sync q80, the
    byte counters and the batched tier."""

    def test_tp2_engine_matches_jax_and_one_device(self, q40):
        eng = q40.eng
        assert eng.exchange is not None and eng.cfg.n_heads == 2 and eng.cfg.n_kv_heads == 1
        got = steps(eng)
        close_all(got, steps(jax_engine(KW, q40.jp)))
        eng.reset(0)
        q40.one.reset(0)
        close_all(got, steps(q40.one))

    def test_tp2_engine_greedy_ids_equal(self, q40):
        q40.eng.reset(0)
        q40.one.reset(0)
        ids = greedy(q40.eng)
        assert ids == jax_greedy(jax_engine(KW, q40.jp)) == greedy(q40.one)

    def test_sync_q80_matches_jax_q80(self, q40):
        eng = q40.world.make("engine", sync="q80", cache_dtype=torch.float32)
        assert eng.sync == "q80"
        got = steps(eng)
        want = steps(jax_engine(KW, q40.jp, sync="q80"))
        close_all(got, want)
        # and q80 moves the logits no further than its step from bf16's
        q40.eng.reset(0)
        for x, y in zip(got, steps(q40.eng)):
            np.testing.assert_allclose(x, y, atol=q80_tol(y), rtol=0)

    @pytest.mark.parametrize("sync", ["bf16", "q80"])
    def test_measured_collective_bytes_equal_the_formula(self, q40, sync):
        """One decode step at B=1 (T=1): each layer exchanges the wo and w2
        partials ([1, 1, dim] in the activations' dtype, f32 for this tree),
        the forward gathers the f32 logits once. The counters sum each
        collective's result bytes."""
        eng = q40.eng if sync == "bf16" else q40.world.make("engine", sync="q80",
                                                              cache_dtype=torch.float32)
        eng.reset(0)
        eng.prefill(np.asarray([PROMPT]))
        eng.decode_step(np.array([[3]]))
        rep = eng.measured_collective_report()
        tp, dim, L, vocab = 2, KW["dim"], KW["n_layers"], KW["vocab_size"]
        gather = tp * (vocab // tp) * 4
        if sync == "bf16":
            act = eng.params["embedding"].element_size()
            want = {"all-reduce": L * 2 * dim * act, "all-gather": gather}
        else:  # i8 codes and f16 scales of tp ranks, gathered
            want = {"all-gather": L * 2 * (tp * dim + tp * (dim // 32) * 2) + gather}
        assert rep["per_op"] == want
        assert rep["total_bytes"] == sum(want.values())

    def test_tp2_batch_engine_matches_jax_sharded(self, q40):
        import jax.numpy as jnp

        from dllama_tpu.engine.batch import BatchEngine as JaxBatch

        prompt = list(range(1, 9))

        def run(eng):
            first = eng.add(0, prompt, temperature=0.0, seed=123)
            toks = eng.decode(4)
            return [first] + [int(t) for t in toks[:, 0]]

        jeng = JaxBatch(jax_cfg(**KW), q40.jp, n_slots=2, cache_dtype=jnp.float32,
                        shardings=jax_shardings(KW), kernels="xla")
        be = q40.world.make("batch", n_slots=2, cache_dtype=torch.float32)
        assert be.kv_layout == "dense" and be.cfg.n_kv_heads == 1
        one = BatchEngine(LlamaConfig(**KW), q40.tree, n_slots=2, cache_dtype=torch.float32)
        assert run(be) == run(jeng) == run(one)

    def test_tp2_hybrid_and_spec_streams_equal_tp1(self, q40):
        """Hybrid admission (a 16-token budget, so prompts join in pieces) and
        --spec-k 2 through the Scheduler: the tp=2 greedy streams equal tp=1's."""
        kw = dict(n_slots=2, cache_dtype=torch.float32, spec=2)
        got = _workload(Scheduler(q40.world.make("batch", **kw), prefill_budget=16))
        want = _workload(Scheduler(BatchEngine(LlamaConfig(**KW), q40.tree, **kw),
                                   prefill_budget=16))
        assert got == want and all(len(s) for s in got)

    def test_sampled_streams_equal_on_both_ranks(self, q40):
        """Each rank folds the tokens of every call it makes into its digest:
        sampled slots of the batched tier, then a sampled generate on the
        single tier, emit the same tokens on rank 0 and rank 1."""
        be = q40.world.make("batch", n_slots=2, cache_dtype=torch.float32)
        be.add(0, PROMPT, temperature=0.9, topp=0.9, seed=11)
        be.add(1, [3, 4, 5], temperature=1.1, topp=0.8, seed=12)
        before = q40.world.call_all("rank_digest")
        toks = be.decode(12)
        after = q40.world.call_all("rank_digest")
        assert toks.shape == (12, 2) and after[0] == after[1] and after != before
        q40.eng.reset(0)
        out = list(q40.eng.generate(PROMPT, 12, Sampler(0.9, 0.9, 5)))
        ranks = q40.world.call_all("rank_digest")
        assert len(out) == 12 and len(ranks) == 2 and ranks[0] == ranks[1] != after[0]

    def test_sessions_and_warm_restart_refused_on_a_mesh(self, q40, tmp_path):
        with pytest.raises(pmesh.NotPorted, match="save_session"):
            q40.eng.save_session(str(tmp_path / "s.npz"))
        with pytest.raises(pmesh.NotPorted, match="load_session"):
            q40.eng.load_session(str(tmp_path / "s.npz"))
        be = q40.world.make("batch", n_slots=1, cache_dtype=torch.float32)
        with pytest.raises(pmesh.NotPorted, match="warm_restart"):
            be.warm_restart()
        with pytest.raises(ValueError, match="paged KV cache requires an unsharded engine"):
            q40.world.make("batch", n_slots=1, kv_layout="paged")
        # the world is still in step after the refusals
        q40.eng.reset(0)
        q40.one.reset(0)
        assert greedy(q40.eng, 4) == greedy(q40.one, 4)
        digests = q40.world.call_all("rank_digest")
        assert digests[0] == digests[1]


#: --sync q80 against the exact exchange: each partial sum is coded at
#: absmax/127 a step, so a merged sum is off by at most a Q80 step of its
#: block; taken at the logits' scale, the bound is one step of the largest
#: logit (max|logit|/127) beyond JAX's tp bound. Against JAX's own q80 path
#: the two packages quantize the same partials, so JAX's tp bound holds.
def q80_tol(logits) -> float:
    return float(np.max(np.abs(logits))) / 127.0 + TOL


def _workload(sched):
    reqs = [sched.submit(PROMPT * 3, 0.0, 0.9, 14, frozenset(), seed=1),
            sched.submit([9, 8, 7], 0.0, 0.9, 10, frozenset(), seed=2),
            sched.submit(list(range(3, 40)), 0.0, 0.9, 8, frozenset(), seed=3)]
    try:
        return [list(r.tokens()) for r in reqs]
    finally:
        sched.shutdown()


@pytest.fixture(scope="class")
def q80(tmp_path_factory):
    """A Q80 file loaded on a tp=2 mesh by both packages (dense bf16)."""
    d = tmp_path_factory.mktemp("q80")
    cfg = LlamaConfig(**KW, weight_type=FloatType.Q80)
    rng = np.random.default_rng(5)
    tensors = {n: (rng.standard_normal(s) * 0.05).astype(np.float32)
               for n, s, _ in formats.tensor_plan(cfg)}
    path = str(d / "q80.m")
    formats.save_model(path, cfg, tensors)
    m = load_model(path, mesh="tp=2", device="cpu", cache_dtype=torch.float32)
    yield types.SimpleNamespace(path=path, m=m)
    m.world.close()


class TestQ80File:
    """A Q80 file on a tp=2 mesh (dense bf16 in both packages)."""

    def test_q80_file_on_tp2_matches_jax(self, q80):
        import jax.numpy as jnp

        from dllama_tpu.engine.loader import load_model as jax_load

        eng = q80.m.engine
        assert isinstance(eng.params["layers"]["wq"], torch.Tensor)  # dense bf16 on a mesh
        assert eng.params["layers"]["wq"].dtype == torch.bfloat16
        jm = jax_load(q80.path, mesh="tp=2", cache_dtype=jnp.float32)
        got = steps(eng)
        close_all(got, steps(jm.engine))
        eng.reset(0)
        one = load_model(q80.path, mesh=None, device="cpu", cache_dtype=torch.float32,
                         dequantize=True).engine
        close_all(got, steps(one))
        eng.reset(0)
        one.reset(0)
        assert greedy(eng) == jax_greedy(jax_load(q80.path, mesh="tp=2",
                                                  cache_dtype=jnp.float32).engine) == greedy(one)


@pytest.fixture(scope="class")
def moe(tmp_path_factory):
    jp, npt = jax_tree(MOE_KW, seed=5)
    tree = params_from_numpy(npt)
    world = multihost.launch_tree(LlamaConfig(**MOE_KW), tree, pmesh.MeshConfig(tp=2),
                                  str(tmp_path_factory.mktemp("moe")),
                                  cache_dtype=torch.float32)
    yield types.SimpleNamespace(world=world, jp=jp, tree=tree)
    world.close()


class TestMoE:
    """A tiny MoE tree on a tp=2 mesh (the experts' FFN width split)."""

    def test_moe_on_tp2_matches_jax_and_one_device(self, moe):
        eng = moe.world.engine
        assert eng.cfg.hidden_dim == MOE_KW["hidden_dim"] // 2  # the experts' FFN width split
        got = steps(eng)
        close_all(got, steps(jax_engine(MOE_KW, moe.jp)))
        one = InferenceEngine(LlamaConfig(**MOE_KW), moe.tree, cache_dtype=torch.float32)
        close_all(got, steps(one))
        eng.reset(0)
        one.reset(0)
        assert greedy(eng) == jax_greedy(jax_engine(MOE_KW, moe.jp)) == greedy(one)


LONG = dict(KW, seq_len=512)


@pytest.fixture(scope="class")
def long_world(tmp_path_factory):
    """The Q40 tree at seq_len 512 on a tp=2 world, and on one device."""
    tree = params_from_numpy(jax_tree(KW)[1])
    world = multihost.launch_tree(LlamaConfig(**LONG), tree, pmesh.MeshConfig(tp=2),
                                  str(tmp_path_factory.mktemp("long")),
                                  cache_dtype=torch.float32)
    yield types.SimpleNamespace(world=world, tree=tree)
    world.close()


class TestProcessModel:
    """What keeps the ranks in step over long runs, and what ends them."""

    def test_an_admission_outlives_300_hybrid_steps(self, long_world):
        """A 300-token prompt admitted at one token a hybrid step while
        another slot decodes: rank 0 lets go of 300 decode chunks while it
        holds the admission, and the followers keep it as long. The tokens
        equal one device's, the ranks' token results are equal, and every
        rank holds the same named objects, down to the base engine alone
        once rank 0 lets go of the rest."""
        import gc

        prompt = [int(t) for t in np.random.default_rng(3).integers(1, 128, 300)]

        def run(be):
            be.add(1, [3, 4, 5], temperature=0.0)
            adm = be.add_begin(0, prompt)
            toks, steps = [], 0
            while adm.off < len(adm.toks):
                toks.append(int(be.decode_consume(be.hybrid_dispatch(1, adm, 1))[0, 1]))
                steps += 1
            first = be.add_commit(adm, temperature=0.0)
            return steps, toks, first, be.decode(4).tolist()

        world = long_world.world
        got = run(world.make("batch", n_slots=2, cache_dtype=torch.float32))
        want = run(BatchEngine(LlamaConfig(**LONG), long_world.tree, n_slots=2,
                               cache_dtype=torch.float32))
        assert got[0] == 300 and got == want
        digests = world.call_all("rank_digest")
        assert digests[0] == digests[1]
        gc.collect()
        assert world.call_all("rank_objects") == [1, 1]
        adm_world = world.make("batch", n_slots=1, cache_dtype=torch.float32)
        adm = adm_world.add_begin(0, prompt[:8])
        assert world.call_all("rank_objects") == [3, 3]
        del adm, adm_world
        gc.collect()
        assert world.call_all("rank_objects") == [1, 1]

    def test_a_dead_follower_breaks_the_world(self, long_world):
        """SIGKILL the follower: rank 0's watch marks the world broken, and
        its next call raises instead of waiting on the dead rank."""
        import signal
        import time

        world = long_world.world
        world.children[0].send_signal(signal.SIGKILL)
        end = time.monotonic() + 10
        while not world.link.closed and time.monotonic() < end:
            time.sleep(0.05)
        assert world.link.closed
        with pytest.raises(RuntimeError, match="command channel is closed"):
            world.engine.prefill(np.asarray([PROMPT]))


def test_a_spare_rank_serves_the_next_launch(tmp_path):
    """keep_warm(1): the next tp=2 world's follower is the spare started
    ahead (that process, not a new one), its logits equal one device's
    within TOL, a new spare waits after the launch, and keep_warm(0) ends
    it; each spare exits 0."""
    tree = params_from_numpy(jax_tree(KW)[1])
    multihost.keep_warm(1)
    try:
        spare = multihost._SPARES[0]
        world = multihost.launch_tree(LlamaConfig(**KW), tree, pmesh.MeshConfig(tp=2),
                                      str(tmp_path), cache_dtype=torch.float32)
        try:
            assert world.children == [spare] and len(multihost._SPARES) == 1
            assert multihost._SPARES[0] is not spare
            one = InferenceEngine(LlamaConfig(**KW), tree, cache_dtype=torch.float32)
            close_all(steps(world.engine), steps(one))
        finally:
            world.close()
        assert spare.returncode == 0
        left = multihost._SPARES[0]
    finally:
        multihost.keep_warm(0)
    assert multihost._SPARES == [] and left.returncode == 0
