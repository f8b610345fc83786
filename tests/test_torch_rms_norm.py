"""RMSNorm (K10) on the CPU: the engines' norm against the JAX package's
Pallas kernel (``ops/pallas/rms_norm.rms_norm`` in interpret mode), the
route rule, the kernel's host geometry and the golden forward.

* The norm an engine with CUDA kernels runs (``ops/rms_norm.kernel_norm``)
  reaches the kernel's wrapper, which runs its plain version for CPU
  tensors. Shapes (1, 64), (3, 5, 128) and (17, 256) in f32 (within 1e-6
  of max|ref|: only the order of the f32 sum of squares differs) and bf16
  (within one bf16 ulp of each reference element: a sum order can move a
  rounding across a tie).
* ``resolve_kernels`` gives the kernel's route under backend ``cuda`` and
  the plain norm under ``torch`` and on the CPU; ``RMS_NORM_IMPL = "torch"``
  turns the kernel's route plain, and any value but "cuda" and "torch"
  raises.
* ``geometry`` covers every element of a row exactly once and every row
  once (a model of the kernel's walk: thread t holds vectors t, t +
  threads, ...; block r row r), within the instances and block sizes of
  ``csrc/rms_norm.cu``.
* A pipeline stage's forward runs the norm it was given: two a layer, and
  the final norm on the last stage.
* The golden forward is bit-equal under both routes, and its logits within
  2e-3 of max|logit| of the JAX package's with the Pallas norm (bf16
  activations: the packages round the same values, their f32 sums differ
  in order).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dllama_tpu_torch.engine.kernel_select import resolve_kernels
from dllama_tpu_torch.ops import layers
from dllama_tpu_torch.ops import rms_norm as k10

torch.set_num_threads(1)

EPS = 1e-5
SHAPES = [(1, 64), (3, 5, 128), (17, 256)]
WIDTHS = [8, 64, 128, 4096, 5120, 8192, 14336]
ROWS = [1, 8, 16, 17, 256]
CSRC = Path(k10.__file__).resolve().parent / "csrc" / "rms_norm.cu"
GOLDEN_TOL = 2e-3


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    w = (1.0 + 0.2 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, w


def _cfg(dim: int = 64):
    from dllama_tpu_torch.models.config import LlamaConfig

    return LlamaConfig(dim=dim, hidden_dim=2 * dim, n_layers=2, n_heads=4, n_kv_heads=2,
                       vocab_size=259, seq_len=64)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matches_pallas_interpret(shape, dtype):
    import jax.numpy as jnp

    from dllama_tpu.ops.pallas.rms_norm import rms_norm as pallas_rms_norm

    x, w = _inputs(shape, len(shape) * 100 + shape[-1])
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jx = jnp.asarray(x, jdt)
    want = np.asarray(pallas_rms_norm(jx, jnp.asarray(w), EPS, interpret=True), np.float32)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    tx = tx if dtype == "f32" else tx.to(torch.bfloat16)
    norm = resolve_kernels(_cfg(), "cuda", "cpu").norm
    assert norm is k10.kernel_norm
    before = dict(k10.LAUNCHES)
    got = norm(tx, torch.from_numpy(w), EPS)
    assert k10.LAUNCHES == before  # a CPU tensor runs the plain version
    assert got.dtype == tx.dtype and tuple(got.shape) == shape
    got = got.float().numpy()
    if dtype == "f32":
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all()


def test_switch_routes_the_model_norms(monkeypatch):
    """The norm of a ``cuda`` selection hands a tensor that is not on the CPU
    to the kernel's wrapper (which refuses one that is not on a CUDA
    device); under ``RMS_NORM_IMPL = "torch"``, and in a ``torch``
    selection, the plain version runs on any device."""
    x = torch.ones(2, 64, device="meta")
    w = torch.ones(64, device="meta")
    cfg = _cfg()
    for kernels, device in (("cuda", "cpu"), ("auto", "cuda"), ("cuda", "cuda")):
        with pytest.raises(ValueError, match="CUDA"):
            resolve_kernels(cfg, kernels, device).norm(x, w, EPS)
    for kernels, device in (("torch", "cpu"), ("auto", "cpu"), ("torch", "cuda")):
        assert resolve_kernels(cfg, kernels, device).norm(x, w, EPS).shape == (2, 64)
    monkeypatch.setattr(layers, "RMS_NORM_IMPL", "torch")
    assert resolve_kernels(cfg, "cuda", "cuda").norm(x, w, EPS).shape == (2, 64)


@pytest.mark.parametrize("impl", ["pallas", "jnp", "Cuda", ""])
def test_switch_rejects_other_values(impl, monkeypatch):
    """RMS_NORM_IMPL takes "cuda" or "torch"; any other value (the JAX
    package's "pallas" and "jnp" among them) raises, on any device, rather
    than choosing a norm."""
    norm = resolve_kernels(_cfg(), "cuda", "cpu").norm
    monkeypatch.setattr(layers, "RMS_NORM_IMPL", impl)
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError, match="RMS_NORM_IMPL"):
            norm(torch.ones(2, 64, device=device), torch.ones(64, device=device), EPS)


@pytest.mark.parametrize("kernels,device,want", [
    ("auto", "cpu", "plain"), ("torch", "cpu", "plain"), ("cuda", "cpu", "kernel"),
    ("auto", "cuda", "kernel"), ("cuda", "cuda", "kernel"), ("torch", "cuda", "plain")])
@pytest.mark.parametrize("layout", ["dense", "paged", "ring"])
def test_route_rule(kernels, device, want, layout):
    """The norm follows the matmuls' backend on every layout (head size 64,
    which the attention kernels take): the kernel's route for ``cuda``, the
    plain norm for ``torch``."""
    cfg = _cfg(dim=256)
    kw = {"dense": {}, "paged": dict(paged=True, page_size=8),
          "ring": dict(sp_attention=object())}[layout]
    sel = resolve_kernels(cfg, kernels, device, **kw)
    assert sel.norm is (k10.kernel_norm if want == "kernel" else layers.rms_norm_plain)
    assert sel.norm is k10.engine_norm(sel.backend)


def _walk(rows: int, d: int) -> tuple[np.ndarray, np.ndarray]:
    """How often the kernel over x [rows, d] in geometry(d) reads each
    element of a row and each row: thread t of a block holds vectors t + i *
    threads for i < vectors (all vectors of the row, `threads` apart, for
    the looped instance); the grid is `rows` blocks, block r row r."""
    threads, vectors = k10.geometry(d)
    nvec = d // k10.VEC
    elems = np.zeros(d, np.int64)
    for t in range(threads):
        steps = range(vectors) if vectors else range(-(-nvec // threads))
        for i in steps:
            c = t + i * threads
            if c < nvec:
                elems[c * k10.VEC:(c + 1) * k10.VEC] += 1
    seen = np.zeros(rows, np.int64)
    for b in range(rows):
        seen[b] += 1
    return elems, seen


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("d", WIDTHS)
def test_geometry_covers_every_element_once(rows, d):
    threads, vectors = k10.geometry(d)
    assert threads % 32 == 0
    if vectors:
        assert vectors in k10.VECTORS and threads <= k10.ONE_PASS_THREADS
        assert vectors * threads * k10.VEC >= d
    else:
        assert threads == k10.LOOPED_THREADS
    elems, seen = _walk(rows, d)
    assert (elems == 1).all() and (seen == 1).all()


@pytest.mark.parametrize("d", [16384, 16392, 65536])
def test_geometry_widest_rows(d):
    """The one-pass instances stop at 512 threads of 4 vectors; a wider row
    takes the looped instance, still once per element."""
    vectors = k10.geometry(d)[1]
    assert (vectors == 4) == (d <= k10.ONE_PASS_THREADS * 4 * k10.VEC)
    elems, _ = _walk(1, d)
    assert (elems == 1).all()


def test_geometry_constants_match_the_kernel():
    """The geometry's instances and block limits are the kernel's."""
    src = CSRC.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kVec"]) == k10.VEC
    assert int(consts["kOnePassThreads"]) == k10.ONE_PASS_THREADS
    assert int(consts["kMaxThreads"]) == k10.LOOPED_THREADS
    inst = sorted(int(v) for v in re.findall(r"rms_norm_kernel<T, (\d+)>", src))
    assert tuple(inst) == k10.VECTORS
    assert "rms_norm_looped_kernel<T>" in src
    # the launch asks for programmatic dependent launch; the kernel waits
    # before its first read of x
    assert "cudaLaunchAttributeProgrammaticStreamSerialization" in src
    body = src[src.index("rms_norm_kernel("):]
    assert body.index("grid_dependency_wait()") < body.index("load_row<VPT>(x")
    # one block a row
    assert "cfg.gridDim = dim3(rows);" in src


def test_c_signature_matches_the_build_table():
    """ops/build.SIGNATURES["rms_norm"] types the C entry's arguments one for
    one (a pointer or the stream passed as a C int would be cut)."""
    import ctypes

    from dllama_tpu_torch.ops import build

    src = CSRC.read_text()
    params = re.search(r'extern "C" int rms_norm\(([^)]*)\)', src).group(1)
    kinds = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
             "long long": ctypes.c_longlong, "float": ctypes.c_float}
    want = [kinds[" ".join(p.split()[:-1])] for p in params.split(",")]
    assert list(build.SIGNATURES["rms_norm"]) == want


def _golden():
    from dllama_tpu_torch.models import formats
    from tests.test_golden import FIXTURE_M

    cfg, hs = formats.read_header(FIXTURE_M)
    return cfg, formats.load_params(FIXTURE_M, cfg, hs)


def test_forward_is_the_same_with_the_switch_on(monkeypatch):
    """On the CPU the route changes no bit of the forward: the kernel's
    route (either setting of RMS_NORM_IMPL) and the plain norm."""
    from dllama_tpu_torch.models.llama import KVCache, forward
    from tests.test_golden import GOLDEN_PROMPT

    cfg, params = _golden()
    rope = layers.build_rope_cache(cfg)
    toks = torch.tensor([GOLDEN_PROMPT])
    runs = []
    for norm, impl in ((layers.rms_norm_plain, "cuda"), (k10.kernel_norm, "cuda"),
                       (k10.kernel_norm, "torch"), (None, "cuda")):
        monkeypatch.setattr(layers, "RMS_NORM_IMPL", impl)
        logits, _ = forward(cfg, params, toks, 0, KVCache.create(cfg, 1, torch.float32), rope,
                            norm=norm)
        runs.append(logits)
    assert all(torch.equal(runs[0], r) for r in runs[1:])


def test_golden_engines_match_jax_pallas_norm(monkeypatch):
    """The golden fixture through InferenceEngine under --kernels cuda (the
    kernel's route: its wrapper's plain version on the CPU) and torch:
    prefill and 4 greedy steps bit-equal, the same ids, and the logits within
    GOLDEN_TOL of max|logit| of the JAX engine's with RMS_NORM_IMPL =
    "pallas" (its Pallas norm in interpret mode)."""
    import jax.numpy as jnp

    from dllama_tpu.engine.engine import InferenceEngine as JaxEngine
    from dllama_tpu.models import formats as jformats
    from dllama_tpu.ops import layers as jlayers
    from dllama_tpu_torch.engine.engine import InferenceEngine
    from tests.test_golden import FIXTURE_M, GOLDEN_PROMPT

    monkeypatch.setattr(jlayers, "RMS_NORM_IMPL", "pallas")
    jcfg, jhs = jformats.read_header(FIXTURE_M)
    jeng = JaxEngine(jcfg, jformats.load_params(FIXTURE_M, jcfg, jhs), cache_dtype=jnp.float32)
    cfg, params = _golden()
    engines = [InferenceEngine(cfg, params, cache_dtype=torch.float32, kernels=k)
               for k in ("cuda", "torch")]
    assert [e.norm for e in engines] == [k10.kernel_norm, layers.rms_norm_plain]
    prompt = np.asarray([GOLDEN_PROMPT])
    want = np.asarray(jeng.prefill(prompt), np.float32)
    got = [e.prefill(prompt) for e in engines]
    for _ in range(5):
        assert torch.equal(got[0], got[1])
        g = got[0].float().numpy()
        assert np.abs(g - want).max() <= GOLDEN_TOL * np.abs(want).max()
        tok = int(np.argmax(want[0]))
        assert int(np.argmax(g[0])) == tok
        want = np.asarray(jeng.decode_step(np.array([[tok]])), np.float32)
        got = [e.decode_step(np.array([[tok]])) for e in engines]


@pytest.mark.parametrize("stage", [0, 1])
def test_pp_stage_runs_the_norm_it_was_given(stage):
    """A stage of a two-stage pipeline (parallel/pipeline.make_pp_forward,
    the hop and the broadcast stubbed in this process) runs the norm it was
    given at both norms of each of its layers, and the last stage at the
    final norm too: 2 L/pp calls on stage 0, 2 L/pp + 1 on stage 1; its
    cache (and the last stage's logits) equal the same stage's with the
    plain norm."""
    from dllama_tpu_torch.models.llama import KVCache
    from dllama_tpu_torch.parallel.pipeline import make_pp_forward
    from tests.test_golden import GOLDEN_PROMPT

    cfg, params = _golden()
    per_stage = cfg.n_layers // 2
    calls = []

    def norm(x, w, eps):
        calls.append(tuple(x.shape))
        return layers.rms_norm_plain(x, w, eps)

    class Hop:
        index, size = stage, 2

        def hop(self, x, into):
            return None if into is None else into.copy_(torch.linspace(-1, 1, into.numel())
                                                        .reshape(into.shape))

        def broadcast(self, t, src):
            return t

    class Exchange:
        pp, ffn_sharded, logits_sharded = Hop(), False, False

        def open_forward(self):
            pass

        def close_forward(self, b, t):
            pass

        def reduce_partial(self, o):
            return o

    rope = layers.build_rope_cache(cfg)
    toks = torch.tensor([GOLDEN_PROMPT])
    out = []
    for n in (norm, None):
        full = KVCache.create(cfg, 1, torch.float32)
        cache = KVCache(full.k[:per_stage].clone(), full.v[:per_stage].clone())
        fn = make_pp_forward(cfg, Exchange(), norm=n)
        out.append((fn(params, toks, 0, cache, rope), cache))
    assert len(calls) == 2 * per_stage + (stage == 1)
    assert all(c[-1] == cfg.dim for c in calls)
    (logits, cache), (plain_logits, plain_cache) = out
    assert torch.equal(cache.k, plain_cache.k) and torch.equal(cache.v, plain_cache.v)
    assert stage == 0 or torch.equal(logits, plain_logits)
