"""The port's sparse MoE (``ops.layers.moe_ffn``, ``--moe``) against the JAX
package on tiny shapes (dim 64, hidden 96, 2 layers, 4/2 heads, 4 experts
with 2 active, as tests/test_moe.py).

* ``moe_ffn`` with each scheme (auto, dense, sort, dispatch) on f32 and Q40
  expert stacks equals JAX's within 1e-5 of max|out| (f32: only the order of
  sums differs), and a per-token loop in float64 within 1e-4 of max|out|.
* dispatch drops what JAX drops at ``capacity_factor = 1.0``; top-1 routing
  is the argmax expert's SwiGLU.
* The card's fixed-shape route (``moe_ffn_static``: dense, sort on fixed
  buffers, dispatch), run with the plain matmul on the CPU, equals the plain
  schemes within 1e-5 of max|out|; its buffers hold JAX's sorted rows.
* A full MoE forward on the dense cache and through the paged gather equals
  JAX's ``forward`` on the same ``params_from_numpy`` tree within 1e-4 of
  max|logit|, with equal argmax.
* Greedy ids are bit-exact against JAX's ``InferenceEngine`` and against
  JAX's ``Scheduler`` over a paged ``BatchEngine`` with hybrid admission and
  the radix tree on.
* The format round trip: the port's ``save_model`` read by JAX's
  ``load_params`` gives the port's tree, and JAX's ``save_model`` read by
  the port's gives JAX's (Q80 experts: packed in the port, dense in JAX, the
  same values).
* ``--fuse-weights`` on an MoE model fuses wqkv alone; the config writes and
  reads both expert keys; the CLI parses ``--moe``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from dllama_tpu_torch.convert import paged_cache_from_numpy, params_from_numpy
from dllama_tpu_torch.engine.batch import BatchEngine
from dllama_tpu_torch.engine.engine import InferenceEngine
from dllama_tpu_torch.engine.kernel_select import resolve_moe_impl
from dllama_tpu_torch.engine.sampling import Sampler
from dllama_tpu_torch.models import formats
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.models.llama import KVCache, forward, fuse_layer_weights
from dllama_tpu_torch.ops import layers
from dllama_tpu_torch.ops.matmul import matmul
from dllama_tpu_torch.ops.quant import FloatType, Q8Tensor, QTensor, slice_leaf
from dllama_tpu_torch.serve.scheduler import Scheduler

torch.set_num_threads(1)

KW = dict(dim=64, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
          seq_len=64, n_experts=4, n_active_experts=2)
CFG = LlamaConfig(**KW)
RTOL_FFN = 1e-5  # x max|out|: f32 on both sides, only the order of sums differs
RTOL_FWD = 1e-4  # x max|logit|: as tests/test_torch_model.py
PLAIN_MM = functools.partial(matmul, backend="torch")
SCHEMES = ("auto", "dense", "sort", "dispatch")


def jax_cfg(**kw):
    from dllama_tpu.models.config import LlamaConfig as JaxConfig

    return JaxConfig(**dict(KW, **kw))


@pytest.fixture(scope="module")
def stacks():
    """{weight kind: (port (gate, w1, w2, w3) of layer 0, JAX's)} from one
    random MoE tree of the JAX package (f32 leaves, Q40 stacks)."""
    import jax
    import jax.numpy as jnp

    from dllama_tpu.models.llama import random_params

    out = {}
    for kind, quant in (("f32", False), ("q40", True)):
        jp = random_params(jax_cfg(), seed=5, dtype=jnp.float32, quantize=quant)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp))
        jl, tl = jp["layers"], tp["layers"]
        jw = tuple(jax.tree.map(lambda x: x[0], jl[k]) for k in ("moe_w1", "moe_w2", "moe_w3"))
        tw = tuple(slice_leaf(tl[k], 0) for k in ("moe_w1", "moe_w2", "moe_w3"))
        out[kind] = ((tl["moe_gate"][0], *tw), (jl["moe_gate"][0], *jw))
    return out


def _h(seed, b=2, t=5, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((b, t, KW["dim"])) * scale).astype(
        np.float32)


def naive_moe(h, gate, w1, w2, w3, k):
    """The per-token loop of tests/test_moe.py in float64: route, run only
    the chosen experts, combine."""
    b, t, _ = h.shape
    out = np.zeros(h.shape, np.float64)
    for bi in range(b):
        for ti in range(t):
            x = h[bi, ti].astype(np.float64)
            logits = x @ gate
            top = np.argsort(-logits)[:k]
            p = np.exp(logits[top] - logits[top].max())
            p /= p.sum()
            for wt, e in zip(p, top):
                g = x @ w1[e]
                out[bi, ti] += wt * ((g / (1.0 + np.exp(-g)) * (x @ w3[e])) @ w2[e])
    return out


def _dense(w):
    return (w.dequantize(torch.float32) if isinstance(w, (QTensor, Q8Tensor)) else w).numpy()


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


@pytest.mark.parametrize("kind", ["f32", "q40"])
@pytest.mark.parametrize("impl", SCHEMES)
def test_moe_ffn_matches_jax_and_the_loop(stacks, kind, impl):
    import jax.numpy as jnp

    from dllama_tpu.ops.layers import moe_ffn as jax_moe

    (tg, *tw), (jg, *jw) = stacks[kind]
    h = _h(1)
    got = layers.moe_ffn(CFG, torch.from_numpy(h), tg, *tw, impl=impl).numpy()
    want = np.asarray(jax_moe(jax_cfg(), jnp.asarray(h), jg, *jw, impl=impl))
    _close(got, want, RTOL_FFN)
    # 2 * 5 rows, 4 experts, k = 2: dispatch's capacity is every row, no drop
    _close(got, naive_moe(h, tg.numpy(), *(_dense(w) for w in tw), CFG.n_active_experts),
           1e-4)


def test_moe_auto_rule_follows_jax(stacks, monkeypatch):
    """auto is sort at N >= E and dense below, on the CPU."""
    (tg, *tw), _ = stacks["f32"]
    seen = []
    bincount = torch.bincount

    def spy(*a, **k):  # only the sort scheme counts its groups on the host
        seen.append(True)
        return bincount(*a, **k)

    monkeypatch.setattr(torch, "bincount", spy)
    layers.moe_ffn(CFG, torch.from_numpy(_h(2, 1, 3)), tg, *tw)  # N = 3 < E
    assert not seen
    layers.moe_ffn(CFG, torch.from_numpy(_h(2, 1, 4)), tg, *tw)  # N = 4 >= E
    assert seen


def test_moe_dispatch_capacity_drop_semantics(stacks):
    """Every token routed to expert 0 with k = 1 at capacity factor 1.0:
    the first C = ceil(8 / 4) = 2 tokens equal dense, the rest are zero,
    as in JAX."""
    import jax.numpy as jnp

    from dllama_tpu.ops.layers import moe_ffn as jax_moe

    cfg = dataclasses.replace(CFG, n_active_experts=1)
    _, *tw = stacks["f32"][0]
    _, *jw = stacks["f32"][1]
    h = np.abs(_h(3, 1, 8))
    gate = np.zeros((KW["dim"], 4), np.float32)
    gate[:, 0] = 1.0
    got = layers.moe_ffn(cfg, torch.from_numpy(h), torch.from_numpy(gate), *tw,
                         impl="dispatch", capacity_factor=1.0).numpy()
    dense = layers.moe_ffn(cfg, torch.from_numpy(h), torch.from_numpy(gate), *tw,
                           impl="dense").numpy()
    want = np.asarray(jax_moe(jax_cfg(n_active_experts=1), jnp.asarray(h), jnp.asarray(gate),
                              *jw, impl="dispatch", capacity_factor=1.0))
    assert layers.moe_capacity(8, 1, 4, 1.0) == 2
    _close(got[0, :2], dense[0, :2], RTOL_FFN)
    np.testing.assert_array_equal(got[0, 2:], 0.0)
    _close(got, want, RTOL_FFN)
    static = layers.moe_ffn_static(cfg, torch.from_numpy(h), torch.from_numpy(gate), *tw,
                                   PLAIN_MM, impl="dispatch", capacity_factor=1.0).numpy()
    _close(static, got, RTOL_FFN)


def test_moe_top1_selects_single_expert(stacks):
    cfg = dataclasses.replace(CFG, n_active_experts=1)
    (tg, *tw), _ = stacks["f32"]
    h = _h(4, 1, 3)
    got = layers.moe_ffn(cfg, torch.from_numpy(h), tg, *tw).numpy()
    w1, w2, w3 = (_dense(w) for w in tw)
    for ti in range(3):
        x = h[0, ti].astype(np.float64)
        e = int(np.argmax(x @ tg.numpy()))
        g = x @ w1[e]
        want = (g / (1 + np.exp(-g)) * (x @ w3[e])) @ w2[e]
        _close(got[0, ti], want, 1e-5)


@pytest.mark.parametrize("kind", ["f32", "q40"])
@pytest.mark.parametrize("impl", ["dense", "sort", "dispatch"])
def test_static_route_matches_the_plain_schemes(stacks, kind, impl):
    """The card's bodies (every shape fixed by B and T, one matmul a expert
    product) with the plain matmul on the CPU: dense and sort equal the
    exact schemes, dispatch equals plain dispatch at the same capacity
    (here one that drops)."""
    (tg, *tw), _ = stacks[kind]
    h = torch.from_numpy(_h(6, 2, 8, scale=3.0))
    cf = 0.75 if impl == "dispatch" else 2.0
    want = layers.moe_ffn(CFG, h, tg, *tw, impl=impl, capacity_factor=cf).numpy()
    got = layers.moe_ffn_static(CFG, h, tg, *tw, PLAIN_MM, impl=impl,
                                capacity_factor=cf).numpy()
    _close(got, want, RTOL_FFN)
    if impl == "dense":  # auto on the card
        auto = layers.moe_ffn_static(CFG, h, tg, *tw, PLAIN_MM, impl="auto").numpy()
        np.testing.assert_array_equal(auto, got)


def test_moe_buffers_hold_the_sorted_rows():
    """Buffer row (e, r) is the token of the r-th choice routed to e in
    token-major order (JAX's stable sort), zero past e's count; ranks and
    keeps follow JAX's one-hot cumsum."""
    rng = np.random.default_rng(7)
    n, k, e, c = 9, 2, 4, 3
    topi = np.stack([rng.choice(e, k, replace=False) for _ in range(n)])
    hf = rng.standard_normal((n, 5)).astype(np.float32)
    ei, ri, keep, buf = layers.moe_buffers(torch.from_numpy(hf), torch.from_numpy(topi), e, c)
    assign = topi.reshape(-1)
    want = np.zeros((e, c, 5), np.float32)
    seen = np.zeros(e, int)
    for j, x in enumerate(assign):
        r = seen[x]
        seen[x] += 1
        assert int(keep[j]) == (r < c)
        if r < c:
            want[x, r] = hf[j // k]
            assert (int(ei[j]), int(ri[j])) == (x, r)
        else:
            assert (int(ei[j]), int(ri[j])) == (0, 0)
    np.testing.assert_array_equal(buf.numpy(), want)


@pytest.fixture(scope="module")
def models():
    """(JAX config, JAX params, the port's tree) of one random Q40 MoE
    model of the JAX package, f32 activations."""
    import jax
    import jax.numpy as jnp

    from dllama_tpu.models.llama import random_params

    jparams = random_params(jax_cfg(), seed=3, dtype=jnp.float32)
    return jax_cfg(), jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


def test_params_from_numpy_carries_the_moe_tree(models):
    _, jparams, params = models
    lay = params["layers"]
    assert isinstance(lay["moe_w1"], QTensor)
    assert tuple(lay["moe_w1"].packed.shape) == (2, 4, 32, 96)
    assert tuple(lay["moe_w2"].scales.shape) == (2, 4, 3, 64)
    assert lay["moe_gate"].dtype == torch.float32 and tuple(lay["moe_gate"].shape) == (2, 64, 4)
    np.testing.assert_array_equal(lay["moe_w3"].packed.numpy(),
                                  np.asarray(jparams["layers"]["moe_w3"].packed))
    assert not {"w1", "w2", "w3"} & set(lay)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_moe_forward_matches_jax(models, layout):
    import jax.numpy as jnp

    from dllama_tpu.models.llama import KVCache as JaxKV
    from dllama_tpu.models.llama import PagedKVCache as JaxPaged
    from dllama_tpu.models.llama import forward as jax_forward
    from dllama_tpu.ops.layers import build_rope_cache as jax_rope

    jcfg, jparams, params = models
    rng = np.random.default_rng(11)
    page, nb = 8, 8
    if layout == "paged":
        jcache = JaxPaged.create(jcfg, 2, 2 * nb, page, jnp.float32, nb)
        tables = rng.permutation(2 * nb).reshape(2, nb).astype(np.int32)
        jcache = JaxPaged(jcache.k, jcache.v, jnp.asarray(tables))
        cache = paged_cache_from_numpy(
            {"k": np.asarray(jcache.k), "v": np.asarray(jcache.v), "tables": tables})
    else:
        jcache = JaxKV.create(jcfg, 2, jnp.float32)
        cache = KVCache.create(CFG, 2, torch.float32)
    rope, jrope = layers.build_rope_cache(CFG), jax_rope(jcfg)
    toks = rng.integers(0, KW["vocab_size"], (2, 7))
    pos = np.array([0, 9], np.int32)
    for t, p in ((toks[:, :6], pos), (toks[:, 6:], pos + 6)):
        want, jcache = jax_forward(jcfg, jparams, jnp.asarray(t, jnp.int32), jnp.asarray(p),
                                   jcache, jrope)
        got, _ = forward(CFG, params, torch.from_numpy(t), torch.from_numpy(p), cache, rope)
        want = np.asarray(want)
        _close(got.numpy(), want, RTOL_FWD)
        np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


def test_moe_forward_schemes_agree(models):
    """The forward under each scheme: dense and sort equal (exact schemes),
    dispatch drop-free at this size."""
    _, _, params = models
    toks = torch.from_numpy(np.random.default_rng(12).integers(0, 128, (1, 9)))
    rope = layers.build_rope_cache(CFG)
    out = {impl: forward(CFG, params, toks, 0, KVCache.create(CFG, 1, torch.float32), rope,
                         moe_impl=impl)[0].numpy() for impl in SCHEMES}
    for impl in SCHEMES:
        _close(out[impl], out["dense"], RTOL_FWD)


def test_greedy_ids_match_jax_inference_engine(models):
    import jax.numpy as jnp

    from dllama_tpu.engine.engine import InferenceEngine as JaxEngine
    from dllama_tpu.engine.sampling import Sampler as JaxSampler

    jcfg, jparams, params = models
    prompt = [3, 17, 5, 99, 42, 7]
    for impl in ("auto", "sort"):
        jeng = JaxEngine(jcfg, jparams, cache_dtype=jnp.float32, moe_impl=impl)
        want = list(jeng.generate(prompt, 12, JaxSampler(0.0, 0.9, 1)))
        eng = InferenceEngine(CFG, params, cache_dtype=torch.float32, moe_impl=impl)
        assert eng.moe_impl == impl
        assert list(eng.generate(prompt, 12, Sampler(0.0, 0.9, 1))) == want


def _greedy_traffic(sched):
    """Two greedy decoders, then a joiner whose 20-token prompt admits in
    hybrid slices while they decode, and a request sharing the first's
    prompt (a radix hit)."""
    a = sched.submit([1, 2, 3, 4, 5, 6, 7, 8, 9], 0.0, 0.9, 12, frozenset(), seed=1)
    b = sched.submit([9, 8, 7], 0.0, 0.9, 12, frozenset(), seed=2)
    it_a = a.tokens()
    head = [next(it_a), next(it_a)]
    c = sched.submit([int(x) % 120 + 1 for x in range(30, 50)], 0.0, 0.9, 8, frozenset(),
                     seed=3)
    d = sched.submit([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], 0.0, 0.9, 6, frozenset(), seed=4)
    return [head + list(it_a), list(b.tokens()), list(c.tokens()), list(d.tokens())]


def test_greedy_ids_match_the_jax_scheduler_hybrid_and_radix_on(models):
    import jax.numpy as jnp

    from dllama_tpu.engine.batch import BatchEngine as JaxBatch
    from dllama_tpu.serve.scheduler import Scheduler as JaxScheduler

    jcfg, jparams, params = models
    kw = dict(n_slots=3, kv_layout="paged", page_size=8, max_prefill_chunk=8)
    jsched = JaxScheduler(JaxBatch(jcfg, jparams, cache_dtype=jnp.float32, **kw), chunk=4,
                          prefill_budget="auto", preempt="off")
    try:
        want = _greedy_traffic(jsched)
    finally:
        jsched.shutdown()
    eng = BatchEngine(CFG, params, cache_dtype=torch.float32, moe_impl="auto", **kw)
    eng.pool.audit_on_release = True
    sched = Scheduler(eng, prefill_budget="auto", preempt="off")
    try:
        got = _greedy_traffic(sched)
        summary = sched.latency_summary()
    finally:
        sched.shutdown()
    assert got == want
    assert eng.radix is not None and summary["hybrid"]["chunks"] > 0
    assert summary["radix"]["hit_tokens"] > 0
    assert eng.pool.audit()["ok"]


def _tree_equal(a, b, path="params"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, QTensor):
        assert torch.equal(a.packed, b.packed) and torch.equal(a.scales, b.scales), path
    elif isinstance(a, Q8Tensor):
        assert torch.equal(a.codes, b.codes) and torch.equal(a.scales, b.scales), path
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize("wt", ["F32", "Q40", "Q80"])
def test_format_round_trip_with_jax(tmp_path, wt):
    """The port's writer -> JAX's reader -> the port's tree, and JAX's
    writer -> the port's reader -> JAX's tree. Q80 experts load packed in
    the port and dense in JAX: the port's dequantized to the load dtype
    equal JAX's bit for bit."""
    import jax
    import jax.numpy as jnp

    from dllama_tpu.models import formats as jf

    cfg = dataclasses.replace(CFG, weight_type=FloatType[wt])
    jcfg = jax_cfg(weight_type=jf.FloatType[wt])
    rng = np.random.default_rng(13)
    tensors = {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
               for n, s, _ in formats.tensor_plan(cfg)}
    assert [n for n, _, _ in formats.tensor_plan(cfg)] == [n for n, _, _ in jf.tensor_plan(jcfg)]
    for writer, path in ((formats.save_model, tmp_path / "port.m"),
                         (jf.save_model, tmp_path / "jax.m")):
        writer(str(path), cfg if writer is formats.save_model else jcfg, tensors)
        tcfg, hs = formats.read_header(str(path))
        jc, jhs = jf.read_header(str(path))
        assert (tcfg.n_experts, tcfg.n_active_experts) == (4, 2) == (jc.n_experts,
                                                                    jc.n_active_experts)
        port = formats.load_params(str(path), tcfg, hs, dtype=torch.float32)
        # q80_packed: what the JAX package's load_model passes on one device
        theirs = jf.load_params(str(path), jc, jhs, dtype=jnp.float32, q80_packed=True)
        theirs = params_from_numpy(jax.tree.map(np.asarray, theirs))
        if wt == "Q80":
            for k in ("moe_w1", "moe_w2", "moe_w3"):
                assert isinstance(port["layers"][k], Q8Tensor)
                port["layers"][k] = port["layers"][k].dequantize(torch.float32)
        _tree_equal(port, theirs)
    assert open(tmp_path / "port.m", "rb").read() == open(tmp_path / "jax.m", "rb").read()


def test_stacks_are_filled_in_place(models, tmp_path):
    """load_params makes each key's [L, ...] stack once (one storage for
    the whole stack, every layer's leaf a view of it)."""
    cfg = dataclasses.replace(CFG, weight_type=FloatType.Q40)
    rng = np.random.default_rng(14)
    formats.save_model(str(tmp_path / "m.m"), cfg,
                       {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
                        for n, s, _ in formats.tensor_plan(cfg)})
    c, hs = formats.read_header(str(tmp_path / "m.m"))
    lay = formats.load_params(str(tmp_path / "m.m"), c, hs)["layers"]
    assert list(lay) == ["wq", "wk", "wv", "wo", "moe_gate", "moe_w1", "moe_w2", "moe_w3",
                         "rms_att", "rms_ffn"]
    w1 = lay["moe_w1"]
    assert w1.packed.is_contiguous() and tuple(w1.packed.shape) == (2, 4, 32, 96)
    assert slice_leaf(w1, 1).packed[3].data_ptr() == w1.packed[1, 3].data_ptr()


def test_fuse_weights_on_moe_fuses_wqkv_only(models):
    _, _, params = models
    fused = fuse_layer_weights(params["layers"])
    assert "wqkv" in fused and "w13" not in fused
    assert {"moe_w1", "moe_w2", "moe_w3", "moe_gate"} <= set(fused)
    eng = InferenceEngine(CFG, params, cache_dtype=torch.float32, fuse_weights=True)
    ref = InferenceEngine(CFG, params, cache_dtype=torch.float32)
    prompt = [3, 17, 5, 99]
    assert (list(eng.generate(prompt, 6, Sampler(0.0, 0.9, 1)))
            == list(ref.generate(prompt, 6, Sampler(0.0, 0.9, 1))))


def test_config_writes_and_reads_the_expert_keys():
    from dllama_tpu.models.config import LlamaConfig as JaxConfig

    kv = CFG.to_header_kv()
    assert (7, 4) in kv and (8, 2) in kv
    back = LlamaConfig.from_header_kv(kv)
    assert (back.n_experts, back.n_active_experts) == (4, 2)
    assert kv == [tuple(p) for p in JaxConfig(**KW).to_header_kv()]
    assert CFG.describe() == JaxConfig(**KW).describe()
    assert CFG.describe().endswith(" experts=4/2")


def test_resolve_moe_impl_and_the_cli():
    from dllama_tpu.cli.main import build_parser as jax_parser
    from dllama_tpu_torch.cli.main import build_parser

    for impl in SCHEMES:
        assert resolve_moe_impl(impl) == impl
    with pytest.raises(ValueError):
        resolve_moe_impl("ragged")
    ours = {a.dest: a for a in build_parser()._actions}
    theirs = {a.dest: a for a in jax_parser()._actions}
    assert list(ours["moe"].choices) == list(theirs["moe"].choices)
    assert set(ours["moe"].choices) == set(SCHEMES) == set(layers.MOE_IMPLS)
    assert ours["moe"].default == theirs["moe"].default == "auto"
    assert build_parser().parse_args(["serve", "--moe", "sort"]).moe == "sort"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["serve", "--moe", "ragged"])


def test_cost_model_prices_the_expert_stacks_like_jax(models):
    """decode_step_bytes prices the resident parameter bytes, the [L, E, ...]
    expert stacks included, as the JAX engine's cost model does."""
    import jax.numpy as jnp

    from dllama_tpu.engine.batch import BatchEngine as JaxBatch
    from dllama_tpu_torch.utils.profiling import params_nbytes

    jcfg, jparams, params = models
    kw = dict(n_slots=2, kv_layout="paged", page_size=8)
    tcm = BatchEngine(CFG, params, cache_dtype=torch.float32, **kw).chunk_cost_model()
    jcm = JaxBatch(jcfg, jparams, cache_dtype=jnp.float32, **kw).chunk_cost_model()
    assert tcm.__dict__ == jcm.__dict__
    moe = ("moe_w1", "moe_w2", "moe_w3")
    experts = params_nbytes({k: params["layers"][k] for k in moe})
    rest = dict(params, layers={k: v for k, v in params["layers"].items() if k not in moe})
    assert tcm.weight_bytes == params_nbytes(rest) + experts and experts > 0
    assert tcm.step_bytes(2, 20.0) == jcm.step_bytes(2, 20.0)
