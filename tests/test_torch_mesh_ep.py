"""The port's ep mesh axis (an MoE model's experts split over ranks) against
the JAX package's ep mesh, on the CPU: an ep=2 and an ep=2 x tp=2 world
(each rank a process over gloo, module-scoped) of tests/test_moe.py's
moe_cfg() (dim 64, hidden 96, 2 layers, 4/2 heads, 4 experts with 2
active) in f32, the JAX side the test process's virtual CPU devices.

* The single engine's prefill and two decode steps within 1e-4/1e-4
  (JAX's bound, tests/test_moe.py) of JAX's InferenceEngine on the same
  mesh, under ``dense`` and under ``dispatch``. (An ep that does not
  divide the experts: tests/test_torch_mesh_ep_dense.py.)
* resolve_moe_impl on an ep mesh as JAX's: ``auto`` -> ``dense``,
  ``sort`` raises JAX's message, ``dispatch`` stays. Two ranks' MoE FFN
  partials sum to the whole FFN under every scheme, on the CPU's route and
  the card's fixed-shape one.
* A dense BatchEngine of 4 slots on each world: greedy, seeded sampled and
  penalized streams through the Scheduler bit-equal to the unsharded
  port's; its greedy ids equal to JAX's unsharded BatchEngine's.
  (tests/test_torch_mesh_ep_dense.py: a model without experts on ep.)
* Each rank holds only its E/ep experts, and one decode step's exchange is
  the bytes of its shapes.
* The CLI: ``serve --slots 2 --mesh ep=2`` on a MoE file answers a chat
  completion.
"""

import http.client
import json
import os
import re
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from dllama_tpu_torch.convert import params_from_numpy
from dllama_tpu_torch.engine.batch import BatchEngine
from dllama_tpu_torch.engine.engine import InferenceEngine
from dllama_tpu_torch.engine.kernel_select import resolve_moe_impl
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.parallel import mesh as pmesh, multihost
from dllama_tpu_torch.parallel.sharding import LlamaShardings
from dllama_tpu_torch.serve.scheduler import Scheduler

torch.set_num_threads(1)

KW = dict(dim=64, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
          seq_len=32, n_experts=4, n_active_experts=2)
TOL = dict(atol=1e-4, rtol=1e-4)  # JAX's bound for ep=2 x tp=2 (tests/test_moe.py)
PROMPT = [5, 9, 2, 7, 1, 3]


def jax_cfg(**kw):
    from dllama_tpu.models.config import LlamaConfig as JaxConfig

    return JaxConfig(**dict(KW, **kw))


def jax_shardings(spec: str, **kw):
    from dllama_tpu.parallel.mesh import MeshConfig, make_mesh
    from dllama_tpu.parallel.sharding import LlamaShardings as JaxShardings

    return JaxShardings(make_mesh(MeshConfig.parse(spec)), jax_cfg(**kw))


def steps(eng) -> list:
    """[prefill logits, two decode steps' logits], each the argmax fed."""
    eng.reset(0)
    out = [np.asarray(eng.prefill(np.asarray([PROMPT])), np.float32).reshape(-1)]
    for _ in range(2):
        tok = int(np.argmax(out[-1]))
        out.append(np.asarray(eng.decode_step(np.array([[tok]])), np.float32).reshape(-1))
    return out


def make_tree(seed: int, **kw):
    import jax
    import jax.numpy as jnp

    from dllama_tpu.models.llama import random_params

    jp = random_params(jax_cfg(**kw), seed=seed, dtype=jnp.float32, quantize=False)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def tree():
    return make_tree(5)


@pytest.fixture(scope="module", params=["ep=2", "ep=2,tp=2"])
def world(request, tree, tmp_path_factory):
    w = multihost.launch_tree(LlamaConfig(**KW), tree[1], pmesh.MeshConfig.parse(request.param),
                              str(tmp_path_factory.mktemp("ep")), cache_dtype=torch.float32)
    yield types.SimpleNamespace(world=w, eng=w.engine, spec=request.param,
                                config=w.mesh.config)
    w.close()


@pytest.mark.parametrize("impl", ["dense", "dispatch"])
def test_ep_engine_matches_jax(world, tree, impl):
    import jax.numpy as jnp

    from dllama_tpu.engine.engine import InferenceEngine as JaxEngine

    eng = world.eng if impl == "dense" else world.world.make(
        "engine", moe_impl=impl, cache_dtype=torch.float32)
    assert eng.moe_impl == impl
    jeng = JaxEngine(jax_cfg(), tree[0], cache_dtype=jnp.float32, attn_impl="jnp",
                     moe_impl=impl, shardings=jax_shardings(world.spec))
    for x, y in zip(steps(eng), steps(jeng)):
        np.testing.assert_allclose(x, y, **TOL)
    assert len(set(world.world.call_all("rank_digest"))) == 1


@pytest.mark.parametrize("impl", ["auto", "dense", "dispatch", "sort"])
def test_resolve_moe_impl_equals_jax(impl):
    """On ep=2 (and ep=2 x tp=2) the port resolves every scheme as JAX's
    resolve_moe_impl(impl, shardings); off ep it keeps the scheme."""
    from dllama_tpu.engine.kernel_select import resolve_moe_impl as jax_resolve

    for spec in ("ep=2", "ep=2,tp=2", "tp=2"):
        sh = LlamaShardings(pmesh.Mesh(pmesh.MeshConfig.parse(spec)), LlamaConfig(**KW))
        try:
            want = jax_resolve(impl, jax_shardings(spec))
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                resolve_moe_impl(impl, sh)
            assert impl == "sort" and "ep" in spec
            continue
        assert resolve_moe_impl(impl, sh) == want


@pytest.mark.parametrize("route,impl", [("cpu", "dense"), ("cpu", "dispatch"),
                                        ("static", "dense"), ("static", "dispatch"),
                                        ("static", "sort")])
def test_ep_partials_sum_to_the_whole_ffn(route, impl):
    """Each of two ep ranks' MoE FFN over its half of the experts (the
    router over all four), summed, equals the FFN over every expert within
    1e-5 of max|out| (f32; only the order of sums differs), on the CPU's
    route (dense and dispatch; its sort takes whole stacks only) and on
    the card's fixed-shape route (moe_ffn_static, plain matmuls, every
    scheme); dispatch at a capacity that drops choices, counted from the
    global E on both sides."""
    import functools

    from dllama_tpu_torch.ops import layers
    from dllama_tpu_torch.ops.matmul import matmul
    from dllama_tpu_torch.parallel.sharding import LocalLlamaConfig

    gen = torch.Generator().manual_seed(9)
    d, f, e = KW["dim"], KW["hidden_dim"], KW["n_experts"]
    h = torch.randn(2, 7, d, generator=gen)
    gate = torch.randn(d, e, generator=gen)
    w1, w3 = (torch.randn(e, d, f, generator=gen) * 0.1 for _ in range(2))
    w2 = torch.randn(e, f, d, generator=gen) * 0.1
    mm = functools.partial(matmul, backend="torch")

    def ffn(cfg, ws):
        if route == "cpu":
            return layers.moe_ffn(cfg, h, gate, *ws, impl=impl, capacity_factor=1.0)
        return layers.moe_ffn_static(cfg, h, gate, *ws, mm, impl=impl, capacity_factor=1.0)

    want = ffn(LlamaConfig(**KW), (w1, w2, w3))
    got = sum(ffn(LocalLlamaConfig(**KW, ep=2, expert_offset=lo),
                  tuple(w[lo : lo + e // 2] for w in (w1, w2, w3))) for lo in (0, e // 2))
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5 * scale, rtol=0)


def _workload(sched):
    reqs = [sched.submit(PROMPT * 2, 0.0, 0.9, 10, frozenset(), seed=1),
            sched.submit([9, 8, 7], 0.9, 0.9, 8, frozenset(), seed=2),
            sched.submit(list(range(3, 15)), 1.0, 0.8, 9, frozenset(), seed=4,
                         presence=0.5, frequency=0.3),
            sched.submit([4, 4, 2, 9], 0.7, 0.95, 7, frozenset(), seed=5)]
    try:
        return [list(r.tokens()) for r in reqs]
    finally:
        sched.shutdown()


def _greedy_slots(eng):
    prompts = [PROMPT, [9, 8, 7], list(range(3, 12)), [2, 4, 6, 8, 10]]
    first = [eng.add(s, p, temperature=0.0) for s, p in enumerate(prompts)]
    toks = eng.decode(6)
    return [[f] + [int(t) for t in toks[:, s]] for s, f in enumerate(first)]


def test_ep_batch_engine_streams_equal_one_device(world, tree):
    """Every ep rank holds all 4 slots and runs the same forward with its
    experts: greedy, seeded sampled and penalized streams bit-equal to the
    unsharded port's (phase-split admission on both sides), greedy ids
    equal to JAX's unsharded BatchEngine's."""
    import jax.numpy as jnp

    from dllama_tpu.engine.batch import BatchEngine as JaxBatch

    kw = dict(n_slots=4, cache_dtype=torch.float32, kv_layout="dense", moe_impl="dense")
    be = world.world.make("batch", **kw)
    assert be.block == (0, 4) and be.cache.k.shape[1] == 4 and be.moe_impl == "dense"
    got = _workload(Scheduler(be, prefill_budget=0))
    one = BatchEngine(LlamaConfig(**KW), tree[1], **kw)
    assert got == _workload(Scheduler(one, prefill_budget=0)) and all(len(s) for s in got)
    be = world.world.make("batch", **kw)
    jeng = JaxBatch(jax_cfg(), tree[0], n_slots=4, cache_dtype=jnp.float32, kernels="xla",
                    moe_impl="dense")
    assert _greedy_slots(be) == _greedy_slots(jeng)
    assert len(set(world.world.call_all("rank_digest"))) == 1


def test_each_ep_rank_holds_its_experts(world, tree):
    """Rank 0 holds experts [0, E/ep) of every layer (its tp shard of
    them); every rank's parameter bytes are the whole tree's less the
    experts it does not hold."""
    from dllama_tpu_torch.utils.profiling import params_nbytes

    ep, tp = world.config.ep, world.config.tp
    lay, cfg = world.eng.params["layers"], world.eng.cfg
    e = KW["n_experts"] // ep
    assert (cfg.ep, cfg.expert_offset, cfg.n_experts) == (ep, 0, KW["n_experts"])
    for k in ("moe_w1", "moe_w2", "moe_w3"):
        want = np.asarray(tree[1]["layers"][k][:, :e])
        got = lay[k].numpy()
        assert got.shape[1] == e
        if tp == 1:
            np.testing.assert_array_equal(got, want)
    full = params_nbytes(tree[1])
    experts = params_nbytes({k: tree[1]["layers"][k] for k in ("moe_w1", "moe_w2", "moe_w3")})
    if tp == 1:
        assert [r["param_bytes"] for r in world.world.call_all("rank_report")] == \
            [full - experts // 2] * 2


def test_ep_decode_step_bytes_equal_the_shapes(world):
    """One decode step's exchange: each layer's f32 MoE partials summed over
    ep; with tp also the wo and MoE partials over tp and the f32 logits
    gathered."""
    world.eng.reset(0)
    world.eng.prefill(np.asarray([PROMPT]))
    world.eng.decode_step(np.array([[3]]))
    d, n_layers = KW["dim"], KW["n_layers"]
    want = {"ep:all-reduce": n_layers * d * 4}
    if world.config.tp > 1:
        want.update({"all-reduce": 2 * n_layers * d * 4, "all-gather": KW["vocab_size"] * 4})
    assert world.eng.measured_collective_report()["per_op"] == want


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_serve_on_ep(tmp_path_factory):
    """``serve --slots 2 --mesh ep=2`` on a Q40 MoE file (moe_cfg's widths,
    the golden tokenizer's 1057 ids) answers a greedy chat completion."""
    from dllama_tpu_torch.models import formats
    from dllama_tpu_torch.ops.quant import FloatType
    from tests.test_torch_continuous_serve import _tokenizer_path
    from tests.test_torch_mesh_cli import _free_port

    cfg = LlamaConfig(**dict(KW, vocab_size=1057, seq_len=128, weight_type=FloatType.Q40))
    rng = np.random.default_rng(3)
    tensors = {n: (rng.standard_normal(s) * 0.05).astype(np.float32)
               for n, s, _ in formats.tensor_plan(cfg)}
    path = str(tmp_path_factory.mktemp("ep_cli") / "moe.m")
    formats.save_model(path, cfg, tensors)
    port = _free_port()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "dllama_tpu_torch", "serve", "--model", path, "--tokenizer",
         _tokenizer_path(tmp_path_factory), "--device", "cpu", "--mesh", "ep=2", "--slots",
         "2", "--port", str(port), "--temperature", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        deadline = time.monotonic() + 120
        for line in proc.stdout:
            lines.append(line)
            if "/v1/chat/completions" in line or time.monotonic() > deadline:
                break
        assert proc.poll() is None, "".join(lines)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        body = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 6,
                "temperature": 0}
        conn.request("POST", "/v1/chat/completions", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        reply = json.loads(resp.read())
        assert resp.status == 200, reply
        assert reply["usage"]["completion_tokens"] >= 1
    finally:
        proc.kill()
        proc.wait()
