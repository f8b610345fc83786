"""What ep does not split runs replicated over ep, as in the JAX package: a
model without experts on ep=2 (every leaf's spec there names no ep axis),
and an MoE model on an ep that does not divide its experts (ep=3 on 4,
whose stacks _sanitize replicates). Worlds over gloo on the CPU of
tests/test_torch_mesh_ep.py's widths, f32. Its own module, as the world
of tests/test_torch_mesh_ep.py holds the test process's process group
while that module runs."""

import numpy as np
import torch

from dllama_tpu_torch.engine.engine import InferenceEngine
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.parallel import mesh as pmesh, multihost
from tests.test_torch_mesh_ep import TOL, KW, jax_cfg, jax_shardings, make_tree, steps

torch.set_num_threads(1)


def test_a_dense_model_on_ep_runs_replicated(tmp_path):
    """Every rank holds the whole tree and runs the unsharded path, with no
    exchange: the prefill and two decode logits bit-equal to one device's,
    and the parameter bytes of every rank the whole tree's."""
    from dllama_tpu_torch.utils.profiling import params_nbytes

    dense = dict(KW, n_experts=0, n_active_experts=0)
    _, params = make_tree(7, n_experts=0, n_active_experts=0)
    w = multihost.launch_tree(LlamaConfig(**dense), params, pmesh.MeshConfig(ep=2),
                              str(tmp_path), cache_dtype=torch.float32)
    try:
        one = InferenceEngine(LlamaConfig(**dense), params, cache_dtype=torch.float32)
        for x, y in zip(steps(w.engine), steps(one)):
            np.testing.assert_array_equal(x, y)
        assert w.engine.measured_collective_report()["per_op"] == {}
        assert [r["param_bytes"] for r in w.call_all("rank_report")] == \
            [params_nbytes(params)] * 2
    finally:
        w.close()


def test_experts_ep_does_not_divide_run_replicated(tmp_path):
    """ep=3 on 4 experts: every rank holds every expert and runs them all,
    with no ep sum (a sum would count each expert's output three times):
    the prefill and two decode logits within JAX's bound of JAX's engine on
    the same mesh and bit-equal to the port's unsharded dense engine, and
    every rank's parameter bytes the whole tree's."""
    import jax.numpy as jnp

    from dllama_tpu.engine.engine import InferenceEngine as JaxEngine
    from dllama_tpu_torch.utils.profiling import params_nbytes

    jp, params = make_tree(5)
    w = multihost.launch_tree(LlamaConfig(**KW), params, pmesh.MeshConfig(ep=3),
                              str(tmp_path), cache_dtype=torch.float32)
    try:
        assert (w.engine.cfg.ep, w.engine.moe_impl) == (1, "dense")
        got = steps(w.engine)
        one = InferenceEngine(LlamaConfig(**KW), params, cache_dtype=torch.float32,
                              moe_impl="dense")
        for x, y in zip(got, steps(one)):
            np.testing.assert_array_equal(x, y)
        jeng = JaxEngine(jax_cfg(), jp, cache_dtype=jnp.float32, attn_impl="jnp",
                         moe_impl="dense", shardings=jax_shardings("ep=3"))
        for x, y in zip(got, steps(jeng)):
            np.testing.assert_allclose(x, y, **TOL)
        assert w.engine.measured_collective_report()["per_op"] == {}
        assert [r["param_bytes"] for r in w.call_all("rank_report")] == \
            [params_nbytes(params)] * 3
    finally:
        w.close()
