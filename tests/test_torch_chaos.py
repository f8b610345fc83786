"""The port's chaos drill (``dllama_tpu_torch/experiments/chaos.py``), as
``tests/test_chaos.py`` runs the JAX package's: a bounded seeded soak of
mixed greedy/sampled/penalized/deadline traffic through a warm-restart-
enabled paged scheduler under a seeded fault schedule, and a reduced
multi-replica soak of CLI replicas behind the router. Each entry point
asserts its own contract: every request terminal, a clean ``PagePool.audit()``
with zero leaked pages, ``/health`` recovered, the restart/recovered/
timeout counters reconciled against the flight recorder; on the mesh, every
stream's token positions exactly 0..n-1 across failovers."""

import numpy as np
import pytest
import torch

from dllama_tpu_torch.experiments import chaos

torch.set_num_threads(1)


def test_random_params_are_the_jax_packages():
    import jax
    import jax.numpy as jnp

    from dllama_tpu.models.config import LlamaConfig as JaxConfig
    from dllama_tpu.models.llama import random_params
    from dllama_tpu_torch.models.config import LlamaConfig

    kw = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=96,
              seq_len=64)
    want = jax.tree_util.tree_flatten_with_path(
        random_params(JaxConfig(**kw), seed=3, dtype=jnp.float32, quantize=False))[0]
    got = chaos.random_params(LlamaConfig(**kw), seed=3)
    for path, leaf in want:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf), err_msg=str(path))


def test_host_tier_counts_reconcile_across_a_warm_restart():
    """A warm restart empties the host tier and starts its counts again, as
    the JAX package's restart makes a new tier: spilled = used + restored +
    dropped, the soak's reconciliation, holds after it."""
    import threading

    from dllama_tpu_torch.engine.batch import HostKVPool

    host = HostKVPool(2, 8, threading.Lock(), (2, 8, 4), torch.float32)
    for key in ((1,) * 8, (2,) * 8, (3,) * 8):
        assert host.put(key, lambda k, v: None)
    st = host.stats()
    assert (st["spilled"], st["used"], st["dropped"]) == (3, 2, 1)
    host.reset()
    st = host.stats()
    assert st["spilled"] == st["used"] + st["restored"] + st["dropped"] == 0
    assert host.put((4,) * 8, lambda k, v: None) and host.stats()["spilled"] == 1


@pytest.mark.parametrize("seed", [1, 2])
def test_mini_chaos_soak_terminal_audit_recovery(seed):
    report = chaos.run_chaos(n_requests=30, seed=seed, clients=3, client_deadline_s=90.0,
                             device="cpu")
    assert report["ok"], report["problems"]
    # the soak exercised the self-healing machinery: faults fired, and every
    # submitted request has a recorded outcome
    assert report["faults_injected"] > 0
    assert sum(report["finish_reasons"].values()) == 30
    assert report["pages_leaked"] == 0 and report["audit"]["ok"]


def test_mesh_chaos_two_replicas_failover():
    report = chaos.run_mesh_chaos(n_replicas=2, n_requests=10, seed=3, clients=2,
                                  boot_deadline_s=120.0, device="cpu")
    assert report["ok"], report["problems"]
    assert report["failovers"].get("resumed", 0) >= 1
    assert report["chaos_events"] >= 1 and report["trace_cross_replica_resumed"] >= 1
    assert sum(report["finish_reasons"].values()) == 10
