"""Two small pieces of the port held to the JAX package:

* ``Scheduler.reset_latency_stats`` (JAX ``serve/scheduler.py``): after a
  burst, a reset leaves ``latency_summary()`` and the ``/debug/perf``
  windows empty (the SLO targets, cost model and peak kept), and the first
  host gap after it does not span the reset.
* ``engine.kernel_select.resolve_kernels`` on a head size the attention
  kernels do not take (the golden model's 16): on a CUDA device under
  ``auto``/``cuda`` the Q40/Q80 kernels stay and attention takes the plain
  route (``torch``), as JAX keeps route ``jnp``; no card is needed to
  resolve it.
"""

import http.client
import json
import threading
import time

import pytest
import torch

from dllama_tpu_torch.engine.kernel_select import resolve_kernels
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.ops import flash_attention
from dllama_tpu_torch.ops.layers import gqa_attention
from tests.test_golden import FIXTURE_M
from tests.test_torch_continuous_serve import _tokenizer_path

torch.set_num_threads(1)


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return json.loads(body)


def _chat(port, text, max_tokens=8):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/chat/completions", json.dumps(
        {"messages": [{"role": "user", "content": text}], "temperature": 0,
         "max_tokens": max_tokens}), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    resp.read()
    conn.close()
    return resp.status


def test_reset_latency_stats_empties_the_record(tmp_path_factory):
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.serve.api import make_server

    loaded = load_model(FIXTURE_M, _tokenizer_path(tmp_path_factory),
                        cache_dtype=torch.float32, device="cpu")
    httpd, api = make_server(loaded, n_slots=2, kv_layout="paged", page_size=16,
                             slo_ttft_ms=5000.0, slo_itl_ms=500.0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    sched = api.scheduler
    try:
        results = [None] * 3

        def run(i):
            results[i] = _chat(port, f"burst request {i} about the sea", 12)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert results == [200] * 3
        before = sched.latency_summary()
        assert before["completed"] == 3 and before["decode_host_gaps"] > 0
        assert _get(port, "/debug/perf")["window"]["ttft"]["count"] == 3
        old = sched.perf
        sched.reset_latency_stats()
        after = sched.latency_summary()
        assert after["completed"] == 0 and after["admission_gaps"] == 0
        assert after["decode_host_gaps"] == 0
        assert after["ttft_ms_p50"] is after["ttft_ms_p95"] is after["itl_ms_p95"] is None
        perf = _get(port, "/debug/perf")
        assert all(perf["window"][k]["count"] == 0 for k in ("ttft", "itl", "e2e"))
        assert perf["roofline"]["window_chunks"] == 0 and perf["slo"]["window_finished"] == 0
        assert perf["slo"]["targets"] == {"ttft_ms": 5000.0, "itl_ms": 500.0}
        assert sched.perf is not old and sched.perf.slo is old.slo
        assert sched.perf.cost_model is old.cost_model
        assert sched.perf.peak_gbs == old.peak_gbs
        # the first gap after the reset starts from a chunk after it
        idle_s = 0.6
        time.sleep(idle_s)
        assert _chat(port, "one more after the reset", 12) == 200
        summary = sched.latency_summary()
        assert summary["completed"] == 1 and summary["decode_host_gaps"] > 0
        assert summary["decode_host_gap_ms_mean"] < idle_s * 1000.0
        with sched._metrics_lock:
            assert max(sched._host_gap_ms) < idle_s * 1000.0
    finally:
        httpd.shutdown()
        httpd.server_close()
        sched.shutdown()


def test_scheduler_reset_mirrors_the_jax_method():
    """The same state is cleared as by the JAX package's method."""
    import inspect

    from dllama_tpu.serve.scheduler import Scheduler as JaxScheduler
    from dllama_tpu_torch.serve.scheduler import Scheduler

    jax_src = inspect.getsource(JaxScheduler.reset_latency_stats)
    ours = inspect.getsource(Scheduler.reset_latency_stats)
    for attr in ("_completed.clear()", "_admit_gaps_ms.clear()", "_host_gap_ms.clear()",
                 "_t_dec_end = None", "_t_consumed = None", "PerfAggregator(",
                 "slo=self.perf.slo", "cost_model=self.perf.cost_model"):
        assert attr in jax_src and attr in ours, attr


HEAD16 = LlamaConfig(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                     vocab_size=1057, seq_len=128)


@pytest.mark.parametrize("kernels", ["auto", "cuda"])
def test_unsupported_head_size_keeps_the_kernels_with_plain_attention(kernels):
    assert HEAD16.head_size == 16 and not flash_attention.supported(16)
    sel = resolve_kernels(HEAD16, kernels, device="cuda")
    assert (sel.backend, sel.attn_route) == ("cuda", "torch")
    assert sel.attn_fn is gqa_attention
    assert sel.mm.keywords == {"backend": "cuda"}
    # a head size the kernel takes still routes it; auto on the CPU stays plain
    assert resolve_kernels(LlamaConfig(**dict(HEAD16.__dict__, dim=512, orig_seq_len=0)),
                           kernels, device="cuda").attn_route == "flash"
    assert resolve_kernels(HEAD16, "auto", device="cpu").attn_route == "torch"


def test_head_size_rule_equals_jax_on_the_golden_model():
    """JAX resolves the golden model to its kernels' backend with route jnp
    under kernels='pallas' (what auto is on a TPU); the port to cuda with
    route torch on a CUDA device."""
    from dllama_tpu.engine.kernel_select import resolve_kernels as jax_resolve
    from dllama_tpu.models import formats as jf
    from dllama_tpu_torch.models import formats

    jcfg, _ = jf.read_header(FIXTURE_M)
    cfg, _ = formats.read_header(FIXTURE_M)
    jsel = jax_resolve(jcfg, jcfg.seq_len, 1, "pallas")
    sel = resolve_kernels(cfg, "auto", device="cuda")
    assert (jsel.backend, jsel.attn_route) == ("pallas", "jnp")
    assert (sel.backend, sel.attn_route) == ("cuda", "torch")
