"""`GET /metrics` and the `/debug/*` family of the port's server against the
JAX package's: the same scripted requests (greedy, 2 slots on the page
pool, a shared system prompt, plain and SSE, a legacy completion, a bad
body, an unknown path, probes) through a JAX server and a port server on
the CPU move these counters by the same deltas: requests admitted, finished
by reason, tokens generated, prefill tokens, reused-prefix tokens, radix hit
tokens, and HTTP responses by endpoint and code. The port's debug endpoints
answer as the JAX package's do (`/debug/kv` audit, `/debug/radix` tree,
`/debug/perf` windows and ledger, `/debug/compile`, `POST /debug/profile`
with 409 while a capture runs), and a failed `/metrics` render is a 500.

By design (ROADMAP §C) the JAX server here runs its threads front end and
the port its aio default: the HTTP answers and counters are the same."""

import http.client
import json
import os
import re
import threading
import time

import pytest
import torch

from tests.test_golden import FIXTURE_M
from tests.test_metrics import check_histogram, parse_exposition
from tests.test_torch_continuous_serve import _tokenizer_path

torch.set_num_threads(1)

KW = dict(n_slots=2, kv_layout="paged", page_size=16)
SYSTEM = "You are a careful assistant; answer briefly."


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    import jax.numpy as jnp

    from dllama_tpu.engine.loader import load_model as jax_load
    from dllama_tpu.serve.api import make_server as jax_server
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.serve.api import make_server

    tpath = _tokenizer_path(tmp_path_factory)
    httpd, api = make_server(load_model(FIXTURE_M, tpath, cache_dtype=torch.float32,
                                        device="cpu"), slo_ttft_ms=60000.0, **KW)
    jhttpd, japi = jax_server(jax_load(FIXTURE_M, tpath, mesh=None, cache_dtype=jnp.float32),
                              frontend="threads", slo_ttft_ms=60000.0, **KW)
    for h in (httpd, jhttpd):
        threading.Thread(target=h.serve_forever, daemon=True).start()
    for h in (httpd, jhttpd):  # every test finds served requests (JAX compiles here)
        assert _call(h.server_address[1], "POST", "/v1/chat/completions",
                     _chat("warm up"))[0] == 200
    yield httpd.server_address[1], jhttpd.server_address[1], api
    for h, a in ((httpd, api), (jhttpd, japi)):
        h.shutdown()
        h.server_close()
        a.scheduler.shutdown()


def _call(port, method, path, body=None, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    data = raw if raw is not None else (json.dumps(body) if body is not None else None)
    conn.request(method, path, data, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.read()
    conn.close()
    return resp.status, out


def _scrape(port) -> dict:
    st, raw = _call(port, "GET", "/metrics")
    assert st == 200
    return parse_exposition(raw.decode())[1]


TRACKED = ("dllama_requests_admitted_total", "dllama_requests_finished_total",
           "dllama_tokens_generated_total", "dllama_prefill_tokens_total",
           "dllama_reused_prefix_tokens_total", "dllama_radix_hit_tokens_total",
           "dllama_http_responses_total")


def _delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if k[0] in TRACKED and v != before.get(k, 0.0)}


def _chat(user, **kw):
    return dict({"messages": [{"role": "system", "content": SYSTEM},
                              {"role": "user", "content": user}],
                 "temperature": 0, "max_tokens": 6}, **kw)


def _script(port) -> list:
    """The scripted traffic, one request at a time (each admission sees a
    settled tree, so reuse is deterministic); returns what the client saw."""
    seen = []
    for body, path in ((_chat("first question"), "/v1/chat/completions"),
                       (_chat("second question", stream=True), "/v1/chat/completions"),
                       (_chat("first question", max_tokens=3), "/v1/chat/completions"),
                       ({"prompt": "once upon a time", "max_tokens": 5, "temperature": 0},
                        "/v1/completions")):
        st, raw = _call(port, "POST", path, body)
        assert st == 200, raw
        seen.append(raw.decode().split("data: [DONE]")[0][-200:] if body.get("stream")
                    else json.loads(raw)["choices"][0])
    assert _call(port, "POST", "/v1/chat/completions", raw=b"{not json")[0] == 400
    assert _call(port, "POST", "/v1/nope", {})[0] == 404
    assert _call(port, "GET", "/nope")[0] == 404
    assert _call(port, "GET", "/health")[0] == 200
    assert _call(port, "GET", "/v1/models")[0] == 200
    return seen


def test_counter_deltas_equal_the_jax_server(servers):
    port, jport, api = servers
    deltas = []
    for p in (port, jport):
        before = _scrape(p)
        _script(p)
        deltas.append(_delta(before, _scrape(p)))
    got, want = deltas
    assert got == want
    assert got[("dllama_requests_finished_total", '{reason="length"}')] == 4
    assert got[("dllama_tokens_generated_total", "")] == 6 + 6 + 3 + 5
    assert got[("dllama_reused_prefix_tokens_total", "")] > 0
    assert got[("dllama_http_responses_total",
                '{endpoint="/metrics",code="200"}')] == 1
    assert got[("dllama_http_responses_total", '{endpoint="other",code="404"}')] == 2


def test_metrics_exposition_and_scrape_time_gauges(servers):
    port, _, api = servers
    st, raw = _call(port, "GET", "/metrics")
    assert st == 200
    text = raw.decode()
    families, samples = parse_exposition(text)
    for name in ("dllama_ttft_seconds", "dllama_itl_seconds", "dllama_decode_chunk_seconds",
                 "dllama_batch_occupancy", "dllama_prefill_chunk_seconds"):
        assert families[name] == "histogram"
        check_histogram(samples, name)
    # the time ledger partitions the worker's wall time, state by state
    led = api.scheduler.ledger.snapshot()
    states = {k[1] for k in samples if k[0] == "dllama_scheduler_time_seconds_total"}
    assert {'{state="idle"}', '{state="decode_wait"}', '{state="emit"}'} <= states
    assert sum(led["seconds"].values()) == pytest.approx(led["wall_s"], rel=1e-3)
    # the CPU has no peak: attainment is NaN, never a guessed number
    assert re.search(r"^dllama_decode_bandwidth_attainment NaN$", text, re.M)
    assert samples[("dllama_kv_pages_total", "")] == api.scheduler.engine.pool.n_pages
    assert samples[("dllama_slots_total", "")] == 2
    assert ('dllama_tpu_build_info', '{version="' + api.build_info["version"]
            + '",jax="none",backend="cpu",overlap="on",warmup="off"}') in samples
    assert samples[("dllama_process_threads", "")] >= 1


def test_debug_endpoints_answer_like_jax(servers):
    port, jport, api = servers
    for path in ("/debug/kv", "/debug/radix", "/debug/perf", "/debug/compile"):
        st, raw = _call(port, "GET", path)
        jst, jraw = _call(jport, "GET", path)
        assert st == jst == 200, (path, raw[:300])
        got, want = json.loads(raw), json.loads(jraw)
        assert set(got) == set(want), path
    kv = json.loads(_call(port, "GET", "/debug/kv")[1])
    assert kv["audit"]["ok"] and kv["layout"] == "paged" and kv["radix"]["pages"] > 0
    radix = json.loads(_call(port, "GET", "/debug/radix")[1])
    assert radix["enabled"] and radix["tree"]["nodes"] == radix["stats"]["nodes"] > 0
    perf = json.loads(_call(port, "GET", "/debug/perf")[1])
    assert perf["mode"] == "continuous" and perf["slo"]["targets"]["ttft_ms"] == 60000.0
    assert perf["window"]["ttft"]["count"] > 0 and perf["slo"]["attainment"] == 1.0
    assert perf["roofline"]["priced"] and perf["roofline"]["peak_gbs"] is None
    assert perf["roofline"]["bandwidth_attainment"] is None
    assert set(perf["ledger"]["seconds"]) == set(json.loads(
        _call(jport, "GET", "/debug/perf")[1])["ledger"]["seconds"])
    comp = json.loads(_call(port, "GET", "/debug/compile")[1])
    # the CPU captures nothing; the contract names the batched programs
    assert comp["compiles"] == comp["unexpected"] == 0
    assert {"decode", "decode_pen", "prefill_chunk"} <= set(comp["contract"]["fns"])
    assert comp["transfers"]["sites"]["d2h.decode_tokens"]["count"] > 0
    health = json.loads(_call(port, "GET", "/health")[1])
    assert health["compile"]["unexpected_compiles"] == 0
    assert health["process"]["threads"] >= 1 and health["model_params_bytes"] > 0


def test_debug_profile_writes_a_trace_and_conflicts_409(servers, tmp_path):
    port, _, _ = servers
    d = str(tmp_path / "prof")
    st, raw = _call(port, "POST", "/debug/profile", {"duration_s": 0.3, "dir": d})
    assert st == 200, raw
    info = json.loads(raw)["profiling"]
    assert info["trace"] == os.path.join(d, "trace.json")
    assert info["activities"] == ["cpu"]  # no card here
    st, raw = _call(port, "POST", "/debug/profile", {"duration_s": 0.3})
    assert st == 409 and b"already running" in raw
    assert _call(port, "POST", "/debug/profile", raw=b"[1]")[0] == 400
    deadline = time.monotonic() + 60
    while not os.path.exists(info["trace"]) and time.monotonic() < deadline:
        time.sleep(0.05)
    with open(info["trace"]) as f:
        assert "traceEvents" in json.load(f)


def test_metrics_render_failure_is_a_500(servers, monkeypatch):
    from dllama_tpu_torch.obs import metrics

    port, _, _ = servers

    def broken():
        raise RuntimeError("render broke")

    monkeypatch.setattr(metrics.REGISTRY, "render", broken)
    st, raw = _call(port, "GET", "/metrics")
    assert st == 500 and b"render failed" in raw
