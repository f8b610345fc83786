"""The port's request-flow tracer (`dllama_tpu_torch/obs/trace.py`, a copy
of the JAX package's): every tracer case of tests/test_trace.py runs
against the copy, and one greedy request through a JAX server and a port
server on the CPU leaves the same flight-recorder record shape at
`/debug/requests/{id}` and the same span and event names at `/debug/trace`
(JAX's jit `compile` spans aside: on the CPU the port captures no graphs)."""

import http.client
import inspect
import json
import threading

import pytest
import torch

import tests.test_trace as jax_trace_tests
from dllama_tpu_torch.obs import trace as ttrace
from tests.test_golden import FIXTURE_M
from tests.test_torch_continuous_serve import _tokenizer_path

torch.set_num_threads(1)

TRACER_CASES = sorted(name for name, fn in vars(jax_trace_tests).items()
                      if name.startswith("test_") and inspect.isfunction(fn))


@pytest.mark.parametrize("case", TRACER_CASES)
def test_jax_tracer_case_on_the_port(case, monkeypatch):
    monkeypatch.setattr(jax_trace_tests, "trace", ttrace)
    getattr(jax_trace_tests, case)()


def test_hop_header_and_log_extra_match_jax():
    from dllama_tpu.obs import trace as jtrace

    assert ttrace.HOP_HEADER == jtrace.HOP_HEADER
    hop = ttrace.format_hop("t" * 32, "span1", 2)
    assert hop == jtrace.format_hop("t" * 32, "span1", 2)
    for v in (hop, "junk", None, "a/b/c"):
        assert ttrace.parse_hop(v) == jtrace.parse_hop(v)
    assert set(ttrace.SPAN_CATALOG) == set(jtrace.SPAN_CATALOG)
    assert set(ttrace.EVENT_CATALOG) == set(jtrace.EVENT_CATALOG)
    assert ttrace.log_extra("req_1", fault_point="x") == {"request_id": "req_1",
                                                          "fault_point": "x"}


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """A port server (aio) and a JAX server (threads), 2 slots each on the
    page pool, the golden model."""
    import jax.numpy as jnp

    from dllama_tpu.engine.loader import load_model as jax_load
    from dllama_tpu.serve.api import make_server as jax_server
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.serve.api import make_server

    tpath = _tokenizer_path(tmp_path_factory)
    kw = dict(n_slots=2, kv_layout="paged", page_size=16)
    httpd, api = make_server(load_model(FIXTURE_M, tpath, cache_dtype=torch.float32,
                                        device="cpu"), **kw)
    jhttpd, japi = jax_server(jax_load(FIXTURE_M, tpath, mesh=None, cache_dtype=jnp.float32),
                              frontend="threads", **kw)
    for h in (httpd, jhttpd):
        threading.Thread(target=h.serve_forever, daemon=True).start()
    yield httpd.server_address[1], jhttpd.server_address[1]
    for h, a in ((httpd, api), (jhttpd, japi)):
        h.shutdown()
        h.server_close()
        a.scheduler.shutdown()


def _call(port, method, path, body=None, rid=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    hdrs = {"Content-Type": "application/json", **({"X-Request-Id": rid} if rid else {})}
    conn.request(method, path, json.dumps(body) if body is not None else None, hdrs)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _keys(rec, prefix=""):
    out = set()
    for k, v in rec.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def _names(doc, rid=None):
    evs = [e for e in doc["traceEvents"] if e.get("ph") in ("X", "i")]
    if rid is not None:
        evs = [e for e in evs if e.get("args", {}).get("req_id") == rid]
    return {e["name"] for e in evs} - {"compile"}


def test_same_request_same_flight_record_and_span_names(servers):
    from dllama_tpu.obs import trace as jtrace

    port, jport = servers
    body = {"messages": [{"role": "user", "content": "tell me a story"}], "temperature": 0,
            "max_tokens": 9}
    # one request first on each (the JAX server's jits warm up, and both
    # radix trees then hold the prompt: the traced request reuses it)
    for p in (port, jport):
        assert _call(p, "POST", "/v1/chat/completions", body)[0] == 200
    ttrace.TRACER.reset()
    jtrace.TRACER.reset()
    got, want = {}, {}
    for p, out in ((port, got), (jport, want)):
        st, raw = _call(p, "POST", "/v1/chat/completions", body, rid="trace-same-1")
        assert st == 200, raw
        out["content"] = json.loads(raw)["choices"][0]["message"]["content"]
        st, raw = _call(p, "GET", "/debug/requests/trace-same-1")
        assert st == 200, raw
        out["rec"] = json.loads(raw)
        st, raw = _call(p, "GET", "/debug/trace")
        assert st == 200
        out["trace"] = json.loads(raw)
        out["summary"] = json.loads(_call(p, "GET", "/debug/requests")[1])["requests"]
    assert got["content"] == want["content"]
    assert _keys(got["rec"]) == _keys(want["rec"])
    for k in ("state", "prompt_tokens", "decode_tokens", "finish_reason", "reused_tokens"):
        assert got["rec"][k] == want["rec"][k], k
    assert got["rec"]["reused_tokens"] > 0
    gs, ws = got["rec"]["slo"], want["rec"]["slo"]  # no targets on either
    assert set(gs) == set(ws) and gs["ok"] and ws["ok"]
    assert {k: gs[k] for k in ("ttft_ok", "itl_ok", "targets", "violated_by_ms")} == \
        {k: ws[k] for k in ("ttft_ok", "itl_ok", "targets", "violated_by_ms")}
    assert [c["tokens"] for c in got["rec"]["chunks"]] == \
        [c["tokens"] for c in want["rec"]["chunks"]]
    assert _names(got["trace"], "trace-same-1") == _names(want["trace"], "trace-same-1")
    assert _names(got["trace"]) == _names(want["trace"])
    assert [set(r) for r in got["summary"]] == [set(r) for r in want["summary"]]


def test_unknown_request_is_404_and_disabled_tracer_says_so(servers):
    port, _ = servers
    st, raw = _call(port, "GET", "/debug/requests/never-seen")
    assert st == 404 and b"flight-recorder" in raw
    prev = ttrace.TRACER
    try:
        ttrace.configure(0)
        st, raw = _call(port, "GET", "/debug/trace")
        assert st == 404 and b"--trace-buffer" in raw
    finally:
        ttrace.TRACER = prev
