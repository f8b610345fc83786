"""The port's aio front end (`dllama_tpu_torch/serve/aio.py`), the drills
of tests/test_aio.py: many concurrent SSE streams on a bounded thread count
(64 here, the JAX drill's 260 on the card), a client hang-up that cancels
its request through the event loop (awaited on an event with a deadline,
no sleep), the idle-stream heartbeat on both front ends, X-Replica-Id, and
the same contents from aio and from the threads server. Decode is slowed,
where a drill needs it, by a sleep around `BatchEngine._decode_launch`
(the port has no fault injection)."""

import contextlib
import http.client
import json
import re
import selectors
import socket
import threading
import time

import pytest
import torch

from tests.test_golden import FIXTURE_M
from tests.test_torch_continuous_serve import _tokenizer_path

torch.set_num_threads(1)

N_STREAMS = 64


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """{'aio': (httpd, api), 'threads': (httpd, api)}: 4 slots each on the
    page pool, the golden model; the aio server has a replica id."""
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.serve.api import make_server

    tpath = _tokenizer_path(tmp_path_factory)
    out = {}
    for frontend, extra in (("aio", {"replica_id": "replica-7"}), ("threads", {})):
        loaded = load_model(FIXTURE_M, tpath, cache_dtype=torch.float32, device="cpu")
        httpd, api = make_server(loaded, n_slots=4, kv_layout="paged", page_size=16,
                                 frontend=frontend, **extra)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        out[frontend] = (httpd, api)
    yield out
    for httpd, api in out.values():
        api.scheduler.shutdown()
        httpd.shutdown()
        httpd.server_close()


@contextlib.contextmanager
def slow_decode(api, seconds: float):
    eng = api.scheduler.engine
    launch = eng._decode_launch

    def slow(*a, **k):
        time.sleep(seconds)
        return launch(*a, **k)

    eng._decode_launch = slow
    try:
        yield
    finally:
        del eng._decode_launch  # the class's method again


def _stream_request(port: int, max_tokens: int = 2, content: str = "hi") -> bytes:
    body = json.dumps({"messages": [{"role": "user", "content": content}],
                       "max_tokens": max_tokens, "temperature": 0.0,
                       "stream": True}).encode()
    return (b"POST /v1/chat/completions HTTP/1.1\r\nHost: 127.0.0.1:%d\r\n"
            b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n"
            % (port, len(body))) + body


def _scrape(port: int) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/metrics")
    text = conn.getresponse().read().decode()
    conn.close()
    return text


def test_many_streams_bounded_threads(servers):
    """64 concurrent SSE streams over 4 slots: every stream ends in [DONE],
    the connections gauge sees them all live, and the thread count stays a
    constant of the configuration (a thread a connection would be 64+)."""
    httpd, api = servers["aio"]
    port = httpd.server_address[1]
    idle = float(re.search(r"^dllama_process_threads (\S+)$", _scrape(port), re.M).group(1))
    sel = selectors.DefaultSelector()
    bufs: dict = {}
    with slow_decode(api, 0.01):
        for _ in range(N_STREAMS):
            s = socket.create_connection(("127.0.0.1", port), timeout=60)
            s.sendall(_stream_request(port))
            s.setblocking(False)
            bufs[s] = bytearray()
            sel.register(s, selectors.EVENT_READ)
        deadline = time.monotonic() + 120
        done, headered, mid = set(), set(), None
        while len(done) < N_STREAMS and time.monotonic() < deadline:
            for key, _ in sel.select(timeout=1.0):
                s = key.fileobj
                try:
                    data = s.recv(65536)
                except (BlockingIOError, InterruptedError):
                    continue
                except OSError:
                    data = b""
                if data:
                    bufs[s] += data
                    if b"text/event-stream" in bufs[s]:
                        headered.add(s)
                if not data or b"data: [DONE]" in bufs[s]:
                    sel.unregister(s)
                    s.close()
                    done.add(s)
            if mid is None and len(headered) >= N_STREAMS and len(done) < N_STREAMS // 2:
                text = _scrape(port)
                mid = float(re.search(r"^dllama_process_threads (\S+)$", text, re.M).group(1))
                m = re.search(r'^dllama_frontend_connections\{server="127\.0\.0\.1:'
                              + str(port) + r'"\} (\S+)$', text, re.M)
                # every stream whose client has not closed yet is live
                assert m and float(m.group(1)) >= N_STREAMS - len(done)
    assert len(done) == N_STREAMS
    assert all(b"data: [DONE]" in b for b in bufs.values())
    assert mid is not None, "never saw every stream live at once"
    # loop + pump + <= 8 workers + 2 control threads + the scheduler
    assert mid - idle <= 12, (idle, mid)


def test_disconnect_cancels_through_the_event_loop(servers):
    """A mid-stream hang-up: the loop's EOF signal (no polling thread)
    cancels the request, its pages come back and the pool audits clean."""
    httpd, api = servers["aio"]
    port = httpd.server_address[1]
    sched = api.scheduler
    cancelled = threading.Event()
    seen = []
    finish = sched._finish

    def rec_finish(req, reason, *a, **k):
        out = finish(req, reason, *a, **k)
        if req.finish_reason == "cancelled":
            seen.append(req)
            cancelled.set()
        return out

    sched._finish = rec_finish
    try:
        with slow_decode(api, 0.05):
            s = socket.create_connection(("127.0.0.1", port), timeout=30)
            s.sendall(_stream_request(port, max_tokens=90))
            buf, deadline = b"", time.monotonic() + 30
            while b'"content"' not in buf and time.monotonic() < deadline:
                buf += s.recv(4096)
            assert b"text/event-stream" in buf
            s.close()  # hang up mid-stream
            assert cancelled.wait(timeout=30), "the hang-up did not cancel the stream"
    finally:
        del sched._finish
    assert seen[0].produced < 90
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/debug/kv")
    kv = json.loads(conn.getresponse().read())
    conn.close()
    assert kv["audit"]["ok"]


@pytest.mark.parametrize("frontend", ["aio", "threads"])
def test_sse_heartbeat_on_idle_stream(servers, frontend):
    httpd, api = servers[frontend]
    api.sse_heartbeat_s = 0.05
    try:
        with slow_decode(api, 0.15):
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
            conn.request("POST", "/v1/chat/completions",
                         json.dumps({"messages": [{"role": "user", "content": "hi"}],
                                     "max_tokens": 9, "temperature": 0.0, "stream": True}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            raw = resp.read().decode()
            conn.close()
    finally:
        api.sse_heartbeat_s = 0.0
    assert raw.count(": keep-alive") >= 1, raw[:400]
    events = [ln for ln in raw.splitlines() if ln.startswith("data: ")]
    assert events[-1] == "data: [DONE]"


def test_x_replica_id_and_timings_replica(servers):
    httpd, api = servers["aio"]
    conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
    conn.request("POST", "/v1/chat/completions",
                 json.dumps({"messages": [{"role": "user", "content": "hi"}],
                             "max_tokens": 3, "temperature": 0.0}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    assert resp.getheader("X-Replica-Id") == "replica-7"
    assert body["timings"]["replica"] == "replica-7"
    conn.request("GET", "/health")
    resp = conn.getresponse()
    resp.read()
    assert resp.getheader("X-Replica-Id") == "replica-7"
    conn.close()
    # the threads server's default identity is its bound address
    th, _ = servers["threads"]
    assert servers["threads"][1].replica_id == f"127.0.0.1:{th.server_address[1]}"


def _content(port, content, stream, extra=None):
    body = dict({"messages": [{"role": "user", "content": content}], "temperature": 0,
                 "max_tokens": 7, "stream": stream}, **(extra or {}))
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/chat/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    assert resp.status == 200, raw
    if not stream:
        return json.loads(raw)["choices"][0]["message"]["content"]
    events = [ln[6:] for ln in raw.decode().split("\n") if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    return "".join(json.loads(e)["choices"][0]["delta"].get("content", "")
                   for e in events[:-1])


def test_same_contents_from_aio_and_threads(servers):
    """Concurrent plain and SSE requests, priority and tenant passed
    through: the aio server's contents equal the threads server's."""
    prompts = ["hello world", "tell me a story", "abc", "one more"]
    out = {}
    for frontend in ("aio", "threads"):
        port = servers[frontend][0].server_address[1]
        got = [None] * (2 * len(prompts))
        jobs = [(p, s, {"priority": i % 3, "tenant": f"t{i % 2}"})
                for i, (p, s) in enumerate((p, s) for s in (False, True) for p in prompts)]

        def run(i, job, port=port, got=got):
            got[i] = _content(port, *job)

        threads = [threading.Thread(target=run, args=(i, j)) for i, j in enumerate(jobs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        out[frontend] = got
    assert out["aio"] == out["threads"]
    assert out["aio"][:4] == out["aio"][4:]  # SSE carries what the plain body does
