"""The port's multi-replica router (``serve/router.py``), its failover
surface on the port's replicas, and a mixed mesh of a port replica and a
JAX replica behind it.

* **Stub drills.** The JAX suite's router drills (``tests/test_router.py``:
  the handshake, affinity, least-loaded spread, a replica killed mid-queue,
  death mid-stream without a failover budget, mid-stream failover with
  duplicate suppression, budget exhaustion, drain redirection, saturation
  shedding, router drain, stream passthrough) run unchanged against the
  port's router over the same controllable stub replicas; the counters
  they read are the port's (``dllama_tpu_torch.obs.instruments``).
* **Port replicas.** Two in-process ``serve --slots 2`` port replicas on a
  tiny f32 model behind the port's router: trace propagation and the
  cross-hop postmortem, affinity and failover after a replica's death, and
  a stream resumed on the other replica bit-equal to the uninterrupted run
  (greedy, sampled and penalized), through the router with a wire cut
  mid-stream too.
* **A mixed mesh.** One port replica and one JAX replica of the same file
  behind the port's router: the handshake admits both (both report version
  0.1.0 and the model id ``dllama-tpu``), and a greedy stream resumed from
  either package onto the other is bit-equal.
"""

import http.client
import json
import threading
import time

import pytest
import torch

import tests.test_router as jr
from dllama_tpu_torch.obs import instruments as ins
from dllama_tpu_torch.serve.router import Router, make_router
from tests.test_router import (
    SHARED,
    SeverProxy,
    StubState,
    assemble,
    make_stub,
    rget,
    rpost,
    sse_events,
    stream_raw,
)

torch.set_num_threads(1)


def _close(*servers):
    for h in servers:
        try:
            h.shutdown()
            h.server_close()
        except OSError:
            pass


@pytest.fixture
def mesh(monkeypatch):
    """Two stub replicas behind the port's started router (its poller inert
    at poll_s=30: drills call _poll_one themselves); the JAX drill module
    reads the port's counters while it runs."""
    monkeypatch.setattr(jr, "ins", ins)
    a, b = StubState("stub-a"), StubState("stub-b")
    ha, hb = make_stub(a), make_stub(b)
    server, router = make_router([f"127.0.0.1:{ha.server_address[1]}",
                                  f"127.0.0.1:{hb.server_address[1]}"], poll_s=30.0)
    router.start()
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield server.server_address[1], router, (a, b), (ha, hb)
    router.stop()
    _close(server, ha, hb)


STUB_DRILLS = ["test_handshake_and_health", "test_affinity_pins_shared_prefix",
               "test_least_loaded_spreads_distinct_prefixes",
               "test_replica_kill_mid_queue_reroutes_zero_lost",
               "test_replica_death_mid_stream_fails_exactly_once",
               "test_midstream_failover_resumes_and_suppresses_duplicates",
               "test_failover_budget_exhaustion_fails_exactly_once",
               "test_drain_redirects_new_traffic", "test_all_saturated_sheds_with_retry_after",
               "test_router_drain_sheds_503",
               "test_stream_passthrough_forwards_tokens_incrementally"]


@pytest.mark.parametrize("drill", STUB_DRILLS)
def test_stub_drill(mesh, drill):
    """One of the JAX suite's stub-mesh drills, against the port's router."""
    assert isinstance(mesh[1], Router)
    getattr(jr, drill)(mesh)


def test_health_answers_while_streams_saturate_workers():
    """/health and /metrics ride the aio front end's control pool: they
    answer while every request worker holds a long proxied stream."""
    a = StubState("stub-a")
    a.ntokens, a.stream_delay = 100, 0.05
    ha = make_stub(a)
    server, router = make_router([f"127.0.0.1:{ha.server_address[1]}"], poll_s=30.0,
                                 workers=2)
    try:
        router.start()
        threading.Thread(target=server.serve_forever, daemon=True).start()
        port = server.server_address[1]

        def stream():
            stream_raw(port, {"messages": SHARED, "stream": True, "max_tokens": 50})

        for _ in range(2):
            threading.Thread(target=stream, daemon=True).start()
        time.sleep(0.5)
        t0 = time.monotonic()
        assert rget(port, "/health/ready")[0] == 200
        assert time.monotonic() - t0 < 2.0, "the probe starved behind the streams"
        assert rget(port, "/metrics")[0] == 200
    finally:
        router.stop()
        _close(server, ha)


def test_config_handshake_quarantines_mismatch():
    """A replica of another (model, version) is quarantined, never picked."""
    a, c = StubState("stub-a"), StubState("stub-c", model="other-model", version="9.9")
    ha, hc = make_stub(a), make_stub(c)
    server, router = make_router([f"127.0.0.1:{ha.server_address[1]}",
                                  f"127.0.0.1:{hc.server_address[1]}"], poll_s=30.0)
    try:
        router.start()
        assert router.replicas[1].config_ok is False
        assert router.mesh_model == "stub-model"
        rep, _ = router.pick(None, exclude=set())
        assert rep is router.replicas[0]
        router.release(rep)
    finally:
        router.stop()
        server.server_close()
        _close(ha, hc)


@pytest.mark.parametrize("body,legacy", [
    ({"messages": SHARED}, False),
    ({"messages": [{"role": "user", "content": "no system"}]}, False),
    ({"messages": []}, False), ({"prompt": "x" * 600}, True), ({"prompt": ["p"]}, True),
    ({"messages": "not a list"}, False), ({}, True)])
def test_fingerprint_equals_jax(body, legacy):
    from dllama_tpu.serve.router import Router as JaxRouter

    assert Router.fingerprint(body, legacy) == JaxRouter.fingerprint(body, legacy)


# ------------------------------------------------------------ real replicas


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from tests.test_serve import make_tiny_files

    mpath, tpath, _cfg = make_tiny_files(tmp_path_factory.mktemp("torch_router"))
    return mpath, tpath


def _port_replica(files, **kw):
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.serve.api import make_server

    httpd, api = make_server(load_model(*files, cache_dtype=torch.float32, device="cpu"),
                             n_slots=2, kv_layout="paged", page_size=8, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, api


def _jax_replica(files):
    import jax.numpy as jnp

    from dllama_tpu.engine.loader import load_model
    from dllama_tpu.serve.api import make_server

    httpd, api = make_server(load_model(*files, mesh=None, cache_dtype=jnp.float32),
                             n_slots=2, kv_layout="paged", page_size=8, frontend="threads")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, api


def _router(addrs):
    rserver, router = make_router(addrs, poll_s=30.0)
    router.start()
    threading.Thread(target=rserver.serve_forever, daemon=True).start()
    return rserver, router


def _teardown(rserver, router, servers, proxy=None):
    router.stop()
    _close(rserver)
    if proxy is not None:
        proxy.close()
    for httpd, api in servers:
        if api.scheduler is not None:
            api.scheduler.shutdown()
        _close(httpd)


@pytest.fixture(scope="module")
def real_mesh(files):
    servers = [_port_replica(files) for _ in range(2)]
    rserver, router = _router([f"127.0.0.1:{h.server_address[1]}" for h, _ in servers])
    yield rserver.server_address[1], router, servers
    _teardown(rserver, router, servers)


def test_real_mesh_trace_propagation_and_postmortem(real_mesh):
    """One trace id from the router's hop header into the port replica's
    flight recorder; /router/trace merges both processes' spans on one
    aligned timeline; /router/requests/{id} joins the router's record with
    the replica's timeline; /router/metrics federates the replicas."""
    from tests.test_metrics import parse_exposition

    port, router, _ = real_mesh
    for rep in router.replicas:
        router._poll_one(rep)
    rid = "req-torch-obs-1"
    st, data, _ = rpost(port, "/v1/chat/completions",
                        {"messages": [{"role": "user", "content": "trace me"}],
                         "max_tokens": 4, "temperature": 0.0},
                        headers={"X-Request-Id": rid})
    assert st == 200, data
    st, data = rget(port, f"/router/requests/{rid}")
    assert st == 200, data
    pm = json.loads(data)
    tid = pm["trace_id"]
    assert tid and len(tid) == 16 and pm["router"]["outcome"] == "ok"
    serving = pm["router"]["attempts"][0]["replica"]
    leg = pm["replicas"][serving]
    assert leg["req_id"] == rid and leg["trace_id"] == tid and leg["state"] == "finished"
    st, data = rget(port, "/router/trace")
    merged = json.loads(data)
    assert st == 200 and merged["otherData"]["replicas_merged"] == 2
    for c in merged["otherData"]["clock"].values():
        assert c["aligned"] is True and abs(c["offset_s"]) <= max(c["uncertainty_s"], 0.25)
    body = [e for e in merged["traceEvents"] if e.get("ph") != "M"]
    assert [e["ts"] for e in body] == sorted(e["ts"] for e in body)
    traced = [e for e in body if e.get("args", {}).get("trace_id") == tid]
    assert {"connect", "request"} <= {e["name"] for e in traced}
    assert 1 in {e["pid"] for e in traced} and any(e["pid"] > 1 for e in traced)
    st, data = rget(port, "/router/metrics")
    fams, samples = parse_exposition(data.decode())
    assert st == 200 and fams["dllama_fleet_requests_finished_total"] == "counter"
    assert any(n == "dllama_requests_finished_total" and f'replica="{serving}"' in lbl
               for (n, lbl) in samples)


def test_real_mesh_affinity_and_failover(real_mesh):
    """A shared system prompt lands on one warm replica; after that replica
    dies, the same prompt is served by the survivor, whose pool audits
    clean. Last on this mesh: it kills a replica."""
    port, router, servers = real_mesh
    system = {"role": "system", "content": "Shared preamble for the warm-path routing test."}
    ids = set()
    for i in range(3):
        st, data, headers = rpost(port, "/v1/chat/completions",
                                  {"messages": [system, {"role": "user", "content": f"q{i}"}],
                                   "max_tokens": 4, "temperature": 0.0})
        assert st == 200, data
        assert headers.get("X-Replica-Id") == json.loads(data)["timings"]["replica"]
        ids.add(headers["X-Replica-Id"])
    assert len(ids) == 1, f"affinity scattered the shared prefix: {ids}"
    warm = ids.pop()
    victim = next(h for h, a in servers if a.replica_id == warm)
    _close(victim)
    st, data, headers = rpost(port, "/v1/chat/completions",
                              {"messages": [system, {"role": "user", "content": "after"}],
                               "max_tokens": 4, "temperature": 0.0})
    assert st == 200, data
    assert headers["X-Replica-Id"] != warm
    st, data = rget(int(headers["X-Replica-Id"].split(":")[1]), "/debug/kv")
    kv = json.loads(data)
    assert st == 200 and kv["layout"] == "paged" and kv["audit"]["ok"] is True


RESUME_MSGS = [{"role": "system", "content":
                "Failover drill shared preamble, long enough to matter."},
               {"role": "user", "content": "continue the drill"}]
BODIES = {"greedy": dict(temperature=0.0),
          "sampled": dict(temperature=0.9, top_p=0.95, seed=7),
          "penalized": dict(temperature=0.0, presence_penalty=0.6, frequency_penalty=0.4)}


def _resume_bit_exact(a_port, b_port, body):
    """The uninterrupted stream on replica A, then a resume at a frame
    boundary half-way on replica B (which never saw the prompt): same ids,
    same text and finish, positions continuing where the journal stops,
    the stream's identity kept, no second role delta."""
    base = stream_raw(a_port, body)
    content, ids, finish, _ = assemble(base)
    frames = sse_events(base)
    tok_idx = [i for i, e in enumerate(frames) if "token_ids" in e]
    assert len(tok_idx) >= 2, f"too few token frames: {frames}"
    mid = tok_idx[len(tok_idx) // 2]
    k = frames[mid]["position"]
    suffix = "".join(((e.get("choices") or [{}])[0].get("delta") or {}).get("content") or ""
                     for e in frames[mid:])
    raw = stream_raw(b_port, dict(body, resume={"tokens": ids[:k], "id": "chatcmpl-drill",
                                                "created": 1234}))
    c2, ids2, fin2, cids2 = assemble(raw)
    assert ids2 == ids[k:], f"resume diverged: {ids2} vs {ids[k:]}"
    assert (c2, fin2, cids2) == (suffix, finish, {"chatcmpl-drill"})
    assert '"role"' not in raw
    assert next(e for e in sse_events(raw) if "token_ids" in e)["position"] == k


@pytest.fixture(scope="module")
def failover_real(files):
    """Two port replicas (paged, a small host tier), the first behind a
    severable wire, and the port's router."""
    servers = [_port_replica(files, kv_host_pages=4) for _ in range(2)]
    a_port, b_port = (h.server_address[1] for h, _ in servers)
    proxy = SeverProxy(a_port)
    rserver, router = _router([f"127.0.0.1:{proxy.port}", f"127.0.0.1:{b_port}"])
    yield rserver.server_address[1], router, a_port, b_port, proxy
    _teardown(rserver, router, servers, proxy)


@pytest.mark.parametrize("case", list(BODIES))
def test_cross_replica_resume_bit_exact(failover_real, case):
    _, _, a_port, b_port, _ = failover_real
    _resume_bit_exact(a_port, b_port, dict(
        {"messages": RESUME_MSGS, "stream": True, "max_tokens": 10,
         "include_token_ids": True}, **BODIES[case]))


def test_resume_validation(failover_real, files):
    """A sampled resume needs the original seed; resume must be an object
    of int tokens; the single-engine tier answers any resume with 400."""
    _, _, a_port, _, _ = failover_real
    base = {"messages": RESUME_MSGS, "max_tokens": 4}
    for extra, needle in (({"temperature": 0.8, "resume": {"tokens": [1, 2]}}, b"seed"),
                          ({"resume": [1, 2]}, b"object"),
                          ({"resume": {"tokens": ["a"]}}, b"int array")):
        st, data, _ = rpost(a_port, "/v1/chat/completions", dict(base, **extra))
        assert st == 400 and needle in data, (extra, data)
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.serve.api import make_server

    httpd, _ = make_server(load_model(*files, device="cpu"), n_slots=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        st, data, _ = rpost(httpd.server_address[1], "/v1/chat/completions",
                            dict(base, resume={"tokens": [1]}))
        assert st == 400 and b"batched scheduler tier" in data
    finally:
        _close(httpd)


def test_router_kill_mid_stream_bit_exact(failover_real):
    """The acceptance drill: the wire to the serving replica dies after the
    role delta and two token frames; the client's one stream completes with
    the uninterrupted run's ids and text, one identity, one `: retrying`,
    and the survivor's pool audits clean. Last on this mesh."""
    rport, router, a_port, b_port, proxy = failover_real
    body = {"messages": [{"role": "system", "content": "kill-drill preamble nobody else uses"},
                         {"role": "user", "content": "go"}],
            "stream": True, "max_tokens": 10, "temperature": 0.0, "seed": 11,
            "include_token_ids": True}
    content, ids, finish, _ = assemble(stream_raw(a_port, body))
    assert len(ids) >= 5, f"stream too short for a mid-stream kill: {ids}"
    with router._mu:
        router._affinity[Router.fingerprint(body, False)] = f"127.0.0.1:{proxy.port}"
    resumed0 = ins.ROUTER_FAILOVERS.labels(outcome="resumed").value()
    proxy.cut_after_frames = 3
    raw = stream_raw(rport, body)
    c2, ids2, fin2, cids2 = assemble(raw)
    assert ids2 == ids, f"token loss or duplication across the failover: {ids2} vs {ids}"
    assert (c2, fin2, len(cids2)) == (content, finish, 1)
    assert raw.count(": retrying") == 1
    assert ins.ROUTER_FAILOVERS.labels(outcome="resumed").value() - resumed0 == 1
    st, data = rget(b_port, "/debug/kv")
    assert st == 200 and json.loads(data)["audit"]["ok"] is True


# --------------------------------------------------------------- mixed mesh


@pytest.fixture(scope="module")
def mixed(files):
    """A port replica (behind a severable wire) and a JAX replica of the
    same file, both f32 caches, behind the port's router."""
    port_srv, jax_srv = _port_replica(files), _jax_replica(files)
    p_port, j_port = port_srv[0].server_address[1], jax_srv[0].server_address[1]
    proxy = SeverProxy(p_port)
    rserver, router = _router([f"127.0.0.1:{proxy.port}", f"127.0.0.1:{j_port}"])
    yield rserver.server_address[1], router, p_port, j_port, proxy
    _teardown(rserver, router, [port_srv, jax_srv], proxy)


def test_mixed_mesh_handshake_admits_both_packages(mixed):
    """The handshake compares (model id, version): both packages answer
    /v1/models with 'dllama-tpu' and report version 0.1.0, so a mixed mesh
    is one config and both replicas route."""
    port, router, _, _, _ = mixed
    st, data = rget(port, "/health")
    h = json.loads(data)
    assert st == 200 and h["mesh"] == {"model": "dllama-tpu", "version": "0.1.0"}
    assert all(r["config_ok"] and r["ready"] for r in h["replicas"])


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_mixed_mesh_greedy_resume_bit_exact(mixed, direction):
    """A greedy stream started on one package's replica and resumed on the
    other's continues with the same ids and text."""
    _, _, p_port, j_port, _ = mixed
    a, b = (p_port, j_port) if direction == "port_to_jax" else (j_port, p_port)
    _resume_bit_exact(a, b, {"messages": RESUME_MSGS, "stream": True, "max_tokens": 10,
                             "temperature": 0.0, "include_token_ids": True})


def test_mixed_mesh_router_fails_over_port_to_jax(mixed):
    """The router-kill drill across packages: the port replica's wire dies
    mid-stream, the JAX replica resumes it, and the client's stream equals
    the uninterrupted one."""
    rport, router, p_port, j_port, proxy = mixed
    body = {"messages": [{"role": "system", "content": "mixed-mesh kill drill"},
                         {"role": "user", "content": "go"}],
            "stream": True, "max_tokens": 10, "temperature": 0.0, "seed": 3,
            "include_token_ids": True}
    content, ids, finish, _ = assemble(stream_raw(p_port, body))
    assert len(ids) >= 5
    with router._mu:
        router._affinity[Router.fingerprint(body, False)] = f"127.0.0.1:{proxy.port}"
    proxy.cut_after_frames = 3
    raw = stream_raw(rport, body)
    c2, ids2, fin2, _ = assemble(raw)
    assert (ids2, c2, fin2) == (ids, content, finish)
    assert raw.count(": retrying") == 1


def test_router_cli_runs(files):
    """`router --replica H:P` through the port's CLI: it boots, answers
    /health with the mesh, and proxies a completion (run in a thread; the
    server is stopped through the router module's run loop)."""
    import socket

    from dllama_tpu_torch.cli.main import build_parser, main
    from dllama_tpu_torch.serve import router as router_mod

    args = build_parser().parse_args(["router", "--replica", "127.0.0.1:1"])
    assert args.model is None and args.port is None and args.failover_max == 2
    assert main(["router"]) == 1  # at least one --replica
    httpd, api = _port_replica(files)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        rport = s.getsockname()[1]
    started = {}
    orig = router_mod.make_router

    def capture(*a, **k):
        started["pair"] = orig(*a, **k)
        return started["pair"]

    router_mod.make_router = capture
    t = threading.Thread(target=main, args=(["router", "--replica",
                                             f"127.0.0.1:{httpd.server_address[1]}",
                                             "--port", str(rport), "--poll-s", "5"],),
                         daemon=True)
    try:
        t.start()
        deadline = time.monotonic() + 30
        while True:
            try:
                st, data = rget(rport, "/health")
                break
            except OSError:
                assert time.monotonic() < deadline, "router never came up"
                time.sleep(0.05)
        assert st == 200 and json.loads(data)["mode"] == "router"
        st, data, _ = rpost(rport, "/v1/chat/completions",
                            {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 3,
                             "temperature": 0.0})
        assert st == 200 and json.loads(data)["usage"]["completion_tokens"] == 3
    finally:
        router_mod.make_router = orig
        if "pair" in started:
            server, router = started["pair"]
            router.stop()
            server.shutdown()
        t.join(timeout=10)
        api.scheduler.shutdown()
        _close(httpd)
