"""The port's continuous-batching server against the JAX package's, over real
sockets: both serve the golden `.m` with 3 slots on the paged KV cache at
page 16 (the JAX server with its radix tree, hybrid prefill and preemption
off, the configuration the port has). Concurrent temperature-0 chat requests,
plain and SSE, must carry the same content on both; a second turn must reuse
cached rows; a full admission queue answers 429 with Retry-After; after a
drain the page pool audits clean with every page free. Port only: the
scheduler's streams are the same dense and paged, overlap on and off."""

import http.client
import json
import threading

import pytest
import torch

from tests.golden_fixture import write_tiktoken_file
from tests.test_golden import FIXTURE_M

torch.set_num_threads(1)

PROMPTS = ["hello world", "tell me a story", "abc"]
PAGED = dict(n_slots=3, kv_layout="paged", page_size=16)


def _tokenizer_path(tmp_path_factory) -> str:
    from dllama_tpu.tools.convert_tokenizer import convert_llama3_tokenizer

    tmp = tmp_path_factory.mktemp("torch_continuous")
    write_tiktoken_file(str(tmp / "tokenizer.model"))
    tpath = str(tmp / "golden.t")
    convert_llama3_tokenizer(str(tmp / "tokenizer.model")).save(tpath)
    return tpath


def _start(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _stop(httpd):
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture(scope="module")
def tpath(tmp_path_factory):
    return _tokenizer_path(tmp_path_factory)


@pytest.fixture(scope="module")
def servers(tpath):
    import jax.numpy as jnp

    from dllama_tpu.engine.loader import load_model as jax_load
    from dllama_tpu.serve.api import make_server as jax_server
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.serve.api import make_server

    httpd, api = make_server(load_model(FIXTURE_M, tpath, cache_dtype=torch.float32,
                                        device="cpu"), **PAGED)
    jhttpd, _ = jax_server(jax_load(FIXTURE_M, tpath, mesh=None, cache_dtype=jnp.float32),
                           frontend="threads", radix_cache="off", prefill_budget=0,
                           preempt="off", **PAGED)
    _start(httpd), _start(jhttpd)
    yield httpd.server_address[1], jhttpd.server_address[1], api
    for h in (httpd, jhttpd):
        _stop(h)
    api.scheduler.shutdown()


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/chat/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, dict(resp.getheaders()), data


def _content(port, messages, stream=False, max_tokens=8):
    body = {"messages": messages, "temperature": 0, "max_tokens": max_tokens,
            "stream": stream}
    status, _, raw = _post(port, body)
    assert status == 200, raw
    if not stream:
        return json.loads(raw)["choices"][0]["message"]["content"]
    events = [ln[6:] for ln in raw.decode().split("\n") if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant"}
    assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    return "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)


def _concurrently(fn, args_list):
    out = [None] * len(args_list)

    def run(i, args):
        out[i] = fn(*args)

    threads = [threading.Thread(target=run, args=(i, a)) for i, a in enumerate(args_list)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    return out


@pytest.mark.parametrize("stream", [False, True])
def test_concurrent_requests_same_content_as_jax_server(servers, stream):
    port, jax_port, api = servers
    chats = [[{"role": "user", "content": p}] for p in PROMPTS]
    got = _concurrently(_content, [(port, c, stream) for c in chats])
    want = _concurrently(_content, [(jax_port, c, stream) for c in chats])
    assert got == want
    assert api.scheduler.engine.attn_route == "paged_gather"  # the kernel's plain version


def test_second_turn_reuses_rows(servers):
    port, jax_port, api = servers
    chat = [{"role": "user", "content": "hello world"}]
    first = _content(port, chat)
    assert first == _content(jax_port, chat)
    turn2 = chat + [{"role": "assistant", "content": first},
                    {"role": "user", "content": "and again"}]
    before = api.scheduler.reused_prefix_tokens
    assert _content(port, turn2) == _content(jax_port, turn2)
    assert api.scheduler.reused_prefix_tokens > before
    h = api.health()
    assert h["mode"] == "continuous" and h["n_slots"] == 3 and h["busy_slots"] == 0
    assert h["build"]["kv_layout"] == "paged"


def test_full_queue_answers_429_and_drain_frees_every_page(tpath):
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.serve.api import graceful_drain, make_server

    httpd, api = make_server(load_model(FIXTURE_M, tpath, cache_dtype=torch.float32,
                                        device="cpu"),
                             n_slots=1, kv_layout="paged", page_size=16, max_queue=1)
    _start(httpd)
    pool = api.scheduler.engine.pool
    pool.audit_on_release = True
    body = {"messages": [{"role": "user", "content": "hello world"}], "temperature": 0,
            "max_tokens": 100}
    port = httpd.server_address[1]
    try:
        replies = _concurrently(_post, [(port, body)] * 6)
    finally:
        clean = graceful_drain(httpd, api, timeout_s=60)
        httpd.server_close()
    statuses = sorted(r[0] for r in replies)
    assert 429 in statuses and 200 in statuses and set(statuses) <= {200, 429}, statuses
    assert all(int(h["Retry-After"]) >= 1 for s, h, _ in replies if s == 429)
    assert clean
    report = pool.audit()
    assert report["ok"] and report["free"] == report["total"]


def test_scheduler_streams_equal_across_layouts_and_overlap(tpath):
    """The scheduler's token streams do not depend on the KV layout or on
    the overlapped pipeline; a request cancelled after its first token ends
    'cancelled' and gives its pages back."""
    from dllama_tpu_torch.engine.batch import BatchEngine
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.serve.scheduler import Scheduler

    loaded = load_model(FIXTURE_M, tpath, cache_dtype=torch.float32, device="cpu")
    prompts = [loaded.tokenizer.encode(p, add_bos=True) for p in PROMPTS + ["one more"]]
    streams = []
    for layout, overlap in (("dense", True), ("paged", True), ("paged", False)):
        eng = BatchEngine(loaded.config, loaded.engine.params, n_slots=3,
                          cache_dtype=torch.float32, kv_layout=layout, page_size=16)
        sched = Scheduler(eng, overlap=overlap)
        try:
            reqs = [sched.submit(p, 0.0, 0.9, 12, loaded.tokenizer.eos_ids) for p in prompts]
            victim = sched.submit(prompts[0], 0.0, 0.9, 100, [])
            it = victim.tokens()
            next(it)
            sched.cancel(victim)
            list(it)  # the stream ends once the worker releases the slot
            streams.append([list(r.tokens()) for r in reqs])
            assert victim.finish_reason == "cancelled" and victim.produced < 100
        finally:
            assert sched.drain(timeout_s=60)
        if eng.pool is not None:
            report = eng.pool.audit()
            assert report["ok"] and report["free"] == report["total"]
    assert streams[0] == streams[1] == streams[2]
    assert all(streams[0])
