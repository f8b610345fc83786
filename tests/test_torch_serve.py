"""The port's HTTP server against the JAX package's single-engine tier, over
real sockets: the golden `.m` with the tokenizer built as test_golden builds
it, temperature-0 chat completions (plain and SSE) must carry the same
content on both servers, and a second turn must hit the prefix cache."""

import http.client
import json
import threading

import pytest
import torch

from tests.golden_fixture import write_tiktoken_file
from tests.test_golden import FIXTURE_M

torch.set_num_threads(1)

CHAT = [{"role": "user", "content": "hello world"}]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    import jax.numpy as jnp

    from dllama_tpu.engine.loader import load_model as jax_load
    from dllama_tpu.serve.api import make_server as jax_server
    from dllama_tpu.tools.convert_tokenizer import convert_llama3_tokenizer
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.serve.api import make_server

    tmp = tmp_path_factory.mktemp("torch_serve")
    write_tiktoken_file(str(tmp / "tokenizer.model"))
    tpath = str(tmp / "golden.t")
    convert_llama3_tokenizer(str(tmp / "tokenizer.model")).save(tpath)
    started = []
    for make, loaded in (
            (make_server, load_model(FIXTURE_M, tpath, cache_dtype=torch.float32,
                                     device="cpu")),
            (jax_server, jax_load(FIXTURE_M, tpath, mesh=None, cache_dtype=jnp.float32))):
        httpd, _ = make(loaded, host="127.0.0.1", port=0, frontend="threads")
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        started.append(httpd)
    yield [h.server_address[1] for h in started] + [tpath]
    for h in started:
        h.shutdown()
        h.server_close()


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/chat/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    assert resp.status == 200, data
    return data


def _content(port, messages, stream=False):
    body = {"messages": messages, "temperature": 0, "max_tokens": 8, "stream": stream}
    raw = _post(port, body)
    if not stream:
        out = json.loads(raw)
        return out["choices"][0]["message"]["content"], out
    events = [ln[6:] for ln in raw.decode().split("\n") if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant"}
    assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    return "".join(c["choices"][0]["delta"].get("content", "") for c in chunks), None


@pytest.mark.parametrize("stream", [False, True])
def test_same_content_as_jax_server(servers, stream):
    port, jax_port, _ = servers
    got, _ = _content(port, CHAT, stream)
    want, _ = _content(jax_port, CHAT, stream)
    assert got == want


def test_second_turn_hits_prefix_cache(servers):
    from dllama_tpu_torch.tokenizer.chat import ChatItem, ChatTemplate, ChatTemplateType
    from dllama_tpu_torch.tokenizer.tokenizer import Tokenizer

    port, jax_port, tpath = servers
    first, _ = _content(port, CHAT)
    assert _content(jax_port, CHAT)[0] == first
    turn2 = CHAT + [{"role": "assistant", "content": first},
                    {"role": "user", "content": "and again"}]
    got, out = _content(port, turn2)
    want, jout = _content(jax_port, turn2)
    tok = Tokenizer.load(tpath)
    full = len(tok.encode(ChatTemplate(ChatTemplateType.UNKNOWN, tok.chat_template, "")
                          .generate([ChatItem(m["role"], m["content"]) for m in turn2]).content))
    assert out["usage"]["prompt_tokens"] < full  # only the delta was prefilled
    assert out["usage"]["prompt_tokens"] == jout["usage"]["prompt_tokens"]
    assert got == want
