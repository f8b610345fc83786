"""OpenAI-compatible HTTP API server, single-engine tier — the `dllama-api`
binary's role (dllama-api.cpp:509-581).

Routes: POST /v1/chat/completions and the legacy POST /v1/completions (both
stream + non-stream), GET /v1/models, GET /health (+ /health/live,
/health/ready). Every POST mints (or adopts from an inbound X-Request-Id) a
request id returned as the X-Request-Id header. Request params override the
CLI defaults as the reference's do (dllama-api.cpp:455-484): temperature,
top_p, presence/frequency_penalty, seed, max_tokens, stop, stream.

The **prefix cache** reproduces NaiveCache (dllama-api.cpp:264-309): the
previous request's chat history is kept with its KV-cache position; when a
new request's messages extend the cached ones, only the delta is encoded and
prefilled. Requests are serialized with a lock because one engine owns the
KV cache, as the reference is single-request. The JSON and SSE bodies are
those of the JAX package's single-engine tier.
"""

from __future__ import annotations

import json
import logging
import re
import select
import signal
import socket
import threading
import time
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from dllama_tpu_torch import __version__
from dllama_tpu_torch.engine.sampling import Sampler
from dllama_tpu_torch.tokenizer.chat import (
    ChatItem,
    ChatTemplate,
    ChatTemplateType,
    EosDetector,
    EosResult,
    chat_stops,
)

log = logging.getLogger("dllama_tpu_torch.serve")

#: socket errors meaning "the client went away"
CLIENT_GONE = (BrokenPipeError, ConnectionResetError, ConnectionAbortedError,
               TimeoutError, socket.timeout)

_REQ_ID_RE = re.compile(r"^[A-Za-z0-9._:-]{1,128}$")


def new_request_id(client_supplied: str | None = None) -> str:
    """Mint a ``req_<hex>`` id, or adopt a well-formed client-supplied
    ``X-Request-Id`` verbatim (a malformed one is replaced, never echoed)."""
    if client_supplied and _REQ_ID_RE.match(client_supplied):
        return client_supplied
    return "req_" + uuid.uuid4().hex[:24]


class ClientDisconnected(Exception):
    """Raised inside a completion when the disconnect probe sees the client
    socket closed: generation is cancelled."""


class Draining(Exception):
    """The server is draining (SIGTERM): new requests get 503."""

    retry_after_s = 1.0


class ApiError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def _parse_timeout(body: dict) -> float | None:
    """Per-request deadline: `timeout_s` in the body (or the X-Request-Timeout
    header). None/absent = no deadline."""
    v = body.get("timeout_s")
    if v is None:
        return None
    try:
        v = float(v)
    except (TypeError, ValueError):
        raise ApiError(400, "timeout_s must be a number of seconds") from None
    if not v > 0:
        raise ApiError(400, "timeout_s must be > 0")
    return v


def _validate_extras(body: dict) -> None:
    """Fields the batched tier acts on and this tier accepts inert: validated
    like the JAX package validates them, so a malformed one is a 400."""
    v = body.get("spec_k")
    if v is not None:
        try:
            ok = int(v) >= 0
        except (TypeError, ValueError):
            ok = False
        if not ok:
            raise ApiError(400, "spec_k must be an integer >= 0")
    p = body.get("priority")
    if p is not None:
        names = {"low", "normal", "high"}
        try:
            ok = p in names if isinstance(p, str) else 0 <= int(p) <= 2
        except (TypeError, ValueError):
            ok = False
        if not ok:
            raise ApiError(400, "priority must be an integer 0..2 or one of "
                                "low|normal|high")
    t = body.get("tenant")
    if t is not None and (not isinstance(t, str) or len(t) > 64):
        raise ApiError(400, "tenant must be a string of at most 64 chars")


@dataclass
class PrefixCache:
    """NaiveCache equivalent: the last conversation's messages and the KV
    position right after them."""

    messages: list[tuple[str, str]] = field(default_factory=list)
    pos: int = 0
    bos_sent: bool = False

    def resolve(self, incoming: list[tuple[str, str]]) -> tuple[list[tuple[str, str]], int, bool]:
        """-> (delta_messages, start_pos, add_bos). Matches whole-message
        prefixes only, like resolveDeltaPrompt (dllama-api.cpp:286-308)."""
        n = len(self.messages)
        if n and len(incoming) > n and incoming[:n] == self.messages:
            return incoming[n:], self.pos, False
        return incoming, 0, True

    def clear(self) -> None:
        self.messages = []
        self.pos = 0
        self.bos_sent = False


class ApiServer:
    def __init__(self, loaded, default_temperature=0.8, default_topp=0.9,
                 default_seed=None, replica_id: str = "", sse_heartbeat_s: float = 0.0):
        self.engine = loaded.engine
        self.tokenizer = loaded.tokenizer
        self.config = loaded.config
        self.template = ChatTemplate(ChatTemplateType.UNKNOWN, self.tokenizer.chat_template, "")
        self.stops = chat_stops(self.tokenizer)
        self.defaults = dict(temperature=default_temperature, topp=default_topp,
                             seed=default_seed)
        self.cache = PrefixCache()
        self.replica_id = str(replica_id or "")
        self.sse_heartbeat_s = float(sse_heartbeat_s or 0.0)
        self.lock = threading.Lock()
        self.model_name = "dllama-tpu"
        self.draining = False
        self.build_info = {"version": __version__, "backend": self.engine.device.type,
                           "kernels": self.engine.backend,
                           "attention": self.engine.attn_route}

    def health(self) -> dict:
        h = {"live": True, "ready": not self.draining, "queue_depth": 0,
             "busy_slots": 0, "n_slots": 0, "status": "ok", "mode": "single",
             "build": self.build_info}
        if self.draining:
            h["draining"] = True
        return h

    def precheck_capacity(self) -> None:
        if self.draining:
            raise Draining("server is draining")

    # ------------------------------------------------------------------ core

    def complete(self, body: dict, emit=None, probe=None, req_id: str = "") -> dict:
        """Run one chat completion. `emit(text)` streams deltas when given;
        `probe()` returns True when the client socket is gone. Returns the
        non-streaming response dict (also when streaming, for the usage)."""
        t_submit = time.monotonic()
        if body.get("resume") is not None:
            raise ApiError(400, "resume requires the batched scheduler tier")
        messages = [(m["role"], str(m["content"])) for m in body.get("messages", [])]
        if not messages:
            raise ApiError(400, "messages must be a non-empty array")
        temperature = float(body.get("temperature", self.defaults["temperature"]))
        topp = float(body.get("top_p", self.defaults["topp"]))
        # `or 0.0`: OpenAI treats an explicit JSON null as "use default"
        presence = float(body.get("presence_penalty") or 0.0)
        frequency = float(body.get("frequency_penalty") or 0.0)
        seed = body.get("seed", self.defaults["seed"])
        max_tokens = int(body.get("max_tokens") or body.get("max_completion_tokens") or 0)
        timeout_s = _parse_timeout(body)
        _validate_extras(body)
        extra_stops = body.get("stop") or []
        if isinstance(extra_stops, str):
            extra_stops = [extra_stops]

        with self.lock:
            t_admit = time.monotonic()
            delta, start_pos, add_bos = self.cache.resolve(messages)
            if start_pos == 0:
                self.cache.clear()
            self.engine.reset(start_pos)
            generated = self.template.generate(
                [ChatItem(r, c) for r, c in delta], append_generation_prompt=True)
            prompt_tokens = self.tokenizer.encode(generated.content, add_bos=add_bos)
            budget, sampler = self._budget_and_sampler(
                len(prompt_tokens), max_tokens, temperature, topp, seed, presence, frequency)
            content, finish, n_generated, t_first = self._run_single(
                prompt_tokens, budget, sampler, self.stops + list(extra_stops), emit,
                probe=probe, deadline=None if timeout_s is None else t_submit + timeout_s)
            if not (finish == "timeout" and n_generated == 0):
                # cache the full conversation incl. the reply for the next
                # turn (a request that expired on the lock prefilled nothing)
                self.cache.messages = messages + [("assistant", content)]
                self.cache.pos = self.engine.pos
                self.cache.bos_sent = True
        timings = self._timings(t_submit, t_admit, t_first, n_generated, finish, timeout_s)
        return {
            "timings": timings,
            "id": f"chatcmpl-{uuid.uuid4().hex[:16]}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": body.get("model", self.model_name),
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": content},
                "finish_reason": finish,
            }],
            "usage": {
                "prompt_tokens": len(prompt_tokens),
                "completion_tokens": n_generated,
                "total_tokens": len(prompt_tokens) + n_generated,
            },
        }

    @staticmethod
    def _normalize_legacy_prompt(body: dict) -> str:
        prompt = body.get("prompt")
        if isinstance(prompt, list):
            if len(prompt) != 1:
                raise ApiError(400, "only a single prompt is supported")
            prompt = prompt[0]
        if not isinstance(prompt, str) or not prompt:
            raise ApiError(400, "prompt must be a non-empty string")
        return prompt

    def prevalidate(self, body: dict, legacy: bool = False) -> None:
        """Raise ApiError for request-shape problems detectable without the
        engine — run before streaming headers go out."""
        _parse_timeout(body)
        _validate_extras(body)
        if legacy:
            self._normalize_legacy_prompt(body)
            return
        messages = body.get("messages")
        if (not isinstance(messages, list) or not messages
                or not all(isinstance(m, dict) and "role" in m and "content" in m
                           for m in messages)):
            raise ApiError(400, "messages must be a non-empty array of "
                                "{role, content} objects")

    def _budget_and_sampler(self, prompt_len, max_tokens, temperature, topp, seed,
                            presence, frequency):
        budget = self.engine.seq_len - self.engine.pos - prompt_len - 1
        if budget <= 0:
            raise ApiError(400, "context window exhausted")
        if max_tokens > 0:
            budget = min(budget, max_tokens)
        sampler = Sampler(temperature, topp,
                          seed if seed is not None else int(time.time()),
                          presence=presence, frequency=frequency)
        return budget, sampler

    def _timings(self, t_submit, t_admit, t_first, n_generated, finish,
                 timeout_s=None) -> dict:
        t_done = time.monotonic()
        timings = {
            "queue_wait_ms": round((t_admit - t_submit) * 1000.0, 3),
            "ttft_ms": (None if t_first is None
                        else round((t_first - t_submit) * 1000.0, 3)),
            "e2e_ms": round((t_done - t_submit) * 1000.0, 3),
            "decode_tokens": n_generated,
        }
        if timeout_s is not None:
            timings["timeout_s"] = timeout_s
            timings["deadline_exceeded"] = finish == "timeout"
        if self.replica_id:
            timings["replica"] = self.replica_id
        return timings

    def _run_single(self, prompt_tokens, budget, sampler, stops, emit, probe=None,
                    deadline=None) -> tuple[str, str, int, float | None]:
        """Token loop of a completion (generate + EOS/stop detection +
        held-prefix flush) -> (content, finish_reason, n_tokens,
        first_token_monotonic_or_None). The caller holds self.lock and has
        positioned the engine."""
        if deadline is not None and time.monotonic() >= deadline:
            return "", "timeout", 0, None  # expired on the lock: no engine work
        detector = EosDetector(self.tokenizer.eos_ids, stops, padding_left=2, padding_right=2)
        self.tokenizer.reset_decoder()
        parts: list[str] = []
        n_generated = 0
        finish = "length"
        t_first = None
        timed_out = False
        probe_at = time.monotonic() + 0.25

        def out(text):
            if text:
                parts.append(text)
                if emit is not None:
                    emit(text)

        for t in self.engine.generate(prompt_tokens, budget, sampler):
            if t_first is None:
                t_first = time.monotonic()
            if probe is not None and time.monotonic() >= probe_at:
                probe_at = time.monotonic() + 0.25
                if probe():
                    raise ClientDisconnected()
            n_generated += 1
            res = detector.append(t, self.tokenizer.decode(t))
            out(detector.get_delta())
            if res == EosResult.EOS:
                finish = "stop"
                break
            if deadline is not None and time.monotonic() >= deadline:
                finish = "timeout"
                timed_out = True
                break
        else:
            out(detector.flush())  # budget exhausted mid-held-prefix
        if timed_out:
            out(detector.flush())
        return "".join(parts), finish, n_generated, t_first

    def complete_legacy(self, body: dict, emit=None, probe=None, req_id: str = "") -> dict:
        """POST /v1/completions: a RAW prompt string, no chat template,
        `text` in the choices."""
        t_submit = time.monotonic()
        if body.get("resume") is not None:
            raise ApiError(400, "resume requires the batched scheduler tier")
        prompt = self._normalize_legacy_prompt(body)
        temperature = float(body.get("temperature", self.defaults["temperature"]))
        topp = float(body.get("top_p", self.defaults["topp"]))
        presence = float(body.get("presence_penalty") or 0.0)
        frequency = float(body.get("frequency_penalty") or 0.0)
        seed = body.get("seed", self.defaults["seed"])
        max_tokens = int(body.get("max_tokens") or 16)  # legacy default
        timeout_s = _parse_timeout(body)
        _validate_extras(body)
        extra_stops = body.get("stop") or []
        if isinstance(extra_stops, str):
            extra_stops = [extra_stops]
        prompt_tokens = self.tokenizer.encode(prompt, add_bos=True)
        with self.lock:
            t_admit = time.monotonic()
            self.cache.clear()  # raw-prompt rows overwrite the chat cache's claim
            self.engine.reset(0)
            budget, sampler = self._budget_and_sampler(
                len(prompt_tokens), max_tokens, temperature, topp, seed, presence, frequency)
            content, finish, n_generated, t_first = self._run_single(
                prompt_tokens, budget, sampler, list(extra_stops), emit, probe=probe,
                deadline=None if timeout_s is None else t_submit + timeout_s)
        timings = self._timings(t_submit, t_admit, t_first, n_generated, finish, timeout_s)
        return {
            "timings": timings,
            "id": f"cmpl-{uuid.uuid4().hex[:16]}",
            "object": "text_completion",
            "created": int(time.time()),
            "model": body.get("model", self.model_name),
            "choices": [{"index": 0, "text": content, "logprobs": None,
                         "finish_reason": finish}],
            "usage": {
                "prompt_tokens": len(prompt_tokens),
                "completion_tokens": n_generated,
                "total_tokens": len(prompt_tokens) + n_generated,
            },
        }

    def models(self) -> dict:
        return {"object": "list", "data": [{
            "id": self.model_name, "object": "model", "created": int(time.time()),
            "owned_by": "dllama-tpu"}]}


#: SSE comment frame: the keep-alive heartbeat idle streams emit
SSE_HEARTBEAT = b": keep-alive\n\n"


def sse_chat_payload(cid: str, created: int, model: str, delta: dict, finish=None,
                     timings=None) -> bytes:
    """One `chat.completion.chunk` SSE data frame."""
    data = {
        "id": cid,
        "object": "chat.completion.chunk",
        "created": created,
        "model": model,
        "choices": [{"index": 0, "delta": delta, "finish_reason": finish}],
    }
    if timings is not None:
        data["timings"] = timings
    return b"data: " + json.dumps(data).encode() + b"\n\n"


def sse_text_payload(cid: str, created: int, model: str, text: str, finish=None,
                     timings=None) -> bytes:
    """One legacy `text_completion` SSE data frame."""
    data = {
        "id": cid,
        "object": "text_completion",
        "created": created,
        "model": model,
        "choices": [{"index": 0, "text": text, "finish_reason": finish}],
    }
    if timings is not None:
        data["timings"] = timings
    return b"data: " + json.dumps(data).encode() + b"\n\n"


class RequestRoutes:
    """The HTTP routes, written against a transport seam (``_send_raw``,
    ``_start_sse``, ``_write_chunk``, ``_read_body``, ``_client_gone``) plus
    ``path``/``headers`` of the current request."""

    api: ApiServer
    _req_id: str | None = None
    path: str = ""

    def _send_json(self, status: int, payload: dict, headers: dict | None = None) -> None:
        rid = self._req_id
        if rid and isinstance(payload.get("error"), dict):
            payload["error"].setdefault("request_id", rid)
        data = json.dumps(payload).encode()
        hdrs = [("Content-Type", "application/json"), ("Content-Length", str(len(data)))]
        if rid:
            hdrs.append(("X-Request-Id", rid))
        if self.api.replica_id:
            hdrs.append(("X-Replica-Id", self.api.replica_id))
        hdrs.extend((headers or {}).items())
        self._send_raw(status, hdrs, data)

    def do_GET(self):
        self._req_id = None
        if self.path == "/v1/models":
            self._send_json(200, self.api.models())
        elif self.path in ("/health", "/health/live", "/health/ready"):
            h = self.api.health()
            key = "ready" if self.path.endswith("/ready") else "live"
            self._send_json(200 if h[key] else 503, h)
        else:
            self._send_json(404, {"error": {"message": "not found"}})

    def do_POST(self):
        rid = self._req_id = new_request_id(self.headers.get("X-Request-Id"))
        chat = self.path in ("/v1/chat/completions", "/chat/completions")
        legacy = self.path in ("/v1/completions", "/completions")
        # consume the body before any early answer: on a keep-alive
        # connection unread bytes would be parsed as the next request line
        try:
            raw = self._read_body()
        except (ValueError, OSError):
            self._send_json(400, {"error": {"message": "invalid request"}})
            return
        if not (chat or legacy):
            self._send_json(404, {"error": {"message": "not found"}})
            return
        try:
            body = json.loads(raw or b"{}")
        except (ValueError, json.JSONDecodeError):
            self._send_json(400, {"error": {"message": "invalid JSON body"}})
            return
        tmo_hdr = self.headers.get("X-Request-Timeout")
        if tmo_hdr is not None and isinstance(body, dict) and "timeout_s" not in body:
            body["timeout_s"] = tmo_hdr
        try:
            self.api.precheck_capacity()
            if body.get("stream"):
                # validate BEFORE the 200/chunked headers go out: an error
                # after them would corrupt the stream
                self.api.prevalidate(body, legacy=legacy)
                self._stream(body, legacy=legacy)
            elif legacy:
                result = self.api.complete_legacy(body, probe=self._client_gone, req_id=rid)
                result["request_id"] = rid
                self._send_json(200, result)
            else:
                result = self.api.complete(body, probe=self._client_gone, req_id=rid)
                result["request_id"] = rid
                self._send_json(200, result)
        except ApiError as e:
            log.info("request %s rejected: %s", rid, e.message)
            self._send_json(e.status, {"error": {"message": e.message}})
        except Draining as e:
            self._send_json(503, {"error": {"message": str(e)}},
                            {"Retry-After": str(int(e.retry_after_s))})
        except ClientDisconnected:
            log.info("client disconnected; request %s cancelled", rid)
        except CLIENT_GONE:
            log.info("client connection lost mid-response (request %s)", rid)
        except Exception:
            log.exception("completion %s failed", rid)
            try:
                self._send_json(500, {"error": {"message": "internal error"}})
            except CLIENT_GONE:
                pass

    def _stream(self, body: dict, legacy: bool = False) -> None:
        """SSE chunked streaming (dllama-api.cpp:203-223's role)."""
        rid = self._req_id
        self._start_sse()
        cid = f"{'cmpl' if legacy else 'chatcmpl'}-{uuid.uuid4().hex[:16]}"
        created = int(time.time())
        model = body.get("model", self.api.model_name)
        chunk = self._write_chunk
        last_write = [time.monotonic()]
        hb = self.api.sse_heartbeat_s

        def emit_chat(delta: dict, finish=None, timings=None) -> None:
            chunk(sse_chat_payload(cid, created, model, delta, finish=finish, timings=timings))
            last_write[0] = time.monotonic()

        def emit_text(text: str, finish=None, timings=None) -> None:
            chunk(sse_text_payload(cid, created, model, text, finish=finish, timings=timings))
            last_write[0] = time.monotonic()

        def probe() -> bool:
            if hb and time.monotonic() - last_write[0] >= hb:
                chunk(SSE_HEARTBEAT)
                last_write[0] = time.monotonic()
            return self._client_gone()

        try:
            if legacy:
                result = self.api.complete_legacy(body, emit=emit_text, probe=probe, req_id=rid)
                emit_text("", finish=result["choices"][0]["finish_reason"],
                          timings=result.get("timings"))
            else:
                emit_chat({"role": "assistant"})
                result = self.api.complete(
                    body, emit=lambda text: emit_chat({"content": text}), probe=probe,
                    req_id=rid)
                emit_chat({}, finish=result["choices"][0]["finish_reason"],
                          timings=result.get("timings"))
        except (ClientDisconnected, *CLIENT_GONE):
            raise
        except Exception as e:
            # the headers are out: report in-band and end the stream cleanly
            log.exception("streamed completion %s failed mid-stream", rid)
            msg = str(e) if isinstance(e, ApiError) else "internal error"
            err = {"message": msg or e.__class__.__name__, "type": "server_error"}
            if rid:
                err["request_id"] = rid
            chunk(b"data: " + json.dumps({"error": err}).encode() + b"\n\n")
        chunk(b"data: [DONE]\n\n")
        chunk(b"")  # terminating zero-length chunk


class _Handler(RequestRoutes, BaseHTTPRequestHandler):
    """Thread-per-connection transport (stdlib BaseHTTPRequestHandler)."""

    server_version = "dllama-tpu"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        log.info("%s %s", self.address_string(), fmt % args)

    def _send_raw(self, status: int, headers, body: bytes) -> None:
        self.send_response(status)
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _start_sse(self) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        if self._req_id:
            self.send_header("X-Request-Id", self._req_id)
        if self.api.replica_id:
            self.send_header("X-Replica-Id", self.api.replica_id)
        self.end_headers()

    def _write_chunk(self, payload: bytes) -> None:
        self.wfile.write(f"{len(payload):x}\r\n".encode() + payload + b"\r\n")
        self.wfile.flush()

    def _read_body(self) -> bytes:
        return self.rfile.read(int(self.headers.get("Content-Length", 0)))

    def _client_gone(self) -> bool:
        """A readable socket that MSG_PEEKs zero bytes is a closed peer."""
        try:
            r, _, _ = select.select([self.connection], [], [], 0)
            if not r:
                return False
            return self.connection.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True


def make_server(loaded, host="127.0.0.1", port=0, n_slots: int = 0, **defaults):
    """-> (server, api): the single-engine tier on a ThreadingHTTPServer.
    The continuous-batching tier (n_slots > 0), speculative decoding and the
    aio front end are not yet ported and raise."""
    if n_slots > 0:
        raise NotImplementedError("--slots > 0 (continuous batching) is not yet "
                                  "ported to the PyTorch/CUDA package")
    if int(defaults.get("spec") or 0) > 0:
        raise NotImplementedError("speculative decoding (--spec) is not yet "
                                  "ported to the PyTorch/CUDA package")
    frontend = str(defaults.get("frontend") or "threads")
    if frontend != "threads":
        raise NotImplementedError(f"--frontend {frontend} is not yet ported to the "
                                  "PyTorch/CUDA package (threads is)")
    api = ApiServer(
        loaded,
        default_temperature=defaults.get("default_temperature", 0.8),
        default_topp=defaults.get("default_topp", 0.9),
        default_seed=defaults.get("default_seed"),
        replica_id=defaults.get("replica_id") or "",
        sse_heartbeat_s=defaults.get("sse_heartbeat_s") or 0.0,
    )
    handler = type("Handler", (_Handler,), {"api": api})
    httpd = ThreadingHTTPServer((host, port), handler)
    if not api.replica_id:
        ident = socket.gethostname() if host in ("0.0.0.0", "::", "") else host
        api.replica_id = f"{ident}:{httpd.server_address[1]}"
    return httpd, api


def graceful_drain(httpd, api, timeout_s: float = 30.0) -> bool:
    """Stop admission (503), let the in-flight request finish (bounded by
    `timeout_s`), stop the accept loop. True when it finished in time."""
    api.draining = True
    clean = api.lock.acquire(timeout=max(0.0, timeout_s))
    if clean:
        api.lock.release()
    httpd.shutdown()
    return clean


def install_sigterm_drain(httpd, api, timeout_s: float = 30.0) -> bool:
    """SIGTERM -> graceful_drain in a helper thread. False when not on the
    main thread, where signal.signal raises."""
    fired = threading.Event()

    def _term(signum, frame):
        if fired.is_set():
            return
        fired.set()
        log.info("SIGTERM: draining (timeout %.0fs) — new requests get 503", timeout_s)
        threading.Thread(target=graceful_drain, args=(httpd, api, timeout_s),
                         name="dllama-drain", daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _term)
        return True
    except ValueError:
        return False


def run_server(loaded, host="127.0.0.1", port=9990, n_slots: int = 0, **defaults) -> int:
    httpd, api = make_server(loaded, host, port, n_slots=n_slots, **defaults)
    install_sigterm_drain(httpd, api, float(defaults.get("drain_timeout_s") or 30.0))
    log.info("serving on http://%s:%d (single-request + prefix cache)",
             host, httpd.server_address[1])
    print(f"🚀 http://{host}:{httpd.server_address[1]}/v1/chat/completions "
          "(single-request + prefix cache)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0
