"""OpenAI-compatible HTTP API server — the `dllama-api` binary's role
(dllama-api.cpp:509-581) — in two tiers: the single-engine tier
(``n_slots == 0``) and the continuous-batching tier (``n_slots > 0``: a
BatchEngine behind a Scheduler, concurrent requests sharing the card).

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
KV cache, as the reference is single-request. On the batched tier the
scheduler's per-slot prefix cache does the same at the token level, for many
conversations at once. The JSON and SSE bodies are those of the JAX
package's tiers; a full admission queue answers 429 with Retry-After.
"""

from __future__ import annotations

import json
import logging
import math
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
from dllama_tpu_torch.serve.scheduler import QueueFull, SchedulerRejected
from dllama_tpu_torch.tokenizer.chat import (
    ChatItem,
    ChatTemplate,
    ChatTemplateType,
    TokenAssembler,
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


def _parse_spec_k(body: dict) -> int | None:
    """Per-request speculation: ``spec_k`` in the body, the draft length of
    this request (0 disables speculation for it; values above the server's
    --spec clamp down to it). None = the server's --spec."""
    v = body.get("spec_k")
    if v is None:
        return None
    try:
        v = int(v)
    except (TypeError, ValueError):
        raise ApiError(400, "spec_k must be an integer >= 0") from None
    if v < 0:
        raise ApiError(400, "spec_k must be an integer >= 0")
    return v


def _validate_extras(body: dict) -> None:
    """Fields the batched tier accepts inert (priority, tenant) and spec_k:
    validated like the JAX package validates them, so a malformed one is a
    400."""
    _parse_spec_k(body)
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
                 default_seed=None, replica_id: str = "", sse_heartbeat_s: float = 0.0,
                 scheduler=None, spec: int = 0):
        self.scheduler = scheduler
        # prompt-lookup speculative decoding of greedy single-engine
        # requests: the draft length, and the cap of a request's spec_k
        self.spec = int(spec)
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
        eng = scheduler.engine if scheduler is not None else self.engine
        self.build_info = {"version": __version__, "backend": eng.device.type,
                           "kernels": eng.backend, "attention": eng.attn_route}
        if scheduler is not None:
            self.build_info["kv_layout"] = eng.kv_layout

    def health(self) -> dict:
        if self.scheduler is not None:
            h = self.scheduler.health()
        else:
            h = {"live": True, "ready": True, "queue_depth": 0, "busy_slots": 0,
                 "n_slots": 0}
        if self.draining:
            h["ready"] = False
            h["draining"] = True
        h["status"] = "ok" if h["live"] else "unhealthy"
        h["mode"] = "continuous" if self.scheduler is not None else "single"
        h["build"] = self.build_info
        return h

    def precheck_capacity(self) -> None:
        """Raise what a submit would raise, without submitting: stream
        handlers call it before their 200/chunked headers go out."""
        if self.draining:
            raise Draining("server is draining")
        if self.scheduler is not None:
            self.scheduler.check_admission()

    # ------------------------------------------------------------------ core

    def complete(self, body: dict, emit=None, probe=None, req_id: str = "") -> dict:
        """Run one chat completion. `emit(text)` streams deltas when given;
        `probe()` returns True when the client socket is gone. Returns the
        non-streaming response dict (also when streaming, for the usage)."""
        return self._completion(body, False, emit, probe, req_id)

    def complete_legacy(self, body: dict, emit=None, probe=None, req_id: str = "") -> dict:
        """POST /v1/completions: a RAW prompt string, no chat template,
        `text` in the choices."""
        return self._completion(body, True, emit, probe, req_id)

    def _completion(self, body: dict, legacy: bool, emit, probe, req_id: str) -> dict:
        t_submit = time.monotonic()
        p = self.prepare_request(body, legacy=legacy)
        if self.scheduler is not None:
            content, finish, n_generated, timings = self._run_batched(p, emit, probe, req_id)
        else:
            content, finish, n_generated, timings = self._serve_single(p, emit, probe, t_submit)
        n_prompt = len(p["prompt_tokens"])
        if legacy:
            head = {"id": f"cmpl-{uuid.uuid4().hex[:16]}", "object": "text_completion"}
            choice = {"index": 0, "text": content, "logprobs": None, "finish_reason": finish}
        else:
            head = {"id": f"chatcmpl-{uuid.uuid4().hex[:16]}", "object": "chat.completion"}
            choice = {"index": 0, "message": {"role": "assistant", "content": content},
                      "finish_reason": finish}
        return {
            "timings": timings,
            **head,
            "created": int(time.time()),
            "model": body.get("model", self.model_name),
            "choices": [choice],
            "usage": {
                "prompt_tokens": n_prompt,
                "completion_tokens": n_generated,
                "total_tokens": n_prompt + n_generated,
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

    def _encode_chat(self, messages, add_bos: bool) -> list[int]:
        generated = self.template.generate([ChatItem(r, c) for r, c in messages],
                                           append_generation_prompt=True)
        return self.tokenizer.encode(generated.content, add_bos=add_bos)

    def prepare_request(self, body: dict, legacy: bool = False) -> dict:
        """Parse a completions body, for either tier, into the sampling
        parameters, ``stops`` (chat adds the template's stops, the legacy
        raw-prompt endpoint only explicit ones) and the prompt:
        ``prompt_tokens`` for a raw prompt, ``messages`` for chat, which each
        tier encodes itself (the batched tier whole, the single-engine tier
        as the delta past its prefix cache)."""
        if body.get("resume") is not None:
            raise ApiError(400, "resume is not yet ported to the PyTorch/CUDA package")
        timeout_s = _parse_timeout(body)
        _validate_extras(body)
        extra_stops = body.get("stop") or []
        if isinstance(extra_stops, str):
            extra_stops = [extra_stops]
        p = dict(temperature=float(body.get("temperature", self.defaults["temperature"])),
                 topp=float(body.get("top_p", self.defaults["topp"])),
                 # `or 0.0`: OpenAI treats an explicit JSON null as "use default"
                 presence=float(body.get("presence_penalty") or 0.0),
                 frequency=float(body.get("frequency_penalty") or 0.0),
                 seed=body.get("seed", self.defaults["seed"]), timeout_s=timeout_s,
                 spec_k=_parse_spec_k(body))
        if legacy:
            p["prompt_tokens"] = self.tokenizer.encode(self._normalize_legacy_prompt(body),
                                                       add_bos=True)
            p["stops"] = list(extra_stops)
            p["max_tokens"] = int(body.get("max_tokens") or 16)  # OpenAI legacy default
        else:
            messages = [(m["role"], str(m["content"])) for m in body.get("messages", [])]
            if not messages:
                raise ApiError(400, "messages must be a non-empty array")
            p["messages"] = messages
            p["stops"] = self.stops + list(extra_stops)
            p["max_tokens"] = int(body.get("max_tokens") or body.get("max_completion_tokens")
                                  or 0)
        return p

    # -------------------------------------------------- single-engine tier

    def _serve_single(self, p: dict, emit, probe, t_submit: float):
        """One request on the single engine, under the lock -> (content,
        finish_reason, n_tokens, timings). A chat request extending the
        cached conversation prefills only the delta (``p["prompt_tokens"]``
        is set to it); a raw prompt drops the cache's claim."""
        timeout_s = p["timeout_s"]
        with self.lock:
            t_admit = time.monotonic()
            messages = p.get("messages")
            if messages is not None:
                delta, start_pos, add_bos = self.cache.resolve(messages)
                if start_pos == 0:
                    self.cache.clear()
                self.engine.reset(start_pos)
                p["prompt_tokens"] = self._encode_chat(delta, add_bos)
            else:
                self.cache.clear()  # raw-prompt rows overwrite the chat cache's claim
                self.engine.reset(0)
            budget = self.engine.seq_len - self.engine.pos - len(p["prompt_tokens"]) - 1
            if budget <= 0:
                raise ApiError(400, "context window exhausted")
            if p["max_tokens"] > 0:
                budget = min(budget, p["max_tokens"])
            seed = p["seed"]
            sampler = Sampler(p["temperature"], p["topp"],
                              seed if seed is not None else int(time.time()),
                              presence=p["presence"], frequency=p["frequency"])
            # a request's spec_k clamps to the server's --spec, as in the JAX
            # package
            spec = self.spec if p["spec_k"] is None else min(p["spec_k"], self.spec)
            content, finish, n_generated, t_first = self._run_single(
                p["prompt_tokens"], budget, sampler, p["stops"], emit, probe=probe,
                deadline=None if timeout_s is None else t_submit + timeout_s, spec=spec)
            if messages is not None and not (finish == "timeout" and n_generated == 0):
                # cache the full conversation incl. the reply for the next
                # turn (a request that expired on the lock prefilled nothing)
                self.cache.messages = messages + [("assistant", content)]
                self.cache.pos = self.engine.pos
                self.cache.bos_sent = True
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
        return content, finish, n_generated, timings

    def _run_single(self, prompt_tokens, budget, sampler, stops, emit, probe=None,
                    deadline=None, spec: int = 0) -> tuple[str, str, int, float | None]:
        """Token loop of a completion (generate + EOS/stop detection +
        held-prefix flush) -> (content, finish_reason, n_tokens,
        first_token_monotonic_or_None). The caller holds self.lock and has
        positioned the engine."""
        if deadline is not None and time.monotonic() >= deadline:
            return "", "timeout", 0, None  # expired on the lock: no engine work
        asm = TokenAssembler(self.tokenizer, stops)
        finish = "length"
        t_first = None
        probe_at = time.monotonic() + 0.25
        for t in self.engine.generate(prompt_tokens, budget, sampler, spec=spec):
            if t_first is None:
                t_first = time.monotonic()
            if probe is not None and time.monotonic() >= probe_at:
                probe_at = time.monotonic() + 0.25
                if probe():
                    raise ClientDisconnected()
            text = asm.feed(t)
            if text and emit is not None:
                emit(text)
            if asm.eos:
                finish = "stop"
                break
            if deadline is not None and time.monotonic() >= deadline:
                finish = "timeout"
                break
        if not asm.eos:
            text = asm.flush()  # budget or deadline hit mid-held-prefix
            if text and emit is not None:
                emit(text)
        return asm.content(), finish, asm.n, t_first

    # ------------------------------------------------------- batched tier

    def batched_submit(self, p: dict, req_id: str = ""):
        """Budget-clamp and submit one parsed request -> the live Request.
        Raises ApiError when the context cannot fit the prompt, and the
        SchedulerRejected family when admission sheds it."""
        if "prompt_tokens" not in p:
            p["prompt_tokens"] = self._encode_chat(p["messages"], add_bos=True)
        prompt_tokens = p["prompt_tokens"]
        budget = self.scheduler.engine.seq_len - len(prompt_tokens) - 1
        if budget <= 0:
            raise ApiError(400, "context window exhausted")
        if p["max_tokens"] > 0:
            budget = min(budget, p["max_tokens"])
        seed = p["seed"]
        return self.scheduler.submit(
            prompt_tokens, p["temperature"], p["topp"], budget, self.tokenizer.eos_ids,
            presence=p["presence"], frequency=p["frequency"],
            seed=int(seed) if seed is not None else None, req_id=req_id,
            timeout_s=p["timeout_s"])

    def finish_batched(self, req, ended_on_eos: bool, n_generated: int) -> tuple[str, dict]:
        """Release a batched request's slot and derive the client's
        (finish_reason, timings). A release after the detector saw a string
        stop sequence is a successful stop, not a cancellation."""
        self.scheduler.cancel(req, reason="stop" if ended_on_eos else "cancelled")
        finish = (req.finish_reason if req.finish_reason in ("stop", "length", "timeout")
                  else "stop")
        timings = req.timings()
        if timings["e2e_ms"] is None:
            # a stop-string release is finished by the worker later; for the
            # client the request is over now
            timings["e2e_ms"] = round((time.monotonic() - req.submitted_at) * 1000.0, 3)
        timings["decode_tokens"] = n_generated  # what the client received
        if self.replica_id:
            timings["replica"] = self.replica_id
        return finish, timings

    def _run_batched(self, p: dict, emit, probe=None,
                     req_id: str = "") -> tuple[str, str, int, dict]:
        """Submit, stream the tokens through EOS/stop detection, finish ->
        (content, finish_reason, n_tokens, timings)."""
        asm = TokenAssembler(self.tokenizer, p["stops"])
        req = self.batched_submit(p, req_id=req_id)
        probe_at = time.monotonic() + 0.25

        def probe_tick():
            # runs while the stream is quiet (queued, mid-prefill): a dead
            # client cancels even before its first token exists
            if probe():
                raise ClientDisconnected()

        try:
            for t in req.tokens(poll=probe_tick if probe is not None else None):
                if probe is not None and time.monotonic() >= probe_at:
                    probe_at = time.monotonic() + 0.25
                    if probe():
                        raise ClientDisconnected()
                text = asm.feed(t)
                if text and emit is not None:
                    emit(text)
                if asm.eos:
                    break
            if not asm.eos:
                text = asm.flush()
                if text and emit is not None:
                    emit(text)
            finish, timings = self.finish_batched(req, asm.eos, asm.n)
        except BaseException:
            # disconnect/shed/crash: the slot must still be released
            self.scheduler.cancel(req, reason="stop" if asm.eos else "cancelled")
            raise
        return asm.content(), finish, asm.n, timings

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
        except (Draining, SchedulerRejected) as e:
            status = 429 if isinstance(e, QueueFull) else 503
            self._send_json(status, {"error": {"message": str(e)}},
                            {"Retry-After": str(max(1, math.ceil(e.retry_after_s)))})
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
    """-> (server, api) on a ThreadingHTTPServer. n_slots > 0 is the
    continuous-batching tier: a BatchEngine with that many cache slots behind
    a Scheduler. n_slots == 0 keeps the single-engine tier with the
    NaiveCache prefix reuse, and ``spec`` > 0 (--spec) its speculative
    decoding of greedy requests. Batched speculation (spec with n_slots > 0)
    and the aio front end are not yet ported and raise."""
    spec = int(defaults.get("spec") or 0)
    if spec > 0 and n_slots > 0:
        raise NotImplementedError("batched speculative decoding (--spec with --slots > 0) "
                                  "is not yet ported to the PyTorch/CUDA package")
    frontend = str(defaults.get("frontend") or "threads")
    if frontend != "threads":
        raise NotImplementedError(f"--frontend {frontend} is not yet ported to the "
                                  "PyTorch/CUDA package (threads is)")
    scheduler = None
    if n_slots > 0:
        scheduler = _make_scheduler(loaded, n_slots, defaults)
    api = ApiServer(
        loaded,
        default_temperature=defaults.get("default_temperature", 0.8),
        default_topp=defaults.get("default_topp", 0.9),
        default_seed=defaults.get("default_seed"),
        replica_id=defaults.get("replica_id") or "",
        sse_heartbeat_s=defaults.get("sse_heartbeat_s") or 0.0,
        scheduler=scheduler,
        spec=spec,
    )
    handler = type("Handler", (_Handler,), {"api": api})
    httpd = ThreadingHTTPServer((host, port), handler)
    if not api.replica_id:
        ident = socket.gethostname() if host in ("0.0.0.0", "::", "") else host
        api.replica_id = f"{ident}:{httpd.server_address[1]}"
    return httpd, api


def resolve_kv_layout(loaded, kv_layout: str = "auto", page_size: int = 128) -> tuple[str, int]:
    """(layout, page size) of the batched tier. ``auto`` resolves to paged
    where the paged attention kernel takes the configuration
    (ops.paged_attention.paged_decode_supported), with the page shrunk to
    gcd(page_size, context) so short contexts stay paged; a gcd under 8 rows
    or a configuration the kernel refuses (an f8 cache among them) resolves
    to dense. An explicit layout is kept as given."""
    from dllama_tpu_torch.ops.paged_attention import paged_decode_supported

    page_size = int(page_size or 128)
    if kv_layout != "auto":
        return kv_layout, page_size
    eng = loaded.engine
    g = math.gcd(page_size, eng.seq_len)
    capable = g >= 8 and paged_decode_supported(
        (loaded.config.n_heads, loaded.config.head_size), g, eng.cache.k.dtype)
    if capable and g != page_size:
        log.info("kv-layout auto: page size %d does not divide context %d; using %d",
                 page_size, eng.seq_len, g)
    layout = "paged" if capable else "dense"
    log.info("kv-layout auto -> %s", layout)
    return layout, g if capable else page_size


def _make_scheduler(loaded, n_slots: int, defaults: dict):
    from dllama_tpu_torch.engine.batch import BatchEngine
    from dllama_tpu_torch.serve.scheduler import Scheduler

    kv_layout, page_size = resolve_kv_layout(loaded, defaults.get("kv_layout") or "auto",
                                             defaults.get("page_size") or 128)
    eng = loaded.engine
    be = BatchEngine(loaded.config, eng.params, n_slots=n_slots, cache_dtype=eng.cache.k.dtype,
                     max_seq_len=eng.seq_len, max_prefill_chunk=eng.max_prefill_chunk,
                     kernels=eng.backend, kv_layout=kv_layout, page_size=page_size,
                     kv_pages=int(defaults.get("kv_pages") or 0), device=eng.device)
    sched_kw = {}
    if defaults.get("max_queue"):
        sched_kw["max_queue"] = int(defaults["max_queue"])
    if defaults.get("overlap") is not None:
        sched_kw["overlap"] = bool(defaults["overlap"])
    return Scheduler(be, **sched_kw)


def graceful_drain(httpd, api, timeout_s: float = 30.0) -> bool:
    """Stop admission (503), let the in-flight requests finish (bounded by
    `timeout_s`; on the batched tier the scheduler drains and audits its page
    pool), stop the accept loop. True when they finished in time."""
    api.draining = True
    if api.scheduler is not None:
        clean = api.scheduler.drain(timeout_s)
    else:
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
    mode = (f"continuous batching, {n_slots} slots, {api.build_info['kv_layout']} KV"
            if n_slots else "single-request + prefix cache")
    log.info("serving on http://%s:%d (%s)", host, httpd.server_address[1], mode)
    print(f"🚀 http://{host}:{httpd.server_address[1]}/v1/chat/completions ({mode})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if api.scheduler is not None:
            api.scheduler.shutdown()
        httpd.server_close()
    return 0
