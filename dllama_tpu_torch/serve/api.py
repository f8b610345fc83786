"""OpenAI-compatible HTTP API server — the `dllama-api` binary's role
(dllama-api.cpp:509-581) — in two tiers: the single-engine tier
(``n_slots == 0``) and the continuous-batching tier (``n_slots > 0``: a
BatchEngine behind a Scheduler, concurrent requests sharing the card).

Routes: POST /v1/chat/completions and the legacy POST /v1/completions (both
stream + non-stream), GET /v1/models, GET /health (+ /health/live,
/health/ready), GET /metrics (the Prometheus text exposition of the process
registry, obs/), the read-only /debug family (GET /debug/kv, /debug/radix,
/debug/perf, /debug/compile, /debug/trace, /debug/requests[/{req_id}]) and
POST /debug/profile (a timed torch.profiler capture). Every POST mints (or
adopts from an inbound X-Request-Id) a request id returned as the
X-Request-Id header and carried by the request's log lines (``request_id``)
and trace spans. Request params override the CLI defaults as the
reference's do (dllama-api.cpp:455-484): temperature, top_p,
presence/frequency_penalty, seed, max_tokens, stop, stream.

The **prefix cache** reproduces NaiveCache (dllama-api.cpp:264-309): the
previous request's chat history is kept with its KV-cache position; when a
new request's messages extend the cached ones, only the delta is encoded and
prefilled. Requests are serialized with a lock because one engine owns the
KV cache, as the reference is single-request. On the batched tier the
scheduler's radix prefix tree over the page pool (or, on the dense layout
and with ``--radix-cache off``, its per-slot prefix cache) does the same at
the token level, for many conversations at once, and a request's
``priority`` and ``tenant`` steer its admission. The JSON and SSE bodies
are those of the JAX package's tiers; a full admission queue answers 429
with Retry-After.

**Failover surface** (the router's, serve/router.py): a body's
``include_token_ids`` makes every SSE frame carry the raw ``(position,
token_ids)`` its text consumed, which the router journals; a ``resume``
object (``tokens``, ``id``, ``created``) re-enters a journaled stream on
this replica's batched tier: the prompt and the journaled tokens re-prefill
through the scheduler's resume path with the generator at (seed, counter =
tokens emitted), and the continuation keeps the stream's id and created,
its first frame carrying ``position = len(tokens)``. A sampled resume
needs the original seed; the single-engine tier answers a resume with 400.
``/health/live`` goes false when the scheduler's worker stalls past
``stall_deadline_s`` or its restart budget (``restart_max`` within
``restart_window_s``) is spent.

Two transports serve the same routes (:class:`RequestRoutes`): the
selectors event loop of serve/aio.py (``frontend="aio"``, the default, as
in the JAX package) and the thread-per-connection ThreadingHTTPServer
(``frontend="threads"``).
"""

from __future__ import annotations

import json
import logging
import math
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
from dllama_tpu_torch.obs import compile as compile_obs
from dllama_tpu_torch.obs import instruments as ins
from dllama_tpu_torch.obs import metrics, new_request_id, trace
from dllama_tpu_torch.obs import perf as perfmod
from dllama_tpu_torch.serve.scheduler import QueueFull, SchedulerRejected
from dllama_tpu_torch.utils import locks
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


#: named priority classes the `priority` body field accepts beside the
#: integers (0 low, 1 normal, 2 high)
PRIORITY_NAMES = {"low": 0, "normal": 1, "high": 2}


def _parse_priority(body: dict) -> int:
    """Scheduling class: `priority` in the body, 0/'low', 1/'normal' (the
    default) or 2/'high'. On the batched tier a higher class admits
    strictly first and (with --preempt) may suspend a running lower-class
    request at a chunk boundary; the single-engine tier serves one request
    at a time and only validates it."""
    v = body.get("priority")
    if v is None:
        return 1
    msg = "priority must be an integer 0..2 or one of low|normal|high"
    if isinstance(v, str):
        if v not in PRIORITY_NAMES:
            raise ApiError(400, msg)
        return PRIORITY_NAMES[v]
    try:
        v = int(v)
    except (TypeError, ValueError):
        raise ApiError(400, msg) from None
    if not 0 <= v <= 2:
        raise ApiError(400, msg)
    return v


def _parse_tenant(body: dict) -> str:
    """Fair-queueing key: `tenant` in the body. Requests of one tenant share
    one weighted-fair-queue lane at admission ("" = the shared tenant;
    weights from --tenant-weight)."""
    v = body.get("tenant")
    if v is None:
        return ""
    if not isinstance(v, str) or len(v) > 64:
        raise ApiError(400, "tenant must be a string of at most 64 chars")
    return v


def _validate_extras(body: dict) -> None:
    """spec_k, priority and tenant, validated as the JAX package validates
    them, so a malformed one is a 400 before any header goes out."""
    _parse_spec_k(body)
    _parse_priority(body)
    _parse_tenant(body)


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
                 scheduler=None, spec: int = 0, slo_ttft_ms: float | None = None,
                 slo_itl_ms: float | None = None):
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
        self.lock = locks.make_lock("api.single")
        self.model_name = "dllama-tpu"
        self.draining = False
        # device-memory gauges (model_params_bytes / kv_cache_bytes) of the
        # engine that serves: the BatchEngine on the batched tier
        from dllama_tpu_torch.utils.profiling import set_memory_gauges

        eng = scheduler.engine if scheduler is not None else self.engine
        self.model_params_bytes, self.kv_cache_bytes = set_memory_gauges(eng.params, eng.cache)
        overlap = "n/a" if scheduler is None else ("on" if scheduler.overlap else "off")
        warmup = "n/a" if scheduler is None else scheduler.warmup
        self.build_info = {"version": __version__, "backend": eng.device.type,
                           "kernels": eng.backend, "attention": eng.attn_route,
                           "overlap": overlap, "warmup": warmup}
        if scheduler is not None:
            self.build_info["kv_layout"] = eng.kv_layout
        # the build-info gauge (always 1; the labels are the payload), under
        # the JAX package's label names: `jax` reads "none" on this package
        ins.BUILD_INFO.labels(version=__version__, jax="none", backend=eng.device.type,
                              overlap=overlap, warmup=warmup).set(1)
        # the SLO policy of the /debug/requests/{id} verdict: the scheduler's
        # aggregator owns it on the batched tier, the api on the single tier
        self.slo = (scheduler.perf.slo if scheduler is not None
                    else perfmod.SloPolicy(None if slo_ttft_ms is None else float(slo_ttft_ms),
                                           None if slo_itl_ms is None else float(slo_itl_ms)))

    def health(self) -> dict:
        if self.scheduler is not None:
            h = self.scheduler.health()
        else:
            h = {"live": True, "ready": True, "queue_depth": 0, "busy_slots": 0,
                 "n_slots": 0,
                 # the capture ledger rides the single tier's probe too
                 "compile": {"warmup": "n/a",
                             "compiles": compile_obs.LEDGER.total_compiles(),
                             "unexpected_compiles": compile_obs.LEDGER.total_unexpected()}}
        if self.draining:
            h["ready"] = False
            h["draining"] = True
        h["status"] = "ok" if h["live"] else "unhealthy"
        h["mode"] = "continuous" if self.scheduler is not None else "single"
        h["model_params_bytes"] = self.model_params_bytes
        h["kv_cache_bytes"] = self.kv_cache_bytes
        h["build"] = self.build_info
        # process self-metrics: uptime, RSS and threads without a scrape
        h["process"] = ins.refresh_process_gauges()
        h["clock"] = {"monotonic_s": time.monotonic(),
                      "trace_epoch_s": getattr(trace.TRACER, "epoch", None)}
        return h

    def precheck_capacity(self) -> None:
        """Raise what a submit would raise, without submitting: stream
        handlers call it before their 200/chunked headers go out."""
        if self.draining:
            ins.REQUESTS_SHED.labels(reason="draining").inc()
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
            content, finish, n_generated, timings = self._serve_single(p, emit, probe, t_submit,
                                                                       req_id)
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
        as the delta past its prefix cache). ``token_ids`` and the
        ``resume_*`` fields carry the failover surface."""
        resume = body.get("resume")
        if resume is not None and self.scheduler is None:
            raise ApiError(400, "resume requires the batched scheduler tier")
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
                 spec_k=_parse_spec_k(body), priority=_parse_priority(body),
                 tenant=_parse_tenant(body))
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
        p["token_ids"] = bool(body.get("include_token_ids"))
        p["resume_tokens"] = p["resume_id"] = p["resume_created"] = None
        if resume is not None:
            if not isinstance(resume, dict):
                raise ApiError(400, "resume must be an object")
            # empty tokens are legal: a stream that died after its role delta
            # but before any token resumes to keep its id and created
            toks = resume.get("tokens")
            if not isinstance(toks, list) or not all(isinstance(t, int) for t in toks):
                raise ApiError(400, "resume.tokens must be an int array")
            if p["temperature"] > 0.0 and p["seed"] is None:
                # an unseeded sampled stream cannot be replayed (the router
                # pins a seed at its first proxy to keep its journal resumable)
                raise ApiError(400, "sampled resume requires the original seed")
            p["resume_tokens"] = [int(t) for t in toks]
            p["resume_id"] = str(resume.get("id") or "")
            p["resume_created"] = int(resume.get("created") or 0)
        return p

    # -------------------------------------------------- single-engine tier

    def _serve_single(self, p: dict, emit, probe, t_submit: float, req_id: str = ""):
        """One request on the single engine, under the lock -> (content,
        finish_reason, n_tokens, timings). A chat request extending the
        cached conversation prefills only the delta (``p["prompt_tokens"]``
        is set to it); a raw prompt drops the cache's claim. The flight
        recorder gets the request's marks (the lock wait plays the queue)."""
        timeout_s = p["timeout_s"]
        tr = trace.TRACER
        if tr.enabled and req_id:
            tr.req_submit(req_id, t=t_submit)
        start_pos = 0
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
        if tr.enabled and req_id:
            tr.req_admitted(req_id, t=t_admit)
            tr.req_mark(req_id, prompt_tokens=len(p["prompt_tokens"]), reused_tokens=start_pos)
            if t_first is not None:
                tr.req_first_token(req_id, t=t_first)
            if finish == "timeout":
                tr.event("request.timeout", cat="deadline", track="requests", req_id=req_id,
                         where="queued" if n_generated == 0 else "decoding")
            tr.req_end(req_id, finish, t=t_done, **timings)
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
            timeout_s=p["timeout_s"], priority=p["priority"], tenant=p["tenant"],
            # None takes the server's --spec-k (the engine's K); clamped to it
            spec_k=p["spec_k"],
            # a failover resume: the journaled tokens to re-prefill first
            resume_tokens=p.get("resume_tokens"))

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
        (content, finish_reason, n_tokens, timings). With ``token_ids`` each
        emit also gets the frame's ``ids=(position, token_ids)``."""
        asm = TokenAssembler(self.tokenizer, p["stops"])
        want_ids = bool(p.get("token_ids"))
        resume = p.get("resume_tokens")
        if resume:
            # failover re-entry: replay the journaled tokens through the
            # fresh assembler (emitting nothing: those deltas reached the
            # client already), so the stop detector and the position counter
            # continue where the dead replica stopped
            if replay_resume(asm, resume):
                # the journaled tokens already complete a stop sequence
                timings: dict = {"e2e_ms": 0.0, "decode_tokens": 0}
                if self.replica_id:
                    timings["replica"] = self.replica_id
                return asm.content(), "stop", asm.n, timings

        def out(text: str) -> None:
            if text and emit is not None:
                if want_ids:
                    emit(text, ids=asm.take_ids())
                else:
                    emit(text)

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
                out(asm.feed(t))
                if asm.eos:
                    break
            if not asm.eos:
                out(asm.flush())
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


#: path -> bounded-cardinality endpoint label for the HTTP response counter
_KNOWN_PATHS = {
    "/v1/chat/completions": "/v1/chat/completions",
    "/chat/completions": "/v1/chat/completions",
    "/v1/completions": "/v1/completions",
    "/completions": "/v1/completions",
    "/v1/models": "/v1/models",
    "/health": "/health",
    "/health/live": "/health/live",
    "/health/ready": "/health/ready",
    "/metrics": "/metrics",
    "/debug/trace": "/debug/trace",
    "/debug/requests": "/debug/requests",
    "/debug/profile": "/debug/profile",
    "/debug/kv": "/debug/kv",
    "/debug/perf": "/debug/perf",
    "/debug/radix": "/debug/radix",
    "/debug/compile": "/debug/compile",
}


def replay_resume(asm: TokenAssembler, tokens) -> bool:
    """Feed a failover resume's journaled tokens through a fresh assembler
    without emitting, and drain its ids (the continuation's first frame then
    carries position = len(tokens)). True when they already complete a stop
    sequence: the stream is over, with no engine work left."""
    for t in tokens:
        asm.feed(t)
        if asm.eos:
            break
    asm.take_ids()
    return asm.eos


def _endpoint(path: str) -> str:
    """Label-safe endpoint name: unknown paths collapse to 'other' and
    per-request flight-recorder lookups collapse their id, so a scanner
    cannot explode the label cardinality."""
    if path.startswith("/debug/requests/"):
        return "/debug/requests/{req_id}"
    return _KNOWN_PATHS.get(path, "other")


#: SSE comment frame: the keep-alive heartbeat idle streams emit
SSE_HEARTBEAT = b": keep-alive\n\n"


def sse_chat_payload(cid: str, created: int, model: str, delta: dict, finish=None,
                     timings=None, ids=None) -> bytes:
    """One `chat.completion.chunk` SSE data frame. ``ids`` (include_token_ids
    requests) is TokenAssembler.take_ids()'s ``(position, token_ids)``: the
    raw ids this frame's text consumed and their stream offset, which the
    router journals for a mid-stream failover."""
    data = {
        "id": cid,
        "object": "chat.completion.chunk",
        "created": created,
        "model": model,
        "choices": [{"index": 0, "delta": delta, "finish_reason": finish}],
    }
    if ids is not None:
        data["position"], data["token_ids"] = ids[0], list(ids[1])
    if timings is not None:
        data["timings"] = timings
    return b"data: " + json.dumps(data).encode() + b"\n\n"


def sse_text_payload(cid: str, created: int, model: str, text: str, finish=None,
                     timings=None, ids=None) -> bytes:
    """One legacy `text_completion` SSE data frame (see sse_chat_payload)."""
    data = {
        "id": cid,
        "object": "text_completion",
        "created": created,
        "model": model,
        "choices": [{"index": 0, "text": text, "finish_reason": finish}],
    }
    if ids is not None:
        data["position"], data["token_ids"] = ids[0], list(ids[1])
    if timings is not None:
        data["timings"] = timings
    return b"data: " + json.dumps(data).encode() + b"\n\n"


class RequestRoutes:
    """The HTTP routes, written against a transport seam so the
    thread-per-connection tier (:class:`_Handler`) and the event-loop tier
    (serve/aio.py) serve the same semantics from one definition site.
    Subclasses provide ``_send_raw(status, headers, body)``, ``_start_sse()``,
    ``_write_chunk(payload)`` (b"" ends the stream), ``_read_body()``,
    ``_drain_body()`` and ``_client_gone()``, plus ``path``/``headers`` of
    the current request."""

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
        elif self.path == "/metrics":
            self._metrics()
        elif self.path.startswith("/debug/"):
            # read-side observability: no request id, no admission counter
            self._drain_body()
            self._debug_get()
        elif self.path in ("/health", "/health/live", "/health/ready"):
            h = self.api.health()
            key = "ready" if self.path.endswith("/ready") else "live"
            self._send_json(200 if h[key] else 503, h)
        else:
            self._send_json(404, {"error": {"message": "not found"}})

    def _metrics(self) -> None:
        """GET /metrics: refresh the scrape-time gauges (process, device
        memory, the time ledger's open span, the aggregator's windows), then
        render the registry. A render failure is a 500 and a log line, never
        an empty 200."""
        try:
            ins.refresh_process_gauges()
            compile_obs.refresh_device_gauges()
            sched = self.api.scheduler
            if sched is not None:
                sched.ledger.poke()
                sched.perf.refresh_gauges()
            body = metrics.REGISTRY.render().encode()
        except Exception:
            log.exception("/metrics render failed")
            self._send_json(500, {"error": {"message": "metrics render failed"}})
            return
        self._send_raw(200, [("Content-Type", "text/plain; version=0.0.4; charset=utf-8"),
                             ("Content-Length", str(len(body)))], body)

    def _debug_kv(self) -> None:
        """GET /debug/kv: page-pool occupancy and an audit run on demand
        (refcounts against the block tables and the tree, free-list
        disjointness); 500 when the audit finds corruption."""
        sched = self.api.scheduler
        pool = sched.engine.pool if sched is not None else None
        if pool is None:
            self._send_json(200, {"layout": "dense", "pool": None, "audit": None})
            return
        report = pool.audit(raise_on_fail=False)
        self._send_json(200 if report["ok"] else 500,
                        {"layout": "paged", "page_size": pool.page_size, "pool": pool.stats(),
                         "audit": report, "radix": sched.engine.radix_stats()})

    def _debug_radix(self) -> None:
        """GET /debug/radix: the prefix tree's hit accounting and a bounded
        dump of the live tree; enabled=false with the tree off."""
        sched = self.api.scheduler
        radix = sched.engine.radix if sched is not None else None
        if radix is None:
            self._send_json(200, {"enabled": False, "stats": None, "tree": None})
            return
        self._send_json(200, {"enabled": True, "page_size": radix.page, "stats": radix.stats(),
                              "tree": radix.dump()})

    def _debug_perf(self) -> None:
        """GET /debug/perf: windowed TTFT/ITL/e2e quantiles, SLO accounting,
        the time ledger, the roofline (bandwidth attainment against the
        card's peak) and the process self-metrics in one document."""
        sched = self.api.scheduler
        payload: dict = {"process": ins.refresh_process_gauges()}
        if sched is None:
            payload.update({"mode": "single",
                            "slo": {"targets": {"ttft_ms": self.api.slo.ttft_ms,
                                                "itl_ms": self.api.slo.itl_ms},
                                    "enabled": self.api.slo.enabled()}})
        else:
            sched.ledger.poke()  # a long idle park reads as idle seconds now
            sched.perf.refresh_gauges()  # /metrics and this document agree
            payload["mode"] = "continuous"
            payload.update(sched.perf.snapshot(ledger=sched.ledger))
            payload["radix"] = sched.engine.radix_stats()
            # speculation's acceptance record (None with --spec-k 0)
            payload["spec"] = sched.engine.spec_stats()
            payload["hybrid"] = {"prefill_budget": sched._budget_now,
                                 "preemptions": sched.preempt_count,
                                 "resumed": sched.resume_count}
        payload["compile"] = compile_obs.LEDGER.summary()
        self._send_json(200, payload)

    def _debug_compile(self) -> None:
        """GET /debug/compile: the capture ledger (per-fn totals, recent
        captures), the shape contract's coverage, the boot warm-up report,
        host/device transfer tallies and live device memory."""
        sched = self.api.scheduler
        self._send_json(200, compile_obs.debug_payload(
            warmup_report=sched.warmup_report if sched is not None else None))

    def _debug_get(self) -> None:
        if self.path == "/debug/kv":
            self._debug_kv()
            return
        if self.path == "/debug/perf":
            self._debug_perf()
            return
        if self.path == "/debug/radix":
            self._debug_radix()
            return
        if self.path == "/debug/compile":
            self._debug_compile()
            return
        tr = trace.TRACER
        if not tr.enabled:
            self._send_json(404, {"error": {
                "message": "tracing is disabled; restart with --trace-buffer N > 0"}})
            return
        if self.path == "/debug/trace":
            self._send_json(200, tr.export_chrome())
        elif self.path == "/debug/requests":
            self._send_json(200, {"requests": tr.requests_summary()})
        elif self.path.startswith("/debug/requests/"):
            rid = self.path[len("/debug/requests/"):]
            rec = tr.request_timeline(rid)
            if rec is None:
                self._send_json(404, {"error": {
                    "message": f"no flight-recorder entry for {rid!r} "
                               "(never seen, or evicted from the ring)"}})
            else:
                # the postmortem SLO verdict from the record's own marks
                rec["slo"] = self.api.slo.verdict_from_marks(
                    rec.get("ttft_ms"), rec.get("e2e_ms"), rec.get("decode_tokens"))
                self._send_json(200, rec)
        else:
            self._send_json(404, {"error": {"message": "not found"}})

    def _log_done(self, rid: str, result: dict) -> None:
        u = result.get("usage", {})
        log.info("completion %s done: %d prompt + %d completion tokens", rid,
                 u.get("prompt_tokens", 0), u.get("completion_tokens", 0),
                 extra=trace.log_extra(rid))

    def do_POST(self):
        rid = self._req_id = new_request_id(self.headers.get("X-Request-Id"))
        chat = self.path in ("/v1/chat/completions", "/chat/completions")
        legacy = self.path in ("/v1/completions", "/completions")
        # a router hop header joins this request's record to the mesh trace;
        # marked before admission, so even a shed request correlates
        hopctx = trace.parse_hop(self.headers.get(trace.HOP_HEADER))
        if hopctx is not None and (chat or legacy):
            trace.TRACER.req_mark(rid, trace_id=hopctx[0], parent_span=hopctx[1],
                                  hop=hopctx[2])
        # consume the body before any early answer: on a keep-alive
        # connection unread bytes would be parsed as the next request line
        try:
            raw = self._read_body()
        except (ValueError, OSError):
            self._send_json(400, {"error": {"message": "invalid request"}})
            return
        if self.path == "/debug/profile":
            # not a serving request: no request id, no admission counters
            self._req_id = None
            self._handle_profile(raw)
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
                self._log_done(rid, result)
                self._send_json(200, result)
            else:
                result = self.api.complete(body, probe=self._client_gone, req_id=rid)
                result["request_id"] = rid
                self._log_done(rid, result)
                self._send_json(200, result)
        except ApiError as e:
            log.info("request %s rejected: %s", rid, e.message, extra=trace.log_extra(rid))
            self._send_json(e.status, {"error": {"message": e.message}})
        except (Draining, SchedulerRejected) as e:
            status = 429 if isinstance(e, QueueFull) else 503
            log.warning("request %s shed (%s): %s", rid, e.__class__.__name__, e,
                        extra=trace.log_extra(rid))
            self._send_json(status, {"error": {"message": str(e)}},
                            {"Retry-After": str(max(1, math.ceil(e.retry_after_s)))})
        except ClientDisconnected:
            log.info("client disconnected; request %s cancelled", rid,
                     extra=trace.log_extra(rid))
        except CLIENT_GONE:
            log.info("client connection lost mid-response (request %s)", rid,
                     extra=trace.log_extra(rid))
        except Exception:
            log.exception("completion %s failed", rid, extra=trace.log_extra(rid))
            try:
                self._send_json(500, {"error": {"message": "internal error"}})
            except CLIENT_GONE:
                pass

    def _handle_profile(self, raw: bytes) -> None:
        """POST /debug/profile: a duration-capped torch.profiler capture
        (utils/profiling.start_profile, the profiler the CLI's --trace
        uses), exported as a Chrome trace into its directory. Body:
        {"duration_s": float, "dir": str}, both optional. 409 while a
        capture runs; 503 when the card's activity cannot be recorded."""
        from dllama_tpu_torch.utils import profiling

        try:
            body = json.loads(raw or b"{}")
            if not isinstance(body, dict):
                raise ValueError
        except (ValueError, json.JSONDecodeError):
            self._send_json(400, {"error": {"message": "invalid JSON body"}})
            return
        try:
            info = profiling.start_profile(log_dir=body.get("dir"),
                                           duration_s=body.get("duration_s", 2.0))
        except profiling.ProfileBusy as e:
            self._send_json(409, {"error": {"message": str(e)}}, {"Retry-After": "2"})
            return
        except profiling.ProfileUnavailable as e:
            self._send_json(503, {"error": {"message": str(e)}})
            return
        except (TypeError, ValueError) as e:
            self._send_json(400, {"error": {"message": f"bad profile request: {e}"}})
            return
        log.info("profile capture started: %.2fs -> %s", info["duration_s"], info["trace"])
        self._send_json(200, {"profiling": info})

    def _stream(self, body: dict, legacy: bool = False) -> None:
        """SSE chunked streaming (dllama-api.cpp:203-223's role). Blocking:
        the threads tier runs every stream through it; the aio tier runs
        only the single-engine tier's streams here (its batched streams go
        to the SSE pump)."""
        rid = self._req_id
        self._start_sse()
        # a failover resume keeps the dead replica's stream identity: the
        # client already saw this id and created on the journaled frames
        resume = body.get("resume") if isinstance(body.get("resume"), dict) else None
        cid = ((resume.get("id") if resume else None)
               or f"{'cmpl' if legacy else 'chatcmpl'}-{uuid.uuid4().hex[:16]}")
        created = int((resume.get("created") if resume else 0) or time.time())
        model = body.get("model", self.api.model_name)
        chunk = self._write_chunk
        last_write = [time.monotonic()]
        hb = self.api.sse_heartbeat_s

        def emit_chat(delta: dict, finish=None, timings=None, ids=None) -> None:
            chunk(sse_chat_payload(cid, created, model, delta, finish=finish, timings=timings,
                                   ids=ids))
            last_write[0] = time.monotonic()

        def emit_text(text: str, finish=None, timings=None, ids=None) -> None:
            chunk(sse_text_payload(cid, created, model, text, finish=finish, timings=timings,
                                   ids=ids))
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
                if resume is None:
                    # a resumed stream's client got the role delta already
                    emit_chat({"role": "assistant"})
                result = self.api.complete(
                    body, emit=lambda text, ids=None: emit_chat({"content": text}, ids=ids),
                    probe=probe, req_id=rid)
                emit_chat({}, finish=result["choices"][0]["finish_reason"],
                          timings=result.get("timings"))
            self._log_done(rid or "-", result)
        except (ClientDisconnected, *CLIENT_GONE):
            raise
        except Exception as e:
            # the headers are out: report in-band and end the stream cleanly
            log.exception("streamed completion %s failed mid-stream", rid,
                          extra=trace.log_extra(rid))
            msg = str(e) if isinstance(e, (ApiError, SchedulerRejected)) else "internal error"
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
        # counted before the body write: once a client has read the
        # response, the counter has moved
        ins.HTTP_RESPONSES.labels(endpoint=_endpoint(self.path), code=str(status)).inc()
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
        ins.HTTP_RESPONSES.labels(endpoint=_endpoint(self.path), code="200").inc()

    def _write_chunk(self, payload: bytes) -> None:
        self.wfile.write(f"{len(payload):x}\r\n".encode() + payload + b"\r\n")
        self.wfile.flush()

    def _read_body(self) -> bytes:
        return self.rfile.read(int(self.headers.get("Content-Length", 0)))

    def _drain_body(self) -> None:
        """Read and discard a GET's body (legal, if unusual): unread bytes
        would be parsed as the next request line on this keep-alive
        connection."""
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            length = 0
        if length > 0:
            try:
                self.rfile.read(length)
            except OSError:
                pass

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
    """-> (server, api). n_slots > 0 is the continuous-batching tier: a
    BatchEngine with that many cache slots behind a Scheduler, with the radix
    prefix tree on the paged layout (``radix_cache``, auto = on where paged),
    the host-RAM spill tier (``kv_host_pages``), preemption (``preempt``,
    auto = on) and tenant weights (``tenant_weights``), the JAX package's
    defaults. n_slots == 0 keeps the single-engine tier with the NaiveCache
    prefix reuse. ``spec`` > 0 (--spec-k, or --spec) is prompt-lookup
    speculative decoding: on the batched tier the engine's draft length K,
    each request's own ``spec_k`` clamped to it; on the single-engine tier
    the draft length of greedy requests. ``frontend`` picks the transport: 'aio' (the default,
    serve/aio.py's event loop; ``aio_workers`` sizes its pool) or 'threads'
    (ThreadingHTTPServer); both answer the same routes and expose
    serve_forever/shutdown/server_close/server_address. A bind or start
    failure of either raises. ``slo_ttft_ms``/``slo_itl_ms`` are the SLO
    targets the perf aggregator judges requests by. Supervision (batched
    tier): ``stall_deadline_s`` (the watchdog), ``restart_max`` within
    ``restart_window_s`` (warm restarts) and ``transfer_guard`` (off, log,
    strict: the steady-state replays under torch's sync debug mode)."""
    spec = int(defaults.get("spec") or 0)
    frontend = str(defaults.get("frontend") or "aio")
    if frontend not in ("aio", "threads"):
        raise ValueError(f"unknown frontend {frontend!r} (aio|threads)")
    if n_slots <= 0 and defaults.get("warmup") not in (None, "off"):
        log.warning("--warmup needs --slots > 0; the single-engine tier has no "
                    "BatchEngine shape contract to precompile — ignored")
    if n_slots <= 0 and defaults.get("transfer_guard") not in (None, "off"):
        log.warning("--transfer-guard needs --slots > 0; the single-engine tier has no "
                    "steady-state decode window to guard — ignored")
    if n_slots <= 0 and any(defaults.get(k) for k in ("max_queue", "stall_deadline_s")):
        log.warning("--max-queue / --stall-deadline-s need --slots > 0; the single-engine "
                    "tier has no admission queue or worker thread to watch — ignored")
    if n_slots <= 0 and defaults.get("restart_max"):
        log.warning("--restart-max needs --slots > 0; the single-engine tier has no "
                    "scheduler worker to warm-restart — ignored")
    if n_slots <= 0 and defaults.get("radix_cache") == "on":
        log.warning("--radix-cache on needs --slots > 0; the single-engine tier's "
                    "NaiveCache has no page pool to share — ignored")
    if n_slots <= 0 and defaults.get("kv_host_pages"):
        log.warning("--kv-host-pages needs --slots > 0; the single-engine tier has no "
                    "page pool to spill from — ignored")
    if n_slots <= 0 and (defaults.get("prefill_budget") not in (None, "auto")
                         or defaults.get("preempt") not in (None, "auto")
                         or defaults.get("tenant_weights")
                         or any(defaults.get(k) is not None
                                for k in ("admit_stall_budget_ms", "admit_ttft_deadline_ms"))):
        log.warning("--prefill-budget / --admit-budget-ms / --admit-ttft-deadline-ms / "
                    "--preempt / --tenant-weight need --slots > 0; the single-engine tier "
                    "serves one request at a time and has no admission scheduler — ignored "
                    "(priority/tenant body fields are validated only)")
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
        slo_ttft_ms=defaults.get("slo_ttft_ms"),
        slo_itl_ms=defaults.get("slo_itl_ms"),
    )
    if frontend == "aio":
        from dllama_tpu_torch.serve.aio import AioHttpServer

        httpd = AioHttpServer((host, port), api,
                              workers=int(defaults.get("aio_workers") or 0) or None)
    else:
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
    if getattr(loaded, "world", None) is not None:
        # a mesh serves dense (the page pool has no slot axis to shard), as
        # in the JAX package; an explicit paged layout raises in BatchEngine
        log.info("kv-layout auto -> dense (a mesh)")
        return "dense", page_size
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
    # an explicit --radix-cache on (or --kv-host-pages) against a layout that
    # cannot carry it warns and serves without it, as the JAX package's
    # make_server does; BatchEngine raises only on a direct library misuse
    radix_cache = str(defaults.get("radix_cache") or "auto")
    if radix_cache == "on" and kv_layout == "dense":
        log.warning("--radix-cache on requires the paged KV layout; this engine resolved "
                    "dense — the per-slot prefix cache serves instead")
        radix_cache = "off"
    kv_host_pages = int(defaults.get("kv_host_pages") or 0)
    if kv_host_pages > 0 and (kv_layout != "paged" or radix_cache == "off"):
        log.warning("--kv-host-pages requires the paged KV layout with the radix cache on; "
                    "this engine resolved %s/radix=%s — the host spill tier stays off",
                    kv_layout, radix_cache)
        kv_host_pages = 0
    kw = dict(n_slots=n_slots, cache_dtype=eng.cache.k.dtype,
              max_seq_len=eng.seq_len, max_prefill_chunk=eng.max_prefill_chunk,
              kernels=eng.backend, kv_layout=kv_layout, page_size=page_size,
              kv_pages=int(defaults.get("kv_pages") or 0),
              radix_cache=radix_cache, kv_host_pages=kv_host_pages,
              spec=int(defaults.get("spec") or 0), moe_impl=eng.moe_impl,
              # --transfer-guard: the steady-state replays under
              # torch.cuda.set_sync_debug_mode
              transfer_guard=str(defaults.get("transfer_guard") or "off"))
    world = getattr(loaded, "world", None)
    if world is not None:
        # every rank builds its BatchEngine over its resident shards; rank
        # 0's drives the others (parallel/multihost)
        be = world.make("batch", sync=loaded.sync, **kw)
    else:
        be = BatchEngine(loaded.config, eng.params, device=eng.device, **kw)
    sched_kw = {}
    if defaults.get("max_queue"):
        sched_kw["max_queue"] = int(defaults["max_queue"])
    if defaults.get("overlap") is not None:
        sched_kw["overlap"] = bool(defaults["overlap"])
    if defaults.get("warmup"):
        sched_kw["warmup"] = str(defaults["warmup"])
    # supervision: the stall watchdog (--stall-deadline-s) and warm restarts
    # (--restart-max within --restart-window-s; 0 keeps a crash fatal)
    if defaults.get("stall_deadline_s"):
        sched_kw["stall_deadline_s"] = float(defaults["stall_deadline_s"])
    if defaults.get("restart_max"):
        sched_kw["restart_max"] = int(defaults["restart_max"])
    if defaults.get("restart_window_s") is not None:
        sched_kw["restart_window_s"] = float(defaults["restart_window_s"])
    for key in ("prefill_budget", "admit_stall_budget_ms", "admit_ttft_deadline_ms",
                "slo_itl_ms", "slo_ttft_ms", "preempt", "tenant_weights"):
        if defaults.get(key) is not None:
            sched_kw[key] = defaults[key]
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
    log.info("serving on http://%s:%d (%s); telemetry at /metrics, probes at /health/live "
             "and /health/ready", host, httpd.server_address[1], mode)
    report = api.scheduler.warmup_report if api.scheduler is not None else None
    if report is not None:
        print(f"warmup: {json.dumps(report)}", flush=True)
    print(f"🚀 http://{host}:{httpd.server_address[1]}/v1/chat/completions ({mode})",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if api.scheduler is not None:
            api.scheduler.shutdown()
        httpd.server_close()
    return 0
