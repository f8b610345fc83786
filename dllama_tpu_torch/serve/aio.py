"""Selectors-based async serving front end, ``--frontend aio`` (the
default): the port of the JAX package's ``serve/aio.py`` over the port's
routes and scheduler.

The thread-per-connection tier (serve/api.ThreadingHTTPServer) spends one
blocked OS thread per live connection: a thousand long-lived SSE streams is
a thousand parked threads. This front-end multiplexes EVERY connection's
I/O — accept, request parse, response/SSE writes, and disconnect detection
— on ONE selectors event loop thread, with a SMALL FIXED worker pool for
request handling and ONE pump thread that cooperatively advances every
live SSE stream. Thread count is a constant of the configuration, never of
the connection count (`dllama_process_threads` is the proof gauge).

Division of labor:

* **event loop** (`serve_forever`, the calling thread): non-blocking
  accept; per-connection read buffering and HTTP/1.1 request parsing
  (request line + headers via the stdlib parser, Content-Length bodies);
  outbound buffer flushing with write-readiness backpressure; keep-alive /
  pipelining; and the disconnect signal — a readable socket returning EOF
  marks the connection dead, which is how queued or mid-stream requests
  get cancelled WITHOUT any per-stream polling thread.
* **worker pool** (ThreadPoolExecutor, fixed size): runs the shared
  :class:`~dllama_tpu_torch.serve.api.RequestRoutes` endpoints — the SAME route
  code the threads tier runs, over this module's transport primitives, so
  the two front-ends cannot drift. Non-streaming completions block their
  worker (bounded by the pool, queued beyond it); batched-tier SSE streams
  only SUBMIT here, then detach to the pump. A two-thread control pool
  answers ``/health`` and ``/metrics`` even while every worker is parked.
* **SSE pump** (one thread): drives every live stream through the
  scheduler's non-blocking :meth:`Request.poll_tokens` seam — drain what's
  available, assemble deltas (tokenizer.chat.TokenAssembler — the same
  EOS/stop machinery as the blocking tier), enqueue chunked frames, emit
  `: keep-alive` heartbeats on idle streams, and finalize through
  api.finish_batched. One thread, any number of streams.

The single-engine tier (no scheduler) has no token queue to poll; its
streams run the blocking ``_stream`` on a pool worker — the global engine
lock serializes them anyway, so concurrency there is 1 by construction.

Lifecycle mirrors ThreadingHTTPServer: ``serve_forever()`` blocks until
``shutdown()``; ``server_close()`` releases the listener. SIGTERM drain
(api.graceful_drain) works unchanged: admission stops first, in-flight
requests finish, then shutdown() stops the loop after a bounded flush.
"""

from __future__ import annotations

import collections
import email.utils
import http
import io
import json
import logging
import os
import selectors
import socket
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from http.client import parse_headers

from dllama_tpu_torch.obs import instruments as ins
from dllama_tpu_torch.obs import trace
from dllama_tpu_torch.serve import api as api_mod
from dllama_tpu_torch.tokenizer.chat import TokenAssembler
from dllama_tpu_torch.utils import locks

log = logging.getLogger("dllama_tpu_torch.serve.aio")

#: request-head cap (status line + headers) before a 431 close — the same
#: order of magnitude as http.server's 64 KiB line limit
MAX_HEADER_BYTES = 65536
#: body cap: completions bodies are small; anything past this is abuse
MAX_BODY_BYTES = 64 * 1024 * 1024
#: outbound-buffer cap per connection: a client that stops READING while
#: its socket stays open gives no EOF signal, so unsent response bytes
#: would otherwise accumulate without bound (the threads tier gets natural
#: backpressure from its blocking writes) — past this the peer is treated
#: as gone
MAX_OUT_BYTES = 32 * 1024 * 1024
#: idle sleep of the pump when at least one stream is live but none
#: progressed — bounds added inter-token latency at well under a decode
#: chunk on any real model
PUMP_IDLE_S = 0.005


class _Conn:
    """One client connection's loop-side state. The deque is the outbound
    byte queue (worker/pump threads append, the loop pops — both ends are
    GIL-atomic, no lock on the hot path)."""

    __slots__ = ("sock", "addr", "inbuf", "out", "obytes", "busy", "dead",
                 "closing", "wmask", "continued")

    def __init__(self, sock, addr):
        self.sock = sock
        self.addr = addr
        self.inbuf = bytearray()
        self.out: collections.deque = collections.deque()
        self.obytes = 0  # unsent bytes queued in `out` (loop + enqueue)
        self.busy = False  # a request is being handled (worker or pump owns it)
        self.dead = False  # peer EOF/reset observed by the loop
        self.closing = False  # close after the current response flushes
        self.wmask = False  # registered for write-readiness
        self.continued = False  # interim 100 Continue sent for this request


class _SseMachine:
    """One live batched-tier SSE stream, advanced cooperatively by the pump.

    Construction runs on a pool worker and does everything that may REJECT
    — body parse (ApiError -> clean 400) and scheduler submit (QueueFull /
    draining -> clean 429/503) — BEFORE the 200/chunked headers go out,
    then emits the headers (+ the initial role delta for chat) and hands
    the stream to the pump. ``pump()`` is non-blocking and returns whether
    it made progress."""

    def __init__(self, ctx, body: dict, legacy: bool):
        api = ctx.api
        self.ctx = ctx
        self.conn = ctx.conn
        self.api = api
        self.legacy = legacy
        self.rid = ctx._req_id
        self.model = body.get("model", api.model_name)
        p = api.prepare_request(body, legacy=legacy)
        self.asm = TokenAssembler(api.tokenizer, p["stops"])
        # failover resume: the journaled tokens replay through the fresh
        # assembler (no emission: those deltas reached the client already),
        # so the detector and the position counter continue where the dead
        # replica stopped, and the stream keeps its identity (the blocking
        # tier's _run_batched does the same)
        self.want_ids = bool(p.get("token_ids"))
        resume = p.get("resume_tokens")
        self.resumed_done = bool(resume) and api_mod.replay_resume(self.asm, resume)
        # a resume whose tokens already complete a stop sequence submits
        # nothing: pump() emits the finish frame at once
        self.req = None if self.resumed_done else api.batched_submit(p, req_id=self.rid or "")
        self.cid = ((p.get("resume_id") or None) if resume else None) or (
            f"{'cmpl' if legacy else 'chatcmpl'}-{uuid.uuid4().hex[:16]}")
        self.created = int((p.get("resume_created") or 0) if resume else 0) or int(time.time())
        self.hb = api.sse_heartbeat_s
        self.done = False
        ctx._start_sse()
        if not legacy and not resume:
            # a resumed stream's client got the role delta already
            self._emit({"role": "assistant"})
        self.last_write = time.monotonic()

    # ------------------------------------------------------------- emission

    def _emit(self, delta_or_text, finish=None, timings=None, ids=None) -> None:
        if self.legacy:
            payload = api_mod.sse_text_payload(
                self.cid, self.created, self.model, delta_or_text,
                finish=finish, timings=timings, ids=ids)
        else:
            payload = api_mod.sse_chat_payload(
                self.cid, self.created, self.model, delta_or_text,
                finish=finish, timings=timings, ids=ids)
        self.ctx._write_chunk(payload)
        self.last_write = time.monotonic()

    def _emit_text(self, text: str) -> None:
        self._emit(text if self.legacy else {"content": text},
                   ids=self.asm.take_ids() if self.want_ids else None)

    def _terminate(self) -> None:
        self.ctx._write_chunk(b"data: [DONE]\n\n")
        self.ctx._write_chunk(b"")  # terminating zero-length chunk
        self._complete()

    def _complete(self) -> None:
        self.done = True
        self.ctx.server._request_done(self.conn)

    # ------------------------------------------------------------- stepping

    def pump(self) -> bool:
        """Advance the stream without blocking -> True when bytes moved or
        the stream reached a terminal state."""
        if self.done:
            return False
        if self.conn.dead:
            # the event loop saw EOF/reset on the socket: cancel the
            # scheduler request so its slot (and KV pages) free NOW —
            # no polling thread involved, the loop's readable/EOF signal
            # IS the probe
            log.info("client disconnected; request %s cancelled", self.rid,
                     extra=trace.log_extra(self.rid))
            if self.req is not None:
                self.api.scheduler.cancel(self.req, reason="cancelled")
            self._complete()
            return True
        if self.resumed_done:
            # the journaled tokens already completed the stream: the finish
            # frame, and nothing was submitted
            timings: dict = {"e2e_ms": 0.0, "decode_tokens": 0}
            if self.api.replica_id:
                timings["replica"] = self.api.replica_id
            self._emit("" if self.legacy else {}, finish="stop", timings=timings)
            self._terminate()
            return True
        try:
            toks, ended = self.req.poll_tokens()
        except Exception as e:
            # terminal queue exception (worker crash / shutdown / shed after
            # admission): same in-band SSE error shape as the blocking
            # tier's mid-stream failure path, then a clean stream end
            self.api.scheduler.cancel(self.req, reason="cancelled")
            log.exception("streamed completion %s failed mid-stream",
                          self.rid, extra=trace.log_extra(self.rid))
            from dllama_tpu_torch.serve.scheduler import SchedulerRejected

            msg = (str(e) if isinstance(e, (api_mod.ApiError,
                                            SchedulerRejected))
                   else "internal error")
            err = {"message": msg or e.__class__.__name__,
                   "type": "server_error"}
            if self.rid:
                err["request_id"] = self.rid
            self.ctx._write_chunk(
                b"data: " + json.dumps({"error": err}).encode() + b"\n\n")
            self._terminate()
            return True
        for t in toks:
            text = self.asm.feed(t)
            if text:
                self._emit_text(text)
            if self.asm.eos:
                # stop-string hit: overrun tokens already queued are
                # discarded, exactly like the blocking tier's loop break
                ended = True
                break
        if ended:
            if not self.asm.eos:
                tail = self.asm.flush()
                if tail:
                    self._emit_text(tail)
            finish, timings = self.api.finish_batched(
                self.req, self.asm.eos, self.asm.n)
            self._emit("" if self.legacy else {},
                       finish=finish, timings=timings)
            log.info("completion %s done: %d completion tokens",
                     self.rid, self.asm.n, extra=trace.log_extra(self.rid))
            self._terminate()
            return True
        if toks:
            return True
        if self.hb and time.monotonic() - self.last_write >= self.hb:
            # idle stream: SSE comment frame so LB/router idle timeouts
            # can't kill a slow decode (heartbeats don't count as progress
            # — the pump may still sleep)
            self.ctx._write_chunk(api_mod.SSE_HEARTBEAT)
            self.last_write = time.monotonic()
        return False


class _Pump(threading.Thread):
    """The one thread advancing every live SSE stream."""

    def __init__(self, server):
        super().__init__(name="dllama-aio-pump", daemon=True)
        self.server = server
        self._streams: list[_SseMachine] = []
        self._event = threading.Event()
        self._stop = threading.Event()

    def add(self, machine: _SseMachine) -> None:
        with self.server._mu:
            self._streams.append(machine)
        self._event.set()

    def stop(self) -> None:
        self._stop.set()
        self._event.set()

    def live_streams(self) -> int:
        with self.server._mu:
            return len(self._streams)

    def run(self) -> None:
        while not self._stop.is_set():
            with self.server._mu:
                streams = list(self._streams)
            progressed = False
            finished = []
            for m in streams:
                try:
                    progressed = m.pump() or progressed
                except Exception:
                    # a machine must never take the pump down with it
                    log.exception("SSE pump: stream %s failed", m.rid)
                    m.done = True
                    try:
                        m.api.scheduler.cancel(m.req, reason="cancelled")
                    except Exception:
                        pass
                    # the 200/chunked headers are already out: end the
                    # chunked response and retire the connection — leaving
                    # it open would hang the client mid-stream and let a
                    # pipelined request's bytes interleave into the
                    # unterminated chunk stream
                    try:
                        m.ctx._write_chunk(b"")
                    except Exception:
                        pass
                    m.conn.closing = True
                    self.server._request_done(m.conn)
                if m.done:
                    finished.append(m)
            if finished:
                with self.server._mu:
                    self._streams = [m for m in self._streams
                                     if m not in finished]
            if not progressed:
                self._event.wait(PUMP_IDLE_S if streams else 0.5)
                self._event.clear()


class _AioContext(api_mod.RequestRoutes):
    """RequestRoutes over the event-loop transport: responses are rendered
    to bytes and enqueued on the connection's outbound buffer; the loop
    flushes them as the socket accepts writes."""

    def __init__(self, server, conn: _Conn, command: str, path: str,
                 headers, body: bytes):
        self.server = server
        self.conn = conn
        self.command = command
        self.path = path
        self.headers = headers
        self._body = body
        self.api = server.api
        self.detached = False  # True once an SSE machine owns the connection

    # ------------------------------------------------- transport primitives

    def _read_body(self) -> bytes:
        return self._body

    def _drain_body(self) -> None:
        pass  # the loop buffered the whole body before dispatch

    def _client_gone(self) -> bool:
        return self.conn.dead

    @staticmethod
    def _head(status: int, headers) -> bytes:
        try:
            phrase = http.HTTPStatus(status).phrase
        except ValueError:  # pragma: no cover - nonstandard code
            phrase = ""
        lines = [f"HTTP/1.1 {status} {phrase}",
                 "Server: dllama-tpu aio",
                 f"Date: {email.utils.formatdate(usegmt=True)}"]
        lines.extend(f"{k}: {v}" for k, v in headers)
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    def _send_raw(self, status: int, headers, body: bytes) -> None:
        ins.HTTP_RESPONSES.labels(endpoint=api_mod._endpoint(self.path),
                                  code=str(status)).inc()
        self.server.enqueue(self.conn, self._head(status, headers) + body)

    def _start_sse(self) -> None:
        hdrs = [("Content-Type", "text/event-stream"),
                ("Cache-Control", "no-cache"),
                ("Transfer-Encoding", "chunked")]
        if self._req_id:
            hdrs.append(("X-Request-Id", self._req_id))
        if self.api.replica_id:
            hdrs.append(("X-Replica-Id", self.api.replica_id))
        ins.HTTP_RESPONSES.labels(endpoint=api_mod._endpoint(self.path),
                                  code="200").inc()
        self.server.enqueue(self.conn, self._head(200, hdrs))

    def _write_chunk(self, payload: bytes) -> None:
        self.server.enqueue(
            self.conn,
            f"{len(payload):x}\r\n".encode() + payload + b"\r\n")

    # --------------------------------------------------- streaming override

    def _stream(self, body: dict, legacy: bool = False) -> None:
        """Batched-tier streams detach to the pump (zero blocked threads
        per stream); the single-engine tier runs the shared blocking
        implementation on this pool worker."""
        if self.api.scheduler is None:
            api_mod.RequestRoutes._stream(self, body, legacy)
            return
        machine = _SseMachine(self, body, legacy)
        self.detached = True
        self.server._pump.add(machine)


class AioHttpServer:
    """The event-loop front-end. Interface-compatible with the
    ThreadingHTTPServer the serving stack already drives: construct with
    ``(host, port)``, read ``server_address``, run ``serve_forever()`` in
    a thread, stop with ``shutdown()``, release with ``server_close()``."""

    def __init__(self, address, api, workers: int | None = None,
                 ctx_factory=None):
        host, port = address
        self.api = api
        self._ctx_factory = ctx_factory or _AioContext
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(256)
        self._listener.setblocking(False)
        self.server_address = self._listener.getsockname()
        self._sel = selectors.DefaultSelector()
        self._mu = locks.make_lock("serve.frontend")
        self._conns: dict = {}  # socket -> _Conn (loop thread mutates)
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        n = workers or min(8, max(2, (os.cpu_count() or 4)))
        self.workers = int(n)
        # per-server gauge series: several event loops can share a process
        # (replica servers + router fronts in tests/bench) and must not
        # clobber one another's counts
        self._conn_gauge = ins.FRONTEND_CONNECTIONS.labels(
            server=f"{self.server_address[0]}:{self.server_address[1]}")
        self._pool = ThreadPoolExecutor(max_workers=self.workers,
                                        thread_name_prefix="dllama-aio")
        # control plane gets its own tiny pool: /health probes, /metrics
        # scrapes, and registry reads must answer even when every request
        # worker is parked on a long completion (on the router tier each
        # proxied stream occupies a worker for its whole lifetime — an LB
        # probe queued behind 16 of those would flag a healthy process
        # dead and restart it, killing every in-flight stream)
        self._ctrl = ThreadPoolExecutor(max_workers=2,
                                        thread_name_prefix="dllama-aio-ctrl")
        self._pump = _Pump(self)
        self._stop = threading.Event()
        self._stopped = threading.Event()
        self._serving = False
        self._accepting = True

    # ------------------------------------------------------------ lifecycle

    def serve_forever(self, poll_interval: float = 0.5) -> None:
        self._serving = True
        if not self._pump.is_alive():
            self._pump.start()
        self._sel.register(self._listener, selectors.EVENT_READ, "listen")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        try:
            while not self._stop.is_set():
                try:
                    events = self._sel.select(timeout=poll_interval)
                except OSError:  # pragma: no cover - fd churn at shutdown
                    continue
                for key, mask in events:
                    tag = key.data
                    if tag == "listen":
                        self._accept()
                    elif tag == "wake":
                        try:
                            while self._wake_r.recv(4096):
                                pass
                        except (BlockingIOError, InterruptedError):
                            pass
                        if not self._accepting:
                            try:
                                self._sel.unregister(self._listener)
                            except (KeyError, ValueError):
                                pass
                    else:
                        if mask & selectors.EVENT_READ:
                            self._read(tag)
                # post-select sweep: flush, parse pipelined requests, close
                for conn in list(self._conns.values()):
                    if conn.dead:
                        # marked dead off-loop (outbound-cap overflow): tear
                        # it down here — the loop owns socket/selector state
                        self._close(conn)
                        continue
                    if conn.out:
                        self._flush(conn)
                    if not conn.busy and not conn.dead \
                            and not conn.closing and conn.inbuf:
                        self._try_parse(conn)
                    if conn.closing and not conn.busy and not conn.out:
                        self._close(conn)
        finally:
            for conn in list(self._conns.values()):
                self._close(conn)
            for sock in (self._listener, self._wake_r):
                try:
                    self._sel.unregister(sock)
                except (KeyError, ValueError):
                    pass
            self._stopped.set()

    def shutdown(self, flush_timeout_s: float = 5.0) -> None:
        """Stop accepting, give in-flight responses a bounded window to
        finish flushing (the scheduler drain has already run by the time
        the SIGTERM path calls this), then stop the loop."""
        self._accepting = False
        self._wake()
        deadline = time.monotonic() + flush_timeout_s
        while time.monotonic() < deadline:
            with self._mu:  # the loop thread pops _conns concurrently
                conns = list(self._conns.values())
            busy = any(c.busy or c.out for c in conns)
            if not busy and self._pump.live_streams() == 0:
                break
            time.sleep(0.02)
        self._stop.set()
        self._wake()
        if self._serving:
            self._stopped.wait(timeout=10.0)
        self._pump.stop()
        self._pool.shutdown(wait=False)
        self._ctrl.shutdown(wait=False)

    def server_close(self) -> None:
        for sock in (self._listener, self._wake_r, self._wake_w):
            try:
                sock.close()
            except OSError:
                pass
        try:
            self._sel.close()
        except OSError:  # pragma: no cover
            pass

    # ------------------------------------------------------------- plumbing

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\x01")
        except (BlockingIOError, InterruptedError, OSError):
            pass  # wake pipe full = a wake is already pending

    def enqueue(self, conn: _Conn, data: bytes) -> None:
        """Worker/pump threads hand response bytes to the loop."""
        if conn.dead:
            return  # the peer is gone; nothing to deliver to
        if conn.obytes > MAX_OUT_BYTES:
            # the peer stopped reading but kept the socket open (no EOF to
            # observe): treat it as gone so the stream's producer stops —
            # the pump/probe sees `dead` and cancels the request
            conn.dead = True
            self._wake()
            return
        conn.obytes += len(data)
        conn.out.append(data)
        self._wake()

    def _request_done(self, conn: _Conn) -> None:
        """A handler or stream finished its response: the connection may
        parse its next pipelined request (loop-side sweep picks it up)."""
        conn.busy = False
        self._wake()

    def _accept(self) -> None:
        while self._accepting:
            try:
                sock, addr = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                break
            sock.setblocking(False)
            conn = _Conn(sock, addr)
            with self._mu:
                self._conns[sock] = conn
            self._sel.register(sock, selectors.EVENT_READ, conn)
            self._conn_gauge.set(len(self._conns))

    def _read(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            data = b""
        if not data:
            # EOF/reset: THE disconnect signal. Mark dead and tear the
            # socket down; a busy handler's probe / the pump notices the
            # flag and cancels the scheduler request.
            conn.dead = True
            self._close(conn)
            return
        conn.inbuf += data
        if len(conn.inbuf) > MAX_HEADER_BYTES + MAX_BODY_BYTES:
            # one request head + the largest legal body is the most a
            # well-behaved client ever buffers ahead (size limits are only
            # checked at parse time, which waits while a handler is busy);
            # past it the peer is flooding — drop the connection rather
            # than grow without bound. The threads tier gets the same
            # protection from its blocking reads' natural backpressure.
            conn.dead = True
            self._close(conn)

    def _flush(self, conn: _Conn) -> None:
        out = conn.out
        while out:
            data = out[0]
            try:
                n = conn.sock.send(data)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                conn.dead = True
                self._close(conn)
                return
            conn.obytes -= n
            if n < len(data):
                out[0] = data[n:]
                break
            out.popleft()
        if not out:
            # unlocked += from worker/pump threads can drift a few bytes
            # under GIL races; an empty queue is the exact ground truth, so
            # re-zero here (every fully-flushed moment) — the cap only has
            # to be approximately right, never cumulatively wrong
            conn.obytes = 0
        want_write = bool(out)
        if want_write != conn.wmask:
            conn.wmask = want_write
            mask = selectors.EVENT_READ | (
                selectors.EVENT_WRITE if want_write else 0)
            try:
                self._sel.modify(conn.sock, mask, conn)
            except (KeyError, ValueError):  # pragma: no cover - racing close
                pass

    def _close(self, conn: _Conn) -> None:
        with self._mu:
            existed = self._conns.pop(conn.sock, None)
        if existed is None:
            return
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        self._conn_gauge.set(len(self._conns))

    # -------------------------------------------------------------- parsing

    def _bad_request(self, conn: _Conn, status: int, message: str) -> None:
        body = (b'{"error": {"message": "' + message.encode() + b'"}}')
        head = _AioContext._head(status, [
            ("Content-Type", "application/json"),
            ("Content-Length", str(len(body))),
            ("Connection", "close")])
        # through enqueue like every other response: obytes accounting, the
        # loop wake (otherwise the bytes sit until the next select timeout
        # — the sweep's flush already ran for this connection), and the
        # response counter the threads tier's _send_json increments
        ins.HTTP_RESPONSES.labels(endpoint="other", code=str(status)).inc()
        self.enqueue(conn, head + body)
        # drop the offending bytes — a closing connection parses nothing
        # more, and leaving them buffered would re-answer the same error
        # every sweep while the close waits for the flush
        conn.inbuf.clear()
        conn.closing = True

    def _try_parse(self, conn: _Conn) -> None:
        """Parse one complete request off the connection's input buffer and
        dispatch it to the pool. Loop thread only; at most one in-flight
        request per connection (HTTP/1.1 pipelining is answered in order
        because the next parse waits for _request_done)."""
        buf = conn.inbuf
        idx = buf.find(b"\r\n\r\n")
        if idx < 0:
            if len(buf) > MAX_HEADER_BYTES:
                self._bad_request(conn, 431, "request header too large")
            return
        head = bytes(buf[:idx + 2])
        line, _, rest = head.partition(b"\r\n")
        parts = line.split()
        if len(parts) != 3 or not parts[2].startswith(b"HTTP/"):
            self._bad_request(conn, 400, "malformed request line")
            return
        command = parts[0].decode("latin-1")
        path = parts[1].decode("latin-1")
        version = parts[2].decode("latin-1")
        try:
            headers = parse_headers(io.BytesIO(rest + b"\r\n"))
        except Exception:
            self._bad_request(conn, 400, "malformed headers")
            return
        if headers.get("Transfer-Encoding"):
            # this parser frames bodies by Content-Length ONLY. Accepting a
            # TE request CL-framed is the CL.TE request-smuggling shape
            # behind any TE-honoring proxy (RFC 9112: TE wins or the
            # message must be rejected) — reject, never mis-frame
            self._bad_request(conn, 411,
                              "chunked request bodies are not supported; "
                              "send Content-Length")
            return
        cls = headers.get_all("Content-Length") or []
        if len(set(cls)) > 1:
            # differing duplicate Content-Length is the CL.CL smuggling
            # shape (a front proxy framing by the LAST value would leave
            # our first-value framing a desynchronized tail) — RFC 9112
            # requires rejection
            self._bad_request(conn, 400, "conflicting Content-Length")
            return
        try:
            length = int(cls[0]) if cls else 0
        except ValueError:
            self._bad_request(conn, 400, "invalid Content-Length")
            return
        if length < 0 or length > MAX_BODY_BYTES:
            self._bad_request(conn, 413, "body too large")
            return
        total = idx + 4 + length
        if len(buf) < total:
            # the threads tier (BaseHTTPRequestHandler) answers an interim
            # 100 Continue for HTTP/1.1 `Expect` bodies — clients like curl
            # withhold POST bodies >1 KB until they see it, so without this
            # every large-prompt request stalls on the client's expect
            # timeout (the _try_parse re-run each sweep is why the flag
            # guards a single send per request)
            if (not conn.continued and version != "HTTP/1.0"
                    and headers.get("Expect", "").lower() == "100-continue"):
                conn.continued = True
                self.enqueue(conn, b"HTTP/1.1 100 Continue\r\n\r\n")
            return  # body still arriving
        conn.continued = False
        body = bytes(buf[idx + 4:total])
        del buf[:total]
        if (version == "HTTP/1.0"
                or headers.get("Connection", "").lower() == "close"):
            conn.closing = True
        conn.busy = True
        ctx = self._ctx_factory(self, conn, command, path, headers, body)
        control = command == "GET" and path.startswith(("/health", "/metrics", "/router/"))
        (self._ctrl if control else self._pool).submit(self._run_ctx, ctx)

    def _run_ctx(self, ctx: _AioContext) -> None:
        try:
            if ctx.command == "GET":
                ctx.do_GET()
            elif ctx.command == "POST":
                ctx.do_POST()
            else:
                ctx._send_json(501, {"error": {
                    "message": f"unsupported method {ctx.command}"}})
        except Exception:
            # do_GET/do_POST handle their own errors; anything escaping is
            # a transport-level failure — drop the connection (the threads
            # tier's handler thread dies the same way)
            log.exception("aio handler failed (%s %s)",
                          ctx.command, ctx.path)
            ctx.conn.closing = True
        finally:
            if not ctx.detached:
                self._request_done(ctx.conn)
