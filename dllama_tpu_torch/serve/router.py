"""Multi-replica serving router — `python -m dllama_tpu_torch router`: a copy
of the JAX package's ``serve/router.py`` over this package's aio transport,
observability and fault points (it imports nothing of the JAX package, and
nothing of torch: it owns no device). Replicas of either package can sit
behind it; they speak the same HTTP surface.

One engine process owns one device; serving "millions of users" needs N of
them. This router is the separate process that fronts N engine replicas
(each a normal `dllama-tpu serve --slots ...` process) and gives the fleet
one OpenAI-compatible address, the way the reference's ROOT node fronts
its `NnNetwork` worker mesh (SURVEY.md L4/L5: the root performs a config
handshake with every worker, then scatter-gathers the actual work):

* **replica registry + config handshake** — at registration the router
  reads each replica's `/health` build payload and `/v1/models`; the first
  replica's (model, version) pair becomes the mesh config, and a replica
  that disagrees is quarantined (config_ok=False, never routed) instead of
  silently serving a different model — the root/worker handshake verdict,
  inverted for a pull-style mesh (replicas own their weights; the router
  verifies instead of distributing).
* **health polling + drain integration** — a poller thread GETs `/health`
  on a short cadence: `ready:false` (draining or saturated) stops NEW
  routing while in-flight requests finish; `live` flips the
  `dllama_replica_healthy` gauge; connection failure marks the replica
  down immediately at the first failed proxy attempt, not a poll later.
* **prefix-affinity routing** — requests carry their prefix fingerprint
  (the shared system prompt / leading prompt bytes, hashed); the router
  pins a fingerprint to the replica that served it last, so multi-turn
  chats and shared-template traffic land where the replicas' radix cache is
  already warm (SGLang's cache-aware routing, one level up). Token-id
  exactness lives in the replica's radix tree; the router only needs a
  stable warm HINT, so a text-prefix hash is sufficient and tokenizer-free.
  Capacity-aware: a warm replica that is overloaded relative to the
  least-loaded one (or not ready) is overridden, and the fingerprint is
  re-pinned to wherever the request actually lands.
* **failover** — a replica that refuses/resets before any response byte
  reached the client is NOT a client-visible failure: the request is
  re-routed to a surviving replica (bounded attempts, exponential backoff
  with jitter), the failed replica is marked down, and the reroute is
  counted.
* **mid-stream failover** — the router sees every SSE frame it
  relays, so it JOURNALS each stream's resume state: the raw token ids the
  frames carried (`include_token_ids` is injected into every proxied
  stream body), the stream id/created, and a pinned per-request seed. When
  a replica dies mid-stream, the router resubmits to a survivor with a
  `resume` body — prompt plus the journaled emitted prefix, which the
  replica re-prefills through its radix/resume_commit path and whose PRNG
  chain it replays from the seed — so greedy AND sampled streams continue
  BIT-EXACT vs the uninterrupted run, duplicate-suppressed by journal
  position, with at most one in-band `: retrying` comment visible.
  Bounded by `--failover-max` resume attempts per stream under capped
  exponential backoff with jitter. Unresumable streams (journal ring
  full, journal over its token bound, no survivor, budget spent) keep the
  old exactly-once contract: a final SSE chunk with
  `finish_reason:"error"`, an in-band error event, then `[DONE]` — never
  a half-open socket. When every replica is down or shedding, the router
  sheds with the worst upstream's `Retry-After` honored.

* **fleet observability plane** — the router is the one
  process that sees every request leg, so it owns the fleet's joined view:
  it mints a distributed trace context per request (`X-Dllama-Trace` hop
  header: trace id + parent span + hop count) and instruments its own path
  as first-class spans in a router-side tracer (`connect`, `proxy`,
  `poll`, `failover.attempt`, `resume`, `journal`, plus the
  `affinity.pick` instant event); the health poller doubles as an NTP-lite
  clock-offset estimator per replica (obs/perf.ClockOffset, min-RTT sample
  per poll window) and each poll exchange is itself a `poll` span;
  `GET /router/trace` fetches every replica's Chrome export, shifts it by
  the estimated offset, and merges it with the router's own track into ONE
  Perfetto file; `GET /metrics` (alias `/router/metrics`) federates every
  live replica's exposition (each series relabeled `replica=<rid>`,
  counters summed and histograms merged bucket-wise into an exact
  `dllama_fleet_*` view, dead replicas held at their last-known values
  with `dllama_fleet_scrape_age_seconds` growing); client-perspective
  TTFT/ITL is measured AT the router per replica and fleet-wide
  (`dllama_router_ttft_seconds`, `dllama_router_itl_seconds`,
  `dllama_router_slo_attainment{replica}`) so failover- and network-
  induced SLO misses invisible to any single replica are scored where the
  client feels them; `GET /router/fleet` joins health + SLO attainment +
  KV/spill/radix + clock offsets + failover counters vs client-observed
  errors with mesh-wide goodput; `GET /router/requests/{req_id}` joins the
  router's failover journal with each serving replica's flight recorder —
  one URL answers "what happened to this request" across retries,
  resumes, and deaths.

Transport: the same selectors event loop as `--frontend aio`
(serve/aio.AioHttpServer with a router context class); each in-flight
proxied request occupies one worker-pool thread for its upstream I/O.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import logging
import random
import re
import threading
import time
import uuid
from collections import OrderedDict

from dllama_tpu_torch.obs import metrics, new_request_id, trace
from dllama_tpu_torch.obs import instruments as ins
from dllama_tpu_torch.obs.perf import (ClockOffset, SloPolicy, WindowQuantiles,
                                 WindowSums)
from dllama_tpu_torch.serve.aio import AioHttpServer, _AioContext
from dllama_tpu_torch.utils import faults, locks

log = logging.getLogger("dllama_tpu_torch.serve.router")

#: request paths the router proxies (completions surface only; /debug and
#: /metrics are per-replica diagnostics an operator hits directly)
_PROXY_POSTS = ("/v1/chat/completions", "/chat/completions",
                "/v1/completions", "/completions")

#: leading prompt characters the affinity fingerprint hashes — long enough
#: to separate real system prompts, short enough that giant pastes don't
#: dominate the hash cost
AFFINITY_PREFIX_CHARS = 512

#: how much busier (in-flight + queued) an affinity-warm replica may be
#: than the least-loaded one before warmth loses to capacity
AFFINITY_OVERLOAD = 8


class Replica:
    """Registry entry for one engine replica."""

    __slots__ = ("rid", "host", "port", "live", "ready", "draining",
                 "queue_depth", "busy_slots", "inflight", "build",
                 "model", "config_ok", "handshaken", "last_poll",
                 "last_picked", "fails", "clock", "trace_epoch",
                 "last_metrics_text", "last_metrics_t")

    def __init__(self, rid: str, host: str, port: int):
        self.rid = rid
        self.host = host
        self.port = port
        self.live = False
        self.ready = False
        self.draining = False
        self.queue_depth = 0
        self.busy_slots = 0
        self.inflight = 0  # router-side in-flight proxied requests
        self.build = None  # /health "build" payload from the handshake
        self.model = None  # /v1/models first id
        self.config_ok = True
        self.handshaken = False
        self.last_poll = 0.0
        self.last_picked = 0.0
        self.fails = 0
        # NTP-lite clock alignment: the health poller samples
        # this replica's monotonic clock against ours on every round trip;
        # trace_epoch is the replica tracer's t=0 in the replica's clock,
        # which is what /router/trace shifts Chrome timestamps by
        self.clock = ClockOffset()
        self.trace_epoch: float | None = None
        # last successful /metrics scrape (the staleness contract):
        # a dead replica keeps federating these last-known series while
        # dllama_fleet_scrape_age_seconds grows — stale, never zero traffic
        self.last_metrics_text: str | None = None
        self.last_metrics_t = 0.0

    def load(self) -> int:
        """The routing load signal: what's running here plus what's queued
        (health-poll fresh) plus what this router already sent."""
        return self.inflight + self.queue_depth + self.busy_slots

    def snapshot(self) -> dict:
        return {"id": self.rid, "address": f"{self.host}:{self.port}",
                "live": self.live, "ready": self.ready,
                "draining": self.draining, "config_ok": self.config_ok,
                "queue_depth": self.queue_depth,
                "busy_slots": self.busy_slots, "inflight": self.inflight,
                "fails": self.fails, "model": self.model,
                "build": self.build,
                "clock": self.clock.estimate(),
                "last_poll_age_s": (round(time.monotonic() - self.last_poll,
                                          3) if self.last_poll else None)}


class _StreamJournal:
    """Per-stream resume state, built from the frames the router
    relays: the raw token ids (`token_ids`/`position` fields the injected
    ``include_token_ids`` makes every frame carry), the stream identity the
    client saw, and terminal-frame tracking. ``valid`` drops to False when
    the journal can no longer vouch for the client's view (ring full at
    admission, token bound exceeded, a position gap) — the stream then
    fails with the pre-failover exactly-once error contract."""

    __slots__ = ("tokens", "cid", "created", "finished", "valid", "counted")

    def __init__(self, valid: bool = True):
        self.tokens: list[int] = []
        self.cid: str | None = None
        self.created = 0
        self.finished = False  # terminal frame relayed (finish/error/[DONE])
        self.valid = valid
        self.counted = valid  # held a slot in the router's journal ring

    def note_frame(self, frame: bytes, max_tokens: int) -> bool:
        """Account one complete SSE frame -> whether to RELAY it (False =
        a duplicate the client already has, drop it). Appends ids only at
        the exact journal position, which makes replayed/overlapping
        frames after a failover self-suppressing."""
        if not frame.startswith(b"data: "):
            return True  # comment/heartbeat frames pass through
        payload = frame[len(b"data: "):].strip()
        if payload == b"[DONE]":
            self.finished = True
            return True
        try:
            obj = json.loads(payload)
        except ValueError:
            return True
        if "error" in obj:
            self.finished = True
            return True
        if self.cid is None:
            self.cid = obj.get("id")
            self.created = int(obj.get("created") or 0)
        ids = obj.get("token_ids")
        pos = obj.get("position")
        if ids and isinstance(pos, int):
            if pos == len(self.tokens):
                self.tokens.extend(int(t) for t in ids)
                if len(self.tokens) > max_tokens:
                    self.valid = False  # over the ring bound: stop vouching
            elif pos + len(ids) <= len(self.tokens):
                # the survivor replayed a frame the dead replica already
                # delivered: the client has these bytes — suppress
                return False
            else:
                self.valid = False  # gap: the journal lost sync
        try:
            if (obj.get("choices") or [{}])[0].get("finish_reason"):
                self.finished = True
        except (TypeError, AttributeError, IndexError):
            pass
        return True


class _UpstreamDead(Exception):
    """Connection-level failure before/while talking to a replica."""


class _UpstreamBusy(Exception):
    """Replica answered 429/503 — try elsewhere, honor Retry-After."""

    def __init__(self, status: int, retry_after: float):
        super().__init__(f"upstream {status}")
        self.status = status
        self.retry_after = retry_after


def _parse_replica(spec: str) -> Replica:
    """'host:port' or 'http://host:port' -> Replica (rid = host:port)."""
    s = spec.strip()
    if s.startswith("http://"):
        s = s[len("http://"):]
    s = s.rstrip("/")
    host, _, port = s.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"replica spec {spec!r}: expected host:port")
    return Replica(f"{host}:{port}", host, int(port))


#: one exposition sample line: name, optional {labels}, value
_SAMPLE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)$")


def _parse_exposition(text: str):
    """Line-parse one Prometheus exposition -> (families, samples) where
    families maps name -> [kind, help] and samples are (family, sample_name,
    label_block, value_text) in input order. Family attribution for _bucket/
    _sum/_count rides the preceding HELP/TYPE block, the way the renderer
    emits them. Values stay TEXT — federation must not reformat a number it
    merely relays."""
    fams: dict[str, list] = {}
    samples: list[tuple[str, str, str, str]] = []
    cur = None
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            name, _, help_ = line[len("# HELP "):].partition(" ")
            fams.setdefault(name, ["", ""])[1] = help_
            cur = name
        elif line.startswith("# TYPE "):
            name, _, kind = line[len("# TYPE "):].partition(" ")
            fams.setdefault(name, ["", ""])[0] = kind.strip()
            cur = name
        elif line.startswith("#"):
            continue
        else:
            m = _SAMPLE_RE.match(line)
            if not m:
                continue
            name, labels, value = m.groups()
            fam = cur if cur and name.startswith(cur) else name
            samples.append((fam, name, labels or "", value))
    return fams, samples


def _fleet_name(fam: str) -> str:
    return ("dllama_fleet_" + fam[len("dllama_"):]
            if fam.startswith("dllama_") else "fleet_" + fam)


def federate(own: str, parts: list[tuple[str, str]]) -> str:
    """Merge the router's exposition with each replica's into one: every
    replica sample gains a leading ``replica="<rid>"`` label
    (the router's own series stay unlabeled — it IS the scrape target),
    families keep one HELP/TYPE block each, and counters AND histograms
    are additionally pre-aggregated across replicas into a
    ``dllama_fleet_*`` view so a dashboard gets mesh totals without a
    query-time sum. The histogram merge is EXACT, not approximate:
    buckets are fixed per family (obs/metrics registers one bucket tuple
    per histogram), so summing each ``le`` bucket, ``_sum``, and
    ``_count`` across replicas is the same histogram a single registry
    observing the union stream would render — property-tested in
    tests/test_fleet_obs.py."""
    fams: dict[str, list] = {}
    grouped: dict[str, list[str]] = {}
    fleet: dict[str, dict[str, float]] = {}
    # histograms: fam -> {(sample_name, label_block) -> summed value}, in
    # first-seen order (every replica renders one family's buckets in the
    # same ascending-le order, so insertion order IS exposition order)
    hfleet: dict[str, dict[tuple[str, str], float]] = {}

    def declare(name: str, kind: str, help_: str) -> None:
        cur = fams.setdefault(name, ["", ""])
        if kind and not cur[0]:
            cur[0] = kind
        if help_ and not cur[1]:
            cur[1] = help_

    own_fams, own_samples = _parse_exposition(own)
    for name, (kind, help_) in own_fams.items():
        declare(name, kind, help_)
    for fam, name, labels, value in own_samples:
        grouped.setdefault(fam, []).append(f"{name}{labels} {value}")

    for rid, text in parts:
        rep_fams, rep_samples = _parse_exposition(text)
        for name, (kind, help_) in rep_fams.items():
            declare(name, kind, help_)
        tag = f'replica="{metrics.escape_label_value(rid)}"'
        for fam, name, labels, value in rep_samples:
            inner = labels[1:-1] if labels else ""
            relabeled = "{" + tag + ("," + inner if inner else "") + "}"
            grouped.setdefault(fam, []).append(f"{name}{relabeled} {value}")
            kind = fams.get(fam, ["", ""])[0]
            if kind == "counter" and name == fam:
                try:
                    v = float(value)
                except ValueError:
                    continue
                acc = fleet.setdefault(fam, {})
                acc[labels] = acc.get(labels, 0.0) + v
            elif kind == "histogram" and name in (
                    fam + "_bucket", fam + "_sum", fam + "_count"):
                try:
                    v = float(value)
                except ValueError:
                    continue
                hacc = hfleet.setdefault(fam, {})
                hkey = (name, labels)
                hacc[hkey] = hacc.get(hkey, 0.0) + v

    out: list[str] = []
    for name in sorted(fams):
        kind, help_ = fams[name]
        if name not in grouped:
            continue  # declared but sampleless: nothing to expose
        out.append(f"# HELP {name} {help_ or name}")
        if kind in ("counter", "gauge", "histogram"):
            out.append(f"# TYPE {name} {kind}")
        out.extend(grouped[name])
    for fam in sorted(fleet):
        fname = _fleet_name(fam)
        out.append(f"# HELP {fname} Sum of {fam} across all scraped "
                   "replicas (pre-aggregated at the router)")
        out.append(f"# TYPE {fname} counter")
        for labels, v in sorted(fleet[fam].items()):
            out.append(f"{fname}{labels} {metrics.format_value(v)}")
    for fam in sorted(hfleet):
        fname = _fleet_name(fam)
        out.append(f"# HELP {fname} Bucket-wise sum of {fam} across all "
                   "scraped replicas (exact: buckets are fixed per family)")
        out.append(f"# TYPE {fname} histogram")
        for (name, labels), v in hfleet[fam].items():
            out.append(f"{fname}{name[len(fam):]}{labels} "
                       f"{metrics.format_value(v)}")
    return "\n".join(out) + "\n"


class Router:
    """The replica mesh + routing policy (transport-independent: the
    context class below adapts it onto the aio event loop)."""

    # the aio context reads these off `server.api`
    replica_id = ""
    sse_heartbeat_s = 0.0
    scheduler = None

    def __init__(self, replicas: list[str], poll_s: float = 0.5,
                 affinity: bool = True, connect_timeout_s: float = 2.0,
                 stream_idle_timeout_s: float = 120.0,
                 max_affinity_entries: int = 4096,
                 failover_max: int = 2,
                 max_live_journals: int = 1024,
                 max_journal_tokens: int = 16384,
                 fleet_obs: bool = True,
                 trace_capacity: int = 2048,
                 max_request_records: int = 512,
                 slo: SloPolicy | None = None):
        if not replicas:
            raise ValueError("router needs at least one --replica")
        self.replicas = [_parse_replica(s) for s in replicas]
        if len({r.rid for r in self.replicas}) != len(self.replicas):
            raise ValueError("duplicate --replica addresses")
        self.poll_s = float(poll_s)
        self.affinity_on = bool(affinity)
        self.connect_timeout_s = float(connect_timeout_s)
        self.stream_idle_timeout_s = float(stream_idle_timeout_s)
        self.max_affinity_entries = int(max_affinity_entries)
        # mid-stream failover: resume attempts per stream
        # (--failover-max; 0 restores the fail-exactly-once contract), the
        # live-journal ring bound (streams admitted past it relay fine but
        # are unresumable), and the per-journal token bound
        self.failover_max = int(failover_max)
        self.max_live_journals = int(max_live_journals)
        self.max_journal_tokens = int(max_journal_tokens)
        self._live_journals = 0
        # mesh observability plane: the router's OWN tracer (its
        # spans are the mesh trace's router track), gated by --fleet-obs so
        # the bench can A/B the plane's overhead; off => NULL tracer, no hop
        # header, no clock sampling. Postmortem records live in a bounded
        # insertion-ordered ring (oldest evicted), keyed by request id.
        self.fleet_obs = bool(fleet_obs)
        self.tracer = (trace.Tracer(int(trace_capacity))
                       if self.fleet_obs and int(trace_capacity) > 0
                       else trace.NULL_TRACER)
        self.max_request_records = int(max_request_records)
        self._requests: OrderedDict[str, dict] = OrderedDict()
        # router-side SLO attainment: CLIENT-perspective TTFT/
        # ITL windows per replica plus the replica="fleet" rollup, judged
        # against the router's own SloPolicy. A replica can meet its local
        # SLOs while the client misses them (failover gap, network): that
        # delta is precisely what these windows exist to expose.
        self.slo = slo or SloPolicy()
        self._client: dict[str, dict] = {"fleet": self._client_window()}
        for r in self.replicas:
            self._client[r.rid] = self._client_window()
        # the router's own trace epoch: merge math aligns every replica's
        # export onto THIS timeline (postmortem at_ms is relative to it too)
        self._boot = getattr(self.tracer, "epoch", None) or time.monotonic()
        self._mu = locks.make_lock("serve.router")
        self._affinity: dict[str, str] = {}  # fingerprint -> replica rid
        self._pick_seq = 0.0
        self.draining = False
        self._stop = threading.Event()
        self._pollers: list[threading.Thread] = []  # one per replica
        # mesh config (set by the first successful handshake): every other
        # replica must agree or it is quarantined
        self.mesh_model = None
        self.mesh_version = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        # one synchronous poll round first so the router comes up knowing
        # its mesh (the reference root performs its config handshake before
        # serving, nn-network root/worker synchronize the same way).
        # SEQUENTIAL in list order so mesh-config adoption is deterministic
        # — "the first replica's (model, version) becomes the mesh config"
        # must mean the first LISTED live replica, not a poll race winner.
        for rep in self.replicas:
            self._poll_one(rep)
        # steady state: ONE persistent poller thread per replica — polls of
        # the same replica are serialized by construction (a stale timed-out
        # poll can never overwrite a fresher one's verdict), an unreachable
        # replica's 2 s connect timeouts never stretch its neighbors'
        # cadence, and nothing spawns per tick
        for rep in self.replicas:
            t = threading.Thread(target=self._poll_replica_loop, args=(rep,),
                                 name=f"dllama-router-poll-{rep.rid}",
                                 daemon=True)
            self._pollers.append(t)
            t.start()

    def stop(self) -> None:
        self._stop.set()

    def drain(self) -> None:
        """Stop admitting NEW requests (503 + ready:false); in-flight
        proxied requests keep streaming until they finish."""
        self.draining = True

    # ---------------------------------------------------------- health poll

    def _poll_one(self, rep: Replica) -> None:
        t_send = time.monotonic()
        try:
            conn = http.client.HTTPConnection(rep.host, rep.port,
                                              timeout=self.connect_timeout_s)
            conn.request("GET", "/health")
            resp = conn.getresponse()
            payload = json.loads(resp.read() or b"{}")
            conn.close()
        except (OSError, ValueError, http.client.HTTPException) as e:
            # HTTPException (BadStatusLine/IncompleteRead from a replica
            # mid-restart) is not an OSError — escaping here would kill the
            # poller thread permanently
            self.tracer.span_at("poll", t_send, time.monotonic(),
                                cat="router", track="poll",
                                replica=rep.rid, ok=False)
            self._mark_down(rep, f"health poll failed: {e!r}")
            return
        t_recv = time.monotonic()
        # the poll exchange is itself a first-class span on the router's
        # "poll" track — it doubles as the NTP-lite clock sample below, so
        # a trace reader can see exactly which round trips fed alignment
        self.tracer.span_at("poll", t_send, t_recv, cat="router",
                            track="poll", replica=rep.rid, ok=True)
        if self.fleet_obs:
            # NTP-lite: the replica reports its own monotonic clock inside
            # the poll response; one (rtt, offset) sample per poll, min-RTT
            # wins over the window (the tightest round trip bounds the
            # asymmetry error best)
            clk = payload.get("clock") or {}
            t_remote = clk.get("monotonic_s")
            if isinstance(t_remote, (int, float)):
                rep.clock.sample(t_send, t_recv, float(t_remote))
                est = rep.clock.estimate()
                if est is not None:
                    ins.REPLICA_CLOCK_OFFSET.labels(replica=rep.rid).set(
                        est["offset_s"])
                    ins.REPLICA_CLOCK_UNCERTAINTY.labels(
                        replica=rep.rid).set(est["uncertainty_s"])
            epoch = clk.get("trace_epoch_s")
            if isinstance(epoch, (int, float)):
                rep.trace_epoch = float(epoch)
        rep.live = bool(payload.get("live"))
        rep.ready = bool(payload.get("ready")) and not payload.get("draining")
        rep.draining = bool(payload.get("draining"))
        rep.queue_depth = int(payload.get("queue_depth") or 0)
        rep.busy_slots = int(payload.get("busy_slots") or 0)
        rep.last_poll = time.monotonic()
        ins.REPLICA_HEALTHY.labels(replica=rep.rid).set(
            1.0 if rep.live else 0.0)
        if not rep.handshaken:
            self._handshake(rep, payload)

    def _handshake(self, rep: Replica, health: dict) -> None:
        """Config handshake (reference root/worker wire protocol's role):
        record the replica's build + served model, adopt the first
        replica's pair as the mesh config, quarantine disagreement."""
        rep.build = health.get("build")
        try:
            conn = http.client.HTTPConnection(rep.host, rep.port,
                                              timeout=self.connect_timeout_s)
            conn.request("GET", "/v1/models")
            resp = conn.getresponse()
            models = json.loads(resp.read() or b"{}")
            conn.close()
            rep.model = (models.get("data") or [{}])[0].get("id")
        except (OSError, ValueError, IndexError, http.client.HTTPException):
            return  # not handshaken yet; next poll retries
        rep.handshaken = True
        version = (rep.build or {}).get("version")
        with self._mu:
            if self.mesh_model is None:
                self.mesh_model = rep.model
                self.mesh_version = version
                rep.config_ok = True
                log.info("router mesh config from %s: model=%s version=%s",
                         rep.rid, rep.model, version)
                return
        ok = rep.model == self.mesh_model and version == self.mesh_version
        if not ok and rep.config_ok:
            log.error("replica %s FAILED the config handshake: serves "
                      "(%s, %s), mesh is (%s, %s) — quarantined",
                      rep.rid, rep.model, version, self.mesh_model,
                      self.mesh_version)
        elif ok and not rep.config_ok:
            # a formerly-quarantined replica came back (redeployed) with
            # the mesh's config: re-admit it
            log.info("replica %s re-passed the config handshake — "
                     "re-admitted", rep.rid)
        rep.config_ok = ok

    def _mark_down(self, rep: Replica, why: str) -> None:
        if rep.live or rep.ready:
            log.warning("replica %s marked down: %s", rep.rid, why)
        rep.live = False
        rep.ready = False
        # a down replica may come back as a DIFFERENT process (redeploy):
        # its identity must be re-verified before it is routed again — this
        # is also how a quarantined replica rejoins after being fixed
        rep.handshaken = False
        rep.fails += 1
        rep.last_poll = time.monotonic()
        ins.REPLICA_HEALTHY.labels(replica=rep.rid).set(0.0)

    def _poll_replica_loop(self, rep: Replica) -> None:
        while not self._stop.wait(self.poll_s):
            self._poll_one(rep)

    # -------------------------------------------------------------- routing

    @staticmethod
    def fingerprint(body: dict, legacy: bool) -> str | None:
        """Prefix fingerprint of a completions body — the warm-cache hint.
        Chat: the leading SYSTEM message when present (the shared-template
        prefix real traffic reuses), else the first message; legacy: the
        prompt's leading bytes. Deterministic text prefix => deterministic
        token prefix => the replica's radix tree resolves the real hit."""
        try:
            if legacy:
                text = str(body.get("prompt") or "")
            else:
                msgs = body.get("messages") or []
                first = msgs[0] if msgs else {}
                text = f"{first.get('role')}\x1f{first.get('content')}"
            if not text:
                return None
            return hashlib.sha1(
                text[:AFFINITY_PREFIX_CHARS].encode("utf-8", "replace")
            ).hexdigest()
        except (TypeError, AttributeError, IndexError):
            return None

    def _routable(self, exclude: set) -> list[Replica]:
        # handshaken is required, not just config_ok: before the handshake
        # completes the replica's identity is UNVERIFIED (config_ok still
        # holds its default) — never route there yet
        return [r for r in self.replicas
                if r.ready and r.handshaken and r.config_ok
                and r.rid not in exclude]

    def pick(self, fp: str | None,
             exclude: set) -> tuple[Replica | None, bool]:
        """-> (replica, via_affinity). Affinity wins when the pinned
        replica is routable and not overloaded relative to the least-
        loaded candidate; otherwise least-loaded (LRU tie-break). The
        fingerprint is (re)pinned to whatever is returned."""
        with self._mu:
            candidates = self._routable(exclude)
            if not candidates:
                return None, False
            least = min(candidates, key=lambda r: (r.load(), r.last_picked))
            chosen, warm = least, False
            if self.affinity_on and fp is not None:
                rid = self._affinity.get(fp)
                if rid is not None:
                    rep = next((r for r in candidates if r.rid == rid), None)
                    if rep is not None and (
                            rep.load() <= least.load() + AFFINITY_OVERLOAD):
                        chosen, warm = rep, True
                if len(self._affinity) >= self.max_affinity_entries \
                        and fp not in self._affinity:
                    # cheap cap: drop the oldest insertion (dict preserves
                    # insertion order); a fingerprint that matters re-pins
                    # on its next request
                    self._affinity.pop(next(iter(self._affinity)))
                self._affinity[fp] = chosen.rid
            self._pick_seq += 1.0
            chosen.last_picked = self._pick_seq
            chosen.inflight += 1
        if warm:
            ins.ROUTER_AFFINITY_HITS.inc()
        return chosen, warm

    def release(self, rep: Replica) -> None:
        with self._mu:
            rep.inflight = max(0, rep.inflight - 1)

    # ------------------------------------------------------ failover journal

    def journal_acquire(self) -> _StreamJournal:
        """One journal per live proxied stream, bounded: past the ring cap
        the stream still relays normally but starts unresumable (valid =
        False) — bounded memory beats a failover promise the router could
        only keep by buffering without limit."""
        with self._mu:
            if self._live_journals >= self.max_live_journals:
                return _StreamJournal(valid=False)
            self._live_journals += 1
            return _StreamJournal()

    def journal_release(self, js: _StreamJournal) -> None:
        if not js.counted:
            return  # cap-rejected at acquire: never held a ring slot
        js.counted = False
        with self._mu:
            self._live_journals = max(0, self._live_journals - 1)

    # -------------------------------------------------- postmortem records

    def _note_rec(self, rid: str) -> dict:
        """Get-or-create one request's postmortem record (lock held)."""
        rec = self._requests.get(rid)
        if rec is None:
            rec = self._requests[rid] = {
                "req_id": rid, "trace_id": None, "stream": None,
                "outcome": None, "retries": 0, "attempts": []}
            while len(self._requests) > self.max_request_records:
                self._requests.popitem(last=False)
        return rec

    def note_request(self, rid: str, **fields) -> None:
        """Merge scalar facts into the request's postmortem record."""
        if not rid:
            return
        with self._mu:
            rec = self._note_rec(rid)
            for k, v in fields.items():
                if v is not None:
                    rec[k] = v

    def note_attempt(self, rid: str, replica: str, kind: str,
                     outcome: str) -> None:
        """Append one routing leg (kind: forward|resume) and its verdict."""
        if not rid:
            return
        with self._mu:
            rec = self._note_rec(rid)
            rec["attempts"].append({
                "replica": replica, "kind": kind, "outcome": outcome,
                "at_ms": round((time.monotonic() - self._boot) * 1000.0, 1)})

    # ----------------------------------------------- client-perspective SLO

    @staticmethod
    def _client_window() -> dict:
        return {"ttft": WindowQuantiles(60.0, 6),
                "itl": WindowQuantiles(60.0, 6),
                "flow": WindowSums(60.0, 6)}

    def observe_client(self, rid: str, ttft_s: float | None,
                       itl_s: float | None = None) -> None:
        """Score one finished proxied request from the CLIENT's seat:
        feed the per-replica and fleet latency windows and the router
        histograms, judge against the router's SloPolicy. ``rid`` is the
        replica that delivered the scored latency (first token for TTFT;
        a failed-over stream's survivor inherits the failover gap in its
        ITL — that attribution is the point, the gap is real client
        time)."""
        if not self.fleet_obs:
            return
        if ttft_s is not None:
            ins.ROUTER_TTFT_SECONDS.observe(ttft_s)
        if itl_s is not None:
            ins.ROUTER_ITL_SECONDS.observe(itl_s)
        v = self.slo.verdict(
            None if ttft_s is None else ttft_s * 1000.0,
            None if itl_s is None else itl_s * 1000.0)
        for key in ("fleet", rid):
            w = self._client.get(key)
            if w is None:
                continue
            if ttft_s is not None:
                w["ttft"].observe(ttft_s)
            if itl_s is not None:
                w["itl"].observe(itl_s)
            w["flow"].add(finished=1, ok=1 if v["ok"] else 0)

    def _client_snapshot(self, key: str) -> dict | None:
        """Windowed client-perspective view for one replica (or "fleet")."""
        w = self._client.get(key)
        if w is None:
            return None
        out: dict = {}
        for name in ("ttft", "itl"):
            s = w[name].snapshot()
            out[name + "_ms"] = {
                "count": s["count"],
                **{p: (None if s[p] is None
                       else round(s[p] * 1000.0, 3))
                   for p in ("p50", "p95", "p99")}}
        f = w["flow"].totals()
        fin = f.get("finished", 0.0)
        out["window_finished"] = int(fin)
        out["attainment"] = (round(f.get("ok", 0.0) / fin, 6)
                             if fin else None)
        out["targets"] = {"ttft_ms": self.slo.ttft_ms,
                          "itl_ms": self.slo.itl_ms}
        return out

    def refresh_client_gauges(self) -> None:
        """Scrape-time refresh of dllama_router_slo_attainment{replica}
        (NaN when the window drained — unknown, not perfect)."""
        for key in self._client:
            snap = self._client_snapshot(key)
            att = snap["attainment"] if snap else None
            ins.ROUTER_SLO_ATTAINMENT.labels(replica=key).set(
                float("nan") if att is None else att)

    # -------------------------------------------------- fleet observability

    def _fetch(self, rep: Replica, path: str) -> tuple[int, bytes] | None:
        """One GET against one replica; None on any transport failure (a
        fleet view must degrade to the replicas it can reach, not 500)."""
        try:
            conn = http.client.HTTPConnection(rep.host, rep.port,
                                              timeout=self.connect_timeout_s)
            conn.request("GET", path)
            resp = conn.getresponse()
            data = resp.read()
            conn.close()
            return resp.status, data
        except (OSError, http.client.HTTPException):
            return None

    def _fan_out(self, jobs: list[tuple[str, Replica, str]]
                 ) -> dict[str, tuple[int, bytes] | None]:
        """Concurrent GETs: jobs are (key, replica, path) -> {key: result}.
        One short-lived thread per job — scrape fan-out is poll-cadence
        work, not request-path work, so thread churn here is fine."""
        out: dict[str, tuple[int, bytes] | None] = {}

        def one(key: str, rep: Replica, path: str) -> None:
            out[key] = self._fetch(rep, path)

        threads = [threading.Thread(target=one, args=j, daemon=True)
                   for j in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self.connect_timeout_s * 4)
        return out

    def _scrape_targets(self) -> list[Replica]:
        # live (not necessarily ready): a draining replica's metrics and
        # traces are exactly what a postmortem needs
        return [r for r in self.replicas if r.live and r.handshaken]

    def merged_trace(self) -> dict:
        """ONE Perfetto/Chrome trace for the whole mesh: the router's own
        track plus every reachable replica's export, each replica's
        timestamps shifted onto the router's clock by the poller's offset
        estimate (shift_us = (epoch_replica - offset - epoch_router) µs:
        a replica monotonic instant t maps to t - offset on the router's
        clock, and Chrome ts values are relative to each tracer's epoch)."""
        own = self.tracer.export_chrome() if self.fleet_obs else {
            "traceEvents": [], "displayTimeUnit": "ms"}
        epoch = self._boot
        parts: list[tuple[str, dict, float]] = [("router", own, 0.0)]
        clocks: dict[str, dict] = {}
        targets = self._scrape_targets()
        got = self._fan_out([(r.rid, r, "/debug/trace") for r in targets])
        for rep in targets:
            res = got.get(rep.rid)
            if res is None or res[0] != 200:
                continue
            try:
                export = json.loads(res[1])
            except ValueError:
                continue
            est = rep.clock.estimate()
            offset = est["offset_s"] if est else 0.0
            aligned = est is not None and rep.trace_epoch is not None
            rep_epoch = (rep.trace_epoch if rep.trace_epoch is not None
                         else epoch + offset)
            shift_us = (rep_epoch - offset - epoch) * 1e6
            parts.append((rep.rid, export, shift_us))
            clocks[rep.rid] = {"aligned": aligned,
                               "offset_s": offset,
                               "uncertainty_s": (est or {}).get(
                                   "uncertainty_s"),
                               "trace_epoch_s": rep.trace_epoch,
                               "shift_us": round(shift_us, 1)}
        merged = trace.merge_chrome(parts)
        merged["otherData"] = {"router_epoch_s": epoch, "clock": clocks,
                               "replicas_merged": len(parts) - 1}
        return merged

    def federate_metrics(self) -> str:
        """One exposition for the mesh: the router's own registry plus every
        replica's /metrics with each series relabeled replica=<rid>,
        counters summed and histograms merged bucket-wise into
        dllama_fleet_*. Staleness contract: a replica the scrape
        can't reach keeps federating its LAST successful exposition — its
        counters hold their last-known values instead of vanishing (which a
        fleet sum would read as traffic dropping to zero) — while
        dllama_fleet_scrape_age_seconds{replica} grows to say how stale."""
        t0 = time.monotonic()
        ins.refresh_process_gauges()
        self.refresh_client_gauges()
        targets = self._scrape_targets()
        got = self._fan_out([(r.rid, r, "/metrics") for r in targets])
        now = time.monotonic()
        for rep in targets:
            res = got.get(rep.rid)
            if res is not None and res[0] == 200:
                rep.last_metrics_text = res[1].decode("utf-8", "replace")
                rep.last_metrics_t = now
        parts = []
        for rep in self.replicas:
            if rep.last_metrics_text is None:
                continue  # never scraped successfully: nothing to hold
            ins.FLEET_SCRAPE_AGE.labels(replica=rep.rid).set(
                max(now - rep.last_metrics_t, 0.0))
            parts.append((rep.rid, rep.last_metrics_text))
        text = federate(metrics.REGISTRY.render(), parts)
        ins.FEDERATION_SCRAPE_SECONDS.observe(time.monotonic() - t0)
        return text

    def fleet(self) -> dict:
        """The mesh as one system: per-replica health + SLO attainment +
        KV/spill/radix + clock offset + client-perspective latency, and
        fleet aggregates (goodput, throughput, request-weighted SLO
        attainment, failover counters vs client-observed errors)."""
        targets = self._scrape_targets()
        jobs = []
        for r in targets:
            for path in ("/debug/perf", "/debug/kv", "/debug/radix"):
                jobs.append((f"{r.rid}{path}", r, path))
        got = self._fan_out(jobs)

        def part(rep: Replica, path: str):
            res = got.get(f"{rep.rid}{path}")
            if res is None or res[0] != 200:
                return None
            try:
                return json.loads(res[1])
            except ValueError:
                return None

        reps = []
        thr = good = 0.0
        att_num = att_den = 0.0
        for r in self.replicas:
            entry = r.snapshot()
            entry["client"] = self._client_snapshot(r.rid)
            if r in targets:
                perf = part(r, "/debug/perf") or {}
                entry["slo"] = perf.get("slo")
                entry["window"] = perf.get("window")
                entry["roofline"] = perf.get("roofline")
                entry["kv"] = part(r, "/debug/kv")
                entry["radix"] = part(r, "/debug/radix")
                roof = perf.get("roofline") or {}
                thr += float(roof.get("throughput_tok_s") or 0.0)
                good += float(roof.get("goodput_tok_s") or 0.0)
                slo = perf.get("slo") or {}
                fin = float(slo.get("window_finished") or 0.0)
                att = slo.get("attainment")
                if fin > 0 and att is not None:
                    att_num += float(att) * fin
                    att_den += fin
            reps.append(entry)
        # reconciliation block: the router's failover counters
        # next to the client-observed error count they must explain — a
        # SIGKILL drill's exhausted+unresumable failovers ARE the stream
        # errors clients saw, and chaos --mesh asserts exactly that.
        # REGISTRY.sample() reads without creating series: an outcome that
        # never happened reads 0 here without polluting the exposition.
        def cval(name: str, **labels) -> float:
            v = metrics.REGISTRY.sample(name, labels)
            return 0.0 if v is None else float(v)

        failovers = {o: cval("dllama_router_failovers_total", outcome=o)
                     for o in ("retried", "resumed", "exhausted",
                               "unresumable")}
        rids = [r.rid for r in self.replicas] + ["none"]
        client_errors = {
            "stream_error": failovers["exhausted"]
            + failovers["unresumable"],
            "shed": sum(cval("dllama_router_requests_total",
                             replica=x, outcome="shed") for x in rids),
            "upstream_error": sum(cval("dllama_router_requests_total",
                                       replica=x, outcome="error")
                                  for x in rids),
        }
        return {
            "replicas": reps,
            "mesh": {"model": self.mesh_model, "version": self.mesh_version,
                     "draining": self.draining},
            "fleet": {
                "replicas": len(self.replicas),
                "live": sum(1 for r in self.replicas if r.live),
                "ready": sum(1 for r in self.replicas
                             if r.ready and r.handshaken and r.config_ok),
                "scraped": len(targets),
                "throughput_tok_s": round(thr, 3),
                "goodput_tok_s": round(good, 3),
                "slo_attainment": (round(att_num / att_den, 6)
                                   if att_den else None),
                "window_finished": int(att_den),
                "client": self._client_snapshot("fleet"),
                "failovers": failovers,
                "client_errors": client_errors,
            },
        }

    def postmortem(self, req_id: str) -> dict | None:
        """Cross-hop join for one request: the router's routing/failover
        record + every involved replica's flight-recorder timeline."""
        with self._mu:
            rec = self._requests.get(req_id)
            if rec is not None:
                rec = dict(rec)
                rec["attempts"] = [dict(a) for a in rec["attempts"]]
        if rec is None:
            return None
        rids = []
        for a in rec["attempts"]:
            if a["replica"] not in rids:
                rids.append(a["replica"])
        by_rid = {r.rid: r for r in self.replicas}
        jobs = [(rid, by_rid[rid], f"/debug/requests/{req_id}")
                for rid in rids if rid in by_rid]
        got = self._fan_out(jobs)
        legs: dict[str, dict] = {}
        for rid in rids:
            res = got.get(rid)
            if res is None:
                legs[rid] = {"error": "unreachable"}
                continue
            status, data = res
            try:
                legs[rid] = (json.loads(data) if status == 200
                             else {"error": f"status {status}"})
            except ValueError:
                legs[rid] = {"error": "bad payload"}
        return {"req_id": req_id, "trace_id": rec.get("trace_id"),
                "router": rec, "replicas": legs}

    # ------------------------------------------------------------- snapshot

    def health(self) -> dict:
        reps = [r.snapshot() for r in self.replicas]
        ready = any(r.ready and r.handshaken and r.config_ok
                    for r in self.replicas) and not self.draining
        return {"live": True, "ready": ready,
                "status": "ok", "mode": "router",
                "draining": self.draining,
                "replicas": reps,
                "mesh": {"model": self.mesh_model,
                         "version": self.mesh_version},
                "clock": {"monotonic_s": time.monotonic(),
                          "trace_epoch_s": self._boot},
                "process": ins.refresh_process_gauges()}


class _RouterContext(_AioContext):
    """Router endpoints over the aio transport. `self.api` is the Router."""

    def do_GET(self):
        self._req_id = None
        router: Router = self.api
        if self.path in ("/health", "/health/live", "/health/ready"):
            h = router.health()
            key = "ready" if self.path.endswith("/ready") else "live"
            self._send_json(200 if h[key] else 503, h)
        elif self.path == "/router/replicas":
            self._send_json(200, {"replicas": [r.snapshot()
                                               for r in router.replicas]})
        elif self.path == "/router/trace":
            self._send_json(200, router.merged_trace())
        elif self.path in ("/metrics", "/router/metrics"):
            # the router's /metrics IS the federated view: a
            # Prometheus pointed at the router gets the whole mesh —
            # replica-labeled series, exact dllama_fleet_* rollups, and
            # the router's own series — in one scrape
            body = router.federate_metrics().encode()
            self._send_raw(
                200,
                [("Content-Type", "text/plain; version=0.0.4; charset=utf-8"),
                 ("Content-Length", str(len(body)))],
                body)
        elif self.path == "/router/fleet":
            self._send_json(200, router.fleet())
        elif self.path.startswith("/router/requests/"):
            rec = router.postmortem(self.path[len("/router/requests/"):])
            if rec is None:
                self._send_json(404, {"error": {
                    "message": "unknown or expired request id"}})
            else:
                self._send_json(200, rec)
        elif self.path == "/v1/models":
            # answered from the handshake record — the mesh serves ONE model
            # by construction, no upstream round-trip needed
            self._send_json(200, {
                "object": "list",
                "data": [{"id": router.mesh_model or "dllama-tpu",
                          "object": "model", "created": int(time.time()),
                          "owned_by": "dllama-tpu"}]})
        else:
            self._send_json(404, {"error": {"message": "not found"}})

    def do_POST(self):
        router: Router = self.api
        rid = self._req_id = new_request_id(self.headers.get("X-Request-Id"))
        try:
            raw = self._read_body()
        except (ValueError, OSError):
            self._send_json(400, {"error": {"message": "invalid request"}})
            return
        if self.path not in _PROXY_POSTS:
            self._send_json(404, {"error": {"message": "not found"}})
            return
        if router.draining:
            self._send_json(503, {"error": {"message": "router is draining"}},
                            {"Retry-After": "5"})
            ins.ROUTER_REQUESTS.labels(replica="none",
                                       outcome="shed").inc()
            return
        _proxy(router, self, raw, rid)


def _proxy(router: Router, ctx: _RouterContext, raw: bytes,
           rid: str) -> None:
    """Route one completions request: pick -> forward -> (maybe) failover.
    Runs on a pool worker; a streamed response occupies the worker for the
    stream's lifetime (upstream I/O is blocking)."""
    legacy = ctx.path in ("/v1/completions", "/completions")
    # client-perspective latency starts HERE — queueing, backoff, and
    # failover gaps between this mark and the first relayed token are
    # client time no replica's own TTFT accounts for
    t_req = time.monotonic()
    # distributed trace context: ONE trace id covers every leg
    # this request takes — the router's own spans plus each replica's, the
    # hop header carrying (trace id, parent span, hop count) downstream
    tid = trace.new_trace_id() if router.fleet_obs else ""
    router.note_request(rid, trace_id=tid or None, path=ctx.path)
    if tid:
        # mark the router tracer's flight record: export_chrome stamps the
        # trace id into every router-track event carrying this req_id
        router.tracer.req_mark(rid, trace_id=tid)
    try:
        # shed drill (faults: router.proxy): a raise here is a clean 503
        # before any replica is picked — the chaos mesh's router-shed path
        faults.fire("router.proxy")
    except faults.InjectedFault:
        ins.ROUTER_REQUESTS.labels(replica="none", outcome="shed").inc()
        router.note_request(rid, outcome="shed")
        ctx._send_json(503, {"error": {"message": "router shed (fault)"}},
                       {"Retry-After": "1"})
        return
    try:
        body = json.loads(raw or b"{}")
        if not isinstance(body, dict):
            raise ValueError
    except (ValueError, json.JSONDecodeError):
        ctx._send_json(400, {"error": {"message": "invalid JSON body"}})
        return
    stream = bool(body.get("stream"))
    router.note_request(rid, stream=stream)
    if stream:
        # mid-stream failover needs two body amendments BEFORE the first
        # attempt: frames must carry their raw token ids (the journal
        # feed), and sampled streams must have a pinned seed — an unseeded
        # stream's PRNG chain exists only on the replica that started it,
        # so nothing could replay it bit-exact after a death
        body["include_token_ids"] = True
        if body.get("seed") is None:
            body["seed"] = random.getrandbits(31)
        raw = json.dumps(body).encode()
    fp = router.fingerprint(body, legacy)
    tr = router.tracer
    tried: set[str] = set()
    busy: list[_UpstreamBusy] = []
    backoff = 0.05
    hop = [0]  # shared leg counter: the hop header's monotone hop count
    attempts = len(router.replicas) + 1
    for _ in range(attempts):
        rep, warm = router.pick(fp, exclude=tried)
        if rep is None:
            break
        tr.event("affinity.pick", cat="router", track="router", req_id=rid,
                 replica=rep.rid, warm=warm)
        try:
            _forward(router, ctx, rep, raw, rid, stream, legacy, body, fp,
                     tid, hop, t_req)
            return
        except _UpstreamBusy as e:
            # the replica is shedding (429 queue-full / 503 draining):
            # honest capacity signal, not a crash — try the next one
            busy.append(e)
            tried.add(rep.rid)
            router.note_attempt(rid, rep.rid, "forward", "busy")
            ins.ROUTER_REQUESTS.labels(replica=rep.rid,
                                       outcome="busy").inc()
        except _UpstreamDead as e:
            # connection refused/reset with ZERO client-visible bytes:
            # idempotent from the client's seat — mark down, reroute
            router._mark_down(rep, f"proxy failed: {e}")
            tried.add(rep.rid)
            router.note_attempt(rid, rep.rid, "forward", "rerouted")
            ins.ROUTER_REQUESTS.labels(replica=rep.rid,
                                       outcome="rerouted").inc()
            log.warning("request %s: replica %s failed before response "
                        "start; rerouting", rid, rep.rid,
                        extra={"request_id": rid, "replica": rep.rid,
                               "trace_id": tid})
            # jittered: after a replica kill every pinned stream lands
            # here at once — synchronized retries would hammer the same
            # survivor at the same instant (thundering herd)
            t0 = tr.now()
            time.sleep(backoff * (0.5 + random.random() / 2.0))
            tr.span_at("failover.attempt", t0, tr.now(), cat="router",
                       track="router", req_id=rid, reroute=True)
            backoff = min(backoff * 2, 1.0)
        finally:
            router.release(rep)
    # every replica tried/saturated: shed. Prefer the upstreams' own
    # Retry-After (429 beats 503 as the status when any replica exists but
    # is saturated — the client should back off and retry, not fail over).
    ins.ROUTER_REQUESTS.labels(replica="none", outcome="shed").inc()
    router.note_request(rid, outcome="shed")
    if busy:
        retry_after = max(int(e.retry_after) for e in busy)
        status = 429 if any(e.status == 429 for e in busy) else 503
        ctx._send_json(status, {"error": {
            "message": "all replicas are saturated"}},
            {"Retry-After": str(max(retry_after, 1))})
    else:
        ctx._send_json(503, {"error": {
            "message": "no ready replicas"}}, {"Retry-After": "5"})


def _forward(router: Router, ctx: _RouterContext, rep: Replica,
             raw: bytes, rid: str, stream: bool, legacy: bool,
             body: dict | None = None, fp: str | None = None,
             tid: str = "", hop: list | None = None,
             t_req: float | None = None) -> None:
    """One forwarding attempt. Raises _UpstreamDead/_UpstreamBusy while the
    attempt is still idempotent (no client-visible bytes); once a streamed
    response starts, an upstream death enters the mid-stream failover path
    (journal resume on a survivor, bounded by --failover-max) and — only
    when that is exhausted or unresumable — terminates the client stream
    cleanly with finish_reason="error" instead of raising."""
    hop = hop if hop is not None else [0]
    t_req = t_req if t_req is not None else time.monotonic()
    headers = {"Content-Type": "application/json", "X-Request-Id": rid}
    if tid:
        hop[0] += 1
        headers[trace.HOP_HEADER] = trace.format_hop(tid, "connect",
                                                     hop[0])
    tmo = ctx.headers.get("X-Request-Timeout")
    if tmo:
        headers["X-Request-Timeout"] = tmo
    tr = router.tracer
    t0 = tr.now()
    try:
        # connect under the SHORT timeout so a black-holed replica (SYN
        # dropped, no RST) fails over in ~connect_timeout_s instead of
        # holding this worker for the whole read timeout; only the
        # established socket gets the long read deadline
        conn = http.client.HTTPConnection(rep.host, rep.port,
                                          timeout=router.connect_timeout_s)
        conn.connect()
        conn.sock.settimeout(router.stream_idle_timeout_s if stream
                             else max(router.stream_idle_timeout_s, 600.0))
        conn.request("POST", ctx.path, raw, headers)
        resp = conn.getresponse()
    except (OSError, http.client.HTTPException) as e:
        # HTTPException covers a replica dying mid-status-line
        # (BadStatusLine & co.) — still zero client-visible bytes, still
        # idempotent, still a reroute
        tr.span_at("connect", t0, tr.now(), cat="router",
                   track="router", req_id=rid, trace_id=tid,
                   replica=rep.rid, hop=hop[0], ok=False)
        raise _UpstreamDead(f"{e.__class__.__name__}: {e}") from None
    tr.span_at("connect", t0, tr.now(), cat="router", track="router",
               req_id=rid, trace_id=tid, replica=rep.rid, hop=hop[0],
               ok=True)
    ctype = resp.getheader("Content-Type") or ""
    if resp.status in (429, 503):
        try:
            resp.read()  # drain so the connection closes cleanly
        except (OSError, http.client.HTTPException):
            pass  # verdict (status + Retry-After) is already in hand; a
            # replica dying after its shed headers must still shed, not
            # escape _proxy and drop the client with no response
        conn.close()
        try:
            retry_after = float(resp.getheader("Retry-After") or 1)
        except ValueError:
            retry_after = 1.0
        raise _UpstreamBusy(resp.status, retry_after)
    replica_hdr = resp.getheader("X-Replica-Id") or rep.rid
    if not (stream and resp.status == 200
            and ctype.startswith("text/event-stream")):
        # non-stream (or upstream error answered as JSON): buffer fully,
        # THEN forward — a failure mid-read leaves the attempt idempotent
        try:
            data = resp.read()
        except (OSError, http.client.HTTPException) as e:
            conn.close()
            raise _UpstreamDead(f"read failed: {e!r}") from None
        conn.close()
        hdrs = [("Content-Type", ctype or "application/json"),
                ("Content-Length", str(len(data))),
                ("X-Request-Id", resp.getheader("X-Request-Id") or rid),
                ("X-Replica-Id", replica_hdr)]
        ctx._send_raw(resp.status, hdrs, data)
        outcome = "ok" if resp.status < 500 else "error"
        router.note_attempt(rid, rep.rid, "forward", outcome)
        router.note_request(rid, outcome=outcome, status=resp.status)
        ins.ROUTER_REQUESTS.labels(replica=rep.rid, outcome=outcome).inc()
        if resp.status < 500:
            # non-stream: the whole buffered response IS the first (and
            # only) client-visible byte burst — TTFT is the full leg
            router.observe_client(rep.rid, time.monotonic() - t_req)
        return
    # ---- streamed pass-through: client-visible from the headers on
    hdrs = [("Content-Type", "text/event-stream"),
            ("Cache-Control", "no-cache"),
            ("Transfer-Encoding", "chunked"),
            ("X-Request-Id", resp.getheader("X-Request-Id") or rid),
            ("X-Replica-Id", replica_hdr)]
    ins.HTTP_RESPONSES.labels(
        endpoint="/v1/completions" if legacy else "/v1/chat/completions",
        code="200").inc()
    ctx.server.enqueue(ctx.conn, ctx._head(200, hdrs))
    _relay_with_failover(router, ctx, rep, conn, resp, rid, legacy,
                         body or {}, fp, tid, hop, t_req)


def _relay_stream(ctx: _RouterContext, resp, js: _StreamJournal,
                  max_tokens: int, marks: dict | None = None) -> str:
    """Relay one upstream SSE response frame-by-frame, feeding the journal.
    -> "done" (terminal frame relayed), "client_gone", or "died: <why>"
    (socket error, or EOF before any terminal frame). ``marks`` (shared
    across failover legs) collects client-perspective frame timing: the
    monotonic instant of the first and last relayed data frame, the frame
    count, and the replica that delivered the first frame — the router-side
    SLO windows are fed from exactly these."""
    buf = b""
    try:
        while True:
            # read1: forward whatever is available NOW. read(n) on a
            # chunked response blocks until n bytes accumulate or EOF —
            # it would hold ~100-byte token deltas (and keep-alive
            # heartbeats) hostage until the stream ended, turning the
            # router into a buffer that defeats streaming entirely
            data = resp.read1(16384)
            if not data:
                # EOF on a journaled stream that never delivered a terminal
                # frame IS a death (the old pass-through silently truncated
                # here) — a SIGKILLed replica's socket just closes
                return ("done" if js.finished
                        else "died: eof before terminal frame")
            buf += data
            # relay COMPLETE frames only (the incomplete tail waits for
            # more bytes): the journal must account a frame's ids before
            # its bytes reach the client, or a death between the two
            # would resume short and duplicate tokens
            while True:
                frame, sep, rest = buf.partition(b"\n\n")
                if not sep:
                    break
                buf = rest
                if js.note_frame(frame + sep, max_tokens):
                    ctx._write_chunk(frame + sep)
                    if (marks is not None and frame.startswith(b"data: ")
                            and frame[len(b"data: "):].strip()
                            != b"[DONE]"):
                        t = time.monotonic()
                        if marks.get("first") is None:
                            marks["first"] = t
                        marks["last"] = t
                        marks["frames"] = marks.get("frames", 0) + 1
            if ctx.conn.dead:
                return "client_gone"
    except (OSError, http.client.HTTPException) as e:
        return f"died: {e.__class__.__name__}: {e}"


def _resume_raw(body: dict, js: _StreamJournal) -> bytes:
    """The resume request body a survivor replica re-enters the stream
    with: the ORIGINAL prompt/params (max_tokens included — the replica's
    produced-counter starts at the journal length) plus the journaled
    emitted prefix and the stream identity the client already saw."""
    b2 = dict(body)
    b2["resume"] = {"tokens": list(js.tokens), "id": js.cid or "",
                    "created": int(js.created or 0)}
    b2["include_token_ids"] = True
    return json.dumps(b2).encode()


def _fail_stream(ctx: _RouterContext, rid: str, legacy: bool,
                 model: str, why: str) -> None:
    """The exactly-once terminal error sequence for an unresumable or
    exhausted stream: finish_reason="error" chunk, in-band error event,
    [DONE], chunk terminator — never a half-open socket."""
    fail = {
        "id": f"{'cmpl' if legacy else 'chatcmpl'}-{uuid.uuid4().hex[:16]}",
        "object": "text_completion" if legacy else "chat.completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [{"index": 0,
                     **({"text": ""} if legacy else {"delta": {}}),
                     "finish_reason": "error"}],
    }
    err = {"message": why, "type": "server_error", "request_id": rid}
    ctx._write_chunk(b"data: " + json.dumps(fail).encode() + b"\n\n")
    ctx._write_chunk(b"data: " + json.dumps({"error": err}).encode()
                     + b"\n\n")
    ctx._write_chunk(b"data: [DONE]\n\n")
    ctx._write_chunk(b"")


def _relay_with_failover(router: Router, ctx: _RouterContext, rep: Replica,
                         conn, resp, rid: str, legacy: bool, body: dict,
                         fp: str | None, tid: str = "",
                         hop: list | None = None,
                         t_req: float | None = None) -> None:
    """Own a streamed response end-to-end: relay + journal, and on an
    upstream death resume on a survivor (at most --failover-max times,
    capped exponential backoff with jitter, one `: retrying` comment)."""
    hop = hop if hop is not None else [0]
    t_req = t_req if t_req is not None else time.monotonic()
    tr = router.tracer
    js = router.journal_acquire()
    t_j = tr.now()  # journal hold window opens: spanned at release
    model = router.mesh_model or "dllama-tpu"
    cur_rep, cur_conn, cur_resp = rep, conn, resp
    retries = 0
    commented = False
    # frame-timing marks shared across failover legs: first/last relayed
    # data frame + count, and the replica that delivered the first frame
    # (TTFT is attributed to it; ITL to whichever replica finishes)
    marks: dict = {"first": None, "last": None, "frames": 0}

    def score_client() -> None:
        ttft = (marks["first"] - t_req if marks["first"] is not None
                else None)
        itl = ((marks["last"] - marks["first"]) / (marks["frames"] - 1)
               if marks["frames"] >= 2 else None)
        if ttft is None and itl is None:
            return
        router.observe_client(marks.get("first_rid") or cur_rep.rid,
                              ttft, itl)

    try:
        while True:
            leg_kind = "resume" if retries else "forward"
            t0 = tr.now()
            verdict = _relay_stream(ctx, cur_resp, js,
                                    router.max_journal_tokens, marks)
            if marks["first"] is not None and "first_rid" not in marks:
                marks["first_rid"] = cur_rep.rid
            tr.span_at("proxy", t0, tr.now(), cat="router",
                       track="router", req_id=rid, replica=cur_rep.rid,
                       verdict=verdict.split(":")[0],
                       tokens=len(js.tokens))
            cur_conn.close()
            if verdict == "client_gone":
                # client hung up mid-stream: stop pulling tokens; closing
                # the upstream socket makes the REPLICA's disconnect probe
                # fire and free the slot
                ins.ROUTER_REQUESTS.labels(replica=cur_rep.rid,
                                           outcome="client_gone").inc()
                router.note_attempt(rid, cur_rep.rid, leg_kind,
                                    "client_gone")
                router.note_request(rid, outcome="client_gone",
                                    retries=retries)
                return
            if verdict == "done":
                # count BEFORE the terminating chunk: the client observes
                # stream end the instant that write lands, and a scrape
                # (or test) right after must already see the outcome
                ins.ROUTER_REQUESTS.labels(replica=cur_rep.rid,
                                           outcome="ok").inc()
                if retries:
                    ins.ROUTER_FAILOVERS.labels(outcome="resumed").inc()
                router.note_attempt(rid, cur_rep.rid, leg_kind, "ok")
                router.note_request(rid, outcome="ok", retries=retries,
                                    tokens=len(js.tokens))
                score_client()
                ctx._write_chunk(b"")  # clean upstream end; end our chunks
                return
            # ---- upstream death mid-stream
            router._mark_down(cur_rep, f"died mid-stream: {verdict}")
            ins.ROUTER_REQUESTS.labels(replica=cur_rep.rid,
                                       outcome="stream_error").inc()
            router.note_attempt(rid, cur_rep.rid, leg_kind,
                                "died_mid_stream")
            log.warning("request %s: replica %s died mid-stream (%s); "
                        "journal holds %d tokens", rid, cur_rep.rid,
                        verdict, len(js.tokens),
                        extra={"request_id": rid, "replica": cur_rep.rid,
                               "trace_id": tid})
            if js.finished:
                # death AFTER the terminal frame was relayed: from the
                # client's seat the stream already ended — just close
                router.note_request(rid, outcome="ok", retries=retries)
                score_client()
                ctx._write_chunk(b"")
                return
            if not js.valid:
                ins.ROUTER_FAILOVERS.labels(outcome="unresumable").inc()
                router.note_request(rid, outcome="error_unresumable",
                                    retries=retries)
                score_client()
                _fail_stream(ctx, rid, legacy, model,
                             f"replica {cur_rep.rid} failed mid-stream")
                return
            # ---- resume on a survivor, bounded + jittered
            nxt = None
            while retries < router.failover_max and nxt is None:
                retries += 1
                t_back = tr.now()
                delay = min(0.05 * (2 ** (retries - 1)), 1.0)
                time.sleep(delay * (0.5 + random.random() / 2.0))
                cand, warm = router.pick(fp, exclude={cur_rep.rid})
                tr.span_at("failover.attempt", t_back, tr.now(),
                           cat="router", track="router", req_id=rid,
                           attempt=retries)
                if cand is None:
                    continue
                tr.event("affinity.pick", cat="router", track="router",
                         req_id=rid, replica=cand.rid, warm=warm)
                if not commented:
                    # the ONE client-visible failover artifact: an SSE
                    # comment (ignored by EventSource parsers)
                    ctx._write_chunk(b": retrying\n\n")
                    commented = True
                ins.ROUTER_FAILOVERS.labels(outcome="retried").inc()
                h2 = {"Content-Type": "application/json",
                      "X-Request-Id": rid}
                if tid:
                    # the resume leg JOINS the same trace: same id, new
                    # hop, parented under the failover span
                    hop[0] += 1
                    h2[trace.HOP_HEADER] = trace.format_hop(
                        tid, "resume", hop[0])
                t_res = tr.now()
                try:
                    c2 = http.client.HTTPConnection(
                        cand.host, cand.port,
                        timeout=router.connect_timeout_s)
                    c2.connect()
                    c2.sock.settimeout(router.stream_idle_timeout_s)
                    c2.request("POST", ctx.path, _resume_raw(body, js), h2)
                    r2 = c2.getresponse()
                    ctype2 = r2.getheader("Content-Type") or ""
                    if (r2.status != 200
                            or not ctype2.startswith("text/event-stream")):
                        # shed or rejected the resume (e.g. its own 4xx/
                        # 5xx): drain the verdict, try the next candidate
                        try:
                            r2.read()
                        except (OSError, http.client.HTTPException):
                            pass
                        c2.close()
                        router.release(cand)
                        router.note_attempt(rid, cand.rid, "resume",
                                            f"rejected_{r2.status}")
                        continue
                    nxt = (cand, c2, r2)
                    tr.span_at("resume", t_res, tr.now(),
                               cat="router", track="router", req_id=rid,
                               replica=cand.rid, hop=hop[0],
                               tokens=len(js.tokens))
                except (OSError, http.client.HTTPException) as e:
                    router._mark_down(cand, f"resume connect failed: {e!r}")
                    router.release(cand)
                    router.note_attempt(rid, cand.rid, "resume",
                                        "connect_failed")
            if nxt is None:
                ins.ROUTER_FAILOVERS.labels(outcome="exhausted").inc()
                router.note_request(rid, outcome="error_exhausted",
                                    retries=retries)
                score_client()
                log.warning("request %s: failover budget spent (%d/%d); "
                            "failing the stream exactly once", rid,
                            retries, router.failover_max,
                            extra={"request_id": rid, "trace_id": tid})
                _fail_stream(ctx, rid, legacy, model,
                             f"replica {cur_rep.rid} failed mid-stream")
                return
            # hand accounting to the survivor. The ORIGINAL pick is the
            # caller's to release (its finally does); any replica WE
            # switched to is ours — release it before taking the next
            if cur_rep is not rep:
                router.release(cur_rep)
            cur_rep, cur_conn, cur_resp = nxt
            log.info("request %s: resumed on %s at token %d", rid,
                     cur_rep.rid, len(js.tokens),
                     extra={"request_id": rid, "replica": cur_rep.rid,
                            "trace_id": tid})
    finally:
        router.journal_release(js)
        # the journal hold window as ONE span, acquire to release: its
        # length is how long this stream's resume state was live, its args
        # whether the journal could still vouch for the client's view
        tr.span_at("journal", t_j, tr.now(), cat="router", track="router",
                   req_id=rid, valid=js.valid, tokens=len(js.tokens),
                   retries=retries)
        if cur_rep is not rep:
            # _proxy's finally releases `rep`; any replica we switched to
            # is ours to release
            router.release(cur_rep)


def make_router(replicas: list[str], host: str = "127.0.0.1", port: int = 0,
                poll_s: float = 0.5, affinity: bool = True,
                workers: int | None = None,
                failover_max: int = 2,
                fleet_obs: bool = True,
                trace_capacity: int = 2048,
                slo_ttft_ms: float | None = None,
                slo_itl_ms: float | None = None
                ) -> tuple[AioHttpServer, Router]:
    """Build (server, router) without starting either — the test seam.
    Call router.start() for the handshake + poller, then serve_forever."""
    router = Router(replicas, poll_s=poll_s, affinity=affinity,
                    failover_max=failover_max, fleet_obs=fleet_obs,
                    trace_capacity=trace_capacity,
                    slo=SloPolicy(ttft_ms=slo_ttft_ms, itl_ms=slo_itl_ms))
    server = AioHttpServer((host, port), router, workers=workers or 16,
                           ctx_factory=_RouterContext)
    return server, router


def run_router(replicas: list[str], host: str = "127.0.0.1",
               port: int = 9980, poll_s: float = 0.5, affinity: bool = True,
               workers: int | None = None,
               drain_timeout_s: float = 30.0,
               failover_max: int = 2,
               fleet_obs: bool = True,
               trace_capacity: int = 2048,
               slo_ttft_ms: float | None = None,
               slo_itl_ms: float | None = None) -> int:
    """CLI entry: boot the router, install SIGTERM drain, serve forever."""
    import signal

    server, router = make_router(replicas, host, port, poll_s=poll_s,
                                 affinity=affinity, workers=workers,
                                 failover_max=failover_max,
                                 fleet_obs=fleet_obs,
                                 trace_capacity=trace_capacity,
                                 slo_ttft_ms=slo_ttft_ms,
                                 slo_itl_ms=slo_itl_ms)
    router.start()

    fired = threading.Event()

    def _term(signum, frame):
        if fired.is_set():
            return
        fired.set()
        log.info("SIGTERM: router draining (timeout %.0fs)", drain_timeout_s)

        def _drain():
            router.drain()
            deadline = time.monotonic() + drain_timeout_s
            while time.monotonic() < deadline:
                if not any(r.inflight for r in router.replicas):
                    break
                time.sleep(0.1)
            server.shutdown()

        threading.Thread(target=_drain, name="dllama-router-drain",
                         daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:  # pragma: no cover - not the main thread
        pass
    n = len(router.replicas)
    log.info("router serving on http://%s:%d over %d replica(s); "
             "affinity=%s", host, server.server_address[1], n,
             "on" if affinity else "off")
    print(f"🔀 http://{host}:{server.server_address[1]}/v1/chat/completions "
          f"(router, {n} replicas, affinity "
          f"{'on' if affinity else 'off'})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:  # pragma: no cover - interactive
        pass
    finally:
        router.stop()
        server.server_close()
    return 0
