"""Seeded chaos soak for the port's self-healing serving stack: the
counterpart of the JAX package's ``experiments/chaos.py``.

Drives mixed traffic — greedy / sampled / penalized, staggered submission,
a fraction carrying per-request deadlines — through a warm-restart-enabled
Scheduler while a seeded injector keeps arming random faults across the
catalog (engine.decode, engine.prefill, scheduler.loop, scheduler.queue,
pool.alloc, decode.nan, pool.spill, pool.restore; raise and delay actions).
Every request streams through its token queue, exactly like an SSE client.

What a passing soak proves, asserted at the end:

* **100% terminal**: every submitted request reaches a terminal state
  (stop/length/timeout/error/cancelled — or a clean admission shed); no
  client queue ever hangs;
* **allocator integrity**: ``PagePool.audit()`` is clean — including the
  radix prefix tree's page references reconciling exactly against the pool
  refcounts (the engine runs with the paged-default radix cache ON) — and,
  after idle prefix caches and the tree are dropped, ZERO pages remain
  referenced;
* **self-healing**: ``/health`` is back to live=true/ready=true once the
  fault schedule stops;
* **counter/trace reconciliation**: dllama_engine_restarts_total,
  dllama_requests_recovered_total and finished{reason="timeout"} deltas
  each equal their flight-recorder event counts (engine.restart /
  request.recovered / request.timeout), and the timeout counter matches
  what clients actually observed.

``run_chaos`` runs on the JAX package's tiny random model (dim 64, 2
layers, vocab 96, f32), or on a `.m` file (``model``) with the bf16 cache,
on ``device``; ``run_mesh_chaos`` runs N CLI replicas of this package
behind its router. CLI::

    python -m dllama_tpu_torch.experiments.chaos --requests 200 --seed 0 --device cpu
    python -m dllama_tpu_torch.experiments.chaos --mesh 2 --requests 24 --seed 3 --device cpu

tests/test_torch_chaos.py runs a bounded mini-soak and a reduced mesh soak
through the same entry points.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

import numpy as np

#: fault points the injector cycles through. engine.restart is deliberately
#: NOT in the schedule: a raise there makes the restart itself die, which is
#: the budget-exhaustion drill (tests/test_faults.py), not a soak the stack
#: is supposed to survive.
FAULT_MENU = (
    ("engine.decode", "raise"),
    ("engine.decode", "delay"),
    ("engine.prefill", "raise"),
    ("scheduler.loop", "raise"),
    ("scheduler.queue", "raise"),
    ("pool.alloc", "raise"),
    ("decode.nan", "raise"),
    # host spill tier: a failed spill degrades to a discard, a
    # failed restore degrades to a re-prefill — never a corrupt page
    ("pool.spill", "raise"),
    ("pool.restore", "raise"),
)

#: finish reasons that count as "reached a terminal state"
TERMINAL = {"stop", "length", "timeout", "error", "cancelled", "shutdown"}


def _sample(name, labels=None) -> float:
    from dllama_tpu_torch.obs import metrics

    v = metrics.REGISTRY.sample(name, labels)
    return float(v or 0.0)


def random_params(cfg, seed: int = 0, device="cpu") -> dict:
    """The JAX package's ``models.llama.random_params(cfg, seed,
    dtype=float32, quantize=False)`` for a dense model, in this package's
    parameter tree on ``device``: the same numpy draws in the same order,
    so the same weights."""
    import torch

    rng = np.random.default_rng(seed)
    L = cfg.n_layers

    def t(a):
        return torch.from_numpy(a).to(device)

    def stack(fn):
        return t(np.stack([fn() for _ in range(L)]))

    def w(k, n):
        return (rng.standard_normal((k, n)) * 0.02).astype(np.float32)

    def ones():
        return np.ones((cfg.dim,), np.float32)

    layers = {
        "wq": stack(lambda: w(cfg.dim, cfg.dim)),
        "wk": stack(lambda: w(cfg.dim, cfg.kv_dim)),
        "wv": stack(lambda: w(cfg.dim, cfg.kv_dim)),
        "wo": stack(lambda: w(cfg.dim, cfg.dim)),
        "rms_att": stack(ones),
        "rms_ffn": stack(ones),
    }
    layers["w1"] = stack(lambda: w(cfg.dim, cfg.hidden_dim))
    layers["w2"] = stack(lambda: w(cfg.hidden_dim, cfg.dim))
    layers["w3"] = stack(lambda: w(cfg.dim, cfg.hidden_dim))
    emb = (rng.standard_normal((cfg.vocab_size, cfg.dim)) * 0.02).astype(np.float32)
    return {
        "embedding": t(emb),
        "final_norm": torch.ones(cfg.dim, dtype=torch.float32, device=device),
        "wcls": t(w(cfg.dim, cfg.vocab_size)),
        "layers": layers,
    }


def run_chaos(n_requests: int = 200, seed: int = 0, n_slots: int = 3,
              kv_pages: int = 12, page_size: int = 8, clients: int = 4,
              fault_gap_s: tuple = (0.02, 0.15),
              timeout_frac: float = 0.15, client_deadline_s: float = 120.0,
              kv_host_pages: int = 6, verbose: bool = False, device="cuda",
              model: str | None = None, max_seq_len: int | None = None) -> dict:
    """Run one seeded soak on ``device``; returns a report dict with ``ok``
    plus every assertion's inputs. Raises AssertionError on any robustness
    violation. The model is the JAX package's tiny random one (f32 weights
    and cache) unless ``model`` names a `.m` file, loaded packed with a
    bf16 cache (its context cut to ``max_seq_len``). The scheduler decodes
    its fixed ``DECODE_CHUNK`` steps a chunk (the JAX soak's ``chunk``
    argument has no counterpart)."""
    import torch

    from dllama_tpu_torch.engine.batch import BatchEngine
    from dllama_tpu_torch.engine.loader import resolve_device
    from dllama_tpu_torch.models import formats
    from dllama_tpu_torch.models.config import LlamaConfig
    from dllama_tpu_torch.obs import trace
    from dllama_tpu_torch.serve.scheduler import Scheduler, SchedulerRejected
    from dllama_tpu_torch.utils import faults

    device = resolve_device(device)
    if model is None:
        cfg = LlamaConfig(dim=64, hidden_dim=128, n_layers=2, n_heads=4,
                          n_kv_heads=2, vocab_size=96, seq_len=64)
        params = random_params(cfg, seed=3, device=device)
        cache_dtype = torch.float32
    else:
        cfg, header_size = formats.read_header(model, max_seq_len)
        params = formats.load_params(model, cfg, header_size, device=device)
        cache_dtype = torch.bfloat16
    rng = np.random.default_rng(seed)
    rng_inj = np.random.default_rng(seed + 1)

    # a soak-sized tracer: reconciliation counts flight-recorder events, so
    # nothing relevant may fall off the ring (restored in the finally)
    prev_tracer = trace.TRACER
    tracer = trace.configure(1 << 16, max_requests=max(256, 2 * n_requests))

    # kv_host_pages > 0 puts the host spill tier under the fault
    # schedule too: the undersized device pool forces radix evictions all
    # soak long, so spills/restores interleave with crashes and restarts
    eng = BatchEngine(cfg, params, n_slots=n_slots, cache_dtype=cache_dtype,
                      kv_layout="paged", page_size=page_size,
                      kv_pages=kv_pages, spec=4,
                      kv_host_pages=kv_host_pages)
    eng.pool.audit_on_release = True  # every release audited, crash-adjacent
    sched = Scheduler(eng, restart_max=1_000_000,
                      restart_window_s=2.0, restart_backoff_s=0.005)
    sched.restart_backoff_max_s = 0.05

    # metric baselines (the registry is process-global; soak asserts deltas)
    base = {
        "restarts": _sample("dllama_engine_restarts_total"),
        "recovered": _sample("dllama_requests_recovered_total"),
        "fin_timeout": _sample("dllama_requests_finished_total",
                               {"reason": "timeout"}),
        "shed_timeout": _sample("dllama_requests_shed_total",
                                {"reason": "timeout"}),
        "audit_fail": _sample("dllama_kv_audit_failures_total"),
    }

    # seeded request mix: ~half greedy, a sampled band, a penalized band, a
    # deadline band; prompts and budgets sized for the tiny pool
    specs = []
    for i in range(n_requests):
        plen = int(rng.integers(2, 14))
        greedy = rng.random() < 0.5
        specs.append(dict(
            prompt=rng.integers(1, cfg.vocab_size - 1, size=plen).tolist(),
            temperature=0.0 if greedy else float(rng.uniform(0.7, 1.2)),
            topp=float(rng.uniform(0.8, 0.95)),
            max_tokens=int(rng.integers(2, 12)),
            seed=int(rng.integers(0, 2**31)),
            presence=0.5 if rng.random() < 0.15 else 0.0,
            frequency=0.25 if rng.random() < 0.10 else 0.0,
            timeout_s=(float(rng.uniform(0.05, 0.5))
                       if rng.random() < timeout_frac else None),
            # per-request speculation: roughly half the greedy
            # band speculates, so spec cycles + plain chunks + restarts +
            # deadlines + penalties all interleave under fault injection —
            # and the release-time pool audits run with draft rows landing
            # k+1 past live positions the whole soak
            spec_k=(4 if greedy and rng.random() < 0.5 else 0),
        ))

    results: list[dict] = [None] * n_requests  # type: ignore[list-item]
    next_idx = {"i": 0}
    idx_lock = threading.Lock()
    stop_inj = threading.Event()
    fault_log: list[tuple] = []

    def injector() -> None:
        while not stop_inj.is_set():
            time.sleep(float(rng_inj.uniform(*fault_gap_s)))
            point, action = FAULT_MENU[int(rng_inj.integers(len(FAULT_MENU)))]
            kw = {"times": 1}
            if action == "delay":
                kw["ms"] = float(rng_inj.uniform(5, 40))
            faults.install(point, action, **kw)
            fault_log.append((time.monotonic(), point, action))

    def client() -> None:
        while True:
            with idx_lock:
                i = next_idx["i"]
                if i >= n_requests:
                    return
                next_idx["i"] = i + 1
            s = specs[i]
            try:
                req = sched.submit(s["prompt"], s["temperature"], s["topp"],
                                   s["max_tokens"], frozenset(),
                                   seed=s["seed"], presence=s["presence"],
                                   frequency=s["frequency"],
                                   req_id=f"req_chaos{i:05d}",
                                   timeout_s=s["timeout_s"],
                                   spec_k=s["spec_k"])
            except SchedulerRejected as e:
                # admission shed (injected queue overflow, restart-depth
                # backpressure): a clean, client-visible terminal outcome
                results[i] = {"finish": "shed", "tokens": 0,
                              "error": type(e).__name__}
                continue
            toks: list[int] = []
            err = None
            deadline = time.monotonic() + client_deadline_s
            try:
                while True:
                    item = req.out.get(
                        timeout=max(0.01, deadline - time.monotonic()))
                    if isinstance(item, BaseException):
                        err = type(item).__name__
                        break
                    if isinstance(item, int):
                        toks.append(item)
                    else:
                        break  # _END
            except Exception:
                results[i] = {"finish": "HUNG", "tokens": len(toks),
                              "error": "client drain deadline"}
                continue
            results[i] = {"finish": req.finish_reason, "tokens": len(toks),
                          "error": err}

    report: dict = {"ok": False, "requests": n_requests, "seed": seed}
    t0 = time.monotonic()
    inj = threading.Thread(target=injector, name="chaos-injector", daemon=True)
    workers = [threading.Thread(target=client, name=f"chaos-client-{c}",
                                daemon=True) for c in range(clients)]
    try:
        # warm-up BEFORE the fault schedule starts (the first programs are
        # captured here): the soak times supervision and recovery
        warm = sched.submit([1, 2, 3], 0.0, 0.9, 2, frozenset(), seed=0)
        for _ in warm.tokens():
            pass
        pen = sched.submit([4, 5], 0.9, 0.9, 2, frozenset(), seed=1,
                           presence=0.5)
        for _ in pen.tokens():
            pass
        inj.start()
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=client_deadline_s + 30.0)
        stop_inj.set()
        inj.join(timeout=5.0)
        faults.clear()

        problems: list[str] = []
        hung = [w for w in workers if w.is_alive()]
        if hung:
            problems.append(f"{len(hung)} client thread(s) never finished")

        # --- 1) every request terminal
        finishes: dict[str, int] = {}
        for i, r in enumerate(results):
            if r is None:
                problems.append(f"request {i} has no result record")
                continue
            finishes[r["finish"] or "none"] = finishes.get(
                r["finish"] or "none", 0) + 1
            if r["finish"] not in TERMINAL and r["finish"] != "shed":
                problems.append(
                    f"request {i} non-terminal: {r}")
        report["finish_reasons"] = finishes

        # --- 2) /health recovers once the fault schedule stops
        deadline = time.monotonic() + 15.0
        h = sched.health()
        while time.monotonic() < deadline:
            h = sched.health()
            if h["live"] and h["ready"]:
                break
            time.sleep(0.02)
        report["health"] = {k: h[k] for k in
                            ("live", "ready", "restarts", "crashed")}
        if not (h["live"] and h["ready"]):
            problems.append(f"/health did not recover: {report['health']}")
        else:
            # post-chaos probe: the healed engine still serves, end to end
            probe = sched.submit([9, 8, 7], 0.0, 0.9, 3, frozenset(), seed=7)
            got = sum(1 for _ in probe.tokens())
            if probe.finish_reason != "length" or got != 3:
                problems.append(
                    f"post-chaos probe broken: {probe.finish_reason}/{got}")

        # --- 3) allocator integrity: audit clean (incl. the radix prefix
        # tree's page refs reconciling against the pool refcounts), zero
        # pages leaked once idle prefix caches AND the tree are dropped
        audit = eng.pool.audit(raise_on_fail=False)
        report["audit"] = audit
        if not audit["ok"]:
            problems.append(f"pool audit failed: {audit['problems']}")
        report["radix"] = eng.radix_stats()
        report["spec"] = eng.spec_stats()  # acceptance record of the soak's
        # speculative band (cycles > 0 proves spec ran under the faults)
        for s in range(n_slots):
            if not eng.active[s]:
                eng.drop_slot_pages(s)
        if eng.radix is not None:
            eng.radix.clear()  # the tree's refs are cache, not leaks
        leaked = eng.pool.stats()["used"]
        report["pages_leaked"] = leaked
        if eng.active.any():
            problems.append("slots still active after all clients finished")
        elif leaked:
            problems.append(f"{leaked} page(s) leaked after dropping caches")
        host = eng.pool.host
        if host is not None:
            hs = host.stats()
            report["host"] = hs
            # put/take/drop bookkeeping must close: what went down minus
            # what came back (or was LRU-dropped) is exactly what's resident
            if hs["spilled"] != hs["used"] + hs["restored"] + hs["dropped"]:
                problems.append(f"host tier counters do not reconcile: {hs}")
        audit_fails = _sample("dllama_kv_audit_failures_total") - base["audit_fail"]
        report["audit_failures"] = audit_fails
        if audit_fails:
            problems.append(f"{audit_fails:.0f} audit failure(s) during soak")

        # --- 4) counters reconcile with the flight recorder
        events: dict[str, int] = {}
        for ev in tracer.export_chrome()["traceEvents"]:
            if ev.get("ph") == "i":
                events[ev["name"]] = events.get(ev["name"], 0) + 1
        d_restart = _sample("dllama_engine_restarts_total") - base["restarts"]
        d_recovered = (_sample("dllama_requests_recovered_total")
                       - base["recovered"])
        d_fin_tmo = (_sample("dllama_requests_finished_total",
                             {"reason": "timeout"}) - base["fin_timeout"])
        d_shed_tmo = (_sample("dllama_requests_shed_total",
                              {"reason": "timeout"}) - base["shed_timeout"])
        report["reconcile"] = {
            "restarts": d_restart,
            "restart_events": events.get("engine.restart", 0),
            "recovered": d_recovered,
            "recovered_events": events.get("request.recovered", 0),
            "finished_timeout": d_fin_tmo,
            "shed_timeout": d_shed_tmo,
            "timeout_events": events.get("request.timeout", 0),
            "client_timeouts": finishes.get("timeout", 0),
        }
        if d_restart != events.get("engine.restart", 0):
            problems.append("restart counter != engine.restart events: "
                            f"{report['reconcile']}")
        if d_recovered != events.get("request.recovered", 0):
            problems.append("recovered counter != request.recovered events: "
                            f"{report['reconcile']}")
        if d_fin_tmo != events.get("request.timeout", 0):
            problems.append("finished{timeout} != request.timeout events: "
                            f"{report['reconcile']}")
        if d_fin_tmo != finishes.get("timeout", 0):
            problems.append("finished{timeout} != client-observed timeouts: "
                            f"{report['reconcile']}")
        if d_shed_tmo > d_fin_tmo:
            problems.append("shed{timeout} exceeds finished{timeout}: "
                            f"{report['reconcile']}")

        report["faults_injected"] = len(fault_log)
        report["elapsed_s"] = round(time.monotonic() - t0, 2)
        report["problems"] = problems
        report["ok"] = not problems
        if verbose or problems:
            print(f"chaos: {n_requests} requests, "
                  f"{report['faults_injected']} faults, "
                  f"{report['reconcile']['restarts']:.0f} restarts, "
                  f"{report['reconcile']['recovered']:.0f} recovered, "
                  f"finishes={finishes}, leaked={leaked}, "
                  f"{report['elapsed_s']}s")
            for p in problems:
                print(f"chaos VIOLATION: {p}")
        assert not problems, "; ".join(problems)
        return report
    finally:
        stop_inj.set()
        faults.clear()
        sched.shutdown()
        trace.TRACER = prev_tracer


def tiny_files(tmp_dir: str, seed: int = 0) -> tuple[str, str]:
    """The JAX suite's tiny serving fixture (``tests/test_serve.make_tiny_files``),
    written with this package: a 263-id tokenizer with a few merges and a
    chat template, and a dim-64, 2-layer, 512-context f32 `.m` of the same
    seed's weights. -> (model path, tokenizer path)."""
    from dllama_tpu_torch.models.config import LlamaConfig
    from dllama_tpu_torch.models.formats import save_model, tensor_plan
    from dllama_tpu_torch.tokenizer.tokenizer import Tokenizer

    vocab = [bytes([i]) for i in range(256)]
    scores = [0.0] * 256
    for piece, score in {b"he": 1.0, b"ll": 2.0, b"hello": 4.0}.items():
        vocab.append(piece)
        scores.append(score)
    bos_id = len(vocab)
    vocab += [b"<s>", b"</s>"]
    scores += [0.0, 0.0]
    tok = Tokenizer(vocab, scores, bos_id, [bos_id + 1],
                    chat_template="...<|start_header_id|>...")
    tpath = os.path.join(tmp_dir, "tok.t")
    tok.save(tpath)
    cfg = LlamaConfig(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                      vocab_size=len(vocab), seq_len=512)
    rng = np.random.default_rng(seed)
    tensors = {}
    for name, shape, _ft in tensor_plan(cfg):
        if name.endswith(("rms_att", "rms_ffn")) or name == "final_norm":
            tensors[name] = np.ones(shape, np.float32)
        else:
            tensors[name] = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    mpath = os.path.join(tmp_dir, "model.m")
    save_model(mpath, cfg, tensors)
    return mpath, tpath


def run_mesh_chaos(n_replicas: int = 3, n_requests: int = 30, seed: int = 0,
                   clients: int = 3, kv_host_pages: int = 4,
                   failover_max: int = 3, boot_deadline_s: float = 420.0,
                   verbose: bool = False, device="cuda") -> dict:
    """Multi-replica chaos mesh: one router subprocess over N real
    `python -m dllama_tpu_torch serve` CLI replicas on ``device`` (the tiny
    fixture model of :func:`tiny_files`, paged KV + host spill tier), while
    a seeded scheduler of process-level faults — SIGKILL (with respawn),
    SIGSTOP/SIGCONT stalls, slow-poll windows — runs against them.
    Streaming clients verify per stream:

    * a terminal outcome ALWAYS arrives (finish_reason/error + [DONE]);
    * token positions are exactly 0..n-1 — zero duplicated, zero dropped
      tokens across however many mid-stream failovers the stream ate.

    Afterwards: every live replica's /debug/kv audit must be clean (device
    AND host tier reconciled), and the router's failover counters must
    reconcile with what the clients observed (every error-finished stream
    is exactly one exhausted/unresumable failover verdict)."""
    import http.client
    import json
    import re
    import shutil
    import signal
    import socket
    import subprocess
    import tempfile

    rng = np.random.default_rng(seed)
    tmp = tempfile.mkdtemp(prefix="dllama_chaos_mesh_")
    mpath, tpath = tiny_files(tmp)

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    ports = [free_port() for _ in range(n_replicas)]
    rport = free_port()
    # the children import this package from the same tree, one CPU thread
    # each on the CPU
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    if str(device) == "cpu":
        env["OMP_NUM_THREADS"] = "1"

    def spawn_replica(port):
        return subprocess.Popen(
            [sys.executable, "-m", "dllama_tpu_torch", "serve", "--model", mpath,
             "--tokenizer", tpath, "--slots", "2", "--port", str(port),
             "--device", str(device), "--no-mesh",
             # 56 device pages: two concurrent ~170-token chat prompts
             # (~22 pages each) fit, but retained radix prefixes don't —
             # evictions (and with the host tier on, spills) all soak long
             "--kv-layout", "paged", "--page-size", "8",
             "--kv-pages", "56", "--kv-host-pages", str(kv_host_pages)],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, env=env)

    replicas = {p: spawn_replica(p) for p in ports}
    router = subprocess.Popen(
        [sys.executable, "-m", "dllama_tpu_torch", "router", "--port", str(rport),
         *[a for p in ports for a in ("--replica", f"127.0.0.1:{p}")],
         "--poll-s", "0.2", "--failover-max", str(failover_max)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, env=env)

    def get(port, path, timeout=10):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        conn.request("GET", path)
        r = conn.getresponse()
        body = r.read().decode()
        conn.close()
        return r.status, body

    def wait_ready(deadline_s, want_all=False):
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            try:
                st, body = get(rport, "/router/replicas")
                if st == 200:
                    reps = json.loads(body)["replicas"]
                    ok = [r for r in reps if r["ready"] and r["config_ok"]]
                    if (len(ok) == n_replicas) if want_all else ok:
                        return True
            except OSError:
                pass
            time.sleep(0.25)
        return False

    report: dict = {"ok": False, "mode": "mesh", "replicas": n_replicas,
                    "requests": n_requests, "seed": seed}
    stop_chaos = threading.Event()
    chaos_log: list[tuple] = []
    mu = threading.Lock()

    def chaos_agent():
        """Seeded process-level fault schedule. Never reduces the live set
        below 2 (someone must survive to resume onto)."""
        rng_c = np.random.default_rng(seed + 99)
        while not stop_chaos.is_set():
            time.sleep(float(rng_c.uniform(1.0, 2.5)))
            if stop_chaos.is_set():
                return
            action = ("kill", "stop", "slow")[int(rng_c.integers(3))]
            with mu:
                live = [p for p, proc in replicas.items()
                        if proc.poll() is None]
                if len(live) < 2:
                    continue
                victim = live[int(rng_c.integers(len(live)))]
                proc = replicas[victim]
            if action == "kill":
                proc.kill()
                proc.wait(timeout=10)
                chaos_log.append(("kill", victim))
                time.sleep(float(rng_c.uniform(0.5, 1.5)))
                with mu:
                    replicas[victim] = spawn_replica(victim)  # rejoin later
            elif action == "stop":
                # a frozen replica: in-flight reads stall, health polls
                # time out, then the world resumes mid-flight
                try:
                    proc.send_signal(signal.SIGSTOP)
                    chaos_log.append(("stop", victim))
                    time.sleep(float(rng_c.uniform(0.3, 1.2)))
                finally:
                    try:
                        proc.send_signal(signal.SIGCONT)
                    except OSError:
                        pass
            else:
                # slow-poll window: brief freeze, long enough to make the
                # router's next poll verdict stale but not to kill streams
                try:
                    proc.send_signal(signal.SIGSTOP)
                    chaos_log.append(("slow", victim))
                    time.sleep(0.15)
                finally:
                    try:
                        proc.send_signal(signal.SIGCONT)
                    except OSError:
                        pass

    results: list[dict] = [None] * n_requests  # type: ignore[list-item]
    next_idx = {"i": 0}
    idx_lock = threading.Lock()

    def stream_one(i):
        greedy = (i % 2 == 0)
        body = {"messages": [
                    {"role": "system",
                     "content": f"mesh soak shared preamble {i % 4}"},
                    {"role": "user", "content": f"request {i}"}],
                "stream": True, "max_tokens": int(6 + (i % 6)),
                "temperature": 0.0 if greedy else 0.9,
                "seed": 1000 + i}
        conn = http.client.HTTPConnection("127.0.0.1", rport, timeout=120)
        try:
            conn.request("POST", "/v1/chat/completions", json.dumps(body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            if resp.status != 200:
                resp.read()
                return {"finish": "shed", "status": resp.status,
                        "positions_ok": True}
            raw = resp.read().decode()
        except (OSError, http.client.HTTPException) as e:
            return {"finish": "HUNG", "error": repr(e), "positions_ok": False}
        finally:
            conn.close()
        finish, err, poss = None, False, []
        for line in raw.splitlines():
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            try:
                ev = json.loads(line[6:])
            except ValueError:
                continue
            if "error" in ev:
                err = True
                continue
            if "token_ids" in ev:
                poss.extend(range(ev["position"],
                                  ev["position"] + len(ev["token_ids"])))
            fr = (ev.get("choices") or [{}])[0].get("finish_reason")
            if fr:
                finish = fr
        return {"finish": finish or ("error" if err else "NONE"),
                "done": raw.rstrip().endswith("data: [DONE]"),
                "positions_ok": poss == list(range(len(poss))),
                "tokens": len(poss)}

    def client():
        while True:
            with idx_lock:
                i = next_idx["i"]
                if i >= n_requests:
                    return
                next_idx["i"] = i + 1
            results[i] = stream_one(i)

    t0 = time.monotonic()
    procs = lambda: list(replicas.values()) + [router]  # noqa: E731
    try:
        if not wait_ready(boot_deadline_s, want_all=True):
            raise AssertionError("mesh never became ready "
                                 f"(replica boot > {boot_deadline_s:.0f}s)")
        agent = threading.Thread(target=chaos_agent, name="chaos-mesh-agent",
                                 daemon=True)
        workers = [threading.Thread(target=client, daemon=True,
                                    name=f"mesh-client-{c}")
                   for c in range(clients)]
        agent.start()
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=600.0)
        stop_chaos.set()
        agent.join(timeout=15.0)

        problems: list[str] = []
        if any(w.is_alive() for w in workers):
            problems.append("client thread(s) never finished")

        finishes: dict[str, int] = {}
        for i, r in enumerate(results):
            if r is None:
                problems.append(f"request {i} has no result record")
                continue
            finishes[r["finish"]] = finishes.get(r["finish"], 0) + 1
            if r["finish"] in ("NONE", "HUNG"):
                problems.append(f"request {i} non-terminal: {r}")
            if not r["positions_ok"]:
                problems.append(f"request {i} duplicated/dropped tokens: {r}")
        report["finish_reasons"] = finishes

        # the mesh heals: at least the floor of survivors is ready again
        if not wait_ready(60.0):
            problems.append("mesh did not recover after the fault schedule")

        # every live replica's device + host KV tiers audit clean
        audits = {}
        with mu:
            live = [p for p, proc in replicas.items() if proc.poll() is None]
        for p in live:
            # a replica respawned late in the schedule may still be
            # booting (a cold serve boot takes seconds) —
            # connection-refused within its boot window is "booting", not
            # a violation, so give each live process the boot deadline
            audit_deadline = time.monotonic() + boot_deadline_s
            while True:
                try:
                    st, body = get(p, "/debug/kv", timeout=30)
                    kv = json.loads(body)
                    audits[p] = kv.get("audit", {}).get("ok")
                    if st != 200 or audits[p] is not True:
                        problems.append(f"replica :{p} KV audit not clean")
                    break
                except (OSError, ValueError) as e:
                    with mu:
                        gone = replicas[p].poll() is not None
                    if gone or time.monotonic() > audit_deadline:
                        problems.append(
                            f"replica :{p} /debug/kv unreachable: {e!r}")
                        break
                    time.sleep(1.0)
        report["audits"] = audits

        # ---- directed failover drill ------------------------------------
        # The random schedule alone rarely lands a SIGKILL mid-stream with
        # an UNSATURATED survivor (a resume dispatched into a shedding
        # degraded mesh exhausts its budget instead of resuming), so the
        # cross-replica-trace assertion below would usually have no
        # subject. Drill it deterministically on the HEALED mesh, after
        # the random schedule has stopped: stream one request through the
        # router, SIGKILL whichever replica holds it once content frames
        # are on the wire, and require the stream to finish on the
        # survivor. Running it last also means nothing can SIGKILL the
        # survivor afterward and erase its tracer ring before the merged
        # trace is read. The drill's `resumed` verdict lands in the same
        # counters the reconciliation below scrapes.
        drill_killed = {"port": None}

        def _drill_assassin(n_frames):
            if drill_killed["port"] is None and n_frames >= 3:
                _st, body_r = get(rport, "/router/replicas")
                for rr in json.loads(body_r)["replicas"]:
                    if rr["inflight"] > 0:
                        p = int(rr["id"].rsplit(":", 1)[1])
                        with mu:
                            replicas[p].kill()
                        drill_killed["port"] = p
                        return

        if not wait_ready(boot_deadline_s, want_all=True):
            problems.append("mesh never FULLY healed — the directed "
                            "failover drill needs every replica back")
        else:
            drill_body = {"messages": [
                              {"role": "system",
                               "content": "mesh soak shared preamble drill"},
                              {"role": "user",
                               "content": "stream me a dozen tokens"}],
                          "stream": True, "max_tokens": 12,
                          "temperature": 0.0, "seed": seed + 7}
            conn = http.client.HTTPConnection("127.0.0.1", rport,
                                              timeout=120)
            try:
                conn.request("POST", "/v1/chat/completions",
                             json.dumps(drill_body),
                             {"Content-Type": "application/json",
                              "X-Request-Id": "req-mesh-drill"})
                resp = conn.getresponse()
                if resp.status != 200:
                    resp.read()
                    problems.append("failover drill shed on an idle mesh: "
                                    f"{resp.status}")
                else:
                    raw = b""
                    while True:
                        chunk = resp.read1(65536)
                        if not chunk:
                            break
                        raw += chunk
                        _drill_assassin(raw.count(b"data: "))
                    if drill_killed["port"] is None:
                        problems.append(
                            "failover drill never caught a replica inflight"
                            " — the stream finished too fast to interrupt")
                    elif (not raw.rstrip().endswith(b"data: [DONE]")
                            or b'"error"' in raw):
                        problems.append(
                            "failover drill stream did not resume cleanly "
                            f"on the survivor: {raw[-300:]!r}")
            except (OSError, http.client.HTTPException) as e:
                problems.append(f"failover drill stream broke: {e!r}")
            finally:
                conn.close()
            if drill_killed["port"] is not None:
                with mu:
                    replicas[drill_killed["port"]].wait(timeout=10)
                    replicas[drill_killed["port"]] = spawn_replica(
                        drill_killed["port"])
                chaos_log.append(("kill", drill_killed["port"]))

        # router counters reconcile with the client view: every
        # error-finished stream is exactly one exhausted/unresumable verdict
        st, mtext = get(rport, "/metrics", timeout=30)
        fov = {m.group(1): float(m.group(2)) for m in re.finditer(
            r'dllama_router_failovers_total\{outcome="(\w+)"\} ([0-9.e+-]+)',
            mtext)}
        report["failovers"] = fov
        errors_seen = finishes.get("error", 0)
        if errors_seen != fov.get("exhausted", 0) + fov.get("unresumable", 0):
            problems.append(
                f"error streams ({errors_seen}) != exhausted+unresumable "
                f"({fov})")
        if fov.get("resumed", 0) > fov.get("retried", 0):
            problems.append(f"resumed > retried: {fov}")

        # the fleet plane under fire: GET /router/fleet must
        # tell the SAME failover story as the raw counters and the client
        # view — its reconciliation block is only trustworthy if it holds
        # while replicas are dying, not just in a quiet mesh
        try:
            st, fbody = get(rport, "/router/fleet", timeout=30)
            fleet = json.loads(fbody) if st == 200 else {}
        except (OSError, ValueError) as e:
            st, fleet = 0, {}
            problems.append(f"/router/fleet unreachable: {e!r}")
        if st == 200:
            fblock = fleet.get("fleet") or {}
            ffov = fblock.get("failovers") or {}
            report["fleet_failovers"] = ffov
            for k in ("retried", "resumed", "exhausted", "unresumable"):
                if ffov.get(k) != fov.get(k, 0):
                    problems.append(
                        f"/router/fleet failovers[{k}]={ffov.get(k)} "
                        f"disagrees with /metrics ({fov.get(k, 0)})")
            cerr = fblock.get("client_errors") or {}
            if cerr.get("stream_error") != errors_seen:
                problems.append(
                    f"/router/fleet client_errors.stream_error="
                    f"{cerr.get('stream_error')} != client-observed error "
                    f"streams ({errors_seen})")
        elif st:
            problems.append(f"/router/fleet status {st}")

        # the merged mesh trace must hold >= 1 CROSS-REPLICA resumed
        # request: a `resume` span on the router track (pid 1) whose
        # req_id also has events on a replica track (pid > 1 — the
        # survivor; the original replica was SIGKILLed and respawned with
        # an empty ring, so its leg is gone by design)
        if fov.get("resumed", 0) < 1:
            problems.append("fault schedule produced no resumed stream — "
                            "the cross-replica trace check has no subject")
        else:
            try:
                st, tbody = get(rport, "/router/trace", timeout=60)
                merged = json.loads(tbody) if st == 200 else {}
            except (OSError, ValueError) as e:
                st, merged = 0, {}
                problems.append(f"/router/trace unreachable: {e!r}")
            evs = merged.get("traceEvents") or []
            resumed_ids = {e.get("args", {}).get("req_id")
                           for e in evs
                           if e.get("name") == "resume"
                           and e.get("pid") == 1
                           and e.get("args", {}).get("req_id")}
            cross = set()
            for e in evs:
                if (e.get("pid", 1) > 1 and e.get("ph") != "M"
                        and e.get("args", {}).get("req_id") in resumed_ids):
                    cross.add(e["args"]["req_id"])
            report["trace_resumed_req_ids"] = len(resumed_ids)
            report["trace_cross_replica_resumed"] = len(cross)
            if st == 200 and not cross:
                problems.append(
                    "merged /router/trace has no cross-replica resumed "
                    f"request (resume spans for {len(resumed_ids)} req_ids, "
                    "none with replica-track events)")

        report["chaos_events"] = len(chaos_log)
        report["elapsed_s"] = round(time.monotonic() - t0, 2)
        report["problems"] = problems
        report["ok"] = not problems
        if verbose or problems:
            print(f"chaos mesh: {n_requests} streams over {n_replicas} "
                  f"replicas, {len(chaos_log)} process faults "
                  f"({[e[0] for e in chaos_log]}), finishes={finishes}, "
                  f"failovers={fov}, {report['elapsed_s']}s")
            for p in problems:
                print(f"chaos mesh VIOLATION: {p}")
        assert not problems, "; ".join(problems)
        return report
    finally:
        stop_chaos.set()
        for proc in procs():
            if proc.poll() is None:
                try:
                    proc.send_signal(signal.SIGCONT)  # un-freeze first
                except OSError:
                    pass
                proc.kill()
            proc.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--kv-pages", type=int, default=12)
    ap.add_argument("--kv-host-pages", type=int, default=6)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--timeout-frac", type=float, default=0.15)
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run the MULTI-REPLICA mesh soak instead: a router "
                         "+ N real CLI replicas under randomized SIGKILL/"
                         "SIGSTOP/slow-poll; --requests then "
                         "means streamed requests through the router")
    ap.add_argument("--failover-max", type=int, default=3)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device to run on (default cuda; the replicas of --mesh too)")
    args = ap.parse_args(argv)
    try:
        if args.mesh > 0:
            report = run_mesh_chaos(
                n_replicas=args.mesh, n_requests=args.requests,
                seed=args.seed, clients=args.clients,
                kv_host_pages=args.kv_host_pages,
                failover_max=args.failover_max, verbose=True, device=args.device)
            print(f"chaos mesh PASSED (seed {args.seed}): "
                  f"{report['requests']} streams 100% terminal with zero "
                  f"duplicate/dropped tokens, audits clean, "
                  f"failovers={report['failovers']}")
            return 0
        report = run_chaos(n_requests=args.requests, seed=args.seed,
                           n_slots=args.slots, kv_pages=args.kv_pages,
                           kv_host_pages=args.kv_host_pages,
                           clients=args.clients,
                           timeout_frac=args.timeout_frac, verbose=True,
                           device=args.device)
    except AssertionError as e:
        print(f"chaos soak FAILED: {e}", file=sys.stderr)
        return 1
    print(f"chaos soak PASSED (seed {args.seed}): "
          f"{report['requests']} requests 100% terminal, audit clean, "
          f"health recovered, counters reconciled")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
