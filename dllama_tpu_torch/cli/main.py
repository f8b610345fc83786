"""CLI frontend — the reference's `dllama` binary (dllama.cpp:207-229,
app.cpp:21-110) on PyTorch.

Modes:
  inference  one-shot generation from --prompt, with the tok/s summary
  chat       REPL with chat template + streaming EOS detection
  serve      OpenAI-compatible HTTP server (the `dllama-api` binary's role)
  info       print the model header
  router     one address over N `serve` replicas (serve/router.py): config
             handshake, health polling, prefix-affinity routing, failover
             and mid-stream failover, the fleet observability plane

Everything runs on `--device cuda` (the default) or `--device cpu`. Without
a CUDA device the CLI stops with an error unless the CPU was asked for.
`--mesh tp=4,dp=2,sp=1` (default `auto`: the JAX package's factoring, tp
capped by the kv heads and the rest on dp; `--no-mesh` pins one device)
runs tensor, sequence (ring attention), data, pipeline (GPipe stages:
inference, chat and `serve --slots 0`) and expert parallelism, one process
a rank with rank 0 driving (parallel/multihost.py), over NCCL on cards and
gloo on the CPU; `--sync` picks the tp exchange's payload, and
`--distributed --coordinator HOST:PORT --num-processes P --process-id I`
joins processes across hosts; rank 0 watches every rank's heartbeat, as
JAX's coordination service does. A mesh larger than the cards exits 2.
`serve --slots N` runs the JAX package's defaults: paged KV where the paged
kernel takes the model, the radix prefix tree on it (`--radix-cache auto`),
preemption with priority classes and tenant fair queueing (`--preempt auto`,
`--tenant-weight NAME=W`), the host-RAM spill tier when `--kv-host-pages N`
is given, and hybrid chunked prefill (`--prefill-budget auto`; 0 restores
phase-split admission). `--spec K`
(prompt-lookup speculative decoding) drives the single-engine paths, and
`serve --slots N --spec K` (or `--spec-k K`) speculates on the batched tier:
every greedy request at K unless its body's `spec_k` asks for less.
`serve --slots N --warmup auto` captures every decode, prefill and spec
program before the first request. `serve` runs on the
aio front end (`--frontend aio`, the default, as in the JAX package; `threads`
is the thread-per-connection server) and answers `/metrics` and the
`/debug/*` family; `--log-format json`, `--trace DIR` (a torch.profiler
Chrome trace of the run), `--trace-buffer N` (the request-flow tracer's
ring; 0 turns it off), `--slo-ttft-ms`/`--slo-itl-ms` and `--report` (memory
and per-token latency after `inference`) are the JAX package's. Supervision is
too: `--stall-deadline-s` (the watchdog), `--restart-max`/`--restart-window-s`
(warm restarts), `--transfer-guard` (the steady-state replays under
`torch.cuda.set_sync_debug_mode`) and `--faults` / `$DLLAMA_FAULTS` (fault
injection, utils/faults.py), on one device and on every mesh: on a mesh the
plan is rank 0's, sent to every rank, and a warm restart refills each
rank's shard. `router --replica HOST:PORT ...` needs no
`--model`: replicas own their weights. A Mixtral-style MoE `.m` runs on every
mode: `--moe` picks its expert scheme (ops.layers.moe_ffn), on both tiers.
`--dequantize` loads the Q40/Q80 matmul weights as dense bf16.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np
import torch

CACHE_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "f8": torch.float8_e4m3fn}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dllama-tpu-torch",
        description="distributed-llama inference on PyTorch + hand-written CUDA kernels",
    )
    p.add_argument("mode", choices=["inference", "chat", "serve", "info", "router"])
    # required by every mode but `router`, which owns no engine; main()
    # enforces it per mode
    p.add_argument("--model", default=None,
                   help=".m model file (required for every mode except router)")
    p.add_argument("--tokenizer", help=".t tokenizer file")
    p.add_argument("--prompt", help="prompt text (inference mode)")
    p.add_argument("--steps", type=int, default=64, help="max tokens to generate")
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--topp", type=float, default=0.9)
    p.add_argument("--presence-penalty", type=float, default=0.0)
    p.add_argument("--frequency-penalty", type=float, default=0.0)
    p.add_argument("--exact-topp", action="store_true",
                   help="reference-exact nucleus: full-vocab sort instead of the "
                        "top-256 candidate set")
    p.add_argument("--seed", type=int, default=None, help="sampler seed (default: time)")
    p.add_argument("--max-seq-len", type=int, default=None, help="clamp context length")
    p.add_argument("--max-prefill-chunk", type=int, default=256,
                   help="prefill chunk cap (pow-2 chunks)")
    p.add_argument("--cache-dtype", choices=list(CACHE_DTYPES), default="bf16",
                   help="KV cache element type; f8 (e4m3) halves the cache's "
                        "bytes (dense KV layout on a GPU)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device to run on (default cuda; there is no silent "
                        "fallback to the CPU)")
    p.add_argument("--kernels", choices=["auto", "cuda", "torch"], default="auto",
                   help="auto = the CUDA kernels on a CUDA device, plain PyTorch "
                        "on the CPU; torch = plain PyTorch everywhere")
    p.add_argument("--fuse-weights", action="store_true",
                   help="fused wqkv/w13 matmul launches")
    p.add_argument("--moe", choices=["auto", "dispatch", "sort", "dense"], default="auto",
                   help="MoE compute: capacity-bucketed dispatch (O(k) FLOPs, rare "
                        "capacity drops), sort (grouped-GEMM ragged segments — "
                        "O(k) FLOPs AND exact), or exact dense all-experts")
    p.add_argument("--dequantize", action="store_true",
                   help="load Q40 weights as bf16 (faster prefill, 4x HBM)")
    p.add_argument("--port", type=int, default=None,
                   help="HTTP port (default: 9990 in serve mode, 9980 in router mode)")
    p.add_argument("--host", default="127.0.0.1",
                   help="HTTP bind address (serve/router modes)")
    p.add_argument("--sse-heartbeat-s", type=float, default=15.0,
                   help="serve mode: `: keep-alive` frame on streams idle this long")
    p.add_argument("--replica-id", default=None,
                   help="serve mode: identity stamped on every response")
    p.add_argument("--replica", action="append", default=None, metavar="HOST:PORT",
                   help="router mode (repeatable, at least one): an engine replica to "
                        "front, a normal `serve` process; the router handshakes its "
                        "config, polls its health, and routes and fails over across the set")
    p.add_argument("--affinity", choices=["on", "off"], default="on",
                   help="router mode: prefix-affinity routing, each request's prefix "
                        "fingerprint pinned to the replica that served it last (off = "
                        "least-loaded)")
    p.add_argument("--poll-s", type=float, default=0.5,
                   help="router mode: replica /health poll cadence in seconds")
    p.add_argument("--router-workers", type=int, default=16,
                   help="router mode: worker threads (each in-flight proxied request "
                        "holds one for its upstream I/O)")
    p.add_argument("--failover-max", type=int, default=2,
                   help="router mode: resume attempts a journaled stream gets when its "
                        "replica dies mid-stream (0 = fail it once with "
                        "finish_reason=error)")
    p.add_argument("--fleet-obs", choices=["on", "off"], default="on",
                   help="router mode: trace propagation, router-side spans and clock-"
                        "offset estimation; the /router/* endpoints stay up either way")
    p.add_argument("--drain-timeout-s", type=float, default=30.0,
                   help="serve mode: on SIGTERM, give the in-flight requests this long")
    p.add_argument("--slots", type=int, default=0,
                   help="serve mode: continuous-batching slots (0 = the single-engine tier)")
    p.add_argument("--kv-layout", choices=["auto", "dense", "paged"], default="auto",
                   help="batched KV cache layout; auto = paged where the paged "
                        "attention kernel takes the configuration")
    p.add_argument("--page-size", type=int, default=128, help="paged KV: rows per page")
    p.add_argument("--kv-pages", type=int, default=0,
                   help="paged KV: pool size in pages (0 = every slot's full context)")
    p.add_argument("--max-queue", type=int, default=0,
                   help="serve mode: shed requests with 429 beyond this queue depth "
                        "(0 = unbounded)")
    p.add_argument("--stall-deadline-s", type=float, default=0.0,
                   help="serve mode, needs --slots > 0: watchdog deadline; a worker "
                        "silent this long with work in flight turns /health/live false "
                        "(0 = watchdog off)")
    p.add_argument("--restart-max", type=int, default=0,
                   help="serve mode, needs --slots > 0: on a worker crash, warm-restart "
                        "the engine in-process (cache, pools and slot state refilled in "
                        "place against the resident weights; queued requests survive, "
                        "running ones resume exactly) at most this many times per "
                        "--restart-window-s, with exponential backoff (0 = a crash is "
                        "permanent)")
    p.add_argument("--restart-window-s", type=float, default=60.0,
                   help="serve mode: the sliding window --restart-max counts restarts in")
    p.add_argument("--faults", default=None, metavar="SPEC",
                   help="arm deterministic fault injection (drills): comma-separated "
                        "point:action[:k=v...] clauses, e.g. 'engine.decode:raise:after=2' "
                        "(points and options: dllama_tpu_torch/utils/faults.py; also "
                        "$DLLAMA_FAULTS); on a mesh the plan is rank 0's and reaches "
                        "every rank")
    p.add_argument("--overlap", choices=["on", "off"], default="on",
                   help="batched tier: launch decode chunk N+1 before consuming chunk N")
    p.add_argument("--prefill-budget", default="auto", metavar="{auto,N,0}",
                   help="serve --slots > 0: hybrid chunked prefill, each decode chunk "
                        "preceded on the card by up to this many prompt tokens of an "
                        "admitting request, so a long prompt never stalls running "
                        "streams. 'auto' (default) steers the budget from the windowed "
                        "ITL against --slo-itl-ms (holds 64 with no target); an integer "
                        "pins it; 0 restores phase-split admission. Token streams are "
                        "the same under every setting")
    p.add_argument("--admit-budget-ms", type=float, default=None,
                   help="serve --slots > 0, phase-split admission only (--prefill-budget "
                        "0): the decode stall (ms) a joining prompt's prefill may insert "
                        "a visit (default 250; 0 = one prefill chunk a decode chunk)")
    p.add_argument("--admit-ttft-deadline-ms", type=float, default=None,
                   help="serve --slots > 0: joiners older than this pump their prefill "
                        "to completion despite the pacing (hard TTFT bound; default off)")
    p.add_argument("--slo-itl-ms", type=float, default=None,
                   help="serve mode: inter-token-latency SLO target in ms (mean ITL per "
                        "request): violations burn dllama_slo_violations_total{kind=itl}, "
                        "and --prefill-budget auto steers by it (default: no target)")
    p.add_argument("--slo-ttft-ms", type=float, default=None,
                   help="serve mode: TTFT SLO target in ms; terminal requests over it burn "
                        "dllama_slo_violations_total{kind=ttft} and drop out of goodput; "
                        "windowed attainment at /debug/perf (default: no target)")
    p.add_argument("--frontend", choices=["aio", "threads"], default="aio",
                   help="serve mode transport: 'aio' (default) multiplexes every "
                        "connection on one selectors event loop with a fixed worker "
                        "pool and one SSE pump thread, so the thread count does not "
                        "grow with connections; 'threads' is one thread a connection. "
                        "Routes and HTTP semantics are the same")
    p.add_argument("--aio-workers", type=int, default=0,
                   help="serve mode, --frontend aio: request-handling worker threads "
                        "(0 = min(8, cores); streams do not occupy workers)")
    p.add_argument("--log-format", choices=["text", "json"], default="text",
                   help="log line format: text, or json (one object a line, with "
                        "request_id and other context as fields)")
    p.add_argument("--trace", metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run to DIR/trace.json "
                        "(serve mode can instead capture on demand: POST /debug/profile)")
    p.add_argument("--trace-buffer", type=int, default=2048, metavar="N",
                   help="request-flow span tracer: ring capacity in events (serve mode "
                        "exports it at GET /debug/trace and GET /debug/requests); 0 turns "
                        "tracing off (default 2048)")
    p.add_argument("--report", action="store_true",
                   help="inference mode: print the memory and per-token latency report")
    p.add_argument("--radix-cache", choices=["auto", "on", "off"], default="auto",
                   help="serve --slots > 0: cross-request radix prefix tree over the paged "
                        "KV pool; admissions map the longest shared prefix by refcount and "
                        "prefill only the rest, LRU leaves are reclaimed under page "
                        "pressure. auto (default) = on whenever the KV layout is paged; "
                        "on needs it paged. Token streams are the same on or off")
    p.add_argument("--preempt", choices=["auto", "on", "off"], default="auto",
                   help="serve --slots > 0: preempt-to-pages; a running lower-priority "
                        "request is suspended at a chunk boundary when a strictly "
                        "higher-priority one is blocked (no free slot or KV pages); its "
                        "pages stay referenced and its stream resumes where it stopped. "
                        "auto = on (default)")
    p.add_argument("--kv-host-pages", type=int, default=0,
                   help="serve --slots > 0, needs the radix tree: host-RAM KV spill tier "
                        "of this many pages (0 = off), one pinned slab made at boot. Tree "
                        "eviction copies cold pages to it instead of discarding them; a "
                        "returning prompt copies them back at admission")
    p.add_argument("--tenant-weight", action="append", default=[], metavar="NAME=W",
                   help="serve --slots > 0: weighted fair queueing across tenants (the "
                        "`tenant` body field) within each priority class; repeatable, "
                        "e.g. --tenant-weight paid=4 --tenant-weight free=1; unlisted "
                        "tenants weigh 1")
    p.add_argument("--warmup", choices=["auto", "off"], default="off",
                   help="serve --slots > 0: capture every decode and prefill program "
                        "(CUDA graph) before the first request; ignored with a warning "
                        "on the single-engine tier")
    p.add_argument("--spec", type=int, default=0, metavar="K",
                   help="prompt-lookup speculative decoding with K-token drafts for "
                        "greedy runs (inference, chat, serve; a request's spec_k "
                        "clamps to K); same tokens, fewer forwards on repetitive text. "
                        "In serve mode the alias of --spec-k")
    p.add_argument("--spec-k", type=int, default=None, metavar="K",
                   help="serve mode: speculative decoding's draft length and each "
                        "request's default; with --slots > 0 the batched tier runs "
                        "K-draft verify cycles, every request speculating at K unless "
                        "its body passes its own spec_k (0..K; 0 opts out). Greedy "
                        "streams are the same spec on or off; sampled and penalized "
                        "requests ride the cycles one token at a time. Telemetry: "
                        "dllama_spec_*, the spec objects of timings and /debug/perf "
                        "(default: --spec)")
    p.add_argument("--mesh", default="auto",
                   help="device mesh spec 'tp=4,dp=2,sp=1,pp=1,ep=1' or 'auto' (all devices "
                        "on tp, capped by the kv heads, the rest on dp); one process a rank, "
                        "rank 0 drives. On the CPU ('--device cpu') each rank is a process")
    p.add_argument("--no-mesh", action="store_true", help="one device even if more exist")
    p.add_argument("--sync", choices=["bf16", "q80", "auto"], default="bf16",
                   help="tp activation exchange: bf16 (exact, default), q80 (the "
                        "reference's quantized payload), or auto (q80 only at tp=2)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host: run the same command on every host with "
                        "--coordinator, --num-processes and --process-id; process 0 drives")
    p.add_argument("--coordinator", default=None, help="host:port rendezvous of process 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--transfer-guard", choices=["off", "log", "strict"], default="off",
                   help="serve mode, needs --slots > 0: run the steady-state decode and "
                        "spec replays under torch.cuda.set_sync_debug_mode; 'strict' "
                        "makes a synchronizing operation there (a blocking upload or "
                        "read) raise, 'log' warns")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _resolve_mesh(args):
    """The mesh the command runs (engine/loader.resolve_mesh over the model
    file's header and the cards, or the processes of --distributed), or
    None for one device. An unreadable file resolves to None here and is
    reported by the load."""
    from dllama_tpu_torch.engine.loader import resolve_mesh
    from dllama_tpu_torch.models.formats import read_header

    if args.no_mesh or args.mode not in ("inference", "chat", "serve"):
        return None
    try:
        cfg, _ = read_header(args.model, args.max_seq_len)
    except (OSError, ValueError):
        return None
    return resolve_mesh(args.mesh, cfg, args.device)


def _parse_tenant_weights(specs) -> dict[str, float] | None:
    """--tenant-weight NAME=W (repeatable) -> {name: weight}; a malformed
    spec stops startup with a clear message instead of weighing 1."""
    if not specs:
        return None
    out: dict[str, float] = {}
    for spec in specs:
        name, sep, w = str(spec).partition("=")
        try:
            weight = float(w)
        except ValueError:
            weight = 0.0
        # NaN poisons every tag comparison and inf zeroes a tenant's cost
        if not sep or not name or not math.isfinite(weight) or weight <= 0:
            raise SystemExit(f"--tenant-weight {spec!r}: expected NAME=W with finite W > 0")
        out[name] = weight
    return out


def _load(args):
    from dllama_tpu_torch.engine import sampling
    from dllama_tpu_torch.engine.loader import load_model

    if args.exact_topp:
        sampling.NUCLEUS_K = None
    m = load_model(
        args.model,
        args.tokenizer,
        max_seq_len=args.max_seq_len,
        mesh=None if args.no_mesh else args.mesh,
        cache_dtype=CACHE_DTYPES[args.cache_dtype],
        max_prefill_chunk=args.max_prefill_chunk,
        dequantize=args.dequantize,
        sync=args.sync,
        kernels=args.kernels,
        moe_impl=args.moe,
        fuse_weights=args.fuse_weights,
        device=args.device,
    )
    if m.world is not None:
        if not m.world.driver:
            # a process of a --distributed world other than process 0: follow
            raise SystemExit(m.world.follow())
        m.world.link.fail_stop = True  # a dead rank ends this process non-zero
    return m


def _sampler(args):
    from dllama_tpu_torch.engine.sampling import Sampler

    return Sampler(args.temperature, args.topp,
                   args.seed if args.seed is not None else int(time.time()),
                   presence=args.presence_penalty, frequency=args.frequency_penalty)


def cmd_info(args) -> int:
    from dllama_tpu_torch.engine.kernel_select import resolve_kernels
    from dllama_tpu_torch.models.formats import read_header, tensor_plan

    cfg, header_size = read_header(args.model, args.max_seq_len)
    print(cfg.describe())
    total = sum(ft.nbytes(int(np.prod(shape))) for _, shape, ft in tensor_plan(cfg))
    print(f"header: {header_size} B, weights: {total / 1e9:.2f} GB on disk")
    sel = resolve_kernels(cfg, args.kernels, args.device)
    print(f"device: {args.device}; kernels={sel.backend} attention={sel.attn_route}")
    if cfg.n_experts:
        scheme = args.moe
        if scheme == "auto":
            scheme = ("dense (fixed shapes, every expert)" if args.device == "cuda"
                      else "sort for B*T >= experts, else dense")
        print(f"moe: {cfg.n_experts} experts, {cfg.n_active_experts} active; --moe "
              f"{args.moe}: {scheme}")
    return 0


def cmd_inference(args) -> int:
    from dllama_tpu_torch.engine.engine import GenerationStats
    from dllama_tpu_torch.utils import profiling

    if not args.prompt:
        print("inference mode requires --prompt", file=sys.stderr)
        return 1
    if not args.tokenizer:
        print("inference mode requires --tokenizer", file=sys.stderr)
        return 1
    m = _load(args)
    tok = m.tokenizer
    sampler = _sampler(args)
    prompt_tokens = tok.encode(args.prompt, add_bos=True)
    max_tokens = min(args.steps, m.engine.seq_len - len(prompt_tokens))
    stats = GenerationStats()
    timer = profiling.TokenTimer()
    tok.reset_decoder()
    with profiling.trace(args.trace):
        timer.start()
        for t in m.engine.generate(prompt_tokens, max_tokens, sampler, stop_fn=tok.is_eos,
                                   stats=stats, spec=args.spec):
            timer.stop()
            piece = tok.decode(t)
            if piece:
                print(piece, end="", flush=True)
            timer.start()
    print()
    print(stats.summary(), file=sys.stderr)
    if args.report:
        print(profiling.memory_report(m.config, m.engine.params, m.engine.cache),
              file=sys.stderr)
        print(f"⏱  {timer.summary()}", file=sys.stderr)
        tp, sp = (m.shardings.tp, m.shardings.sp) if m.shardings is not None else (1, 1)
        est = profiling.collective_bytes_per_token(
            m.config, tp=tp, sp=sp, exchange_bytes=34 / 32 if m.sync == "q80" else 2.0)
        print(f"🔗 mesh: {m.shardings.mesh.shape if m.shardings else 'one device'} "
              f"(sync {m.sync})", file=sys.stderr)
        print(f"🔗 est. inter-chip payload: {est['kb_per_token_per_chip']:.0f} "
              f"kB/token/chip (tp={tp}, sp={sp})", file=sys.stderr)
        meas = m.engine.measured_collective_report()
        ops = ", ".join(f"{k}={v / 1024:.1f}kB" for k, v in meas["per_op"].items()) or "none"
        print(f"🔗 measured in one decode step: {meas['total_bytes'] / 1024:.1f} kB ({ops})",
              file=sys.stderr)
    if args.trace:
        print(f"trace: {profiling.profile_status()['last_trace']}", file=sys.stderr)
    return 0


def cmd_chat(args) -> int:
    from dllama_tpu_torch.tokenizer.chat import (
        ChatItem,
        ChatTemplate,
        ChatTemplateType,
        TokenAssembler,
        chat_stops,
    )

    if not args.tokenizer:
        print("chat mode requires --tokenizer", file=sys.stderr)
        return 1
    m = _load(args)
    tok = m.tokenizer
    template = ChatTemplate(ChatTemplateType.UNKNOWN, tok.chat_template, "")
    stops = chat_stops(tok)
    sampler = _sampler(args)
    print("💬 chat mode — empty line or Ctrl-D to exit")
    try:
        system = input("📢 system: ").strip()
    except EOFError:
        return 0
    items: list[ChatItem] = [ChatItem("system", system)] if system else []
    first = True
    while True:
        try:
            user = input("👱 user: ").strip()
        except EOFError:
            break
        if not user:
            break
        items.append(ChatItem("user", user))
        generated = template.generate(items, append_generation_prompt=True)
        # feed only the delta: the engine's KV cache holds the history
        prompt_tokens = tok.encode(generated.content, add_bos=first)
        items = []
        first = False
        if generated.public_prompt:
            print(generated.public_prompt, end="")
        asm = TokenAssembler(tok, stops)
        print("🤖 assistant: ", end="", flush=True)
        budget = m.engine.seq_len - m.engine.pos - len(prompt_tokens) - 1
        if budget <= 0:
            print("(context window exhausted)")
            break
        for t in m.engine.generate(prompt_tokens, budget, sampler, spec=args.spec):
            print(asm.feed(t), end="", flush=True)
            if asm.eos:
                break
        else:
            print(asm.flush(), end="", flush=True)
        print()
    return 0


def cmd_serve(args) -> int:
    from dllama_tpu_torch.serve.api import run_server

    if not args.tokenizer:
        print("serve mode requires --tokenizer", file=sys.stderr)
        return 1
    prefill_budget = args.prefill_budget
    if prefill_budget != "auto":
        try:
            prefill_budget = int(prefill_budget)
        except ValueError:
            print(f"--prefill-budget must be 'auto' or an integer, got "
                  f"{prefill_budget!r}", file=sys.stderr)
            return 1
        if prefill_budget < 0:
            print("--prefill-budget must be >= 0", file=sys.stderr)
            return 1
    tenant_weights = _parse_tenant_weights(args.tenant_weight)
    m = _load(args)
    from dllama_tpu_torch.utils import profiling

    with profiling.trace(args.trace):
        return run_server(
            m, host=args.host, port=args.port if args.port is not None else 9990,
            n_slots=args.slots,
            default_temperature=args.temperature, default_topp=args.topp,
            default_seed=args.seed, frontend=args.frontend, aio_workers=args.aio_workers,
            sse_heartbeat_s=args.sse_heartbeat_s, replica_id=args.replica_id,
            drain_timeout_s=args.drain_timeout_s, kv_layout=args.kv_layout,
            page_size=args.page_size, kv_pages=args.kv_pages, max_queue=args.max_queue,
            overlap=args.overlap == "on", warmup=args.warmup,
            # --spec-k is the serving knob; --spec its alias
            spec=args.spec_k if args.spec_k is not None else args.spec,
            prefill_budget=prefill_budget, admit_stall_budget_ms=args.admit_budget_ms,
            admit_ttft_deadline_ms=args.admit_ttft_deadline_ms, slo_itl_ms=args.slo_itl_ms,
            slo_ttft_ms=args.slo_ttft_ms, radix_cache=args.radix_cache,
            kv_host_pages=args.kv_host_pages, preempt=args.preempt,
            tenant_weights=tenant_weights, stall_deadline_s=args.stall_deadline_s,
            restart_max=args.restart_max, restart_window_s=args.restart_window_s,
            transfer_guard=args.transfer_guard,
        )


def cmd_router(args) -> int:
    from dllama_tpu_torch.serve.router import run_router

    if not args.replica:
        print("router mode requires at least one --replica HOST:PORT", file=sys.stderr)
        return 1
    return run_router(
        args.replica, host=args.host, port=args.port if args.port is not None else 9980,
        poll_s=args.poll_s, affinity=args.affinity == "on", workers=args.router_workers,
        drain_timeout_s=args.drain_timeout_s, failover_max=args.failover_max,
        fleet_obs=args.fleet_obs == "on", trace_capacity=args.trace_buffer,
        slo_ttft_ms=args.slo_ttft_ms, slo_itl_ms=args.slo_itl_ms)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mode != "router" and not args.model:
        print(f"{args.mode} mode requires --model", file=sys.stderr)
        return 1
    from dllama_tpu_torch.obs import trace
    from dllama_tpu_torch.utils.logs import setup_logging

    # --log-format json switches every line to one object with request_id
    # and the other context as fields
    setup_logging(fmt=args.log_format, verbose=args.verbose)
    # the request-flow tracer, configured before anything can emit a span
    trace.configure(args.trace_buffer)
    from dllama_tpu_torch.utils import faults

    # $DLLAMA_FAULTS first, --faults wins when both are set; a bad spec
    # stops startup here rather than never firing. A process of a
    # --distributed world other than process 0 checks the spec and arms
    # nothing: its ranks follow rank 0's plan
    try:
        if args.distributed and args.process_id:
            for spec in (os.environ.get(faults.ENV_VAR), args.faults):
                faults.parse(spec or "")
        else:
            faults.configure_from_env()
            if args.faults:
                faults.configure(args.faults)
    except ValueError as e:
        print(f"fault spec: {e}", file=sys.stderr)
        return 2
    if args.mode == "router":
        return cmd_router(args)  # owns no device: the replicas do
    if args.mode != "info" and args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device was found; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 1
    from dllama_tpu_torch.parallel.mesh import MeshTooLarge

    try:
        if args.distributed:
            from dllama_tpu_torch.parallel.multihost import initialize

            initialize(args.coordinator, args.num_processes, args.process_id)
        _resolve_mesh(args)  # a mesh larger than the cards stops before a rank starts
    except MeshTooLarge as e:
        print(f"--mesh {args.mesh}: {e}", file=sys.stderr)
        return 2
    except ValueError as e:  # --distributed's settings
        print(str(e), file=sys.stderr)
        return 2
    return {
        "info": cmd_info,
        "inference": cmd_inference,
        "chat": cmd_chat,
        "serve": cmd_serve,
    }[args.mode](args)


if __name__ == "__main__":
    raise SystemExit(main())
