#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`dllama_tpu_torch`) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives the port's main paths at the full width of Llama-3.1-8B, Q40 and
Q80, and of Mixtral-8x7B, Q40 (random weights from a seed), and exits 0 only
if every phase passed:

1. card       the card's name and power limit (nvidia-smi), then the CUDA
              kernels built from dllama_tpu_torch/ops/csrc, one nvcc per
              source, all at once, and the native host library
              (dllama_tpu_torch/utils/csrc/native.cpp) by the host C++
              compiler; a failed build fails the run.
2. kernels    every kernel's wrapper against its plain PyTorch version on the
              card at the 8B shapes of the main path, each error beside its
              stated tolerance; CUDA-event medians of the kernel, the plain
              version and a one-call PyTorch yardstick (never used by the
              port), with the L2 cache flushed before every timed run, and
              the bound max(bytes / HBM rate, operations / bf16 tensor rate;
              K11-B's f32 products are exact on the bf16 tensor cores).
              The paged attention kernel (K9, and K8 as its read-only mode)
              also leaves the pools bit-equal to the plain scatter's. The Q80
              kernels (K5 decode, K6 prefill), RMSNorm (K10) and K7's f8 mode
              come after; then untimed edge cases of every kernel.
3. forward    a synthetic 8B Q40 `.m` + `.t` written to a temp dir and loaded
              with load_model; a 256-token prefill, 8 decode steps and a
              9-row spec verify forward (every position's logits) through
              the kernels against the same forward with the plain versions;
              then the device time of one 256-token prefill chunk through
              the kernels at cache positions 0 and 2048 (CUDA events), on
              the dense cache (K2 + K7) and on a page pool at page 128 read
              through one slot's table (K2 + K9); then the same chunks as
              captured prefill programs (64 and 256 tokens, the single
              engine's `step` and one slot's `add_step`): wall, stream and
              busy ms, and the captured slot chunk bit-equal to the
              uncaptured one.
4. serve      make_server (the function `serve` runs) over real HTTP on the
              single-engine tier: a greedy chat completion, the same again
              (identical content), an SSE stream, and a second turn that hits
              the prefix cache.
5. batch      make_server with 8 slots (`serve --slots 8`): the auto KV layout
              must be paged at page 128; 8 concurrent greedy chat requests,
              the same 8 again (identical contents), an SSE stream; every
              batched forward launches the paged attention kernel in every
              layer and the Q40 kernels, no dense flash attention; after the
              drain the page pool audits clean with every page free. The
              server admits with hybrid chunked prefill, its default (the
              check that decode ran batched, > 2 live slots a chunk in the
              first round, holds the phase-split servers: the q80 phase's
              and the hybrid phase's at budget 0).
6. hybrid     the 8-slot server booted with --warmup auto at --prefill-budget
              0, auto and 256: 7 greedy streams decoding and a ~2,048-token
              prompt joining (its TTFT, the streams' ITL with no joiner and
              during the join, live slots, hybrid chunks and tokens), then a
              burst of 8 simultaneous ~85-token chats (TTFT, live slots a
              chunk; at budget 0 more than 2); greedy contents identical
              across the budgets, the pool clean after each drain.
7. radix      the 8-slot server at its defaults (the radix prefix tree on the
              page pool at page 128, preemption, hybrid admission, --warmup
              auto) against --radix-cache off --preempt off: (a) a
              1,536-row system prompt shared by 8 user turns of 64-160
              tokens, one alone then 8 at once (TTFT p50/max, rows
              prefilled, hit tokens, peak pool pages); (b) 16 two-turn chats
              over 8 slots (turn 2's hit tokens and TTFT); (d) a priority-2
              request arriving over 8 priority-0 streams (its TTFT, the
              preemptions and the rows each resume re-prefilled; every
              stream's ids equal its uninterrupted run's); (c) on a 48-page
              pool, 48 host pages against 0: prompt A, three more that push
              A out, A again (pages spilled and restored, a page's copy ms
              each way, the host ms of a spill, A's TTFT); (e) every pool
              audits clean with the tree and host tier intact, frees every
              page after its drain, and no spill is discarded. Greedy ids
              compared across runs must be equal or first differ at a near
              tie of the plain forward's logits (printed with the margin).
8. obs        the observability stack on the 8-slot server at its defaults
              (the aio front end, --warmup auto, --trace-buffer 2048, TTFT and
              ITL SLO targets): /metrics scraped before and after a mixed run
              (8 greedy priority-0 streams; a 1 s POST /debug/profile and a
              /debug/perf read during their decode; a priority-2 arrival that
              preempts one; a burst of 16 chats beside a stream whose client
              hangs up): the token, finish-reason, TTFT, preemption and radix
              counters equal what the clients and the scheduler saw; the time
              ledger's states sum to the scheduler's wall time within 5 %
              (shares printed); the bandwidth attainment is finite in (0,
              1.05) against the card's peak; /debug/compile and /health show
              the warm-up's 21 captures and none unexpected; /debug/trace
              holds every request, the victim's preempted/resumed events and
              the priority-2 admission; the profile names K1 and K9; then 256
              SSE streams on 8 slots with dllama_process_threads bounded and
              every content equal to its prompt served alone (or apart at a
              near tie); then 8 streams' decode tokens/s on aio with tracing,
              aio with --trace-buffer 0 and the threads server.
9. inference  the CLI's `inference` mode on the same files.
10. f8         the same Q40 file loaded with the f8 (e4m3) KV cache: the
              forward against the plain versions and HTTP serve, K7's f8 mode
              in every layer of every forward.
11. q80       after the Q40 files are gone, a synthetic 8B Q80 `.m` loaded
              packed: the forward against the plain versions, the prefill
              chunk's device time (K6 + K7) as in `forward`, HTTP serve on
              the single-engine tier, the 8-slot batched server with the
              RMSNorm switch at 'cuda' (K10) and phase-split admission
              (--prefill-budget 0), and the CLI's `inference
              --fuse-weights`, whose greedy text must equal the unfused
              engine's; Q80 kernels on every forward and no Q40 launch.
12. kbench    the kernel benchmark (dllama_tpu_torch.experiments.kbench):
              `suite`, then `8 w1 B D`; no FAILED row, KBENCH DONE at the end;
              its kernels K11-B/K11-D launched.
13. styles    the Q40 8B model with q40_matmul.STYLE at maskdot, loopdot and
              deq: the forward against the plain versions, 32 greedy tokens
              through the `inference` CLI (their text printed beside auto's);
              decode forwards launch K3 (K4) in every matmul and K1 never,
              prefill chunks launch K2.
14. spec      `inference --spec 8` on a repetitive prompt (its emitted tokens
              and verify forwards printed; K1 and K7 launched); the greedy ids
              of spec 8 and spec 0 equal, or first differ at a near-tie of the
              plain run's logits; 32 tokens at --spec 8 through the captured
              verify cycles (tokens, cycles, replays) and at --spec 0 (4
              decode chunks of 8), ms a token wall, stream and device; HTTP
              serve with --spec 8 and a spec_k 0 request.
15. spec_batch the 8-slot server at its defaults with --warmup auto and
              --spec-k 4 (`serve --slots 8 --spec 4`, paged at page 128):
              8 concurrent streams of 128 tokens on repetitive prompts (two
              sampled, one sampled with penalties, one spec_k 0, one
              priority 0) and a priority-2 arrival that preempts the priority-0
              one, on two --spec-k 4 servers and a --spec-k 0 server: greedy
              ids equal across spec 4 and 0 or first apart at a near tie,
              sampled streams equal across the two spec runs, dllama_spec_* on
              /metrics equal to spec_stats() and bounding the responses' spec
              records, a preemption resumed, no unexpected capture, clean
              pools; tokens a cycle, accept mean, aggregate tok/s against the
              --spec-k 0 server; then one 8-slot verify cycle's device ms
              against one plain step's at K = 4 (40 rows: K2) and K = 1 (16
              rows: K1).
16. graphs    decode chunks as CUDA graphs (engine/graphs.py) against the same
              bodies launched from Python (`capture=False`), on the Q40 8B
              model: one stream (greedy ids and a seeded sampled stream
              equal), then eight paged slots (the same two checks); for
              each, wall ms and device ms a step (profiler) and the busy
              share, captured and not, and each kernel's launches in one
              replayed chunk exactly those of the steps it ran; the graphs
              captured and the seconds the captures took; then the CLI
              `serve --slots 8 --warmup auto` in a child process: its boot
              report (full coverage), and its first request's content equal
              to a server's without warmup.
17. supervision the 8-slot server at its defaults with --warmup auto,
              --restart-max 2 and --stall-deadline-s 2: (a) 8 streams of 128
              tokens (5 greedy, 2 sampled, 1 penalized) run once, then again
              with an engine.decode raise armed after 32 frames of the first:
              one warm restart, every stream whole (each position once, its
              budget reached), greedy ids equal to the first run's or apart
              at a near tie, /debug/kv clean, no capture after the restart;
              the crash-to-first-resumed-token ms; (b) an engine.decode
              delay past the deadline: /health/live 503, then 200,
              dllama_watchdog_stalls_total advanced; (c) decode.nan fails
              exactly one of 8 streams; (d) the engine.restart fault kills
              the restart: live false, 503; (e) the single engine: 32 greedy
              tokens, save_session, a fresh engine, load_session, 32 more,
              bit-equal to 64 uninterrupted (K1/K7); (f) a
              --transfer-guard strict server serves 8 streams, and an
              .item() put into its guarded window raises.
18. router    two CLI `serve --slots 8 --warmup auto` replicas on the card
              and the CLI `router --failover-max 2` in front: the handshake,
              4 requests sharing a system prompt on one replica, a greedy and
              a sampled stream through the router, then the same two with
              SIGKILL sent to their replica after 8 frames: both whole with
              at most one `: retrying` each, greedy ids equal to the baseline
              or apart at a near tie, the sampled stream printed, not
              compared; the gap across the failover in ms;
              dllama_router_failovers_total{outcome="resumed"} advanced; the
              survivor's /debug/kv clean; /router/metrics federating both
              replicas, /router/fleet joining them.
19. golden    tests/fixtures/golden_tiny.m (head size 16, which no attention
              kernel takes) under --kernels auto: the Q40 kernels with the
              plain attention on the single engine and on an 8-slot
              BatchEngine, 16 greedy tokens each equal to the JAX package's
              pinned continuation or first apart at a near tie.
20. dequantize the Q40 8B file loaded with --dequantize (dense bf16 weights,
              torch.matmul): its forward within TOL_FWD of the kernels', no
              Q40 launch; then the CLI's `inference --dequantize`.
21. moe       Mixtral-8x7B at its published widths, depth cut to MOE_LAYERS
              (8 of 32) for the smoke's deadline (random Q40 weights from
              seed 0, 7.1 GB, context cut to 4096; cut further only where the
              temp filesystem cannot hold the file, and then printed): the
              forward against the plain versions, HTTP serve on the
              single-engine tier, --moe dense against sort and dispatch
              (greedy ids), the 8-slot server at its defaults with --warmup
              auto (no unexpected capture, a clean pool), each forward at
              least (4 + 3E)L + 1 Q40 launches and K7 or K9 in every layer
              (a replayed chunk exactly that), then a captured decode step
              at 1 and 8 slots and a 256-token chunk, wall, stream and busy,
              and their device time split by launch order: expert products,
              projections, attention, the MoE FFN's plain operations.
22. mesh      tensor parallelism at tp=2 on the 8B widths cut to 8 layers, Q40
              (one card: both ranks on it over gloo, exchanges staged
              through host memory, programs eager; two or more: NCCL,
              captured): logits, ids of
              the single engine and 8 dense slots, each rank's launches and
              exchange bytes, then the checks' power on a 2-layer model of
              codes of mean 0 with two faults planted in the exchange.
23. mesh_dp_sp the dp and sp axes on the 8B Q40 file, every rank on this
              card over gloo (a harness): the CLI refusing --mesh dp=2 and
              sp=2 by the device count; dp=2 with 8 dense slots (ids, each
              replica's launches, the ranks' digests); dp=2 x tp=2 logits;
              sp=2 through a 2,000-token prefill, a chunk across the shard
              boundary (the ring) and 8 decode steps (the LSE merge); a
              dropped partial planted in the merge on the power model.
24. mesh_pp_ep the pp and ep axes on the same file (pp=2, tp=2 x pp=2,
              pp_micro=2; with moe, Mixtral at ep=2 and ep=2 x tp=2), every
              rank on this card over gloo, and two faults planted in the
              stage hop and the expert partials.
25. mesh_supervision supervision on a mesh, the same file, every rank on this
              card over gloo (a harness): (a) a tp=2 4-slot dense Scheduler
              with restart_max=2: 4 greedy streams of 64 tokens, then again
              with engine.decode:raise armed after 16 chunks (rank 0's plan,
              fired on every rank): one warm restart, every stream whole,
              ids equal to the first run's or apart at a near tie, the
              ranks' digests equal, no capture after the restart, and the
              crash-to-first-resumed-token ms; (b) decode.nan fails exactly
              one of 4 streams; (c) 32 greedy tokens, save_session on tp=2
              and on pp=2, load_session into the unsharded engine, 32 more,
              against 64 on one device (equal or apart at a near tie), and
              a session saved on one device loaded on pp=2 and continued
              there; the seconds of each save and load; (d) each rank's
              K1/K2/K7 launches.
26. tools     the port's tools at Llama-3.1-8B's widths (depth cut to 8
              layers): (a) the native host library built from
              dllama_tpu_torch/utils/csrc with the host compiler (a failed
              build fails); (b) an HF `tokenizer.json` in the Llama-3 layout
              (128,000 regular ids, >= 20,000 of them BPE pieces learned from
              the repository's Markdown, the 256 specials, the smoke's chat
              template) converted by `convert_tokenizer hf`, encode timed at
              2,000 / 8,000 / 32,000 bytes natively and at 2,000 through the
              Python fallback, the ids equal; (c) a BF16 safetensors
              checkpoint of Llama-3.1-8B's published config.json at 8 layers
              (two shards and an index, seed 0) converted to Q40 by
              `convert_hf`, its header checked and four tensors' bytes equal
              to the DLLAMA_NATIVE=0 path's; (d) the `.m` cut into two
              file:// parts behind a zoo entry: `launch download` (bytes
              equal), then the command `launch run` prints, `inference
              --steps 8` (K1/K2/K7); (e) the CLI's `serve --slots 8 --warmup
              auto` on the downloaded files (paged: K1/K2/K9): an
              8,000-byte system prompt of repository text, one chat alone
              and 8 at once, the server's tokenization ms, TTFT, every
              greedy id sequence equal to the single engine's greedy
              replay or apart at a near tie; (f) the chaos drill
              (experiments/chaos.run_chaos) on the file: 24 requests, 8
              paged slots at page 8, the tree and the host tier on,
              captured programs, seeded faults and warm restarts: ok, no
              page leaked.
27. analysis  the port's invariant analyzer (dllama_tpu_torch/analysis): (a)
              `python -m dllama_tpu_torch.analysis --json` on this checkout
              in a child process, no finding, its seconds, torch and jax
              not loaded; (b) its seeded-violation drill
              (analysis.smoke: the pristine copy passes, four seeded
              violations caught at their file:line); (c) a child process
              with DLLAMA_LOCK_AUDIT=1 serving 8 concurrent chats through
              the 8-slot server with --warmup auto on the Q40 8B file: no
              LockOrderError, the page pool's lock audited at rank 20,
              every capture-ledger function in COMPILE_FNS, no capture
              after the warm-up, every device_state() tensor at its
              warm-up address to the end (the runtime half of dev-state),
              K1/K2/K9 launched; beside it the static lock graph's edges.

Every path runs its decode and prefill chunks as captured CUDA graphs (the
engines' default on a card); a replay adds the launches its capture recorded to each
wrapper's count, so the launch counts below are counted through replays.
The q80 phase also profiles one 8-slot chunk with the CUDA RMSNorm (K10's
device time inside the graph).

The kernels phase also holds K1 and K5 (the decode body csrc/decode.cuh)
against the plain version of their own arithmetic (exact-code partials,
TOL_K34) besides the bf16-weight plain versions, and each row of an m-row
call bit-equal to the row alone, for K3 and K4 (the same body in its Maskdot
and Loopdot styles) too; K3 and K4 against their plain versions and against
K1, K4 bit-equal under the geometries of 78, 114 and 132 SMs, K3 and K4 one
device kernel a call under the profiler, and K11-B/K11-D against theirs on
both their routes (the decode body at m <= 16, the wgmma loop above: m = 16
and 17, an f32 x for K11-B, k = 4104 for K11-D, one device kernel a call);
K1 at 9 rows and K7 at 9 query rows (the spec verify forward); and
every kernel the kbench phase launches on kbench's own inputs (each variant
of its suite rows and of `8 w1 B D`, the tile sweep, the flash rows), since
the benchmark checks no result. `serve`, `batch`, `hybrid`, `radix`, `obs`, `supervision`, `f8`,
`q80`, `kbench`, `styles`, `spec`, `spec_batch`, `golden`, `dequantize`, `mesh`, `mesh_dp_sp`,
`mesh_pp_ep`, `mesh_supervision`, `moe` and the tools phase's `tools-inference`,
`tools-serve`, `tools-chaos` and `analysis` (counted in its audit-armed child) are the
main paths: the launch counters are zeroed
just before each of their runs and read just after it. The `router` phase's kernels run in its
replica processes, whose counters this process cannot read: its entry in `launches_by_path` is
null. Not in the default: `profile` adds a torch.profiler pass
over one single-stream and one 8-slot decode chunk (device time and
operations a step, K1's share, and no split-k second pass; then one
single-stream chunk under STYLE maskdot and loopdot); `chunk` runs only the
prefill-chunk timings (Q40 dense and paged, uncaptured and as programs, then
Q80), so that they can be taken from another checkout of the package as
well.

The line before the last is the card's name and power limit; before that, one
JSON object lists every ported kernel with its numbers; the last line is
{"ok": true, "device": {...}}. Options cut the run for quicker checks.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import http.client
import io
import json
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time

HBM_BYTES_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
BF16_OPS_S = 989e12  # H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
TOL_K1 = 5e-3  # x max|ref|: exact codes + f32 scales vs a bf16-rounded weight
TOL_K2 = 2e-3  # x max|ref|: the same bf16 weights, only the order of sums differs
TOL_K7 = 2e-3  # absolute: both f32 from the same bf16 inputs
TOL_FWD = 5e-2  # x max|logit|: the K1-vs-plain rounding compounds over 32 layers
TOL_K9 = 2e-3  # absolute, as K7: both f32 from the same bf16 (or f32) inputs
# K5/K6 take K1's/K2's tolerances for the same reasons (TOL_K1, TOL_K2); the
# f8 mode of K7 takes TOL_K7: both sides widen the same e4m3 bytes to f32
TOL_K10 = 2.0 ** -7  # x max|ref|: one bf16 ulp at the largest value (a sum
# order or 1/sqrt vs rsqrt can move one rounding across a tie)
TOL_K34 = 1e-4  # x max|ref|: K3/K4 vs their plain versions and vs K1, all f32
# sums of the same exact-code products, only the order differs
TOL_K11 = 1e-4  # x max|ref|: K11-B/K11-D vs plain, the same f32 products
N_LAYERS_8B = 32
#: the batched decode cases' slot positions: 8 slots, up to the last row of 4096
SPREAD = [0, 127, 128, 1000, 2047, 2900, 3500, 4095]
#: batch phase: one request at a time would give exactly 1 live slot a chunk
MIN_BATCH_SLOTS = 2.0
SERVE_KERNELS = ("q40_decode", "q40_prefill", "flash_attention")
Q40_KERNELS = ("q40_decode", "q40_prefill", "q40_maskdot", "q40_loopdot")
#: kernel of each forced decode style of q40_matmul.STYLE
STYLE_KERNELS = {"maskdot": "q40_maskdot", "loopdot": "q40_loopdot", "deq": "q40_prefill"}
Q80_KERNELS = ("q80_decode", "q80_prefill")
#: graphs phase: decode tokens a stream for the id checks, steps of a timed
#: chunk (one stream: generate's chunk; 8 slots: the scheduler's DECODE_CHUNK)
GRAPH_TOKENS = 32
GRAPH_CHUNK = {"single": 8, "batch": 4}
#: the captured prefill chunks timed (forward/chunk phases): token widths and
#: cache positions
PROGRAM_WIDTHS = (64, 256)
PROGRAM_POSITIONS = (0, 2048)
#: prefill programs `--warmup auto` captures at the CLI's --max-prefill-chunk
#: 256: the widths 1, 2, 4, ..., 256
PREFILL_WIDTHS = 9
#: clock cycles of the spin kernel that holds a timed chunk back until the
#: host has enqueued it (~50 ms at the H100's 1.98 GHz)
SPIN_CYCLES = 100_000_000
#: kernel -> (case of its row, source, TPU kernel it replaces, main path that
#: launches it; None: no path routes it, as in the JAX package)
KERNEL_ROWS = {
    "q40_decode": ("w1 4096x14336 m=1", "dllama_tpu_torch/ops/csrc/q40_decode.cu",
                   "dllama_tpu/ops/pallas/q40_matmul.py:143", "batch"),
    "q40_prefill": ("w1 4096x14336 m=256", "dllama_tpu_torch/ops/csrc/q40_prefill.cu",
                    "dllama_tpu/ops/pallas/q40_matmul.py:125", "batch"),
    "flash_attention": ("T=1 pos=4095 S=4096 group=4",
                        "dllama_tpu_torch/ops/csrc/flash_attention.cu",
                        "dllama_tpu/ops/pallas/flash_attention.py:49", "serve"),
    "paged_attention": ("decode B=8 fused scatter", "dllama_tpu_torch/ops/csrc/paged_attention.cu",
                        "dllama_tpu/ops/pallas/paged_attention.py:95", "batch"),
    "paged_flash_attention": ("read-only decode B=8",
                              "dllama_tpu_torch/ops/csrc/paged_attention.cu",
                              "dllama_tpu/ops/pallas/flash_attention.py:257", None),
    "q80_decode": ("w1 4096x14336 m=1", "dllama_tpu_torch/ops/csrc/q80_decode.cu",
                   "dllama_tpu/ops/pallas/q80_matmul.py:47", "q80"),
    "q80_prefill": ("w1 4096x14336 m=256", "dllama_tpu_torch/ops/csrc/q80_prefill.cu",
                    "dllama_tpu/ops/pallas/q80_matmul.py:29", "q80"),
    "rms_norm": ("m=1 x 4096", "dllama_tpu_torch/ops/csrc/rms_norm.cu",
                 "dllama_tpu/ops/pallas/rms_norm.py:23", "q80"),
    "flash_attention_f8": ("T=1 pos=4095 S=4096 group=4 f8 cache",
                           "dllama_tpu_torch/ops/csrc/flash_attention.cu",
                           "dllama_tpu/ops/pallas/flash_attention.py:49", "f8"),
    "q40_maskdot": ("w1 4096x14336 m=1", "dllama_tpu_torch/ops/csrc/q40_maskdot.cu",
                    "dllama_tpu/ops/pallas/q40_matmul.py:208", "styles-maskdot"),
    "q40_loopdot": ("w1 4096x14336 m=1", "dllama_tpu_torch/ops/csrc/q40_loopdot.cu",
                    "dllama_tpu/ops/pallas/q40_matmul.py:234", "styles-loopdot"),
    "kbench_fma_f32": ("w1 4096x14336 m=8", "dllama_tpu_torch/ops/csrc/kbench_fma_f32.cu",
                       "experiments/kbench.py:40", "kbench"),
    "kbench_bf16_gemm": ("w1 4096x14336 m=8", "dllama_tpu_torch/ops/csrc/kbench_bf16_gemm.cu",
                         "experiments/kbench.py:66", "kbench"),
}


_PHASE_MARK = [time.perf_counter()]


def phase_done(name: str, phases=None) -> None:
    """Print the seconds since the previous phase ended, and the device
    memory tensors still hold, when `name` ran."""
    import gc

    import torch

    now = time.perf_counter()
    gc.collect()  # an engine and its programs' bodies refer to each other
    if phases is None or name in phases:
        print(f"phase {name}: {now - _PHASE_MARK[0]:.1f} s, "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated", flush=True)
    _PHASE_MARK[0] = now


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def mm_per_forward(cfg) -> int:
    """Matmul kernel launches a forward makes at the least: wq, wk, wv, wo
    and the feed-forward's w1, w3, w2 a layer (an MoE layer: each expert's
    three, every expert), then wcls."""
    return (4 + 3 * max(1, cfg.n_experts)) * cfg.n_layers + 1


def llama31_8b(n_layers: int, weight_type: str = "Q40"):
    from dllama_tpu_torch.models.config import LlamaConfig, RopeType
    from dllama_tpu_torch.ops.quant import FloatType

    return LlamaConfig(
        dim=4096, hidden_dim=14336, n_layers=n_layers, n_heads=32, n_kv_heads=8,
        vocab_size=128256, seq_len=131072, rope_theta=500000.0,
        rope_type=RopeType.LLAMA3_1, rope_scaling_factor=8.0,
        rope_scaling_low_freq_factor=1.0, rope_scaling_high_freq_factor=4.0,
        rope_scaling_orig_max_seq_len=8192, weight_type=FloatType[weight_type])


# ------------------------------------------------------------------ timing


class Timer:
    """CUDA-event median of `reps` runs after `warmup`, the L2 cache
    flushed (a 256 MB write) before each timed run, as a decode step finds
    each weight cold. A spin kernel after the flush keeps the card busy
    while the host enqueues the timed call, so the events measure device
    time, not the wrapper's Python."""

    def __init__(self, device, reps: int, warmup: int = 3):
        import torch

        self.reps, self.warmup = reps, warmup
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device=device)

    def __call__(self, fn) -> float | None:
        import torch

        if self.reps <= 0:
            return None
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            # ~2 ms of clock cycles: longer than the slowest wrapper takes to
            # enqueue its launches (the paged prefill's plain pre-scatter)
            torch.cuda._sleep(4_000_000)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def bound_ms(nbytes: float, ops: float, ops_s: float = BF16_OPS_S) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / ops_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _r(v):
    return None if v is None else round(v, 6)


# ------------------------------------------------------------ phase 2


def random_q40(gen, lead, k, n, device):
    """Random packed nibbles + small positive f16 scales (the JAX package's
    random_params_fast recipe), stacked over `lead`."""
    import torch

    from dllama_tpu_torch.ops.quant import QTensor

    packed = torch.randint(0, 256, (*lead, k // 2, n), generator=gen, device=device,
                           dtype=torch.uint8)
    scales = (torch.rand((*lead, k // 32, n), generator=gen, device=device) * 0.02
              + 1e-3).to(torch.float16)
    return QTensor(packed, scales)


def random_q80(gen, lead, k, n, device):
    """Random int8 codes over the whole range, -128 included, and small
    positive f16 scales, stacked over `lead`."""
    import torch

    from dllama_tpu_torch.ops.quant import Q8Tensor

    codes = torch.randint(-128, 128, (*lead, k, n), generator=gen, device=device,
                          dtype=torch.int8)
    codes.view(-1)[:: 4099] = -128
    scales = (torch.rand((*lead, k // 32, n), generator=gen, device=device) * 0.02
              + 1e-3).to(torch.float16)
    return Q8Tensor(codes, scales)


def report(kernel: str, case: dict) -> None:
    exact = (f" exact-code err {case['err_exact']:.3e} <= {case['tol_exact']:.3e}"
             if "err_exact" in case else "")
    total = f"  sum {case['sum_ms']}" if "sum_ms" in case else ""
    print(f"  {kernel:18s} {case['case']:36s} err {case['max_abs_err']:.3e} <= tol "
          f"{case['tol']:.3e}{exact}  ms {case['ms']}  plain {case['plain_ms']}  lib "
          f"{case['library_ms']}{total}  bound {case['bound_ms']:.4f} ({case['bound_by']})",
          flush=True)
    if not case["max_abs_err"] <= case["tol"]:
        fail(f"{kernel} {case['case']}: max error {case['max_abs_err']} over {case['tol']}")
    if not case.get("err_exact", 0.0) <= case.get("tol_exact", 0.0):
        fail(f"{kernel} {case['case']}: {case['err_exact']} from the exact-code plain version, "
             f"over {case['tol_exact']}")


def exact_plain(kernel: str):
    """The plain version of a decode kernel's own arithmetic (exact-code
    partials per 32-row block, scaled and summed in f32): K1 shares K3's."""
    from dllama_tpu_torch.ops import q40_matmul, q80_matmul

    return {"q40_decode": q40_matmul.q40_maskdot_plain,
            "q80_decode": q80_matmul.q80_blockdot_plain}[kernel]


def exact_check(kernel: str, got, x, w, layer, label: str) -> tuple[float, float]:
    """K1/K5 output `got` (f32) against the exact-code plain version at
    TOL_K34 -> (error, tolerance); fails past it."""
    import torch

    ref = exact_plain(kernel)(x, w, layer, out_dtype=torch.float32)
    err, tol = (got - ref).abs().max().item(), TOL_K34 * ref.abs().max().item()
    if not err <= tol:
        fail(f"{label}: {err} from the exact-code plain version, over {tol}")
    return err, tol


def matmul_cases(cfg, device, timer, gen, fmt: str, plan, layer: int = 1, tp: int = 1) -> dict:
    """The decode and prefill kernels of weight format `fmt` ('q40': K1/K2,
    'q80': K5/K6) at the 8B shapes of `plan` [(kernel, weight, m)], each
    weight stacked [L=2] with layer 1 used; K2 at m <= 16 under STYLE deq.
    Each case must launch its own kernel. ``tp`` > 1: one rank's shard of
    each weight on a tp mesh (out dim / tp for wq, wk, w1, wcls; in dim /
    tp for w2), the case named "tp=N"."""
    import torch

    from dllama_tpu_torch.ops import q40_matmul, q80_matmul
    from dllama_tpu_torch.ops.quant import slice_leaf

    mod, rand, weight_bytes = {"q40": (q40_matmul, random_q40, 0.5),
                               "q80": (q80_matmul, random_q80, 1.0)}[fmt]
    kernel_fn, plain_fn = getattr(mod, f"{fmt}_matmul"), getattr(mod, f"{fmt}_matmul_plain")
    d, f, kvd, v = cfg.dim, cfg.hidden_dim, cfg.kv_dim, cfg.vocab_size
    weights = {"wq": (d, d // tp), "wk": (d, kvd // tp), "w1": (d, f // tp),
               "w2": (f // tp, d), "wcls": (d, v // tp)}
    tag = f"tp={tp} " if tp > 1 else ""
    results: dict[str, list] = {}
    for kernel, name, m in plan:
        k, n = weights[name]
        w = rand(gen, (2,), k, n, device)
        x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        decode = kernel.endswith("_decode")
        # the prefill kernel at decode row counts: the deq style (K2 only)
        deq = not decode and m <= mod.DECODE_MAX_M
        assert decode == (m <= mod.DECODE_MAX_M) or (deq and kernel == "q40_prefill")
        with (q40_matmul.forced_style("deq") if deq else contextlib.nullcontext()):
            before = mod.LAUNCHES[kernel]
            got = kernel_fn(x, w, layer, out_dtype=torch.float32)
            if mod.LAUNCHES[kernel] != before + 1:
                fail(f"{kernel} {name} m={m}: another kernel was launched")
            ref = plain_fn(x, w, layer, out_dtype=torch.float32)
            torch.cuda.synchronize()
            wd = slice_leaf(w, layer).dequantize(torch.bfloat16)
            nbytes = m * k * 2 + int(k * n * weight_bytes) + (k // 32) * n * 2 + m * n * 2
            b, by = bound_ms(nbytes, 2.0 * m * k * n)
            case = dict(case=f"{tag}{name} {k}x{n} m={m}{' deq' if deq else ''}",
                        max_abs_err=(got - ref).abs().max().item(),
                        tol=(TOL_K1 if decode else TOL_K2) * ref.abs().max().item(),
                        ms=timer(lambda: kernel_fn(x, w, layer)),
                        plain_ms=timer(lambda: plain_fn(x, w, layer)),
                        library_ms=timer(lambda: torch.matmul(x, wd)),
                        bound_ms=b, bound_by=by)
            if decode:  # K1/K5 also against their own arithmetic, exact codes
                ex = exact_plain(kernel)(x, w, layer, out_dtype=torch.float32)
                case.update(err_exact=(got - ex).abs().max().item(),
                            tol_exact=TOL_K34 * ex.abs().max().item())
                del ex
        report(kernel, case)
        results.setdefault(kernel, []).append(case)
        del w, wd, x, got, ref
    return results


def rms_norm_cases(cfg, device, timer) -> dict:
    """K10 on bf16 rows of the model width, against its plain version."""
    import torch
    import torch.nn.functional as F

    from dllama_tpu_torch.ops.layers import rms_norm_plain
    from dllama_tpu_torch.ops.rms_norm import rms_norm

    gen = torch.Generator(device=device).manual_seed(4)
    d, eps = cfg.dim, cfg.norm_epsilon
    w = 1.0 + 0.1 * torch.randn((d,), generator=gen, device=device)
    cases = []
    for m in (1, 8, 256):
        x = (torch.randn((m, d), generator=gen, device=device) * 3).to(torch.bfloat16)
        got, ref = rms_norm(x, w, eps), rms_norm_plain(x, w, eps)
        torch.cuda.synchronize()
        wb = w.to(torch.bfloat16)
        b, by = bound_ms(2 * m * d * 2 + d * 4, 4.0 * m * d)
        case = dict(case=f"m={m} x {d}", max_abs_err=(got.float() - ref.float()).abs().max().item(),
                    tol=TOL_K10 * ref.float().abs().max().item(),
                    ms=timer(lambda: rms_norm(x, w, eps)),
                    plain_ms=timer(lambda: rms_norm_plain(x, w, eps)),
                    library_ms=timer(lambda: F.rms_norm(x, (d,), wb, eps)),
                    library="F.rms_norm with the weight in bf16", bound_ms=b, bound_by=by)
        report("rms_norm", case)
        cases.append(case)
    return {"rms_norm": cases}


def flash_f8_cases(cfg, device, timer) -> dict:
    """K7's f8 mode: bf16 q over an e4m3 cache [1, Hkv, 4096, hd]."""
    import torch
    import torch.nn.functional as F

    from dllama_tpu_torch.ops.flash_attention import flash_gqa_attention
    from dllama_tpu_torch.ops.layers import gqa_attention

    gen = torch.Generator(device=device).manual_seed(5)
    hq, hkv, hd, s = cfg.n_heads, cfg.n_kv_heads, cfg.head_size, 4096
    f8 = torch.float8_e4m3fn
    kc = torch.randn((1, hkv, s, hd), generator=gen, device=device).to(f8)
    vc = torch.randn((1, hkv, s, hd), generator=gen, device=device).to(f8)
    cases = []
    for t, pos in ((1, 4095), (256, 2048)):
        q = torch.randn((1, t, hq, hd), generator=gen, device=device).to(torch.bfloat16)
        got = flash_gqa_attention(q, kc, vc, pos, out_dtype=torch.float32)
        ref = gqa_attention(q.float(), kc.float(), vc.float(), pos)
        torch.cuda.synchronize()
        live = pos + t
        # the yardstick reads a bf16 copy of the live rows, made here (untimed)
        qt, kl, vl = (q.transpose(1, 2), kc[:, :, :live].to(torch.bfloat16),
                      vc[:, :, :live].to(torch.bfloat16))
        mask = (torch.arange(live, device=device)[None, :]
                <= pos + torch.arange(t, device=device)[:, None])
        nbytes = 2 * q.numel() * 2 + 2 * hkv * live * hd * 1
        b, by = bound_ms(nbytes, 4.0 * hd * hq * sum(pos + i + 1 for i in range(t)))
        case = dict(case=f"T={t} pos={pos} S={s} group={hq // hkv} f8 cache",
                    max_abs_err=(got - ref).abs().max().item(), tol=TOL_K7,
                    ms=timer(lambda: flash_gqa_attention(q, kc, vc, pos)),
                    plain_ms=timer(lambda: gqa_attention(q, kc, vc, pos)),
                    library_ms=timer(lambda: F.scaled_dot_product_attention(
                        qt, kl, vl, attn_mask=mask, enable_gqa=True)),
                    library="sdpa(enable_gqa) over a bf16 copy of the live f8 rows",
                    bound_ms=b, bound_by=by)
        report("flash_attention_f8", case)
        cases.append(case)
    return {"flash_attention_f8": cases}


def phase_kernels(cfg, device, timer, layer=1):
    """Each kernel against its plain version at the main path's shapes.
    Returns {kernel: [case dicts]}."""
    import torch
    import torch.nn.functional as F

    from dllama_tpu_torch.ops.flash_attention import flash_gqa_attention
    from dllama_tpu_torch.ops.layers import gqa_attention

    gen = torch.Generator(device=device).manual_seed(0)
    names = ("wq", "wk", "w1", "w2", "wcls")
    # m = 9: the spec verify forward (k + 1 rows at --spec 8)
    plan = [("q40_decode", name, m) for name in names for m in (1, 8, 9)]
    plan += [("q40_prefill", name, m) for name in ("w1", "w2") for m in (32, 256)]
    # m = 40: the batched verify forward at 8 slots and --spec-k 4 (K2's route)
    plan += [("q40_prefill", "w1", 40)]
    # narrow n (split-k) and wq at a chunk; the deq style's decode rows
    plan += [("q40_prefill", "wk", 256), ("q40_prefill", "wq", 256),
             ("q40_prefill", "w1", 1), ("q40_prefill", "w1", 16)]
    results = matmul_cases(cfg, device, timer, gen, "q40", plan, layer)
    # one rank's shards on a tp=2 mesh (the mesh phase's shapes): wq n=2048,
    # w2 k=7168, wcls n=64128, as a decode step and a 256-token chunk
    tp2 = [(kernel, name, m) for kernel, m in (("q40_decode", 1), ("q40_prefill", 256))
           for name in ("wq", "w2", "wcls")]
    for kernel, cases in matmul_cases(cfg, device, timer, gen, "q40", tp2, layer,
                                      tp=2).items():
        results[kernel] += cases
    results["flash_attention"] = []

    hq, hkv, hd, s = cfg.n_heads, cfg.n_kv_heads, cfg.head_size, 4096
    group = hq // hkv
    kc = torch.randn((1, hkv, s, hd), generator=gen, device=device).to(torch.bfloat16)
    vc = torch.randn((1, hkv, s, hd), generator=gen, device=device).to(torch.bfloat16)
    for t, pos, cache_dtype, heads in (
            (1, 0, torch.bfloat16, 1), (1, 1000, torch.bfloat16, 1),
            (1, 4095, torch.bfloat16, 1), (256, 0, torch.bfloat16, 1),
            (256, 2048, torch.bfloat16, 1), (9, 1000, torch.bfloat16, 1),
            (64, 0, torch.bfloat16, 1), (128, 0, torch.bfloat16, 1),
            (256, 3840, torch.bfloat16, 1),
            (1, 1000, torch.float32, 1),  # T=9: a spec verify forward
            # one rank's heads on a tp=2 mesh: 16 query and 4 kv heads
            (1, 1000, torch.bfloat16, 2), (256, 0, torch.bfloat16, 2)):
        nq, nkv = hq // heads, hkv // heads  # one rank's heads at tp=heads
        q = torch.randn((1, t, nq, hd), generator=gen, device=device).to(torch.bfloat16)
        kc, vc = kc.to(cache_dtype), vc.to(cache_dtype)
        kh, vh = kc[:, :nkv], vc[:, :nkv]
        got = flash_gqa_attention(q, kh, vh, pos, out_dtype=torch.float32)
        ref = gqa_attention(q.float(), kh.float(), vh.float(), pos)
        torch.cuda.synchronize()
        live = pos + t
        qt, kl, vl = q.transpose(1, 2).to(kh.dtype), kh[:, :, :live], vh[:, :, :live]
        mask = (torch.arange(live, device=device)[None, :]
                <= pos + torch.arange(t, device=device)[:, None])
        nbytes = 2 * q.numel() * 2 + 2 * nkv * live * hd * kh.element_size()
        ops = 4.0 * hd * nq * sum(pos + i + 1 for i in range(t))
        b, by = bound_ms(nbytes, ops)
        tag = "" if cache_dtype == torch.bfloat16 else " f32 cache"
        if heads > 1:
            tag += f" tp={heads} heads {nq}/{nkv}"
        case = dict(case=f"T={t} pos={pos} S={s} group={group}{tag}",
                    max_abs_err=(got - ref).abs().max().item(), tol=TOL_K7,
                    ms=timer(lambda: flash_gqa_attention(q, kh, vh, pos)),
                    plain_ms=timer(lambda: gqa_attention(q, kh, vh, pos)),
                    library_ms=timer(lambda: F.scaled_dot_product_attention(
                        qt, kl, vl, attn_mask=mask, enable_gqa=True)),
                    bound_ms=b, bound_by=by)
        report("flash_attention", case)
        results["flash_attention"].append(case)

    # K9 and K8 over a page pool at page 128 (Llama-3.1-8B's heads, bf16)
    results["paged_attention"], results["paged_flash_attention"] = [], []
    some_inactive = [True, False, True, True, False, True, False, True]
    # the batched spec verify forward: 8 slots of K+1 = 5 rows at mixed
    # positions, one slot inactive (its rows go to the trash page)
    spec_pos = [0, 127, 128, 1000, 2047, 2900, 3500, 4091]
    spec_active = [True, True, True, True, True, False, True, True]
    for kernel, label, b, t, pos, active in (
            ("paged_attention", "spec verify B=8 T=5 fused scatter, 1 inactive", 8, 5,
             spec_pos, spec_active),
            ("paged_attention", "decode B=8 fused scatter", 8, 1, SPREAD, None),
            ("paged_attention", "decode B=8 fused scatter, 3 inactive", 8, 1, SPREAD,
             some_inactive),
            ("paged_attention", "decode B=8 fused scatter, all pos=4095", 8, 1, [4095] * 8,
             None),
            ("paged_attention", "prefill T=256 pos=0 pre-scatter", 1, 256, [0], None),
            ("paged_attention", "prefill T=256 pos=2048 pre-scatter", 1, 256, [2048], None),
            ("paged_attention", "prefill T=256 pos=3840 pre-scatter", 1, 256, [3840], None),
            ("paged_flash_attention", "read-only decode B=8", 8, 1, SPREAD, None)):
        case = paged_case(gen, device, timer, kernel, label, b, t, hq, hkv, hd, 128,
                          s // 128, pos, active, torch.bfloat16)
        results[kernel].append(case)
    plan = [("q80_decode", name, m) for name, m in (("wq", 1), ("wk", 1), ("w1", 1),
                                                    ("w1", 8), ("w2", 1), ("wcls", 1),
                                                    ("wk", 8), ("w2", 8), ("wcls", 8))]
    plan += [("q80_prefill", name, m) for name, m in (("w1", 32), ("w1", 256), ("w2", 256),
                                                      ("wq", 256), ("wk", 256))]
    results.update(matmul_cases(cfg, device, timer, torch.Generator(device=device).manual_seed(3),
                                "q80", plan, layer))
    results.update(rms_norm_cases(cfg, device, timer))
    results.update(flash_f8_cases(cfg, device, timer))
    return results


def paged_inputs(gen, device, b, t, hq, hkv, hd, page, nb, dtype, q_dtype=None):
    """q, pools with a trash page, shuffled tables and new rows."""
    import torch

    def rnd(*shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=device).to(dt)

    n_pool = b * nb + 1
    tables = torch.randperm(n_pool - 1, generator=gen, device=device)[: b * nb]
    return (rnd(b, t, hq, hd, dt=q_dtype or dtype), rnd(n_pool, hkv, page, hd),
            rnd(n_pool, hkv, page, hd), tables.reshape(b, nb).to(torch.int32),
            rnd(b, hkv, t, hd), rnd(b, hkv, t, hd))


def paged_check(kernel, q, kp, vp, tables, pos, nk, nv, active):
    """One call of K9 (with the new rows when given) or K8 against its plain
    version on copies of the pools -> (max |out error| in f32, pools equal)."""
    import torch

    from dllama_tpu_torch.models.llama import _paged_cache_update
    from dllama_tpu_torch.ops.flash_attention import paged_flash_gqa_attention
    from dllama_tpu_torch.ops.layers import paged_gqa_attention
    from dllama_tpu_torch.ops.paged_attention import paged_decode_attention

    kk, vk, kr, vr = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    f32 = torch.float32
    if kernel == "paged_flash_attention":
        got = paged_flash_gqa_attention(q, kk, vk, tables, pos, out_dtype=f32)
    elif nk is None:
        got = paged_decode_attention(q, kk, vk, tables, pos, out_dtype=f32)
    else:
        got, _, _ = paged_decode_attention(q, kk, vk, tables, pos, nk, nv, active,
                                           out_dtype=f32)
        _paged_cache_update(kr, nk, tables, pos, active)
        _paged_cache_update(vr, nv, tables, pos, active)
    ref = paged_gqa_attention(q.float(), kr.float(), vr.float(), tables, pos)
    torch.cuda.synchronize()
    same = torch.equal(kk, kr) and torch.equal(vk, vr)
    return (got - ref).abs().max().item(), same


def paged_case(gen, device, timer, kernel, label, b, t, hq, hkv, hd, page, nb, pos, active,
               dtype) -> dict:
    """A K9/K8 case at the main path's shapes: the kernel against its plain
    version (pools bit-equal, output within TOL_K9), then timed beside the
    plain version and SDPA over a contiguous copy of the same live rows."""
    import torch
    import torch.nn.functional as F

    from dllama_tpu_torch.ops.flash_attention import paged_flash_gqa_attention
    from dllama_tpu_torch.ops.layers import paged_view
    from dllama_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_plain,
    )

    q, kp, vp, tables, nk, nv = paged_inputs(gen, device, b, t, hq, hkv, hd, page, nb, dtype)
    if kernel == "paged_flash_attention":
        nk = nv = None
    posv = torch.tensor(pos, dtype=torch.int32, device=device)
    act = None if active is None else torch.tensor(active, device=device)
    err, same = paged_check(kernel, q, kp, vp, tables, posv, nk, nv, act)
    if not same:
        fail(f"{kernel} {label}: the pools differ from the plain scatter's")
    if not err <= TOL_K9:
        fail(f"{kernel} {label}: max error {err} over {TOL_K9}")

    if kernel == "paged_flash_attention":
        def run():
            return paged_flash_gqa_attention(q, kp, vp, tables, posv)
    else:
        def run():
            return paged_decode_attention(q, kp, vp, tables, posv, nk, nv, act)
    # the library yardstick reads a contiguous copy of the live rows, made
    # here (untimed), padded to the longest slot and masked per row
    live = max(pos) + t
    kc = paged_view(kp, tables)[:, :, :live].contiguous()
    vc = paged_view(vp, tables)[:, :, :live].contiguous()
    mask = (torch.arange(live, device=device)[None, None, None, :]
            <= posv[:, None, None, None] + torch.arange(t, device=device)[None, None, :, None])
    qt = q.transpose(1, 2)
    rows = [p + t for p in pos]
    nbytes = (q.numel() * 2 * q.element_size() + 2 * hkv * hd * sum(rows) * kp.element_size()
              + tables.numel() * 4 + posv.numel() * 4)
    if nk is not None:  # the new rows, read once and written once
        nbytes += 4 * nk.numel() * nk.element_size()
    ops = 4.0 * hd * hq * sum(p + i + 1 for p in pos for i in range(t))
    bnd, by = bound_ms(nbytes, ops)
    case = dict(case=label, max_abs_err=err, tol=TOL_K9, pools_bit_equal=same,
                ms=timer(run),
                plain_ms=timer(lambda: paged_decode_attention_plain(
                    q, kp, vp, tables, posv, nk, nv, act)),
                library_ms=timer(lambda: F.scaled_dot_product_attention(
                    qt, kc, vc, attn_mask=mask, enable_gqa=True)),
                library="sdpa(enable_gqa) over a contiguous copy of the live rows",
                bound_ms=bnd, bound_by=by)
    print(f"  {kernel:15s} {label:36s} err {err:.3e} <= tol {TOL_K9:.0e}  pools equal  "
          f"ms {case['ms']}  plain {case['plain_ms']}  lib {case['library_ms']}  "
          f"bound {bnd:.4f} ({by})", flush=True)
    return case


def phase_edges(device) -> None:
    """Untimed checks of the kernels' edge paths, which the 8B shapes never
    take: row counts between template sizes, ragged n (with and without
    aligned loads), an odd number of 32-row blocks of k, a 2-D weight,
    head size 64, a ragged cache length, per-row positions, f32 q/cache."""
    import torch

    from dllama_tpu_torch.ops.flash_attention import flash_gqa_attention
    from dllama_tpu_torch.ops.layers import gqa_attention
    from dllama_tpu_torch.ops.q40_matmul import forced_style as q40_forced_style
    from dllama_tpu_torch.ops.q40_matmul import q40_matmul, q40_matmul_plain

    gen = torch.Generator(device=device).manual_seed(2)
    f32 = torch.float32
    for m, k, n, stacked, style in ((12, 4096, 4096, True, "auto"), (3, 4128, 1000, True, "auto"),
                                    (5, 256, 1002, False, "auto"), (16, 4096, 1024, True, "auto"),
                                    (100, 4128, 1000, True, "auto"),
                                    (40, 512, 1003, False, "auto"),
                                    (33, 4096, 1000, True, "auto"),
                                    (1, 4128, 1000, True, "deq"), (16, 512, 1003, False, "deq")):
        w = random_q40(gen, (2,) if stacked else (), k, n, device)
        layer = 1 if stacked else None
        x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        with q40_forced_style(style):
            got = q40_matmul(x, w, layer, out_dtype=f32)
        ref = q40_matmul_plain(x, w, layer, out_dtype=f32)
        tol = (TOL_K1 if m <= 16 and style == "auto" else TOL_K2) * ref.abs().max().item()
        err = (got - ref).abs().max().item()
        exact = ""
        if m <= 16 and style == "auto":  # K1 also against its own arithmetic
            e2, t2 = exact_check("q40_decode", got, x, w, layer, f"q40 edge m={m} k={k} n={n}")
            exact = f", exact-code err {e2:.3e} <= {t2:.3e}"
        print(f"  edge q40 m={m} k={k} n={n}{'' if stacked else ' 2-D'}"
              f"{' deq' if style == 'deq' else ''}: err {err:.3e} <= tol {tol:.3e}{exact}",
              flush=True)
        if not err <= tol:
            fail(f"q40 edge m={m} k={k} n={n}: max error {err} over {tol}")
    for b, t, hq, hkv, hd, s, pos, dt in (
            (2, 1, 8, 4, 64, 1000, [5, 900], torch.bfloat16),
            (2, 7, 8, 4, 64, 1000, [0, 990], torch.bfloat16),
            (1, 3, 4, 1, 128, 130, 70, f32)):
        q = torch.randn((b, t, hq, hd), generator=gen, device=device).to(dt)
        kc = torch.randn((b, hkv, s, hd), generator=gen, device=device).to(dt)
        vc = torch.randn((b, hkv, s, hd), generator=gen, device=device).to(dt)
        pv = torch.tensor(pos, dtype=torch.int32, device=device) if isinstance(pos, list) else pos
        got = flash_gqa_attention(q, kc, vc, pv, out_dtype=f32)
        ref = gqa_attention(q.float(), kc.float(), vc.float(), pv)
        err = (got - ref).abs().max().item()
        print(f"  edge flash B={b} T={t} heads={hq}/{hkv} hd={hd} S={s} pos={pos} {dt}: "
              f"err {err:.3e} <= tol {TOL_K7:.0e}", flush=True)
        if not err <= TOL_K7:
            fail(f"flash edge B={b} T={t} hd={hd} S={s}: max error {err} over {TOL_K7}")
    # paged: small and odd pages, head size 64, f32 pools, a chunk across a
    # page boundary, the widest fused chunk and one past it, group 1, trash
    # rows, and ragged tables (entries past a slot's pages left at page 0)
    for kernel, page, nb, b, t, hq, hkv, hd, dt, pos, active, ragged in (
            ("paged_attention", 8, 64, 3, 1, 32, 8, 128, torch.bfloat16, [0, 300, 511], None,
             False),
            ("paged_attention", 24, 10, 2, 5, 16, 4, 64, torch.bfloat16, [20, 230],
             [True, False], False),
            ("paged_attention", 64, 4, 2, 5, 8, 2, 128, f32, [61, 100], None, False),
            ("paged_attention", 16, 8, 3, 1, 8, 2, 64, f32, [5, 40, 127], [True, True, False],
             True),
            ("paged_attention", 16, 8, 2, 16, 16, 4, 128, torch.bfloat16, [3, 100], None, True),
            ("paged_attention", 16, 8, 2, 17, 4, 4, 64, torch.bfloat16, [0, 90], None, False),
            ("paged_attention", 64, 4, 1, 100, 32, 8, 128, f32, [20], None, False),
            ("paged_flash_attention", 128, 2, 2, 3, 8, 2, 64, f32, [5, 200], None, False)):
        q, kp, vp, tables, nk, nv = paged_inputs(gen, device, b, t, hq, hkv, hd, page, nb, dt,
                                                 q_dtype=torch.bfloat16)
        posv = torch.tensor(pos, dtype=torch.int32, device=device)
        if ragged:  # only the pages each slot's rows reach are allocated
            used = (posv + t - 1) // page + 1
            tables = torch.where(torch.arange(nb, device=device)[None] < used[:, None],
                                 tables, 0).to(torch.int32)
        act = None if active is None else torch.tensor(active, device=device)
        if kernel == "paged_flash_attention":
            nk = nv = None
        err, same = paged_check(kernel, q, kp, vp, tables, posv, nk, nv, act)
        tag = (f"edge {kernel} page={page} B={b} T={t} heads={hq}/{hkv} hd={hd} {dt} "
               f"pos={pos}{' ragged' if ragged else ''}{' inactive' if active else ''}")
        print(f"  {tag}: err {err:.3e} <= tol {TOL_K9:.0e}, pools equal {same}", flush=True)
        if not (same and err <= TOL_K9):
            fail(f"{tag}: pools equal {same}, max error {err} (tol {TOL_K9})")
    edges_slice3(device)
    edges_decode(device)


def edges_decode(device) -> None:
    """Untimed edges of the decode body of K1, K5, K3 and K4: each row of an
    m-row call (m = 2, 8, 9, 16) bit-equal to that row computed alone, at
    the w1 and wk shapes (a verify row summed like a decode row); m = 0; the
    bf16 output equal to the f32 output rounded."""
    import torch

    from dllama_tpu_torch.ops import q40_matmul as q40
    from dllama_tpu_torch.ops import q80_matmul as q80

    def styled(style):
        def fn(*args, **kw):
            with q40.forced_style(style):
                return q40.q40_matmul(*args, **kw)
        return fn

    gen = torch.Generator(device=device).manual_seed(10)
    f32 = torch.float32
    for kernel, fn, rand in (("q40_decode", q40.q40_matmul, random_q40),
                             ("q80_decode", q80.q80_matmul, random_q80),
                             ("q40_maskdot", styled("maskdot"), random_q40),
                             ("q40_loopdot", styled("loopdot"), random_q40)):
        for name, k, n in (("w1", 4096, 14336), ("wk", 4096, 1024)):
            w = rand(gen, (2,), k, n, device)
            x = torch.randn((16, k), generator=gen, device=device).to(torch.bfloat16)
            alone = torch.cat([fn(x[r : r + 1], w, 1, out_dtype=f32) for r in range(16)])
            for m in (2, 8, 9, 16):
                same = torch.equal(fn(x[:m], w, 1, out_dtype=f32), alone[:m])
                print(f"  edge {kernel} {name} m={m}: every row bit-equal to the row alone: "
                      f"{same}", flush=True)
                if not same:
                    fail(f"{kernel} {name} m={m}: a row depends on the other rows")
            bf = fn(x[:9], w, 1)
            empty = fn(x[:0], w, 1, out_dtype=f32)
            torch.cuda.synchronize()
            if not (torch.equal(bf, alone[:9].to(torch.bfloat16)) and empty.shape == (0, n)):
                fail(f"{kernel} {name}: bf16 output is not the f32 one rounded, or m = 0 "
                     f"gave {tuple(empty.shape)}")
            del w


def edges_styles(device) -> None:
    """Untimed edges of K3 and K4 on the decode body: K4's output bit-equal
    under the geometries loopdot_geometry gives for 78, 114 and 132 SMs (its
    sum order follows k alone; the column tile may change with the SMs), and
    each of K3 and K4 one device kernel a call in a captured graph, at a
    split launch (wk, w1) and an unsplit one (wcls): no second pass."""
    import torch

    from dllama_tpu_torch.ops import q40_matmul as q40

    gen = torch.Generator(device=device).manual_seed(12)
    f32 = torch.float32
    for k, n in ((4096, 1024), (4096, 14336), (4128, 1000)):
        w = random_q40(gen, (), k, n, device)
        x = torch.randn((8, k), generator=gen, device=device).to(torch.bfloat16)
        with q40.forced_style("loopdot"):
            want = q40.q40_matmul(x, w, out_dtype=f32)
        for sms in (78, 114, 132):
            geo = q40.loopdot_geometry(k, n, sms)
            got = torch.empty_like(want)
            q40.decode_launch("q40_loopdot", x, w.packed, w.scales, got, geo)
            same = torch.equal(got, want)
            print(f"  edge q40_loopdot k={k} n={n} m=8, the geometry of {sms} SMs "
                  f"{tuple(geo)}: bit-equal to the wrapper's launch {same}", flush=True)
            if not same:
                fail(f"q40_loopdot k={k} n={n}: the geometry of {sms} SMs changed the sums")
    for style in ("maskdot", "loopdot"):
        name = STYLE_NAMES[style][0]
        for k, n in ((4096, 1024), (4096, 14336), (4096, 128256)):
            w = random_q40(gen, (), k, n, device)
            x = torch.randn((1, k), generator=gen, device=device).to(torch.bfloat16)
            with q40.forced_style(style):
                nodes = one_call_nodes(lambda: q40.q40_matmul(x, w))
            geo = (q40.loopdot_geometry if style == "loopdot" else q40.decode_geometry)(
                k, n, q40._sm_count(device.index or 0))
            print(f"  edge {STYLE_KERNELS[style]} k={k} n={n} m=1 ({geo.splits} splits): "
                  f"{len(nodes)} device operation(s) a call", flush=True)
            if len(nodes) != 1 or nodes[0][0] != "kernel" or name not in nodes[0][1]:
                fail(f"{STYLE_KERNELS[style]} k={k} n={n}: one call ran {nodes}, want one "
                     f"{name} kernel")


def edges_slice3(device) -> None:
    """Untimed edges of K5/K6, K10 and K7's f8 mode: random int8 codes with
    -128, m = 16 and 17 on either side of the decode/prefill split (each
    launching its kernel), a ragged n with and without aligned loads, an odd
    count of 32-row k blocks, 2-D weights; a wide weight's first columns
    bit-equal to the narrow weight's (the fused wqkv/w13 case) at decode and
    at prefill row counts that split one and not the other; RMSNorm on f32,
    on a strided row slice and on a width that is no multiple of 1024; the
    f8 cache at head size 64 with per-row positions and T = 7."""
    import torch

    from dllama_tpu_torch.ops import q80_matmul as q80
    from dllama_tpu_torch.ops.flash_attention import flash_gqa_attention
    from dllama_tpu_torch.ops.layers import gqa_attention, rms_norm_plain
    from dllama_tpu_torch.ops.quant import Q8Tensor
    from dllama_tpu_torch.ops.rms_norm import rms_norm

    gen = torch.Generator(device=device).manual_seed(6)
    f32 = torch.float32
    for m, k, n, stacked in ((16, 4096, 4096, True), (17, 4096, 1024, True),
                             (3, 4128, 1000, True), (5, 256, 1002, False),
                             (40, 512, 1003, False), (100, 4128, 1000, True)):
        w = random_q80(gen, (2,) if stacked else (), k, n, device)
        layer = 1 if stacked else None
        x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        before = dict(q80.LAUNCHES)
        got = q80.q80_matmul(x, w, layer, out_dtype=f32)
        ref = q80.q80_matmul_plain(x, w, layer, out_dtype=f32)
        kernel = "q80_decode" if m <= 16 else "q80_prefill"
        if q80.LAUNCHES[kernel] != before[kernel] + 1:
            fail(f"q80 edge m={m}: {kernel} was not the kernel launched")
        tol = (TOL_K1 if m <= 16 else TOL_K2) * ref.abs().max().item()
        err = (got - ref).abs().max().item()
        exact = ""
        if m <= 16:  # K5 also against its own arithmetic
            e2, t2 = exact_check("q80_decode", got, x, w, layer, f"q80 edge m={m} k={k} n={n}")
            exact = f", exact-code err {e2:.3e} <= {t2:.3e}"
        print(f"  edge q80 m={m} k={k} n={n}{'' if stacked else ' 2-D'} ({kernel}): "
              f"err {err:.3e} <= tol {tol:.3e}{exact}", flush=True)
        if not err <= tol:
            fail(f"q80 edge m={m} k={k} n={n}: max error {err} over {tol}")
    wide = random_q80(gen, (), 4096, 14336, device)
    narrow = Q8Tensor(wide.codes[:, :1024].contiguous(), wide.scales[:, :1024].contiguous())
    for m in (1, 8, 32, 256):
        x = torch.randn((m, 4096), generator=gen, device=device).to(torch.bfloat16)
        same = torch.equal(q80.q80_matmul(x, wide, out_dtype=f32)[:, :1024],
                           q80.q80_matmul(x, narrow, out_dtype=f32))
        print(f"  edge q80 m={m}: the first 1024 of 14336 columns bit-equal to a 1024-wide "
              f"weight's: {same}", flush=True)
        if not same:
            fail(f"q80 edge m={m}: a column's sum depends on the weight's width")
    w = 1.0 + 0.1 * torch.randn((4096,), generator=gen, device=device)
    for label, x, wt in (
            ("f32 3x5x4096", torch.randn((3, 5, 4096), generator=gen, device=device), w),
            ("bf16 row slice x[:, -1:] of 2x7x4096",
             torch.randn((2, 7, 4096), generator=gen, device=device).to(torch.bfloat16)[:, -1:],
             w),
            ("bf16 9x264", torch.randn((9, 264), generator=gen, device=device).to(torch.bfloat16),
             w[:264])):
        got, ref = rms_norm(x, wt, 1e-5), rms_norm_plain(x, wt, 1e-5)
        err = (got.float() - ref.float()).abs().max().item()
        tol = (1e-5 if x.dtype == f32 else TOL_K10) * ref.float().abs().max().item()
        print(f"  edge rms_norm {label}: err {err:.3e} <= tol {tol:.3e}", flush=True)
        if not (got.shape == x.shape and err <= tol):
            fail(f"rms_norm edge {label}: max error {err} over {tol}")
    f8 = torch.float8_e4m3fn
    for b, t, hq, hkv, hd, s, pos in ((2, 1, 8, 4, 64, 1000, [5, 900]),
                                      (2, 7, 8, 4, 64, 1000, [0, 990]),
                                      (1, 3, 4, 1, 128, 130, 70)):
        q = torch.randn((b, t, hq, hd), generator=gen, device=device).to(torch.bfloat16)
        kc = torch.randn((b, hkv, s, hd), generator=gen, device=device).to(f8)
        vc = torch.randn((b, hkv, s, hd), generator=gen, device=device).to(f8)
        pv = torch.tensor(pos, dtype=torch.int32, device=device) if isinstance(pos, list) else pos
        got = flash_gqa_attention(q, kc, vc, pv, out_dtype=f32)
        ref = gqa_attention(q.float(), kc.float(), vc.float(), pv)
        err = (got - ref).abs().max().item()
        print(f"  edge flash f8 B={b} T={t} heads={hq}/{hkv} hd={hd} S={s} pos={pos}: "
              f"err {err:.3e} <= tol {TOL_K7:.0e}", flush=True)
        if not err <= TOL_K7:
            fail(f"flash f8 edge B={b} T={t} hd={hd} S={s}: max error {err} over {TOL_K7}")


def style_case(style: str, x, w, layer, label: str):
    """One call of the `style` kernel (K3/K4) through q40_matmul, checked
    to launch that kernel, against its plain version and against K1 on the
    same inputs -> (out, error vs plain, error vs K1, tolerance)."""
    import torch

    from dllama_tpu_torch.ops import q40_matmul as q40

    plain = q40.STYLE_PLAIN[style]
    kernel = STYLE_KERNELS[style]
    before = q40.LAUNCHES[kernel]
    with q40.forced_style(style):
        got = q40.q40_matmul(x, w, layer, out_dtype=torch.float32)
    if q40.LAUNCHES[kernel] != before + 1:
        fail(f"{label}: STYLE={style} did not launch {kernel}")
    with q40.forced_style("blockdot"):
        k1 = q40.q40_matmul(x, w, layer, out_dtype=torch.float32)
    ref = plain(x, w, layer, out_dtype=torch.float32)
    torch.cuda.synchronize()
    tol = TOL_K34 * ref.abs().max().item()
    err, err_k1 = (got - ref).abs().max().item(), (got - k1).abs().max().item()
    if not (err <= tol and err_k1 <= tol):
        fail(f"{label}: max error {err} vs plain, {err_k1} vs K1, over {tol}")
    return got, err, err_k1, tol


def style_cases(cfg, device, timer, layer: int = 1) -> dict:
    """K3 (maskdot) and K4 (loopdot) at the 8B decode shapes, m = 1 and 8
    (K3 also 16), each weight stacked [L=2] with layer 1 used: against the
    plain versions and K1, then timed beside the plain version, torch.matmul
    on the pre-dequantized bf16 weight and a torch.sum over the layer's
    packed bytes read as f32 (what reading the weight alone takes under this
    timer)."""
    import torch

    from dllama_tpu_torch.ops import q40_matmul as q40
    from dllama_tpu_torch.ops.quant import slice_leaf

    gen = torch.Generator(device=device).manual_seed(7)
    d, f, kvd, v = cfg.dim, cfg.hidden_dim, cfg.kv_dim, cfg.vocab_size
    weights = {"wq": (d, d), "wk": (d, kvd), "w1": (d, f), "w2": (f, d), "wcls": (d, v)}
    results: dict[str, list] = {"q40_maskdot": [], "q40_loopdot": []}
    for name, (k, n) in weights.items():
        w = random_q40(gen, (2,), k, n, device)
        wd = slice_leaf(w, layer).dequantize(torch.bfloat16)
        sum_ms = timer(lambda: torch.sum(w.packed[layer].view(torch.float32)))
        for style, ms in (("maskdot", (1, 8, 16)), ("loopdot", (1, 8))):
            kernel = STYLE_KERNELS[style]
            plain = q40.STYLE_PLAIN[style]
            for m in ms:
                x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
                _, err, err_k1, tol = style_case(style, x, w, layer, f"{kernel} {name} m={m}")

                def run(x=x):
                    with q40.forced_style(style):
                        return q40.q40_matmul(x, w, layer)

                nbytes = m * k * 2 + k * n // 2 + (k // 32) * n * 2 + m * n * 2
                b, by = bound_ms(nbytes, 2.0 * m * k * n)
                case = dict(case=f"{name} {k}x{n} m={m}", max_abs_err=err, err_vs_k1=err_k1,
                            tol=tol, ms=timer(run),
                            plain_ms=timer(lambda x=x: plain(x, w, layer)),
                            library_ms=timer(lambda x=x: torch.matmul(x, wd)),
                            sum_ms=sum_ms, bound_ms=b, bound_by=by)
                report(kernel, case)
                results[kernel].append(case)
        del w, wd
    return results


def kbench_cases(cfg, device, timer) -> dict:
    """K11-B (f32-FMA Q40) and K11-D (bf16 weights) at w1, m = 8 and 256,
    against their plain versions; the library yardsticks are torch.matmul on
    the f32 dequantized weight (K11-B) and on the bf16 one (K11-D)."""
    import torch

    from dllama_tpu_torch.experiments import kbench

    gen = torch.Generator(device=device).manual_seed(8)
    k, n = cfg.dim, cfg.hidden_dim
    w = random_q40(gen, (), k, n, device)
    scales32 = w.scales.to(torch.float32)
    wf = kbench.fma_dequantize(w.packed, scales32)
    wb = w.dequantize(torch.bfloat16)
    results: dict[str, list] = {"kbench_fma_f32": [], "kbench_bf16_gemm": []}
    for m in (8, 256):
        x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        for kernel, fn, plain, lib, nbytes, ops_s in (
                # the bf16 rate: a bf16 x times a code q - 8 is exact in f32, so
                # the tensor cores compute this f32 function (only the order of
                # the f32 sums differs), and the card needs no f32 unit for it
                ("kbench_fma_f32", lambda x: kbench.fma_f32(x, w.packed, scales32),
                 lambda x: kbench.fma_f32_plain(x, w.packed, scales32),
                 lambda x: torch.matmul(x.float(), wf),
                 m * k * 2 + k * n // 2 + (k // 32) * n * 4 + m * n * 4, BF16_OPS_S),
                ("kbench_bf16_gemm", lambda x: kbench.bf16_gemm(x, wb),
                 lambda x: kbench.bf16_gemm_plain(x, wb), lambda x: torch.matmul(x, wb),
                 m * k * 2 + k * n * 2 + m * n * 4, BF16_OPS_S)):
            before = kbench.LAUNCHES[kernel]
            got, ref = fn(x), plain(x)
            torch.cuda.synchronize()
            if kbench.LAUNCHES[kernel] != before + 1:
                fail(f"{kernel}: the wrapper did not launch its kernel")
            b, by = bound_ms(nbytes, 2.0 * m * k * n, ops_s)
            case = dict(case=f"w1 {k}x{n} m={m}", max_abs_err=(got - ref).abs().max().item(),
                        tol=TOL_K11 * ref.abs().max().item(),
                        ms=timer(lambda x=x, fn=fn: fn(x)),
                        plain_ms=timer(lambda x=x, plain=plain: plain(x)),
                        library_ms=timer(lambda x=x, lib=lib: lib(x)), bound_ms=b, bound_by=by)
            report(kernel, case)
            results[kernel].append(case)
    return results


def kbench_shape_checks() -> None:
    """Every kernel the kbench phase launches, held against its plain
    version on the benchmark's own inputs (kbench.make_inputs at
    kbench.SHAPES, kbench.flash_inputs): each kernel variant of each SUITE
    row and of `8 w1 B D`, K1 under each tile of the sweep, and K7 on every
    flash row. Untimed: kbench only times."""
    import torch

    from dllama_tpu_torch.experiments import kbench
    from dllama_tpu_torch.ops import q40_matmul as q40
    from dllama_tpu_torch.ops import q80_matmul as q80
    from dllama_tpu_torch.ops.flash_attention import flash_gqa_attention
    from dllama_tpu_torch.ops.layers import gqa_attention

    f32 = torch.float32

    def check(what, got, ref, tol):
        torch.cuda.synchronize()
        err, tol = (got - ref).abs().max().item(), tol * ref.abs().max().item()
        print(f"  kbench inputs {what}: err {err:.3e} <= tol {tol:.3e}", flush=True)
        if not err <= tol:
            fail(f"kbench inputs {what}: max error {err} over {tol}")

    def style_tol(style):
        return {"blockdot": TOL_K1, "deq": TOL_K2}.get(style, TOL_K34)

    for m, label, variants in [*kbench.SUITE, (8, "w1", ["B", "D"])]:
        w, x, _ = kbench.make_inputs(m, label)
        k, n = kbench.SHAPES[label]
        for v in variants:
            what = f"m={m} {label} {v}"
            if v in kbench.STYLE_OF:
                style = q40.resolve_style(kbench.STYLE_OF[v], m)
                with q40.forced_style(kbench.STYLE_OF[v]):
                    got = q40.q40_matmul(x, w, out_dtype=f32)
                ref = q40.STYLE_PLAIN.get(style, q40.q40_matmul_plain)(x, w, out_dtype=f32)
                check(f"{what} ({style})", got, ref, style_tol(style))
                if style == "blockdot":  # K1 also against its own arithmetic
                    check(f"{what} (blockdot, exact codes)", got,
                          exact_plain("q40_decode")(x, w, None, out_dtype=f32), TOL_K34)
            elif v == "B":
                s32 = w.scales.to(f32)
                check(what, kbench.fma_f32(x, w.packed, s32),
                      kbench.fma_f32_plain(x, w.packed, s32), TOL_K11)
            elif v == "D":
                wb = w.dequantize(torch.bfloat16)
                check(what, kbench.bf16_gemm(x, wb), kbench.bf16_gemm_plain(x, wb), TOL_K11)
                del wb
            elif v == "Q8":
                w8 = kbench.make_q80(k, n)
                got = q80.q80_matmul(x, w8, out_dtype=f32)
                check(what, got, q80.q80_matmul_plain(x, w8, out_dtype=f32),
                      TOL_K1 if m <= q80.DECODE_MAX_M else TOL_K2)
                if m <= q80.DECODE_MAX_M:  # K5 also against its own arithmetic
                    check(f"{what} (exact codes)", got,
                          exact_plain("q80_decode")(x, w8, None, out_dtype=f32), TOL_K34)
                del w8
        del w, x
    w, x, _ = kbench.make_inputs(8, "w1")
    k, n = kbench.SHAPES["w1"]
    ref = q40.q40_matmul_plain(x, w, out_dtype=f32)
    exact = exact_plain("q40_decode")(x, w, None, out_dtype=f32)
    for tk in kbench.SWEEP_TK:
        for tn in kbench.SWEEP_TN:
            if k % tk or n % tn:
                continue
            with q40.forced_style("blockdot", tk, tn):
                got = q40.q40_matmul(x, w, out_dtype=f32)
            check(f"tile sweep m=8 w1 tk={tk} tn={tn}", got, ref, TOL_K1)
            check(f"tile sweep m=8 w1 tk={tk} tn={tn} (exact codes)", got, exact, TOL_K34)
    for section, label, q, kc, vc, pos in kbench.flash_inputs():
        got = flash_gqa_attention(q, kc, vc, pos, out_dtype=f32)
        ref = gqa_attention(q.float(), kc.float(), vc.float(), pos)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        print(f"  kbench inputs flash {section} {label}: err {err:.3e} <= tol {TOL_K7:.0e}",
              flush=True)
        if not err <= TOL_K7:
            fail(f"kbench inputs flash {label}: max error {err} over {TOL_K7}")


def edges_slice4(device) -> None:
    """Untimed edges of the decode-style ladder: K2 at m = 1 and 8 under
    STYLE=deq (its row mask); K1 tile overrides that do not divide k or are
    not compiled falling back to the default launch bit for bit, and valid
    ones within K1's tolerance; K3 at m = 9 and K3/K4 on ragged n, an odd
    count of 32-row k blocks and a 2-D weight; K11-B/K11-D at ragged m and n."""
    import torch

    from dllama_tpu_torch.experiments import kbench
    from dllama_tpu_torch.ops import q40_matmul as q40

    gen = torch.Generator(device=device).manual_seed(9)
    f32 = torch.float32
    for m, k, n in ((1, 4096, 1024), (8, 4096, 4096), (8, 4128, 1000)):
        w = random_q40(gen, (2,), k, n, device)
        x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        before = q40.LAUNCHES["q40_prefill"]
        with q40.forced_style("deq"):
            got = q40.q40_matmul(x, w, 1, out_dtype=f32)
        ref = q40.q40_matmul_plain(x, w, 1, out_dtype=f32)
        err, tol = (got - ref).abs().max().item(), TOL_K2 * ref.abs().max().item()
        print(f"  edge STYLE=deq m={m} k={k} n={n} (K2): err {err:.3e} <= tol {tol:.3e}",
              flush=True)
        if q40.LAUNCHES["q40_prefill"] != before + 1 or not err <= tol:
            fail(f"deq edge m={m}: K2 not launched, or max error {err} over {tol}")
    w = random_q40(gen, (2,), 4096, 14336, device)
    x = torch.randn((8, 4096), generator=gen, device=device).to(torch.bfloat16)
    with q40.forced_style("blockdot"):
        default = q40.q40_matmul(x, w, 1, out_dtype=f32)
    ref = q40.q40_matmul_plain(x, w, 1, out_dtype=f32)
    for tk, tn in ((96, 384), (100, 64), (4096 * 2, 128), (512, 512), (1024, 128), (2048, 256)):
        before = q40.LAUNCHES["q40_decode"]
        with q40.forced_style("blockdot", tk, tn):
            got = q40.q40_matmul(x, w, 1, out_dtype=f32)
        applied = q40.blockdot_tiles(4096, 14336, tk, tn)
        err, tol = (got - ref).abs().max().item(), TOL_K1 * ref.abs().max().item()
        same = torch.equal(got, default)
        e2, t2 = exact_check("q40_decode", got, x, w, 1, f"K1 tile override {tk}/{tn}")
        print(f"  edge BLOCKDOT_TK/TN={tk}/{tn} -> {applied}: err {err:.3e} <= tol {tol:.3e}, "
              f"exact-code err {e2:.3e} <= {t2:.3e}, bit-equal to the default launch {same}",
              flush=True)
        if q40.LAUNCHES["q40_decode"] != before + 1 or not err <= tol or (
                applied == (None, None) and not same):
            fail(f"K1 tile override {tk}/{tn}: launches, error {err} (tol {tol}) or fallback")
    for style, m, k, n, stacked in (("maskdot", 9, 4096, 1024, True),
                                    ("maskdot", 3, 4128, 1000, True),
                                    ("maskdot", 16, 256, 1002, False),
                                    ("loopdot", 3, 4128, 1000, True),
                                    ("loopdot", 16, 256, 1002, False),
                                    ("loopdot", 9, 4096, 1024, True)):
        w = random_q40(gen, (2,) if stacked else (), k, n, device)
        x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        _, err, err_k1, tol = style_case(style, x, w, 1 if stacked else None,
                                         f"edge {style} m={m} k={k} n={n}")
        print(f"  edge {STYLE_KERNELS[style]} m={m} k={k} n={n}{'' if stacked else ' 2-D'}: "
              f"err {err:.3e}, vs K1 {err_k1:.3e} <= tol {tol:.3e}", flush=True)
    for m, k, n in ((5, 4096, 1000), (100, 256, 1024), (1, 4128, 136)):
        w = random_q40(gen, (), k, n, device)
        x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        s32, wb = w.scales.to(f32), w.dequantize(torch.bfloat16)
        for kernel, got, ref in (
                ("kbench_fma_f32", kbench.fma_f32(x, w.packed, s32),
                 kbench.fma_f32_plain(x, w.packed, s32)),
                ("kbench_fma_f32 (f32 x)", kbench.fma_f32(x.float(), w.packed, s32),
                 kbench.fma_f32_plain(x.float(), w.packed, s32)),
                ("kbench_bf16_gemm", kbench.bf16_gemm(x, wb), kbench.bf16_gemm_plain(x, wb))):
            err, tol = (got - ref).abs().max().item(), TOL_K11 * ref.abs().max().item()
            print(f"  edge {kernel} m={m} k={k} n={n}: err {err:.3e} <= tol {tol:.3e}",
                  flush=True)
            if not err <= tol:
                fail(f"{kernel} edge m={m} k={k} n={n}: max error {err} over {tol}")


def edges_k11(device) -> None:
    """Untimed edges of K11-B and K11-D on both routes: m = 16 and 17 on
    either side of the route split, an f32 x (K11-B) on both routes, a k
    that is a multiple of 8 but not of 32 (K11-D) on both routes, each
    within TOL_K11 of its plain version and launching its kernel once; then
    each kernel one device kernel a call in a captured graph at w1, m = 8
    and 256 (both routes; K11-B with bf16 and f32 x)."""
    import torch

    from dllama_tpu_torch.experiments import kbench

    if not hasattr(kbench, "route"):  # an earlier checkout of the package, timed with this script
        print("  edges K11: this package's K11 kernels have no routes", flush=True)
        return
    gen = torch.Generator(device=device).manual_seed(10)
    f32 = torch.float32
    for m, k, n in ((16, 4096, 1024), (17, 4096, 1024), (16, 4128, 1000), (17, 4128, 1000),
                    (3, 4104, 1000), (40, 4104, 1000)):
        w = random_q40(gen, (), k - k % 32, n, device)
        wb = torch.randn((k, n), generator=gen, device=device).to(torch.bfloat16) * 0.02
        x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        s32 = w.scales.to(f32)
        cases = [("kbench_bf16_gemm", lambda: kbench.bf16_gemm(x, wb),
                  lambda: kbench.bf16_gemm_plain(x, wb))]
        if k % 32 == 0:
            cases += [("kbench_fma_f32", lambda: kbench.fma_f32(x, w.packed, s32),
                       lambda: kbench.fma_f32_plain(x, w.packed, s32)),
                      ("kbench_fma_f32", lambda: kbench.fma_f32(x.float() * 1.001, w.packed, s32),
                       lambda: kbench.fma_f32_plain(x.float() * 1.001, w.packed, s32))]
        for i, (kernel, fn, plain) in enumerate(cases):
            before = kbench.LAUNCHES[kernel]
            got, ref = fn(), plain()
            torch.cuda.synchronize()
            err, tol = (got - ref).abs().max().item(), TOL_K11 * ref.abs().max().item()
            tag = " (f32 x)" if i == 2 else ""
            print(f"  edge {kernel}{tag} m={m} k={k} n={n} ({kbench.route(m)} route): "
                  f"err {err:.3e} <= tol {tol:.3e}", flush=True)
            if kbench.LAUNCHES[kernel] != before + 1 or not err <= tol:
                fail(f"{kernel}{tag} edge m={m} k={k} n={n}: launches, or max error {err} "
                     f"over {tol}")
        del w, wb
    k, n = 4096, 14336
    w = random_q40(gen, (), k, n, device)
    s32, wb = w.scales.to(f32), w.dequantize(torch.bfloat16)
    for m in (8, 256):
        x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        xf = x.float()
        name = "decode_kernel" if kbench.route(m) == "decode" else "prefill_kernel"
        for kernel, fn in (("kbench_fma_f32", lambda: kbench.fma_f32(x, w.packed, s32)),
                           ("kbench_fma_f32 (f32 x)", lambda: kbench.fma_f32(xf, w.packed, s32)),
                           ("kbench_bf16_gemm", lambda: kbench.bf16_gemm(x, wb))):
            nodes = one_call_nodes(fn)
            print(f"  edge {kernel} w1 m={m} ({kbench.route(m)} route): "
                  f"{len(nodes)} device operation(s) a call", flush=True)
            if len(nodes) != 1 or nodes[0][0] != "kernel" or name not in nodes[0][1]:
                fail(f"{kernel} w1 m={m}: one call ran {nodes}, want one {name}")


# ------------------------------------------------------------ phase 3


def q80_records(scales, packed):
    """Q40 blocks (f16 scales [nb], packed nibbles [nb, 16] in the file's
    order) re-quantized to Q80 file records [nb, 34] as the converter does
    (ops/quant.quantize_q80_np): f16 absmax/127, codes round(w / delta)."""
    import torch

    codes4 = torch.cat([(packed & 15).to(torch.int8) - 8, (packed >> 4).to(torch.int8) - 8],
                       dim=1)
    w = codes4.to(torch.float32) * scales.to(torch.float32)[:, None]
    delta = w.abs().amax(dim=1) / 127.0
    inv = torch.where(delta != 0, 1.0 / delta, torch.zeros_like(delta))
    rec = torch.empty((w.shape[0], 34), dtype=torch.uint8, device=w.device)
    rec[:, :2] = delta.to(torch.float16).view(torch.uint8).reshape(-1, 2)
    rec[:, 2:] = torch.round(w * inv[:, None]).to(torch.int8).view(torch.uint8)
    return rec


def write_model(path: str, cfg, device, seed: int = 0, zero_mean: bool = False) -> None:
    """A `.m` of `cfg` with random Q40 records (packed bytes + small positive
    f16 scales) and a small f32 embedding, generated on the device. A Q80
    `cfg` gets the same seed's Q40 weights re-quantized to Q80 (q80_records):
    the same network, whose forward is as well conditioned as the Q40 one's.
    (Uniform random int8 codes make a zero-mean random network that
    amplifies the kernels' exact codes against the plain path's bf16-rounded
    weights to 0.17 of max|logit| over 32 layers, where this recipe's nibbles,
    whose mean is -s/2, keep it near 6.5e-3; the kernels phase feeds the Q80
    kernels such codes, -128 included.) `zero_mean`: Q40 nibbles drawn from
    1..15, codes -7..7 of mean 0, a network whose output moves with its
    input (mesh_power)."""
    import numpy as np
    import torch

    from dllama_tpu_torch.models.formats import tensor_plan, write_header
    from dllama_tpu_torch.ops.quant import FloatType

    gen = torch.Generator(device=device).manual_seed(seed)
    with open(path, "wb") as f:
        write_header(f, cfg)
        for name, shape, ft in tensor_plan(cfg):
            n = int(np.prod(shape))
            if ft in (FloatType.Q40, FloatType.Q80):
                nb = n // 32
                scales = (torch.rand(nb, generator=gen, device=device) * 0.02
                          + 1e-3).to(torch.float16)
                if zero_mean:
                    lo, hi = (torch.randint(1, 16, (nb, 16), generator=gen, device=device,
                                            dtype=torch.uint8) for _ in range(2))
                    packed = lo | (hi << 4)
                else:
                    packed = torch.randint(0, 256, (nb, 16), generator=gen, device=device,
                                           dtype=torch.uint8)
                if ft == FloatType.Q80:
                    rec = q80_records(scales, packed)
                else:
                    rec = torch.cat([scales.view(torch.uint8).reshape(nb, 2), packed], dim=1)
                f.write(rec.cpu().numpy().data)
            elif name == "embedding":
                for r0 in range(0, shape[0], 8192):
                    rows = min(8192, shape[0] - r0)
                    e = (torch.rand((rows, shape[1]), generator=gen, device=device) - 0.5) * 0.04
                    f.write(e.cpu().numpy().tobytes())
            else:  # norm weights
                f.write(np.ones(n, np.float32).tobytes())


#: the Llama-3 chat template of the smoke's tokenizers
SMOKE_CHAT_TEMPLATE = ("{% for message in messages %}<|start_header_id|>{{ message['role'] }}"
                       "<|end_header_id|>\n\n{{ message['content'] }}<|eot_id|>{% endfor %}")


def write_tokenizer(path: str, vocab_size: int) -> None:
    """A Llama-3-layout `.t`: 256 byte tokens, inert filler pieces up to the
    128000 regular ids (so every id the random model emits decodes), the 256
    Llama-3 special tokens, and a Llama-3 chat template."""
    from dllama_tpu_torch.tokenizer.tokenizer import Tokenizer

    n_special = 256
    n_regular = vocab_size - n_special
    vocab = [bytes([i]) for i in range(256)]
    vocab += [f"<f{i}>".encode() for i in range(256, n_regular)]
    named = ["<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
             "<|reserved_special_token_1|>", "<|reserved_special_token_2|>",
             "<|reserved_special_token_3|>", "<|start_header_id|>", "<|end_header_id|>",
             "<|reserved_special_token_4|>", "<|eot_id|>"]
    named += [f"<|reserved_special_token_{i}|>" for i in range(5, n_special - 5)]
    vocab += [s.encode() for s in named]
    scores = [0.0] * len(vocab)
    bos = n_regular
    Tokenizer(vocab, scores, bos, [bos + 1, bos + 9], chat_template=SMOKE_CHAT_TEMPLATE,
              special_ids=list(range(n_regular, len(vocab)))).save(path)


def forward_logits(loaded, device, runs: dict, prefill: int = 256, decode: int = 8,
                   verify: int = 9) -> dict:
    """Every run of `runs` (label -> (params, mm, attn)) through the whole
    forward on a fresh cache of the engine's cache dtype: a prefill, decode
    steps, then one forward of `verify` tokens with every position's
    logits, the shape of a spec verify forward (k + 1 rows at --spec 8), all
    on the same random tokens. -> label -> the stacked logits."""
    import torch

    from dllama_tpu_torch.models.llama import KVCache, forward

    eng = loaded.engine
    cfg = loaded.config
    gen = torch.Generator(device=device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, prefill + decode + verify), generator=gen,
                         device=device)
    out = {}
    for label, (params, mm, attn) in runs.items():
        cache = KVCache.create(cfg, 1, eng.cache.k.dtype, eng.seq_len, device)
        outs = []
        with torch.no_grad():
            logits, _ = forward(cfg, params, toks[:, :prefill], 0, cache,
                                eng.rope_cache, attn, mm, last_only=True)
            outs.append(logits[:, -1])
            for i in range(decode):
                p = prefill + i
                logits, _ = forward(cfg, params, toks[:, p : p + 1], p, cache,
                                    eng.rope_cache, attn, mm, last_only=True)
                outs.append(logits[:, -1])
            p = prefill + decode
            logits, _ = forward(cfg, params, toks[:, p : p + verify], p, cache,
                                eng.rope_cache, attn, mm, last_only=False)
            outs.extend(logits.unbind(1))
        out[label] = torch.stack(outs)
        del cache
    return out


def phase_forward(loaded, device, prefill: int = 256, decode: int = 8, verify: int = 9) -> float:
    """Kernels vs plain versions through the whole forward (forward_logits:
    a prefill, decode steps and a verify forward). Returns the largest
    |logit difference| / max|logit| over all of them."""
    import functools

    import torch

    from dllama_tpu_torch.ops.layers import gqa_attention
    from dllama_tpu_torch.ops.matmul import matmul

    eng = loaded.engine
    runs = forward_logits(loaded, device, {
        "kernels": (eng.params, eng.mm, eng.attn_fn),
        "plain": (eng.params, functools.partial(matmul, backend="torch"), gqa_attention)},
        prefill, decode, verify)
    ref = runs["plain"]
    if not torch.isfinite(runs["kernels"]).all():
        fail("forward: non-finite logits through the kernels")
    return ((runs["kernels"] - ref).abs().max() / ref.abs().max()).item()


#: kernel-name fragments of the chunk's device-time split: the prefill GEMM
#: (K2, K6), the attention kernels with their combine and scatter passes (K7,
#: K9, under the names of this tree and of earlier ones), everything else
CHUNK_MATMUL = ("prefill_kernel",)  # K2 (prefill.cuh's, or an earlier q40_prefill_kernel) and K6
CHUNK_ATTENTION = ("attn_", "flash_", "paged_kernel", "paged_combine", "scatter_kernel")


def prefill_chunk_ms(loaded, device, positions=(0, 2048), chunk: int = 256, reps: int = 5,
                     page: int = 0) -> dict:
    """Device time of one `chunk`-token prefill forward through the kernels
    at each cache position of `positions`: CUDA events around `forward`,
    the median of `reps` runs taken in turns across the positions after a
    warm-up. A spin kernel longer than the host takes to enqueue the forward
    runs first, so the events measure the card's time for the forward's
    launches, not the host's pace, as long as the launch queue holds the
    whole forward (past about a thousand pending launches the host waits
    for the card, and the events then follow the host). Then one forward
    per position under torch.profiler splits the device time by kernel
    name: the prefill GEMM, attention, everything else; their sum is the
    card's busy time, beside the number of device operations. With `page`, the cache is a page pool of
    that page size and the chunk reads it through one slot's block table,
    as BatchEngine.add_step runs a chunk (the paged attention kernel);
    else the engine's dense cache (flash attention)."""
    import torch
    from torch.autograd import DeviceType

    from dllama_tpu_torch.engine.kernel_select import resolve_kernels
    from dllama_tpu_torch.models.llama import KVCache, PagedKVCache, forward

    eng, cfg = loaded.engine, loaded.config
    gen = torch.Generator(device=device).manual_seed(9)
    attn_fn = eng.attn_fn
    if page:
        n_pages = eng.seq_len // page
        cache = PagedKVCache.create(cfg, 1, n_pages, page, eng.cache.k.dtype, n_pages, device)
        cache.tables[0] = torch.randperm(n_pages, generator=gen, device=device).to(torch.int32)
        attn_fn = resolve_kernels(cfg, "auto", device, paged=True, page_size=page,
                                  cache_dtype=eng.cache.k.dtype).attn_fn
    else:
        cache = KVCache.create(cfg, 1, eng.cache.k.dtype, eng.seq_len, device)
    toks = torch.randint(0, cfg.vocab_size, (1, chunk), generator=gen, device=device)

    def run(pos):
        forward(cfg, eng.params, toks, pos, cache, eng.rope_cache, attn_fn, eng.mm,
                last_only=True)

    # the spin's clock: cycles per ms of torch.cuda._sleep
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    b.synchronize()
    cycles_per_ms = 20_000_000 / a.elapsed_time(b)
    out = {pos: {"times": []} for pos in positions}
    with torch.no_grad():
        for pos in positions:  # warm-up, and the host's enqueue time
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(pos)
            out[pos]["host_ms"] = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
        for _ in range(reps):
            for pos in positions:
                torch.cuda._sleep(int(2 * out[pos]["host_ms"] * cycles_per_ms))
                a.record()
                run(pos)
                b.record()
                b.synchronize()
                out[pos]["times"].append(a.elapsed_time(b))
        for pos in positions:
            torch.cuda.synchronize()
            with profiled() as prof:
                run(pos)
                torch.cuda.synchronize()
            split = {"matmul_ms": 0.0, "attention_ms": 0.0, "other_ms": 0.0, "kernels": 0}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA and LEAD_IN_NAME not in e.name:
                    key = ("matmul_ms" if any(k in e.name for k in CHUNK_MATMUL) else
                           "attention_ms" if any(k in e.name for k in CHUNK_ATTENTION) else
                           "other_ms")
                    split[key] += e.time_range.elapsed_us() / 1e3
                    split["kernels"] += 1
            out[pos].update(split, ms=statistics.median(out[pos].pop("times")))
    del cache
    return out


def report_chunk(label: str, chunk: dict) -> None:
    print(f"prefill chunk {label} (256 tokens, 32 layers, through the kernels): device "
          + "; ".join(f"{c['ms']:.3f} ms at pos {p} (profiled: busy "
                      f"{c['matmul_ms'] + c['attention_ms'] + c['other_ms']:.3f} ms in "
                      f"{c['kernels']} device ops: matmul {c['matmul_ms']:.3f}, attention "
                      f"{c['attention_ms']:.3f}, other {c['other_ms']:.3f} ms; host enqueue "
                      f"{c['host_ms']:.1f} ms)" for p, c in chunk.items()), flush=True)


def phase_profile(loaded, prompt_tokens: list[int], steps: int = 8, names=None) -> dict:
    """torch.profiler over one decode chunk of `steps` tokens after a
    prefill: wall time, device time summed over kernels, the Q40 decode
    kernel's share (kernel names with a fragment of `names`, default
    K1_NAMES), and the kernels that take the most device time."""
    import torch

    from dllama_tpu_torch.engine.sampling import Sampler

    eng = loaded.engine
    eng.reset(0)
    logits = eng.prefill(prompt_tokens)
    tok = int(torch.argmax(logits[0]))
    eng.decode_sample_n([[tok]], steps, Sampler(0.0, 0.9, 0))  # warm
    eng.reset(len(prompt_tokens))
    torch.cuda.synchronize()
    with profiled() as prof:
        t0 = time.perf_counter()
        eng.decode_sample_n([[tok]], steps, Sampler(0.0, 0.9, 0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = device_ops(prof)
    rows = sorted(((us, name, n) for name, (us, n) in by_name.items()), reverse=True)
    device_s = sum(r[0] for r in rows) / 1e6
    return {"steps": steps, "wall_ms_per_token": wall / steps * 1e3,
            "device_ms_per_token": device_s / steps * 1e3,
            "device_busy_share": device_s / wall if wall else None,
            **decode_split(by_name, steps, names or K1_NAMES),
            "top": [(k[:60], c, round(us / steps / 1e3, 4)) for us, k, c in rows[:10]]}


#: kernel-name fragments of K1 in the profiler (this tree's decode body over
#: the Q40 policy, and the name of the earlier kernel) and of the split-k
#: second pass that K1 and K5 no longer launch
K1_NAMES = ("Q40Codes", "q40_decode_kernel")
#: the same for K3 and K4 (this tree's decode body over the Q40 policy, whose
#: name K3 shares with K1, and in the Loopdot walk; the names of the earlier
#: kernels)
STYLE_NAMES = {"maskdot": ("Q40Codes", "q40_maskdot_kernel"),
               "loopdot": ("Loopdot", "q40_loopdot_kernel")}
SPLITK_NAME = "splitk_reduce"


def device_ops(prof) -> dict:
    """{name: [device us, count]} of the operations on the card (kernels,
    memcpys, memsets) in a torch.profiler run, the lead-in's left out."""
    from torch.autograd import DeviceType

    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and LEAD_IN_NAME not in e.name:
            agg = by_name.setdefault(e.name, [0.0, 0])
            agg[0] += e.time_range.elapsed_us()
            agg[1] += 1
    return by_name


#: how long the spin kernels that open every profiled block run, and their
#: kernel's name (torch.cuda._sleep), which device_ops leaves out
LEAD_IN_S = 0.2
LEAD_IN_NAME = "spin"


@contextlib.contextmanager
def profiled(cuda_only: bool = False):
    """torch.profiler over the block, which starts after LEAD_IN_S of short
    spin kernels. On the card a session loses the device records of its
    first milliseconds, more of them the longer the process has run: none
    in a fresh process, every record of a one-kernel block after a minute
    or two. The spins' records are the ones lost."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if cuda_only else [ProfilerActivity.CPU,
                                                       ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < LEAD_IN_S:
            torch.cuda._sleep(20_000)
            torch.cuda.synchronize()
        yield prof


#: CUgraphNodeType values (cuda.h) of the nodes a captured call may hold
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
                    6: "wait_event", 7: "event_record", 10: "mem_alloc", 11: "mem_free"}


def one_call_nodes(fn) -> list[tuple[str, str]]:
    """The device operations of one call of fn, read from the CUDA graph
    that captures it: [(node type, kernel name or "")]. A capture holds
    every kernel, memset and memcpy the call enqueues, and needs no
    profiler (torch.profiler on the card drops device events in a process
    that has run for a while). fn runs once uncaptured first, on the
    capture's stream, so that any scratch it keeps on that stream exists."""
    import ctypes

    import torch

    cu = ctypes.CDLL("libcuda.so.1")

    def ok(rc: int, what: str) -> None:
        if rc != 0:
            fail(f"{what} returned CUresult {rc}")

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=s):
        fn()
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(graph, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    ok(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    out = []
    for node in nodes:
        kind = ctypes.c_int()
        ok(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        name = ""
        if kind.value == 0:
            # CUDA_KERNEL_NODE_PARAMS_v2: CUfunction func at 0, CUkernel kern at 56
            params = (ctypes.c_uint8 * 128)()
            ok(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params),
               "cuGraphKernelNodeGetParams")
            func = ctypes.c_void_p.from_buffer(params, 0).value
            kern = ctypes.c_void_p.from_buffer(params, 56).value
            text = ctypes.c_char_p()
            if func:
                ok(cu.cuFuncGetName(ctypes.byref(text), ctypes.c_void_p(func)), "cuFuncGetName")
            else:
                ok(cu.cuKernelGetName(ctypes.byref(text), ctypes.c_void_p(kern)),
                   "cuKernelGetName")
            name = text.value.decode()
        out.append((GRAPH_NODE_TYPES.get(kind.value, str(kind.value)), name))
    g.reset()
    return out


def decode_split(by_name: dict, steps: int, names=K1_NAMES) -> dict:
    """Device operations, the Q40 decode kernel's device ms and launches
    (kernel names with a fragment of `names`: K1's by default) and split-k
    second passes, each per decode step (a token of one stream, or one
    batched step)."""
    mm = [v for name, v in by_name.items() if any(f in name for f in names)]
    return {"device_ops_per_step": sum(v[1] for v in by_name.values()) / steps,
            "q40_ms_per_step": sum(v[0] for v in mm) / steps / 1e3,
            "q40_launches_per_step": sum(v[1] for v in mm) / steps,
            "splitk_reduce_per_step": sum(v[1] for name, v in by_name.items()
                                          if SPLITK_NAME in name) / steps}


# ------------------------------------------------------------ phase 4


class IdTrace:
    """The prompt ids and emitted ids of every request a batched scheduler
    serves, by request id, in the order of their first tokens (a wrapper
    around Scheduler._emit). With the radix tree on, a request can prefill
    its suffix from another row than the same prompt did before, in other
    pow2 slices, so K1's and K2's routes (m <= 16, m > 16) can change low
    bits of its KV rows: greedy ids compared across such runs go through
    near_tie."""

    def __init__(self, sched):
        self.runs: dict[str, tuple[list[int], list[int]]] = {}
        self.reqs: dict = {}  # the Request objects, by request id
        emit = sched._emit

        def rec(req, token, row, emit=emit):
            self.reqs[req.req_id] = req
            self.runs.setdefault(req.req_id, (list(req.prompt), []))[1].append(int(token))
            return emit(req, token, row)

        sched._emit = rec

    def of(self, prompt) -> list[list[int]]:
        """The emitted ids of every request with `prompt`, in order."""
        return [ids for p, ids in self.runs.values() if p == list(prompt)]


def prompt_ids(api, body: dict) -> list[int]:
    """The prompt ids the batched tier encodes for a chat body."""
    return api._encode_chat([(m["role"], str(m["content"])) for m in body["messages"]],
                            add_bos=True)


def near_tie(loaded, prompt, ids, other, label: str) -> str | None:
    """None when `ids` equals `other`; else the first position where they
    differ and the single engine's top-2 logit margin there (its plain
    replay of the prompt and the ids before it) beside TOL_FWD *
    max|logit|, printed and returned. Fails when the margin is not a near
    tie: then the runs differ by more than rounding."""
    import torch

    if ids == other:
        return None
    i = next((j for j, (a, b) in enumerate(zip(ids, other)) if a != b), min(len(ids), len(other)))
    eng = loaded.engine
    eng.reset(0)
    logits = eng.prefill(list(prompt))
    for t in ids[:i]:
        logits = eng.decode_step([[t]])
    top2 = torch.topk(logits[0].float(), 2).values
    gap, scale = (top2[0] - top2[1]).item(), logits.abs().max().item()
    eng.reset(0)
    msg = (f"{label}: ids first differ at token {i} ({ids[i:i + 1]} vs {other[i:i + 1]}); "
           f"top-2 logit margin there {gap:.4e}, TOL_FWD * max|logit| {TOL_FWD * scale:.4e}")
    print(f"divergence {msg}", flush=True)
    if not gap < TOL_FWD * scale:
        fail(f"{msg}: not a near tie")
    return msg


def spec_lockstep_check(eng, admits: list, want: int, script=(("spec", 4), ("plain", 2))
                        ) -> dict:
    """The batched spec programs' tokens held against plain decode's, bit
    for bit, on one BatchEngine whose verify forward stays on the decode
    kernel's route (n_slots * (K+1) <= 16 rows: K1, as plain decode): the
    slots `admits` ([(prompt ids, add() keywords)], greedy, sampled and
    penalized) run `script` over and over (spec chunks with plain chunks
    between them, so the generator counter crosses the switch) until every
    slot has `want` tokens, then again from the same prompts in plain
    chunks alone. Every slot's first `want` tokens must be equal: a
    sampled row drawn at a wrong counter, or from a wrong row of the verify
    forward, is a different token within a few draws. -> {"spec", "plain"
    (the streams), "stats" (spec_stats() of the spec run), "chunks"}."""
    def run(plan):
        streams = {s: [eng.add(s, toks, **kw)] for s, (toks, kw) in enumerate(admits)}
        s0, chunks = eng.spec_stats(), 0
        while min(len(v) for v in streams.values()) < want:
            for kind, n in plan:
                chunk = eng.decode_dispatch(n, spec=kind == "spec")
                toks = eng.decode_consume(chunk)
                chunks += 1
                for s in streams:
                    streams[s] += [int(t) for t in toks[: int(chunk.advance[s]), s]]
        s1 = eng.spec_stats()
        for s in streams:
            eng.release(s)
        return ({s: v[:want] for s, v in streams.items()}, chunks,
                {k: s1[k] - s0[k] for k in ("cycles", "drafted", "accepted", "emitted")})

    spec, chunks, stats = run(script)
    plain, _, _ = run((("plain", 4),))
    if not stats["cycles"] or not stats["accepted"]:
        fail(f"spec lockstep: the spec run ran {stats} (no accepted draft)")
    for s in spec:
        if spec[s] != plain[s]:
            i = next(j for j, (x, y) in enumerate(zip(spec[s], plain[s])) if x != y)
            fail(f"spec lockstep: slot {s} ({admits[s][1]}) differs from plain decode at "
                 f"token {i}: {spec[s][i:i + 4]} vs {plain[s][i:i + 4]}")
    return {"spec": spec, "plain": plain, "stats": stats, "chunks": chunks}


def _post(port: int, body: dict) -> tuple[int, bytes]:
    return _post_timed(port, body)[:2]


def _headers(req_id: str = "") -> dict:
    return {"Content-Type": "application/json", **({"X-Request-Id": req_id} if req_id else {})}


def _post_timed(port: int, body: dict, req_id: str = "") -> tuple[int, bytes, float]:
    """-> (status, body, time.perf_counter() when the request was sent);
    `req_id` goes out as X-Request-Id."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t_sent = time.perf_counter()
    conn.request("POST", "/v1/chat/completions", json.dumps(body),
                 _headers(req_id))
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data, t_sent


def phase_serve(loaded, prompt: str) -> dict:
    """Four requests over HTTP; returns TTFT / decode-rate figures."""
    from dllama_tpu_torch.serve.api import make_server

    httpd, api = make_server(loaded, host="127.0.0.1", port=0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    port = httpd.server_address[1]
    try:
        msgs = [{"role": "user", "content": prompt}]
        body = {"messages": msgs, "temperature": 0, "max_tokens": 32}
        st, raw = _post(port, body)
        if st != 200:
            fail(f"serve: first completion answered {st}: {raw[:300]!r}")
        first = json.loads(raw)
        if first["usage"]["prompt_tokens"] < 64:
            fail(f"serve: prompt of {first['usage']['prompt_tokens']} tokens, want >= 64")
        st, raw = _post(port, body)
        again = json.loads(raw)
        c1 = first["choices"][0]["message"]["content"]
        if st != 200 or again["choices"][0]["message"]["content"] != c1:
            fail("serve: the same greedy request gave different content")
        st, raw = _post(port, dict(body, stream=True))
        events = [ln for ln in raw.decode().split("\n") if ln.startswith("data: ")]
        if st != 200 or not events or events[-1] != "data: [DONE]":
            fail(f"serve: SSE stream did not end in [DONE]: {events[-2:]}")
        streamed = "".join(json.loads(e[6:])["choices"][0]["delta"].get("content", "")
                           for e in events[:-1])
        if streamed != c1:
            fail("serve: streamed content differs from the non-stream completion")
        turn2 = msgs + [{"role": "assistant", "content": c1},
                        {"role": "user", "content": "And then?"}]
        st, raw = _post(port, {"messages": turn2, "temperature": 0, "max_tokens": 8})
        second = json.loads(raw)
        from dllama_tpu_torch.tokenizer.chat import ChatItem

        full = len(loaded.tokenizer.encode(api.template.generate(
            [ChatItem(m["role"], m["content"]) for m in turn2]).content))
        if st != 200 or second["usage"]["prompt_tokens"] >= full:
            fail(f"serve: second turn missed the prefix cache "
                 f"({second['usage'].get('prompt_tokens')} of {full} tokens)")
    finally:
        httpd.shutdown()
        httpd.server_close()
    t = first["timings"]
    n = first["usage"]["completion_tokens"]
    decode_s = (t["e2e_ms"] - t["ttft_ms"]) / 1e3
    return {"ttft_ms": t["ttft_ms"], "completion_tokens": n,
            "decode_tok_s": (n - 1) / decode_s if n > 1 and decode_s > 0 else None,
            "prefix_hit_prompt_tokens": second["usage"]["prompt_tokens"],
            "full_conversation_tokens": full}


# ------------------------------------------------------------ phase 5


def batch_prompts(n: int) -> list[str]:
    """n distinct chat prompts of at least 64 tokens each."""
    topics = ["a lighthouse keeper", "a desert caravan", "a clockmaker's apprentice",
              "a deep-sea station", "a mountain village", "a city of canals",
              "an orbital greenhouse", "a winter market"]
    return [f"Request {i}: write a long and careful summary of a story about "
            f"{topics[i % len(topics)]}, a storm that lasts for seven days, a ship that never "
            f"arrives, three letters that are never sent, and a quiet ending by the sea."
            for i in range(n)]


def _concurrently(fn, args_list) -> list:
    out = [None] * len(args_list)

    def run(i, args):
        out[i] = fn(*args)

    threads = [threading.Thread(target=run, args=(i, a)) for i, a in enumerate(args_list)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
        if th.is_alive():
            fail("batch: a request thread did not finish within 600 s")
    return out


def phase_batch(loaded, n_slots: int = 8, max_tokens: int = 32,
                mm_kernels: tuple = Q40_KERNELS, prefill_budget="auto", **server_kw) -> dict:
    """make_server with slots (what `serve --slots 8` runs) over real HTTP,
    at `prefill_budget` (the server's default, hybrid, unless given): the
    auto layout, n concurrent greedy chat requests twice (identical
    contents), one SSE stream, a seeded sampled request alone and among
    penalized batch-mates (the same stream), and the page pool after the
    drain. The launch counters are zeroed before the requests and read
    after them: every forward launches the model's matmul kernels
    (`mm_kernels`, those of its weight format, and no other format's) at
    least mm_per_forward times. `server_kw` goes to make_server (e.g.
    warmup="auto"); the captures the server made and those outside its
    warm-up's contract are returned.
    With phase-split admission (budget 0) decode must really run batched:
    the first round's decode chunks must carry more than MIN_BATCH_SLOTS
    live slots on average. (Hybrid admits the n prompts one after another,
    each over several chunks, so its first round carries fewer by design;
    phase_hybrid holds the same requests to MIN_BATCH_SLOTS at budget 0.)"""
    from dllama_tpu_torch.serve.api import graceful_drain, make_server

    import torch

    from dllama_tpu_torch.engine.sampling import philox_uniforms
    from dllama_tpu_torch.obs import compile as compile_obs

    # the per-slot generator gives the same bits on the CPU and the card
    seeds = torch.tensor([0, 1, 2**40 + 5, 2**62 + 3, 2**63 - 1], dtype=torch.int64)
    ctrs = torch.tensor([0, 1, 2**31, 2**33 + 7, 2**62], dtype=torch.int64)
    if not torch.equal(philox_uniforms(seeds, ctrs),
                       philox_uniforms(seeds.to(loaded.engine.device),
                                       ctrs.to(loaded.engine.device)).cpu()):
        fail("batch: Philox uniforms differ between the CPU and the card")
    captures0 = (compile_obs.LEDGER.total_compiles(), compile_obs.LEDGER.total_unexpected())
    httpd, api = make_server(loaded, host="127.0.0.1", port=0, n_slots=n_slots,
                             prefill_budget=prefill_budget, **server_kw)
    eng = api.scheduler.engine
    if (eng.kv_layout, eng.page_size, eng.attn_route) != ("paged", 128, "paged_kernel"):
        fail(f"batch: --kv-layout auto resolved to {eng.kv_layout} page {eng.page_size} "
             f"route {eng.attn_route}; want paged, 128, paged_kernel")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    trace = IdTrace(api.scheduler)
    bodies = [{"messages": [{"role": "user", "content": p}], "temperature": 0,
               "max_tokens": max_tokens} for p in batch_prompts(n_slots)]
    try:
        sched = api.scheduler
        f0 = eng.forwards
        reset_counters()
        rounds, walls, sent, occupancy = [], [], [], []
        for _ in range(2):
            c0, s0 = sched.chunks, sched.chunk_slots
            t0 = time.perf_counter()
            replies = _concurrently(_post_timed, [(port, b) for b in bodies])
            walls.append(time.perf_counter() - t0)
            chunks = sched.chunks - c0
            occupancy.append((sched.chunk_slots - s0) / chunks if chunks else 0.0)
            bad = [(st, raw[:200]) for st, raw, _ in replies if st != 200]
            if bad:
                fail(f"batch: {len(bad)} of {n_slots} requests failed: {bad[:2]}")
            rounds.append([json.loads(raw) for _, raw, _ in replies])
            sent.append([t for _, _, t in replies])
        st, raw = _post(port, dict(bodies[0], stream=True))
        # a seeded sampled request gives one stream alone and among 7
        # batch-mates that decode penalized-greedy in the same chunks. It is
        # sent once before, so that the tree holds its first page for both
        # compared runs and both prefill the same rows in the same slices
        sampled = {"messages": [{"role": "user", "content": "Sample: " + batch_prompts(1)[0]}],
                   "temperature": 0.8, "top_p": 0.9, "seed": 11, "max_tokens": 16}
        mates = [dict(b, frequency_penalty=0.5, presence_penalty=0.3) for b in bodies[1:]]
        _post(port, sampled)
        mixed = [_post(port, sampled)] + _concurrently(
            _post, [(port, sampled)] + [(port, b) for b in mates])
        launches = counters()
        forwards = eng.forwards - f0
    finally:
        clean = graceful_drain(httpd, api, timeout_s=120)
        httpd.server_close()
    captures = (compile_obs.LEDGER.total_compiles() - captures0[0],
                compile_obs.LEDGER.total_unexpected() - captures0[1])
    if prefill_budget == 0 and not occupancy[0] > MIN_BATCH_SLOTS:
        fail(f"batch: the first round's decode chunks carried {occupancy[0]:.2f} live slots "
             f"on average, want > {MIN_BATCH_SLOTS}: decode did not run batched")
    contents = [[r["choices"][0]["message"]["content"] for r in rnd] for rnd in rounds]
    near_ties = []
    if contents[0] != contents[1]:  # each pair equal, or apart at a near tie only
        for i, b in enumerate(bodies):
            p = prompt_ids(api, b)
            first, second = trace.of(p)[:2]
            near_ties.append(near_tie(loaded, p, second, first, f"batch round 2, request {i}"))
    bad = [(st, raw[:200]) for st, raw in mixed if st != 200]
    if bad:
        fail(f"batch: {len(bad)} sampled/penalized requests failed: {bad[:2]}")
    alone, among = (json.loads(raw)["choices"][0]["message"]["content"] for _, raw in mixed[:2])
    if alone != among:
        fail("batch: a seeded sampled stream changed with its batch-mates")
    prompt_tokens = min(r["usage"]["prompt_tokens"] for r in rounds[0])
    if prompt_tokens < 64:
        fail(f"batch: a prompt of {prompt_tokens} tokens, want >= 64")
    events = [ln for ln in raw.decode().split("\n") if ln.startswith("data: ")]
    if st != 200 or not events or events[-1] != "data: [DONE]":
        fail(f"batch: SSE stream did not end in [DONE]: {events[-2:]}")
    streamed = "".join(json.loads(e[6:])["choices"][0]["delta"].get("content", "")
                       for e in events[:-1])
    if streamed != contents[0][0]:
        p = prompt_ids(api, bodies[0])
        runs = trace.of(p)
        near_ties.append(near_tie(loaded, p, runs[2], runs[0], "batch SSE stream"))
    mm = sum(launches[k] for k in mm_kernels)
    other = sum(launches[k] for k in Q40_KERNELS + Q80_KERNELS if k not in mm_kernels)
    per_fwd = mm_per_forward(loaded.config)
    if (launches["paged_attention"] < loaded.config.n_layers * forwards
            or mm < per_fwd * forwards or other or launches["flash_attention"]):
        fail(f"batch: {launches} for {forwards} batched forwards (want >= "
             f"{loaded.config.n_layers} paged_attention and >= {per_fwd} {mm_kernels} launches "
             f"each, no other matmul kernel, 0 flash_attention)")
    report = eng.pool.audit(raise_on_fail=False)
    if not (clean and report["ok"] and report["free"] == report["total"]):
        fail(f"batch: drain clean {clean}, pool after it {report}")
    summary = api.scheduler.latency_summary()
    # the first round's decode window on one clock: from the first request's
    # first token to the last request's end (each request's own submit time
    # plus its server-side ttft / e2e). Its decode tokens are those after
    # each request's first token, which comes from prefill.
    first = rounds[0]
    n_tok = [r["usage"]["completion_tokens"] for r in first]
    window_s = (max(t + r["timings"]["e2e_ms"] / 1e3 for r, t in zip(first, sent[0]))
                - min(t + r["timings"]["ttft_ms"] / 1e3 for r, t in zip(first, sent[0])))
    return {"slots": n_slots, "forwards": forwards, "launches": launches,
            "completion_tokens": sum(n_tok), "decode_tokens": sum(n - 1 for n in n_tok),
            "decode_window_s": window_s,
            "agg_decode_tok_s": sum(n - 1 for n in n_tok) / window_s if window_s > 0 else None,
            "decode_slots_mean": occupancy,
            "agg_tok_s_with_prefill": sum(n_tok) / walls[0],
            "ttft_ms_p50": summary["ttft_ms_p50"], "ttft_ms_max": summary["ttft_ms_max"],
            "round_wall_s": walls, "reused_prefix_tokens": summary["reused_prefix_tokens"],
            "near_ties": [m for m in near_ties if m],
            "captures": captures[0], "unexpected_captures": captures[1],
            "pool_after_drain": {k: report[k] for k in ("total", "free", "ok")}}


def phase_profile_batch(loaded, n_slots: int = 8, steps: int = 8, names=K1_NAMES) -> dict:
    """torch.profiler over one n_slots-slot decode chunk of `steps` tokens
    on a paged BatchEngine, every slot live after a prefill (the split of
    decode_split by the kernel names `names`)."""
    import torch

    from dllama_tpu_torch.engine.batch import BatchEngine

    eng = loaded.engine
    be = BatchEngine(loaded.config, eng.params, n_slots=n_slots, cache_dtype=torch.bfloat16,
                     max_seq_len=eng.seq_len, kv_layout="paged", page_size=128,
                     device=eng.device)
    for slot, p in enumerate(batch_prompts(n_slots)):
        be.add(slot, loaded.tokenizer.encode(p), temperature=0.0)
    be.decode(steps)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    be.decode(steps)  # the same chunk without the profiler's cost
    torch.cuda.synchronize()
    bare = time.perf_counter() - t0
    with profiled() as prof:
        t0 = time.perf_counter()
        be.decode(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = device_ops(prof)
    device_us = sum(v[0] for v in by_name.values())
    del be
    torch.cuda.empty_cache()
    top = sorted(((v[0], name) for name, v in by_name.items()), reverse=True)[:6]
    return {"slots": n_slots, "steps": steps, "wall_ms_per_step": wall / steps * 1e3,
            "device_ms_per_step": device_us / steps / 1e3,
            "device_busy_share": device_us / 1e6 / wall if wall else None,
            "agg_tok_s": n_slots * steps / wall,
            "unprofiled_ms_per_step": bare / steps * 1e3,
            "unprofiled_agg_tok_s": n_slots * steps / bare,
            **decode_split(by_name, steps, names),
            "top": [(name[:60], round(us / steps / 1e3, 4)) for us, name in top]}


# ------------------------------------------------------------ phases 7-8


def check_forward(loaded, device, label: str) -> float:
    rel = phase_forward(loaded, device)
    print(f"{label}: prefill 256 + 8 decode + a 9-row verify, max|logit diff|/max|logit| = "
          f"{rel:.3e} <= "
          f"{TOL_FWD}", flush=True)
    if not rel <= TOL_FWD:
        fail(f"{label}: kernels vs plain logits differ by {rel} of max|logit|")
    return rel


def serve_checked(loaded, prompt: str, label: str, mm_kernels: tuple, per_fwd: int,
                  attn: str) -> dict:
    """phase_serve with the launch counters zeroed just before and read just
    after: at least `per_fwd` launches of `mm_kernels` and n_layers of
    `attn` per forward, none of the other weight format's kernels."""
    n_layers = loaded.config.n_layers
    f0 = loaded.engine.forwards
    reset_counters()
    serve = phase_serve(loaded, prompt)
    launches = counters()
    fwd = loaded.engine.forwards - f0
    print(f"{label}: {serve}; forwards {fwd}; launches {launches}", flush=True)
    mm = sum(launches[k] for k in mm_kernels)
    other = sum(launches[k] for k in Q40_KERNELS + Q80_KERNELS if k not in mm_kernels)
    if mm < per_fwd * fwd or launches[attn] < n_layers * fwd or other:
        fail(f"{label}: {mm} {mm_kernels} / {launches[attn]} {attn} launches for {fwd} "
             f"forwards (want >= {per_fwd} / {n_layers} each and no other matmul kernel)")
    return launches


def phase_f8(mpath: str, tpath: str, device, prompt: str) -> dict:
    """The Q40 8B file with the f8 (e4m3) KV cache on the dense layout: the
    forward through the kernels against the plain versions, then HTTP on the
    single-engine tier, every forward launching K7's f8 mode in every layer
    (and never its bf16 mode). Returns the launches of the serve run."""
    import torch

    from dllama_tpu_torch.engine.loader import load_model

    loaded = load_model(mpath, tpath, max_seq_len=4096, mesh=None,
                        cache_dtype=torch.float8_e4m3fn,
                        device=device)
    eng = loaded.engine
    if eng.cache.k.dtype != torch.float8_e4m3fn or eng.attn_route != "flash":
        fail(f"f8: cache {eng.cache.k.dtype}, attention {eng.attn_route}; want e4m3, flash")
    check_forward(loaded, device, "f8 forward")
    launches = serve_checked(loaded, prompt, "f8 serve", Q40_KERNELS,
                             7 * loaded.config.n_layers + 1, "flash_attention_f8")
    if launches["flash_attention"]:
        fail(f"f8 serve: {launches['flash_attention']} launches of K7's bf16 mode")
    del loaded, eng
    torch.cuda.empty_cache()
    return launches


def q80_model(tmp: str, device):
    """The synthetic Llama-3.1-8B Q80 `.m` and its `.t`, written to `tmp`
    and loaded packed -> (loaded, model path, tokenizer path)."""
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.ops.quant import Q8Tensor

    cfg = llama31_8b(N_LAYERS_8B, "Q80")
    mpath, tpath = os.path.join(tmp, "llama31_8b_q80.m"), os.path.join(tmp, "tok.t")
    t0 = time.perf_counter()
    write_model(mpath, cfg, device)
    write_tokenizer(tpath, cfg.vocab_size)
    print(f"q80: wrote synthetic {cfg.describe()} ({os.path.getsize(mpath) / 1e9:.2f} GB) "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    loaded = load_model(mpath, tpath, max_seq_len=4096, mesh=None, device=device)
    print(f"q80: load_model {time.perf_counter() - t0:.1f} s; kernels={loaded.engine.backend} "
          f"attention={loaded.engine.attn_route}", flush=True)
    layers_p = loaded.engine.params["layers"]
    if not all(isinstance(layers_p[k], Q8Tensor) for k in ("wq", "wk", "wv", "wo", "w1",
                                                           "w2", "w3")):
        fail("q80: the weights did not load as packed Q8Tensors")
    return loaded, mpath, tpath


def phase_q80(device, prompt: str) -> dict:
    """A synthetic Llama-3.1-8B Q80 `.m` at full width and depth, loaded
    packed: the forward through K5/K6 against the plain versions; HTTP on
    the single-engine tier; `serve --slots 8` (paged, K9) with the RMSNorm
    switch at 'cuda' (K10 on a served path; restored after); the CLI's
    `inference --fuse-weights`, whose greedy text must equal the unfused
    engine's. Every sub-check zeroes the launch counters just before it and
    reads them just after: Q80 kernels on every forward (>= 7L+1 unfused,
    >= 4L+1 fused per forward) and no Q40 launch; >= 2L+1 rms_norm launches
    per forward with the switch on. Returns the launches summed over the
    sub-checks."""
    import torch

    from dllama_tpu_torch.cli.main import main as cli
    from dllama_tpu_torch.engine.sampling import Sampler
    from dllama_tpu_torch.ops import layers

    n_layers = N_LAYERS_8B
    with tempfile.TemporaryDirectory(prefix="dllama_smoke_q80_") as tmp:
        loaded, mpath, tpath = q80_model(tmp, device)
        check_forward(loaded, device, "q80 forward")
        report_chunk("Q80 dense (K6 + K7)", prefill_chunk_ms(loaded, device))
        total: dict[str, int] = {}

        def add(launches):
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v

        add(serve_checked(loaded, prompt, "q80 serve", Q80_KERNELS, 7 * n_layers + 1,
                          "flash_attention"))
        layers.RMS_NORM_IMPL = "cuda"
        try:
            # phase-split admission: the Q80 server keeps the occupancy check
            batch = phase_batch(loaded, mm_kernels=Q80_KERNELS, prefill_budget=0)
            k10 = phase_profile_batch(loaded, names=("rms_norm_kernel",))
        finally:
            layers.RMS_NORM_IMPL = "torch"
        k10_per = k10["q40_ms_per_step"] / max(k10["q40_launches_per_step"], 1)
        print(f"q80 batch K10 inside the decode graph: {k10['q40_ms_per_step']:.4f} ms in "
              f"{k10['q40_launches_per_step']:.1f} launches a step ({k10_per:.5f} ms a launch) "
              f"of {k10['device_ms_per_step']:.3f} ms device time; {k10['wall_ms_per_step']:.3f} "
              f"ms a step wall", flush=True)
        launches = batch.pop("launches")
        print(f"q80 batch: {batch}; launches {launches}", flush=True)
        if launches["rms_norm"] < (2 * n_layers + 1) * batch["forwards"]:
            fail(f"q80 batch: {launches['rms_norm']} rms_norm launches for "
                 f"{batch['forwards']} forwards (want >= {2 * n_layers + 1} each)")
        add(launches)

        # the unfused engine's greedy text, as the CLI prints it
        eng, tok = loaded.engine, loaded.tokenizer
        eng.reset(0)
        tok.reset_decoder()
        ids = list(eng.generate(tok.encode(prompt, add_bos=True), 32, Sampler(0.0, 0.9, 0),
                                stop_fn=tok.is_eos))
        want = "".join(p for p in (tok.decode(t) for t in ids) if p) + "\n"
        del loaded, eng
        torch.cuda.empty_cache()

        reset_counters()
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli(["inference", "--model", mpath, "--tokenizer", tpath, "--prompt", prompt,
                      "--temperature", "0", "--steps", "32", "--max-seq-len", "4096",
                      "--fuse-weights", "--no-mesh"])
        launches = counters()
        stats = [ln for ln in err.getvalue().splitlines()
                 if ln.startswith(("Prefill:", "Decode:"))]
        print(f"q80 inference --fuse-weights: rc {rc}; {' | '.join(stats)}; launches {launches}",
              flush=True)
        decode_tokens = len(ids) - 1  # every token after the first takes a decode forward
        mm = sum(launches[k] for k in Q80_KERNELS)
        if rc != 0 or mm < (4 * n_layers + 1) * (decode_tokens + 1) or any(
                launches[k] for k in Q40_KERNELS):
            fail(f"q80 inference: rc {rc}, launches {launches} for >= {decode_tokens + 1} "
                 f"forwards (want >= {4 * n_layers + 1} Q80 and no Q40 launches each)")
        if out.getvalue() != want:
            fail(f"q80 inference: the fused CLI's greedy text differs from the unfused "
                 f"engine's: {out.getvalue()[:200]!r} vs {want[:200]!r}")
        print(f"q80 inference: fused greedy text equals the unfused engine's "
              f"({len(ids)} tokens)", flush=True)
        add(launches)
    torch.cuda.empty_cache()
    return total


# ------------------------------------------------------------ phases 9-11


def phase_kbench() -> dict:
    """The port's kernel benchmark in this process (its launch counts are
    read here): `suite`, then `8 w1 B D` (the suite runs B only in its smoke
    form). Fails on a FAILED row, a missing KBENCH DONE or an unlaunched
    K11 kernel. Returns the launches."""
    from dllama_tpu_torch.experiments import kbench

    reset_counters()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rcs = [kbench.main(["suite"]), kbench.main(["8", "w1", "B", "D"])]
    launches = counters()
    lines = buf.getvalue().splitlines()
    for ln in lines:
        print(f"  kbench| {ln}")
    print(f"kbench: {time.perf_counter() - t0:.1f} s; launches {launches}", flush=True)
    if any(rcs) or [ln for ln in lines if "FAILED" in ln] or "KBENCH DONE" not in lines:
        fail(f"kbench: exit codes {rcs}, a FAILED row or no KBENCH DONE")
    if not any(ln.startswith("m=8 w1: B fma-f32=") and "D bf16-ref=" in ln for ln in lines):
        fail("kbench: no `8 w1 B D` row")
    if not (launches["kbench_fma_f32"] and launches["kbench_bf16_gemm"]):
        fail(f"kbench: K11-B/K11-D were not launched: {launches}")
    return launches


def _cli(argv: list[str]) -> tuple[int, str, list[str]]:
    """The CLI in this process -> (exit code, stdout, its stats lines)."""
    from dllama_tpu_torch.cli.main import main as cli

    out, err = io.StringIO(), io.StringIO()
    if "--mesh" not in argv:
        argv = argv + ["--no-mesh"]  # one device even on a machine with several
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli(argv)
    stats = [ln for ln in err.getvalue().splitlines()
             if ln.startswith(("Prefill:", "Decode:", "Speculation:"))]
    return rc, out.getvalue(), stats


def _stat(stats: list[str], head: str) -> int:
    """The first integer of the stats line starting with `head` (0 if none)."""
    line = next((ln for ln in stats if ln.startswith(head)), "")
    return int(line.split()[1]) if line else 0


def inference_argv(mpath: str, tpath: str, prompt: str) -> list[str]:
    """The CLI's greedy `inference` run of 32 tokens on the smoke's files."""
    return ["inference", "--model", mpath, "--tokenizer", tpath, "--prompt", prompt,
            "--temperature", "0", "--steps", "32", "--max-seq-len", "4096"]


def phase_styles(loaded, device, mpath: str, tpath: str, prompt: str,
                 auto_text: str | None = None) -> dict:
    """The Q40 8B model under q40_matmul.STYLE = maskdot, loopdot and deq:
    the forward (256-token prefill, 8 decode steps, a 9-row verify forward)
    against the plain versions, with its exact launch counts (a decode or
    verify forward launches the style's kernel 7L+1 times, a prefill chunk
    K2 in its 7L layer matmuls and the style's kernel for its one-row
    lm-head), then 32 greedy tokens
    through the `inference` CLI: no K1 launch, the style's kernel 7L+1 times
    per decode forward, K2 on prefill chunks; each text beside STYLE auto's
    (`auto_text`, the inference phase's, or run here). Returns {style:
    launches}."""
    from dllama_tpu_torch.ops import q40_matmul as q40

    n_layers = loaded.config.n_layers
    per_fwd = 7 * n_layers + 1
    argv = inference_argv(mpath, tpath, prompt)
    if auto_text is None:
        rc, auto_text, _ = _cli(argv)
    print(f"styles auto inference: text {auto_text[:60]!r}", flush=True)
    out = {}
    for style in ("maskdot", "loopdot", "deq"):
        kernel = STYLE_KERNELS[style]
        with q40.forced_style(style):
            reset_counters()
            check_forward(loaded, device, f"styles {style} forward")
            fwd = counters()
            rc, text, stats = _cli(argv)
            launches = counters()
        # 8 decode forwards and the 9-row verify forward take the style's
        # kernel in every matmul, the prefill its lm-head row only
        want = ({"q40_prefill": 10 * per_fwd} if style == "deq"
                else {kernel: 9 * per_fwd + 1, "q40_prefill": 7 * n_layers})
        got = {k: fwd[k] for k in Q40_KERNELS + Q80_KERNELS if fwd[k]}
        if got != want:
            fail(f"styles {style} forward: launches {got}, want {want}")
        cli_l = {k: launches[k] - fwd[k] for k in launches}
        decode = _stat(stats, "Decode:")
        print(f"styles {style} inference: rc {rc}; {' | '.join(stats)}; text {text[:60]!r} "
              f"(auto's: {text == auto_text}); launches {cli_l}", flush=True)
        others = [k for k in Q40_KERNELS if k not in (kernel, "q40_prefill") and cli_l[k]]
        if rc or decode < 1 or others or cli_l[kernel] < per_fwd * decode or not cli_l["q40_prefill"]:
            fail(f"styles {style} inference: rc {rc}, {decode} decode forwards, launches {cli_l} "
                 f"(want >= {per_fwd} {kernel} each, K2 on prefill, none of {others})")
        out[style] = launches
    return out


def phase_spec(loaded, mpath: str, tpath: str) -> dict:
    """Speculative decoding on the Q40 8B model: `inference --spec 8` on a
    repetitive prompt (its emitted tokens and verify forwards; every verify
    forward launches K1 7L+1 times and K7 L times); the greedy ids of spec 8
    and spec 0 through the engine, which must be equal or first differ where
    the plain run's top-2 logit gap is under TOL_FWD * max|logit| (a near
    tie the verify forward's sum order may flip); the CLI's text equal to
    the spec run's; then 32 tokens at --spec 8 (the captured verify cycles:
    tokens, cycles and replays) and at --spec 0 (4 decode chunks of 8, as
    generate runs them), ms a token wall, stream and device (chunk_timing),
    after the repetitive prompt and after SPEC_PLAIN_PROMPT;
    HTTP on the single-engine tier with --spec 8, a default request and a
    spec_k 0 one. Returns the launches of the CLI and serve runs."""
    import torch

    from dllama_tpu_torch.engine.sampling import Sampler
    from dllama_tpu_torch.serve.api import make_server

    eng, tok = loaded.engine, loaded.tokenizer
    n_layers = loaded.config.n_layers
    prompt = "The bell rings at noon. " * 10 + "The bell rings"
    reset_counters()
    rc, text, stats = _cli(["inference", "--model", mpath, "--tokenizer", tpath, "--prompt",
                            prompt, "--temperature", "0", "--steps", "32", "--max-seq-len",
                            "4096", "--spec", "8"])
    launches = counters()
    emitted, cycles = _stat(stats, "Speculation:"), 0
    if emitted:
        cycles = int(next(ln for ln in stats if ln.startswith("Speculation:")).split()[4])
    print(f"spec inference --spec 8: rc {rc}; {' | '.join(stats)}; launches {launches}",
          flush=True)
    print(f"spec: emitted {emitted} tokens in {cycles} verify forwards", flush=True)
    if (rc or not cycles or launches["q40_decode"] < (7 * n_layers + 1) * cycles
            or launches["flash_attention"] < n_layers * cycles):
        fail(f"spec inference: rc {rc}, {cycles} verify forwards, launches {launches}")

    ptoks = tok.encode(prompt, add_bos=True)
    ids = {}
    for k in (8, 0):
        eng.reset(0)
        ids[k] = list(eng.generate(ptoks, 32, Sampler(0.0, 0.9, 0), stop_fn=tok.is_eos, spec=k))
    tok.reset_decoder()
    spec_text = "".join(p for p in (tok.decode(t) for t in ids[8]) if p) + "\n"
    if spec_text != text:
        fail("spec: the CLI's text differs from the engine's spec 8 run")
    near_tie = False
    if ids[8] != ids[0]:
        i = next((j for j, (a, b) in enumerate(zip(ids[8], ids[0])) if a != b),
                 min(len(ids[8]), len(ids[0])))
        eng.reset(0)
        logits = eng.prefill(ptoks)  # replay the plain run up to token i
        for t in ids[0][:i]:
            logits = eng.decode_step([[t]])
        top2 = torch.topk(logits[0].float(), 2).values
        gap, scale = (top2[0] - top2[1]).item(), logits.abs().max().item()
        print(f"spec: ids first differ at token {i} ({ids[8][i:i + 1]} vs {ids[0][i:i + 1]}); "
              f"plain run's top-2 logit gap there {gap:.4e}, TOL_FWD * max|logit| "
              f"{TOL_FWD * scale:.4e}", flush=True)
        if not gap < TOL_FWD * scale:
            fail(f"spec: greedy ids of spec 8 and spec 0 differ at token {i} with no near tie")
        near_tie = True
    else:
        print(f"spec: greedy ids of spec 8 equal spec 0's ({len(ids[0])} tokens)", flush=True)
    spec_timing(eng, ptoks, "repetitive")
    spec_timing(eng, tok.encode(SPEC_PLAIN_PROMPT, add_bos=True), "non-repetitive")

    httpd, api = make_server(loaded, host="127.0.0.1", port=0, spec=8)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    body = {"messages": [{"role": "user", "content": prompt}], "temperature": 0,
            "max_tokens": 32}
    reset_counters()
    try:
        eng._spec_stats = None
        st1, raw1 = _post(httpd.server_address[1], body)
        used_spec = eng._spec_stats is not None
        eng._spec_stats = None
        st0, raw0 = _post(httpd.server_address[1], dict(body, spec_k=0))
        opted_out = eng._spec_stats is None
    finally:
        httpd.shutdown()
        httpd.server_close()
    serve_l = counters()
    if st1 != 200 or st0 != 200 or not used_spec or not opted_out:
        fail(f"spec serve: status {st1}/{st0}, speculated {used_spec}, spec_k 0 opted out "
             f"{opted_out}")
    c1, c0 = (json.loads(r)["choices"][0]["message"]["content"] for r in (raw1, raw0))
    print(f"spec serve --spec 8: content equal to the spec_k 0 request's: {c1 == c0}; "
          f"launches {serve_l}", flush=True)
    if c1 != c0 and not near_tie:
        fail("spec serve: --spec 8 and spec_k 0 gave different content")
    return {k: launches[k] + serve_l[k] for k in launches}


#: the spec phase's second timed prompt: prose that does not repeat itself
#: (the first is one sentence ten times over)
SPEC_PLAIN_PROMPT = ("Quick zephyrs blow, vexing daft Jim, while a wizard's job is to keep "
                     "five dozen liquor jugs boxed for the night market at Grimsby.")


def spec_timing(eng, ptoks: list[int], label: str, n: int = 32, k: int = 8) -> dict:
    """n greedy tokens after the prompt `ptoks` through the single engine at
    --spec k (decode_spec_greedy_n: captured verify cycles, one count read
    a replay) and at --spec 0 (n / 8 decode chunks of 8, one host read
    each, as generate runs them): tokens, cycles and replays, and the wall,
    stream and device ms a token (chunk_timing, each run from the same
    position). Prints (under `label`) and returns both."""
    import torch

    eng.reset(0)
    first = int(torch.argmax(eng.prefill(ptoks)[0]))
    p0 = eng.pos

    def spec_run():
        eng.reset(p0)
        return eng.decode_spec_greedy_n(ptoks, first, n, k=k)

    def plain_run():
        eng.reset(p0)
        tok = first
        for _ in range(n // 8):
            tok = int(eng.decode_greedy_n([[tok]], 8)[-1, 0])

    out = {"spec": chunk_timing(spec_run, n), "plain": chunk_timing(plain_run, n)}
    out["spec"].update(eng._spec_stats, replays=eng.spec_replays)
    eng.reset(0)
    s, p = out["spec"], out["plain"]
    print(f"spec timing, {label} prompt, --spec {k}: {s['emitted']} tokens in {s['cycles']} "
          f"cycles, {s['replays']} replays; {s['wall_ms']:.3f} ms/token wall, {s['stream_ms']:.3f} "
          f"stream, {s['device_ms']:.3f} device (busy {s['busy']:.3f}); --spec 0: "
          f"{p['wall_ms']:.3f} ms/token wall, {p['stream_ms']:.3f} stream, "
          f"{p['device_ms']:.3f} device (busy {p['busy']:.3f})", flush=True)
    if not s["cycles"] or s["replays"] > s["cycles"]:
        fail(f"spec timing, {label} prompt: {s['cycles']} cycles in {s['replays']} replays")
    return out


#: spec_batch phase: the draft length, decode tokens a stream, and the
#: cycles a timed spec chunk runs
SPEC_BATCH_K = 4
SPEC_BATCH_TOKENS = 128
SPEC_BATCH_CYCLES = 4
#: spec_batch phase: the tokens a slot of spec_lockstep_check compares
SPEC_BATCH_LOCKSTEP = 48


def _spec_batch_bodies() -> dict:
    """The spec_batch traffic: 8 streams on repetitive prompts (s0 priority
    0, the preemption's victim; s4 spec_k 0; s5, s6 sampled; s7 sampled with
    penalties; the rest greedy) and the priority-2 arrival `hi`."""
    out = {}
    for i in range(8):
        kw: dict = {}
        if i == 0:
            kw["priority"] = 0
        if i == 4:
            kw["spec_k"] = 0
        if i in (5, 6, 7):
            kw.update(temperature=0.8, seed=100 + i)
        if i == 7:
            kw.update(presence_penalty=0.5, frequency_penalty=0.3)
        user = f"{chr(97 + i)}) " + "The bell rings at noon, and the keeper climbs. " * 2
        out[f"s{i}"] = dict({"messages": [{"role": "user", "content": user}],
                             "temperature": 0, "max_tokens": SPEC_BATCH_TOKENS}, **kw)
    out["hi"] = {"messages": [{"role": "user", "content": "Z) urgent: the lamp is out. " * 3}],
                 "temperature": 0, "max_tokens": 16, "priority": 2}
    return out


def _spec_batch_traffic(srv, tag: str) -> dict:
    """The 8 streams over SSE, s1-s7 at once, then, once each of them has a
    token, s0 (so that it still runs when the priority-2 request, sent once
    s0 has a token, needs its slot). -> {"responses": {key: _sse result},
    "launches",
    "metrics" (the dllama_spec_* and unexpected-capture deltas), "wall_s",
    "agg_tok_s" (the streams' decode tokens over the window from their
    first token to their last)}."""
    bodies = _spec_batch_bodies()
    streams = [k for k in bodies if k != "hi"]
    firsts = {k: threading.Event() for k in streams}
    res: dict = {}
    before, _ = _scrape(srv.port)
    reset_counters()
    t0 = time.perf_counter()

    def run(k):
        res[k] = _sse(srv.port, bodies[k], f"{k}-{tag}", first=firsts[k])

    threads = {k: threading.Thread(target=run, args=(k,)) for k in streams}
    for k in streams[1:] + streams[:1]:
        if k == streams[0]:
            for other in streams[1:]:
                if not firsts[other].wait(300):
                    fail(f"spec_batch {tag}: stream {other} produced no token in 300 s")
        threads[k].start()
    if not firsts[streams[0]].wait(300):
        fail(f"spec_batch {tag}: stream {streams[0]} produced no token in 300 s")
    res["hi"] = _sse(srv.port, bodies["hi"], f"hi-{tag}")
    threads = list(threads.values())
    for th in threads:
        th.join(timeout=600)
        if th.is_alive():
            fail(f"spec_batch {tag}: a stream did not finish within 600 s")
    wall = time.perf_counter() - t0
    launches = counters()
    after, _ = _scrape(srv.port)
    for k, r in res.items():
        if r["status"] != 200 or not r["done"] or r["finish"] != "length":
            fail(f"spec_batch {tag}: {k} answered {r['status']}, finish {r['finish']}")
    tokens = sum(r["timings"]["decode_tokens"] - 1 for k, r in res.items() if k != "hi")
    window = (max(r["t_done"] for k, r in res.items() if k != "hi")
              - min(r["t_first"] for k, r in res.items() if k != "hi"))
    metrics = {
        "cycles": after.get(("dllama_spec_cycles_total", ""), 0.0)
        - before.get(("dllama_spec_cycles_total", ""), 0.0),
        **{kind: v for kind, v in (
            (lab.split('"')[1], d) for lab, d in
            _family_delta(before, after, "dllama_spec_tokens_total").items())},
        "unexpected": sum(_family_delta(before, after,
                                        "dllama_jit_unexpected_compiles_total").values())}
    return {"responses": res, "launches": launches, "metrics": metrics, "wall_s": wall,
            "agg_tok_s": tokens / window}


def _cycle_ms(eng, spec: bool, n: int = SPEC_BATCH_CYCLES) -> dict:
    """chunk_timing of one n-cycle spec chunk (or n-step plain chunk) of
    `eng`'s 8 active greedy slots, a cycle's (step's) share; with the
    launches of one more chunk and, for spec, its tokens a cycle."""
    def run():
        return eng.decode_consume(eng.decode_dispatch(n, spec=spec))

    t = chunk_timing(run, n)
    reset_counters()
    s0 = eng.spec_stats()
    run()
    t["launches"] = {k: v for k, v in counters().items() if v}
    if spec:
        s1 = eng.spec_stats()
        t["tokens_per_cycle"] = (s1["emitted"] - s0["emitted"]) / (s1["cycles"] - s0["cycles"])
    return t


def _timed_cycles(eng, prompts: list[list[int]]) -> dict:
    """8 greedy slots admitted into `eng` (idle, its server drained): one
    spec cycle's and one plain step's device ms (_cycle_ms); the slots are
    released after."""
    for s, toks in enumerate(prompts):
        eng.add(s, toks, temperature=0.0)
    out = {"spec": _cycle_ms(eng, True), "plain": _cycle_ms(eng, False)}
    for s in range(len(prompts)):
        eng.release(s)
    return out


def phase_spec_batch(loaded) -> dict:
    """Batched speculation on the 8B Q40 model at full width: the 8-slot
    server at its defaults (make_server: aio, the radix tree, preemption,
    hybrid admission, page 128) with --warmup auto and --spec-k 4. The same
    traffic (_spec_batch_bodies: 8 streams of SPEC_BATCH_TOKENS tokens, a
    priority-2 arrival preempting s0) on two --spec-k 4 servers and one
    --spec-k 0 server: greedy ids equal the spec 0 server's or first differ
    at a near tie (the verify forward's K2 rows against plain decode's K1
    rows); the sampled streams' first differences between the two spec
    servers (printed: their tokens take K1's or K2's route as the schedule
    falls); the dllama_spec_* deltas equal the engine's spec_stats() deltas, and the
    emitted tokens and (cycle, slot) pairs equal the responses' summed
    timings().spec plus the discarded overrun (spec_rows); a preemption and
    its resume; no
    unexpected capture; a clean pool after each drain; the launches of the
    first spec run (K2 and K9 in its verify cycles, K1 in its plain and
    hybrid chunks). Then, on the drained spec server's engine and on a
    --spec-k 1 engine (8 x 2 = 16 rows: K1's route), one cycle's device ms
    against one plain step's, with tokens a cycle; and on a 3-slot K = 4
    engine (15 rows: K1's route) greedy, sampled and penalized slots through
    spec and plain chunks bit-equal to plain decode (spec_lockstep_check).
    Returns the first spec run's launches."""
    import gc

    import torch

    from dllama_tpu_torch.engine.batch import BatchEngine

    runs, servers = {}, {}
    for tag, spec in (("spec", SPEC_BATCH_K), ("spec2", SPEC_BATCH_K), ("plain", 0)):
        srv = RadixServer(loaded, spec=spec)
        if srv.eng.kv_layout != "paged" or srv.eng.page_size != 128:
            fail(f"spec_batch: the server resolved {srv.eng.kv_layout} at page "
                 f"{srv.eng.page_size}, not paged at 128")
        if not srv.sched.warmup_report["full_coverage"]:
            fail(f"spec_batch {tag}: the warm-up left programs uncaptured "
                 f"{srv.sched.warmup_report}")
        s0, r0 = srv.eng.spec_stats(), srv.eng.spec_rows()
        runs[tag] = _spec_batch_traffic(srv, tag)
        s1, r1 = srv.eng.spec_stats(), srv.eng.spec_rows()
        runs[tag].update(stats=s1, preemptions=srv.sched.preempt_count,
                         resumed=srv.sched.resume_count,
                         rows={k: r1[k] - r0[k] for k in r1},
                         delta=None if s1 is None else {
                             k: s1[k] - s0[k] for k in ("cycles", "drafted", "accepted",
                                                        "emitted")})
        srv.close(tag)
        servers[tag] = srv
    spec, spec2, plain = runs["spec"], runs["spec2"], runs["plain"]
    for tag, r in runs.items():
        if r["metrics"]["unexpected"]:
            fail(f"spec_batch {tag}: {r['metrics']['unexpected']} unexpected captures")
        if not r["preemptions"] or r["resumed"] != r["preemptions"]:
            fail(f"spec_batch {tag}: {r['preemptions']} preemptions, {r['resumed']} resumes")
    reports = []
    a, b, c = servers["spec"], servers["spec2"], servers["plain"]
    for k in ("s0", "s1", "s2", "s3", "s4", "hi"):
        msg = near_tie(loaded, a.trace.runs[f"{k}-spec"][0], a.ids(f"{k}-spec"),
                       c.ids(f"{k}-plain"), f"spec_batch {k} spec 4 vs 0")
        if msg:
            reports.append(msg)
    # a sampled stream's tokens run in verify cycles (K2 at 40 rows) or in
    # plain or hybrid chunks (K1) as each run's schedule falls, and on the
    # random weights' flat top-p candidates those routes' low bits move the
    # draw: the two spec runs' sampled streams are printed, not compared
    # (spec_lockstep_check holds the sampled rows on one route, exactly)
    apart = {k: next((j for j, (x, y) in enumerate(zip(a.ids(f"{k}-spec"),
                                                        b.ids(f"{k}-spec2"))) if x != y), None)
             for k in ("s5", "s6", "s7")}
    for tag in ("spec", "spec2"):
        r, srv = runs[tag], servers[tag]
        m, d, rows = r["metrics"], r["delta"], r["rows"]
        if (m["cycles"] != d["cycles"] or m.get("emitted", 0) != d["emitted"]
                or m.get("drafted", 0) != d["drafted"] or m.get("accepted", 0) != d["accepted"]):
            fail(f"spec_batch {tag}: /metrics dllama_spec_* {m} against spec_stats() {d}")
        # the emitted tokens and (cycle, slot) pairs are exactly the
        # responses' spec records (s4's, at spec_k 0, from its Request:
        # timings() leaves it out) plus the rows of slots released while
        # their chunk was in flight (the overrun no request is credited)
        summed = {"cycles": 0, "tokens": 0}
        for k, resp in r["responses"].items():
            t = (resp["timings"] or {}).get("spec")
            if (k == "s4") != (t is None):
                fail(f"spec_batch {tag}: {k}'s timings spec object {t}")
            if t is None:
                req = srv.trace.reqs[f"{k}-{tag}"]
                t = {"cycles": req.spec_cycles, "tokens": req.spec_tokens}
            summed["cycles"] += t["cycles"]
            summed["tokens"] += t["tokens"]
        if (d["emitted"] != summed["tokens"] + rows["discarded_tokens"]
                or rows["slot_cycles"] != summed["cycles"] + rows["discarded_cycles"]):
            fail(f"spec_batch {tag}: emitted {d['emitted']} tokens in {rows['slot_cycles']} "
                 f"(cycle, slot) pairs against the responses' {summed} plus the discarded "
                 f"{rows}")
        r["summed"] = summed
    launches = spec["launches"]
    for kname in ("q40_prefill", "paged_attention", "q40_decode"):
        if not launches.get(kname):
            fail(f"spec_batch: kernel {kname} was never launched ({launches})")
    st = spec["stats"]
    print(f"spec_batch --spec-k {SPEC_BATCH_K}: {json.dumps(spec['delta'])}; tokens a cycle "
          f"over the batch {st['tokens_per_cycle']}, accept mean {st['accept_mean']}; the "
          f"responses' spec "
          f"records {json.dumps(spec['summed'])}; /metrics {json.dumps(spec['metrics'])}; "
          f"preemptions {spec['preemptions']}, resumed {spec['resumed']}; aggregate "
          f"{spec['agg_tok_s']:.1f} tok/s (second spec run {spec2['agg_tok_s']:.1f}) against "
          f"{plain['agg_tok_s']:.1f} at --spec-k 0; walls {spec['wall_s']:.2f} / "
          f"{spec2['wall_s']:.2f} / {plain['wall_s']:.2f} s; near ties {len(reports)}; "
          f"discarded overrun {json.dumps(spec['rows'])}; sampled streams of the two spec "
          f"runs first apart at {apart}; launches {launches}", flush=True)

    prompts = [prompt_ids(a.api, _spec_batch_bodies()[f"s{i}"]) for i in range(8)]
    cyc = {SPEC_BATCH_K: _timed_cycles(a.eng, prompts)}
    del a, b, c, servers
    gc.collect()
    torch.cuda.empty_cache()
    e = loaded.engine
    # 3 slots x (K+1) = 15 verify rows: the spec programs on K1's route, as
    # plain decode, so their tokens must be plain decode's bit for bit
    few = BatchEngine(loaded.config, e.params, n_slots=3, cache_dtype=e.cache.k.dtype,
                      max_seq_len=e.seq_len, kv_layout="paged", page_size=128,
                      device=e.device, spec=SPEC_BATCH_K)
    admits = [(prompts[1], dict(temperature=0.0)),
              (prompts[5], dict(temperature=0.8, seed=105)),
              (prompts[7], dict(temperature=0.8, seed=107, presence=0.5, frequency=0.3))]
    lock = spec_lockstep_check(few, admits, SPEC_BATCH_LOCKSTEP)
    print(f"spec_batch lockstep, 3 slots, K={SPEC_BATCH_K} ({3 * (SPEC_BATCH_K + 1)} verify "
          f"rows: K1): greedy, sampled and penalized slots' first {SPEC_BATCH_LOCKSTEP} "
          f"tokens bit-equal to plain decode's over {lock['chunks']} spec and plain chunks; "
          f"{json.dumps(lock['stats'])}", flush=True)
    del few
    gc.collect()
    torch.cuda.empty_cache()
    k1 = BatchEngine(loaded.config, e.params, n_slots=8, cache_dtype=e.cache.k.dtype,
                     max_seq_len=e.seq_len, kv_layout="paged", page_size=128,
                     device=e.device, spec=1)
    cyc[1] = _timed_cycles(k1, prompts)
    del k1
    gc.collect()
    torch.cuda.empty_cache()
    for k, t in cyc.items():
        s, p = t["spec"], t["plain"]
        print(f"spec_batch cycle, 8 slots, K={k} ({8 * (k + 1)} verify rows): "
              f"{s['device_ms']:.4f} ms device, {s['stream_ms']:.4f} stream, "
              f"{s['wall_ms']:.4f} wall a cycle, {s['tokens_per_cycle']:.3f} tokens a cycle "
              f"over the 8 slots; "
              f"plain step {p['device_ms']:.4f} ms device, {p['stream_ms']:.4f} stream, "
              f"{p['wall_ms']:.4f} wall; launches a spec chunk of {SPEC_BATCH_CYCLES} "
              f"{s['launches']}, a plain chunk {p['launches']}", flush=True)
    if cyc[1]["spec"]["launches"].get("q40_prefill") or not cyc[1]["spec"]["launches"].get(
            "q40_decode"):
        fail("spec_batch: at K=1 the 16-row verify forward left K1's route")
    if not cyc[SPEC_BATCH_K]["spec"]["launches"].get("q40_prefill"):
        fail(f"spec_batch: at K={SPEC_BATCH_K} the verify forward never ran K2")
    return launches


# ------------------------------------------------------------ phase 12


def chunk_timing(run, steps: int, reps: int = 5) -> dict:
    """One decode chunk of `steps` steps, `run` (which ends when its tokens
    are on the host), a step's share of: the wall ms (host clock, median of
    `reps` runs); the stream ms (CUDA events around a run that a ~50 ms
    spin kernel holds back until the host has enqueued it, median of
    `reps`: the chunk's device window with the host out of its way); the
    device ms (the device operations torch.profiler saw in one more run,
    summed); and the busy share device / wall."""
    import torch

    run()  # captures where needed
    walls, streams = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        streams.append(a.elapsed_time(b))
    wall = statistics.median(walls)
    torch.cuda.synchronize()
    with profiled(cuda_only=True) as prof:
        run()
        torch.cuda.synchronize()
    ops = device_ops(prof)
    device_s = sum(v[0] for v in ops.values()) / 1e6
    return {"wall_ms": wall / steps * 1e3, "device_ms": device_s / steps * 1e3,
            "busy": device_s / wall, "device_ops": sum(v[1] for v in ops.values()) / steps,
            "stream_ms": statistics.median(streams) / steps}


def prefill_timing(run, reps: int = 5) -> dict:
    """One prefill chunk, `run` (which returns the chunk's logits on the
    card): the wall ms (host clock around the run and a synchronize, median
    of `reps`), the stream ms (CUDA events around a run that a spin kernel
    holds back until the host has enqueued it, median of `reps`) and the
    host ms of that enqueue (median), then the busy ms (the device
    operations torch.profiler saw in one more run, summed) split into
    matmul, attention and the rest, and the number of device operations."""
    import torch

    run()  # captures where needed
    torch.cuda.synchronize()
    walls, streams, hosts = [], [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        run()
        hosts.append(time.perf_counter() - t0)
        b.record()
        b.synchronize()
        streams.append(a.elapsed_time(b))
    torch.cuda.synchronize()
    with profiled(cuda_only=True) as prof:
        run()
        torch.cuda.synchronize()
    split = {"matmul_ms": 0.0, "attention_ms": 0.0, "other_ms": 0.0, "ops": 0}
    for name, (us, count) in device_ops(prof).items():
        key = ("matmul_ms" if any(k in name for k in CHUNK_MATMUL) else
               "attention_ms" if any(k in name for k in CHUNK_ATTENTION) else "other_ms")
        split[key] += us / 1e3
        split["ops"] += count
    return dict(split, wall_ms=statistics.median(walls) * 1e3,
                stream_ms=statistics.median(streams), host_ms=statistics.median(hosts) * 1e3,
                busy_ms=split["matmul_ms"] + split["attention_ms"] + split["other_ms"])


def prefill_programs(loaded) -> dict:
    """Prefill chunks as captured programs (one CUDA graph a token width,
    the position a device input) at PROGRAM_WIDTHS x PROGRAM_POSITIONS:
    through the single engine's `step` on its dense cache (K2 + K7), and
    through `BatchEngine.add_step` of one slot on a page pool at page 128
    (K2 + K9 after the plain pre-scatter). Each prints wall, stream and
    busy ms (prefill_timing); the logits of a captured chunk must equal
    the uncaptured body's on the same rows."""
    import gc

    import numpy as np
    import torch

    from dllama_tpu_torch.engine.batch import BatchEngine
    from dllama_tpu_torch.engine.graphs import Programs

    cfg, eng = loaded.config, loaded.engine
    gen = np.random.default_rng(5)
    be = BatchEngine(cfg, eng.params, n_slots=1, cache_dtype=eng.cache.k.dtype,
                     max_seq_len=eng.seq_len, kv_layout="paged", page_size=128,
                     device=eng.device)
    uncaptured = Programs(eng.device, capture=False)
    out: dict = {}
    for width in PROGRAM_WIDTHS:
        toks = gen.integers(0, cfg.vocab_size, (1, width))
        for pos in PROGRAM_POSITIONS:

            def single(pos=pos, toks=toks):
                eng.reset(pos)
                return eng.step(toks)

            def paged(pos=pos, toks=toks, be=be):
                be.release(0)
                adm = be.add_begin(0, toks[0], start_pos=pos)
                be.add_step(adm)
                return adm.logits

            for tier, run in (("single dense", single), ("paged slot", paged)):
                res = out[(tier, width, pos)] = prefill_timing(run)
                print(f"prefill program {tier}, {width} tokens at pos {pos}: wall "
                      f"{res['wall_ms']:.3f} ms, stream {res['stream_ms']:.3f} ms (events, "
                      f"host held off), busy {res['busy_ms']:.3f} ms in {res['ops']} device "
                      f"ops (matmul {res['matmul_ms']:.3f}, attention "
                      f"{res['attention_ms']:.3f}, other {res['other_ms']:.3f}); host "
                      f"{res['host_ms']:.3f} ms to enqueue; wall/busy "
                      f"{res['wall_ms'] / max(res['busy_ms'], 1e-9):.3f}", flush=True)
            # the captured slot chunk against the same body launched from
            # Python, each over a zeroed pool
            logits, captured = [], be.programs
            for programs in (captured, uncaptured):
                be.programs = programs
                be.cache.k.zero_()
                be.cache.v.zero_()
                logits.append(paged().clone())
            be.programs = captured
            if not torch.equal(*logits):
                fail(f"prefill program: the captured {width}-token chunk at pos {pos} "
                     "differs from the uncaptured body")
    eng.reset(0)
    stats = be.programs.stats()
    print(f"prefill programs: {stats['graphs']} graphs on the page pool in "
          f"{stats['capture_s']:.2f} s; captured and uncaptured slot chunks bit-equal",
          flush=True)
    del be, uncaptured
    gc.collect()
    torch.cuda.empty_cache()
    return out


def graph_launch_ms(prog, reps: int = 5) -> float:
    """Host ms of one `replay()` of a captured decode program, the card kept
    busy by a spin kernel so the call never waits for it (median of
    `reps`). The replays move the engine's device state: run it last."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        prog.graph.replay()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def host_ms(dispatch, consume=None, reps: int = 5) -> float:
    """Median host ms of `dispatch` alone, the card idle before each call
    (`consume` then waits for what it launched)."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        launched = dispatch()
        times.append(time.perf_counter() - t0)
        if consume is not None:
            consume(launched)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def replay_launches(run, want: dict, label: str) -> None:
    """The launches of one more `run` (a chunk whose program is captured
    already) must be exactly `want`: counted through the replay."""
    reset_counters()
    run()
    got = {k: v for k, v in counters().items() if v}
    if got != want:
        fail(f"{label}: launches {got} in one chunk, want {want}")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawn(cmd: list[str], marker: str):
    """A CLI child process whose output is read by a thread -> (process,
    its lines, an event set once `marker` is printed or the output ends)."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    lines: list[str] = []
    ready = threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if marker in line:
                ready.set()
        ready.set()

    threading.Thread(target=read, daemon=True).start()
    return proc, lines, ready


def _reap(proc, sig=None, timeout: float = 60.0) -> None:
    import signal

    if proc.poll() is None:
        proc.send_signal(sig or signal.SIGTERM)
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def cli_warmup_serve(mpath: str, tpath: str, body: dict) -> tuple[dict, str, float]:
    """`serve --slots 8 --warmup auto` in a child process (the CLI as a user
    runs it): -> (its boot report, the content of `body`'s completion,
    seconds from the start to the server's ready line)."""
    port = _free_port()
    t0 = time.perf_counter()
    proc, lines, ready = _spawn(
        [sys.executable, "-u", "-m", "dllama_tpu_torch", "serve", "--model", mpath,
         "--tokenizer", tpath, "--slots", "8", "--warmup", "auto", "--port", str(port),
         "--max-seq-len", "4096", "--no-mesh"], "/v1/chat/completions")
    try:
        if not ready.wait(300) or proc.poll() is not None:
            fail(f"graphs: serve --warmup auto did not come up: {lines[-20:]}")
        boot_s = time.perf_counter() - t0
        report = next((json.loads(ln[len("warmup: "):]) for ln in lines
                       if ln.startswith("warmup: ")), None)
        st, raw = _post(port, body)
        if st != 200:
            fail(f"graphs: serve --warmup auto answered {st}: {raw[:300]!r}")
    finally:
        _reap(proc, timeout=120)
    if report is None:
        fail(f"graphs: serve --warmup auto printed no boot report: {lines[-20:]}")
    return report, json.loads(raw)["choices"][0]["message"]["content"], boot_s


def phase_graphs(loaded, mpath: str, tpath: str, prompt: str) -> dict:
    """Decode chunks as CUDA graphs against the same bodies launched from
    Python, on the loaded Q40 8B model: one stream, then eight paged slots
    at page 128 (ids and timings, see the module's docstring), then the
    CLI's `serve --slots 8 --warmup auto`, whose first request's content
    must equal a server's without warmup (each the first request its
    server serves, so both prefill the prompt from row 0). Returns the
    launches of the captured runs."""
    import gc

    import numpy as np
    import torch

    from dllama_tpu_torch.engine.batch import BatchEngine
    from dllama_tpu_torch.engine.engine import InferenceEngine
    from dllama_tpu_torch.engine.sampling import Sampler
    from dllama_tpu_torch.serve.api import graceful_drain, make_server
    from dllama_tpu_torch.serve.scheduler import DECODE_CHUNK

    cfg, eng, tok = loaded.config, loaded.engine, loaded.tokenizer
    per_fwd = 7 * cfg.n_layers + 1
    out: dict = {"launches": {}}

    def add(launches):
        for k, v in launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + v

    # ---- one stream: the loaded engine (captured) and one on its weights (not)
    ptoks = tok.encode(prompt, add_bos=True)
    single = {}
    n = GRAPH_CHUNK["single"]
    for label, capture in (("captured", True), ("uncaptured", False)):
        e = InferenceEngine(cfg, eng.params, cache_dtype=eng.cache.k.dtype,
                            max_seq_len=eng.seq_len, device=eng.device, capture=capture)
        reset_counters()
        ids = {}
        for kind, sampler in (("greedy", Sampler(0.0, 0.9, 0)), ("sampled", Sampler(0.8, 0.9, 7))):
            e.reset(0)
            ids[kind] = list(e.generate(ptoks, GRAPH_TOKENS + 1, sampler, chunk=n))
        if label == "captured":
            add(counters())
        start, last = len(ptoks), ids["greedy"][0]

        def run(e=e, start=start, last=last):
            e.reset(start)
            return e.decode_greedy_n([[last]], n)

        timing = chunk_timing(run, n, reps=5 if capture else 2)
        replay_launches(run, {"q40_decode": per_fwd * n, "flash_attention": cfg.n_layers * n},
                        f"graphs single-stream {label}")
        stats = e.programs.stats()
        single[label] = dict(ids=ids, host_ms=None, graphs=stats["graphs"],
                             capture_s=stats["capture_s"], **timing)
        if capture:
            single[label]["launch_ms"] = graph_launch_ms(e.programs.find("greedy", n))
        del e, run
        gc.collect()
        torch.cuda.empty_cache()
    for kind in ("greedy", "sampled"):
        if single["captured"]["ids"][kind] != single["uncaptured"]["ids"][kind]:
            fail(f"graphs: single-stream {kind} ids differ with and without capture")
    # ---- eight paged slots
    prompts = [tok.encode(p) for p in batch_prompts(8)]
    batch = {}
    n = GRAPH_CHUNK["batch"]
    for label, capture in (("captured", True), ("uncaptured", False)):
        be = BatchEngine(cfg, eng.params, n_slots=8, cache_dtype=eng.cache.k.dtype,
                         max_seq_len=eng.seq_len, kv_layout="paged", page_size=128,
                         device=eng.device, capture=capture)
        reset_counters()
        ids = {}
        for kind, temp in (("greedy", 0.0), ("sampled", 0.8)):
            for slot, p in enumerate(prompts):
                be.release(slot)
                be.add(slot, p, temperature=temp, seed=100 + slot)
            ids[kind] = np.concatenate([be.decode(n) for _ in range(GRAPH_TOKENS // n)]).tolist()
        for slot in range(8):
            be.release(slot)
        for slot, p in enumerate(prompts):
            be.add(slot, p, temperature=0.0)
        if capture:
            add(counters())

        def run(be=be):
            return be.decode(n)

        timing = chunk_timing(run, n, reps=5 if capture else 2)
        replay_launches(run, {"q40_decode": per_fwd * n, "paged_attention": cfg.n_layers * n},
                        f"graphs 8 slots {label}")
        timing["host_ms"] = host_ms(lambda: be.decode_dispatch(n), be.decode_consume,
                                    reps=5 if capture else 2)
        stats = be.programs.stats()
        batch[label] = dict(ids=ids, graphs=stats["graphs"], capture_s=stats["capture_s"],
                            **timing)
        if capture:
            batch[label]["launch_ms"] = graph_launch_ms(be.programs.find("greedy", n))
        del be, run
        gc.collect()  # the engine and its programs' bodies refer to each other
        torch.cuda.empty_cache()
    for kind in ("greedy", "sampled"):
        if batch["captured"]["ids"][kind] != batch["uncaptured"]["ids"][kind]:
            fail(f"graphs: 8-slot {kind} ids differ with and without capture")
    out["graphs"] = single["captured"]["graphs"] + batch["captured"]["graphs"]
    out["capture_s"] = single["captured"]["capture_s"] + batch["captured"]["capture_s"]
    for tier, res in (("single stream", single), ("8 slots", batch)):
        for label in ("captured", "uncaptured"):
            r = res[label]
            print(f"graphs {tier} {label}: {r['wall_ms']:.3f} ms a step wall, "
                  f"{r['stream_ms']:.3f} ms stream time (events, host held off), "
                  f"{r['device_ms']:.3f} ms device time (profiler), busy share "
                  f"{r['busy']:.3f}, {r['device_ops']:.1f} device ops a step"
                  + (f"; host {r['host_ms']:.3f} ms a chunk in decode_dispatch"
                     if r["host_ms"] is not None else "")
                  + (f"; replay() {r['launch_ms']:.3f} ms of host time a chunk"
                     if "launch_ms" in r else "")
                  + "; greedy and sampled ids equal to the other's", flush=True)
        out[tier] = {k: {m: res[k].get(m) for m in ("wall_ms", "stream_ms", "device_ms",
                                                     "busy", "host_ms", "launch_ms")}
                     for k in res}
    print(f"graphs: {out['graphs']} graphs captured in {out['capture_s']:.2f} s "
          f"(single stream {single['captured']['graphs']}, 8 slots "
          f"{batch['captured']['graphs']})", flush=True)
    # ---- the CLI with --warmup auto, against a server without warmup
    body = {"messages": [{"role": "user", "content": batch_prompts(1)[0]}], "temperature": 0,
            "max_tokens": GRAPH_TOKENS}
    httpd, api = make_server(loaded, host="127.0.0.1", port=0, n_slots=8)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        st, raw = _post(httpd.server_address[1], body)
    finally:
        graceful_drain(httpd, api, timeout_s=60)
        httpd.server_close()
    if st != 200:
        fail(f"graphs: the server without warmup answered {st}")
    want = json.loads(raw)["choices"][0]["message"]["content"]
    del api, httpd
    gc.collect()
    torch.cuda.empty_cache()
    report, got, boot_s = cli_warmup_serve(mpath, tpath, body)
    print(f"graphs: serve --slots 8 --warmup auto ready in {boot_s:.1f} s; boot report "
          f"{json.dumps(report)}", flush=True)
    if got != want:
        fail(f"graphs: the first request's content differs with --warmup auto: {got[:80]!r} "
             f"vs {want[:80]!r}")
    coverage = 3 * DECODE_CHUNK + PREFILL_WIDTHS
    if not report.get("full_coverage") or report.get("graphs_captured") != coverage:
        fail(f"graphs: --warmup auto report {report}, want full coverage and {coverage} graphs")
    print(f"graphs: --warmup auto first request's content equals the server's without "
          f"warmup ({len(got)} characters)", flush=True)
    out["warmup"] = report
    return out


#: hybrid phase: the budgets compared, the running streams (a free slot of 8
#: is left for the joiner), their decode tokens, the joining prompt's
#: characters (one token a byte with the smoke's tokenizer), the tokens of
#: the joiner and of each burst request, and the no-joiner window (s)
HYBRID_BUDGETS = (0, "auto", 256)
HYBRID_RUNNING = 7
HYBRID_RUN_TOKENS = 448
HYBRID_JOIN_CHARS = 2000
HYBRID_TOKENS = 16
HYBRID_BASELINE_S = 0.6


def _stream(port: int, body: dict, first: threading.Event,
            req_id: str = "") -> tuple[int, str]:
    """An SSE chat completion (`req_id` as X-Request-Id); sets `first` at
    its first content event. -> (status, the streamed content)."""
    out = _sse(port, body, req_id, first=first)
    first.set()
    return out["status"], out["content"]


def _quantiles(xs: list) -> dict:
    xs = sorted(xs)
    if not xs:
        return {"n": 0, "p50": None, "p95": None, "max": None}
    return {"n": len(xs), "p50": statistics.median(xs),
            "p95": xs[min(len(xs) - 1, int(round(0.95 * (len(xs) - 1))))], "max": xs[-1]}


def phase_hybrid(loaded) -> dict:
    """Hybrid chunked prefill against phase-split admission: the 8-slot
    server on the page pool at page 128 (make_server, `serve --slots 8`),
    booted with `--warmup auto`, at each --prefill-budget of
    HYBRID_BUDGETS. Per budget: 7 greedy streams decode, and once they all
    do a ~2,048-token prompt joins; the joiner's TTFT, and the running
    streams' ITL with no joiner and during the join (each consumed decode
    chunk's gap since the one before, over its steps: the wait between
    tokens a running stream sees, spread over the chunk's tokens; p50, p95
    and the largest gap), live slots a chunk, hybrid chunks and tokens.
    Then, on the idle server, a burst of 8 simultaneous ~85-token chats
    (the batch phase's prompts): TTFT p50/max, live slots a chunk, hybrid
    chunks and tokens. Greedy ids must be identical across the budgets or
    first differ at a near tie (near_tie), and the page pool must audit
    clean after each drain. Returns the launches of the served requests,
    summed over the budgets."""
    import gc

    import torch

    from dllama_tpu_torch.serve.api import graceful_drain, make_server

    launches: dict = {}
    results, traces, prompts = {}, {}, {}
    # the running streams' prompts share no more than the chat header with
    # the burst's, so the burst finds nothing of them in the prefix cache
    running = [{"messages": [{"role": "user", "content": "Stream on: " + p}],
                "temperature": 0, "max_tokens": HYBRID_RUN_TOKENS}
               for p in batch_prompts(HYBRID_RUNNING)]
    words = " ".join(f"line {i}: the keeper logs the weather, the tide and the lamp."
                     for i in range(200))[:HYBRID_JOIN_CHARS]
    joiner = {"messages": [{"role": "user", "content": "Summarize this log. " + words}],
              "temperature": 0, "max_tokens": HYBRID_TOKENS}
    burst = [{"messages": [{"role": "user", "content": p}], "temperature": 0,
              "max_tokens": 32} for p in batch_prompts(8)]
    for budget in HYBRID_BUDGETS:
        t_boot = time.perf_counter()
        httpd, api = make_server(loaded, host="127.0.0.1", port=0, n_slots=8,
                                 prefill_budget=budget, warmup="auto")
        boot_s = time.perf_counter() - t_boot
        sched, eng = api.scheduler, api.scheduler.engine
        traces[budget] = IdTrace(sched)
        if not prompts:
            prompts.update({"running": [prompt_ids(api, b) for b in running],
                            "joiner": [prompt_ids(api, joiner)],
                            "burst": [prompt_ids(api, b) for b in burst]})
        consumed = []  # (host time, steps, live slots) of each consumed decode chunk
        consume = eng.decode_consume

        def timed_consume(chunk, consume=consume, consumed=consumed):
            toks = consume(chunk)
            consumed.append((time.perf_counter(), chunk.n, int(chunk.active.sum())))
            return toks

        eng.decode_consume = timed_consume
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        port = httpd.server_address[1]
        res: dict = {"boot_s": boot_s, "warmup": sched.warmup_report}
        try:
            reset_counters()
            # ---- the join: 7 running streams, then the long prompt
            firsts = [threading.Event() for _ in running]
            out = [None] * len(running)

            def run(i):
                out[i] = _stream(port, running[i], firsts[i])

            threads = [threading.Thread(target=run, args=(i,)) for i in range(len(running))]
            for th in threads:
                th.start()
            for ev in firsts:
                if not ev.wait(300):
                    fail("hybrid: a running stream produced no token in 300 s")
            time.sleep(HYBRID_BASELINE_S)
            h0 = dict(sched.latency_summary()["hybrid"])
            st, raw, t_join = _post_timed(port, joiner)
            if st != 200:
                fail(f"hybrid: the joiner answered {st}: {raw[:300]!r}")
            jresp = json.loads(raw)
            h1 = sched.latency_summary()["hybrid"]
            for th in threads:
                th.join(timeout=600)
                if th.is_alive():
                    fail("hybrid: a running stream did not finish within 600 s")
            if any(st != 200 for st, _ in out):
                fail(f"hybrid: a running stream failed: {[st for st, _ in out]}")
            ttft_s = jresp["timings"]["ttft_ms"] / 1e3
            join_end = t_join + ttft_s
            # (host time, ms since the chunk before, steps, live slots)
            gaps = [(t, (t - t0) * 1e3, n, live)
                    for (t0, _, _), (t, n, live) in zip(consumed, consumed[1:])]
            base = [ms / n for t, ms, n, live in gaps
                    if t_join - HYBRID_BASELINE_S <= t < t_join and live == HYBRID_RUNNING]
            # the join: every chunk consumed after the joiner was sent, up to
            # and with the first one after its first token (a phase-split
            # prefill's stall shows in that chunk)
            after = [g[0] for g in gaps if g[0] > join_end]
            during = [g for g in gaps if t_join <= g[0] <= (after[0] if after else join_end)]
            res["join"] = {
                "prompt_tokens": jresp["usage"]["prompt_tokens"],
                "ttft_ms": jresp["timings"]["ttft_ms"],
                "itl_ms_no_joiner": _quantiles(base),
                "itl_ms_during_join": _quantiles([ms / n for _, ms, n, _ in during]),
                "largest_gap_ms": max((ms for _, ms, _, _ in during), default=None),
                "live_slots_in_join": (min((g[3] for g in during), default=None),
                                       max((g[3] for g in during), default=None)),
                "hybrid_chunks": h1["chunks"] - h0["chunks"],
                "hybrid_tokens": h1["tokens"] - h0["tokens"],
            }
            # ---- the burst on the idle server
            c0, s0 = sched.chunks, sched.chunk_slots
            h0 = dict(sched.latency_summary()["hybrid"])
            replies = _concurrently(_post_timed, [(port, b) for b in burst])
            if any(st != 200 for st, _, _ in replies):
                fail(f"hybrid: a burst request failed: {[st for st, _, _ in replies]}")
            rs = [json.loads(raw) for _, raw, _ in replies]
            h1 = sched.latency_summary()["hybrid"]
            chunks = sched.chunks - c0
            ttfts = [r["timings"]["ttft_ms"] for r in rs]
            res["burst"] = {"ttft_ms_p50": statistics.median(ttfts), "ttft_ms_max": max(ttfts),
                            "live_slots_per_chunk": ((sched.chunk_slots - s0) / chunks
                                                     if chunks else None),
                            "decode_chunks": chunks,
                            "hybrid_chunks": h1["chunks"] - h0["chunks"],
                            "hybrid_tokens": h1["tokens"] - h0["tokens"]}
            for k, v in counters().items():
                launches[k] = launches.get(k, 0) + v
            res["mode"] = sched.latency_summary()["hybrid"]["mode"]
        finally:
            clean = graceful_drain(httpd, api, timeout_s=120)
            httpd.server_close()
        report = eng.pool.audit(raise_on_fail=False)
        if not (clean and report["ok"] and report["free"] == report["total"]):
            fail(f"hybrid: budget {budget}: drain clean {clean}, pool after it {report}")
        results[budget] = res
        print(f"hybrid --prefill-budget {budget} ({res['mode']}): boot {boot_s:.1f} s "
              f"({res['warmup']['graphs_captured']} graphs); join {json.dumps(res['join'])}; "
              f"burst {json.dumps(res['burst'])}", flush=True)
        del api, httpd, sched, eng
        gc.collect()
        torch.cuda.empty_cache()
    # greedy ids equal across the budgets, or apart at a near tie only (a
    # prompt whose admission mapped a sub-page boundary from the tree in one
    # run prefills from another row, in other slices, than in another)
    near_ties = [near_tie(loaded, p, traces[b].of(p)[0], traces[HYBRID_BUDGETS[0]].of(p)[0],
                          f"hybrid {key} request {i}, budget {b}")
                 for key, ps in prompts.items() for i, p in enumerate(ps)
                 for b in HYBRID_BUDGETS[1:]]
    near_ties = [m for m in near_ties if m]
    if results["auto"]["join"]["hybrid_chunks"] <= 0 or results[0]["join"]["hybrid_chunks"]:
        fail("hybrid: the joiner did not ride hybrid chunks under auto, or did at budget 0")
    # the batch phase's requests on the same server, phase-split: decode batched
    occupancy = results[0]["burst"]["live_slots_per_chunk"]
    if not occupancy > MIN_BATCH_SLOTS:
        fail(f"hybrid: the budget-0 burst's decode chunks carried {occupancy:.2f} live slots "
             f"on average, want > {MIN_BATCH_SLOTS}: decode did not run batched")
    print(f"hybrid: greedy ids identical across the budgets (running, joiner, burst) but "
          f"{len(near_ties)} near ties; "
          f"pool clean after each drain; launches {launches}", flush=True)
    return launches


# ------------------------------------------------------------ the radix phase

#: radix phase: rows of the shared system prompt (12 pages of 128; the user
#: turns diverge at this row), the user turns' lengths (one byte a token in
#: the smoke's tokenizer), decode tokens a reply
RADIX_SYSTEM_ROWS = 1536
RADIX_TURNS = (64, 80, 96, 112, 128, 144, 160, 100)
RADIX_TOKENS = 32
#: (b) multi-turn: chats, turn-1 length and turn-2 addition (tokens)
RADIX_CHATS, RADIX_TURN1, RADIX_TURN2 = 16, 300, 48
#: (c) the spill tier: device pool pages and host pages (16.8 MB each at 8B)
RADIX_KV_PAGES = RADIX_HOST_PAGES = 48
#: (d) preemption: decode tokens of the 8 priority-0 streams (~2 s, so none
#: ends before the priority-2 request has been served)
RADIX_PREEMPT_TOKENS = 256


def _filler(n: int, seed: str) -> str:
    """n characters of readable filler (n tokens under the byte tokenizer)."""
    words = " ".join(f"{seed} {i}: the keeper logs the weather, the tide and the lamp."
                     for i in range(n // 40 + 2))
    return words[:n]


class RadixServer:
    """An 8-slot server (make_server, `serve --slots 8 --warmup auto`) whose
    scheduler records each request's prompt and emitted ids by request id
    (IdTrace), the most pool pages in use at any emit, and the rows each
    resume re-prefilled."""

    def __init__(self, loaded, **kw):
        from dllama_tpu_torch.serve.api import make_server

        self.httpd, self.api = make_server(loaded, host="127.0.0.1", port=0, n_slots=8,
                                           warmup="auto", **kw)
        self.sched, self.eng = self.api.scheduler, self.api.scheduler.engine
        self.trace, self.resume_rows = IdTrace(self.sched), []
        self.peak_used = 0
        emit, resume = self.sched._emit, self.eng.resume_commit

        def rec_emit(req, token, row, emit=emit):
            pool = self.eng.pool
            self.peak_used = max(self.peak_used, pool.n_pages - pool.free_count)
            return emit(req, token, row)

        def rec_resume(adm, *a, resume=resume, **k):
            self.resume_rows.append(len(adm.toks))
            return resume(adm, *a, **k)

        self.sched._emit, self.eng.resume_commit = rec_emit, rec_resume
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.port = self.httpd.server_address[1]

    def ids(self, req_id: str) -> list[int]:
        return self.trace.runs[req_id][1]

    def post(self, body: dict, req_id: str) -> dict:
        st, raw, _ = _post_timed(self.port, body, req_id)
        if st != 200:
            fail(f"radix: request {req_id} answered {st}: {raw[:300]!r}")
        return json.loads(raw)

    def burst(self, bodies: dict) -> dict:
        """{req_id: body} at once -> {req_id: response}."""
        keys = list(bodies)
        out = _concurrently(self.post, [(bodies[k], k) for k in keys])
        return dict(zip(keys, out))

    def stats(self) -> dict:
        s = self.sched.latency_summary()
        return {"reused": s["reused_prefix_tokens"], "radix": s["radix"],
                "preemptions": s["preemptions"], "resumed": s["resumed"],
                "kv": s["kv_pages"]}

    def close(self, label: str) -> dict:
        """Audit the pool with the tree and the host tier intact, drain,
        and check every page came back and no spill was discarded."""
        from dllama_tpu_torch.serve.api import graceful_drain

        report = self.eng.pool.audit(raise_on_fail=False)
        clean = graceful_drain(self.httpd, self.api, timeout_s=120)
        self.httpd.server_close()
        after = self.eng.pool.audit(raise_on_fail=False)
        host = after.get("host")
        if not (report["ok"] and clean and after["ok"] and after["free"] == after["total"]):
            fail(f"radix {label}: audit before the drain {report}, drain clean {clean}, "
                 f"pool after it {after}")
        if host is not None and host["discarded"]:
            fail(f"radix {label}: {host['discarded']} spills discarded")
        return {"audit_ok": True, "radix_pages": report["radix_pages"], "host": host}


def _same_ids(loaded, a: RadixServer, b: RadixServer, pairs, label: str) -> list[str]:
    """Compare the ids of (req_id on a, req_id on b) pairs (near_tie); the
    divergence reports of those that differ."""
    reports = [near_tie(loaded, a.trace.runs[ka][0], a.ids(ka), b.ids(kb), f"radix {label} {ka}")
               for ka, kb in pairs]
    return [m for m in reports if m]


def _system_prompt(api) -> str:
    """A system message whose chat encoding, with any user turn after it,
    shares exactly RADIX_SYSTEM_ROWS leading tokens with another turn's."""
    def lcp(n):
        a, b = (api._encode_chat([("system", _filler(n, "sys")), ("user", c + " hello")],
                                 add_bos=True) for c in ("A", "B"))
        return next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)

    n = RADIX_SYSTEM_ROWS - 40
    n += RADIX_SYSTEM_ROWS - lcp(n)
    if lcp(n) != RADIX_SYSTEM_ROWS:
        fail(f"radix: could not align the system prompt to {RADIX_SYSTEM_ROWS} rows")
    return _filler(n, "sys")


def _chat(system: str | None, user: str, max_tokens: int = RADIX_TOKENS, **kw) -> dict:
    msgs = ([{"role": "system", "content": system}] if system else [])
    return dict({"messages": msgs + [{"role": "user", "content": user}], "temperature": 0,
                 "max_tokens": max_tokens}, **kw)


def _ttfts(resps) -> list[float]:
    return [r["timings"]["ttft_ms"] for r in resps]


def phase_radix(loaded) -> dict:
    """The radix prefix tree, the host spill tier and preemption on the
    8-slot server (page 128, hybrid admission, --warmup auto), each with
    the tree on (the default) and with --radix-cache off (and --preempt off):
    (a) a 1,536-row system prompt shared by 8 user turns: one alone, then 8
    at once; (b) 16 two-turn chats over 8 slots; (c) on a 48-page pool with
    48 host pages against 0: prompt A, three more that push A's pages out,
    then A again; (d) 8 priority-0 streams, then a priority-2 arrival;
    (e) every pool audits clean (tree and host tier intact) before its drain
    and has every page free after it, with no spill discarded. Greedy ids
    must match between the runs compared, or first differ at a near tie of
    the plain forward's logits. Returns the launches of the whole phase."""
    import gc

    import torch

    res: dict = {}
    reports: list[str] = []
    reset_counters()
    on = RadixServer(loaded)
    off = RadixServer(loaded, radix_cache="off", preempt="off")
    if on.eng.radix is None or on.eng.page_size != 128 or off.eng.radix is not None:
        fail("radix: the default 8-slot server has no tree at page 128, or --radix-cache off "
             "has one")
    system = _system_prompt(on.api)
    turns = [f"{chr(65 + i)}) " + _filler(n - 3, f"turn {i}") for i, n in enumerate(RADIX_TURNS)]

    # ---- (a) the shared system prompt
    for label, srv in (("on", on), ("off", off)):
        s0 = srv.stats()
        alone = srv.post(_chat(system, turns[0]), "a-alone")
        srv.peak_used = 0
        burst = srv.burst({f"a-{i}": _chat(system, t) for i, t in enumerate(turns)})
        s1 = srv.stats()
        prompt = alone["usage"]["prompt_tokens"] + sum(r["usage"]["prompt_tokens"]
                                                         for r in burst.values())
        reused = s1["reused"] - s0["reused"]
        res[f"a_{label}"] = {
            "alone_ttft_ms": alone["timings"]["ttft_ms"],
            "burst_ttft_ms_p50": statistics.median(_ttfts(burst.values())),
            "burst_ttft_ms_max": max(_ttfts(burst.values())),
            "prompt_tokens": prompt, "prefilled": prompt - reused,
            "hit_tokens": (None if s1["radix"] is None
                           else s1["radix"]["hit_tokens"] - s0["radix"]["hit_tokens"]),
            "reused": reused, "peak_pages_used": srv.peak_used}
    reports += _same_ids(loaded, on, off, [(k, k) for k in ["a-alone"] + [f"a-{i}" for i in
                                                                        range(len(turns))]],
                         "(a)")
    print(f"radix (a) shared {RADIX_SYSTEM_ROWS}-row system prompt, tree on: "
          f"{json.dumps(res['a_on'])}; off: {json.dumps(res['a_off'])}", flush=True)
    if res["a_on"]["hit_tokens"] < RADIX_SYSTEM_ROWS * len(turns):
        fail(f"radix (a): the tree served {res['a_on']['hit_tokens']} rows, want >= "
             f"{RADIX_SYSTEM_ROWS * len(turns)}")

    # ---- (b) multi-turn
    users = [f"{i:02d} " + _filler(RADIX_TURN1 - 3, f"chat {i}") for i in range(RADIX_CHATS)]
    for label, srv in (("on", on), ("off", off)):
        first = srv.burst({f"b1-{i}": _chat(None, u) for i, u in enumerate(users)})
        s0 = srv.stats()
        second = srv.burst({
            f"b2-{i}": {"messages": [
                {"role": "user", "content": u},
                {"role": "assistant",
                 "content": first[f"b1-{i}"]["choices"][0]["message"]["content"]},
                {"role": "user", "content": _filler(RADIX_TURN2, f"again {i}")}],
                "temperature": 0, "max_tokens": RADIX_TOKENS}
            for i, u in enumerate(users)})
        s1 = srv.stats()
        res[f"b_{label}"] = {
            "turn2_ttft_ms_p50": statistics.median(_ttfts(second.values())),
            "turn2_ttft_ms_max": max(_ttfts(second.values())),
            "turn2_prompt_tokens": sum(r["usage"]["prompt_tokens"] for r in second.values()),
            "hit_tokens": (None if s1["radix"] is None
                           else s1["radix"]["hit_tokens"] - s0["radix"]["hit_tokens"]),
            "reused": s1["reused"] - s0["reused"]}
    same_b = all(on.ids(k) == off.ids(k) for k in on.trace.runs if k.startswith("b"))
    res["b_ids_equal"] = same_b
    print(f"radix (b) {RADIX_CHATS} two-turn chats over 8 slots, tree on: "
          f"{json.dumps(res['b_on'])}; off: {json.dumps(res['b_off'])}; greedy ids equal "
          f"on/off: {same_b}", flush=True)

    # ---- (d) preemption: 8 priority-0 streams, then a priority-2 arrival
    # turns of their own (the tree holds (a)'s replies, which would serve a
    # resume every row), run uninterrupted on the server without the tree,
    # so the victim's resume re-prefills what its suspension left out
    streams = {f"d-{i}": _chat(system, f"{chr(97 + i)}) " + _filler(n - 3, f"stream {i}"),
                               RADIX_PREEMPT_TOKENS, priority=0)
               for i, n in enumerate(RADIX_TURNS)}
    off.burst({f"base-{k}": b for k, b in streams.items()})
    hi_body = _chat(system, "Z) " + _filler(90, "urgent"), 16, priority=2)
    for label, srv in (("on", on), ("off", off)):
        s0 = srv.stats()
        firsts = [threading.Event() for _ in streams]
        out: dict = {}

        def run(i, k, srv=srv, out=out, firsts=firsts):
            st, _ = _stream(srv.port, streams[k], firsts[i], f"{k}-{label}")
            if st != 200:
                fail(f"radix (d): stream {k} answered {st}")
            out[k] = (st, time.perf_counter())  # (status, when it ended)

        threads = [threading.Thread(target=run, args=(i, k)) for i, k in enumerate(streams)]
        for th in threads:
            th.start()
        for ev in firsts:
            if not ev.wait(300):
                fail("radix (d): a priority-0 stream produced no token in 300 s")
        st, raw, t_hi = _post_timed(srv.port, hi_body, f"d-hi-{label}")
        if st != 200:
            fail(f"radix (d): the priority-2 request answered {st}: {raw[:300]!r}")
        hi = json.loads(raw)
        t_hi_done = time.perf_counter()
        for th in threads:
            th.join(timeout=600)
            if th.is_alive():
                fail("radix (d): a priority-0 stream did not finish within 600 s")
        s1 = srv.stats()
        res[f"d_{label}"] = {
            "hi_ttft_ms": hi["timings"]["ttft_ms"],
            "hi_queue_wait_ms": hi["timings"]["queue_wait_ms"],
            "streams_done_after_hi_s": max(t for _, t in out.values()) - t_hi_done,
            # > 0: admitted while every priority-0 stream still ran
            "hi_admitted_before_a_stream_ended_s": (
                min(t for _, t in out.values())
                - (t_hi + hi["timings"]["queue_wait_ms"] / 1e3)),
            "preemptions": s1["preemptions"] - s0["preemptions"],
            "resumed": s1["resumed"] - s0["resumed"]}
    res["d_on"]["resume_rows"] = list(on.resume_rows)
    reports += _same_ids(loaded, on, off, [(f"{k}-on", f"base-{k}") for k in streams], "(d)")
    reports += _same_ids(loaded, off, off, [(f"{k}-off", f"base-{k}") for k in streams],
                         "(d) off")
    print(f"radix (d) a priority-2 arrival over 8 priority-0 streams, preempt on: "
          f"{json.dumps(res['d_on'])}; preempt off: {json.dumps(res['d_off'])}", flush=True)
    if (not res["d_on"]["preemptions"] or res["d_on"]["resumed"] != res["d_on"]["preemptions"]
            or res["d_on"]["hi_admitted_before_a_stream_ended_s"] <= 0):
        fail(f"radix (d): preemptions {res['d_on']['preemptions']}, resumed "
             f"{res['d_on']['resumed']}, the first priority-0 stream ended "
             f"{res['d_on']['hi_admitted_before_a_stream_ended_s']:.3f} s after the "
             "priority-2 request was admitted")
    if res["d_off"]["preemptions"]:
        fail("radix (d): --preempt off preempted")
    res["audit_on"], res["audit_off"] = on.close("on"), off.close("off")
    del on, off
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) the host spill tier on a 48-page pool
    # B, C and D share a 12-token prefix (one more than the chat header all
    # four share), so their lookups offer each other, not A, as the
    # sub-page boundary and leave A the coldest leaf
    prompts = {k: _chat(_filler(RADIX_SYSTEM_ROWS, seed), turns[0])
               for k, seed in (("A", "A"), ("B", "Zb"), ("C", "Zc"), ("D", "Zd"))}
    a_runs = []  # A's second (prompt, ids) on each server
    for label, host_pages in (("host", RADIX_HOST_PAGES), ("nohost", 0)):
        srv = RadixServer(loaded, kv_pages=RADIX_KV_PAGES, kv_host_pages=host_pages)
        first = srv.post(prompts["A"], "c-A1")
        for k in "BCD":
            srv.post(prompts[k], f"c-{k}")
        again = srv.post(prompts["A"], "c-A2")
        host = srv.eng.pool.host
        out = {"A_first_ttft_ms": first["timings"]["ttft_ms"],
               "A_again_ttft_ms": again["timings"]["ttft_ms"],
               "A_again_prompt_tokens": again["usage"]["prompt_tokens"],
               "radix": srv.stats()["radix"]}
        if host is not None:
            st = host.stats()
            out.update(spilled=st["spilled"], restored=st["restored"], dropped=st["dropped"],
                       spill_host_ms=st["spill_s"] * 1e3 / max(st["spilled"], 1),
                       slab_mb=st["slab_bytes"] / 1e6, **page_copy_ms(srv.eng))
            if not (st["spilled"] and st["restored"]):
                fail(f"radix (c): the tier spilled {st['spilled']} and restored "
                     f"{st['restored']} pages")
        reports += _same_ids(loaded, srv, srv, [("c-A2", "c-A1")], f"(c) {label}")
        res[f"c_{label}"] = out
        res[f"c_{label}"]["close"] = srv.close(label)
        a_runs.append(srv.trace.runs["c-A2"])
        del srv
        gc.collect()
        torch.cuda.empty_cache()
    (prompt, ids), (_, other) = a_runs
    res["c_ids_equal"] = ids == other
    reports += [m for m in [near_tie(loaded, prompt, ids, other, "radix (c) A with the tier "
                                     "against without")] if m]
    print(f"radix (c) spill tier ({RADIX_KV_PAGES} pool pages): {RADIX_HOST_PAGES} host "
          f"pages {json.dumps(res['c_host'])}; 0 host pages {json.dumps(res['c_nohost'])}; "
          f"A's ids equal across the two {res['c_ids_equal']}", flush=True)
    launches = counters()
    for k in ("q40_decode", "q40_prefill", "paged_attention"):
        if not launches[k]:
            fail(f"radix: kernel {k} was never launched")
    res["divergences"] = reports
    print(f"radix (e) every pool audited clean before its drain and freed every page after "
          f"it, no spill discarded; divergences {len(reports)}; launches {launches}",
          flush=True)
    return launches


#: obs phase: decode tokens of each of the 8 priority-0 streams; the
#: priority-2 request's, the burst's and the hung-up stream's budgets; the
#: 256-stream drill (its distinct prompts and tokens a stream); the tokens of
#: a stream of the cost runs; the SLO targets the server judges by
OBS_STREAM_TOKENS = 256
OBS_HI_TOKENS, OBS_BURST, OBS_BURST_TOKENS, OBS_CUT_FRAMES = 16, 16, 16, 8
OBS_DRILL_STREAMS, OBS_DRILL_PROMPTS, OBS_DRILL_TOKENS = 256, 8, 8
OBS_COST_TOKENS = 128
OBS_SLO = {"slo_ttft_ms": 2000.0, "slo_itl_ms": 50.0}
#: the profiler activity the capture must record, and the kernel-name
#: fragments of the Q40 decode kernel (K1) and the paged attention kernel
#: (K9) its trace must hold
OBS_PROFILE_ACTIVITY = "cuda"
OBS_PROFILE_NAMES = {"q40_decode": "Q40Codes", "paged_attention": "PagedRows"}
#: the graphs `--warmup auto` captures on the 8-slot server: 3 decode
#: variants x DECODE_CHUNK, and every prefill width
OBS_CAPTURES = 12 + PREFILL_WIDTHS
#: the obs phase's ceiling on dllama_process_threads over its idle value under
#: 256 streams: the aio loop, its pump, 8 workers, 2 control threads and the
#: client's reader thread
OBS_THREAD_SLACK = 16


def _get_json(port: int, path: str) -> tuple[int, dict]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, json.loads(data)


def _scrape(port: int) -> tuple[dict, float]:
    """GET /metrics -> ({(name, labels): value}, ms the scrape took)."""
    import re

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("GET", "/metrics")
    resp = conn.getresponse()
    text = resp.read().decode()
    conn.close()
    ms = (time.perf_counter() - t0) * 1e3
    if resp.status != 200:
        fail(f"obs: /metrics answered {resp.status}")
    out = {}
    for line in text.splitlines():
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)$", line)
        if m:
            out[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return out, ms


def _family_delta(before: dict, after: dict, name: str) -> dict:
    """{labels: after - before} of one family's samples that moved."""
    return {k[1]: v - before.get(k, 0.0) for k, v in after.items()
            if k[0] == name and v != before.get(k, 0.0)}


def _sse(port: int, body: dict, req_id: str = "", progress: list | None = None, i: int = 0,
         hang_up_after: int = 0, first: threading.Event | None = None, on_frame=None) -> dict:
    """A streamed chat completion read frame by frame -> {status, content,
    frames (content frames read), finish, timings, t_first, t_done, done,
    error (an in-band error event), retrying (`: retrying` comments), and
    with include_token_ids ids, id_frames [(position, n ids)] and frame_t
    (time.perf_counter() of each such frame)}. `progress[i]` follows the
    frames read and `first` is set at the first one; `on_frame(k)` runs
    after the k-th token-id frame; with `hang_up_after` the client closes
    the connection after that many content frames."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/v1/chat/completions", json.dumps(dict(body, stream=True)),
                 _headers(req_id))
    resp = conn.getresponse()
    out = {"status": resp.status, "content": "", "frames": 0, "finish": None,
           "timings": None, "t_first": None, "t_done": None, "done": False, "error": None,
           "retrying": 0, "ids": [], "id_frames": [], "frame_t": []}
    while True:
        line = resp.readline()
        if not line:
            break
        line = line.decode().strip()
        if line.startswith(": retrying"):
            out["retrying"] += 1
            continue
        if line == "data: [DONE]":
            out["t_done"], out["done"] = time.perf_counter(), True
            resp.read()
            break
        if not line.startswith("data: "):
            continue
        ev = json.loads(line[6:])
        if "error" in ev:
            out["error"] = ev["error"]
            continue
        if ev.get("token_ids"):
            out["id_frames"].append((ev["position"], len(ev["token_ids"])))
            out["ids"] += ev["token_ids"]
            out["frame_t"].append(time.perf_counter())
            if on_frame is not None:
                on_frame(len(out["frame_t"]))
        choice = ev["choices"][0]
        text = choice["delta"].get("content")
        if text:
            out["content"] += text
            out["frames"] += 1
            if out["t_first"] is None:
                out["t_first"] = time.perf_counter()
                if first is not None:
                    first.set()
            if progress is not None:
                progress[i] = out["frames"]
            if hang_up_after and out["frames"] >= hang_up_after:
                break  # the client goes away mid-stream
        if choice.get("finish_reason"):
            out["finish"], out["timings"] = choice["finish_reason"], ev.get("timings")
    resp.close()
    conn.close()
    return out


def _wait_for(cond, what: str, timeout_s: float = 120.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            fail(f"obs: {what} did not happen within {timeout_s:.0f} s")
        time.sleep(0.01)


def _obs_server(loaded, **kw):
    """The 8-slot server at its defaults (make_server: aio, the radix tree,
    preemption, hybrid admission) with --warmup auto and the SLO targets,
    serving in a thread -> (httpd, api, port)."""
    from dllama_tpu_torch.serve.api import make_server

    httpd, api = make_server(loaded, host="127.0.0.1", port=0, n_slots=8, warmup="auto",
                             **OBS_SLO, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, api, httpd.server_address[1]


def _obs_close(httpd, api, label: str) -> None:
    """Drain the server; its pool must audit clean with every page free."""
    from dllama_tpu_torch.serve.api import graceful_drain

    if not graceful_drain(httpd, api, timeout_s=120):
        fail(f"obs {label}: the drain did not finish in time")
    httpd.server_close()
    report = api.scheduler.engine.pool.audit(raise_on_fail=False)
    if not (report["ok"] and report["free"] == report["total"]):
        fail(f"obs {label}: the pool after the drain {report}")


def _stream_rates(port: int, prompts: list[str], tokens: int, label: str) -> float:
    """8 concurrent greedy streams -> their aggregate decode tokens/s (the
    sum of each stream's (tokens - 1) / (last token - first token))."""
    bodies = [{"messages": [{"role": "user", "content": p}], "temperature": 0,
               "max_tokens": tokens} for p in prompts]
    outs = _concurrently(lambda b, k: _sse(port, b, k),
                         [(b, f"obs-{label}-{i}") for i, b in enumerate(bodies)])
    rate = 0.0
    for o in outs:
        n = o["timings"]["decode_tokens"] if o["timings"] else 0
        if not o["done"] or n < 2 or o["t_done"] <= o["t_first"]:
            fail(f"obs {label}: a stream ended without [DONE] or with {n} tokens")
        rate += (n - 1) / (o["t_done"] - o["t_first"])
    return rate


def _drill(port: int, api, trace_ids, loaded) -> dict:
    """OBS_DRILL_STREAMS concurrent SSE streams over OBS_DRILL_PROMPTS
    prompts, each prompt first served alone: every stream ends with
    [DONE], its content equals its prompt's alone (or first differs at a
    near tie), and dllama_process_threads stays within OBS_THREAD_SLACK of
    its idle value. -> {threads_idle, threads_mid, connections_mid, s,
    divergences}."""
    import selectors
    import socket

    prompts = [f"Drill {k}: a short note about {t}." for k, t in enumerate(
        ("rain", "tides", "maps", "lamps", "ships", "salt", "wind", "stars"))]
    prompts = prompts[:OBS_DRILL_PROMPTS]
    bodies = [{"messages": [{"role": "user", "content": p}], "temperature": 0,
               "max_tokens": OBS_DRILL_TOKENS} for p in prompts]
    alone = []
    for k, b in enumerate(bodies):
        st, raw, _ = _post_timed(port, b, f"obs-alone-{k}")
        if st != 200:
            fail(f"obs drill: prompt {k} alone answered {st}")
        alone.append(json.loads(raw)["choices"][0]["message"]["content"])
    idle = _scrape(port)[0][("dllama_process_threads", "")]
    sel = selectors.DefaultSelector()
    socks = {}
    t0 = time.perf_counter()
    for i in range(OBS_DRILL_STREAMS):
        body = json.dumps(dict(bodies[i % len(bodies)], stream=True)).encode()
        head = (f"POST /v1/chat/completions HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
                f"Content-Type: application/json\r\nX-Request-Id: obs-drill-{i}\r\n"
                f"Content-Length: {len(body)}\r\n\r\n").encode()
        s = socket.create_connection(("127.0.0.1", port), timeout=60)
        s.sendall(head + body)
        s.setblocking(False)
        socks[s] = (i, bytearray())
        sel.register(s, selectors.EVENT_READ)
    done, headered, mid = set(), set(), None
    deadline = time.monotonic() + 300
    while len(done) < OBS_DRILL_STREAMS and time.monotonic() < deadline:
        for key, _ in sel.select(timeout=1.0):
            s = key.fileobj
            try:
                data = s.recv(65536)
            except (BlockingIOError, InterruptedError):
                continue
            except OSError:
                data = b""
            buf = socks[s][1]
            if data:
                buf += data
                if b"text/event-stream" in buf:
                    headered.add(s)
            if not data or b"data: [DONE]" in buf:
                sel.unregister(s)
                s.close()
                done.add(s)
        if mid is None and len(headered) >= OBS_DRILL_STREAMS and len(done) < OBS_DRILL_STREAMS // 2:
            m, _ = _scrape(port)
            server = f'{{server="127.0.0.1:{port}"}}'
            # the streams whose client has not closed yet are live
            mid = (m[("dllama_process_threads", "")],
                   m.get(("dllama_frontend_connections", server), 0.0),
                   OBS_DRILL_STREAMS - len(done))
    secs = time.perf_counter() - t0
    if len(done) < OBS_DRILL_STREAMS:
        fail(f"obs drill: {len(done)} of {OBS_DRILL_STREAMS} streams finished in 300 s")
    if mid is None:
        fail("obs drill: never saw every stream live at once")
    if mid[0] - idle > OBS_THREAD_SLACK or mid[1] < mid[2]:
        fail(f"obs drill: {mid[0]:.0f} threads (idle {idle:.0f}) and {mid[1]:.0f} connections "
             f"under {mid[2]} live streams")
    divergences = []
    for s, (i, buf) in socks.items():
        if b"data: [DONE]" not in buf:
            fail(f"obs drill: stream {i} closed without [DONE]")
        text = _sse_content(bytes(buf))
        k = i % len(bodies)
        if text != alone[k]:
            prompt, ids = trace_ids.runs[f"obs-drill-{i}"]
            msg = near_tie(loaded, prompt, ids, trace_ids.runs[f"obs-alone-{k}"][1],
                           f"obs drill stream {i}")
            if msg:
                divergences.append(msg)
    return {"threads_idle": idle, "threads_mid": mid[0], "connections_mid": mid[1],
            "streams_live_mid": mid[2], "s": secs, "divergences": divergences}


def _sse_content(raw: bytes) -> str:
    """The streamed content of a raw chunked SSE response."""
    out = []
    for line in raw.decode(errors="replace").split("\n"):
        if line.startswith("data: {"):
            try:
                ev = json.loads(line[6:].strip())
            except ValueError:
                continue  # a frame cut by the chunked framing's length lines
            out.append(ev["choices"][0]["delta"].get("content") or "")
    return "".join(out)


def phase_obs(loaded, card: str) -> dict:
    """The observability stack on the 8-slot server at its defaults (aio,
    --warmup auto, --trace-buffer 2048, --slo-ttft-ms / --slo-itl-ms): a
    mixed run (8 greedy priority-0 streams, a 1 s POST /debug/profile and a
    /debug/perf read during their decode, a priority-2 arrival that
    preempts one of them, then a burst of 16 chats beside a stream whose
    client hangs up) scraped before and after; then the 256-stream drill;
    then the decode tokens/s of 8 streams on aio with tracing, aio without
    and the threads server. Returns the launches of the mixed run."""
    import math
    import tempfile as _tempfile

    from dllama_tpu_torch.obs import compile as compile_obs
    from dllama_tpu_torch.obs import trace
    from dllama_tpu_torch.obs.perf import peak_hbm_gbs
    from dllama_tpu_torch.serve.scheduler import DECODE_CHUNK

    res: dict = {"card": card}
    trace.configure(2048)
    compile_obs.LEDGER.reset()
    httpd, api, port = _obs_server(loaded)
    if type(httpd).__name__ != "AioHttpServer":
        fail(f"obs: make_server's default transport is {type(httpd).__name__}, not aio")
    sched = api.scheduler
    ids = IdTrace(sched)
    warm = sched.warmup_report
    m0, res["scrape_ms"] = _scrape(port)
    led0, lat0, radix0 = sched.ledger.snapshot(), sched.latency_summary(), sched.engine.radix_stats()

    # ---- (a) the mixed run
    reset_counters()
    prompts = batch_prompts(8)
    streams = [{"messages": [{"role": "user", "content": p}], "temperature": 0,
                "max_tokens": OBS_STREAM_TOKENS, "priority": 0} for p in prompts]
    progress = [0] * len(streams)
    outs: dict = {}

    def run_stream(i):
        outs[f"obs-s{i}"] = _sse(port, streams[i], f"obs-s{i}", progress, i)

    # the first profiler capture pays CUPTI's initialization (seconds): a
    # short one before the streams, so the timed one starts at once
    prof_dir = _tempfile.mkdtemp(prefix="dllama_obs_profile_")
    warm_dir = os.path.join(prof_dir, "warm")
    _profile(port, 0.05, warm_dir)
    _wait_for(lambda: _profile_done(os.path.join(warm_dir, "trace.json")), "the first profile")
    threads = [threading.Thread(target=run_stream, args=(i,)) for i in range(len(streams))]
    for th in threads:
        th.start()
    _wait_for(lambda: min(progress) >= 4, "every stream's 4th token")
    hi = {}

    def run_hi():
        st, raw, _ = _post_timed(port, {"messages": [{"role": "user", "content":
                                                      "Urgent: name three harbours."}],
                                        "temperature": 0, "max_tokens": OBS_HI_TOKENS,
                                        "priority": 2}, "obs-hi")
        hi.update(status=st, body=json.loads(raw) if st == 200 else raw)

    # the priority-2 arrival finds every slot decoding: it preempts one
    hi_thread = threading.Thread(target=run_hi)
    hi_thread.start()
    _wait_for(lambda: min(progress) >= OBS_STREAM_TOKENS // 4, "a quarter of every stream")
    # the roofline before the profile: stopping a profile and writing its
    # trace holds the server's interpreter for seconds (measured below)
    st, perf_mid = _get_json(port, "/debug/perf")
    roof = perf_mid["roofline"]
    att = roof["bandwidth_attainment"]
    if st != 200 or att is None or not math.isfinite(att) or not 0 < att < 1.05:
        fail(f"obs: bandwidth attainment during the 8-stream decode is {att} ({roof})")
    res["roofline"] = {k: roof[k] for k in ("bandwidth_attainment", "achieved_gbs", "peak_gbs",
                                           "window_chunks", "device_s", "bytes")}
    t0 = time.perf_counter()
    led_p0 = sched.ledger.snapshot()
    prof = _profile(port, 1.0, prof_dir)
    res["profile_start_ms"] = (time.perf_counter() - t0) * 1e3
    res["streams_min_tokens_at_profile"] = min(progress)
    hi_thread.join(timeout=600)
    for th in threads:
        th.join(timeout=600)
    # the ledger's seconds from the profile's start to its trace on disk
    # (its stop and write hold the interpreter), apart from the rest
    _wait_for(lambda: _profile_done(prof["trace"]), "the profile's trace file")
    led_p1 = sched.ledger.snapshot()
    if hi.get("status") != 200 or any(not o["done"] for o in outs.values()):
        fail(f"obs: the priority-2 request answered {hi.get('status')} or a stream ended "
             "without [DONE]")
    cut: dict = {}
    burst_bodies = {f"obs-b{i}": {"messages": [{"role": "user", "content": p}],
                                  "temperature": 0, "max_tokens": OBS_BURST_TOKENS}
                    for i, p in enumerate(batch_prompts(OBS_BURST))}

    def run_cut():
        cut.update(_sse(port, {"messages": [{"role": "user", "content": prompts[0]}],
                               "temperature": 0, "max_tokens": 512}, "obs-cut",
                        hang_up_after=OBS_CUT_FRAMES))

    cut_thread = threading.Thread(target=run_cut)
    cut_thread.start()
    burst = dict(zip(burst_bodies, _concurrently(
        lambda b, k: _post_timed(port, b, k), [(b, k) for k, b in burst_bodies.items()])))
    cut_thread.join(timeout=600)
    if any(st != 200 for st, _, _ in burst.values()) or cut.get("frames") != OBS_CUT_FRAMES:
        fail(f"obs: a burst request failed or the hung-up stream read {cut.get('frames')} "
             "frames")
    _wait_for(lambda: _get_json(port, "/debug/requests/obs-cut")[1].get("state")
              == "finished", "the hung-up stream's cancel")
    m1, scrape_ms = _scrape(port)
    res["scrape_ms_loaded"] = scrape_ms
    led1, lat1, radix1 = sched.ledger.snapshot(), sched.latency_summary(), sched.engine.radix_stats()
    launches = counters()
    for k in ("q40_decode", "q40_prefill", "paged_attention"):
        if not launches[k]:
            fail(f"obs: kernel {k} was never launched")
    res["launches"] = {k: v for k, v in launches.items() if v}

    # ---- counters against the clients
    burst_out = {k: json.loads(raw) for k, (_, raw, _) in burst.items()}
    cut_rec = _get_json(port, "/debug/requests/obs-cut")[1]
    client_tokens = (sum(o["timings"]["decode_tokens"] for o in outs.values())
                     + hi["body"]["usage"]["completion_tokens"]
                     + sum(b["usage"]["completion_tokens"] for b in burst_out.values()))
    cut_tokens = cut_rec["decode_tokens"]
    tok_delta = _family_delta(m0, m1, "dllama_tokens_generated_total").get("", 0.0)
    finish_client: dict = {}
    for reason in ([o["finish"] for o in outs.values()]
                   + [hi["body"]["choices"][0]["finish_reason"]]
                   + [b["choices"][0]["finish_reason"] for b in burst_out.values()]
                   + ["cancelled"]):
        finish_client[f'{{reason="{reason}"}}'] = finish_client.get(f'{{reason="{reason}"}}', 0) + 1
    finish_delta = _family_delta(m0, m1, "dllama_requests_finished_total")
    ttft_delta = _family_delta(m0, m1, "dllama_ttft_seconds_count").get("", 0.0)
    n_first = len(outs) + 1 + len(burst_out) + 1
    pre_delta = sum(_family_delta(m0, m1, "dllama_preemptions_total").values())
    res_delta = _family_delta(m0, m1, "dllama_resumed_total").get("", 0.0)
    hit_delta = _family_delta(m0, m1, "dllama_radix_hit_tokens_total").get("", 0.0)
    res["counters"] = {
        "tokens_delta": tok_delta, "client_tokens": client_tokens, "cut_tokens": cut_tokens,
        "cut_frames_read": cut["frames"], "finished_delta": finish_delta,
        "finished_client": finish_client, "ttft_count_delta": ttft_delta,
        "first_tokens": n_first, "preemptions_delta": pre_delta,
        "preemptions_summary": lat1["preemptions"] - lat0["preemptions"],
        "resumed_delta": res_delta, "resumed_summary": lat1["resumed"] - lat0["resumed"],
        "radix_hit_delta": hit_delta,
        "radix_hit_stats": radix1["hit_tokens"] - radix0["hit_tokens"]}
    c = res["counters"]
    if (tok_delta != client_tokens + cut_tokens
            or not cut["frames"] <= cut_tokens <= cut["frames"] + 2 * DECODE_CHUNK
            or finish_delta != finish_client or ttft_delta != n_first
            or pre_delta != c["preemptions_summary"] or pre_delta < 1
            or res_delta != c["resumed_summary"] or hit_delta != c["radix_hit_stats"]):
        fail(f"obs: /metrics disagrees with the clients: {json.dumps(c)}")
    print(f"obs counters against the clients: {json.dumps(c)}", flush=True)

    # ---- the time ledger
    sec = {k[1][len('{state="'):-2]: v for k, v in m1.items()
           if k[0] == "dllama_scheduler_time_seconds_total"}
    sec = {s: v - m0.get(("dllama_scheduler_time_seconds_total", f'{{state="{s}"}}'), 0.0)
           for s, v in sec.items()}
    wall = led1["wall_s"] - led0["wall_s"]
    covered = sum(sec.values())
    in_prof = {s: led_p1["seconds"][s] - led_p0["seconds"][s] for s in led_p1["seconds"]}
    wall_prof = led_p1["wall_s"] - led_p0["wall_s"]
    rest = wall - wall_prof
    res["ledger"] = {"wall_s": wall, "covered_s": covered,
                     "shares": {s: v / wall for s, v in sorted(sec.items()) if v},
                     "profile_window_s": wall_prof,
                     "shares_outside_profile": {s: (v - in_prof.get(s, 0.0)) / rest
                                                for s, v in sorted(sec.items()) if v}}
    if not abs(covered - wall) <= 0.05 * wall:
        fail(f"obs: the ledger's states sum to {covered:.3f} s of {wall:.3f} s wall")
    print(f"obs ledger over {wall:.3f} s of scheduler wall ({covered:.3f} s billed): "
          f"{json.dumps(res['ledger']['shares'])}; outside the profile's {wall_prof:.3f} s "
          f"(its start to its trace on disk): "
          f"{json.dumps(res['ledger']['shares_outside_profile'])}", flush=True)

    # ---- captures
    st, comp = _get_json(port, "/debug/compile")
    health = _get_json(port, "/health")[1]["compile"]
    want = warm["graphs_captured"]
    res["captures"] = {"warmup": want, "compiles": comp["compiles"],
                       "unexpected": comp["unexpected"], "health": health,
                       "full": comp["contract"]["full"]}
    if not (want == OBS_CAPTURES == comp["compiles"] == health["compiles"]
            and comp["unexpected"] == health["unexpected_compiles"] == 0
            and (comp["contract"]["full"] or not OBS_CAPTURES)):
        fail(f"obs: captures {json.dumps(res['captures'])}")

    # ---- tracing
    st, doc = _get_json(port, "/debug/trace")
    by_req: dict = {}
    for ev in doc["traceEvents"]:
        rid = ev.get("args", {}).get("req_id")
        if rid:
            by_req.setdefault(rid, set()).add(ev["name"])
    run_ids = list(outs) + ["obs-hi", "obs-cut"] + list(burst_out)
    missing = [r for r in run_ids if r not in by_req]
    victims = [r for r, names in by_req.items() if "request.preempted" in names]
    hi_rec = _get_json(port, "/debug/requests/obs-hi")[1]
    if (missing or not victims or not all("request.resumed" in by_req[v] for v in victims)
            or hi_rec.get("state") != "finished" or hi_rec.get("slot") is None
            or hi_rec.get("queue_wait_ms") is None):
        fail(f"obs: trace spans missing for {missing}; victims {victims}; priority-2 record "
             f"{hi_rec}")
    res["trace"] = {"events": len(doc["traceEvents"]), "requests": len(run_ids),
                    "victims": victims, "hi_queue_wait_ms": hi_rec["queue_wait_ms"],
                    "hi_ttft_ms": hi_rec["ttft_ms"], "hi_slo": hi_rec["slo"]["ok"]}

    # ---- profiling
    path = prof["trace"]
    with open(path) as f:
        text = f.read()
    names = {k: text.count(v) for k, v in OBS_PROFILE_NAMES.items()}
    json.loads(text)  # Chrome trace JSON
    from dllama_tpu_torch.utils import profiling

    res["profile"] = {"trace_mb": len(text) / 1e6, "name_hits": names,
                      "stop_and_write_s": profiling.profile_status()["last_written_s"]}
    if not all(names.values()):
        fail(f"obs: the profile holds no {[k for k, v in names.items() if not v]} kernel")
    os.remove(path)
    print(f"obs captures {json.dumps(res['captures'])}; trace {json.dumps(res['trace'])}; "
          f"profile {json.dumps(res['profile'])}", flush=True)

    # ---- the front end at scale
    res["drill"] = _drill(port, api, ids, loaded)
    print(f"obs drill {OBS_DRILL_STREAMS} SSE streams on 8 slots: "
          f"{json.dumps(res['drill'])}", flush=True)

    _obs_close(httpd, api, "the mixed run")

    # ---- what the stack costs: fresh servers, aio traced, aio untraced,
    # threads traced
    cost_prompts = batch_prompts(8)
    rates = {}
    for label, buffer, frontend in (("aio_trace2048", 2048, "aio"), ("aio_trace0", 0, "aio"),
                                    ("threads_trace2048", 2048, "threads")):
        trace.configure(buffer)
        httpd, api, port = _obs_server(loaded, frontend=frontend)
        rates[label] = _stream_rates(port, cost_prompts, OBS_COST_TOKENS, label)
        _obs_close(httpd, api, label)
    trace.configure(2048)
    res["decode_tok_s"] = rates
    res["aio_over_threads"] = rates["aio_trace2048"] / rates["threads_trace2048"]
    res["trace_over_untraced"] = rates["aio_trace2048"] / rates["aio_trace0"]
    peak = peak_hbm_gbs()
    print(f"obs on {card}: bandwidth attainment {att:.4f} of {peak} GB/s "
          f"({roof['achieved_gbs']} GB/s over {roof['window_chunks']} chunks); "
          f"decode tok/s of 8 streams {json.dumps(rates)}; aio/threads "
          f"{res['aio_over_threads']:.4f}, traced/untraced {res['trace_over_untraced']:.4f}; "
          f"/metrics scrape {res['scrape_ms']:.2f} ms idle, {scrape_ms:.2f} ms after the run",
          flush=True)
    print(f"obs: {json.dumps(res)}", flush=True)
    return launches


def _profile(port: int, seconds: float, log_dir: str) -> dict:
    """POST /debug/profile; fails unless it answered 200 with the required
    activity -> its `profiling` object."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/debug/profile", json.dumps({"duration_s": seconds, "dir": log_dir}),
                 _headers())
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    if resp.status != 200 or OBS_PROFILE_ACTIVITY not in body["profiling"]["activities"]:
        fail(f"obs: POST /debug/profile answered {resp.status}: {body}")
    return body["profiling"]


def _profile_done(path: str) -> bool:
    """True once a profile's Chrome trace is completely written."""
    from dllama_tpu_torch.utils import profiling

    st = profiling.profile_status()
    return not st["active"] and st["last_trace"] == path


def page_copy_ms(eng, reps: int = 10) -> dict:
    """CUDA-event medians of one page's copy host-to-device (a restore: a
    slab row into the trash page) and device-to-host (a spill: a page into a
    pinned buffer of the slab's row shape)."""
    import torch

    host, trash = eng.pool.host, eng.pool.n_pages
    buf_k, buf_v = torch.empty_like(host.k[0]), torch.empty_like(host.v[0])

    def timed(fn):
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def restore():
        eng.cache.k[:, trash].copy_(host.k[0], non_blocking=True)
        eng.cache.v[:, trash].copy_(host.v[0], non_blocking=True)

    def spill():
        buf_k.copy_(eng.cache.k[:, trash], non_blocking=True)
        buf_v.copy_(eng.cache.v[:, trash], non_blocking=True)

    return {"restore_page_ms": timed(restore), "spill_page_ms": timed(spill)}


# ------------------------------------------------------------ phases 17-18

#: supervision: the server's --stall-deadline-s, the tokens a stream of (a),
#: the token frames stream 0 shows before engine.decode is armed, and the
#: greedy tokens before and after the session round trip of (e)
SUP_STALL_S = 2.0
SUP_TOKENS = 128
SUP_CRASH_AT = 32
SESSION_TOKENS = 32
#: router: tokens a stream, and the token frames the client holds before the
#: serving replica is killed
ROUTER_TOKENS = 64
ROUTER_KILL_AT = 8


def _sse_ids(port: int, body: dict, req_id: str = "", on_frame=None) -> dict:
    """_sse with include_token_ids (the router's journal feed)."""
    return _sse(port, dict(body, include_token_ids=True), req_id, on_frame=on_frame)


def _whole(res: dict, n: int, label: str) -> None:
    """A stream that ended cleanly at its budget of n tokens (the finish
    frame's decode_tokens), each position of its token frames once. (Ids
    ride the frame of their text: trailing tokens whose text is empty end
    the stream in no frame, as in the JAX package.)"""
    at = 0
    for pos, k in res["id_frames"]:
        if pos != at:
            fail(f"{label}: a frame at position {pos} where {at} was next (a token lost or "
                 f"repeated): {res['id_frames']}")
        at += k
    got = (res["timings"] or {}).get("decode_tokens")
    if not (res["status"] == 200 and res["done"] and res["error"] is None
            and res["finish"] == "length" and got == n and len(res["ids"]) <= n):
        fail(f"{label}: the stream did not finish whole: status {res['status']}, finish "
             f"{res['finish']}, error {res['error']}, {got} of {n} tokens, "
             f"{len(res['ids'])} ids in frames")


def _sup_bodies(prompts: list[str], tokens: int) -> list[dict]:
    """Greedy streams, two sampled (seeded) and one penalized greedy."""
    out = []
    for i, p in enumerate(prompts):
        b = {"messages": [{"role": "user", "content": p}], "max_tokens": tokens,
             "temperature": 0.0, "seed": 100 + i}
        if i in (5, 6):
            b.update(temperature=0.8, top_p=0.9)
        if i == 7:
            b.update(presence_penalty=0.5, frequency_penalty=0.3)
        out.append(b)
    return out


def phase_supervision(loaded, tmpdir: str) -> dict:
    """Fault injection, the watchdog, warm restart, sessions and the
    transfer guard on the 8B Q40 model. Returns the launch counts of the
    drills, zeroed just before them and read just after."""
    import numpy as np
    import torch

    from dllama_tpu_torch.engine.engine import InferenceEngine
    from dllama_tpu_torch.engine.sampling import Sampler
    from dllama_tpu_torch.obs import compile as compile_obs
    from dllama_tpu_torch.serve.api import graceful_drain, make_server
    from dllama_tpu_torch.utils import faults

    t_boot = time.perf_counter()
    httpd, api = make_server(loaded, host="127.0.0.1", port=0, n_slots=8, warmup="auto",
                             restart_max=2, stall_deadline_s=SUP_STALL_S)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port, sched = httpd.server_address[1], api.scheduler
    print(f"supervision: server up in {time.perf_counter() - t_boot:.1f} s "
          f"({sched.warmup_report['graphs_captured']} graphs captured)", flush=True)
    marks: dict = {}
    restart, warm_restart, emit = sched._try_restart, sched.engine.warm_restart, sched._emit

    def stamped_restart(exc):
        marks.setdefault("crash", time.perf_counter())
        return restart(exc)

    def timed_rebuild():
        t0 = time.perf_counter()
        warm_restart()
        marks["rebuild_ms"] = (time.perf_counter() - t0) * 1e3

    def stamped_emit(req, token, row):
        if "crash" in marks and "resumed" not in marks:
            marks["resumed"] = time.perf_counter()
        return emit(req, token, row)

    sched._try_restart, sched.engine.warm_restart, sched._emit = (
        stamped_restart, timed_rebuild, stamped_emit)
    reset_counters()
    bodies = _sup_bodies(batch_prompts(8), SUP_TOKENS)
    # (a) a crash in a decode dispatch with 8 streams mid-flight: one warm restart
    base = _concurrently(lambda i: _sse_ids(port, bodies[i], f"sup-base-{i}"),
                         [(i,) for i in range(8)])
    for i, r in enumerate(base):
        _whole(r, SUP_TOKENS, f"supervision (a) baseline stream {i}")
    m0, _ = _scrape(port)
    captures0, unexpected0 = (compile_obs.LEDGER.total_compiles(),
                              compile_obs.LEDGER.total_unexpected())
    armed = threading.Event()

    def arm(k):
        if k >= SUP_CRASH_AT and not armed.is_set():
            armed.set()
            faults.install("engine.decode", "raise", times=1)

    crash = _concurrently(lambda i: _sse_ids(port, bodies[i], f"sup-crash-{i}",
                                             on_frame=arm if i == 0 else None),
                          [(i,) for i in range(8)])
    faults.clear()
    for i, r in enumerate(crash):
        _whole(r, SUP_TOKENS, f"supervision (a) stream {i} across the restart")
    if sched.restart_count != 1 or "resumed" not in marks:
        fail(f"supervision (a): {sched.restart_count} restarts (want 1), marks {marks}")
    m1, _ = _scrape(port)
    restarts = _family_delta(m0, m1, "dllama_engine_restarts_total")
    recovered = _family_delta(m0, m1, "dllama_requests_recovered_total")
    if restarts != {"": 1.0} or sum(recovered.values()) < 1:
        fail(f"supervision (a): restarts {restarts}, recovered {recovered}")
    captures1, unexpected1 = (compile_obs.LEDGER.total_compiles(),
                              compile_obs.LEDGER.total_unexpected())
    if captures1 != captures0 or unexpected1 != unexpected0:
        fail(f"supervision (a): the restart captured {captures1 - captures0} programs "
             f"({unexpected1 - unexpected0} unexpected); it must recapture none")
    st, kv = _get_json(port, "/debug/kv")
    if st != 200 or not (kv.get("audit") or {}).get("ok"):
        fail(f"supervision (a): /debug/kv after the restart {st} {kv}")
    enc = api  # the batched tier's chat encoding, for near_tie's replay
    kinds = ["greedy"] * 5 + ["sampled", "sampled", "penalized"]
    parted = []
    for i, kind in enumerate(kinds):
        same = crash[i]["ids"] == base[i]["ids"]
        if kind == "greedy" and not same:
            near_tie(loaded, prompt_ids(enc, bodies[i]), crash[i]["ids"], base[i]["ids"],
                     f"supervision (a) greedy stream {i}")
        if not same:
            j = next(j for j, (x, y) in enumerate(zip(crash[i]["ids"], base[i]["ids"]))
                     if x != y)
            parted.append(f"{i} ({kind}) at token {j}")
    crash_ms = (marks["resumed"] - marks["crash"]) * 1e3
    print(f"supervision (a): 8 streams of {SUP_TOKENS} tokens whole across 1 warm restart "
          f"(the crash armed after {SUP_CRASH_AT} frames of stream 0); crash to the first "
          f"resumed token {crash_ms:.1f} ms (the rebuild {marks['rebuild_ms']:.1f} ms, the "
          f"backoff {sched.restart_backoff_s * 1e3:.0f} ms); recovered "
          f"{sum(recovered.values()):.0f}; captures unchanged ({captures1}, 0 unexpected); "
          f"/debug/kv clean; streams apart from the uninterrupted run: "
          f"{', '.join(parted) or 'none'}", flush=True)
    # (b) a decode dispatch delayed past the deadline: live goes false, then back
    stalls0 = _scrape(port)[0]
    prog = [0]
    stall_ms = (SUP_STALL_S + 1.5) * 1e3

    def arm_delay(k):
        prog[0] = k
        if k == 4:
            faults.install("engine.decode", "delay", ms=stall_ms, times=1)

    th = threading.Thread(target=lambda: marks.update(
        stall_stream=_sse_ids(port, dict(bodies[0], max_tokens=48), "sup-stall",
                              on_frame=arm_delay)))
    th.start()
    t0 = time.monotonic()
    seen = []
    while time.monotonic() - t0 < 60:
        seen.append((time.monotonic() - t0, _get_json(port, "/health/live")[0]))
        if seen[-1][1] == 200 and any(st == 503 for _, st in seen):
            break  # down, then back
        time.sleep(0.05)
    th.join(timeout=120)
    faults.clear()
    _whole(marks["stall_stream"], 48, "supervision (b) the delayed stream")
    stalls = _family_delta(stalls0, _scrape(port)[0], "dllama_watchdog_stalls_total")
    down = [t for t, s in seen if s == 503]
    if not down or seen[-1][1] != 200 or sum(stalls.values()) < 1:
        fail(f"supervision (b): /health/live never went 503 and back ({seen[-5:]}), stalls "
             f"{stalls}")
    print(f"supervision (b): a {stall_ms:.0f} ms delay at a decode dispatch (deadline "
          f"{SUP_STALL_S:.1f} s): /health/live 503 from {down[0]:.2f} s to {down[-1]:.2f} s "
          f"after the watch began, 200 again; dllama_watchdog_stalls_total +"
          f"{sum(stalls.values()):.0f}; the stream whole", flush=True)
    # (c) decode.nan fails exactly one request; the rest finish
    nan_armed = threading.Event()

    def arm_nan(k):
        if k >= 8 and not nan_armed.is_set():
            nan_armed.set()
            faults.install("decode.nan", "raise", times=1)

    nan = _concurrently(lambda i: _sse_ids(port, dict(bodies[i], max_tokens=64), f"sup-nan-{i}",
                                           on_frame=arm_nan if i == 0 else None),
                        [(i,) for i in range(8)])
    faults.clear()
    failed = [i for i, r in enumerate(nan) if r["error"] is not None]
    if len(failed) != 1:
        fail(f"supervision (c): {len(failed)} requests failed under decode.nan (want 1)")
    for i, r in enumerate(nan):
        if i not in failed:
            _whole(r, 64, f"supervision (c) stream {i}")
    if _get_json(port, "/health/live")[0] != 200 or sched.restart_count != 1:
        fail("supervision (c): the NaN drill touched the engine's health")
    print(f"supervision (c): decode.nan failed request {failed[0]} alone "
          f"({nan[failed[0]]['error']['message'][:60]!r}); 7 streams whole, live", flush=True)
    # (d) a restart that itself dies ends supervision: live false, 503s
    faults.install("engine.restart", "raise", times=1)
    faults.install("scheduler.loop", "raise", times=1)
    deadline = time.monotonic() + 30
    while sched.crashed is None and time.monotonic() < deadline:
        time.sleep(0.01)
    faults.clear()
    st_post, _ = _post(port, {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4})
    if sched.crashed is None or _get_json(port, "/health/live")[0] != 503 or st_post != 503:
        fail(f"supervision (d): crashed {sched.crashed!r}, POST {st_post}")
    print(f"supervision (d): engine.restart killed the restart: live=false, POST 503 "
          f"({sched.restart_count} restarts in all)", flush=True)
    httpd.shutdown()
    httpd.server_close()
    sched.shutdown()
    del httpd, api, sched, enc
    torch.cuda.empty_cache()
    # (e) a session round trip on the single engine: 32 tokens, save, a
    # fresh engine loads it, 32 more, bit-equal to 64 uninterrupted
    eng = loaded.engine
    ptoks = loaded.tokenizer.encode(bodies[0]["messages"][0]["content"], add_bos=True)
    greedy = Sampler(0.0, 0.9, 0)
    eng.reset(0)
    full = list(eng.generate(ptoks, 2 * SESSION_TOKENS, greedy))
    eng.reset(0)
    head = list(eng.generate(ptoks, SESSION_TOKENS, greedy))
    path = os.path.join(tmpdir, "session.npz")
    t0 = time.perf_counter()
    eng.save_session(path)
    save_ms = (time.perf_counter() - t0) * 1e3
    fresh = InferenceEngine(loaded.config, eng.params, cache_dtype=eng.cache.k.dtype,
                            max_seq_len=eng.seq_len, max_prefill_chunk=eng.max_prefill_chunk,
                            device=eng.device)
    ptrs = (fresh.cache.k.data_ptr(), fresh.cache.v.data_ptr())
    t0 = time.perf_counter()
    fresh.load_session(path)
    load_ms = (time.perf_counter() - t0) * 1e3
    tail = fresh.decode_greedy_n(np.array([head[-1]]), SESSION_TOKENS)[:, 0].tolist()
    if head + tail != full or (fresh.cache.k.data_ptr(), fresh.cache.v.data_ptr()) != ptrs:
        fail(f"supervision (e): the session round trip gave {head + tail} against {full}")
    eng.reset(0)
    print(f"supervision (e): {SESSION_TOKENS} + {SESSION_TOKENS} greedy tokens across "
          f"save_session / a fresh engine / load_session bit-equal to "
          f"{2 * SESSION_TOKENS} uninterrupted; save {save_ms:.0f} ms, load {load_ms:.0f} ms, "
          f"{os.path.getsize(path) / 1e6:.1f} MB", flush=True)
    os.remove(path)
    del fresh
    torch.cuda.empty_cache()
    # (f) --transfer-guard strict serves 8 streams; a synchronizing read put
    # into the guarded window raises
    httpd2, api2 = make_server(loaded, host="127.0.0.1", port=0, n_slots=8, warmup="auto",
                               transfer_guard="strict")
    threading.Thread(target=httpd2.serve_forever, daemon=True).start()
    port2 = httpd2.server_address[1]
    strict = _concurrently(lambda i: _sse_ids(port2, dict(bodies[i], max_tokens=64),
                                              f"sup-strict-{i}"), [(i,) for i in range(8)])
    for i, r in enumerate(strict):
        _whole(r, 64, f"supervision (f) strict stream {i}")
    sched2 = api2.scheduler
    if sched2.crashed is not None or sched2.restart_count:
        fail(f"supervision (f): the strict server crashed: {sched2.crashed!r}")
    if not graceful_drain(httpd2, api2, timeout_s=120):
        fail("supervision (f): the drain did not finish")
    httpd2.server_close()
    eng2 = sched2.engine
    outputs = eng2._outputs_to_host

    def syncing(*bufs):
        bufs[0].sum().item()  # a synchronizing read inside the guarded window
        return outputs(*bufs)

    eng2.add(0, ptoks[:16], temperature=0.0)
    eng2._outputs_to_host = syncing
    try:
        eng2.decode_dispatch(1)
        fail("supervision (f): a synchronizing read in the guarded window did not raise")
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        msg = str(e).splitlines()[0][:80]
    finally:
        eng2._outputs_to_host = outputs
    if torch.cuda.get_sync_debug_mode() != 0:
        fail("supervision (f): the guard left the sync debug mode set")
    print(f"supervision (f): --transfer-guard strict served 8 streams of 64 tokens "
          f"untripped; an .item() in the window raised ({msg!r}); the mode restored",
          flush=True)
    launches = counters()
    for k in ("q40_decode", "q40_prefill", "paged_attention", "flash_attention"):
        if launches[k] == 0:
            fail(f"supervision: kernel {k} was never launched")
    del httpd2, api2, sched2, eng2
    torch.cuda.empty_cache()
    return launches


def _post_replica(port: int, body: dict) -> tuple[int, dict, str]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/v1/chat/completions", json.dumps(body), _headers())
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, json.loads(data), resp.getheader("X-Replica-Id") or ""


def phase_router(loaded, mpath: str, tpath: str) -> None:
    """Two CLI `serve --slots 8 --warmup auto` replicas on the card and the
    CLI `router --failover-max 2` in front: the handshake, affinity, a
    greedy and a sampled stream through the router, the same two again
    with SIGKILL sent to their replica mid-stream, federation and the
    fleet view. The replicas' kernels run in their own processes."""
    import signal

    from dllama_tpu_torch.serve.api import ApiServer

    ports = []
    while len(ports) < 3:
        p = _free_port()
        if p not in ports:
            ports.append(p)
    t0 = time.perf_counter()
    reps = {}
    for p in ports[:2]:
        reps[f"127.0.0.1:{p}"] = _spawn(
            [sys.executable, "-u", "-m", "dllama_tpu_torch", "serve", "--model", mpath,
             "--tokenizer", tpath, "--slots", "8", "--warmup", "auto", "--port", str(p),
             "--max-seq-len", "4096", "--no-mesh"], "/v1/chat/completions")
    router = None
    try:
        for rid, (proc, lines, ready) in reps.items():
            if not ready.wait(400) or proc.poll() is not None:
                fail(f"router: replica {rid} did not come up: {lines[-20:]}")
        boot_s = time.perf_counter() - t0
        rport = ports[2]
        router = _spawn([sys.executable, "-u", "-m", "dllama_tpu_torch", "router",
                         "--replica", f"127.0.0.1:{ports[0]}", "--replica",
                         f"127.0.0.1:{ports[1]}", "--port", str(rport), "--failover-max", "2",
                         "--poll-s", "0.5"], "/v1/chat/completions")
        if not router[2].wait(120) or router[0].poll() is not None:
            fail(f"router: the router did not come up: {router[1][-20:]}")
        st, h = _get_json(rport, "/health")
        if not (st == 200 and h["mode"] == "router" and len(h["replicas"]) == 2
                and all(r["config_ok"] and r["ready"] for r in h["replicas"])
                and h["mesh"] == {"model": "dllama-tpu", "version": "0.1.0"}):
            fail(f"router: the handshake {st} {h}")
        # affinity: requests sharing a system prompt land on one replica
        system = {"role": "system", "content": "You are the router drill's narrator. " * 3}
        landed = set()
        for i in range(4):
            st, resp, rid = _post_replica(rport, {"messages": [
                system, {"role": "user", "content": f"Question {i}: name a colour."}],
                "max_tokens": 8, "temperature": 0.0})
            if st != 200:
                fail(f"router: affinity request {i} answered {st}")
            landed.add(rid)
        if len(landed) != 1:
            fail(f"router: the shared system prompt landed on {landed}")
        victim = landed.pop()
        survivor = next(r for r in reps if r != victim)
        enc = ApiServer(loaded)
        bodies = [{"messages": [system, {"role": "user", "content": batch_prompts(1)[0]}],
                   "max_tokens": ROUTER_TOKENS, "temperature": 0.0, "seed": 5},
                  {"messages": [system, {"role": "user", "content": batch_prompts(2)[1]}],
                   "max_tokens": ROUTER_TOKENS, "temperature": 0.8, "top_p": 0.9, "seed": 7}]
        base = _concurrently(lambda i: _sse_ids(rport, bodies[i]), [(0,), (1,)])
        for i, r in enumerate(base):
            _whole(r, ROUTER_TOKENS, f"router baseline stream {i}")
            if (r["timings"] or {}).get("replica") != victim:
                fail(f"router: baseline stream {i} was served by "
                     f"{(r['timings'] or {}).get('replica')}, not the pinned {victim}")
        before, _ = _scrape(rport)  # the federation holds both replicas' expositions
        killed = {}

        def kill(k):
            if k >= ROUTER_KILL_AT and not killed:
                killed["t"] = time.perf_counter()
                victim_proc = reps[victim][0]
                victim_proc.send_signal(signal.SIGKILL)
                victim_proc.wait()
                killed["exited"] = time.perf_counter()

        res = _concurrently(lambda i: _sse_ids(rport, bodies[i], f"router-kill-{i}",
                                               on_frame=kill if i == 0 else None),
                            [(0,), (1,)])
        if not killed:
            fail("router: the kill never fired")
        # the router's journal of the greedy stream on this host's monotonic
        # clock (its attempts' at_ms count from its trace epoch): when it saw
        # the death and when the survivor took the resume, from the kill
        st_pm, pm = _get_json(rport, "/router/requests/router-kill-0")
        _, rh = _get_json(rport, "/health")
        kill_mono = killed["t"] + time.monotonic() - time.perf_counter()
        legs = [(a["kind"], a["outcome"],
                 round((rh["clock"]["trace_epoch_s"] + a["at_ms"] / 1e3 - kill_mono) * 1e3, 1))
                for a in (pm.get("router") or {}).get("attempts", [])] if st_pm == 200 else pm
        for i, r in enumerate(res):
            _whole(r, ROUTER_TOKENS, f"router stream {i} across the failover")
            if r["retrying"] > 1:
                fail(f"router: stream {i} carried {r['retrying']} `: retrying` comments")
        g, g0 = res[0], base[0]
        if g["ids"] != g0["ids"]:
            near_tie(loaded, prompt_ids(enc, bodies[0]), g["ids"], g0["ids"],
                     "router greedy stream across the failover")
        # the failover's gap: the longest wait between two token frames from
        # the kill on (frames already on the wire arrive after it too)
        ft = g["frame_t"]
        k0 = max(1, sum(1 for t in ft if t <= killed["t"]))
        gaps = [(b - a) * 1e3 for a, b in zip(ft[k0 - 1:], ft[k0:])]
        gap_ms = max(gaps) if gaps else float("nan")
        med_ms = statistics.median((b - a) * 1e3 for a, b in zip(ft, ft[1:]))
        s, s0 = res[1]["ids"], base[1]["ids"]
        s_part = next((j for j, (x, y) in enumerate(zip(s, s0)) if x != y), None)
        after, _ = _scrape(rport)
        resumed = _family_delta(before, after, "dllama_router_failovers_total")
        if resumed.get('{outcome="resumed"}', 0.0) < 1:
            fail(f"router: dllama_router_failovers_total moved {resumed}")
        st, kv = _get_json(int(survivor.split(":")[1]), "/debug/kv")
        if st != 200 or not (kv.get("audit") or {}).get("ok"):
            fail(f"router: the survivor's /debug/kv {st} {kv.get('audit')}")
        fed = {lbl for (n, lbl) in after if n == "dllama_fleet_scrape_age_seconds"}
        if fed != {f'{{replica="{victim}"}}', f'{{replica="{survivor}"}}'}:
            fail(f"router: /router/metrics federates {fed}")
        st, fleet = _get_json(rport, "/router/fleet")
        live = {r["id"]: r.get("live") for r in fleet["replicas"]}
        if st != 200 or fleet["fleet"]["replicas"] != 2 or not live.get(survivor):
            fail(f"router: /router/fleet {st} {fleet.get('fleet')} {live}")
        print(f"router: 2 replicas up in {boot_s:.1f} s; handshake (dllama-tpu, 0.1.0); 4 "
              f"requests sharing a system prompt on {victim}; SIGKILL to it after "
              f"{ROUTER_KILL_AT} frames of the greedy stream: both streams whole on "
              f"{survivor} ({res[0]['retrying']} and {res[1]['retrying']} `: retrying`), the "
              f"greedy ids {'equal to' if g['ids'] == g0['ids'] else 'apart at a near tie from'} "
              f"the baseline; the gap across the failover {gap_ms:.1f} ms (median frame gap "
              f"{med_ms:.1f} ms; the resumed legs' queue wait / TTFT on the survivor "
              f"{[(r['timings'] or {}).get('queue_wait_ms') for r in res]} / "
              f"{[(r['timings'] or {}).get('ttft_ms') for r in res]} ms; the victim exited "
              f"{(killed['exited'] - killed['t']) * 1e3:.1f} ms after the SIGKILL; the "
              f"router's attempts, ms from the kill: {legs}); failovers "
              f"{resumed}; the sampled stream "
              f"{'equal' if s_part is None else f'apart from its baseline at token {s_part}'} "
              f"(printed, not compared); the survivor's pool clean; /router/metrics "
              f"federates both ({len(after)} samples), /router/fleet live {live}",
              flush=True)
    finally:
        if router is not None:
            _reap(router[0])
        for proc, _, _ in reps.values():
            _reap(proc)


# ------------------------------------------------------------ phases 19-21

#: tests/fixtures/golden_tiny.m (head size 16) and its pinned temperature-0
#: continuation, the JAX package's tests/test_golden.py constants
GOLDEN_M = os.path.join("tests", "fixtures", "golden_tiny.m")
GOLDEN_PROMPT = [801, 799, 777, 46]
GOLDEN_CONTINUATION = [573, 932, 583, 990, 121, 209, 314, 633, 274, 831,
                       499, 615, 643, 349, 143, 357]
#: moe phase: greedy tokens a scheme, and decode steps of a timed chunk
MOE_TOKENS = 16
#: Mixtral's depth in the moe phase: 8 of its 32 layers (widths not cut), so
#: that the default smoke, the tools phase after it included, ends inside
#: its deadline on a slow host
MOE_LAYERS = 8
MOE_CHUNK = 4
#: kernel-name fragments of the matmul kernels in the profiler (K1, K2)
MM_NAMES = K1_NAMES + CHUNK_MATMUL


def phase_golden(device) -> dict:
    """tests/fixtures/golden_tiny.m under --kernels auto on the card: its
    head size (16) has no attention kernel, so the engines keep the Q40
    kernels (K1) with the plain attention (route torch). 16 greedy tokens
    from GOLDEN_PROMPT through the single engine and through an 8-slot
    BatchEngine (dense layout: the paged kernel takes heads of 64 and 128),
    both captured, must equal GOLDEN_CONTINUATION or first differ at a near
    tie of the engine's replay. Returns the launches of the two runs."""
    import gc

    import torch

    from dllama_tpu_torch.engine.batch import BatchEngine
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.engine.sampling import Sampler

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), GOLDEN_M)
    loaded = load_model(path, None, mesh=None, device=device)
    eng = loaded.engine
    if (eng.backend, eng.attn_route) != ("cuda", "torch"):
        fail(f"golden: kernels={eng.backend} attention={eng.attn_route}; want cuda, torch")
    reset_counters()
    single = list(eng.generate(GOLDEN_PROMPT, len(GOLDEN_CONTINUATION), Sampler(0.0, 0.9, 0)))
    be = BatchEngine(loaded.config, eng.params, n_slots=8, cache_dtype=eng.cache.k.dtype,
                     max_seq_len=eng.seq_len, device=eng.device)
    if (be.backend, be.attn_route, be.kv_layout) != ("cuda", "torch", "dense"):
        fail(f"golden batch: kernels={be.backend} attention={be.attn_route} "
             f"layout={be.kv_layout}; want cuda, torch, dense")
    first = be.add(3, GOLDEN_PROMPT, temperature=0.0)
    batched = [int(first)] + [int(t) for t in be.decode(len(GOLDEN_CONTINUATION) - 1)[:, 3]]
    launches = counters()
    for label, ids in (("single engine", single), ("8-slot batch", batched)):
        msg = near_tie(loaded, GOLDEN_PROMPT, ids, GOLDEN_CONTINUATION, f"golden {label}")
        print(f"golden {label} (--kernels auto: cuda matmuls, torch attention): "
              f"{'equal to GOLDEN_CONTINUATION' if msg is None else msg}", flush=True)
    if launches["q40_decode"] == 0 or launches["flash_attention"] or launches["paged_attention"]:
        fail(f"golden: launches {launches}; want K1 and no attention kernel")
    print(f"golden: launches {launches}", flush=True)
    del be, loaded, eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_dequantize(loaded, device, mpath: str, tpath: str, prompt: str) -> dict:
    """The Q40 8B file loaded with --dequantize: every matmul weight a dense
    bf16 tensor, its forward (forward_logits) through torch.matmul within
    TOL_FWD of the Q40 kernels' forward on the same tokens, no Q40 kernel
    launched; then the CLI's `inference --dequantize`, greedy, whose text
    is printed beside the kernels' CLI run's. Returns the launches of both
    runs."""
    import gc

    import torch

    from dllama_tpu_torch.engine.loader import load_model

    eng = loaded.engine
    t0 = time.perf_counter()
    dq = load_model(mpath, tpath, max_seq_len=4096, mesh=None, dequantize=True,
                    device=device)
    print(f"dequantize: load_model {time.perf_counter() - t0:.1f} s", flush=True)
    leaves = [dq.engine.params["wcls"]] + [dq.engine.params["layers"][k]
                                           for k in ("wq", "wk", "wv", "wo", "w1", "w2", "w3")]
    if not all(isinstance(w, torch.Tensor) and w.dtype == torch.bfloat16 for w in leaves):
        fail("dequantize: the matmul weights did not load as dense bf16 tensors")
    reset_counters()
    runs = forward_logits(loaded, device, {"dequantized": (dq.engine.params, dq.engine.mm,
                                                           dq.engine.attn_fn)})
    launches = counters()
    runs.update(forward_logits(loaded, device, {"kernels": (eng.params, eng.mm,
                                                            eng.attn_fn)}))
    ref = runs["kernels"]
    rel = ((runs["dequantized"] - ref).abs().max() / ref.abs().max()).item()
    print(f"dequantize forward: prefill 256 + 8 decode + a 9-row verify against the Q40 "
          f"kernels, max|logit diff|/max|logit| = {rel:.3e} <= {TOL_FWD}; launches "
          f"{launches}", flush=True)
    if not rel <= TOL_FWD or any(launches[k] for k in Q40_KERNELS + Q80_KERNELS) or \
            not launches["flash_attention"]:
        fail(f"dequantize forward: {rel} of max|logit|, launches {launches} (want no Q40/Q80 "
             "kernel and K7)")
    del dq, runs
    gc.collect()
    torch.cuda.empty_cache()
    reset_counters()
    rc, text, stats = _cli(inference_argv(mpath, tpath, prompt) + ["--dequantize"])
    cli = counters()
    print(f"dequantize inference: rc {rc}; {' | '.join(stats)}; launches {cli}; text "
          f"{text[:120]!r}", flush=True)
    if rc != 0 or any(cli[k] for k in Q40_KERNELS + Q80_KERNELS) or not cli["flash_attention"]:
        fail(f"dequantize inference: rc {rc}, launches {cli} (want no Q40/Q80 kernel and K7)")
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches[k] + cli[k] for k in launches}


def mixtral_8x7b(n_layers: int):
    """Mixtral-8x7B's published geometry (mistralai/Mixtral-8x7B-v0.1,
    config.json): dim 4096, hidden 14336, 32 query and 8 KV heads, vocab
    32000, 8 experts with 2 active, rope_theta 1e6, RMSNorm eps 1e-5, a
    32768-row context; `n_layers` of its 32 layers."""
    from dllama_tpu_torch.models.config import LlamaConfig
    from dllama_tpu_torch.ops.quant import FloatType

    return LlamaConfig(dim=4096, hidden_dim=14336, n_layers=n_layers, n_heads=32, n_kv_heads=8,
                       vocab_size=32000, seq_len=32768, n_experts=8, n_active_experts=2,
                       rope_theta=1e6, norm_epsilon=1e-5, weight_type=FloatType.Q40)


def _file_bytes(cfg) -> int:
    from dllama_tpu_torch.models.formats import tensor_plan

    import numpy as np

    return sum(ft.nbytes(int(np.prod(shape))) for _, shape, ft in tensor_plan(cfg))


@contextlib.contextmanager
def moe_capacity(capacity_factor: float):
    """Every MoE layer's dispatch at `capacity_factor` while the block
    runs (models.llama looks moe_ffn up in its module at each layer)."""
    import functools

    from dllama_tpu_torch.models import llama

    orig = llama.moe_ffn
    llama.moe_ffn = functools.partial(orig, capacity_factor=capacity_factor)
    try:
        yield
    finally:
        llama.moe_ffn = orig


def moe_split(loaded, t: int, pos: int = 0) -> dict:
    """One uncaptured forward of `t` tokens at `pos` on the single engine's
    weights and attention (a fresh dense cache) under torch.profiler, its
    device time split by where each kernel sits in the forward: between two
    attention launches run wo, the layer's MoE FFN with its 3 * E expert
    products, then the next layer's wq, wk and wv (before the first: layer
    0's; after the last: wo, the FFN and wcls). -> the expert products, the
    attention projections and wcls, attention (K7), the MoE FFN's plain
    operations (the router's product, top-k and softmax, SwiGLU, the
    combine, the residual and the next norm) and the attention block's
    (norm, RoPE, the cache writes), with the launches the profiler saw."""
    import torch
    from torch.autograd import DeviceType

    from dllama_tpu_torch.models.llama import KVCache, forward

    eng, cfg = loaded.engine, loaded.config
    cache = KVCache.create(cfg, 1, eng.cache.k.dtype, eng.seq_len, eng.device)
    gen = torch.Generator(device=eng.device).manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (1, t), generator=gen, device=eng.device)

    def run():
        forward(cfg, eng.params, toks, pos, cache, eng.rope_cache, eng.attn_fn, eng.mm,
                last_only=True, moe_impl=eng.moe_impl)
        torch.cuda.synchronize()

    with torch.no_grad():
        run()
        with profiled() as prof:  # the forward's kernels are those after the last spin
            run()
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    spins = [i for i, e in enumerate(kernels) if "spin" in e.name]
    kernels = kernels[spins[-1] + 1:] if spins else kernels
    del cache
    return split_moe_forward([(e.name, e.time_range.elapsed_us() / 1e3) for e in kernels])


def split_moe_forward(kernels: list) -> dict:
    """moe_split's attribution of one MoE forward's (kernel name, ms) in
    launch order."""
    segments: list[list] = [[]]  # kernels between attention launches
    for name, ms in kernels:
        kind = ("mm" if any(f in name for f in MM_NAMES) else
                "attn" if any(f in name for f in CHUNK_ATTENTION) else "plain")
        if kind == "attn" and segments[-1] and segments[-1][-1][0] != "attn":
            segments.append([])
        segments[-1].append((kind, ms))
    split = dict.fromkeys(("expert_mm_ms", "proj_mm_ms", "attention_ms", "moe_plain_ms",
                           "attn_plain_ms"), 0.0)
    counts = {"expert_mm": 0, "proj_mm": 0, "ops": len(kernels)}
    for si, seg in enumerate(segments):
        mms = [i for i, (kind, _) in enumerate(seg) if kind == "mm"]
        last = si == len(segments) - 1
        # projections: wo first, then the next layer's wq, wk, wv (wcls last)
        proj = set(mms[:1] + mms[-1:] if last else mms[:1] + mms[-3:]) if si else set(mms)
        moe = (mms[0], mms[-1] if last else mms[-3]) if si and len(mms) > 4 else None
        for i, (kind, ms) in enumerate(seg):
            if kind == "mm":
                key = "proj_mm" if i in proj else "expert_mm"
                counts[key] += 1
            elif kind == "attn":
                key = "attention"
            else:
                key = "moe_plain" if moe and moe[0] < i < moe[1] else "attn_plain"
            split[f"{key}_ms"] += ms
    return dict(split, busy_ms=sum(split.values()), **counts)


def phase_moe(device, prompt: str, mesh: set = frozenset()) -> dict:
    """Mixtral-8x7B at its published width (mixtral_8x7b), random Q40
    weights from seed 0 written by write_model, context cut to 4096, depth
    cut only where the temp filesystem cannot hold the file: (a) the
    forward through the kernels against the plain versions (check_forward);
    (d) HTTP serve on the single-engine tier (phase_serve); (c) 16 greedy
    tokens under --moe dense, sort and dispatch at a capacity factor of
    E/k (C = N: nothing dropped) on one prompt, equal or first apart at a
    near tie; (e) the 8-slot server at its defaults with --warmup auto
    (phase_batch: paged at page 128, hybrid admission, the radix tree), no
    unexpected capture; (b) every forward of (d) and (e) launches at least
    mm_per_forward K1/K2 (the attention projections, 3 * E * L expert
    products, wcls) and K7 (single tier) or K9 (batched); one replayed
    decode chunk exactly that many and no other; (f) device times: a
    captured decode step at 1 and 8 slots (wall, stream, busy), a captured
    256-token prefill chunk, and both split by kernel (moe_split). The
    file is deleted at the end. ``mesh``: the mesh phases that run; after
    the engine is freed, the same file against its saved unsharded logits
    at tp=2 (the mesh phase) and at ep=2 and ep=2 x tp=2 (mesh_pp_ep), each
    mesh_moe. Returns the launches of (d) and (e)."""
    import gc
    import shutil

    import torch

    from dllama_tpu_torch.engine.batch import BatchEngine
    from dllama_tpu_torch.engine.engine import InferenceEngine
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.engine.sampling import Sampler
    from dllama_tpu_torch.ops.quant import QTensor

    total: dict[str, int] = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    with tempfile.TemporaryDirectory(prefix="dllama_smoke_moe_") as tmp:
        free = shutil.disk_usage(tmp).free
        print(f"moe: {free / 1e9:.1f} GB free in {tmp}, "
              f"{shutil.disk_usage(os.path.dirname(os.path.abspath(__file__))).free / 1e9:.1f} "
              "GB beside the checkout", flush=True)
        one, two = _file_bytes(mixtral_8x7b(1)), _file_bytes(mixtral_8x7b(2))
        per_layer, fixed = two - one, 2 * one - two
        depth = MOE_LAYERS if fixed + MOE_LAYERS * per_layer + 2e9 <= free else int(
            (free - 2e9 - fixed) // per_layer)
        if depth < 1:
            fail(f"moe: {free / 1e9:.1f} GB free in {tmp} holds no Mixtral layer")
        cfg = mixtral_8x7b(depth)
        print(f"phase moe: Mixtral-8x7B, {depth} of its 32 layers (temp filesystem "
              f"{free / 1e9:.1f} GB free for a {_file_bytes(cfg) / 1e9:.2f} GB file): "
              f"{cfg.describe()}, context 4096", flush=True)
        mpath, tpath = os.path.join(tmp, "mixtral_8x7b_q40.m"), os.path.join(tmp, "tok.t")
        t0 = time.perf_counter()
        write_model(mpath, cfg, device)
        write_tokenizer(tpath, cfg.vocab_size)
        print(f"moe: wrote {os.path.getsize(mpath) / 1e9:.2f} GB in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        loaded = load_model(mpath, tpath, max_seq_len=4096, mesh=None, device=device)
        eng, tok = loaded.engine, loaded.tokenizer
        w1 = eng.params["layers"].get("moe_w1")
        print(f"moe: load_model {time.perf_counter() - t0:.1f} s; kernels={eng.backend} "
              f"attention={eng.attn_route} moe={eng.moe_impl}; {torch.cuda.memory_allocated() / 1e9:.2f} GB "
              f"allocated", flush=True)
        if not isinstance(w1, QTensor) or tuple(w1.packed.shape) != (depth, 8, 2048, 14336):
            fail("moe: the experts did not load as a [L, E, in/2, out] Q40 stack")
        per_fwd = mm_per_forward(cfg)
        from dllama_tpu_torch.utils.profiling import params_nbytes

        lay = eng.params["layers"]
        experts = params_nbytes({k: lay[k] for k in ("moe_w1", "moe_w2", "moe_w3")})
        rest = params_nbytes({"wcls": eng.params["wcls"], **{k: lay[k] for k in
                                                             ("wq", "wk", "wv", "wo")}})
        routed = experts * cfg.n_active_experts / cfg.n_experts
        print(f"moe: a decode step's weight bytes: every expert {experts / 1e9:.3f} GB "
              f"({experts / HBM_BYTES_S * 1e3:.3f} ms at {HBM_BYTES_S / 1e12:.2f} TB/s), one "
              f"token's routed experts {routed / 1e9:.3f} GB ({routed / HBM_BYTES_S * 1e3:.3f} "
              f"ms), projections and wcls {rest / 1e9:.3f} GB ({rest / HBM_BYTES_S * 1e3:.3f} "
              "ms)", flush=True)
        mark = [time.perf_counter()]

        def took(step):
            now = time.perf_counter()
            print(f"moe: {step} took {now - mark[0]:.1f} s", flush=True)
            mark[0] = now

        check_forward(loaded, device, "moe forward")  # (a)
        took("the forward check")
        launches = serve_checked(loaded, prompt, "moe serve", Q40_KERNELS, per_fwd,  # (d), (b)
                                 "flash_attention")
        add(launches)
        took("serve")

        # (c) the three schemes' greedy ids on one prompt
        ptoks = tok.encode(prompt, add_bos=True)
        ids = {}
        for impl in ("dense", "sort", "dispatch"):
            e = InferenceEngine(cfg, eng.params, cache_dtype=eng.cache.k.dtype,
                                max_seq_len=eng.seq_len, device=eng.device, moe_impl=impl)
            with moe_capacity(cfg.n_experts / cfg.n_active_experts):
                ids[impl] = list(e.generate(ptoks, MOE_TOKENS, Sampler(0.0, 0.9, 0)))
            del e
            gc.collect()
            torch.cuda.empty_cache()
        for impl in ("sort", "dispatch"):
            msg = near_tie(loaded, ptoks, ids[impl], ids["dense"], f"moe {impl} vs dense")
            print(f"moe --moe {impl}: {MOE_TOKENS} greedy ids "
                  f"{'equal to dense' if msg is None else msg}", flush=True)
        took("the schemes")

        # (e) the 8-slot server at its defaults, warmed up
        batch = phase_batch(loaded, warmup="auto")
        launches = batch.pop("launches")
        print(f"moe batch: {batch}; launches {launches}", flush=True)
        if batch["unexpected_captures"]:
            fail(f"moe batch: {batch['unexpected_captures']} unexpected captures")
        add(launches)
        took("the 8-slot server")

        # (f) device times, captured: a decode step at 1 and 8 slots, a chunk
        n = MOE_CHUNK
        first = ids["dense"][0]

        def run1():
            eng.reset(len(ptoks))
            return eng.decode_greedy_n([[first]], n)

        times = {"1 slot": chunk_timing(run1, n)}
        replay_launches(run1, {"q40_decode": per_fwd * n, "flash_attention": depth * n},
                        "moe single-engine chunk")
        be = BatchEngine(cfg, eng.params, n_slots=8, cache_dtype=eng.cache.k.dtype,
                         max_seq_len=eng.seq_len, kv_layout="paged", page_size=128,
                         device=eng.device, moe_impl=eng.moe_impl)
        for slot, p in enumerate(batch_prompts(8)):
            be.add(slot, tok.encode(p), temperature=0.0)

        def run8():
            return be.decode(n)

        times["8 slots"] = chunk_timing(run8, n)
        replay_launches(run8, {"q40_decode": per_fwd * n, "paged_attention": depth * n},
                        "moe 8-slot chunk")
        del be
        gc.collect()
        torch.cuda.empty_cache()
        for label, tm in times.items():
            print(f"moe decode step, {label}, captured: wall {tm['wall_ms']:.3f} ms, stream "
                  f"{tm['stream_ms']:.3f} ms, busy {tm['device_ms']:.3f} ms "
                  f"({tm['device_ops']:.1f} device ops a step, busy share {tm['busy']:.3f})",
                  flush=True)
        toks = torch.randint(0, cfg.vocab_size, (1, 256),
                             generator=torch.Generator().manual_seed(6)).numpy()

        def prefill():
            eng.reset(0)
            return eng.step(toks)

        pre = prefill_timing(prefill)
        print(f"moe prefill chunk, 256 tokens at pos 0, captured: wall {pre['wall_ms']:.3f} ms, "
              f"stream {pre['stream_ms']:.3f} ms, busy {pre['busy_ms']:.3f} ms in {pre['ops']} "
              f"device ops", flush=True)
        for label, t in (("decode step (1 token at pos 512)", 1), ("prefill chunk (256)", 256)):
            sp = moe_split(loaded, t, 512 if t == 1 else 0)
            print(f"moe split, {label}, uncaptured, busy {sp['busy_ms']:.3f} ms in {sp['ops']} "
                  f"device ops: expert products {sp['expert_mm_ms']:.3f} ms in "
                  f"{sp['expert_mm']} launches, attention projections + wcls "
                  f"{sp['proj_mm_ms']:.3f} ms in {sp['proj_mm']}, attention "
                  f"{sp['attention_ms']:.3f} ms, the MoE FFN's plain ops (routing, SwiGLU, "
                  f"combine) {sp['moe_plain_ms']:.3f} ms, the attention block's "
                  f"{sp['attn_plain_ms']:.3f} ms", flush=True)
            want = (3 * cfg.n_experts * depth, 4 * depth + 1)
            if (sp["expert_mm"], sp["proj_mm"]) != want:
                # the counters hold every launch (replay_launches above); a
                # profiler that drops events only blurs the split's edges
                print(f"moe split: the profiler saw {sp['expert_mm']} expert products and "
                      f"{sp['proj_mm']} other matmul kernels of the {want[0]} and {want[1]} "
                      "launched", flush=True)
            if not sp["expert_mm"] > 0.9 * want[0]:
                fail(f"moe split: {sp['expert_mm']} expert-product kernels seen, want "
                     f"{want[0]}")
        took("the timings")
        eng.reset(0)
        specs = (["tp=2"] if "mesh" in mesh else []) + \
            (["ep=2", "ep=2,tp=2"] if "mesh_pp_ep" in mesh else [])
        if specs:  # the unsharded logits of a prefill and 8 greedy steps, saved
            ref = [eng.prefill(ptoks)[0].float().cpu()]
            for _ in range(MESH_MOE_STEPS):
                ref.append(eng.decode_step([[int(ref[-1].argmax())]])[0].float().cpu())
            eng.reset(0)
            slots = moe_slot_reference(eng, tok) if "ep=2" in specs else None
            took("the mesh runs' reference")
        del loaded, eng, tok, w1
        gc.collect()
        torch.cuda.empty_cache()
        for spec in specs:
            mesh_moe(mpath, tpath, device, ptoks, ref, spec, slots)
            took(f"Mixtral at {spec}")
    return total


#: the ep=2 BatchEngine's slots and the greedy ids a slot (mesh_moe)
MOE_EP_SLOTS, MOE_EP_TOKENS = 4, 16


def moe_slot_reference(eng, tok) -> dict:
    """The unsharded dense BatchEngine's MOE_EP_TOKENS greedy ids on each of
    MOE_EP_SLOTS slots, and the single engine's top-2 margin before each
    id along that stream (for _ids_check)."""
    import gc

    import torch

    from dllama_tpu_torch.engine.batch import BatchEngine

    prompts = [tok.encode(p) for p in batch_prompts(MOE_EP_SLOTS)]
    be = BatchEngine(eng.cfg, eng.params, n_slots=MOE_EP_SLOTS, cache_dtype=eng.cache.k.dtype,
                     max_seq_len=eng.seq_len, kv_layout="dense", device=eng.device,
                     moe_impl=eng.moe_impl)
    first = [be.add(s, p, temperature=0.0) for s, p in enumerate(prompts)]
    toks = be.decode(MOE_EP_TOKENS - 1)
    streams = [[f] + [int(t) for t in toks[:, s]] for s, f in enumerate(first)]
    del be
    gc.collect()
    torch.cuda.empty_cache()
    margins = []
    for p, ids in zip(prompts, streams):
        eng.reset(0)
        logits = [eng.prefill(p)[0]]
        logits += [eng.decode_step([[t]])[0] for t in ids[:-1]]
        margins.append(_margins(logits))
    eng.reset(0)
    return {"prompts": prompts, "streams": streams, "margins": margins}


#: greedy decode steps of Mixtral on a mesh (after its prefill)
MESH_MOE_STEPS = 8


def mesh_moe(mpath: str, tpath: str, device, ptoks: list[int], ref: list, spec: str,
             slots: dict | None = None) -> None:
    """Mixtral-8x7B (`mpath`, the moe phase's file) on the mesh
    `spec` (tp=2, ep=2 or ep=2 x tp=2; the mesh phases' mode: every rank on
    one card over gloo, or one a card over NCCL where there are enough): a
    prefill and MESH_MOE_STEPS decode steps fed
    the unsharded engine's greedy ids, each step's logits within TOL_FWD of
    the unsharded logits `ref`, and the argmax equal or at a near tie of
    `ref`; each rank's expert products of one decode step 3 * E * L / ep
    (dense); on ep=2, `slots` (moe_slot_reference): a dense BatchEngine of
    MOE_EP_SLOTS slots whose greedy ids a slot equal the unsharded
    engine's or first leave them at a near tie. Prints each rank's
    parameter bytes and lazy load, the load seconds, a decode step's wall
    time and its exchange beside collective_bytes_per_token."""
    import gc

    import torch

    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.parallel.mesh import MeshConfig
    from dllama_tpu_torch.utils.profiling import collective_bytes_per_token

    config = MeshConfig.parse(spec)
    n = config.n_devices
    one_card = torch.cuda.device_count() < n
    t0 = time.perf_counter()
    m = load_model(mpath, tpath, max_seq_len=4096, mesh=spec, device=device,
                   devices=[device] * n if one_card else None)
    eng = m.engine
    try:
        cfg = eng.cfg
        print(f"moe mesh: Mixtral at {spec} ({m.world.mesh.backend}"
              f"{', staged' if m.world.mesh.staged else ''}) loaded in "
              f"{time.perf_counter() - t0:.1f} s; local FFN {cfg.hidden_dim}, heads "
              f"{cfg.n_heads}/{cfg.n_kv_heads}, experts {cfg.n_experts // cfg.ep} from "
              f"{cfg.expert_offset}", flush=True)
        for r in m.world.call_all("rank_report"):
            print(f"moe mesh {spec} rank {r['rank']}: params {r['param_bytes'] / 1e9:.3f} GB, "
                  f"lazy Q40 decode {r['lazy_decode_bytes'] / 1e9:.3f} GB in "
                  f"{r['lazy_decode_s']:.1f} s, build {r['build_s']:.1f} s", flush=True)
        eng.reset(0)
        got = [eng.prefill(ptoks)[0].float().cpu()]
        for i in range(MESH_MOE_STEPS):
            got.append(eng.decode_step([[int(ref[i].argmax())]])[0].float().cpu())
        reset_counters()
        m.world.call_all("rank_launches", True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.decode_step([[int(ref[-1].argmax())]])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        per_rank = [r.get("q40_decode", 0) - (4 * cfg.n_layers + 1)
                    for r in m.world.call_all("rank_launches", True)]
        rep = eng.measured_collective_report()
        for i, (a, b) in enumerate(zip(got, ref)):
            err = _rel(a, b)
            top2 = torch.topk(b, 2).values
            gap, scale = (top2[0] - top2[1]).item(), b.abs().max().item()
            same = int(a.argmax()) == int(b.argmax())
            print(f"moe mesh {spec}: {'prefill' if i == 0 else f'decode {i}'}: max|diff|/max|"
                  f"logit| {err:.3e} <= TOL_FWD {TOL_FWD}; argmax "
                  f"{'equal' if same else 'apart'} (top-2 margin {gap:.3e})", flush=True)
            if not err <= TOL_FWD:
                fail(f"moe mesh: the {spec} logits are off the unsharded kernels'")
            if not same and not gap < TOL_FWD * scale:
                fail(f"moe mesh: the {spec} argmax differs where the margin is no near tie")
        want = 3 * cfg.n_experts * cfg.n_layers // cfg.ep
        print(f"moe mesh {spec}: a decode step {step_ms:.3f} ms wall; expert products by rank "
              f"{per_rank} (want {want}: 3 x {cfg.n_experts // cfg.ep} experts x "
              f"{cfg.n_layers} layers); its exchange on rank 0 {rep['per_op']} "
              f"({rep['total_bytes']} B), collective_bytes_per_token(tp={config.tp}) "
              f"{collective_bytes_per_token(m.config, tp=config.tp)['bytes_per_token_per_chip']:.0f}"
              " B (no ep term)", flush=True)
        if any(x != want for x in per_rank):
            fail(f"moe mesh: a rank's expert products at {spec} are not its experts'")
        if config.ep > 1 and rep["per_op"].get("ep:all-reduce") != cfg.n_layers * cfg.dim * 4:
            fail(f"moe mesh: the ep sums at {spec} are not a layer's f32 row each")
        if slots is not None and spec == "ep=2":
            be = m.world.make("batch", n_slots=MOE_EP_SLOTS, max_seq_len=4096,
                              kv_layout="dense")
            first = [be.add(s, p, temperature=0.0) for s, p in enumerate(slots["prompts"])]
            toks = be.decode(MOE_EP_TOKENS - 1)
            del be
            msgs = [_ids_check([f] + [int(t) for t in toks[:, s]], slots["streams"][s],
                               slots["margins"][s], f"moe mesh {spec} slot {s}")
                    for s, f in enumerate(first)]
            print(f"moe mesh {spec}: {MOE_EP_SLOTS} dense slots, {MOE_EP_TOKENS} greedy ids "
                  f"each, against the unsharded engine's: {msgs}", flush=True)
        if len(set(m.world.call_all("rank_digest"))) != 1:
            fail(f"moe mesh: the {spec} ranks' token results differ")
    finally:
        m.world.close()
        del m, eng
        gc.collect()
        torch.cuda.empty_cache()


# ------------------------------------------------------------ mesh (tp=2)

#: tokens of the mesh phase's greedy continuations (single engine and slots)
MESH_TOKENS = 32


def _cli_rc_err(argv: list[str]) -> tuple[int, str]:
    """The CLI in this process -> (exit code, its stderr)."""
    from dllama_tpu_torch.cli.main import main as cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli(argv)
    return rc, err.getvalue()


def _rel(a, b) -> float:
    """max |a - b| over max |b| (f32)."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def mesh_step_logits(eng, ptoks: list[int], n_decode: int = 2) -> list:
    """[prefill logits, n_decode decode logits] of `ptoks`, the argmax fed."""
    eng.reset(0)
    out = [eng.prefill(ptoks)[0].float()]
    for _ in range(n_decode):
        out.append(eng.decode_step([[int(out[-1].argmax())]])[0].float())
    eng.reset(0)
    return out


#: the depth of the mesh phases' model (mesh_model): the 8B's widths cut to 8
#: of its 32 layers, so the default smoke keeps
#: its margin to the deadline (the mesh runs are eager harnesses: depth costs
#: time and shows nothing the full-depth one-device phases do not)
MESH_LAYERS = 8


def mesh_model(tmp: str, tpath: str, device):
    """The model of the mesh phases (mesh, mesh_dp_sp, mesh_pp_ep):
    Llama-3.1-8B's widths cut to MESH_LAYERS layers (write_model's seed-0
    recipe), written beside the smoke's files, and its unsharded engine,
    the reference. -> (loaded, path); the caller removes the file."""
    from dllama_tpu_torch.engine.loader import load_model

    mpath = os.path.join(tmp, "llama31_8b_mesh.m")
    cfg = llama31_8b(MESH_LAYERS)
    write_model(mpath, cfg, device)
    loaded = load_model(mpath, tpath, max_seq_len=4096, mesh=None, device=device)
    print(f"mesh phases: {cfg.describe()} (the 8B widths, {MESH_LAYERS} of 32 layers)",
          flush=True)
    return loaded, mpath


def phase_mesh(loaded, mpath: str, tpath: str, device, prompt: str) -> dict:
    """Tensor parallelism at tp=2 on Llama-3.1-8B Q40 (mesh_model's).
    With one card both ranks run on it over gloo, the exchange staged
    through pinned host memory and the programs eager (NCCL refuses two
    ranks on one card); with two or more, one rank a card over NCCL, the
    programs captured, and then the CLI's `serve --mesh tp=2 --slots 8`
    answers 8 streams. Checks: the CLI's --mesh tp=2 on one card exits 2
    with the device-count message; each rank's parameter bytes are half
    the matmul weights plus the replicated embedding and norms (2%); the
    prefill and two decode logits within TOL_FWD of the unsharded
    kernels'; 32 greedy ids equal to the unsharded engine's or first apart
    at a near tie; the same for 8 slots of a dense BatchEngine; every
    rank's K1/K2/K7 launches for a decode step and a 256-token chunk equal
    the unsharded engine's; one decode step's measured exchange equals the
    bytes of its shapes (printed beside collective_bytes_per_token's wire
    model); every rank's token results digest equal; then mesh_power, the
    checks' power on a model whose logits move with the input. Prints the decode
    step's wall time and each rank's lazy load (bytes decoded, seconds).
    With one card, then the NCCL path at one rank (mesh_nccl_one). Returns
    rank 0's launches of the driven path (single engine and 8 slots)."""
    import gc

    import numpy as np
    import torch

    from dllama_tpu_torch.engine.batch import BatchEngine
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.engine.sampling import Sampler
    from dllama_tpu_torch.utils.profiling import collective_bytes_per_token, params_nbytes

    cfg, eng, tok = loaded.config, loaded.engine, loaded.tokenizer
    n_cards = torch.cuda.device_count()
    one_card = n_cards < 2
    mode = ("gloo, both ranks on cuda:0, the exchange staged through pinned host memory, "
            "programs eager" if one_card else "NCCL, one rank a card, programs captured")
    print(f"phase mesh: torch.cuda.device_count() = {n_cards}; tp=2 over {mode}", flush=True)
    if one_card:
        rc, err = _cli_rc_err(["inference", "--model", mpath, "--tokenizer", tpath,
                               "--prompt", "x", "--mesh", "tp=2"])
        msg = next((ln for ln in err.splitlines() if "--mesh" in ln), "")
        print(f"mesh: the CLI's --mesh tp=2 on one card: rc {rc}: {msg}", flush=True)
        if rc != 2 or "the mesh needs 2 devices, have 1" not in msg:
            fail("mesh: the CLI did not refuse a mesh larger than the cards")
    t0 = time.perf_counter()
    m = load_model(mpath, tpath, max_seq_len=4096, mesh="tp=2", device=device,
                   devices=[device, device] if one_card else None)
    load_s = time.perf_counter() - t0
    world, meng = m.world, m.engine
    try:
        print(f"mesh: load_model {load_s:.1f} s; backend {world.mesh.backend}, staged "
              f"{world.mesh.staged}; programs {'captured' if meng.programs.capture else 'eager'}"
              f" on both tiers; rank 0 kernels={meng.backend} attention={meng.attn_route}; "
              f"local heads {meng.cfg.n_heads}/{meng.cfg.n_kv_heads}, FFN {meng.cfg.hidden_dim}",
              flush=True)
        if meng.backend != "cuda" or meng.attn_route != "flash":
            fail("mesh: rank 0 does not run the CUDA kernels")
        full = params_nbytes(eng.params)
        repl = params_nbytes({k: eng.params[k] for k in ("embedding", "final_norm")}) + \
            params_nbytes({k: eng.params["layers"][k] for k in ("rms_att", "rms_ffn")})
        want = repl + (full - repl) / 2
        for r in world.call_all("rank_report"):
            print(f"mesh rank {r['rank']} ({r['device']}): params {r['param_bytes'] / 1e9:.3f} "
                  f"GB (want {want / 1e9:.3f}: half of {(full - repl) / 1e9:.3f} GB of matmul "
                  f"weights + {repl / 1e9:.3f} GB replicated), allocated "
                  f"{r['allocated_bytes'] / 1e9:.3f} GB; lazy Q40 decode "
                  f"{r['lazy_decode_bytes'] / 1e9:.3f} GB in {r['lazy_decode_s']:.1f} s; build "
                  f"{r['build_s']:.1f} s", flush=True)
            if abs(r["param_bytes"] - want) > 0.02 * want:
                fail(f"mesh: rank {r['rank']} holds {r['param_bytes']} parameter bytes, "
                     f"want about {want:.0f}")
        ptoks = tok.encode(prompt, add_bos=True)
        prompts = [tok.encode(p) for p in batch_prompts(8)]
        kw = dict(n_slots=8, cache_dtype=torch.bfloat16, max_seq_len=4096, kv_layout="dense")

        def drive(e, batch_engine):
            """(a) the logits of a prefill and two decode steps, (b) greedy ids
            of the single engine, (c) 8 slots of a dense BatchEngine."""
            logits = mesh_step_logits(e, ptoks)
            t0 = time.perf_counter()
            ids = list(e.generate(ptoks, MESH_TOKENS, Sampler(0.0, 0.9, 0)))
            gen_s = time.perf_counter() - t0
            e.reset(0)
            be = batch_engine()
            first = [be.add(s, p, temperature=0.0) for s, p in enumerate(prompts)]
            toks = be.decode(MESH_TOKENS - 1)
            streams = [[f] + [int(t) for t in toks[:, s]] for s, f in enumerate(first)]
            del be
            gc.collect()
            torch.cuda.empty_cache()
            return logits, ids, gen_s, streams

        # the mesh's path first, counted alone: this process also runs the
        # unsharded reference afterwards
        reset_counters()
        world.call_all("rank_launches", True)
        logits, ids, gen_s, streams = drive(meng, lambda: world.make("batch", **kw))
        launches = counters()
        ranks = world.call_all("rank_launches", True)
        print(f"mesh: launches of the driven path, rank 0 {launches}; by rank "
              f"{[{k: r.get(k, 0) for k in SERVE_KERNELS} for r in ranks]}", flush=True)
        if any(r.get(k, 0) == 0 for r in ranks for k in SERVE_KERNELS):
            fail("mesh: a rank never launched one of K1/K2/K7 on the driven path")
        ref_logits, ref, _, ref_streams = drive(
            eng, lambda: BatchEngine(cfg, eng.params, device=eng.device, **kw))
        for i, (a, b) in enumerate(zip(logits, ref_logits)):
            err = _rel(a, b)
            print(f"mesh: {'prefill' if i == 0 else f'decode {i}'} logits, tp=2 vs one "
                  f"device: max|diff|/max|logit| {err:.3e} <= TOL_FWD {TOL_FWD}", flush=True)
            if not err <= TOL_FWD:
                fail("mesh: the tp=2 logits are off the unsharded kernels'")
        print(f"mesh: the unsharded logits move {_rel(ref_logits[1], ref_logits[0]):.3e} of "
              "max|logit| from the prefill to decode 1 (see mesh_power)", flush=True)
        msg = near_tie(loaded, ptoks, ids, ref, "mesh single engine")
        print(f"mesh: {MESH_TOKENS} greedy ids {'equal to one device' if msg is None else msg}"
              f" ({gen_s:.2f} s with the prefill)", flush=True)
        apart = 0
        for s, (a, b) in enumerate(zip(streams, ref_streams)):
            if near_tie(loaded, prompts[s], a, b, f"mesh batch slot {s}") is not None:
                apart += 1
        print(f"mesh: 8 dense slots, {MESH_TOKENS} greedy ids each: {8 - apart} equal to one "
              f"device, {apart} first apart at a near tie", flush=True)
        # (d) a decode step and a 256-token chunk: each rank's launches
        chunk = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 256))

        def counted(e, fn):
            fn(e)  # once first: a capture's warm-up launches are not a step's
            reset_counters()
            world.call_all("rank_launches", True)
            fn(e)
            return counters()

        for label, fn in (("decode step", lambda e: (e.reset(len(ptoks)),
                                                     e.decode_step([[ids[0]]]))),
                          ("256-token chunk", lambda e: (e.reset(0), e.step(chunk)))):
            ref_n = counted(eng, fn)
            counted(meng, fn)
            per_rank = world.call_all("rank_launches", True)
            want_n = {k: ref_n.get(k, 0) for k in SERVE_KERNELS}
            got = [{k: r.get(k, 0) for k in SERVE_KERNELS} for r in per_rank]
            print(f"mesh: {label}: K1/K2/K7 launches by rank {got}, one device {want_n}",
                  flush=True)
            if any(g != want_n for g in got):
                fail(f"mesh: a rank's launches for a {label} differ from one device's")
        eng.reset(0)
        # (e) one decode step's exchange
        rep = meng.measured_collective_report()
        shapes = cfg.n_layers * 2 * cfg.dim * 2 + cfg.vocab_size * 4
        wire = collective_bytes_per_token(cfg, tp=2)["bytes_per_token_per_chip"]
        print(f"mesh: one decode step's exchange, measured {rep['total_bytes']} B "
              f"({rep['per_op']}); its shapes {shapes} B (2 bf16 all-reduces of dim a layer, "
              f"the f32 logits gathered); collective_bytes_per_token's wire model "
              f"{wire:.0f} B sent+received a chip", flush=True)
        if rep["total_bytes"] != shapes:
            fail("mesh: the measured exchange is not the bytes of its shapes")
        # (f) a decode step's wall time
        meng.reset(len(ptoks))
        meng.decode_greedy_n([[ids[0]]], 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meng.reset(len(ptoks))
        meng.decode_greedy_n([[ids[0]]], 16)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 16 * 1e3
        print(f"mesh: decode step wall {step_ms:.3f} ms (tp=2, {mode})", flush=True)
        digests = world.call_all("rank_digest")
        if len(set(digests)) != 1:
            fail(f"mesh: the ranks' token results differ: {digests}")
        print(f"mesh: every rank's token results equal ({digests[0][:12]})", flush=True)
        if not one_card:
            mesh_cli_serve(mpath, tpath)
    finally:
        world.close()
        del m, meng, world
        gc.collect()
        torch.cuda.empty_cache()
    mesh_power(os.path.dirname(mpath), tpath, device, ptoks)
    if one_card:
        mesh_nccl_one(loaded, mpath, device, ptoks, ref_logits, ref, prompts, ref_streams)
    return launches


#: the depth of mesh_power's model (Llama-3.1-8B's widths, codes of mean 0)
MESH_POWER_LAYERS = 2


def mesh_power(tmp: str, tpath: str, device, ptoks: list[int]) -> None:
    """What the mesh checks can see. The smoke's model (write_model's codes,
    of mean -s/2) is nearly a constant function: every matmul's output
    leans on one fixed direction whose scale the norms take out, so its
    logits move about as far from one token to the next as tp=2 moves them,
    and a fault that drops a partial sum hides there. The checks' power is
    shown on a model of Llama-3.1-8B's widths whose codes have mean 0, cut
    to MESH_POWER_LAYERS layers, at tp=2 (both ranks on one card over gloo,
    the programs eager, whatever the cards): its logits (a prefill and two
    decode steps) and every layer's K/V rows of the prompt on rank 0 (its
    kv heads; a layer's rows read its input, the exchange's output) within
    TOL_FWD of one device's. Then two faults are planted in rank 0's
    exchange (its partial sums left out of the reduce, which both ranks
    then share): at layer 0, and at every layer's wo. Both checks must
    catch each."""
    import gc

    import torch

    from dllama_tpu_torch.engine.loader import load_model

    cfg = llama31_8b(MESH_POWER_LAYERS)
    path = os.path.join(tmp, "llama31_8b_power.m")
    t0 = time.perf_counter()
    write_model(path, cfg, device, seed=1, zero_mean=True)
    one = load_model(path, tpath, max_seq_len=4096, mesh=None, device=device).engine
    m = load_model(path, tpath, max_seq_len=4096, mesh="tp=2", device=device,
                   devices=[device, device])
    meng, ex = m.engine, m.engine.exchange
    n, kv, n_layers = len(ptoks), meng.cfg.n_kv_heads, cfg.n_layers
    def steps(e, feed) -> list:
        """[prefill logits, a decode step's for each token of `feed`]; the
        prefill's rows [0, n) stay in the cache."""
        e.reset(0)
        out = [e.prefill(ptoks)[0].float()]
        out += [e.decode_step([[t]])[0].float() for t in feed]
        e.reset(0)
        return out

    try:
        ref = mesh_step_logits(one, ptoks)
        feed = [int(x.argmax()) for x in ref[:-1]]  # both sides fed one device's ids
        ref = steps(one, feed)
        ref_k = one.cache.k[:, 0, :kv, :n].float().clone()
        ref_v = one.cache.v[:, 0, :kv, :n].float().clone()
        print(f"mesh power: {cfg.describe()}, codes of mean 0, up in "
              f"{time.perf_counter() - t0:.1f} s; its logits move "
              f"{_rel(ref[1], ref[0]):.3e} of max|logit| from the prefill to decode 1",
              flush=True)

        def run() -> tuple[float, list[float]]:
            logits = steps(meng, feed)
            k, v = meng.cache.k[:, 0, :, :n].float(), meng.cache.v[:, 0, :, :n].float()
            rows = [max(_rel(k[i], ref_k[i]), _rel(v[i], ref_v[i])) for i in range(n_layers)]
            return max(_rel(a, b) for a, b in zip(logits, ref)), rows

        logit_err, rows = run()
        print(f"mesh power: tp=2 vs one device: logits {logit_err:.3e}, K/V rows by layer "
              f"{[f'{e:.3e}' for e in rows]} <= TOL_FWD {TOL_FWD}", flush=True)
        if not max(rows + [logit_err]) <= TOL_FWD:
            fail("mesh power: the tp=2 logits or K/V rows are off one device's")
        for label, skip in (("rank 0's wo and w2 partials left out at layer 0",
                             lambda i: i % (2 * n_layers) < 2),
                            ("rank 0's wo partial left out at every layer",
                             lambda i: i % 2 == 0)):
            calls = [0]

            def faulty(x, skip=skip, calls=calls, reduce=ex.reduce_partial):
                calls[0] += 1  # a forward reduces wo, then w2, a layer
                return reduce(torch.zeros_like(x) if skip(calls[0] - 1) else x)

            ex.reduce_partial = faulty
            try:
                logit_err, rows = run()
            finally:
                del ex.reduce_partial
            print(f"mesh power: planted {label}: logits {logit_err:.3e}, K/V rows by layer "
                  f"{[f'{e:.3e}' for e in rows]} (TOL_FWD {TOL_FWD})", flush=True)
            if logit_err <= TOL_FWD or max(rows) <= TOL_FWD:
                fail(f"mesh power: a check missed a planted fault ({label})")
        digests = m.world.call_all("rank_digest")
        if len(set(digests)) != 1:
            fail(f"mesh power: the ranks' token results differ: {digests}")
    finally:
        m.world.close()
        del m, meng, ex, one
        gc.collect()
        torch.cuda.empty_cache()
        os.remove(path)


def mesh_nccl_one(loaded, mpath: str, device, ptoks, ref_logits, ref, prompts,
                  ref_streams) -> None:
    """The NCCL path on one card: a world of one rank over NCCL (NCCL
    refuses two ranks on one card), the engines built as on a mesh (the
    exchange on, so every layer's wo all-reduce is an NCCL collective) and
    their programs captured with it. Checks: both tiers' programs captured,
    the logits of mesh_step_logits bit-equal to one device's (an all-reduce
    over one rank adds nothing), the single engine's greedy ids and 8 dense
    slots' equal to one device's."""
    import gc

    import torch

    from dllama_tpu_torch.engine.sampling import Sampler
    from dllama_tpu_torch.parallel import multihost
    from dllama_tpu_torch.parallel.mesh import MeshConfig

    t0 = time.perf_counter()
    world = multihost.launch(
        "dllama_tpu_torch.engine.loader:rank_engine",
        dict(model_path=mpath, max_seq_len=4096, engine_kw={}), MeshConfig(tp=1),
        device=device)
    eng = world.engine
    try:
        print(f"mesh nccl: a one-rank world over {world.mesh.backend} up in "
              f"{time.perf_counter() - t0:.1f} s; programs "
              f"{'captured' if eng.programs.capture else 'eager'}", flush=True)
        logits = mesh_step_logits(eng, ptoks)
        same = all(torch.equal(a, b) for a, b in zip(logits, ref_logits))
        ids = list(eng.generate(ptoks, MESH_TOKENS, Sampler(0.0, 0.9, 0)))
        eng.reset(0)
        be = world.make("batch", n_slots=8, cache_dtype=torch.bfloat16, max_seq_len=4096,
                        kv_layout="dense")
        first = [be.add(s, p, temperature=0.0) for s, p in enumerate(prompts)]
        toks = be.decode(MESH_TOKENS - 1)
        streams = [[f] + [int(t) for t in toks[:, s]] for s, f in enumerate(first)]
        graphs = (eng.programs.stats()["graphs"], be.programs.stats()["graphs"])
        rep = eng.measured_collective_report()
        print(f"mesh nccl: graphs captured single {graphs[0]}, batched {graphs[1]}; logits "
              f"{'bit-equal to' if same else 'apart from'} one device's; {MESH_TOKENS} greedy "
              f"ids {'equal' if ids == ref else 'apart'}; 8 slots "
              f"{'equal' if streams == ref_streams else 'apart'}; one decode step's "
              f"all-reduces {rep['per_op']}", flush=True)
        if eng.device.type == "cuda" and (world.mesh.backend != "nccl" or min(graphs) == 0):
            fail("mesh nccl: the programs were not captured over NCCL")
        if not same or ids != ref or streams != ref_streams:
            near_tie(loaded, ptoks, ids, ref, "mesh nccl single engine")
            fail("mesh nccl: a one-rank NCCL world is not one device, bit for bit")
        del be
    finally:
        world.close()
        del eng, world
        gc.collect()
        torch.cuda.empty_cache()


def mesh_cli_serve(mpath: str, tpath: str) -> None:
    """The CLI's `serve --mesh tp=2 --slots 8` (two or more cards): 8
    concurrent streams of 32 greedy tokens, each answered."""
    port = _free_port()
    proc, lines, ready = _spawn(
        [sys.executable, "-u", "-m", "dllama_tpu_torch", "serve", "--model", mpath,
         "--tokenizer", tpath, "--mesh", "tp=2", "--slots", "8", "--port", str(port),
         "--max-seq-len", "4096"], "/v1/chat/completions")
    try:
        if not ready.wait(400) or proc.poll() is not None:
            fail(f"mesh: serve --mesh tp=2 did not come up: {lines[-20:]}")
        bodies = [{"messages": [{"role": "user", "content": p}], "max_tokens": MESH_TOKENS,
                   "temperature": 0} for p in batch_prompts(8)]
        out = _concurrently(lambda b: _post(port, b), [(b,) for b in bodies])
        n = [json.loads(data)["usage"]["completion_tokens"] for status, data in out
             if status == 200]
        print(f"mesh: serve --mesh tp=2 --slots 8 answered {len(n)} of 8 streams, "
              f"{sum(n)} tokens", flush=True)
        if len(n) != 8:
            fail("mesh: serve --mesh tp=2 did not answer every stream")
    finally:
        _reap(proc)


# ------------------------------------------------------- mesh (dp and sp)

#: mesh_dp_sp's sp run: the prompt prefilled, the chunk after it (rows
#: 2000..2255 straddle the 2048-row shard boundary of a 4096 context at sp=2)
#: and the decode steps after that
SP_PREFILL, SP_CHUNK, SP_DECODE = 2000, 256, 8
#: the plant's prompt on the power model: rank 1 of sp=2 then holds about
#: half the live rows, so a dropped partial moves the attention, not a tail
PLANT_PREFILL = 4000


def _rank_bytes(world, label: str, want: float) -> None:
    """Print each rank's parameter bytes and load; fail when one is off
    `want` by more than 2%."""
    for r in world.call_all("rank_report"):
        print(f"{label} rank {r['rank']}: params {r['param_bytes'] / 1e9:.3f} GB (want "
              f"{want / 1e9:.3f}), allocated {r['allocated_bytes'] / 1e9:.3f} GB; lazy Q40 "
              f"decode {r['lazy_decode_bytes'] / 1e9:.3f} GB in {r['lazy_decode_s']:.1f} s; "
              f"build {r['build_s']:.1f} s", flush=True)
        if abs(r["param_bytes"] - want) > 0.02 * want:
            fail(f"{label}: rank {r['rank']} holds {r['param_bytes']} parameter bytes, want "
                 f"about {want:.0f}")


def _close_world(m) -> None:
    import gc

    import torch

    m.world.close()
    gc.collect()
    torch.cuda.empty_cache()


def _margins(logits: list) -> list[tuple[float, float]]:
    """(top-2 gap, max|logit|) of each logits vector."""
    import torch

    out = []
    for x in logits:
        top2 = torch.topk(x.float().reshape(-1), 2).values
        out.append(((top2[0] - top2[1]).item(), x.abs().max().item()))
    return out


def _ids_check(ids: list, ref_ids: list, margins: list, label: str) -> str:
    """'equal', or where `ids` first leave `ref_ids` beside the reference's
    top-2 margin there (a near tie when under TOL_FWD * max|logit|); fails
    when it is not a near tie. ``margins[i]`` (_margins) is of the logits
    that chose ``ref_ids[i]``."""
    if ids == ref_ids:
        return "equal"
    i = next(j for j, (a, b) in enumerate(zip(ids, ref_ids)) if a != b)
    gap, scale = margins[i]
    msg = (f"first apart at {i} ({ids[i]} vs {ref_ids[i]}), top-2 margin {gap:.4e} vs "
           f"TOL_FWD * max|logit| {TOL_FWD * scale:.4e}")
    if not gap < TOL_FWD * scale:
        fail(f"{label}: ids {msg}: not a near tie")
    return msg


def phase_mesh_dp_sp(loaded, mpath: str, tpath: str, device, prompt: str) -> dict:
    """The dp and sp mesh axes on the mesh phases' model (mesh_model: the 8B
    Q40 widths at MESH_LAYERS layers, context 4096), every world's ranks on this card over gloo with the exchanges
    staged through pinned host memory and the programs eager (a harness:
    it shows correctness, loading and launches, not dp's or sp's speed).
    (a) The CLI's --mesh dp=2 and --mesh sp=2 exit 2 with the device-count
    message, not "not yet ported". (b) dp=2: a dense 8-slot BatchEngine, 4
    slots a replica: 32 greedy ids a slot equal to the unsharded dense
    engine's or first apart at a near tie; each replica's K1/K2/K7 launches
    for a decode step equal an unsharded 4-slot engine's; every rank's
    digest of its token results equal. (c) dp=2 x tp=2: the single engine's
    prefill and two decode logits within TOL_FWD of the unsharded engine's.
    (d) sp=2: a 2,000-token prefill, a 256-token chunk at position 2000 that
    straddles the shard boundary (the ring), then 8 decode steps (the LSE
    merge), both sides fed the unsharded engine's ids: the logits within
    TOL_FWD at every step, the ids equal or apart at a near tie. (e) On the
    power model (mesh_power's: the 8B widths, codes of mean 0, 2 layers) at
    sp=2 after a 4,000-token prefill: a decode step within TOL_FWD of one
    device's, then the same step with rank 1's partials dropped from rank
    0's LSE merge at layer 0, which the logits check must catch. Prints each
    rank's parameter bytes and load, the load seconds, a decode step's wall
    time, and the measured dp/sp bytes beside collective_bytes_per_token.
    Returns rank 0's launches of the mesh runs of (b) and (d)."""
    import numpy as np
    import torch

    from dllama_tpu_torch.engine.batch import BatchEngine
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.utils.profiling import collective_bytes_per_token, params_nbytes

    cfg, eng, tok = loaded.config, loaded.engine, loaded.tokenizer
    print("phase mesh_dp_sp: every rank on cuda:0 over gloo, the exchanges staged through "
          "pinned host memory, programs eager", flush=True)
    # (a) a mesh larger than the cards is refused by its size, not by its axis
    for spec in ("dp=2", "sp=2"):
        rc, err = _cli_rc_err(["inference", "--model", mpath, "--tokenizer", tpath,
                               "--prompt", "x", "--mesh", spec])
        msg = next((ln for ln in err.splitlines() if "--mesh" in ln), "")
        print(f"mesh_dp_sp: the CLI's --mesh {spec}: rc {rc}: {msg}", flush=True)
        if torch.cuda.device_count() < 2 and (
                rc != 2 or "the mesh needs 2 devices, have 1" not in msg
                or "not yet ported" in err):
            fail(f"mesh_dp_sp: the CLI did not refuse --mesh {spec} by the device count")
    full = params_nbytes(eng.params)
    ptoks = tok.encode(prompt, add_bos=True)
    launches: dict = {}

    def add(counts: dict) -> None:
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # (b) dp=2 on the batched tier
    t0 = time.perf_counter()
    m = load_model(mpath, tpath, max_seq_len=4096, mesh="dp=2", device=device,
                   devices=[device, device])
    print(f"mesh_dp_sp dp=2: load_model {time.perf_counter() - t0:.1f} s", flush=True)
    prompts = [tok.encode(p) for p in batch_prompts(8)]
    kw = dict(cache_dtype=torch.bfloat16, max_seq_len=4096, kv_layout="dense")
    try:
        _rank_bytes(m.world, "mesh_dp_sp dp=2", full)  # dp replicates the weights
        reset_counters()
        m.world.call_all("rank_launches", True)
        be = m.world.make("batch", n_slots=8, **kw)
        if be.block != (0, 4) or be.cache.k.shape[1] != 4:
            fail(f"mesh_dp_sp: rank 0 holds slots {be.block}, want (0, 4)")
        first = [be.add(s, p, temperature=0.0) for s, p in enumerate(prompts)]
        toks = be.decode(MESH_TOKENS - 1)
        streams = [[f] + [int(t) for t in toks[:, s]] for s, f in enumerate(first)]
        add(counters())
        ranks = m.world.call_all("rank_launches", True)
        print(f"mesh_dp_sp dp=2: launches of 8 slots x {MESH_TOKENS} tokens, by rank "
              f"{[{k: r.get(k, 0) for k in SERVE_KERNELS} for r in ranks]}", flush=True)
        if any(r.get(k, 0) == 0 for r in ranks for k in SERVE_KERNELS):
            fail("mesh_dp_sp: a dp replica never launched one of K1/K2/K7")
        be.decode(1)  # the step counted below is not the first of its shape
        reset_counters()
        m.world.call_all("rank_launches", True)
        be.decode(1)
        per_rank = [{k: r.get(k, 0) for k in SERVE_KERNELS}
                    for r in m.world.call_all("rank_launches", True)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        be.decode(8)
        step_ms = (time.perf_counter() - t0) / 8 * 1e3
        dp_bytes = dict(be.exchange.forward_bytes.get((8, 1), {}))
        digests = m.world.call_all("rank_digest")
        del be
    finally:
        _close_world(m)
    ref_be = BatchEngine(cfg, eng.params, device=eng.device, n_slots=8, **kw)
    ref_first = [ref_be.add(s, p, temperature=0.0) for s, p in enumerate(prompts)]
    ref_toks = ref_be.decode(MESH_TOKENS - 1)
    ref_streams = [[f] + [int(t) for t in ref_toks[:, s]] for s, f in enumerate(ref_first)]
    del ref_be
    one4 = BatchEngine(cfg, eng.params, device=eng.device, n_slots=4, **kw)
    for s, p in enumerate(prompts[:4]):
        one4.add(s, p, temperature=0.0)
    one4.decode(1)
    reset_counters()
    one4.decode(1)
    want_n = {k: counters().get(k, 0) for k in SERVE_KERNELS}
    del one4
    torch.cuda.empty_cache()
    apart = sum(near_tie(loaded, prompts[s], a, b, f"mesh_dp_sp dp=2 slot {s}") is not None
                for s, (a, b) in enumerate(zip(streams, ref_streams)))
    print(f"mesh_dp_sp dp=2: 8 dense slots, {MESH_TOKENS} greedy ids each: {8 - apart} equal "
          f"to one device, {apart} first apart at a near tie; a decode step's K1/K2/K7 by "
          f"replica {per_rank}, an unsharded 4-slot engine's {want_n}; a step {step_ms:.3f} "
          f"ms wall; its exchange {dp_bytes} (collective_bytes_per_token has no dp term: "
          f"{collective_bytes_per_token(cfg)['bytes_per_token_per_chip']:.0f} B)", flush=True)
    if any(r != want_n for r in per_rank):
        fail("mesh_dp_sp: a replica's decode-step launches differ from a 4-slot engine's")
    if len(set(digests)) != 1:
        fail(f"mesh_dp_sp: the ranks' token results differ: {digests}")
    print(f"mesh_dp_sp dp=2: every rank's token results equal ({digests[0][:12]})",
          flush=True)

    # (c) dp=2 x tp=2, the single engine
    ref_logits = mesh_step_logits(eng, ptoks)
    t0 = time.perf_counter()
    m = load_model(mpath, tpath, max_seq_len=4096, mesh="dp=2,tp=2", device=device,
                   devices=[device] * 4)
    print(f"mesh_dp_sp dp=2,tp=2: load_model {time.perf_counter() - t0:.1f} s", flush=True)
    try:
        repl = params_nbytes({k: eng.params[k] for k in ("embedding", "final_norm")}) + \
            params_nbytes({k: eng.params["layers"][k] for k in ("rms_att", "rms_ffn")})
        _rank_bytes(m.world, "mesh_dp_sp dp=2,tp=2", repl + (full - repl) / 2)
        logits = mesh_step_logits(m.engine, ptoks)
        rep = m.engine.measured_collective_report()
    finally:
        _close_world(m)
    errs = [_rel(a, b) for a, b in zip(logits, ref_logits)]
    print(f"mesh_dp_sp dp=2,tp=2: prefill and 2 decode logits vs one device "
          f"{[f'{e:.3e}' for e in errs]} <= TOL_FWD {TOL_FWD}; a decode step's exchange "
          f"{rep['per_op']} ({rep['total_bytes']} B), collective_bytes_per_token(tp=2) "
          f"{collective_bytes_per_token(cfg, tp=2)['bytes_per_token_per_chip']:.0f} B",
          flush=True)
    if not max(errs) <= TOL_FWD:
        fail("mesh_dp_sp: the dp=2,tp=2 logits are off the unsharded kernels'")

    # (d) sp=2: the ring (a straddling chunk) and the LSE merge (decode)
    rng = np.random.default_rng(12)
    long = [int(t) for t in rng.integers(1, cfg.vocab_size, SP_PREFILL + SP_CHUNK)]

    def sp_run(e, feed=None):
        e.reset(0)
        out = [e.prefill([long[:SP_PREFILL]])[0].float()]
        out.append(e.step(np.asarray([long[SP_PREFILL:]]))[0].float())
        ids = []
        for i in range(SP_DECODE):
            ids.append(int(out[-1].argmax()) if feed is None else feed[i])
            out.append(e.decode_step([[ids[-1]]])[0].float())
        e.reset(0)
        return out, ids

    ref_out, ref_ids = sp_run(eng)
    t0 = time.perf_counter()
    m = load_model(mpath, tpath, max_seq_len=4096, mesh="sp=2", device=device,
                   devices=[device, device])
    print(f"mesh_dp_sp sp=2: load_model {time.perf_counter() - t0:.1f} s", flush=True)
    meng = m.engine
    try:
        _rank_bytes(m.world, "mesh_dp_sp sp=2", full)  # sp replicates the weights
        if meng.attn_route != "ring" or meng.backend != "cuda" or \
                meng.cache.k.shape[3] != 4096 // 2 + 1:
            fail(f"mesh_dp_sp: the sp engine runs {meng.backend}/{meng.attn_route} over "
                 f"{meng.cache.k.shape[3]} rows a layer")
        reset_counters()
        m.world.call_all("rank_launches", True)
        t0 = time.perf_counter()
        out, _ = sp_run(meng, ref_ids)
        run_s = time.perf_counter() - t0
        add(counters())
        ranks = m.world.call_all("rank_launches", True)
        ids = [int(x.argmax()) for x in out[1:-1]]  # each step's own choice of the next id
        rep = meng.measured_collective_report()
        meng.reset(SP_PREFILL)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meng.decode_greedy_n([[ref_ids[0]]], 4)
        step_ms = (time.perf_counter() - t0) / 4 * 1e3
        meng.reset(0)
        if len(set(m.world.call_all("rank_digest"))) != 1:
            fail("mesh_dp_sp: the sp ranks' token results differ")
    finally:
        _close_world(m)
        del meng
    errs = [_rel(a, b) for a, b in zip(out, ref_out)]
    msg = _ids_check(ids, ref_ids, _margins(ref_out[1:-1]), "mesh_dp_sp sp=2")
    print(f"mesh_dp_sp sp=2: prefill {SP_PREFILL}, a {SP_CHUNK}-token chunk at {SP_PREFILL} "
          f"(ring), {SP_DECODE} decode steps (LSE) in {run_s:.1f} s; logits vs one device "
          f"{[f'{e:.3e}' for e in errs]} <= TOL_FWD {TOL_FWD}; ids {msg}; K1/K2 by rank "
          f"{[{k: r.get(k, 0) for k in SERVE_KERNELS} for r in ranks]}; a decode step "
          f"{step_ms:.3f} ms wall; its exchange {rep['per_op']}, "
          f"collective_bytes_per_token(sp=2) "
          f"{collective_bytes_per_token(cfg, sp=2)['bytes_per_token_per_chip']:.0f} B (kv "
          f"heads; the merge moves the query heads' partials)", flush=True)
    if not max(errs) <= TOL_FWD:
        fail("mesh_dp_sp: the sp=2 logits are off the unsharded kernels'")
    if any(r.get(k, 0) == 0 for r in ranks for k in ("q40_decode", "q40_prefill")):
        fail("mesh_dp_sp: an sp rank never launched K1 or K2")
    mesh_sp_plant(os.path.dirname(mpath), tpath, device)
    return launches


def mesh_sp_plant(tmp: str, tpath: str, device) -> None:
    """mesh_dp_sp (e): the power model (mesh_power's recipe) at sp=2 after a
    PLANT_PREFILL-token prefill; a decode step within TOL_FWD of one
    device's, then the same step with rank 1's partials dropped from rank
    0's LSE merge at layer 0 (rank 0 makes the exchange, then keeps its own
    partial sums), which the logits check must catch."""
    import numpy as np
    import torch

    from dllama_tpu_torch.engine.loader import load_model

    cfg = llama31_8b(MESH_POWER_LAYERS)
    path = os.path.join(tmp, "llama31_8b_power_sp.m")
    t0 = time.perf_counter()
    write_model(path, cfg, device, seed=1, zero_mean=True)
    one = load_model(path, tpath, max_seq_len=4096, mesh=None, device=device).engine
    m = load_model(path, tpath, max_seq_len=4096, mesh="sp=2", device=device,
                   devices=[device, device])
    meng, axis = m.engine, m.engine.exchange.sp
    toks = [int(t) for t in np.random.default_rng(13).integers(1, cfg.vocab_size,
                                                                PLANT_PREFILL)]

    def step(e, feed: int):
        """The decode step after the prompt, fed `feed`."""
        e.reset(0)
        e.prefill([toks])
        return e.decode_step([[feed]])[0].float()

    try:
        feed = int(one.prefill([toks])[0].argmax())
        ref = step(one, feed)
        clean = _rel(step(meng, feed), ref)
        calls = [0]

        def dropped(x, op="sum", real=axis.all_reduce):
            calls[0] += 1
            out = real(x, op)  # every rank still takes part
            return x if (calls[0] == 2 and op == "sum") else out  # layer 0's sums

        meng.reset(0)
        meng.prefill([toks])
        axis.all_reduce = dropped
        try:
            planted = _rel(meng.decode_step([[feed]])[0].float(), ref)
        finally:
            del axis.all_reduce
        print(f"mesh_dp_sp plant: {cfg.describe()}, codes of mean 0, up in "
              f"{time.perf_counter() - t0:.1f} s; after {PLANT_PREFILL} tokens a decode step "
              f"at sp=2 vs one device {clean:.3e} <= TOL_FWD {TOL_FWD}; with rank 1's "
              f"partials dropped from rank 0's merge at layer 0: {planted:.3e}", flush=True)
        if not clean <= TOL_FWD:
            fail("mesh_dp_sp: the power model's sp=2 decode step is off one device's")
        if planted <= TOL_FWD:
            fail("mesh_dp_sp: the logits check missed the dropped partials")
    finally:
        _close_world(m)
        del m, meng, one
        torch.cuda.empty_cache()
        os.remove(path)


# ------------------------------------------------------ mesh (pp and ep)

#: mesh_pp_ep (b): the random prompt prefilled at pp=2 and the greedy decode
#: steps after it
PP_PREFILL, PP_DECODE = 256, 8


def _stage_bytes(params, pp: int, tp: int) -> float:
    """A rank's parameter bytes on a pp x tp mesh: the embedding and final
    norm whole, wcls's tp shard, its stage's norms and its tp shard of its
    stage's matmul weights."""
    from dllama_tpu_torch.utils.profiling import params_nbytes

    lay = params["layers"]
    norms = params_nbytes({k: lay[k] for k in ("rms_att", "rms_ffn")})
    mats = params_nbytes({k: v for k, v in lay.items() if k not in ("rms_att", "rms_ffn")})
    return (params_nbytes({k: params[k] for k in ("embedding", "final_norm")})
            + params_nbytes({"wcls": params["wcls"]}) / tp + norms / pp + mats / (pp * tp))


def phase_mesh_pp_ep(loaded, mpath: str, tpath: str, device, prompt: str) -> dict:
    """The pp and ep mesh axes, every world's ranks on this card over gloo
    with the exchanges staged through pinned host memory and the programs
    eager (a harness: correctness, loading and launches, not pp's or ep's
    speed). (a) The CLI's --mesh pp=2 and --mesh ep=2 exit 2 with the
    device-count message, not "not yet ported". (b) pp=2 on the mesh
    phases' model (mesh_model, MESH_LAYERS / 2 layers a stage): a
    PP_PREFILL-token prefill
    and PP_DECODE greedy decode steps, both sides fed the unsharded engine's
    ids: the logits within TOL_FWD at every step, the ids equal or first
    apart at a near tie, each stage's K1/K2/K7 launches a decode step its
    layers' share of the unsharded engine's (wcls on the last stage only).
    (c) tp=2 x pp=2 (4 ranks): the prefill and two decode logits within
    TOL_FWD. (d) pp_micro=2 at batch 2 within TOL_FWD of pp_micro=1. (e)
    mesh_pp_ep_plants. Prints each rank's parameter bytes and load, the
    load seconds, a decode step's wall time, and the measured pp bytes
    beside collective_bytes_per_token. Returns rank 0's launches of (b)."""
    import numpy as np
    import torch

    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.utils.profiling import collective_bytes_per_token

    cfg, eng, tok = loaded.config, loaded.engine, loaded.tokenizer
    print("phase mesh_pp_ep: every rank on cuda:0 over gloo, the exchanges staged through "
          "pinned host memory, programs eager", flush=True)
    for spec in ("pp=2", "ep=2"):  # (a)
        rc, err = _cli_rc_err(["inference", "--model", mpath, "--tokenizer", tpath,
                               "--prompt", "x", "--mesh", spec])
        msg = next((ln for ln in err.splitlines() if "--mesh" in ln), "")
        print(f"mesh_pp_ep: the CLI's --mesh {spec}: rc {rc}: {msg}", flush=True)
        if torch.cuda.device_count() < 2 and (
                rc != 2 or "the mesh needs 2 devices, have 1" not in msg
                or "not yet ported" in err):
            fail(f"mesh_pp_ep: the CLI did not refuse --mesh {spec} by the device count")
    ptoks = tok.encode(prompt, add_bos=True)
    toks = [int(t) for t in np.random.default_rng(14).integers(1, cfg.vocab_size, PP_PREFILL)]

    def pp_run(e, feed=None):
        e.reset(0)
        out = [e.prefill([toks])[0].float()]
        ids = []
        for i in range(PP_DECODE):
            ids.append(int(out[-1].argmax()) if feed is None else feed[i])
            out.append(e.decode_step([[ids[-1]]])[0].float())
        e.reset(0)
        return out, ids

    def step_launches(e, world=None) -> list[dict]:
        """K1/K2/K7 launches of one decode step after the prompt (the
        second of its shape): rank 0's alone, or every rank's."""
        for _ in range(2):
            reset_counters()
            if world is not None:
                world.call_all("rank_launches", True)
            e.reset(PP_PREFILL)
            e.decode_step([[toks[0]]])
        e.reset(0)
        got = [counters()] if world is None else world.call_all("rank_launches", True)
        return [{k: r.get(k, 0) for k in SERVE_KERNELS} for r in got]

    ref_out, ref_ids = pp_run(eng)
    one_step = step_launches(eng)[0]
    launches: dict = {}

    # (b) pp=2, the single engine
    t0 = time.perf_counter()
    m = load_model(mpath, tpath, max_seq_len=4096, mesh="pp=2", device=device,
                   devices=[device, device])
    print(f"mesh_pp_ep pp=2: load_model {time.perf_counter() - t0:.1f} s", flush=True)
    meng = m.engine
    try:
        if meng.cfg.n_layers != cfg.n_layers // 2 or meng.backend != "cuda" or \
                meng.attn_route != "flash":
            fail(f"mesh_pp_ep: stage 0 runs {meng.cfg.n_layers} layers on "
                 f"{meng.backend}/{meng.attn_route}")
        _rank_bytes(m.world, "mesh_pp_ep pp=2", _stage_bytes(eng.params, 2, 1))
        reset_counters()
        m.world.call_all("rank_launches", True)
        t0 = time.perf_counter()
        out, _ = pp_run(meng, ref_ids)
        run_s = time.perf_counter() - t0
        launches = counters()
        ranks = m.world.call_all("rank_launches", True)
        per_rank = step_launches(meng, m.world)
        rep = meng.measured_collective_report()
        meng.reset(PP_PREFILL)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meng.decode_greedy_n([[ref_ids[0]]], 4)
        step_ms = (time.perf_counter() - t0) / 4 * 1e3
        if len(set(m.world.call_all("rank_digest"))) != 1:
            fail("mesh_pp_ep: the pp ranks' token results differ")
        # (d) GPipe microbatches at batch 2
        rows = np.asarray([toks[:64], toks[64:128]])
        micro = []
        for n in (1, 2):
            e2 = m.world.make("engine", batch=2, pp_micro=n, max_seq_len=256)
            micro.append(e2.step(rows).float())
            del e2
        micro_err = _rel(micro[1], micro[0])
    finally:
        _close_world(m)
        del meng
    errs = [_rel(a, b) for a, b in zip(out, ref_out)]
    ids = [int(x.argmax()) for x in out[:-1]]  # each step's own choice of the next id
    msg = _ids_check(ids, ref_ids, _margins(ref_out[:-1]), "mesh_pp_ep pp=2")
    last = cfg.n_layers // 2
    want = [{"q40_decode": 7 * last + s, "q40_prefill": 0, "flash_attention": last}
            for s in (0, 1)]
    print(f"mesh_pp_ep pp=2: prefill {PP_PREFILL}, {PP_DECODE} decode steps in {run_s:.1f} s; "
          f"logits vs one device {[f'{e:.3e}' for e in errs]} <= TOL_FWD {TOL_FWD}; ids {msg}; "
          f"launches of the run by rank {[{k: r.get(k, 0) for k in SERVE_KERNELS} for r in ranks]}"
          f"; a decode step's K1/K2/K7 by stage {per_rank} (want {want}; one device "
          f"{one_step}); a decode step {step_ms:.3f} ms wall; its exchange on stage 0 "
          f"{rep['per_op']} ({rep['total_bytes']} B), collective_bytes_per_token has no pp "
          f"term: {collective_bytes_per_token(cfg)['bytes_per_token_per_chip']:.0f} B; "
          f"pp_micro=2 vs 1 at batch 2 {micro_err:.3e}", flush=True)
    if not max(errs) <= TOL_FWD:
        fail("mesh_pp_ep: the pp=2 logits are off the unsharded kernels'")
    if per_rank != want or one_step != {"q40_decode": 7 * cfg.n_layers + 1, "q40_prefill": 0,
                                        "flash_attention": cfg.n_layers}:
        fail("mesh_pp_ep: a stage's decode-step launches are not its layers' share")
    if rep["per_op"] != {"pp:send": cfg.dim * eng.params["embedding"].element_size(),
                         "pp:broadcast": cfg.vocab_size * 4}:
        fail("mesh_pp_ep: stage 0's exchange is not the bytes of its shapes")
    if not micro_err <= TOL_FWD:
        fail("mesh_pp_ep: pp_micro=2 is off pp_micro=1")

    # (c) tp=2 x pp=2, the single engine
    ref_logits = mesh_step_logits(eng, ptoks)
    t0 = time.perf_counter()
    m = load_model(mpath, tpath, max_seq_len=4096, mesh="tp=2,pp=2", device=device,
                   devices=[device] * 4)
    print(f"mesh_pp_ep tp=2,pp=2: load_model {time.perf_counter() - t0:.1f} s", flush=True)
    try:
        _rank_bytes(m.world, "mesh_pp_ep tp=2,pp=2", _stage_bytes(eng.params, 2, 2))
        logits = mesh_step_logits(m.engine, ptoks)
        rep = m.engine.measured_collective_report()
    finally:
        _close_world(m)
    errs = [_rel(a, b) for a, b in zip(logits, ref_logits)]
    print(f"mesh_pp_ep tp=2,pp=2: prefill and 2 decode logits vs one device "
          f"{[f'{e:.3e}' for e in errs]} <= TOL_FWD {TOL_FWD}; a decode step's exchange on "
          f"stage 0 {rep['per_op']} ({rep['total_bytes']} B), collective_bytes_per_token(tp=2) "
          f"{collective_bytes_per_token(cfg, tp=2)['bytes_per_token_per_chip']:.0f} B",
          flush=True)
    if not max(errs) <= TOL_FWD:
        fail("mesh_pp_ep: the tp=2,pp=2 logits are off the unsharded kernels'")
    mesh_pp_ep_plants(os.path.dirname(mpath), device)
    return launches


def mesh_pp_ep_plants(tmp: str, device) -> None:
    """mesh_pp_ep (e): the checks' power on mesh_power's kind of model (codes
    of mean 0, MESH_POWER_LAYERS layers) at Mixtral-8x7B's widths, so that
    one file serves pp and ep. At pp=2 and at ep=2: the prefill and two
    decode logits within TOL_FWD of one device's on a random 64-token
    prompt of its vocabulary, both sides fed one device's ids; then the
    second decode step again with a fault planted on rank 0, which the
    logits check must catch: at pp=2, stage 0 sends the previous decode
    step's activation (stage 1 receives a stale one); at ep=2, rank 0's
    sum over ep at layer 0 loses one rank's expert partial (its own where
    it routed the token to one of its experts, else rank 1's)."""
    import numpy as np
    import torch

    from dllama_tpu_torch.engine.loader import load_model

    cfg = mixtral_8x7b(MESH_POWER_LAYERS)
    path = os.path.join(tmp, "mixtral_power.m")
    t0 = time.perf_counter()
    write_model(path, cfg, device, seed=1, zero_mean=True)
    one = load_model(path, max_seq_len=4096, mesh=None, device=device).engine
    ptoks = [int(t) for t in np.random.default_rng(15).integers(1, cfg.vocab_size, 64)]

    def steps(e, feed) -> list:
        e.reset(0)
        out = [e.prefill(ptoks)[0].float()]
        out += [e.decode_step([[t]])[0].float() for t in feed]
        return out

    try:
        ref = mesh_step_logits(one, ptoks)
        feed = [int(x.argmax()) for x in ref[:-1]]
        ref = steps(one, feed)
        print(f"mesh_pp_ep plants: {cfg.describe()}, codes of mean 0, up in "
              f"{time.perf_counter() - t0:.1f} s; its logits move "
              f"{_rel(ref[1], ref[0]):.3e} of max|logit| from the prefill to decode 1",
              flush=True)
        for spec in ("pp=2", "ep=2"):
            m = load_model(path, max_seq_len=4096, mesh=spec, device=device,
                           devices=[device, device])
            meng, ex = m.engine, m.engine.exchange
            try:
                clean = max(_rel(a, b) for a, b in zip(steps(meng, feed), ref))
                armed = [False]
                if spec == "pp=2":
                    axis, name, sent = ex.pp, "hop", []

                    def planted(send, recv_like, real=ex.pp.hop):
                        if send is not None:
                            sent.append(send.clone())
                            if armed[0] and len(sent) > 1:
                                send = sent[-2]  # the previous step's activation
                        return real(send, recv_like)
                    label = "stage 1 receives the previous decode step's activation"
                else:
                    axis, name, calls = ex.ep, "all_reduce", [0]

                    def planted(x, op="sum", real=ex.ep.all_reduce):
                        calls[0] += armed[0]
                        if calls[0] != 1:  # not the armed step's first layer
                            return real(x, op)
                        mine = bool(x.abs().max() > 0)  # rank 0 routed the token here
                        out = real(torch.zeros_like(x) if mine else x, op)
                        return out if mine else x
                    label = "rank 0's ep sum at layer 0 loses one rank's expert partial"
                setattr(axis, name, planted)
                try:
                    meng.reset(0)
                    meng.prefill(ptoks)
                    meng.decode_step([[feed[0]]])
                    armed[0] = True
                    hit = _rel(meng.decode_step([[feed[1]]])[0].float(), ref[2])
                finally:
                    delattr(axis, name)
                print(f"mesh_pp_ep plants {spec}: clean, the worst step {clean:.3e} <= TOL_FWD "
                      f"{TOL_FWD}; planted ({label}): decode 2 {hit:.3e}", flush=True)
                if not clean <= TOL_FWD:
                    fail(f"mesh_pp_ep plants: the power model at {spec} is off one device's")
                if hit <= TOL_FWD:
                    fail(f"mesh_pp_ep plants: the logits check missed the fault at {spec}")
            finally:
                _close_world(m)
                del meng, ex
    finally:
        del one
        torch.cuda.empty_cache()
        os.remove(path)


# ------------------------------------------------------------ main


# -------------------------------------------------------- mesh supervision

#: mesh_supervision: the greedy streams of (a) and (b), their tokens, the
#: decode chunks before (a)'s crash, and the tokens before and after (c)'s
#: session round trips
SUPM_STREAMS = 4
SUPM_TOKENS = 64
SUPM_CRASH_AFTER = 16
SUPM_SESSION_TOKENS = 32


def _drain(req, timeout: float = 300.0) -> tuple[list[int], BaseException | None]:
    """A Scheduler request's tokens and its error (None when it ended
    cleanly), with a deadline."""
    toks, deadline = [], time.monotonic() + timeout
    while True:
        item = req.out.get(timeout=max(0.01, deadline - time.monotonic()))
        if isinstance(item, BaseException):
            return toks, item
        if isinstance(item, int):
            toks.append(item)
        else:
            return toks, None


def phase_mesh_supervision(loaded, mpath: str, tpath: str, device, prompt: str) -> dict:
    """Supervision on a mesh (the mesh phases' model, every rank on this
    card over gloo, staged, eager): (a) a tp=2 dense Scheduler of
    SUPM_STREAMS slots with restart_max=2 serves SUPM_STREAMS greedy
    streams of SUPM_TOKENS, then the same with engine.decode:raise armed
    (faults.install on rank 0) after SUPM_CRASH_AFTER chunks: one warm
    restart, each stream whole, its ids equal to the first run's or apart at
    a near tie, the ranks' digests equal, no capture after the restart, the
    crash-to-first-resumed-token ms and the rebuild's; (b) decode.nan fails
    exactly one stream; (c) sessions: SUPM_SESSION_TOKENS greedy tokens,
    save_session on tp=2 and on pp=2, load_session into the unsharded
    engine, as many more, against twice as many on one device; and one
    saved on one device, loaded on pp=2 and continued there; each save and
    load timed; (d) every rank's K1/K2/K7 launches of the phase. Returns
    rank 0's launches of (a)-(c)."""
    import torch

    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.engine.sampling import Sampler
    from dllama_tpu_torch.obs import compile as compile_obs
    from dllama_tpu_torch.serve.scheduler import Scheduler
    from dllama_tpu_torch.utils import faults

    eng, tok = loaded.engine, loaded.tokenizer
    one_card = torch.cuda.device_count() < 2
    devices = [device, device] if one_card else None
    print(f"phase mesh_supervision: tp=2 and pp=2 over "
          f"{'gloo on cuda:0, staged, eager' if one_card else 'NCCL, one card a rank'}",
          flush=True)
    prompts = [tok.encode(p) for p in batch_prompts(SUPM_STREAMS)]
    ptoks = tok.encode(prompt, add_bos=True)
    greedy = Sampler(0.0, 0.9, 0)
    eng.reset(0)
    ref64 = list(eng.generate(ptoks, 2 * SUPM_SESSION_TOKENS, greedy))
    eng.reset(0)
    launches: dict = {}
    ranks_n: dict = {}

    def add(rank0: dict, ranks: list, label: str) -> None:
        for k, v in rank0.items():
            launches[k] = launches.get(k, 0) + v
        ranks_n[label] = [{k: r.get(k, 0) for k in SERVE_KERNELS} for r in ranks]

    t0 = time.perf_counter()
    m = load_model(mpath, tpath, max_seq_len=4096, mesh="tp=2", device=device,
                   devices=devices)
    print(f"mesh_supervision tp=2: load_model {time.perf_counter() - t0:.1f} s", flush=True)
    world = m.world
    times: dict = {}
    try:
        reset_counters()
        world.call_all("rank_launches", True)
        be = world.make("batch", n_slots=SUPM_STREAMS, cache_dtype=torch.bfloat16,
                        max_seq_len=4096, kv_layout="dense")
        sched = Scheduler(be, restart_max=2)
        marks: dict = {}
        restart, warm_restart, emit = sched._try_restart, be.warm_restart, sched._emit

        def stamped_restart(exc):
            marks.setdefault("crash", time.perf_counter())
            return restart(exc)

        def timed_rebuild():
            t1 = time.perf_counter()
            warm_restart()
            marks["rebuild_ms"] = (time.perf_counter() - t1) * 1e3

        def stamped_emit(req, token, row):
            if "crash" in marks and "resumed" not in marks:
                marks["resumed"] = time.perf_counter()
            return emit(req, token, row)

        sched._try_restart, be.warm_restart, sched._emit = (stamped_restart, timed_rebuild,
                                                            stamped_emit)

        def run(point=None, after=0):
            if point is not None:
                faults.install(point, "raise", after=after, times=1)
            try:
                reqs = [sched.submit(p, 0.0, 0.9, SUPM_TOKENS, frozenset(), seed=100 + i)
                        for i, p in enumerate(prompts)]
                return [_drain(r) for r in reqs]
            finally:
                faults.clear()

        try:
            t1 = time.perf_counter()
            base = run()
            times["base_s"] = time.perf_counter() - t1
            captures0 = compile_obs.LEDGER.total_compiles()
            crash = run("engine.decode", SUPM_CRASH_AFTER)
            captures1 = compile_obs.LEDGER.total_compiles()
            nan = run("decode.nan", 4)
            health = sched.health()
        finally:
            sched.shutdown()
        for label, res in (("baseline", base), ("across the restart", crash)):
            for i, (ids, exc) in enumerate(res):
                if exc is not None or len(ids) != SUPM_TOKENS:
                    fail(f"mesh_supervision (a) stream {i} {label}: {len(ids)} of "
                         f"{SUPM_TOKENS} tokens, error {exc!r}")
        if sched.restart_count != 1 or "resumed" not in marks or not health["live"]:
            fail(f"mesh_supervision (a): {sched.restart_count} restarts (want 1), marks "
                 f"{marks}, health {health}")
        if captures1 != captures0:
            fail(f"mesh_supervision (a): the restart captured {captures1 - captures0} programs")
        parted = [msg for i in range(SUPM_STREAMS)
                  if (msg := near_tie(loaded, prompts[i], crash[i][0], base[i][0],
                                      f"mesh_supervision (a) stream {i}")) is not None]
        failed = [i for i, (_, exc) in enumerate(nan) if exc is not None]
        if len(failed) != 1 or any(len(nan[i][0]) != SUPM_TOKENS for i in range(SUPM_STREAMS)
                                   if i not in failed):
            fail(f"mesh_supervision (b): decode.nan failed streams {failed} (want one)")
        digests = world.call_all("rank_digest")
        if len(set(digests)) != 1:
            fail(f"mesh_supervision: the ranks' token results differ: {digests}")
        crash_ms = (marks["resumed"] - marks["crash"]) * 1e3
        print(f"mesh_supervision (a): {SUPM_STREAMS} greedy streams of {SUPM_TOKENS} tokens "
              f"({times['base_s']:.1f} s uninterrupted); engine.decode raised on every rank "
              f"after {SUPM_CRASH_AFTER} chunks: 1 warm restart, every stream whole, "
              f"{SUPM_STREAMS - len(parted)} equal to the uninterrupted run, {len(parted)} "
              f"apart at a near tie; crash to the first resumed token {crash_ms:.1f} ms (the "
              f"rebuild on every rank {marks['rebuild_ms']:.1f} ms, the backoff "
              f"{sched.restart_backoff_s * 1e3:.0f} ms); captures unchanged ({captures1}); "
              f"digests equal ({digests[0][:12]})", flush=True)
        print(f"mesh_supervision (b): decode.nan failed stream {failed[0]} alone "
              f"({nan[failed[0]][1]!r:.60}); the other {SUPM_STREAMS - 1} whole", flush=True)
        del be, sched
        # (c) the single engine's session, tp=2 -> one device
        meng = m.engine
        meng.reset(0)
        head = list(meng.generate(ptoks, SUPM_SESSION_TOKENS, greedy))
        path = os.path.join(os.path.dirname(mpath), "session_tp2.npz")
        t1 = time.perf_counter()
        meng.save_session(path)
        times["tp2_save_s"] = time.perf_counter() - t1
        fps = world.call_all("rank_fingerprint")
        meng.reset(0)
        add(counters(), world.call_all("rank_launches", True), "tp=2")
    finally:
        _close_world(m)
    if len(set(fps)) != 1 or fps[0] != eng.session_fingerprint():
        fail(f"mesh_supervision (c): the tp=2 ranks' fingerprints {fps} are not one device's")
    session_checks = []

    def into_one(path: str, head: list, label: str) -> None:
        t1 = time.perf_counter()
        eng.load_session(path)
        times[f"{label}_load_s"] = time.perf_counter() - t1
        tail = eng.decode_greedy_n([[head[-1]]], SUPM_SESSION_TOKENS)[:, 0].tolist()
        eng.reset(0)
        os.remove(path)
        msg = near_tie(loaded, ptoks, head + tail, ref64, f"mesh_supervision (c) {label}")
        session_checks.append(f"{label} {'equal' if msg is None else 'near tie'}")

    into_one(path, head, "tp2")
    # (c) pp=2 -> one device, and one device -> pp=2
    eng.reset(0)
    head_one = list(eng.generate(ptoks, SUPM_SESSION_TOKENS, greedy))
    one_path = os.path.join(os.path.dirname(mpath), "session_one.npz")
    t1 = time.perf_counter()
    eng.save_session(one_path)
    times["one_save_s"] = time.perf_counter() - t1
    eng.reset(0)
    t0 = time.perf_counter()
    m = load_model(mpath, tpath, max_seq_len=4096, mesh="pp=2", device=device,
                   devices=devices)
    print(f"mesh_supervision pp=2: load_model {time.perf_counter() - t0:.1f} s", flush=True)
    world, meng = m.world, m.engine
    try:
        reset_counters()
        world.call_all("rank_launches", True)
        meng.reset(0)
        head = list(meng.generate(ptoks, SUPM_SESSION_TOKENS, greedy))
        path = os.path.join(os.path.dirname(mpath), "session_pp2.npz")
        t1 = time.perf_counter()
        meng.save_session(path)
        times["pp2_save_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        meng.load_session(one_path)
        times["pp2_load_s"] = time.perf_counter() - t1
        tail = meng.decode_greedy_n([[head_one[-1]]], SUPM_SESSION_TOKENS)[:, 0].tolist()
        msg = near_tie(loaded, ptoks, head_one + tail, ref64, "mesh_supervision (c) one->pp2")
        session_checks.append(f"one->pp2 {'equal' if msg is None else 'near tie'}")
        fps = world.call_all("rank_fingerprint")
        if len(set(world.call_all("rank_digest"))) != 1:
            fail("mesh_supervision (c): the pp ranks' token results differ")
        meng.reset(0)
        add(counters(), world.call_all("rank_launches", True), "pp=2")
    finally:
        _close_world(m)
        del meng, world
    os.remove(one_path)
    if len(set(fps)) != 1 or fps[0] != eng.session_fingerprint():
        fail(f"mesh_supervision (c): the pp=2 ranks' fingerprints {fps} are not one device's")
    into_one(path, head, "pp2")
    print(f"mesh_supervision (c): {SUPM_SESSION_TOKENS} + {SUPM_SESSION_TOKENS} greedy tokens "
          f"across sessions against {2 * SUPM_SESSION_TOKENS} on one device: "
          f"{', '.join(session_checks)}; seconds "
          f"{ {k: round(v, 3) for k, v in times.items() if k != 'base_s'} }; every rank's "
          "fingerprint one device's", flush=True)
    print(f"mesh_supervision (d): K1/K2/K7 launches by rank {ranks_n}; rank 0 {launches}",
          flush=True)
    if any(r.get(k, 0) == 0 for rs in ranks_n.values() for r in rs for k in SERVE_KERNELS):
        fail("mesh_supervision: a rank never launched one of K1/K2/K7")
    return launches


# ------------------------------------------------------------ phase tools

#: merged pieces the tools phase's tokenizer learns from the repository's
#: text, and the least it must get (the rest of the 128,000 regular ids are
#: inert filler pieces)
TOOLS_MERGES = 24_000
TOOLS_MIN_MERGES = 20_000
#: prompt sizes timed through the converted tokenizer (the Python fallback
#: at the first only: it is quadratic in the prompt)
TOOLS_TOKENIZE_BYTES = (2_000, 8_000, 32_000)
TOOLS_SYSTEM_BYTES = 8_000  # the served chats' system prompt
TOOLS_CHATS = 8
TOOLS_TOKENS = 16  # greedy tokens a served chat
TOOLS_STEPS = 8  # the launcher's `inference --steps`
TOOLS_CHAOS_REQUESTS = 24
#: tensors the conversion's bytes are held against the numpy path on (a
#: layer's index: first, middle or last)
TOOLS_SPOT_CHECK = (("first", "wq"), ("first", "wk"), ("middle", "w2"), ("last", "w3"))
#: the byte-level BPE learner's pre-tokenizer: an optional space and a run
#: of other bytes, or a run of whitespace
BPE_SPLIT = re.compile(rb" ?\S+|\s+")


def repo_text() -> bytes:
    """The repository's own prose: every Markdown file at its root, in name
    order (the corpus the tools phase's BPE vocabulary is learned from, and
    its prompts are cut from)."""
    root = os.path.dirname(os.path.abspath(__file__))
    names = sorted(n for n in os.listdir(root) if n.endswith(".md"))
    return b"\n".join(open(os.path.join(root, n), "rb").read() for n in names)


def learn_bpe(text: bytes, n_merges: int) -> list[tuple[bytes, bytes]]:
    """Byte-level BPE training on `text`, deterministic: the pair of
    adjacent pieces with the highest count is merged first (ties by the
    pair's ids), inside the chunks of BPE_SPLIT, until `n_merges` distinct
    pieces are learned or no pair is left. -> each new piece's (left,
    right) halves, in merge order (the ids after the 256 bytes)."""
    import heapq
    from collections import Counter, defaultdict

    words = Counter(BPE_SPLIT.findall(text))
    seqs = [list(w) for w in words]
    counts = list(words.values())
    pieces = [bytes([i]) for i in range(256)]
    index = {p: i for i, p in enumerate(pieces)}
    pair_count: dict = defaultdict(int)
    where: dict = defaultdict(set)
    for wi, seq in enumerate(seqs):
        for p in zip(seq, seq[1:]):
            pair_count[p] += counts[wi]
            where[p].add(wi)
    heap = [(-c, a, b) for (a, b), c in pair_count.items()]
    heapq.heapify(heap)
    merged = []
    while len(merged) < n_merges and heap:
        negc, a, b = heapq.heappop(heap)
        if pair_count.get((a, b), 0) != -negc:
            continue  # a stale entry: the pair's count moved since
        piece = pieces[a] + pieces[b]
        nid = index.get(piece)
        if nid is None:
            nid = index[piece] = len(pieces)
            pieces.append(piece)
            merged.append((pieces[a], pieces[b]))
        changed = set()
        for wi in where.pop((a, b)):
            seq, c = seqs[wi], counts[wi]
            out, i, n = [], 0, len(seq)
            while i < n:
                if i + 1 < n and seq[i] == a and seq[i + 1] == b:
                    out.append(nid)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            if len(out) == n:
                continue
            diff = Counter(zip(out, out[1:]))
            diff.subtract(zip(seq, seq[1:]))
            for p, d in diff.items():
                if d:
                    pair_count[p] += d * c
                    changed.add(p)
                    if d > 0:
                        where[p].add(wi)
            seqs[wi] = out
        pair_count.pop((a, b), None)
        for p in changed:
            if pair_count[p] > 0:
                heapq.heappush(heap, (-pair_count[p], *p))
    return merged


def write_hf_tokenizer(model_dir: str, merged: list[tuple[bytes, bytes]],
                       vocab_size: int) -> None:
    """An HF fast tokenizer in the Llama-3 layout into `model_dir`:
    `tokenizer.json` (byte-level BPE: the 256 bytes, the `merged` pieces,
    inert filler pieces up to the regular ids, then the 256 Llama-3 special
    tokens as added tokens) and `tokenizer_config.json` (bos, eos and
    write_tokenizer's chat template). HF scores are -id, so earlier merges
    win."""
    from dllama_tpu_torch.tools.convert_tokenizer import (
        LLAMA3_NAMED_SPECIALS,
        N_LLAMA3_SPECIALS,
        byte_decoder,
    )

    enc = {b: c for c, b in byte_decoder().items()}

    def alias(piece: bytes) -> str:
        return "".join(enc[b] for b in piece)

    n_regular = vocab_size - N_LLAMA3_SPECIALS
    vocab: dict[str, int] = {}
    for piece in [bytes([i]) for i in range(256)] + [a + b for a, b in merged]:
        vocab[alias(piece)] = len(vocab)
    merges = [f"{alias(a)} {alias(b)}" for a, b in merged]
    i = 0
    while len(vocab) < n_regular:
        filler = f"<f{i}>"
        i += 1
        if filler not in vocab:
            vocab[filler] = len(vocab)
    specials = LLAMA3_NAMED_SPECIALS + [f"<|reserved_special_token_{i}|>"
                                        for i in range(5, N_LLAMA3_SPECIALS - 5)]
    tok_json = {
        "version": "1.0",
        "added_tokens": [{"id": n_regular + j, "content": s, "special": True}
                         for j, s in enumerate(specials)],
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": BPE_SPLIT.pattern.decode()}},
            {"type": "ByteLevel", "add_prefix_space": False}]},
        "decoder": {"type": "ByteLevel"},
        "model": {"type": "BPE", "vocab": vocab, "merges": merges},
    }
    with open(os.path.join(model_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(tok_json, f, ensure_ascii=False)
    with open(os.path.join(model_dir, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump({"bos_token": "<|begin_of_text|>", "eos_token": "<|end_of_text|>",
                   "chat_template": SMOKE_CHAT_TEMPLATE}, f)


def llama31_8b_hf_config(n_layers: int) -> dict:
    """Llama-3.1-8B's published `config.json` (meta-llama/Llama-3.1-8B) with
    its depth cut to `n_layers`."""
    return {
        "architectures": ["LlamaForCausalLM"], "attention_bias": False,
        "attention_dropout": 0.0, "bos_token_id": 128000, "eos_token_id": 128001,
        "hidden_act": "silu", "hidden_size": 4096, "initializer_range": 0.02,
        "intermediate_size": 14336, "max_position_embeddings": 131072, "mlp_bias": False,
        "model_type": "llama", "num_attention_heads": 32, "num_hidden_layers": n_layers,
        "num_key_value_heads": 8, "pretraining_tp": 1, "rms_norm_eps": 1e-05,
        "rope_scaling": {"factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                         "original_max_position_embeddings": 8192, "rope_type": "llama3"},
        "rope_theta": 500000.0, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
        "use_cache": True, "vocab_size": 128256,
    }


def hf_tensor_shapes(hf: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of every tensor of an HF Llama checkpoint of `hf`."""
    dim, hidden, vocab = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    kv = dim * hf["num_key_value_heads"] // hf["num_attention_heads"]
    out = [("model.embed_tokens.weight", (vocab, dim))]
    for li in range(hf["num_hidden_layers"]):
        p = f"model.layers.{li}."
        out += [(p + "self_attn.q_proj.weight", (dim, dim)),
                (p + "self_attn.k_proj.weight", (kv, dim)),
                (p + "self_attn.v_proj.weight", (kv, dim)),
                (p + "self_attn.o_proj.weight", (dim, dim)),
                (p + "mlp.gate_proj.weight", (hidden, dim)),
                (p + "mlp.up_proj.weight", (hidden, dim)),
                (p + "mlp.down_proj.weight", (dim, hidden)),
                (p + "input_layernorm.weight", (dim,)),
                (p + "post_attention_layernorm.weight", (dim,))]
    return out + [("model.norm.weight", (dim,)), ("lm_head.weight", (vocab, dim))]


def write_safetensors(path: str, shapes: list, make) -> int:
    """A `.safetensors` file of BF16 tensors, in the format's own layout (an
    8-byte little-endian header length, the JSON header, then each tensor's
    raw little-endian bytes in order): `make(name, shape)` gives each
    tensor, bf16, when its turn comes. -> the bytes of data written."""
    import numpy as np
    import torch

    header, at = {"__metadata__": {"format": "pt"}}, 0
    for name, shape in shapes:
        n = 2 * int(np.prod(shape))
        header[name] = {"dtype": "BF16", "shape": list(shape), "data_offsets": [at, at + n]}
        at += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name, shape in shapes:
            t = make(name, shape)
            assert t.dtype == torch.bfloat16 and tuple(t.shape) == tuple(shape), name
            f.write(t.contiguous().view(torch.int16).cpu().numpy().data)
    return at


def write_hf_checkpoint(model_dir: str, hf: dict, device, seed: int = 0) -> int:
    """A BF16 HF checkpoint of `hf` into `model_dir` (`config.json`, two
    shards and their index), random from `seed` on the device. Each 32-wide
    block of a projection's input dim is codes -8..7 times one bf16 scale
    of write_model's range, with one code of the block at -8, so its Q40
    conversion is exactly those codes and that scale: the network
    write_model's recipe makes, as well conditioned (codes of mean about
    -s/2, not 0). The embedding is write_model's too; the norms are ones.
    -> the bytes of tensor data."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def make(name, shape):
        if len(shape) == 1:
            return torch.ones(shape, dtype=torch.bfloat16, device=device)
        if name == "model.embed_tokens.weight":
            return ((torch.rand(shape, generator=gen, device=device) - 0.5) * 0.04).to(
                torch.bfloat16)
        out, k = shape
        nb = k // 32
        codes = torch.randint(0, 16, (out, nb, 32), generator=gen, device=device,
                              dtype=torch.uint8)
        at = torch.randint(0, 32, (out, nb, 1), generator=gen, device=device)
        codes.scatter_(2, at, 0)  # a -8 in every block: the block's scale is exact
        scale = (torch.rand((out, nb, 1), generator=gen, device=device) * 0.02 + 1e-3).to(
            torch.bfloat16).float()
        return ((codes.float() - 8.0) * scale).to(torch.bfloat16).reshape(out, k)

    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(hf, f, indent=2)
    shapes = hf_tensor_shapes(hf)
    half = hf["num_hidden_layers"] // 2
    first = [s for s in shapes if s[0] == "model.embed_tokens.weight"
             or (s[0].startswith("model.layers.") and int(s[0].split(".")[2]) < half)]
    second = [s for s in shapes if s not in first]
    names = [f"model-0000{i}-of-00002.safetensors" for i in (1, 2)]
    total = 0
    weight_map = {}
    for fn, part in zip(names, (first, second)):
        total += write_safetensors(os.path.join(model_dir, fn), part, make)
        weight_map.update({name: fn for name, _ in part})
    with open(os.path.join(model_dir, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
    return total


@contextlib.contextmanager
def native_off():
    """The port as DLLAMA_NATIVE=0 leaves it: the numpy/Python paths."""
    from dllama_tpu_torch.utils import native

    saved, before = (native._lib, native._tried), os.environ.get("DLLAMA_NATIVE")
    os.environ["DLLAMA_NATIVE"] = "0"
    native._lib, native._tried = None, False
    try:
        yield
    finally:
        native._lib, native._tried = saved
        if before is None:
            os.environ.pop("DLLAMA_NATIVE", None)
        else:
            os.environ["DLLAMA_NATIVE"] = before


def _same_file(a: str, b: str, chunk: int = 64 << 20) -> bool:
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x = fa.read(chunk)
            if x != fb.read(chunk):
                return False
            if not x:
                return True


def _split_file(path: str, parts: list[str], chunk: int = 64 << 20) -> None:
    """`path`'s bytes cut into len(parts) files of nearly equal size."""
    size = os.path.getsize(path)
    per = -(-size // len(parts))
    with open(path, "rb") as f:
        for part in parts:
            left = min(per, size - f.tell())
            with open(part, "wb") as g:
                while left > 0:
                    buf = f.read(min(chunk, left))
                    g.write(buf)
                    left -= len(buf)


def _launched(counts: dict) -> dict:
    """The kernels of a path's counts that launched."""
    return {k: v for k, v in counts.items() if v}


def _timed(fn, reps: int = 3) -> tuple[float, object]:
    """Median host ms of `reps` calls of fn(), and its last result."""
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def tools_tokenizer(tmp: str, text: bytes) -> dict:
    """(b): learn the BPE pieces, write the HF tokenizer, convert it with
    `convert_tokenizer hf`, time encode. -> the numbers, and the `.t` path
    under "tpath"."""
    from dllama_tpu_torch.tokenizer.tokenizer import Tokenizer
    from dllama_tpu_torch.tools import convert_tokenizer

    t0 = time.perf_counter()
    merged = learn_bpe(text, TOOLS_MERGES)
    learn_s = time.perf_counter() - t0
    if len(merged) < TOOLS_MIN_MERGES:
        fail(f"tools: only {len(merged)} BPE pieces learned from {len(text)} bytes of the "
             f"repository's text (want >= {TOOLS_MIN_MERGES})")
    write_hf_tokenizer(tmp, merged, 128256)
    tpath = os.path.join(tmp, "tok.t")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = convert_tokenizer.main(["hf", tmp, "--output", tpath])
    convert_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"tools: convert_tokenizer hf failed: {out.getvalue()[-500:]}")
    tok = Tokenizer.load(tpath)
    if (len(tok.vocab), tok.bos_id, tok.eos_ids, tok.regular_vocab_size) != (
            128256, 128000, [128001, 128009], 128000):
        fail(f"tools: the converted tokenizer is not the Llama-3 layout: {len(tok.vocab)} ids, "
             f"bos {tok.bos_id}, eos {tok.eos_ids}, {tok.regular_vocab_size} regular")
    res = {"merged_pieces": len(merged), "learn_s": learn_s, "convert_s": convert_s,
           "tpath": tpath}
    src = text.decode("utf-8", "replace")
    for n in TOOLS_TOKENIZE_BYTES:
        prompt = src.encode()[:n].decode("utf-8", "ignore")
        ms, ids = _timed(lambda: tok.encode(prompt))
        res[f"native_ms_{n}"], res[f"tokens_{n}"] = ms, len(ids)
        if n == TOOLS_TOKENIZE_BYTES[0]:
            slow = Tokenizer.load(tpath)
            slow._native_tried = True  # the Python fallback
            res[f"fallback_ms_{n}"], fb = _timed(lambda: slow.encode(prompt), reps=1)
            if fb != ids:
                fail(f"tools: native and fallback ids differ at {n} bytes")
    if not tok._native:
        fail("tools: the tokenizer did not run the native BPE")
    return res


def tools_checkpoint(tmp: str, device) -> dict:
    """(c): write the 8B-wide BF16 checkpoint, convert it to Q40 with
    `convert_hf`, spot-check bytes against the numpy path, delete the
    safetensors. -> the numbers, and the `.m` path under "mpath"."""
    from dllama_tpu_torch.models import formats
    from dllama_tpu_torch.tools import convert_hf
    from dllama_tpu_torch.tools.converter_core import hf_tensor_for

    hf = llama31_8b_hf_config(MESH_LAYERS)
    t0 = time.perf_counter()
    data = write_hf_checkpoint(tmp, hf, device)
    write_s = time.perf_counter() - t0
    mpath = os.path.join(tmp, "llama31_8b_tools_q40.m")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = convert_hf.main([tmp, "q40", "--output", mpath])
    convert_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"tools: convert_hf failed: {out.getvalue()[-500:]}")
    cfg, hs = formats.read_header(mpath)
    want = llama31_8b(MESH_LAYERS)
    for f in ("dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size",
              "seq_len", "rope_theta", "rope_type", "rope_scaling_factor",
              "rope_scaling_low_freq_factor", "rope_scaling_high_freq_factor",
              "rope_scaling_orig_max_seq_len", "weight_type"):
        if getattr(cfg, f) != getattr(want, f):
            fail(f"tools: the converted header's {f} is {getattr(cfg, f)}, want "
                 f"{getattr(want, f)}")
    src = convert_hf.SafetensorsDir(tmp)
    at = {"first": 0, "middle": cfg.n_layers // 2, "last": cfg.n_layers - 1}
    spot = [f"layers.{at[which]}.{short}" for which, short in TOOLS_SPOT_CHECK]
    raws = {name: raw for name, _, _, raw in formats.iter_tensors(mpath, cfg, hs)
            if name in spot}
    t0 = time.perf_counter()
    with native_off():
        for name in spot:
            buf = io.BytesIO()
            formats.write_tensor(buf, hf_tensor_for(name, cfg, src.get), cfg.weight_type)
            if buf.getvalue() != raws[name].tobytes():
                fail(f"tools: {name}'s converted bytes differ from the DLLAMA_NATIVE=0 path's")
    spot_s = time.perf_counter() - t0
    src.close()
    del raws
    for fn in os.listdir(tmp):
        if fn.endswith(".safetensors"):
            os.remove(os.path.join(tmp, fn))
    return {"checkpoint_gb": data / 1e9, "write_s": write_s, "convert_s": convert_s,
            "file_gb": os.path.getsize(mpath) / 1e9, "spot_check_s": spot_s,
            "mpath": mpath, "describe": cfg.describe()}


def tools_launch(tmp: str, mpath: str, tpath: str) -> dict:
    """(d): the converted `.m` cut into two `file://` parts behind a zoo
    entry, `launch download` (the parts concatenated, the bytes equal),
    then `launch run --mode inference`'s command. -> the numbers, the
    downloaded files, and the printed command under "argv"."""
    from dllama_tpu_torch.tools import launch

    zoo, parts = os.path.join(tmp, "zoo"), []
    for suffix in launch._parts(2):
        parts.append(f"{mpath}.{suffix}")
    t0 = time.perf_counter()
    _split_file(mpath, parts)
    split_s = time.perf_counter() - t0
    entry = launch.ZooModel("smoke_llama31_8b_q40", tuple(f"file://{p}" for p in parts),
                            f"file://{tpath}", os.path.getsize(mpath) / 1e9)
    launch.MODELS[entry.name] = entry
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = launch.main(["download", entry.name, "--dir", zoo])
        download_s = time.perf_counter() - t0
        if rc != 0:
            fail(f"tools: launch download failed: {out.getvalue()[-500:]}")
        got = os.path.join(zoo, entry.model_file)
        if not _same_file(got, mpath) or not _same_file(
                os.path.join(zoo, entry.tokenizer_file), tpath):
            fail("tools: the downloaded files' bytes differ from the converted ones")
        with contextlib.redirect_stdout(io.StringIO()) as out:
            launch.main(["run", entry.name, "--dir", zoo, "--mode", "inference"])
        argv = out.getvalue().split()
    finally:
        del launch.MODELS[entry.name]
    for p in parts + [mpath]:
        os.remove(p)
    if argv[:4] != [sys.executable, "-m", "dllama_tpu_torch", "inference"]:
        fail(f"tools: launch run printed {' '.join(argv)}")
    return {"split_s": split_s, "download_s": download_s, "parts": len(parts), "argv": argv,
            "mpath": got, "tpath": os.path.join(zoo, entry.tokenizer_file)}


def tools_serve(mpath: str, tpath: str, device, system: str) -> tuple[dict, dict]:
    """(e): the CLI's `serve --slots 8 --warmup auto` on the converted
    files, in a thread of this process (its make_server noted, so its
    scheduler is read and its server stopped): one chat with the system
    prompt alone, then TOOLS_CHATS at once, greedy; the server's
    tokenization ms of the chat; every served id sequence against the
    single engine's greedy replay of its prompt (near_tie). -> (numbers,
    launch counts of the chats)."""
    import types

    from dllama_tpu_torch.cli.main import main as cli
    from dllama_tpu_torch.engine.sampling import Sampler
    from dllama_tpu_torch.serve import api as api_mod

    made: dict = {}
    make_server = api_mod.make_server

    def noted(*a, **kw):
        made["httpd"], made["api"] = out = make_server(*a, **kw)
        return out

    port = _free_port()
    argv = ["serve", "--model", mpath, "--tokenizer", tpath, "--slots", "8", "--warmup",
            "auto", "--port", str(port), "--max-seq-len", "4096", "--no-mesh",
            "--device", device.type]
    api_mod.make_server = noted
    th = threading.Thread(target=lambda: made.setdefault("rc", cli(argv)), name="tools-serve",
                          daemon=True)
    t0 = time.perf_counter()
    th.start()

    def up() -> bool:
        if not th.is_alive() or time.perf_counter() - t0 > 600:
            fail(f"tools: serve did not come up (rc {made.get('rc')})")
        try:
            return "httpd" in made and _get_json(port, "/health")[0] == 200
        except OSError:  # not listening yet
            return False

    try:
        while not up():
            time.sleep(0.25)
    finally:
        api_mod.make_server = make_server
    boot_s = time.perf_counter() - t0
    api = made["api"]
    if api.build_info["kv_layout"] != "paged":
        fail(f"tools: serve --slots 8 resolved the {api.build_info['kv_layout']} layout")
    res: dict = {"boot_s": boot_s,
                 "captures": (api.scheduler.warmup_report or {}).get("graphs_captured")}
    idtrace = IdTrace(api.scheduler)

    def chat(i):
        return {"messages": [{"role": "system", "content": system},
                             {"role": "user", "content": f"Question {i}: what does the "
                              f"section above say about the port?"}],
                "max_tokens": TOOLS_TOKENS, "temperature": 0}

    msgs = [(m["role"], m["content"]) for m in chat(0)["messages"]]
    res["tokenize_ms"], ptoks = _timed(lambda: api._encode_chat(msgs, add_bos=True))
    res["prompt_tokens"] = len(ptoks)
    try:
        reset_counters()
        st, raw, sent = _post_timed(port, chat(0))
        alone_ms = (time.perf_counter() - sent) * 1e3
        if st != 200:
            fail(f"tools: serve answered {st}: {raw[:300]!r}")
        res["ttft_ms_alone"] = json.loads(raw)["timings"]["ttft_ms"]
        res["e2e_ms_alone"] = alone_ms
        resps = _concurrently(lambda i: _post_timed(port, chat(i)),
                              [(i,) for i in range(1, TOOLS_CHATS + 1)])
        launches = counters()
    finally:
        made["httpd"].shutdown()
        th.join(timeout=120)
    if th.is_alive() or made.get("rc") != 0:
        fail(f"tools: serve did not stop cleanly (rc {made.get('rc')})")
    bad = [st for st, _, _ in resps if st != 200]
    if bad:
        fail(f"tools: {len(bad)} of {TOOLS_CHATS} chats failed: {bad}")
    ttfts = sorted(json.loads(raw)["timings"]["ttft_ms"] for _, raw, _ in resps)
    res["ttft_ms_p50"], res["ttft_ms_max"] = statistics.median(ttfts), ttfts[-1]
    eng = api.engine
    single = types.SimpleNamespace(engine=eng)
    ties = []
    for req_id, (prompt, ids) in idtrace.runs.items():
        eng.reset(0)
        ref = list(eng.generate(prompt, len(ids), Sampler(0.0, 0.9, 1)))
        eng.reset(0)
        msg = near_tie(single, prompt, ids, ref[:len(ids)], f"tools serve {req_id}")
        if msg:
            ties.append(msg)
    if len(idtrace.runs) != TOOLS_CHATS + 1:
        fail(f"tools: {len(idtrace.runs)} traced requests, want {TOOLS_CHATS + 1}")
    res["ids_equal"] = len(idtrace.runs) - len(ties)
    res["near_ties"] = len(ties)
    made.clear()
    return res, launches


def phase_tools(device, native_s: float | None) -> dict:
    """The tools on the card: (a) the native host library, (b) an HF
    Llama-3 tokenizer of 128,256 ids with BPE pieces learned from the
    repository's text, converted and timed, (c) an HF checkpoint of
    Llama-3.1-8B's widths at MESH_LAYERS layers converted to Q40, (d) the
    zoo launcher's download and `inference` command, (e) the CLI's serve on
    the converted files, (f) the chaos drill on them. -> launch counts by
    path ("tools-inference", "tools-serve", "tools-chaos"). `native_s`: the
    seconds the card phase took to build the native library (None: it was
    built already)."""
    import gc
    import logging

    import torch

    from dllama_tpu_torch.experiments import chaos
    from dllama_tpu_torch.utils import native

    card = card_line()
    if not native.available():
        fail("tools: the native host library did not build or load")
    print(f"tools (a): native library {native.library_path().name} loaded; "
          f"{'it was built already' if native_s is None else f'built in {native_s:.2f} s'} "
          f"[{card}]", flush=True)

    paths: dict[str, dict] = {}
    with tempfile.TemporaryDirectory(prefix="dllama_smoke_tools_") as tmp:
        text = repo_text()
        tk = tools_tokenizer(tmp, text)
        print(f"tools (b): {tk['merged_pieces']} BPE pieces learned from {len(text)} bytes in "
              f"{tk['learn_s']:.2f} s; convert_tokenizer hf {tk['convert_s']:.2f} s; encode ms "
              f"native " + ", ".join(f"{n} B {tk[f'native_ms_{n}']:.2f} ({tk[f'tokens_{n}']} "
                                     f"tokens)" for n in TOOLS_TOKENIZE_BYTES)
              + f"; Python fallback {TOOLS_TOKENIZE_BYTES[0]} B "
              f"{tk[f'fallback_ms_{TOOLS_TOKENIZE_BYTES[0]}']:.1f}, ids equal [{card}]",
              flush=True)
        ck = tools_checkpoint(tmp, device)
        print(f"tools (c): {ck['describe']}: BF16 checkpoint {ck['checkpoint_gb']:.2f} GB "
              f"written in {ck['write_s']:.1f} s; convert_hf q40 {ck['convert_s']:.1f} s -> "
              f"{ck['file_gb']:.2f} GB; {len(TOOLS_SPOT_CHECK)} tensors byte-equal to the "
              f"DLLAMA_NATIVE=0 path ({ck['spot_check_s']:.1f} s) [{card}]", flush=True)
        ln = tools_launch(tmp, ck["mpath"], tk["tpath"])
        print(f"tools (d): split into {ln['parts']} file:// parts in {ln['split_s']:.1f} s, "
              f"launch download {ln['download_s']:.1f} s, bytes equal; launch run: "
              f"{' '.join(ln['argv'][1:])}", flush=True)
        prompt = text.decode("utf-8", "replace")[:600]
        reset_counters()
        rc, out, stats = _cli(ln["argv"][3:] + ["--prompt", prompt, "--steps", str(TOOLS_STEPS),
                                                 "--temperature", "0", "--device", device.type])
        paths["tools-inference"] = counters()
        if rc != 0 or min(paths["tools-inference"][k] for k in SERVE_KERNELS) == 0:
            fail(f"tools: the launcher's inference failed or skipped a kernel: rc {rc}, "
                 f"{paths['tools-inference']}")
        print(f"tools (d): {' | '.join(stats)}; launches {_launched(paths['tools-inference'])}",
              flush=True)

        system = text.decode("utf-8", "replace").encode()[
            len(text) // 2:len(text) // 2 + TOOLS_SYSTEM_BYTES].decode("utf-8", "ignore")
        sv, paths["tools-serve"] = tools_serve(ln["mpath"], ln["tpath"], device, system)
        if min(paths["tools-serve"][k] for k in ("q40_decode", "q40_prefill",
                                                  "paged_attention")) == 0:
            fail(f"tools: serve skipped K1, K2 or K9: {paths['tools-serve']}")
        print(f"tools (e): serve --slots 8 --warmup auto up in {sv['boot_s']:.1f} s "
              f"({sv['captures']} captures); a {TOOLS_SYSTEM_BYTES}-byte system prompt, "
              f"{sv['prompt_tokens']} tokens, tokenized by the server in "
              f"{sv['tokenize_ms']:.2f} ms; TTFT alone {sv['ttft_ms_alone']:.1f} ms (e2e "
              f"{sv['e2e_ms_alone']:.1f}), {TOOLS_CHATS} at once p50 {sv['ttft_ms_p50']:.1f} / "
              f"max {sv['ttft_ms_max']:.1f} ms; greedy ids equal the single engine's on "
              f"{sv['ids_equal']}, near ties {sv['near_ties']}; launches "
              f"{_launched(paths['tools-serve'])} [{card}]", flush=True)
        gc.collect()

        # every injected fault logs a warning or a traceback (the serve CLI
        # set logging up); the drill's report holds what it found
        log = logging.getLogger("dllama_tpu_torch")
        level = log.level
        log.setLevel(logging.CRITICAL)
        reset_counters()
        try:
            rep = chaos.run_chaos(n_requests=TOOLS_CHAOS_REQUESTS, seed=0, n_slots=8,
                                  kv_pages=32, page_size=8, kv_host_pages=16, clients=4,
                                  device=device, model=ln["mpath"], max_seq_len=4096)
        finally:
            log.setLevel(level)
        paths["tools-chaos"] = counters()
        if not rep["ok"] or rep["pages_leaked"]:
            fail(f"tools: the chaos drill failed: {rep['problems']}")
        rc_ = rep["reconcile"]
        print(f"tools (f): chaos {TOOLS_CHAOS_REQUESTS} requests on 8 paged slots: "
              f"{rep['faults_injected']} faults, {rc_['restarts']:.0f} restarts, "
              f"{rc_['recovered']:.0f} recovered, finishes {rep['finish_reasons']}, "
              f"leaked {rep['pages_leaked']}, spec {rep['spec']}, host {rep.get('host')}, "
              f"{rep['elapsed_s']} s; launches {_launched(paths['tools-chaos'])} [{card}]",
              flush=True)
    torch.cuda.empty_cache()
    return paths


#: analysis phase: the streams the audit-armed server serves, and their tokens
AUDIT_STREAMS = 8
AUDIT_TOKENS = 32


def audit_child(mpath: str, tpath: str, device: str = "cuda:0") -> int:
    """The analysis phase's runtime half, in a process started with
    DLLAMA_LOCK_AUDIT=1, so that every named lock it makes is audited:
    make_server with 8 slots and --warmup auto (what `serve --slots 8
    --warmup auto` runs) serves AUDIT_STREAMS concurrent chats (greedy,
    sampled, penalized). Prints one JSON line: the LockOrderErrors raised
    (every audited acquisition is counted), the capture ledger's functions
    and its captures after the warm-up, whether every device_state() tensor
    kept its address from the warm-up to the end, the page pool's lock, the
    kernels' launches while serving, and the responses."""
    import torch

    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.obs import compile as compile_obs
    from dllama_tpu_torch.serve.api import graceful_drain, make_server
    from dllama_tpu_torch.utils import locks

    if not locks.armed():
        print(json.dumps({"error": "DLLAMA_LOCK_AUDIT is not armed"}))
        return 1
    errors, acquisitions = [], [0]
    check = locks.AuditedLock._check

    def counted(lock, site):  # counts every audited acquisition, keeps its verdict
        acquisitions[0] += 1
        try:
            check(lock, site)
        except locks.LockOrderError as e:
            errors.append(str(e))
            raise

    locks.AuditedLock._check = counted
    loaded = load_model(mpath, tpath, max_seq_len=4096, mesh=None, device=torch.device(device))
    t0 = time.perf_counter()
    httpd, api = make_server(loaded, host="127.0.0.1", port=0, n_slots=8, warmup="auto")
    boot_s = time.perf_counter() - t0
    eng = api.scheduler.engine
    mu = eng.pool._mu
    warm = compile_obs.LEDGER.total_compiles()
    before = {k: t.data_ptr() for k, t in eng.device_state().items()}
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    bodies = [{"messages": [{"role": "user", "content": p}], "temperature": 0,
               "max_tokens": AUDIT_TOKENS} for p in batch_prompts(AUDIT_STREAMS)]
    bodies[1].update(temperature=0.8, top_p=0.9, seed=7)
    bodies[2].update(temperature=0.8, seed=9, frequency_penalty=0.5, presence_penalty=0.3)
    try:
        reset_counters()
        t0 = time.perf_counter()
        replies = _concurrently(_post, [(port, b) for b in bodies])
        serve_s = time.perf_counter() - t0
        launches = counters()
    finally:
        clean = graceful_drain(httpd, api, timeout_s=120)
        httpd.server_close()
    after = {k: t.data_ptr() for k, t in eng.device_state().items()}
    ledger = compile_obs.LEDGER.snapshot(entries=256)
    tokens = [json.loads(raw)["usage"]["completion_tokens"] if st == 200 else None
              for st, raw in replies]
    print(json.dumps({
        "lock_order_errors": errors, "audited_acquisitions": acquisitions[0],
        "pool_lock": {"audited": isinstance(mu, locks.AuditedLock),
                      "name": getattr(mu, "name", None), "rank": getattr(mu, "rank", None),
                      "reentrant": getattr(mu, "reentrant", None)},
        "captures_warmup": warm, "captures_after_warmup": ledger["compiles"] - warm,
        "ledger_fns": sorted({e["fn"] for e in ledger["entries"]}),
        "off_catalog_fns": sorted({e["fn"] for e in ledger["entries"]}
                                  - set(compile_obs.COMPILE_FNS)),
        "device_state": len(before), "moved": sorted(k for k in before
                                                     if after.get(k) != before[k]),
        "new_state": sorted(set(after) - set(before)),
        "statuses": [st for st, _ in replies], "tokens": tokens, "drained": clean,
        "launches": launches, "boot_s": round(boot_s, 3), "serve_s": round(serve_s, 3)}))
    return 0


def phase_analysis(mpath: str, tpath: str) -> dict:
    """(a) `python -m dllama_tpu_torch.analysis --json` on this checkout in a
    child process: no finding, and neither torch nor jax loaded; (b) the
    seeded-violation drill (dllama_tpu_torch.analysis.smoke); (c)
    audit_child in a process with DLLAMA_LOCK_AUDIT=1: no LockOrderError,
    only COMPILE_FNS labels, no capture after the warm-up, every
    device_state() tensor at its address; and the static lock graph's edge
    count beside it. Returns the child's launch counts."""
    from dllama_tpu_torch.analysis import smoke
    from dllama_tpu_torch.analysis.core import Project
    from dllama_tpu_torch.analysis.rules_locks import build_graph

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "dllama_tpu_torch.analysis", "--json"],
                         cwd=root, capture_output=True, text=True, timeout=120)
    wall = time.perf_counter() - t0
    try:
        doc = json.loads(out.stdout)
    except ValueError:
        fail(f"analysis: the analyzer printed no JSON (exit {out.returncode}): "
             f"{(out.stdout + out.stderr)[-2000:]}")
    print(f"analysis (a): {doc['count']} finding(s) over {doc['files']} files, {doc['rules']} "
          f"rules, {doc['seconds']} s inside the analyzer ({wall:.2f} s with the interpreter); "
          f"the child loaded {doc['loaded']} of torch, jax, dllama_tpu", flush=True)
    for d in doc["findings"]:
        print(f"  {d['path']}:{d['line']}: {d['rule']} {d['message']}")
    if out.returncode != 0 or doc["count"] != 0 or doc["loaded"] != []:
        fail(f"analysis (a): exit {out.returncode}, {doc['count']} finding(s), loaded "
             f"{doc['loaded']}")
    drill = smoke.drill(root)
    print(f"analysis (b): pristine copy exit {drill['pristine_rc']} with "
          f"{drill['pristine_findings']} finding(s); seeded copy exit {drill['seeded_rc']}, "
          f"reported {drill['reported']} ({drill['seconds']} s)", flush=True)
    if not drill["ok"]:
        fail(f"analysis (b): the drill failed: {drill}")
    edges = build_graph(Project.from_disk(root))[0]
    env = dict(os.environ, DLLAMA_LOCK_AUDIT="1")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", "import sys, chip_smoke; "
                          f"sys.exit(chip_smoke.audit_child({mpath!r}, {tpath!r}))"],
                         cwd=root, env=env, capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    try:
        rep = json.loads(lines[-1])
    except (ValueError, IndexError):
        fail(f"analysis (c): the audit-armed child failed (exit {out.returncode}): "
             f"{(out.stdout + out.stderr)[-3000:]}")
    print(f"analysis (c): DLLAMA_LOCK_AUDIT=1 child, {child_s:.1f} s (boot with --warmup auto "
          f"{rep.get('boot_s')} s, {AUDIT_STREAMS} streams {rep.get('serve_s')} s): "
          f"{len(rep.get('lock_order_errors', []))} LockOrderError in "
          f"{rep.get('audited_acquisitions')} audited acquisitions; pool lock "
          f"{rep.get('pool_lock')}; {rep.get('captures_warmup')} captures in the warm-up, "
          f"{rep.get('captures_after_warmup')} after, ledger fns {rep.get('ledger_fns')}; "
          f"{rep.get('device_state')} device_state() tensors, moved {rep.get('moved')}; "
          f"tokens {rep.get('tokens')}; launches "
          f"{ {k: v for k, v in (rep.get('launches') or {}).items() if v} }; static lock "
          f"graph: {len(edges)} edges ({len(set(edges))} distinct)", flush=True)
    pool = rep.get("pool_lock", {})
    problems = [
        out.returncode != 0 and f"exit {out.returncode}",
        rep.get("lock_order_errors") and f"LockOrderError {rep['lock_order_errors'][:2]}",
        not rep.get("audited_acquisitions") and "no audited acquisition",
        (pool.get("audited"), pool.get("name"), pool.get("rank"), pool.get("reentrant"))
        != (True, "engine.pool", 20, True) and f"pool lock {pool}",
        rep.get("off_catalog_fns") and f"ledger fns outside COMPILE_FNS {rep['off_catalog_fns']}",
        not rep.get("captures_warmup") and "the warm-up captured nothing",
        rep.get("captures_after_warmup") != 0
        and f"{rep.get('captures_after_warmup')} capture(s) after the warm-up",
        (rep.get("moved") or rep.get("new_state")) and
        f"device_state() tensors moved {rep.get('moved')} or appeared {rep.get('new_state')}",
        rep.get("statuses") != [200] * AUDIT_STREAMS and f"statuses {rep.get('statuses')}",
        any(not t for t in rep.get("tokens") or [None]) and f"tokens {rep.get('tokens')}",
        not rep.get("drained") and "the server did not drain clean",
    ]
    problems = [p for p in problems if p]
    if problems:
        fail(f"analysis (c): {'; '.join(problems)}; stderr {out.stderr[-1500:]}")
    for k in ("q40_decode", "q40_prefill", "paged_attention"):
        if not rep["launches"].get(k):
            fail(f"analysis (c): {k} was never launched while the audit-armed server served")
    return rep["launches"]


def _launch_tables():
    from dllama_tpu_torch.experiments import kbench
    from dllama_tpu_torch.ops import (
        flash_attention,
        paged_attention,
        q40_matmul,
        q80_matmul,
        rms_norm,
    )

    return (q40_matmul.LAUNCHES, q80_matmul.LAUNCHES, flash_attention.LAUNCHES,
            paged_attention.LAUNCHES, rms_norm.LAUNCHES, kbench.LAUNCHES)


def counters() -> dict:
    out = {}
    for d in _launch_tables():
        out.update(d)
    return out


def reset_counters() -> None:
    for d in _launch_tables():
        for k in d:
            d[k] = 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20, help="timed runs per case (0: no timing)")
    ap.add_argument("--phases",
                    default="card,kernels,golden,kbench,forward,serve,batch,hybrid,radix,obs,"
                            "supervision,router,inference,styles,spec,spec_batch,graphs,"
                            "dequantize,mesh,mesh_dp_sp,mesh_pp_ep,mesh_supervision,f8,q80,"
                            "moe,tools,analysis",
                    help="comma list; not in the default: 'profile' adds a "
                         "torch.profiler pass over one decode chunk, single-stream "
                         "and 8-slot; 'chunk' is the prefill-chunk timing alone (Q40 "
                         "dense and paged, uncaptured and as programs; Q80)")
    ap.add_argument("--deadline-s", type=float, default=1150.0,
                    help="after this many seconds, print every thread's stack and exit 1 "
                         "(the run must end within its 1200 s limit, hung or not)")
    args = ap.parse_args(argv)
    faulthandler.dump_traceback_later(args.deadline_s, exit=True)
    phases = set(args.phases.split(","))

    try:
        import torch

        import dllama_tpu_torch  # noqa: F401  (run from the repository root)
        from dllama_tpu_torch.ops import build
        from dllama_tpu_torch.parallel import multihost
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the repository root")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    logs = build.build(ptxas_info=True)
    print(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(sorted(logs)) or 'cached'})",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "arning" in line:
                print(f"  ptxas {name}: {line.strip()}")
    # the host library (BPE encode, Q40/Q80 quantize), built by the host
    # compiler before any phase encodes a prompt
    from dllama_tpu_torch.utils import native

    cached = native.library_path().exists()
    t0 = time.perf_counter()
    try:
        native.build()
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        fail(f"the native host library did not build: {e}")
    native_s = None if cached else time.perf_counter() - t0
    print(f"native: {native.library_path().name} "
          f"{'cached' if cached else f'built in {native_s:.2f} s'}", flush=True)
    phase_done("card")

    cfg = llama31_8b(N_LAYERS_8B)
    timer = Timer(device, args.reps)
    results = {}
    if "kernels" in phases:
        print("phase kernels (8B shapes, stacked layer 1, bf16 in, f32 compared):", flush=True)
        results = phase_kernels(cfg, device, timer)
        results.update(style_cases(cfg, device, timer))
        results.update(kbench_cases(cfg, device, timer))
        kbench_shape_checks()
        phase_edges(device)
        edges_slice4(device)
        edges_styles(device)
        edges_k11(device)
    phase_done("kernels", phases)

    paths: dict[str, dict] = {}  # launch counts of each path, read just after it
    if "golden" in phases:
        paths["golden"] = phase_golden(device)
    phase_done("golden", phases)
    if "kbench" in phases:
        paths["kbench"] = phase_kbench()
    phase_done("kbench", phases)
    prompt = ("Summarize the plot of a long story about a lighthouse keeper, "
              "a storm, and a ship that never arrives.")
    if phases & {"forward", "chunk", "serve", "profile", "batch", "hybrid", "radix", "obs",
                  "supervision", "router", "inference", "styles", "spec", "spec_batch",
                  "graphs", "dequantize", "mesh", "mesh_dp_sp", "mesh_pp_ep",
                  "mesh_supervision", "f8", "analysis"}:
        from dllama_tpu_torch.engine.loader import load_model

        tmp = tempfile.TemporaryDirectory(prefix="dllama_smoke_")
        mpath, tpath = os.path.join(tmp.name, "llama31_8b_q40.m"), os.path.join(tmp.name, "tok.t")
        t0 = time.perf_counter()
        write_model(mpath, cfg, device)
        write_tokenizer(tpath, cfg.vocab_size)
        print(f"wrote synthetic {cfg.describe()} ({os.path.getsize(mpath) / 1e9:.2f} GB) "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        loaded = load_model(mpath, tpath, max_seq_len=4096, mesh=None, device=device)
        print(f"load_model: {time.perf_counter() - t0:.1f} s; kernels={loaded.engine.backend} "
              f"attention={loaded.engine.attn_route}", flush=True)
        phase_done("model")

        if "forward" in phases:
            check_forward(loaded, device, "forward")
        if phases & {"forward", "chunk"}:
            report_chunk("Q40 dense (K2 + K7)", prefill_chunk_ms(loaded, device))
            report_chunk("Q40 paged, page 128 (K2 + K9)",
                         prefill_chunk_ms(loaded, device, page=128))
            prefill_programs(loaded)
        phase_done("forward", phases)

        if "serve" in phases:
            launches = serve_checked(loaded, prompt, "serve", Q40_KERNELS,
                                     7 * cfg.n_layers + 1, "flash_attention")
            for k in SERVE_KERNELS:
                if launches[k] == 0:
                    fail(f"serve: kernel {k} was never launched on the single-engine path")
            paths["serve"] = launches
        phase_done("serve", phases)

        if "profile" in phases:
            prof = phase_profile(loaded, loaded.tokenizer.encode(prompt))
            print(f"profile: {prof['wall_ms_per_token']:.3f} ms/token wall, "
                  f"{prof['device_ms_per_token']:.3f} ms/token device time, busy share "
                  f"{prof['device_busy_share']}; {prof['device_ops_per_step']:.1f} device ops, "
                  f"K1 {prof['q40_ms_per_step']:.3f} ms in {prof['q40_launches_per_step']:.1f} "
                  f"launches, {prof['splitk_reduce_per_step']:.1f} splitk_reduce a token",
                  flush=True)
            for key, count, ms in prof["top"]:
                print(f"  {ms:9.4f} ms/token  x{count:<6d} {key}")
            bprof = phase_profile_batch(loaded)
            print(f"profile batch: {bprof['slots']} slots, {bprof['wall_ms_per_step']:.3f} ms/step "
                  f"wall, {bprof['device_ms_per_step']:.3f} ms/step device time, busy share "
                  f"{bprof['device_busy_share']}, {bprof['agg_tok_s']:.1f} tok/s; without the "
                  f"profiler {bprof['unprofiled_ms_per_step']:.3f} ms/step, "
                  f"{bprof['unprofiled_agg_tok_s']:.1f} tok/s; {bprof['device_ops_per_step']:.1f} "
                  f"device ops, K1 {bprof['q40_ms_per_step']:.3f} ms in "
                  f"{bprof['q40_launches_per_step']:.1f} launches, "
                  f"{bprof['splitk_reduce_per_step']:.1f} splitk_reduce a step", flush=True)
            for key, ms in bprof["top"]:
                print(f"  {ms:9.4f} ms/step  {key}")
            from dllama_tpu_torch.ops import q40_matmul

            # the decode body makes one launch a call (an earlier checkout of the
            # package, timed with this script for comparison, still has a second pass)
            if hasattr(q40_matmul, "decode_geometry") and (
                    prof["splitk_reduce_per_step"] or bprof["splitk_reduce_per_step"]):
                fail("profile: splitk_reduce ran on the Q40 decode path")
            for style, names in STYLE_NAMES.items():  # K3 and K4 in every decode matmul
                with q40_matmul.forced_style(style):
                    sp = phase_profile(loaded, loaded.tokenizer.encode(prompt), names=names)
                print(f"profile STYLE={style}: {sp['wall_ms_per_token']:.3f} ms/token wall, "
                      f"{sp['device_ms_per_token']:.3f} ms/token device time; "
                      f"{sp['device_ops_per_step']:.1f} device ops, {STYLE_KERNELS[style]} "
                      f"{sp['q40_ms_per_step']:.3f} ms in {sp['q40_launches_per_step']:.1f} "
                      f"launches, {sp['splitk_reduce_per_step']:.1f} splitk_reduce a token",
                      flush=True)
                # this tree's K3 and K4 make one launch a call (an earlier checkout
                # of the package, timed with this script, may not)
                if hasattr(q40_matmul, "loopdot_geometry") and (
                        sp["splitk_reduce_per_step"] or not sp["q40_launches_per_step"]):
                    fail(f"profile STYLE={style}: no {STYLE_KERNELS[style]} launch, or a "
                         "splitk_reduce pass")
        phase_done("profile", phases)

        if "batch" in phases:
            batch = phase_batch(loaded)
            paths["batch"] = batch.pop("launches")
            print(f"batch: {batch}; launches {paths['batch']}", flush=True)
            print(f"batch: aggregate decode {batch['agg_decode_tok_s']:.1f} tok/s over "
                  f"{batch['slots']} slots ({batch['decode_tokens']} decode tokens in "
                  f"{batch['decode_window_s']:.3f} s); live slots per decode chunk "
                  f"{batch['decode_slots_mean'][0]:.2f} and {batch['decode_slots_mean'][1]:.2f} "
                  f"in rounds 1 and 2; TTFT p50 {batch['ttft_ms_p50']:.1f} ms, max "
                  f"{batch['ttft_ms_max']:.1f} ms", flush=True)
        phase_done("batch", phases)

        if "hybrid" in phases:
            paths["hybrid"] = phase_hybrid(loaded)
        phase_done("hybrid", phases)

        if "radix" in phases:
            paths["radix"] = phase_radix(loaded)
        phase_done("radix", phases)

        if "obs" in phases:
            paths["obs"] = phase_obs(loaded, card)
        phase_done("obs", phases)

        if "supervision" in phases:
            paths["supervision"] = phase_supervision(loaded, tmp.name)
            print(f"supervision: launches {paths['supervision']}", flush=True)
        phase_done("supervision", phases)

        if "router" in phases:
            phase_router(loaded, mpath, tpath)
            # its kernels ran in the replicas' own processes, whose counters
            # this process cannot read: null in launches_by_path
            paths["router"] = dict.fromkeys(counters())
            print("router: the K1/K2/K9 launches of this path ran in the two CLI replica "
                  "processes and are not counted here (launches_by_path null)", flush=True)
        phase_done("router", phases)

        auto_text = None  # the greedy CLI text under STYLE auto, for the styles phase
        if "inference" in phases:
            reset_counters()
            rc, auto_text, stats = _cli(inference_argv(mpath, tpath, prompt))
            inf_launches = counters()
            print(f"inference: rc {rc}; {' | '.join(stats)}; launches {inf_launches}",
                  flush=True)
            if rc != 0 or min(inf_launches[k] for k in SERVE_KERNELS) == 0:
                fail("inference: the CLI failed or skipped a kernel")
        phase_done("inference")

        if "styles" in phases:
            for style, launches in phase_styles(loaded, device, mpath, tpath, prompt,
                                                auto_text).items():
                paths[f"styles-{style}"] = launches
        phase_done("styles", phases)

        if "spec" in phases:
            paths["spec"] = phase_spec(loaded, mpath, tpath)
        phase_done("spec", phases)

        if "spec_batch" in phases:
            paths["spec_batch"] = phase_spec_batch(loaded)
        phase_done("spec_batch", phases)

        if "graphs" in phases:
            paths["graphs"] = phase_graphs(loaded, mpath, tpath, prompt)["launches"]
        phase_done("graphs", phases)
        if "dequantize" in phases:
            paths["dequantize"] = phase_dequantize(loaded, device, mpath, tpath, prompt)
        phase_done("dequantize", phases)
        if "analysis" in phases:
            paths["analysis"] = phase_analysis(mpath, tpath)
        phase_done("analysis", phases)
        if phases & {"mesh", "mesh_dp_sp", "mesh_pp_ep", "mesh_supervision"}:
            # the mesh worlds (here and at the end of moe) come one after
            # another: each finds its followers' processes started ahead,
            # torch imported (seconds a process on the card's host)
            multihost.keep_warm(3)
            mloaded, mesh_path = mesh_model(tmp.name, tpath, device)
            for name, fn in (("mesh", phase_mesh), ("mesh_dp_sp", phase_mesh_dp_sp),
                             ("mesh_pp_ep", phase_mesh_pp_ep),
                             ("mesh_supervision", phase_mesh_supervision)):
                if name in phases:
                    paths[name] = fn(mloaded, mesh_path, tpath, device, prompt)
                phase_done(name, phases)
            del mloaded
            os.remove(mesh_path)
        del loaded
        torch.cuda.empty_cache()
        if "f8" in phases:
            paths["f8"] = phase_f8(mpath, tpath, device, prompt)
        phase_done("f8", phases)
        tmp.cleanup()  # the Q40 model and its files go before the Q80 ones come

    if "q80" in phases:
        paths["q80"] = phase_q80(device, prompt)
    elif "chunk" in phases:  # the Q80 chunk alone
        with tempfile.TemporaryDirectory(prefix="dllama_smoke_q80_") as tmp:
            loaded, _, _ = q80_model(tmp, device)
            report_chunk("Q80 dense (K6 + K7)", prefill_chunk_ms(loaded, device))
            del loaded
        torch.cuda.empty_cache()
    phase_done("q80", phases)

    if "moe" in phases:
        paths["moe"] = phase_moe(device, prompt, mesh=phases & {"mesh", "mesh_pp_ep"})
    multihost.keep_warm(0)
    phase_done("moe", phases)

    if "tools" in phases:
        paths.update(phase_tools(device, native_s))
    phase_done("tools", phases)

    if results:
        line = []
        for name, cases in results.items():
            rep, source, replaces, path = KERNEL_ROWS[name]
            c = next(c for c in cases if c["case"] == rep)
            by_path = {p: counts[name] for p, counts in paths.items()}
            line.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": by_path.get(path, 0 if path is None else None),
                "launches_by_path": by_path, "main_path": path,
                "max_abs_err": max(x["max_abs_err"] for x in cases),
                "ms": _r(c["ms"]), "plain_ms": _r(c["plain_ms"]),
                "bound_ms": _r(c["bound_ms"]), "bound_by": c["bound_by"],
                "library_ms": _r(c["library_ms"]), "case": c["case"]})
        print(json.dumps({"kernels": line}))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
