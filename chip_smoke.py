#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`dllama_tpu_torch`) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives the port's main paths at the full width of Llama-3.1-8B, Q40 and
Q80 (random weights from a seed), and exits 0 only if every phase passed:

1. card       the card's name and power limit (nvidia-smi), then the CUDA
              kernels built from dllama_tpu_torch/ops/csrc, one nvcc per
              source, all at once.
2. kernels    every kernel's wrapper against its plain PyTorch version on the
              card at the 8B shapes of the main path, each error beside its
              stated tolerance; CUDA-event medians of the kernel, the plain
              version and a one-call PyTorch yardstick (never used by the
              port), with the L2 cache flushed before every timed run, and
              the bound max(bytes / HBM rate, operations / bf16 tensor rate).
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
              through one slot's table (K2 + K9).
4. serve      make_server (the function `serve` runs) over real HTTP on the
              single-engine tier: a greedy chat completion, the same again
              (identical content), an SSE stream, and a second turn that hits
              the prefix cache.
5. batch      make_server with 8 slots (`serve --slots 8`): the auto KV layout
              must be paged at page 128; 8 concurrent greedy chat requests,
              the same 8 again (identical contents), an SSE stream; every
              batched forward launches the paged attention kernel in every
              layer and the Q40 kernels, no dense flash attention; after the
              drain the page pool audits clean with every page free.
6. inference  the CLI's `inference` mode on the same files.
7. f8         the same Q40 file loaded with the f8 (e4m3) KV cache: the
              forward against the plain versions and HTTP serve, K7's f8 mode
              in every layer of every forward.
8. q80        after the Q40 files are gone, a synthetic 8B Q80 `.m` loaded
              packed: the forward against the plain versions, the prefill
              chunk's device time (K6 + K7) as in `forward`, HTTP serve on
              the single-engine tier, the 8-slot batched server with the
              RMSNorm switch at 'cuda' (K10), and the CLI's `inference
              --fuse-weights`, whose greedy text must equal the unfused
              engine's; Q80 kernels on every forward and no Q40 launch.
9. kbench     the kernel benchmark (dllama_tpu_torch.experiments.kbench):
              `suite`, then `8 w1 B D`; no FAILED row, KBENCH DONE at the end;
              its kernels K11-B/K11-D launched.
10. styles    the Q40 8B model with q40_matmul.STYLE at maskdot, loopdot and
              deq: the forward against the plain versions, 32 greedy tokens
              through the `inference` CLI; decode forwards launch K3 (K4) in
              every matmul and K1 never, prefill chunks launch K2.
11. spec      `inference --spec 8` on a repetitive prompt (its emitted tokens
              and verify forwards printed; K1 and K7 launched); the greedy ids
              of spec 8 and spec 0 equal, or first differ at a near-tie of the
              plain run's logits; HTTP serve with --spec 8 and a spec_k 0
              request.

The kernels phase also holds K1 and K5 (the decode body csrc/decode.cuh)
against the plain version of their own arithmetic (exact-code partials,
TOL_K34) besides the bf16-weight plain versions, and each row of an m-row
call bit-equal to the row alone; K3 (maskdot, tensor cores) and K4 (loopdot,
CUDA cores) against their plain versions and against K1, and K11-B/K11-D
against theirs; K1 at 9 rows and K7 at 9 query rows (the spec verify
forward); and
every kernel the kbench phase launches on kbench's own inputs (each variant
of its suite rows and of `8 w1 B D`, the tile sweep, the flash rows), since
the benchmark checks no result. `serve`, `batch`, `f8`, `q80`, `kbench`, `styles` and `spec` are the
main paths: the launch counters are zeroed just before each of their runs and
read just after it. Not in the default: `profile` adds a torch.profiler pass
over one single-stream and one 8-slot decode chunk (device time and
operations a step, K1's share, and no split-k second pass); `chunk` runs only the
prefill-chunk timings (Q40 dense and paged, then Q80), so that they can be
taken from another checkout of the package as well.

The line before the last is the card's name and power limit; before that, one
JSON object lists every ported kernel with its numbers; the last line is
{"ok": true, "device": {...}}. Options cut the run for quicker checks.
"""

from __future__ import annotations

import argparse
import contextlib
import http.client
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

HBM_BYTES_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
BF16_OPS_S = 989e12  # H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
F32_OPS_S = 67e12  # H100 SXM f32 rate outside the tensor cores (NVIDIA data sheet)
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
    print(f"  {kernel:18s} {case['case']:36s} err {case['max_abs_err']:.3e} <= tol "
          f"{case['tol']:.3e}{exact}  ms {case['ms']}  plain {case['plain_ms']}  lib "
          f"{case['library_ms']}  bound {case['bound_ms']:.4f} ({case['bound_by']})",
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


def matmul_cases(cfg, device, timer, gen, fmt: str, plan, layer: int = 1) -> dict:
    """The decode and prefill kernels of weight format `fmt` ('q40': K1/K2,
    'q80': K5/K6) at the 8B shapes of `plan` [(kernel, weight, m)], each
    weight stacked [L=2] with layer 1 used; K2 at m <= 16 under STYLE deq.
    Each case must launch its own kernel."""
    import torch

    from dllama_tpu_torch.ops import q40_matmul, q80_matmul
    from dllama_tpu_torch.ops.quant import slice_leaf

    mod, rand, weight_bytes = {"q40": (q40_matmul, random_q40, 0.5),
                               "q80": (q80_matmul, random_q80, 1.0)}[fmt]
    kernel_fn, plain_fn = getattr(mod, f"{fmt}_matmul"), getattr(mod, f"{fmt}_matmul_plain")
    d, f, kvd, v = cfg.dim, cfg.hidden_dim, cfg.kv_dim, cfg.vocab_size
    weights = {"wq": (d, d), "wk": (d, kvd), "w1": (d, f), "w2": (f, d), "wcls": (d, v)}
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
            case = dict(case=f"{name} {k}x{n} m={m}{' deq' if deq else ''}",
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
    # narrow n (split-k) and wq at a chunk; the deq style's decode rows
    plan += [("q40_prefill", "wk", 256), ("q40_prefill", "wq", 256),
             ("q40_prefill", "w1", 1), ("q40_prefill", "w1", 16)]
    results = matmul_cases(cfg, device, timer, gen, "q40", plan, layer)
    results["flash_attention"] = []

    hq, hkv, hd, s = cfg.n_heads, cfg.n_kv_heads, cfg.head_size, 4096
    group = hq // hkv
    kc = torch.randn((1, hkv, s, hd), generator=gen, device=device).to(torch.bfloat16)
    vc = torch.randn((1, hkv, s, hd), generator=gen, device=device).to(torch.bfloat16)
    for t, pos, cache_dtype in ((1, 0, torch.bfloat16), (1, 1000, torch.bfloat16),
                                (1, 4095, torch.bfloat16), (256, 0, torch.bfloat16),
                                (256, 2048, torch.bfloat16), (9, 1000, torch.bfloat16),
                                (64, 0, torch.bfloat16), (128, 0, torch.bfloat16),
                                (256, 3840, torch.bfloat16),
                                (1, 1000, torch.float32)):  # T=9: a spec verify forward
        q = torch.randn((1, t, hq, hd), generator=gen, device=device).to(torch.bfloat16)
        kc, vc = kc.to(cache_dtype), vc.to(cache_dtype)
        got = flash_gqa_attention(q, kc, vc, pos, out_dtype=torch.float32)
        ref = gqa_attention(q.float(), kc.float(), vc.float(), pos)
        torch.cuda.synchronize()
        live = pos + t
        qt, kl, vl = q.transpose(1, 2).to(kc.dtype), kc[:, :, :live], vc[:, :, :live]
        mask = (torch.arange(live, device=device)[None, :]
                <= pos + torch.arange(t, device=device)[:, None])
        nbytes = 2 * q.numel() * 2 + 2 * hkv * live * hd * kc.element_size()
        ops = 4.0 * hd * hq * sum(pos + i + 1 for i in range(t))
        b, by = bound_ms(nbytes, ops)
        tag = "" if cache_dtype == torch.bfloat16 else " f32 cache"
        case = dict(case=f"T={t} pos={pos} S={s} group={group}{tag}",
                    max_abs_err=(got - ref).abs().max().item(), tol=TOL_K7,
                    ms=timer(lambda: flash_gqa_attention(q, kc, vc, pos)),
                    plain_ms=timer(lambda: gqa_attention(q, kc, vc, pos)),
                    library_ms=timer(lambda: F.scaled_dot_product_attention(
                        qt, kl, vl, attn_mask=mask, enable_gqa=True)),
                    bound_ms=b, bound_by=by)
        report("flash_attention", case)
        results["flash_attention"].append(case)

    # K9 and K8 over a page pool at page 128 (Llama-3.1-8B's heads, bf16)
    results["paged_attention"], results["paged_flash_attention"] = [], []
    some_inactive = [True, False, True, True, False, True, False, True]
    for kernel, label, b, t, pos, active in (
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
    """Untimed edges of the decode body shared by K1 and K5: each row of an
    m-row call (m = 2, 8, 9, 16) bit-equal to that row computed alone, at
    the w1 and wk shapes (a verify row summed like a decode row); m = 0; the
    bf16 output equal to the f32 output rounded."""
    import torch

    from dllama_tpu_torch.ops import q40_matmul as q40
    from dllama_tpu_torch.ops import q80_matmul as q80

    gen = torch.Generator(device=device).manual_seed(10)
    f32 = torch.float32
    for fmt, fn, rand in (("q40", q40.q40_matmul, random_q40), ("q80", q80.q80_matmul, random_q80)):
        for name, k, n in (("w1", 4096, 14336), ("wk", 4096, 1024)):
            w = rand(gen, (2,), k, n, device)
            x = torch.randn((16, k), generator=gen, device=device).to(torch.bfloat16)
            alone = torch.cat([fn(x[r : r + 1], w, 1, out_dtype=f32) for r in range(16)])
            for m in (2, 8, 9, 16):
                same = torch.equal(fn(x[:m], w, 1, out_dtype=f32), alone[:m])
                print(f"  edge {fmt}_decode {name} m={m}: every row bit-equal to the row alone: "
                      f"{same}", flush=True)
                if not same:
                    fail(f"{fmt}_decode {name} m={m}: a row depends on the other rows")
            bf = fn(x[:9], w, 1)
            empty = fn(x[:0], w, 1, out_dtype=f32)
            torch.cuda.synchronize()
            if not (torch.equal(bf, alone[:9].to(torch.bfloat16)) and empty.shape == (0, n)):
                fail(f"{fmt}_decode {name}: bf16 output is not the f32 one rounded, or m = 0 "
                     f"gave {tuple(empty.shape)}")
            del w


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
    plain versions and K1, then timed beside the plain version and
    torch.matmul on the pre-dequantized bf16 weight."""
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
                            bound_ms=b, bound_by=by)
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
                ("kbench_fma_f32", lambda x: kbench.fma_f32(x, w.packed, scales32),
                 lambda x: kbench.fma_f32_plain(x, w.packed, scales32),
                 lambda x: torch.matmul(x.float(), wf),
                 m * k * 2 + k * n // 2 + (k // 32) * n * 4 + m * n * 4, F32_OPS_S),
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


def write_model(path: str, cfg, device, seed: int = 0) -> None:
    """A `.m` of `cfg` with random Q40 records (packed bytes + small positive
    f16 scales) and a small f32 embedding, generated on the device. A Q80
    `cfg` gets the same seed's Q40 weights re-quantized to Q80 (q80_records):
    the same network, whose forward is as well conditioned as the Q40 one's.
    (Uniform random int8 codes make a zero-mean random network that
    amplifies the kernels' exact codes against the plain path's bf16-rounded
    weights to 0.17 of max|logit| over 32 layers, where this recipe's nibbles,
    whose mean is -s/2, keep it near 6.5e-3; the kernels phase feeds the Q80
    kernels such codes, -128 included.)"""
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
                packed = torch.randint(0, 256, (nb, 16), generator=gen, device=device,
                                       dtype=torch.uint8)
                if ft == FloatType.Q80:
                    rec = q80_records(scales, packed)
                else:
                    rec = torch.cat([scales.view(torch.uint8).reshape(nb, 2), packed], dim=1)
                f.write(rec.cpu().numpy().tobytes())
            elif name == "embedding":
                for r0 in range(0, shape[0], 8192):
                    rows = min(8192, shape[0] - r0)
                    e = (torch.rand((rows, shape[1]), generator=gen, device=device) - 0.5) * 0.04
                    f.write(e.cpu().numpy().tobytes())
            else:  # norm weights
                f.write(np.ones(n, np.float32).tobytes())


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
    template = ("{% for message in messages %}<|start_header_id|>{{ message['role'] }}"
                "<|end_header_id|>\n\n{{ message['content'] }}<|eot_id|>{% endfor %}")
    bos = n_regular
    Tokenizer(vocab, scores, bos, [bos + 1, bos + 9], chat_template=template,
              special_ids=list(range(n_regular, len(vocab)))).save(path)


def phase_forward(loaded, device, prefill: int = 256, decode: int = 8, verify: int = 9) -> float:
    """Kernels vs plain versions through the whole forward, each on a fresh
    cache of the engine's cache dtype: a prefill, decode steps, then one
    forward of `verify` tokens with every position's logits, the shape of a
    spec verify forward (k + 1 rows at --spec 8). Returns the largest
    |logit difference| / max|logit| over all of them."""
    import functools

    import torch

    from dllama_tpu_torch.models.llama import KVCache, forward
    from dllama_tpu_torch.ops.layers import gqa_attention
    from dllama_tpu_torch.ops.matmul import matmul

    eng = loaded.engine
    cfg = loaded.config
    gen = torch.Generator(device=device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, prefill + decode + verify), generator=gen,
                         device=device)
    runs = {}
    for label, mm, attn in (
            ("kernels", eng.mm, eng.attn_fn),
            ("plain", functools.partial(matmul, backend="torch"), gqa_attention)):
        cache = KVCache.create(cfg, 1, eng.cache.k.dtype, eng.seq_len, device)
        outs = []
        with torch.no_grad():
            logits, _ = forward(cfg, eng.params, toks[:, :prefill], 0, cache,
                                eng.rope_cache, attn, mm, last_only=True)
            outs.append(logits[:, -1])
            for i in range(decode):
                p = prefill + i
                logits, _ = forward(cfg, eng.params, toks[:, p : p + 1], p, cache,
                                    eng.rope_cache, attn, mm, last_only=True)
                outs.append(logits[:, -1])
            p = prefill + decode
            logits, _ = forward(cfg, eng.params, toks[:, p : p + verify], p, cache,
                                eng.rope_cache, attn, mm, last_only=False)
            outs.extend(logits.unbind(1))
        runs[label] = torch.stack(outs)
        del cache
    ref = runs["plain"]
    if not torch.isfinite(runs["kernels"]).all():
        fail("forward: non-finite logits through the kernels")
    return ((runs["kernels"] - ref).abs().max() / ref.abs().max()).item()


#: kernel-name fragments of the chunk's device-time split: the prefill GEMM
#: (K2, K6), the attention kernels with their combine and scatter passes (K7,
#: K9, under the names of this tree and of earlier ones), everything else
CHUNK_MATMUL = ("q40_prefill_kernel", "q80_prefill_kernel")
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
    from torch.profiler import ProfilerActivity, profile

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
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run(pos)
                torch.cuda.synchronize()
            split = {"matmul_ms": 0.0, "attention_ms": 0.0, "other_ms": 0.0, "kernels": 0}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
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


def phase_profile(loaded, prompt_tokens: list[int], steps: int = 8) -> dict:
    """torch.profiler over one decode chunk of `steps` tokens after a
    prefill: wall time, device time summed over kernels, and the kernels
    that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dllama_tpu_torch.engine.sampling import Sampler

    eng = loaded.engine
    eng.reset(0)
    logits = eng.prefill(prompt_tokens)
    tok = int(torch.argmax(logits[0]))
    eng.decode_sample_n([[tok]], steps, Sampler(0.0, 0.9, 0))  # warm
    eng.reset(len(prompt_tokens))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
            **decode_split(by_name, steps),
            "top": [(k[:60], c, round(us / steps / 1e3, 4)) for us, k, c in rows[:10]]}


#: kernel-name fragments of K1 in the profiler (this tree's decode body over
#: the Q40 policy, and the name of the earlier kernel) and of the split-k
#: second pass that K1 and K5 no longer launch
K1_NAMES = ("Q40Codes", "q40_decode_kernel")
SPLITK_NAME = "splitk_reduce"


def device_ops(prof) -> dict:
    """{name: [device us, count]} of the operations on the card (kernels,
    memcpys, memsets) in a torch.profiler run."""
    from torch.autograd import DeviceType

    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            agg = by_name.setdefault(e.name, [0.0, 0])
            agg[0] += e.time_range.elapsed_us()
            agg[1] += 1
    return by_name


def decode_split(by_name: dict, steps: int) -> dict:
    """Device operations, K1's device ms and split-k second passes, each
    per decode step (a token of one stream, or one batched step)."""
    k1 = [v for name, v in by_name.items() if any(f in name for f in K1_NAMES)]
    return {"device_ops_per_step": sum(v[1] for v in by_name.values()) / steps,
            "k1_ms_per_step": sum(v[0] for v in k1) / steps / 1e3,
            "k1_launches_per_step": sum(v[1] for v in k1) / steps,
            "splitk_reduce_per_step": sum(v[1] for name, v in by_name.items()
                                          if SPLITK_NAME in name) / steps}


# ------------------------------------------------------------ phase 4


def _post(port: int, body: dict) -> tuple[int, bytes]:
    return _post_timed(port, body)[:2]


def _post_timed(port: int, body: dict) -> tuple[int, bytes, float]:
    """-> (status, body, time.perf_counter() when the request was sent)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t_sent = time.perf_counter()
    conn.request("POST", "/v1/chat/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
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
                mm_kernels: tuple = Q40_KERNELS) -> dict:
    """make_server with slots (what `serve --slots 8` runs) over real HTTP:
    the auto layout, n concurrent greedy chat requests twice (identical
    contents), one SSE stream, a seeded sampled request alone and among
    penalized batch-mates (the same stream), and the page pool after the
    drain. The launch counters are zeroed before the requests and read
    after them: every forward launches the model's matmul kernels
    (`mm_kernels`, those of its weight format, and no other format's).
    Decode must really run batched: the first round's decode chunks must
    carry more than MIN_BATCH_SLOTS live slots on average."""
    from dllama_tpu_torch.serve.api import graceful_drain, make_server

    import torch

    from dllama_tpu_torch.engine.sampling import philox_uniforms

    # the per-slot generator gives the same bits on the CPU and the card
    seeds = torch.tensor([0, 1, 2**40 + 5, 2**62 + 3, 2**63 - 1], dtype=torch.int64)
    ctrs = torch.tensor([0, 1, 2**31, 2**33 + 7, 2**62], dtype=torch.int64)
    if not torch.equal(philox_uniforms(seeds, ctrs),
                       philox_uniforms(seeds.to(loaded.engine.device),
                                       ctrs.to(loaded.engine.device)).cpu()):
        fail("batch: Philox uniforms differ between the CPU and the card")
    httpd, api = make_server(loaded, host="127.0.0.1", port=0, n_slots=n_slots)
    eng = api.scheduler.engine
    if (eng.kv_layout, eng.page_size, eng.attn_route) != ("paged", 128, "paged_kernel"):
        fail(f"batch: --kv-layout auto resolved to {eng.kv_layout} page {eng.page_size} "
             f"route {eng.attn_route}; want paged, 128, paged_kernel")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
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
        # batch-mates that decode penalized-greedy in the same chunks
        sampled = {"messages": [{"role": "user", "content": "Sample: " + batch_prompts(1)[0]}],
                   "temperature": 0.8, "top_p": 0.9, "seed": 11, "max_tokens": 16}
        mates = [dict(b, frequency_penalty=0.5, presence_penalty=0.3) for b in bodies[1:]]
        mixed = [_post(port, sampled)] + _concurrently(
            _post, [(port, sampled)] + [(port, b) for b in mates])
        launches = counters()
        forwards = eng.forwards - f0
    finally:
        clean = graceful_drain(httpd, api, timeout_s=120)
        httpd.server_close()
    if not occupancy[0] > MIN_BATCH_SLOTS:
        fail(f"batch: the first round's decode chunks carried {occupancy[0]:.2f} live slots "
             f"on average, want > {MIN_BATCH_SLOTS}: decode did not run batched")
    contents = [[r["choices"][0]["message"]["content"] for r in rnd] for rnd in rounds]
    if contents[0] != contents[1]:
        fail("batch: the same greedy requests gave different contents")
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
        fail("batch: streamed content differs from the non-stream completion")
    mm = sum(launches[k] for k in mm_kernels)
    other = sum(launches[k] for k in Q40_KERNELS + Q80_KERNELS if k not in mm_kernels)
    per_fwd = 7 * loaded.config.n_layers + 1
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
            "pool_after_drain": {k: report[k] for k in ("total", "free", "ok")}}


def phase_profile_batch(loaded, n_slots: int = 8, steps: int = 8) -> dict:
    """torch.profiler over one n_slots-slot decode chunk of `steps` tokens
    on a paged BatchEngine, every slot live after a prefill."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
            **decode_split(by_name, steps),
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

    loaded = load_model(mpath, tpath, max_seq_len=4096, cache_dtype=torch.float8_e4m3fn,
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
    loaded = load_model(mpath, tpath, max_seq_len=4096, device=device)
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
            batch = phase_batch(loaded, mm_kernels=Q80_KERNELS)
        finally:
            layers.RMS_NORM_IMPL = "torch"
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
                      "--fuse-weights"])
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
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli(argv)
    stats = [ln for ln in err.getvalue().splitlines()
             if ln.startswith(("Prefill:", "Decode:", "Speculation:"))]
    return rc, out.getvalue(), stats


def _stat(stats: list[str], head: str) -> int:
    """The first integer of the stats line starting with `head` (0 if none)."""
    line = next((ln for ln in stats if ln.startswith(head)), "")
    return int(line.split()[1]) if line else 0


def phase_styles(loaded, device, mpath: str, tpath: str, prompt: str) -> dict:
    """The Q40 8B model under q40_matmul.STYLE = maskdot, loopdot and deq:
    the forward (256-token prefill, 8 decode steps, a 9-row verify forward)
    against the plain versions, with its exact launch counts (a decode or
    verify forward launches the style's kernel 7L+1 times, a prefill chunk
    K2 in its 7L layer matmuls and the style's kernel for its one-row
    lm-head), then 32 greedy tokens
    through the `inference` CLI: no K1 launch, the style's kernel 7L+1 times
    per decode forward, K2 on prefill chunks. Returns {style: launches}."""
    from dllama_tpu_torch.ops import q40_matmul as q40

    n_layers = loaded.config.n_layers
    per_fwd = 7 * n_layers + 1
    argv = ["inference", "--model", mpath, "--tokenizer", tpath, "--prompt", prompt,
            "--temperature", "0", "--steps", "32", "--max-seq-len", "4096"]
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
        print(f"styles {style} inference: rc {rc}; {' | '.join(stats)}; text {text[:60]!r}; "
              f"launches {cli_l}", flush=True)
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
    the spec run's; HTTP on the single-engine tier with --spec 8, a default
    request and a spec_k 0 one. Returns the launches of the CLI and serve
    runs."""
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


# ------------------------------------------------------------ main


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
                    default="card,kernels,kbench,forward,serve,batch,inference,styles,spec,f8,q80",
                    help="comma list; not in the default: 'profile' adds a "
                         "torch.profiler pass over one decode chunk, single-stream "
                         "and 8-slot; 'chunk' is the prefill-chunk timing alone (Q40 "
                         "dense and paged, Q80)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    try:
        import torch

        import dllama_tpu_torch  # noqa: F401  (run from the repository root)
        from dllama_tpu_torch.ops import build
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

    paths: dict[str, dict] = {}  # launch counts of each path, read just after it
    if "kbench" in phases:
        paths["kbench"] = phase_kbench()
    prompt = ("Summarize the plot of a long story about a lighthouse keeper, "
              "a storm, and a ship that never arrives.")
    if phases & {"forward", "chunk", "serve", "profile", "batch", "inference", "styles", "spec",
                  "f8"}:
        from dllama_tpu_torch.engine.loader import load_model

        tmp = tempfile.TemporaryDirectory(prefix="dllama_smoke_")
        mpath, tpath = os.path.join(tmp.name, "llama31_8b_q40.m"), os.path.join(tmp.name, "tok.t")
        t0 = time.perf_counter()
        write_model(mpath, cfg, device)
        write_tokenizer(tpath, cfg.vocab_size)
        print(f"wrote synthetic {cfg.describe()} ({os.path.getsize(mpath) / 1e9:.2f} GB) "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        loaded = load_model(mpath, tpath, max_seq_len=4096, device=device)
        print(f"load_model: {time.perf_counter() - t0:.1f} s; kernels={loaded.engine.backend} "
              f"attention={loaded.engine.attn_route}", flush=True)

        if "forward" in phases:
            check_forward(loaded, device, "forward")
        if phases & {"forward", "chunk"}:
            report_chunk("Q40 dense (K2 + K7)", prefill_chunk_ms(loaded, device))
            report_chunk("Q40 paged, page 128 (K2 + K9)",
                         prefill_chunk_ms(loaded, device, page=128))

        if "serve" in phases:
            launches = serve_checked(loaded, prompt, "serve", Q40_KERNELS,
                                     7 * cfg.n_layers + 1, "flash_attention")
            for k in SERVE_KERNELS:
                if launches[k] == 0:
                    fail(f"serve: kernel {k} was never launched on the single-engine path")
            paths["serve"] = launches

        if "profile" in phases:
            prof = phase_profile(loaded, loaded.tokenizer.encode(prompt))
            print(f"profile: {prof['wall_ms_per_token']:.3f} ms/token wall, "
                  f"{prof['device_ms_per_token']:.3f} ms/token device time, busy share "
                  f"{prof['device_busy_share']}; {prof['device_ops_per_step']:.1f} device ops, "
                  f"K1 {prof['k1_ms_per_step']:.3f} ms in {prof['k1_launches_per_step']:.1f} "
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
                  f"device ops, K1 {bprof['k1_ms_per_step']:.3f} ms in "
                  f"{bprof['k1_launches_per_step']:.1f} launches, "
                  f"{bprof['splitk_reduce_per_step']:.1f} splitk_reduce a step", flush=True)
            for key, ms in bprof["top"]:
                print(f"  {ms:9.4f} ms/step  {key}")
            from dllama_tpu_torch.ops import q40_matmul

            # the decode body makes one launch a call (an earlier checkout of the
            # package, timed with this script for comparison, still has a second pass)
            if hasattr(q40_matmul, "decode_geometry") and (
                    prof["splitk_reduce_per_step"] or bprof["splitk_reduce_per_step"]):
                fail("profile: splitk_reduce ran on the Q40 decode path")

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

        if "inference" in phases:
            from dllama_tpu_torch.cli.main import main as cli

            reset_counters()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
                rc = cli(["inference", "--model", mpath, "--tokenizer", tpath,
                          "--prompt", prompt, "--temperature", "0", "--steps", "32",
                          "--max-seq-len", "4096"])
            inf_launches = counters()
            stats = [ln for ln in buf.getvalue().splitlines()
                     if ln.startswith(("Prefill:", "Decode:"))]
            print(f"inference: rc {rc}; {' | '.join(stats)}; launches {inf_launches}",
                  flush=True)
            if rc != 0 or min(inf_launches[k] for k in SERVE_KERNELS) == 0:
                fail("inference: the CLI failed or skipped a kernel")

        if "styles" in phases:
            for style, launches in phase_styles(loaded, device, mpath, tpath, prompt).items():
                paths[f"styles-{style}"] = launches

        if "spec" in phases:
            paths["spec"] = phase_spec(loaded, mpath, tpath)
        del loaded
        torch.cuda.empty_cache()
        if "f8" in phases:
            paths["f8"] = phase_f8(mpath, tpath, device, prompt)
        tmp.cleanup()  # the Q40 model and its files go before the Q80 ones come

    if "q80" in phases:
        paths["q80"] = phase_q80(device, prompt)
    elif "chunk" in phases:  # the Q80 chunk alone
        with tempfile.TemporaryDirectory(prefix="dllama_smoke_q80_") as tmp:
            loaded, _, _ = q80_model(tmp, device)
            report_chunk("Q80 dense (K6 + K7)", prefill_chunk_ms(loaded, device))
            del loaded
        torch.cuda.empty_cache()

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
