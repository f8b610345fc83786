"""Microbenchmark of the Q40 matmul kernel variants, on the card.

Usage: python -m dllama_tpu_torch.experiments.kbench suite [--smoke] [--no-flash] [--device D]
       python -m dllama_tpu_torch.experiments.kbench flash [--smoke] [--device D]
       python -m dllama_tpu_torch.experiments.kbench M SHAPE [variant ...] [--device D]

The port of experiments/kbench.py, with its shapes, suite, tile sweep,
variant letters and row format. 'suite' benches the decode variants (m=8 on
w1/wcls), the prefill tier (m=256/512), the decode kernel's (tk, tn) tile
sweep and the flash-attention rows, in one process, and ends with
``KBENCH DONE``. A variant that raises prints a ``FAILED`` line and the rest
of its row still runs.
  variants: A  production dispatch (q40_matmul, STYLE auto: K1 for m<=16, K2 above)
            DQ forced deq (K2)      BD forced blockdot (K1)
            MD forced maskdot (K3)  LD forced loopdot (K4)
            B  f32-FMA Q40 product, f32 scales (K11-B, csrc/kbench_fma_f32.cu)
            D  bf16-weight reference (K11-D, csrc/kbench_bf16_gemm.cu)
            E  dequantize + torch.matmul (a library yardstick)
            Q8 the Q80 matmul (K5 at m<=16, K6 above)
The two K11 kernels each take two routes, split at m <= 16 as K1 against K2:
the decode body (csrc/decode.cuh: a cp.async ring a warp, mma.sync, split-k
summed inside the launch; bound by the weight's bytes) and K2's wgmma loop
(csrc/prefill.cuh: a TMA ring, wgmma; at m = 256 still bound by the bytes
for K11-D, by the bf16 tensor rate for K11-B). K11-B's products are exact
on the bf16 tensor cores (a bf16 x times a code q - 8 is exact in f32; an
f32 x enters as three bf16 terms, the weight as w_hi + w_lo on the wgmma
route), so its bound is the bf16 rate's, not the CUDA cores' f32 rate.
The forced decode styles apply only when m <= 16; a larger m runs deq, as
in the JAX package. Rows give the time per call and the rate over the
weight's bytes (packed nibbles + f16 scales for Q40).

It runs on the card (``--device cuda``, the default; without a card it
stops with an error). ``--device cpu`` runs the wrappers' plain versions on
the CPU: with ``--smoke`` (tiny shapes, 2 iterations) that proves the
harness completes; its times are host times of plain PyTorch, no device
metric. Times on the card come from CUDA events around ITERS calls, each on
its own x buffer, after one warm-up call.

The weights are random (uniform nibbles or int8 codes, small positive
scales) from a seeded generator on the device, and x is Gaussian: a kernel's
time does not depend on the values.
"""

from __future__ import annotations

import sys
import time

import torch

from dllama_tpu_torch.ops import build
from dllama_tpu_torch.ops import q40_matmul as qmod
from dllama_tpu_torch.ops.quant import Q_BLOCK, Q8Tensor, QTensor

# --smoke flips these: tiny shapes, 2 timing iterations (see enable_smoke)
SMOKE = False
ITERS = 30
DEVICE = torch.device("cuda")

#: kernel launches made through the K11 wrappers (plain ints)
LAUNCHES = {"kbench_fma_f32": 0, "kbench_bf16_gemm": 0}


# ------------------------------------------------------------ K11-B, K11-D

#: the two routes of each K11 kernel (the C entries' `route`): the decode
#: body (csrc/decode.cuh) for m <= DECODE_MAX_M rows, K2's wgmma loop
#: (csrc/prefill.cuh) above, the split of K1 against K2
ROUTES = ("decode", "wgmma")
DECODE_MAX_M = qmod.DECODE_MAX_M
#: column tiles of the decode route for 2-byte weights (csrc/decode.cuh
#: Bf16Weights: a 4-slot ring a warp, two blocks an SM) and for an f32 x
#: (its three bf16 terms' registers), widest first
NARROW_COLS = (64, 32)


def route(m: int) -> str:
    """The route of an m-row call: the decode body up to DECODE_MAX_M rows,
    the wgmma loop above."""
    return ROUTES[m > DECODE_MAX_M]


def bf16_decode_geometry(k: int, n: int, sms: int) -> qmod.DecodeGeometry:
    """K11-D's decode launch for a [k, n] weight (k % 8 == 0), whatever m is:
    K1's rule (q40_matmul.decode_geometry) over NARROW_COLS, so a weight whose
    column tiles alone fill the card walks all of k in one split (every split
    cost time at w1, kernel_proof.py k11) and a narrow one is split until
    every SM has a block."""
    return qmod.decode_geometry(k, n, sms, cols=NARROW_COLS)


def fma_decode_geometry(k: int, n: int, sms: int, x_f32: bool) -> qmod.DecodeGeometry:
    """K11-B's decode launch: K1's (q40_matmul.decode_geometry), at most 64
    columns a warp for an f32 x."""
    geo = qmod.decode_geometry(k, n, sms)
    if x_f32 and geo.cols > NARROW_COLS[0]:
        geo = qmod.decode_geometry(k, n, sms, None, NARROW_COLS[0])
    return geo


def fma_dequantize(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """K11-B's weight: w = f * s - 8 * s in f32 from the unsigned nibbles f
    (packed u8 [k/2, n]) and f32 scales s ([k/32, n]) -> f32 [k, n]."""
    kh, n = packed.shape
    p = packed.reshape(kh // (Q_BLOCK // 2), Q_BLOCK // 2, n)
    f = torch.cat([p & 0x0F, p >> 4], dim=1).to(torch.float32)  # [nb, 32, n]
    s = scales.to(torch.float32)[:, None, :]
    return (f * s - 8.0 * s).reshape(kh * 2, n)


def fma_f32_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Plain version of K11-B: fma_dequantize, then an f32 dot with x
    widened to f32."""
    return torch.matmul(x.to(torch.float32), fma_dequantize(packed, scales))


def _launch(name: str, x: torch.Tensor, w: torch.Tensor, scales: torch.Tensor | None,
            out: torch.Tensor, route_: str, geo: qmod.DecodeGeometry | None) -> None:
    """One launch of K11 kernel `name` on the route `route_` (the decode
    route under `geo`)."""
    m, k = x.shape
    n = w.shape[1]
    if route_ not in ROUTES or (route_ == "decode" and m > DECODE_MAX_M):
        raise ValueError(f"{name}: route {route_!r} for {m} rows (the decode route takes at "
                         f"most {DECODE_MAX_M})")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route_ == "decode":
        partial, counters = qmod.decode_scratch(x.device, stream, m, n, geo)
        tile = (geo.splits, geo.kb_per_split, geo.cols)
    else:
        partial = counters = None
        tile = (1, 0, 0)
    lib = getattr(build.library(name), name)
    if name == "kbench_fma_f32":
        err = lib(x.data_ptr(), w.data_ptr(), scales.data_ptr(), partial, counters,
                  out.data_ptr(), m, k, n, *tile, int(x.dtype == torch.float32),
                  ROUTES.index(route_), stream)
    else:
        err = lib(x.data_ptr(), w.data_ptr(), partial, counters, out.data_ptr(), m, k, n, *tile,
                  ROUTES.index(route_), stream)
    build.check(name, err)


def fma_f32(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """K11-B: ``x[m, k] @ (f * s - 8 * s)`` -> f32 [m, n], for any m; x in
    bf16 or f32, ``packed`` u8 [k/2, n], ``scales`` f32 [k/32, n]. One launch
    on the route of m (:func:`route`). A CPU tensor runs
    :func:`fma_f32_plain`."""
    m, k = x.shape
    n = packed.shape[-1]
    if k % Q_BLOCK or tuple(packed.shape) != (k // 2, n) or tuple(scales.shape) != (k // Q_BLOCK, n):
        raise ValueError(f"fma_f32: x {tuple(x.shape)} against packed {tuple(packed.shape)} "
                         f"/ scales {tuple(scales.shape)}")
    if x.device.type == "cpu":
        return fma_f32_plain(x, packed, scales)
    if x.device.type != "cuda" or packed.device != x.device or scales.device != x.device:
        raise ValueError("fma_f32: the kernel takes CUDA tensors on one device")
    if (x.dtype not in (torch.bfloat16, torch.float32) or packed.dtype != torch.uint8
            or scales.dtype != torch.float32):
        raise ValueError(f"fma_f32: x bf16/f32, packed u8, scales f32; got {x.dtype} / "
                         f"{packed.dtype} / {scales.dtype}")
    if not (x.is_contiguous() and packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError("fma_f32: x, packed and scales must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("fma_f32: x must be 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    r = route(m)
    geo = (fma_decode_geometry(k, n, qmod._sm_count(x.device.index or 0),
                               x.dtype == torch.float32) if r == "decode" else None)
    _launch("kbench_fma_f32", x, packed, scales, out, r, geo)
    LAUNCHES["kbench_fma_f32"] += 1
    return out


def bf16_gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of K11-D: bf16 x and W widened to f32 (exactly), an
    f32 dot."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def bf16_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K11-D: ``x[m, k] @ w[k, n]`` with bf16 operands -> f32 [m, n], for
    any m (k and n multiples of 8). One launch on the route of m
    (:func:`route`). A CPU tensor runs :func:`bf16_gemm_plain`."""
    m, k = x.shape
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"bf16_gemm: x {tuple(x.shape)} against w {tuple(w.shape)}")
    n = w.shape[1]
    if x.device.type == "cpu":
        return bf16_gemm_plain(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError("bf16_gemm: the kernel takes CUDA tensors on one device")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"bf16_gemm: bf16 operands, got {x.dtype} / {w.dtype}")
    if k % 8 or n % 8 or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("bf16_gemm: contiguous operands with k and n multiples of 8")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("bf16_gemm: operands must be 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    r = route(m)
    geo = (bf16_decode_geometry(k, n, qmod._sm_count(x.device.index or 0))
           if r == "decode" else None)
    _launch("kbench_bf16_gemm", x, w, None, out, r, geo)
    LAUNCHES["kbench_bf16_gemm"] += 1
    return out


# ------------------------------------------------------------ harness


def bench(fn, args, iters=None) -> float:
    """Seconds per call. Each call gets a DISTINCT x buffer, as the JAX
    harness does; on the card CUDA events bracket the whole loop after one
    warm-up call; on the CPU the host clock does."""
    iters = iters or ITERS
    x, *rest = args
    xs = [x + torch.tensor(float(i), dtype=x.dtype, device=x.device) for i in range(iters)]
    fn(xs[0], *rest)
    if x.device.type == "cuda":
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for xi in xs:
            fn(xi, *rest)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3 / iters
    t0 = time.perf_counter()
    for xi in xs:
        fn(xi, *rest)
    return (time.perf_counter() - t0) / iters


SHAPES = {
    "wq": (2048, 2048),
    "w1": (2048, 8192),
    "w2": (8192, 2048),
    "wcls": (2048, 128256),
}


def make_inputs(m, label):
    """Shared test data for run_one and the tile sweep -> (w, x, qbytes):
    a Q40 weight of the shape, bf16 x [m, k], and the weight's bytes."""
    k, n = SHAPES[label]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    packed = torch.randint(0, 256, (k // 2, n), generator=gen, device=DEVICE, dtype=torch.uint8)
    scales = (torch.rand((k // Q_BLOCK, n), generator=gen, device=DEVICE) * 0.02
              + 1e-3).to(torch.float16)
    x = torch.randn((m, k), generator=gen, device=DEVICE).to(torch.bfloat16)
    qbytes = k * n // 2 + (k // Q_BLOCK) * n * 2  # packed + f16 scales
    return QTensor(packed, scales), x, qbytes


def make_q80(k, n) -> Q8Tensor:
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    codes = torch.randint(-128, 128, (k, n), generator=gen, device=DEVICE, dtype=torch.int8)
    scales = (torch.rand((k // Q_BLOCK, n), generator=gen, device=DEVICE) * 0.02
              + 1e-3).to(torch.float16)
    return Q8Tensor(codes, scales)


def dispatch_closure(w, style, tk=None, tn=None):
    """The production dispatch with a forced style (and optional K1 tile
    overrides), the caller's knobs restored after every call."""

    def prod(x):
        with qmod.forced_style(style, tk, tn):
            return qmod.q40_matmul(x, w)

    return prod


STYLE_OF = {"A": "auto", "DQ": "deq", "BD": "blockdot", "MD": "maskdot", "LD": "loopdot"}


def run_one(m, label, variants):
    k, n = SHAPES[label]
    w, x, qbytes = make_inputs(m, label)
    rows = []
    for v in variants:
        # per-variant isolation: one failing kernel must not eat the row's
        # other timings
        try:
            if v in STYLE_OF:
                t = bench(dispatch_closure(w, STYLE_OF[v]), (x,))
                rows.append((f"{v} {STYLE_OF[v]}", t, qbytes))
            elif v == "B":
                scales32 = w.scales.to(torch.float32)  # the legacy kernel's f32 scales
                t = bench(lambda xi: fma_f32(xi, w.packed, scales32), (x,))
                rows.append(("B fma-f32", t, qbytes + (k // Q_BLOCK) * n * 2))  # f32 scales
            elif v == "D":
                wb = w.dequantize(torch.bfloat16)
                t = bench(lambda xi: bf16_gemm(xi, wb), (x,))
                rows.append(("D bf16-ref", t, k * n * 2))
            elif v == "E":
                t = bench(lambda xi: torch.matmul(xi, w.dequantize(torch.bfloat16)), (x,))
                rows.append(("E torch-deq", t, qbytes))
            elif v == "Q8":
                from dllama_tpu_torch.ops.q80_matmul import q80_matmul

                w8 = make_q80(k, n)
                t = bench(lambda xi: q80_matmul(xi, w8), (x,))
                rows.append(("Q8 q80-fused", t, k * n + (k // Q_BLOCK) * n * 2))
            else:
                raise SystemExit(f"unknown variant {v!r}; see module docstring")
        except SystemExit:
            raise
        except Exception as e:
            print(f"m={m} {label} {v}: FAILED {e!r}"[:250])
            sys.stdout.flush()
    out = f"m={m} {label}: "
    for name, t, nb in rows:
        out += f"{name}={t*1e6:.0f}us({nb/t/1e9:.0f}GB/s) "
    print(out)
    sys.stdout.flush()


SUITE = [
    # decode shapes: the production dispatch + each forced style + rooflines
    (8, "w1", ["A", "BD", "MD", "LD", "DQ", "D", "E", "Q8"]),
    (8, "wcls", ["A", "D", "E"]),  # the lm head is ~18% of 1B weight bytes
    # prefill shapes: in-kernel deq vs dequantize + torch.matmul
    (256, "w1", ["DQ", "D", "E", "Q8"]),
    (512, "w1", ["DQ", "D", "E"]),
]

SWEEP_TK = (512, 1024, 2048)
SWEEP_TN = (128, 256, 512)


def enable_smoke():
    """Same code path, tiny: every SUITE row and the tile sweep on shapes
    small enough for a test (seconds)."""
    global SMOKE, ITERS, SHAPES, SUITE, SWEEP_TK, SWEEP_TN
    SMOKE = True
    ITERS = 2
    SHAPES = {
        "wq": (128, 128),
        "w1": (128, 256),
        "w2": (256, 128),
        "wcls": (128, 512),
    }
    SUITE = [
        (8, "w1", ["A", "BD", "MD", "LD", "DQ", "B", "D", "E", "Q8"]),
        (8, "wcls", ["A", "D", "E"]),
        (32, "w1", ["DQ", "D", "E", "Q8"]),
    ]
    SWEEP_TK = (32, 64)
    SWEEP_TN = (128,)


def sweep_blockdot_tiles(m=8, label="w1"):
    """The decode kernel's (tk, tn) overrides (BLOCKDOT_TK/TN): each combo
    prints as soon as it is measured, then a sorted summary."""
    k, n = SHAPES[label]
    w, x, qbytes = make_inputs(m, label)
    rows = []
    for tk in SWEEP_TK:
        for tn in SWEEP_TN:
            if k % tk or n % tn:
                continue
            try:
                t = bench(dispatch_closure(w, "blockdot", tk, tn), (x,))
                rows.append((tk, tn, t))
                print(f"  tile tk={tk} tn={tn}: {t*1e6:.0f}us ({qbytes/t/1e9:.0f}GB/s)")
            except Exception as e:
                print(f"  tile tk={tk} tn={tn}: FAILED {e!r}"[:200])
            sys.stdout.flush()
    rows.sort(key=lambda r: r[2])
    out = f"tile sweep m={m} {label} best-first: "
    for tk, tn, t in rows:
        out += f"tk{tk}/tn{tn}={t*1e6:.0f}us({qbytes/t/1e9:.0f}GB/s) "
    print(out)
    sys.stdout.flush()


def flash_inputs():
    """Inputs of every flash row, from one seed, in print order ->
    [(section, label, q, k, v, pos)]: section "group" is the decode rows at
    group 4, group 8 and group 4 on the f8 cache over the same KV heads;
    "depth" the decode rows at growing live depth over one S=8192 cache;
    "prefill" one prefill chunk at a shallow depth over that cache."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)

    hd = 64 if SMOKE else 128
    s_ab = 512 if SMOKE else 1024
    rows = []
    for hq, hkv, kvdt, label in (
            (32, 8, torch.bfloat16, "group=4 (4 live rows, 4 pad)"),
            (64, 8, torch.bfloat16, "group=8 (8 live rows, 0 pad)"),
            (32, 8, torch.float8_e4m3fn, "group=4 f8 KV cache")):
        q = rnd(1, 1, hq, hd)
        rows.append(("group", label, q, rnd(1, hkv, s_ab, hd, dtype=kvdt),
                     rnd(1, hkv, s_ab, hd, dtype=kvdt), s_ab - 2))
    s_long = 1024 if SMOKE else 8192
    k, v = rnd(1, 8, s_long, hd), rnd(1, 8, s_long, hd)
    q = rnd(1, 1, 32, hd)
    for frac in (1 / 128, 1 / 8, 1 / 2, 63 / 64):
        pos = max(1, int(s_long * frac))
        rows.append(("depth", f"S={s_long} pos={pos}", q, k, v, pos))
    tq_pf = 64 if SMOKE else 256
    rows.append(("prefill", f"t={tq_pf} static S={s_long} pos={tq_pf}", rnd(1, tq_pf, 32, hd),
                 k, v, tq_pf))
    return rows


def bench_flash_decode():
    """Flash attention (K7) on flash_inputs: (1) group 4 against group 8
    with the same KV heads (identical cache bytes; equal times mean the
    kernel is bound by the cache, not the rows), and group 4 on the f8 cache
    (half the bytes); (2) decode time against the live depth at S=8192,
    which should scale with the live cache; (3) one prefill chunk at a
    shallow depth."""
    from dllama_tpu_torch.ops.flash_attention import flash_gqa_attention

    depth = []
    for section, label, q, k, v, pos in flash_inputs():
        kind = "prefill" if section == "prefill" else "decode"
        if section == "prefill" and len(depth) >= 2:
            (p0, t0), (p1, t1) = depth[0], depth[-1]
            print(f"pruning scaling: pos x{p1/p0:.0f} -> time x{t1/t0:.1f} "
                  f"(~linear = pruning works; ~flat = static-grid overhead dominates)")
        if section == "prefill":
            # the JAX harness repeats the depth sweep on its bucketed grid
            # (s_buckets): the CUDA kernel has no static grid to bucket
            print("flash decode BUCKETED: no counterpart (the CUDA kernel walks only the live "
                  "KV tiles); rows above are the only ones")
        try:
            t = bench(lambda q, k, v, p=pos: flash_gqa_attention(q, k, v, p), (q, k, v))
        except Exception as e:
            print(f"flash {kind} {label}: FAILED {e!r}"[:250])
            sys.stdout.flush()
            continue
        if section == "group":
            kv_bytes = 2 * k.numel() * k.element_size()
            print(f"flash decode {label}: {t*1e6:.0f}us ({kv_bytes/t/1e9:.0f}GB/s cache)")
        else:
            print(f"flash {kind} {label}: {t*1e6:.0f}us")
        if section == "depth":
            depth.append((pos, t))
        sys.stdout.flush()


def _pop_device(argv: list[str]) -> str:
    if "--device" in argv:
        i = argv.index("--device")
        dev = argv[i + 1] if i + 1 < len(argv) else ""
        del argv[i : i + 2]
        return dev
    return "cuda"


def main(argv=None) -> int:
    # argv: 'suite [--smoke] [--no-flash]' | 'flash [--smoke]' |
    # M SHAPE [variant ...]; each takes --device cuda|cpu
    global DEVICE
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = _pop_device(argv)
    if dev not in ("cuda", "cpu"):
        print(f"kbench: --device {dev!r} (cuda or cpu)", file=sys.stderr)
        return 2
    if dev == "cuda" and not torch.cuda.is_available():
        print("kbench: no CUDA device was found; pass --device cpu to run the plain "
              "versions on the CPU", file=sys.stderr)
        return 1
    DEVICE = torch.device(dev)
    no_flash = "--no-flash" in argv
    if no_flash:
        argv.remove("--no-flash")
    if "--smoke" in argv:
        argv.remove("--smoke")
        enable_smoke()
    name = torch.cuda.get_device_name(0) if dev == "cuda" else "cpu (plain versions, host times)"
    print(f"kbench device: {name}")
    if argv[:1] == ["flash"]:
        bench_flash_decode()
        print("KBENCH DONE")
        return 0
    if argv[:1] == ["suite"]:
        for m, label, variants in SUITE:
            try:
                run_one(m, label, variants)
            except Exception as e:
                print(f"m={m} {label}: FAILED {e!r}"[:300])
                sys.stdout.flush()
        try:
            sweep_blockdot_tiles()
        except Exception as e:
            print(f"tile sweep: FAILED {e!r}"[:300])
            sys.stdout.flush()
        if no_flash:
            print("flash bench SKIPPED (--no-flash)")
        else:
            try:
                bench_flash_decode()
            except Exception as e:
                print(f"flash bench: FAILED {e!r}"[:300])
                sys.stdout.flush()
        print("KBENCH DONE")
        sys.stdout.flush()
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    run_one(int(argv[0]), argv[1], argv[2:] or ["A", "B", "D", "E"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
