#!/usr/bin/env python3
"""Five one-off proofs about the kernels and the programs that launch them, on one NVIDIA GPU.

Run from the repository root (it reuses chip_smoke.py's inputs and timer):

    python3 kernel_proof.py splits [--reps N]
    python3 kernel_proof.py loopdot [--reps N]
    python3 kernel_proof.py parity --save FILE      # in one checkout
    python3 kernel_proof.py parity --against FILE   # in another
    python3 kernel_proof.py k11 [--reps N]
    python3 kernel_proof.py profile [--iters N] [--seconds S]

`splits` times the paged attention kernel (K9) under its own split rule and
under fixed tile counts per split, on decode B=8 at chip_smoke's SPREAD
positions, decode B=8 with every slot at pos 4095 and a 256-token chunk at
pos 2048 (page 128, Llama-3.1-8B heads, bf16), each checked against the
plain version within TOL_K9. The fixed counts replace the wrapper's rule
only inside this script.

`loopdot` times the Q40 loopdot kernel (K4) at the 8B shapes, m = 1 and 8,
under split counts that follow k alone (4, 5, 6 and 8: LOOPDOT_SPLITS is the
best of those that give wk a block on every SM) and under the strictly
ascending walk of all of k (one split, a 512-column tile: one warp along k),
each checked against its plain version within TOL_K34, beside K1's own
launch and a torch.sum over the layer's packed bytes read as f32 (what
reading the weight alone takes under this timer), on the same inputs in one
call. The candidate geometries replace the wrapper's only inside this
script.

`parity` computes the K2 (Q40 prefill GEMM), K7 (flash attention), K1 (Q40
decode), K5 (Q80 decode), K3 and K4 (the maskdot and loopdot styles) and K6
(Q80 prefill GEMM) f32 outputs of seeded inputs at the 8B shapes of
chip_smoke's kernels phase and saves them, or compares them bit for bit with
a file saved by another checkout of the package (copy this script and
chip_smoke.py into it): the proof that a refactor of a kernel's source
changed no bit of its result.

`k11` times the kernel benchmark's two kernels at w1 (4096 x 14336), m = 8
and 16, on both their routes (the decode body, and the wgmma loop, whose
smallest block pads x to 128 rows), K11-D's decode route under its own
geometry (one split at w1) and under 2 and 5 splits at 64 and at 32 columns
a warp, beside torch.matmul on the same inputs
(bf16 for K11-D, f32 on the f32 weight for K11-B) and a torch.sum over the
weight's bytes read as f32 (what reading the weight alone takes under this
timer), each checked against its plain version within TOL_K11. The routes and splits are forced only
inside this script.

`profile` boots chip_smoke's 8-slot obs server on the synthetic 8B Q40 model
and, N times, starts 8 greedy streams of 128 tokens and a `POST
/debug/profile` of S seconds at their 8th token: every stream must end and
every trace be written within 120 s, else every thread's stack is printed
and the script exits 1. It prints each round's seconds and the seconds the
profile's stop and write took (a stop beside a CUDA-graph replay on another
thread hung before `utils/profiling.GRAPH_GATE` kept them apart).
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import math
import os
import tempfile
import threading
import time

import chip_smoke as cs


@contextlib.contextmanager
def fixed_tiles_per_split(pa, per: int | None):
    """The paged wrapper's split rule replaced by `per` tiles a split (None:
    the rule itself)."""
    rule = pa.kv_splits
    if per is not None:
        def fixed(rows, bhkv, table_tiles, sms):
            p = max(1, min(per, table_tiles))
            return math.ceil(table_tiles / p), p
        pa.kv_splits = fixed
    try:
        yield pa.kv_splits
    finally:
        pa.kv_splits = rule


def splits(cfg, device, timer) -> None:
    import torch

    from dllama_tpu_torch.ops import paged_attention as pa
    from dllama_tpu_torch.ops.q40_matmul import _sm_count

    gen = torch.Generator(device=device).manual_seed(8)
    sms = _sm_count(device.index or 0)
    hq, hkv, hd, page, nb = cfg.n_heads, cfg.n_kv_heads, cfg.head_size, 128, 32
    for label, t, pos, pers in (("decode B=8 spread", 1, cs.SPREAD, (1, 2, 4, 8, 16, 32)),
                                ("decode B=8 all pos=4095", 1, [4095] * 8, (1, 2, 4, 8, 16, 32)),
                                ("prefill T=256 pos=2048", 256, [2048], (4, 8, 16, 32, 64))):
        b = len(pos)
        q, kp, vp, tables, nk, nv = cs.paged_inputs(gen, device, b, t, hq, hkv, hd, page, nb,
                                                    torch.bfloat16)
        posv = torch.tensor(pos, dtype=torch.int32, device=device)
        if t > pa.FUSED_SCATTER_MAX_T:  # the chunk's rows are scattered before the sweep
            nk = nv = None
        want = pa.paged_decode_attention_plain(q.float(), kp.clone().float(), vp.clone().float(),
                                               tables, posv, *(() if nk is None else
                                                               (nk.float(), nv.float())))
        want = want if nk is None else want[0]
        line = []
        for per in (None, *pers):
            with fixed_tiles_per_split(pa, per) as rule:
                n_splits, per_used = rule(t * hq // hkv, b * hkv, nb * page // pa.TS, sms)
                count = {"x": 0}
                got = pa.launch(q, kp.clone(), vp.clone(), tables, posv, nk, nv, None,
                                torch.float32, count, "x")
                err = (got - want).abs().max().item()
                if not err <= cs.TOL_K9:
                    cs.fail(f"splits {label} per={per}: max error {err} over {cs.TOL_K9}")
                ms = timer(lambda: pa.launch(q, kp, vp, tables, posv, nk, nv, None, None, count,
                                             "x"))
            line.append(f"{'rule' if per is None else per}: {n_splits}x{per_used} {cs._r(ms)} ms")
        print(f"  splits {label} (each err <= {cs.TOL_K9:.0e}; splits x tiles a split): "
              + "; ".join(line), flush=True)


def loopdot(cfg, device, timer) -> None:
    import torch

    from dllama_tpu_torch.ops import q40_matmul as q40

    gen = torch.Generator(device=device).manual_seed(13)
    sms = q40._sm_count(device.index or 0)
    d, f, kvd, v = cfg.dim, cfg.hidden_dim, cfg.kv_dim, cfg.vocab_size
    for name, k, n in (("wq", d, d), ("wk", d, kvd), ("w1", d, f), ("w2", f, d),
                       ("wcls", d, v)):
        w = cs.random_q40(gen, (), k, n, device)
        nkb = k // 32
        total = timer(lambda: torch.sum(w.packed.view(torch.float32)))
        cands = [("K1", "q40_decode", q40.decode_geometry(k, n, sms))]
        for s in (4, 5, 6, 8):
            per = max(q40.DECODE_MIN_BLOCKS_PER_SPLIT, -(-nkb // s))
            geo = q40.DecodeGeometry(-(-nkb // per), per, q40.decode_cols(n, -(-nkb // per), sms))
            cands.append((f"K4 {s} splits", "q40_loopdot", geo))
        cands.append(("K4 one walk", "q40_loopdot", q40.DecodeGeometry(1, nkb, 512)))
        for m in (1, 8):
            x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
            plain = q40.q40_loopdot_plain(x, w, out_dtype=torch.float32)
            tol = cs.TOL_K34 * plain.abs().max().item()
            line = []
            for label, lib, geo in cands:
                out = torch.empty((m, n), dtype=torch.float32, device=device)
                q40.decode_launch(lib, x, w.packed, w.scales, out, geo)
                err = (out - plain).abs().max().item()
                if not err <= tol:
                    cs.fail(f"loopdot {label} {name} m={m} {tuple(geo)}: max error {err} over {tol}")
                out = torch.empty((m, n), dtype=torch.bfloat16, device=device)
                ms = timer(lambda: q40.decode_launch(lib, x, w.packed, w.scales, out, geo))
                line.append(f"{label} {tuple(geo)} {cs._r(ms)}")
            print(f"  loopdot {name} {k}x{n} m={m} (each err <= TOL_K34; splits, blocks a split, "
                  f"columns; ms): torch.sum {cs._r(total)}; " + "; ".join(line), flush=True)
        del w


def parity(cfg, device, save: str | None, against: str | None) -> None:
    import torch

    from dllama_tpu_torch.ops.flash_attention import flash_gqa_attention
    from dllama_tpu_torch.ops.q40_matmul import forced_style, q40_matmul
    from dllama_tpu_torch.ops.q80_matmul import q80_matmul

    gen = torch.Generator(device=device).manual_seed(11)
    outs = {}
    d, f, kvd = cfg.dim, cfg.hidden_dim, cfg.kv_dim
    for name, k, n, m in (("w1", d, f, 256), ("w1", d, f, 32), ("w2", f, d, 256),
                          ("wq", d, d, 256), ("wk", d, kvd, 256), ("w1", d, f, 1)):
        w = cs.random_q40(gen, (2,), k, n, device)
        x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        with forced_style("deq"):
            outs[f"q40_prefill {name} m={m}"] = q40_matmul(x, w, 1, out_dtype=torch.float32)
    hq, hkv, hd, s = cfg.n_heads, cfg.n_kv_heads, cfg.head_size, 4096
    for dt in (torch.bfloat16, torch.float8_e4m3fn, torch.float32):
        kc = torch.randn((1, hkv, s, hd), generator=gen, device=device).to(dt)
        vc = torch.randn((1, hkv, s, hd), generator=gen, device=device).to(dt)
        for t, pos in ((1, 0), (1, 1000), (1, 4095), (256, 0), (256, 2048), (9, 1000),
                       (64, 0), (128, 0), (256, 3840)):
            q = torch.randn((1, t, hq, hd), generator=gen, device=device).to(torch.bfloat16)
            outs[f"flash_attention {dt} T={t} pos={pos}"] = flash_gqa_attention(
                q, kc, vc, pos, out_dtype=torch.float32)
        del kc, vc
    shapes = {"wq": (d, d), "wk": (d, kvd), "w1": (d, f), "w2": (f, d), "wcls": (d, cfg.vocab_size)}
    q80_decode_cases = [("wq", 1), ("wk", 1), ("w1", 1), ("w1", 8), ("w2", 1), ("wcls", 1),
                        ("wk", 8), ("w2", 8), ("wcls", 8)]
    for fmt, fn, rand, style, cases in (
            ("q40_decode", q40_matmul, cs.random_q40, "auto",
             [(name, m) for name in shapes for m in (1, 8, 9)]),
            ("q80_decode", q80_matmul, cs.random_q80, "auto", q80_decode_cases),
            ("q40_maskdot", q40_matmul, cs.random_q40, "maskdot",
             [(name, m) for name in shapes for m in (1, 8, 16)]),
            ("q40_loopdot", q40_matmul, cs.random_q40, "loopdot",
             [(name, m) for name in shapes for m in (1, 8, 16)]),
            ("q80_prefill", q80_matmul, cs.random_q80, "auto",
             [("w1", 256), ("w1", 32), ("w2", 256), ("wq", 256), ("wk", 256)])):
        for name, m in cases:  # the kernels phase's cases of each kernel
            k, n = shapes[name]
            w = rand(gen, (2,), k, n, device)
            x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
            with forced_style(style):
                outs[f"{fmt} {name} m={m}"] = fn(x, w, 1, out_dtype=torch.float32)
            del w
    outs = {k: v.cpu() for k, v in outs.items()}
    if save:
        torch.save(outs, save)
        print(f"parity: saved {len(outs)} K2/K7/K1/K5/K3/K4/K6 outputs to {save}", flush=True)
    if against:
        ref = torch.load(against)
        differ = [k for k in outs if not torch.equal(outs[k], ref[k])]
        groups = {}
        for key in outs:
            kern = key.split()[0]
            groups.setdefault(kern, [0, 0])[0] += key not in differ
            groups[kern][1] += 1
        print(f"parity: {len(outs) - len(differ)} of {len(outs)} outputs bit-equal to {against} ("
              + ", ".join(f"{kern} {a} of {b}" for kern, (a, b) in groups.items()) + ")",
              flush=True)
        if differ:
            cs.fail(f"parity: outputs differ from {against}: {differ}")


def k11(cfg, device, timer) -> None:
    import torch

    from dllama_tpu_torch.experiments import kbench
    from dllama_tpu_torch.ops import q40_matmul as q40

    gen = torch.Generator(device=device).manual_seed(14)
    sms = q40._sm_count(device.index or 0)
    k, n = cfg.dim, cfg.hidden_dim
    w = cs.random_q40(gen, (), k, n, device)
    s32, wb = w.scales.to(torch.float32), w.dequantize(torch.bfloat16)
    wf = kbench.fma_dequantize(w.packed, s32)
    for m in (8, 16):
        x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        for name, wt, sc, plain, lib, geos in (
                ("kbench_bf16_gemm", wb, None, kbench.bf16_gemm_plain(x, wb),
                 lambda: torch.matmul(x, wb),
                 [kbench.bf16_decode_geometry(k, n, sms)]
                 + [q40.DecodeGeometry(s, -(-k // 32 // s), c) for c in kbench.NARROW_COLS
                    for s in (2, 5)]),
                ("kbench_fma_f32", w.packed, s32, kbench.fma_f32_plain(x, w.packed, s32),
                 lambda: torch.matmul(x.float(), wf),
                 [kbench.fma_decode_geometry(k, n, sms, False)])):
            tol = cs.TOL_K11 * plain.abs().max().item()
            line = [f"torch.matmul {cs._r(timer(lib))}",
                    f"torch.sum over the weight's bytes as f32 "
                    f"{cs._r(timer(lambda: torch.sum(wt.view(torch.float32))))}"]
            for route, geo in [("decode", g) for g in geos] + [("wgmma", None)]:
                out = torch.empty((m, n), dtype=torch.float32, device=device)
                kbench._launch(name, x, wt, sc, out, route, geo)
                err = (out - plain).abs().max().item()
                if not err <= tol:
                    cs.fail(f"k11 {name} m={m} {route} {geo}: max error {err} over {tol}")
                ms = timer(lambda: kbench._launch(name, x, wt, sc, out, route, geo))
                line.append(f"{route} {tuple(geo) if geo else ''} {cs._r(ms)}")
            print(f"  k11 {name} w1 m={m} (each err <= TOL_K11; splits, blocks a split, "
                  f"columns; ms): " + "; ".join(line), flush=True)


def profile_rounds(cfg, device, iters: int, seconds: float) -> None:
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.ops import build
    from dllama_tpu_torch.utils import profiling

    build.build()  # every source at once, one nvcc each
    tmp = tempfile.mkdtemp(prefix="dllama_proof_profile_")
    mpath, tpath = os.path.join(tmp, "m.m"), os.path.join(tmp, "t.t")
    cs.write_model(mpath, cfg, device)
    cs.write_tokenizer(tpath, cfg.vocab_size)
    loaded = load_model(mpath, tpath, max_seq_len=4096, device=device)
    httpd, api, port = cs._obs_server(loaded)
    prompts = cs.batch_prompts(8)
    for it in range(iters):
        t0 = time.perf_counter()
        progress = [0] * len(prompts)

        def run(i, it=it, progress=progress):
            cs._sse(port, {"messages": [{"role": "user", "content": prompts[i]}],
                           "temperature": 0, "max_tokens": 128}, f"p{it}-{i}", progress, i)

        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        for th in threads:
            th.start()
        cs._wait_for(lambda: min(progress) >= 8, "every stream's 8th token")
        prof = cs._profile(port, seconds, tempfile.mkdtemp(prefix="dllama_proof_trace_"))
        for th in threads:
            th.join(timeout=120)
            if th.is_alive():
                print(f"round {it}: a stream stalled at {progress} tokens", flush=True)
                faulthandler.dump_traceback(all_threads=True)
                os._exit(1)
        cs._wait_for(lambda: cs._profile_done(prof["trace"]), "the trace", 120)
        os.remove(prof["trace"])
        print(f"round {it}: {time.perf_counter() - t0:.1f} s, the profile's stop and write "
              f"{profiling.profile_status()['last_written_s']:.1f} s", flush=True)
    cs._obs_close(httpd, api, "profile")
    print(f"profile: {iters} rounds, no stall", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="proof", required=True)
    sp = sub.add_parser("splits", help="K9's split rule against fixed tiles per split")
    sp.add_argument("--reps", type=int, default=20, help="timed runs per case")
    st = sub.add_parser("loopdot", help="K4's split counts and one ascending walk, timed")
    st.add_argument("--reps", type=int, default=20, help="timed runs per case")
    kp = sub.add_parser("k11", help="K11-B and K11-D on both routes, timed")
    kp.add_argument("--reps", type=int, default=20, help="timed runs per case")
    fp = sub.add_parser("profile", help="profiles during 8-stream decode, N rounds, no stall")
    fp.add_argument("--iters", type=int, default=30, help="rounds")
    fp.add_argument("--seconds", type=float, default=0.5, help="each profile's duration")
    pp = sub.add_parser("parity", help="save or compare K2/K7/K1/K5/K3/K4/K6 outputs bit for bit")
    pp.add_argument("--save", help="save the outputs here")
    pp.add_argument("--against", help="compare the outputs with this file")
    args = ap.parse_args(argv)
    if args.proof == "parity" and not (args.save or args.against):
        ap.error("parity needs --save or --against")

    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: these proofs need an NVIDIA GPU")
    device = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}", flush=True)
    cfg = cs.llama31_8b(cs.N_LAYERS_8B)
    if args.proof == "splits":
        print("splits (K9, page 128, Llama-3.1-8B heads, bf16):", flush=True)
        splits(cfg, device, cs.Timer(device, args.reps))
    elif args.proof == "loopdot":
        print("loopdot (K4 on the decode body, Llama-3.1-8B shapes):", flush=True)
        loopdot(cfg, device, cs.Timer(device, args.reps))
    elif args.proof == "k11":
        print("k11 (the kernel benchmark's K11-B and K11-D, both routes):", flush=True)
        k11(cfg, device, cs.Timer(device, args.reps))
    elif args.proof == "profile":
        print(f"profile ({args.iters} rounds of a {args.seconds} s profile during 8-stream "
              "decode):", flush=True)
        profile_rounds(cfg, device, args.iters, args.seconds)
    else:
        parity(cfg, device, args.save, args.against)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
