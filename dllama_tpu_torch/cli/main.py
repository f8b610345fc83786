"""CLI frontend — the reference's `dllama` binary (dllama.cpp:207-229,
app.cpp:21-110) on PyTorch.

Modes:
  inference  one-shot generation from --prompt, with the tok/s summary
  chat       REPL with chat template + streaming EOS detection
  serve      OpenAI-compatible HTTP server (the `dllama-api` binary's role)
  info       print the model header

Everything runs on one device, `--device cuda` (the default) or
`--device cpu`. Without a CUDA device the CLI stops with an error unless the
CPU was asked for. Options of the JAX package that this package has not
ported yet are accepted by name and refused with a clear message (exit 2);
the batched tier's `auto` defaults for features not yet ported (radix prefix
tree, hybrid chunked prefill, preemption) resolve to off, with one logged
line each. `--spec K` (prompt-lookup speculative decoding) drives the
single-engine paths; with `--slots > 0` it is refused.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np
import torch

CACHE_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "f8": torch.float8_e4m3fn}


class NotPorted(Exception):
    """An option the PyTorch/CUDA package does not support yet."""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dllama-tpu-torch",
        description="distributed-llama inference on PyTorch + hand-written CUDA kernels",
    )
    p.add_argument("mode", choices=["inference", "chat", "serve", "info"])
    p.add_argument("--model", required=True, help=".m model file")
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
    p.add_argument("--port", type=int, default=9990, help="HTTP port (serve mode)")
    p.add_argument("--host", default="127.0.0.1", help="HTTP bind address (serve mode)")
    p.add_argument("--sse-heartbeat-s", type=float, default=15.0,
                   help="serve mode: `: keep-alive` frame on streams idle this long")
    p.add_argument("--replica-id", default=None,
                   help="serve mode: identity stamped on every response")
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
    p.add_argument("--overlap", choices=["on", "off"], default="on",
                   help="batched tier: launch decode chunk N+1 before consuming chunk N")
    # accepted by name, refused until ported
    p.add_argument("--frontend", choices=["aio", "threads"], default="threads",
                   help="serve mode transport (aio is not yet ported)")
    p.add_argument("--radix-cache", choices=["auto", "on", "off"], default="auto",
                   help="radix prefix tree (not yet ported: auto resolves to off)")
    p.add_argument("--prefill-budget", default="auto",
                   help="hybrid chunked prefill (not yet ported: auto resolves to 0)")
    p.add_argument("--preempt", choices=["auto", "on", "off"], default="auto",
                   help="preemption (not yet ported: auto resolves to off)")
    p.add_argument("--kv-host-pages", type=int, default=0,
                   help="host-RAM KV spill tier (not yet ported)")
    p.add_argument("--tenant-weight", action="append", default=[],
                   help="fair-queue tenant weight NAME=W (not yet ported)")
    p.add_argument("--warmup", choices=["auto", "off"], default="off",
                   help="boot precompile (not yet ported)")
    p.add_argument("--restart-max", type=int, default=0,
                   help="warm engine restarts (not yet ported)")
    p.add_argument("--spec", type=int, default=0, metavar="K",
                   help="prompt-lookup speculative decoding with K-token drafts for "
                        "greedy runs (inference, chat, serve on the single-engine "
                        "tier; a request's spec_k clamps to K); same tokens, fewer "
                        "forwards on repetitive text. Not yet ported with --slots > 0")
    p.add_argument("--mesh", default=None, help="device mesh (not yet ported)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _refuse_unported(args) -> None:
    if args.spec and args.mode == "serve" and args.slots > 0:
        raise NotPorted("--spec with --slots > 0 (batched speculative decoding)")
    if args.radix_cache == "on":
        raise NotPorted("--radix-cache on (the radix prefix tree)")
    if args.prefill_budget not in ("auto", "0"):
        raise NotPorted("--prefill-budget N > 0 (hybrid chunked prefill)")
    if args.preempt == "on":
        raise NotPorted("--preempt on")
    if args.kv_host_pages:
        raise NotPorted("--kv-host-pages (the host-RAM KV spill tier)")
    if args.tenant_weight:
        raise NotPorted("--tenant-weight")
    if args.warmup != "off":
        raise NotPorted("--warmup")
    if args.restart_max:
        raise NotPorted("--restart-max (warm engine restarts)")
    if args.mesh is not None:
        raise NotPorted("--mesh (multi-device meshes)")
    if args.frontend == "aio":
        raise NotPorted("--frontend aio")


def _load(args):
    from dllama_tpu_torch.engine import sampling
    from dllama_tpu_torch.engine.loader import load_model

    if args.exact_topp:
        sampling.NUCLEUS_K = None
    return load_model(
        args.model,
        args.tokenizer,
        max_seq_len=args.max_seq_len,
        cache_dtype=CACHE_DTYPES[args.cache_dtype],
        max_prefill_chunk=args.max_prefill_chunk,
        kernels=args.kernels,
        fuse_weights=args.fuse_weights,
        device=args.device,
    )


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
    return 0


def cmd_inference(args) -> int:
    from dllama_tpu_torch.engine.engine import GenerationStats

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
    tok.reset_decoder()
    for t in m.engine.generate(prompt_tokens, max_tokens, sampler, stop_fn=tok.is_eos,
                               stats=stats, spec=args.spec):
        piece = tok.decode(t)
        if piece:
            print(piece, end="", flush=True)
    print()
    print(stats.summary(), file=sys.stderr)
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
    m = _load(args)
    if args.slots > 0:
        log = logging.getLogger("dllama_tpu_torch.cli")
        for flag, value in (("--radix-cache", "off"), ("--prefill-budget", "0"),
                            ("--preempt", "off")):
            if getattr(args, flag[2:].replace("-", "_")) == "auto":
                log.warning("%s auto -> %s: the feature is not yet ported to the "
                            "PyTorch/CUDA package", flag, value)
    return run_server(
        m, host=args.host, port=args.port, n_slots=args.slots,
        default_temperature=args.temperature, default_topp=args.topp,
        default_seed=args.seed, frontend=args.frontend,
        sse_heartbeat_s=args.sse_heartbeat_s, replica_id=args.replica_id,
        drain_timeout_s=args.drain_timeout_s, kv_layout=args.kv_layout,
        page_size=args.page_size, kv_pages=args.kv_pages, max_queue=args.max_queue,
        overlap=args.overlap == "on", spec=args.spec,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    try:
        _refuse_unported(args)
    except NotPorted as e:
        print(f"{e} is not yet ported to the PyTorch/CUDA package", file=sys.stderr)
        return 2
    if args.mode != "info" and args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device was found; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 1
    return {
        "info": cmd_info,
        "inference": cmd_inference,
        "chat": cmd_chat,
        "serve": cmd_serve,
    }[args.mode](args)


if __name__ == "__main__":
    raise SystemExit(main())
