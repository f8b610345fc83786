"""Inference engine: prefill/decode steps over one model replica + the host
generation loop (the reference's RootLlmInference loop, app.cpp:131-195).

Prefill is chunked in power-of-two widths. Decode runs in chunks of up to
``chunk`` tokens: inside a chunk every sampled token stays on the device and
feeds the next forward directly, and the chunk's tokens reach the host in
one copy — one host round trip per chunk, not per token. Each chunk is a
program (engine/graphs.py): a prefill chunk one per token width, reading
its position from the device, a decode chunk one per (variant, n), a run of
speculative verify cycles one per (k, m); on a CUDA device each is a CUDA
graph, replayed; ``capture=False`` launches the same bodies from Python
instead, for comparison.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np
import torch

from dllama_tpu_torch.engine.graphs import Programs
from dllama_tpu_torch.obs import instruments as ins
from dllama_tpu_torch.engine.kernel_select import resolve_kernels, resolve_moe_impl
from dllama_tpu_torch.engine.sampling import Sampler, apply_penalties, sample_logits
from dllama_tpu_torch.engine.speculative import cycles_per_replay, spec_cycle
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.models.llama import KVCache, forward, fuse_layer_weights
from dllama_tpu_torch.ops.layers import build_rope_cache
from dllama_tpu_torch.parallel.collectives import (TPExchange, host_gather, host_scatter,
                                                   resolve_sync)
from dllama_tpu_torch.parallel.multihost import mirrored
from dllama_tpu_torch.parallel.pipeline import make_pp_forward
from dllama_tpu_torch.parallel.ring_attention import make_sp_attention

#: KV cache element types; e4m3 is the f8 cache (--cache-dtype f8)
CACHE_DTYPES = (torch.bfloat16, torch.float32, torch.float8_e4m3fn)


def pow2_chunk(remaining: int, max_chunk: int) -> int:
    """Largest power-of-two width <= min(max_chunk, remaining)."""
    c = min(max_chunk, 1 << (remaining - 1).bit_length())
    while c > remaining:
        c //= 2
    return c


@dataclass
class GenerationStats:
    """Per-token timing in the reference's report shape (dllama.cpp:93-104)."""

    prefill_tokens: int = 0
    prefill_s: float = 0.0
    decode_tokens: int = 0
    decode_s: float = 0.0
    spec_tokens: int = 0  # decode tokens that speculative cycles produced
    spec_cycles: int = 0  # their verify forwards

    @property
    def prefill_tok_s(self) -> float:
        return self.prefill_tokens / self.prefill_s if self.prefill_s else 0.0

    @property
    def decode_tok_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0

    def summary(self) -> str:
        return (
            f"Prefill: {self.prefill_tokens} tokens in {self.prefill_s*1000:.0f} ms "
            f"({self.prefill_tok_s:.1f} tok/s)\n"
            f"Decode:  {self.decode_tokens} tokens in {self.decode_s*1000:.0f} ms "
            f"({self.decode_tok_s:.1f} tok/s, {1000*self.decode_s/max(1,self.decode_tokens):.2f} ms/token)"
        ) + (f"\nSpeculation: {self.spec_tokens} tokens in {self.spec_cycles} verify forwards "
             f"({self.spec_tokens / self.spec_cycles:.2f} tokens/forward)"
             if self.spec_cycles else "")


class InferenceEngine:
    """Owns params + KV cache + the resolved kernels for one model replica
    on one device (``device``, default: the device the params lie on).
    ``capture`` (default: on for a CUDA device) runs each prefill and
    decode chunk as a captured CUDA graph.

    ``shardings`` (parallel/sharding.LlamaShardings) makes it one rank of a
    mesh: ``cfg`` is the model's, ``params`` the full tree or the rank's
    shards, and the engine runs the rank's view (``self.cfg``: its heads
    and FFN width) with the tp exchange ``sync`` ('bf16' | 'q80' | 'auto',
    parallel/collectives.resolve_sync). On dp the batch is replicated
    unless dp divides it (JAX's ``_batch_axis``); a replica of a divided
    batch runs its rows (``block``) and the logits are all-gathered over
    dp, so every rank samples the same tokens. On sp the cache holds the
    rank's sequence rows (and a trash row) and the attention is the ring's
    (parallel/ring_attention). On pp the rank is one GPipe stage
    (parallel/pipeline: its layers and their cache, ``pp_micro``
    microbatches, the logits broadcast from the last stage); on ep an MoE
    rank runs its experts and sums their partials over ep. Over gloo with
    CUDA tensors (ranks that share a card), and on any sp or pp mesh, the
    programs run eagerly; ``fuse_weights`` is ignored on a mesh, as in the
    JAX package. The
    methods marked ``mirrored`` are the calls rank 0 sends to the other
    ranks (parallel/multihost)."""

    def __init__(
        self,
        cfg: LlamaConfig,
        params: dict,
        batch: int = 1,
        cache_dtype=torch.bfloat16,
        max_seq_len: int | None = None,
        max_prefill_chunk: int = 256,
        kernels: str = "auto",  # 'auto' | 'cuda' | 'torch'
        fuse_weights: bool = False,  # wqkv/w13 fused launches (copies on the device)
        device=None,
        capture: bool | None = None,  # decode chunks as CUDA graphs (None: on a CUDA device)
        moe_impl: str = "auto",  # 'auto' | 'dispatch' | 'sort' | 'dense' (ops.layers.moe_ffn)
        shardings=None,  # parallel/sharding.LlamaShardings: one rank of a tp mesh
        sync: str = "bf16",  # the tp exchange: 'bf16' | 'q80' | 'auto'
        pp_micro: int = 1,  # GPipe microbatches on a pp mesh (batch % pp_micro == 0)
    ):
        if cache_dtype not in CACHE_DTYPES:
            raise ValueError(f"KV cache dtype {cache_dtype} is not one of {CACHE_DTYPES}")
        self.device = torch.device(device) if device is not None else params["embedding"].device
        self.shardings = shardings
        self.sync = resolve_sync(sync, shardings)
        check_pipeline(None if shardings is None else shardings.mesh.config, self.sync, batch,
                       pp_micro)
        self.exchange, capture = _mesh_setup(self, shardings, capture)
        if shardings is not None:
            cfg, params, fuse_weights = shardings.local_config(), shardings.put_params(
                params, self.device), False
        self.cfg = cfg
        self.params = params
        if fuse_weights:
            self.params = dict(params, layers=fuse_layer_weights(params["layers"]))
        self.batch = batch
        self.seq_len = min(max_seq_len or cfg.seq_len, cfg.seq_len)
        self.max_prefill_chunk = max_prefill_chunk
        self.rope_cache = build_rope_cache(cfg, self.seq_len, self.device)
        self.block, rows, sp_attn = _mesh_layout(shardings, self.exchange, batch, self.seq_len)
        self.cache = KVCache.create(cfg, self.block[1] - self.block[0], cache_dtype, rows,
                                    self.device)
        self.pos = 0
        self.moe_impl = resolve_moe_impl(moe_impl, shardings)
        sel = resolve_kernels(cfg, kernels, self.device, sp_attention=sp_attn)
        self.mm, self.attn_fn, self.norm = sel.mm, sel.attn_fn, sel.norm
        self.backend, self.attn_route = sel.backend, sel.attn_route
        self._pp = None if self.exchange is None or self.exchange.pp is None else \
            make_pp_forward(cfg, self.exchange, pp_micro, self.attn_fn, self.mm, self.moe_impl,
                            self.norm)
        self.forwards = 0  # forward passes run (each is one token column)
        # speculation (decode_spec_greedy_n): the device history, the
        # (count, cycles) pair a replay leaves, the tokens wanted, and an
        # output buffer a draft length, all made at the first call and only
        # ever refilled in place (the spec programs read them where they
        # were when captured); _spec_h = (pos, cur) when the history holds
        # the sequence up to pos (chunked-call reuse)
        self._spec_h = None
        self._spec_stats = None  # {emitted, cycles} of the last speculative call
        self._spec_hist: torch.Tensor | None = None
        self._spec_ctr: torch.Tensor | None = None
        self._spec_n: torch.Tensor | None = None
        self._spec_out: dict[int, torch.Tensor] = {}
        self._spec_host: torch.Tensor | None = None
        self.spec_replays = 0  # replays of the last speculative call
        # the programs and their static inputs: the fed token, the position
        # vector (every program advances it; _dev_pos is the host value it
        # holds after the last program, None before any), the sampling rows
        # (temperature, top-p, presence, frequency) and the occurrence counts
        # (made at the first penalized chunk); a prefill program's tokens
        # and logits are its own buffers
        self.programs = Programs(self.device, capture, tier="single")
        self._dec_tok = torch.zeros((batch, 1), dtype=torch.int64, device=self.device)
        self._dec_pos = torch.zeros(batch, dtype=torch.int32, device=self.device)
        self._dev_pos: int | None = None
        self._dec_samp = torch.zeros((4, batch), dtype=torch.float32, device=self.device)
        self._dec_counts: torch.Tensor | None = None

    def device_state(self) -> dict[str, torch.Tensor]:
        """Every engine-owned tensor a prefill, decode or spec program reads
        or writes, by name (BatchEngine.device_state's counterpart). A
        captured program holds their addresses, so no method may replace
        one: they are refilled in place, and the lazily made ones (the
        occurrence counts, the spec tensors) are made once."""
        out = {"cache.k": self.cache.k, "cache.v": self.cache.v, "token": self._dec_tok,
               "pos": self._dec_pos, "sampling": self._dec_samp}
        if self._dec_counts is not None:
            out["counts"] = self._dec_counts
        if self._spec_hist is not None:
            out.update({"spec.history": self._spec_hist, "spec.counters": self._spec_ctr,
                        "spec.n": self._spec_n})
        out.update({f"spec.out{k}": t for k, t in self._spec_out.items()})
        return out

    def _logits(self, tokens: torch.Tensor, pos, last_only: bool = True) -> torch.Tensor:
        """One forward at `pos` (an int, or a [B] tensor); returns f32
        logits: the last position's [B, V], or with ``last_only=False``
        every position's [B, T, V]. The caller counts it in ``forwards``.
        A dp replica of a divided batch runs its rows and all-gathers the
        logits over dp."""
        lo, hi = self.block
        sharded = hi - lo < self.batch
        if sharded:
            self.exchange.open_forward()  # the dp gather counts with the forward
            tokens = tokens[lo:hi]
            if isinstance(pos, torch.Tensor) and pos.dim() == 1:
                pos = pos[lo:hi]
        logits = self._run(tokens, pos, last_only)
        logits = logits[:, -1] if last_only else logits
        if sharded:
            logits = self.exchange.dp.all_gather(logits).reshape(
                self.batch, *logits.shape[1:])
            self.exchange.close_forward(self.batch, tokens.shape[1])
        return logits

    def _run(self, tokens: torch.Tensor, pos, last_only: bool, active=None) -> torch.Tensor:
        """The model's forward over this rank's cache -> f32 logits [B, T or
        1, V]: a pp stage's GPipe schedule (parallel/pipeline), else
        models/llama.forward."""
        if self._pp is not None:
            return self._pp(self.params, tokens, pos, self.cache, self.rope_cache, last_only,
                            active)
        logits, _ = forward(self.cfg, self.params, tokens, pos, self.cache, self.rope_cache,
                            self.attn_fn, self.mm, last_only=last_only, active=active,
                            moe_impl=self.moe_impl, exchange=self.exchange, norm=self.norm)
        return logits

    def measured_collective_report(self) -> dict:
        """The exchange of one decode step (a [batch, 1] forward) as this
        rank's collectives counted it: the bytes of each collective's
        result, by op (the JAX package's count of the compiled step's HLO
        collectives; another axis's op carries its name: "sp:all-reduce",
        "pp:send" (the bytes this stage sends), "pp:broadcast",
        "ep:all-reduce"). Empty before the first decode step, and on one
        device."""
        per_op = {} if self.exchange is None else dict(
            self.exchange.forward_bytes.get((self.batch, 1), {}))
        return {"total_bytes": sum(per_op.values()), "per_op": per_op}

    @torch.no_grad()
    def _forward(self, tokens: torch.Tensor, pos: int, last_only: bool = True) -> torch.Tensor:
        self.forwards += 1
        return self._logits(tokens, pos, last_only)

    def _check_room(self, n: int) -> None:
        if self.pos + n > self.seq_len:
            raise ValueError(f"position {self.pos}+{n} exceeds seq_len {self.seq_len}")

    # ------------------------------------------------------------------ core

    @mirrored
    def step(self, tokens) -> torch.Tensor:
        """Run T tokens at the current position; returns last-pos logits [B, V].
        The chunk is the prefill program of width T (the JAX package's
        ``_step`` of that width): the tokens go into its static [B, T]
        buffer, the position is the device vector the decode programs read,
        and the logits are copied out of its static [B, V] buffer in stream
        order, before another replay can overwrite them."""
        tokens = np.asarray(tokens, dtype=np.int64).reshape(self.batch, -1)
        width = tokens.shape[1]
        self._check_room(width)
        prog = self.programs.prefill(width, "dense", self._make_prefill)
        host = torch.from_numpy(tokens)
        if self.device.type == "cuda":
            host = host.pin_memory()  # the copy then does not wait for the card
        prog.buffers["toks"].copy_(host, non_blocking=True)
        self._load_pos()
        self._dev_pos = None  # unknown until the program has run
        prog.run()
        self.forwards += 1
        self.pos += width
        self._dev_pos = self.pos
        return prog.buffers["logits"].clone()

    def _load_pos(self) -> None:
        """Point the device position vector at ``pos`` when a rewind or
        another path moved it (no host read: the host knows what it holds)."""
        if self._dev_pos != self.pos:
            self._dec_pos.fill_(self.pos)

    def _make_prefill(self, width: int, layout: str):
        """(body, buffers, state) of the prefill program of `width` tokens:
        one forward at the device position, which it advances by `width`;
        the last position's logits go to ``buffers["logits"]`` [B, V]."""
        toks = torch.zeros((self.batch, width), dtype=torch.int64, device=self.device)
        out = torch.zeros((self.batch, self.cfg.vocab_size), dtype=torch.float32,
                          device=self.device)
        pos0 = self._dec_pos

        def body():
            out.copy_(self._logits(toks, pos0))
            pos0.add_(width)

        return body, {"toks": toks, "logits": out}, (pos0,)

    @mirrored
    def reset(self, pos: int = 0) -> None:
        """Rewind to `pos` (prefix-cache reuse keeps cache contents <= pos valid)."""
        self.pos = pos

    # -------------------------------------------------------------- sessions

    def session_fingerprint(self) -> str:
        """The geometry, cache dtype and weights a session file is bound to:
        the unsharded engine's on every rank of every mesh (the model's
        config, the unsharded tree's digest), so a session crosses between
        any mesh and one device."""
        c = self.cfg if self.shardings is None else self.shardings.cfg
        dtype = str(self.cache.k.dtype).removeprefix("torch.")
        return (f"{c.dim}:{c.n_layers}:{c.n_kv_heads}:{c.head_size}:"
                f"{self.seq_len}:{self.batch}:{dtype}:{self._params_digest()}")

    def _params_digest(self) -> str:
        """params_digest of this engine's tree: on a mesh the unsharded
        tree's, which the world computed when it built its engines."""
        if self.shardings is not None and self.shardings.params_digest is not None:
            return self.shardings.params_digest
        if not hasattr(self, "_digest"):
            self._digest = params_digest(self.params, self.shardings)
        return self._digest

    def save_session(self, path: str) -> None:
        """Persist the KV cache and the position (npz): the cache's bytes as
        uint8 with the dtype's name (an f8 cache round-trips byte for byte),
        ``pos`` and this engine's fingerprint. On a mesh every rank's block
        is gathered to rank 0 (session_cache), which writes the file the
        same model would write on one device; the file is on rank 0's host."""
        k, v = self.session_cache()
        np.savez_compressed(path, fingerprint=self.session_fingerprint(),
                            cache_dtype=str(self.cache.k.dtype).removeprefix("torch."),
                            pos=self.pos, k=k.numpy(), v=v.numpy())

    @mirrored
    @torch.no_grad()
    def session_cache(self) -> tuple[torch.Tensor, torch.Tensor] | None:
        """The unsharded KV cache's bytes (k, v as uint8 on the host): on a
        mesh each rank's block (parallel/sharding.cache_block, an sp rank's
        trash row left out) gathered to rank 0; None on the other ranks."""
        k, v = (t.detach().to("cpu").contiguous().view(torch.uint8)
                for t in (self.cache.k, self.cache.v))
        if self.shardings is None:
            return k, v
        sh = self.shardings
        rows = sh.seq_block(self.seq_len)[1]
        blocks = host_gather(sh.mesh, (sh.cache_block(self.batch, self.seq_len),
                                       k[:, :, :, :rows].clone(), v[:, :, :, :rows].clone()))
        if blocks is None:
            return None
        c = sh.cfg
        shape = (c.n_layers, self.batch, c.n_kv_heads, self.seq_len, k.shape[-1])
        full_k, full_v = torch.empty(shape, dtype=torch.uint8), torch.empty(shape,
                                                                            dtype=torch.uint8)
        for block, bk, bv in blocks:
            full_k[block], full_v[block] = bk, bv
        return full_k, full_v

    def load_session(self, path: str) -> None:
        """Restore a saved session INTO the existing cache tensors (``copy_``):
        the captured prefill, decode and spec programs hold their addresses,
        so the cache is never replaced. Raises ValueError when the file's
        fingerprint (geometry, dtype, weights) is not this engine's. On a
        mesh rank 0 reads the file (session_restore): every rank checks the
        fingerprint before any exchange, then takes its block."""
        with np.load(path) as data:
            fp = str(data["fingerprint"])
        self.session_restore(path, fp)

    @mirrored
    @torch.no_grad()
    def session_restore(self, path: str, fingerprint: str) -> None:
        """load_session's body on every rank: the fingerprint check (a
        settled ValueError on every rank), then rank 0 reads the file and
        each rank copies its block (parallel/sharding.cache_block) and the
        position into place."""
        if fingerprint != self.session_fingerprint():
            raise ValueError(f"session file does not match this engine: {fingerprint!r} != "
                             f"{self.session_fingerprint()!r}")
        sh = self.shardings
        if sh is None or sh.mesh.rank == 0:
            with np.load(path) as data:
                k, v = (torch.from_numpy(np.ascontiguousarray(data[n])) for n in ("k", "v"))
                pos = int(data["pos"])
        if sh is None:
            blocks = (k, v, pos)
        else:
            blocks = host_scatter(sh.mesh, [
                (k[b].clone(), v[b].clone(), pos)
                for b in (sh.cache_block(self.batch, self.seq_len, r)
                          for r in range(sh.mesh.size))] if sh.mesh.rank == 0 else None)
        bk, bv, pos = blocks
        for dst, raw in ((self.cache.k, bk), (self.cache.v, bv)):
            raw = raw.view(dst.dtype)  # an sp rank's trash row stays as it is
            dst[:, :, :, : raw.shape[3]].copy_(raw)
        self.pos = pos
        self._dev_pos = None  # the device position is reloaded before the next program
        self._spec_h = None  # the spec history no longer describes the cache

    @mirrored
    def prefill(self, tokens) -> torch.Tensor:
        """Chunked prefill; returns logits after the last token."""
        tokens = np.atleast_2d(np.asarray(tokens, dtype=np.int64))
        n = tokens.shape[1]
        if n == 0:
            raise ValueError("prompt must be non-empty")
        logits = None
        off = 0
        while off < n:
            chunk = pow2_chunk(n - off, self.max_prefill_chunk)
            logits = self.step(tokens[:, off : off + chunk])
            off += chunk
        return logits

    @mirrored
    def decode_step(self, tokens) -> torch.Tensor:
        return self.step(np.asarray(tokens, dtype=np.int64).reshape(self.batch, 1))

    def _make_program(self, variant: str, n: int):
        """(body, buffers, state) of the n-step decode program `variant`
        (engine/graphs.py): the n-step loop over the static inputs, each
        step's token written into ``buffers["toks"]`` [n, B]."""
        b = self.batch
        toks = torch.zeros((n, b), dtype=torch.int64, device=self.device)
        buffers = {"toks": toks}
        if variant != "greedy":
            buffers["uniforms"] = torch.zeros((n, b, 2), dtype=torch.float32,
                                              device=self.device)
        tok0, pos0, samp = self._dec_tok, self._dec_pos, self._dec_samp
        counts = self._dec_counts if variant == "penalized" else None
        rows = torch.arange(b, device=self.device)

        def body():
            tok, pos = tok0, pos0
            for i in range(n):
                logits = self._logits(tok, pos)
                if counts is not None:
                    # the fed token counts before its successor is sampled
                    counts[rows, tok[:, 0]] += 1
                    logits = apply_penalties(logits, counts, samp[2], samp[3])
                if variant == "greedy":
                    nxt = torch.argmax(logits, dim=-1)
                else:
                    nxt = sample_logits(logits, samp[0], samp[1],
                                        uniforms=buffers["uniforms"][i])
                toks[i].copy_(nxt)
                tok, pos = nxt[:, None], pos + 1
            tok0.copy_(tok)
            pos0.copy_(pos)

        return body, buffers, (tok0, pos0) + ((counts,) if counts is not None else ())

    @mirrored
    @torch.no_grad()
    def _decode_chunk(self, variant: str, token, n: int, sampler: Sampler | None = None,
                      counts=None) -> np.ndarray:
        """Load the static inputs, run the n-step program `variant` and copy
        its tokens [n, B] to the host. A sampled chunk draws its uniforms
        [n, B, 2] from the sampler's generator in one call, before the
        program runs (a graph cannot draw from a host-seeded generator)."""
        self._check_room(n)
        if variant == "penalized" and self._dec_counts is None:
            self._dec_counts = torch.zeros((self.batch, self.cfg.vocab_size),
                                           dtype=torch.int32, device=self.device)
        prog = self.programs.get(variant, n, self._make_program)
        self._dec_tok.copy_(torch.as_tensor(np.asarray(token, dtype=np.int64)).reshape(
            self.batch, 1))
        self._load_pos()
        if variant != "greedy":
            self._dec_samp.copy_(torch.tensor(
                [sampler.temperature, sampler.topp, sampler.presence, sampler.frequency],
                dtype=torch.float32)[:, None].expand(4, self.batch))
            if sampler.temperature != 0.0:
                prog.buffers["uniforms"].uniform_(generator=sampler.generator(self.device))
        if variant == "penalized":
            self._dec_counts.copy_(torch.as_tensor(
                np.asarray(counts, dtype=np.int32)).reshape(self.batch, -1))
        self._dev_pos = None  # unknown until the program has run
        prog.run()
        self.forwards += n
        self.pos += n
        self._dev_pos = self.pos
        return prog.buffers["toks"].cpu().numpy()

    def decode_greedy_n(self, token, n: int) -> np.ndarray:
        """n greedy decode steps; the tokens stay on the device until the one
        copy at the end. Returns tokens [n, B]."""
        return self._decode_chunk("greedy", token, n)

    @mirrored
    def decode_spec_greedy_n(self, history, token: int, n: int, k: int = 8,
                             ngram: int = 2) -> np.ndarray:
        """n exact-greedy tokens via prompt-lookup speculative decoding
        (engine/speculative.py): up to k tokens drafted from the sequence's
        own n-gram statistics are verified per forward, so repetitive text
        decodes several tokens per weight sweep. The tokens are
        decode_greedy_n's; only the forward count changes.

        ``history``: the tokens already FED, most recent last — the full
        prompt and continuation, or any suffix of it (a chat turn's delta:
        earlier positions are marked unknown and cannot be drafted from).
        ``token``: the last sampled, not yet fed token. Batch-1 engines only.
        ``_spec_stats`` records {emitted, cycles} of the call (emitted /
        cycles is the realised speedup). A call that continues exactly where
        the last one stopped reuses the history on the device.

        The cycles run as spec programs (engine/graphs.py, keyed
        ("single_spec", k, m, ngram)): each replay runs m cycles of
        speculative.spec_cycle with the loop condition on the device, then
        the host reads the count and the cycles once (one small copy behind
        one event) and replays again while fewer than n tokens are out and a
        (k+1)-row window still fits.
        m is speculative.cycles_per_replay: the largest power of two no
        larger than the cycles that cannot freeze even at full acceptance,
        so no replay runs a frozen (wasted) forward. A 32-token call at k = 8
        takes 1 replay (4 cycles) at full acceptance and 18 replays (32
        cycles) at acceptance 0; ``spec_replays`` records the last call's.
        Returns the tokens [<= n]; fewer than n only where the context has
        no room for another (k+1)-row window."""
        if self.batch != 1:
            raise ValueError(
                f"decode_spec_greedy_n drives a single sequence (batch==1, got batch="
                f"{self.batch}); batched speculation runs on the continuous-batching "
                "BatchEngine (spec=K)")
        self._check_room(n)
        self._ensure_spec(k)
        if self._spec_h != (self.pos, int(token)):
            hist = np.asarray(history, dtype=np.int64).reshape(-1)
            if hist.shape[0] > self.pos:
                raise ValueError(f"history length {hist.shape[0]} > pos {self.pos}")
            # unknown earlier positions hold -1: no real token id equals -1,
            # so the n-gram matcher can never draft across the unknown region
            hb = np.full(self.seq_len + 1, -1, np.int64)
            hb[self.pos - hist.shape[0] : self.pos] = hist
            hb[self.pos] = token
            host = torch.from_numpy(hb)
            if self.device.type == "cuda":
                host = host.pin_memory()
            self._spec_hist.copy_(host, non_blocking=True)
        self._dec_tok.fill_(int(token))
        self._load_pos()
        self._spec_ctr.zero_()
        self._spec_n.fill_(int(n))
        self._dev_pos = None  # unknown until the programs have run
        pos0, cnt, cyc, self.spec_replays = self.pos, 0, 0, 0
        while cnt < n and pos0 + cnt + k + 1 <= self.seq_len:
            m = cycles_per_replay(n - cnt, pos0 + cnt, k, self.seq_len)
            self.programs.spec(k, m, ngram, self._make_spec).run()
            cnt, cyc = self._spec_read()
            self.spec_replays += 1
        self.forwards += cyc
        self._dev_pos = pos0 + cnt
        m = min(n, cnt)
        toks = self._spec_out[k][:m].cpu().numpy() if m else np.zeros(0, np.int64)
        # overshoot rewind: emitted tokens beyond n were fed rows we do not
        # keep (the stale-row invariant of generate's mid-chunk rewind); the
        # history stays valid for the rewound position: index pos+m holds
        # toks[m-1]
        self.pos += m
        self._spec_stats = {"emitted": cnt, "cycles": cyc}
        self._spec_h = (self.pos, int(toks[m - 1])) if m else None
        return toks.astype(np.int64)

    def _ensure_spec(self, k: int) -> None:
        """Make the spec programs' static tensors once (the output buffer
        once a draft length)."""
        dev = self.device
        if self._spec_hist is None:
            self._spec_hist = torch.full((self.seq_len + 1,), -1, dtype=torch.int64, device=dev)
            self._spec_ctr = torch.zeros(2, dtype=torch.int64, device=dev)
            self._spec_n = torch.zeros(1, dtype=torch.int64, device=dev)
            if dev.type == "cuda":
                self._spec_host = torch.zeros(2, dtype=torch.int64, pin_memory=True)
        if k not in self._spec_out:
            self._spec_out[k] = torch.zeros(self.seq_len + k + 1, dtype=torch.int64, device=dev)

    def _spec_read(self) -> tuple[int, int]:
        """(count, cycles) after a replay: the call's one read of a device
        value a replay (a small copy to pinned memory behind an event)."""
        if self._spec_host is None:
            cnt, cyc = self._spec_ctr.tolist()
            return int(cnt), int(cyc)
        self._spec_host.copy_(self._spec_ctr, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        event.synchronize()
        cnt, cyc = self._spec_host.tolist()
        return int(cnt), int(cyc)

    def _make_spec(self, k: int, m: int, ngram: int):
        """(body, buffers, state) of the spec program of m cycles at draft
        length k: speculative.spec_cycle m times over the static history,
        the fed token and position vectors the decode programs share, the
        (count, cycles) pair and the draft length's output buffer."""
        h, ctr, n, out = self._spec_hist, self._spec_ctr, self._spec_n, self._spec_out[k]
        cur, pos = self._dec_tok.view(-1), self._dec_pos
        cnt, cyc = ctr[0:1], ctr[1:2]

        def fwd(toks, p, live):
            return self._run(toks, p, False, live)

        def body():
            for _ in range(m):
                spec_cycle(fwd, h, cur, pos, cnt, cyc, out, n, k, ngram, self.seq_len)

        return body, {"out": out, "ctr": ctr}, (h, self._dec_tok, pos, ctr, out)

    def decode_sample_n(self, token, n: int, sampler: Sampler,
                        counts: np.ndarray | None = None) -> np.ndarray:
        """n sampled decode steps on the device; returns tokens [n, B].
        ``counts`` ([B, V] occurrence counts of the text so far, EXCLUDING
        the unfed ``token``, which is counted before its successor is
        sampled) applies the sampler's presence/frequency penalties."""
        if counts is not None and sampler.has_penalties:
            return self._decode_chunk("penalized", token, n, sampler, counts)
        if sampler.temperature == 0.0:
            return self._decode_chunk("greedy", token, n)
        return self._decode_chunk("sampled", token, n, sampler)

    # ------------------------------------------------------------- generation

    def generate(
        self,
        prompt_tokens: list[int],
        max_tokens: int,
        sampler: Sampler,
        stop_fn: Callable[[int], bool] | None = None,
        stats: GenerationStats | None = None,
        chunk: int = 8,
        spec: int = 0,
    ) -> Iterator[int]:
        """Host generation loop: prefill the prompt, then decode in device
        chunks of up to `chunk` tokens. Yields each token id; stops at
        max_tokens, seq_len, or when `stop_fn(token)` returns True. On an
        early stop mid-chunk the position is rewound so the KV cache stays
        prefix-consistent (rows past pos are masked, so over-decoded rows are
        harmless).

        ``spec`` > 0 decodes GREEDY runs (temperature 0, no penalties) by
        prompt-lookup speculation with that draft length
        (decode_spec_greedy_n): the same tokens in fewer forwards on
        repetitive text. Sampled or penalized runs ignore it, and so does a
        chunk with no room left for a draft window."""
        assert self.batch == 1, "generate() drives a single sequence; use step() for batches"
        # penalized greedy is the argmax of MODIFIED logits: drafts are
        # verified against the raw argmax, so penalties take the plain loop
        use_spec = spec > 0 and sampler.temperature == 0.0 and not sampler.has_penalties
        penalized = sampler.has_penalties
        t0 = time.perf_counter()
        logits = self.prefill(np.asarray([prompt_tokens], dtype=np.int64))
        if penalized:
            # OpenAI semantics: counts cover tokens SAMPLED in this completion
            # only; the first token is penalty-free (all counts zero)
            v = logits.shape[-1]
            text: list[int] = []
        token = int(sampler(logits)[0])  # the copy to the host waits for the device
        t1 = time.perf_counter()
        if stats is not None:
            stats.prefill_tokens += len(prompt_tokens)
            stats.prefill_s += t1 - t0
        # the registry's mirror of the stats marks (one sample for the whole
        # chunked prefill; the token's copy to the host made it device-real)
        ins.PREFILL_CHUNK_SECONDS.observe(t1 - t0)
        ins.PREFILL_TOKENS.inc(len(prompt_tokens))
        ins.TOKENS_GENERATED.inc()  # the prefill-sampled first token

        fed = list(prompt_tokens) if use_spec else None
        produced = 0
        yield token
        produced += 1
        if stop_fn is not None and stop_fn(token):
            return
        while produced < max_tokens and self.pos < self.seq_len:
            c = min(chunk, max_tokens - produced, self.seq_len - self.pos)
            start_pos = self.pos
            t2 = time.perf_counter()
            if use_spec and self.pos + c + spec + 1 > self.seq_len:
                use_spec = False  # no head-room for a draft window
            if use_spec:
                flat = self.decode_spec_greedy_n(fed, token, c, k=spec)
                c = len(flat)
                if c == 0:
                    break
                if stats is not None:
                    stats.spec_tokens += c
                    stats.spec_cycles += self._spec_stats["cycles"]
                fed.extend([token] + [int(t) for t in flat[:-1]])
                toks = flat[:, None]
            elif penalized:
                counts = np.bincount(text, minlength=v)[None, :v]
                toks = self.decode_sample_n(np.array([[token]]), c, sampler, counts=counts)
                text.append(token)
                text.extend(int(t) for t in toks[:-1, 0])
            else:
                toks = self.decode_sample_n(np.array([[token]]), c, sampler)
            if stats is not None:
                stats.decode_tokens += c
                stats.decode_s += time.perf_counter() - t2
            ins.DECODE_CHUNK_SECONDS.observe(time.perf_counter() - t2)
            for i in range(c):
                token = int(toks[i, 0])
                # counted at hand-off: after the yield it would never run for
                # the last token of a stop-terminated iteration
                ins.TOKENS_GENERATED.inc()
                yield token
                produced += 1
                stopped = stop_fn is not None and stop_fn(token)
                if stopped or produced >= max_tokens:
                    if i + 1 < c:
                        # rewind over-decoded rows (the valid prefix ends after
                        # the row written when sampling this token)
                        self.reset(start_pos + i + 1)
                    if stopped:
                        return
                    break


def _named_leaves(tree, name: str = ""):
    """(name, tensor) of every leaf, dict keys sorted and a dataclass's
    fields in order (a QTensor's packed bytes, then its scales), each named
    as parallel/sharding names its leaf ('embedding', 'layers.wq')."""
    if isinstance(tree, torch.Tensor):
        yield name, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{name}.{k}" if name else k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _named_leaves(v, name)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _named_leaves(getattr(tree, f.name), name)


def params_digest(params: dict, shardings=None, gather=None) -> str:
    """Cheap weight-identity hash of a parameter tree, so a session saved
    against one checkpoint refuses to resume on another of the same
    geometry: every leaf's shape and dtype, plus the first four values of
    up to 8 leaves (a handful of scalars, not a weights hash). The JAX
    package hashes its own leaves the same way; the two digests differ, as
    the two packages' sessions are their own.

    On a mesh (``shardings``: one rank's tree) the digest is the unsharded
    tree's: each leaf's shape there (LlamaShardings.leaf_block), and each
    sampled value from the rank that holds it, every rank's share pooled by
    ``gather`` (a rank's list -> every rank's lists, as
    collectives.host_all_gather; None: this rank's share alone)."""
    flat = list(_named_leaves(params))
    blocks = [((tuple(leaf.shape), (0,) * leaf.dim()) if shardings is None
               else shardings.leaf_block(name, leaf.shape)) for name, leaf in flat]
    h = hashlib.sha1()
    for (full, _), (_, leaf) in zip(blocks, flat):
        h.update(f"{full}{leaf.dtype}".encode())
    picked = list(range(len(flat)))[:: max(1, len(flat) // 8)]
    mine = []  # (leaf, flat index in the unsharded leaf, the value's bytes) held here
    for i in picked:
        leaf, (full, start) = flat[i][1], blocks[i]
        for j in range(min(4, int(np.prod(full)))):
            at = np.unravel_index(j, full)
            local = tuple(int(a) - s for a, s in zip(at, start))
            if all(0 <= a < n for a, n in zip(local, leaf.shape)):
                mine.append((i, j, leaf[local].reshape(1).to("cpu").view(torch.uint8)
                             .numpy().tobytes()))
    held = {}
    for share in (gather(mine) if gather is not None else [mine]):
        for i, j, b in share:
            held[i, j] = b
    for i in picked:
        h.update(b"".join(held.get((i, j), b"")
                          for j in range(min(4, int(np.prod(blocks[i][0]))))))
    return h.hexdigest()[:16]


def check_pipeline(config, sync: str, batch: int, pp_micro: int) -> None:
    """Raise, with the JAX package's messages, for a pp mesh (``config``:
    parallel/mesh.MeshConfig, or None) this engine cannot run: ``--sync
    q80`` with tp > 1, or a ``pp_micro`` below 1 or not dividing the
    batch. Off pp nothing is checked (pp_micro is ignored)."""
    if config is None or config.pp == 1:
        return
    if sync == "q80" and config.tp > 1:
        raise ValueError("--sync q80 is not supported on pp meshes yet")
    if pp_micro < 1 or batch % pp_micro != 0:
        raise ValueError(f"pp_micro must be >= 1 and divide batch; got pp_micro={pp_micro} "
                         f"batch={batch}")


def _mesh_setup(engine, shardings, capture):
    """(exchange, capture) of an engine on `shardings` (None and `capture`
    off a mesh): the rank's TPExchange, and capture off where the
    exchange is staged through the host (gloo on CUDA tensors), which no
    CUDA graph can hold, and on an sp or pp mesh, whose ring's or stage
    hop's point-to-point exchange runs eagerly."""
    if shardings is None:
        return None, capture
    ex = TPExchange(shardings.mesh, engine.sync, shardings.ffn_sharded,
                    shardings.logits_sharded)
    if ex.staged or ex.sp is not None or ex.pp is not None:
        if capture:
            raise ValueError("a mesh over gloo on CUDA tensors, or with sp > 1 or pp > 1, "
                             "runs its programs eagerly (capture=False)")
        capture = False
    return ex, capture


def _mesh_layout(shardings, exchange, batch: int, seq_len: int):
    """(block, rows, sp attention) of an engine's cache: the batch rows
    [lo, hi) it holds (parallel/sharding.batch_block), the rows a layer's
    cache holds (an sp rank's sequence rows plus its trash row), and the
    sp rank's attention (parallel/ring_attention.SPAttention), or None."""
    if shardings is None:
        return (0, batch), seq_len, None
    block = shardings.batch_block(batch)
    if exchange.sp is None:
        return block, seq_len, None
    _, rows = shardings.seq_block(seq_len)
    return block, rows + 1, make_sp_attention(exchange, rows)
