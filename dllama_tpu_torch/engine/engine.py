"""Inference engine: prefill/decode steps over one model replica + the host
generation loop (the reference's RootLlmInference loop, app.cpp:131-195).

Prefill is chunked in power-of-two widths. Decode runs in chunks of up to
``chunk`` tokens: inside a chunk every sampled token stays on the device and
feeds the next forward directly, and the chunk's tokens reach the host in
one copy — one host round trip per chunk, not per token.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np
import torch

from dllama_tpu_torch.engine.kernel_select import resolve_kernels
from dllama_tpu_torch.engine.sampling import Sampler, apply_penalties, sample_logits
from dllama_tpu_torch.engine.speculative import spec_decode
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.models.llama import KVCache, forward, fuse_layer_weights
from dllama_tpu_torch.ops.layers import build_rope_cache

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
    on one device (``device``, default: the device the params lie on)."""

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
    ):
        if cache_dtype not in CACHE_DTYPES:
            raise ValueError(f"KV cache dtype {cache_dtype} is not one of {CACHE_DTYPES}")
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else params["embedding"].device
        self.params = params
        if fuse_weights:
            self.params = dict(params, layers=fuse_layer_weights(params["layers"]))
        self.batch = batch
        self.seq_len = min(max_seq_len or cfg.seq_len, cfg.seq_len)
        self.max_prefill_chunk = max_prefill_chunk
        self.rope_cache = build_rope_cache(cfg, self.seq_len, self.device)
        self.cache = KVCache.create(cfg, batch, cache_dtype, self.seq_len, self.device)
        self.pos = 0
        sel = resolve_kernels(cfg, kernels, self.device)
        self.mm, self.attn_fn = sel.mm, sel.attn_fn
        self.backend, self.attn_route = sel.backend, sel.attn_route
        self.forwards = 0  # forward passes run (each is one token column)
        self._spec_h = None  # (device history, pos, cur): chunked-call reuse
        self._spec_stats = None  # {emitted, cycles} of the last speculative call

    @torch.no_grad()
    def _forward(self, tokens: torch.Tensor, pos: int, last_only: bool = True) -> torch.Tensor:
        """One forward at `pos`; returns f32 logits: the last position's [B,
        V], or with ``last_only=False`` every position's [B, T, V]."""
        self.forwards += 1
        logits, self.cache = forward(self.cfg, self.params, tokens, pos, self.cache,
                                     self.rope_cache, self.attn_fn, self.mm,
                                     last_only=last_only)
        return logits[:, -1] if last_only else logits

    def _check_room(self, n: int) -> None:
        if self.pos + n > self.seq_len:
            raise ValueError(f"position {self.pos}+{n} exceeds seq_len {self.seq_len}")

    # ------------------------------------------------------------------ core

    def step(self, tokens) -> torch.Tensor:
        """Run T tokens at the current position; returns last-pos logits [B, V]."""
        tokens = np.asarray(tokens, dtype=np.int64)
        self._check_room(tokens.shape[1])
        logits = self._forward(torch.from_numpy(tokens).to(self.device), self.pos)
        self.pos += tokens.shape[1]
        return logits

    def reset(self, pos: int = 0) -> None:
        """Rewind to `pos` (prefix-cache reuse keeps cache contents <= pos valid)."""
        self.pos = pos

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

    def decode_step(self, tokens) -> torch.Tensor:
        return self.step(np.asarray(tokens, dtype=np.int64).reshape(self.batch, 1))

    def _token_tensor(self, token) -> torch.Tensor:
        return torch.as_tensor(np.asarray(token, dtype=np.int64)).reshape(
            self.batch, 1).to(self.device)

    def decode_greedy_n(self, token, n: int) -> np.ndarray:
        """n greedy decode steps; the tokens stay on the device until the one
        copy at the end. Returns tokens [n, B]."""
        self._check_room(n)
        tok = self._token_tensor(token)
        out = []
        for i in range(n):
            tok = torch.argmax(self._forward(tok, self.pos + i), dim=-1, keepdim=True)
            out.append(tok)
        self.pos += n
        return torch.cat(out, dim=1).T.cpu().numpy()

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
        the last one stopped reuses the history on the device. Each verify
        cycle reads its accepted count on the host (speculative.spec_decode).
        Returns the tokens [<= n]; fewer than n only where the context has no
        room for another (k+1)-row window."""
        if self.batch != 1:
            raise ValueError(
                f"decode_spec_greedy_n drives a single sequence (batch==1, got batch="
                f"{self.batch}); batched speculation is not yet ported to the "
                "PyTorch/CUDA package")
        self._check_room(n)
        cached = self._spec_h
        if cached is not None and cached[1] == self.pos and cached[2] == token:
            h = cached[0]  # continue the device-resident history
        else:
            hist = np.asarray(history, dtype=np.int64).reshape(-1)
            if hist.shape[0] > self.pos:
                raise ValueError(f"history length {hist.shape[0]} > pos {self.pos}")
            # unknown earlier positions hold -1: no real token id equals -1,
            # so the n-gram matcher can never draft across the unknown region
            hb = np.full(self.seq_len + 1, -1, np.int64)
            hb[self.pos - hist.shape[0] : self.pos] = hist
            hb[self.pos] = token
            h = torch.from_numpy(hb).to(self.device)

        def fwd(toks, pos):
            return self._forward(toks, pos, last_only=False)

        toks, cnt, cyc, h = spec_decode(fwd, h, int(token), self.pos, n, k, ngram,
                                        self.seq_len)
        m = min(n, cnt)
        # overshoot rewind: emitted tokens beyond n were fed rows we do not
        # keep (the stale-row invariant of generate's mid-chunk rewind); h
        # stays valid for the rewound position: index pos+m holds toks[m-1]
        self.pos += m
        self._spec_stats = {"emitted": cnt, "cycles": cyc}
        self._spec_h = (h, self.pos, toks[m - 1]) if m else None
        return np.asarray(toks[:m], dtype=np.int64)

    def decode_sample_n(self, token, n: int, sampler: Sampler,
                        counts: np.ndarray | None = None) -> np.ndarray:
        """n sampled decode steps on the device; returns tokens [n, B].
        ``counts`` ([B, V] occurrence counts of the text so far, EXCLUDING
        the unfed ``token``, which is counted before its successor is
        sampled) applies the sampler's presence/frequency penalties."""
        self._check_room(n)
        tok = self._token_tensor(token)
        gen = sampler.generator(self.device)
        penalized = counts is not None and sampler.has_penalties
        if penalized:
            cnt = torch.as_tensor(np.asarray(counts)).reshape(self.batch, -1).to(
                self.device, torch.int32)
            rows = torch.arange(self.batch, device=self.device)
        out = []
        for i in range(n):
            logits = self._forward(tok, self.pos + i)
            if penalized:
                cnt[rows, tok[:, 0]] += 1
                logits = apply_penalties(logits, cnt, sampler.presence, sampler.frequency)
            tok = sample_logits(logits, sampler.temperature, sampler.topp, gen)[:, None]
            out.append(tok)
        self.pos += n
        return torch.cat(out, dim=1).T.cpu().numpy()

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
            for i in range(c):
                token = int(toks[i, 0])
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
