"""The tensor-parallel exchange on ``torch.distributed``: the reference's
activation sync (SYNC_NODE_SLICES + OP_MERGE_ADD, nn-network.cpp:521-554)
as one collective a call.

* :meth:`TPExchange.all_reduce`: the bf16 all-reduce of the wo and w2
  partial sums (``--sync bf16``, exact up to the order of the sum).
* :func:`q80_all_gather`, :func:`q80_all_reduce`: the payload quantized to
  Q80 (i8 codes and f16 block scales through ``_f16_wire``'s clamp, the
  reference's NnBlockQ80 wire format), gathered and merged in f32
  (``--sync q80``, the JAX package's ``parallel/collectives.py``). The
  quantize and dequantize are plain torch, as they are plain jnp in JAX.
* :meth:`TPExchange.gather_logits`: the f32 all-gather of the vocab-sharded
  logits, so every rank holds bit-identical logits and samples the same
  token.

A CUDA tensor on a gloo group (ranks that share one card) is staged
through pinned host memory; a CPU tensor goes to gloo as it is; NCCL takes
the CUDA tensor directly, also inside a CUDA-graph capture.

Every collective adds the bytes of its result to a per-op counter (the
port's counterpart of the JAX package's ``measured_collective_bytes``,
which sums the result shapes of the compiled HLO's collectives), per
forward shape: ``forward_bytes[(B, T)]`` is one forward's exchange.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dllama_tpu_torch.ops.quant import Q_BLOCK

_F16_MAX = 65504.0
SYNCS = ("auto", "bf16", "q80")
_issued = 0  # collectives this process issued from Python (issued())


def issued() -> int:
    """How many collectives this process has issued from Python (a graph's
    replay issues its own without Python): parallel/multihost tells an
    error raised before a call's first exchange from one raised after."""
    return _issued


def quantize_q80(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Q80 of activations along the last dim: (codes i8 [..., d], scales f32
    [..., d/32]); the JAX package's ``quantize_q80_jnp``."""
    shape = x.shape
    g = x.to(torch.float32).reshape(*shape[:-1], -1, Q_BLOCK)
    deltas = g.abs().amax(dim=-1) / 127.0
    inv = torch.where(deltas != 0, 1.0 / deltas, torch.zeros_like(deltas))
    codes = torch.round(g * inv[..., None]).to(torch.int8)
    return codes.reshape(shape), deltas


def dequantize_q80(codes: torch.Tensor, scales: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """The JAX package's ``dequantize_q80_jnp``."""
    shape = codes.shape
    g = codes.to(torch.float32).reshape(*shape[:-1], -1, Q_BLOCK)
    return (g * scales[..., None]).reshape(shape).to(dtype)


def _f16_wire(scales: torch.Tensor) -> torch.Tensor:
    """f32 block scales -> f16 for the wire, saturation-safe: a block with
    absmax > ~8.3e6 would otherwise overflow f16 to inf and poison the whole
    reduced tensor. Clamping to f16-max keeps the block merely coarser."""
    return scales.clamp(-_F16_MAX, _F16_MAX).to(torch.float16)


def resolve_sync(sync: str, shardings) -> str:
    """Resolve the tp activation-exchange payload ('auto' -> 'bf16'|'q80'),
    as the JAX package does: 'auto' takes q80 only at tp=2, where it wins
    on both of that package's byte accountings (COLLECTIVES.md); at tp >= 4
    they disagree and it stays on bf16; a pp mesh degrades to bf16."""
    if sync not in SYNCS:
        raise ValueError(f"sync must be 'auto', 'bf16' or 'q80', got {sync!r}")
    if sync != "auto":
        return sync
    if shardings is None:
        return "bf16"
    shape = shardings.mesh.shape
    if shape.get("pp", 1) > 1:
        return "bf16"
    return "q80" if shape["tp"] == 2 else "bf16"


class TPExchange:
    """One rank's collectives over the mesh's tp group, with the byte
    counters. ``sync`` ('bf16' | 'q80') picks :meth:`reduce_partial`;
    ``ffn_sharded`` and ``logits_sharded`` say which outputs the layer
    reduces and the forward gathers (parallel/sharding: a dim tp does not
    divide is replicated)."""

    def __init__(self, mesh, sync: str = "bf16", ffn_sharded: bool = True,
                 logits_sharded: bool = True):
        if sync not in ("bf16", "q80"):
            raise ValueError(f"sync must be resolved to 'bf16' or 'q80', got {sync!r}")
        self.mesh = mesh
        self.tp = mesh.tp
        self.group = mesh.group
        self.staged = mesh.staged
        self.sync = sync
        self.ffn_sharded = ffn_sharded  # the FFN's output is a partial sum
        self.logits_sharded = logits_sharded  # wcls holds a vocab shard
        self.forward_bytes: dict[tuple[int, int], dict[str, int]] = {}
        self._cur: dict[str, int] | None = None

    # ------------------------------------------------------------ counters

    def _count(self, op: str, nbytes: int) -> None:
        if self._cur is not None:
            self._cur[op] = self._cur.get(op, 0) + nbytes

    def open_forward(self) -> None:
        self._cur = {}

    def close_forward(self, rows: int, width: int) -> None:
        """Keep the exchange of the forward that just ran under its (B, T)."""
        if self._cur is not None:
            self.forward_bytes[(rows, width)] = self._cur
        self._cur = None

    # ---------------------------------------------------------- primitives

    def _staged(self, x: torch.Tensor, fn) -> torch.Tensor:
        """Run ``fn(host tensor) -> host tensor`` on a pinned host copy of a
        CUDA tensor (gloo takes no CUDA tensor) and copy the result back."""
        if not (self.staged and x.device.type == "cuda"):
            return fn(x)
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return fn(host).to(x.device)

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        def run(t):
            global _issued
            _issued += 1
            t = t.contiguous()
            dist.all_reduce(t, group=self.group)
            return t

        out = self._staged(x, run)
        self._count("all-reduce", out.numel() * out.element_size())
        return out

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[*s] -> [tp, *s]: every rank's x, in rank order."""
        def run(t):
            global _issued
            _issued += 1
            t = t.contiguous()
            out = torch.empty((self.tp * t.numel(),), dtype=t.dtype, device=t.device)
            _gather_into(out, t.reshape(-1), self.group)
            return out.reshape(self.tp, *t.shape)

        out = self._staged(x, run)
        self._count("all-gather", out.numel() * out.element_size())
        return out

    # -------------------------------------------------------------- the API

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's x (``--sync bf16``: in x's dtype)."""
        return self._all_reduce(x)

    def reduce_partial(self, x: torch.Tensor) -> torch.Tensor:
        """The wo / dense-w2 exchange: bf16 all-reduce, or under
        ``--sync q80`` the Q80 all-gather and f32 merge."""
        if self.sync == "q80":
            return q80_all_reduce(x, self)
        return self.all_reduce(x)

    def gather_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """[..., V/tp] f32 on each rank -> [..., V] f32, rank r's slice at
        columns [r V/tp, (r+1) V/tp): every rank holds the same bits."""
        parts = self._all_gather(logits.to(torch.float32))  # [tp, ..., V/tp]
        return torch.cat(list(parts.unbind(0)), dim=-1)


def _gather_into(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, inp, group=group)


def q80_all_gather(x: torch.Tensor, exchange: TPExchange, axis: int = 0) -> torch.Tensor:
    """all_gather(x) along ``axis`` (tiled) with the payload quantized to
    Q80: ~1/2 the bytes of bf16 on the wire."""
    codes, scales = quantize_q80(x)
    codes_g = exchange._all_gather(codes)
    scales_g = exchange._all_gather(_f16_wire(scales))
    parts = dequantize_q80(codes_g, scales_g.to(torch.float32), x.dtype)
    return torch.cat(list(parts.unbind(0)), dim=axis)


def q80_all_reduce(x: torch.Tensor, exchange: TPExchange) -> torch.Tensor:
    """The reference's all-reduce: all-gather Q80 partial sums, reduce locally
    (all-gather + merge-add ≡ all-reduce, SURVEY.md §3.4). The payload is
    the quantized partials with f16 scales; the merge is f32, in rank
    order, then one cast to x's dtype."""
    codes, scales = quantize_q80(x)
    codes_g = exchange._all_gather(codes)
    scales_g = exchange._all_gather(_f16_wire(scales))
    parts = dequantize_q80(codes_g, scales_g.to(torch.float32), torch.float32)
    return torch.sum(parts, dim=0).to(x.dtype)
