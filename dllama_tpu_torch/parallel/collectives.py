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

The other axes (:class:`AxisGroup`: ``TPExchange.sp``, ``.dp``, ``.pp``
and ``.ep``) carry the sequence-parallel attention's exchanges
(parallel/ring_attention: the LSE merge's all-reduces, the ring's permutes,
the gather of a sharded chunk's output), a dp replica's rows (its tokens,
or its logits, gathered; an admission's logits broadcast from the replica
that holds the slot), the pipeline's stage hop and its logits broadcast
from the last stage (parallel/pipeline), and the sum of an MoE layer's
expert partials over ep (ops/layers.moe_ffn).

Every collective adds the bytes of its result to a per-op counter (the
port's counterpart of the JAX package's ``measured_collective_bytes``,
which sums the result shapes of the compiled HLO's collectives), per
forward shape: ``forward_bytes[(B, T)]`` is one forward's exchange. The tp
exchange's ops are named as JAX's HLO names them ("all-reduce",
"all-gather"); another axis's carry the axis ("sp:all-reduce",
"sp:collective-permute", "dp:all-gather", "pp:send", "pp:broadcast",
"ep:all-reduce", ...).
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


def _count_issued() -> None:
    global _issued
    _issued += 1


def host_gather(mesh, obj) -> list | None:
    """`obj` of every rank, pickled over the world's host channel (the gloo
    group of parallel/multihost's commands, ``mesh.host_group``): the list
    in rank order on rank 0, None elsewhere. For host-side values (a
    session's cache blocks), not for the forward's tensors."""
    _count_issued()
    out = [None] * mesh.size if mesh.rank == 0 else None
    dist.gather_object(obj, out, dst=0, group=mesh.host_group)
    return out


def host_scatter(mesh, objs: list | None):
    """Rank r's item of rank 0's `objs` (one a rank, in rank order; None on
    the other ranks), over the host channel as :func:`host_gather`."""
    _count_issued()
    out = [None]
    dist.scatter_object_list(out, objs if mesh.rank == 0 else None, src=0,
                             group=mesh.host_group)
    return out[0]


def host_all_gather(mesh, obj) -> list:
    """`obj` of every rank on every rank, in rank order (host channel)."""
    _count_issued()
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.host_group)
    return out


def _host(x: torch.Tensor, staged: bool) -> torch.Tensor:
    """`x` as a collective of a staged group takes it: a pinned host copy
    of a CUDA tensor (gloo takes no CUDA tensor), else `x` itself."""
    if not (staged and x.device.type == "cuda"):
        return x.contiguous()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


class AxisGroup:
    """One rank's collectives over one mesh axis other than tp (``sp``,
    ``dp``, ``pp`` or ``ep``): the axis's process group, this rank's index on it and the
    group's global ranks in index order (parallel/mesh.Mesh.axis_group).
    Bytes are counted into the owning exchange's forward window under
    "<axis>:<op>"."""

    def __init__(self, mesh, axis: str, exchange=None):
        self.axis = axis
        self.group, self.index, self.ranks = mesh.axis_group(axis)
        self.size = len(self.ranks)
        self.staged = mesh.staged
        self.exchange = exchange

    def _count(self, op: str, out: torch.Tensor) -> None:
        if self.exchange is not None:
            self.exchange._count(f"{self.axis}:{op}", out.numel() * out.element_size())

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (``op`` "sum") or elementwise max ("max") of every index's x."""
        _count_issued()
        t = _host(x, self.staged)
        t = t.clone() if t is x else t
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=self.group)
        out = t.to(x.device)
        self._count("all-reduce", out)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[*s] -> [size, *s]: every index's x, in index order."""
        _count_issued()
        t = _host(x, self.staged)
        out = torch.empty((self.size * t.numel(),), dtype=t.dtype, device=t.device)
        _gather_into(out, t.reshape(-1), self.group)
        out = out.reshape(self.size, *x.shape).to(x.device)
        self._count("all-gather", out)
        return out

    def permute(self, *xs: torch.Tensor) -> list[torch.Tensor]:
        """The ring step (JAX's ``ppermute`` with perm i -> i+1): every x goes
        to the next index and the previous index's arrive, one paired send
        and receive an x in one ``batch_isend_irecv`` (unpaired point-to-point
        calls deadlock under gloo), each x its own tag."""
        _count_issued()
        nxt = self.ranks[(self.index + 1) % self.size]
        prv = self.ranks[(self.index - 1) % self.size]
        # as bytes: the payload's dtype (an f8 cache block) need not be one
        # the backend reduces
        sends = [_host(x, self.staged).reshape(-1).view(torch.uint8) for x in xs]
        recvs = [torch.empty_like(t) for t in sends]
        ops = [dist.P2POp(dist.isend, t, nxt, self.group, tag) for tag, t in enumerate(sends)]
        ops += [dist.P2POp(dist.irecv, t, prv, self.group, tag) for tag, t in enumerate(recvs)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out = [r.view(x.dtype).reshape(x.shape).to(x.device) for r, x in zip(recvs, xs)]
        for o in out:
            self._count("collective-permute", o)
        return out

    def hop(self, send: torch.Tensor | None, recv_like: torch.Tensor | None
            ) -> torch.Tensor | None:
        """The pipeline's one-stage hop (JAX's non-cyclic ``ppermute`` with
        perm i -> i+1): `send` goes to the next index and a tensor shaped
        as `recv_like` arrives from the previous one, paired in one
        ``batch_isend_irecv``. Either may be None (the first index
        receives nothing, the last sends nothing, and a bubble step neither
        sends nor receives): the two ends of a hop must agree on it, as an
        unmatched point-to-point call hangs the group. The sender counts
        the bytes under "send". Returns the received tensor (None when
        none was posted)."""
        ops, recv = [], None
        if send is not None:
            t = _host(send, self.staged).reshape(-1).view(torch.uint8)
            ops.append(dist.P2POp(dist.isend, t, self.ranks[self.index + 1], self.group))
        if recv_like is not None:
            host = self.staged and recv_like.device.type == "cuda"
            recv = torch.empty(recv_like.shape, dtype=recv_like.dtype,
                               device="cpu" if host else recv_like.device,
                               pin_memory=host)
            ops.append(dist.P2POp(dist.irecv, recv.reshape(-1).view(torch.uint8),
                                  self.ranks[self.index - 1], self.group))
        if not ops:
            return None
        _count_issued()
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if send is not None:
            self._count("send", send)
        return None if recv is None else recv.to(recv_like.device)

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Index `src`'s x on every index (`x` is overwritten elsewhere)."""
        _count_issued()
        t = _host(x, self.staged)
        dist.broadcast(t, src=self.ranks[src], group=self.group)
        if t is not x:
            x.copy_(t)
        self._count("broadcast", x)
        return x


class TPExchange:
    """One rank's collectives over the mesh's tp group, with the byte
    counters. ``sync`` ('bf16' | 'q80') picks :meth:`reduce_partial`;
    ``ffn_sharded`` and ``logits_sharded`` say which outputs the layer
    reduces and the forward gathers (parallel/sharding: a dim tp does not
    divide is replicated). ``sp``, ``dp``, ``pp`` and ``ep`` are the
    rank's :class:`AxisGroup` on those axes (None on an axis of one)."""

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
        self._nested = 0
        shape = mesh.shape
        self.sp = AxisGroup(mesh, "sp", self) if shape["sp"] > 1 else None
        self.dp = AxisGroup(mesh, "dp", self) if shape["dp"] > 1 else None
        self.pp = AxisGroup(mesh, "pp", self) if shape["pp"] > 1 else None
        self.ep = AxisGroup(mesh, "ep", self) if shape["ep"] > 1 else None

    # ------------------------------------------------------------ counters

    def _count(self, op: str, nbytes: int) -> None:
        if self._cur is not None:
            self._cur[op] = self._cur.get(op, 0) + nbytes

    def open_forward(self) -> None:
        """Open a counting window; a window opened inside another (a forward
        inside an engine's step, which also gathers a dp replica's rows)
        counts into the outer one."""
        if self._nested == 0:
            self._cur = {}
        self._nested += 1

    def close_forward(self, rows: int, width: int) -> None:
        """Keep the exchange of the forward that just ran under its (B, T)
        (the outermost window's)."""
        self._nested = max(0, self._nested - 1)
        if self._nested == 0:
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
            _count_issued()
            t = t.contiguous()
            dist.all_reduce(t, group=self.group)
            return t

        out = self._staged(x, run)
        self._count("all-reduce", out.numel() * out.element_size())
        return out

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[*s] -> [tp, *s]: every rank's x, in rank order."""
        def run(t):
            _count_issued()
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
        ``--sync q80`` the Q80 all-gather and f32 merge; nothing where the
        rank has no tp group (tp of one in a dp or sp world, whose partial
        sums are whole; a world of one rank reduces over itself)."""
        if self.group is None:
            return x
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
