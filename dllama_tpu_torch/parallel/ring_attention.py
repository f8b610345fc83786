"""Ring / sequence-parallel attention over a mesh's ``sp`` axis: the JAX
package's ``parallel/ring_attention.py`` on ``torch.distributed``.

The KV cache's sequence axis is split over sp: rank r of sp holds the rows
``[r S/sp, (r+1) S/sp)`` of every layer (parallel/sharding.seq_block), and
the queries are computed whole on every rank. Two exact primitives
(online-softmax rescaling, f32 partials):

* :func:`sp_cache_attention`: every rank attends the whole chunk's queries
  to its own rows; the partials merge with one MAX all-reduce of the row
  maxima and one SUM all-reduce of the rescaled numerators and
  denominators (JAX: one ``pmax``, two ``psum``; the same bytes). Decode
  steps and ragged chunks take it.
* :func:`ring_cache_attention`: each rank attends its own 1/sp of the
  chunk's queries while the cache blocks travel the ring (JAX's
  ``ppermute``: one ``batch_isend_irecv`` of a paired send and receive a
  step, AxisGroup.permute); the output is all-gathered back to the chunk.
  Chunks of T > 1 with T % sp == 0 take it.

:func:`ring_attention` is the blockwise attention with queries and keys
both sharded (no cache), as in JAX. ``NEG`` is the finite mask value, and
a second ``where`` zeroes a fully masked row's probabilities, so a rank
whose whole shard lies past a query's position contributes exactly zero,
not NaN. This is plain torch, as JAX's is jnp outside any Pallas kernel.
"""

from __future__ import annotations

import math

import torch

NEG = -1e30


def _block_scores(q, k, scale):
    """q [B,T,Hkv,G,d] x k [B,Hkv,S,d] -> scores f32 [B,Hkv,G,T,S]."""
    return torch.einsum("bthgd,bhsd->bhgts", q.to(torch.float32),
                        k.to(torch.float32)) * scale


def _merge(acc, o, m, l):
    """Online-softmax merge of a new block's (unnormalized out, max, denom)."""
    o0, m0, l0 = acc
    m_new = torch.maximum(m0, m)
    a0 = torch.exp(m0 - m_new)
    a1 = torch.exp(m - m_new)
    return o0 * a0[..., None] + o * a1[..., None], m_new, l0 * a0 + l * a1


def _partial_attn(q, k, v, mask, scale):
    """-> (o_unnorm [B,Hkv,G,T,d], m [B,Hkv,G,T], l [B,Hkv,G,T])."""
    s = torch.where(mask, _block_scores(q, k, scale), NEG)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(mask, p, 0.0)  # kill exp(NEG-NEG)=1 rows where all-masked
    l = p.sum(dim=-1)
    o = torch.einsum("bhgts,bhsd->bhgtd", p, v.to(torch.float32))
    return o, m, l


def _positions(pos_base, b: int, device) -> torch.Tensor:
    """i64 [B, 1, 1]: each row's absolute position of query 0 (an int, a
    scalar or a [B] tensor)."""
    if isinstance(pos_base, torch.Tensor):
        pos = pos_base.to(device=device, dtype=torch.int64).reshape(-1)
        return pos.expand(b).reshape(b, 1, 1) if pos.numel() == 1 else pos.reshape(b, 1, 1)
    return torch.full((b, 1, 1), int(pos_base), dtype=torch.int64, device=device)


def _finish(acc, q):
    b, t, hq, d = q.shape
    o, _, l = acc
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, hq, d).to(q.dtype)


def _empty_acc(b, hkv, g, t, d, device):
    return (torch.zeros((b, hkv, g, t, d), dtype=torch.float32, device=device),
            torch.full((b, hkv, g, t), NEG, dtype=torch.float32, device=device),
            torch.zeros((b, hkv, g, t), dtype=torch.float32, device=device))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis,
                   causal: bool = True) -> torch.Tensor:
    """Exact blockwise attention over the ring: q [B, Tl, Hq, d] this rank's
    query block, k and v [B, Hkv, Sl, d] its KV block, index i of `axis`
    (collectives.AxisGroup) owning tokens [i Tl, (i+1) Tl). Each of the sp
    steps attends the local queries to the KV block held, merges the
    running softmax state, then passes the block to the next index."""
    b, tl, hq, d = q.shape
    hkv, sl = k.shape[1], k.shape[2]
    g = hq // hkv
    sp, idx = axis.size, axis.index
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, tl, hkv, g, d)
    q_pos = idx * tl + torch.arange(tl, device=q.device)[:, None]
    acc = _empty_acc(b, hkv, g, tl, d, q.device)
    for step in range(sp):
        src = (idx - step) % sp  # owner of the KV block currently held
        if causal:
            k_pos = src * sl + torch.arange(sl, device=q.device)[None, :]
            mask = (k_pos <= q_pos)[None, None, None]
        else:
            mask = torch.ones((1, 1, 1, tl, sl), dtype=torch.bool, device=q.device)
        acc = _merge(acc, *_partial_attn(qg, k, v, mask, scale))
        if step + 1 < sp:
            k, v = axis.permute(k, v)
    return _finish(acc, q)


def sp_cache_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                       pos_base, axis) -> torch.Tensor:
    """GQA of q [B, T, Hq, d] (every rank's the same) over a cache whose
    sequence axis is split over `axis`: k_cache, v_cache [B, Hkv, Sl, d] are
    this rank's rows [i Sl, (i+1) Sl). The partials merge by the LSE
    (flash-decoding): the row maxima's MAX, then the SUM of the rescaled
    numerators and denominators. Exact against one device's softmax."""
    b, t, hq, d = q.shape
    hkv, sl = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, t, hkv, g, d)
    slot = axis.index * sl + torch.arange(sl, device=q.device)[None, None, :]
    limit = _positions(pos_base, b, q.device) + torch.arange(t, device=q.device)[None, :, None]
    mask = (slot <= limit)[:, None, None]  # [B, 1, 1, T, Sl]
    o, m, l = _partial_attn(qg, k_cache, v_cache, mask, scale)
    m_g = axis.all_reduce(m, "max")
    a = torch.exp(m - m_g)
    merged = axis.all_reduce(torch.cat([o * a[..., None], (l * a)[..., None]], dim=-1))
    return _finish((merged[..., :d], m_g, merged[..., d]), q)


def ring_cache_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         pos_base, axis) -> torch.Tensor:
    """Chunked-prefill attention with the chunk's queries split over `axis`:
    q [B, Tl, Hq, d] is this rank's slice (index i holds queries
    [i Tl, (i+1) Tl) of the chunk at ``pos_base``) and the cache blocks
    [B, Hkv, Sl, d] travel the ring. The chunk's own rows are already in
    the cache (models/llama writes before it attends), so each step attends
    the local queries to one block, masked to global rows <= the query's
    position."""
    b, tl, hq, d = q.shape
    hkv, sl = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    sp, idx = axis.size, axis.index
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, tl, hkv, g, d)
    q_pos = (_positions(pos_base, b, q.device) + idx * tl
             + torch.arange(tl, device=q.device)[None, :, None])  # [B, Tl, 1]
    acc = _empty_acc(b, hkv, g, tl, d, q.device)
    k, v = k_cache, v_cache
    for step in range(sp):
        src = (idx - step) % sp  # owner of the cache block currently held
        slot = src * sl + torch.arange(sl, device=q.device)[None, None, :]
        mask = (slot <= q_pos)[:, None, None]
        acc = _merge(acc, *_partial_attn(qg, k, v, mask, scale))
        if step + 1 < sp:
            k, v = axis.permute(k, v)
    return _finish(acc, q)


class SPAttention:
    """The attention of an sp rank's forward (models/llama's ``attn_fn``):
    the layer's cache is this rank's ``rows`` sequence rows plus one trash
    row (a new row outside the rank's range is written there, never read),
    starting at global row ``offset``. Dispatch is static on the chunk
    width T, as JAX's make_sp_attention: T > 1 with T % sp == 0 takes
    :func:`ring_cache_attention` (this rank's 1/sp of the queries; the
    output all-gathered over sp), anything else :func:`sp_cache_attention`."""

    def __init__(self, axis, rows: int):
        self.axis = axis
        self.rows = rows
        self.offset = axis.index * rows

    def __call__(self, q, k_cache, v_cache, pos_base):
        k, v = k_cache[:, :, : self.rows], v_cache[:, :, : self.rows]
        b, t, hq, d = q.shape
        sp = self.axis.size
        if t > 1 and t % sp == 0:
            tl = t // sp
            mine = q[:, self.axis.index * tl : (self.axis.index + 1) * tl]
            parts = self.axis.all_gather(ring_cache_attention(mine, k, v, pos_base, self.axis))
            return parts.permute(1, 0, 2, 3, 4).reshape(b, t, hq, d)
        return sp_cache_attention(q, k, v, pos_base, self.axis)

    def write_index(self, pos_base, b: int, h: int, t: int, device,
                    active: torch.Tensor | None = None) -> torch.Tensor:
        """i64 [B*H*T]: the row of a layer cache [B, H, rows+1, hd] seen as
        [B*H*(rows+1), hd] that new row [b, h, j] (global position
        pos[b] + j) goes to: its local row where it falls in this rank's
        range (and its slot is active), else the trash row. A chunk that
        straddles a shard boundary writes into both shards."""
        local = (_positions(pos_base, b, device)[:, :, 0]
                 + torch.arange(t, device=device) - self.offset)
        ok = (local >= 0) & (local < self.rows)
        if active is not None:
            ok = ok & active.to(device)[:, None]
        local = torch.where(ok, local, self.rows)
        base = torch.arange(b * h, device=device).view(b, h, 1) * (self.rows + 1)
        return (base + local[:, None, :]).reshape(-1)


def make_sp_attention(exchange, rows: int) -> SPAttention:
    """The sp attention of a rank whose exchange (parallel/collectives.
    TPExchange) has an sp axis and whose cache holds `rows` rows a layer
    (JAX's make_sp_attention, with the mesh's sp group in place of the
    shard_map)."""
    return SPAttention(exchange.sp, rows)
