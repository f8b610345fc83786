"""Llama decoder forward pass (buildLlmNet, llm.cpp:125-436).

Per layer (the reference's att+ff segments):
  x += wo( attention( rope(q), rope(k)->cache, v->cache ) )   [att segment]
  x += w2( act(w1 h) * w3 h )                                 [ff segment]
with pre-RMSNorm before each block; an MoE model's ff segment is the sparse
expert FFN (ops.layers.moe_ffn). A Python loop walks the layers; the
weights stay stacked [L, ...] and each layer takes views of its slice.
Unlike the functional JAX version, the KV cache (dense, or the paged pool)
is updated in place where JAX donates its buffers. An f8 (e4m3) cache takes
its new rows cast once, then written as bytes (``_as_bytes``): some indexing
ops have no float8 kernel, and the byte copy is exact. Casting saturates at
±448 in torch where JAX gives NaN; values in range round identically.
"""

from __future__ import annotations

import dataclasses

import torch

from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.ops.layers import (
    activation,
    apply_rope,
    gqa_attention,
    moe_ffn,
    paged_gqa_attention,
    paged_write_targets,
    rms_norm_plain,
)
from dllama_tpu_torch.ops.matmul import matmul
from dllama_tpu_torch.ops.quant import Q8Tensor, QTensor, slice_leaf


@dataclasses.dataclass
class KVCache:
    """[n_layers, batch, n_kv_heads, seq_len, head_size] per tensor."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, cfg: LlamaConfig, batch: int, dtype=torch.bfloat16,
               seq_len: int | None = None, device="cpu") -> "KVCache":
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq_len or cfg.seq_len, cfg.head_size)
        return cls(_zeros(shape, dtype, device), _zeros(shape, dtype, device))


def _zeros(shape, dtype, device) -> torch.Tensor:
    """A zero cache buffer; an e4m3 one as zero bytes (+0.0), which needs no
    float8 fill kernel."""
    if dtype == torch.float8_e4m3fn:
        return torch.zeros(shape, dtype=torch.uint8, device=device).view(dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


def _as_bytes(cache: torch.Tensor, new: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(cache, new) to write: ``new`` cast to the cache's dtype; for an f8
    cache both as u8 views of the same bytes."""
    new = new.to(cache.dtype)
    if cache.dtype == torch.float8_e4m3fn:
        return cache.view(torch.uint8), new.view(torch.uint8)
    return cache, new


@dataclasses.dataclass
class PagedKVCache:
    """Paged KV layout: one global page pool
    [n_layers, n_pages + 1, n_kv_heads, page_size, head_size] per tensor plus
    per-slot block tables i32 [n_slots, max_blocks] (logical block j of slot
    s lives in pool page tables[s, j]). The allocator (engine/batch.PagePool)
    hands out pages as positions advance and refcounts them. The LAST pool
    page is the trash page: masked writes (inactive slots) land there and
    the allocator never hands it out. Unallocated table entries point at
    page 0; reads through them are masked by position."""

    k: torch.Tensor
    v: torch.Tensor
    tables: torch.Tensor  # i32 [n_slots, max_blocks]

    @classmethod
    def create(cls, cfg: LlamaConfig, n_slots: int, n_pages: int, page_size: int,
               dtype=torch.bfloat16, max_blocks: int = 0, device="cpu") -> "PagedKVCache":
        shape = (cfg.n_layers, n_pages + 1, cfg.n_kv_heads, page_size, cfg.head_size)
        tables = torch.zeros((n_slots, max_blocks or 1), dtype=torch.int32, device=device)
        return cls(_zeros(shape, dtype, device), _zeros(shape, dtype, device), tables)

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def n_pages(self) -> int:
        """Usable pages (the +1 trash page is excluded)."""
        return self.k.shape[1] - 1


def _dense_write_index(pos: torch.Tensor, b: int, h: int, s: int, t: int) -> torch.Tensor:
    """i64 [B*H*T]: the row of a layer cache [B, H, S, hd] seen as [B*H*S,
    hd] that new row [b, h, j] goes to, (b*H + h)*S + pos[b] + j, in the
    order of new.reshape(-1, hd). Made once a forward and shared by every
    layer's writes."""
    base = torch.arange(b * h, device=pos.device).view(b, h, 1) * s
    offs = torch.arange(t, device=pos.device)
    return (base + pos.to(torch.int64).view(b, 1, 1) + offs).reshape(-1)


def _cache_update(cache: torch.Tensor, new: torch.Tensor, pos_base,
                  active: torch.Tensor | None = None, index: torch.Tensor | None = None
                  ) -> None:
    """Write new [B, H, T, hd] rows into one layer's cache [B, H, S, hd] at
    pos (an int, or a [B] tensor of per-row positions), in place. Rows with
    active == False keep their old contents (frozen slots of a batch).
    ``index`` (_dense_write_index of a tensor pos, no mask) writes every
    row with one index_copy_."""
    cache, new = _as_bytes(cache, new)
    t = new.shape[2]
    if index is not None:
        cache.view(-1, cache.shape[-1]).index_copy_(0, index, new.reshape(-1, new.shape[-1]))
    elif isinstance(pos_base, torch.Tensor) and pos_base.dim() == 1:
        rows = pos_base.to(torch.long)[:, None] + torch.arange(t, device=cache.device)
        bidx = torch.arange(cache.shape[0], device=cache.device)[:, None]
        vals = new.permute(0, 2, 1, 3)  # [B, T, H, hd]
        if active is not None:
            vals = torch.where(active[:, None, None, None], vals, cache[bidx, :, rows])
        cache[bidx, :, rows] = vals
    elif active is not None:
        old = cache[:, :, pos_base : pos_base + t]
        cache[:, :, pos_base : pos_base + t] = torch.where(active[:, None, None, None], new, old)
    else:
        cache[:, :, pos_base : pos_base + t] = new


def _paged_cache_update(pool: torch.Tensor, new: torch.Tensor, tables: torch.Tensor,
                        pos_base, active: torch.Tensor | None = None) -> None:
    """Write new [B, H, T, hd] rows into one layer's pool [P, H, page, hd] at
    block-table positions (ops.layers.paged_write_targets), in place; rows of
    inactive slots go to the trash page P-1. Two rows with one target (only
    inactive slots sharing the trash page, or a row past the table width)
    resolve as if written in (slot, t) order, last row winning: every
    duplicate writes the last one's values, so the result does not depend on
    the order in which index_put_ applies them."""
    b, h, t, hd = new.shape
    pool, new = _as_bytes(pool, new)
    pages, off = paged_write_targets(tables, pos_base, t, pool.shape[2], pool.shape[0], active)
    flat = (pages.long() * pool.shape[2] + off.long()).reshape(-1)  # [B*T]
    vals = new.permute(0, 2, 1, 3).reshape(b * t, h, hd)
    if b * t > 1:
        order = torch.arange(b * t, device=flat.device)
        last = torch.where(flat[None, :] == flat[:, None], order[None, :], -1).amax(dim=1)
        vals = vals[last]
    pool[pages.long().reshape(-1), :, off.long().reshape(-1)] = vals


def _layer(cfg: LlamaConfig, x, layers, li, k_cache, v_cache, rope, pos_base,
           attn_fn, mm, active=None, tables=None, index=None, moe_impl="auto",
           exchange=None, norm=rms_norm_plain):
    """One decoder layer; `layers` holds the stacked weights and `li` the
    layer index (the matmul takes the layer's view of each stack, `norm`,
    the engine's RMSNorm, the layer's row of each norm weight). A layer
    with a ``moe_gate`` runs the sparse MoE FFN (ops.layers.moe_ffn, scheme
    `moe_impl`) in place of the dense one. With
    `tables` the caches are one layer's page pools [P, Hkv, page, hd]; an
    `attn_fn` marked ``fused_kv_scatter`` writes the new rows itself, inside
    its kernel launch, instead of a separate scatter. `index`: the dense
    caches' write rows (_dense_write_index).

    On a tensor-parallel rank (``exchange``, parallel/collectives.TPExchange)
    `cfg` is the rank's view (its heads, kv heads and FFN width) and the
    weights its shards: the wo product and the FFN's are partial sums,
    each all-reduced once here at the layer (one reduce for an MoE FFN of
    tp-sharded experts, not one an expert). On an ep rank the MoE FFN runs
    the rank's experts and sums their f32 partials over ep inside
    moe_ffn, before the cast; the tp reduce follows here."""
    b, t, _ = x.shape
    qd, kvd = cfg.n_heads * cfg.head_size, cfg.kv_dim
    h = norm(x, layers["rms_att"][li], cfg.norm_epsilon)
    if "wqkv" in layers:  # fused launch (fuse_layer_weights)
        qkv = mm(h, layers["wqkv"], li)
        q, k, v = qkv[..., :qd], qkv[..., qd : qd + kvd], qkv[..., qd + kvd :]
    else:
        q = mm(h, layers["wq"], li)
        k = mm(h, layers["wk"], li)
        v = mm(h, layers["wv"], li)
    q = apply_rope(q.reshape(b, t, cfg.n_heads, cfg.head_size), rope)
    k = apply_rope(k.reshape(b, t, cfg.n_kv_heads, cfg.head_size), rope)
    v = v.reshape(b, t, cfg.n_kv_heads, cfg.head_size)
    if tables is None:
        _cache_update(k_cache, k.transpose(1, 2), pos_base, active, index)
        _cache_update(v_cache, v.transpose(1, 2), pos_base, active, index)
        att = attn_fn(q, k_cache, v_cache, pos_base)
    elif getattr(attn_fn, "fused_kv_scatter", False):
        att, _, _ = attn_fn(q, k_cache, v_cache, tables, pos_base, k.transpose(1, 2),
                            v.transpose(1, 2), active)
    else:
        _paged_cache_update(k_cache, k.transpose(1, 2), tables, pos_base, active)
        _paged_cache_update(v_cache, v.transpose(1, 2), tables, pos_base, active)
        att = attn_fn(q, k_cache, v_cache, tables, pos_base)
    o = mm(att.reshape(b, t, qd), layers["wo"], li)
    x = x + (o if exchange is None else exchange.reduce_partial(o))
    h = norm(x, layers["rms_ffn"][li], cfg.norm_epsilon)
    reduce_ffn = exchange is not None and exchange.ffn_sharded
    if "moe_gate" in layers:
        # the rank holds a share of the experts only where ep divides them
        # (LlamaShardings.local_config); otherwise every rank runs them all
        ep = exchange.ep if getattr(cfg, "ep", 1) > 1 else None
        y = moe_ffn(cfg, h, layers["moe_gate"][li], slice_leaf(layers["moe_w1"], li),
                    slice_leaf(layers["moe_w2"], li), slice_leaf(layers["moe_w3"], li),
                    impl=moe_impl, mm=mm, reduce=None if ep is None else ep.all_reduce)
        # exact under --sync q80 too: the JAX package's q80 exchange
        # replaces the wo and dense w2 products only
        return x + (exchange.all_reduce(y) if reduce_ffn else y)
    if "w13" in layers:  # fused launch (fuse_layer_weights)
        gu = mm(h, layers["w13"], li)
        f = cfg.hidden_dim
        gate = activation(gu[..., :f].to(torch.float32), cfg.hidden_act).to(x.dtype)
        up = gu[..., f:]
    else:
        gate = activation(mm(h, layers["w1"], li).to(torch.float32),
                          cfg.hidden_act).to(x.dtype)
        up = mm(h, layers["w3"], li)
    y = mm(gate * up, layers["w2"], li)
    return x + (exchange.reduce_partial(y) if reduce_ffn else y)


def fuse_layer_weights(layers: dict) -> dict:
    """wq/wk/wv -> wqkv and w1/w3 -> w13, concatenated on the output dim:
    five matmul launches per layer become two. Exact for QTensors and
    Q8Tensors (packed nibbles or int8 codes, and f16 scales, all carry the
    output dim last). A layer without w1/w3 (an MoE model's) fuses wqkv
    alone."""

    def cat(*ws):
        if isinstance(ws[0], QTensor):
            return QTensor(torch.cat([w.packed for w in ws], dim=-1),
                           torch.cat([w.scales for w in ws], dim=-1))
        if isinstance(ws[0], Q8Tensor):
            return Q8Tensor(torch.cat([w.codes for w in ws], dim=-1),
                            torch.cat([w.scales for w in ws], dim=-1))
        return torch.cat(ws, dim=-1)

    out = dict(layers)
    if all(k in out for k in ("wq", "wk", "wv")):
        out["wqkv"] = cat(out.pop("wq"), out.pop("wk"), out.pop("wv"))
    if all(k in out for k in ("w1", "w3")):
        out["w13"] = cat(out.pop("w1"), out.pop("w3"))
    return out


def run_layers(cfg: LlamaConfig, layer_params: dict, x, pos_base, cache, rope,
               attn_fn=None, mm=None, active=None, moe_impl: str = "auto",
               exchange=None, norm=None) -> torch.Tensor:
    """Walk the decoder layers over a KVCache or a PagedKVCache (whose block
    tables select the paged branch of each layer). `active` [B] bool masks
    the cache writes of frozen rows. The layers are those the weights and
    the cache stack: a pipeline stage's (parallel/pipeline) are its own
    [L/pp, ...] slices, indexed from 0, at global positions and RoPE
    rows. ``norm`` is the engine's RMSNorm (default the plain norm)."""
    tables = cache.tables if isinstance(cache, PagedKVCache) else None
    if attn_fn is None:
        attn_fn = gqa_attention if tables is None else paged_gqa_attention
    mm = mm or matmul
    norm = norm or rms_norm_plain
    index = None
    if tables is None and hasattr(attn_fn, "write_index"):
        # a sequence-sharded cache (parallel/ring_attention.SPAttention): each
        # rank writes the rows of [pos, pos+T) in its own range, at local
        # offsets, the rest into its trash row
        _, b, h, _, _ = cache.k.shape
        index = attn_fn.write_index(pos_base, b, h, x.shape[1], x.device, active)
    # each layer's cache must be one block (one slot's view of a batched
    # cache is, though the stack of layers is not)
    elif (tables is None and active is None and isinstance(pos_base, torch.Tensor)
            and pos_base.dim() == 1 and cache.k[0].is_contiguous()
            and cache.v[0].is_contiguous()):
        _, b, h, s, _ = cache.k.shape
        index = _dense_write_index(pos_base, b, h, s, x.shape[1])
    for li in range(cache.k.shape[0]):
        x = _layer(cfg, x, layer_params, li, cache.k[li], cache.v[li], rope,
                   pos_base, attn_fn, mm, active, tables, index, moe_impl, exchange, norm)
    return x


def rope_rows(rope_cache: torch.Tensor, pos_base, t: int) -> torch.Tensor:
    """The RoPE rows of T tokens at `pos_base`: [T, ...] for an int, [B, T,
    ...] for a [B] tensor of per-row positions (clamped to the cache)."""
    if isinstance(pos_base, torch.Tensor) and pos_base.dim() == 1:
        idx = pos_base.to(torch.long)[:, None] + torch.arange(t, device=pos_base.device)
        return rope_cache[idx.clamp(0, rope_cache.shape[0] - 1)]
    return rope_cache[pos_base : pos_base + t]


def forward(
    cfg: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,  # i64 [B, T] on the params' device
    pos_base,  # int, or a [B] tensor of per-row positions
    cache,  # KVCache, or PagedKVCache (the paged layout)
    rope_cache: torch.Tensor,  # [seq, head_size/2, 2]
    attn_fn=None,  # attention; default the plain gqa_attention / paged_gqa_attention
    mm=None,  # (x, w, layer) -> out; default ops.matmul
    last_only: bool = False,  # project logits for the last position only
    active: torch.Tensor | None = None,  # [B] bool cache-write mask (batch mode)
    moe_impl: str = "auto",  # MoE compute scheme (ops.layers.moe_ffn)
    exchange=None,  # a tp rank's parallel/collectives.TPExchange
    norm=None,  # the RMSNorm (x, w, eps); default the plain ops.layers.rms_norm_plain
):
    """Returns (logits f32 [B, T or 1, vocab], cache), the cache updated in
    place. ``mm`` / ``attn_fn`` / ``norm`` override the kernels (the plain
    versions run the same forward on the card for comparison). ``last_only``
    slices to the final position before the lm-head, which is all prefill
    needs. A
    paged attn_fn takes (q, k_pool, v_pool, tables, pos). On a tp rank
    (``exchange``) the logits of the rank's vocab shard are all-gathered,
    so every rank returns the same full f32 logits."""
    if exchange is not None:
        exchange.open_forward()
    x = params["embedding"][tokens]  # [B, T, D]
    t = tokens.shape[1]
    rope = rope_rows(rope_cache, pos_base, t)
    norm = norm or rms_norm_plain
    x = run_layers(cfg, params["layers"], x, pos_base, cache, rope, attn_fn, mm, active,
                   moe_impl, exchange, norm)
    if last_only:
        x = x[:, -1:]
    x = norm(x, params["final_norm"], cfg.norm_epsilon)
    logits = (mm or matmul)(x, params["wcls"]).to(torch.float32)
    if exchange is not None:
        if exchange.logits_sharded:
            logits = exchange.gather_logits(logits)
        exchange.close_forward(tokens.shape[0], t)
    return logits, cache
