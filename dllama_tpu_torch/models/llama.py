"""Llama decoder forward pass (buildLlmNet, llm.cpp:125-436).

Per layer (the reference's att+ff segments):
  x += wo( attention( rope(q), rope(k)->cache, v->cache ) )   [att segment]
  x += w2( act(w1 h) * w3 h )                                 [ff segment]
with pre-RMSNorm before each block. A Python loop walks the layers; the
weights stay stacked [L, ...] and each layer takes views of its slice.
Unlike the functional JAX version, the KV cache is updated in place.
"""

from __future__ import annotations

import dataclasses

import torch

from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.ops.layers import activation, apply_rope, gqa_attention, rms_norm
from dllama_tpu_torch.ops.matmul import matmul
from dllama_tpu_torch.ops.quant import QTensor


@dataclasses.dataclass
class KVCache:
    """[n_layers, batch, n_kv_heads, seq_len, head_size] per tensor."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, cfg: LlamaConfig, batch: int, dtype=torch.bfloat16,
               seq_len: int | None = None, device="cpu") -> "KVCache":
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq_len or cfg.seq_len, cfg.head_size)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _cache_update(cache: torch.Tensor, new: torch.Tensor, pos_base) -> None:
    """Write new [B, H, T, hd] rows into one layer's cache [B, H, S, hd] at
    pos (an int, or a [B] tensor of per-row positions), in place."""
    new = new.to(cache.dtype)
    t = new.shape[2]
    if isinstance(pos_base, torch.Tensor) and pos_base.dim() == 1:
        rows = pos_base.to(torch.long)[:, None] + torch.arange(t, device=cache.device)
        bidx = torch.arange(cache.shape[0], device=cache.device)[:, None]
        cache[bidx, :, rows] = new.permute(0, 2, 1, 3)
    else:
        cache[:, :, pos_base : pos_base + t] = new


def _layer(cfg: LlamaConfig, x, layers, li, k_cache, v_cache, rope, pos_base,
           attn_fn, mm):
    """One decoder layer; `layers` holds the stacked weights and `li` the
    layer index (the matmul takes the layer's view of each stack)."""
    b, t, d = x.shape
    kvd = cfg.kv_dim
    h = rms_norm(x, layers["rms_att"][li], cfg.norm_epsilon)
    if "wqkv" in layers:  # fused launch (fuse_layer_weights)
        qkv = mm(h, layers["wqkv"], li)
        q, k, v = qkv[..., :d], qkv[..., d : d + kvd], qkv[..., d + kvd :]
    else:
        q = mm(h, layers["wq"], li)
        k = mm(h, layers["wk"], li)
        v = mm(h, layers["wv"], li)
    q = apply_rope(q.reshape(b, t, cfg.n_heads, cfg.head_size), rope)
    k = apply_rope(k.reshape(b, t, cfg.n_kv_heads, cfg.head_size), rope)
    v = v.reshape(b, t, cfg.n_kv_heads, cfg.head_size)
    _cache_update(k_cache, k.transpose(1, 2), pos_base)
    _cache_update(v_cache, v.transpose(1, 2), pos_base)
    att = attn_fn(q, k_cache, v_cache, pos_base).reshape(b, t, d)
    x = x + mm(att, layers["wo"], li)
    h = rms_norm(x, layers["rms_ffn"][li], cfg.norm_epsilon)
    if "w13" in layers:  # fused launch (fuse_layer_weights)
        gu = mm(h, layers["w13"], li)
        f = cfg.hidden_dim
        gate = activation(gu[..., :f].to(torch.float32), cfg.hidden_act).to(x.dtype)
        up = gu[..., f:]
    else:
        gate = activation(mm(h, layers["w1"], li).to(torch.float32),
                          cfg.hidden_act).to(x.dtype)
        up = mm(h, layers["w3"], li)
    return x + mm(gate * up, layers["w2"], li)


def fuse_layer_weights(layers: dict) -> dict:
    """wq/wk/wv -> wqkv and w1/w3 -> w13, concatenated on the output dim:
    five matmul launches per layer become two. Exact for QTensors (packed
    nibbles and f16 scales both carry the output dim last)."""

    def cat(*ws):
        if isinstance(ws[0], QTensor):
            return QTensor(torch.cat([w.packed for w in ws], dim=-1),
                           torch.cat([w.scales for w in ws], dim=-1))
        return torch.cat(ws, dim=-1)

    out = dict(layers)
    if all(k in out for k in ("wq", "wk", "wv")):
        out["wqkv"] = cat(out.pop("wq"), out.pop("wk"), out.pop("wv"))
    if all(k in out for k in ("w1", "w3")):
        out["w13"] = cat(out.pop("w1"), out.pop("w3"))
    return out


def run_layers(cfg: LlamaConfig, layer_params: dict, x, pos_base, cache: KVCache,
               rope, attn_fn=None, mm=None) -> torch.Tensor:
    attn_fn = attn_fn or gqa_attention
    mm = mm or matmul
    for li in range(cache.k.shape[0]):
        x = _layer(cfg, x, layer_params, li, cache.k[li], cache.v[li], rope,
                   pos_base, attn_fn, mm)
    return x


def forward(
    cfg: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,  # i64 [B, T] on the params' device
    pos_base,  # int, or a [B] tensor of per-row positions
    cache: KVCache,
    rope_cache: torch.Tensor,  # [seq, head_size/2, 2]
    attn_fn=None,  # (q, k_cache, v_cache, pos) -> out; default plain gqa_attention
    mm=None,  # (x, w, layer) -> out; default ops.matmul
    last_only: bool = False,  # project logits for the last position only
) -> tuple[torch.Tensor, KVCache]:
    """Returns (logits f32 [B, T or 1, vocab], cache), the cache updated in
    place. ``mm`` / ``attn_fn`` override the kernels (the plain versions run
    the same forward on the card for comparison). ``last_only`` slices to
    the final position before the lm-head, which is all prefill needs."""
    x = params["embedding"][tokens]  # [B, T, D]
    t = tokens.shape[1]
    if isinstance(pos_base, torch.Tensor) and pos_base.dim() == 1:
        idx = pos_base.to(torch.long)[:, None] + torch.arange(t, device=tokens.device)
        rope = rope_cache[idx.clamp(0, rope_cache.shape[0] - 1)]
    else:
        rope = rope_cache[pos_base : pos_base + t]
    x = run_layers(cfg, params["layers"], x, pos_base, cache, rope, attn_fn, mm)
    if last_only:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"], cfg.norm_epsilon)
    logits = (mm or matmul)(x, params["wcls"]).to(torch.float32)
    return logits, cache
