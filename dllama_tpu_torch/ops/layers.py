"""Core model ops: RMSNorm, RoPE, GQA attention, activations.

Plain PyTorch. Numerics follow the reference kernels (nn-cpu-ops.cpp) and
the `dllama_tpu` package's casts: norms, RoPE, softmax and attention
accumulate in f32 and cast back to the activation dtype at the same points,
so bf16 runs of the two packages round at the same places.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from dllama_tpu_torch.models.config import HiddenAct, LlamaConfig, RopeType


#: 'torch' (the default) runs the plain norm below; 'cuda' routes through
#: ops/rms_norm (the CUDA kernel, K10), as the JAX package's 'pallas' switch
#: routes its Pallas kernel. Off by default there too: flip only with a
#: recorded win.
RMS_NORM_IMPL = "torch"


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """y = x * w / rms(x) with f32 accumulation (nn-cpu-ops.cpp:108-183)."""
    if RMS_NORM_IMPL == "cuda":
        from dllama_tpu_torch.ops.rms_norm import rms_norm as cuda_rms_norm

        return cuda_rms_norm(x, weight, eps)
    return rms_norm_plain(x, weight, eps)


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """The plain version of the RMSNorm kernel: mean of squares in f32,
    rsqrt(+eps), times the f32 weight, one cast to ``x.dtype``."""
    xf = x.to(torch.float32)
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv * weight.to(torch.float32)).to(x.dtype)


def activation(x: torch.Tensor, act: HiddenAct) -> torch.Tensor:
    if act == HiddenAct.SILU:
        return F.silu(x)
    return F.gelu(x, approximate="none")


def llama31_scale_freqs(freqs: np.ndarray, cfg: LlamaConfig) -> np.ndarray:
    """Llama-3.1 NTK-by-parts frequency scaling (frequency domain, as Meta's
    reference model applies it)."""
    wavelen = 2.0 * math.pi / freqs
    high_freq_wavelen = cfg.rope_scaling_orig_max_seq_len / cfg.rope_scaling_high_freq_factor
    low_freq_wavelen = cfg.rope_scaling_orig_max_seq_len / cfg.rope_scaling_low_freq_factor
    scaled = freqs / cfg.rope_scaling_factor
    smooth = (cfg.rope_scaling_orig_max_seq_len / wavelen - cfg.rope_scaling_low_freq_factor) / (
        cfg.rope_scaling_high_freq_factor - cfg.rope_scaling_low_freq_factor
    )
    smoothed = (1 - smooth) * scaled + smooth * freqs
    out = np.where(wavelen < high_freq_wavelen, freqs,
                   np.where(wavelen > low_freq_wavelen, scaled, smoothed))
    return out.astype(np.float32)


def build_rope_cache(cfg: LlamaConfig, seq_len: int | None = None,
                     device="cpu") -> torch.Tensor:
    """Precomputed [seq_len, head_size/2, 2] (cos, sin) table, f32, for the
    interleaved-pair layout the `.m` format stores Q/K in. Computed in numpy
    so both packages build the same table."""
    seq_len = seq_len or cfg.seq_len
    half = cfg.head_size // 2
    freqs = 1.0 / (cfg.rope_theta ** (np.arange(half, dtype=np.float64) * 2.0 / cfg.head_size))
    freqs = freqs.astype(np.float32)
    if cfg.rope_type == RopeType.LLAMA3_1 and cfg.rope_scaling_factor != 1.0:
        freqs = llama31_scale_freqs(freqs, cfg)
    t = np.arange(seq_len, dtype=np.float32)
    angles = np.outer(t, freqs)  # [S, half]
    cache = np.stack([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32)
    return torch.from_numpy(cache).to(device)


def apply_rope(x: torch.Tensor, rope: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs x[..., 2i], x[..., 2i+1] by angle pos*freq_i.

    x: [B, T, H, head_size]; rope: [T, head_size/2, 2] rows for the T
    tokens' absolute positions, or [B, T, head_size/2, 2] per sequence."""
    b, t, h, hs = x.shape
    xf = x.to(torch.float32).reshape(b, t, h, hs // 2, 2)
    if rope.dim() == 4:
        cos = rope[:, :, None, :, 0]
        sin = rope[:, :, None, :, 1]
    else:
        cos = rope[None, :, None, :, 0]
        sin = rope[None, :, None, :, 1]
    x0, x1 = xf[..., 0], xf[..., 1]
    r0 = x0 * cos - x1 * sin
    r1 = x0 * sin + x1 * cos
    return torch.stack([r0, r1], dim=-1).reshape(b, t, h, hs).to(x.dtype)


def gqa_attention(
    q: torch.Tensor,  # [B, T, Hq, hd]
    k_cache: torch.Tensor,  # [B, Hkv, S, hd]
    v_cache: torch.Tensor,  # [B, Hkv, S, hd]
    pos_base,  # int, or i32/i64 [B] per-sequence positions
) -> torch.Tensor:
    """Causal GQA over the full KV cache (nn-cpu-ops.cpp:752-787).

    Query t attends to cache slots s <= pos_base + t; unwritten slots past
    that are masked out. The plain version of the flash-attention kernel."""
    b, t, hq, hd = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qf = q.to(torch.float32).reshape(b, t, hkv, g, hd)
    kf = k_cache.to(torch.float32)
    vf = v_cache.to(torch.float32)
    scores = torch.einsum("bthgd,bhsd->bhgts", qf, kf) / math.sqrt(hd)
    spans = torch.arange(s, device=q.device)[None, :]
    qoff = torch.arange(t, device=q.device)[:, None]
    if isinstance(pos_base, torch.Tensor) and pos_base.dim() == 1:
        pos = pos_base.to(device=q.device, dtype=torch.int64)
        mask = spans[None] <= pos[:, None, None] + qoff[None]  # [B, t, s]
        mask = mask[:, None, None]
    else:
        mask = (spans <= int(pos_base) + qoff)[None, None, None]
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bhsd->bthgd", probs, vf)
    return out.reshape(b, t, hq, hd).to(q.dtype)


def paged_view(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Gather a [B, Hkv, max_blocks*page, hd] contiguous cache view from a
    [P, Hkv, page, hd] page pool through [B, max_blocks] block tables:
    logical row r of slot b reads pool[tables[b, r // page], :, r % page].
    Rows behind unallocated table entries surface stale page contents; the
    causal mask gives them probability exactly 0.0 (pool values are always
    finite), so a view-based attention is bit-exact against dense."""
    b, nb = tables.shape
    _, hkv, page, hd = pool.shape
    kv = pool[tables.long()]  # [B, nb, Hkv, page, hd]
    return kv.permute(0, 2, 1, 3, 4).reshape(b, hkv, nb * page, hd)


def paged_write_targets(tables: torch.Tensor, pos_base, t: int, page: int, n_pool: int,
                        active: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """(pages, offsets) i32 [B, T] for writing T new KV rows at block-table
    positions: the definition of paged write addressing. Logical row
    pos+tt of slot b lands in pool page tables[b, (pos+tt) // page] at offset
    (pos+tt) % page, the block index clipped to the table width, and rows of
    inactive slots go to the trash page (n_pool - 1, never allocated). Used
    by models.llama._paged_cache_update (the plain scatter); the paged
    kernel's fused scatter (csrc/paged_attention.cu write_target) computes
    the same targets on the card, and chip_smoke.py holds its pools bit-equal
    to the plain scatter's. Device tensors in, device tensors out: no host
    sync."""
    b, nb = tables.shape
    dev = tables.device
    if isinstance(pos_base, torch.Tensor):
        pos = pos_base.to(device=dev, dtype=torch.int64).reshape(-1).expand(b)
    else:
        pos = torch.full((b,), int(pos_base), dtype=torch.int64, device=dev)
    rows = pos[:, None] + torch.arange(t, device=dev)[None]  # [B, T]
    blk = torch.clamp(rows // page, 0, nb - 1)
    off = rows % page
    pages = torch.gather(tables.long(), 1, blk)
    if active is not None:
        pages = torch.where(active.to(dev)[:, None], pages, n_pool - 1)
    return pages.to(torch.int32), off.to(torch.int32)


def paged_gqa_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                        tables: torch.Tensor, pos_base) -> torch.Tensor:
    """Causal GQA over the paged KV cache: gather the block-table view, then
    the dense attention math unchanged. The plain version of the paged
    attention kernels; it re-materializes the whole view every call."""
    return gqa_attention(q, paged_view(k_pool, tables), paged_view(v_pool, tables), pos_base)
