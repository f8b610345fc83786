"""Causal GQA flash attention over the dense KV cache: the CUDA kernel's
wrapper.

``flash_gqa_attention`` has the signature and semantics of
:func:`dllama_tpu_torch.ops.layers.gqa_attention` (``q[B, T, Hq, hd]``,
cache ``[B, Hkv, S, hd]``, ``pos`` an int or an i32 ``[B]`` tensor), which is
its plain version. On a CUDA tensor it launches ``csrc/flash_attention.cu``
(replaces ``dllama_tpu/ops/pallas/flash_attention.py:_kernel``); on a CPU
tensor it runs the plain version. A bf16 ``q`` over an e4m3 cache (the f8 KV
cache) is the kernel's f8 mode, which widens the cache bytes to f32 as the
TPU kernel does; its launches count under ``flash_attention_f8``.

``paged_flash_gqa_attention`` is the block-table variant (replaces
``dllama_tpu/ops/pallas/flash_attention.py:_paged_kernel``, K8): the signature
and semantics of :func:`dllama_tpu_torch.ops.layers.paged_gqa_attention` over
pages of whole 64-row tiles. It is the read-only mode of the paged kernel
(``csrc/paged_attention.cu``), with its own launch count; like the JAX
package, kernel selection does not route it.
"""

from __future__ import annotations

import math

import torch

from dllama_tpu_torch.ops import build, paged_attention
from dllama_tpu_torch.ops.layers import gqa_attention, paged_gqa_attention
from dllama_tpu_torch.ops.q40_matmul import _sm_count

TQ = 64  # folded query rows per block (csrc/flash_attention.cu)
TS = 64  # cache rows per KV tile
HEAD_SIZES = (64, 128)
MIN_TILES_PER_SPLIT = 2
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
F8_MODE = 2  # the source's dtype code of a bf16 q over an e4m3 cache

#: kernel launches made through the wrappers (plain ints; the f8 mode counts
#: apart from the bf16/f32 modes)
LAUNCHES = {"flash_attention": 0, "flash_attention_f8": 0, "paged_flash_attention": 0}


def supported(head_size: int) -> bool:
    return head_size in HEAD_SIZES


def kv_splits(rows: int, bhkv: int, live_tiles: int, sms: int) -> tuple[int, int]:
    """(splits, tiles per split) of the split-KV sweep: enough blocks for
    about two per SM, each split at least MIN_TILES_PER_SPLIT live KV tiles
    (the merge pass reads every split's partial row)."""
    q_tiles = -(-rows // TQ)
    splits = min(max(1, live_tiles // MIN_TILES_PER_SPLIT),
                 max(1, math.ceil(2 * sms / (q_tiles * bhkv))))
    per = -(-live_tiles // splits)
    return -(-live_tiles // per), per


def flash_gqa_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                        pos_base, out_dtype=None) -> torch.Tensor:
    """Attention output in ``out_dtype`` (default ``q.dtype``; the kernel
    also writes f32, the result before its rounding)."""
    if q.device.type == "cpu":
        if out_dtype == torch.float32:  # the plain math is f32 throughout
            q, k_cache, v_cache = q.float(), k_cache.float(), v_cache.float()
        return gqa_attention(q, k_cache, v_cache, pos_base)
    b, t, hq, hd = q.shape
    _, hkv, s, _ = k_cache.shape
    if q.device.type != "cuda":
        raise ValueError(f"flash_gqa_attention: q is on {q.device}")
    if q.dtype == torch.bfloat16 and k_cache.dtype == torch.float32:
        # an f32 cache (--cache-dtype f32): the kernel reads one dtype, and
        # widening q to f32 is exact; the output is rounded once, at the end
        out = flash_gqa_attention(q.float(), k_cache, v_cache, pos_base)
        return out.to(out_dtype or q.dtype)
    if k_cache.device != q.device or v_cache.device != q.device:
        raise ValueError("flash_gqa_attention: q and the cache are on different devices")
    f8 = q.dtype == torch.bfloat16 and k_cache.dtype == torch.float8_e4m3fn
    same = q.dtype in _DTYPES and k_cache.dtype == q.dtype
    if not (f8 or same) or v_cache.dtype != k_cache.dtype:
        raise ValueError("flash_gqa_attention: q and the cache must share one dtype of "
                         "bf16/f32, or be a bf16 q over an e4m3 cache, got "
                         f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if hd not in HEAD_SIZES:
        raise ValueError(f"flash_gqa_attention: head size {hd} not in {HEAD_SIZES}")
    if (tuple(k_cache.shape) != (b, hkv, s, hd) or v_cache.shape != k_cache.shape
            or hq % hkv):
        raise ValueError(f"flash_gqa_attention: q {tuple(q.shape)} against cache "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    if not (q.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("flash_gqa_attention: q and the cache must be contiguous")
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise ValueError(f"flash_gqa_attention: out_dtype {out_dtype} (q.dtype or f32)")
    rows = t * (hq // hkv)
    if isinstance(pos_base, torch.Tensor) and pos_base.dim() == 1:
        if pos_base.shape[0] != b or pos_base.device != q.device:
            raise ValueError("flash_gqa_attention: pos must be [B] on q's device")
        pos_vec = pos_base.to(torch.int32).contiguous()
        pos_scalar = 0
        live_tiles = -(-s // TS)
    else:
        pos_vec = None
        pos_scalar = int(pos_base)
        live_tiles = max(0, min(s - 1, pos_scalar + t - 1)) // TS + 1
    splits, per = kv_splits(rows, b * hkv, live_tiles, _sm_count(q.device.index or 0))
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    o_part = ml_part = None
    if splits > 1:
        rows_pad = -(-rows // TQ) * TQ
        o_part = torch.empty((splits, b * hkv, rows_pad, hd), dtype=torch.float32,
                             device=q.device)
        ml_part = torch.empty((splits, b * hkv, rows_pad, 2), dtype=torch.float32,
                              device=q.device)
    err = build.library("flash_attention").flash_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        o_part.data_ptr() if o_part is not None else None,
        ml_part.data_ptr() if ml_part is not None else None,
        pos_vec.data_ptr() if pos_vec is not None else None, pos_scalar,
        b, t, hq, hkv, s, hd, F8_MODE if f8 else _DTYPES[q.dtype],
        int(out_dtype == torch.float32), splits, per,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_attention", err)
    LAUNCHES["flash_attention_f8" if f8 else "flash_attention"] += 1
    return out


def paged_supported(q_shape: tuple[int, ...], page_size: int) -> bool:
    """K8's rule, the JAX package's paged_supported: a page holds a whole
    number of 64-row tiles (and the head sizes built)."""
    return page_size % TS == 0 and q_shape[-1] in HEAD_SIZES


def paged_flash_gqa_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                              tables: torch.Tensor, pos_base, out_dtype=None) -> torch.Tensor:
    """Paged attention output in ``out_dtype`` (default ``q.dtype``) over one
    layer's pools [P, Hkv, page, hd] through tables i32 [B, nb]; read-only."""
    if q.device.type == "cpu":
        if out_dtype == torch.float32:
            q = q.float()
        return paged_gqa_attention(q, k_pool, v_pool, tables, pos_base)
    if not paged_supported(q.shape, k_pool.shape[2]):
        raise ValueError(f"paged_flash_gqa_attention: page {k_pool.shape[2]} is not a "
                         f"multiple of {TS} rows, or head size {q.shape[-1]} not in "
                         f"{HEAD_SIZES}")
    return paged_attention.launch(q, k_pool, v_pool, tables, pos_base, None, None, None,
                                  out_dtype, TS, LAUNCHES, "paged_flash_attention")
