"""Paged attention over the KV page pool: the CUDA kernel's wrapper.

``paged_decode_attention`` has the signature and return contract of the JAX
package's ``ops/pallas/paged_attention.paged_decode_attention``. Without
``new_k`` it is a drop-in for :func:`dllama_tpu_torch.ops.layers.paged_gqa_attention`
and returns the output. With ``new_k``/``new_v`` it is the fused decode step:
the new rows are written at their block-table positions (inactive rows to the
trash page; the kernel computes the targets of
``ops.layers.paged_write_targets`` itself) and the sweep reads them; it
returns ``(out, k_pool, v_pool)`` with the pools updated in place (JAX
aliases them, so in place is the same contract). Chunks longer than
``FUSED_SCATTER_MAX_T`` rows are scattered first by the plain scatter, then
swept read-only, as JAX scatters them in XLA.

On a CUDA tensor it launches ``csrc/paged_attention.cu`` (replaces
``dllama_tpu/ops/pallas/paged_attention.py:_kernel``), whose sweep is the
tensor-core body of flash attention (``csrc/attention.cuh``) with KV rows
gathered through the block table; on a CPU tensor it runs the plain version,
``models.llama._paged_cache_update`` followed by ``paged_gqa_attention``.
Nothing here reads a device value back to the host.
"""

from __future__ import annotations

import math

import torch

from dllama_tpu_torch.models.llama import _paged_cache_update
from dllama_tpu_torch.ops import build
from dllama_tpu_torch.ops.layers import paged_gqa_attention
from dllama_tpu_torch.ops.q40_matmul import _sm_count

#: widest chunk (query rows per slot) whose new-KV rows are written by the
#: kernel launch itself; wider chunks (prefill) are scattered first
FUSED_SCATTER_MAX_T = 16
TQ = 64  # folded query rows per block (csrc/attention.cuh)
TS = 64  # cache rows per KV tile
BLOCKS_PER_SM = 2  # blocks an SM holds (the source's kMinBlocksPerSm)
#: waves of blocks the split rule aims for when every slot's table is full
WAVES = 2
MIN_TILES_PER_SPLIT = 2
HEAD_SIZES = (64, 128)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

#: kernel launches made through the wrapper (a plain int under one key)
LAUNCHES = {"paged_attention": 0}


def paged_decode_supported(q_shape: tuple[int, ...], page_size: int,
                           kv_dtype=torch.bfloat16) -> bool:
    """What the kernel takes: any page of at least 8 rows that is a whole
    number of 8-row sub-tiles, the head sizes built (64, 128), and bf16 or
    f32 pools. Ragged tables need nothing: entries past a slot's horizon are
    never read and unallocated ones are masked by position."""
    return (page_size >= 8 and page_size % 8 == 0 and q_shape[-1] in HEAD_SIZES
            and kv_dtype in _DTYPES)


def kv_splits(rows: int, bhkv: int, table_tiles: int, sms: int) -> tuple[int, int]:
    """(splits, tiles per split) of the KV sweep, from the table width in
    64-row tiles (no horizon from the device): split z walks tiles
    [z * per, (z + 1) * per) of each query tile's live ones, and a split past
    a slot's horizon exits at once, so a long slot gets many blocks and a
    short one few. Enough splits for WAVES waves of the BLOCKS_PER_SM blocks
    each SM holds when every slot is full, each at least MIN_TILES_PER_SPLIT
    tiles: at mixed positions the longest slot's blocks then hold half the
    tiles one wave would give them. It depends on the rows only through the
    number of query tiles, so decode (4 rows) and a spec verify forward (36)
    split a row's keys alike."""
    q_tiles = -(-rows // TQ)
    splits = min(max(1, table_tiles // MIN_TILES_PER_SPLIT),
                 max(1, math.ceil(WAVES * BLOCKS_PER_SM * sms / (q_tiles * bhkv))))
    per = -(-table_tiles // splits)
    return -(-table_tiles // per), per


def paged_decode_attention_plain(q, k_pool, v_pool, tables, pos_base, new_k=None,
                                 new_v=None, active=None):
    """The plain version: the model's scatter, then the gather attention."""
    if new_k is None:
        return paged_gqa_attention(q, k_pool, v_pool, tables, pos_base)
    _paged_cache_update(k_pool, new_k, tables, pos_base, active)
    _paged_cache_update(v_pool, new_v, tables, pos_base, active)
    return paged_gqa_attention(q, k_pool, v_pool, tables, pos_base), k_pool, v_pool


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           tables: torch.Tensor, pos_base, new_k: torch.Tensor | None = None,
                           new_v: torch.Tensor | None = None,
                           active: torch.Tensor | None = None, out_dtype=None):
    """Paged attention of q [B, T, Hq, hd] over one layer's pools
    [P, Hkv, page, hd] through tables i32 [B, nb] at pos (an int or an i32
    [B] tensor on q's device). ``out_dtype`` (default ``q.dtype``; the kernel
    also writes f32, the result before its rounding)."""
    if q.device.type == "cpu":
        if out_dtype == torch.float32:  # the plain math is f32 throughout
            q = q.float()
        return paged_decode_attention_plain(q, k_pool, v_pool, tables, pos_base, new_k,
                                            new_v, active)
    write = new_k is not None
    if write and q.shape[1] > FUSED_SCATTER_MAX_T:
        # prefill-sized chunk: one plain scatter, then the read-only sweep
        _paged_cache_update(k_pool, new_k, tables, pos_base, active)
        _paged_cache_update(v_pool, new_v, tables, pos_base, active)
        write = False
    out = launch(q, k_pool, v_pool, tables, pos_base, new_k if write else None,
                 new_v if write else None, active, out_dtype, LAUNCHES, "paged_attention")
    if new_k is None:
        return out
    return out, k_pool, v_pool


def launch(q, k_pool, v_pool, tables, pos_base, new_k, new_v, active, out_dtype,
           counter: dict, key: str) -> torch.Tensor:
    """One call of the C entry point (scatter when ``new_k`` is given, then
    the sweep); counts it under ``counter[key]``. Shared with the read-only
    K8 wrapper in ops.flash_attention."""
    b, t, hq, hd = q.shape
    n_pool, hkv, page, _ = k_pool.shape
    if q.device.type != "cuda":
        raise ValueError(f"paged attention: q is on {q.device}")
    if q.dtype == torch.bfloat16 and k_pool.dtype == torch.float32:
        # f32 pools: the kernel reads one dtype, and widening q is exact;
        # the output is rounded once, at the end
        out = launch(q.float(), k_pool, v_pool, tables, pos_base, new_k, new_v, active,
                     None, counter, key)
        return out.to(out_dtype or q.dtype)
    for name, x in (("k_pool", k_pool), ("v_pool", v_pool), ("tables", tables)):
        if x.device != q.device:
            raise ValueError(f"paged attention: {name} is on {x.device}, q on {q.device}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError("paged attention: q and the pools must share one dtype of "
                         f"bf16/f32, got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if not paged_decode_supported(q.shape, page, k_pool.dtype):
        raise ValueError(f"paged attention: page {page} / head size {hd} not supported "
                         f"(page >= 8, page % 8 == 0, head size in {HEAD_SIZES})")
    if (v_pool.shape != k_pool.shape or k_pool.shape[3] != hd or hq % hkv
            or tables.dim() != 2 or tables.shape[0] != b):
        raise ValueError(f"paged attention: q {tuple(q.shape)} against pools "
                         f"{tuple(k_pool.shape)} / tables {tuple(tables.shape)}")
    if not (q.is_contiguous() and k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged attention: q and the pools must be contiguous")
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise ValueError(f"paged attention: out_dtype {out_dtype} (q.dtype or f32)")
    nb = tables.shape[1]
    tables = tables.to(torch.int32).contiguous()
    if isinstance(pos_base, torch.Tensor):
        if pos_base.device != q.device or pos_base.numel() not in (1, b):
            raise ValueError("paged attention: pos must be [B] on q's device")
        pos = pos_base.to(torch.int32).reshape(-1).expand(b).contiguous()
    else:
        pos = torch.full((b,), int(pos_base), dtype=torch.int32, device=q.device)
    nk = nv = act = None
    if new_k is not None:
        if new_k.shape != (b, hkv, t, hd) or new_v.shape != new_k.shape:
            raise ValueError(f"paged attention: new rows {tuple(new_k.shape)}, want "
                             f"{(b, hkv, t, hd)}")
        # the kernel reads [B, T, Hkv, hd]: the layer's own layout, so the
        # engine's k.transpose(1, 2) comes back without a copy
        nk = new_k.transpose(1, 2).to(k_pool.dtype).contiguous()
        nv = new_v.transpose(1, 2).to(v_pool.dtype).contiguous()
        if active is not None:
            act = active.to(device=q.device, dtype=torch.bool).reshape(b).contiguous()
    rows = t * (hq // hkv)
    splits, per = kv_splits(rows, b * hkv, -(-nb * page // TS),
                            _sm_count(q.device.index or 0))
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    o_part = ml_part = None
    if splits > 1:
        rows_pad = -(-rows // TQ) * TQ
        o_part = torch.empty((splits, b * hkv, rows_pad, hd), dtype=torch.float32,
                             device=q.device)
        ml_part = torch.empty((splits, b * hkv, rows_pad, 2), dtype=torch.float32,
                              device=q.device)

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = build.library("paged_attention").paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ptr(nk), ptr(nv), ptr(act),
        tables.data_ptr(), pos.data_ptr(), out.data_ptr(), ptr(o_part), ptr(ml_part), b, t,
        hq, hkv, page, nb, n_pool, hd, _DTYPES[q.dtype], int(out_dtype == torch.float32),
        splits, per, torch.cuda.current_stream(q.device).cuda_stream)
    build.check("paged_attention", err)
    counter[key] += 1
    return out
