"""Q40 matmul: the CUDA kernels' wrappers and their plain version.

``q40_matmul(x, w, layer)`` computes ``x @ w[layer]`` for a Q40 weight in
the device layout of :class:`~dllama_tpu_torch.ops.quant.QTensor` and
returns ``x.dtype``. On a CUDA tensor it launches one of two kernels, split
by the number of rows as on the TPU:

* ``csrc/q40_decode.cu`` for m <= 16 (decode): exact codes, per-block
  partial dots scaled in f32, split-k with a fixed-order reduction
  (replaces ``dllama_tpu/ops/pallas/q40_matmul.py:_blockdot_kernel``);
* ``csrc/q40_prefill.cu`` for m > 16 (prefill chunks): weight tiles
  dequantized to bf16 in shared memory, tensor-core products with f32
  accumulation (replaces ``_deq_kernel``).

Unlike the TPU kernels no row padding is needed (the (8, 128) tiling was a
TPU constraint), and a stacked ``[L, k/2, n]`` weight is addressed by taking
the view ``packed[layer]`` — a free view of the contiguous stack, so the
TPU's scalar-prefetch layer indexing has no counterpart.

On a CPU tensor the wrapper runs :func:`q40_matmul_plain`, the JAX XLA
path's arithmetic: dequantize to f32, cast to the activation dtype, f32 dot,
cast back. A CUDA tensor never reaches it through the wrapper.
"""

from __future__ import annotations

import functools
import math

import torch

from dllama_tpu_torch.ops import build
from dllama_tpu_torch.ops.quant import Q_BLOCK, QTensor

#: widest row count the decode kernel takes (the TPU's blockdot split)
DECODE_MAX_M = 16
#: decode-kernel blocks (64 threads each) to aim for on every SM
DECODE_BLOCKS_PER_SM = 16
#: fewest 32-row blocks of k one decode split walks
DECODE_MIN_BLOCKS_PER_SPLIT = 4
#: fewest 64-row steps of k one prefill split walks
PREFILL_MIN_STEPS_PER_SPLIT = 8

#: kernel launches made through the wrappers (plain ints; reset by callers
#: that want to see which kernels a run went through)
LAUNCHES = {"q40_decode": 0, "q40_prefill": 0}


def _layer_view(w: QTensor, layer) -> tuple[torch.Tensor, torch.Tensor]:
    if layer is None:
        packed, scales = w.packed, w.scales
    else:
        packed, scales = w.packed[layer], w.scales[layer]
    if packed.dim() != 2:
        raise ValueError("a stacked QTensor needs a layer index")
    return packed, scales


def q40_matmul_plain(x: torch.Tensor, w: QTensor, layer=None, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch ``x @ w[layer]``: dequantize (exact f32 codes times
    scales), round the weight to ``x.dtype``, f32 dot, cast to ``out_dtype``
    (default ``x.dtype``)."""
    packed, scales = _layer_view(w, layer)
    wd = QTensor(packed, scales).dequantize(x.dtype)
    out = torch.matmul(x.to(torch.float32), wd.to(torch.float32))
    return out.to(out_dtype or x.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def decode_splits(k: int, n: int, sms: int) -> tuple[int, int]:
    """(splits, 32-row blocks per split) of the decode kernel's split-k:
    about DECODE_BLOCKS_PER_SM blocks of two warps on every SM — enough
    loads in flight to cover the memory latency — each split a whole
    number of 32-row blocks, at least DECODE_MIN_BLOCKS_PER_SPLIT of them
    (the fixed-order reduction reads every split's partial row)."""
    col_blocks = -(-n // 256)
    nkb = k // Q_BLOCK
    splits = min(max(1, nkb // DECODE_MIN_BLOCKS_PER_SPLIT),
                 max(1, math.ceil(DECODE_BLOCKS_PER_SM * sms / col_blocks)))
    per = -(-nkb // splits)
    return -(-nkb // per), per


def prefill_splits(m: int, k: int, n: int, sms: int) -> tuple[int, int]:
    """(splits, 64-row steps per split) of the prefill kernel's split-k:
    only where its 64 x 128 output tiles alone would give fewer than two
    blocks per SM, and never below PREFILL_MIN_STEPS_PER_SPLIT steps."""
    tiles = -(-m // 64) * -(-n // 128)
    steps = -(-k // 64)
    splits = min(max(1, steps // PREFILL_MIN_STEPS_PER_SPLIT),
                 max(1, math.ceil(2 * sms / tiles)))
    per = -(-steps // splits)
    return -(-steps // per), per


def _check_cuda(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"q40_matmul: x is on {x.device}; the kernels take CUDA "
                         "tensors (CPU tensors run the plain version)")
    if packed.device != x.device or scales.device != x.device:
        raise ValueError("q40_matmul: x and the weight are on different devices")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"q40_matmul: the CUDA kernels take bf16 activations, got {x.dtype}")
    if packed.dtype != torch.uint8 or scales.dtype != torch.float16:
        raise ValueError("q40_matmul: weight must be packed u8 + f16 scales, "
                         f"got {packed.dtype} / {scales.dtype}")
    if not (x.is_contiguous() and packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError("q40_matmul: x, packed and scales must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("q40_matmul: x must be 16-byte aligned")


def q40_matmul(x: torch.Tensor, w: QTensor, layer=None, out_dtype=None) -> torch.Tensor:
    """``x[..., k] @ w[layer]`` -> ``[..., n]`` in ``out_dtype`` (default
    ``x.dtype``; the kernels also write f32, the sum before its rounding)."""
    packed, scales = _layer_view(w, layer)
    *lead, k = x.shape
    n = packed.shape[1]
    if k % Q_BLOCK or packed.shape[0] * 2 != k or tuple(scales.shape) != (k // Q_BLOCK, n):
        raise ValueError(f"q40_matmul: x [..., {k}] against packed "
                         f"{tuple(packed.shape)} / scales {tuple(scales.shape)}")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return q40_matmul_plain(x, w, layer, out_dtype)
    _check_cuda(x, packed, scales)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q40_matmul: out_dtype {out_dtype} (bf16 or f32)")
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    out_f32 = int(out_dtype == torch.float32)
    if m == 0:
        return out.reshape(*lead, n)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if m <= DECODE_MAX_M:
        splits, per = decode_splits(k, n, _sm_count(x.device.index or 0))
        partial = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
                   if splits > 1 else None)
        err = build.library("q40_decode").q40_decode(
            x2.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            partial.data_ptr() if partial is not None else None, out.data_ptr(),
            m, k, n, splits, per, out_f32, stream)
        build.check("q40_decode", err)
        LAUNCHES["q40_decode"] += 1
    else:
        splits, per = prefill_splits(m, k, n, _sm_count(x.device.index or 0))
        partial = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
                   if splits > 1 else None)
        err = build.library("q40_prefill").q40_prefill(
            x2.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            partial.data_ptr() if partial is not None else None, out.data_ptr(),
            m, k, n, splits, per, out_f32, stream)
        build.check("q40_prefill", err)
        LAUNCHES["q40_prefill"] += 1
    return out.reshape(*lead, n)
