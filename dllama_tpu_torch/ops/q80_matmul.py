"""Q80 matmul: the CUDA kernels' wrappers and their plain version.

``q80_matmul(x, w, layer)`` computes ``x @ w[layer]`` for a Q80 weight in
the device layout of :class:`~dllama_tpu_torch.ops.quant.Q8Tensor` (int8
codes ``[(L,) k, n]``, f16 scales ``[(L,) k/32, n]``) and returns
``x.dtype``. On a CUDA tensor it launches one of two kernels, split by the
number of rows as on the TPU (JAX splits on the row count padded to 8, which
gives the same cut):

* ``csrc/q80_decode.cu`` for m <= 16 (decode): exact int8 codes, per-block
  partial dots scaled in f32, split-k with a fixed-order reduction
  (replaces ``dllama_tpu/ops/pallas/q80_matmul.py:_blockdot_kernel``);
* ``csrc/q80_prefill.cu`` for m > 16 (prefill chunks): weight tiles
  dequantized to bf16 in shared memory, tensor-core products with f32
  accumulation (replaces ``_deq_kernel``).

Both kernels share the Q40 kernels' tiles (256 columns per decode block, 64
x 128 prefill tiles with a 64-row k step), but not their split-k rule: where
a split starts depends on k alone (:func:`decode_splits`,
:func:`prefill_splits`), so every output column is summed in the same order
whatever n is, and fused wqkv/w13 weights (``--fuse-weights``) give the
bit-equal columns of their parts. A stacked ``[L, k, n]`` weight is
addressed by the free view ``codes[layer]``.

On a CPU tensor the wrapper runs :func:`q80_matmul_plain`, the JAX XLA
path's arithmetic: dequantize to f32, cast to the activation dtype, f32 dot,
cast back. A CUDA tensor never reaches it through the wrapper.
"""

from __future__ import annotations

import torch

from dllama_tpu_torch.ops import build
from dllama_tpu_torch.ops.q40_matmul import DECODE_MAX_M, _sm_count
from dllama_tpu_torch.ops.quant import Q_BLOCK, Q8Tensor

#: 32-row blocks of k per decode split: every run of 4 is its own split
DECODE_BLOCKS_PER_SPLIT = 4
#: 64-row steps the prefill kernel sums from zero before adding them to its
#: total (csrc/q80_prefill.cu kRunSteps): the unit of its split-k
PREFILL_RUN_STEPS = 8

#: kernel launches made through the wrappers (plain ints; reset by callers
#: that want to see which kernels a run went through)
LAUNCHES = {"q80_decode": 0, "q80_prefill": 0}


def _layer_view(w: Q8Tensor, layer) -> tuple[torch.Tensor, torch.Tensor]:
    if layer is None:
        codes, scales = w.codes, w.scales
    else:
        codes, scales = w.codes[layer], w.scales[layer]
    if codes.dim() != 2:
        raise ValueError("a stacked Q8Tensor needs a layer index")
    return codes, scales


def q80_matmul_plain(x: torch.Tensor, w: Q8Tensor, layer=None, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch ``x @ w[layer]``: dequantize (exact f32 codes times f32
    scales), round the weight once to ``x.dtype``, f32 dot, cast to
    ``out_dtype`` (default ``x.dtype``)."""
    codes, scales = _layer_view(w, layer)
    wd = Q8Tensor(codes, scales).dequantize(x.dtype)
    out = torch.matmul(x.to(torch.float32), wd.to(torch.float32))
    return out.to(out_dtype or x.dtype)


def decode_splits(k: int) -> tuple[int, int]:
    """(splits, 32-row blocks per split) of the decode kernel: one split per
    DECODE_BLOCKS_PER_SPLIT blocks, whatever n is (wq/wk at k = 4096: 32
    splits, enough blocks in flight for the narrowest n)."""
    nkb = k // Q_BLOCK
    return -(-nkb // DECODE_BLOCKS_PER_SPLIT), DECODE_BLOCKS_PER_SPLIT


def prefill_splits(m: int, k: int, n: int, sms: int) -> tuple[int, int]:
    """(splits, 64-row steps per split) of the prefill kernel: one split per
    PREFILL_RUN_STEPS-step run where the 64 x 128 output tiles would leave
    more than half the SMs idle, else one split for all of k. The kernel
    sums the runs in k order either way, so the choice (which follows n)
    changes no bit of a column."""
    steps = -(-k // 64)
    if -(-m // 64) * -(-n // 128) * 2 < sms:
        return -(-steps // PREFILL_RUN_STEPS), PREFILL_RUN_STEPS
    return 1, steps


def _check_cuda(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"q80_matmul: x is on {x.device}; the kernels take CUDA "
                         "tensors (CPU tensors run the plain version)")
    if codes.device != x.device or scales.device != x.device:
        raise ValueError("q80_matmul: x and the weight are on different devices")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"q80_matmul: the CUDA kernels take bf16 activations, got {x.dtype}")
    if codes.dtype != torch.int8 or scales.dtype != torch.float16:
        raise ValueError("q80_matmul: weight must be i8 codes + f16 scales, "
                         f"got {codes.dtype} / {scales.dtype}")
    if not (x.is_contiguous() and codes.is_contiguous() and scales.is_contiguous()):
        raise ValueError("q80_matmul: x, codes and scales must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("q80_matmul: x must be 16-byte aligned")


def q80_matmul(x: torch.Tensor, w: Q8Tensor, layer=None, out_dtype=None) -> torch.Tensor:
    """``x[..., k] @ w[layer]`` -> ``[..., n]`` in ``out_dtype`` (default
    ``x.dtype``; the kernels also write f32, the sum before its rounding)."""
    codes, scales = _layer_view(w, layer)
    *lead, k = x.shape
    n = codes.shape[1]
    if k % Q_BLOCK or codes.shape[0] != k or tuple(scales.shape) != (k // Q_BLOCK, n):
        raise ValueError(f"q80_matmul: x [..., {k}] against codes "
                         f"{tuple(codes.shape)} / scales {tuple(scales.shape)}")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return q80_matmul_plain(x, w, layer, out_dtype)
    _check_cuda(x, codes, scales)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q80_matmul: out_dtype {out_dtype} (bf16 or f32)")
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, n)
    if m <= DECODE_MAX_M:
        name, (splits, per) = "q80_decode", decode_splits(k)
    else:
        name, (splits, per) = "q80_prefill", prefill_splits(m, k, n,
                                                            _sm_count(x.device.index or 0))
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    err = getattr(build.library(name), name)(
        x2.data_ptr(), codes.data_ptr(), scales.data_ptr(),
        partial.data_ptr() if partial is not None else None, out.data_ptr(),
        m, k, n, splits, per, int(out_dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(name, err)
    LAUNCHES[name] += 1
    return out.reshape(*lead, n)
