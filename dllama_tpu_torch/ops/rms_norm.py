"""RMSNorm: the CUDA kernel's wrapper, its geometry and the engines' route.

``rms_norm(x, weight, eps)`` has the signature and semantics of
:func:`dllama_tpu_torch.ops.layers.rms_norm_plain`, its plain version: any
leading dims, f32 accumulation, one cast back to ``x.dtype``. On a CUDA
tensor it launches ``csrc/rms_norm.cu`` (replaces
``dllama_tpu/ops/pallas/rms_norm.py:_kernel``) in the geometry of
:func:`geometry`; on a CPU tensor it runs the plain version.

:func:`engine_norm` is the norm an engine's forward runs (carried on
``engine/kernel_select.KernelSelection`` beside the matmul and attention):
the kernel's route where the engine's kernels are CUDA, the plain norm
under ``--kernels torch`` and on the CPU.
"""

from __future__ import annotations

from typing import Callable

import torch

from dllama_tpu_torch.ops import build, layers
from dllama_tpu_torch.ops.layers import rms_norm_plain

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

#: elements of a vector: a thread's 16-byte load of bf16 (two of f32)
VEC = 8
#: vectors a thread of the one-pass kernel holds: its template instances
#: (csrc/rms_norm.cu); 0 names the looped instance, which reads a row twice
VECTORS = (1, 2, 4)
#: vectors a thread the geometry aims at: four independent loads in flight
TARGET_VECTORS = 4
#: the one-pass instances' largest block (weight and row take 16 registers
#: a vector a thread) and the looped instance's block
ONE_PASS_THREADS, LOOPED_THREADS = 512, 1024

#: kernel launches made through the wrapper (a plain int under one key)
LAUNCHES = {"rms_norm": 0}


def geometry(d: int) -> tuple[int, int]:
    """(threads a row, vectors a thread) of the kernel over rows of width d,
    d % 8 == 0; the kernel runs one block a row. Threads are a multiple of
    32, enough for TARGET_VECTORS vectors each; vectors the fewest of VECTORS
    that cover the row, or 0 (the looped instance at LOOPED_THREADS) past
    ONE_PASS_THREADS. Thread t holds vectors t, t + threads, ... of its
    row."""
    nvec = d // VEC
    threads = -(-nvec // TARGET_VECTORS)
    threads = max(32, -(-threads // 32) * 32)
    if threads > ONE_PASS_THREADS:
        return LOOPED_THREADS, 0
    return threads, next(v for v in VECTORS if v * threads >= nvec)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """y = x * w / rms(x) over the last dim of x, in ``x.dtype``."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"rms_norm: x on {x.device} and the weight on {weight.device}; "
                         "the kernel takes CUDA tensors on one device")
    *lead, d = x.shape
    if x.dtype not in _DTYPES or weight.dtype != torch.float32:
        raise ValueError(f"rms_norm: x must be bf16/f32 and the weight f32, got "
                         f"{x.dtype} / {weight.dtype}")
    if d % VEC or tuple(weight.shape) != (d,):
        raise ValueError(f"rms_norm: width {d} (a multiple of 8) against weight "
                         f"{tuple(weight.shape)}")
    x2 = x.reshape(-1, d)  # a view for the model's row slices (x[:, -1:])
    rows = x2.shape[0]
    out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    if rows == 0:
        return out.reshape(*lead, d)
    if (x2.stride(1) != 1 or (x2.stride(0) * x2.element_size()) % 16 or x2.data_ptr() % 16
            or not weight.is_contiguous() or weight.data_ptr() % 16):
        raise ValueError("rms_norm: rows of x and the weight must be contiguous and "
                         "16-byte aligned")
    threads, vectors = geometry(d)
    err = build.library("rms_norm").rms_norm(
        x2.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d, x2.stride(0), float(eps),
        _DTYPES[x.dtype], threads, vectors, torch.cuda.current_stream(x.device).cuda_stream)
    build.check("rms_norm", err)
    LAUNCHES["rms_norm"] += 1
    return out.reshape(*lead, d)


def kernel_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """The norm of an engine whose kernels are CUDA: the kernel where
    ``ops/layers.RMS_NORM_IMPL`` is "cuda", the plain norm where it is
    "torch" (for a comparison on the card); any other value raises. The
    switch is read at each call and is one of ``engine/graphs.knobs``, so a
    captured program keeps the norm it was captured with."""
    impl = layers.RMS_NORM_IMPL
    if impl == "cuda":
        return rms_norm(x, weight, eps)
    if impl == "torch":
        return rms_norm_plain(x, weight, eps)
    raise ValueError(f"ops/layers.RMS_NORM_IMPL is {impl!r}; it takes 'cuda' or 'torch'")


def engine_norm(backend: str) -> Callable:
    """The norm of one engine: :func:`kernel_norm` for the ``cuda`` backend
    (whose wrapper runs the plain version on CPU tensors), the plain norm
    for ``torch``."""
    return kernel_norm if backend == "cuda" else rms_norm_plain
