"""Matmul dispatch: the CUDA Q40/Q80 kernels, or plain PyTorch.

Two backends, resolved once per engine from the ``--kernels`` flag:

* ``cuda``  — Q40 and Q80 weights go through the hand-written kernels
              (ops/q40_matmul.py, ops/q80_matmul.py), as the JAX package
              routes both to its Pallas kernels. Their wrappers run the plain
              version for CPU tensors, so this backend is also correct on the
              CPU.
* ``torch`` — dequantize-then-dot in plain PyTorch everywhere: the
              counterpart of the JAX package's ``xla`` backend, taken only
              when asked for explicitly.

Dense (unquantized) weights go to ``torch.matmul`` on either backend, with
an f32 product cast back to the activation dtype.
"""

from __future__ import annotations

import functools

import torch

from dllama_tpu_torch.ops.q40_matmul import q40_matmul, q40_matmul_plain
from dllama_tpu_torch.ops.q80_matmul import q80_matmul, q80_matmul_plain
from dllama_tpu_torch.ops.quant import Q8Tensor, QTensor, slice_leaf

BACKENDS = ("auto", "cuda", "torch")


def resolve_backend(backend: str, device) -> str:
    """'cuda' or 'torch'. 'auto' is 'cuda' on a CUDA device and the plain
    'torch' path on the CPU."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernels backend {backend!r} (one of {BACKENDS})")
    if backend == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    return backend


def engine_matmul(backend: str) -> functools.partial:
    """The bound matmul of one engine: ``mm(x, w, layer)``."""
    return functools.partial(matmul, backend=backend)


def matmul(x: torch.Tensor, w, layer=None, backend: str = "cuda",
           out_dtype=None) -> torch.Tensor:
    """``x @ w`` (or ``x @ w[layer]`` for a stacked weight; ``layer`` may be
    a tuple, e.g. (layer, expert) of an expert stack) where ``w`` is a
    QTensor/Q8Tensor or a dense tensor. Returns ``out_dtype`` (default
    ``x.dtype``; f32 is the sum before its rounding)."""
    if isinstance(w, QTensor):
        if backend == "cuda":
            return q40_matmul(x, w, layer, out_dtype)
        return q40_matmul_plain(x, w, layer, out_dtype)
    if isinstance(w, Q8Tensor):
        if backend == "cuda":
            return q80_matmul(x, w, layer, out_dtype)
        return q80_matmul_plain(x, w, layer, out_dtype)
    if layer is not None and w.dim() > 2:
        w = slice_leaf(w, layer)
    wd = w.to(x.dtype)
    return torch.matmul(x.to(torch.float32), wd.to(torch.float32)).to(out_dtype or x.dtype)
