"""Per-engine kernel selection: the one place the ``--kernels`` flag and the
device turn into the matmul and attention callables an engine runs.

Rules (the unsharded dense branch of the JAX package's resolve_kernels):

* ``auto`` on a CUDA device, or ``cuda``: the Q40 kernels and flash
  attention. Their wrappers run the plain versions for CPU tensors.
* ``auto`` on the CPU, or ``torch``: plain PyTorch matmuls and attention.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.ops import flash_attention
from dllama_tpu_torch.ops.layers import gqa_attention
from dllama_tpu_torch.ops.matmul import engine_matmul, resolve_backend


@dataclass
class KernelSelection:
    mm: Callable  # (x, w, layer) -> x @ w[layer]
    attn_fn: Callable  # (q, k_cache, v_cache, pos) -> attention output
    backend: str  # 'cuda' | 'torch': what the quantized matmuls run on
    attn_route: str  # 'flash' | 'torch': what attention runs on


def resolve_kernels(cfg: LlamaConfig, kernels: str = "auto", device="cpu") -> KernelSelection:
    backend = resolve_backend(kernels, device)
    mm = engine_matmul(backend)
    if backend == "torch":
        return KernelSelection(mm, gqa_attention, backend, "torch")
    if torch.device(device).type == "cuda" and not flash_attention.supported(cfg.head_size):
        raise NotImplementedError(
            f"head size {cfg.head_size} has no CUDA attention kernel yet "
            f"({flash_attention.HEAD_SIZES} are built); use --kernels torch")
    return KernelSelection(mm, flash_attention.flash_gqa_attention, backend, "flash")
