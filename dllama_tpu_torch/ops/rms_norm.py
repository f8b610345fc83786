"""RMSNorm: the CUDA kernel's wrapper.

``rms_norm(x, weight, eps)`` has the signature and semantics of
:func:`dllama_tpu_torch.ops.layers.rms_norm_plain`, its plain version: any
leading dims, f32 accumulation, one cast back to ``x.dtype``. On a CUDA
tensor it launches ``csrc/rms_norm.cu`` (replaces
``dllama_tpu/ops/pallas/rms_norm.py:_kernel``); on a CPU tensor it runs the
plain version. ``ops/layers.RMS_NORM_IMPL = "cuda"`` routes the model's
norms here; the default, ``"torch"``, keeps the plain norm, as the JAX
package keeps its jnp norm by default.
"""

from __future__ import annotations

import torch

from dllama_tpu_torch.ops import build
from dllama_tpu_torch.ops.layers import rms_norm_plain

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

#: kernel launches made through the wrapper (a plain int under one key)
LAUNCHES = {"rms_norm": 0}


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
    if d % 8 or tuple(weight.shape) != (d,):
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
    err = build.library("rms_norm").rms_norm(
        x2.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d, x2.stride(0), float(eps),
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check("rms_norm", err)
    LAUNCHES["rms_norm"] += 1
    return out.reshape(*lead, d)
