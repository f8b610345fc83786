"""Carry a parameter tree of the JAX package across to this package.

``params_from_numpy(tree, device)`` takes the `dllama_tpu` parameter tree
with every leaf already a numpy array — e.g. ``jax.tree.map(np.asarray,
params)`` — and returns this package's tree on ``device``. A Q40 weight
arrives as an object with ``packed``/``scales`` attributes (the JAX
``QTensor`` after the tree map) or as a ``{"packed", "scales"}`` dict; a Q80
weight likewise with ``codes``/``scales``. Bytes are unchanged: the same
device layout, f16 scales, and bf16 leaves bit for bit.

``paged_cache_from_numpy(cache, device)`` does the same for a JAX
``PagedKVCache`` (its k, v and tables as numpy arrays, or the cache itself
after ``jax.tree.map(np.asarray, cache)``), so tests hand one pool state to
both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from dllama_tpu_torch.models.llama import PagedKVCache
from dllama_tpu_torch.ops.quant import Q8Tensor, QTensor


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if not a.flags.writeable:  # a read-only view of a JAX array: own a copy
        a = a.copy()
    if a.dtype.name == "bfloat16":  # ml_dtypes: carry the bits across
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _fields(x, names):
    if isinstance(x, dict) and set(x) == set(names):
        return [x[n] for n in names]
    if all(hasattr(x, n) for n in names):
        return [getattr(x, n) for n in names]
    return None


def params_from_numpy(tree, device="cpu"):
    """Numpy-leaved JAX parameter tree -> this package's tree on `device`."""
    q = _fields(tree, ("packed", "scales"))
    if q is not None:
        return QTensor(_tensor(q[0], device), _tensor(q[1], device))
    q8 = _fields(tree, ("codes", "scales"))
    if q8 is not None:
        return Q8Tensor(_tensor(q8[0], device), _tensor(q8[1], device))
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def paged_cache_from_numpy(cache, device="cpu") -> PagedKVCache:
    """A JAX PagedKVCache with numpy leaves (k, v [L, P+1, Hkv, page, hd],
    tables i32 [n_slots, max_blocks]) -> this package's PagedKVCache."""
    k, v, tables = _fields(cache, ("k", "v", "tables"))
    return PagedKVCache(_tensor(k, device), _tensor(v, device),
                        _tensor(tables, device).to(torch.int32))
