"""Per-engine kernel selection: the one place the ``--kernels`` flag, the
device and the KV layout turn into the matmul and attention callables an
engine runs.

Rules (the unsharded branches of the JAX package's resolve_kernels):

* ``auto`` on a CUDA device, or ``cuda``: the Q40/Q80 kernels and flash
  attention, which takes bf16, f32 and e4m3 (``--cache-dtype f8``) dense
  caches. Their wrappers run the plain versions for CPU tensors. A head
  size the attention kernel does not take keeps the kernels' matmuls with
  the plain attention (route ``torch``), as the JAX package keeps route
  ``jnp`` there.
* ``auto`` on the CPU, or ``torch``: plain PyTorch matmuls and attention.
* Paged KV layout: route ``paged_kernel`` (the paged attention kernel with
  its fused KV scatter) on a CUDA device with ``auto``/``cuda``; a paged
  layout the kernel does not take (an f8 pool among them: the kernel keeps
  the JAX package's bf16/f32 rule) raises there, naming ``--kernels torch``.
  ``--kernels torch``, or the CPU, gives ``paged_gather`` (the plain
  block-table gather). K8 (``paged_flash_gqa_attention``) is not routed.
* On a mesh each rank resolves the same rules on its own view of the
  config (its heads, parallel/sharding.LocalLlamaConfig), so the CUDA
  kernels run on each shard; a dp replica runs them on its rows. The
  dense layout only, as in the JAX package: the api resolves
  ``--kv-layout auto`` to dense and BatchEngine raises on an explicit
  paged layout; ``--fuse-weights`` is ignored.
* A pp stage (parallel/pipeline) resolves the same rules over its own
  layers, so K1/K2/K7 run on each stage where JAX's pipeline runs XLA
  matmuls and jnp attention (``supports_sharded_pallas`` is False on pp:
  a GSPMD limit, not a semantic). An ep rank runs its experts' products
  on the same kernels.
* On an sp mesh (``sp_attention``, parallel/ring_attention.SPAttention)
  the attention is route ``ring``: the LSE merge and the ring over the
  sequence-sharded cache, plain torch as JAX's is jnp. The matmuls keep
  the backend's kernels on each rank (JAX's GSPMD runs XLA matmuls there,
  as ``pallas_call`` has no partitioning rule; the function is the same).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.ops import flash_attention, paged_attention
from dllama_tpu_torch.ops.layers import MOE_IMPLS, gqa_attention, paged_gqa_attention
from dllama_tpu_torch.ops.matmul import engine_matmul, resolve_backend

#: the paged layout's attention routes, the single definition site: the
#: kernel with its fused KV scatter, and the plain block-table gather (the
#: analyzer's gate-routes rule holds the README port-route table to it)
PAGED_ROUTES = ("paged_kernel", "paged_gather")
KERNEL_ROUTE, GATHER_ROUTE = PAGED_ROUTES


@dataclass
class KernelSelection:
    mm: Callable  # (x, w, layer) -> x @ w[layer]
    attn_fn: Callable  # dense: (q, k_cache, v_cache, pos); paged: see ops.paged_attention
    backend: str  # 'cuda' | 'torch': what the quantized matmuls run on
    attn_route: str  # 'flash' | 'torch' | 'ring' | 'paged_kernel' | 'paged_gather'
    fused_scatter_max_t: int | None = None  # paged_kernel only: widest chunk
    # whose new-KV rows the kernel launch writes itself


def _paged_kernel_attn(q, k_pool, v_pool, tables, pos, new_k, new_v, active):
    """The engine's paged attention: the kernel with its fused scatter."""
    return paged_attention.paged_decode_attention(q, k_pool, v_pool, tables, pos, new_k,
                                                  new_v, active)


_paged_kernel_attn.fused_kv_scatter = True


def resolve_kernels(cfg: LlamaConfig, kernels: str = "auto", device="cpu", paged: bool = False,
                    page_size: int = 0, cache_dtype=torch.bfloat16,
                    sp_attention=None) -> KernelSelection:
    backend = resolve_backend(kernels, device)
    mm = engine_matmul(backend)
    on_cuda = torch.device(device).type == "cuda"
    if sp_attention is not None:
        return KernelSelection(mm, sp_attention, backend, "ring")
    if paged:
        if backend == "torch" or not on_cuda:
            return KernelSelection(mm, paged_gqa_attention, backend, GATHER_ROUTE)
        if not paged_attention.paged_decode_supported((cfg.n_heads, cfg.head_size), page_size,
                                                      cache_dtype):
            raise NotImplementedError(
                f"the paged attention kernel does not take page size {page_size}, head "
                f"size {cfg.head_size} and {cache_dtype} pools (page >= 8, page % 8 == 0, "
                f"head size in {paged_attention.HEAD_SIZES}, bf16/f32); use --kernels torch")
        return KernelSelection(mm, _paged_kernel_attn, backend, KERNEL_ROUTE,
                               paged_attention.FUSED_SCATTER_MAX_T)
    if backend == "torch" or (on_cuda and not flash_attention.supported(cfg.head_size)):
        return KernelSelection(mm, gqa_attention, backend, "torch")
    return KernelSelection(mm, flash_attention.flash_gqa_attention, backend, "flash")


def resolve_moe_impl(moe_impl: str, shardings=None) -> str:
    """The MoE scheme both engines run (ops.layers.moe_ffn), checked, as the
    JAX package resolves it: off an expert-parallel mesh it is ``moe_impl``
    itself, ``auto`` resolved per call (ops.layers: JAX's size rule on the
    CPU, dense on a CUDA device). On ep > 1 ``auto`` is ``dense`` on every
    device and ``sort`` raises JAX's message (its ragged product does not
    partition over a sharded expert axis there); ``dispatch`` runs."""
    if moe_impl not in MOE_IMPLS:
        raise ValueError(f"moe_impl must be one of {MOE_IMPLS}, got {moe_impl!r}")
    ep = shardings.mesh.shape.get("ep", 1) if shardings is not None else 1
    if ep > 1:
        if moe_impl == "sort":
            raise ValueError(
                "moe_impl='sort' is unsupported on ep>1 meshes: ragged_dot "
                "partitions incorrectly over a sharded expert axis; use "
                "'dense' (exact) or 'dispatch'")
        if moe_impl == "auto":
            return "dense"
    return moe_impl
