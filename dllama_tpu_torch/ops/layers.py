"""Core model ops: RMSNorm, RoPE, GQA attention, activations, the sparse MoE FFN.

Plain PyTorch. Numerics follow the reference kernels (nn-cpu-ops.cpp) and
the `dllama_tpu` package's casts: norms, RoPE, softmax and attention
accumulate in f32 and cast back to the activation dtype at the same points,
so bf16 runs of the two packages round at the same places.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from dllama_tpu_torch.models.config import HiddenAct, LlamaConfig, RopeType


#: The norm of an engine whose kernels are CUDA (ops/rms_norm.kernel_norm):
#: 'cuda' (the default) runs the kernel (K10), 'torch' the plain norm
#: below. Engines with the plain kernels (--kernels torch, the CPU) run the
#: plain norm either way. The JAX package's switch keeps its jnp norm by
#: default, since XLA fuses it; nothing fuses the plain chain on the card,
#: and the kernel's captured steps were faster (PERF.md §6).
RMS_NORM_IMPL = "cuda"


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """y = x * w / rms(x) with f32 accumulation (nn-cpu-ops.cpp:108-183): the
    plain version of the RMSNorm kernel, the mean of squares in f32,
    rsqrt(+eps), times the f32 weight, one cast to ``x.dtype``."""
    xf = x.to(torch.float32)
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv * weight.to(torch.float32)).to(x.dtype)


def activation(x: torch.Tensor, act: HiddenAct) -> torch.Tensor:
    if act == HiddenAct.SILU:
        return F.silu(x)
    return F.gelu(x, approximate="none")


def llama31_scale_freqs(freqs: np.ndarray, cfg: LlamaConfig) -> np.ndarray:
    """Llama-3.1 NTK-by-parts frequency scaling (frequency domain, as Meta's
    reference model applies it)."""
    wavelen = 2.0 * math.pi / freqs
    high_freq_wavelen = cfg.rope_scaling_orig_max_seq_len / cfg.rope_scaling_high_freq_factor
    low_freq_wavelen = cfg.rope_scaling_orig_max_seq_len / cfg.rope_scaling_low_freq_factor
    scaled = freqs / cfg.rope_scaling_factor
    smooth = (cfg.rope_scaling_orig_max_seq_len / wavelen - cfg.rope_scaling_low_freq_factor) / (
        cfg.rope_scaling_high_freq_factor - cfg.rope_scaling_low_freq_factor
    )
    smoothed = (1 - smooth) * scaled + smooth * freqs
    out = np.where(wavelen < high_freq_wavelen, freqs,
                   np.where(wavelen > low_freq_wavelen, scaled, smoothed))
    return out.astype(np.float32)


def build_rope_cache(cfg: LlamaConfig, seq_len: int | None = None,
                     device="cpu") -> torch.Tensor:
    """Precomputed [seq_len, head_size/2, 2] (cos, sin) table, f32, for the
    interleaved-pair layout the `.m` format stores Q/K in. Computed in numpy
    so both packages build the same table."""
    seq_len = seq_len or cfg.seq_len
    half = cfg.head_size // 2
    freqs = 1.0 / (cfg.rope_theta ** (np.arange(half, dtype=np.float64) * 2.0 / cfg.head_size))
    freqs = freqs.astype(np.float32)
    if cfg.rope_type == RopeType.LLAMA3_1 and cfg.rope_scaling_factor != 1.0:
        freqs = llama31_scale_freqs(freqs, cfg)
    t = np.arange(seq_len, dtype=np.float32)
    angles = np.outer(t, freqs)  # [S, half]
    cache = np.stack([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32)
    return torch.from_numpy(cache).to(device)


def apply_rope(x: torch.Tensor, rope: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs x[..., 2i], x[..., 2i+1] by angle pos*freq_i.

    x: [B, T, H, head_size]; rope: [T, head_size/2, 2] rows for the T
    tokens' absolute positions, or [B, T, head_size/2, 2] per sequence."""
    b, t, h, hs = x.shape
    xf = x.to(torch.float32).reshape(b, t, h, hs // 2, 2)
    if rope.dim() == 4:
        cos = rope[:, :, None, :, 0]
        sin = rope[:, :, None, :, 1]
    else:
        cos = rope[None, :, None, :, 0]
        sin = rope[None, :, None, :, 1]
    x0, x1 = xf[..., 0], xf[..., 1]
    r0 = x0 * cos - x1 * sin
    r1 = x0 * sin + x1 * cos
    return torch.stack([r0, r1], dim=-1).reshape(b, t, h, hs).to(x.dtype)


#: --moe choices (ops.layers.moe_ffn's schemes)
MOE_IMPLS = ("auto", "dispatch", "sort", "dense")


def _dense_w(w, dtype) -> torch.Tensor:
    """An expert stack [E, in, out] as a dense ``dtype`` tensor (a QTensor or
    Q8Tensor dequantized: exact f32 codes times scales, one cast)."""
    from dllama_tpu_torch.ops.quant import Q8Tensor, QTensor

    return w.dequantize(dtype) if isinstance(w, (QTensor, Q8Tensor)) else w.to(dtype)


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (batched over leading axes) as an f32 sum."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def moe_route(h: torch.Tensor, gate: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The router: f32 logits ``h @ gate``, the top k of them, a softmax over
    those k. -> (probs f32 [..., k], expert ids i64 [..., k])."""
    logits = _dot(h, gate)
    topv, topi = torch.topk(logits, k, dim=-1)
    return torch.softmax(topv, dim=-1), topi


def moe_capacity(n: int, k: int, e: int, capacity_factor: float) -> int:
    """dispatch's rows an expert: ceil(cf * k * n / e), at least 1 and at
    most n, rounded up to a multiple of 8 above 8."""
    c = min(n, max(1, math.ceil(capacity_factor * k * n / e)))
    if c > 8:
        c = min(n, -(-c // 8) * 8)
    return c


def moe_buffers(hf: torch.Tensor, topi: torch.Tensor, e: int, c: int):
    """Capacity buffers of fixed shape, with no scatter and no host read.

    Choice j = (token j // k, its (j % k)-th expert) arrives at expert
    ``assign[j]`` with rank = the choices before it routed there, in
    token-major order; ranks of c and above are dropped. Buffer row
    (e, r) holds the token of the r-th choice routed to e, found by a
    binary search of e's running count (the same rows JAX's stable sort
    groups), zero where e got fewer than r + 1.
    -> (expert i64 [N*k], rank i64 [N*k], keep bool [N*k], buf [E, c, D]);
    a dropped choice reads (0, 0) and carries keep False."""
    n, d = hf.shape
    k = topi.shape[-1]
    dev = hf.device
    assign = topi.reshape(-1)
    onehot = (assign[:, None] == torch.arange(e, device=dev)).to(torch.int64)  # [N*k, E]
    csum = torch.cumsum(onehot, dim=0)
    rank = ((csum - onehot) * onehot).sum(dim=-1)
    keep = rank < c
    count = csum[-1]  # [E]
    r = torch.arange(c, device=dev)
    idx = torch.searchsorted(csum.t().contiguous(), (r + 1).expand(e, c).contiguous())
    src = torch.clamp(idx, max=n * k - 1) // k  # [E, c] token rows
    buf = torch.where((r[None, :] < count[:, None])[..., None], hf[src],
                      torch.zeros((), dtype=hf.dtype, device=dev))
    return torch.where(keep, assign, 0), torch.where(keep, rank, 0), keep, buf


def expert_range(cfg: LlamaConfig) -> tuple[int, int]:
    """(first, count) of the experts whose stacks this rank holds: an ep
    rank's block (parallel/sharding.LocalLlamaConfig), every expert
    elsewhere."""
    return getattr(cfg, "expert_offset", 0), cfg.n_experts // getattr(cfg, "ep", 1)


def moe_ffn(
    cfg: LlamaConfig,
    h: torch.Tensor,  # [B, T, D] (already rms-normed)
    gate: torch.Tensor,  # router [D, E] f32
    w1, w2, w3,  # one layer's expert stacks: [E, D, F], [E, F, D], [E, D, F]
    impl: str = "auto",  # 'auto' | 'dispatch' | 'sort' | 'dense'
    capacity_factor: float = 2.0,
    mm=None,  # the engine's matmul (x, w, layer, out_dtype=); CUDA tensors only
    reduce=None,  # an ep rank's f32 sum over ep (parallel/collectives.AxisGroup.all_reduce)
) -> torch.Tensor:
    """Mixtral-style sparse MoE FFN: top-k router (softmax over the top-k
    logits), SwiGLU experts, probability-weighted combine.

    Three schemes, as in the JAX package:

    * ``sort``: the N*k (token, choice) rows grouped by expert (stable
      argsort), one product per expert segment; exact.
    * ``dispatch``: each expert takes a buffer of C = ~cf*k*N/E rows
      (moe_capacity); a choice past its expert's capacity contributes
      nothing.
    * ``dense``: every expert on every token, the unrouted ones weighted 0;
      exact.

    ``auto`` is ``sort`` for N = B*T >= E and ``dense`` below, on the CPU.
    On a CUDA device the schemes run as moe_ffn_static (fixed shapes, the
    engine's matmul kernels on each expert), where ``auto`` is ``dense``.
    On the CPU this is the JAX package's
    arithmetic: the weights dequantized to ``h.dtype``; sort's products f32;
    dispatch's and dense's products rounded to ``h.dtype``; the combines
    f32. The dispatch combine sums each token's k choices in order (JAX
    scatter-adds them).

    On an ep rank (``cfg.ep`` > 1, expert_range) the stacks hold the rank's
    experts only. The router still runs over all E; the rank computes its
    own experts' products (dense: on every row; dispatch: their segments,
    the capacity from the global E), sums its weighted outputs in f32, and
    ``reduce`` sums those partials over ep before the one cast to
    ``h.dtype``. ``sort`` takes whole stacks only: the engines resolve
    ``auto`` to ``dense`` on ep and refuse ``sort``, as JAX does
    (engine/kernel_select.resolve_moe_impl)."""
    if h.device.type == "cuda":
        if mm is None:
            from dllama_tpu_torch.ops.matmul import matmul as mm
        return moe_ffn_static(cfg, h, gate, w1, w2, w3, mm, impl, capacity_factor, reduce)
    e, k = cfg.n_experts, cfg.n_active_experts
    lo, ne = expert_range(cfg)
    b, t, d = h.shape
    n = b * t
    if impl == "auto":
        impl = "sort" if n >= e else "dense"
    if impl not in MOE_IMPLS:
        raise ValueError(f"moe impl must be one of {MOE_IMPLS}, got {impl!r}")
    hdt = h.dtype
    probs, topi = moe_route(h, gate, k)
    hf = h.reshape(n, d)
    w1d, w2d, w3d = (_dense_w(w, hdt) for w in (w1, w2, w3))
    act = cfg.hidden_act

    def finish(out: torch.Tensor) -> torch.Tensor:
        out = out if reduce is None else reduce(out)
        return out.reshape(b, t, d).to(hdt)

    if impl == "sort":
        assign = topi.reshape(-1)
        order = torch.argsort(assign, stable=True)  # segments stay token-ordered
        inv = torch.argsort(order)
        xs = hf[order // k]  # [N*k, D] rows grouped by expert
        ys, s = [], 0
        for ei, size in enumerate(torch.bincount(assign, minlength=e).tolist()):
            x = xs[s : s + size]
            s += size
            a = activation(_dot(x, w1d[ei]), act).to(hdt) * _dot(x, w3d[ei]).to(hdt)
            ys.append(_dot(a, w2d[ei]))
        y = torch.cat(ys)[inv].reshape(n, k, d)
        return finish(torch.sum(y * probs.reshape(n, k, 1), dim=1))

    if impl == "dispatch":
        c = moe_capacity(n, k, e, capacity_factor)
        ei, ri, keep, buf = moe_buffers(hf, topi, e, c)
        buf = buf[lo : lo + ne]
        g = _dot(buf, w1d).to(hdt)
        up = _dot(buf, w3d).to(hdt)
        a = activation(g.to(torch.float32), act).to(hdt)
        y = _dot(a * up, w2d).to(hdt)  # [E, C, D]
        wgt = probs.reshape(-1) * keep  # dropped choices contribute nothing
        if ne < e:  # only this rank's experts' choices
            wgt = wgt * ((ei >= lo) & (ei < lo + ne))
            ei = (ei - lo).clamp(0, ne - 1)
        y_tok = y[ei, ri].to(torch.float32)  # [N*k, D]
        return finish(torch.sum((y_tok * wgt[:, None]).reshape(n, k, d), dim=1))

    weights = _route_weights(probs, topi, e).reshape(n, e)[:, lo : lo + ne]
    g = torch.einsum("nd,edf->nef", hf.to(torch.float32), w1d.to(torch.float32)).to(hdt)
    up = torch.einsum("nd,edf->nef", hf.to(torch.float32), w3d.to(torch.float32)).to(hdt)
    a = activation(g.to(torch.float32), act).to(hdt)
    y = torch.einsum("nef,efd->ned", (a * up).to(torch.float32),
                     w2d.to(torch.float32)).to(hdt)
    return finish(torch.einsum("ned,ne->nd", y.to(torch.float32), weights))


def _route_weights(probs: torch.Tensor, topi: torch.Tensor, e: int) -> torch.Tensor:
    """[..., E] combine weights: each token's top-k probabilities at their
    experts, 0 elsewhere."""
    hit = topi[..., None] == torch.arange(e, device=topi.device)  # [..., k, E]
    return torch.sum(hit.to(probs.dtype) * probs[..., None], dim=-2)


def moe_ffn_static(cfg: LlamaConfig, h: torch.Tensor, gate: torch.Tensor, w1, w2, w3, mm,
                   impl: str = "dense", capacity_factor: float = 2.0,
                   reduce=None) -> torch.Tensor:
    """moe_ffn with every shape fixed by (B, T) alone, so a captured CUDA
    graph holds it: no host read of a group size anywhere. Each expert's
    three products go through ``mm(x, w, e, out_dtype=float32)`` on the
    expert's 2-D view of the stack (the Q40/Q80 kernels on the card; the
    plain versions for CPU tensors), activation and up rounded to
    ``h.dtype`` between them, as sort's are:

    * ``dense`` (and ``auto``): every expert over all N rows, 3*E products,
      then the combine weights;
    * ``dispatch``: moe_buffers at moe_capacity rows an expert, 3*E
      products of C rows, each token's k choices gathered back and summed
      in order (no scatter-add, so the sums repeat run to run);
    * ``sort``: dispatch at C = N, which drops nothing: exact, equal to
      sort up to the order of sums.

    On an ep rank only its E/ep experts run (3*E/ep products; expert_range)
    and ``reduce`` sums the f32 partials over ep, as in moe_ffn.
    """
    e, k = cfg.n_experts, cfg.n_active_experts
    lo, ne = expert_range(cfg)
    b, t, d = h.shape
    n = b * t
    impl = "dense" if impl == "auto" else impl
    if impl not in MOE_IMPLS:
        raise ValueError(f"moe impl must be one of {MOE_IMPLS}, got {impl!r}")
    hdt, f32 = h.dtype, torch.float32
    probs, topi = moe_route(h, gate, k)
    hf = h.reshape(n, d).contiguous()

    def expert(x, j):
        g = mm(x, w1, j, out_dtype=f32)
        up = mm(x, w3, j, out_dtype=f32)
        return mm(activation(g, cfg.hidden_act).to(hdt) * up.to(hdt), w2, j, out_dtype=f32)

    def finish(out: torch.Tensor) -> torch.Tensor:
        out = out if reduce is None else reduce(out)
        return out.reshape(b, t, d).to(hdt)

    if impl == "dense":
        y = torch.stack([expert(hf, j) for j in range(ne)])  # [E, N, D]
        weights = _route_weights(probs, topi, e).reshape(n, e)[:, lo : lo + ne]
        return finish(torch.einsum("end,ne->nd", y, weights))
    c = n if impl == "sort" else moe_capacity(n, k, e, capacity_factor)
    ei, ri, keep, buf = moe_buffers(hf, topi, e, c)
    y = torch.stack([expert(buf[lo + j], j) for j in range(ne)])  # [E, C, D]
    wgt = probs.reshape(-1) * keep
    if ne < e:  # only this rank's experts' choices
        wgt = wgt * ((ei >= lo) & (ei < lo + ne))
        ei = (ei - lo).clamp(0, ne - 1)
    return finish(torch.sum((y[ei, ri] * wgt[:, None]).reshape(n, k, d), dim=1))


def gqa_attention(
    q: torch.Tensor,  # [B, T, Hq, hd]
    k_cache: torch.Tensor,  # [B, Hkv, S, hd]
    v_cache: torch.Tensor,  # [B, Hkv, S, hd]
    pos_base,  # int, or i32/i64 [B] per-sequence positions
) -> torch.Tensor:
    """Causal GQA over the full KV cache (nn-cpu-ops.cpp:752-787).

    Query t attends to cache slots s <= pos_base + t; unwritten slots past
    that are masked out. The plain version of the flash-attention kernel."""
    b, t, hq, hd = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qf = q.to(torch.float32).reshape(b, t, hkv, g, hd)
    kf = k_cache.to(torch.float32)
    vf = v_cache.to(torch.float32)
    scores = torch.einsum("bthgd,bhsd->bhgts", qf, kf) / math.sqrt(hd)
    spans = torch.arange(s, device=q.device)[None, :]
    qoff = torch.arange(t, device=q.device)[:, None]
    if isinstance(pos_base, torch.Tensor) and pos_base.dim() == 1:
        pos = pos_base.to(device=q.device, dtype=torch.int64)
        mask = spans[None] <= pos[:, None, None] + qoff[None]  # [B, t, s]
        mask = mask[:, None, None]
    else:
        mask = (spans <= int(pos_base) + qoff)[None, None, None]
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bhsd->bthgd", probs, vf)
    return out.reshape(b, t, hq, hd).to(q.dtype)


def paged_view(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Gather a [B, Hkv, max_blocks*page, hd] contiguous cache view from a
    [P, Hkv, page, hd] page pool through [B, max_blocks] block tables:
    logical row r of slot b reads pool[tables[b, r // page], :, r % page].
    Rows behind unallocated table entries surface stale page contents; the
    causal mask gives them probability exactly 0.0 (pool values are always
    finite), so a view-based attention is bit-exact against dense."""
    b, nb = tables.shape
    _, hkv, page, hd = pool.shape
    kv = pool[tables.long()]  # [B, nb, Hkv, page, hd]
    return kv.permute(0, 2, 1, 3, 4).reshape(b, hkv, nb * page, hd)


def paged_write_targets(tables: torch.Tensor, pos_base, t: int, page: int, n_pool: int,
                        active: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """(pages, offsets) i32 [B, T] for writing T new KV rows at block-table
    positions: the definition of paged write addressing. Logical row
    pos+tt of slot b lands in pool page tables[b, (pos+tt) // page] at offset
    (pos+tt) % page, the block index clipped to the table width, and rows of
    inactive slots go to the trash page (n_pool - 1, never allocated). Used
    by models.llama._paged_cache_update (the plain scatter); the paged
    kernel's fused scatter (csrc/paged_attention.cu write_target) computes
    the same targets on the card, and chip_smoke.py holds its pools bit-equal
    to the plain scatter's. Device tensors in, device tensors out: no host
    sync."""
    b, nb = tables.shape
    dev = tables.device
    if isinstance(pos_base, torch.Tensor):
        pos = pos_base.to(device=dev, dtype=torch.int64).reshape(-1).expand(b)
    else:
        pos = torch.full((b,), int(pos_base), dtype=torch.int64, device=dev)
    rows = pos[:, None] + torch.arange(t, device=dev)[None]  # [B, T]
    blk = torch.clamp(rows // page, 0, nb - 1)
    off = rows % page
    pages = torch.gather(tables.long(), 1, blk)
    if active is not None:
        pages = torch.where(active.to(dev)[:, None], pages, n_pool - 1)
    return pages.to(torch.int32), off.to(torch.int32)


def paged_gqa_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                        tables: torch.Tensor, pos_base) -> torch.Tensor:
    """Causal GQA over the paged KV cache: gather the block-table view, then
    the dense attention math unchanged. The plain version of the paged
    attention kernels; it re-materializes the whole view every call."""
    return gqa_attention(q, paged_view(k_pool, tables), paged_view(v_pool, tables), pos_base)
