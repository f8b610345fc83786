"""Q40 matmul: the CUDA kernels' wrappers and their plain versions.

``q40_matmul(x, w, layer)`` computes ``x @ w[layer]`` for a Q40 weight in
the device layout of :class:`~dllama_tpu_torch.ops.quant.QTensor` and
returns ``x.dtype``. On a CUDA tensor it launches one of four kernels,
chosen by :func:`resolve_style` from the module knob ``STYLE`` and the
number of rows, with the JAX package's rule (``auto`` splits decode from
prefill at 16 rows as on the TPU; a forced decode style applies only to
decode-shaped calls):

* ``blockdot`` — ``csrc/q40_decode.cu`` (K1, the body ``csrc/decode.cuh``
  shared with K5): exact codes on the tensor cores, per-block partial dots
  scaled in f32, split-k summed in split order inside the one launch
  (replaces ``dllama_tpu/ops/pallas/q40_matmul.py:_blockdot_kernel``); its
  geometry is :func:`decode_geometry`, and ``BLOCKDOT_TK`` /
  ``BLOCKDOT_TN`` override its k rows per split and its columns per block
  (:func:`blockdot_tiles`);
* ``maskdot`` — ``csrc/q40_maskdot.cu`` (K3): blockdot's math on the
  tensor cores, ``mma.sync`` per 32-row block (replaces ``_maskdot_kernel``);
* ``loopdot`` — ``csrc/q40_loopdot.cu`` (K4): blockdot's math on the CUDA
  cores, one thread a column, blocks in ascending order (replaces
  ``_loopdot_kernel``);
* ``deq`` — ``csrc/q40_prefill.cu`` (K2): x and raw Q40 tiles through a
  TMA ring, dequantized to bf16 in shared memory, wgmma products with f32
  accumulation (replaces ``_deq_kernel``); every prefill chunk, and every
  row count under ``STYLE = "deq"``.

Unlike the TPU kernels no row padding is needed (the (8, 128) tiling was a
TPU constraint), and a stacked ``[L, k/2, n]`` weight is addressed by taking
the view ``packed[layer]`` — a free view of the contiguous stack, so the
TPU's scalar-prefetch layer indexing has no counterpart.

On a CPU tensor the wrapper runs the plain version of the kernel the style
picks: :func:`q40_maskdot_plain` (K3) and :func:`q40_loopdot_plain` (K4),
f32 sums of exact-code partials as those kernels form them, and otherwise
:func:`q40_matmul_plain`, the JAX XLA path's arithmetic (dequantize to f32,
cast to the activation dtype, f32 dot, cast back). A CUDA tensor never
reaches a plain version through the wrappers.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple

import torch

from dllama_tpu_torch.ops import build
from dllama_tpu_torch.ops.quant import Q_BLOCK, QTensor

#: widest row count the decode kernel takes (the TPU's blockdot split)
DECODE_MAX_M = 16
#: column tiles of the decode body (csrc/decode.cuh: 16 I columns a warp,
#: I = 8, 4, 2), widest first; a column's sum does not depend on its tile
DECODE_COLS = (128, 64, 32)
#: decode blocks (4 warps each) K1 keeps to on every SM: more splits would
#: shorten each warp's run of k
DECODE_BLOCKS_PER_SM = 2
#: fewest 32-row blocks of k one decode split walks (two slots of the ring)
DECODE_MIN_BLOCKS_PER_SPLIT = 8
#: most splits of a decode launch (csrc/decode.cuh kMaxSplits: the last block
#: of a column tile reads every split's partial at once)
DECODE_MAX_SPLITS = 8
#: the prefill kernel's tile (csrc/q40_prefill.cu BM, BM_SMALL, BN, BK):
#: output rows per block where m >= PREFILL_TILE_M (else
#: PREFILL_TILE_M_SMALL), output columns per block, input dims per step
PREFILL_TILE_M = 256
PREFILL_TILE_M_SMALL = 128
PREFILL_TILE_N = 128
PREFILL_STEP_K = 64
#: prefill-kernel blocks an SM holds (its __launch_bounds__)
PREFILL_BLOCKS_PER_SM = 1
#: fewest steps of k one prefill split walks
PREFILL_MIN_STEPS_PER_SPLIT = 8

#: kernel styles of q40_matmul (the JAX package's q40_matmul.STYLE values)
STYLES = ("auto", "deq", "blockdot", "maskdot", "loopdot")
#: kernel-style override for benchmarks (experiments/kbench.py sets it)
STYLE = "auto"
#: K1 tile overrides for autotuning (None = the defaults): k rows per split
#: and output columns per block; see blockdot_tiles for when they apply
BLOCKDOT_TK: int | None = None
BLOCKDOT_TN: int | None = None
#: columns per block that BLOCKDOT_TN may set (K1 is compiled for them: one,
#: two or four 128-column warps side by side)
DECODE_TILES_N = (128, 256, 512)
#: columns per block of K3 (csrc/q40_maskdot.cu: 4 warps of 32 columns)
MASKDOT_COLS = 128
#: K3's blocks (128 threads) to aim for on every SM, and the fewest 32-row
#: blocks of k one of its splits walks
MASKDOT_BLOCKS_PER_SM = 16
MASKDOT_MIN_BLOCKS_PER_SPLIT = 4

#: kernel launches made through the wrappers (plain ints; reset by callers
#: that want to see which kernels a run went through)
LAUNCHES = {"q40_decode": 0, "q40_prefill": 0, "q40_maskdot": 0, "q40_loopdot": 0}


def resolve_style(style: str, m: int) -> str:
    """The kernel style that serves ``m`` rows under ``style``: the JAX
    package's rule (dllama_tpu/ops/pallas/q40_matmul.py, q40_matmul), which
    pads m to a multiple of 8 first. ``auto`` is blockdot up to 16 rows and
    deq above; a forced decode style (blockdot/maskdot/loopdot) applies only
    up to 16 rows, and a larger m goes to deq; ``deq`` takes every m."""
    if style not in STYLES:
        raise ValueError(f"unknown Q40 kernel style {style!r} (one of {STYLES})")
    mp = m + (-m) % 8
    if style == "auto":
        return "blockdot" if mp <= DECODE_MAX_M else "deq"
    if style != "deq" and mp > DECODE_MAX_M:
        return "deq"
    return style


@contextlib.contextmanager
def forced_style(style: str, tk: int | None = None, tn: int | None = None):
    """``STYLE``, ``BLOCKDOT_TK`` and ``BLOCKDOT_TN`` set for the duration
    of the ``with`` block, and the caller's values restored after it."""
    global STYLE, BLOCKDOT_TK, BLOCKDOT_TN
    if style not in STYLES:
        raise ValueError(f"unknown Q40 kernel style {style!r} (one of {STYLES})")
    saved = STYLE, BLOCKDOT_TK, BLOCKDOT_TN
    STYLE, BLOCKDOT_TK, BLOCKDOT_TN = style, tk, tn
    try:
        yield
    finally:
        STYLE, BLOCKDOT_TK, BLOCKDOT_TN = saved


def blockdot_tiles(k: int, n: int, tk: int | None = None,
                   tn: int | None = None) -> tuple[int | None, int | None]:
    """The K1 tile overrides that apply to a [k, n] weight (None = the
    default). ``tk`` (k rows per split) applies when it divides k and is a
    multiple of 32, as in the JAX package; ``tn`` (columns per block) when it
    divides n and K1 is compiled for it (DECODE_TILES_N)."""
    tk = tk if (tk and k % tk == 0 and tk % Q_BLOCK == 0) else None
    tn = tn if (tn and tn in DECODE_TILES_N and n % tn == 0) else None
    return tk, tn


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


def _exact_codes(w: QTensor, layer) -> tuple[torch.Tensor, torch.Tensor]:
    """(exact codes q - 8 as f32 [nb, 32, n], f32 scales [nb, n]) of one
    layer: the operands of blockdot's math."""
    packed, scales = _layer_view(w, layer)
    nb, n = scales.shape
    p = packed.reshape(nb, Q_BLOCK // 2, n)
    codes = torch.cat([(p & 0x0F).to(torch.int8) - 8, (p >> 4).to(torch.int8) - 8], dim=1)
    return codes.to(torch.float32), scales.to(torch.float32)


def q40_maskdot_plain(x: torch.Tensor, w: QTensor, layer=None, out_dtype=None) -> torch.Tensor:
    """Plain version of K3 (the maskdot style): every block's partial dot
    ``y_b = x_b @ codes_b`` of exact codes in f32 at once, then
    ``sum_b s_b * y_b``; cast to ``out_dtype`` (default ``x.dtype``)."""
    codes, scales = _exact_codes(w, layer)
    *lead, k = x.shape
    xb = x.reshape(-1, k // Q_BLOCK, Q_BLOCK).to(torch.float32).transpose(0, 1)  # [nb, m, 32]
    y = torch.bmm(xb, codes)  # [nb, m, n]
    out = (y * scales[:, None, :]).sum(dim=0)
    return out.reshape(*lead, -1).to(out_dtype or x.dtype)


def q40_loopdot_plain(x: torch.Tensor, w: QTensor, layer=None, out_dtype=None) -> torch.Tensor:
    """Plain version of K4 (the loopdot style): the blocks of k in ascending
    order, each a plain ``[m, 32] x [32, n]`` dot of exact codes in f32 whose
    result, times the block's f32 scale, is added to the sum."""
    codes, scales = _exact_codes(w, layer)
    *lead, k = x.shape
    x2 = x.reshape(-1, k).to(torch.float32)
    acc = torch.zeros((x2.shape[0], codes.shape[-1]), dtype=torch.float32, device=x.device)
    for b in range(codes.shape[0]):
        acc = acc + (x2[:, b * Q_BLOCK : (b + 1) * Q_BLOCK] @ codes[b]) * scales[b]
    return acc.reshape(*lead, -1).to(out_dtype or x.dtype)


#: the plain version of each forced decode style's own kernel (K3, K4); the
#: other styles' kernels are held against q40_matmul_plain
STYLE_PLAIN = {"maskdot": q40_maskdot_plain, "loopdot": q40_loopdot_plain}


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def maskdot_splits(k: int, n: int, sms: int) -> tuple[int, int]:
    """(splits, 32-row blocks per split) of K3's split-k, MASKDOT_COLS columns
    a block: about MASKDOT_BLOCKS_PER_SM blocks on every SM — enough loads
    in flight to cover the memory latency — each split a whole number of
    32-row blocks, at least MASKDOT_MIN_BLOCKS_PER_SPLIT of them (its
    fixed-order second pass reads every split's partial row)."""
    nkb = k // Q_BLOCK
    col_blocks = -(-n // MASKDOT_COLS)
    splits = min(max(1, nkb // MASKDOT_MIN_BLOCKS_PER_SPLIT),
                 max(1, math.ceil(MASKDOT_BLOCKS_PER_SM * sms / col_blocks)))
    per = -(-nkb // splits)
    return -(-nkb // per), per


class DecodeGeometry(NamedTuple):
    """A launch of the decode body (K1, K5): grid (ceil(n / cols), splits),
    each split walking kb_per_split 32-row blocks of k. No thread-block
    cluster: the splits meet through counters in one launch."""

    splits: int
    kb_per_split: int
    cols: int


def decode_cols(n: int, splits: int, sms: int) -> int:
    """The widest column tile of DECODE_COLS whose blocks, at `splits` splits,
    give every SM one (else the narrowest)."""
    return next((c for c in DECODE_COLS if -(-n // c) * splits >= sms), DECODE_COLS[-1])


@functools.lru_cache(maxsize=None)
def decode_geometry(k: int, n: int, sms: int, tk: int | None = None,
                    tn: int | None = None) -> DecodeGeometry:
    """K1's launch for a [k, n] weight, whatever m is: the widest column tile
    that fills the card at the most splits allowed (DECODE_MAX_SPLITS, each of
    at least DECODE_MIN_BLOCKS_PER_SPLIT blocks of k), then the most splits
    that keep to DECODE_BLOCKS_PER_SM blocks an SM (one split where the
    column tiles alone pass that), so that wide weights walk long runs of k
    and narrow ones (wk/wv) still reach every SM. BLOCKDOT_TK (`tk`, a
    divisor of k) fixes the k rows per split, raised to k / DECODE_MAX_SPLITS
    where it would make more splits than that; BLOCKDOT_TN (`tn`) fixes the
    columns per block."""
    nkb = k // Q_BLOCK
    most = min(DECODE_MAX_SPLITS, max(1, nkb // DECODE_MIN_BLOCKS_PER_SPLIT))
    cols = tn or decode_cols(n, most, sms)
    if tk:
        per = max(tk // Q_BLOCK, -(-nkb // DECODE_MAX_SPLITS))
    else:
        per = -(-nkb // max(1, min(most, DECODE_BLOCKS_PER_SM * sms // -(-n // cols))))
    return DecodeGeometry(-(-nkb // per), per, cols)


#: the decode body's split-k scratch on each (device, stream): f32 partials
#: and the column tiles' arrival counters (0 between launches: the last block
#: of a tile sets its counter back)
_DECODE_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def decode_launch(name: str, x2: torch.Tensor, weight: torch.Tensor, scales: torch.Tensor,
                  out: torch.Tensor, geo: DecodeGeometry) -> None:
    """Launch the decode body `name` (q40_decode, q80_decode) on x2 [m, k]."""
    m, k = x2.shape
    n = weight.shape[1]
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    partial = counters = None
    if geo.splits > 1:
        key = (x2.device.index or 0, stream)
        part, count = _DECODE_SCRATCH.get(key, (None, None))
        if part is None or part.numel() < geo.splits * m * n:
            part = torch.empty(geo.splits * m * n, dtype=torch.float32, device=x2.device)
        if count is None or count.numel() < -(-n // geo.cols):
            count = torch.zeros(-(-n // geo.cols), dtype=torch.int32, device=x2.device)
        _DECODE_SCRATCH[key] = part, count
        partial, counters = part.data_ptr(), count.data_ptr()
    err = getattr(build.library(name), name)(
        x2.data_ptr(), weight.data_ptr(), scales.data_ptr(), partial, counters, out.data_ptr(),
        m, k, n, geo.splits, geo.kb_per_split, int(out.dtype == torch.float32), geo.cols, stream)
    build.check(name, err)


def prefill_tile_m(m: int) -> int:
    """Output rows per block of the prefill kernel for an m-row call."""
    return PREFILL_TILE_M if m >= PREFILL_TILE_M else PREFILL_TILE_M_SMALL


def prefill_splits(m: int, k: int, n: int, sms: int) -> tuple[int, int]:
    """(splits, PREFILL_STEP_K-row steps per split) of the prefill kernel's
    split-k: only where its output tiles alone would leave more than half the
    card idle, then as many splits as one wave of blocks holds, never below
    PREFILL_MIN_STEPS_PER_SPLIT steps a split."""
    tiles = -(-m // prefill_tile_m(m)) * -(-n // PREFILL_TILE_N)
    steps = -(-k // PREFILL_STEP_K)
    slots = PREFILL_BLOCKS_PER_SM * sms
    if 2 * tiles > slots:
        return 1, steps
    splits = min(max(1, steps // PREFILL_MIN_STEPS_PER_SPLIT), slots // tiles)
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


def _split_k_launch(name: str, x2, packed, scales, out, out_f32: int, splits: int, per: int,
                    *extra) -> None:
    """Launch a split-k kernel with a second pass (K2, K3) and its f32
    partials."""
    m, k = x2.shape
    n = packed.shape[1]
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=x2.device)
               if splits > 1 else None)
    err = getattr(build.library(name), name)(
        x2.data_ptr(), packed.data_ptr(), scales.data_ptr(),
        partial.data_ptr() if partial is not None else None, out.data_ptr(),
        m, k, n, splits, per, out_f32, *extra, torch.cuda.current_stream(x2.device).cuda_stream)
    build.check(name, err)
    LAUNCHES[name] += 1


def q40_matmul(x: torch.Tensor, w: QTensor, layer=None, out_dtype=None) -> torch.Tensor:
    """``x[..., k] @ w[layer]`` -> ``[..., n]`` in ``out_dtype`` (default
    ``x.dtype``; the kernels also write f32, the sum before its rounding),
    through the kernel that ``resolve_style(STYLE, m)`` picks."""
    packed, scales = _layer_view(w, layer)
    *lead, k = x.shape
    n = packed.shape[1]
    if k % Q_BLOCK or packed.shape[0] * 2 != k or tuple(scales.shape) != (k // Q_BLOCK, n):
        raise ValueError(f"q40_matmul: x [..., {k}] against packed "
                         f"{tuple(packed.shape)} / scales {tuple(scales.shape)}")
    out_dtype = out_dtype or x.dtype
    m = math.prod(lead)
    style = resolve_style(STYLE, m)
    if x.device.type == "cpu":
        return STYLE_PLAIN.get(style, q40_matmul_plain)(x, w, layer, out_dtype)
    _check_cuda(x, packed, scales)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q40_matmul: out_dtype {out_dtype} (bf16 or f32)")
    x2 = x.reshape(-1, k)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    out_f32 = int(out_dtype == torch.float32)
    if m == 0:
        return out.reshape(*lead, n)
    sms = _sm_count(x.device.index or 0)
    if style == "blockdot":
        geo = decode_geometry(k, n, sms, *blockdot_tiles(k, n, BLOCKDOT_TK, BLOCKDOT_TN))
        decode_launch("q40_decode", x2, packed, scales, out, geo)
        LAUNCHES["q40_decode"] += 1
    elif style == "maskdot":
        splits, per = maskdot_splits(k, n, sms)
        _split_k_launch("q40_maskdot", x2, packed, scales, out, out_f32, splits, per)
    elif style == "loopdot":
        err = build.library("q40_loopdot").q40_loopdot(
            x2.data_ptr(), packed.data_ptr(), scales.data_ptr(), out.data_ptr(), m, k, n,
            out_f32, torch.cuda.current_stream(x.device).cuda_stream)
        build.check("q40_loopdot", err)
        LAUNCHES["q40_loopdot"] += 1
    else:
        splits, per = prefill_splits(m, k, n, sms)
        _split_k_launch("q40_prefill", x2, packed, scales, out, out_f32, splits, per)
    return out.reshape(*lead, n)
