"""Q40 / Q80 block quantization: numpy file codecs and the device layout.

The numeric formats are the reference's (nn-quants.hpp:51-67,
converter/writer.py:29-74), bit for bit:

* **Q40**: 32-element blocks, one f16 scale per block, 4-bit codes with
  offset -8. The file stores row-major ``[out, in/32]`` blocks of ``{f16
  scale, 16 bytes}`` where byte ``j`` packs code ``j`` (low nibble) and code
  ``j+16`` (high nibble). On the device the transpose is kept —
  ``packed: u8[(L,) in/2, out]``, ``scales: f16[(L,) in/32, out]`` — so a
  product ``x @ W`` reads weight columns contiguously: neighbouring threads
  of a kernel walk neighbouring output columns.
* **Q80**: 32-element blocks, f16 scale, int8 codes (round to nearest).

Quantize math:
  Q40: delta = (signed value with max |.|) / -8 ; q = clip(floor(x/delta + 8.5), 0, 15)
  Q80: delta = absmax / 127              ; q = round(x/delta)
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum

import numpy as np
import torch

Q_BLOCK = 32  # block size shared by Q40 and Q80 (nn-quants.hpp:59-67)


class FloatType(IntEnum):
    """Wire/file float-type ids (nn-quants.hpp:51-57, writer.py:6-10)."""

    F32 = 0
    F16 = 1
    Q40 = 2
    Q80 = 3
    # dllama-tpu extension: bf16 on-device weights (not in reference format).
    BF16 = 100

    @property
    def bytes_per_block(self) -> int:
        return {
            FloatType.F32: 4 * Q_BLOCK,
            FloatType.F16: 2 * Q_BLOCK,
            FloatType.BF16: 2 * Q_BLOCK,
            FloatType.Q40: 2 + Q_BLOCK // 2,
            FloatType.Q80: 2 + Q_BLOCK,
        }[self]

    def nbytes(self, n_elements: int) -> int:
        assert n_elements % Q_BLOCK == 0 or self in (FloatType.F32, FloatType.F16)
        if self in (FloatType.F32, FloatType.BF16):
            return {FloatType.F32: 4, FloatType.BF16: 2}[self] * n_elements
        if self == FloatType.F16:
            return 2 * n_elements
        return (n_elements // Q_BLOCK) * self.bytes_per_block


def parse_float_type(name: str) -> FloatType:
    try:
        return FloatType[name.upper()]
    except KeyError:
        raise ValueError(f"unsupported float type: {name!r}") from None


# ---------------------------------------------------------------------------
# numpy side: file <-> array codecs (used by the .m writer, the reader and
# the converters)
# ---------------------------------------------------------------------------


def quantize_q40_np(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """f32[..., K] -> (packed u8[..., K/32, 16], scales f16[..., K/32]).

    Matches converter/writer.py:29-53 exactly (including the floor-after-+8.5
    rounding and the where(-min > max) tie-break)."""
    shape = x.shape
    assert shape[-1] % Q_BLOCK == 0, shape
    g = x.astype(np.float32).reshape(*shape[:-1], -1, Q_BLOCK)
    gmax = g.max(axis=-1)
    gmin = g.min(axis=-1)
    deltas = np.where(-gmin > gmax, gmin, gmax) / -8.0
    deltas16 = deltas.astype(np.float16)
    with np.errstate(divide="ignore"):
        inv = np.where(deltas != 0, 1.0 / deltas, 0.0)
    q = np.clip(g * inv[..., None] + 8.5, 0, 15).astype(np.uint8)
    packed = q[..., : Q_BLOCK // 2] | (q[..., Q_BLOCK // 2 :] << 4)
    return packed, deltas16


def dequantize_q40_np(packed: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """(packed u8[..., B, 16], scales f16[..., B]) -> f32[..., B*32]."""
    lo = (packed & 0x0F).astype(np.int8) - 8
    hi = (packed >> 4).astype(np.int8) - 8
    codes = np.concatenate([lo, hi], axis=-1).astype(np.float32)
    out = codes * scales[..., None].astype(np.float32)
    return out.reshape(*packed.shape[:-2], packed.shape[-2] * Q_BLOCK)


def quantize_q80_np(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """f32[..., K] -> (codes i8[..., K/32, 32], scales f16[..., K/32])."""
    shape = x.shape
    assert shape[-1] % Q_BLOCK == 0, shape
    g = x.astype(np.float32).reshape(*shape[:-1], -1, Q_BLOCK)
    absmax = np.abs(g).max(axis=-1)
    deltas = absmax / 127.0
    deltas16 = deltas.astype(np.float16)
    with np.errstate(divide="ignore"):
        inv = np.where(deltas != 0, 1.0 / deltas, 0.0)
    codes = np.round(g * inv[..., None]).astype(np.int8)
    return codes, deltas16


def dequantize_q80_np(codes: np.ndarray, scales: np.ndarray) -> np.ndarray:
    out = codes.astype(np.float32) * scales[..., None].astype(np.float32)
    return out.reshape(*codes.shape[:-2], codes.shape[-2] * Q_BLOCK)


def q40_to_bytes(packed: np.ndarray, scales: np.ndarray) -> bytes:
    """Serialize to the reference's on-disk block stream {f16 scale, 16 bytes}."""
    nb = packed.reshape(-1, Q_BLOCK // 2).shape[0]
    rec = np.zeros((nb, 2 + Q_BLOCK // 2), dtype=np.uint8)
    rec[:, :2] = scales.reshape(-1, 1).view(np.uint8).reshape(nb, 2)
    rec[:, 2:] = packed.reshape(nb, Q_BLOCK // 2)
    return rec.tobytes()


def q40_from_bytes(buf: bytes, n_elements: int) -> tuple[np.ndarray, np.ndarray]:
    nb = n_elements // Q_BLOCK
    rec = np.frombuffer(buf, dtype=np.uint8, count=nb * (2 + Q_BLOCK // 2)).reshape(
        nb, 2 + Q_BLOCK // 2
    )
    scales = rec[:, :2].copy().view(np.float16).reshape(nb)
    packed = rec[:, 2:].copy()
    return packed, scales


def q80_to_bytes(codes: np.ndarray, scales: np.ndarray) -> bytes:
    nb = codes.reshape(-1, Q_BLOCK).shape[0]
    rec = np.zeros((nb, 2 + Q_BLOCK), dtype=np.uint8)
    rec[:, :2] = scales.reshape(-1, 1).view(np.uint8).reshape(nb, 2)
    rec[:, 2:] = codes.reshape(nb, Q_BLOCK).view(np.uint8)
    return rec.tobytes()


def q80_from_bytes(buf: bytes, n_elements: int) -> tuple[np.ndarray, np.ndarray]:
    nb = n_elements // Q_BLOCK
    rec = np.frombuffer(buf, dtype=np.uint8, count=nb * (2 + Q_BLOCK)).reshape(
        nb, 2 + Q_BLOCK
    )
    scales = rec[:, :2].copy().view(np.float16).reshape(nb)
    codes = rec[:, 2:].copy().view(np.int8)
    return codes, scales


# ---------------------------------------------------------------------------
# device side: weights resident in device memory
# ---------------------------------------------------------------------------


def _as_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclasses.dataclass
class QTensor:
    """A Q40 weight for ``x @ W`` with ``W: [(L,) k_in, n_out]`` logical shape.

    ``packed: u8[(L,) k/2, n]`` — row ``16*b + j`` packs codes for input
    dims ``32*b + j`` (low nibble) and ``32*b + j + 16`` (high nibble).
    ``scales: f16[(L,) k/32, n]``. A leading layer axis stacks the layers;
    ``packed[li]`` of the contiguous stack is a view, never a copy."""

    packed: torch.Tensor
    scales: torch.Tensor

    @property
    def shape(self) -> tuple[int, ...]:
        """Logical [..., k, n] (leading axes = layer stacking)."""
        *lead, kh, n = self.packed.shape
        return (*lead, kh * 2, n)

    @classmethod
    def quantize(cls, w, device="cpu") -> "QTensor":
        """f32[k, n] -> QTensor on ``device`` (numpy quantization; used by
        tests and converters)."""
        w = np.asarray(w, dtype=np.float32)
        packed, scales = quantize_q40_np(np.ascontiguousarray(w.T))  # [n, k/32, 16]
        k = w.shape[0]
        packed = np.transpose(packed, (1, 2, 0)).reshape(k // 2, w.shape[1])
        scales = np.ascontiguousarray(np.transpose(scales, (1, 0)))  # f16
        return cls(_as_tensor(packed, device), _as_tensor(scales, device))

    @classmethod
    def from_file_layout(cls, packed, scales, n_out: int, k_in: int,
                         device="cpu") -> "QTensor":
        """Build from the `.m` on-disk layout (blocks row-major over
        [n_out, k_in]): ``packed`` u8[n_out*k_in/32, 16] and ``scales``
        f16[n_out*k_in/32], numpy arrays or tensors. The transpose to the
        device layout runs on ``device``."""
        packed = _as_tensor(packed, device).reshape(n_out, k_in // Q_BLOCK, Q_BLOCK // 2)
        scales = _as_tensor(scales, device).reshape(n_out, k_in // Q_BLOCK)
        packed = packed.permute(1, 2, 0).reshape(k_in // 2, n_out).contiguous()
        return cls(packed, scales.t().contiguous())

    @classmethod
    def from_records(cls, rec: torch.Tensor) -> "QTensor":
        """Build from the file's records u8 [..., n_out, k_in/32, 18] (f16
        scale, 16 bytes, leading axes stacked), on ``rec``'s device: the
        transpose of :meth:`from_file_layout` for a block of records."""
        *lead, n, nb, _ = rec.shape
        packed = rec[..., 2:].movedim(-3, -1).reshape(*lead, nb * (Q_BLOCK // 2), n)
        scales = rec[..., :2].contiguous().view(torch.float16)[..., 0]  # [..., n, nb]
        return cls(packed.contiguous(), scales.transpose(-1, -2).contiguous())

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Plain dequantization -> [..., k, n]: codes q-8 times the f32
        scale, then one cast to ``dtype``."""
        *lead, k, n = self.shape
        p = self.packed.reshape(*lead, k // Q_BLOCK, Q_BLOCK // 2, n)
        lo = (p & 0x0F).to(torch.int8) - 8
        hi = (p >> 4).to(torch.int8) - 8
        codes = torch.cat([lo, hi], dim=-2).to(torch.float32)
        w = codes * self.scales.reshape(*lead, k // Q_BLOCK, 1, n).to(torch.float32)
        return w.reshape(*lead, k, n).to(dtype)


@dataclasses.dataclass
class Q8Tensor:
    """A Q80 weight for ``x @ W``: ``codes: i8[(L,) k, n]``, ``scales:
    f16[(L,) k/32, n]`` — the same output-dim-last layout as :class:`QTensor`,
    so neighbouring threads of the Q80 kernels (ops/q80_matmul.py) read
    neighbouring output columns. ``codes[li]`` of the contiguous stack is a
    view, never a copy."""

    codes: torch.Tensor
    scales: torch.Tensor

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.codes.shape)

    @classmethod
    def from_file_layout(cls, codes, scales, n_out: int, k_in: int,
                         device="cpu") -> "Q8Tensor":
        codes = _as_tensor(codes, device).reshape(n_out, k_in)
        scales = _as_tensor(scales, device).reshape(n_out, k_in // Q_BLOCK)
        return cls(codes.t().contiguous(), scales.t().contiguous())

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        *lead, k, n = self.shape
        c = self.codes.to(torch.float32).reshape(*lead, k // Q_BLOCK, Q_BLOCK, n)
        w = c * self.scales.reshape(*lead, k // Q_BLOCK, 1, n).to(torch.float32)
        return w.reshape(*lead, k, n).to(dtype)


def slice_leaf(w, li):
    """One layer's slice of a stacked weight leaf (QTensor/Q8Tensor or
    dense): views of the contiguous stack, no copy."""
    if isinstance(w, QTensor):
        return QTensor(w.packed[li], w.scales[li])
    if isinstance(w, Q8Tensor):
        return Q8Tensor(w.codes[li], w.scales[li])
    return w[li]
