"""`.m` model-file reader/writer.

File schema (llm.cpp:26-98, converter/writer.py:109-143): i32 magic
0xA00ABCD, i32 headerSize, (key,value) i32 pairs, then raw tensors in fixed
order (llm.cpp:453-468):

  embedding f32 [vocab, dim]
  per layer: q [dim,dim] k [kv_dim,dim] v [kv_dim,dim] wo [dim,dim]
             w1 [hidden,dim] w2 [dim,hidden] w3 [hidden,dim]   (weight_type)
             rms_norm_0 f32 [dim], rms_norm_1 f32 [dim]
  final_rms_norm f32 [dim]
  wcls [vocab, dim]                                            (weight_type)

Matmul tensors are stored [out, in] row-major and load as transposed
``x @ W`` operands ([in, out]): Q40 becomes a :class:`QTensor`, Q80 a
:class:`Q8Tensor`, f32/f16 become dense tensors. Loading is eager and goes
straight to one device: the raw Q40/Q80 records are uploaded as they are and
rearranged into the device layout there.
"""

from __future__ import annotations

import struct
from typing import Iterator

import numpy as np
import torch

from dllama_tpu_torch.models.config import MODEL_MAGIC, LlamaConfig
from dllama_tpu_torch.ops.quant import (
    FloatType,
    Q_BLOCK,
    Q8Tensor,
    QTensor,
    dequantize_q40_np,
    dequantize_q80_np,
    quantize_q40_np,
    quantize_q80_np,
)


class ModelFileError(ValueError):
    """A .m file that cannot be what it claims: wrong magic, truncated
    header, or fewer/more tensor bytes than the header's config implies."""


def read_header(path: str, max_seq_len: int | None = None) -> tuple[LlamaConfig, int]:
    """Returns (config, header_size_bytes). Mirrors loadLlmHeader (llm.cpp:26-98)."""
    from dllama_tpu_torch.utils import faults

    faults.fire("loader.read")
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ModelFileError(
                f"{path}: not a .m model file — {len(head)} bytes on disk, "
                f"need at least the 8-byte magic+size header")
        magic, header_size = struct.unpack("<ii", head)
        if magic in (0xABCD00, 0xABCD01):
            raise ModelFileError(f"{path}: old model format is not supported")
        if magic != MODEL_MAGIC:
            raise ModelFileError(
                f"{path}: unsupported magic number {magic:#x} "
                f"(expected {MODEL_MAGIC:#x}) — not a .m model file, or corrupt")
        if header_size < 8 or (header_size - 8) % 8 != 0:
            raise ModelFileError(
                f"{path}: corrupt header: headerSize={header_size} "
                f"(want 8 + a multiple of 8 key/value bytes)")
        body = f.read(header_size - 8)
        if len(body) < header_size - 8:
            raise ModelFileError(
                f"{path}: truncated header: declares {header_size} bytes but "
                f"only {8 + len(body)} are on disk")
        kv = [struct.unpack_from("<ii", body, i * 8)
              for i in range((header_size - 8) // 8)]
    config = LlamaConfig.from_header_kv(kv)
    return config.clamp_seq_len(max_seq_len), header_size


def write_header(f, config: LlamaConfig) -> int:
    kv = config.to_header_kv()
    header = struct.pack("<ii", MODEL_MAGIC, 8 + len(kv) * 8)
    body = b"".join(struct.pack("<ii", k, v) for k, v in kv)
    f.write(header + body)
    return len(header) + len(body)


def tensor_plan(config: LlamaConfig) -> list[tuple[str, tuple[int, ...], FloatType]]:
    """(name, file_shape, float_type) in on-disk order (llm.cpp:453-468)."""
    wt = config.weight_type
    plan: list = [("embedding", (config.vocab_size, config.dim), FloatType.F32)]
    for layer in range(config.n_layers):
        plan += [
            (f"layers.{layer}.wq", (config.dim, config.dim), wt),
            (f"layers.{layer}.wk", (config.kv_dim, config.dim), wt),
            (f"layers.{layer}.wv", (config.kv_dim, config.dim), wt),
            (f"layers.{layer}.wo", (config.dim, config.dim), wt),
        ]
        if config.n_experts:
            plan += [
                (f"layers.{layer}.moe_gate", (config.n_experts, config.dim), FloatType.F32),
                (f"layers.{layer}.moe_w1",
                 (config.n_experts, config.hidden_dim, config.dim), wt),
                (f"layers.{layer}.moe_w2",
                 (config.n_experts, config.dim, config.hidden_dim), wt),
                (f"layers.{layer}.moe_w3",
                 (config.n_experts, config.hidden_dim, config.dim), wt),
            ]
        else:
            plan += [
                (f"layers.{layer}.w1", (config.hidden_dim, config.dim), wt),
                (f"layers.{layer}.w2", (config.dim, config.hidden_dim), wt),
                (f"layers.{layer}.w3", (config.hidden_dim, config.dim), wt),
            ]
        plan += [
            (f"layers.{layer}.rms_att", (config.dim,), FloatType.F32),
            (f"layers.{layer}.rms_ffn", (config.dim,), FloatType.F32),
        ]
    plan += [
        ("final_norm", (config.dim,), FloatType.F32),
        ("wcls", (config.vocab_size, config.dim), wt),
    ]
    return plan


def write_tensor(f, x: np.ndarray, float_type: FloatType) -> int:
    """Serialize a tensor in the reference byte format (writer.py:29-107)."""
    flat = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if float_type == FloatType.F32:
        buf = flat.tobytes()
    elif float_type == FloatType.F16:
        buf = flat.astype(np.float16).tobytes()
    elif float_type == FloatType.Q40:
        packed, scales = quantize_q40_np(flat)
        rec = np.zeros((packed.shape[0], 2 + Q_BLOCK // 2), dtype=np.uint8)
        rec[:, :2] = scales.reshape(-1, 1).view(np.uint8)
        rec[:, 2:] = packed
        buf = rec.tobytes()
    elif float_type == FloatType.Q80:
        codes, scales = quantize_q80_np(flat)
        rec = np.zeros((codes.shape[0], 2 + Q_BLOCK), dtype=np.uint8)
        rec[:, :2] = scales.reshape(-1, 1).view(np.uint8)
        rec[:, 2:] = codes.view(np.uint8)
        buf = rec.tobytes()
    else:
        raise ValueError(f"unsupported weight type: {float_type}")
    f.write(buf)
    return len(buf)


def save_model(path: str, config: LlamaConfig, tensors: dict[str, np.ndarray]) -> None:
    """Write a complete `.m` file; `tensors` maps plan names to file-shape arrays."""
    with open(path, "wb") as f:
        write_header(f, config)
        for name, shape, ft in tensor_plan(config):
            x = tensors[name]
            assert tuple(x.shape) == tuple(shape), (name, x.shape, shape)
            write_tensor(f, x, ft)


def iter_tensors(path: str, config: LlamaConfig,
                 header_size: int) -> Iterator[tuple[str, tuple, FloatType, np.ndarray]]:
    """Yield (name, file_shape, float_type, raw_bytes_view) per plan entry,
    over a copy-on-write memmap (no copy until a tensor is decoded). The
    whole plan is checked against the size on disk first."""
    data = np.memmap(path, dtype=np.uint8, mode="c")
    plan = tensor_plan(config)
    total = header_size + sum(ft.nbytes(int(np.prod(shape))) for _, shape, ft in plan)
    if data.shape[0] < total:
        offset = header_size
        for name, shape, ft in plan:
            nbytes = ft.nbytes(int(np.prod(shape)))
            if offset + nbytes > data.shape[0]:
                raise ModelFileError(
                    f"{path}: truncated .m file: {data.shape[0]:,} bytes on "
                    f"disk, {total:,} expected for this header's config; "
                    f"first incomplete tensor is {name!r} "
                    f"(needs bytes [{offset:,}, {offset + nbytes:,}))")
            offset += nbytes
    if data.shape[0] > total:
        raise ModelFileError(
            f"{path}: .m file has {data.shape[0]:,} bytes but this header's "
            f"config accounts for {total:,} — corrupt header or mismatched "
            f"weight type")
    offset = header_size
    for name, shape, ft in plan:
        nbytes = ft.nbytes(int(np.prod(shape)))
        yield name, shape, ft, data[offset : offset + nbytes]
        offset += nbytes


def decode_dense(raw: np.ndarray, shape: tuple, ft: FloatType) -> np.ndarray:
    """Decode raw bytes to an f32 array of `shape`."""
    if ft == FloatType.F32:
        return raw.view(np.float32).reshape(shape)
    if ft == FloatType.F16:
        return raw.view(np.float16).reshape(shape).astype(np.float32)
    if ft == FloatType.Q40:
        n = int(np.prod(shape))
        rec = raw.reshape(n // Q_BLOCK, 2 + Q_BLOCK // 2)
        scales = rec[:, :2].copy().view(np.float16).reshape(-1)
        return dequantize_q40_np(rec[:, 2:], scales).reshape(shape)
    if ft == FloatType.Q80:
        n = int(np.prod(shape))
        rec = raw.reshape(n // Q_BLOCK, 2 + Q_BLOCK)
        scales = rec[:, :2].copy().view(np.float16).reshape(-1)
        return dequantize_q80_np(rec[:, 2:].view(np.int8), scales).reshape(shape)
    raise ValueError(f"unsupported weight type: {ft}")


def _to_device(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """Copy a host array (possibly a memmap view) to `device` as its own
    storage, optionally cast there."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype, copy=True)


def _load_matmul(raw: np.ndarray, shape: tuple[int, int], ft: FloatType, dtype, device):
    """File [out, in] -> device x@W operand: QTensor/Q8Tensor or dense [in, out]."""
    n_out, k_in = shape
    device = torch.device(device)
    if ft == FloatType.Q40:
        rec = _to_device(raw, device).view(n_out * k_in // Q_BLOCK, 2 + Q_BLOCK // 2)
        scales = rec[:, :2].contiguous().view(torch.float16)
        return QTensor.from_file_layout(rec[:, 2:], scales, n_out, k_in, device)
    if ft == FloatType.Q80:
        rec = _to_device(raw, device).view(n_out * k_in // Q_BLOCK, 2 + Q_BLOCK)
        scales = rec[:, :2].contiguous().view(torch.float16)
        return Q8Tensor.from_file_layout(rec[:, 2:].view(torch.int8), scales, n_out, k_in,
                                         device)
    return _to_device(decode_dense(raw, shape, ft).T, device, dtype)


def load_params(path: str, config: LlamaConfig, header_size: int,
                dtype=torch.bfloat16, device="cpu") -> dict:
    """Load the full parameter tree onto `device`.

    Per-layer tensors are stacked on a leading layer axis ([L, ...]); a
    layer's weight is a view of the stack (``packed[li]``). The embedding
    takes `dtype`; norms stay f32."""
    if config.n_experts:
        raise NotImplementedError(
            "MoE checkpoints are not yet ported to the PyTorch/CUDA package")
    layer_acc: dict[str, list] = {}
    params: dict = {}
    for name, shape, ft, raw in iter_tensors(path, config, header_size):
        if name == "embedding":
            params["embedding"] = _to_device(decode_dense(raw, shape, ft), device, dtype)
        elif name == "final_norm":
            params["final_norm"] = _to_device(decode_dense(raw, shape, ft), device)
        elif name == "wcls":
            params["wcls"] = _load_matmul(raw, shape, ft, dtype, device)
        else:
            short = name.split(".")[2]
            if short in ("rms_att", "rms_ffn"):
                leaf = _to_device(decode_dense(raw, shape, ft), device)
            else:
                leaf = _load_matmul(raw, shape, ft, dtype, device)
            layer_acc.setdefault(short, []).append(leaf)

    layers = {}
    for short, leaves in layer_acc.items():
        first = leaves[0]
        if isinstance(first, QTensor):
            layers[short] = QTensor(torch.stack([q.packed for q in leaves]),
                                    torch.stack([q.scales for q in leaves]))
        elif isinstance(first, Q8Tensor):
            layers[short] = Q8Tensor(torch.stack([q.codes for q in leaves]),
                                     torch.stack([q.scales for q in leaves]))
        else:
            layers[short] = torch.stack(leaves)
        leaves.clear()
    params["layers"] = layers
    return params
