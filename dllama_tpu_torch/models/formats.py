"""`.m` model-file reader/writer.

File schema (llm.cpp:26-98, converter/writer.py:109-143): i32 magic
0xA00ABCD, i32 headerSize, (key,value) i32 pairs, then raw tensors in fixed
order (llm.cpp:453-468):

  embedding f32 [vocab, dim]
  per layer: q [dim,dim] k [kv_dim,dim] v [kv_dim,dim] wo [dim,dim]
             w1 [hidden,dim] w2 [dim,hidden] w3 [hidden,dim]   (weight_type)
             (an MoE model: moe_gate f32 [E,dim], then moe_w1 [E,hidden,dim]
             moe_w2 [E,dim,hidden] moe_w3 [E,hidden,dim] in their place)
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
import time
from typing import Callable, Iterator

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
    slice_leaf,
)
from dllama_tpu_torch.utils import native


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
    """Serialize a tensor in the reference byte format (writer.py:29-107).

    Q40 and Q80 quantization run in C++ when the native library is available
    (bit-identical to quantize_q40_np / quantize_q80_np; tests pin it)."""
    flat = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if float_type == FloatType.F32:
        buf = flat.tobytes()
    elif float_type == FloatType.F16:
        buf = flat.astype(np.float16).tobytes()
    elif float_type == FloatType.Q40:
        packed, scales = (native.quantize_q40 if native.available() else quantize_q40_np)(flat)
        rec = np.zeros((packed.shape[0], 2 + Q_BLOCK // 2), dtype=np.uint8)
        rec[:, :2] = scales.reshape(-1, 1).view(np.uint8)
        rec[:, 2:] = packed
        buf = rec.tobytes()
    elif float_type == FloatType.Q80:
        codes, scales = (native.quantize_q80 if native.available() else quantize_q80_np)(flat)
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


class LazyQ40:
    """A Q40 matmul weight still living as bytes on the `.m` memmap.

    Shards decode on demand in the device layout (packed u8[k/2, n], scales
    f16[k/32, n]), so a rank of a tensor-parallel mesh decodes only the byte
    ranges of its own shard (parallel/sharding.LlamaShardings.put) and a
    model bigger than one host's RAM never fully decodes anywhere: the
    reference's slice-then-ship (nn-network.cpp:775-869) with the mmap as
    the wire. Both device dims map to contiguous or strided ranges of the
    file's [n_out, k_in/32, 18-byte block] record array. The JAX package's
    ``LazyQ40``, in numpy alone; each shard is a contiguous array of its
    own. A mesh rank takes its shard's :meth:`records` (one copy of its
    byte ranges) and rearranges them into the device layout on its device
    (``QTensor.from_records``), as the unsharded load does; ``LAZY_DECODE``
    counts the bytes and seconds read."""

    def __init__(self, raw: np.ndarray, n_out: int, k_in: int):
        self.rec = raw.reshape(n_out, k_in // Q_BLOCK, 2 + Q_BLOCK // 2)
        self.n_out = n_out
        self.k_in = k_in

    @property
    def packed_shape(self) -> tuple[int, ...]:
        return (self.k_in // 2, self.n_out)

    @property
    def scales_shape(self) -> tuple[int, ...]:
        return (self.k_in // Q_BLOCK, self.n_out)

    @staticmethod
    def _aligned(sl: slice, total: int, unit: int) -> tuple[int, int]:
        start = sl.start or 0
        stop = total if sl.stop is None else sl.stop
        assert start % unit == 0 and stop % unit == 0, (sl, unit)
        return start // unit, stop // unit

    def records(self, k2_sl: slice, n_sl: slice, out: np.ndarray | None = None) -> np.ndarray:
        """The file's records of the shard [k2_sl, n_sl] (k2 in units of
        half-blocks), u8 [n, nb, 18] (f16 scale, 16 bytes), copied off the
        memmap into one contiguous array (``out`` when given): the only
        bytes of the tensor read."""
        t0 = time.perf_counter()
        b0, b1 = self._aligned(k2_sl, self.k_in // 2, Q_BLOCK // 2)
        n0, n1 = self._aligned(n_sl, self.n_out, 1)
        src = self.rec[n0:n1, b0:b1]
        if out is None:
            out = np.ascontiguousarray(src)
        else:
            np.copyto(out, src)
        LAZY_DECODE["bytes"] += int(out.nbytes)
        LAZY_DECODE["seconds"] += time.perf_counter() - t0
        return out

    def packed_shard(self, k2_sl: slice, n_sl: slice) -> np.ndarray:
        """Device-layout packed rows [k2_sl, n_sl] (k2 in units of half-blocks)."""
        sub = self.records(k2_sl, n_sl)[:, :, 2:]  # [n, nb, 16]
        return np.ascontiguousarray(np.transpose(sub, (1, 2, 0)).reshape(-1, sub.shape[0]))

    def scales_shard(self, kb_sl: slice, n_sl: slice) -> np.ndarray:
        k2_sl = slice(None if kb_sl.start is None else kb_sl.start * (Q_BLOCK // 2),
                      None if kb_sl.stop is None else kb_sl.stop * (Q_BLOCK // 2))
        sub = np.ascontiguousarray(self.records(k2_sl, n_sl)[:, :, :2])  # [n, nb, 2]
        return np.ascontiguousarray(sub.view(np.float16)[..., 0].T)  # f16 [nb, n]

    def eager(self) -> QTensor:
        full = slice(None)
        return QTensor(torch.from_numpy(self.packed_shard(full, full)),
                       torch.from_numpy(self.scales_shard(full, full)))


class LazyQ40Stack:
    """Stacked lazy Q40 leaves (layers, or an MoE layer's experts): one more
    leading axis on every shard request. Members may be stacks themselves
    ([L, E, ...] expert stacks)."""

    def __init__(self, members: list):
        self.members = members

    @property
    def packed_shape(self) -> tuple[int, ...]:
        return (len(self.members), *self.members[0].packed_shape)

    @property
    def scales_shape(self) -> tuple[int, ...]:
        return (len(self.members), *self.members[0].scales_shape)

    def records(self, l_sl: slice, *rest: slice, out: np.ndarray | None = None) -> np.ndarray:
        """The members' records stacked, each copied once into the stack."""
        members = self.members[l_sl]
        for i, m in enumerate(members):
            r = m.records(*rest, out=None if out is None else out[i])
            if out is None:
                out = np.empty((len(members), *r.shape), np.uint8)
                out[0] = r
        return out

    def packed_shard(self, l_sl: slice, *rest: slice) -> np.ndarray:
        return np.stack([m.packed_shard(*rest) for m in self.members[l_sl]])

    def scales_shard(self, l_sl: slice, *rest: slice) -> np.ndarray:
        return np.stack([m.scales_shard(*rest) for m in self.members[l_sl]])


#: lazy Q40 shards read in this process since the last load: the bytes
#: copied off the memmap and the seconds that took (a mesh rank's cost)
LAZY_DECODE = {"bytes": 0, "seconds": 0.0}


def _to_device(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """Copy a host array (possibly a memmap view) to `device` as its own
    storage, optionally cast there."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype, copy=True)


def _load_matmul(raw: np.ndarray, shape: tuple[int, int], ft: FloatType, dtype, device,
                 dequantize: bool = False):
    """File [out, in] -> device x@W operand: QTensor/Q8Tensor or dense [in, out].
    ``dequantize``: a Q40/Q80 weight as a dense ``dtype`` tensor instead
    (exact f32 codes times scales, one cast: the JAX package's
    ``decode_dense(...).T.astype(dtype)``, bit for bit)."""
    n_out, k_in = shape
    device = torch.device(device)
    if ft == FloatType.Q40:
        rec = _to_device(raw, device).view(n_out * k_in // Q_BLOCK, 2 + Q_BLOCK // 2)
        scales = rec[:, :2].contiguous().view(torch.float16)
        w = QTensor.from_file_layout(rec[:, 2:], scales, n_out, k_in, device)
        return w.dequantize(dtype) if dequantize else w
    if ft == FloatType.Q80:
        rec = _to_device(raw, device).view(n_out * k_in // Q_BLOCK, 2 + Q_BLOCK)
        scales = rec[:, :2].contiguous().view(torch.float16)
        w = Q8Tensor.from_file_layout(rec[:, 2:].view(torch.int8), scales, n_out, k_in, device)
        return w.dequantize(dtype) if dequantize else w
    return _to_device(decode_dense(raw, shape, ft).T, device, dtype)


def _load_expert_matmul(raw: np.ndarray, shape: tuple[int, int, int], ft: FloatType, dtype,
                        device, dequantize: bool = False) -> list:
    """File [E, out, in] blob -> the E experts' x@W operands [in, out], in
    expert order (each as _load_matmul makes it; the stack places them)."""
    e, n_out, k_in = shape
    per = ft.nbytes(n_out * k_in)
    return [_load_matmul(raw[i * per : (i + 1) * per], (n_out, k_in), ft, dtype, device,
                         dequantize) for i in range(e)]


def _empty_stack(leaf, lead: tuple[int, ...]):
    """An uninitialized stack of ``leaf``'s kind with leading axes ``lead``."""
    def like(t):
        return torch.empty((*lead, *t.shape), dtype=t.dtype, device=t.device)

    if isinstance(leaf, QTensor):
        return QTensor(like(leaf.packed), like(leaf.scales))
    if isinstance(leaf, Q8Tensor):
        return Q8Tensor(like(leaf.codes), like(leaf.scales))
    return like(leaf)


def _place(stack, index, leaf) -> None:
    """Copy ``leaf`` into ``stack[index]``."""
    if isinstance(leaf, QTensor):
        stack.packed[index].copy_(leaf.packed)
        stack.scales[index].copy_(leaf.scales)
    elif isinstance(leaf, Q8Tensor):
        stack.codes[index].copy_(leaf.codes)
        stack.scales[index].copy_(leaf.scales)
    else:
        stack[index].copy_(leaf)


def load_params(path: str, config: LlamaConfig, header_size: int,
                dtype=torch.bfloat16, device="cpu", dequantize: bool = False,
                put: Callable[[str, object], object] | None = None,
                layer_range: range | None = None) -> dict:
    """Load the full parameter tree onto `device`.

    Per-layer tensors are stacked on a leading layer axis ([L, ...]); a
    layer's weight is a view of the stack (``packed[li]``). Each stack is
    made once at its full size and filled layer by layer, so loading never
    holds a key's layers twice. An MoE layer's experts stack on a second
    axis ([L, E, in, out]; the packed bytes and scales unchanged) and its
    router ``moe_gate`` loads f32 as [dim, E]. The embedding takes `dtype`;
    norms stay f32. ``dequantize`` loads every Q40/Q80 matmul weight, wcls
    and the experts included, as a dense `dtype` tensor (the JAX package's
    ``load_params(dequantize=True)``). Q80 experts stay packed otherwise,
    where the JAX package loads them dense.

    ``put(name, leaf)`` (the JAX package's hook; a mesh passes
    parallel/sharding.LlamaShardings.put) receives each leaf on the host
    and returns what the rank keeps on its device: names are "embedding",
    "final_norm", "wcls" and "layers.<short>", a layer's leaf carries a
    leading layer axis of 1, and Q40 matmul weights arrive as lazy stacks
    (:class:`LazyQ40Stack`), so only the rank's own shard is ever decoded.
    Dense leaves arrive as CPU tensors in their load dtype; Q80 weights
    load dense (the JAX package's rule on a mesh). With ``put``,
    ``layer_range`` (a pp stage's layers, parallel/sharding.layer_range)
    loads only those layers, stacked from 0; the others are never read."""
    if put is not None:
        return _load_params_put(path, config, header_size, dtype, dequantize, put,
                                layer_range or range(config.n_layers))
    n_layers = config.n_layers
    layers: dict = {}
    params: dict = {}
    for name, shape, ft, raw in iter_tensors(path, config, header_size):
        if name == "embedding":
            params["embedding"] = _to_device(decode_dense(raw, shape, ft), device, dtype)
        elif name == "final_norm":
            params["final_norm"] = _to_device(decode_dense(raw, shape, ft), device)
        elif name == "wcls":
            params["wcls"] = _load_matmul(raw, shape, ft, dtype, device, dequantize)
        else:
            _, li, short = name.split(".")
            li = int(li)
            if short in ("rms_att", "rms_ffn"):
                leaves = [((li,), _to_device(decode_dense(raw, shape, ft), device))]
            elif short == "moe_gate":  # router stays f32; file [E, dim] -> [dim, E]
                leaves = [((li,), _to_device(decode_dense(raw, shape, ft).T, device))]
            elif short.startswith("moe_"):
                experts = _load_expert_matmul(raw, shape, ft, dtype, device, dequantize)
                leaves = [((li, e), leaf) for e, leaf in enumerate(experts)]
            else:
                leaves = [((li,), _load_matmul(raw, shape, ft, dtype, device, dequantize))]
            for index, leaf in leaves:
                if short not in layers:
                    lead = (n_layers, shape[0]) if len(index) == 2 else (n_layers,)
                    layers[short] = _empty_stack(leaf, lead)
                _place(layers[short], index, leaf)
    params["layers"] = layers
    return params


def _load_params_put(path: str, config: LlamaConfig, header_size: int, dtype,
                     dequantize: bool, put, mine: range) -> dict:
    """load_params through the `put` hook (see load_params)."""

    def host(a: np.ndarray, leaf_dtype=torch.float32) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(leaf_dtype)

    def matmul_leaf(raw, shape, ft):
        n_out, k_in = shape
        if ft == FloatType.Q40 and not dequantize:
            return LazyQ40(raw, n_out, k_in)
        return host(decode_dense(raw, shape, ft).T, dtype)

    def stacked(leaves: list):
        if isinstance(leaves[0], (LazyQ40, LazyQ40Stack)):
            return LazyQ40Stack(leaves)
        return torch.stack(leaves)

    layers: dict = {}
    params: dict = {}
    for name, shape, ft, raw in iter_tensors(path, config, header_size):
        if name == "embedding":
            params["embedding"] = put(name, host(decode_dense(raw, shape, ft), dtype))
        elif name == "final_norm":
            params["final_norm"] = put(name, host(decode_dense(raw, shape, ft)))
        elif name == "wcls":
            params["wcls"] = put(name, matmul_leaf(raw, shape, ft))
        else:
            _, li, short = name.split(".")
            if int(li) not in mine:
                continue
            if short in ("rms_att", "rms_ffn"):
                leaf = host(decode_dense(raw, shape, ft))
            elif short == "moe_gate":
                leaf = host(decode_dense(raw, shape, ft).T)
            elif short.startswith("moe_"):
                e, n_out, k_in = shape
                per = ft.nbytes(n_out * k_in)
                leaf = stacked([matmul_leaf(raw[i * per : (i + 1) * per], (n_out, k_in), ft)
                                for i in range(e)])
            else:
                leaf = matmul_leaf(raw, shape, ft)
            local = slice_leaf(put(f"layers.{short}", stacked([leaf])), 0)
            if short not in layers:
                layers[short] = _empty_stack(local, (len(mine),))
            _place(layers[short], int(li) - mine.start, local)
    params["layers"] = layers
    return params
