"""ctypes bindings for the port's native host library (``csrc/native.cpp``):
byte-level BPE encode and Q40/Q80 block quantization.

Loading order: ``$DLLAMA_NATIVE_LIB`` if set, else this package's own build
of ``csrc/native.cpp``. The build runs at first use with the host C++
compiler (``c++ -O3 -shared -fPIC``, no CUDA) into ``dllama_tpu_torch/build/``,
named by a hash of the source and the flags, as ``ops/build.py`` names the
CUDA libraries. ``DLLAMA_NATIVE=0`` disables all of it. Every caller keeps
its pure-Python/numpy path: ``available()`` gates each one, and
tests/test_torch_native.py holds the two paths (and the JAX package's
native library) to the same bytes and ids.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_tried = False


def library_path() -> Path:
    """Where this source and these flags build to."""
    h = hashlib.sha256()
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdllama_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built already; -> its path. Raises
    with the compiler's output if the compile fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (c++ or g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode:
        raise RuntimeError(f"{cxx} failed on {SOURCE.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("DLLAMA_NATIVE", "1") == "0":
        return None
    path = os.environ.get("DLLAMA_NATIVE_LIB")
    if not path:
        try:
            path = str(build())
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    _bind(lib)
    _lib = lib
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.dllama_quantize_q40.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, u8p, ctypes.POINTER(ctypes.c_uint16)]
    lib.dllama_quantize_q40.restype = None
    lib.dllama_quantize_q80.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_uint16)]
    lib.dllama_quantize_q80.restype = None
    lib.dllama_tok_create.argtypes = [
        u8p, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    lib.dllama_tok_create.restype = ctypes.c_void_p
    lib.dllama_tok_destroy.argtypes = [ctypes.c_void_p]
    lib.dllama_tok_destroy.restype = None
    lib.dllama_tok_encode.argtypes = [
        ctypes.c_void_p, u8p, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    lib.dllama_tok_encode.restype = ctypes.c_int32


def available() -> bool:
    return _load() is not None


def quantize_q40(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """f32[..., K] -> (packed u8[..., K/32, 16], scales f16[..., K/32]);
    same contract as ops.quant.quantize_q40_np."""
    lib = _load()
    assert lib is not None
    flat = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    nb = flat.size // 32
    packed = np.empty(nb * 16, dtype=np.uint8)
    scales = np.empty(nb, dtype=np.uint16)
    lib.dllama_quantize_q40(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), flat.size,
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        scales.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    shape = x.shape
    return (packed.reshape(*shape[:-1], shape[-1] // 32, 16),
            scales.view(np.float16).reshape(*shape[:-1], shape[-1] // 32))


def quantize_q80(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """f32[..., K] -> (codes i8[..., K/32, 32], scales f16[..., K/32]);
    same contract as ops.quant.quantize_q80_np."""
    lib = _load()
    assert lib is not None
    flat = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    nb = flat.size // 32
    codes = np.empty(flat.size, dtype=np.int8)
    scales = np.empty(nb, dtype=np.uint16)
    lib.dllama_quantize_q80(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), flat.size,
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        scales.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    shape = x.shape
    return (codes.reshape(*shape[:-1], shape[-1] // 32, 32),
            scales.view(np.float16).reshape(*shape[:-1], shape[-1] // 32))


class NativeBpe:
    """Persistent native tokenizer handle (built once per Tokenizer)."""

    def __init__(self, vocab: list[bytes], scores: list[float], special_ids: list[int]):
        lib = _load()
        assert lib is not None
        self._lib = lib
        blob = b"".join(vocab)
        offsets = np.zeros(len(vocab) + 1, dtype=np.int64)
        np.cumsum([len(v) for v in vocab], out=offsets[1:])
        self._blob = np.frombuffer(blob, dtype=np.uint8) if blob else np.zeros(1, np.uint8)
        self._offsets = offsets
        self._scores = np.asarray(scores, dtype=np.float32)
        self._specials = np.asarray(special_ids, dtype=np.int32)
        self._handle = lib.dllama_tok_create(
            self._blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self._scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(vocab),
            self._specials.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(special_ids))

    def encode(self, data: bytes, add_special_tokens: bool) -> list[int] | None:
        """None signals 'cannot tokenize' (the caller raises with its own message)."""
        out = np.empty(max(16, 2 * len(data) + 16), dtype=np.int32)
        n = self._lib.dllama_tok_encode(
            self._handle,
            np.frombuffer(data, dtype=np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            if data else ctypes.cast(0, ctypes.POINTER(ctypes.c_uint8)),
            len(data), int(add_special_tokens),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out.size)
        if n == -1:
            return None
        assert n >= 0, "native encode output buffer overflow"
        return out[:n].tolist()

    def __del__(self):
        try:
            self._lib.dllama_tok_destroy(self._handle)
        except Exception:
            pass
