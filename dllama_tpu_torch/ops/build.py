"""Build the CUDA kernels from this package's sources, at first use.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper (sm_90a) into
its own shared library with a plain C interface, loaded with ``ctypes``. The
libraries land in ``dllama_tpu_torch/build/``, named by a hash of their
source, the shared headers (``csrc/*.cuh``) and the flags, so a changed
source is rebuilt and an unchanged one is reused. :func:`build` starts one ``nvcc`` per missing library, all at once.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
#: C entry point of each library (named like its source) -> argument types.
#: Every pointer and the stream are c_void_p; every entry returns the CUDA
#: error state after its launches as an int (0 = success).
SIGNATURES = {
    "q40_decode": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "q40_prefill": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "q40_maskdot": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "q40_loopdot": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "q80_decode": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "q80_prefill": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "rms_norm": (_P, _P, _P, _I, _I, _LL, _F, _I, _I, _I, _P),
    "flash_attention": (_P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "paged_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "kbench_fma_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "kbench_bf16_gemm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "dllama_tpu_torch/ops/csrc at first use and need the CUDA "
                       "toolkit (put nvcc on PATH or set CUDA_HOME)")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # the shared helpers (common.cuh)
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=tuple(SIGNATURES), ptxas_info: bool = False) -> dict[str, str]:
    """Compile every library of `names` that is not built yet, one nvcc
    process each, all started together. Returns {name: compiler output}
    for the libraries compiled now (with ``ptxas_info`` the output lists
    each kernel's registers, shared memory and spills). Raises with the
    compiler's output if any compile fails."""
    extra = ("-Xptxas=-v",) if ptxas_info else ()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
            logs[name] = log
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_library_path(name)))
            fn = getattr(lib, name)
            fn.argtypes = list(SIGNATURES[name])
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}"
                           + (" (unsupported dtype/head size/tile)" if err < 0 else ""))
