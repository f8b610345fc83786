"""Convert a HuggingFace safetensors checkpoint to the `.m` format.

Analog of the reference converter (converter/convert-hf.py): reads
``config.json`` + ``*.safetensors`` shards lazily (one tensor materialized at
a time), applies the Q/K rope permutation, and streams tensors to disk in the
fixed `.m` plan order (llm.cpp:453-468).

The safetensors files are read directly, without the ``safetensors``
package: an 8-byte little-endian header length, a JSON header naming each
tensor's dtype, shape and byte range, then the raw little-endian data, which
is memory-mapped.

Usage:
    python -m dllama_tpu_torch.tools.convert_hf <model_dir> <weight_type> [--output out.m] [--max-seq-len N]
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys

import numpy as np

from dllama_tpu_torch.ops.quant import parse_float_type
from dllama_tpu_torch.tools.converter_core import (
    default_output_name,
    hf_config_to_llama,
    hf_tensor_for,
    write_model,
)

#: safetensors dtype -> numpy dtype of its little-endian bytes (BF16 is read
#: as its raw 16 bits and widened to f32 exactly)
SAFETENSORS_DTYPES = {"F32": "<f4", "F16": "<f2", "BF16": "<u2"}


class SafetensorsFile:
    """One ``.safetensors`` file: its header parsed, its data memory-mapped."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        self.path = path
        self.header = header
        # np.memmap cannot map an empty region (a file of empty tensors only)
        self._data = (np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
                      if os.path.getsize(path) > 8 + n else np.zeros(0, np.uint8))

    def keys(self) -> list[str]:
        return list(self.header)

    def get(self, name: str) -> np.ndarray:
        """The tensor as f32 numpy, in a fresh array. KeyError if absent."""
        entry = self.header[name]
        dtype = SAFETENSORS_DTYPES.get(entry["dtype"])
        if dtype is None:
            raise ValueError(f"{self.path}: tensor {name} has unsupported dtype {entry['dtype']}")
        begin, end = entry["data_offsets"]
        shape = tuple(entry["shape"])
        x = self._data[begin:end].view(dtype).reshape(shape)
        if entry["dtype"] == "BF16":
            return (np.array(x, dtype=np.uint32) << 16).view(np.float32)
        return np.array(x, dtype=np.float32)


class SafetensorsDir:
    """Lazy tensor accessor over a sharded safetensors checkpoint dir."""

    def __init__(self, model_dir: str):
        self.model_dir = model_dir
        index_path = os.path.join(model_dir, "model.safetensors.index.json")
        if os.path.exists(index_path):
            with open(index_path) as f:
                self.weight_map = json.load(f)["weight_map"]
        else:
            single = [fn for fn in sorted(os.listdir(model_dir)) if fn.endswith(".safetensors")]
            if not single:
                raise FileNotFoundError(f"no .safetensors files in {model_dir}")
            self.weight_map = {}
            for fn in single:
                for key in SafetensorsFile(os.path.join(model_dir, fn)).keys():
                    self.weight_map[key] = fn
        self._open_file: SafetensorsFile | None = None

    def __contains__(self, name: str) -> bool:
        return name in self.weight_map

    def get(self, name: str) -> np.ndarray:
        """Returns the tensor as float32 numpy. KeyError if absent."""
        fn = self.weight_map[name]  # KeyError propagates (tied-embedding probe)
        path = os.path.join(self.model_dir, fn)
        if self._open_file is None or self._open_file.path != path:
            self._open_file = SafetensorsFile(path)
        return self._open_file.get(name)

    def close(self) -> None:
        self._open_file = None


def convert_hf(model_dir: str, weight_type_name: str, output: str | None = None,
               max_seq_len: int | None = None) -> str:
    weight_type = parse_float_type(weight_type_name)
    with open(os.path.join(model_dir, "config.json")) as f:
        hf_config = json.load(f)
    cfg = hf_config_to_llama(hf_config, weight_type)
    if max_seq_len:
        cfg = cfg.clamp_seq_len(max_seq_len)
    if output is None:
        output = default_output_name(model_dir, weight_type_name)

    src = SafetensorsDir(model_dir)
    write_model(cfg, output, lambda name: hf_tensor_for(name, cfg, src.get))
    src.close()
    return output


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("model_dir", help="HF checkpoint dir (config.json + *.safetensors)")
    p.add_argument("weight_type", choices=["q40", "q80", "f16", "f32"], help="on-disk matmul weight type")
    p.add_argument("--output", default=None, help="output .m path")
    p.add_argument("--max-seq-len", type=int, default=None, help="clamp seq_len in the header")
    args = p.parse_args(argv)
    convert_hf(args.model_dir, args.weight_type, args.output, args.max_seq_len)
    return 0


if __name__ == "__main__":
    sys.exit(main())
