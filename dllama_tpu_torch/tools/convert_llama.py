"""Convert a Meta Llama checkpoint (``consolidated.*.pth``) to `.m`.

Analog of the reference converter (converter/convert-llama.py). Meta shards
are megatron-style slices of each tensor: wq/wk/wv/w1/w3/output concatenate on
the output dim (0), wo/w2 and tok_embeddings on the input dim (1), 1-D norm
weights are replicated. Meta's Q/K layout is already the interleaved-pair rope
layout the `.m` format uses, so no permutation is needed (unlike HF).

Usage:
    python -m dllama_tpu_torch.tools.convert_llama <model_dir> <weight_type> [--output out.m]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

from dllama_tpu_torch.models.config import ArchType, HiddenAct, LlamaConfig, RopeType
from dllama_tpu_torch.ops.quant import parse_float_type
from dllama_tpu_torch.tools.converter_core import default_output_name, write_model

# `.m` plan short name -> (Meta name template, shard concat axis or None)
META_NAME_MAP = {
    "embedding": ("tok_embeddings.weight", 1),
    "wq": ("layers.{l}.attention.wq.weight", 0),
    "wk": ("layers.{l}.attention.wk.weight", 0),
    "wv": ("layers.{l}.attention.wv.weight", 0),
    "wo": ("layers.{l}.attention.wo.weight", 1),
    "w1": ("layers.{l}.feed_forward.w1.weight", 0),
    "w2": ("layers.{l}.feed_forward.w2.weight", 1),
    "w3": ("layers.{l}.feed_forward.w3.weight", 0),
    "rms_att": ("layers.{l}.attention_norm.weight", None),
    "rms_ffn": ("layers.{l}.ffn_norm.weight", None),
    "final_norm": ("norm.weight", None),
    "wcls": ("output.weight", 0),
}


def derive_hidden_dim(params: dict, w1_shard_rows: int, n_shards: int) -> int:
    """Meta params.json has no hidden_dim; it's implied by the checkpoint."""
    return w1_shard_rows * n_shards


def meta_params_to_config(params: dict, hidden_dim: int, weight_type) -> LlamaConfig:
    if params.get("vocab_size", -1) < 1:
        raise ValueError("vocab_size is invalid, please update params.json")
    if params.get("max_seq_len") is None:
        raise ValueError("max_seq_len is required, please update params.json")
    kwargs = dict(
        arch=ArchType.LLAMA,
        hidden_act=HiddenAct.SILU,
        dim=params["dim"],
        hidden_dim=hidden_dim,
        n_layers=params["n_layers"],
        n_heads=params["n_heads"],
        n_kv_heads=params.get("n_kv_heads") or params["n_heads"],
        weight_type=weight_type,
        seq_len=params["max_seq_len"],
        vocab_size=params["vocab_size"],
        norm_epsilon=float(params.get("norm_eps", 1e-5)),
    )
    if params.get("rope_theta") is not None:
        kwargs["rope_theta"] = float(params["rope_theta"])
    scaling = params.get("rope_scaling") or (params.get("use_scaled_rope") and {})
    if isinstance(scaling, dict) and (scaling or params.get("use_scaled_rope")):
        kwargs.update(
            rope_type=RopeType.LLAMA3_1,
            rope_scaling_factor=float(scaling.get("factor", 8.0)),
            rope_scaling_low_freq_factor=float(scaling.get("low_freq_factor", 1.0)),
            rope_scaling_high_freq_factor=float(scaling.get("high_freq_factor", 4.0)),
            rope_scaling_orig_max_seq_len=int(
                scaling.get("original_max_position_embeddings", 8192)
            ),
        )
    return LlamaConfig(**kwargs)


class MetaCheckpoint:
    """Lazy accessor over consolidated.*.pth shards (mmap'd, no full load)."""

    def __init__(self, model_dir: str):
        import torch

        self._torch = torch
        self.shards = []
        for p in sorted(Path(model_dir).glob("consolidated.*.pth")):
            self.shards.append(torch.load(p, map_location="cpu", mmap=True, weights_only=True))
        if not self.shards:
            raise FileNotFoundError(f"no consolidated.*.pth in {model_dir}")

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def w1_shard_rows(self) -> int:
        return self.shards[0]["layers.0.feed_forward.w1.weight"].shape[0]

    def get(self, short: str, layer: int | None = None) -> np.ndarray:
        name_tmpl, axis = META_NAME_MAP[short]
        name = name_tmpl.format(l=layer)
        parts = [s[name] for s in self.shards]
        if len(parts) == 1 or parts[0].dim() == 1:
            t = parts[0]
        else:
            t = self._torch.cat(parts, dim=axis)
        return t.to(dtype=self._torch.float32).numpy()


def convert_llama(model_dir: str, weight_type_name: str, output: str | None = None) -> str:
    weight_type = parse_float_type(weight_type_name)
    with open(os.path.join(model_dir, "params.json")) as f:
        params = json.load(f)
    ckpt = MetaCheckpoint(model_dir)
    hidden_dim = derive_hidden_dim(params, ckpt.w1_shard_rows(), ckpt.n_shards)
    cfg = meta_params_to_config(params, hidden_dim, weight_type)
    if output is None:
        output = default_output_name(model_dir, weight_type_name)

    def get_tensor(name: str) -> np.ndarray:
        parts = name.split(".")
        layer = int(parts[1]) if len(parts) == 3 else None
        short = parts[-1] if len(parts) == 3 else name
        return ckpt.get(short, layer)

    return write_model(cfg, output, get_tensor)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("model_dir", help="Meta checkpoint dir (params.json + consolidated.*.pth)")
    p.add_argument("weight_type", choices=["q40", "q80", "f16", "f32"])
    p.add_argument("--output", default=None)
    args = p.parse_args(argv)
    convert_llama(args.model_dir, args.weight_type, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
