"""High-level model loading: file -> device params -> ready InferenceEngine
(the reference's runInferenceApp bootstrap, app.cpp:197-260: header ->
tokenizer -> weights -> engine), on one device."""

from __future__ import annotations

import dataclasses
import logging

import torch

from dllama_tpu_torch.engine.engine import InferenceEngine
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.models.formats import ModelFileError, load_params, read_header
from dllama_tpu_torch.tokenizer.tokenizer import Tokenizer

log = logging.getLogger("dllama_tpu_torch")


@dataclasses.dataclass
class LoadedModel:
    config: LlamaConfig
    engine: InferenceEngine
    tokenizer: Tokenizer | None


def resolve_device(device) -> torch.device:
    """The device to run on, a CUDA one with its index (``cuda`` is the
    current card). A CUDA device that is not there is an error: nothing
    carries on on the CPU unless the CPU was asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device was found; pass --device cpu "
                           "(device='cpu') to run on the CPU")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def load_model(
    model_path: str,
    tokenizer_path: str | None = None,
    *,
    max_seq_len: int | None = None,
    batch: int = 1,
    cache_dtype=torch.bfloat16,
    dequantize: bool = False,  # Q40/Q80 matmul weights as dense bf16 (torch.matmul)
    max_prefill_chunk: int = 256,
    kernels: str = "auto",
    moe_impl: str = "auto",  # MoE compute scheme (ops.layers.moe_ffn)
    fuse_weights: bool = False,
    device="cuda",
) -> LoadedModel:
    device = resolve_device(device)
    try:
        cfg, header_size = read_header(model_path, max_seq_len)
    except (ModelFileError, FileNotFoundError, IsADirectoryError):
        raise
    except (OSError, ValueError) as e:
        raise ModelFileError(f"{model_path}: unreadable .m model file: {e}") from e
    log.info("model: %s", cfg.describe())
    params = load_params(model_path, cfg, header_size, dtype=torch.bfloat16, device=device,
                         dequantize=dequantize)
    tokenizer = Tokenizer.load(tokenizer_path) if tokenizer_path else None
    if tokenizer is not None and tokenizer.regular_vocab_size > cfg.vocab_size:
        raise ValueError(
            f"tokenizer vocab ({len(tokenizer.vocab)}) exceeds model vocab ({cfg.vocab_size})")
    engine = InferenceEngine(
        cfg, params, batch=batch, cache_dtype=cache_dtype, max_seq_len=max_seq_len,
        max_prefill_chunk=max_prefill_chunk, kernels=kernels,
        fuse_weights=fuse_weights, device=device, moe_impl=moe_impl)
    return LoadedModel(cfg, engine, tokenizer)
