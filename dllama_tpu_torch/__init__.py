"""dllama-tpu on PyTorch and CUDA: the single-sequence path on one NVIDIA GPU.

A second implementation of the `dllama_tpu` package's main path (`.m` file
-> Q40 weights packed on the device -> Llama forward -> single-engine
generation -> OpenAI-compatible HTTP server), written for PyTorch with
hand-written CUDA kernels for Hopper (sm_90a). It imports neither JAX nor
anything of `dllama_tpu`: what it needs of that package it keeps as its own
copy, with the same byte layouts, so the two can be held against each other
on the same inputs.

Layer map (each module mirrors its `dllama_tpu` counterpart):
  ops/        Q40 codecs + device layout, layers, the CUDA kernels' wrappers
  models/     `.m` header/config, file reader/writer, Llama forward
  engine/     sampler, kernel selection, InferenceEngine, loader
  tokenizer/  `.t` format, byte-level BPE, chat templates, EOS detection
  serve/      OpenAI-compatible HTTP API (single-engine tier)
  parallel/   tensor parallelism on torch.distributed: mesh, sharding rules,
              collectives, one process a rank driven by rank 0
  cli/        `inference` / `chat` / `serve` / `info` frontends
"""

__version__ = "0.1.0"
