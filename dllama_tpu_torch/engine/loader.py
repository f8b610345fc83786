"""High-level model loading: file -> device params -> ready InferenceEngine
(the reference's runInferenceApp bootstrap, app.cpp:197-260: header ->
tokenizer -> weights -> engine), on one device or on a mesh of any of the
five axes.

On a mesh (``mesh="tp=2"``, ``"dp=2,tp=2"``, ``"sp=2"``, ``"tp=2,pp=2"``,
``"ep=2"``, or ``"auto"`` on a machine with several cards) every rank loads
shard-direct: each Q40 matmul weight decodes only the rank's byte ranges
off the memmap (models/formats.LazyQ40 through the ``put`` hook; a pp
stage only its layers, an ep rank only its experts), and Q80 weights load
dense bf16, as the JAX package's do on a mesh. The local ranks are
spawned here (parallel/multihost.launch) and the returned engine is rank
0's, which drives the world.
"""

from __future__ import annotations

import dataclasses
import logging

import torch

from dllama_tpu_torch.engine.engine import InferenceEngine, check_pipeline
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.models.formats import ModelFileError, load_params, read_header
from dllama_tpu_torch.parallel import multihost
from dllama_tpu_torch.parallel.mesh import MeshConfig, MeshTooLarge, auto_mesh_config
from dllama_tpu_torch.parallel.sharding import LlamaShardings
from dllama_tpu_torch.tokenizer.tokenizer import Tokenizer

log = logging.getLogger("dllama_tpu_torch")


@dataclasses.dataclass
class LoadedModel:
    config: LlamaConfig
    engine: InferenceEngine
    tokenizer: Tokenizer | None
    shardings: LlamaShardings | None = None
    sync: str = "bf16"  # tp exchange mode, forwarded to the serving tier
    world: multihost.World | None = None  # the mesh's process world (rank 0 drives)


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


def resolve_mesh(mesh_spec: str | None, cfg: LlamaConfig, device,
                 devices: list | None = None) -> MeshConfig | None:
    """The mesh to run, or None for one device: ``mesh_spec`` 'tp=2'-style,
    'auto' or None. The devices are the cards this process sees (one for
    the CPU) times the processes of a ``--distributed`` world. ``auto``
    factors them as the JAX package's auto_mesh_config does: tp capped by
    the kv heads, the rest on dp. A mesh larger than the cards raises
    :class:`MeshTooLarge`, as JAX's make_mesh refuses one larger than its
    devices; on the CPU each rank is a process of its own. ``auto`` never
    hands out pp or ep, as JAX's auto_mesh_config does not.
    ``devices`` (a harness's one device a local rank, ranks may share a
    card) replaces the count of cards."""
    if mesh_spec is None:
        return None
    device = torch.device(device)
    multi = multihost.distributed()
    local = (len(devices) if devices is not None
             else torch.cuda.device_count() if device.type == "cuda" else 1)
    n_dev = local * (multi["processes"] if multi else 1)
    if mesh_spec == "auto":
        if n_dev == 1:
            return None
        config = auto_mesh_config(n_dev, cfg.n_kv_heads)
    else:
        config = MeshConfig.parse(mesh_spec)
        if device.type == "cuda" and config.n_devices > n_dev:
            raise MeshTooLarge(f"the mesh needs {config.n_devices} devices, have {n_dev} "
                               "(one card a rank)")
    return None if config.n_devices == 1 else config


def build_shardings(cfg: LlamaConfig, mesh) -> LlamaShardings | None:
    """The placement rules of one rank (``mesh``: parallel/mesh.Mesh), or
    None without a mesh (the JAX package's build_shardings, per rank)."""
    return None if mesh is None else LlamaShardings(mesh, cfg)


def rank_engine(mesh, device, model_path: str, max_seq_len=None, engine_kw=None,
                dequantize: bool = False) -> InferenceEngine:
    """One rank's engine (run on every rank by parallel/multihost.launch):
    the shard-direct load of its weights (a pp stage's layers only) and its
    InferenceEngine."""
    cfg, header_size = read_header(model_path, max_seq_len)
    sh = build_shardings(cfg, mesh)
    params = load_params(model_path, cfg, header_size, dtype=torch.bfloat16,
                         dequantize=dequantize, layer_range=sh.layer_range(),
                         put=lambda name, leaf: sh.put(name, leaf, device))
    return InferenceEngine(cfg, params, max_seq_len=max_seq_len, device=device,
                           shardings=sh, **(engine_kw or {}))


def load_model(
    model_path: str,
    tokenizer_path: str | None = None,
    *,
    max_seq_len: int | None = None,
    mesh: str | None = "auto",  # 'tp=2'-style, 'auto' (JAX's factoring), None (one device)
    batch: int = 1,
    cache_dtype=torch.bfloat16,
    dequantize: bool = False,  # Q40/Q80 matmul weights as dense bf16 (torch.matmul)
    max_prefill_chunk: int = 256,
    sync: str = "bf16",  # the tp exchange: 'bf16' | 'q80' | 'auto'
    kernels: str = "auto",
    moe_impl: str = "auto",  # MoE compute scheme (ops.layers.moe_ffn)
    pp_micro: int = 1,  # GPipe microbatches on a pp mesh (library callers with batch > 1;
    # the CLI drives batch 1 and has no flag for it, as in the JAX package)
    fuse_weights: bool = False,  # ignored on a mesh, as in the JAX package
    device="cuda",
    devices: list | None = None,  # mesh: one device a local rank (a harness's choice)
) -> LoadedModel:
    device = resolve_device(device)
    try:
        cfg, header_size = read_header(model_path, max_seq_len)
    except (ModelFileError, FileNotFoundError, IsADirectoryError):
        raise
    except (OSError, ValueError) as e:
        raise ModelFileError(f"{model_path}: unreadable .m model file: {e}") from e
    log.info("model: %s", cfg.describe())
    tokenizer = Tokenizer.load(tokenizer_path) if tokenizer_path else None
    if tokenizer is not None and tokenizer.regular_vocab_size > cfg.vocab_size:
        raise ValueError(
            f"tokenizer vocab ({len(tokenizer.vocab)}) exceeds model vocab ({cfg.vocab_size})")
    mesh_cfg = resolve_mesh(mesh, cfg, device, devices)
    if mesh_cfg is not None:
        LlamaShardings.check(mesh_cfg, cfg)
        check_pipeline(mesh_cfg, sync, batch, pp_micro)
        log.info("mesh: %s over %d devices", mesh_cfg, mesh_cfg.n_devices)
        engine_kw = dict(batch=batch, cache_dtype=cache_dtype,
                         max_prefill_chunk=max_prefill_chunk, kernels=kernels,
                         moe_impl=moe_impl, sync=sync, pp_micro=pp_micro)
        world = multihost.launch(
            "dllama_tpu_torch.engine.loader:rank_engine",
            dict(model_path=model_path, max_seq_len=max_seq_len, engine_kw=engine_kw,
                 dequantize=dequantize),
            mesh_cfg, device=device, devices=devices)
        eng = world.engine
        return LoadedModel(cfg, eng, tokenizer, eng.shardings, eng.sync, world)
    params = load_params(model_path, cfg, header_size, dtype=torch.bfloat16, device=device,
                         dequantize=dequantize)
    engine = InferenceEngine(
        cfg, params, batch=batch, cache_dtype=cache_dtype, max_seq_len=max_seq_len,
        max_prefill_chunk=max_prefill_chunk, kernels=kernels,
        fuse_weights=fuse_weights, device=device, moe_impl=moe_impl)
    return LoadedModel(cfg, engine, tokenizer)
