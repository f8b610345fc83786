"""Model configuration — the `.m` header schema as a dataclass.

Key ids and semantics mirror the reference header kv-list (llm.hpp:8-28,
llm.cpp:26-98) for drop-in model-file compatibility: same magic, same keys,
same int-valued floats, same derived quantities (head_size, kv_dim), and the
same `--max-seq-len` clamping rule (llm.cpp:89-91).
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum

from dllama_tpu_torch.ops.quant import FloatType

MODEL_MAGIC = 0x0A00ABCD  # llm.cpp:46-48 (magic 0xA00ABCD)


class ArchType(IntEnum):
    LLAMA = 0xABCD00


class HiddenAct(IntEnum):
    GELU = 0
    SILU = 1


class RopeType(IntEnum):
    LLAMA = 0
    FALCON = 1  # present in the reference enum order (nn-core.hpp), unused
    LLAMA3_1 = 2


class HeaderKey(IntEnum):
    """llm.hpp:8-28."""

    VERSION = 0
    ARCH_TYPE = 1
    DIM = 2
    HIDDEN_DIM = 3
    N_LAYERS = 4
    N_HEADS = 5
    N_KV_HEADS = 6
    N_EXPERTS = 7
    N_ACTIVE_EXPERTS = 8
    VOCAB_SIZE = 9
    SEQ_LEN = 10
    HIDDEN_ACT = 11
    ROPE_THETA = 12
    WEIGHT_FLOAT_TYPE = 13
    ROPE_SCALING_FACTOR = 14
    ROPE_SCALING_LOW_FREQ_FACTOR = 15
    ROPE_SCALING_HIGH_FREQ_FACTORY = 16
    ROPE_SCALING_ORIG_MAX_SEQ_LEN = 17
    ROPE_TYPE = 18
    # dllama-tpu extension (not in the reference schema, which hardcodes
    # normEpsilon=1e-5, llm.cpp:33): written only when eps != 1e-5, value is
    # eps * 1e12 as an int. Reference binaries reject files carrying it.
    NORM_EPSILON_X1E12 = 100


@dataclasses.dataclass
class LlamaConfig:
    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    seq_len: int
    version: int = 0
    arch: ArchType = ArchType.LLAMA
    n_experts: int = 0
    n_active_experts: int = 0
    hidden_act: HiddenAct = HiddenAct.SILU
    rope_theta: float = 10000.0
    rope_type: RopeType = RopeType.LLAMA
    rope_scaling_factor: float = 1.0
    rope_scaling_low_freq_factor: float = 0.0
    rope_scaling_high_freq_factor: float = 0.0
    rope_scaling_orig_max_seq_len: int = 0
    norm_epsilon: float = 1e-5
    weight_type: FloatType = FloatType.Q40
    orig_seq_len: int = 0  # pre-clamp seq len from the file

    def __post_init__(self):
        if self.orig_seq_len == 0:
            self.orig_seq_len = self.seq_len

    @property
    def head_size(self) -> int:
        return self.dim // self.n_heads

    @property
    def kv_dim(self) -> int:
        return (self.dim * self.n_kv_heads) // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def describe(self) -> str:
        """One-line summary in the spirit of the reference's header dump
        (llm.cpp:100-123)."""
        return (
            f"{self.arch.name} dim={self.dim} hidden={self.hidden_dim} "
            f"layers={self.n_layers} heads={self.n_heads}/{self.n_kv_heads} "
            f"vocab={self.vocab_size} seq={self.seq_len} "
            f"act={self.hidden_act.name} rope={self.rope_type.name} "
            f"weights={self.weight_type.name}"
            + (f" experts={self.n_experts}/{self.n_active_experts}" if self.n_experts else "")
        )

    def clamp_seq_len(self, max_seq_len: int | None) -> "LlamaConfig":
        """The reference's --max-seq-len RAM clamp (llm.cpp:89-91)."""
        if max_seq_len and self.seq_len > max_seq_len:
            return dataclasses.replace(self, seq_len=max_seq_len, orig_seq_len=self.orig_seq_len)
        return self

    def to_header_kv(self) -> list[tuple[int, int]]:
        """Serialize to the `.m` kv pairs (float values stored as ints, as the
        reference converter does — writer.py:109-143)."""
        kv = [
            (HeaderKey.VERSION, self.version),
            (HeaderKey.ARCH_TYPE, int(self.arch)),
            (HeaderKey.DIM, self.dim),
            (HeaderKey.HIDDEN_DIM, self.hidden_dim),
            (HeaderKey.N_LAYERS, self.n_layers),
            (HeaderKey.N_HEADS, self.n_heads),
            (HeaderKey.N_KV_HEADS, self.n_kv_heads),
            (HeaderKey.N_EXPERTS, self.n_experts),
            (HeaderKey.N_ACTIVE_EXPERTS, self.n_active_experts),
            (HeaderKey.VOCAB_SIZE, self.vocab_size),
            (HeaderKey.SEQ_LEN, self.orig_seq_len),
            (HeaderKey.HIDDEN_ACT, int(self.hidden_act)),
            (HeaderKey.ROPE_THETA, int(self.rope_theta)),
            (HeaderKey.WEIGHT_FLOAT_TYPE, int(self.weight_type)),
        ]
        if self.rope_type == RopeType.LLAMA3_1:
            kv += [
                (HeaderKey.ROPE_SCALING_FACTOR, int(self.rope_scaling_factor)),
                (HeaderKey.ROPE_SCALING_LOW_FREQ_FACTOR, int(self.rope_scaling_low_freq_factor)),
                (HeaderKey.ROPE_SCALING_HIGH_FREQ_FACTORY, int(self.rope_scaling_high_freq_factor)),
                (HeaderKey.ROPE_SCALING_ORIG_MAX_SEQ_LEN, self.rope_scaling_orig_max_seq_len),
                (HeaderKey.ROPE_TYPE, int(self.rope_type)),
            ]
        if abs(self.norm_epsilon - 1e-5) > 1e-12:
            kv.append((HeaderKey.NORM_EPSILON_X1E12, int(round(self.norm_epsilon * 1e12))))
        return [(int(k), int(v)) for k, v in kv]

    @classmethod
    def from_header_kv(cls, kv: list[tuple[int, int]]) -> "LlamaConfig":
        vals: dict = {}
        for key, value in kv:
            key = HeaderKey(key)
            if key == HeaderKey.VERSION:
                vals["version"] = value
            elif key == HeaderKey.ARCH_TYPE:
                vals["arch"] = ArchType(value)
            elif key == HeaderKey.DIM:
                vals["dim"] = value
            elif key == HeaderKey.HIDDEN_DIM:
                vals["hidden_dim"] = value
            elif key == HeaderKey.N_LAYERS:
                vals["n_layers"] = value
            elif key == HeaderKey.N_HEADS:
                vals["n_heads"] = value
            elif key == HeaderKey.N_KV_HEADS:
                vals["n_kv_heads"] = value
            elif key == HeaderKey.N_EXPERTS:
                vals["n_experts"] = value
            elif key == HeaderKey.N_ACTIVE_EXPERTS:
                vals["n_active_experts"] = value
            elif key == HeaderKey.VOCAB_SIZE:
                vals["vocab_size"] = value
            elif key == HeaderKey.SEQ_LEN:
                vals["seq_len"] = value
            elif key == HeaderKey.HIDDEN_ACT:
                vals["hidden_act"] = HiddenAct(value)
            elif key == HeaderKey.ROPE_THETA:
                vals["rope_theta"] = float(value)
            elif key == HeaderKey.WEIGHT_FLOAT_TYPE:
                vals["weight_type"] = FloatType(value)
            elif key == HeaderKey.ROPE_SCALING_FACTOR:
                vals["rope_scaling_factor"] = float(value)
            elif key == HeaderKey.ROPE_SCALING_LOW_FREQ_FACTOR:
                vals["rope_scaling_low_freq_factor"] = float(value)
            elif key == HeaderKey.ROPE_SCALING_HIGH_FREQ_FACTORY:
                vals["rope_scaling_high_freq_factor"] = float(value)
            elif key == HeaderKey.ROPE_SCALING_ORIG_MAX_SEQ_LEN:
                vals["rope_scaling_orig_max_seq_len"] = value
            elif key == HeaderKey.ROPE_TYPE:
                vals["rope_type"] = RopeType(value)
            elif key == HeaderKey.NORM_EPSILON_X1E12:
                vals["norm_epsilon"] = value / 1e12
        return cls(**vals)
