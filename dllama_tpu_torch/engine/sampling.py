"""Token sampling on the device: greedy / temperature / top-p nucleus.

Semantics follow the reference Sampler (tokenizer.cpp:332-453): temperature
0 is argmax; otherwise softmax(logits/temp), then plain multinomial, or top-p
truncation when 0 < topp < 1. Random numbers come from a ``torch.Generator``
on the logits' device, seeded from the user seed: reproducible, but not the
JAX package's threefry stream. Each draw is an inverse-CDF lookup of one
uniform number, so tests can feed the uniforms directly.
"""

from __future__ import annotations

import torch

#: top-p candidate-set width: the nucleus is taken among the top-K logits,
#: with probabilities normalized over the FULL vocab (see sample_logits).
#: None = exact mode: a full-vocab sort like the reference's nucleus.
NUCLEUS_K: int | None = 256


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor, presence: float,
                    frequency: float) -> torch.Tensor:
    """OpenAI-style repetition penalties on raw logits:
    ``logit[j] - presence * 1[counts[j] > 0] - frequency * counts[j]``, with
    counts [B, V] of the tokens SAMPLED in this completion so far."""
    c = counts.to(torch.float32)
    return logits - presence * (c > 0).to(torch.float32) - frequency * c


def _inverse_cdf(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Index drawn from the unnormalized non-negative `weights` [B, N] by
    the uniforms `u` [B, 1] in [0, 1): the first index whose cumulative
    weight exceeds u * total."""
    c = torch.cumsum(weights, dim=-1)
    i = torch.searchsorted(c, u * c[:, -1:], right=True)
    return i.clamp(max=weights.shape[-1] - 1)[:, 0]


def sample_logits(logits: torch.Tensor, temperature: float, topp: float,
                  generator: torch.Generator | None = None,
                  uniforms: torch.Tensor | None = None) -> torch.Tensor:
    """logits [B, V] -> token ids i64 [B].

    Top-p is computed over the top-NUCLEUS_K candidates with probabilities
    normalized against the FULL vocab; the kept set within the candidates is
    the reference's break-after-include (keep while the mass before a token
    is < topp). If the candidates cover less than topp of the mass (a
    nucleus wider than K), the row falls back to full-vocab temperature
    sampling rather than behaving as top-k = K. ``uniforms`` [B, 2] (top-p
    draw, temperature draw) replace the generator's draws."""
    logits = logits.to(torch.float32)
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = logits / max(temperature, 1e-6)
    b, v = scaled.shape
    if uniforms is None:
        uniforms = torch.rand((b, 2), generator=generator, device=logits.device)
    tok_temp = _inverse_cdf(torch.softmax(scaled, dim=-1), uniforms[:, 1:2])
    if not 0.0 < topp < 1.0:
        return tok_temp
    k = v if NUCLEUS_K is None else min(NUCLEUS_K, v)
    vals, idx = torch.topk(scaled, k, dim=-1)  # sorted descending
    pk = torch.exp(vals - torch.logsumexp(scaled, dim=-1, keepdim=True))
    cum = torch.cumsum(pk, dim=-1)
    keep = (cum - pk) < topp
    choice = _inverse_cdf(torch.where(keep, pk, torch.zeros_like(pk)), uniforms[:, 0:1])
    tok_topp = idx.gather(-1, choice[:, None])[:, 0]
    return torch.where(cum[:, -1] >= topp, tok_topp, tok_temp)


class Sampler:
    """Stateful sampling parameters plus the OpenAI repetition-penalty
    fields. The generator is made on the device of the first logits it
    samples (the engine's device) and seeded from ``seed``."""

    def __init__(self, temperature: float = 0.8, topp: float = 0.9, seed: int = 0,
                 presence: float = 0.0, frequency: float = 0.0):
        self.temperature = float(temperature)
        self.topp = float(topp)
        self.presence = float(presence)
        self.frequency = float(frequency)
        self.seed = int(seed)
        self._gen: torch.Generator | None = None

    @property
    def has_penalties(self) -> bool:
        return self.presence != 0.0 or self.frequency != 0.0

    def generator(self, device) -> torch.Generator:
        device = torch.device(device)
        if self._gen is None or self._gen.device != device:
            self._gen = torch.Generator(device=device)
            self._gen.manual_seed(self.seed)
        return self._gen

    def sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample_logits(logits, self.temperature, self.topp,
                             self.generator(logits.device))

    __call__ = sample
