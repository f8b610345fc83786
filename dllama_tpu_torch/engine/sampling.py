"""Token sampling on the device: greedy / temperature / top-p nucleus.

Semantics follow the reference Sampler (tokenizer.cpp:332-453): temperature
0 is argmax; otherwise softmax(logits/temp), then plain multinomial, or top-p
truncation when 0 < topp < 1. Random numbers come from a ``torch.Generator``
on the logits' device, seeded from the user seed: reproducible, but not the
JAX package's threefry stream. Each draw is an inverse-CDF lookup of one
uniform number, so tests can feed the uniforms directly.

The continuous-batching engine draws its uniforms from :class:`CounterRNG`,
a counter-based generator (Philox4x32-10) with a (seed, counter) state per
slot: a row's numbers depend on its own seed and counter only, never on its
batch-mates, and replaying n draws is ``counter += n``. It is written in
int64 tensor ops that never overflow, so it gives the same bits on the CPU
and on CUDA.
"""

from __future__ import annotations

import torch

#: top-p candidate-set width: the nucleus is taken among the top-K logits,
#: with probabilities normalized over the FULL vocab (see sample_logits).
#: None = exact mode: a full-vocab sort like the reference's nucleus.
NUCLEUS_K: int | None = 256


def _per_row(v):
    """A scalar stays a scalar; a [B] tensor broadcasts over the vocab."""
    return v[:, None] if isinstance(v, torch.Tensor) and v.dim() == 1 else v


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor, presence,
                    frequency) -> torch.Tensor:
    """OpenAI-style repetition penalties on raw logits:
    ``logit[j] - presence * 1[counts[j] > 0] - frequency * counts[j]``, with
    counts [B, V] of the tokens SAMPLED in this completion so far.
    presence/frequency: floats or f32 [B] per-row vectors."""
    c = counts.to(torch.float32)
    return logits - _per_row(presence) * (c > 0).to(torch.float32) - _per_row(frequency) * c


def _inverse_cdf(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Index drawn from the unnormalized non-negative `weights` [B, N] by
    the uniforms `u` [B, 1] in [0, 1): the first index whose cumulative
    weight exceeds u * total."""
    c = torch.cumsum(weights, dim=-1)
    i = torch.searchsorted(c, u * c[:, -1:], right=True)
    return i.clamp(max=weights.shape[-1] - 1)[:, 0]


def sample_logits(logits: torch.Tensor, temperature, topp,
                  generator: torch.Generator | None = None,
                  uniforms: torch.Tensor | None = None) -> torch.Tensor:
    """logits [B, V] -> token ids i64 [B].

    Top-p is computed over the top-NUCLEUS_K candidates with probabilities
    normalized against the FULL vocab; the kept set within the candidates is
    the reference's break-after-include (keep while the mass before a token
    is < topp). If the candidates cover less than topp of the mass (a
    nucleus wider than K), the row falls back to full-vocab temperature
    sampling rather than behaving as top-k = K. ``uniforms`` [B, 2] (top-p
    draw, temperature draw) replace the generator's draws.

    ``temperature`` and ``topp`` are floats, or f32 [B] per-row vectors (the
    batch engine's slots); a row at temperature 0 is the argmax."""
    logits = logits.to(torch.float32)
    per_row = isinstance(temperature, torch.Tensor)
    if not per_row and temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    temp = _per_row(temperature)
    scaled = logits / (temp.clamp(min=1e-6) if per_row else max(temperature, 1e-6))
    b, v = scaled.shape
    if uniforms is None:
        uniforms = torch.rand((b, 2), generator=generator, device=logits.device)
    tok_temp = _inverse_cdf(torch.softmax(scaled, dim=-1), uniforms[:, 1:2])
    if per_row:
        p = _per_row(topp)
        use = (p > 0.0) & (p < 1.0)
    elif not 0.0 < topp < 1.0:
        return tok_temp
    else:
        p, use = topp, True
    k = v if NUCLEUS_K is None else min(NUCLEUS_K, v)
    vals, idx = torch.topk(scaled, k, dim=-1)  # sorted descending
    pk = torch.exp(vals - torch.logsumexp(scaled, dim=-1, keepdim=True))
    cum = torch.cumsum(pk, dim=-1)
    keep = (cum - pk) < p
    choice = _inverse_cdf(torch.where(keep, pk, torch.zeros_like(pk)), uniforms[:, 0:1])
    tok_topp = idx.gather(-1, choice[:, None])[:, 0]
    use = use & (cum[:, -1:] >= p)
    tok = torch.where(use.reshape(-1), tok_topp, tok_temp)
    if per_row:
        tok = torch.where(temperature == 0.0, torch.argmax(logits, dim=-1), tok)
    return tok


# ----------------------------------------------------------- counter-based RNG

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a * m for a < 2^32 in int64 and a 32-bit
    constant m, from 16-bit halves: no intermediate reaches 2^63, so the
    result is exact on every device (int64 has no unsigned overflow rule)."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    m_hi, m_lo = m >> 16, m & 0xFFFF
    mid = a_lo * m_hi + a_hi * m_lo  # < 2^33
    low = a_lo * m_lo + ((mid & 0xFFFF) << 16)  # < 2^33
    hi = (a_hi * m_hi + (mid >> 16) + (low >> 32)) & _M32
    return hi, low & _M32


def philox4x32(counter: tuple, key: tuple, rounds: int = 10) -> tuple:
    """Philox4x32 (Salmon et al., SC 2011) on int64 tensors holding 32-bit
    words: counter (c0, c1, c2, c3), key (k0, k1) -> four words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(rounds):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _M32
            k1 = (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniforms(seed: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """Two uniforms in [0, 1) per element, f32 [..., 2], from int64 seeds and
    counters of one shape: the first two Philox words of counter under key
    seed, 24 bits each (exact in f32)."""
    key = (seed & _M32, (seed >> 32) & _M32)
    zero = torch.zeros_like(counter)
    words = philox4x32((counter & _M32, (counter >> 32) & _M32, zero, zero), key)
    return torch.stack([(w >> 8).to(torch.float32) * 2.0 ** -24 for w in words[:2]], dim=-1)


class CounterRNG:
    """Per-slot counter-based random numbers: state (seed, counter), int64
    [n] each, on one device. ``uniforms(steps)`` gives the draws of the next
    ``steps`` counters of every row without moving them; the caller advances
    each row by the draws it really consumed (``advance``). A row's numbers
    depend only on its own state, so a request's sampled stream does not
    depend on its batch-mates, and replaying n draws is ``advance(rows, n)``."""

    def __init__(self, n: int, device):
        self.seed = torch.zeros(n, dtype=torch.int64, device=device)
        self.counter = torch.zeros(n, dtype=torch.int64, device=device)

    def reset(self, row: int, seed: int, counter: int = 0) -> None:
        """Start row `row` at (seed, counter), in place: fills of one-row
        slices, in stream order (no host sync)."""
        self.seed[row : row + 1].fill_(int(seed) & ((1 << 63) - 1))
        self.counter[row : row + 1].fill_(int(counter))

    def uniforms(self, steps: int = 1, rows=None) -> torch.Tensor:
        """f32 [steps, n, 2] (or [steps, len(rows), 2]): step i of row r is
        drawn at counter[r] + i."""
        seed, ctr = (self.seed, self.counter) if rows is None else (
            self.seed[rows], self.counter[rows])
        offs = torch.arange(steps, dtype=torch.int64, device=ctr.device)[:, None]
        return philox_uniforms(seed[None].expand(steps, -1), ctr[None] + offs)

    def advance(self, n) -> None:
        """counter += n: an int for every row, or an int64 [n] per-row count."""
        self.counter += n

    def advance_row(self, row: int, n: int) -> None:
        """counter[row] += n: replay n draws of one row."""
        self.counter[row] += int(n)


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
            state, self._gen_state = getattr(self, "_gen_state", None), None
            self._gen = torch.Generator(device=device)
            if state is not None and state[0] == device.type:
                self._gen.set_state(state[1])
            else:
                self._gen.manual_seed(self.seed)
        return self._gen

    def __getstate__(self) -> dict:
        """A copy carries its generator's state, not the generator: a tp
        rank that receives the sampler with a call (parallel/multihost)
        draws the same numbers on its own device of the same type."""
        state = dict(self.__dict__)
        gen = state.pop("_gen")
        if gen is not None:
            state["_gen_state"] = (gen.device.type, gen.get_state())
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._gen = None

    def sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample_logits(logits, self.temperature, self.topp,
                             self.generator(logits.device))

    __call__ = sample
