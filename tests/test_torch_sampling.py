"""The port's sampler: greedy at temperature 0, the reference's
break-after-include top-p set (fed a fixed distribution and chosen uniform
draws), the wide-nucleus fallback, seeded reproducibility, and the
repetition penalties against the JAX package's formula."""

import numpy as np
import pytest
import torch

from dllama_tpu_torch.engine import sampling
from dllama_tpu_torch.engine.sampling import Sampler, apply_penalties, sample_logits

torch.set_num_threads(1)

V = 300


def _logits(probs_at: dict[int, float], rest: float = 1e-6) -> torch.Tensor:
    p = np.full(V, rest)
    for i, v in probs_at.items():
        p[i] = v
    return torch.from_numpy(np.log(p / p.sum()))[None].float()


def test_temperature_zero_is_argmax():
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((3, V))).float()
    assert torch.equal(sample_logits(logits, 0.0, 0.9), torch.argmax(logits, dim=-1))


def test_top_p_keeps_the_break_after_include_set():
    """Sorted probs .5/.3/.15/.05: with topp .7 the kept set is {.5, .3}
    (the mass before .3 is .5 < .7, before .15 it is .8). Uniform draws
    below .5/.8 pick the first, above pick the second, never a third."""
    a, b, c, d = 17, 201, 5, 99
    logits = _logits({a: 0.5, b: 0.3, c: 0.15, d: 0.05})
    picks = []
    for u in np.linspace(0.0, 0.999, 41):
        uni = torch.tensor([[u, 0.5]], dtype=torch.float32)
        picks.append(int(sample_logits(logits, 1.0, 0.7, uniforms=uni)[0]))
        assert picks[-1] == (a if u * 0.8 < 0.5 else b), u
    assert set(picks) == {a, b}
    # topp just past .8 takes the third token in too
    uni = torch.tensor([[0.999, 0.5]])
    assert int(sample_logits(logits, 1.0, 0.81, uniforms=uni)[0]) == c


def test_wide_nucleus_falls_back_to_temperature_sampling(monkeypatch):
    """Candidates that cover less than topp of the mass: the row samples the
    full vocab instead (here: the temperature draw lands past the top-2)."""
    monkeypatch.setattr(sampling, "NUCLEUS_K", 2)
    logits = torch.zeros((1, V))  # flat: two candidates hold 2/300 of the mass
    uni = torch.tensor([[0.0, 0.505]])
    assert int(sample_logits(logits, 1.0, 0.9, uniforms=uni)[0]) == 151  # 0.505 * 300


def test_same_seed_same_stream():
    rng = np.random.default_rng(1)
    rows = [torch.from_numpy(rng.standard_normal((1, V))).float() for _ in range(12)]

    def stream(seed):
        s = Sampler(0.9, 0.95, seed)
        return [int(s(r)[0]) for r in rows]

    assert stream(7) == stream(7)
    assert stream(7) != stream(8)


@pytest.mark.parametrize("presence,frequency", [(0.0, 0.5), (0.7, 0.0), (0.3, 0.2)])
def test_penalties_match_jax(presence, frequency):
    from dllama_tpu.engine.sampling import apply_penalties as jax_penalties

    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, V)).astype(np.float32)
    counts = rng.integers(0, 3, (2, V)).astype(np.int32)
    want = np.asarray(jax_penalties(logits, counts, presence, frequency))
    got = apply_penalties(torch.from_numpy(logits), torch.from_numpy(counts), presence,
                          frequency).numpy()
    assert np.abs(got - want).max() <= 1e-6
