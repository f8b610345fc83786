"""Prompt-lookup speculative decoding: n-gram drafting + exact greedy
verification, on the device (single-sequence tier).

A decode forward is bound by the weight bytes it streams, and streaming the
weights for k+1 tokens costs about what one token does, so verifying k
drafted tokens in one (k+1)-wide forward is almost free, and every accepted
draft saves a forward. Drafts come from the sequence itself ("prompt
lookup": continue the most recent earlier occurrence of the trailing
n-gram), so no draft model is needed, and the output is the plain greedy
decode's: every emitted token is the model's argmax; speculation changes only
how many forwards it takes.

* propose — :func:`propose_ngram`, a vectorised n-gram match over the token
  history on the device (bit-exact with the JAX package's);
* verify — one (k+1)-wide forward through the engine's own forward with
  ``last_only=False``, so every position's logits come back (the Q40 matmuls
  run K1 at m = k+1, attention K7 with k+1 query rows);
* accept — the longest prefix of the draft that agrees with the argmax.

Rejected drafts leave stale KV rows past the live position; attention masks
rows past ``pos``, and they are overwritten when those positions are really
decoded — the invariant behind the engine's mid-chunk rewind.

Unlike the JAX package, whose cycle loop is a ``lax.while_loop`` carried on
the device with no host round trip until n tokens are ready, the loop here
runs on the host: each cycle reads one accepted count from the device (one
small copy and one synchronisation per verify forward), which is what
advances the position.
"""

from __future__ import annotations

import torch


def propose_ngram(h: torch.Tensor, length: int, k: int, ngram: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Draft k tokens by continuing the most recent earlier occurrence of
    the trailing ``ngram`` tokens of ``h[:length]``.

    h: i64 [S+1] token-at-position buffer (position i holds the sequence's
    i-th token for i < length; unknown positions hold -1, which never
    matches a real id). Returns (draft [k], found bool tensor). With no match
    the draft is an arbitrary in-range window — harmless, because
    verification only ever emits argmax tokens."""
    s = h.shape[0]
    idx = torch.arange(s, device=h.device)
    # candidate j = index of the ngram's LAST token in an earlier occurrence:
    # h[j - d] == h[length - 1 - d] for d in 0..ngram-1, and j <= length - 2
    # (strictly earlier); j >= ngram - 1 keeps the roll from wrapping
    cond = (idx >= ngram - 1) & (idx <= length - 2)
    for d in range(ngram):
        tail = h[max(length - 1 - d, 0)]
        cond &= torch.roll(h, d) == tail
    j = torch.where(cond, idx, -1).max()
    found = j >= 0
    j = j.clamp(0, s - k - 1)
    return h[j + 1 + torch.arange(k, device=h.device)], found


def spec_decode(fwd, h: torch.Tensor, cur: int, pos: int, n: int, k: int, ngram: int,
                seq_len: int) -> tuple[list[int], int, int, torch.Tensor]:
    """The greedy propose/verify/accept loop.

    ``fwd(tokens [1, T], pos) -> logits [1, T, V]`` runs the engine's
    forward with ``last_only=False`` and writes the KV rows. ``h`` (i64
    [seq_len+1], updated in place and returned) holds the tokens up to and
    including position ``pos``, where the unfed ``cur`` sits. Cycles run while
    fewer than n tokens are out and a (k+1)-row window still fits before
    seq_len. Returns (tokens, count, cycles, h): ``count`` >= n unless the
    context filled first; each token is the exact greedy continuation."""
    out: list[torch.Tensor] = []
    cnt = cyc = 0
    cur_t = torch.tensor([cur], dtype=h.dtype, device=h.device)
    while cnt < n and pos + k + 1 <= seq_len:
        draft, _ = propose_ngram(h, pos + 1, k, ngram)
        toks = torch.cat([cur_t, draft])[None]  # [1, k+1]
        g = torch.argmax(fwd(toks, pos)[0], dim=-1)  # [k+1]
        # the longest draft prefix the model agrees with; g[a] is the bonus
        # token after the last accepted draft
        acc = torch.cumprod((draft == g[:k]).to(torch.int64), dim=0).sum()
        # g[:a+1] are the emitted tokens AND the tokens at positions
        # pos+1 .. pos+a+1 (history entries past the new live position are
        # garbage that is never read and later overwritten)
        h[pos + 1 : pos + k + 2] = g
        a = int(acc)  # the cycle's one read of a device value
        out.append(g[: a + 1])
        cur_t = g[a : a + 1]
        pos += a + 1
        cnt += a + 1
        cyc += 1
    toks = torch.cat(out).tolist() if out else []
    return toks, cnt, cyc, h
