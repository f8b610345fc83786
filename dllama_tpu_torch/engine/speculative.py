"""Prompt-lookup speculative decoding: n-gram drafting + exact greedy
verification, on the device.

A decode forward is bound by the weight bytes it streams, and streaming the
weights for k+1 tokens costs about what one token does, so verifying k
drafted tokens in one (k+1)-wide forward is almost free, and every accepted
draft saves a forward. Drafts come from the sequence itself ("prompt
lookup": continue the most recent earlier occurrence of the trailing
n-gram), so no draft model is needed, and the output is the plain greedy
decode's: every emitted token is the model's argmax; speculation changes only
how many forwards it takes.

* propose — :func:`propose_ngram`, a vectorised n-gram match over a batch
  of token histories on the device (bit-exact with the JAX package's; the
  batched tier's per-slot rows, or the single engine's one row);
* verify — one (k+1)-wide forward with every position's logits (the Q40
  matmuls run K1 at m = k+1, attention K7 with k+1 query rows);
* accept — the longest prefix of the draft that agrees with the argmax.

:func:`spec_cycle` is one cycle of the single-sequence tier with all of its
state in device tensors (the history, the unfed token, the position, the
running count and cycle count, the output buffer): the JAX package's
``lax.while_loop`` condition (``cnt < n and pos + k + 1 <= seq_len``) is
evaluated on the device before the cycle, and a cycle that fails it is
frozen: it writes no KV row (the forward's ``active`` mask, at a clamped
position), no history and no output, and advances nothing. Nothing in it
reads a device value, so the engine captures a run of cycles as one device
program (``InferenceEngine.decode_spec_greedy_n``) and reads the count once
a replay.

Rejected drafts leave stale KV rows past the live position; attention masks
rows past ``pos``, and they are overwritten when those positions are really
decoded — the invariant behind the engine's mid-chunk rewind.
"""

from __future__ import annotations

import torch

#: the n-gram length the proposer matches (the JAX package's default)
SPEC_NGRAM = 2


def propose_ngram(h: torch.Tensor, length: torch.Tensor, k: int,
                  ngram: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Draft k tokens a row by continuing the most recent earlier occurrence
    of the trailing ``ngram`` tokens of ``h[b, :length[b]]``.

    h: i64 [B, S] token-at-position buffers, one history a row. Position i
    holds the sequence's i-th token for i < length; unknown positions hold
    -1, which never matches a real id. ``length``: a device tensor [B] (or
    one that broadcasts to it), so that nothing here reads a device value.
    Returns (draft [B, k], found: bool [B]). With no match the draft is an
    arbitrary in-range window — harmless, because verification only ever
    emits argmax tokens."""
    b, s = h.shape
    dev = h.device
    ln = length.to(torch.int64).reshape(-1).expand(b)
    idx = torch.arange(s, device=dev)
    # candidate j = index of the ngram's LAST token in an earlier occurrence:
    # h[j - d] == h[length - 1 - d] for d in 0..ngram-1, and j <= length - 2
    # (strictly earlier); j >= ngram - 1 keeps the roll from wrapping. An
    # index past the row clamps, as JAX's does.
    cond = (idx >= ngram - 1)[None] & (idx[None] <= (ln - 2)[:, None])
    for d in range(ngram):
        tail = h.gather(1, (ln - 1 - d).clamp(0, s - 1)[:, None])
        cond = cond & (torch.roll(h, d, dims=1) == tail)
    j = torch.where(cond, idx[None], -1).amax(dim=1)
    found = j >= 0
    j = j.clamp(0, s - k - 1)
    draft = h.gather(1, j[:, None] + 1 + torch.arange(k, device=dev)[None])
    return draft, found


def masked_put(buf: torch.Tensor, index: torch.Tensor, values: torch.Tensor,
               keep: torch.Tensor) -> None:
    """buf[..., index] = values where ``keep`` (broadcast over the index's
    last dim), in place, along buf's last dim: rows where ``keep`` is False
    write their old values back. An index past the end clamps to it: only
    masked rows reach there, and they write what is already there."""
    index = index.clamp(max=buf.shape[-1] - 1)
    old = buf.gather(-1, index)
    buf.scatter_(-1, index, torch.where(keep, values, old))


def spec_cycle(fwd, h: torch.Tensor, cur: torch.Tensor, pos: torch.Tensor,
               cnt: torch.Tensor, cyc: torch.Tensor, out: torch.Tensor, n: torch.Tensor,
               k: int, ngram: int, seq_len: int) -> None:
    """One greedy propose/verify/accept cycle over device state, in place.

    ``fwd(tokens [1, k+1], pos [1], active [1]) -> logits [1, k+1, V]`` runs
    the forward with every position's logits, writing KV rows only where
    ``active``. ``h`` (i64 [seq_len+1]) holds the tokens up to and including
    position ``pos`` (i32 [1]), where the unfed ``cur`` (i64 [1]) sits;
    ``cnt`` and ``cyc`` (i64 [1]) count the tokens emitted into ``out``
    (i64, at least n + k + 1 long) and the cycles run; ``n`` (i64 [1]) is the
    number of tokens wanted. The cycle runs when ``cnt < n`` and a
    (k+1)-row window fits before seq_len, and is frozen otherwise."""
    p = pos.to(torch.int64)
    live = (cnt < n) & (p + k + 1 <= seq_len)  # [1]
    draft = propose_ngram(h[None], p + 1, k, ngram)[0][0]  # [k]
    toks = torch.cat([cur, draft])[None]  # [1, k+1]
    # a frozen cycle still runs the forward (its KV writes masked): clamp its
    # rope and cache rows so the whole window stays in range
    p_cl = p.clamp(max=max(seq_len - (k + 1), 0)).to(pos.dtype)
    g = torch.argmax(fwd(toks, p_cl, live)[0], dim=-1)  # [k+1]
    # the longest draft prefix the model agrees with; g[a] is the bonus
    # token after the last accepted draft
    a = torch.cumprod((draft == g[:k]).to(torch.int64), dim=0).sum().view(1)
    # g[:a+1] are the emitted tokens AND the tokens at positions
    # pos+1 .. pos+a+1 (history entries past the new live position are
    # garbage that is never read and later overwritten)
    rows = torch.arange(k + 1, device=h.device)
    masked_put(out, cnt + rows, g, live)
    masked_put(h, p + 1 + rows, g, live)
    step = torch.where(live, a + 1, 0)
    cur.copy_(torch.where(live, g.gather(0, a), cur))
    pos.add_(step.to(pos.dtype))
    cnt.add_(step)
    cyc.add_(live.to(cyc.dtype))


def cycles_per_replay(remaining: int, pos: int, k: int, seq_len: int) -> int:
    """Cycles in the next replay of the single engine's spec program: the
    largest power of two that is at most the cycles that cannot freeze even
    at full acceptance (k+1 tokens each): ceil(remaining / (k+1)) before the
    count reaches n, and the cycles whose (k+1)-row window fits before
    seq_len from ``pos``. No cycle of a replay is then frozen, so no forward
    is wasted; the powers of two bound the programs a draft length needs to
    log2 of the chunk. The caller replays while remaining > 0 and a window
    fits (pos + k + 1 <= seq_len)."""
    most = -(-int(remaining) // (k + 1))
    edge = (seq_len - int(pos) - k - 1) // (k + 1) + 1
    m = max(1, min(most, edge))
    return 1 << (m.bit_length() - 1)
