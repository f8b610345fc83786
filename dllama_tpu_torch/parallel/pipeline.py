"""Pipeline parallelism: the JAX package's GPipe schedule over the ``pp``
axis (``dllama_tpu/parallel/pipeline.py``), one process a stage.

Stage s holds the layers [s L/pp, (s+1) L/pp) and their cache rows
(parallel/sharding puts "pp" on every layer leaf's leading axis); the
embedding, final norm and wcls are replicated over pp, as JAX's
``pp_param_specs`` places them. The batch splits into ``n_micro``
microbatches. At step t of the M + pp - 1 steps stage s runs microbatch
t - s through its layers (stage 0 embeds it first), then the activation
hops one stage (parallel/collectives.AxisGroup.hop: a send to s + 1 and a
receive from s - 1 in one ``batch_isend_irecv``). The last stage banks each
finished microbatch, then applies the final norm and wcls (the tp logits
gather where tp > 1), and the f32 logits are broadcast from it over pp, so
every stage holds the same bits (JAX's masked psum adds zeros to them).

Where JAX computes the bubble steps and masks their cache writes, a stage
here skips them: the same function, and both ends of every hop know from
(t, s) alone whether it carries a microbatch, so the sends and receives
stay paired. Each stage runs its layers through ``models/llama.run_layers``
with the engine's kernels (K1/K2/K7 on the card), where JAX's partial-manual
shard_map runs XLA matmuls. The tp exchange keeps working inside a stage:
every tp group lies within one stage. Plain torch around the kernels, as
JAX's schedule is jnp.
"""

from __future__ import annotations

import torch

from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.models.llama import KVCache, rope_rows, run_layers
from dllama_tpu_torch.ops.layers import rms_norm_plain
from dllama_tpu_torch.ops.matmul import matmul


def make_pp_forward(cfg: LlamaConfig, exchange, n_micro: int = 1, attn_fn=None, mm=None,
                    moe_impl: str = "auto", norm=None):
    """``fn(params, tokens, pos, cache, rope_cache, last_only=False,
    active=None) -> logits`` f32 [B, T or 1, V], every stage's the same.

    ``cfg`` is the stage's view (parallel/sharding.LocalLlamaConfig: its
    ``n_layers`` layers), ``exchange`` its parallel/collectives.TPExchange
    (``exchange.pp`` the hop and broadcast), ``params`` its tree and
    ``cache`` its layers' cache, updated in place. ``tokens`` [B, T] with
    B % n_micro == 0; ``pos`` an int or a [B] tensor; ``active`` [B] masks
    the cache writes of frozen rows. ``norm`` is the engine's RMSNorm
    (default the plain norm), in the stage's layers and the final norm."""
    hop = exchange.pp
    stage, last = hop.index, hop.size - 1
    mm = mm or matmul
    norm = norm or rms_norm_plain

    def fn(params, tokens, pos, cache: KVCache, rope_cache, last_only=False, active=None):
        b, t = tokens.shape
        if b % n_micro != 0:
            raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
        mbs = b // n_micro
        per_row = isinstance(pos, torch.Tensor) and pos.dim() == 1
        emb = params["embedding"]
        inbound = torch.empty((mbs, t, cfg.dim), dtype=emb.dtype, device=emb.device)
        exchange.open_forward()
        x, out = None, []
        for step in range(n_micro + last):
            m = step - stage
            if 0 <= m < n_micro:
                rows = slice(m * mbs, (m + 1) * mbs)
                if stage == 0:
                    x = emb[tokens[rows]]
                p = pos[rows] if per_row else pos
                sub = cache if n_micro == 1 else KVCache(cache.k[:, rows], cache.v[:, rows])
                x = run_layers(cfg, params["layers"], x, p, sub, rope_rows(rope_cache, p, t),
                               attn_fn, mm, None if active is None else active[rows],
                               moe_impl, exchange, norm)
                if stage == last:
                    out.append(x)
            # the hop: a stage sends what it ran this step, and receives what
            # the stage before it ran (that stage's microbatch is ours next)
            sends = stage < last and 0 <= m < n_micro
            recvs = stage > 0 and 0 <= m + 1 < n_micro
            x = hop.hop(x if sends else None, inbound if recvs else None)
        if stage == last:
            h = torch.cat(out) if n_micro > 1 else out[0]
            if last_only:
                h = h[:, -1:]
            h = norm(h, params["final_norm"], cfg.norm_epsilon)
            logits = mm(h, params["wcls"]).to(torch.float32)
            if exchange.logits_sharded:
                logits = exchange.gather_logits(logits)
        else:
            logits = torch.empty((b, 1 if last_only else t, cfg.vocab_size),
                                 dtype=torch.float32, device=emb.device)
        logits = hop.broadcast(logits, last)
        exchange.close_forward(b, t)
        return logits

    return fn
