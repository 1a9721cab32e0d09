"""Deterministic synthetic token pipeline (the port of the reference's
`repro/data/pipeline.py`).

  * stateless — batch(step) is a pure function of (seed, step, shard),
    so a restarted or replaced host replays exactly without
    coordination;
  * host-sharded — each host materializes only its slice of the global
    batch (`global_batch / num_shards` rows);
  * resumable — a checkpoint stores only the step counter.

Tokens are Zipf-distributed unigrams (exponent 1.1) with a repeat
overlay of period R = 8: position t copies position t - R with
probability 1/2, copied from the final stream block by block, so
repeats chain across blocks. The stream is learnable, so a training run
shows a falling loss.

The draws come from a `torch.Generator` on the CPU, seeded from
(seed, step, shard), so a batch is the same on every device; it is then
moved to the caller's device, the card unless the caller asks for the
CPU (`device="cpu"`), as every entry point of the port does. The reference draws with `jax.random`'s
threefry bits, which this cannot reproduce: the two pipelines make
streams of the same law, not the same tokens.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["DataConfig", "make_batch", "batch_iterator"]


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_exponent: float = 1.1
    ngram_repeat: int = 8        # repeat window: makes the stream learnable


def _generator(cfg: DataConfig, step: int, shard_index: int):
    """A CPU generator seeded from (seed, step, shard) through numpy's
    SeedSequence, which mixes the three into one 64-bit seed."""
    words = np.random.SeedSequence(
        [int(cfg.seed), int(step), int(shard_index)]).generate_state(
            2, np.uint32)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(words[0]) | (int(words[1] & 0x7FFFFFFF) << 32))
    return gen


def _zipf_probs(vocab: int, exponent: float) -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64)
    return torch.softmax(-exponent * torch.log(ranks), dim=0)


def make_batch(cfg: DataConfig, step, *, shard_index: int = 0,
               num_shards: int = 1, device="cuda"):
    """Returns {tokens: (global_batch / num_shards, seq_len) int32} for
    this shard, on `device`."""
    local = cfg.global_batch // num_shards
    gen = _generator(cfg, int(step), shard_index)
    raw = torch.multinomial(_zipf_probs(cfg.vocab_size, cfg.zipf_exponent),
                            local * cfg.seq_len, replacement=True,
                            generator=gen).reshape(local, cfg.seq_len)
    coin = torch.rand((local, cfg.seq_len), generator=gen) < 0.5
    # the overlay, block by block from the final stream: a position's
    # token is the raw draw of the same offset in the latest block at or
    # before it whose coin there came up tails (block 0 keeps its draws)
    r = cfg.ngram_repeat
    pad = (-cfg.seq_len) % r
    n_blocks = (cfg.seq_len + pad) // r
    raw_b = torch.nn.functional.pad(raw, (0, pad)).reshape(local, n_blocks, r)
    coin_b = torch.nn.functional.pad(coin, (0, pad)).reshape(
        local, n_blocks, r)
    blocks = torch.arange(n_blocks)[None, :, None].expand_as(raw_b)
    src = torch.where(coin_b, torch.zeros_like(blocks), blocks)
    src[:, 0] = 0
    src = torch.cummax(src, dim=1).values
    tokens = raw_b.gather(1, src).reshape(local, -1)[:, :cfg.seq_len]
    return {"tokens": tokens.to(torch.int32).to(device)}


def batch_iterator(cfg: DataConfig, start_step: int = 0, *,
                   shard_index: int = 0, num_shards: int = 1,
                   device="cuda"):
    """(step, batch) from `start_step` on, without end."""
    step = start_step
    while True:
        yield step, make_batch(cfg, step, shard_index=shard_index,
                               num_shards=num_shards, device=device)
        step += 1
