"""Deterministic synthetic token pipeline (host-sharded).

A copy of the reference's ``repro.data.pipeline`` (pure numpy): the
batches are equal to the reference's for every step, seed and host shard,
and tensors are made from them by the trainer, on its device.

Every batch is a pure function of (seed, step, host shard), so training is
reproducible and restart-safe: after a crash/restore at step k, the stream
continues bit-identically — the property the fault-tolerance tests assert.

The generated stream is a Zipf-ish unigram mix with short induction motifs
(repeated bigrams) so small models have learnable structure and losses
drop visibly in the e2e example.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1

    def __post_init__(self):
        if self.global_batch % self.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.host_batch = self.global_batch // self.n_hosts
        # fixed motif table: v -> successor (makes bigrams predictable)
        rng = np.random.default_rng(self.seed ^ 0x5EED)
        self._succ = rng.integers(0, self.vocab, self.vocab, dtype=np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host_id
        )
        # zipf-ish unigram draw
        u = rng.random((self.host_batch, self.seq_len + 1))
        toks = (self.vocab * u**3).astype(np.int32) % self.vocab
        # 50% of positions follow the motif table (predictable structure)
        follow = rng.random((self.host_batch, self.seq_len)) < 0.5
        for t in range(1, self.seq_len + 1):
            prev = toks[:, t - 1]
            toks[:, t] = np.where(follow[:, t - 1], self._succ[prev],
                                  toks[:, t])
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
        }


def make_train_iterator(
    vocab: int,
    seq_len: int,
    global_batch: int,
    seed: int = 0,
    start_step: int = 0,
    host_id: int = 0,
    n_hosts: int = 1,
    extra: Optional[Dict] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite deterministic iterator, resumable at ``start_step``."""
    ds = SyntheticTokens(vocab, seq_len, global_batch, seed, host_id, n_hosts)
    step = start_step
    while True:
        b = ds.batch(step)
        if extra:
            b = {**b, **extra}
        yield b
        step += 1
