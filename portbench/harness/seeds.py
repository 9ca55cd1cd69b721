"""Seeds of the parts of a run, all drawn from ``--seed``."""

from __future__ import annotations

import zlib

import numpy as np


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed for the part of a run named by ``keys`` (strings or
    ints): the same for the same ``seed`` and keys, and unrelated across
    keys. ``seed`` may be any integer; it is taken modulo 2**128."""
    s = int(seed) % (1 << 128)
    words = [(s >> (32 * i)) & 0xFFFFFFFF for i in range(4)]
    for k in keys:
        words.append(zlib.crc32(k.encode()) if isinstance(k, str)
                     else int(k) % (1 << 64))
    state = np.random.SeedSequence(words).generate_state(2, np.uint64)
    return int(state[0] >> np.uint64(1))


def generator(device, seed: int, *keys):
    """A ``torch.Generator`` on ``device`` seeded by :func:`sub_seed`."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, *keys))
    return gen
