"""Seeds derived from a run's ``--seed``.

``--seed`` may exceed 32 bits; every consumer (numpy's global generator,
``torch.Generator``) gets a 31-bit value derived from it and a purpose name,
so the weights, the data and the traffic of one run draw from streams of
their own and the same ``--seed`` always gives the same inputs.
"""

from __future__ import annotations

import zlib

import numpy as np


def derive(seed: int, *purpose: str) -> int:
    """A 31-bit seed for ``purpose`` (names joined), from ``seed``."""
    if seed < 0:
        raise ValueError(f"--seed must be a whole number >= 0, not {seed}")
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF]
    words += [zlib.crc32(p.encode()) for p in purpose]
    return int(np.random.SeedSequence(words).generate_state(1)[0] & 0x7FFFFFFF)
