"""Synthetic test data, byte-identical to `huffman_tpu/utils/datagen.py`.

Each byte is one of 'A'..'D' with probability ``redundancy``, else uniform
over 0..255, drawn from a NumPy generator seeded with ``seed`` in 64 MiB
chunks (the same draw order, so the same seed gives the same bytes)."""

from __future__ import annotations

import numpy as np

__all__ = ["generate_redundant"]


def generate_redundant(
    size: int, redundancy: float, seed: int | None = 0
) -> np.ndarray:
    redundancy = float(min(max(redundancy, 0.0), 1.0))
    rng = np.random.default_rng(seed)
    out = np.empty(size, np.uint8)
    chunk = 1 << 26
    for off in range(0, size, chunk):
        n = min(chunk, size - off)
        r = rng.random(n)
        low = ord("A") + rng.integers(0, 4, size=n, dtype=np.uint8)
        full = rng.integers(0, 256, size=n, dtype=np.uint8)
        out[off : off + n] = np.where(r < redundancy, low, full)
    return out
