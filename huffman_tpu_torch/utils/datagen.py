"""Synthetic test data, byte-identical to `huffman_tpu/utils/datagen.py`.

`generate_redundant`: each byte is one of 'A'..'D' with probability
``redundancy``, else uniform over 0..255, drawn from a NumPy generator
seeded with ``seed`` in 64 MiB chunks (the same draw order, so the same
seed gives the same bytes).  `generate_binomial`: binomial(255, 0.5)
bytes, mass near 128 (skewed code lengths).  `generate_single_symbol`:
one repeated byte (a 1-bit code)."""

from __future__ import annotations

import numpy as np

__all__ = ["generate_redundant", "generate_binomial", "generate_single_symbol"]


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


def generate_binomial(size: int, seed: int | None = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.binomial(255, 0.5, size=size).astype(np.uint8)


def generate_single_symbol(size: int, symbol: int = 65) -> np.ndarray:
    return np.full(size, symbol, np.uint8)
