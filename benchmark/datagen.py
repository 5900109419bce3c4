"""Inputs made from the seed, on the device.

`redundant` follows the semantics of the upstream project's
``generate.cpp`` (BASELINE.json): each byte is one of 'A'..'D' with
probability ``redundancy``, else uniform over 0..255.  It draws with a
`torch.Generator` on the device in a few large calls, so the same seed
gives the same bytes on the same kind of device.  Host-side choices
(orders, samples) come from `rng`.  Seeds are any non-negative integer.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK = 1 << 28


def _state(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([seed % (1 << 64), stream])
               .generate_state(1, np.uint64)[0])


def rng(seed: int, stream: int) -> np.random.Generator:
    """A host generator for one purpose (``stream``) of a run's seed."""
    return np.random.default_rng(_state(seed, stream))


def redundant(n: int, redundancy: float, seed: int, stream: int,
              device) -> torch.Tensor:
    """(n,) uint8 of generate.cpp's distribution, made on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_state(seed, stream))
    out = torch.empty(n, dtype=torch.uint8, device=device)
    for off in range(0, n, CHUNK):
        m = min(CHUNK, n - off)
        pick = torch.rand(m, generator=gen, device=device) < redundancy
        low = torch.randint(65, 69, (m,), generator=gen, device=device,
                            dtype=torch.uint8)
        full = torch.randint(0, 256, (m,), generator=gen, device=device,
                             dtype=torch.uint8)
        out[off:off + m] = torch.where(pick, low, full)
    return out


def log_uniform_sizes(n: int, lo: int, hi: int) -> np.ndarray:
    """n sizes spread log-uniformly over [lo, hi]: the same set for every
    seed (its quantiles), so a seed changes their order and not the work."""
    q = (np.arange(n) + 0.5) / n
    return np.rint(lo * (hi / lo) ** q).astype(np.int64)
