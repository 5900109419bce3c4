"""The probe's inputs and its plain reference: each rank's tensor made
from the seed and the rank, and their sum over every rank."""

from __future__ import annotations

import torch

from benchmark import datagen

STREAM = 100  # the seed's sub-streams 100 + rank; int32 sums stay exact
HIGH = 1 << 20


def inputs(n_bytes: int, seed: int, rank: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(datagen.rng(seed, STREAM + rank).integers(1 << 62)))
    return torch.randint(0, HIGH, (n_bytes // 4,), generator=gen,
                         device=device, dtype=torch.int32)


def check(out, n_bytes: int, seed: int, world: int, device) -> dict:
    want = inputs(n_bytes, seed, 0, device)
    for r in range(1, world):
        want += inputs(n_bytes, seed, r, device)
    diff = (0 if out is None else
            int((out.view(torch.uint8) != want.view(torch.uint8)).sum()))
    return {"decode_byte_diff": diff, "missing_answers": int(out is None)}
