"""Drives a sum across ranks: ``torch.distributed.all_reduce`` in the
process group that the port's ``init_multihost`` opens (the probe cell of
the harness's tests)."""

from __future__ import annotations

import torch.distributed as dist

from huffman_tpu_torch.utils.distributed import init_multihost


def open_group(address: str, world: int, rank: int, device) -> None:
    init_multihost(address, world, rank,
                   backend="nccl" if device.type == "cuda" else "gloo",
                   timeout=60)


def reduce(x):
    out = x.clone()
    dist.all_reduce(out)
    return out


def close_group() -> None:
    dist.destroy_process_group()
