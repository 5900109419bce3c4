"""Drives the program's sharded ILS codec (`IlsShardedCodec`, container
ILS1) on every rank of a cell of several cards.

Each rank holds one shard of one stream: `open_group` joins the program's
process group through the port's `init_multihost` (NCCL on the cards,
gloo on the CPU) and returns the rank's mesh; `fit` builds the table of
the whole stream's histogram on every rank, `encode` makes this rank's
shard, `decode` returns the whole stream in rank order on every rank and
`container` the ILS1 container of the whole stream.  Every call but
`input_shape` is collective: every rank makes it, in the same order.
"""

from __future__ import annotations

import torch.distributed as dist

from huffman_tpu_torch.parallel import (
    IlsShardedCodec,
    data_mesh,
    sharded_histogram,
)
from huffman_tpu_torch.utils.distributed import init_multihost

# a collective left waiting by a rank that is gone fails after this long
TIMEOUT_S = 60


def open_group(address: str, world: int, rank: int, device):
    init_multihost(address, world, rank,
                   backend="nccl" if device.type == "cuda" else "gloo",
                   timeout=TIMEOUT_S)
    return data_mesh(world, device=device)


def close_group(mesh) -> None:
    dist.destroy_process_group()


def input_shape(cfg: dict, n_bytes: int) -> tuple:
    return (n_bytes,)


def fit(cfg: dict, mesh, data):
    """The table of the whole stream's histogram; where the configuration
    holds ``control_stride`` (the control's override), the table of every
    ``control_stride``-th byte's global counts plus one
    (`control_sharded.py`)."""
    stride = cfg.get("control_stride")
    if not stride:
        return IlsShardedCodec.fit(mesh, data, max_len=cfg["max_len"],
                                   k=cfg["k"], optimize=cfg["optimize"],
                                   rotate=cfg["rotate"])
    counts = sharded_histogram(mesh, data.reshape(-1)[::stride])
    return fit_from_freqs(cfg, mesh, counts.cpu().numpy().astype("int64") + 1)


def fit_from_freqs(cfg: dict, mesh, freqs):
    """A codec whose table is the program's code of given global counts,
    with k chosen as `fit` chooses it."""
    return IlsShardedCodec.from_counts(mesh, freqs, max_len=cfg["max_len"],
                                       k=cfg["k"], optimize=cfg["optimize"],
                                       rotate=cfg["rotate"])


def encode(codec, data):
    return codec.encode(data)


def decode(codec, shard):
    return codec.decode(shard)


def container(codec, shard) -> bytes:
    return codec.container(shard)
