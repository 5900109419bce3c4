"""Multi-device codecs on `torch.distributed`: one rank per device, each
holding its local shard (`mesh.py`).  Counterpart of
`huffman_tpu/parallel/`, whose names it exports, less ``P`` and plus
`DataMesh` and `gather_shards`.  ``python -m
huffman_tpu_torch.parallel.dryrun N`` runs the multi-device dry run."""

from .mesh import data_mesh, DATA_AXIS, DataMesh, Mesh, gather_shards
from .codec import (
    sharded_histogram,
    make_sharded_encode,
    make_sharded_decode,
    make_sharded_roundtrip,
)
from .ils import (
    shard_ils_payload,
    make_ils_sharded_decode,
    make_ils_sharded_roundtrip,
    ils_sharded_certified_encode,
    IlsShardedSection,
)

__all__ = [
    "ils_sharded_certified_encode",
    "IlsShardedSection",
    "data_mesh",
    "DATA_AXIS",
    "DataMesh",
    "Mesh",
    "gather_shards",
    "sharded_histogram",
    "make_sharded_encode",
    "make_sharded_decode",
    "make_sharded_roundtrip",
    "shard_ils_payload",
    "make_ils_sharded_decode",
    "make_ils_sharded_roundtrip",
]
