"""Multi-device codecs on `torch.distributed`: one rank per device, each
holding its local shard (`mesh.py`).  Counterpart of
`huffman_tpu/parallel/`, whose names it exports, less ``P`` and plus
`DataMesh`, `gather_shards`, `gather_ragged` and `IlsShardedCodec` (the
sharded ILS codec at the level of `IlsCodec`).  ``python -m
huffman_tpu_torch.parallel.dryrun N`` runs the multi-device dry run."""

from .mesh import (
    data_mesh,
    DATA_AXIS,
    DataMesh,
    Mesh,
    gather_ragged,
    gather_shards,
)
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
    IlsShardedCodec,
)

__all__ = [
    "ils_sharded_certified_encode",
    "IlsShardedSection",
    "IlsShardedCodec",
    "data_mesh",
    "DATA_AXIS",
    "DataMesh",
    "Mesh",
    "gather_shards",
    "gather_ragged",
    "sharded_histogram",
    "make_sharded_encode",
    "make_sharded_decode",
    "make_sharded_roundtrip",
    "shard_ils_payload",
    "make_ils_sharded_decode",
    "make_ils_sharded_roundtrip",
]
