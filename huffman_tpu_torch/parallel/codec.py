"""Sharded block-parallel HTC1 codec: the block axis over the ranks.

Counterpart of `huffman_tpu/parallel/codec.py`.  The input stream is split
into independent fixed-size blocks at encode time, each rank holds its
contiguous ``(n_local, B)`` range of them, the code tables are replicated,
and the global histogram is a local histogram plus an ``all_reduce``.
Each function here takes and returns the rank's local blocks; the ordered
gather is `mesh.gather_shards`.  The encode runs the rank's blocks through
the HTC1 encode kernels B4b-B4d (`ops/gap_encode_kernels.py::
encode_blocks`, the same function as the JAX package's ``vmap`` of XLA's
`encode_block`); the decode is `ops/decode.py::decode_block` (a step
decoder, the JAX package's ``method``) over the local blocks, on the
mesh's device.
"""

from __future__ import annotations

import torch

from .mesh import DataMesh, all_reduce, on_mesh
from ..constants import MAX_CODEWORD_LENGTH
from ..ops.decode import decode_block
from ..ops.encode import histogram
from ..ops.gap_encode_kernels import encode_blocks
from ..ops.tables import DecSpec, DeviceDecTable

__all__ = [
    "sharded_histogram",
    "make_sharded_encode",
    "make_sharded_decode",
    "make_sharded_roundtrip",
]


def sharded_histogram(mesh: DataMesh, blocks: torch.Tensor) -> torch.Tensor:
    """Global (256,) int32 histogram of the blocks of every rank.
    ``blocks`` are this rank's local blocks: each rank counts its own,
    then one SUM over the mesh."""
    on_mesh(mesh, blocks)
    return all_reduce(mesh, histogram(blocks), "sum")


def make_sharded_encode(mesh: DataMesh, *, seg_bits: int, max_words: int,
                        n_segs: int):
    """Sharded encode: fn(local_blocks (n_local, B) uint8, enc) ->
    (words (n_local, max_words+1) int32 (the u32 bits), total_bits
    (n_local,), gaps (n_local, n_segs), counts (n_local, n_segs)), int32,
    each the rank's own blocks.  ``enc`` is the (256,) int32 table of
    `ops.device_enc_table`.  The kernels size their rows for 16-bit codes
    (`MAX_CODEWORD_LENGTH`), which fits every table, without reading the
    table's longest code back to the host."""

    def enc_fn(blocks: torch.Tensor, enc: torch.Tensor):
        on_mesh(mesh, blocks, enc)
        return encode_blocks(blocks, enc, seg_bits=seg_bits,
                             max_words=max_words, n_segs=n_segs,
                             max_len=MAX_CODEWORD_LENGTH)

    return enc_fn


def make_sharded_decode(mesh: DataMesh, *, spec: DecSpec, seg_bits: int,
                        max_count: int, out_size: int, method: str = "lut"):
    """Sharded decode: fn(words, gaps, counts, dec) -> (n_local, out_size)
    uint8, the rank's own blocks; `mesh.gather_shards` gives the ordered
    stream."""

    def dec_fn(words, gaps, counts, dec: DeviceDecTable) -> torch.Tensor:
        on_mesh(mesh, words, gaps, counts, *dec)
        return torch.stack([
            decode_block(w, g, c, dec, spec=spec, seg_bits=seg_bits,
                         max_count=max_count, out_size=out_size, method=method)
            for w, g, c in zip(words, gaps, counts)
        ])

    return dec_fn


def make_sharded_roundtrip(mesh: DataMesh, *, spec: DecSpec, seg_bits: int,
                           max_words: int, n_segs: int, max_count: int,
                           block_bytes: int, method: str = "lut"):
    """The full step (encode -> decode -> verify) over the mesh:
    fn(local_blocks, enc, dec) -> (decoded (n_local, B) uint8, ok () int32),
    ``ok`` the MIN over the ranks of each rank's bit-exact check, the same
    on every rank."""
    enc_fn = make_sharded_encode(mesh, seg_bits=seg_bits, max_words=max_words,
                                 n_segs=n_segs)
    dec_fn = make_sharded_decode(mesh, spec=spec, seg_bits=seg_bits,
                                 max_count=max_count, out_size=block_bytes,
                                 method=method)

    def step(blocks: torch.Tensor, enc: torch.Tensor, dec: DeviceDecTable):
        words, _, gaps, counts = enc_fn(blocks, enc)
        out = dec_fn(words, gaps, counts, dec)
        ok = (out == blocks).all().to(torch.int32)
        return out, all_reduce(mesh, ok, "min")

    return step
