"""Drives the program's gap-array codec (`GapArrayCodec`, container HTC1).

Bulk: `GapArrayCodec.encode_device` of a (blocks, block_bytes) stack on
the device and `decode_device` of its `DeviceCompressed`; the container
is written by `stage_host` and `write_container`.  (No cell reads HTC1
pages yet, so this driver has no ``pack`` or ``read``.)
"""

from __future__ import annotations

from huffman_tpu_torch import GapArrayCodec
from huffman_tpu_torch.core.canonical import canonical_code_table
from huffman_tpu_torch.core.package_merge import package_merge_lengths
from huffman_tpu_torch.io import write_container
from huffman_tpu_torch.models.gap_codec import Compressed


def input_shape(cfg: dict, n_bytes: int) -> tuple:
    bb = cfg["block_bytes"]
    if n_bytes % bb:
        raise ValueError("the bulk input is whole blocks")
    return (n_bytes // bb, bb)


def fit(cfg: dict, data):
    return GapArrayCodec.fit(data, max_len=cfg["max_len"],
                             seg_bits=cfg["seg_bits"],
                             block_bytes=cfg["block_bytes"],
                             device=data.device)


def fit_from_freqs(cfg: dict, freqs, device):
    """A codec whose table is the program's code of given counts (the
    control's table)."""
    table = canonical_code_table(
        package_merge_lengths(freqs, cfg["max_len"]), cfg["max_len"])
    return GapArrayCodec(table, seg_bits=cfg["seg_bits"],
                         block_bytes=cfg["block_bytes"], device=device)


def encode(codec, blocks):
    return codec.encode_device(blocks)


def decode(codec, dcomp):
    return codec.decode_device(dcomp)


def container(codec, dcomp) -> bytes:
    comp = Compressed(table=dcomp.table, seg_bits=dcomp.seg_bits,
                      original_size=dcomp.original_size,
                      block_bytes=dcomp.block_bytes, block_words=[],
                      block_total_bits=[], block_gaps=[], block_counts=[])
    codec.stage_host(dcomp, comp)
    return write_container(comp)
