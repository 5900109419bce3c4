"""Drives the program's ILS codec (`IlsCodec`, container ILS1).

Bulk: `IlsCodec.encode` of a flat device-resident input, `IlsCodec.decode`
of its `IlsCompressed`.  A page read is the command line's decode of an
ILS1 file: `read_ils_container`, then `IlsCodec(table)`, then `decode`.
"""

from __future__ import annotations

from huffman_tpu_torch import IlsCodec
from huffman_tpu_torch.core.canonical import canonical_code_table
from huffman_tpu_torch.core.package_merge import package_merge_lengths
from huffman_tpu_torch.io import read_ils_container, write_ils_container
from huffman_tpu_torch.ops.ils import pick_k


def input_shape(cfg: dict, n_bytes: int) -> tuple:
    return (n_bytes,)


def fit(cfg: dict, data):
    return IlsCodec.fit(data, max_len=cfg["max_len"], k=cfg["k"],
                        optimize=cfg["optimize"], rotate=cfg["rotate"],
                        device=data.device)


def fit_from_freqs(cfg: dict, freqs, device):
    """A codec whose table is the program's code of given counts (the
    control's table), with k chosen as `fit` chooses it."""
    table = canonical_code_table(
        package_merge_lengths(freqs, cfg["max_len"]), cfg["max_len"])
    avg = float((freqs * table.lengths).sum() / max(freqs.sum(), 1))
    return IlsCodec(table, k=cfg["k"] or pick_k(avg, cfg["optimize"]),
                    rotate=cfg["rotate"], device=device)


def encode(codec, data):
    return codec.encode(data)


def decode(codec, comp):
    return codec.decode(comp)


def container(codec, comp) -> bytes:
    return write_ils_container(comp)


def pack(codec, data) -> bytes:
    return write_ils_container(codec.encode(data))


def read(blob: bytes, device, span):
    with span("parse"):
        comp = read_ils_container(blob)
    with span("tables"):
        codec = IlsCodec(comp.table, device=device)
    with span("decode"):
        return codec.decode(comp)
