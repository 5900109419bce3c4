"""Device tables of the HTC1 codec, built from a host `CodeTable`.

Counterpart of `huffman_tpu/ops/tables.py`.  Ported: the canonical-limit
part of the decoder table (limits, offsets, first codes, rank -> symbol),
as tensors on an explicit device, and the static `DecSpec`.  Values the
JAX package keeps in uint32 are int64 here (torch has no full uint32
arithmetic).  The encoder reads one (256,) table of ``(len << 20) |
code`` (`ops/ils_kernels.py::ils_enc_tabs`) in place of the JAX package's
`DeviceEncTable` pair.  The flat LUT and the two-level L1/L2 tables feed
only the XLA step decoders, which are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.canonical import CodeTable, chain_spec

__all__ = [
    "DeviceDecTable",
    "DecSpec",
    "device_dec_table",
    "dec_spec",
]


class DeviceDecTable(NamedTuple):
    """Decoder-side canonical-limit tables."""

    lim_left: torch.Tensor  # (max_len+1,) int64 left-justified u32 limits
    offsets: torch.Tensor  # (max_len+1,) int32 rank of each length's first code
    first_code: torch.Tensor  # (max_len+1,) int64 first code of each length
    symtab: torch.Tensor  # (256,) int32 rank -> symbol, zero past num_symbols


@dataclasses.dataclass(frozen=True)
class DecSpec:
    """Hashable static decode configuration (as the JAX package's)."""

    lut_bits: int
    max_len: int  # deepest occupied level
    min_len: int  # shallowest occupied level
    prefix_bits: int = 0  # two-level L1 width
    l1_boundary: int = 0  # first L1 index owned by long codes
    chain: tuple | None = None  # grouped compare chain (`chain_spec`)


def device_dec_table(table: CodeTable, device="cpu") -> DeviceDecTable:
    symtab = np.zeros(256, np.int32)
    symtab[: table.num_symbols] = table.symtab
    return DeviceDecTable(
        lim_left=torch.from_numpy(table.lim_left.astype(np.int64)).to(device),
        offsets=torch.from_numpy(table.offsets.astype(np.int32)).to(device),
        first_code=torch.from_numpy(table.first_code.astype(np.int64)).to(device),
        symtab=torch.from_numpy(symtab).to(device),
    )


def _two_level_prefix(table: CodeTable) -> int:
    return min(10, max(table.max_len_present, 1))


def _two_level_boundary(table: CodeTable, p: int) -> int:
    """First p-bit L1 index owned by codes longer than p bits."""
    syms = table.symtab
    ls = table.lengths[syms].astype(np.int64)
    cs = table.codes[syms].astype(np.int64)
    long = ls > p
    if not np.any(long):
        return 1 << p
    return int((cs[long] >> (ls[long] - p)).min())


def dec_spec(table: CodeTable, lut_bits: int | None = None) -> DecSpec:
    b = int(lut_bits if lut_bits is not None else max(table.max_len_present, 1))
    p = _two_level_prefix(table)
    return DecSpec(
        lut_bits=b,
        max_len=max(table.max_len_present, 1),
        min_len=max(table.min_len, 1),
        prefix_bits=p,
        l1_boundary=_two_level_boundary(table, p),
        chain=chain_spec(table),
    )
