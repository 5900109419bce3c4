"""Device tables of the HTC1 and ILS codecs, built from a host `CodeTable`.

Counterpart of `huffman_tpu/ops/tables.py`: the decoder table's three
forms, as tensors on an explicit device, and the static `DecSpec`; and of
the table builders of `huffman_tpu/ops/pallas/ils_kernels.py`
(`ils_enc_tabs`, `ils_dec_tabs`, `IlsDecTabs`), which `ops/ils_kernels.py`
names too.
Values the JAX package keeps in uint32 are int64 here (torch has no full
uint32 arithmetic).  The canonical-limit form feeds the CUDA kernels
(`ops/gap_decode_kernels.py::kernel_tabs`) and the "canonical" step
decoder; the flat LUT and the two-level L1/L2 tables feed the "lut" and
"twolevel" step decoders of `ops/decode.py`.  The encoder reads one (256,)
int32 table of ``(len << 20) | code`` (`device_enc_table`, the table of
`ils_enc_tabs`) in place of the JAX package's
``(codes, lengths)`` pair; `DeviceEncTable` names that form.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.canonical import (
    CodeTable,
    build_flat_lut,
    build_two_level_table,
    chain_spec,
)
from ..utils import trace
from .launch import resolve_device

__all__ = [
    "IlsDecTabs",
    "ils_enc_tabs",
    "ils_dec_tabs",
    "DeviceEncTable",
    "DeviceDecTable",
    "DecSpec",
    "device_enc_table",
    "device_dec_table",
    "dec_spec",
]

_PAD1 = torch.zeros(1, dtype=torch.int32)

# The encoder's device table: a (256,) int32 tensor of (len << 20) | code
DeviceEncTable = torch.Tensor


class IlsDecTabs(NamedTuple):
    """The ILS decoder's tables: canonical limits, rank bias and the
    rank->symbol map."""

    lim: torch.Tensor  # (32,) int32 bit patterns of the u32 left-justified limits
    bias: torch.Tensor  # (32,) int32 offsets[l] - first_code[l]
    symtab: torch.Tensor  # (256,) int32 canonical rank -> symbol


def ils_enc_tabs(table: CodeTable, *, device="cuda") -> torch.Tensor:
    """(256,) int32 ``(len << 20) | code`` per symbol, on ``device`` (CUDA
    unless the caller asks for the CPU)."""
    packed = (table.lengths.astype(np.int32) << 20) | table.codes.astype(np.int32)
    with trace.span("ils.enc_tables"):
        return trace.to_device(packed.astype(np.int32), resolve_device(device),
                               "enc_table")


def ils_dec_tabs(table: CodeTable, *, device="cuda") -> IlsDecTabs:
    """The ILS decoder's tables of ``table`` on ``device`` (CUDA unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    lim = np.zeros(32, np.uint32)
    lim[: table.lim_left.shape[0]] = table.lim_left
    bias = np.zeros(32, np.int32)
    b = table.offsets.astype(np.int64) - table.first_code.astype(np.int64)
    bias[: b.shape[0]] = b.astype(np.int32)
    symtab = np.zeros(256, np.int32)
    symtab[: table.num_symbols] = table.symtab
    with trace.span("ils.dec_tables"):
        return IlsDecTabs(
            trace.to_device(lim.view(np.int32), device, "dec_tables"),
            trace.to_device(bias, device, "dec_tables"),
            trace.to_device(symtab, device, "dec_tables"),
        )


def device_enc_table(table: CodeTable, *, device="cuda") -> DeviceEncTable:
    """The (256,) int32 ``(len << 20) | code`` table on ``device`` (CUDA
    unless the caller asks for the CPU) that `ops/encode.py::encode_block`
    and the ILS and HTC1 kernels read."""
    return ils_enc_tabs(table, device=device)


class DeviceDecTable(NamedTuple):
    """Decoder-side tables.  The JAX package's eleven fields, the four
    canonical-limit ones first (the CUDA kernels read them by position);
    the others default to the 1-element pads of ``two_level=False``."""

    lim_left: torch.Tensor  # (max_len+1,) int64 left-justified u32 limits
    offsets: torch.Tensor  # (max_len+1,) int32 rank of each length's first code
    first_code: torch.Tensor  # (max_len+1,) int64 first code of each length
    symtab: torch.Tensor  # (256,) int32 rank -> symbol, zero past num_symbols
    lut_sym: torch.Tensor = _PAD1  # (2^lut_bits,) int32
    lut_len: torch.Tensor = _PAD1  # (2^lut_bits,) int32
    l1_sym: torch.Tensor = _PAD1  # (2^prefix_bits,) int32
    l1_len: torch.Tensor = _PAD1  # (2^prefix_bits,) int32
    ptr_tab: torch.Tensor = _PAD1.long()  # (>=1,) int64 (l2 width << 16) | offset
    l2_sym: torch.Tensor = _PAD1  # (>=1,) int32
    l2_len: torch.Tensor = _PAD1  # (>=1,) int32


@dataclasses.dataclass(frozen=True)
class DecSpec:
    """Hashable static decode configuration (as the JAX package's)."""

    lut_bits: int
    max_len: int  # deepest occupied level
    min_len: int  # shallowest occupied level
    prefix_bits: int = 0  # two-level L1 width
    l1_boundary: int = 0  # first L1 index owned by long codes
    chain: tuple | None = None  # grouped compare chain (`chain_spec`)


def device_dec_table(table: CodeTable, lut_bits: int | None = None, *,
                     two_level: bool = True, device="cuda") -> DeviceDecTable:
    """The decoder tables on ``device`` (CUDA unless the caller asks for
    the CPU), with the JAX function's arguments in its order.
    ``two_level=False`` skips the L1/L2 build and stores 1-element pads, as
    the JAX package does on the paths that never select the "twolevel"
    method; the twolevel step raises on such a table."""
    device = resolve_device(device)
    b = int(lut_bits if lut_bits is not None else max(table.max_len_present, 1))
    lut_sym, lut_len = build_flat_lut(table, b)
    symtab = np.zeros(256, np.int32)
    symtab[: table.num_symbols] = table.symtab

    def t(a, dtype=np.int32):  # gathers need at least one element
        a = a.astype(dtype) if a.size else np.zeros(1, dtype)
        return torch.from_numpy(a).to(device)

    if two_level:
        two = build_two_level_table(table, _two_level_prefix(table))
        l1l2 = dict(l1_sym=t(two.l1_sym), l1_len=t(two.l1_len),
                    ptr_tab=t(two.ptr_table, np.int64), l2_sym=t(two.l2_sym),
                    l2_len=t(two.l2_len))
    else:
        pad = np.zeros(0, np.int32)
        l1l2 = dict(l1_sym=t(pad), l1_len=t(pad), ptr_tab=t(pad, np.int64),
                    l2_sym=t(pad), l2_len=t(pad))
    return DeviceDecTable(
        lim_left=t(table.lim_left, np.int64),
        offsets=t(table.offsets),
        first_code=t(table.first_code, np.int64),
        symtab=t(symtab),
        lut_sym=t(lut_sym),
        lut_len=t(lut_len),
        **l1l2,
    )


def _two_level_prefix(table: CodeTable) -> int:
    return min(10, max(table.max_len_present, 1))


def _two_level_boundary(table: CodeTable, p: int) -> int:
    """First p-bit L1 index owned by codes longer than p bits (the scalar
    form of ``build_two_level_table(...).boundary_code``)."""
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
