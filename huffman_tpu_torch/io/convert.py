"""Carry codec state across from NumPy fields.

This system has no weights: its state is the code table and the encoded
sections.  These build the port's `CodeTable` and `IlsSection` from the
plain NumPy fields of any producer's table, schedule parameters and
payload (the JAX package's `CodeTable`, `IlsParams` and `IlsSection` have
exactly these fields), so a section encoded elsewhere decodes here and
vice versa.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.canonical import CodeTable, canonical_code_table
from ..core.ils_ref import ILS_LANES, IlsParams, ils_n_win

__all__ = ["code_table_from_numpy", "section_from_numpy"]


def code_table_from_numpy(lengths: np.ndarray, max_len: int) -> CodeTable:
    """The canonical table of a (256,) length profile (codes, limits and
    canonical order all follow from the lengths)."""
    return canonical_code_table(np.asarray(lengths, np.uint8), int(max_len))


def section_from_numpy(k, snum, boffs, w_band, w_cap, w_tiles, n_tiles, rot,
                       payload):
    """An `IlsSection` (payload as a CPU int32 tensor) from NumPy fields;
    ``payload`` is (total_rows, 1024) uint32 or int32."""
    from ..ops.ils import IlsSection

    w_tiles = np.asarray(w_tiles).astype(np.int32)
    boffs = np.asarray(boffs).astype(np.int32).reshape(int(n_tiles), ils_n_win(int(k)))
    payload = np.ascontiguousarray(payload)
    if payload.dtype not in (np.uint32, np.int32):
        raise TypeError(f"payload must be uint32 or int32, got {payload.dtype}")
    payload = payload.view(np.int32).reshape(int(w_tiles.sum()), ILS_LANES)
    params = IlsParams(
        k=int(k), snum=int(snum), boffs=boffs, w_band=int(w_band),
        w_cap=int(w_cap), w_tiles=w_tiles, n_tiles=int(n_tiles),
        rot=bool(rot),
    )
    return IlsSection(params=params, payload=torch.from_numpy(payload.copy()))
