"""Carry codec state across from NumPy fields.

This system has no weights: its state is the code table and the encoded
sections or blocks.  These build the port's `CodeTable`, `IlsSection`,
`Compressed` and `DeviceCompressed` from the plain NumPy fields of any
producer's table, schedule parameters, metadata and payload (the JAX
package's types of the same names have exactly these fields), so what is
encoded elsewhere decodes here and vice versa.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.canonical import CodeTable, canonical_code_table
from ..core.ils_ref import ILS_LANES, IlsParams, ils_n_win

__all__ = [
    "code_table_from_numpy",
    "section_from_numpy",
    "compressed_from_numpy",
    "device_compressed_from_numpy",
]


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


def compressed_from_numpy(lengths, max_len, seg_bits, original_size,
                          block_bytes, block_words, block_total_bits,
                          block_gaps, block_counts):
    """A host `Compressed` of the gap codec from its NumPy fields (per
    block: uint32 payload, total bits, uint8 gaps, int32 counts)."""
    from ..models.gap_codec import Compressed

    return Compressed(
        table=code_table_from_numpy(lengths, max_len), seg_bits=int(seg_bits),
        original_size=int(original_size), block_bytes=int(block_bytes),
        block_words=[np.asarray(w, np.uint32).copy() for w in block_words],
        block_total_bits=[int(t) for t in block_total_bits],
        block_gaps=[np.asarray(x, np.uint8).copy() for x in block_gaps],
        block_counts=[np.asarray(x, np.int32).copy() for x in block_counts],
    )


def device_compressed_from_numpy(lengths, max_len, seg_bits, original_size,
                                 block_bytes, words, total_bits, gaps,
                                 counts, device="cuda"):
    """A `DeviceCompressed` on ``device`` from NumPy fields: words (G, W)
    uint32, total_bits (G,), gaps and counts (G, n_segs)."""
    from ..models.gap_codec import DeviceCompressed
    from ..ops.ils import resolve_device

    dev = resolve_device(device)

    def put(x, dtype):  # a copy: the source array may be read-only
        return torch.from_numpy(np.array(x, dtype).view(np.int32)).to(dev)

    return DeviceCompressed(
        table=code_table_from_numpy(lengths, max_len), seg_bits=int(seg_bits),
        original_size=int(original_size), block_bytes=int(block_bytes),
        words=put(words, np.uint32), total_bits=put(total_bits, np.int32),
        gaps=put(gaps, np.int32), counts=put(counts, np.int32),
    )
