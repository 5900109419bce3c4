"""Self-sync transition kernel C2: wrapper, plain version, launch count.

Counterpart of `huffman_tpu/ops/pallas/selfsync_kernels.py`
(`sync_transitions`).  The routing is that of `ops/ils_kernels.py`: a CUDA
tensor launches the kernel of ``csrc/selfsync.cu`` or raises, a CPU tensor
runs the plain version.

A codeword crosses a subsequence edge by fewer than ``max_len <= 16``
bits, so a subsequence is a function of its entry offset: for every
(entry e, subsequence i) `sync_transitions` gives ``(exit << 16) | count``,
the codewords that start in the subsequence from bit ``i * seg_bits + e``
and the offset at which the last one leaves it.

The kernel stops each entry where it meets an earlier entry's walk and
takes the rest of its count from that walk (``csrc/selfsync.cu``); the
plain version walks all 16 entries to the end, as the JAX kernel does.
The kernel's block geometry comes from `sync_tile`, which the launcher
checks.
"""

from __future__ import annotations

import torch

from ..utils import trace
from .gap_decode_kernels import _walk_counts
from .ils_kernels import (
    _check,
    _launched,
    _lib,
    _same_device,
    _stream,
    _use_kernel,
)

__all__ = [
    "SYNC_STATES",
    "sync_tile",
    "sync_transitions",
    "sync_transitions_plain",
    "reset_launch_counts",
    "launch_counts",
]

SYNC_STATES = 16  # entry states: a codeword crosses an edge by < max_len bits
SYNC_ROWS = 128  # subsequences (threads) a block
SYNC_MAP_WORDS = 16  # walk 0's bitmap: a subsequence's first 512 bits
SYNC_OWN_WORDS = 8  # owner map of entries 1..15: 4 bits an offset, 64 offsets


def sync_tile(seg_bits: int) -> tuple[int, int, int]:
    """(subsequences per block, bitmap words per subsequence, dynamic
    shared-memory bytes) of C2 at ``seg_bits``: for each subsequence of a
    block, walk 0's bitmap of its first ``SYNC_MAP_WORDS`` words, the owner
    map of its first 64 bits and the 16 entries' records (at most 20,480
    bytes, beside the static 1 KB length table).  ``csrc/selfsync.cu``
    checks the same formula."""
    map_words = min(seg_bits // 32, SYNC_MAP_WORDS)
    smem = (map_words + SYNC_OWN_WORDS + SYNC_STATES) * SYNC_ROWS * 4
    return SYNC_ROWS, map_words, smem


def sync_transitions_plain(words, lim, *, total_bits, seg_bits, n_subseq,
                           min_len, max_len):
    dev = words.device
    base = torch.arange(n_subseq, device=dev)[None, :] * seg_bits
    end = base + (total_bits - base).clamp(0, seg_bits)
    pos = base + torch.arange(SYNC_STATES, device=dev)[:, None]
    # the walks end at `end`, at most seg_bits codewords in
    count, pos = _walk_counts(words, pos, end, lim, min_len=min_len,
                              max_len=max_len, max_count=seg_bits)
    exit_state = (pos - base - seg_bits).clamp(0, SYNC_STATES - 1)
    return ((exit_state << 16) | count).to(torch.int32)


def sync_transitions(words, lim, *, total_bits, seg_bits, n_subseq, min_len,
                     max_len):
    """Per-(entry, subsequence) transitions of a raw MSB-first stream:
    (16, n_subseq) int32 ``(exit << 16) | count``, entry state e the row.

    words: (W,) int32 u32 payload (words past W read as zeros); lim: (32,)
    int32 canonical left-justified limits (`gap_decode_kernels.
    kernel_tabs`); total_bits: the stream's exact length.  Subsequences
    past the stream end give count 0 and exit 0."""
    _check("words", words, torch.int32)
    if words.dim() != 1:
        raise ValueError(f"words must be (W,), got {tuple(words.shape)}")
    _check("lim", lim, torch.int32, (32,))
    _same_device(words, lim)
    if not 1 <= min_len <= max_len <= SYNC_STATES:
        raise ValueError(f"self-sync transitions need code lengths in "
                         f"[1, {SYNC_STATES}], got {min_len}..{max_len}")
    if seg_bits <= 0 or seg_bits % 32 or seg_bits >= 1 << 16:
        raise ValueError(f"seg_bits must be a multiple of 32 below 65536 "
                         f"(counts are 16 bits), got {seg_bits}")
    kw = dict(total_bits=total_bits, seg_bits=seg_bits, n_subseq=n_subseq,
              min_len=min_len, max_len=max_len)
    if not _use_kernel(words):
        return sync_transitions_plain(words, lim, **kw)
    out = torch.empty((SYNC_STATES, n_subseq), dtype=torch.int32,
                      device=words.device)
    if n_subseq == 0:
        return out
    rows, map_words, smem = sync_tile(seg_bits)
    rc = _lib("selfsync").sync_transitions_launch(
        words.data_ptr(), lim.data_ptr(), out.data_ptr(), n_subseq,
        words.shape[0], total_bits, seg_bits, min_len, max_len, rows,
        map_words, smem, _stream(words),
    )
    _launched(sync_transitions, rc)
    return out


def reset_launch_counts() -> None:
    trace.reset_launches(("sync_transitions",))


def launch_counts() -> dict[str, int]:
    return trace.launches(("sync_transitions",))
