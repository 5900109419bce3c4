"""Length-limited Huffman code lengths (package-merge / coin collector).

Host-side NumPy, the same algorithm as `huffman_tpu/core/package_merge.py`
(whose optional native C++ path is bit-identical to this NumPy path).  The
lengths alone decide the canonical code, so they decide the container
bytes.  ``huffman_lengths_unbounded`` gives the depths of the greedy
(unbounded) Huffman tree, and ``kraft_sum`` checks a length assignment.
"""

from __future__ import annotations

import heapq

import numpy as np

from ..constants import ALPHABET_SIZE, MAX_CODEWORD_LENGTH

__all__ = ["package_merge_lengths", "huffman_lengths_unbounded", "kraft_sum"]


def kraft_sum(lengths: np.ndarray) -> float:
    """Kraft sum of a length assignment (0 = absent symbol)."""
    ls = np.asarray(lengths)
    ls = ls[ls > 0].astype(np.float64)
    return float(np.sum(2.0 ** (-ls)))


def package_merge_lengths(
    freqs: np.ndarray, max_len: int = MAX_CODEWORD_LENGTH
) -> np.ndarray:
    """Optimal length-limited code lengths for a byte alphabet.

    Args:
      freqs: (256,) nonnegative symbol frequencies.
      max_len: maximum codeword length L.

    Returns:
      (256,) uint8 code lengths; 0 marks an absent symbol.
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    if freqs.shape != (ALPHABET_SIZE,):
        raise ValueError(f"freqs must be shape (256,), got {freqs.shape}")
    if np.any(freqs < 0):
        raise ValueError("negative frequency")

    syms = np.nonzero(freqs)[0]
    k = len(syms)
    lengths = np.zeros(ALPHABET_SIZE, np.uint8)
    if k == 0:
        return lengths
    if k == 1:
        # a lone symbol still gets a 1-bit code
        lengths[syms[0]] = 1
        return lengths
    if k > (1 << max_len):
        raise ValueError(f"{k} symbols cannot fit in max_len={max_len} bits")

    order = np.argsort(freqs[syms], kind="stable")
    sorted_syms = syms[order]
    w = freqs[sorted_syms]  # ascending leaf weights

    # Coin collector: start at the deepest level with the leaf list; at each
    # level package adjacent pairs and merge with the leaves of the level
    # above.  Each package carries a per-symbol leaf count; after the level-1
    # merge, the first 2k-2 items' counts are the code lengths.
    leaf_counts = np.eye(k, dtype=np.int32)
    pkg_w = w.copy()
    pkg_c = leaf_counts.copy()
    for _ in range(max_len - 1):
        p = len(pkg_w) & ~1
        merged_w = pkg_w[0:p:2] + pkg_w[1:p:2]
        merged_c = pkg_c[0:p:2] + pkg_c[1:p:2]
        all_w = np.concatenate([w, merged_w])
        all_c = np.concatenate([leaf_counts, merged_c], axis=0)
        o = np.argsort(all_w, kind="stable")
        pkg_w = all_w[o]
        pkg_c = all_c[o]

    take = 2 * k - 2
    lens_sorted = pkg_c[:take].sum(axis=0)
    if np.any(lens_sorted <= 0) or np.any(lens_sorted > max_len):
        raise AssertionError("package-merge produced an invalid length")
    lengths[sorted_syms] = lens_sorted.astype(np.uint8)
    return lengths


def huffman_lengths_unbounded(freqs: np.ndarray) -> np.ndarray:
    """Unbounded greedy Huffman code lengths (the reference's greedy tree).

    The depth profile of a heap-built Huffman tree, ties broken by the
    order symbols enter the heap; only the lengths matter for the
    canonical code.  A lone symbol gets a 1-bit code."""
    freqs = np.asarray(freqs, dtype=np.int64)
    syms = np.nonzero(freqs)[0]
    k = len(syms)
    lengths = np.zeros(ALPHABET_SIZE, np.uint8)
    if k == 0:
        return lengths
    if k == 1:
        lengths[syms[0]] = 1
        return lengths

    # heap items: (weight, tiebreak, node); a leaf is a symbol, an internal
    # node a pair of nodes
    heap = [(int(freqs[s]), i, int(s)) for i, s in enumerate(syms)]
    heapq.heapify(heap)
    counter = k
    while len(heap) > 1:
        wa, _, a = heapq.heappop(heap)
        wb, _, b = heapq.heappop(heap)
        heapq.heappush(heap, (wa + wb, counter, (a, b)))
        counter += 1

    stack = [(heap[0][2], 0)]
    while stack:
        node, depth = stack.pop()
        if isinstance(node, tuple):
            stack.append((node[0], depth + 1))
            stack.append((node[1], depth + 1))
        else:
            lengths[node] = max(depth, 1)
    return lengths
