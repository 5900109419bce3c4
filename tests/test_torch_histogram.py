"""A NumPy model of the byte histogram kernel's layout
(`huffman_tpu_torch/csrc/byte_histogram.cu`), which only a card can run.

The model takes the kernel's constants from its source and follows its
index arithmetic: the unaligned head, the 16-byte body in rounds of
``HIST_VECS`` words a thread, grid-strided over the blocks, a drain every
``HIST_ROUNDS`` rounds and one at the end, and the ragged tail.  It checks
that every byte is counted exactly once, that no 8-bit counter passes 255
between two drains, and that the counter and drain addresses keep a warp's
lanes on distinct shared-memory banks for any bytes.  The card tests
(`tests/test_torch_cuda.py`) hold the kernel itself to ``torch.bincount``.
"""

import re
from pathlib import Path

import numpy as np
import pytest

SRC = (Path(__file__).resolve().parents[1] / "huffman_tpu_torch" / "csrc"
       / "byte_histogram.cu").read_text()
T = int(re.search(r"#define HIST_THREADS (\d+)", SRC).group(1))
VECS = int(re.search(r"#define HIST_VECS (\d+)", SRC).group(1))
ROUNDS = int(re.search(r"#define HIST_ROUNDS (\d+)", SRC).group(1))
CHUNK = T * VECS


def _column(t):
    return ((t & 63) << 2) | (t >> 6)


def _model(data, addr, blocks):
    """(counts, the largest 8-bit counter between two drains) as the
    kernel counts ``data`` lying at address ``addr`` with ``blocks``
    blocks."""
    n = data.size
    head = min(n, (16 - addr % 16) % 16)
    n_vec = (n - head) // 16
    tail = n - head - 16 * n_vec
    seen = np.zeros(n, np.int64)
    # (block, drain period, thread, bin) of every count
    keys = []
    body = np.arange(16 * n_vec) + head
    v = (body - head) // 16
    c = v // CHUNK
    t = (v % CHUNK) % T
    keys.append((c % blocks, c // blocks // ROUNDS, t, data[body]))
    edge = np.r_[np.arange(head), head + 16 * n_vec + np.arange(tail)]
    t_edge = np.r_[np.arange(head), np.arange(tail)]
    keys.append((np.zeros(edge.size, np.int64), np.zeros(edge.size, np.int64),
                 t_edge, data[edge]))
    np.add.at(seen, body, 1)
    np.add.at(seen, edge, 1)
    assert (seen == 1).all()
    b, r, th, byte = (np.concatenate(k).astype(np.int64) for k in zip(*keys))
    key = ((b * (r.max(initial=0) + 1) + r) * T + th) * 256 + byte
    per_counter = np.bincount(key) if key.size else np.zeros(1, np.int64)
    return np.bincount(byte, minlength=256), int(per_counter.max())


@pytest.mark.parametrize("n, addr, blocks", [
    (0, 0, 1),                       # nothing
    (15, 1, 1),                      # head only
    (17, 0, 1),                      # one word and a tail
    (CHUNK * 16 + 5, 7, 2),          # head, one round, tail
    (3 * CHUNK * 16 + 4097, 15, 3),  # grid-strided rounds across blocks
])
def test_model_counts_each_byte_once(n, addr, blocks):
    data = np.random.default_rng(n + addr).integers(0, 4, n, dtype=np.uint8)
    counts, top = _model(data, addr, blocks)
    assert np.array_equal(counts, np.bincount(data, minlength=256))
    assert top <= 255


def test_constant_stream_stays_under_a_counter_wrap():
    # the worst case: one value, so one counter a thread takes every byte
    # between two drains, plus block 0's head and tail bytes
    assert ROUNDS * VECS * 16 + 2 <= 255
    data = np.full(2 * ROUNDS * CHUNK * 16 + 30, 9, np.uint8)
    counts, top = _model(data, 1, 1)
    assert counts[9] == data.size and top == ROUNDS * VECS * 16 + 2


def test_counter_and_drain_addresses_avoid_bank_conflicts():
    t = np.arange(T)
    col = _column(t)
    assert sorted(col) == list(range(T))  # one byte of each row a thread
    for b in range(256):
        # the counter of bin b: byte b * 256 + column, bank = word % 32;
        # every warp's lanes on 32 distinct banks, whatever their bins
        bank = ((b << 8) + col) // 4 % 32
        assert (bank == t % 32).all()
    for i in range(16):
        # the drain: thread b reads 16-byte word (i + b) % 16 of row b; a
        # quarter-warp's 8 loads on 8 distinct groups of 4 banks
        word = (t << 6) + 4 * ((i + t) & 15)
        group = word // 4 % 8
        for q in range(0, T, 8):
            assert len(set(group[q:q + 8])) == 8
