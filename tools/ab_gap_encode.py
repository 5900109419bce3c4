#!/usr/bin/env python3
"""A/B of the HTC1 encode kernels on one GPU: B4b (`gap_row_pack`) and B4c
(`gap_row_meta`) of an earlier `huffman_tpu_torch/csrc/gap_encode.cu`, which
take no byte counts, against this tree's, in one process, turns old, new,
new, old.

    mkdir -p build/parent
    git archive <commit> huffman_tpu_torch/csrc | tar -x -C build/parent
    python3 tools/ab_gap_encode.py build/parent/huffman_tpu_torch/csrc

The old source is built with the flags of `ops/cuda_build.py` in a
temporary directory and called in its own form (no `n_bytes`); the new
entries are this tree's, called without byte counts (the codec's full
blocks) and, in a third column, with each block's count equal to its size
(the path a ragged block takes, at full rows).  Shapes: 256 MiB of
generate_redundant(r=0.5, seed=0) as the codec's group of 16 blocks of 16
MiB and as 4 blocks of 64 MiB, seg_bits=1024, the table fitted on it.
Outputs must be equal; each time is the mean of 10 calls between CUDA
events (outputs allocated once, outside).  Prints the card's name and
power limit and one JSON line.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from huffman_tpu_torch import GapArrayCodec  # noqa: E402
from huffman_tpu_torch.ops import cuda_build  # noqa: E402
from huffman_tpu_torch.ops import gap_encode_kernels as ge  # noqa: E402
from huffman_tpu_torch.utils import generate_redundant  # noqa: E402

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# the entries' argtypes before the byte counts
_BEFORE_COUNTS = {
    "gap_row_pack_launch": [_P] * 4 + [_L] + [_I] * 3 + [_P],
    "gap_row_meta_launch": [_P] * 5 + [_L] + [_I] * 7 + [_P],
}


def build_old(csrc: Path):
    """The old `gap_encode.cu`, built and loaded with the argtypes of its
    entries before the byte counts."""
    with tempfile.TemporaryDirectory(prefix="ab_gap_") as tmp:
        out = Path(tmp) / "libold.so"
        subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                        str(csrc), "-o", str(out),
                        str(csrc / "gap_encode.cu")],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(out))  # stays mapped once the file is gone
    for name, argtypes in _BEFORE_COUNTS.items():
        f = getattr(lib, name)
        f.argtypes = argtypes
        f.restype = _I
    return lib


def events_ms(fn, reps=10) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main(argv) -> int:
    old = build_old(Path(argv[1]))
    new = cuda_build.load_kernels()["gap_encode"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    n, seg_bits = 1 << 28, 1024
    host = generate_redundant(n, 0.5, seed=0)
    codec = GapArrayCodec.fit(host, seg_bits=seg_bits, device="cuda")
    enc = codec.enc
    max_len = max(codec.table.max_len_present, 1)
    cap = ge.row_cap_words(max_len)
    pack_rows, pack_smem = ge.row_pack_tile(cap)
    meta_rows, window, meta_smem = ge.meta_tile(seg_bits, max_len)
    stream = torch.cuda.current_stream().cuda_stream
    rows = torch.from_numpy(host).to(dev).view(torch.int32).view(-1, 32)
    n_rows = rows.shape[0]
    results = {"card": card}
    for g in (16, 4):
        rpb = n_rows // g
        nb = torch.full((g,), rpb * 128, dtype=torch.int32, device=dev)
        max_words = -(-(-(-rpb * 128 * max_len // 32)) // 512) * 512
        n_segs = -(-max_words * 32 // seg_bits)
        outs = [(torch.empty((n_rows, cap), dtype=torch.int32, device=dev),
                 torch.empty(n_rows, dtype=torch.int32, device=dev))
                for _ in range(3)]
        pack = [
            lambda p=outs[0]: old.gap_row_pack_launch(
                rows.data_ptr(), enc.data_ptr(), p[0].data_ptr(),
                p[1].data_ptr(), n_rows, cap, pack_rows, pack_smem, stream),
            lambda p=outs[1]: new.gap_row_pack_launch(
                rows.data_ptr(), enc.data_ptr(), None, p[0].data_ptr(),
                p[1].data_ptr(), n_rows, cap, 0, pack_rows, pack_smem,
                stream),
            lambda p=outs[2]: new.gap_row_pack_launch(
                rows.data_ptr(), enc.data_ptr(), nb.data_ptr(),
                p[0].data_ptr(), p[1].data_ptr(), n_rows, cap, rpb,
                pack_rows, pack_smem, stream),
        ]
        for f in pack:
            if f():
                raise RuntimeError(f"B4b launch failed at {g} blocks")
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for o in outs[1:]
                   for a, b in zip(outs[0], o)):
            raise AssertionError(f"B4b outputs differ at {g} blocks")
        bits = outs[0][1].view(g, rpb).to(torch.int64)
        s_local = (torch.cumsum(bits, 1) - bits).reshape(-1)
        metas = [(torch.zeros((g, n_segs), dtype=torch.int32, device=dev),
                  torch.full((g, n_segs), 2**31 - 1, dtype=torch.int32,
                             device=dev)) for _ in range(3)]
        shift = seg_bits.bit_length() - 1

        def meta(lib, m, counts=None):
            args = [rows.data_ptr(), enc.data_ptr(), s_local.data_ptr()]
            if lib is new:
                args.append(counts)
            return lib.gap_row_meta_launch(
                *args, m[0].data_ptr(), m[1].data_ptr(), n_rows, rpb,
                n_segs, shift, max_len, meta_rows, window, meta_smem, stream)

        # checked after one call each into zeroed outputs; the timed calls
        # add into them, which does not change their work
        for m, f in zip(metas, (lambda: meta(old, metas[0]),
                                lambda: meta(new, metas[1]),
                                lambda: meta(new, metas[2], nb.data_ptr()))):
            if f():
                raise RuntimeError(f"B4c launch failed at {g} blocks")
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for m in metas[1:]
                   for a, b in zip(metas[0], m)):
            raise AssertionError(f"B4c outputs differ at {g} blocks")
        turns = (0, 1, 2, 2, 1, 0)
        mf = (lambda: meta(old, metas[0]), lambda: meta(new, metas[1]),
              lambda: meta(new, metas[2], nb.data_ptr()))
        row = {"blocks": g, "block_bytes": rpb * 128, "n_segs": n_segs,
               "turns": ["old", "new", "new_counts", "new_counts", "new",
                         "old"],
               "b4b_ms": [events_ms(pack[i]) for i in turns],
               "b4c_ms": [events_ms(mf[i]) for i in turns]}
        results[f"{g}x{rpb * 128}"] = row
        print(f"{g} blocks: {row}", flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
