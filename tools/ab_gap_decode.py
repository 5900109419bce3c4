#!/usr/bin/env python3
"""A/B of the HTC1 decode B1 on one GPU, in one process, turns old, new,
new, old.  Two modes:

    mkdir -p build/parent
    git archive <commit> huffman_tpu_torch/csrc | tar -x -C build/parent
    python3 tools/ab_gap_decode.py build/parent/huffman_tpu_torch/csrc

the rank form (`gap_decode_ranks`) of an earlier
`huffman_tpu_torch/csrc/gap_decode.cu` against this tree's; and

    python3 tools/ab_gap_decode.py --place

the two-kernel decode (B1's rank form, the output's zero fill and B2,
`gap_place_bytes`) against B1's placing form
(`gap_decode_bytes`, the output not zero-filled where the plan shows the
counts in range), each with the offsets' cumsum, through the wrappers as
`decode_blocks` calls them; beside each shape the parts' own times.

The old source is built with the flags of `ops/cuda_build.py` in a
temporary directory and called in its own form: its launcher takes a
staged pitch or not (read from the source), and without one its tile is
128 rows of min(64, max_count rounded up to 8) columns.  The new entry is
called as `gap_decode_ranks` calls it (`ranks_tile`).  Shapes, each
encoded on the card by `GapArrayCodec.encode_device` and trimmed by
`decode_device_plan` (its max_count):

- cell: the benchmark cell htc1-r01.bulk's input, 64 blocks of 16 MiB of
  r=0.1 (`benchmark/datagen.py`, seed 1, stream 0), seg_bits 1024;
- group: 16 blocks of 16 MiB of r=0.5, seg_bits 1024 (the codec's group);
- yamamoto: one 128 MiB stream of r=0.5 at seg_bits 128 (B1's shape on
  the Yamamoto path);
- selfsync: one 128 MiB stream of r=0.5 at seg_bits 1024 (its shape on
  the self-sync path);
- seg8192: one 64 MiB stream of r=0.5 at seg_bits 8192 (nothing staged).

Outputs must be equal (in --place, to the input too); each time is the
mean of 10 calls between CUDA events (in the rank mode the outputs are
allocated once, outside; in --place each call allocates its own, as the
decode does).  Prints the card's name and power limit, ptxas's registers
and shared memory of the kernels, a line a shape and one JSON line.  Needs
a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import datagen  # noqa: E402
from huffman_tpu_torch import GapArrayCodec  # noqa: E402
from huffman_tpu_torch.ops import cuda_build  # noqa: E402
from huffman_tpu_torch.ops import gap_decode_kernels as gd  # noqa: E402

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ENTRY = "gap_decode_ranks_launch"
# (name, blocks, block bytes, r, seg_bits)
SHAPES = (
    ("cell", 64, 1 << 24, 0.1, 1024),
    ("group", 16, 1 << 24, 0.5, 1024),
    ("yamamoto", 1, 1 << 27, 0.5, 128),
    ("selfsync", 1, 1 << 27, 0.5, 1024),
    ("seg8192", 1, 1 << 26, 0.5, 8192),
)


def build_old(csrc: Path):
    """The old `gap_decode.cu`, loaded; whether its launcher takes a
    pitch; ptxas's report of its rank kernel."""
    src = (csrc / "gap_decode.cu").read_text()
    head = src[src.index(f'extern "C" int {_ENTRY}('):]
    staged = "int pitch" in head[: head.index(")")]
    with tempfile.TemporaryDirectory(prefix="ab_gap_") as tmp:
        out = Path(tmp) / "libold.so"
        run = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                              "-I", str(csrc), "-o", str(out),
                              str(csrc / "gap_decode.cu")],
                             check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(out))  # stays mapped once the file is gone
    f = getattr(lib, _ENTRY)
    f.argtypes = [_P] * 6 + [_L, _I, _L] + [_I] * (8 if staged else 7) + [_P]
    f.restype = _I
    return f, staged, _ptxas(run.stdout + run.stderr)


def _ptxas(log: str) -> str:
    """ptxas's lines for gap_decode_ranks_kernel."""
    keep, lines = False, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = "gap_decode_ranks_kernel" in line
        if keep and ("Used" in line or "spill" in line):
            lines.append(re.sub(r"^ptxas info\s*:\s*", "", line.strip()))
    return "; ".join(lines)


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


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def shape_plan(dev, g, b, r, seg_bits):
    """A shape's codec and `decode_device_plan` of its encoded input."""
    data = datagen.redundant(g * b, r, 1, 0, dev).view(g, b)
    codec = GapArrayCodec.fit(data.view(-1), seg_bits=seg_bits,
                              block_bytes=b, device=dev)
    return codec, data, codec.decode_device_plan(codec.encode_device(data))


def place_main() -> int:
    """B1 + zero fill + B2 (old) against B1 placing its bytes (new)."""
    card = card_line()
    res = {k: v for k, v in cuda_build.kernel_resources().items()
           if "gap_decode_" in k or "gap_place_bytes" in k}
    print(card)
    print(f"ptxas: {res}")
    dev = torch.device("cuda")
    results = {"card": card, "mode": "place", "ptxas": res}
    for name, g, b, r, seg_bits in SHAPES:
        codec, data, (words, gaps, counts, mc, in_range) = shape_plan(
            dev, g, b, r, seg_bits)
        lim, bias = gd.kernel_tabs(codec.dec)
        sym, flat, n = codec.dec.symtab, counts.reshape(-1), g * b
        kw = dict(seg_bits=seg_bits, max_count=mc, min_len=codec.spec.min_len,
                  max_len=codec.spec.max_len)

        def offsets():
            return torch.cumsum(flat, 0, dtype=torch.int64) - flat

        def old():
            ranks = gd.gap_decode_ranks(words, gaps, counts, lim, bias, **kw)
            return gd.gap_place_bytes(ranks, flat, offsets(), sym, n_out=n)

        def new():
            return gd.gap_decode_bytes(words, gaps, counts, offsets(), lim,
                                       bias, sym, n_out=n,
                                       counts_in_range=in_range, **kw)

        if not (torch.equal(old(), data.view(-1))
                and torch.equal(new(), data.view(-1))):
            raise AssertionError(f"outputs differ: {name}")
        del data
        ms = [events_ms((old, new)[i]) for i in (0, 1, 1, 0)]
        ranks, offs = gd.gap_decode_ranks(words, gaps, counts, lim, bias,
                                          **kw), offsets()
        parts = {
            "cumsum": events_ms(offsets),
            "b1_ranks": events_ms(lambda: gd.gap_decode_ranks(
                words, gaps, counts, lim, bias, **kw)),
            "zero_fill": events_ms(lambda: torch.zeros(
                n, dtype=torch.uint8, device=dev)),
            "b2_with_fill": events_ms(lambda: gd.gap_place_bytes(
                ranks, flat, offs, sym, n_out=n)),
            "b1_bytes": events_ms(lambda: gd.gap_decode_bytes(
                words, gaps, counts, offs, lim, bias, sym, n_out=n,
                counts_in_range=in_range, **kw)),
        }
        row = {"segments": flat.numel(), "max_count": mc, "seg_bits": seg_bits,
               "symbols": n, "counts_in_range": in_range,
               "rank_matrix_bytes": ranks.numel(),
               "turns": ["old", "new", "new", "old"], "ms": ms,
               "old_over_new": (ms[0] + ms[3]) / (ms[1] + ms[2]),
               "parts_ms": parts}
        results[name] = row
        print(f"{name}: {row}", flush=True)
        del words, gaps, counts, ranks, offs, codec
        torch.cuda.empty_cache()
    print(json.dumps(results))
    return 0


def main(argv) -> int:
    if argv[1] == "--place":
        return place_main()
    old, old_staged, old_ptxas = build_old(Path(argv[1]))
    new = cuda_build.load_kernels()["gap_decode"].gap_decode_ranks_launch
    card = card_line()
    res = next((v for k, v in cuda_build.kernel_resources().items()
                if "gap_decode_ranks_kernel" in k), {})
    print(card)
    print(f"old ptxas: {old_ptxas}")
    print(f"new ptxas: {res}")
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    results = {"card": card, "old_staged": old_staged, "new_ptxas": res,
               "old_ptxas": old_ptxas}
    for name, g, b, r, seg_bits in SHAPES:
        codec, data, (words, gaps, counts, mc, _) = shape_plan(
            dev, g, b, r, seg_bits)
        del data
        lim, bias = gd.kernel_tabs(codec.dec)
        n_all, ns = counts.numel(), counts.shape[1]
        lens = (codec.spec.min_len, codec.spec.max_len)
        rows, chunk, pitch, smem = gd.ranks_tile(mc, seg_bits)
        o_chunk = min(64, -(-mc // 8) * 8)
        o_geo = ((rows, chunk, pitch, smem) if old_staged
                 else (128, o_chunk, 128 * (o_chunk + 4)))
        outs = [torch.empty((n_all, mc), dtype=torch.uint8, device=dev)
                for _ in range(2)]
        head = [words.data_ptr(), gaps.data_ptr(), counts.data_ptr(),
                lim.data_ptr(), bias.data_ptr()]
        tail = [n_all, ns, words.shape[1], seg_bits, mc, *lens]
        calls = (
            lambda: old(*head, outs[0].data_ptr(), *tail, *o_geo, stream),
            lambda: new(*head, outs[1].data_ptr(), *tail, rows, chunk,
                        pitch, smem, stream),
        )
        for i, f in enumerate(calls):
            if f():
                raise RuntimeError(f"{('old', 'new')[i]} launch failed: "
                                   f"{name}")
        torch.cuda.synchronize()
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError(f"outputs differ: {name}")
        payload = n_all * seg_bits // 8  # the segments' bits
        ms = [events_ms(calls[i]) for i in (0, 1, 1, 0)]
        row = {"segments": n_all, "max_count": mc, "seg_bits": seg_bits,
               "payload_bytes": payload, "symbols": g * b,
               "new_tile": [rows, chunk, pitch, smem],
               "staged_bytes_a_block": 4 * rows * pitch,
               "turns": ["old", "new", "new", "old"], "ms": ms,
               "payload_gbps": [payload / m / 1e6 for m in ms],
               "old_over_new": (ms[0] + ms[3]) / (ms[1] + ms[2])}
        results[name] = row
        print(f"{name}: {row}", flush=True)
        del words, gaps, counts, outs, codec
        torch.cuda.empty_cache()
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
