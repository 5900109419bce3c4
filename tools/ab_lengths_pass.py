#!/usr/bin/env python3
"""A/B of the two-pass ILS tier's kernels on one GPU: A4 (`ils_lengths_pass`)
and A5 (`ils_pack`) of an earlier `huffman_tpu_torch/csrc/ils_encode.cu`
against this tree's, in one process, turns old, new, new, old.

    mkdir -p build/parent
    git archive <commit> huffman_tpu_torch/csrc | tar -x -C build/parent
    python3 tools/ab_lengths_pass.py build/parent/huffman_tpu_torch/csrc

The old source is built with the flags of `ops/cuda_build.py` in a
temporary directory.  Its C entries are called in the form its own text
declares: `ils_lengths_launch` with or without the chunk arguments of the
(tile, chunk) form, `ils_pack_launch` with or without `have_cbits`.  Where
the old A5 takes A4's chunk bits, both sides are given them; where it
does not, the old side counts them itself, as it did.  The new entries
are this tree's, with `ops/cuda_build.py`'s argtypes.  Shapes:
256 MiB of generate_redundant(r=0.5, seed=0) as 64 tiles at k=4096 and 32
at k=8192, and the same bytes plus 777 zero-padded to one tile at
k=262,148 (the file path's first attempt), A4 only there.  Outputs must be
equal; each time is the mean of 10 calls between CUDA events (outputs
allocated once, outside).  Prints the card's name and power limit and one
JSON line.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from huffman_tpu_torch import IlsCodec  # noqa: E402
from huffman_tpu_torch.core.ils_ref import (  # noqa: E402
    ILS_LANES,
    ils_n_win,
    ils_schedule_numer,
)
from huffman_tpu_torch.ops import cuda_build  # noqa: E402
from huffman_tpu_torch.ops import ils as tils  # noqa: E402
from huffman_tpu_torch.ops import ils_kernels as tk  # noqa: E402
from huffman_tpu_torch.utils import generate_redundant  # noqa: E402

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


# the entries' argtypes before A4's (tile, chunk) form; the later form is
# this tree's, from ops/cuda_build.py
_BEFORE_CHUNKS = {
    "ils_lengths_launch": [_P] * 7 + [_I] * 4 + [_P],
    "ils_pack_launch": [_P] * 6 + [_I] * 7 + [_L, _I, _I, _P],
}


def _n_params(src: str, name: str) -> int:
    m = re.search(rf'extern "C" int {name}\((.*?)\)\s*{{', src, re.S)
    if m is None:
        raise ValueError(f"no entry {name} in the old ils_encode.cu")
    return m.group(1).count(",") + 1


def build_old(csrc: Path):
    """The old `ils_encode.cu`, loaded, and whether its entries have the
    (tile, chunk) form: (lib, A4 takes chunk arguments, A5 takes
    have_cbits)."""
    src = (csrc / "ils_encode.cu").read_text()
    with tempfile.TemporaryDirectory(prefix="ab_lengths_") as tmp:
        out = Path(tmp) / "libold.so"
        subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                        str(csrc), "-o", str(out),
                        str(csrc / "ils_encode.cu")],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(out))  # stays mapped once the file is gone
    current = cuda_build.signatures()["ils_encode"]
    chunked = {}
    for name, before in _BEFORE_CHUNKS.items():
        n = _n_params(src, name)
        chunked[name] = n == len(current[name])
        if not chunked[name] and n != len(before):
            raise ValueError(f"{name} of the old source takes {n} arguments,"
                             " a form this tool does not know")
        f = getattr(lib, name)
        f.argtypes = current[name] if chunked[name] else before
        f.restype = _I
    return (lib, chunked["ils_lengths_launch"],
            chunked["ils_pack_launch"])


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
    old, old_a4_chunked, old_a5_cbits = build_old(Path(argv[1]))
    new = cuda_build.load_kernels()["ils_encode"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    n = 1 << 28
    host = generate_redundant(n + 777, 0.5, seed=0)
    codec = IlsCodec.fit(host, device="cuda")
    enc = codec.enc
    stream = torch.cuda.current_stream().cuda_stream
    results = {"card": card}
    for k, size in ((4096, n), (8192, n), (262148, 262148 * ILS_LANES)):
        buf = torch.zeros(size, dtype=torch.uint8)
        m = min(size, host.size)
        buf[:m] = torch.from_numpy(host[:m])
        words = buf.to(dev).view(torch.int32).view(-1, ILS_LANES)
        n_tiles = words.shape[0] // (k // 4)
        snum = ils_schedule_numer(codec._avg_bits(buf))
        n_win = ils_n_win(k)
        chunks, chunk_win = tk.certify_chunks(k)

        def outs():
            return [torch.empty(s, dtype=torch.int32, device=dev) for s in (
                (n_tiles, ILS_LANES),
                *[(n_tiles, n_win, ILS_LANES)] * 4,
                (n_tiles, chunks - 1, ILS_LANES))]

        o_old, o_new = outs(), outs()
        p = [x.data_ptr() for x in o_old]
        q = [x.data_ptr() for x in o_new]
        a4_old = lambda: old.ils_lengths_launch(  # noqa: E731
            words.data_ptr(), enc.data_ptr(), *p[:5], n_tiles, k, snum, 0,
            stream) if not old_a4_chunked else old.ils_lengths_launch(
            words.data_ptr(), enc.data_ptr(), *p, n_tiles, k, snum, 0,
            chunks, chunk_win, stream)
        a4_new = lambda: new.ils_lengths_launch(  # noqa: E731
            words.data_ptr(), enc.data_ptr(), *q[:5], q[5], n_tiles, k, snum,
            0, chunks, chunk_win, stream)
        for f in (a4_old, a4_new):
            if f():
                raise RuntimeError(f"A4 launch failed at k={k}")
        torch.cuda.synchronize()
        for x, y in zip(o_old[:5], o_new[:5]):
            if not torch.equal(x, y):
                raise AssertionError(f"A4 old and new differ at k={k}")
        row = {"tiles": n_tiles, "chunks": chunks,
               "a4_ms": [events_ms(f) for f in (a4_old, a4_new, a4_new,
                                                 a4_old)]}
        if k != 262148:
            bits, dn, dx, en, ex, cbits = o_new
            band, boffs = tils.emission_band(en, ex)
            prm = tils.envelope_params(bits, dn, dx, k=k, snum=snum,
                                       rot=False, extra_band_pairs=band)
            G, W, cap_pairs = tk._pack_geometry(k, prm.w_cap, band)
            boffs = torch.from_numpy(boffs).to(dev)
            starts = tils.row_starts_of(prm, dev)
            rows = prm.total_rows + prm.w_cap
            pays = [torch.zeros((rows, ILS_LANES), dtype=torch.int32,
                                device=dev) for _ in range(2)]
            scratch = torch.empty_like(cbits)
            head = (words.data_ptr(), enc.data_ptr(), boffs.data_ptr(),
                    starts.data_ptr())
            tail = (n_tiles, k, snum, 0, G, W, cap_pairs, rows, chunks,
                    chunk_win)
            a5_old = lambda: old.ils_pack_launch(  # noqa: E731
                *head, pays[0].data_ptr(), scratch.data_ptr(), *tail,
                stream) if not old_a5_cbits else old.ils_pack_launch(
                *head, pays[0].data_ptr(), cbits.data_ptr(), *tail, 1, stream)
            a5_new = lambda: new.ils_pack_launch(  # noqa: E731
                *head, pays[1].data_ptr(), cbits.data_ptr(), *tail, 1, stream)
            for f in (a5_old, a5_new):
                if f():
                    raise RuntimeError(f"A5 launch failed at k={k}")
            torch.cuda.synchronize()
            if not torch.equal(*pays):
                raise AssertionError(f"A5 old and new differ at k={k}")
            row["a5_ms"] = [events_ms(f) for f in (a5_old, a5_new, a5_new,
                                                    a5_old)]
        results[f"k={k}"] = row
        print(f"k={k}: {row}", flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
