"""Command line of the PyTorch port: generate / encode / decode / roundtrip /
bench, with the subcommands, flags and output lines of `huffman_tpu.cli`::

    python -m huffman_tpu_torch.cli generate --size 100000000 --redundancy 0.5 -o data.bin
    python -m huffman_tpu_torch.cli encode data.bin -o data.ils
    python -m huffman_tpu_torch.cli decode data.ils -o out.bin
    python -m huffman_tpu_torch.cli roundtrip data.bin
    python -m huffman_tpu_torch.cli bench --size 268435456 --redundancy 0.5

(script ``huffman-tpu-torch``).  The codecs run on ``--device`` (``cuda``
unless ``--device cpu`` is given), and without a usable card the command
raises rather than run on the CPU.  ``--method auto`` leaves the HTC1 and
Yamamoto decoders their default, the CUDA kernels (``pallas`` names them
too).  The files are the JAX package's CLI's, byte for byte.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

ROTATE = {"auto": "auto", "on": True, "off": False}


def _add_device_arg(p):
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where the codecs run: cuda (the CUDA kernels; raises without "
             "a card) or cpu (their plain PyTorch versions)",
    )


def _add_codec_args(p):
    p.add_argument("--max-len", type=int, default=16)
    p.add_argument("--seg-bits", type=int, default=None)
    p.add_argument("--block-bytes", type=int, default=None)
    p.add_argument(
        "--format", choices=["ils", "htc1", "yamamoto", "seq"], default="ils",
        help="container: ils (flagship), htc1 (gap-array), "
             "yamamoto (reference gap-array container), "
             "seq (reference sequential.cpp blob)",
    )
    p.add_argument(
        "--k", type=int, default=None,
        help="ILS symbols per stream (default: auto from mean code length)",
    )
    p.add_argument(
        "--optimize", choices=["speed", "ratio"], default="speed",
        help="ILS k policy: narrow refill band (speed) or minimal padding (ratio)",
    )
    p.add_argument(
        "--method",
        choices=["auto", "lut", "canonical", "twolevel", "pallas"],
        default="auto",
        help="htc1 decode inner-step implementation (auto and pallas: the "
             "CUDA kernels)",
    )
    p.add_argument(
        "--rotate", choices=["auto", "on", "off"], default="auto",
        help="ILS lane-decorrelation rotation: auto (default) turns it on "
             "per section only when it narrows the certified band; off "
             "writes a v3 container readable by older decoders",
    )
    _add_device_arg(p)


def _method(args):
    return None if args.method == "auto" else args.method


def _to_host(out) -> np.ndarray:
    return out.cpu().numpy() if isinstance(out, torch.Tensor) else out


class _RefFormatCodec:
    """Adapter: reference-format blobs behind the codec interface."""

    def __init__(self, fmt, data, max_len, method=None, device="cuda"):
        from .core import npref
        from .core.canonical import canonical_code_table
        from .core.package_merge import package_merge_lengths

        self.fmt = fmt
        self.method = method  # None: the CUDA kernels
        self.device = device
        self.table = canonical_code_table(
            package_merge_lengths(npref.histogram(data), max_len), max_len
        )

    def encode(self, data):
        from .io.seqfmt import write_seq
        from .io.yamamoto import write_yamamoto

        data = _to_host(data)
        if self.fmt == "seq":
            return write_seq(data, self.table)
        return write_yamamoto(data, self.table)

    def decode(self, blob):
        from .io.seqfmt import decode_seq
        from .io.yamamoto import decode_yamamoto

        if self.fmt == "seq":
            return decode_seq(blob, device=self.device)
        return decode_yamamoto(blob, method=self.method, device=self.device)


def _make_codec(args, data, device):
    if args.format in ("yamamoto", "seq"):
        return _RefFormatCodec(args.format, data, args.max_len,
                               method=_method(args), device=device)
    if args.format == "ils":
        from .models import IlsCodec

        return IlsCodec.fit(data, max_len=args.max_len, k=args.k,
                            optimize=args.optimize,
                            rotate=ROTATE[args.rotate], device=device)
    from .models import GapArrayCodec

    return GapArrayCodec.fit(data, **_codec_kwargs(args), device=device)


def _write_blob(args, comp):
    if args.format in ("yamamoto", "seq"):
        return comp  # _RefFormatCodec.encode already returns bytes
    if args.format == "ils":
        from .io import write_ils_container

        return write_ils_container(comp)
    from .io import write_container

    return write_container(comp)


def _codec_kwargs(args):
    from .constants import DEFAULT_BLOCK_BYTES, SEG_BITS

    return dict(
        max_len=args.max_len,
        seg_bits=args.seg_bits or SEG_BITS,
        block_bytes=args.block_bytes or DEFAULT_BLOCK_BYTES,
        method=_method(args),
    )


def _device(args) -> torch.device:
    """The device of the command; raises where CUDA is asked for and there
    is no card, before any work."""
    from .ops.ils import resolve_device

    return resolve_device(args.device)


def cmd_generate(args):
    from .utils import generate_redundant

    data = generate_redundant(args.size, args.redundancy, seed=args.seed)
    with open(args.output, "wb") as f:
        f.write(data.tobytes())
    print(f"Generated {args.size} bytes in {args.output}")


def cmd_encode(args):
    dev = _device(args)
    if args.stream:
        if args.format != "ils":
            print("error: --stream requires --format ils", file=sys.stderr)
            sys.exit(1)
        from .models import IlsCodec

        t0 = time.perf_counter()
        codec = IlsCodec.fit_file(
            args.input, max_len=args.max_len, k=args.k,
            optimize=args.optimize, rotate=ROTATE[args.rotate], device=dev,
        )
        csize = codec.encode_file(args.input, args.output,
                                  section_bytes=args.section_bytes)
        dt = time.perf_counter() - t0
        n = os.path.getsize(args.input)
        print(f"Original size:   {n} bytes")
        print(f"Compressed size: {csize} bytes")
        print(f"Ratio:           {100.0 * csize / max(n, 1):.2f}%")
        print(f"Encode time:     {dt * 1e3:.1f} ms "
              f"({n / dt / 1e9:.3f} GB/s inc. fit+IO, section-streamed)")
        return
    data = np.fromfile(args.input, np.uint8)
    t0 = time.perf_counter()
    codec = _make_codec(args, data, dev)
    comp = codec.encode(data)
    blob = _write_blob(args, comp)
    dt = time.perf_counter() - t0
    with open(args.output, "wb") as f:
        f.write(blob)
    print(f"Original size:   {data.size} bytes")
    print(f"Compressed size: {len(blob)} bytes")
    print(f"Ratio:           {100.0 * len(blob) / max(data.size, 1):.2f}%")
    print(f"Encode time:     {dt * 1e3:.1f} ms ({data.size / dt / 1e9:.3f} GB/s inc. fit+IO)")


def cmd_decode(args):
    from .io import container_kind, read_container, read_ils_container

    dev = _device(args)
    if args.stream:
        from .models import IlsCodec

        t0 = time.perf_counter()
        n = IlsCodec.decode_file(args.input, args.output, device=dev)
        dt = time.perf_counter() - t0
        print(f"Decompressed {n} bytes in {dt * 1e3:.1f} ms "
              f"({n / dt / 1e9:.3f} GB/s inc. IO, section-streamed)")
        return
    with open(args.input, "rb") as f:
        blob = f.read()
    fmt = args.format
    if fmt in ("yamamoto", "seq"):
        from .io.seqfmt import decode_seq
        from .io.yamamoto import decode_yamamoto

        t0 = time.perf_counter()
        out = _to_host(
            decode_seq(blob, device=dev)
            if fmt == "seq"
            else decode_yamamoto(blob, method=_method(args), device=dev)
        )
        dt = time.perf_counter() - t0
        out.tofile(args.output)
        print(f"Decompressed {out.size} bytes in {dt * 1e3:.1f} ms "
              f"({fmt} reference format)")
        return
    try:
        kind = container_kind(blob)
        if kind == "ils1":
            from .models import IlsCodec

            comp = read_ils_container(blob)
            codec = IlsCodec(comp.table, device=dev)
        else:
            from .models import GapArrayCodec

            comp = read_container(blob)
            codec = GapArrayCodec(
                comp.table, seg_bits=comp.seg_bits,
                block_bytes=comp.block_bytes, method=_method(args), device=dev,
            )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(1)
    t0 = time.perf_counter()
    out = _to_host(codec.decode(comp))  # the one copy back to the host
    dt = time.perf_counter() - t0
    out.tofile(args.output)
    print(f"Decompressed {out.size} bytes in {dt * 1e3:.1f} ms "
          f"({out.size / dt / 1e9:.3f} GB/s inc. host staging)")


def cmd_roundtrip(args):
    from .io import read_container, read_ils_container

    dev = _device(args)
    data = np.fromfile(args.input, np.uint8)
    codec = _make_codec(args, data, dev)
    blob = _write_blob(args, codec.encode(data))
    if args.format in ("yamamoto", "seq"):
        out = codec.decode(blob)
    elif args.format == "ils":
        out = codec.decode(read_ils_container(blob))
    else:
        out = codec.decode(read_container(blob))
    out = _to_host(out)
    ok = np.array_equal(out, data)
    print(f"Original size:   {data.size} bytes")
    print(f"Compressed size: {len(blob)} bytes "
          f"({100.0 * len(blob) / max(data.size, 1):.2f}%)")
    print(f"Verification:    {'PASS' if ok else 'FAIL'}")
    if not ok:
        bad = np.nonzero(out != data)[0]
        i = int(bad[0]) if bad.size else min(out.size, data.size)
        got = out[i] if i < out.size else None
        want = data[i] if i < data.size else None
        print(f"first difference at byte {i}: got {got}, expected {want}")
        sys.exit(1)


class BenchResult:
    """Times of one benchmarked call, printed as the JAX package's
    `utils.timing.BenchResult` prints them (GB/s at the upper median)."""

    def __init__(self, name: str, bytes_processed: int, times_s: list):
        self.name = name
        self.bytes_processed = bytes_processed
        self.times_s = times_s

    @property
    def gbps(self) -> float:
        med = sorted(self.times_s)[len(self.times_s) // 2]
        return self.bytes_processed / med / 1e9

    def __str__(self) -> str:
        best = self.bytes_processed / min(self.times_s) / 1e9
        return (f"{self.name}: {self.gbps:.3f} GB/s "
                f"(median of {len(self.times_s)}, best {best:.3f})")


def bench_fn(name, fn, bytes_processed, dev, *, warmup=2, repeat=5):
    """Time ``fn()`` after ``warmup`` calls: CUDA events around each call
    on a card, the host clock on the CPU."""

    def run_once():
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    for _ in range(warmup):
        run_once()
    times = [run_once() for _ in range(max(repeat, 1))]
    return BenchResult(name, bytes_processed, times)


def cmd_bench(args):
    from .utils import generate_redundant

    dev = _device(args)
    host = generate_redundant(args.size, args.redundancy, seed=args.seed)
    # the input stays on the device; the reference formats' writers are
    # host code and take it from there
    data = torch.from_numpy(host).to(dev)
    codec = _make_codec(args, host, dev)
    comp = codec.encode(data)
    enc = bench_fn("encode", lambda: codec.encode(data), host.size, dev,
                   warmup=args.warmup, repeat=args.repeat)
    dec = bench_fn("decode", lambda: codec.decode(comp), host.size, dev,
                   warmup=args.warmup, repeat=args.repeat)
    ok = bool(torch.equal(codec.decode(comp), data))
    print(enc)
    print(dec)
    print(f"verification: {'PASS' if ok else 'FAIL'}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="huffman_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("generate", help="write synthetic data (generate.cpp semantics)")
    p.add_argument("--size", type=int, required=True)
    p.add_argument("--redundancy", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-o", "--output", default="data.bin")
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser("encode", help="compress a file to an HTC1 container")
    p.add_argument("input")
    p.add_argument("-o", "--output", required=True)
    p.add_argument(
        "--stream", action="store_true",
        help="section-streamed encode with bounded host memory "
             "(ILS format; use --section-bytes to size sections)",
    )
    p.add_argument("--section-bytes", type=int, default=None)
    _add_codec_args(p)
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser("decode", help="decompress a container (auto-detects ILS1/HTC1)")
    p.add_argument("input")
    p.add_argument("-o", "--output", required=True)
    p.add_argument(
        "--stream", action="store_true",
        help="section-streamed decode with bounded host memory (ILS1)",
    )
    p.add_argument(
        "--method",
        choices=["auto", "lut", "canonical", "twolevel", "pallas"],
        default="auto",
        help="auto and pallas: the CUDA kernels",
    )
    p.add_argument(
        "--format", choices=["auto", "yamamoto", "seq"], default="auto",
        help="force a reference format (these have no magic bytes)",
    )
    _add_device_arg(p)
    p.set_defaults(fn=cmd_decode)

    p = sub.add_parser("roundtrip", help="encode+decode+verify a file")
    p.add_argument("input")
    _add_codec_args(p)
    p.set_defaults(fn=cmd_roundtrip)

    p = sub.add_parser("bench", help="throughput benchmark on synthetic data")
    p.add_argument("--size", type=int, default=1 << 28)
    p.add_argument("--redundancy", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--repeat", type=int, default=5)
    _add_codec_args(p)
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
