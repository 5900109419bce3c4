#!/usr/bin/env python3
"""Chip smoke test of huffman_tpu_torch: the ILS codec end to end on one GPU.

    python3 chip_smoke.py [--size BYTES] [--tail BYTES] [--redundancy R]

Needs one CUDA card and ``nvcc``; builds the kernels from ``huffman_tpu_torch/
csrc`` itself.  Imports no JAX and nothing of `huffman_tpu`.  Phases (any
failure raises and exits non-zero with the traceback):

1. Card: name and power limit (nvidia-smi), torch/CUDA versions, build time.
2. Kernels A1-A5 against their plain PyTorch versions on the card, bit for
   bit, on: 4 tiles at k=4096 of generate_redundant(r=0.5) with rotation
   off and on; the zeros-then-uniform input at k=256, e_band=8 (the "mu"
   anchor violates, "laggard" passes); a k=8 tail tile.
3. Container parity: for those inputs, and for the two-pass tier forced with
   stride_budget=0, the container bytes of the kernel path (device="cuda")
   equal those of the plain path (device="cpu"), and the card decodes them.
4. End to end at full size: --size bytes (default 256 MiB) of
   generate_redundant(--redundancy, default 0.5, seed=0) plus a --tail byte
   tail (default 777); --size 1073741824 with 0.9 or 0.1 gives the 1 GiB
   configurations of BASELINE.json:
   IlsCodec fit, encode, write_ils_container, read_ils_container, decode,
   bit-exact on the device, with the launch counters of that one run.  Then
   the kernels are held against their plain versions again at the shapes
   that run gave them and timed: ms is the kernel's own device time
   (torch.profiler), wrapper_ms, plain_ms and library_ms are CUDA-event
   times of whole calls.  Encode and decode are timed as the median of
   several runs after the warm-up run, and one run of each is profiled
   (device-busy share, top kernels).
5. One JSON line per kernel list (name, route, source, replaces, launches,
   max_abs_err, ms, wrapper_ms, plain_ms, bound_ms, bound_by, library_ms,
   at the shapes the main path gave each kernel; A4 and A5, which it gives
   only the small tail, also under "full_section" at the main section's
   shape, the two-pass tier's shape when a full section takes it), then the
   card line, then the device line last.

bound_ms is the larger of (bytes each input read once + each output written
once) / 3.35 TB/s and (integer ALU operations the algorithm needs on this
run's data) / 67 T/s, the H100 SXM's non-tensor peak (its int32 throughput
is at most that, so the bound stays a lower bound).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
KERNELS = {
    # wrapper name -> (source, TPU kernel it replaces)
    "ils_decode": ("huffman_tpu_torch/csrc/ils_decode.cu",
                   "huffman_tpu/ops/pallas/ils_kernels.py:1268"),
    "ils_pack_certify": ("huffman_tpu_torch/csrc/ils_encode.cu",
                         "huffman_tpu/ops/pallas/ils_kernels.py:605"),
    "ils_compact": ("huffman_tpu_torch/csrc/ils_compact.cu",
                    "huffman_tpu/ops/pallas/ils_kernels.py:1211"),
    "ils_lengths_pass": ("huffman_tpu_torch/csrc/ils_encode.cu",
                         "huffman_tpu/ops/pallas/ils_kernels.py:258"),
    "ils_pack": ("huffman_tpu_torch/csrc/ils_encode.cu",
                 "huffman_tpu/ops/pallas/ils_kernels.py:407"),
}
# wrapper name -> the kernel's name as the profiler reports it
SYMBOLS = {
    "ils_decode": "ils_decode_kernel",
    "ils_pack_certify": "ils_encode_kernel<true, true, false>",
    "ils_compact": "ils_compact_kernel",
    "ils_lengths_pass": "ils_encode_kernel<false, false, false>",
    "ils_pack": "ils_encode_kernel<true, false, true>",
}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiled(fn, reps=1):
    """`reps` calls of `fn` under torch.profiler: (wall ms of the calls,
    device events as (ms, count, name), largest first)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    # the first device event of a trace can go missing: a warm-up step of
    # one small op, whose events the schedule discards, takes that place
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, memsets, copies): the aten op
        # that launched a kernel reports the same device time again; the
        # step marker spans the whole step
        if str(getattr(e, "device_type", "")).split(".")[-1] != "CUDA" \
                or e.key.startswith("ProfilerStep"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    return wall_ms, sorted(rows, reverse=True)


def kernel_ms(fn, symbol, reps):
    """Device ms per launch of the kernel whose name holds `symbol`, over
    `reps` calls of its wrapper `fn` after a warm-up: the kernel alone,
    without the wrapper's host checks, allocation and zero fill."""
    fn()
    _, rows = profiled(fn, reps)
    hits = [(ms, count) for ms, count, key in rows if symbol in key]
    # the mean over the launches the profiler recorded: it may drop one
    launches = sum(count for _, count in hits)
    if not 0 < launches <= reps:
        raise AssertionError(f"profiler saw {launches} launches of {symbol} "
                             f"in {reps} calls")
    return sum(ms for ms, _ in hits) / launches


def device_profile(fn, label, tk, tries=3):
    """One profiled call of `fn`: wall ms, device-busy ms (sum of the
    device events' time) and the top device events (torch.profiler).

    The profiler can drop a kernel's event, which would undercount the busy
    time: the call is profiled again (up to `tries` times) until it
    records as many launches of the slice's kernels as their counters."""
    for _ in range(tries):
        before = sum(tk.launch_counts().values())
        wall_ms, rows = profiled(fn)
        launched = sum(tk.launch_counts().values()) - before
        seen = sum(count for _, count, key in rows
                   if any(sym in key for sym in SYMBOLS.values()))
        if seen == launched:
            break
        log(f"  profile {label}: the profiler recorded {seen} of {launched} "
            f"kernel launches")
    busy = sum(r[0] for r in rows)
    log(f"  profile {label}: wall {wall_ms:.3f} ms (profiler on), device busy "
        f"{busy:.3f} ms = {100 * busy / wall_ms:.1f}% of wall")
    for ms, count, key in rows[:8]:
        log(f"    {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "kernel_events": seen, "kernel_launches": launched,
            "top": [[key[:60], count, ms] for ms, count, key in rows[:5]]}


def max_abs_err(got, ref) -> int:
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    err = 0
    for a, b in zip(got, ref):
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            d = (a.to(torch.int64) - b.to(torch.int64)).abs().max()
            err = max(err, int(d))
    return err


class Stats:
    """Per-kernel parity and timing record."""

    def __init__(self):
        self.rows = {name: {"max_abs_err": 0, "checks": 0} for name in KERNELS}

    def check(self, name, got, ref, label):
        err = max_abs_err(got, ref)
        row = self.rows[name]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["checks"] += 1
        shape = tuple((got if isinstance(got, torch.Tensor) else got[0]).shape)
        log(f"  {name:17s} {label:30s} out{shape} equal={err == 0}")
        if err:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"on {label}: max |diff| {err}")


def timed(name, call, plain, reps, plain_reps=1, **extra):
    """Times of one kernel at one shape: `ms` the kernel alone on the device
    (profiler), `wrapper_ms` its wrapper call with the host checks and
    output allocation (CUDA events), `plain_ms` the plain version."""
    return dict(ms=kernel_ms(call, SYMBOLS[name], reps),
                wrapper_ms=cuda_ms(call, reps),
                plain_ms=cuda_ms(plain, plain_reps), **extra)


def kernel_cases(stats, tk, tils, words, codec, snum, k, rot, e_band, label,
                 timing=None):
    """Every kernel and its plain version on one input (CUDA tensors).

    With `timing` (a dict), also times each kernel and plain version and
    records the bytes and operations of this input for the bound."""
    table, enc, dec = codec.table, codec.enc, codec.dec
    n_tiles = words.shape[0] // (k // 4)
    ml = table.max_len_present
    # the tier arithmetic is the orchestration's own (ops/ils.py)
    stride_rows = tils.stride_rows_for(k, ml)
    n_sym = n_tiles * k * 1024
    n_body = n_sym // 4
    data_bytes = words.numel() * 4
    viols = {}
    for anchor in ("mu", "laggard"):
        kw = dict(k=k, stride_rows=stride_rows, rot=rot, e_band=e_band,
                  anchor=anchor)
        got = tk.ils_pack_certify(words, snum, enc, **kw)
        ref = tk.ils_pack_certify_plain(words, snum, enc, **kw)
        stats.check("ils_pack_certify", got, ref, f"{label} {anchor}")
        viols[anchor] = int(got[4].max())
    pay_s, bits, dn, dx, _ = got  # laggard anchor's outputs
    p = tils.envelope_params(bits, dn, dx, k=k, snum=snum, rot=rot)
    starts = tils.row_starts_of(p, words.device)
    if timing is not None:
        # A2 writes only its pairs (the tiles' w_tiles rows, total_rows in
        # all) and the per-lane outputs; the zero fill of the rest of the
        # strided buffer is the wrapper's, outside `ms`
        kw["anchor"] = "mu"
        timing["ils_pack_certify"] = timed(
            "ils_pack_certify",
            lambda: tk.ils_pack_certify(words, snum, enc, **kw),
            lambda: tk.ils_pack_certify_plain(words, snum, enc, **kw), 5,
            bytes=data_bytes + p.total_rows * 4096
            + sum(x.numel() * 4 for x in got[1:]),
            ops=8 * n_sym + 24 * n_body, shape=list(got[0].shape))
    compact = None
    if viols["laggard"] == 0:
        kw = dict(stride_rows=stride_rows, w_cap=p.w_cap, total_rows=p.total_rows)
        got = tk.ils_compact(pay_s, starts, **kw)
        stats.check("ils_compact", got,
                    tk.ils_compact_plain(pay_s, starts, **kw), label)
        compact = (got, starts, p)
        if timing is not None:
            # the one PyTorch call computing the same function: a row gather
            # (slack rows read a zero row of the strided slack)
            w_t = p.w_tiles.astype(np.int64)
            tile = np.repeat(np.arange(n_tiles), w_t)
            src = (tile * stride_rows + np.arange(p.total_rows)
                   - p.row_starts[:-1].astype(np.int64)[tile])
            src = np.concatenate([src, np.full(p.w_cap, n_tiles * stride_rows)])
            src = torch.from_numpy(src).to(words.device)
            lib = torch.index_select(pay_s, 0, src)
            if not torch.equal(lib, got):
                raise AssertionError("index_select yardstick differs from A3")
            timing["ils_compact"] = timed(
                "ils_compact", lambda: tk.ils_compact(pay_s, starts, **kw),
                lambda: tk.ils_compact_plain(pay_s, starts, **kw), 20, 3,
                library_ms=cuda_ms(lambda: torch.index_select(pay_s, 0, src), 20),
                bytes=(2 * p.total_rows + p.w_cap) * 4096, ops=0,
                shape=list(got.shape))
    got = tk.ils_lengths_pass(words, snum, enc, k=k, rot=rot)
    stats.check("ils_lengths_pass", got,
                tk.ils_lengths_pass_plain(words, snum, enc, k=k, rot=rot), label)
    bits, dn, dx, en, ex = got
    w_band_enc, boffs = tils.emission_band(en, ex)
    p2 = tils.envelope_params(bits, dn, dx, k=k, snum=snum, rot=rot,
                              extra_band_pairs=w_band_enc)
    boffs = torch.from_numpy(boffs).to(words.device)
    starts2 = tils.row_starts_of(p2, words.device)
    kw5 = dict(k=k, w_cap=p2.w_cap, w_band=w_band_enc, total_rows=p2.total_rows,
               rot=rot)
    rows = tk.ils_pack(words, snum, boffs, starts2, enc, **kw5)
    stats.check("ils_pack", rows,
                tk.ils_pack_plain(words, snum, boffs, starts2, enc, **kw5), label)
    # decode what the fused tier wrote when it certified, as the main path
    # does, else the two-pass payload
    pay, dstarts, pd = compact if compact is not None else (rows, starts2, p2)
    kw1 = dict(k=k, w_cap=pd.w_cap, n_tiles=n_tiles, max_len=max(ml, 1),
               min_len=max(table.min_len, 1), rot=rot)
    got = tk.ils_decode(pay, dstarts, dec, **kw1)
    stats.check("ils_decode", got, tk.ils_decode_plain(pay, dstarts, dec, **kw1),
                label)
    if not torch.equal(got, words):
        raise AssertionError(f"decode of {label} is not the input")
    if timing is not None:
        timing["ils_lengths_pass"] = timed(
            "ils_lengths_pass",
            lambda: tk.ils_lengths_pass(words, snum, enc, k=k, rot=rot),
            lambda: tk.ils_lengths_pass_plain(words, snum, enc, k=k, rot=rot), 5,
            bytes=data_bytes + sum(x.numel() * 4 for x in (bits, dn, dx, en, ex)),
            ops=3 * n_sym + 16 * n_body, shape=list(bits.shape))
        timing["ils_pack"] = timed(
            "ils_pack", lambda: tk.ils_pack(words, snum, boffs, starts2, enc, **kw5),
            lambda: tk.ils_pack_plain(words, snum, boffs, starts2, enc, **kw5), 5,
            bytes=data_bytes + p2.total_rows * 4096, ops=8 * n_sym + 12 * n_body,
            shape=list(rows.shape))
        levels = max(ml, 1) - max(table.min_len, 1)
        timing["ils_decode"] = timed(
            "ils_decode", lambda: tk.ils_decode(pay, dstarts, dec, **kw1),
            lambda: tk.ils_decode_plain(pay, dstarts, dec, **kw1), 5,
            bytes=pd.total_rows * 4096 + data_bytes,
            ops=(2 * levels + 10) * n_sym + 12 * n_body, shape=list(got.shape))
    return viols


def container_parity(tils, IlsCompressed, write, read, data, table, enc,
                     dec, k, avg, rot, label, **kw):
    """Container bytes of one section encoded on the card and on the CPU.
    Through `ils_encode_to_device`, which also takes the e_band override
    that `ils_encode_device` leaves out."""
    blobs = []
    for dev in ("cuda", "cpu"):
        words = torch.from_numpy(data.view(np.int32).reshape(-1, 1024).copy())
        rows, _, p = tils.ils_encode_to_device(
            words.to(dev), enc.to(dev), k=k, avg_bits=avg,
            max_len=table.max_len_present, rot=rot, **kw)
        sec = tils.IlsSection(params=p, payload=rows[: p.total_rows])
        blobs.append(write(IlsCompressed(table, data.size, [sec])))
    if blobs[0] != blobs[1]:
        raise AssertionError(f"container bytes differ between the kernel and "
                             f"the plain path on {label}")
    comp = read(blobs[0])
    out = tils.ils_decode_device(comp.sections[0], comp.table, dec, device="cuda")
    if not torch.equal(out, torch.from_numpy(data).cuda()):
        raise AssertionError(f"card decode of the {label} container failed")
    p = comp.sections[0].params
    log(f"  container {label:28s} {len(blobs[0])} bytes equal=True "
        f"w_band={p.w_band} w_cap={p.w_cap} rot={p.rot}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=1 << 28,
                    help="bytes of the end-to-end input before the tail")
    ap.add_argument("--tail", type=int, default=777)
    ap.add_argument("--redundancy", type=float, default=0.5,
                    help="share of the end-to-end input drawn from 'A'..'D'")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2

    from huffman_tpu_torch import IlsCodec, IlsCompressed
    from huffman_tpu_torch.core.ils_ref import ILS_LANES, ils_schedule_numer
    from huffman_tpu_torch.io import read_ils_container, write_ils_container
    from huffman_tpu_torch.ops import cuda_build
    from huffman_tpu_torch.ops import ils as tils
    from huffman_tpu_torch.ops import ils_kernels as tk
    from huffman_tpu_torch.utils import generate_redundant

    # ---- 1. card and build
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    cuda_build.load_kernels()
    log(f"build {time.perf_counter() - t0:.1f} s (nvcc, one process per source)")

    stats = Stats()
    dev = torch.device("cuda")

    def case(data, k):
        codec = IlsCodec.fit(data, k=k, device="cuda")
        avg = codec._avg_bits(torch.from_numpy(data))
        words = torch.from_numpy(data.view(np.int32).reshape(-1, ILS_LANES)
                                 .copy()).to(dev)
        return codec, avg, ils_schedule_numer(avg), words

    # ---- 2 + 3. kernels vs plain, container bytes kernel path vs plain path
    log("phase 2+3: small inputs")
    k = 4096
    r05 = generate_redundant(4 * k * ILS_LANES, 0.5, seed=1)
    het = np.zeros(256 * ILS_LANES, np.uint8)
    het[het.size // 2:] = generate_redundant(het.size // 2, 0.0, seed=17)
    tail = np.zeros(8 * ILS_LANES, np.uint8)
    tail[:777] = generate_redundant(777, 0.5, seed=3)
    for data, kk, rot, e_band, label, policy in (
        (r05, 4096, False, None, "4x k=4096 r=0.5", {}),
        (r05, 4096, True, None, "4x k=4096 r=0.5 rot", {}),
        (r05, 4096, False, None, "4x k=4096 two-pass", {"stride_budget": 0}),
        (het, 256, False, 8, "zeros|uniform k=256 e_band=8", {"e_band": 8}),
        (tail, 8, False, None, "k=8 tail tile", {}),
    ):
        codec, avg, snum, words = case(data, kk)
        if "stride_budget" not in policy:  # same data as the first case
            viols = kernel_cases(stats, tk, tils, words, codec, snum, kk, rot,
                                 e_band or tils.fused_e_band(kk), label)
            if e_band == 8 and viols != {"mu": 1, "laggard": 0}:
                raise AssertionError(f"anchor flags on {label}: {viols}")
        container_parity(
            tils, IlsCompressed, write_ils_container, read_ils_container, data,
            codec.table, codec.enc, codec.dec, kk, avg, rot, label, **policy)

    # ---- 4. end to end at full size
    log(f"phase 4: {args.size} + {args.tail} bytes, "
        f"generate_redundant(r={args.redundancy}, seed=0)")
    n = args.size + args.tail
    host = generate_redundant(n, args.redundancy, seed=0)
    data = torch.from_numpy(host).to(dev)
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    codec = IlsCodec.fit(host, device="cuda")
    comp = codec.encode(data)
    blob = write_ils_container(comp)
    comp2 = read_ils_container(blob)
    out = codec.decode(comp2)
    ok = torch.equal(out, data)
    torch.cuda.synchronize()
    launches = tk.launch_counts()
    log(f"  round trip {time.perf_counter() - t0:.2f} s bit-exact={ok} "
        f"k={codec.k} sections={[(s.params.k, s.params.n_tiles, s.params.rot, s.params.w_band, s.params.w_cap) for s in comp.sections]}")
    log(f"  container {len(blob)} bytes, ratio {len(blob) / n:.6f}")
    log(f"  launches in that run: {launches}")
    if not ok:
        raise AssertionError("end-to-end round trip is not bit-exact")
    missing = [name for name, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    log("phase 4b: kernels vs plain at the main path's shapes, timed")
    timing: dict = {}
    main_sec = comp.sections[0]
    k = main_sec.params.k
    tile_bytes = k * ILS_LANES
    main_bytes = main_sec.params.n_tiles * tile_bytes
    chunk = data[:main_bytes]
    snum = ils_schedule_numer(codec._avg_bits(chunk))
    kernel_cases(stats, tk, tils, chunk.view(torch.int32).view(-1, ILS_LANES),
                 codec, snum, k, main_sec.params.rot, tils.fused_e_band(k),
                 f"main {main_sec.params.n_tiles}x k={k}", timing)
    main_timing = {name: timing[name] for name in
                   ("ils_decode", "ils_pack_certify", "ils_compact")
                   if name in timing}
    # A4 and A5 at the full section: the shape of the two-pass tier when a
    # section's anchors both violate or its stride exceeds the budget
    section_timing = {name: timing[name]
                      for name in ("ils_lengths_pass", "ils_pack")}
    if n % tile_bytes:
        tail_sec = comp.sections[-1]
        kt = tail_sec.params.k
        padded = torch.zeros(kt * ILS_LANES, dtype=torch.uint8, device=dev)
        padded[: n % tile_bytes] = data[n - n % tile_bytes:]
        timing = {}
        kernel_cases(stats, tk, tils, padded.view(torch.int32).view(-1, ILS_LANES),
                     codec, ils_schedule_numer(codec._avg_bits(padded)), kt,
                     tail_sec.params.rot, tils.fused_e_band(kt),
                     f"tail 1x k={kt}", timing)
        main_timing["ils_lengths_pass"] = timing["ils_lengths_pass"]
        main_timing["ils_pack"] = timing["ils_pack"]

    enc_ms = [cuda_ms(lambda: codec.encode(data), 1) for _ in range(3)]
    dec_ms = [cuda_ms(lambda: codec.decode(comp), 1) for _ in range(5)]
    enc_med, dec_med = statistics.median(enc_ms), statistics.median(dec_ms)
    prof = {"encode": device_profile(lambda: codec.encode(data), "encode", tk),
            "decode": device_profile(lambda: codec.decode(comp), "decode", tk)}
    log(f"  encode ms {[round(x, 3) for x in enc_ms]} median {enc_med:.3f} "
        f"= {n / enc_med / 1e6:.3f} GB/s")
    log(f"  decode ms {[round(x, 3) for x in dec_ms]} median {dec_med:.3f} "
        f"= {n / dec_med / 1e6:.3f} GB/s")

    # ---- 5. results
    def times(t):
        b_ms = t.get("bytes", 0) / HBM_BYTES_PER_S * 1e3
        o_ms = t.get("ops", 0) / ALU_OPS_PER_S * 1e3
        return {"shape": t.get("shape"), "ms": t.get("ms"),
                "wrapper_ms": t.get("wrapper_ms"), "plain_ms": t.get("plain_ms"),
                "bound_ms": max(b_ms, o_ms),
                "bound_by": "bytes" if b_ms >= o_ms else "operations",
                "library_ms": t.get("library_ms")}

    log(f"per kernel at the main path's shapes ({card}):")
    rows = []
    for name, (source, replaces) in KERNELS.items():
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": stats.rows[name]["max_abs_err"],
               "checks": stats.rows[name]["checks"],
               **times(main_timing.get(name, {}))}
        if name in section_timing:
            row["full_section"] = times(section_timing[name])
        rows.append(row)
        for label, t in (("", row), (" full section", row.get("full_section"))):
            if t is not None:
                log(f"  {name + label:30s} out{tuple(t['shape'] or ())} "
                    f"equal={row['max_abs_err'] == 0} kernel_ms={t['ms']} "
                    f"wrapper_ms={t['wrapper_ms']} plain_ms={t['plain_ms']} "
                    f"bound_ms={t['bound_ms']} ({t['bound_by']}) "
                    f"launches={launches[name]}"
                    + ("" if t["library_ms"] is None
                       else f" library_ms={t['library_ms']}"))
    log(json.dumps({
        "e2e": {"bytes": n, "encode_ms_median": enc_med,
                "decode_ms_median": dec_med,
                "encode_gbps": n / enc_med / 1e6,
                "decode_gbps": n / dec_med / 1e6,
                "container_bytes": len(blob), "card": card,
                "profile": prof},
    }))
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
