#!/usr/bin/env python3
"""Chip smoke test of huffman_tpu_torch: the ILS and HTC1 codecs, the ILS
file path, the foreign-stream (Yamamoto, self-sync) decoders, the
command line and the multi-device paths end to end on one GPU.

    python3 chip_smoke.py [--size BYTES] [--tail BYTES] [--redundancy R]
                          [--gap-block BYTES] [--fuzz-seed S] [--fuzz-iters N]

Needs one CUDA card and ``nvcc``; builds the kernels from ``huffman_tpu_torch/
csrc`` itself.  Imports no JAX and nothing of `huffman_tpu`.  Phases (any
failure raises and exits non-zero with the traceback):

1. Card: name and power limit (nvidia-smi), torch/CUDA versions, build time,
   and what ptxas reported for every kernel (registers, static shared
   memory, stack and spill bytes), with the geometry of B4b, B4c, B1 (both
   forms), C2, B2 and A2 (`row_pack_tile`, `meta_tile`, `ranks_tile`,
   `sync_tile`, `place_tile`, `certify_chunks`), B4d's rows a warp,
   A1's length-and-symbol table, A5's grid, A4's (tile, chunk) grid at
   the shapes below, C1's count table and H1's counters, a line each for
   those thirteen.
2. Kernels A1-A5 against their plain PyTorch versions on the card, bit for
   bit, on: 4 tiles at k=4096 of generate_redundant(r=0.5) with rotation
   off and on (A2 in its chunks, `certify_chunks`); the zeros-then-uniform
   input at k=256, e_band=8 (the "mu" anchor violates, "laggard" passes);
   a k=8 tail tile.  A4 also hands its chunk bits to A5 there, as the
   two-pass tier does, and both are held to the plain versions.
3. Container parity: for those inputs, and for the two-pass tier forced with
   stride_budget=0, the container bytes of the kernel path (device="cuda")
   equal those of the plain path (device="cpu"), and the card decodes them.
4. End to end at full size: --size bytes (default 256 MiB) of
   generate_redundant(--redundancy, default 0.5, seed=0) plus a --tail byte
   tail (default 777); --size 1073741824 with 0.9 or 0.1 gives the 1 GiB
   configurations of BASELINE.json:
   IlsCodec fit, encode, write_ils_container, read_ils_container, decode,
   bit-exact on the device, with the launch counters of that one run
   (the byte histogram H1, `byte_counts`, once a section of the encode).
   Then the kernels are held against their plain versions again at the
   shapes that run gave them and timed (H1 on each section's bytes, and
   at 10^9 B on one constant byte, r=0.9, r=0.1 and uniform bytes, made
   on the card, where its time must not depend on the data:
   HIST_SKEW_MAX): ms is the kernel's own device time, the sum of its
   kernels per wrapper call where it launches two (A2 at more
   than one chunk a stream; each under "ms_parts") (torch.profiler; where
   every trace lost its launches, CUDA events around its wrapper, and
   ms_by says "cuda_events"), wrapper_ms, plain_ms and
   library_ms are CUDA-event times of whole calls.  Encode and decode are timed as the median of
   several runs after the warm-up run, and one run of each is profiled
   (device-busy share, top kernels).
4c. The same input through IlsCodec.fit(optimize="ratio") (its k, 8192
   on the default input, puts the main section's stride over the fused
   tier's budget): fit, encode, write, read, decode, bit-exact, with the
   launch counters of that run, which must show the two-pass tier (A4
   and A5 launched, A2 not); k, stride_rows, the container bytes and
   ratio; A4 and A5 held against their plain versions at its main
   section's shape and timed; encode and decode timed (medians of 3 and
   5) and profiled once.  Phase 4b also holds A4 to its plain version at
   the file path's first attempt on this input (one tile at
   k = 4 * ceil(n / 4096), 262,148 by default; the plain version takes
   about a minute there and is timed by that one call).
5. HTC1 kernels B1 (its rank and its placing form), B2, B4b-B4d against
   their plain versions, bit for bit, on multi-block groups of generate_redundant(r=0.1, 0.5, 0.9), a
   one-symbol input and the uniform 256-symbol input at seg_bits 128, 1024
   and 4096; the HTC1 container bytes of the kernel path equal the plain
   path's on those and on a ragged tail.
6. HTC1 end to end on the input of phase 4: GapArrayCodec fit, encode
   (16 MiB blocks through the kernels as one device group, the tail
   through them as a group of its own, with its byte count),
   write_container, read_container, decode, bit-exact, with the gap
   kernels' launch counters of that one run (B4b-B4d and B1's placing
   form once a group, the tail's included; B1's rank form and B2 never).
   Then every gap kernel is held against its plain
   version on the groups that run gave it (the full blocks, the tail), at
   its shapes, and timed.
7. The JAX package's HTC1 bench shape: one --gap-block byte block (default
   64 MiB, the first 64 MiB of phase 4's input) at seg_bits=1024 through
   one encode_device and decode_device with the launch counters of that
   call, medians by CUDA events, one profiled call each, and every gap
   kernel held against its plain version and timed at its shapes there.
7b. Blocks that are no multiple of 128 bytes: the first 64 MiB as 67
   blocks of 1,000,000 B through one encode_device (B4b-B4d once each,
   with the byte counts), equal to the loop of encode_block over them (the
   route before), decoded back; the kernels held against their plain
   versions and timed there; that encode_device and that loop, and phase
   6's tail through encode_device and encode_block, timed (medians of 5
   by CUDA events), under "ragged" in the summary line.
8. Foreign streams, small inputs: C1 (count_segments) and C2
   (sync_transitions) against their plain versions on the card, bit for
   bit, on generate_redundant(r=0.1, 0.5, 0.9), a one-symbol stream, the
   uniform 256-symbol input and a max_len=16 table, each with a partial
   last segment and subsequence; decode_yamamoto and decode_seq give the
   same bytes on the card as on the CPU; a Yamamoto container built from
   one GapArrayCodec.encode_device block at seg_bits=128 equals
   write_yamamoto's bytes.
9. Yamamoto end to end: the first 128 MiB (at most --size bytes) of
   phase 4's input as one such container (the device encoder builds it;
   the host NumPy writer is far slower at this size), read_yamamoto,
   decode_yamamoto on the card, bit-exact, with the launch counters of
   that run (C1, B1, B2).  The device-resident decode (parse excluded) is
   timed as the median of 5 runs and profiled once; C1, B1 and B2 are
   held against their plain versions and timed at its shapes.
10. Self-sync end to end: the same stream's words and bit count through
   selfsync_decode_device (C2, the composition scan, B1 + B2), bit-exact,
   with its launch counters, timed and profiled the same way; C2, B1 and
   B2 held against their plain versions and timed there, the scan timed
   apart.  Then C2 on as many bytes of the uniform 256-symbol input (8-bit
   codes: entries at offsets that differ mod 8 never meet), held against
   its plain version and timed, on a line of its own and under
   "selfsync"."uniform_c2".
11. The portability path, small inputs: the encode map B5 against its
   plain version on the card, bit for bit, on generate_redundant(r=0.1,
   0.5, 0.9), a one-symbol input, the uniform 256-symbol input, a max_len=16
   table and a block holding bytes its table lacks; encode_block_fast equals
   encode_block there (seg_bits 128 and 1024); the step decoders (lut,
   canonical, twolevel) return each decodable input and count the
   encoder's counts at seg_bits=128; the streaming fused pack
   (ils_pack_certify_stream, D1, on A2's kernel) at k=256, chunk_cap=8,
   stride_rows=128 under both anchors equals its plain version and
   ils_pack_certify (bits, envelopes, flags, rows [0, w_tile)); B2 on a
   ragged placement (the chunk-shared TPU placement D3's function); with
   PREFER_STREAM_PACK on, an ILS section of 2 tiles at k=8192 (16 MiB of
   r=0.5) gives the same container bytes on the card as on the CPU, and
   whether they equal the flag-off bytes is logged.
12. The portability path at phase 7's block: encode_block_fast with
   encode_device's max_words and n_segs equals encode_device's four
   outputs (B5's launches of that one counted call), timed (median of 3
   after a warm-up), B5 held against its plain version and timed there;
   GapArrayCodec(method=m).decode_device for lut, canonical and twolevel,
   bit-exact, timed and profiled; decode_yamamoto(method="lut",
   "canonical") on phase 9's container, bit-exact, timed once, and
   method="twolevel" raising as in the JAX package.
13. The ILS file path, in a temporary directory the phase removes:
   (a) phase 4's input written as a file through IlsCodec.fit_file,
   encode_file (default SECTION_BYTES: the ragged file is one tile whose
   k halves, rounded up to a multiple of 4, until it fits the row
   budget), decode_file and a comparison with the input, and
   read_ils_container + IlsCodec.decode of the same container, with the
   k_sec of every attempt, the sections' (k, n_tiles, w_cap) and the
   launch counters of the encode and the decode; encode_file and
   decode_file timed by the host clock (disk included; medians of 3, one
   profiled call each) beside the disk, host-to-device and device-to-host
   times of the same bytes measured apart; (b) the same file at
   section_bytes = 64 MiB (whole sections at k=4096, A2 + A3, and the
   777-byte tail at k=8, A4 + A5), round trip as in (a); (d) the same at
   a chosen k = 16388 (4 times an odd number, over the row budget): the
   whole-tile sections before the last retry unpadded at a multiple of 4
   that divides them, round trip as in (a) (run before (c)); (c) the
   first 20 MiB + 777 B as a file encoded on the card and on the CPU:
   equal container bytes.
14. The command line (`huffman_tpu_torch.cli.main`, in process, in a
   temporary directory the phase removes), each command with the launch
   counts set to 0 just before it and read just after, failing where its
   path's kernels were not launched (PATH_KERNELS): generate (equal to
   phase 4's input); encode and decode --format ils (the file equals phase
   4's container) and htc1 (phase 6's); yamamoto and seq on the first 128
   MiB, each file equal to write_yamamoto / write_seq called with the
   table the CLI fits (package_merge_lengths of the histogram, 16 bits);
   encode and decode --stream (equal to phase 13a's container); roundtrip
   (PASS); bench at 256 MiB, 5 runs, its medians logged beside phase 4's;
   the native host module's histogram of the input against torch.bincount
   on the card; one `python -m huffman_tpu_torch.cli --help` subprocess.
   Every decode must give the input back; every command's host-clock ms is
   logged with the card's name and power limit.
15. The multi-device paths (`huffman_tpu_torch.parallel`, `parallel_phase`):
   (a) nccl at world 1 on this card, at phase 4's main section (its
   tiles at its k, without the tail): the certified sharded encode and
   its decode (equal to the codec's section and to ils_encode_to_device's,
   bit-exact), the full-band round trip (rot=True), the collective
   histogram (equal to torch.bincount) and the HTC1 block round trip on
   the first 64 MiB as 16 blocks of 4 MiB (seg_bits=1024, "lut"), with
   the launch counts of those calls (A1, A2, A3, A5 and the sharded
   encode's B4b-B4d must launch); A5 and
   A1 at the full-band shape held against their plain versions and
   timed; the sharded encode, decode and round trip timed beside the
   single-device calls (medians of 5 by CUDA events).  (b) gloo, two
   spawned ranks on this card (each joining through init_multihost's JAX
   call form, "127.0.0.1:port"), through dryrun_multichip at 2 x 32 MiB of
   ILS (8 tiles a rank at k=4096) and 2 x 4 blocks of 4 MiB, with its
   fault checks: the rank-ordered certified section equals
   ils_encode_to_device's on the same 64 MiB, every decode bit-exact,
   each rank's launches of A1, A2, A3, A5 and B4b-B4d.
15c. The differential fuzz soak (`tools/fuzz_torch.py`, `fuzz_phase`):
   --fuzz-iters cases (default FUZZ_ITERS) of --fuzz-seed (default 0) at
   the tool's defaults (up to 8 MiB a case, the 15th of every 16 up to 64
   MiB; a secondary case every fourth, its five kinds in turn).  Every
   case is bit-exact on the card, its container bytes equal the CPU's
   (the plain versions), and the ILS section and HTC1 blocks equal the
   NumPy oracles; a divergence raises the tool's reproducer line.  The
   launch counts are set to 0 first; each wrapper's launches, the cases
   it ran in and the distinct case shapes (the tool's `SHAPE_KEYS`) are
   logged, and a wrapper of KERNELS that ran in fewer than FUZZ_MIN_CASES
   cases fails the phase.
15d. The flagship entry point (`huffman_tpu_torch.graft_entry.entry()`,
   `entry_phase`), the counterpart of the JAX package's
   `__graft_entry__.entry()`: one ILS decode step, A1, on a section of
   k=256 and 4 tiles of generate_redundant(r=0.5, seed=0), on the card.
   Its words must equal the data's and the plain version's
   (`entry(device="cpu")`'s step on the same arguments moved to the CPU);
   A1's launch count must rise by one per call.  The step's median of 5
   calls by CUDA events is logged beside the card's name and power limit.
16. One JSON line per kernel list (name, route, source, replaces, launches,
   max_abs_err, ms, ms_by, wrapper_ms, plain_ms, bound_ms, bound_by,
   library_ms):
   each kernel's launches in its codec's end-to-end run (phase 4 or 6)
   beside its times at that run's shapes; A4 and A5, which phase 4 gives
   only the small tail, also under "full_section" at the main section's
   shape (the two-pass tier's shape when a full section takes it) and
   under "ratio_section" at phase 4c's main section, A4 under
   "file_first_attempt" at phase 4b's one tile (the two-kernel form's
   own floor, where the bits kernel reads all chunks but the last a
   second time, is logged beside each A4 check, not listed), A1, B1
   and B2 also under "tail" at the tail's, B4b-B4d also under "tail" and
   "ragged_blocks" (phase 7b's shape); C1's launches are phase 9's,
   C2's phase 10's, B5's phase 12's.  The TPU kernels whose function a
   kernel here computes are under its "also_replaces" (B3, B4a, D1, D3).
   The bench shape's rows, with phase 7's launches, go in the summary line
   before it under "htc1"."kernels", phase 11-12's results under
   "portable", phase 4c's under "ratio", and B1/B2/C1/C2 at the foreign
   paths' shapes under
   "yamamoto"."kernels" and "selfsync"."kernels", phase 13's under "file",
   phase 14's under "cli", phase 15's under "parallel", phase 15c's
   under "fuzz" (and each kernel's row its own "fuzz"), phase 15d's under
   "entry" (and A1's row its own "entry": plain_ms there is the CPU's).
   A5 and A1 also
   carry "full_band" (phase 15a's shape) and, with A2, A3 and B4b-B4d,
   their phase-15 launches ("parallel_launches").  The rows of A1, A2,
   A4, A5, B1, B2, B4b-B4d, C1, C2 and H1 also carry their "ptxas" report;
   H1's row carries "tail" and the four inputs of 10^9 B
   ("bytes_1e9_<input>").  Then the card
   line, then the device line last.

bound_ms is the larger of (bytes each input read once + each output written
once) / 3.35 TB/s and (integer ALU operations the algorithm needs on this
run's data) / 67 T/s, the H100 SXM's non-tensor peak (its int32 throughput
is at most that, so the bound stays a lower bound).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# phase 15c's default count of fuzz cases
FUZZ_ITERS = 64
# H1's largest time on one constant byte over its time on uniform bytes
HIST_SKEW_MAX = 1.3
# H1's inputs of 10^9 B: (label, share of the bytes on 'A'-'D'); None is
# one constant byte
HIST_INPUTS = (("constant", None), ("r09", 0.9), ("r01", 0.1),
               ("uniform", 0.0))
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
    "gap_decode_ranks": ("huffman_tpu_torch/csrc/gap_decode.cu",
                         "huffman_tpu/ops/pallas/decode_kernel.py:154"),
    "gap_place_bytes": ("huffman_tpu_torch/csrc/gap_decode.cu",
                        "huffman_tpu/ops/pallas/compact_kernel.py:78"),
    # B1's placing form, B2 folded in: the codecs' decode path
    "gap_decode_bytes": ("huffman_tpu_torch/csrc/gap_decode.cu",
                         "huffman_tpu/ops/pallas/decode_kernel.py:154"),
    "gap_row_pack": ("huffman_tpu_torch/csrc/gap_encode.cu",
                     "huffman_tpu/ops/pallas/gap_encode_kernel.py:112"),
    "gap_row_meta": ("huffman_tpu_torch/csrc/gap_encode.cu",
                     "huffman_tpu/ops/pallas/gap_encode_kernel.py:252"),
    "gap_place_bits": ("huffman_tpu_torch/csrc/gap_encode.cu",
                       "huffman_tpu/ops/pallas/gap_encode_kernel.py:291"),
    "count_segments": ("huffman_tpu_torch/csrc/gap_decode.cu",
                       "huffman_tpu/ops/pallas/decode_kernel.py:325"),
    "sync_transitions": ("huffman_tpu_torch/csrc/selfsync.cu",
                         "huffman_tpu/ops/pallas/selfsync_kernels.py:42"),
    "encode_map": ("huffman_tpu_torch/csrc/encode_map.cu",
                   "huffman_tpu/ops/pallas/encode_kernel.py:39"),
    # H1: no TPU kernel; the JAX package's histogram is an XLA scatter-add
    "byte_counts": ("huffman_tpu_torch/csrc/byte_histogram.cu", "none"),
}
HTC1 = ("gap_decode_ranks", "gap_place_bytes", "gap_decode_bytes",
        "gap_row_pack", "gap_row_meta", "gap_place_bits")
# the HTC1 kernels that the codecs' paths launch; B1's rank form and B2 run
# only where called directly (D3's form, the plain reference's parts), so
# no fuzz case launches them
HTC1_PATH = ("gap_decode_bytes", "gap_row_pack", "gap_row_meta",
             "gap_place_bits")
OFF_PATH = tuple(name for name in HTC1 if name not in HTC1_PATH)
GAP_ENCODE = ("gap_row_pack", "gap_row_meta", "gap_place_bits")
# TPU kernels whose work a kernel here does: relayouts folded into its
# addressing (B3, B4a), and VMEM-bound variants of its function (D1, the
# streaming fused pack; D3, the chunk-shared placement)
FOLDED = {
    "ils_pack_certify": ["huffman_tpu/ops/pallas/ils_kernels.py:878"],
    "gap_decode_ranks": ["huffman_tpu/ops/pallas/compact_kernel.py:410"],
    "gap_place_bytes": ["huffman_tpu/ops/pallas/compact_kernel.py:249"],
    "gap_decode_bytes": ["huffman_tpu/ops/pallas/compact_kernel.py:78",
                         "huffman_tpu/ops/pallas/compact_kernel.py:410"],
    "gap_row_pack": ["huffman_tpu/ops/pallas/gap_encode_kernel.py:201",
                     "huffman_tpu/ops/pallas/compact_kernel.py:410"],
}
# wrapper name -> the names of its kernels as the profiler reports them;
# the last one is launched once per wrapper call, an earlier one at most
# once (A2's, A4's and A5's bits kernel, where a stream has more than one
# chunk, and A5's only where it was not handed A4's chunk bits;
# C1's table kernel, where the code has more than one length)
A2_KERNELS = ("ils_certify_bits_kernel", "ils_pack_certify_kernel")
A4_KERNELS = ("ils_certify_bits_kernel", "ils_lengths_kernel")
A5_KERNELS = ("ils_certify_bits_kernel", "ils_pack_kernel")
C1_KERNELS = ("gap_count_table_kernel", "gap_count_segments_kernel")
SYMBOLS = {
    "ils_decode": ("ils_decode_kernel",),
    "ils_pack_certify": A2_KERNELS,
    "ils_compact": ("ils_compact_kernel",),
    "ils_lengths_pass": A4_KERNELS,
    "ils_pack": A5_KERNELS,
    "gap_decode_ranks": ("gap_decode_ranks_kernel",),
    "gap_place_bytes": ("gap_place_bytes_kernel",),
    "gap_decode_bytes": ("gap_decode_bytes_kernel",),
    "gap_row_pack": ("gap_row_pack_kernel",),
    "gap_row_meta": ("gap_row_meta_kernel",),
    "gap_place_bits": ("gap_place_bits_kernel",),
    "count_segments": C1_KERNELS,
    "sync_transitions": ("sync_transitions_kernel",),
    "encode_map": ("encode_map_kernel",),
    "byte_counts": ("byte_histogram_kernel",),
    # D1 launches A2's kernels
    "ils_pack_certify_stream": A2_KERNELS,
}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def sync():
    torch.cuda.synchronize()


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
        # the active step can lose its first device event too (a kernel
        # that opens the measured call): a one-element fill opens it
        torch.zeros(1, device="cuda")
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


def kernel_ms(fn, symbols, reps, tries=3):
    """(ms, source, parts): device ms per call of the wrapper `fn` spent in
    the kernels whose names hold `symbols` (each launched once a call),
    over `reps` calls after a warm-up, the kernels alone, without the
    wrapper's host checks, allocation and zero fill ("profiler"); parts
    gives each kernel's ms per launch.

    The profiler can drop some, and now and then all, of a trace's device
    events: a trace that recorded no launch of a kernel is taken again (up
    to `tries` traces); where every trace lost some, the wrapper calls are
    timed by CUDA events instead ("cuda_events", which adds the wrapper's
    own device work, if any)."""
    fn()
    for _ in range(tries):
        _, rows = profiled(fn, reps)
        parts = {}
        for symbol in symbols:
            hits = [(ms, count) for ms, count, key in rows if symbol in key]
            # the mean over the launches the profiler recorded
            launches = sum(count for _, count in hits)
            if not 0 < launches <= reps:
                log(f"  profiler saw {launches} launches of {symbol} in "
                    f"{reps} calls")
                break
            parts[symbol] = sum(ms for ms, _ in hits) / launches
        else:
            return sum(parts.values()), "profiler", parts
    log(f"  {symbols}: timed by CUDA events around the wrapper instead")
    return cuda_ms(fn, reps), "cuda_events", None


def device_profile(fn, label, launch_counts, tries=3):
    """One profiled call of `fn`: wall ms, device-busy ms (sum of the
    device events' time) and the top device events (torch.profiler).

    The profiler can drop a kernel's event, which would undercount the busy
    time: the call is profiled again (up to `tries` times) until it
    records as many launches of the slice's kernels as their counters."""
    for _ in range(tries):
        before = launch_counts()
        wall_ms, rows = profiled(fn)
        launched = {name: c - before[name] for name, c in launch_counts().items()}
        seen = {name: sum(count for _, count, key in rows
                          if SYMBOLS[name][-1] in key)
                for name in launched}
        lost = sorted(name for name in launched if seen[name] < launched[name])
        if not lost:
            break
        log(f"  profile {label}: the profiler recorded {sum(seen.values())} of "
            f"{sum(launched.values())} kernel launches, lost {lost}")
    busy = sum(r[0] for r in rows)
    log(f"  profile {label}: wall {wall_ms:.3f} ms (profiler on), device busy "
        f"{busy:.3f} ms = {100 * busy / wall_ms:.1f}% of wall")
    for ms, count, key in rows[:8]:
        log(f"    {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "kernel_events": sum(seen.values()),
            "kernel_launches": sum(launched.values()), "lost": lost,
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


def timed(name, call, plain, reps, plain_reps=1, symbols=None, **extra):
    """Times of one kernel at one shape: `ms` the kernel alone on the device
    (profiler; `ms_by` says when CUDA events had to stand in), its kernels
    summed where the call launches `symbols` (default all of SYMBOLS[name]),
    `wrapper_ms` its wrapper call with the host checks and output
    allocation (CUDA events), `plain_ms` the plain version."""
    ms, ms_by, parts = kernel_ms(call, symbols or SYMBOLS[name], reps)
    return dict(ms=ms, ms_by=ms_by, wrapper_ms=cuda_ms(call, reps),
                plain_ms=cuda_ms(plain, plain_reps),
                **({"ms_parts": parts} if parts and len(parts) > 1 else {}),
                **extra)


def time_plain_once(plain):
    """(result, ms) of one call of a plain version (host clock,
    synchronised), for shapes where it takes seconds: its check's call
    also gives its time."""
    t0 = time.perf_counter()
    ref = plain()
    sync()
    return ref, (time.perf_counter() - t0) * 1e3


def timed_kernel(name, call, plain_ms, reps, symbols=None, **extra):
    """`timed` for a kernel whose plain version was timed once apart."""
    ms, ms_by, parts = kernel_ms(call, symbols or SYMBOLS[name], reps)
    return dict(ms=ms, ms_by=ms_by, wrapper_ms=cuda_ms(call, reps),
                plain_ms=plain_ms,
                **({"ms_parts": parts} if parts and len(parts) > 1 else {}),
                **extra)


def histogram_case(stats, hk, data, label, timing=None):
    """H1 and its plain version (`torch.bincount`, also the library op)
    on one uint8 tensor on the card, exact; with `timing`, also timed:
    the input read once and the 2 KiB of counts written once."""
    got = hk.byte_counts(data)
    stats.check("byte_counts", got, hk.byte_counts_plain(data), label)
    if timing is not None:
        t = timed("byte_counts", lambda: hk.byte_counts(data),
                  lambda: hk.byte_counts_plain(data), 10, 3,
                  bytes=data.numel() + got.numel() * 8, ops=0,
                  shape=list(got.shape))
        t["library_ms"] = t["plain_ms"]
        timing["byte_counts"] = t


def histogram_inputs(stats, hk, n, dev, card):
    """H1 on `HIST_INPUTS` of `n` bytes each, made on the card from a
    fixed seed (the generator's data: each byte one of 'A'-'D' with
    probability r, else uniform); returns {label: timing}.  Its time on
    the constant byte must stay within HIST_SKEW_MAX of the uniform's."""
    out = {}
    for label, r in HIST_INPUTS:
        g = torch.Generator(device=dev).manual_seed(19)
        if r is None:
            x = torch.full((n,), ord("A"), dtype=torch.uint8, device=dev)
        else:
            x = torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                              generator=g)
            if r:
                hot = torch.rand(n, device=dev, generator=g) < r
                abcd = torch.randint(ord("A"), ord("D") + 1, (n,),
                                     dtype=torch.uint8, device=dev,
                                     generator=g)
                x = torch.where(hot, abcd, x)
                del hot, abcd
        timing = {}
        histogram_case(stats, hk, x, f"{label} {n} B", timing)
        out[label] = timing["byte_counts"]
        del x
        torch.cuda.empty_cache()
    skew = out["constant"]["ms"] / out["uniform"]["ms"]
    log(f"  byte_counts at {n} B: " + ", ".join(
        f"{label} {t['ms']:.4f} ms ({t['ms_by']}, plain {t['plain_ms']:.3f})"
        for label, t in out.items())
        + f"; constant / uniform {skew:.3f} ({card})")
    if skew > HIST_SKEW_MAX:
        raise AssertionError(f"byte_counts: constant / uniform {skew:.3f} "
                             f"> {HIST_SKEW_MAX}")
    return out


def chunk_kernels(tk, k, kernels=A2_KERNELS):
    """A2's (or A5's) kernels of one call at k: the bits kernel too where
    a stream has more than one chunk."""
    return kernels if tk.certify_chunks(k)[0] > 1 else kernels[1:]


def two_pass_cases(stats, tk, tils, words, codec, snum, k, rot, label,
                   timing=None):
    """The two-pass tier's kernels A4 and A5 and their plain versions on
    one input (CUDA tensors), at the shapes `ils_encode_to_device` gives
    them, A5 handed A4's chunk bits as the tier does; returns (A5's
    payload, its row starts, the params).  With `timing`, also times both
    and records the bytes and operations."""
    enc = codec.enc
    got = tk.ils_lengths_pass(words, snum, enc, k=k, rot=rot, chunk_bits=True)
    bits, dn, dx, en, ex, cbits = got
    lengths_case(stats, tk, words, snum, enc, k, rot, got, label, timing)
    w_band_enc, boffs = tils.emission_band(en, ex)
    p2 = tils.envelope_params(bits, dn, dx, k=k, snum=snum, rot=rot,
                              extra_band_pairs=w_band_enc)
    boffs = torch.from_numpy(boffs).to(words.device)
    starts2 = tils.row_starts_of(p2, words.device)
    kw5 = dict(k=k, w_cap=p2.w_cap, w_band=w_band_enc, total_rows=p2.total_rows,
               rot=rot)
    rows = tk.ils_pack(words, snum, boffs, starts2, enc, cbits=cbits, **kw5)
    stats.check("ils_pack", rows,
                tk.ils_pack_plain(words, snum, boffs, starts2, enc, **kw5), label)
    if not torch.equal(rows, tk.ils_pack(words, snum, boffs, starts2, enc,
                                         **kw5)):
        raise AssertionError(f"ils_pack with A4's chunk bits differs on {label}")
    if timing is not None:
        # per symbol a lookup and add, the code's insert and the pair's
        # store; the bits kernel does not run (A4's chunk bits)
        n_sym = words.numel() * 4
        timing["ils_pack"] = timed(
            "ils_pack", lambda: tk.ils_pack(words, snum, boffs, starts2, enc,
                                            cbits=cbits, **kw5),
            lambda: tk.ils_pack_plain(words, snum, boffs, starts2, enc, **kw5), 5,
            symbols=A5_KERNELS[1:],
            bytes=n_sym + cbits.numel() * 4 + p2.total_rows * 4096,
            ops=8 * n_sym + 3 * n_sym, shape=list(rows.shape))
    return rows, starts2, p2


def lengths_case(stats, tk, words, snum, enc, k, rot, got, label, timing=None,
                 plain_once=False):
    """A4's outputs `got` (with its chunk bits) against the plain versions;
    with `timing`, its times.  The bound reads the data once.  The log
    line also gives the two-kernel form's own floor, which reads every
    chunk but the last twice (the bits kernel, then the walk) and writes
    and reads the chunk bits once; it is not the bound.  `plain_once`
    takes the
    plain version's time from the one call of the check (host clock,
    synchronised) where a call takes long."""
    ref, plain_ms = time_plain_once(
        lambda: tk.ils_lengths_pass_plain(words, snum, enc, k=k, rot=rot))
    stats.check("ils_lengths_pass", got[:5], ref, label)
    if not torch.equal(got[5], tk.ils_chunk_bits_plain(words, enc, k=k,
                                                       rot=rot)):
        raise AssertionError(f"A4's chunk bits differ on {label}")
    if timing is None:
        return
    # per symbol a lookup and add, and the refill and emission envelopes
    # per body
    n_sym = words.numel() * 4
    chunks = tk.certify_chunks(k)[0]
    out_bytes = sum(x.numel() * 4 for x in got)
    call = (lambda: tk.ils_lengths_pass(words, snum, enc, k=k, rot=rot,
                                        chunk_bits=True))
    if not plain_once:
        t = timed("ils_lengths_pass", call,
                  lambda: tk.ils_lengths_pass_plain(words, snum, enc, k=k,
                                                    rot=rot), 5,
                  symbols=chunk_kernels(tk, k, A4_KERNELS))
    else:
        t = timed_kernel("ils_lengths_pass", call, plain_ms, 5,
                         symbols=chunk_kernels(tk, k, A4_KERNELS))
    floor_bytes = (n_sym * (2 * chunks - 1) // chunks + out_bytes
                   + got[5].numel() * 4)
    t.update(bytes=n_sym + out_bytes - got[5].numel() * 4,
             ops=3 * n_sym + 4 * n_sym, shape=list(got[0].shape))
    log(f"  A4 {label}: {chunks} chunks a stream, kernel_ms={t['ms']}; "
        f"two-kernel floor {floor_bytes / HBM_BYTES_PER_S * 1e3} ms "
        "(not the bound)")
    timing["ils_lengths_pass"] = t


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
            symbols=chunk_kernels(tk, k), bytes=data_bytes + p.total_rows * 4096
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
    rows, starts2, p2 = two_pass_cases(stats, tk, tils, words, codec, snum, k,
                                       rot, label, timing)
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
        levels = max(ml, 1) - max(table.min_len, 1)
        timing["ils_decode"] = timed(
            "ils_decode", lambda: tk.ils_decode(pay, dstarts, dec, **kw1),
            lambda: tk.ils_decode_plain(pay, dstarts, dec, **kw1), 5,
            bytes=pd.total_rows * 4096 + data_bytes,
            ops=(2 * levels + 10) * n_sym + 12 * n_body, shape=list(got.shape))
    return viols


def container_parity(tils, IlsCompressed, write, read, data, table, enc,
                     dec, k, avg, rot, label, devices=("cuda", "cpu"), **kw):
    """Container bytes of one section encoded on the card and on the CPU
    (or on the `devices` given); returns the card's bytes and params.
    Through `ils_encode_to_device`, which also takes the e_band override
    that `ils_encode_device` leaves out."""
    blobs = []
    for dev in devices:
        words = torch.from_numpy(data.view(np.int32).reshape(-1, 1024).copy())
        rows, _, p = tils.ils_encode_to_device(
            words.to(dev), enc.to(dev), k=k, avg_bits=avg,
            max_len=table.max_len_present, rot=rot, **kw)
        sec = tils.IlsSection(params=p, payload=rows[: p.total_rows])
        blobs.append(write(IlsCompressed(table, data.size, [sec])))
    if blobs[0] != blobs[-1]:
        raise AssertionError(f"container bytes differ between the kernel and "
                             f"the plain path on {label}")
    comp = read(blobs[0])
    out = tils.ils_decode_device(comp.sections[0], comp.table, dec, device="cuda")
    if not torch.equal(out, torch.from_numpy(data).cuda()):
        raise AssertionError(f"card decode of the {label} container failed")
    p = comp.sections[0].params
    log(f"  container {label:28s} {len(blobs[0])} bytes "
        f"{'equal=True' if len(blobs) > 1 else '(card only)'} "
        f"w_band={p.w_band} w_cap={p.w_cap} rot={p.rot}")
    return blobs[0], p


def gap_encode_cases(stats, ge, codec, blocks, label, timing=None):
    """The HTC1 encode kernels and their plain versions on one (G, B)
    group of blocks on the card, at the shapes `encode_device` gives them
    (B no multiple of 128: the blocks zero-padded to whole rows, B4b and
    B4c with the byte counts); returns its `DeviceCompressed`.

    With `timing` (a dict), also times each kernel and plain version and
    records the bytes and operations of this input for the bound."""
    g, b = blocks.shape
    n = g * b
    rows_b = -(-b // 128)
    nb = None
    if b % 128:
        nb = torch.full((g,), b, dtype=torch.int32, device=blocks.device)
        rows = torch.nn.functional.pad(blocks, (0, rows_b * 128 - b))
    else:
        rows = blocks
    rows = rows.view(torch.int32).view(-1, 32)
    max_len = max(codec.table.max_len_present, 1)
    pk = dict(cap_words=ge.row_cap_words(max_len), n_bytes=nb)
    got = ge.gap_row_pack(rows, codec.enc, **pk)
    stats.check("gap_row_pack", got,
                ge.gap_row_pack_plain(rows, codec.enc, **pk), label)
    pay, bits = got
    bits_blk = bits.view(g, -1).to(torch.int64)
    s_local = (torch.cumsum(bits_blk, 1) - bits_blk).reshape(-1)
    dcomp = codec.encode_device(blocks)
    mk = dict(rows_per_block=rows_b, n_segs=dcomp.counts.shape[1],
              seg_bits=codec.seg_bits, n_bytes=nb)
    got = ge.gap_row_meta(rows, codec.enc, s_local, max_len=max_len, **mk)
    stats.check("gap_row_meta", got,
                ge.gap_row_meta_plain(rows, codec.enc, s_local, **mk), label)
    if not torch.equal(got[0], dcomp.counts):
        raise AssertionError(f"gap_row_meta counts of {label} differ from "
                             f"encode_device's")
    bk = dict(rows_per_block=rows_b, out_words=dcomp.words.shape[1])
    got = ge.gap_place_bits(pay, bits, s_local, **bk)
    stats.check("gap_place_bits", got,
                ge.gap_place_bits_plain(pay, bits, s_local, **bk), label)
    if not torch.equal(got, dcomp.words):
        raise AssertionError(f"gap_place_bits of {label} differs from "
                             f"encode_device's words")
    if timing is not None:
        # bytes each kernel itself must move (not the wrappers' zero fills)
        # and integer operations per symbol, from this input
        pay_bytes = int(dcomp.total_bits.to(torch.int64).sum()) // 8
        timing["gap_row_pack"] = timed(
            "gap_row_pack", lambda: ge.gap_row_pack(rows, codec.enc, **pk),
            lambda: ge.gap_row_pack_plain(rows, codec.enc, **pk), 10,
            bytes=n + pay.numel() * 4 + bits.numel() * 4,
            ops=8 * n, shape=list(pay.shape))
        # B4c reads the input bytes (its starts are derived, not stored)
        timing["gap_row_meta"] = timed(
            "gap_row_meta",
            lambda: ge.gap_row_meta(rows, codec.enc, s_local,
                                    max_len=max_len, **mk),
            lambda: ge.gap_row_meta_plain(rows, codec.enc, s_local, **mk), 10,
            bytes=n + s_local.numel() * 8 + dcomp.counts.numel() * 8,
            ops=3 * n, shape=list(dcomp.counts.shape))
        timing["gap_place_bits"] = timed(
            "gap_place_bits", lambda: ge.gap_place_bits(pay, bits, s_local, **bk),
            lambda: ge.gap_place_bits_plain(pay, bits, s_local, **bk), 10,
            bytes=2 * pay_bytes + bits.numel() * 12, ops=2 * pay_bytes,
            shape=list(dcomp.words.shape))
    return dcomp


def gap_decode_cases(stats, gd, codec, plan, pay_bits, expect, label,
                     timing=None):
    """The HTC1 decode kernels and their plain versions on one group on
    the card, at the shapes of `plan` = (words, gaps, counts, max_count),
    the inputs `decode` (`GapArrayCodec.decode_plan`) or `decode_device`
    (`decode_device_plan`) hand them, with whether the counts are in
    range; `expect` is the (G, out_size) input and `pay_bits` the group's
    payload bits (for the bound)."""
    words, gaps, counts, mc, in_range = plan
    g, out_size = expect.shape
    n = g * out_size
    lim, bias = gd.kernel_tabs(codec.dec)
    dk = dict(seg_bits=codec.seg_bits, max_count=mc, min_len=codec.spec.min_len,
              max_len=codec.spec.max_len)
    ranks = gd.gap_decode_ranks(words, gaps, counts, lim, bias, **dk)
    stats.check("gap_decode_ranks", ranks,
                gd.gap_decode_ranks_plain(words, gaps, counts, lim, bias, **dk),
                label)
    flat = counts.reshape(-1)
    offs = torch.cumsum(flat, 0, dtype=torch.int64) - flat
    sym = codec.dec.symtab
    out = gd.gap_place_bytes(ranks, flat, offs, sym, n_out=n)
    stats.check("gap_place_bytes", out,
                gd.gap_place_bytes_plain(ranks, flat, offs, sym, n_out=n), label)
    if not torch.equal(out.view(g, out_size), expect):
        raise AssertionError(f"HTC1 decode of {label} is not the input")
    placed = gd.gap_decode_bytes(words, gaps, counts, offs, lim, bias, sym,
                                 n_out=n, counts_in_range=in_range, **dk)
    stats.check("gap_decode_bytes", placed, out, label)
    if timing is None:
        return
    levels = codec.spec.max_len - codec.spec.min_len
    timing["gap_decode_ranks"] = timed(
        "gap_decode_ranks",
        lambda: gd.gap_decode_ranks(words, gaps, counts, lim, bias, **dk),
        lambda: gd.gap_decode_ranks_plain(words, gaps, counts, lim, bias, **dk),
        10, bytes=pay_bits // 8 + gaps.numel() * 8 + ranks.numel(),
        ops=(2 * levels + 8) * n, shape=list(ranks.shape))
    timing["gap_place_bytes"] = timed(
        "gap_place_bytes",
        lambda: gd.gap_place_bytes(ranks, flat, offs, sym, n_out=n),
        lambda: gd.gap_place_bytes_plain(ranks, flat, offs, sym, n_out=n), 10,
        bytes=2 * n + flat.numel() * 12, ops=2 * n, shape=[n])
    timing["gap_decode_bytes"] = timed(
        "gap_decode_bytes",
        lambda: gd.gap_decode_bytes(words, gaps, counts, offs, lim, bias, sym,
                                    n_out=n, counts_in_range=in_range, **dk),
        lambda: gd.gap_decode_bytes_plain(words, gaps, counts, offs, lim,
                                          bias, sym, n_out=n, **dk),
        10, bytes=pay_bits // 8 + gaps.numel() * 16 + n,
        ops=(2 * levels + 8) * n, shape=[n])


def gap_container_parity(GapArrayCodec, write, read, data, block_bytes,
                         seg_bits, label):
    """HTC1 container bytes of one input encoded on the card and on the
    CPU; the card decodes them."""
    kw = dict(seg_bits=seg_bits, block_bytes=block_bytes)
    blobs = [write(GapArrayCodec.fit(data, device=dev, **kw).encode(data))
             for dev in ("cuda", "cpu")]
    if blobs[0] != blobs[1]:
        raise AssertionError(f"HTC1 container bytes differ between the kernel "
                             f"and the plain path on {label}")
    out = GapArrayCodec.fit(data, device="cuda", **kw).decode(read(blobs[0]))
    if not torch.equal(out, torch.from_numpy(data).cuda()):
        raise AssertionError(f"card decode of the {label} HTC1 container failed")
    log(f"  container {label:28s} {len(blobs[0])} bytes equal=True")


def skew16_input(table_from_length_sequence, n, seed):
    """A max_len=16 table (lengths 1..15, then 16 twice, the two 16-bit
    codes tied against symbol order) and n bytes drawn from it."""
    syms = np.r_[np.arange(40, 55), 56, 55].astype(np.uint8)
    lens = np.r_[np.arange(1, 16), 16, 16]
    p = 2.0 ** -np.arange(1, 18)
    rng = np.random.default_rng(seed)
    data = syms[rng.choice(17, size=n, p=p / p.sum())]
    return data, table_from_length_sequence(syms, lens)


def yamamoto_via_device(GapArrayCodec, yamamoto_bytes, table, data):
    """The Yamamoto container of `data` (uint8, on the card) from one
    GapArrayCodec.encode_device block at seg_bits=128, whose payload words
    and gaps are the container's.  Returns (blob, words as int32 where
    `data` lies, total_bits)."""
    codec = GapArrayCodec(table, seg_bits=128, block_bytes=data.numel(),
                          device=data.device)
    dcomp = codec.encode_device(data.view(1, -1))
    tb = int(dcomp.total_bits[0])
    words = dcomp.words[0, : -(-tb // 32)]
    gaps = dcomp.gaps[0, : -(-tb // 128)]
    blob = yamamoto_bytes(table, words.cpu().numpy().view(np.uint32),
                          gaps.cpu().numpy(), data.numel())
    return blob, words, tb


def count_cases(stats, gd, dec, spec, words, gaps, label, timing=None):
    """C1 and its plain version on one Yamamoto stream on the card, against
    the format's word-count bound (as `decode_yamamoto` runs it); returns
    the counts."""
    lim = gd.kernel_tabs(dec)[0]
    kw = dict(seg_bits=128, total_bits=words.numel() * 32,
              min_len=spec.min_len, max_len=spec.max_len)
    got = gd.count_segments(words, gaps, lim, **kw)
    stats.check("count_segments", got,
                gd.count_segments_plain(words, gaps, lim, **kw), label)
    if timing is not None:
        # the payload and the gaps read once, the counts written; per
        # codeword counted, the compare chain, the shift and the refill
        levels = spec.max_len - spec.min_len
        timing["count_segments"] = timed(
            "count_segments", lambda: gd.count_segments(words, gaps, lim, **kw),
            lambda: gd.count_segments_plain(words, gaps, lim, **kw), 10,
            symbols=C1_KERNELS[spec.min_len == spec.max_len:],
            bytes=words.numel() * 4 + gaps.numel() * 8,
            ops=(2 * levels + 6) * int(got.sum()), shape=list(got.shape))
    return got


def transition_cases(stats, gd, sk, dec, spec, words, total_bits, label,
                     timing=None):
    """C2 and its plain version on one raw stream on the card, at the
    subsequences `selfsync_decode_device` gives it; returns the
    transitions."""
    lim = gd.kernel_tabs(dec)[0]
    kw = dict(total_bits=total_bits, seg_bits=1024,
              n_subseq=-(-total_bits // 1024), min_len=spec.min_len,
              max_len=spec.max_len)
    got = sk.sync_transitions(words, lim, **kw)
    stats.check("sync_transitions", got,
                sk.sync_transitions_plain(words, lim, **kw), label)
    if timing is not None:
        # the payload read once, 16 ints written per subsequence; the
        # operations of one walk of the stream (entry 0's counts): the 16
        # walks of a subsequence merge after a few codewords, so the
        # function needs little more than that one walk
        levels = spec.max_len - spec.min_len
        walked = int((got[0] & 0xFFFF).sum(dtype=torch.int64))
        timing["sync_transitions"] = timed(
            "sync_transitions", lambda: sk.sync_transitions(words, lim, **kw),
            lambda: sk.sync_transitions_plain(words, lim, **kw), 10,
            bytes=total_bits // 8 + got.numel() * 4,
            ops=(2 * levels + 6) * walked, shape=list(got.shape))
    return got


def portable_cases(stats, ns, data, table, label, dev, decodable=True):
    """The portability path on one small input on the card: B5 and its
    plain version, encode_block_fast against encode_block at seg_bits 128
    and 1024, and, where the table holds every byte of the input, the step
    decoders (decode_block returns the input, count_segments the encoder's
    counts at seg_bits=128)."""
    em, tenc, step, tk, tt = ns.em, ns.tenc, ns.step, ns.tk, ns.tt
    d = torch.from_numpy(data).to(dev)
    enc = tk.ils_enc_tabs(table, device=dev)
    stats.check("encode_map", em.encode_map(d, enc), em.encode_map_plain(d, enc),
                label)
    dec, spec = tt.device_dec_table(table, device=dev), tt.dec_spec(table)
    total = int(table.lengths.astype(np.int64)[data].sum())
    for seg_bits in (128, 1024):
        kw = dict(seg_bits=seg_bits, max_words=-(-total // 32),
                  n_segs=max(-(-total // seg_bits), 1))
        fast = tenc.encode_block_fast(d, enc, **kw)
        ref = tenc.encode_block(d, enc, **kw)
        if not all(torch.equal(a, b) for a, b in zip(fast, ref)):
            raise AssertionError(f"encode_block_fast of {label} at seg_bits="
                                 f"{seg_bits} differs from encode_block")
        if not decodable:
            continue
        words, tb, gaps, counts = ref
        for m in ("lut", "canonical", "twolevel"):
            out = step.decode_block(words, gaps, counts, dec, spec=spec,
                                    seg_bits=seg_bits,
                                    max_count=int(counts.max()),
                                    out_size=d.numel(), method=m)
            if not torch.equal(out, d):
                raise AssertionError(f"{m} decode_block of {label} at seg_bits="
                                     f"{seg_bits} is not the input")
            if seg_bits == 128:
                got = step.count_segments(
                    words, gaps, int(tb), dec, spec=spec, seg_bits=128,
                    max_count=128 // spec.min_len + 1, method=m)
                if not torch.equal(got, counts):
                    raise AssertionError(f"{m} count_segments of {label} "
                                         f"differs from the encoder's counts")
    log(f"  portable {label:22s} {data.size} B: encode_map == plain, "
        f"encode_block_fast == encode_block"
        + (", lut/canonical/twolevel decode and count exact" if decodable
           else " (bytes outside the table: not decoded)"))


def ils_case(ns, data, k, dev):
    """(IlsCodec, avg bits, schedule numerator, (rows, 1024) int32 words on
    dev) of one ILS input, as the main path fits it."""
    codec = ns.IlsCodec.fit(data, k=k, device=dev)
    avg = codec._avg_bits(torch.from_numpy(data))
    words = torch.from_numpy(data.view(np.int32).reshape(-1, 1024).copy())
    return codec, avg, ns.ils_schedule_numer(avg), words.to(dev)


def portable_small(stats, ns, dev):
    """Phase 11: the portability path's kernels and functions on small
    inputs on the card.  Returns the D1 and D3 timings and the summary of
    the streaming tier's container check."""
    log("phase 11: the portability path, small inputs")
    tk, gd = ns.tk, ns.gd
    gen = ns.generate_redundant
    skew, skew_table = skew16_input(ns.table_from_length_sequence, 65536, 52)
    lacks = gen(65536, 0.5, seed=53)
    lacks_table = ns.GapArrayCodec.fit(np.where(lacks >= 200, 65, lacks)
                                       .astype(np.uint8), device="cpu").table
    lacks[100:104] = [200, 201, 250, 255]  # one group of absent bytes only
    for label, small, table, decodable in (
        ("r=0.1", gen(65536, 0.1, seed=54), None, True),
        ("r=0.5", gen(65536, 0.5, seed=55), None, True),
        ("r=0.9", gen(65536, 0.9, seed=56), None, True),
        ("one symbol", np.full(65536, 9, np.uint8), None, True),
        ("uniform 256", np.arange(65536, dtype=np.uint8), None, True),
        ("max_len=16", skew, skew_table, True),
        ("bytes the table lacks", lacks, lacks_table, False),
    ):
        if table is None:
            table = ns.GapArrayCodec.fit(small, device="cpu").table
        portable_cases(stats, ns, small, table, label, dev, decodable)

    # D1 on A2's kernel, at tests/test_ils.py's streaming shape
    k, stride = 256, 128
    codec, _, snum, words = ils_case(ns, gen(2 * k * 1024, 0.5, seed=21), k,
                                     dev)
    for anchor in ("mu", "laggard"):
        kw = dict(k=k, stride_rows=stride, chunk_cap=8, anchor=anchor)
        got = tk.ils_pack_certify_stream(words, snum, codec.enc, **kw)
        stats.check("ils_pack_certify", got,
                    tk.ils_pack_certify_stream_plain(words, snum, codec.enc, **kw),
                    f"stream k={k} chunk_cap=8 {anchor}")
        a2 = tk.ils_pack_certify(words, snum, codec.enc, k=k,
                                 stride_rows=stride, anchor=anchor)
        same = all(torch.equal(a, b) for a, b in zip(got[1:], a2[1:]))
        w_t = [2 * (-(-int(got[1][t].max()) // 64)) for t in range(2)]
        for t in range(2):
            rows = slice(t * stride, t * stride + w_t[t])
            same = same and torch.equal(got[0][rows], a2[0][rows])
        if not same:
            raise AssertionError(f"ils_pack_certify_stream ({anchor}) differs "
                                 f"from ils_pack_certify")
    n_sym = 2 * k * 1024
    d1 = timed(
        "ils_pack_certify_stream",
        lambda: tk.ils_pack_certify_stream(words, snum, codec.enc, **kw),
        lambda: tk.ils_pack_certify_stream_plain(words, snum, codec.enc, **kw),
        10, symbols=chunk_kernels(tk, k),
        bytes=n_sym + sum(w_t) * 4096 + sum(x.numel() * 4 for x in got[1:]),
        ops=8 * n_sym + 24 * n_sym // 4, shape=list(got[0].shape))
    log(f"  ils_pack_certify_stream == plain == ils_pack_certify on its "
        f"contract, both anchors")

    # D3's function is B2's: a ragged placement of 65536 segments
    rng = np.random.default_rng(57)
    counts = rng.integers(0, 101, 65536)
    counts[rng.random(65536) < 0.1] = 0
    ranks = torch.from_numpy(rng.integers(0, 256, (65536, 104), dtype=np.uint8)
                             ).to(dev)
    flat = torch.from_numpy(counts.astype(np.int32)).to(dev)
    offs = torch.cumsum(flat, 0, dtype=torch.int64) - flat
    sym = torch.from_numpy(rng.permutation(256).astype(np.int32)).to(dev)
    n = int(counts.sum())
    stats.check("gap_place_bytes", gd.gap_place_bytes(ranks, flat, offs, sym,
                                                      n_out=n),
                gd.gap_place_bytes_plain(ranks, flat, offs, sym, n_out=n),
                "ragged 65536 segments")
    d3 = timed(
        "gap_place_bytes",
        lambda: gd.gap_place_bytes(ranks, flat, offs, sym, n_out=n),
        lambda: gd.gap_place_bytes_plain(ranks, flat, offs, sym, n_out=n),
        10, bytes=2 * n + flat.numel() * 12, ops=2 * n, shape=[n])

    # the streaming tier, flag on and off, on 2 tiles at k=8192
    data = gen(2 * 8192 * 1024, 0.5, seed=51)
    codec, avg, _, _ = ils_case(ns, data, 8192, dev)
    parity = (ns.tils, ns.IlsCompressed, ns.write_ils, ns.read_ils, data,
              codec.table, codec.enc, codec.dec, 8192, avg, False)
    tk.reset_launch_counts()
    ns.tils.PREFER_STREAM_PACK = True
    try:
        on, p_on = container_parity(*parity, "2x k=8192 stream tier")
    finally:
        ns.tils.PREFER_STREAM_PACK = False
    tier = tk.launch_counts()
    if not tier["ils_pack_certify_stream"] or tier["ils_pack"]:
        raise AssertionError(f"the flag-on section did not take the streaming "
                             f"tier: {tier}")
    # the flag-off tier (two-pass) is held against its plain version in
    # phase 3; its bytes are needed here, from the card alone
    off, p_off = container_parity(*parity, "2x k=8192 flag off",
                                  devices=("cuda",))
    log(f"  flag-on launches {tier}; "
        f"flag-on container == flag-off container: {on == off} "
        f"(w_cap {p_on.w_cap} / {p_off.w_cap}, w_band {p_on.w_band} / "
        f"{p_off.w_band}, {len(on)} / {len(off)} bytes)")
    summary = {
        "d1": {"case": f"2x k={k} chunk_cap=8 stride_rows={stride}"},
        "d3": {"case": f"B2 on a ragged placement of 65536 segments, {n} B"},
        "stream_flag": {
            "bytes": int(data.size), "equal": on == off,
            "on": {"container_bytes": len(on), "w_cap": p_on.w_cap,
                   "w_band": p_on.w_band},
            "off": {"container_bytes": len(off), "w_cap": p_off.w_cap,
                    "w_band": p_off.w_band}}}
    return {"d1": d1, "d3": d3, "summary": summary}


def host_ms(fn) -> float:
    """Host-clock ms of one call of `fn` (which ends on the host)."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def host_io_ms(path, out_bytes, dev):
    """Host-clock ms of the data movement of one file-path call, measured
    apart: reading `path` from disk and moving its bytes host to device,
    then moving `out_bytes` device to host and writing them to disk
    (pageable memory, synchronised)."""
    t0 = time.perf_counter()
    arr = np.fromfile(path, np.uint8)
    read_ms = (time.perf_counter() - t0) * 1e3
    sync()
    t0 = time.perf_counter()
    torch.from_numpy(arr).to(dev)
    sync()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    on_dev = torch.zeros(out_bytes, dtype=torch.uint8, device=dev)
    sync()
    t0 = time.perf_counter()
    buf = on_dev.cpu().numpy()
    d2h_ms = (time.perf_counter() - t0) * 1e3
    out = path + ".w"
    t0 = time.perf_counter()
    with open(out, "wb") as f:
        f.write(buf.data)
    write_ms = (time.perf_counter() - t0) * 1e3
    os.unlink(out)
    return {"in_bytes": int(arr.size), "read_ms": read_ms, "h2d_ms": h2d_ms,
            "out_bytes": out_bytes, "d2h_ms": d2h_ms, "write_ms": write_ms}


def file_phase(host, data, tk, IlsCodec, read_ils_container, card,
               section_bytes=64 << 20, parity_bytes=(20 << 20) + 777,
               chosen_k=16388):
    """Phase 13: the ILS file path (fit_file, encode_file, decode_file) on
    phase 4's input written as a file, in a temporary directory that the
    phase removes: (a) at the default SECTION_BYTES, (b) at
    `section_bytes`, (d) at `section_bytes` with k = `chosen_k`, 4 times
    an odd number over the row budget, (c) the first `parity_bytes`
    encoded on the card and on the CPU.  Returns the summary."""
    import huffman_tpu_torch.models.ils_codec as ils_codec_mod

    n = host.size
    dev = data.device
    tmp = tempfile.mkdtemp(prefix="chip_smoke_file_")
    src, ils, out = (os.path.join(tmp, f) for f in ("src.bin", "a.ils",
                                                     "out.bin"))
    attempts = []
    real = ils_codec_mod.ils_encode_device

    def record(buf, *a, k, **kw):
        attempts.append(k)
        return real(buf, *a, k=k, **kw)

    def round_trip(label, section_bytes=None, check=None, k=None):
        """fit_file, encode_file, decode_file with the launch counts of
        each; the decoded file and a whole-buffer decode of the container
        must be the input."""
        attempts.clear()
        sync()
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        codec = IlsCodec.fit_file(src, device="cuda", k=k)
        fit_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        size = codec.encode_file(src, ils, section_bytes=section_bytes)
        enc_ms = (time.perf_counter() - t0) * 1e3
        enc_launches = tk.launch_counts()
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        got = IlsCodec.decode_file(ils, out)
        dec_ms = (time.perf_counter() - t0) * 1e3
        dec_launches = tk.launch_counts()
        ok = got == n and np.array_equal(np.fromfile(out, np.uint8), host)
        with open(ils, "rb") as f:
            raw = f.read()
        comp = read_ils_container(raw)
        whole = torch.equal(codec.decode(comp), data)
        secs = [(q.params.k, q.params.n_tiles, q.params.w_cap)
                for q in comp.sections]
        log(f"  {label}: k={codec.k} attempts k_sec={attempts} sections "
            f"(k, n_tiles, w_cap)={secs} container {size} bytes")
        log(f"  {label}: fit_file {fit_ms:.1f} ms, encode_file {enc_ms:.1f} "
            f"ms, decode_file {dec_ms:.1f} ms (host clock, disk included); "
            f"decoded file bit-exact={ok}, read_ils_container + decode "
            f"bit-exact={whole}")
        log(f"  {label}: launches encode_file {enc_launches}, decode_file "
            f"{dec_launches}")
        if not (ok and whole):
            raise AssertionError(f"file path {label}: round trip not bit-exact")
        if any(k % 4 for k, _, _ in secs):
            raise AssertionError(f"file path {label}: k not a multiple of 4")
        if not dec_launches["ils_decode"]:
            raise AssertionError(f"file path {label}: A1 not launched")
        check(enc_launches, secs)
        return codec, {"k": codec.k, "attempts": list(attempts),
                       "sections": secs, "container_bytes": size,
                       "sha256": hashlib.sha256(raw).hexdigest(),
                       "fit_ms": fit_ms, "encode_ms": enc_ms,
                       "decode_ms": dec_ms, "encode_launches": enc_launches,
                       "decode_launches": dec_launches}

    def ragged(enc_launches, secs):
        # the attempts before the last fail the row budget on the two-pass
        # tier (A4), the last takes a tier (A5, or A2 + A3 where its stride
        # is within the budget); the halvings round up where plain halving
        # leaves k % 4 != 0 (F9)
        f9 = [a for a, b in zip(attempts, attempts[1:])
              if (a // 2) % 4 and b == -(-a // 8) * 4]
        if len(attempts) < 2 or not f9:
            raise AssertionError(f"no F9 rounding in the attempts {attempts}")
        if (enc_launches["ils_lengths_pass"] < len(attempts) - 1
                or not (enc_launches["ils_pack"]
                        or enc_launches["ils_compact"])):
            raise AssertionError(f"file path: A4/A5 launches {enc_launches}")

    def sections64(enc_launches, secs):
        # whole sections at the codec's k (A2 + A3), the tail at k=8
        if (len(secs) != -(-n // section_bytes) or secs[-1][:2] != (8, 1)
                or not enc_launches["ils_pack_certify"]
                or not enc_launches["ils_compact"]
                or not enc_launches["ils_lengths_pass"]
                or not enc_launches["ils_pack"]):
            raise AssertionError(f"64 MiB sections: {secs} {enc_launches}")

    def unpadded(enc_launches, secs):
        # whole-tile sections before the file's last, over the row budget
        # at k = 4 * odd: never zero-padded (F9), each retried at a
        # multiple of 4 that divides it, so each covers its bytes exactly
        take = section_bytes // (chosen_k * 1024) * chosen_k * 1024
        if (len(secs) < 2 or secs[0][0] == chosen_k
                or any(k * t * 1024 != take for k, t, _ in secs[:-1])):
            raise AssertionError(f"13d: sections {secs} attempts {attempts}")

    summary = {"bytes": n, "card": card}
    t_phase = time.perf_counter()
    ils_codec_mod.ils_encode_device = record
    try:
        host.tofile(src)
        log(f"phase 13a: {n} bytes as a file, default SECTION_BYTES")
        codec, summary["default"] = round_trip("13a", check=ragged)
        enc_ms = [host_ms(lambda: codec.encode_file(src, ils))
                  for _ in range(3)]
        dec_ms = [host_ms(lambda: IlsCodec.decode_file(ils, out))
                  for _ in range(3)]
        size = os.path.getsize(ils)
        summary["default"].update(
            encode_ms_runs=enc_ms, decode_ms_runs=dec_ms,
            encode_ms_median=statistics.median(enc_ms),
            decode_ms_median=statistics.median(dec_ms),
            encode_io=host_io_ms(src, size, dev),
            decode_io=host_io_ms(ils, n, dev),
            encode_profile=device_profile(
                lambda: codec.encode_file(src, ils), "encode_file",
                tk.launch_counts),
            decode_profile=device_profile(
                lambda: IlsCodec.decode_file(ils, out), "decode_file",
                tk.launch_counts))
        log(f"  13a: encode_file ms {[round(x, 1) for x in enc_ms]}, "
            f"decode_file ms {[round(x, 1) for x in dec_ms]}; apart: "
            f"{summary['default']['encode_io']} (encode), "
            f"{summary['default']['decode_io']} (decode)")
        log(f"phase 13b: the same file, section_bytes = {section_bytes}")
        summary["sections"] = round_trip("13b", section_bytes=section_bytes,
                                         check=sections64)[1]
        log(f"phase 13d: the same file, section_bytes = {section_bytes}, "
            f"k = {chosen_k}")
        summary["chosen_k"] = round_trip("13d", section_bytes=section_bytes,
                                         check=unpadded, k=chosen_k)[1]
        # 13c: the first parity_bytes as a file, on the card and on the CPU
        m = parity_bytes
        log(f"phase 13c: {m} bytes, encode_file on the card and on the CPU")
        host[:m].tofile(src)
        blobs = {}
        for device in ("cuda", "cpu"):
            attempts.clear()
            t0 = time.perf_counter()
            c = IlsCodec.fit_file(src, device=device)
            c.encode_file(src, ils)
            blobs[device] = (open(ils, "rb").read(), list(attempts),
                             (time.perf_counter() - t0) * 1e3)
        (cuda_blob, cuda_att, cuda_ms_), (cpu_blob, cpu_att, cpu_ms_) = (
            blobs["cuda"], blobs["cpu"])
        equal = cuda_blob == cpu_blob
        log(f"  13c: attempts k_sec={cuda_att} (cpu {cpu_att}), container "
            f"{len(cuda_blob)} bytes, card == cpu bytes: {equal} "
            f"({cuda_ms_:.1f} ms card, {cpu_ms_:.1f} ms cpu)")
        if not equal or cuda_att != cpu_att:
            raise AssertionError("13c: card and CPU containers differ")
        if len(cuda_att) < 2:
            raise AssertionError("13c: the section did not halve its k")
        summary["parity"] = {"bytes": m, "attempts": cuda_att,
                                   "container_bytes": len(cuda_blob),
                                   "equal": equal}
        summary["phase_s"] = time.perf_counter() - t_phase
        log(f"  phase 13 took {summary['phase_s']:.1f} s")
    finally:
        ils_codec_mod.ils_encode_device = real
        shutil.rmtree(tmp, ignore_errors=True)
    return summary


PATH_KERNELS = {
    # CLI command -> the kernels its path must launch
    "encode ils": ("ils_pack_certify", "ils_compact", "ils_lengths_pass",
                   "ils_pack"),
    "decode ils": ("ils_decode",),
    "encode htc1": ("gap_row_pack", "gap_row_meta", "gap_place_bits"),
    "decode htc1": ("gap_decode_bytes",),
    "decode yamamoto": ("count_segments", "gap_decode_bytes"),
    "decode seq": ("sync_transitions", "gap_decode_bytes"),
    "encode --stream": ("ils_lengths_pass",),
    "decode --stream": ("ils_decode",),
    "roundtrip": ("ils_pack_certify", "ils_compact", "ils_lengths_pass",
                  "ils_pack", "ils_decode"),
    "bench": ("ils_pack_certify", "ils_compact", "ils_decode"),
}


def require_launched(label, launches, names):
    missing = [name for name in names if not launches.get(name)]
    if missing:
        raise AssertionError(f"CLI {label}: kernels not launched: {missing} "
                             f"({launches})")


def cli_phase(host, data, expect, card, mods, dev_args=(),
              bench_size=1 << 28, bench_repeat=5, ref_bytes=1 << 27):
    """Phase 14: the command line (`huffman_tpu_torch.cli.main`, in
    process) on the card, in a temporary directory that the phase removes.
    Each command runs with the launch counts set to 0 just before it and
    read just after, and must launch its path's kernels (PATH_KERNELS).
    `expect` holds the codec API's containers of the same input: phase
    4's ILS blob ("ils"), phase 6's HTC1 blob ("htc1"), the SHA-256 of
    phase 13a's streamed container ("stream_sha256") and phase 9's
    Yamamoto container ("yamamoto_device").  Returns the summary."""
    import contextlib
    import hashlib
    import io

    from huffman_tpu_torch import native
    from huffman_tpu_torch.cli import main as cli
    from huffman_tpu_torch.core import (
        canonical_code_table,
        npref,
        package_merge_lengths,
    )
    from huffman_tpu_torch.io import write_seq, write_yamamoto

    n = host.size
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    summary = {"card": card, "bytes": n, "commands": {}}

    def path(name):
        return os.path.join(tmp, name)

    def run(label, argv):
        """One CLI command: its printed lines, host-clock ms and the
        launches of that call alone."""
        for m in mods:
            m.reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                cli([*argv, *(dev_args if argv[0] != "generate" else ())])
        except SystemExit as e:
            raise AssertionError(f"CLI {label} exited {e.code}") from e
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v for m in mods for k, v in m.launch_counts().items()
                    if v}
        lines = buf.getvalue().splitlines()
        log(f"  {label}: {ms:.1f} ms host clock ({card}); launches "
            f"{launches}")
        for line in lines:
            log(f"    | {line}")
        require_launched(label, launches, PATH_KERNELS.get(label, ()))
        summary["commands"][label] = {"ms": ms, "launches": launches,
                                      "printed": lines}
        return lines

    def same_file(a, b):
        return np.array_equal(np.fromfile(a, np.uint8),
                              np.fromfile(b, np.uint8))

    def check(label, ok):
        summary.setdefault("checks", {})[label] = bool(ok)
        log(f"  {label}: {bool(ok)}")
        if not ok:
            raise AssertionError(f"CLI: {label} failed")

    t_phase = time.perf_counter()
    try:
        src = path("src.bin")
        run("generate", ["generate", "--size", str(n), "--redundancy", "0.5",
                         "--seed", "0", "-o", src])
        check("generate equals phase 4's input",
              np.array_equal(np.fromfile(src, np.uint8), host))

        run("encode ils", ["encode", src, "-o", path("a.ils")])
        with open(path("a.ils"), "rb") as f:
            check("ILS file equals phase 4's container", f.read() == expect["ils"])
        run("decode ils", ["decode", path("a.ils"), "-o", path("a.out")])
        check("ILS decode is the input", same_file(path("a.out"), src))

        run("encode htc1", ["encode", src, "--format", "htc1",
                            "-o", path("a.htc")])
        with open(path("a.htc"), "rb") as f:
            check("HTC1 file equals phase 6's container",
                  f.read() == expect["htc1"])
        run("decode htc1", ["decode", path("a.htc"), "-o", path("h.out")])
        check("HTC1 decode is the input", same_file(path("h.out"), src))

        # the reference formats on the first ref_bytes, each file held to
        # the API's writer with the table the CLI fits from these bytes
        fs = min(ref_bytes, n)
        ysrc = path("y.bin")
        host[:fs].tofile(ysrc)
        table = canonical_code_table(
            package_merge_lengths(npref.histogram(host[:fs]), 16), 16)
        for fmt, write in (("yamamoto", write_yamamoto), ("seq", write_seq)):
            enc = path(f"y.{fmt}")
            run(f"encode {fmt}", ["encode", ysrc, "--format", fmt, "-o", enc])
            t0 = time.perf_counter()
            want = write(host[:fs], table)
            api_ms = (time.perf_counter() - t0) * 1e3
            with open(enc, "rb") as f:
                got = f.read()
            log(f"  write_{fmt} through the API: {api_ms:.1f} ms host clock "
                f"({card}), {len(want)} bytes")
            check(f"{fmt} file equals write_{fmt} with the CLI's table",
                  got == want)
            if fmt == "yamamoto":
                summary["yamamoto_equals_phase9"] = (
                    got == expect["yamamoto_device"])
                log(f"  (phase 9's device-built container equal: "
                    f"{summary['yamamoto_equals_phase9']})")
            run(f"decode {fmt}", ["decode", enc, "--format", fmt,
                                  "-o", path(f"y_{fmt}.out")])
            check(f"{fmt} decode is the input",
                  same_file(path(f"y_{fmt}.out"), ysrc))
        os.unlink(ysrc)

        run("encode --stream", ["encode", src, "--stream",
                                "-o", path("s.ils")])
        with open(path("s.ils"), "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        check("streamed file equals phase 13a's container",
              digest == expect["stream_sha256"])
        run("decode --stream", ["decode", path("s.ils"), "--stream",
                                "-o", path("s.out")])
        check("streamed decode is the input", same_file(path("s.out"), src))

        lines = run("roundtrip", ["roundtrip", src])
        check("roundtrip prints PASS", "Verification:    PASS" in lines)

        lines = run("bench", ["bench", "--size", str(bench_size), "--repeat",
                              str(bench_repeat)])
        pat = r"(encode|decode): ([\d.]+) GB/s \(median of (\d+), best ([\d.]+)\)"
        parsed = [re.fullmatch(pat, line) for line in lines[:2]]
        check("bench prints two lines that parse and PASS",
              all(parsed) and lines[2] == "verification: PASS")
        summary["bench"] = {m.group(1): {"gbps_median": float(m.group(2)),
                                         "runs": int(m.group(3)),
                                         "gbps_best": float(m.group(4))}
                            for m in parsed}
        summary["bench"]["bytes"] = bench_size
        if "e2e_ms" in expect:
            enc_ms, dec_ms, e2e_n = expect["e2e_ms"]
            log(f"  bench medians {summary['bench']['encode']['gbps_median']}"
                f" / {summary['bench']['decode']['gbps_median']} GB/s at "
                f"{bench_size} B; phase 4 {e2e_n / enc_ms / 1e6:.3f} / "
                f"{e2e_n / dec_ms / 1e6:.3f} GB/s at {e2e_n} B ({card})")

        # the native host module: its histogram of the input against
        # torch.bincount on the card
        available = native.available()
        log(f"  native host module: {native.library_path()}"
            if available else
            f"  native host module: {native.unavailable_reason()}")
        check("native host module available", available)
        hist_ms = [host_ms(lambda: native.histogram(host)) for _ in range(3)]
        got = native.histogram(host)
        want = torch.bincount(data, minlength=256).cpu().numpy()
        bincount_ms = host_ms(
            lambda: torch.bincount(data, minlength=256).cpu())
        log(f"  native histogram: ms {[round(x, 2) for x in hist_ms]} host "
            f"clock; torch.bincount + copy {bincount_ms:.2f} ms ({card})")
        check("native histogram equals torch.bincount on the card",
              np.array_equal(got, want))
        summary["native"] = {"histogram_ms": hist_ms,
                             "bincount_ms": bincount_ms}

        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "huffman_tpu_torch.cli", "--help"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=120)
        help_ms = (time.perf_counter() - t0) * 1e3
        log(f"  python -m huffman_tpu_torch.cli --help: rc {res.returncode}, "
            f"{help_ms:.1f} ms host clock ({card})")
        check("python -m huffman_tpu_torch.cli --help",
              res.returncode == 0 and "roundtrip" in res.stdout)
        summary["help_ms"] = help_ms
        summary["phase_s"] = time.perf_counter() - t_phase
        log(f"  phase 14 took {summary['phase_s']:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return summary


def median_ms(fn, runs=5) -> tuple[float, list]:
    """Median of `runs` single calls timed by CUDA events, each after a
    warm-up call."""
    ms = [cuda_ms(fn, 1) for _ in range(runs)]
    return statistics.median(ms), ms


def ragged_phase(stats, ge, tenc, GapArrayCodec, host, data, tail_codec,
                 card, block=1_000_000):
    """Phase 7b: HTC1 blocks that are no multiple of 128 bytes, on B4b-B4d
    with their byte counts (before, they took the loop of encode_block).

    (a) The first 64 MiB as whole blocks of `block` bytes (67 of 1,000,000)
    through one encode_device, with the launch counts of that call, equal
    to the loop of encode_block over the same blocks at encode_device's
    sizing, and decoded back; each kernel held against its plain version
    and timed at that shape.  (b) The ragged tail of phase 6 (`tail_codec`,
    777 bytes by default) through encode_device and encode_block, equal.
    Each route timed as the median of 5 single calls by CUDA events."""
    g = min(64 << 20, data.numel()) // block
    codec = GapArrayCodec.fit(host[: g * block], block_bytes=block,
                              device="cuda")
    blocks = data[: g * block].view(g, block)
    log(f"phase 7b: {g} blocks of {block} B through encode_device, against "
        f"the encode_block loop ({card})")
    sync()
    ge.reset_launch_counts()
    dcomp = codec.encode_device(blocks)
    sync()
    run_launches = ge.launch_counts()
    if any(c != 1 for c in run_launches.values()):
        raise AssertionError(f"encode_device of {g}x{block} B launched "
                             f"{run_launches}, not B4b-B4d once each")

    def loop(c, bl, dc):
        """The route before: encode_block block by block, at the sizing of
        the DeviceCompressed `dc`."""
        kw = dict(seg_bits=c.seg_bits, max_words=dc.words.shape[1] - 1,
                  n_segs=dc.counts.shape[1])
        parts = [tenc.encode_block(b, c.enc, **kw) for b in bl]
        return tuple(torch.stack(x) for x in zip(*parts))

    def same(dc, ref):
        return all(torch.equal(a, b) for a, b in zip(
            (dc.words, dc.total_bits, dc.gaps, dc.counts), ref))

    checks = {
        "equals_encode_block_loop": same(dcomp, loop(codec, blocks, dcomp)),
        "round_trip_bit_exact": torch.equal(codec.decode_device(dcomp),
                                            blocks),
    }
    timing = {}
    gap_encode_cases(stats, ge, codec, blocks, f"ragged {g}x{block} B",
                     timing)
    blocks_ms = {"encode_device": median_ms(
        lambda: codec.encode_device(blocks)),
        "encode_block_loop": median_ms(lambda: loop(codec, blocks, dcomp))}

    bb = tail_codec.block_bytes
    tail = data[data.numel() // bb * bb:].view(1, -1)
    tail_ms = {}
    if tail.numel():
        tdc = tail_codec.encode_device(tail)
        checks["tail_equals_encode_block"] = same(
            tdc, loop(tail_codec, tail, tdc))
        tail_ms = {"encode_device": median_ms(
            lambda: tail_codec.encode_device(tail)),
            "encode_block": median_ms(lambda: loop(tail_codec, tail, tdc))}
    for name, ok in checks.items():
        log(f"  {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError(f"phase 7b failed: {checks}")
    for label, t, nbytes in ((f"{g}x{block} B", blocks_ms, g * block),
                             (f"tail {tail.numel()} B", tail_ms,
                              tail.numel())):
        for route, (med, ms) in t.items():
            log(f"  {label} {route:18s} median {med:.4f} ms = "
                f"{nbytes / med / 1e6:.3f} GB/s {[round(x, 4) for x in ms]}")
    return {"card": card, "blocks": g, "block_bytes": block,
            "tail_bytes": tail.numel(), "launches": run_launches,
            "checks": checks,
            "blocks_ms": {k: {"median": v[0], "ms": v[1]}
                          for k, v in blocks_ms.items()},
            "tail_ms": {k: {"median": v[0], "ms": v[1]}
                        for k, v in tail_ms.items()}}, timing


def parallel_phase(stats, tk, tils, codec, data, main_sec, card, e2e_ms):
    """Phase 15: the multi-device paths (`huffman_tpu_torch.parallel`).

    (a) nccl, world 1, on this card, at phase 4's main section (its tiles
    at its k, without the tail): the certified sharded encode and its
    decode, equal to the codec's own section and to
    `ils_encode_to_device`; the full-band round trip (rot=True); the
    collective histogram; the HTC1 block round trip on the first 64 MiB as
    16 blocks of 4 MiB (seg_bits=1024, "lut").  The launch counts are set
    to 0 just before these calls and read just after (A1, A2, A3, A5 and
    the sharded encode's B4b-B4d must launch).  Then A5 and A1 at
    the full-band shape are held against their plain versions and timed,
    and the sharded calls timed beside the single-device ones.  (b) gloo,
    world 2, both ranks on this card, through `dryrun_multichip` at 2 x 32
    MiB of ILS (8 tiles a rank at k=4096) and 2 x 4 blocks of 4 MiB, and
    its fault checks: the rank-ordered certified section equals
    `ils_encode_to_device`'s on the same 64 MiB, and each rank launched
    A1, A2, A3, A5 and B4b-B4d."""
    import dataclasses

    import torch.distributed as dist

    from huffman_tpu_torch import parallel as par
    from huffman_tpu_torch.core.ils_ref import ILS_LANES, ils_n_win
    from huffman_tpu_torch.ops import gap_encode_kernels as ge
    from huffman_tpu_torch.parallel import dryrun as tdr
    from huffman_tpu_torch.ops.tables import (dec_spec, device_dec_table,
                                              device_enc_table)

    t_phase = time.perf_counter()
    p0 = main_sec.params
    k, n_tiles, rot = p0.k, p0.n_tiles, p0.rot
    table = codec.table
    ml, mn = max(table.max_len_present, 1), max(table.min_len, 1)
    chunk = data[: n_tiles * k * ILS_LANES]
    words = chunk.view(torch.int32).view(-1, ILS_LANES)
    avg = codec._avg_bits(chunk)
    gb, gblocks = 1 << 22, 16
    blocks = data[: gb * gblocks].view(gblocks, gb)
    log(f"phase 15a: nccl world 1, {n_tiles} tiles at k={k} rot={rot} "
        f"({chunk.numel()} B); HTC1 {gblocks} blocks of {gb} B ({card})")
    mesh = par.data_mesh(device="cuda")
    if ((mesh.backend, mesh.size, mesh.rank) != ("nccl", 1, 0)
            or dist.is_initialized()):
        raise AssertionError(f"world-1 mesh: {mesh.backend} {mesh}")
    fb_cap = 2 * (-(-k * ml // 64) + 2)
    gseg = 1024
    max_words = -(-gb * 16 // 32)
    n_segs = -(-max_words * 32 // gseg)

    sync()
    tk.reset_launch_counts()
    ge.reset_launch_counts()
    t0 = time.perf_counter()
    sec = par.ils_sharded_certified_encode(
        mesh, words, codec.enc, k=k, max_len=ml, avg_bits=avg,
        tiles_per_device=n_tiles, rot=rot)
    p = sec.params
    boffs = torch.from_numpy(p.boffs).to(words.device)
    dec_fn = par.make_ils_sharded_decode(
        mesh, k=k, w_cap=p.w_cap, w_band=p.w_band, max_len=ml, min_len=mn,
        tiles_per_device=n_tiles, rot=rot)
    out = dec_fn(sec.payload_dev, sec.starts_dev, p.snum, boffs, codec.dec)
    step = par.make_ils_sharded_roundtrip(mesh, k=k, max_len=ml,
                                          tiles_per_device=n_tiles, rot=True)
    fb_out, fb_ok = step(words, codec.enc, codec.dec)
    hist = par.sharded_histogram(mesh, chunk.view(n_tiles, -1))
    gtable = tdr.fit_table(par.sharded_histogram(mesh, blocks).cpu().numpy()
                           .astype(np.int64))
    spec = dec_spec(gtable)
    genc = device_enc_table(gtable, device="cuda")
    gdec = device_dec_table(gtable, device="cuda")
    gstep = par.make_sharded_roundtrip(
        mesh, spec=spec, seg_bits=gseg, max_words=max_words, n_segs=n_segs,
        max_count=gseg // spec.min_len + 1, block_bytes=gb, method="lut")
    gout, gok = gstep(blocks, genc, gdec)
    sync()
    drive_s = time.perf_counter() - t0
    launches_a = {**tk.launch_counts(), **ge.launch_counts()}
    log(f"  driven in {drive_s:.2f} s; launches {launches_a}")
    # the sharded HTC1 encode runs B4b-B4d (once: one call on 16 blocks)
    missing = [n for n in tdr.ILS_WRAPPERS + tdr.GAP_WRAPPERS
               if not launches_a[n]]
    if missing:
        raise AssertionError(f"phase 15a: kernels not launched: {missing}")

    checks = {
        "certified_decode_bit_exact": torch.equal(out, words),
        "full_band_ok": int(fb_ok) == 1,
        "full_band_bit_exact": torch.equal(fb_out, words),
        "histogram_equals_bincount": torch.equal(
            hist, torch.bincount(chunk, minlength=256).to(torch.int32)),
        "gap_ok": int(gok) == 1,
        "gap_bit_exact": torch.equal(gout, blocks),
    }
    rows1, _, p1 = tils.ils_encode_to_device(words, codec.enc, k=k,
                                             avg_bits=avg, max_len=ml, rot=rot)
    total = p1.total_rows

    def same_section(q, rows):
        return all(np.array_equal(getattr(p, f.name), getattr(q, f.name))
                   for f in dataclasses.fields(p)) and torch.equal(
            sec.payload_dev[:total], rows[:total])

    checks["section_equals_ils_encode_to_device"] = same_section(p1, rows1)
    checks["section_equals_codec_section"] = same_section(
        p0, main_sec.payload)
    checks["rows_past_payload_zero"] = not bool(
        sec.payload_dev[total:].any())
    for name, ok in checks.items():
        log(f"  {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError(f"phase 15a failed: {checks}")
    log(f"  section w_cap={p.w_cap} w_band={p.w_band} rows={total} "
        f"payload {tuple(sec.payload_dev.shape)}; full band w_cap={fb_cap} "
        f"W={fb_cap // 2} pairs")

    # A5 and A1 at the full-band shape against their plain versions
    fb_starts = torch.arange(n_tiles, dtype=torch.int32,
                             device=words.device) * fb_cap
    fb_boffs = torch.zeros((n_tiles, ils_n_win(k)), dtype=torch.int32,
                           device=words.device)
    kw5 = dict(k=k, w_cap=fb_cap, w_band=fb_cap // 2,
               total_rows=n_tiles * fb_cap, rot=True)
    # the plain versions take seconds here: each is called once, for its
    # check and its time
    call5 = lambda: tk.ils_pack(words, 0, fb_boffs, fb_starts, codec.enc, **kw5)
    fb_rows = call5()
    label = f"full band {n_tiles}x k={k} w_cap={fb_cap}"
    ref, plain5 = time_plain_once(lambda: tk.ils_pack_plain(
        words, 0, fb_boffs, fb_starts, codec.enc, **kw5))
    stats.check("ils_pack", fb_rows, ref, label)
    kw1 = dict(k=k, w_cap=fb_cap, n_tiles=n_tiles, max_len=ml, rot=True)
    call1 = lambda: tk.ils_decode(fb_rows, fb_starts, codec.dec, **kw1)
    ref, plain1 = time_plain_once(lambda: tk.ils_decode_plain(
        fb_rows, fb_starts, codec.dec, **kw1))
    stats.check("ils_decode", call1(), ref, label)
    del ref
    n_sym = words.numel() * 4
    full_band = {
        # the pairs A5 writes are the streams' own, as many as the
        # certified section's rows hold; the bits kernel runs (no cbits)
        "ils_pack": timed_kernel(
            "ils_pack", call5, plain5, 5,
            symbols=chunk_kernels(tk, k, A5_KERNELS),
            bytes=n_sym + total * 4096, ops=11 * n_sym,
            shape=list(fb_rows.shape)),
        "ils_decode": timed_kernel(
            "ils_decode", call1, plain1, 5, bytes=total * 4096 + n_sym,
            ops=(2 * (ml - 1) + 10) * n_sym + 12 * (n_sym // 4),
            shape=[n_tiles * k // 4, ILS_LANES]),
    }
    single_sec = tils.IlsSection(params=p1, payload=rows1[:total])
    times_a = {}
    for name, fn in (
        ("certified_encode", lambda: par.ils_sharded_certified_encode(
            mesh, words, codec.enc, k=k, max_len=ml, avg_bits=avg,
            tiles_per_device=n_tiles, rot=rot)),
        ("single_encode", lambda: tils.ils_encode_to_device(
            words, codec.enc, k=k, avg_bits=avg, max_len=ml, rot=rot)),
        ("sharded_decode", lambda: dec_fn(sec.payload_dev, sec.starts_dev,
                                          p.snum, boffs, codec.dec)),
        ("single_decode", lambda: tils.ils_decode_device(
            single_sec, table, codec.dec, device=words.device)),
        ("full_band_roundtrip", lambda: step(words, codec.enc, codec.dec)),
    ):
        med, ms = median_ms(fn)
        times_a[name] = {"ms_median": med, "ms": ms,
                         "gbps": chunk.numel() / med / 1e6}
        log(f"  {name:20s} median {med:.3f} ms = "
            f"{chunk.numel() / med / 1e6:.3f} GB/s {[round(x, 3) for x in ms]}")
    log(f"  phase 4 (codec, {e2e_ms[2]} B with the tail): encode "
        f"{e2e_ms[0]:.3f} ms, decode {e2e_ms[1]:.3f} ms ({card})")
    del fb_rows, rows1, single_sec, sec, out, fb_out, gout
    mesh.close()

    # (b) two ranks over gloo, both on this card
    sizes = dict(ils_k=4096, ils_tpd=8, cert_k=4096, cert_tpd=8,
                 gap_blocks=4, gap_block_bytes=gb, gap_seg_bits=gseg)
    log(f"phase 15b: gloo world 2 on this card, dryrun_multichip {sizes}")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tdr.dryrun_multichip(2, backend="gloo", device="cuda", out_dir=tmp,
                             timeout=300, **sizes)
        dryrun_s = time.perf_counter() - t0
        rk = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
              for r in range(2)]
    s = {**tdr.DEFAULT_SIZES, **sizes}
    cdata = tdr.certified_input(2, s["cert_k"], s["cert_tpd"], s["cert_seed"])
    chist = np.bincount(cdata, minlength=256)
    ctable = tdr.fit_table(chist)
    cwords = torch.from_numpy(cdata.view(np.int32).reshape(-1, ILS_LANES)
                              .copy()).cuda()
    rows2, _, p2 = tils.ils_encode_to_device(
        cwords, tk.ils_enc_tabs(ctable, device="cuda"), k=s["cert_k"],
        avg_bits=float(rk[0]["cert_rot0_avg_bits"]),
        max_len=ctable.max_len_present, rot=False)
    per_rank = p2.w_tiles.reshape(2, -1).sum(axis=1)
    launches_b = [{n: int(r[f"launches_{n}"])
                   for n in {**tk.launch_counts(), **ge.launch_counts()}}
                  for r in rk]
    checks_b = {
        "params_equal": all(
            int(r["cert_rot0_w_cap"]) == p2.w_cap
            and int(r["cert_rot0_w_band"]) == p2.w_band
            and np.array_equal(r["cert_rot0_boffs"], p2.boffs)
            and np.array_equal(r["cert_rot0_w_tiles"], p2.w_tiles)
            for r in rk),
        "payload_equal": np.array_equal(
            np.concatenate([r["cert_rot0_payload"][:m]
                            for r, m in zip(rk, per_rank)]),
            rows2[: p2.total_rows].cpu().numpy()),
        "decodes_bit_exact": all(
            np.array_equal(r["cert_rot0_decoded"].view(np.uint8).reshape(-1),
                           cdata[i * cdata.size // 2:(i + 1) * cdata.size // 2])
            for i, r in enumerate(rk)),
        "ils_ok": all(int(r["ils_ok"]) == 1 for r in rk),
        "gap_ok": all(int(r["gap_lut_ok"]) == 1 for r in rk),
        "wrong_table_ok_zero": all(int(r["wrong_table_ok"]) == 0 for r in rk),
        "refusals_on_every_rank": all(
            len({str(r[key]) for r in rk}) == 1
            for key in ("refused_stride", "refused_band")),
        "kernels_launched": all(
            lb[n] > 0 for lb in launches_b
            for n in tdr.ILS_WRAPPERS + tdr.GAP_WRAPPERS),
    }
    log(f"  dry run {dryrun_s:.1f} s (2 spawned ranks); launches "
        f"{launches_b}")
    for name, ok in checks_b.items():
        log(f"  {name}: {ok}")
    if not all(checks_b.values()):
        raise AssertionError(f"phase 15b failed: {checks_b}")
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 15 took {phase_s:.1f} s ({card})")
    return {
        "card": card,
        "a": {"backend": "nccl", "world": 1, "k": k, "tiles": n_tiles,
              "rot": rot, "bytes": chunk.numel(), "w_cap": p.w_cap,
              "w_band": p.w_band, "full_band_w_cap": fb_cap,
              "gap_blocks": gblocks, "gap_block_bytes": gb,
              "launches": launches_a, "checks": checks, "drive_s": drive_s,
              "times": times_a},
        "b": {"backend": "gloo", "world": 2, "sizes": sizes,
              "launches": launches_b, "checks": checks_b,
              "dryrun_s": dryrun_s, "w_cap": p2.w_cap, "w_band": p2.w_band},
        "phase_s": phase_s,
    }, full_band, launches_a, launches_b


# the cases in which each kernel of KERNELS must have launched
FUZZ_MIN_CASES = 3


def fuzz_phase(seed, iters, card):
    """Phase 15c: the differential fuzz soak (`tools/fuzz_torch.py`) on
    the card, cases 0..iters-1 of ``seed`` at the tool's defaults.  Each
    case holds its kernels to the data, to their plain versions (card ==
    CPU container bytes) and to the NumPy oracles; a divergence raises the
    tool's reproducer line.  The launch counts are set to 0 first; each
    wrapper of KERNELS but OFF_PATH's must launch in at least
    FUZZ_MIN_CASES cases."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "fuzz_torch.py")
    spec = importlib.util.spec_from_file_location("fuzz_torch", path)
    fuzz = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fuzz)
    log(f"phase 15c: the fuzz soak, seed {seed}, {iters} cases, at most "
        f"{fuzz.MAX_BYTES} B a case ({card})")
    for m in (fuzz.ils_kernels, fuzz.gap_decode_kernels,
              fuzz.gap_encode_kernels, fuzz.selfsync_kernels,
              fuzz.encode_map_kernels, fuzz.histogram_kernels):
        m.reset_launch_counts()
    r = fuzz.soak(seed, 0, iters, torch.device("cuda"),
                  log=lambda line: log("  " + line))
    per_kernel = {name: r["kernels"][name] for name in KERNELS}
    for name, k in per_kernel.items():
        log(f"  {name:18s} launches={k['launches']} cases={k['cases']} "
            f"shapes={k['shapes']}")
    log(f"  phase 15c took {r['seconds']:.1f} s: {iters} cases, seed {seed}, "
        f"legs {r['legs']} ({card})")
    short = [name for name, k in per_kernel.items()
             if k["cases"] < FUZZ_MIN_CASES and name not in OFF_PATH]
    if short:
        raise AssertionError(f"phase 15c: kernels launched in fewer than "
                             f"{FUZZ_MIN_CASES} cases: {short} {per_kernel}")
    return {"seed": seed, "cases": iters, "legs": r["legs"],
            "phase_s": r["seconds"], "card": card, "kernels": per_kernel}

def entry_phase(stats, tk, generate_redundant, card):
    """Phase 15d: the flagship entry point on the card.  `entry()`'s step
    held to the data and to its plain version (the CPU's
    `entry(device="cpu")` step on the same arguments); A1's launch count
    must rise by one per call.  Returns (summary, A1's timing at the
    step's shape: `ms` by the profiler, the step's median of 5 by CUDA
    events, the CPU plain version's host ms)."""
    from huffman_tpu_torch.graft_entry import ENTRY_K, ENTRY_TILES, entry
    from huffman_tpu_torch.models import IlsCodec

    log(f"phase 15d: the flagship entry point, graft_entry.entry() ({card})")
    t0 = time.perf_counter()
    fn, args = entry()
    sync()
    build_s = time.perf_counter() - t0
    payload_rows, row_starts, params = args
    data = generate_redundant(ENTRY_TILES * ENTRY_K * 1024, 0.5, seed=0)
    words = torch.from_numpy(data.view(np.int32).copy())
    # the section and table `entry()` decodes, for the bound: A1 reads the
    # section's rows (not the slack rows, not `params`) and writes the words
    codec = IlsCodec.fit(data, k=ENTRY_K)
    (sec,) = codec.encode(data).sections
    total_rows = sec.params.total_rows
    levels = (max(codec.table.max_len_present, 1)
              - max(codec.table.min_len, 1))
    pfn, _ = entry(device="cpu")
    plain, plain_ms = time_plain_once(lambda: pfn(*(a.cpu() for a in args)))
    calls = [0]

    def step():
        calls[0] += 1
        return fn(*args)

    tk.reset_launch_counts()
    per_call = []
    for _ in range(3):
        out = step()
        sync()
        per_call.append(tk.launch_counts()["ils_decode"])
    stats.check("ils_decode", out, plain.cuda(), "entry step")
    step_ms, runs = median_ms(step, 5)
    ms, ms_by, _ = kernel_ms(step, SYMBOLS["ils_decode"], 5)
    launches = tk.launch_counts()["ils_decode"]
    checks = {
        "a1_once_per_call": per_call == [1, 2, 3] and launches == calls[0],
        "on_the_card": all(a.device.type == "cuda" for a in args)
        and out.device.type == "cuda",
        "equals_data": torch.equal(out.reshape(-1).cpu(), words),
        "equals_plain": torch.equal(out.cpu(), plain),
    }
    log(f"  args {[tuple(a.shape) for a in args]}, out {tuple(out.shape)}; "
        f"entry() {build_s:.2f} s; launches {per_call} in the first three "
        f"calls, {launches} in {calls[0]}")
    log(f"  step median of 5 {step_ms:.4f} ms by CUDA events {runs}; A1 "
        f"{ms:.4f} ms ({ms_by}); the CPU's plain step {plain_ms:.1f} ms "
        f"({card})")
    for name, ok in checks.items():
        log(f"  {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError(f"phase 15d failed: {checks}")
    # A1's yardstick at the other shapes (`ils_chain`, `full_band`)
    n_sym = words.numel() * 4
    timing = {"shape": list(out.shape), "ms": ms, "ms_by": ms_by,
              "wrapper_ms": step_ms, "plain_ms": plain_ms,
              "bytes": total_rows * 4096 + out.numel() * 4,
              "ops": (2 * levels + 10) * n_sym + 12 * (n_sym // 4)}
    return {"k": ENTRY_K, "tiles": ENTRY_TILES,
            "args": [list(a.shape) for a in args], "build_s": build_s,
            "step_ms_median": step_ms, "step_ms": runs, "a1_ms": ms,
            "a1_ms_by": ms_by, "plain_cpu_ms": plain_ms,
            "launches": launches, "calls": calls[0], "checks": checks,
            "card": card}, timing


def portable_block(stats, ns, bcodec, blocks, yblob, ydata):
    """Phase 12: the portability path at phase 7's block (and phase 9's
    Yamamoto container).  Returns (summary, B5's launches in the one
    counted encode_block_fast call, B5's timing at that shape)."""
    em, tenc = ns.em, ns.tenc
    gb = blocks.shape[1]
    log(f"phase 12: the portability path, one {gb} B block, seg_bits="
        f"{bcodec.seg_bits}")
    ml = bcodec.table.max_len_present
    # encode_device's sizing: the deepest code's bits, in 512-word steps
    word_bound = -(-gb * ml // 32)
    max_words = -(-word_bound // 512) * 512
    fkw = dict(seg_bits=bcodec.seg_bits, max_words=max_words,
               n_segs=-(-max_words * 32 // bcodec.seg_bits))
    block = blocks[0]
    dcomp = bcodec.encode_device(blocks)

    def fast_encode():
        return tenc.encode_block_fast(block, bcodec.enc, **fkw)

    sync()
    em.reset_launch_counts()
    fast = fast_encode()
    sync()
    map_launches = em.launch_counts()
    log(f"  encode_block_fast launches: {map_launches}")
    if not map_launches["encode_map"]:
        raise AssertionError("encode_block_fast did not launch encode_map")
    ref = (dcomp.words[0], dcomp.total_bits[0], dcomp.gaps[0], dcomp.counts[0])
    for name, a, b in zip(("words", "total_bits", "gaps", "counts"), fast, ref):
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"encode_block_fast {name} differ from "
                                 f"encode_device's")
    del fast
    fast_ms = [cuda_ms(fast_encode, 1) for _ in range(3)]
    fast_med = statistics.median(fast_ms)
    fast_prof = device_profile(fast_encode, "encode_block_fast",
                               em.launch_counts)
    log(f"  encode_block_fast == encode_device (words, total_bits, gaps, "
        f"counts); ms {[round(x, 3) for x in fast_ms]} median {fast_med:.3f} "
        f"= {gb / fast_med / 1e6:.3f} GB/s")
    got = em.encode_map(block, bcodec.enc)
    stats.check("encode_map", got, em.encode_map_plain(block, bcodec.enc),
                f"bench 1x{gb} B")
    map_timing = timed(
        "encode_map", lambda: em.encode_map(block, bcodec.enc),
        lambda: em.encode_map_plain(block, bcodec.enc), 10,
        bytes=gb + sum(x.numel() * 4 for x in got), ops=10 * gb,
        shape=list(got[0].shape))
    del got
    decode = {}
    for m in ("lut", "canonical", "twolevel"):
        codec = ns.GapArrayCodec(bcodec.table, block_bytes=gb, method=m,
                                 device=block.device)

        def mdecode():
            return codec.decode_device(dcomp)

        if not torch.equal(mdecode(), blocks):
            raise AssertionError(f"{m} decode_device is not bit-exact")
        ms = [cuda_ms(mdecode, 1) for _ in range(3)]
        med = statistics.median(ms)
        prof = device_profile(mdecode, f"{m} decode_device", dict)
        log(f"  {m} decode_device bit-exact; ms {[round(x, 3) for x in ms]} "
            f"median {med:.3f} = {gb / med / 1e6:.3f} GB/s")
        decode[m] = {"decode_device_ms_median": med, "decode_device_ms": ms,
                     "decode_device_gbps": gb / med / 1e6, "profile": prof}
    del dcomp
    fs = ydata.numel()
    yam = {"bytes": fs}
    for m in ("lut", "canonical"):
        sync()
        t0 = time.perf_counter()
        out = ns.decode_yamamoto(yblob, method=m, device=ydata.device)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(out, ydata):
            raise AssertionError(f"decode_yamamoto(method={m!r}) is not "
                                 f"bit-exact")
        del out
        log(f"  decode_yamamoto method={m} bit-exact, {ms:.3f} ms with the "
            f"parse = {fs / ms / 1e6:.3f} GB/s")
        yam[m] = {"ms_with_parse": ms, "gbps": fs / ms / 1e6}
    try:
        ns.decode_yamamoto(yblob, method="twolevel", device=ydata.device)
    except ValueError as e:
        log(f"  decode_yamamoto method=twolevel raises, as in the JAX "
            f"package: {e}")
        yam["twolevel"] = {"raises": str(e)}
    else:
        raise AssertionError("decode_yamamoto(method='twolevel') must raise")
    summary = {
        "block_bytes": gb, "seg_bits": bcodec.seg_bits,
        "encode_block_fast_ms_median": fast_med, "encode_block_fast_ms": fast_ms,
        "encode_block_fast_gbps": gb / fast_med / 1e6,
        "encode_block_fast_profile": fast_prof, "decode": decode,
        "yamamoto": yam}
    return summary, map_launches, map_timing


def main(argv=None) -> int:
    t_main = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=1 << 28,
                    help="bytes of the end-to-end input before the tail")
    ap.add_argument("--tail", type=int, default=777)
    ap.add_argument("--redundancy", type=float, default=0.5,
                    help="share of the end-to-end input drawn from 'A'..'D'")
    ap.add_argument("--gap-block", type=int, default=1 << 26,
                    help="bytes of the timed HTC1 block (at most --size)")
    ap.add_argument("--fuzz-seed", type=int, default=0,
                    help="seed of phase 15c's fuzz cases")
    ap.add_argument("--fuzz-iters", type=int, default=FUZZ_ITERS,
                    help="phase 15c's fuzz cases")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2

    from types import SimpleNamespace

    from huffman_tpu_torch import GapArrayCodec, IlsCodec, IlsCompressed
    from huffman_tpu_torch.core.ils_ref import ILS_LANES, ils_schedule_numer
    from huffman_tpu_torch.io import (
        decode_seq,
        decode_yamamoto,
        decode_yamamoto_device,
        read_container,
        read_ils_container,
        read_yamamoto,
        table_from_length_sequence,
        write_container,
        write_ils_container,
        write_seq,
        write_yamamoto,
        yamamoto_bytes,
    )
    from huffman_tpu_torch.models.selfsync import (
        _compose_scan,
        selfsync_decode_device,
    )
    from huffman_tpu_torch.ops import cuda_build
    from huffman_tpu_torch.ops import decode as step
    from huffman_tpu_torch.ops import encode as tenc
    from huffman_tpu_torch.ops import encode_map_kernels as em
    from huffman_tpu_torch.ops import gap_decode_kernels as gd
    from huffman_tpu_torch.ops import gap_encode_kernels as ge
    from huffman_tpu_torch.ops import histogram_kernels as hk
    from huffman_tpu_torch.ops import ils as tils
    from huffman_tpu_torch.ops import ils_kernels as tk
    from huffman_tpu_torch.ops import selfsync_kernels as sk
    from huffman_tpu_torch.ops import tables as tt
    from huffman_tpu_torch.ops.tables import dec_spec, device_dec_table
    from huffman_tpu_torch.utils import generate_redundant

    # ---- 1. card and build
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    cuda_build.load_kernels()
    log(f"build {time.perf_counter() - t0:.1f} s (nvcc, one process per source)")
    resources = cuda_build.kernel_resources()
    ptxas = {}
    for name, tile in (
        ("gap_row_pack", "dynamic tiles row_pack_tile(cap_words): "
         + ", ".join(f"{c} words {ge.row_pack_tile(c)[1]} B"
                     for c in (16, 32, 48, 64))
         + f", {ge.row_pack_tile(64)[0]} rows a block"),
        ("gap_row_meta", "window meta_tile(seg_bits, max_len) (rows, "
         "segments, bytes): " + ", ".join(
             f"{b}/{m} {ge.meta_tile(b, m)}"
             for b, m in ((8, 16), (128, 12), (1024, 12), (1024, 16),
                          (8192, 16)))
         + "; the 1 KB length table static"),
        ("gap_place_bits", "8 lanes a row (16-byte quads), 4 rows a warp "
         "step, 128 rows a block"),
        ("gap_decode_ranks", "staged rows and rank tile "
         "ranks_tile(max_count, seg_bits) (rows, column chunk, pitch in "
         "words, bytes): " + ", ".join(
             f"{m}/{b} {gd.ranks_tile(m, b)}"
             for m, b in ((176, 1024), (64, 128), (8192, 8192),
                          (64, 16384)))),
        ("sync_transitions", "dynamic shared memory sync_tile(seg_bits) "
         "(rows, bitmap words, bytes): " + ", ".join(
             f"{b} bits {sk.sync_tile(b)}" for b in (32, 1024, 65504))
         + "; the 1 KB length table static"),
        ("ils_decode", f"length-and-symbol table on {tk.ILS_LUT_BITS} bits: "
         f"{2 << tk.ILS_LUT_BITS} B of the static shared memory"),
        ("gap_decode_bytes", "B1's tile, ranks_tile(max_count, seg_bits), "
         "each row's chunk at the output's phase mod 4, and symtab's 256 B "
         "of static shared memory"),
        ("gap_place_bytes", "dynamic buffer place_tile(max_count) (rows, "
         "column chunk, bytes): " + ", ".join(
             f"{m} {gd.place_tile(m)}"
             for m in (1, 48, 256, 1100, 8193, 65505))),
        ("ils_pack_certify", "certify_chunks(k) (chunks, windows a chunk): "
         + ", ".join(f"k={k} {tk.certify_chunks(k)}"
                     for k in (8, 2048, 4096, 8192, 16384))
         + f"; grid (tile, chunk) of {ILS_LANES} threads"),
        ("ils_pack", "A2's bits kernel and ring, compact form: the same "
         "certify_chunks(k) grid"),
        ("ils_lengths_pass", "A2's bits kernel, then a grid (tile, chunk) "
         f"of {ILS_LANES} threads over certify_chunks(k) chunks (tiles x "
         "chunks): 4 tiles at k=4096 4x4, the k=8 tail 1x1, the 256 MiB "
         f"section at k=4096 64x{tk.certify_chunks(4096)[0]}, at k=8192 32x"
         f"{tk.certify_chunks(8192)[0]}, one tile at k=262148 1x"
         f"{tk.certify_chunks(262148)[0]}"),
        ("count_segments", f"count table on {gd.COUNT_TAB_BITS} bits: "
         f"{2 << gd.COUNT_TAB_BITS} B built per call, copied to each block's "
         "static shared memory"),
        ("byte_counts", "one 8-bit counter a (bin, thread): 64 KiB of "
         "dynamic shared memory, 256 threads a block, drained into 64-bit "
         "totals every 224 B a thread"),
    ):
        ptxas[name] = {}
        for symbol in SYMBOLS[name]:
            # B4b and B4c: one instantiation without byte counts, one with
            hits = {key: r for key, r in resources.items() if symbol in key}
            if not hits:
                raise AssertionError(f"ptxas reported no kernel {symbol}")
            for key, r in hits.items():
                label = symbol if len(hits) == 1 else key
                ptxas[name][label] = r
                log(f"  ptxas {label}: {r}")
        log(f"    {tile}")
    log(json.dumps({"ptxas": resources}))

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
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    codec = IlsCodec.fit(host, device="cuda")
    comp = codec.encode(data)
    blob = write_ils_container(comp)
    comp2 = read_ils_container(blob)
    out = codec.decode(comp2)
    ok = torch.equal(out, data)
    torch.cuda.synchronize()
    launches = {**tk.launch_counts(), **hk.launch_counts()}
    log(f"  round trip {time.perf_counter() - t0:.2f} s bit-exact={ok} "
        f"k={codec.k} sections={[(s.params.k, s.params.n_tiles, s.params.rot, s.params.w_band, s.params.w_cap) for s in comp.sections]}")
    log(f"  container {len(blob)} bytes, ratio {len(blob) / n:.6f}")
    log(f"  launches in that run: {launches}")
    if not ok:
        raise AssertionError("end-to-end round trip is not bit-exact")
    # the fit counted host bytes: H1 runs once a section of the encode
    if launches["byte_counts"] != len(comp.sections):
        raise AssertionError(f"byte_counts launched {launches['byte_counts']}"
                             f" times for {len(comp.sections)} sections")
    # the streaming pack runs only where PREFER_STREAM_PACK is on (phase 11)
    missing = [name for name, c in launches.items()
               if c == 0 and name != "ils_pack_certify_stream"]
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
    histogram_case(stats, hk, chunk, f"main {main_bytes} B", timing)
    main_timing = {name: timing[name] for name in
                   ("ils_decode", "ils_pack_certify", "ils_compact",
                    "byte_counts")
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
        a1_tail = timing["ils_decode"]
        histogram_case(stats, hk, padded, f"tail {padded.numel()} B", timing)
        h1_tail = timing["byte_counts"]
    h1_inputs = histogram_inputs(stats, hk, 10**9, dev, card)
    # A4 at the first attempt of the file path on this input written as a
    # file (phase 13): one tile at k = 4 * ceil(n / 4096), 257 chunks at the
    # default size, unrotated (its section fails the row budget, so
    # rotate="auto" never re-encodes it)
    k_first = max(-(-n // (4 * ILS_LANES)) * 4, 8)
    first = torch.zeros(k_first * ILS_LANES, dtype=torch.uint8, device=dev)
    first[:n] = data
    fwords = first.view(torch.int32).view(-1, ILS_LANES)
    fsnum = ils_schedule_numer(codec._avg_bits(first))
    timing = {}
    lengths_case(stats, tk, fwords, fsnum, codec.enc, k_first, False,
                 tk.ils_lengths_pass(fwords, fsnum, codec.enc, k=k_first,
                                     chunk_bits=True),
                 f"file first attempt 1x k={k_first}", timing, plain_once=True)
    first_timing = timing["ils_lengths_pass"]
    del first, fwords

    enc_ms = [cuda_ms(lambda: codec.encode(data), 1) for _ in range(3)]
    dec_ms = [cuda_ms(lambda: codec.decode(comp), 1) for _ in range(5)]
    enc_med, dec_med = statistics.median(enc_ms), statistics.median(dec_ms)
    prof = {"encode": device_profile(lambda: codec.encode(data), "encode",
                                     lambda: {**tk.launch_counts(),
                                              **hk.launch_counts()}),
            "decode": device_profile(lambda: codec.decode(comp), "decode",
                                     tk.launch_counts)}
    log(f"  encode ms {[round(x, 3) for x in enc_ms]} median {enc_med:.3f} "
        f"= {n / enc_med / 1e6:.3f} GB/s")
    log(f"  decode ms {[round(x, 3) for x in dec_ms]} median {dec_med:.3f} "
        f"= {n / dec_med / 1e6:.3f} GB/s")

    # ---- 4c. IlsCodec(optimize="ratio"): the two-pass tier on whole sections
    log(f"phase 4c: IlsCodec.fit(optimize='ratio') on the same {n} bytes")
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    rcodec = IlsCodec.fit(host, optimize="ratio", device="cuda")
    rcomp = rcodec.encode(data)
    rblob = write_ils_container(rcomp)
    rok = torch.equal(rcodec.decode(read_ils_container(rblob)), data)
    torch.cuda.synchronize()
    r_launches = tk.launch_counts()
    rsec = rcomp.sections[0].params
    rk = rsec.k
    r_stride = tils.stride_rows_for(rk, rcodec.table.max_len_present)
    log(f"  round trip {time.perf_counter() - t0:.2f} s bit-exact={rok} "
        f"k={rk} stride_rows={r_stride} (budget {tils.FUSED_STRIDE_BUDGET}) "
        f"sections={[(q.params.k, q.params.n_tiles, q.params.rot, q.params.w_band, q.params.w_cap) for q in rcomp.sections]}")
    log(f"  container {len(rblob)} bytes, ratio {len(rblob) / n:.6f}")
    log(f"  launches in that run: {r_launches}")
    if not rok:
        raise AssertionError("optimize='ratio' round trip is not bit-exact")
    if (r_stride <= tils.FUSED_STRIDE_BUDGET or r_launches["ils_pack_certify"]
            or not r_launches["ils_lengths_pass"] or not r_launches["ils_pack"]):
        raise AssertionError(f"the optimize='ratio' main section did not take "
                             f"the two-pass tier: {r_launches}")
    ratio_timing: dict = {}
    r_bytes = rsec.n_tiles * rk * ILS_LANES
    rchunk = data[:r_bytes]
    two_pass_cases(stats, tk, tils, rchunk.view(torch.int32).view(-1, ILS_LANES),
                   rcodec, ils_schedule_numer(rcodec._avg_bits(rchunk)), rk,
                   rsec.rot, f"ratio {rsec.n_tiles}x k={rk}", ratio_timing)
    renc_ms = [cuda_ms(lambda: rcodec.encode(data), 1) for _ in range(3)]
    rdec_ms = [cuda_ms(lambda: rcodec.decode(rcomp), 1) for _ in range(5)]
    renc_med, rdec_med = statistics.median(renc_ms), statistics.median(rdec_ms)
    rprof = {"encode": device_profile(lambda: rcodec.encode(data),
                                      "ratio encode", tk.launch_counts),
             "decode": device_profile(lambda: rcodec.decode(rcomp),
                                      "ratio decode", tk.launch_counts)}
    log(f"  encode ms {[round(x, 3) for x in renc_ms]} median {renc_med:.3f} "
        f"= {n / renc_med / 1e6:.3f} GB/s")
    log(f"  decode ms {[round(x, 3) for x in rdec_ms]} median {rdec_med:.3f} "
        f"= {n / rdec_med / 1e6:.3f} GB/s")
    ratio = {"bytes": n, "k": rk, "stride_rows": r_stride,
             "stride_budget": tils.FUSED_STRIDE_BUDGET,
             "launches": r_launches, "container_bytes": len(rblob),
             "ratio": len(rblob) / n, "encode_ms_median": renc_med,
             "encode_ms": renc_ms, "decode_ms_median": rdec_med,
             "decode_ms": rdec_ms, "encode_gbps": n / renc_med / 1e6,
             "decode_gbps": n / rdec_med / 1e6, "card": card,
             "profile": rprof}
    del rcomp, rblob, rchunk

    # ---- 5. HTC1 kernels vs plain, container bytes kernel path vs plain
    log("phase 5: HTC1 small inputs")
    one = np.full(2 * 16384, 7, np.uint8)
    for data_g, bb, seg_bits, label in (
        (generate_redundant(3 * 65536, 0.1, seed=31), 65536, 1024,
         "3x64KiB r=0.1 seg=1024"),
        (generate_redundant(3 * 65536, 0.5, seed=32), 65536, 1024,
         "3x64KiB r=0.5 seg=1024"),
        (generate_redundant(3 * 65536, 0.9, seed=33), 65536, 1024,
         "3x64KiB r=0.9 seg=1024"),
        (one, 16384, 128, "2x16KiB one symbol seg=128"),
        (one, 16384, 1024, "2x16KiB one symbol seg=1024"),
        (np.arange(2 * 65536, dtype=np.uint8), 65536, 4096,
         "2x64KiB uniform seg=4096"),
        (generate_redundant(2 * 65536 + 777, 0.5, seed=35), 65536, 128,
         "2x64KiB+777 r=0.5 seg=128"),
    ):
        gcodec = GapArrayCodec.fit(data_g, seg_bits=seg_bits, block_bytes=bb,
                                   device="cuda")
        n_full = data_g.size // bb
        blocks = torch.from_numpy(
            data_g[: n_full * bb].reshape(n_full, bb).copy()).to(dev)
        dcomp = gap_encode_cases(stats, ge, gcodec, blocks, label)
        gap_decode_cases(stats, gd, gcodec, gcodec.decode_device_plan(dcomp),
                         int(dcomp.total_bits.sum()), blocks, label)
        gap_container_parity(GapArrayCodec, write_container, read_container,
                             data_g, bb, seg_bits, label)

    # ---- 6. HTC1 end to end on the same input
    log(f"phase 6: HTC1 end to end, {n} bytes")
    torch.cuda.synchronize()
    gd.reset_launch_counts()
    ge.reset_launch_counts()
    t0 = time.perf_counter()
    gcodec = GapArrayCodec.fit(host, device="cuda")
    gcomp = gcodec.encode(data)
    gblob = write_container(gcomp)
    gcomp2 = read_container(gblob)
    gout = gcodec.decode(gcomp2)
    gok = torch.equal(gout, data)
    torch.cuda.synchronize()
    gap_launches = {name: c for name, c in {**gd.launch_counts(),
                                            **ge.launch_counts()}.items()
                    if name in HTC1}
    log(f"  round trip {time.perf_counter() - t0:.2f} s bit-exact={gok} "
        f"blocks={gcomp.n_blocks} of {gcodec.block_bytes} B, "
        f"seg_bits={gcodec.seg_bits}")
    log(f"  container {len(gblob)} bytes, ratio {len(gblob) / n:.6f}")
    log(f"  launches in that run: {gap_launches}")
    if not gok:
        raise AssertionError("HTC1 end-to-end round trip is not bit-exact")
    missing = [name for name in HTC1_PATH if gap_launches[name] == 0]
    if missing:
        raise AssertionError(f"HTC1 kernels not launched on its path: {missing}")
    off_path = {name: gap_launches[name] for name in OFF_PATH}
    if any(off_path.values()):
        raise AssertionError(f"HTC1 path launched B1's rank form or B2: "
                             f"{off_path}")
    # B4b-B4d and B1's placing form once a device group, the ragged tail's
    # group included (no block takes another route)
    bb = gcodec.block_bytes
    n_groups = len(gcodec._groups(n // bb, bb)) + (n % bb > 0)
    group_launches = {name: gap_launches[name]
                      for name in (*GAP_ENCODE, "gap_decode_bytes")}
    if any(c != n_groups for c in group_launches.values()):
        raise AssertionError(f"HTC1 kernels launched {group_launches} "
                             f"for {n_groups} groups, the tail included")
    log(f"  B4b-B4d and B1 (placing) launched once for each of the "
        f"{n_groups} groups, the {n % bb}-byte tail included")
    launches.update(gap_launches)
    del gout, gcomp

    log("phase 6b: HTC1 kernels vs plain at that run's shapes, timed")
    # the groups that run gave the kernels: the full blocks' device groups,
    # then the tail, each encoded through B4b-B4d (the tail with its byte
    # count); the first group and the tail are timed
    n_full = n // bb
    groups = [(grp, bb) for grp in gcodec._groups(n_full, bb)]
    if n % bb:
        groups.append(([n_full], n % bb))
    htc1_timing, tail_timing = {}, {}
    for i, (grp, size) in enumerate(groups):
        lo = grp[0] * bb
        blocks = data[lo : lo + len(grp) * size].view(len(grp), size)
        t = htc1_timing if i == 0 else tail_timing if size != bb else None
        label = f"e2e {len(grp)}x{size} B"
        gap_encode_cases(stats, ge, gcodec, blocks, label, t)
        gap_decode_cases(stats, gd, gcodec, gcodec.decode_plan(gcomp2, grp),
                         sum(gcomp2.block_total_bits[j] for j in grp), blocks,
                         label, t)
    del gcomp2

    # ---- 7. the JAX package's HTC1 bench shape, timed
    def gap_counts():
        return {name: c for name, c in {**gd.launch_counts(),
                                        **ge.launch_counts()}.items()
                if name in HTC1}

    gb = min(args.gap_block, args.size)
    log(f"phase 7: one {gb} B HTC1 block, seg_bits=1024, timed")
    bcodec = GapArrayCodec.fit(host[:gb], block_bytes=gb, device="cuda")
    blocks = data[:gb].view(1, gb)
    torch.cuda.synchronize()
    gd.reset_launch_counts()
    ge.reset_launch_counts()
    dcomp = bcodec.encode_device(blocks)
    bok = torch.equal(bcodec.decode_device(dcomp), blocks)
    torch.cuda.synchronize()
    bench_launches = gap_counts()
    log(f"  encode_device + decode_device bit-exact={bok}, launches in that "
        f"run: {bench_launches}")
    if not bok:
        raise AssertionError("HTC1 device-resident round trip is not bit-exact")
    missing = [name for name in HTC1_PATH if bench_launches[name] == 0]
    if missing or any(bench_launches[name] for name in OFF_PATH):
        raise AssertionError(f"HTC1 kernels not launched on the device-resident "
                             f"path as it should: {bench_launches}")
    genc_ms = [cuda_ms(lambda: bcodec.encode_device(blocks), 1)
               for _ in range(3)]
    gdec_ms = [cuda_ms(lambda: bcodec.decode_device(dcomp), 1)
               for _ in range(5)]
    genc_med, gdec_med = statistics.median(genc_ms), statistics.median(gdec_ms)
    gprof = {"encode": device_profile(lambda: bcodec.encode_device(blocks),
                                      "htc1 encode_device", gap_counts),
             "decode": device_profile(lambda: bcodec.decode_device(dcomp),
                                      "htc1 decode_device", gap_counts)}
    log(f"  encode_device ms {[round(x, 3) for x in genc_ms]} median "
        f"{genc_med:.3f} = {gb / genc_med / 1e6:.3f} GB/s")
    log(f"  decode_device ms {[round(x, 3) for x in gdec_ms]} median "
        f"{gdec_med:.3f} = {gb / gdec_med / 1e6:.3f} GB/s")
    bench_timing = {}
    label = f"bench 1x{gb} B"
    dcomp = gap_encode_cases(stats, ge, bcodec, blocks, label, bench_timing)
    gap_decode_cases(stats, gd, bcodec, bcodec.decode_device_plan(dcomp),
                     int(dcomp.total_bits.sum()), blocks, label, bench_timing)
    del dcomp

    # ---- 7b. blocks that are no multiple of 128 bytes, timed
    ragged, ragged_timing = ragged_phase(stats, ge, tenc, GapArrayCodec, host,
                                         data, gcodec, card)

    # ---- 8. foreign streams, small inputs
    log("phase 8: foreign streams, small inputs")
    from huffman_tpu_torch.core import npref

    for label, small, table in (
        ("r=0.1", generate_redundant(200_001, 0.1, seed=41), None),
        ("r=0.5", generate_redundant(200_003, 0.5, seed=42), None),
        ("r=0.9", generate_redundant(150_001, 0.9, seed=43), None),
        ("one symbol", np.full(100_003, 9, np.uint8), None),
        ("uniform 256", np.arange(65_541, dtype=np.uint8), None),
        ("max_len=16", *skew16_input(table_from_length_sequence, 120_001, 44)),
    ):
        if table is None:
            table = GapArrayCodec.fit(small, device="cpu").table
        yam = write_yamamoto(small, table)
        small_d = torch.from_numpy(small).to(dev)
        dblob, words, tb = yamamoto_via_device(GapArrayCodec, yamamoto_bytes,
                                               table, small_d)
        if dblob != yam:
            raise AssertionError(f"device-built Yamamoto container of {label} "
                                 f"differs from write_yamamoto's")
        gaps = torch.from_numpy(read_yamamoto(yam)[2].astype(np.int32)).to(dev)
        dec, spec = device_dec_table(table, device=dev), dec_spec(table)
        counts = count_cases(stats, gd, dec, spec, words, gaps, label)
        ref = npref.segment_metadata(small, table, 128)[1]
        if not np.array_equal(counts[:-1].cpu().numpy(), ref[:-1]):
            raise AssertionError(f"C1 counts of {label} differ from the "
                                 f"encoder's")
        transition_cases(stats, gd, sk, dec, spec, words, tb, label)
        seq = write_seq(small, table)
        for name, fn, arg in (("decode_yamamoto", decode_yamamoto, yam),
                              ("decode_seq", decode_seq, seq)):
            got, cpu = fn(arg), fn(arg, device="cpu")
            if got.device.type != "cuda" or not torch.equal(got.cpu(), cpu) \
                    or not np.array_equal(cpu.numpy(), small):
                raise AssertionError(f"{name} of {label}: card and CPU differ "
                                     f"or are not the input")
        log(f"  foreign {label:14s} {small.size} B, {tb} bits (last segment "
            f"{tb % 128}, last subsequence {tb % 1024} bits): card == CPU")

    # ---- 9. Yamamoto end to end
    fs = min(args.size, 1 << 27)
    log(f"phase 9: Yamamoto end to end, the first {fs} bytes")
    ydata = data[:fs]
    ytable = GapArrayCodec.fit(ydata, device="cuda").table
    t0 = time.perf_counter()
    yblob, ywords, ytb = yamamoto_via_device(GapArrayCodec, yamamoto_bytes,
                                             ytable, ydata)
    t_write = time.perf_counter() - t0
    y_names = ("count_segments", "gap_decode_bytes")

    def yam_counts():
        return {name: gd.launch_counts()[name] for name in y_names}

    torch.cuda.synchronize()
    gd.reset_launch_counts()
    t0 = time.perf_counter()
    ytab2, yw_h, yg_h, ysize = read_yamamoto(yblob)
    yok = torch.equal(decode_yamamoto(yblob), ydata)
    torch.cuda.synchronize()
    t_read = time.perf_counter() - t0
    y_launches = yam_counts()
    log(f"  container {len(yblob)} bytes (built in {t_write:.2f} s), "
        f"read_yamamoto + decode_yamamoto {t_read:.2f} s bit-exact={yok}, "
        f"launches in that run: {y_launches}")
    if not yok:
        raise AssertionError("Yamamoto decode is not bit-exact")
    missing = [name for name, c in y_launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the Yamamoto path: "
                             f"{missing}")
    ydec, yspec = device_dec_table(ytab2, device=dev), dec_spec(ytab2)
    yw = torch.from_numpy(yw_h.view(np.int32)).to(dev)
    yg = torch.from_numpy(yg_h.astype(np.int32)).to(dev)

    def ystaged():
        return decode_yamamoto_device(yw, yg, ysize, ydec, yspec)

    if not torch.equal(ystaged(), ydata):
        raise AssertionError("device-resident Yamamoto decode is not bit-exact")
    y_ms = [cuda_ms(ystaged, 1) for _ in range(5)]
    y_med = statistics.median(y_ms)
    yprof = device_profile(ystaged, "yamamoto decode", yam_counts)
    log(f"  decode_yamamoto_device ms {[round(x, 3) for x in y_ms]} median "
        f"{y_med:.3f} = {fs / y_med / 1e6:.3f} GB/s")
    yam_timing = {}
    label = f"yamamoto {fs} B"
    counts = count_cases(stats, gd, ydec, yspec, yw, yg, label, yam_timing)
    counts[-1] -= int(counts.sum(dtype=torch.int64)) - ysize
    gap_decode_cases(
        stats, gd, SimpleNamespace(dec=ydec, spec=yspec, seg_bits=128),
        (yw.view(1, -1), yg.view(1, -1), counts.view(1, -1),
         -(-int(counts.max()) // 8) * 8, True),
        ytb, ydata.view(1, -1), label, yam_timing)
    del yw, yg, counts

    # ---- 10. self-sync end to end on the same stream
    log(f"phase 10: self-sync end to end, the same {ytb}-bit stream")
    s_names = ("sync_transitions", "gap_decode_bytes")

    def ss_counts():
        return {**sk.launch_counts(), **{name: gd.launch_counts()[name]
                                         for name in s_names[1:]}}

    def ss_decode():
        return selfsync_decode_device(ywords, ytb, ytable)

    torch.cuda.synchronize()
    gd.reset_launch_counts()
    sk.reset_launch_counts()
    sok = torch.equal(ss_decode(), ydata)
    torch.cuda.synchronize()
    s_launches = ss_counts()
    log(f"  selfsync_decode_device bit-exact={sok}, launches in that run: "
        f"{s_launches}")
    if not sok:
        raise AssertionError("self-sync decode is not bit-exact")
    missing = [name for name, c in s_launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the self-sync path: "
                             f"{missing}")
    s_ms = [cuda_ms(ss_decode, 1) for _ in range(5)]
    s_med = statistics.median(s_ms)
    sprof = device_profile(ss_decode, "selfsync decode", ss_counts)
    log(f"  selfsync_decode_device ms {[round(x, 3) for x in s_ms]} median "
        f"{s_med:.3f} = {fs / s_med / 1e6:.3f} GB/s")
    ss_timing = {}
    label = f"selfsync {fs} B"
    sdec, sspec = device_dec_table(ytable, device=dev), dec_spec(ytable)
    packed = transition_cases(stats, gd, sk, sdec, sspec, ywords, ytb, label,
                              ss_timing)
    exits = packed.T >> 16
    scan_ms = cuda_ms(lambda: _compose_scan(exits), 5)
    entry = _compose_scan(exits)
    counts = torch.gather(packed & 0xFFFF, 0, entry[None, :])[0]
    log(f"  composition scan over {exits.shape[0]} subsequences: "
        f"{scan_ms:.3f} ms (CUDA events, plain PyTorch)")
    gap_decode_cases(
        stats, gd, SimpleNamespace(dec=sdec, spec=sspec, seg_bits=1024),
        (ywords.view(1, -1), entry.to(torch.int32).view(1, -1),
         counts.view(1, -1), -(-int(counts.max()) // 8) * 8, True),
        ytb, ydata.view(1, -1), label, ss_timing)
    # C2 on 256 8-bit codes: entries at offsets that differ mod 8 never
    # meet, so stopping walks where they meet saves nothing there
    ucodec = GapArrayCodec.fit(np.arange(256, dtype=np.uint8), seg_bits=128,
                               block_bytes=fs, device="cuda")
    udata = (torch.arange(fs, device=dev) & 255).to(torch.uint8)
    ucomp = ucodec.encode_device(udata.view(1, -1))
    utb = int(ucomp.total_bits[0])
    uwords = ucomp.words[0, : -(-utb // 32)]
    del ucomp, udata
    u_timing = {}
    transition_cases(stats, gd, sk,
                     device_dec_table(ucodec.table, device=dev),
                     dec_spec(ucodec.table), uwords, utb,
                     f"selfsync uniform {fs} B", u_timing)
    uniform_c2 = u_timing["sync_transitions"]
    log(f"  C2 on the uniform input ({fs} B, 8-bit codes, {utb} bits): "
        f"kernel_ms={uniform_c2['ms']} ({uniform_c2['ms_by']}) "
        f"wrapper_ms={uniform_c2['wrapper_ms']} "
        f"plain_ms={uniform_c2['plain_ms']} ({card})")
    del uwords
    launches["count_segments"] = y_launches["count_segments"]
    launches["sync_transitions"] = s_launches["sync_transitions"]
    main_timing["count_segments"] = yam_timing["count_segments"]
    main_timing["sync_transitions"] = ss_timing["sync_transitions"]

    # ---- 11 + 12. the portability path
    ns = SimpleNamespace(
        em=em, tenc=tenc, step=step, tk=tk, tt=tt, tils=tils, gd=gd,
        GapArrayCodec=GapArrayCodec, IlsCodec=IlsCodec,
        IlsCompressed=IlsCompressed, write_ils=write_ils_container,
        read_ils=read_ils_container, decode_yamamoto=decode_yamamoto,
        table_from_length_sequence=table_from_length_sequence,
        generate_redundant=generate_redundant,
        ils_schedule_numer=ils_schedule_numer)
    small = portable_small(stats, ns, dev)
    portable, map_launches, map_timing = portable_block(
        stats, ns, bcodec, blocks, yblob, ydata)
    portable.update(small["summary"], card=card)
    launches["encode_map"] = map_launches["encode_map"]
    main_timing["encode_map"] = map_timing

    # ---- 13. the ILS file path
    file_summary = file_phase(host, data, tk, IlsCodec, read_ils_container,
                              card)

    # ---- 14. the command line on the card
    log(f"phase 14: the command line, {n} bytes ({card})")
    cli_summary = cli_phase(
        host, data, {"ils": blob, "htc1": gblob, "yamamoto_device": yblob,
                     "stream_sha256": file_summary["default"]["sha256"],
                     "e2e_ms": (enc_med, dec_med, n)},
        card, (tk, gd, ge, sk), ref_bytes=fs)

    # ---- 15. the multi-device paths
    par_summary, full_band, par_a, par_b = parallel_phase(
        stats, tk, tils, codec, data, main_sec, card, (enc_med, dec_med, n))

    # ---- 15c. the fuzz soak
    fuzz_summary = fuzz_phase(args.fuzz_seed, args.fuzz_iters, card)

    # ---- 15d. the flagship entry point
    entry_summary, entry_timing = entry_phase(stats, tk, generate_redundant,
                                              card)

    # ---- 16. results
    def times(t):
        b_ms = t.get("bytes", 0) / HBM_BYTES_PER_S * 1e3
        o_ms = t.get("ops", 0) / ALU_OPS_PER_S * 1e3
        return {"shape": t.get("shape"), "ms": t.get("ms"),
                "ms_by": t.get("ms_by"),
                "wrapper_ms": t.get("wrapper_ms"), "plain_ms": t.get("plain_ms"),
                "bound_ms": max(b_ms, o_ms),
                "bound_by": "bytes" if b_ms >= o_ms else "operations",
                "library_ms": t.get("library_ms"),
                **({"ms_parts": t["ms_parts"]} if "ms_parts" in t else {})}

    def show(name, label, t, n_launches):
        log(f"  {name + label:30s} out{tuple(t['shape'] or ())} "
            f"equal={stats.rows[name]['max_abs_err'] == 0} kernel_ms={t['ms']} "
            f"wrapper_ms={t['wrapper_ms']} plain_ms={t['plain_ms']} "
            f"bound_ms={t['bound_ms']} ({t['bound_by']}) launches={n_launches}"
            + ("" if t["library_ms"] is None
               else f" library_ms={t['library_ms']}"))

    portable["d1"].update(times(small["d1"]))
    portable["d3"].update(times(small["d3"]))
    # each kernel's launches in its path's end-to-end run (phase 4 or 6)
    # beside its times at the shapes of that run; A4/A5 also at the full
    # section, B1/B2 also at the tail group
    main_timing.update(htc1_timing)
    extra = {name: [("full_section", t), ("ratio_section", ratio_timing[name])]
             for name, t in section_timing.items()}
    extra["ils_lengths_pass"].append(("file_first_attempt", first_timing))
    extra["ils_pack"].append(("full_band", full_band["ils_pack"]))
    extra.setdefault("ils_decode", []).append(("full_band",
                                               full_band["ils_decode"]))
    for name, t in tail_timing.items():
        extra.setdefault(name, []).append(("tail", t))
    for name, t in ragged_timing.items():
        extra.setdefault(name, []).append(("ragged_blocks", t))
    if n % tile_bytes:
        extra.setdefault("ils_decode", []).insert(0, ("tail", a1_tail))
        extra["byte_counts"] = [("tail", h1_tail)]
    extra.setdefault("byte_counts", []).extend(
        (f"bytes_1e9_{label}", t) for label, t in h1_inputs.items())
    extra["ils_decode"].append(("entry", entry_timing))
    log(f"per kernel at the main path's shapes ({card}):")
    rows = []
    for name, (source, replaces) in KERNELS.items():
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               **({"also_replaces": FOLDED[name]} if name in FOLDED else {}),
               "max_abs_err": stats.rows[name]["max_abs_err"],
               "checks": stats.rows[name]["checks"],
               **times(main_timing.get(name, {})),
               **({"ptxas": ptxas[name]} if name in ptxas else {}),
               "fuzz": fuzz_summary["kernels"][name],
               **({"parallel_launches": {"nccl_world1": par_a[name],
                                         "gloo_world2": [b[name] for b in par_b]}}
                  if name in par_a else {})}
        show(name, "", row, launches[name])
        for key, t in extra.get(name, ()):
            row[key] = times(t)
            show(name, " " + key.replace("_", " "), row[key], launches[name])
        rows.append(row)
    log(f"HTC1 kernels at the bench shape, launches of its one "
        f"encode_device + decode_device ({card}):")
    bench_rows = []
    for name in bench_launches:
        t = times(bench_timing[name])
        show(name, " bench", t, bench_launches[name])
        bench_rows.append({"name": name, "launches": bench_launches[name], **t})
    foreign = {}
    for path, t, path_launches in (("yamamoto", yam_timing, y_launches),
                                   ("selfsync", ss_timing, s_launches)):
        log(f"kernels at the {path} path's shapes, launches of its one "
            f"counted decode ({card}):")
        foreign[path] = []
        for name, c in path_launches.items():
            row = times(t[name])
            show(name, " " + path, row, c)
            foreign[path].append({"name": name, "launches": c, **row})
    log(json.dumps({
        "yamamoto": {"bytes": fs, "container_bytes": len(yblob),
                     "payload_bits": ytb, "decode_ms_median": y_med,
                     "decode_ms": y_ms, "decode_gbps": fs / y_med / 1e6,
                     "card": card, "profile": yprof,
                     "kernels": foreign["yamamoto"]},
        "selfsync": {"bytes": fs, "payload_bits": ytb,
                     "decode_ms_median": s_med, "decode_ms": s_ms,
                     "decode_gbps": fs / s_med / 1e6, "scan_ms": scan_ms,
                     "card": card, "profile": sprof,
                     "kernels": foreign["selfsync"],
                     "uniform_c2": {"payload_bits": utb, **times(uniform_c2)}},
    }))
    log(json.dumps({
        "e2e": {"bytes": n, "encode_ms_median": enc_med,
                "decode_ms_median": dec_med,
                "encode_gbps": n / enc_med / 1e6,
                "decode_gbps": n / dec_med / 1e6,
                "container_bytes": len(blob), "card": card,
                "profile": prof},
        "ratio": ratio,
        "htc1": {"bytes": n, "container_bytes": len(gblob),
                 "block_bytes": gb, "encode_device_ms_median": genc_med,
                 "decode_device_ms_median": gdec_med,
                 "encode_device_gbps": gb / genc_med / 1e6,
                 "decode_device_gbps": gb / gdec_med / 1e6,
                 "card": card, "profile": gprof, "kernels": bench_rows},
        "ragged": {**ragged, "kernels": [
            {"name": name, **times(t)} for name, t in ragged_timing.items()]},
        "portable": portable,
        "file": file_summary,
        "cli": cli_summary,
        "parallel": par_summary,
        "fuzz": {key: v for key, v in fuzz_summary.items() if key != "kernels"},
        "entry": entry_summary,
    }))
    log(f"chip_smoke took {time.perf_counter() - t_main:.1f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
