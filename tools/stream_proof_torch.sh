#!/bin/bash
# Section-streamed big-stream proof of huffman_tpu_torch on one CUDA card:
# a file larger than one section through the port's command line,
# `generate`, `encode --stream` and `decode --stream`, with bounded host
# memory, verified byte-exact with cmp.  The counterpart of
# tools/stream_proof.sh, with its defaults:
#
#   tools/stream_proof_torch.sh [SIZE [SECTION_BYTES]]
#
# SIZE defaults to 5 * 2^28 bytes (1.25 GiB), SECTION_BYTES to 2^28 (five
# streamed sections); SECTION_BYTES 0 leaves the codec's default
# (IlsCodec.SECTION_BYTES, 1 GiB).  Each step logs its wall clock and peak
# RSS; the encode also logs every k_sec attempt of every section (a section
# over the row budget retries at a smaller k: ROADMAP.md F9).  The log goes
# to $STREAM_LOG_DIR (default bench_logs/torch)/stream_<SIZE>.log; the
# files to a temporary directory ($STREAM_TMP, or mktemp -d), removed at
# the end.  Needs a CUDA card (the command line's default device).
set -euo pipefail
cd "$(dirname "$0")/.."
SIZE=${1:-$((5 * (1 << 28)))}
SEC=${2:-$((1 << 28))}
L=${STREAM_LOG_DIR:-bench_logs/torch}
D=${STREAM_TMP:-$(mktemp -d)}
mkdir -p "$L" "$D"
trap 'rm -rf "$D"' EXIT
SECARG=()
if [ "$SEC" != 0 ]; then SECARG=(--section-bytes "$SEC"); fi

# run a command; print its wall clock and peak RSS (its own process tree)
TIMED='
import resource, subprocess, sys, time
t = time.perf_counter()
rc = subprocess.call(sys.argv[1:])
rss = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 1024
print(f"  wall clock {time.perf_counter() - t:.2f} s, peak RSS {rss:.1f} MiB",
      flush=True)
sys.exit(rc)
'
timed() { python -c "$TIMED" "$@"; }

# encode --stream through the command line's own main, with each section's
# k_sec attempts logged as the codec makes them
ENCODE='
import sys

from huffman_tpu_torch import cli
from huffman_tpu_torch.models import ils_codec

real = ils_codec.ils_encode_device


def traced(buf, *args, k, **kw):
    print(f"  k_sec attempt: k={k} bytes={buf.numel()}", flush=True)
    try:
        return real(buf, *args, k=k, **kw)
    except ils_codec.IlsVmemError as e:
        print(f"    over the row budget: {e}", flush=True)
        raise


ils_codec.ils_encode_device = traced
cli.main(["encode", *sys.argv[1:]])
'

{
  echo "stream proof: size=$SIZE section_bytes=$SEC tmp=$D"
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader || true
  timed python -u -m huffman_tpu_torch.cli generate --size "$SIZE" \
    --redundancy 0.5 -o "$D/data.bin"
  timed python -u -c "$ENCODE" "$D/data.bin" -o "$D/data.ils" --stream \
    "${SECARG[@]}"
  timed python -u -m huffman_tpu_torch.cli decode "$D/data.ils" \
    -o "$D/out.bin" --stream
  cmp "$D/data.bin" "$D/out.bin"
  echo "STREAM-ROUNDTRIP-OK"
  ls -la "$D"
} 2>&1 | tee "$L/stream_$SIZE.log"
