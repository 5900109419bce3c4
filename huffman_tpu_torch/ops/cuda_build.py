"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source has a plain C interface and is compiled by ``nvcc`` into its own
shared library for Hopper (``sm_90a``), loaded with ctypes.  The build runs
at first use, one ``nvcc`` per source, all started together, into
``build/huffman_tpu_torch/<hash>/`` beside the package, where ``<hash>`` is
a digest of every source and the compiler flags: an edited source builds
anew, an unchanged one is loaded as built.  A missing ``nvcc`` or a failed
build raises; nothing falls back to the plain PyTorch versions.  Each
library's compiler output (``-Xptxas -v``: registers, shared memory and
spills of every kernel) is kept beside it and read by `kernel_resources`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["load_kernels", "build_kernels", "kernel_resources",
           "KERNEL_SOURCES"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "huffman_tpu_torch"
KERNEL_SOURCES = (
    "ils_decode", "ils_encode", "ils_compact", "gap_decode", "gap_encode",
    "selfsync", "encode_map", "byte_histogram",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argtypes (every entry returns cudaGetLastError())
_SIGNATURES = {
    "ils_decode": {
        "ils_decode_launch": [
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _I, _P,
        ],
    },
    "ils_encode": {
        "ils_lengths_launch": [
            _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
        ],
        "ils_pack_certify_launch": [
            _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
            _I, _L, _I, _I, _P,
        ],
        "ils_pack_launch": [
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _L, _I, _I,
            _I, _P,
        ],
    },
    "ils_compact": {
        "ils_compact_launch": [_P, _P, _P, _I, _L, _L, _I, _P],
    },
    "gap_decode": {
        "gap_decode_ranks_launch": [
            _P, _P, _P, _P, _P, _P, _L, _I, _L, _I, _I, _I, _I, _I, _I, _I,
            _I, _P,
        ],
        "gap_place_bytes_launch": [
            _P, _P, _P, _P, _P, _L, _I, _L, _I, _I, _I, _P,
        ],
        "gap_count_segments_launch": [
            _P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _P,
        ],
    },
    "gap_encode": {
        "gap_row_pack_launch": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
        "gap_row_meta_launch": [
            _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _P,
        ],
        "gap_place_bits_launch": [_P, _P, _P, _P, _L, _I, _I, _L, _P],
    },
    "selfsync": {
        "sync_transitions_launch": [
            _P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _I, _I, _P,
        ],
    },
    "encode_map": {
        "encode_map_launch": [_P, _P, _P, _P, _P, _P, _L, _P],
    },
    "byte_histogram": {
        "byte_histogram_launch": [_P, _L, _P, _P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found (PATH and CUDA_HOME): the CUDA kernels of "
        "huffman_tpu_torch cannot be built"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_kernels() -> dict[str, Path]:
    """Compile every source that is not built yet; returns name -> .so."""
    out_dir = BUILD_ROOT / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    targets = {name: out_dir / f"lib{name}.so" for name in KERNEL_SOURCES}
    todo = [name for name, so in targets.items() if not so.exists()]
    if not todo:
        return targets
    nvcc = _nvcc()
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    errors = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            os.unlink(tmp)
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
        else:
            targets[name].with_suffix(".log").write_text(log)
            # atomic publish: a concurrent loader never sees a partial file
            os.replace(tmp, targets[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


_PTXAS = (
    ("registers", r"Used (\d+) registers"),
    ("static_smem_bytes", r"(\d+) bytes smem"),
    ("stack_bytes", r"(\d+) bytes stack frame"),
    ("spill_store_bytes", r"(\d+) bytes spill stores"),
    ("spill_load_bytes", r"(\d+) bytes spill loads"),
)


def kernel_resources() -> dict[str, dict[str, int]]:
    """Per kernel (mangled name), what ptxas reported when the libraries
    were built: registers, static shared memory, stack and spill bytes."""
    out = {}
    for so in build_kernels().values():
        log = so.with_suffix(".log")
        cur = None
        for line in log.read_text().splitlines() if log.exists() else ():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = out.setdefault(m.group(1), {})
                continue
            for key, pattern in _PTXAS if cur is not None else ():
                m = re.search(pattern, line)
                if m:
                    cur[key] = int(m.group(1))
    return out


def load_kernels() -> dict[str, ctypes.CDLL]:
    """Build (if needed) and load the kernel libraries, once per process."""
    global _libs
    with _lock:
        if _libs is None:
            libs = {}
            for name, so in build_kernels().items():
                lib = ctypes.CDLL(str(so))
                for fn, argtypes in _SIGNATURES[name].items():
                    f = getattr(lib, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
                libs[name] = lib
            _libs = libs
        return _libs
