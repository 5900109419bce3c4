"""ctypes bindings of the port's native host module (``csrc/host_native.cpp``).

The host-side table math has two interchangeable implementations: NumPy
(always there) and this C++ module (an OpenMP histogram, the coin-collector
package-merge, the canonical assignment, the MSB-first bit packer and a
flat-LUT prefix-code walk).  Both give the same results
(`tests/test_torch_native.py` holds them to each other and to the JAX
package's native module).

The library is built at first use, ``g++ -O3 -std=c++17 -fPIC -fopenmp
-shared``, into ``build/huffman_tpu_torch/<hash>/`` beside the package,
where ``<hash>`` is a digest of the source and the flags; concurrent
builders write private names and rename.  Where no compiler is found or the
build fails, `available` is False and the host paths that use the module
(`core/npref.py`, `io/seqfmt.py::host_lut_decode`) run their NumPy
versions.  No device path uses it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "available",
    "unavailable_reason",
    "library_path",
    "histogram",
    "package_merge_lengths",
    "canonical_pieces",
    "encode_bits",
    "decode_prefix_lut",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "host_native.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "build" / "huffman_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-fopenmp", "-shared")
VERSION = 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# C entry -> (argtypes, restype)
_SIGNATURES = {
    "hn_histogram": ([_P, _L, _P], None),
    "hn_package_merge": ([_P, _I, _P], _I),
    "hn_canonical": ([_P, _P, _P, ctypes.POINTER(_I)], _I),
    "hn_encode_bits": ([_P, _L, _P, _P, _P, _L], _L),
    "hn_decode_prefix_lut": ([_P, _L, _L, _P, _P, _I, _P, _L], _L),
    "hn_version": ([], _I),
}

_lock = threading.Lock()
_LIB = None
_TRIED = False
_ERROR = None  # why the module is not available, once `_load` has failed


def _compilers() -> list[str]:
    """$CXX, then g++ and c++ on the PATH: a compiler that cannot build
    with OpenMP (one without libgomp) gives way to the next."""
    found = [os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++")]
    return list(dict.fromkeys(c for c in found if c))


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libhost_native.so"


def _build(out: Path) -> None:
    """Compile the library to `out` with the first compiler that builds
    it; raises OSError or SubprocessError with every compiler's message."""
    compilers = _compilers()
    if not compilers:
        raise OSError("no C++ compiler (CXX, g++ or c++)")
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".libhost_native.", suffix=".so",
                               dir=out.parent)
    os.close(fd)
    errors = []
    try:
        for cxx in compilers:
            res = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                                 capture_output=True, text=True, timeout=300)
            if res.returncode == 0:
                os.replace(tmp, out)  # atomic against concurrent builders
                return
            errors.append(f"{cxx} exited {res.returncode}: "
                          f"{res.stderr.strip()[-1000:]}")
        raise OSError("; ".join(errors))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _LIB, _TRIED, _ERROR
    with _lock:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.SubprocessError) as e:
            _ERROR = f"{type(e).__name__}: {e}"
            return None
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        if lib.hn_version() != VERSION:
            _ERROR = f"{path} is not version {VERSION}"
            return None
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> str | None:
    """Why `available` is False (the compiler's message where the build
    failed), else None."""
    _load()
    return _ERROR


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native host module is not available: {_ERROR}")
    return lib


def histogram(data: np.ndarray) -> np.ndarray:
    """(256,) int64 byte histogram."""
    lib = _require()
    data = np.ascontiguousarray(data, np.uint8).reshape(-1)
    out = np.zeros(256, np.int64)
    lib.hn_histogram(data.ctypes.data, data.size, out.ctypes.data)
    return out


def package_merge_lengths(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """(256,) uint8 optimal length-limited code lengths."""
    lib = _require()
    freqs = np.ascontiguousarray(freqs, np.int64)
    lengths = np.zeros(256, np.uint8)
    rc = lib.hn_package_merge(freqs.ctypes.data, max_len, lengths.ctypes.data)
    if rc != 0:
        raise ValueError(f"native package_merge failed (rc={rc})")
    return lengths


def canonical_pieces(lengths: np.ndarray):
    """Returns (codes (256,) uint32, symtab (n,) uint8)."""
    lib = _require()
    lengths = np.ascontiguousarray(lengths, np.uint8)
    codes = np.zeros(256, np.uint32)
    symtab = np.zeros(256, np.uint8)
    n = ctypes.c_int(0)
    rc = lib.hn_canonical(lengths.ctypes.data, codes.ctypes.data,
                          symtab.ctypes.data, ctypes.byref(n))
    if rc != 0:
        raise ValueError("native canonical assignment failed (Kraft violation)")
    return codes, symtab[: n.value].copy()


def encode_bits(data: np.ndarray, codes: np.ndarray, lengths: np.ndarray):
    """MSB-first u32 pack; returns (words incl. one pad unit, total_bits)."""
    lib = _require()
    data = np.ascontiguousarray(data, np.uint8).reshape(-1)
    codes = np.ascontiguousarray(codes, np.uint32)
    lengths = np.ascontiguousarray(lengths, np.uint8)
    bound = int((histogram(data) * lengths.astype(np.int64)).sum())
    words = np.zeros(bound // 32 + 2, np.uint32)
    total = lib.hn_encode_bits(data.ctypes.data, data.size, codes.ctypes.data,
                               lengths.ctypes.data, words.ctypes.data,
                               words.size)
    if total == -1:
        raise ValueError("input contains a symbol absent from the code table")
    if total < 0:
        raise ValueError(f"native encode_bits failed (rc={total})")
    n_words = (int(total) + 31) // 32
    return words[: n_words + 1], int(total)


def decode_prefix_lut(payload: np.ndarray, total_bits: int,
                      lut_sym: np.ndarray, lut_len: np.ndarray,
                      lut_bits: int, out_cap: int) -> np.ndarray:
    """Sequential flat-LUT walk of any prefix code over an MSB-first byte
    stream; returns the decoded bytes."""
    lib = _require()
    payload = np.ascontiguousarray(payload, np.uint8)
    lut_sym = np.ascontiguousarray(lut_sym, np.uint8)
    lut_len = np.ascontiguousarray(lut_len, np.uint8)
    if not lut_sym.size == lut_len.size == (1 << lut_bits):
        raise ValueError("the LUT must have 2**lut_bits entries")
    out = np.empty(out_cap, np.uint8)
    n = lib.hn_decode_prefix_lut(
        payload.ctypes.data, payload.size, total_bits, lut_sym.ctypes.data,
        lut_len.ctypes.data, lut_bits, out.ctypes.data, out.size)
    if n < 0:
        raise ValueError(f"native prefix-LUT decode failed (rc={n})")
    return out[:n].copy()
