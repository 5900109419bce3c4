"""Binary interop against the compiled reference sequential codec.

Compiles the reference's `sequential.cpp` (read, never copied) behind a
file driver (``csrc/ref_seq_driver.cpp``) and runs encode and decode
through it, so that blobs cross the process boundary both ways:

- reference encode -> `decode_seq` (foreign greedy-tree codes);
- `write_seq` -> reference decode (canonical codes, the same format).

The source is ``$HUFFMAN_TPU_REF_SEQ`` (the JAX package's variable), else
``reference/sequential.cpp`` in the checkout.  The driver is built by g++
into ``build/huffman_tpu_torch/<hash>/`` beside the package, keyed by a
digest of both sources and the flags.  Everything skips (`ref_available`
is False) where the source or g++ is missing.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

__all__ = ["ref_seq_source", "ref_available", "build_ref_driver",
           "ref_encode", "ref_decode"]

_ROOT = Path(__file__).resolve().parents[2]
DRIVER_SRC = Path(__file__).resolve().parents[1] / "csrc" / "ref_seq_driver.cpp"
BUILD_ROOT = _ROOT / "build" / "huffman_tpu_torch"
CXX_FLAGS = ("-O2", "-std=c++17")


def ref_seq_source() -> Path:
    env = os.environ.get("HUFFMAN_TPU_REF_SEQ")
    return Path(env) if env else _ROOT / "reference" / "sequential.cpp"


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def ref_available() -> bool:
    return (ref_seq_source().is_file() and DRIVER_SRC.is_file()
            and shutil.which(_cxx()) is not None)


def build_ref_driver() -> Path:
    """Compile (once per source pair and flags) and return the driver."""
    src = ref_seq_source()
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    h.update(DRIVER_SRC.read_bytes())
    exe = BUILD_ROOT / h.hexdigest()[:16] / "ref_seq"
    if exe.is_file():
        return exe
    exe.parent.mkdir(parents=True, exist_ok=True)
    # a private name, then an atomic rename: concurrent builders never see
    # each other's partial output
    fd, tmp = tempfile.mkstemp(prefix=".ref_seq.", dir=exe.parent)
    os.close(fd)
    try:
        subprocess.run(
            [_cxx(), *CXX_FLAGS, f'-DREF_SEQ_SOURCE="{src}"',
             str(DRIVER_SRC), "-o", tmp],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, exe)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return exe


def _run(mode: str, blob: bytes) -> bytes:
    exe = build_ref_driver()
    with tempfile.TemporaryDirectory() as d:
        fin = Path(d) / "in.bin"
        fout = Path(d) / "out.bin"
        fin.write_bytes(blob)
        subprocess.run([str(exe), mode, str(fin), str(fout)],
                       check=True, capture_output=True, text=True)
        return fout.read_bytes()


def ref_encode(data: np.ndarray) -> bytes:
    """The reference's `HuffmanSequential::encode` of raw bytes."""
    return _run("encode", np.asarray(data, np.uint8).tobytes())


def ref_decode(blob: bytes) -> np.ndarray:
    """The reference's `HuffmanSequential::decode` of a sequential blob."""
    return np.frombuffer(_run("decode", blob), np.uint8)
