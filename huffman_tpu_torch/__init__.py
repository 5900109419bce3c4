"""huffman_tpu_torch — the ILS and HTC1 Huffman codecs, and the decoders of
foreign Yamamoto and sequential.cpp streams, on PyTorch and CUDA (Hopper).

A port of `huffman_tpu` (JAX/Pallas on a TPU), which stays beside it as the
reference.  The host-side table math is NumPy, bit-identical to the JAX
package; every Pallas kernel of the ILS, HTC1, Yamamoto and self-sync
paths is a hand-written CUDA kernel in ``csrc/`` with a plain PyTorch
version beside it (`ops/ils_kernels.py`, `ops/gap_decode_kernels.py`,
`ops/gap_encode_kernels.py`, `ops/selfsync_kernels.py`), and the byte
histogram of a device tensor is one too (`ops/histogram_kernels.py`).
The entry points run on the CUDA device unless the caller passes
``device="cpu"``.
This package imports neither jax nor anything of `huffman_tpu`.

Host helpers: ``native`` (a C++ histogram, package-merge, canonical
assignment, bit packer and prefix-code walk, built by g++ at first use),
``io.refbin`` (the reference's `sequential.cpp` behind a file driver) and
the command line, ``python -m huffman_tpu_torch.cli`` (script
``huffman-tpu-torch``).  ``parallel`` runs the ILS and HTC1 codecs on
several devices, one `torch.distributed` rank each.  ``models``, ``ops``,
``io``, ``utils``, ``native`` and ``parallel`` are also reachable as
attributes, loaded at first use.
"""

__version__ = "0.1.0"

import importlib

from . import constants
from .core import (
    CodeTable,
    build_flat_lut,
    build_two_level_table,
    canonical_code_table,
    huffman_lengths_unbounded,
    package_merge_lengths,
)
from .io.container import (
    container_kind,
    container_size,
    read_container,
    read_ils_container,
    write_container,
    write_ils_container,
)
from .io.seqfmt import PrefixCode, decode_seq, read_seq_header, write_seq
from .io.yamamoto import (
    decode_yamamoto,
    read_yamamoto,
    table_from_length_sequence,
    write_yamamoto,
)
from .models.gap_codec import Compressed, DeviceCompressed, GapArrayCodec
from .models.ils_codec import IlsCodec, IlsCompressed
from .models.selfsync import (
    is_canonical,
    selfsync_decode_bytes,
    selfsync_decode_device,
    selfsync_decode_words,
)

__all__ = [
    "CodeTable",
    "canonical_code_table",
    "package_merge_lengths",
    "huffman_lengths_unbounded",
    "build_flat_lut",
    "build_two_level_table",
    "constants",
    "IlsCodec",
    "IlsCompressed",
    "GapArrayCodec",
    "Compressed",
    "DeviceCompressed",
    "write_container",
    "read_container",
    "container_kind",
    "container_size",
    "write_ils_container",
    "read_ils_container",
    "table_from_length_sequence",
    "write_yamamoto",
    "read_yamamoto",
    "decode_yamamoto",
    "PrefixCode",
    "write_seq",
    "read_seq_header",
    "decode_seq",
    "selfsync_decode_words",
    "selfsync_decode_device",
    "selfsync_decode_bytes",
    "is_canonical",
    "models",
    "ops",
    "io",
    "utils",
    "native",
    "parallel",
]

_LAZY = ("models", "ops", "io", "utils", "native", "parallel")


def __getattr__(name):
    if name in _LAZY:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
