"""huffman_tpu_torch — the ILS and HTC1 Huffman codecs on PyTorch and CUDA
(Hopper).

A port of `huffman_tpu` (JAX/Pallas on a TPU), which stays beside it as the
reference.  The host-side table math is NumPy, bit-identical to the JAX
package; every Pallas kernel of the ILS and HTC1 paths is a hand-written
CUDA kernel in ``csrc/`` with a plain PyTorch version beside it
(`ops/ils_kernels.py`, `ops/gap_decode_kernels.py`,
`ops/gap_encode_kernels.py`).  The entry points run on the CUDA device unless the
caller passes ``device="cpu"``.  This package imports neither jax nor
anything of `huffman_tpu`.
"""

__version__ = "0.1.0"

from .core.canonical import CodeTable, canonical_code_table
from .core.package_merge import package_merge_lengths
from .io.container import (
    container_kind,
    container_size,
    read_container,
    read_ils_container,
    write_container,
    write_ils_container,
)
from .models.gap_codec import Compressed, DeviceCompressed, GapArrayCodec
from .models.ils_codec import IlsCodec, IlsCompressed

__all__ = [
    "CodeTable",
    "canonical_code_table",
    "package_merge_lengths",
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
]
