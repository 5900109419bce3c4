"""huffman_tpu_torch — the ILS and HTC1 Huffman codecs, and the decoders of
foreign Yamamoto and sequential.cpp streams, on PyTorch and CUDA (Hopper).

A port of `huffman_tpu` (JAX/Pallas on a TPU), which stays beside it as the
reference.  The host-side table math is NumPy, bit-identical to the JAX
package; every Pallas kernel of the ILS, HTC1, Yamamoto and self-sync
paths is a hand-written CUDA kernel in ``csrc/`` with a plain PyTorch
version beside it (`ops/ils_kernels.py`, `ops/gap_decode_kernels.py`,
`ops/gap_encode_kernels.py`, `ops/selfsync_kernels.py`).  The entry
points run on the CUDA device unless the caller passes ``device="cpu"``.
This package imports neither jax nor anything of `huffman_tpu`.
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
]
