"""Device operations: tables, the HTC1 block encode and step decoders, and
the ILS device orchestration (`ils`) over its kernels (`ils_kernels`).

The names of `huffman_tpu/ops/__init__.py`.  ``DeviceEncTable`` is one
(256,) int32 tensor of ``(len << 20) | code`` here, where the JAX package
has a ``(codes, lengths)`` pair; ``count_segments`` is the step decoders'
counting pass (`ops/decode.py`), not the kernel C1 of the same name in
`ops/gap_decode_kernels.py`.
"""
from .tables import (
    DeviceEncTable,
    DeviceDecTable,
    DecSpec,
    device_enc_table,
    device_dec_table,
    dec_spec,
)
from .encode import encode_block, histogram
from .decode import decode_block, count_segments
from .bitops import extract_window32
from .ils import (
    IlsSection,
    ils_decode_device,
    ils_encode_device,
    ils_encode_to_device,
    pick_k,
)

__all__ = [
    "DeviceEncTable",
    "DeviceDecTable",
    "DecSpec",
    "device_enc_table",
    "device_dec_table",
    "dec_spec",
    "encode_block",
    "histogram",
    "decode_block",
    "count_segments",
    "extract_window32",
    "IlsSection",
    "ils_decode_device",
    "ils_encode_device",
    "ils_encode_to_device",
    "pick_k",
]
