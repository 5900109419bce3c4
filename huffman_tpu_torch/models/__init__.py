from .gap_codec import Compressed, DeviceCompressed, GapArrayCodec
from .ils_codec import IlsCodec, IlsCompressed
from .selfsync import (
    is_canonical,
    selfsync_decode_bytes,
    selfsync_decode_device,
    selfsync_decode_words,
)

__all__ = [
    "IlsCodec",
    "IlsCompressed",
    "GapArrayCodec",
    "Compressed",
    "DeviceCompressed",
    "selfsync_decode_words",
    "selfsync_decode_device",
    "selfsync_decode_bytes",
    "is_canonical",
]
