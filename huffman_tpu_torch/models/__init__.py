from .gap_codec import Compressed, DeviceCompressed, GapArrayCodec
from .ils_codec import IlsCodec, IlsCompressed

__all__ = [
    "IlsCodec",
    "IlsCompressed",
    "GapArrayCodec",
    "Compressed",
    "DeviceCompressed",
]
