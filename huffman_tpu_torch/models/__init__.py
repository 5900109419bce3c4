from .ils_codec import IlsCodec, IlsCompressed

__all__ = ["IlsCodec", "IlsCompressed"]
