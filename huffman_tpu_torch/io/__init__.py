from .container import (
    container_kind,
    container_size,
    ils_container_size,
    read_container,
    read_ils_container,
    write_container,
    write_ils_container,
)
from .convert import (
    code_table_from_numpy,
    compressed_from_numpy,
    device_compressed_from_numpy,
    section_from_numpy,
)
from .seqfmt import (
    PrefixCode,
    decode_seq,
    host_lut_decode,
    read_seq_header,
    write_seq,
)
from .yamamoto import (
    decode_yamamoto,
    decode_yamamoto_device,
    read_yamamoto,
    table_from_length_sequence,
    write_yamamoto,
    yamamoto_bytes,
)

__all__ = [
    "write_container",
    "read_container",
    "container_size",
    "container_kind",
    "write_ils_container",
    "read_ils_container",
    "ils_container_size",
    "code_table_from_numpy",
    "section_from_numpy",
    "compressed_from_numpy",
    "device_compressed_from_numpy",
    "table_from_length_sequence",
    "write_yamamoto",
    "yamamoto_bytes",
    "read_yamamoto",
    "decode_yamamoto",
    "decode_yamamoto_device",
    "PrefixCode",
    "write_seq",
    "read_seq_header",
    "decode_seq",
    "host_lut_decode",
]
