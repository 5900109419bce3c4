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
]
