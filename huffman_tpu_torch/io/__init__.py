from .container import ils_container_size, read_ils_container, write_ils_container
from .convert import code_table_from_numpy, section_from_numpy

__all__ = [
    "write_ils_container",
    "read_ils_container",
    "ils_container_size",
    "code_table_from_numpy",
    "section_from_numpy",
]
