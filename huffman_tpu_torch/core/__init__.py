"""Host-side table math (NumPy): canonical codes, package-merge, ILS layout."""

from . import npref
from .canonical import (
    CodeTable,
    TwoLevelTable,
    build_flat_lut,
    build_two_level_table,
    canonical_code_table,
)
from .package_merge import (
    huffman_lengths_unbounded,
    kraft_sum,
    package_merge_lengths,
)

__all__ = [
    "package_merge_lengths",
    "huffman_lengths_unbounded",
    "kraft_sum",
    "CodeTable",
    "canonical_code_table",
    "build_flat_lut",
    "build_two_level_table",
    "TwoLevelTable",
    "npref",
]
