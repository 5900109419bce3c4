"""Byte histogram kernel: wrapper, plain version and launch count.

Replaces no Pallas kernel: the JAX package's `huffman_tpu/ops/encode.py::
histogram` is an XLA scatter-add.  `byte_counts` is the (256,) int64 count
of a uint8 tensor's bytes, counted where the tensor lies: a CUDA tensor
launches the kernel of ``csrc/byte_histogram.cu`` or raises, a CPU tensor
runs the plain version.  `core/npref.py::histogram` (the codecs' ``fit``
and the ILS encode's ``avg_bits``) and `ops/encode.py::histogram` count
through it.
"""

from __future__ import annotations

import torch

from ..constants import ALPHABET_SIZE
from .launch import counters, launch, use_kernel

__all__ = ["byte_counts", "byte_counts_plain", "reset_launch_counts",
           "launch_counts"]


def byte_counts_plain(data: torch.Tensor) -> torch.Tensor:
    """The kernel's function on tensors: ``torch.bincount``."""
    return torch.bincount(data.reshape(-1), minlength=ALPHABET_SIZE)


def byte_counts(data: torch.Tensor) -> torch.Tensor:
    """(256,) int64 count of each byte value of a uint8 tensor of any
    shape, on the tensor's device.  A view that is not contiguous is
    copied first; any alignment is taken as it is."""
    if data.dtype != torch.uint8:
        raise TypeError(f"byte_counts needs uint8 data, got {data.dtype}")
    flat = data.contiguous().view(-1)
    if not use_kernel(flat):
        return byte_counts_plain(flat)
    out = torch.empty(ALPHABET_SIZE, dtype=torch.int64, device=flat.device)
    launch("byte_histogram", "byte_histogram_launch",
           flat.data_ptr(), flat.numel(), out.data_ptr(), like=flat,
           counted=byte_counts)
    return out


reset_launch_counts, launch_counts = counters(byte_counts)
