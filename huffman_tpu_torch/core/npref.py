"""Byte histogram (host NumPy, or on the device for a tensor input)."""

from __future__ import annotations

import numpy as np
import torch

from ..constants import ALPHABET_SIZE

__all__ = ["histogram"]


def histogram(data) -> np.ndarray:
    """(256,) int64 byte histogram of a uint8 array or tensor.

    A tensor is counted where it lies (``torch.bincount``) and only the 256
    counts come back to the host, so a device-resident input is never
    copied whole."""
    if isinstance(data, torch.Tensor):
        if data.dtype != torch.uint8:
            raise TypeError(f"histogram needs uint8 data, got {data.dtype}")
        counts = torch.bincount(data.reshape(-1), minlength=ALPHABET_SIZE)
        return counts.cpu().numpy().astype(np.int64)
    data = np.asarray(data, dtype=np.uint8)
    return np.bincount(data.reshape(-1), minlength=ALPHABET_SIZE).astype(np.int64)
