"""HTC1 encode map kernel B5: wrapper, plain version and launch count.

Counterpart of `huffman_tpu/ops/pallas/encode_kernel.py::
encode_map_pallas`.  Each aligned group of 4 bytes becomes its codewords
packed MSB-first and left-justified in 64 bits (two u32 words), the
group's bit length and its 4 code lengths packed 5 bits each, so that
`ops/encode.py::encode_block_fast` places one item per 4 bytes.  The
routing is that of `ops/launch.py`: a CUDA tensor launches the kernel
of ``csrc/encode_map.cu`` or raises, a CPU tensor runs the plain version.
"""

from __future__ import annotations

import torch

from .launch import (
    M32,
    check,
    counters,
    launch,
    same_device,
    to_i32,
    use_kernel,
)

__all__ = ["encode_map", "encode_map_plain", "reset_launch_counts",
           "launch_counts", "MAP_ALIGN"]

# bytes per block of the TPU kernel's (8, 128) word rows; kept as the
# wrapper's precondition so both packages take the same inputs
MAP_ALIGN = 4096


def encode_map_plain(data, enc):
    """The kernel's arithmetic on tensors: the 64-bit accumulator as two
    u32 halves in int64, as the JAX kernel keeps it."""
    w = data.view(-1, 4).to(torch.int64)
    tab = enc.to(torch.int64)
    acc_hi = torch.zeros_like(w[:, 0])
    acc_lo = torch.zeros_like(acc_hi)
    tl = torch.zeros_like(acc_hi)
    meta = torch.zeros_like(acc_hi)
    for b in range(4):
        e = tab[w[:, b]]
        ln = e >> 20
        # (acc_hi, acc_lo) <<= ln, then acc_lo |= code
        acc_hi = ((acc_hi << ln) & M32) | ((acc_lo >> 1) >> (31 - ln))
        acc_lo = ((acc_lo << ln) & M32) | (e & 0xFFFFF)
        tl = tl + ln
        meta = (meta << 5) | ln
    # left-justify: shift left by r = 64 - tl, in [0, 64]
    r = 64 - tl
    rm = r & 31
    lj_hi = torch.where(
        r >= 32, (acc_lo << rm) & M32,
        ((acc_hi << rm) & M32) | ((acc_lo >> 1) >> (31 - rm)))
    lj_lo = torch.where(r >= 32, 0, (acc_lo << rm) & M32)
    return (to_i32(lj_hi), to_i32(lj_lo), tl.to(torch.int32),
            (meta & 0xFFFFF).to(torch.int32))


def encode_map(data, enc):
    """Map (B,) uint8 bytes, B a multiple of MAP_ALIGN, with the (256,)
    int32 table of ``(len << 20) | code`` (`ils_enc_tabs`).

    Returns (hi, lo, lens4, lens_p), each (B/4,) int32: group g's
    codewords (bytes 4g..4g+3, byte 4g first) left-justified in the 64
    bits hi:lo, their total length, and their lengths 5 bits each (byte
    4g in bits 15..19).  A group with no byte in the table gives 0."""
    check("data", data, torch.uint8)
    check("enc", enc, torch.int32, (256,))
    same_device(data, enc)
    if data.dim() != 1 or data.shape[0] % MAP_ALIGN:
        raise ValueError(f"data must be (B,) with B a multiple of {MAP_ALIGN}, "
                         f"got {tuple(data.shape)}")
    if not use_kernel(data):
        return encode_map_plain(data, enc)
    if data.data_ptr() % 4:
        raise ValueError("data must start on a 4-byte boundary (the kernel "
                         "loads a group as one word)")
    n = data.shape[0] // 4
    hi, lo, lens4, lens_p = (torch.empty(n, dtype=torch.int32, device=data.device)
                             for _ in range(4))
    launch("encode_map", "encode_map_launch",
           data.data_ptr(), enc.data_ptr(), hi.data_ptr(), lo.data_ptr(),
           lens4.data_ptr(), lens_p.data_ptr(), n, like=data,
           counted=encode_map)
    return hi, lo, lens4, lens_p


reset_launch_counts, launch_counts = counters(encode_map)
