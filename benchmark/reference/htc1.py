"""Plain reference of the HTC1 (gap-array) container: parse, table rule,
decode.

The format (little-endian): header ``<4sBBBBH`` (magic b"HTC1", version 2,
flags, log2(seg_bits), max_len, n_sym), crc32, n_sym x (symbol, length) in
canonical order, ``<QII`` (original_size, block_bytes, n_blocks), n_blocks
x total_bits u64, then per block ceil(total_bits/seg_bits) u16 segment
words ``(count << 4) | gap`` and ceil(total_bits/32) u32 payload words, one
MSB-first stream of the block's bytes.  Segment k covers bits
[k*seg_bits, (k+1)*seg_bits); ``gap`` is the offset of the first codeword
that starts in it and ``count`` the number that start in it.  The crc32
runs over str(original_size), then every block's segment words and
payload.

The decode runs every segment from its gap for its count of symbols, in
plain PyTorch, vectorised across all segments of all blocks, one step a
symbol.  The metadata is then held to the stream: the codewords of a block
have to tile its bits [0, total_bits) with no gap or overlap, each segment's
codewords start inside it, and the counts add up to the block's bytes.
Where that holds, the segments' symbols are the block's sequential decode.
It imports nothing of the program.
"""

from __future__ import annotations

import functools
import struct
import zlib

import numpy as np
import torch

from benchmark.reference import huffman

_HEADER = struct.Struct("<4sBBBBH")
_SIZES = struct.Struct("<QII")
M32 = 0xFFFFFFFF


def table_rule(data: torch.Tensor, max_len: int) -> np.ndarray:
    """The lengths `GapArrayCodec.fit` has to give: the optimal code of
    the byte histogram."""
    return huffman.package_merge_lengths(huffman.byte_histogram(data), max_len)


def parse(blob: bytes) -> dict:
    mv = memoryview(blob)
    magic, version, _, log2_seg, max_len, n_sym = _HEADER.unpack_from(mv)
    if magic != b"HTC1" or version != 2:
        raise ValueError("not an HTC1 v2 container")
    off = _HEADER.size
    (crc,) = struct.unpack_from("<I", mv, off)
    off += 4
    ent = np.frombuffer(mv, np.uint8, 2 * n_sym, off).reshape(n_sym, 2)
    off += 2 * n_sym
    lengths = np.zeros(256, np.uint8)
    lengths[ent[:, 0]] = ent[:, 1]
    size, block_bytes, n_blocks = _SIZES.unpack_from(mv, off)
    off += _SIZES.size
    total_bits = np.frombuffer(mv, np.uint64, n_blocks, off).astype(np.int64)
    off += 8 * n_blocks
    seg_bits = 1 << log2_seg
    run = zlib.crc32(str(size).encode())
    metas, words = [], []
    for tb in total_bits:
        ns, nw = -(-int(tb) // seg_bits), -(-int(tb) // 32)
        meta = np.frombuffer(mv, np.uint16, ns, off)
        w = np.frombuffer(mv, np.uint32, nw, off + 2 * ns)
        run = zlib.crc32(w, zlib.crc32(meta, run))
        off += 2 * ns + 4 * nw
        metas.append(meta)
        words.append(w)
    faults = int(off != len(blob)) + int((run & M32) != crc)
    faults += int(not huffman.kraft_ok(lengths, max_len))
    faults += int(n_blocks != -(-size // max(block_bytes, 1)))
    return dict(max_len=max_len, lengths=lengths, original_size=size,
                block_bytes=block_bytes, seg_bits=seg_bits,
                total_bits=total_bits, metas=metas, words=words,
                faults=faults)


def decode(c: dict, device) -> tuple[torch.Tensor, int]:
    """(original_size bytes, faults) of one parsed container."""
    size, bb, sb = c["original_size"], c["block_bytes"], c["seg_bits"]
    n_blocks = len(c["metas"])
    out = torch.zeros(max(size, 1), dtype=torch.uint8, device=device)
    if n_blocks == 0:
        return out[:size], int(size != 0)
    ns = np.array([m.size for m in c["metas"]], np.int64)
    nw = np.array([w.size for w in c["words"]], np.int64)
    wbase = np.concatenate([[0], np.cumsum(nw)[:-1]])
    dev = functools.partial(huffman.on_device, device=device)
    meta = dev(np.concatenate(c["metas"]).astype(np.int64))
    w = dev(np.concatenate(c["words"]).astype(np.int64))
    blk = dev(np.repeat(np.arange(n_blocks), ns))
    seg = dev(np.concatenate([np.arange(n) for n in ns]))
    gap, count = meta & 15, meta >> 4
    bit0 = dev(wbase * 32)[blk]             # the block's bit 0 in `w`
    wend = dev(wbase + nw)[blk]             # one past its last word
    start = bit0 + seg * sb + gap
    # each block's symbols in segment order: exclusive prefix of counts
    incl = torch.cumsum(count, 0)
    blk_first = torch.searchsorted(blk, torch.arange(n_blocks, device=device))
    before = torch.cat([torch.zeros(1, dtype=torch.int64, device=device), incl])
    obase = blk * bb + (incl - count - before[blk_first][blk])
    blk_out = torch.clamp_max(size - torch.arange(n_blocks, device=device) * bb, bb)
    faults = int((before[blk_first + dev(ns)] - before[blk_first] != blk_out).sum())
    order = torch.argsort(count, descending=True, stable=True)
    cnt_sorted = count[order].cpu().numpy()
    n_active = np.searchsorted(-cnt_sorted, -np.arange(int(cnt_sorted.max(initial=0))),
                               side="left").tolist()
    pos, last, ob, we = start[order], start[order].clone(), obase[order], wend[order]
    lut_sym, lut_len = (dev(x) for x in huffman.decode_lut(c["lengths"]))
    zero = torch.zeros((), dtype=torch.int64, device=device)
    bad = torch.zeros(order.numel(), dtype=torch.int64, device=device)
    for j, a in enumerate(n_active):
        p = pos[:a]
        wi = p >> 5
        sh = p & 31
        in0, in1 = wi < we[:a], wi + 1 < we[:a]
        hi = torch.where(in0, w[torch.where(in0, wi, zero)], zero)
        lo = torch.where(in1, w[torch.where(in1, wi + 1, zero)], zero)
        look = (((hi << sh) | (lo >> (32 - sh))) & M32) >> (32 - huffman.LUT_BITS)
        ln = lut_len[look]
        bad[:a] += ln == 0
        last[:a] = p
        out[torch.clamp(ob[:a] + j, 0, size - 1)] = lut_sym[look].to(torch.uint8)
        p += ln
    end = torch.empty_like(pos).scatter_(0, order, pos)
    last = torch.empty_like(last).scatter_(0, order, last)
    faults += int(bad.sum())
    # the codewords tile each block: a segment's first codeword starts where
    # the one before ends, the block's first at its bit 0, its last ending
    # at total_bits; every codeword of segment k starts inside it
    live = count > 0
    s_live, e_live, b_live = start[live], end[live], blk[live]
    same = b_live[1:] == b_live[:-1]
    faults += int((same & (e_live[:-1] != s_live[1:])).sum())
    first = torch.ones_like(b_live, dtype=torch.bool)
    first[1:] = ~same
    final = torch.ones_like(first)
    final[:-1] = ~same
    tb = dev(c["total_bits"])
    faults += int((s_live[first] != bit0[live][first]).sum())
    faults += int((e_live[final] != bit0[live][final] + tb[b_live[final]]).sum())
    faults += int((first.sum() != n_blocks).item())
    faults += int(((last[live] >= bit0[live] + (seg[live] + 1) * sb)
                   | (gap[live] >= sb)).sum())
    return out[:size], faults


def check(blobs: list[bytes], datas: list[torch.Tensor], max_len: int,
          device) -> dict:
    """Judge containers against the inputs they were made from (see
    `reference.ils.check`)."""
    table_diff = byte_diff = faults = 0
    for blob, data in zip(blobs, datas):
        c = parse(blob)
        out, f = decode(c, device)
        data = data.reshape(-1).to(device)
        table_diff += int((c["lengths"] != table_rule(data, max_len)).sum())
        faults += f + c["faults"] + int(c["max_len"] != max_len)
        byte_diff += huffman.diff_bytes(out, data)
    return {"table_len_diff": table_diff, "container_byte_diff": byte_diff,
            "format_faults": faults}
