"""Plain reference of the ILS1 container: parse, table rule, decode.

Reads the container bytes as the format defines them and decodes every
stream on its own, symbol by symbol, in plain PyTorch: vectorised across
the streams of all sections (and all containers of a batch), one step a
symbol.  It imports nothing of the program.

The format (little-endian): header ``<4sBBHQBI`` (magic b"ILS1", version 3
or 4, max_len, n_sym, original_size, n_sections, crc32), n_sym x (symbol,
length) in canonical order, then per section ``<IIiIII`` (k, snum, flags,
w_band, w_cap, n_tiles), n_tiles x w_tile u32, n_tiles x ceil(k/4/64) x
boff i32 and the payload, rows of 1024 u32 words.  A tile holds 1024
streams of k symbols; stream s owns column s of the tile's w_tile rows,
packed MSB-first.  Symbol 4r+j of stream s is byte j of word r*1024 + s of
the tile's output, or with the section's rotation flag of word
r*1024 + ((s>>7) - 3r) % 8 * 128 + ((s&127) - 5r) % 128.  The crc32 runs
over str(original_size), then every payload.

Beside the symbols the decode replays the format's refill schedule: per
body of 4 symbols a stream whose 128-bit register holds at most 64 bits
loads its next pair of words, and that pair has to lie in the certified
band ``[base, base + w_band)``, ``base = clamp((i*snum >> 16) + boff,
0, w_cap/2 - w_band)``, unless it lies past the tile's pair capacity.  A
load outside the band is a fault: a banded reader would decode garbage.
"""

from __future__ import annotations

import functools
import struct
import zlib

import numpy as np
import torch

from benchmark.reference import huffman

LANES = 1024
WIN = 64  # bodies per band-anchor window
ROT_FLAGS = 1 | (3 << 8) | (5 << 12)
_HEADER = struct.Struct("<4sBBHQBI")
_SECTION = struct.Struct("<IIiIII")
M32 = 0xFFFFFFFF


def table_rule(data: torch.Tensor, max_len: int) -> np.ndarray:
    """The lengths `IlsCodec.fit` has to give: the optimal code of the
    byte histogram with one more zero byte (the tail's padding)."""
    freqs = huffman.byte_histogram(data)
    freqs[0] += 1
    return huffman.package_merge_lengths(freqs, max_len)


def parse(blob: bytes) -> dict:
    """The container's fields; ``faults`` counts what breaks the format."""
    mv = memoryview(blob)
    magic, version, max_len, n_sym, size, n_sec, crc = _HEADER.unpack_from(mv)
    if magic != b"ILS1" or version not in (3, 4):
        raise ValueError("not an ILS1 v3/v4 container")
    off = _HEADER.size
    ent = np.frombuffer(mv, np.uint8, 2 * n_sym, off).reshape(n_sym, 2)
    off += 2 * n_sym
    lengths = np.zeros(256, np.uint8)
    lengths[ent[:, 0]] = ent[:, 1]
    faults = 0
    sections = []
    run = zlib.crc32(str(size).encode())
    for _ in range(n_sec):
        k, snum, flags, w_band, w_cap, n_tiles = _SECTION.unpack_from(mv, off)
        off += _SECTION.size
        n_win = -(-(k // 4) // WIN)
        w_tiles = np.frombuffer(mv, np.uint32, n_tiles, off).astype(np.int64)
        off += 4 * n_tiles
        boffs = np.frombuffer(mv, np.int32, n_tiles * n_win, off).astype(np.int64)
        off += 4 * n_tiles * n_win
        rows = int(w_tiles.sum())
        payload = np.frombuffer(mv, np.uint32, rows * LANES, off)
        run = zlib.crc32(payload, run)
        off += 4 * rows * LANES
        faults += int(flags not in ((0, ROT_FLAGS) if version == 4 else (0,)))
        faults += int(k % 4 != 0 or not 1 <= w_band <= w_cap // 2)
        faults += int(((w_tiles % 2 != 0) | (w_tiles < 4) | (w_tiles > w_cap)).sum())
        sections.append(dict(k=k, snum=snum, rot=flags == ROT_FLAGS,
                             w_band=w_band, w_cap=w_cap, n_tiles=n_tiles,
                             w_tiles=w_tiles, boffs=boffs, payload=payload))
    faults += int(off != len(blob)) + int((run & M32) != crc)
    faults += int(not huffman.kraft_ok(lengths, max_len))
    return dict(max_len=max_len, lengths=lengths, original_size=size,
                sections=sections, faults=faults)


def decode(parsed: list[dict], device) -> tuple[list[torch.Tensor], int]:
    """Decode a batch of parsed containers together: (outputs, faults).

    Each output is that container's ``original_size`` bytes.  Faults count
    invalid codewords, streams that read past their rows, and refills
    outside the certified band."""
    words, streams, out_sizes, woff, ooff = [], [], [], 0, 0
    boff_tabs, boff_off = [], 0
    luts = []
    for ci, c in enumerate(parsed):
        lut_sym, lut_len = huffman.decode_lut(c["lengths"])
        luts.append((lut_sym, lut_len))
        c_out = ooff
        for sec in c["sections"]:
            k, n_tiles = sec["k"], sec["n_tiles"]
            n_win = -(-(k // 4) // WIN)
            row0 = np.concatenate([[0], np.cumsum(sec["w_tiles"])[:-1]])
            t = np.repeat(np.arange(n_tiles), LANES)
            s = np.tile(np.arange(LANES), n_tiles)
            streams.append(np.stack([
                woff + (row0[t] * LANES) + s,           # word 0 of the stream
                sec["w_tiles"][t],                      # its rows
                np.full(t.size, k),                     # its symbols
                ooff + t * k * LANES,                   # its tile's output
                s,
                np.full(t.size, int(sec["rot"])),
                np.full(t.size, sec["snum"]),
                boff_off + t * n_win,                   # its window anchors
                np.full(t.size, sec["w_band"]),
                np.full(t.size, sec["w_cap"] // 2),     # pair capacity
                np.full(t.size, ci),                    # its table
            ], axis=1))
            words.append(sec["payload"])
            boff_tabs.append(sec["boffs"])
            woff += sec["payload"].size
            boff_off += sec["boffs"].size
            ooff += n_tiles * k * LANES
        out_sizes.append((c_out, c["original_size"]))
    out = torch.zeros(max(ooff, 1), dtype=torch.uint8, device=device)
    if not streams:
        return [out[o:o + n] for o, n in out_sizes], 0
    st = np.concatenate(streams)
    st = st[np.argsort(-st[:, 2], kind="stable")]  # longest streams first
    ks = st[:, 2]
    # streams still decoding at step j: those with more than j symbols
    n_active = np.searchsorted(-ks, -np.arange(int(ks.max())), side="left").tolist()
    dev = functools.partial(huffman.on_device, device=device)
    (base, nrows, _, obase, lane, rot, snum, wbase, w_band, cap,
     table) = (dev(st[:, i]) for i in range(st.shape[1]))
    w = dev(np.concatenate(words).astype(np.int64))
    boffs = dev(np.concatenate(boff_tabs)) if boff_off else dev(np.zeros(1))
    lsym = dev(np.concatenate([a for a, _ in luts]))
    llen = dev(np.concatenate([b for _, b in luts]))
    lut_base = table << huffman.LUT_BITS
    sub, ln7 = lane >> 7, lane & 127
    n = st.shape[0]
    pos = torch.zeros(n, dtype=torch.int64, device=device)
    valid = torch.full((n,), 128, dtype=torch.int64, device=device)
    pptr = torch.full((n,), 2, dtype=torch.int64, device=device)
    body = torch.zeros(n, dtype=torch.int64, device=device)
    faults = torch.zeros(n, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    for j, a in enumerate(n_active):
        r, q = divmod(j, 4)
        p = pos[:a]
        wi = p >> 5
        sh = p & 31
        idx = base[:a] + wi * LANES
        in0 = wi < nrows[:a]
        in1 = wi + 1 < nrows[:a]
        hi = torch.where(in0, w[torch.where(in0, idx, zero)], zero)
        lo = torch.where(in1, w[torch.where(in1, idx + LANES, zero)], zero)
        win = ((hi << sh) | (lo >> (32 - sh))) & M32
        look = lut_base[:a] + (win >> (32 - huffman.LUT_BITS))
        ln = llen[look]
        faults[:a] += ln == 0
        p += ln
        body[:a] += ln
        col = torch.where(rot[:a] == 1,
                          ((sub[:a] - 3 * r) % 8) * 128 + (ln7[:a] - 5 * r) % 128,
                          lane[:a])
        out[obase[:a] + (r * LANES + col) * 4 + q] = lsym[look].to(torch.uint8)
        if q == 3:  # the body's refill
            v = valid[:a]
            v -= body[:a]
            body[:a] = 0
            need = v <= 64
            pp = pptr[:a]
            lo_b = torch.clamp_min((r * snum[:a] >> 16) + boffs[wbase[:a] + r // WIN], 0)
            lo_b = torch.minimum(lo_b, cap[:a] - w_band[:a])
            inband = (pp >= lo_b) & (pp < lo_b + w_band[:a])
            faults[:a] += need & ~inband & (pp < cap[:a])
            pp += need
            v += 64 * need
    faults += pos > nrows * 32
    return [out[o:o + n] for o, n in out_sizes], int(faults.sum())


def check(blobs: list[bytes], datas: list[torch.Tensor], max_len: int,
          device) -> dict:
    """Judge containers against the inputs they were made from: the
    table's lengths against `table_rule`, the decode against the input,
    and the format's faults; each a count, summed over the batch."""
    parsed = [parse(b) for b in blobs]
    outs, faults = decode(parsed, device)
    table_diff = byte_diff = 0
    for c, out, data in zip(parsed, outs, datas):
        data = data.reshape(-1).to(device)
        want = table_rule(data, max_len)
        table_diff += int((c["lengths"] != want).sum())
        faults += c["faults"] + int(c["max_len"] != max_len)
        byte_diff += huffman.diff_bytes(out, data)
    return {"table_len_diff": table_diff, "container_byte_diff": byte_diff,
            "format_faults": faults}
