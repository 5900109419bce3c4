"""Differential fuzz soak of huffman_tpu_torch: random inputs x parameters.

Every case draws a data distribution, a size and the codec's parameters,
then holds three things against each other:

- the device path (the CUDA kernels on ``--device cuda``) and the data
  itself: every round trip is bit-exact;
- the device path and the plain PyTorch versions (``device="cpu"``): the
  container bytes are equal, so every kernel on the path is held to its
  plain version at the case's shape (skipped on ``--device cpu``, where
  both sides are the plain versions);
- the device path and the NumPy oracles (`core/ils_ref.py`,
  `core/npref.py`): the ILS section's payload, ``w_tiles`` and ``boffs``
  equal `ils_encode_np`'s, which `ils_decode_np` round-trips; every HTC1
  block's words, gaps and counts equal `npref`'s.

The ILS leg runs `IlsCodec` (fused tier, or the two-pass tier forced with
``stride_budget=0``, with `ops.ils.PREFER_STREAM_PACK` on in some cases);
the secondary leg, every ``--secondary-every`` case, takes in turn the
HTC1 codec (`gap`), its device-resident group (`gapdev`),
`encode_block_fast`, the self-synchronising decoder and the Yamamoto
decoders.

    python tools/fuzz_torch.py [--iters N] [--seed S] [--device cuda|cpu]
                               [--secondary-every N] [--max-bytes B]
                               [--start I]

Each case draws from its own generator, ``default_rng([seed, i])``, so a
case is reproduced by ``--seed S --start i --iters 1`` with the same
``--max-bytes`` and ``--secondary-every``.  The first divergence, or any
exception, prints ``fuzz FAIL seed=S iter=i`` with every drawn parameter
and exits non-zero; no case falls back to another device or passes on an
exception.  Imports torch, numpy and `huffman_tpu_torch` only.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from huffman_tpu_torch.constants import COUNT_BITS
from huffman_tpu_torch.core import canonical_code_table, npref, package_merge_lengths
from huffman_tpu_torch.core.ils_ref import ILS_LANES, ils_decode_np, ils_encode_np
from huffman_tpu_torch.io import (
    decode_seq,
    decode_yamamoto,
    read_container,
    read_ils_container,
    write_container,
    write_ils_container,
    write_seq,
    write_yamamoto,
)
from huffman_tpu_torch.models import Compressed, GapArrayCodec, IlsCodec
from huffman_tpu_torch.models.selfsync import selfsync_decode_device
from huffman_tpu_torch.ops import (
    encode_map_kernels,
    gap_decode_kernels,
    gap_encode_kernels,
    histogram_kernels,
    ils_kernels,
    selfsync_kernels,
)
from huffman_tpu_torch.ops import encode as tenc
from huffman_tpu_torch.ops import ils as tils
from huffman_tpu_torch.ops.ils_kernels import ils_enc_tabs
from huffman_tpu_torch.utils import generate_redundant

KINDS = ("redundant", "binomial", "two", "blocky", "ascending", "single",
         "sparse", "zipf", "uniform")
ILS_K = (8, 12, 16, 24, 252, 1024, 4096, 4100, 8192)
MAX_LENS = (8, 9, 12, 16)
BLOCK_BYTES = (1, 127, 1000, 1001, 4096, 1 << 16, 1 << 20, 1 << 24)
GAPDEV_BLOCK_BYTES = (1, 127, 1000, 1001, 4096, 1 << 16, 1 << 20)
SEG_BITS = (128, 256, 512, 1024, 2048, 4096, 8192)
GAP_METHODS = (None, "lut", "canonical", "twolevel")
SECONDARY = ("gap", "gapdev", "encode_block_fast", "selfsync", "yamamoto")
MAX_BYTES = 8 << 20
# the 15th of every 16 cases may be this many times --max-bytes
BIG_EVERY, BIG_FACTOR = 16, 8
# HTC1 blocks a case at most: the kernels' group, and the step decoders,
# which decode one block per call; blocks held to the NumPy oracle a case
MAX_BLOCKS, MAX_STEP_BLOCKS, ORACLE_BLOCKS = 512, 32, 64
# the parameters that set the shapes of a case's tensors
SHAPE_KEYS = ("n", "k_sec", "block_bytes", "blocks", "seg_bits", "offset")


class FuzzFailure(AssertionError):
    """A case diverged or raised; ``str()`` is its reproducer line."""


def _require(ok, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def gen_data(rng, kind: str, n: int) -> np.ndarray:
    """n bytes of one of the data kinds (those of `tools/fuzz.py::gen_case`
    and "uniform": every byte equally likely, all 256 present from 256
    bytes on)."""
    if kind == "redundant":
        return generate_redundant(n, float(rng.random()),
                                  seed=int(rng.integers(1 << 30)))
    if kind == "binomial":
        return rng.binomial(255, rng.uniform(0.05, 0.95), n).astype(np.uint8)
    if kind == "two":
        a, b = rng.integers(0, 256, 2)
        return rng.choice([a, b], n, p=[0.99, 0.01]).astype(np.uint8)
    if kind == "blocky":
        parts, left = [], n
        while left > 0:
            m = min(int(rng.integers(100, 20000)), left)
            sub = rng.choice(["z", "u", "c"])
            if sub == "z":
                parts.append(np.zeros(m, np.uint8))
            elif sub == "u":
                parts.append(rng.integers(0, 256, m).astype(np.uint8))
            else:
                parts.append(np.full(m, rng.integers(0, 256), np.uint8))
            left -= m
        return np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    if kind == "ascending":
        return (np.arange(n) % int(rng.integers(2, 257))).astype(np.uint8)
    if kind == "single":
        return np.full(n, rng.integers(0, 256), np.uint8)
    if kind == "sparse":
        data = np.zeros(n, np.uint8)
        idx = rng.integers(0, n, max(n // 50, 1))
        data[idx] = rng.integers(0, 256, idx.size)
        return data
    if kind == "zipf":
        return np.clip(rng.zipf(rng.uniform(1.2, 2.5), n), 0, 255).astype(
            np.uint8)
    if kind == "uniform":
        data = rng.integers(0, 256, n).astype(np.uint8)
        m = min(n, 256)
        data[:m] = rng.permutation(256)[:m]
        return data
    raise ValueError(f"unknown data kind {kind}")


def _max_len(rng, data, params) -> int:
    """A drawn max_len, raised to 16 where the symbols outnumber 2^max_len
    (`tools/fuzz.py`'s rule)."""
    max_len = int(rng.choice(MAX_LENS))
    if int(np.count_nonzero(npref.histogram(data))) > (1 << max_len):
        max_len = 16
    params["L"] = max_len
    return max_len


def gen_case(rng, max_bytes: int = MAX_BYTES, params=None):
    """One ILS case: (kind, data, k, max_len).  n = n_tiles * k * 1024,
    plus a ragged extra of up to k * 1024 - 1 bytes in half the cases (a
    tail section of its own), at most ``max_bytes``."""
    params = {} if params is None else params
    kind = str(rng.choice(KINDS))
    k = int(rng.choice(ILS_K))
    n_tiles = int(rng.integers(1, 9))
    extra = int(rng.integers(0, k * ILS_LANES)) if rng.random() < 0.5 else 0
    n = max(min(n_tiles * k * ILS_LANES + extra, max_bytes), 1)
    params.update(kind=kind, n=n, k=k, n_tiles=n_tiles, extra=extra)
    data = gen_data(rng, kind, n)
    return kind, data, k, _max_len(rng, data, params)


def _ils_oracle(codec, comp, data, rot, stride_budget, device) -> None:
    """The first section again through `ils_encode_device` at the case's
    tier, held to the NumPy oracle (payload, w_tiles, boffs; F1 is why
    w_cap is not compared) and to the codec's own section where the tier
    is the codec's; the tier's section decodes bit-exact."""
    p0 = comp.sections[0].params
    size = p0.n_tiles * p0.k * ILS_LANES
    chunk = np.zeros(size, np.uint8)  # the padded tail where it is alone
    chunk[: min(size, data.size)] = data[:size]
    sec = tils.ils_encode_device(
        chunk, codec.table, codec.enc, k=p0.k,
        avg_bits=codec._avg_bits(torch.from_numpy(chunk)), rot=rot,
        device=device, stride_budget=stride_budget)
    if stride_budget == tils.FUSED_STRIDE_BUDGET:
        ref = comp.sections[0]
        _require(torch.equal(sec.payload, ref.payload)
                 and sec.params.w_cap == p0.w_cap
                 and sec.params.w_band == p0.w_band
                 and np.array_equal(sec.params.boffs, p0.boffs),
                 "ils_encode_device != the codec's first section")
    out = tils.ils_decode_device(sec, codec.table, codec.dec, device=device)
    _require(np.array_equal(_host(out), chunk), "tier section round trip")
    # rot="auto" resolves per content: the oracle takes the section's
    payload_np, params_np = ils_encode_np(chunk, codec.table, p0.k,
                                          rot=sec.params.rot)
    _require(np.array_equal(ils_decode_np(payload_np, params_np, codec.table),
                            chunk), "oracle round trip")
    _require(np.array_equal(_host(sec.payload).view(np.uint32), payload_np),
             "payload != oracle")
    _require(np.array_equal(sec.params.w_tiles, params_np.w_tiles),
             "w_tiles != oracle")
    _require(np.array_equal(sec.params.boffs, params_np.boffs),
             "boffs != oracle")


def ils_case(i, rng, device, *, max_bytes=MAX_BYTES, params=None):
    """The ILS leg (`tools/fuzz.py::one_case` at the card's sizes).
    Returns ("ils", params)."""
    p = {} if params is None else params
    p["leg"] = "ils"
    _, data, k, max_len = gen_case(rng, max_bytes, p)
    rot = (False, True, "auto")[int(rng.integers(3))]
    two_pass = bool(rng.integers(3) == 0)
    stream_pack = bool(rng.integers(8) == 0)
    p.update(rot=rot, two_pass=two_pass, stream_pack=stream_pack)
    saved = tils.PREFER_STREAM_PACK
    tils.PREFER_STREAM_PACK = stream_pack
    try:
        codec = IlsCodec.fit(data, k=k, max_len=max_len, rotate=rot,
                             device=device)
        comp = codec.encode(data)
        blob = write_ils_container(comp)
        p["k_sec"] = [s.params.k for s in comp.sections]
        out = codec.decode(read_ils_container(blob))
        _require(np.array_equal(_host(out), data), "ILS round trip")
        if codec.device.type == "cuda":
            cpu = IlsCodec(codec.table, k=codec.k, rotate=rot, device="cpu")
            _require(write_ils_container(cpu.encode(data)) == blob,
                     "ILS container bytes: card != CPU")
        _ils_oracle(codec, comp, data, rot,
                    0 if two_pass else tils.FUSED_STRIDE_BUDGET, codec.device)
    finally:
        tils.PREFER_STREAM_PACK = saved
    return "ils", p


def _table(data, max_len):
    return canonical_code_table(
        package_merge_lengths(npref.histogram(data), max_len), max_len)


def _blocks_to_oracle(rng, comp: Compressed, data: np.ndarray) -> None:
    """HTC1 blocks' words, total bits, gaps and counts equal
    `core/npref.py`'s for their bytes: every block of a group of at most
    `ORACLE_BLOCKS`, else that many drawn, the first and the last among
    them (the container comparison holds every block to the plain path)."""
    bb = comp.block_bytes
    picks = np.arange(comp.n_blocks)
    if picks.size > ORACLE_BLOCKS:
        picks = np.unique(np.r_[0, picks.size - 1, rng.choice(
            picks.size, ORACLE_BLOCKS - 2, replace=False)])
    for j in picks:
        block = data[j * bb : (j + 1) * bb]
        words, tb = npref.encode_bits(block, comp.table)
        gaps, counts, _ = npref.segment_metadata(block, comp.table,
                                                 comp.seg_bits)
        _require(comp.block_total_bits[j] == tb, f"block {j}: total bits")
        _require(np.array_equal(comp.block_words[j], words[: -(-tb // 32)]),
                 f"block {j}: words != npref")
        _require(np.array_equal(comp.block_gaps[j], gaps)
                 and np.array_equal(comp.block_counts[j], counts),
                 f"block {j}: gaps/counts != npref")


def _fits_htc1(comp: Compressed) -> bool:
    """Whether every segment count fits the HTC1 container's field; where
    one does not, `write_container` must refuse the blocks (F16)."""
    if max((int(c.max(initial=0)) for c in comp.block_counts), default=0) \
            < 1 << COUNT_BITS:
        return True
    try:
        write_container(comp)
    except ValueError as err:
        _require("-bit count" in str(err), str(err))
        return False
    raise AssertionError("a count over the container's field was written")


def _same_htc1(a: Compressed, b: Compressed, fits: bool) -> bool:
    """Equal container bytes, or equal blocks where no container holds
    them."""
    if fits:
        return write_container(a) == write_container(b)
    return (a.block_total_bits == b.block_total_bits
            and all(np.array_equal(x, y) for xs, ys in (
                (a.block_words, b.block_words), (a.block_gaps, b.block_gaps),
                (a.block_counts, b.block_counts)) for x, y in zip(xs, ys)))


def _gap(rng, data, max_len, device, p):
    bb = int(rng.choice(BLOCK_BYTES))
    seg_bits = int(rng.choice(SEG_BITS))
    if rng.integers(8) == 0:  # segments shorter than the codes (F13)
        seg_bits, max_len = 8, max(max_len, 16)
    method = GAP_METHODS[int(rng.integers(len(GAP_METHODS)))]
    cap = MAX_BLOCKS if method is None else MAX_STEP_BLOCKS
    data = data[: cap * bb]
    p.update(n=data.size, L=max_len, block_bytes=bb, seg_bits=seg_bits,
             method=method)
    codec = GapArrayCodec.fit(data, max_len=max_len, seg_bits=seg_bits,
                              block_bytes=bb, method=method, device=device)
    comp = codec.encode(data)
    _blocks_to_oracle(rng, comp, data)
    fits = p["fits"] = _fits_htc1(comp)
    out = codec.decode(read_container(write_container(comp)) if fits else comp)
    _require(np.array_equal(_host(out), data), "HTC1 round trip")
    if codec.device.type == "cuda":
        cpu = GapArrayCodec(codec.table, seg_bits=seg_bits, block_bytes=bb,
                            method=method, device="cpu")
        _require(_same_htc1(cpu.encode(data), comp, fits),
                 "HTC1 container: card != CPU")


def _staged(codec, dcomp, n) -> Compressed:
    comp = Compressed(table=codec.table, seg_bits=codec.seg_bits,
                      original_size=n, block_bytes=dcomp.block_bytes,
                      block_words=[], block_total_bits=[], block_gaps=[],
                      block_counts=[])
    codec.stage_host(dcomp, comp)
    return comp


def _gapdev(rng, data, max_len, device, p):
    bb = int(rng.choice([b for b in GAPDEV_BLOCK_BYTES if b <= data.size]))
    seg_bits = int(rng.choice(SEG_BITS))
    g = min(max(data.size // bb, 1), MAX_BLOCKS)
    d = np.zeros(g * bb, np.uint8)
    d[: min(d.size, data.size)] = data[: d.size]
    p.update(n=d.size, block_bytes=bb, blocks=g, seg_bits=seg_bits)
    codec = GapArrayCodec.fit(d, max_len=max_len, seg_bits=seg_bits,
                              block_bytes=bb, device=device)
    blocks = torch.from_numpy(d.reshape(g, bb)).to(codec.device)
    dcomp = codec.encode_device(blocks)
    out = codec.decode_device(dcomp)
    _require(torch.equal(out, blocks), "HTC1 device group round trip")
    comp = _staged(codec, dcomp, d.size)
    _blocks_to_oracle(rng, comp, d)
    fits = p["fits"] = _fits_htc1(comp)
    if codec.device.type == "cuda":
        cpu = GapArrayCodec(codec.table, seg_bits=seg_bits, block_bytes=bb,
                            device="cpu")
        ref = _staged(cpu, cpu.encode_device(blocks.cpu()), d.size)
        _require(_same_htc1(comp, ref, fits), "stage_host: card != CPU")


def _encode_block_fast(rng, data, max_len, device, p):
    """B5's path on whole 4096-byte groups from a slice at a drawn
    alignment, equal to `encode_block`; a block of any other size (a
    multiple of 4 or not) is refused on both devices."""
    align = tenc.MAP_ALIGN
    b = max(data.size // align, 1) * align
    bad = b + int(rng.integers(1, align))
    off = int(rng.choice([0, 1, 2, 4, 8, 12]))  # the slice's alignment
    seg_bits = int(rng.choice(SEG_BITS))
    buf = gen_data(rng, "redundant", off + bad)
    buf[off : off + min(b, data.size)] = data[:b]
    table = _table(buf[off:], max_len)
    total = int(table.lengths.astype(np.int64)[buf[off:]].sum())
    kw = dict(seg_bits=seg_bits, max_words=-(-total // 32) + 3,
              n_segs=-(-total // seg_bits) + 1)
    p.update(n=b, refused=bad, offset=off, seg_bits=seg_bits)
    dev = tils.resolve_device(device)
    enc = ils_enc_tabs(table, device=dev)
    whole = torch.from_numpy(buf).to(dev)
    got = tenc.encode_block_fast(whole[off : off + b], enc, **kw)
    x, e = whole[off : off + b].cpu(), enc.cpu()
    ref = tenc.encode_block(x, e, **kw)
    plain = tenc.encode_block_fast(x, e, **kw)
    for a, r, c in zip(got, ref, plain):
        _require(torch.equal(a.cpu(), r) and torch.equal(c, r),
                 "encode_block_fast != encode_block")
    for x, e in ((whole, enc), (whole.cpu(), enc.cpu())):
        try:
            tenc.encode_block_fast(x[off:], e, **kw)
        except ValueError as err:
            _require(f"multiple of {align}" in str(err), str(err))
        else:
            raise AssertionError(f"{bad} bytes encoded, not refused")


def _selfsync(rng, data, max_len, device, p):
    table = _table(data, max_len)
    words, total_bits = npref.encode_bits(data, table)
    dev = tils.resolve_device(device)
    out = selfsync_decode_device(
        torch.from_numpy(words.view(np.int32)).to(dev), total_bits, table)
    _require(np.array_equal(_host(out), data), "self-sync decode")
    out = decode_seq(write_seq(data, table), device=dev)
    _require(np.array_equal(_host(out), data), "decode_seq")


def _yamamoto(rng, data, max_len, device, p):
    table = _table(data, max_len)
    blob = write_yamamoto(data, table)
    for method in (None, "lut", "canonical"):
        out = decode_yamamoto(blob, method, device=device)
        _require(np.array_equal(_host(out), data), f"yamamoto[{method}]")
    try:  # the JAX package raises here on every container (ROADMAP F8)
        decode_yamamoto(blob, "twolevel", device=device)
    except ValueError as err:
        _require("two-level form" in str(err), str(err))
    else:
        raise AssertionError("yamamoto[twolevel] decoded")


_SECONDARY = dict(zip(SECONDARY, (_gap, _gapdev, _encode_block_fast,
                                  _selfsync, _yamamoto)))


def secondary_case(i, rng, device, *, which=None, max_bytes=MAX_BYTES,
                   params=None):
    """The secondary leg (`tools/fuzz.py::secondary_case`): ``which`` of
    `SECONDARY` (drawn when None) on 1 B to ``max_bytes`` of a drawn kind.
    Returns (which, params)."""
    p = {} if params is None else params
    which = str(rng.choice(SECONDARY)) if which is None else which
    kind = str(rng.choice(KINDS))
    n = int(np.exp(rng.uniform(0, np.log(max_bytes))))  # 1 B .. max_bytes
    p.update(leg=which, kind=kind, n=n)
    data = gen_data(rng, kind, n)
    max_len = _max_len(rng, data, p)
    _SECONDARY[which](rng, data, max_len, device, p)
    return which, p


def run_case(seed, i, device, *, max_bytes=MAX_BYTES, secondary_every=4):
    """Case ``i`` of seed ``seed``: the secondary leg every
    ``secondary_every`` cases (its kinds in turn), else the ILS leg.
    Returns (leg, params); raises `FuzzFailure` with the reproducer line."""
    rng = np.random.default_rng([seed, i])
    if i % BIG_EVERY == BIG_EVERY - 2:
        max_bytes *= BIG_FACTOR
    p = {}
    try:
        if secondary_every and i % secondary_every == secondary_every - 1:
            which = SECONDARY[(i // secondary_every) % len(SECONDARY)]
            return secondary_case(i, rng, device, which=which,
                                  max_bytes=max_bytes, params=p)
        return ils_case(i, rng, device, max_bytes=max_bytes, params=p)
    except Exception as e:
        raise FuzzFailure(
            f"fuzz FAIL seed={seed} iter={i} "
            + " ".join(f"{key}={val}" for key, val in p.items())
            + f" max_bytes={max_bytes} secondary_every={secondary_every}"
            + f" device={device}: {type(e).__name__}: {e}") from e


def case_line(i, leg, p, seconds) -> str:
    rest = " ".join(f"{key}={val}" for key, val in p.items()
                    if key not in ("leg", "n", "k", "L"))
    return (f"[{i:3d}] ok {leg:17s} n={p['n']} k={p.get('k', 0)} "
            f"L={p['L']} {rest} s={seconds:.3f}")


def _launch_counts() -> dict:
    out = {}
    for m in (ils_kernels, gap_decode_kernels, gap_encode_kernels,
              selfsync_kernels, encode_map_kernels, histogram_kernels):
        out.update(m.launch_counts())
    return out


def soak(seed, start, iters, device, *, max_bytes=MAX_BYTES,
         secondary_every=4, log=print) -> dict:
    """Cases start..start+iters-1 of ``seed``, each logged by ``log`` as
    it passes; the first divergence raises `FuzzFailure`.  Returns the
    cases, the legs, the seconds, and for each kernel wrapper its launches
    over the run, the cases it launched in and the distinct case shapes
    (`SHAPE_KEYS`) of those cases."""
    counts = _launch_counts()
    cases = dict.fromkeys(counts, 0)
    shapes = {name: set() for name in counts}
    legs = {}
    t0 = time.perf_counter()
    for i in range(start, start + iters):
        t = time.perf_counter()
        before = _launch_counts()
        leg, p = run_case(seed, i, device, max_bytes=max_bytes,
                          secondary_every=secondary_every)
        after = _launch_counts()
        legs[leg] = legs.get(leg, 0) + 1
        shape = (leg,) + tuple(str(p.get(key)) for key in SHAPE_KEYS)
        for name in cases:
            if after[name] > before[name]:
                cases[name] += 1
                shapes[name].add(shape)
        log(case_line(i, leg, p, time.perf_counter() - t))
    after = _launch_counts()
    return {"seed": seed, "cases": iters, "legs": legs,
            "seconds": time.perf_counter() - t0,
            "kernels": {name: {"launches": after[name] - counts[name],
                               "cases": cases[name],
                               "shapes": len(shapes[name])}
                        for name in cases}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--start", type=int, default=0,
                    help="first case index (reproduce case i with --start i "
                         "--iters 1)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--secondary-every", type=int, default=4, metavar="N",
                    help="run a secondary-path case every N cases (0: none)")
    ap.add_argument("--max-bytes", type=int, default=MAX_BYTES,
                    help="largest input of a case; the 15th of every 16 "
                         f"cases may be {BIG_FACTOR}x that")
    args = ap.parse_args(argv)
    device = tils.resolve_device(args.device)  # raises without a card
    try:
        r = soak(args.seed, args.start, args.iters, device,
                 max_bytes=args.max_bytes,
                 secondary_every=args.secondary_every,
                 log=lambda line: print(line, flush=True))
    except FuzzFailure as e:
        print(e, flush=True)
        return 1
    for name, k in r["kernels"].items():
        print(f"  {name:24s} launches={k['launches']} cases={k['cases']} "
              f"shapes={k['shapes']}")
    print(f"fuzz: {args.iters} cases PASS, seed {args.seed}, {device}, "
          f"{r['seconds']:.1f} s, legs {r['legs']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
