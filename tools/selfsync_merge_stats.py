#!/usr/bin/env python3
"""How far the 16 entry walks of a self-sync subsequence run before they
meet, on a canonical code fitted to generated data (host NumPy walk, no
card needed).

    python tools/selfsync_merge_stats.py [--size BYTES] [--redundancy R]
                                         [--seed S] [--samples N]

For N subsequences of 1024 bits drawn at random from the stream, each
entry e = 1..15 walks from bit e: the codewords it takes before it lands
on a start of walk 0 (never, within the subsequence, counts apart), and
before it lands on a start of any earlier entry's walk.  It also prints
the codewords a warp of 32 consecutive subsequences walks when its lanes
take their 16 entries one after another in one loop ("flat": the largest
lane sum) and when every entry is a loop of its own ("per entry": the sum
over entries of the largest lane), for entries stopping at walk 0 or at
any earlier walk.  These decide the work of the transition kernel C2
(huffman_tpu_torch/csrc/selfsync.cu).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from huffman_tpu_torch import GapArrayCodec  # noqa: E402
from huffman_tpu_torch.core import npref  # noqa: E402
from huffman_tpu_torch.utils import generate_redundant  # noqa: E402

SEG_BITS = 1024


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=1 << 21)
    ap.add_argument("--redundancy", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--samples", type=int, default=320)
    args = ap.parse_args(argv)

    data = generate_redundant(args.size, args.redundancy, seed=args.seed)
    table = GapArrayCodec.fit(data, device="cpu").table
    words, total_bits = npref.encode_bits(data, table)
    w = [int(x) for x in words]
    lim = [int(x) for x in table.lim_left]
    lo, hi = table.min_len, table.max_len_present
    lens = np.bincount(table.lengths[data], minlength=17)
    print(f"{args.size} B of generate_redundant(r={args.redundancy}, "
          f"seed={args.seed}): code lengths {lo}..{hi}, codewords by length "
          f"{ {n: int(c) for n, c in enumerate(lens) if c} }")

    def length(pos):
        j, sh = pos >> 5, pos & 31
        win = (((w[j] << 32) | w[j + 1]) << sh) >> 32 & 0xFFFFFFFF
        return lo + sum(win >= lim[lv] for lv in range(lo, hi))

    def walk(base, e, stop):
        q, steps = e, 0
        while q < SEG_BITS and q not in stop:
            q += length(base + q)
            steps += 1
        return q, steps

    n_subseq = total_bits // SEG_BITS - 1
    first = np.random.default_rng(args.seed).integers(
        0, n_subseq - 32, max(args.samples // 32, 1))
    meet0, at0, never0, cost = [], [], 0, {"walk0": [], "any": []}
    for f in first:
        for i in range(int(f), int(f) + 32):
            base = i * SEG_BITS
            starts0, q = set(), 0
            while q < SEG_BITS:
                starts0.add(q)
                q += length(base + q)
            per0, per_any, seen = [len(starts0)], [len(starts0)], set(starts0)
            for e in range(1, 16):
                q, steps = walk(base, e, starts0)
                per0.append(steps)
                if q >= SEG_BITS:
                    never0 += 1
                else:
                    meet0.append(steps)
                    at0.append(q)
                q, steps = e, 0
                while q < SEG_BITS and q not in seen:
                    seen.add(q)
                    q += length(base + q)
                    steps += 1
                per_any.append(steps)
            cost["walk0"].append(per0)
            cost["any"].append(per_any)
    n = len(first) * 32
    m = np.array(meet0)
    print(f"{n} subsequences of {SEG_BITS} bits, {15 * n} entries 1..15: "
          f"walk 0 takes {np.mean([c[0] for c in cost['walk0']]):.1f} "
          f"codewords; an entry meets it after a median "
          f"{np.median(m):.0f} codewords (90th percentile "
          f"{np.percentile(m, 90):.0f}), at a median offset of "
          f"{np.median(at0):.0f} bits; {never0} entries "
          f"({100 * never0 / (15 * n):.1f}%) meet it nowhere in the "
          f"subsequence")
    for rule, per in cost.items():
        per = np.array(per).reshape(-1, 32, 16)
        print(f"  stop at {'walk 0' if rule == 'walk0' else 'any earlier walk'}: "
              f"{per.sum(2).mean():.0f} codewords a subsequence; a warp "
              f"walks {per.sum(2).max(1).mean():.0f} (flat) or "
              f"{per.max(1).sum(1).mean():.0f} (per entry); 16 full walks "
              f"take {16 * per[:, :, 0].mean():.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
