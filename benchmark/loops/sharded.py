"""``sharded``: one caller on each card, a closed loop of calls on one
stream whose bytes lie on the ranks in rank order.

Set-up opens the program's process group at ``run.ranks.address`` and
makes ``inputs`` distinct inputs, each rank its own shard of each, from
the seed, the input and the rank (`shard_input`); it fits one table for
each input on the global histogram (a collective call, the same table on
every rank) and encodes and decodes each once: those shards are what the
decode half reads.  The first ``encode_share`` of the window encodes the
inputs in turn; the rest decodes their shards in turn, each decode
gathering the whole stream in order onto every card.  Each call ends in a
synchronise, and every ``AGREE_EVERY``-th in `Ranks.agree`, so every rank
makes the same calls and stops after the same one; a call that raises on
any rank ends the run, and never leaves the others in a collective of
another call.  Each rate is the whole stream's bytes of every call of a
half over rank 0's time of that half.

The check judges two calls of each half, one drawn from the seed among
the first ``SAMPLE_BELOW`` and the last: every rank compares the whole
stream each kept decode returned with the input, rebuilt from the seed
and every rank; the program writes the kept encodes' ordered containers
and rank 0 hands each, with its whole input, to the plain reference.
"""

from __future__ import annotations

import time

import torch

from benchmark import datagen
from benchmark.reference.huffman import diff_bytes
from benchmark.traffic import SAMPLE, slices, sync

SAMPLE_BELOW = 16
# calls between two agreements: each is a round trip through rank 0's
# store, which on four H100s stalled a worker 0.5-6 ms at a time; once a
# call it held the ranks' next collective back by as much, and the decode
# rate of 6 runs spread 28%, so the stalls are paid once in 16 calls
AGREE_EVERY = 16
# the seed's sub-streams of the shards: STREAM + (input << 8) + rank
STREAM = 1000
DRIVER_NEEDS = ("open_group", "close_group", "input_shape", "fit", "encode",
                "decode", "container")


def shard_input(run, i: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s bytes of input ``i``, made on this rank's device."""
    cfg = run.config
    return datagen.redundant(cfg["n_bytes"], cfg["redundancy"], run.seed,
                             STREAM + (i << 8) + rank, run.device)


def whole_input(run, i: int) -> torch.Tensor:
    """Input ``i`` whole: every rank's shard, in rank order."""
    return torch.cat([shard_input(run, i, r) for r in range(run.ranks.world)])


def _calls(run, phase: str, fn, seconds: float, keep: set):
    """Call ``fn(n)`` for n = 0, 1, ... back to back until rank 0 has
    spent ``seconds``; returns (calls, elapsed, kept outputs by call)."""
    n, kept, last, ends, took, agree_s = 0, {}, None, [], [], 0.0
    with run.tracer.stage(phase) as rec:
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            with run.tracer.span(phase):
                last = fn(n)
                sync(run.device)
            if n in keep:
                kept[n] = last
            n += 1
            elapsed = time.perf_counter() - t0
            ends.append(elapsed)
            took.append(elapsed - (t - t0))
            if n % AGREE_EVERY == 0:
                t = time.perf_counter()
                stop = run.ranks.agree(elapsed >= seconds)
                agree_s += time.perf_counter() - t
                if stop:
                    break
        elapsed = time.perf_counter() - t0
        rec["calls"] = n
    kept[n - 1] = last
    run.note(f"{phase} median ms a call by second of the window "
             f"{[round(1e3 * x, 4) for x in slices(ends, took, 1.0)]}; "
             f"agree {1e3 * agree_s * AGREE_EVERY / n:.4f} ms a time")
    return n, elapsed, kept


def setup(run) -> dict:
    cfg, ranks = run.config, run.ranks
    mesh = run.codec.open_group(ranks.address, ranks.world, ranks.rank,
                                run.device)
    shape = run.codec.input_shape(cfg, cfg["n_bytes"])
    data = [shard_input(run, i, ranks.rank).view(*shape)
            for i in range(run.mix["inputs"])]
    codecs = [run.codec.fit(cfg, mesh, d) for d in data]
    # one round over the inputs warms every shape and leaves each its shard
    shards = []
    for codec, d in zip(codecs, data):
        shards.append(run.codec.encode(codec, d))
        run.codec.decode(codec, shards[-1])
        sync(run.device)
    return {"mesh": mesh, "data": data, "codecs": codecs, "shards": shards}


def window(run, st: dict, seconds: float) -> dict:
    whole = run.config["n_bytes"] * run.ranks.world
    pick = datagen.rng(run.seed, SAMPLE)
    codecs, data, shards = st["codecs"], st["data"], st["shards"]
    k = len(codecs)
    enc_s = seconds * run.mix["encode_share"]
    n_e, t_e, st["encoded"] = _calls(
        run, "encode", lambda n: run.codec.encode(codecs[n % k], data[n % k]),
        enc_s, {int(pick.integers(SAMPLE_BELOW))})
    n_d, t_d, st["decoded"] = _calls(
        run, "decode",
        lambda n: run.codec.decode(codecs[n % k], shards[n % k]),
        seconds - enc_s, {int(pick.integers(SAMPLE_BELOW))})
    enc, dec = n_e * whole / t_e / 1e9, n_d * whole / t_d / 1e9
    run.note(f"rank {run.ranks.rank}: encode {n_e} calls in {t_e:.6f} s, "
             f"decode {n_d} calls in {t_d:.6f} s over {k} inputs in turn, "
             f"kept calls encode {sorted(st['encoded'])} decode "
             f"{sorted(st['decoded'])}; each card's share of the rate: "
             f"encode {enc / run.ranks.world:.6f} decode "
             f"{dec / run.ranks.world:.6f} GB/s")
    return {"attempted": n_e + n_d, "failed": 0, "encode_gbps": enc,
            "decode_gbps": dec}


def check(run, st: dict, res: dict) -> dict:
    """Every rank writes the kept encodes' containers (a collective call)
    and judges its kept decodes; the program's state is freed first and
    rank 0 then hands the containers to the reference."""
    ranks, k = run.ranks, run.mix["inputs"]
    whole = run.config["n_bytes"] * ranks.world
    enc = sorted(st.pop("encoded").items())
    blobs = [(n, run.codec.container(st["codecs"][n % k], shard))
             for n, shard in enc]
    decoded = sorted(st.pop("decoded").items())
    del enc, st["codecs"], st["shards"], st["data"]
    run.free()
    counts = {"decode_byte_diff": 0,
              "missing_answers": res["failed"] + int(not decoded)}
    while decoded:
        n, out = decoded.pop(0)
        counts["decode_byte_diff"] += diff_bytes(out, whole_input(run, n % k))
        del out
    if ranks.rank == 0:
        res["ratio"] = len(blobs[-1][1]) / whole
        counts["missing_answers"] += int(not blobs)
        while blobs:  # one container at a time: each holds the whole stream
            n, blob = blobs.pop(0)
            got = run.reference.check([blob], [whole_input(run, n % k)],
                                      run.config["max_len"], run.device)
            for key, value in got.items():
                counts[key] = counts.get(key, 0) + value
            del blob
    run.codec.close_group(st.pop("mesh"))
    return counts
