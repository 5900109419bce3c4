"""``bulk``: one caller, a closed loop of whole-input calls.

Set-up makes ``inputs`` distinct inputs from the seed, each of the
configuration's size and distribution, fits the program's codec on each
and encodes each once: those containers are what the decode half reads.
The first ``encode_share`` of the window encodes the inputs in turn, back
to back; the rest decodes their containers in turn.  So no call takes the
bytes that the call before it took, and an answer kept from an earlier
call is not this call's answer unless a whole round of inputs was kept.
Each call ends in a synchronise, and each rate is all the bytes of a half
over all its time.  The check judges two calls of each half, one drawn
from the seed among the first ``SAMPLE_BELOW`` and the last, each against
its own input.
"""

from __future__ import annotations

import time

from benchmark import datagen
from benchmark.reference.huffman import diff_bytes
from benchmark.traffic import DATA, SAMPLE, slices, sync

SAMPLE_BELOW = 16


def _calls(run, phase: str, fn, seconds: float, keep: set):
    """Call ``fn(n)`` for n = 0, 1, ... back to back for ``seconds``;
    returns (calls, failed, elapsed, kept outputs by call index)."""
    n = failed = 0
    kept, last, ends, took = {}, None, [], []
    with run.tracer.stage(phase) as rec:
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            with run.tracer.span(phase):
                try:
                    last = fn(n)
                    sync(run.device)
                except Exception as exc:  # a failed call counts; the run goes on
                    run.note(f"{phase} call {n} failed: {exc!r}")
                    failed += 1
                    last = None
            if n in keep:
                kept[n] = last
            n += 1
            elapsed = time.perf_counter() - t0
            ends.append(elapsed)
            took.append(elapsed - (t - t0))
            if elapsed >= seconds:
                break
        rec["calls"] = n
    kept[n - 1] = last
    run.note(f"{phase} median ms a call by second of the window "
             f"{[round(1e3 * x, 4) for x in slices(ends, took, 1.0)]}")
    return n, failed, elapsed, kept


def setup(run) -> dict:
    cfg, k = run.config, run.mix["inputs"]
    shape = run.codec.input_shape(cfg, cfg["n_bytes"])
    data = datagen.redundant(k * cfg["n_bytes"], cfg["redundancy"], run.seed,
                             DATA, run.device).view(k, *shape)
    codecs = [run.codec.fit(cfg, d) for d in data]
    # one round over the inputs warms every shape and leaves each its
    # container
    comps = []
    for codec, d in zip(codecs, data):
        comps.append(run.codec.encode(codec, d))
        run.codec.decode(codec, comps[-1])
        sync(run.device)
    return {"data": data, "codecs": codecs, "comps": comps}


def window(run, st: dict, seconds: float) -> dict:
    n_bytes = run.config["n_bytes"]
    pick = datagen.rng(run.seed, SAMPLE)
    codecs, data, comps = st["codecs"], st["data"], st["comps"]
    k = len(codecs)
    enc_s = seconds * run.mix["encode_share"]
    n_e, f_e, t_e, st["encoded"] = _calls(
        run, "encode", lambda n: run.codec.encode(codecs[n % k], data[n % k]),
        enc_s, {int(pick.integers(SAMPLE_BELOW))})
    n_d, f_d, t_d, st["decoded"] = _calls(
        run, "decode", lambda n: run.codec.decode(codecs[n % k], comps[n % k]),
        seconds - enc_s, {int(pick.integers(SAMPLE_BELOW))})
    run.note(f"encode {n_e} calls in {t_e:.6f} s, decode {n_d} calls in "
             f"{t_d:.6f} s over {k} inputs in turn, kept calls encode "
             f"{sorted(st['encoded'])} decode {sorted(st['decoded'])}")
    dec = n_d * n_bytes / t_d / 1e9
    run.note(f"vs_baseline (decode GB/s over sequential.cpp's 0.00517) "
             f"{dec / 0.00517:.1f}")
    return {"attempted": n_e + n_d, "failed": f_e + f_d,
            "encode_gbps": n_e * n_bytes / t_e / 1e9, "decode_gbps": dec}


def check(run, st: dict, res: dict) -> dict:
    """The program writes the kept encodes' containers; its state is then
    freed and the reference judges those containers and the kept decodes,
    each against the input its call took."""
    data, k = st["data"], run.mix["inputs"]
    enc = [(n, c) for n, c in sorted(st.pop("encoded").items()) if c is not None]
    blobs = [run.codec.container(st["codecs"][n % k], c) for n, c in enc]
    inputs = [data[n % k] for n, _ in enc]
    del enc
    n_bytes = run.config["n_bytes"]
    res["ratio"] = len(blobs[-1]) / n_bytes if blobs else float("nan")
    least = n_bytes + sum(map(len, blobs)) / len(blobs) if blobs else 0
    res["least_bytes"] = {"encode": least, "decode": least}
    decoded = [(n, d) for n, d in st.pop("decoded").items() if d is not None]
    del st["codecs"], st["comps"]
    run.free()
    counts = run.reference.check(blobs, inputs, run.config["max_len"],
                                 run.device)
    counts["decode_byte_diff"] = sum(diff_bytes(d, data[n % k])
                                     for n, d in decoded)
    counts["missing_answers"] = (int(not blobs) + int(not decoded)
                                 + res["failed"])
    return counts
