"""The ranks of a cell that asks for more than one card.

``run.py`` is rank 0, on ``cuda:0``.  Before set-up it starts one worker
process for each further card, ``python -m benchmark.ranks --rank r ...``,
which runs on ``cuda:r`` (on the CPU in tests).  Each worker builds its
own `Run` of the same cell, seed, trace flag and overrides, with
``run.ranks`` set, and runs the loop's set-up, window and check as rank 0
does (`run.execute`).  A traced run profiles rank 0 alone: that card's
view of the collectives.

``run.ranks`` (`Ranks`) holds ``rank``, ``world``, ``address`` (a
``host:port`` where the loop's driver opens the program's own process
group through the port's ``init_multihost``) and a control channel of the
harness's own, a ``torch.distributed.TCPStore`` that never touches a
card: ``agree(stop)`` lets rank 0 end a stretch of the window so that
every rank stops after the same number of calls, and ``barrier(name)``
waits for every rank.  Rank 0's set-up ends when every rank's has, so the
ranks' start-up counts in ``setup_s``.

Once its check is done each rank hands over its peak device memory, its
counts and the modules of run.py's ``FORBIDDEN`` it loaded.  Rank 0
reports the largest peak and the sum of the counts, and run.py fails the
run where any rank loaded one.  A worker that raises, exits or is killed
before it handed over ends the run, with no result line, within a second
or so; a worker whose rank 0 is gone ends itself; and every wait on the
channel ends after ``TIMEOUT_S``.

Tests drive rank 0 on the CPU the same way:

    python -m benchmark.ranks --rank 0 --world 4 --device cpu \\
        --workload <name> --seed <n> --seconds <s> --trace 0 \\
        [--spec <file>] [--parts <dir>] [--overrides <json>]
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HOST = "127.0.0.1"
# a checkout's first run of a cell builds the program's kernels in set-up
TIMEOUT_S = 1200
POLL_S = 0.2


def _store(port: int, master: bool):
    from torch.distributed import TCPStore

    return TCPStore(HOST, port, is_master=master, wait_for_workers=False,
                    timeout=datetime.timedelta(seconds=TIMEOUT_S))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind((HOST, 0))
        return s.getsockname()[1]


def _device(kind: str, rank: int) -> str:
    return f"cuda:{rank}" if kind == "cuda" else "cpu"


class Ranks:
    """One rank's view of the others (``run.ranks``)."""

    def __init__(self, rank: int, world: int, address: str, store):
        self.rank, self.world, self.address = rank, world, address
        self.store = store
        self.peaks: dict[int, int] = {}        # rank 0: each rank's peak
        self.forbidden: dict[int, list] = {}   # rank 0: what others loaded
        self._round = 0

    def agree(self, stop: bool) -> bool:
        """Rank 0's ``stop`` on every rank.  Every rank calls it once a
        call of the window, so they stop after the same call."""
        key = f"agree/{self._round}"
        self._round += 1
        if self.rank == 0:
            self.store.set(key, b"1" if stop else b"0")
            return stop
        return self.store.get(key) == b"1"

    def barrier(self, name: str) -> None:
        """Wait until every rank has come here."""
        if self.store.add(f"barrier/{name}", 1) == self.world:
            self.store.set(f"barrier/{name}/all", b"1")
        self.store.wait([f"barrier/{name}/all"])

    def gather(self, peak: int, counts: dict, forbidden: list) -> tuple:
        """Hand this rank's peak, counts and forbidden modules over; on
        rank 0, return the largest peak and the counts summed over all."""
        if self.rank:
            self.store.set(f"rank/{self.rank}", json.dumps(
                {"peak": peak, "counts": counts, "forbidden": forbidden}))
            return peak, counts
        total, self.peaks = dict(counts), {0: peak}
        for r in range(1, self.world):
            got = json.loads(self.store.get(f"rank/{r}"))
            self.peaks[r] = got["peak"]
            if got["forbidden"]:
                self.forbidden[r] = got["forbidden"]
            for k, v in got["counts"].items():
                total[k] = total.get(k, 0) + v
        return max(self.peaks.values()), total


class Workers:
    """Rank 0's worker processes, and a thread that ends the whole run
    as soon as one of them ends before it handed its results over."""

    def __init__(self, procs: dict, port: int):
        self.procs = procs
        self._probe = _store(port, False)  # the watch's own connection
        self._closed = threading.Event()
        self._lock = threading.Lock()
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        while not self._closed.wait(POLL_S):
            for r, p in self.procs.items():
                code = p.poll()
                if code is None or (code == 0 and self._probe.check([f"rank/{r}"])):
                    continue
                with self._lock:
                    if self._closed.is_set():
                        return
                    print(f"rank {r} ended with code {code} before it handed "
                          "its results over: the run fails", file=sys.stderr,
                          flush=True)
                    sys.stdout.flush()
                    self._end()
                    os._exit(4)

    def _end(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.terminate()
        for p in self.procs.values():
            try:
                p.wait(5)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def join(self) -> None:
        """Wait for every worker to end; one that ends badly fails the run."""
        deadline = time.monotonic() + 60
        for r, p in self.procs.items():
            code = p.wait(max(deadline - time.monotonic(), POLL_S))
            if code:
                raise RuntimeError(f"rank {r} ended with code {code}")
        self.stop()

    def stop(self) -> None:
        """End the watch and any worker still running."""
        with self._lock:
            self._closed.set()
        self._end()


def lead(workload: str, seed: int, seconds: float, traced: bool, world: int,
         device: str, *, t0: float, spec_path=None, parts=None,
         overrides=None) -> tuple[dict, list]:
    """Rank 0: start the other ranks, run the cell here with them, and
    return the result line and what of ``FORBIDDEN`` the others loaded."""
    from benchmark import spec as specs
    from benchmark.run import Run, execute

    store = _store(0, True)
    address = f"{HOST}:{_free_port()}"
    args = ["--workload", workload, "--seed", str(seed), "--seconds",
            repr(float(seconds)), "--trace", str(int(traced)), "--world",
            str(world), "--device", device, "--store", str(store.port),
            "--address", address]
    for flag, value in (("--spec", spec_path), ("--parts", parts)):
        if value is not None:
            args += [flag, str(Path(value).resolve())]
    if overrides:
        args += ["--overrides", json.dumps(overrides)]
    # a worker's lines go to standard error, so the result line stays last
    # on standard output
    workers = Workers({r: subprocess.Popen(
        [sys.executable, "-m", "benchmark.ranks", "--rank", str(r), *args],
        cwd=ROOT, stdout=2, stderr=2) for r in range(1, world)}, store.port)
    try:
        run = Run(workload, seed, traced, _device(device, 0),
                  spec=specs.load_spec(spec_path), overrides=overrides,
                  parts=parts)
        run.ranks = Ranks(0, world, address, store)
        run.note("ranks " + ", ".join(
            f"{r} pid {p.pid}" for r, p in workers.procs.items()))
        out = execute(run, seconds, t0)
        workers.join()
    finally:
        workers.stop()
    run.note(f"peak bytes by rank {run.ranks.peaks}")
    for r, names in run.ranks.forbidden.items():
        print(f"rank {r} loaded {names}", file=sys.stderr, flush=True)
    return out, sorted({n for names in run.ranks.forbidden.values()
                        for n in names})


def _orphaned(leader: int) -> None:
    while os.getppid() == leader:
        time.sleep(POLL_S)
    print("rank 0 is gone: this rank ends", file=sys.stderr, flush=True)
    os._exit(5)


def work(args, t0: float) -> int:
    """A worker: rank ``args.rank`` of the cell, on its own card."""
    import torch

    from benchmark import spec as specs
    from benchmark.run import Run, execute

    threading.Thread(target=_orphaned, args=(os.getppid(),), daemon=True).start()
    device = _device(args.device, args.rank)
    if device != "cpu":
        torch.cuda.set_device(device)  # nothing of this rank lands on card 0
    run = Run(args.workload, args.seed, False, device,
              spec=specs.load_spec(args.spec), parts=args.parts,
              overrides=json.loads(args.overrides) if args.overrides else None)
    run.note = lambda msg: print(f"rank {args.rank}: {msg}", flush=True)
    run.ranks = Ranks(args.rank, args.world, args.address,
                      _store(args.store, False))
    seconds = args.seconds
    if args.trace:  # the window rank 0 profiles
        seconds = min(seconds, run.mix.get("trace_seconds", seconds))
    execute(run, seconds, t0)
    return 0


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--store", type=int, help="rank 0's channel port (workers)")
    ap.add_argument("--address", help="the program's group, host:port (workers)")
    ap.add_argument("--spec", type=Path, help="in place of BENCHMARK.json")
    ap.add_argument("--parts", type=Path, help="a second folder of parts")
    ap.add_argument("--overrides", help="JSON: keys of the config and the mix")
    args = ap.parse_args(argv)
    from benchmark.run import _paths, report

    _paths()
    if args.rank:
        return work(args, t0)
    return report(*lead(
        args.workload, args.seed, args.seconds, bool(args.trace), args.world,
        args.device, t0=t0, spec_path=args.spec, parts=args.parts,
        overrides=json.loads(args.overrides) if args.overrides else None))


if __name__ == "__main__":
    sys.exit(main())
