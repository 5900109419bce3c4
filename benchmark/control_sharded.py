"""The control of the comparison that decides ``correct``, for a cell of
several cards.

    python benchmark/control_sharded.py --workload <name> --seeds 1 2 3 [--seconds 2]

`control.py` drives one process and patches its driver's ``fit``; a patch
reaches no other rank.  Here each seed runs the whole cell on its ranks
(``python -m benchmark.ranks``, one card a rank), every rank given the
override `OVERRIDE`, which the sharded driver's ``fit`` reads: it builds
the table from every ``control.STRIDE``-th byte's global counts plus one,
the guarantee `control.py` breaks on one card.  Everything else is the
program's own path, through the cell's set-up, a short window at the
cell's own load, and the check.  Each seed prints the checks; a sound
comparison fails every control seed.  Runs on the cards; tests run the
same override on the CPU at a small size (`benchmark/tests`).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# control.STRIDE: the every-16th-byte table of the one-card control
OVERRIDE = {"config": {"control_stride": 16}}


def ranks_command(workload: str, seed: int, seconds: float, world: int,
                  device: str, overrides=None) -> list[str]:
    """The command that runs rank 0 of the cell, with the control's
    override laid over ``overrides``."""
    over = {key: {**(overrides or {}).get(key, {}), **OVERRIDE.get(key, {})}
            for key in ("config", "mix")}
    return [sys.executable, "-m", "benchmark.ranks", "--rank", "0", "--world",
            str(world), "--device", device, "--workload", workload, "--seed",
            str(seed), "--seconds", str(seconds), "--trace", "0",
            "--overrides", json.dumps(over)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != here]
    import torch

    from benchmark import spec as specs

    world = specs.cell(specs.load_spec(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"control_sharded.py needs {world} CUDA devices", file=sys.stderr)
        return 2
    failed = 0
    for seed in args.seeds:
        p = subprocess.run(ranks_command(args.workload, seed, args.seconds,
                                         world, "cuda"),
                           cwd=ROOT, capture_output=True, text=True)
        lines = p.stdout.strip().splitlines()
        if p.returncode or not lines or not lines[-1].startswith("{"):
            print(f"seed {seed}: the run ended with code {p.returncode}\n"
                  f"{p.stderr[-3000:]}", file=sys.stderr, flush=True)
            return 1
        out = json.loads(lines[-1])
        checks = {k: v["value"] for k, v in out["checks"].items()}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"], "checks": checks}),
              flush=True)
        failed += not out["correct"]
    print(f"{failed} of {len(args.seeds)} seeds read not correct", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
