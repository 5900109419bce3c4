"""The control of the comparison that decides ``correct``.

    python benchmark/control.py --workload <name> --seeds 1 2 3 [--seconds 2]

The codec states no precision, so the control breaks one guarantee that
its configuration states: the table is the optimal code of the input's
histogram.  The control counts only every ``STRIDE``-th byte, and adds one
to every count so that no byte lacks a code: the shortcut that would
tempt a later change, since the histogram is the largest device operation
of an ILS encode.  Everything else is the program's own path, through the
cell's set-up, a short window at the cell's own load, and the check.  Each
seed prints the checks; a sound comparison fails every control seed.
Runs on the card; tests run it on the CPU at a small size
(`benchmark/tests`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

STRIDE = 16
DRIVER_NEEDS = ("fit_from_freqs",)


def sampled_fit(driver):
    """The driver's `fit` with the control's table."""
    import torch

    def fit(cfg, data):
        counts = torch.bincount(data.reshape(-1)[::STRIDE], minlength=256)
        return driver.fit_from_freqs(cfg, counts.cpu().numpy() + 1, data.device)

    return fit


def run_seed(workload: str, seed: int, seconds: float, device, *,
             overrides=None) -> dict:
    from benchmark import spec as specs
    from benchmark.run import Run, execute

    t0 = time.perf_counter()
    spec = specs.load_spec()
    cfg = specs.config(spec, specs.cell(spec, workload)["config"])
    cfg.update((overrides or {}).get("config", {}))
    run = Run(workload, seed, False, device, spec=spec, overrides=overrides,
              patch={"fit": sampled_fit(specs.driver(cfg["driver"]))})
    out = execute(run, seconds, t0)
    run.free()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    root = str(Path(__file__).resolve().parents[1])
    sys.path[:] = [root] + [p for p in sys.path
                            if Path(p or ".").resolve() != Path(__file__).resolve().parent]
    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    failed = 0
    for seed in args.seeds:
        out = run_seed(args.workload, seed, args.seconds, "cuda:0")
        checks = {k: v["value"] for k, v in out["checks"].items()}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"], "checks": checks}),
              flush=True)
        failed += not out["correct"]
    print(f"{failed} of {len(args.seeds)} seeds read not correct", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
