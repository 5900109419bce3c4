"""One run of one benchmark cell of huffman_tpu_torch on the card.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json ``workloads``) names a configuration and a
traffic mix, found by name (`spec`).  The run makes its inputs on the
device from the seed and warms up every shape its window uses (set-up),
drives the program for ``--seconds`` (the window), then judges what the
window produced against the plain reference.  A cell that asks for more
than one card runs one rank a card: this process is rank 0 on ``cuda:0``
and starts the others (`benchmark/ranks.py`).  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics, read from a profiled window), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit, which also end standard error.  Earlier lines say what
the run saw.

It runs only on a CUDA device and fails without one.  The program's
kernel build stays inside the checkout (``build/``), and the caches a
library could write go under ``build/bench_cache/``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench_cache"
FORBIDDEN = {"jax", "jaxlib", "flax", "huffman_tpu"}


def _paths() -> None:
    """Import the benchmark as a package from the checkout's root, never
    its own folder (whose module names would shadow the library's)."""
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != Path(here)]
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    # one process with few threads: the host's share of a run stays steady
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


class Run:
    """One cell's parts, its seed and device, and the run's notes.

    ``overrides`` replaces keys of the configuration or the mix (tests
    run cells at a size the CPU holds); ``patch`` replaces functions of
    the configuration's driver (the control's table, the planted
    faults); ``parts`` is a second folder of parts, searched first (the
    tests' own, `spec`).  ``ranks`` is None on one card, and on more the
    rank's view of the others (`benchmark/ranks.py`)."""

    def __init__(self, workload: str, seed: int, traced: bool, device, *,
                 spec=None, overrides=None, patch=None, parts=None):
        import torch

        from benchmark import spec as specs
        from benchmark.trace import Tracer

        overrides = overrides or {}
        self.spec = spec or specs.load_spec()
        self.cell = specs.cell(self.spec, workload)
        self.config = {**specs.config(self.spec, self.cell["config"]),
                       **overrides.get("config", {})}
        self.mix = {**specs.mix(self.cell["traffic"], parts),
                    **overrides.get("mix", {})}
        driver = specs.driver(self.config["driver"], parts)
        public = {k: v for k, v in vars(driver).items()
                  if callable(v) and not k.startswith("_")}
        self.codec = types.SimpleNamespace(**{**public, **(patch or {})})
        self.reference = specs.reference(self.config["reference"], parts)
        self.loop = specs.loop(self.mix["loop"], parts)
        self.parts = parts
        self.ranks = None
        self.seed = int(seed)
        self.device = torch.device(device)
        self.tracer = Tracer(traced, self.device)
        self.limits = json.loads((ROOT / "benchmark" / "limits.json").read_text())

    def note(self, msg: str) -> None:
        print(msg, flush=True)

    def peak_bytes(self) -> int:
        import torch

        return (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)

    def free(self) -> None:
        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", "0"], capture_output=True, text=True, timeout=20).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def _top(counter: dict, n: int = 10) -> list:
    return [[name[:160], sec] for name, sec in
            sorted(counter.items(), key=lambda kv: -kv[1])[:n]]


def execute(run: Run, seconds: float, t0: float) -> dict:
    """Set-up, window and check of one run; returns the result line."""
    import torch

    from benchmark import spec as specs

    setup, window, check = run.loop.setup, run.loop.window, run.loop.check
    on_card = run.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    st = setup(run)
    sync()
    if run.ranks is not None:
        run.ranks.barrier("setup")  # every rank's start and set-up count
    # the set-up's objects leave the collector's scans, so a collection in
    # the window costs what the window's own garbage costs
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    run.note(f"setup_s {setup_s:.6f}")
    if run.tracer.traced:
        seconds = min(seconds, run.mix.get("trace_seconds", seconds))
    res = window(run, st, seconds)
    sync()
    peak = run.peak_bytes()
    counts = check(run, st, res)
    if run.ranks is not None:
        # rank 0 takes the fullest card's peak and the sum of every rank's
        # counts; another rank hands its own over and is done
        peak, counts = run.ranks.gather(peak, counts, forbidden_modules())
        if run.ranks.rank:
            return {}
    res["setup_s"] = setup_s
    checks = {k: {"value": v, "limit": run.limits[k]} for k, v in counts.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    kind = torch.cuda.get_device_name(run.device) if on_card else "cpu"
    device = {"platform": "gpu" if on_card else "cpu", "kind": kind,
              "count": int(run.cell["chips"]), "memory_peak_bytes": int(peak)}
    if on_card:
        device["power_limit_w"] = _power_limit_w()
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": {}, "device": device}
    if run.tracer.traced:
        ctx = types.SimpleNamespace(
            stages=run.tracer.stages, host=run.tracer.host, on_card=on_card,
            device_kind=kind, least_bytes=res.get("least_bytes", {}), window=res)
        for m in specs.per_layer(run.spec, run.cell["name"]):
            value = specs.metric_reader(m["name"], run.parts).read(ctx)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        ops, idle, gaps = {}, {}, {}
        for name, st_ in run.tracer.stages.items():
            run.note(f"trace {name}: {st_['calls']} calls, {st_['n_ops']} device "
                     f"ops, busy {st_['busy_s']:.6f} of {st_['window_s']:.6f} s; "
                     f"launches: program kernels in trace {st_['port_kernels']}, "
                     f"wrapper counters {st_['launch_counts']} (kernels missing "
                     f"{st_['missing_kernels']}), runtime launches without a "
                     f"device record {st_['lost_launches']} of {st_['launches']}"
                     f"; charged for the missing {st_['imputed_s']:.6f} s"
                     + ("" if st_["launches_ok"] else
                        " -- the trace lost launches: its device metrics are left out"))
            for k, v in st_["ops_by_name"].items():
                ops[k] = ops.get(k, 0.0) + v
            for k, v in st_["idle_by_span"].items():
                idle[k] = idle.get(k, 0.0) + v
            for span, sec, at in st_["longest_gaps"]:
                gaps[f"{name}/{span} at {at:.6f} s"] = sec
        run.note(f"trace idle seconds by span {idle}")
        device["busy_s"] = sum(s["busy_s"] for s in run.tracer.stages.values())
        device["window_s"] = sum(s["window_s"] for s in run.tracer.stages.values())
        out["breakdown"] = {"device_ops": _top(ops), "idle_gaps": _top(gaps)}
    else:
        for m in specs.end_to_end(run.spec, run.cell["name"]):
            out["metrics"][m["name"]] = {"value": res[m["name"]], "unit": m["unit"]}
    out["checks"] = checks
    return out


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    import torch

    from benchmark import spec as specs

    chips = specs.cell(specs.load_spec(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if chips == 1:
        run = Run(args.workload, args.seed, bool(args.trace), "cuda:0")
        return report(execute(run, args.seconds, T0))
    from benchmark import ranks

    return report(*ranks.lead(args.workload, args.seed, args.seconds,
                              bool(args.trace), chips, "cuda", t0=T0))


def report(out: dict, others: list[str] = ()) -> int:
    """Print the checks and the result line; or, where this process or
    another rank (``others``) loaded JAX or the JAX package, say so and
    print no result."""
    bad = sorted(set(others) | set(forbidden_modules()))
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
