"""Finds a cell's parts by the names in BENCHMARK.json.

Everything that belongs to one configuration, traffic mix, codec or
per-layer metric is a file of its own, found by name:

- ``configs/<config>.json``: the deployment (sizes, settings), which names
  its ``driver`` and its ``reference``;
- ``mixes/<traffic>.json``: the traffic's parameters, whose ``loop`` names
  the loop that reads them;
- ``loops/<loop>.py``: one kind of traffic: set-up, window and check;
- ``drivers/<driver>.py``: how the program's codec is driven;
- ``reference/<reference>.py``: the plain reference that judges its
  containers (two drivers of one format share it);
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``tiny/<workload>.json``: the cell at a size the CPU holds in a test,
  ``{"config": {...}, "mix": {...}}``, the keys it replaces.

So a cell, configuration, kind of traffic, way of driving a codec or
metric is added with files and entries alone.  ``parts`` names a second
folder of the same layout, searched first, for parts that only tests use
(`benchmark/tests/parts/`).
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_spec(path: Path | None = None) -> dict:
    return json.loads(Path(path or ROOT / "BENCHMARK.json").read_text())


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def _find(kind: str, filename: str, parts: Path | None) -> Path:
    roots = [Path(r).resolve() for r in (parts, HERE) if r is not None]
    for root in roots:
        path = root / kind / filename
        if path.exists():
            return path
    raise KeyError(f"no {kind} file {filename} under "
                   f"{' or '.join(str(r) for r in roots)}")


def mix(traffic: str, parts: Path | None = None) -> dict:
    return json.loads(_find("mixes", f"{traffic}.json", parts).read_text())


def tiny(workload: str, parts: Path | None = None) -> dict:
    """The keys that cut a cell to a size the CPU holds in a test."""
    try:
        path = _find("tiny", f"{workload}.json", parts)
    except KeyError:
        raise KeyError(f"cell {workload!r} has no CPU size: add "
                       f"benchmark/tiny/{workload}.json, "
                       '{"config": {...}, "mix": {...}}') from None
    return json.loads(path.read_text())


def _module(kind: str, name: str, parts: Path | None = None):
    path = _find(kind, f"{name}.py", parts)
    key = "_".join(path.relative_to(ROOT).with_suffix("").parts)
    key = key.replace(".", "_").replace("-", "_")
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def driver(name: str, parts: Path | None = None):
    return _module("drivers", name, parts)


def reference(name: str, parts: Path | None = None):
    return _module("reference", name, parts)


def loop(name: str, parts: Path | None = None):
    return _module("loops", name, parts)


def metric_reader(name: str, parts: Path | None = None):
    return _module("metrics", name, parts)


def _applies(metric: dict, cell_name: str) -> bool:
    return cell_name in metric.get("workloads", [cell_name])


def end_to_end(spec: dict, cell_name: str) -> list[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in spec["end_to_end"] if _applies(m, cell_name)]


def per_layer(spec: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics this cell reports: those that list it, or,
    without a list, those that move an end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end(spec, cell_name)}
    return [m for m in spec["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
