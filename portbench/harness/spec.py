"""BENCHMARK.json and the files it names, found by name.

Under the benchmark's folder: a configuration is `configs/<config>.json`, a
traffic mix `traffic/<traffic>.json`, a cell's comparison limits
`limits/<workload>.json`; an end-to-end metric is `end_to_end/<metric>.py`
and a per-layer metric `metrics/<metric>.py`, each with a `read` function;
the entry a mix drives is `entries/<entry>.py` and each of its gestures
`gestures/<gesture>.py`. Adding a cell adds such files; nothing here
changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # the benchmark's folder
ROOT = HERE.parent                               # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list   # the BENCHMARK.json metric entries this cell reports
    per_layer: list
    limits: dict


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, workload: str) -> bool:
    """Whether the cell reports the metric: every cell, unless the metric
    lists its cells."""
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell `name` with its configuration, traffic, metrics and limits."""
    bench = bench or load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    return Cell(name=name, config=config, traffic=traffic, chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if reports(m, name)],
                limits=limits)


def load(kind: str, name: str):
    """The module `<kind>/<name>.py` of the benchmark's folder, loaded once."""
    key = f"portbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    if key not in sys.modules:
        path = HERE / kind / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {kind}/{name}.py in the benchmark's folder")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def metric_reader(name: str):
    """The `read(ctx)` function of `metrics/<name>.py`."""
    return load("metrics", name).read


def end_to_end_reader(name: str):
    """The `read(window)` function of `end_to_end/<name>.py`."""
    return load("end_to_end", name).read
