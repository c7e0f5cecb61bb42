"""Toy cells for the benchmark's CPU tests: a cell of BENCHMARK.json cut to
20k splats at 256x256 and run on the CPU, where the port runs its plain
versions (the benchmark's own runs refuse the CPU)."""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

torch.set_num_threads(1)

SPLATS, SIZE = 20_000, 256
SEED = 2**31 + 12345


def cell(name: str):
    """A cell of BENCHMARK.json, or one whose files are there but which the
    benchmark does not list (`<config>.<traffic>`, e.g. `inria6m.served`)."""
    from harness import spec

    bench = spec.load_benchmark()
    if any(w["name"] == name for w in bench["workloads"]):
        return spec.resolve(name, bench)
    config, traffic = name.split(".")
    return spec.Cell(name=name, config=spec.load_json(spec.HERE / "configs" / f"{config}.json"),
                     traffic=spec.load_json(spec.HERE / "traffic" / f"{traffic}.json"), chips=1,
                     end_to_end=[], per_layer=[],
                     limits=spec.load_json(spec.HERE / "limits" / f"{name}.json"))


def toy_cell(name: str, splats: int = SPLATS, size: int = SIZE, **traffic):
    cell = globals()["cell"](name)
    c = copy.deepcopy(cell.config)
    c["width"] = c["height"] = size
    for m in c["scene"]["models"]:
        m["splats"] = splats // len(c["scene"]["models"])
    cell.config = c
    cell.traffic = {**copy.deepcopy(cell.traffic), **traffic}
    return cell


def run_toy(cell, seed: int = SEED, seconds: float = 0.5, trace: bool = False) -> dict:
    import run

    return run.execute(cell, seed, seconds, trace, "cpu", time.perf_counter())
