"""A cell, found by name: the ``BENCHMARK.json`` entry and its files.

Everything that belongs to one configuration, traffic mix, route, per-layer
metric or cell sits in a file of its own, found by the name the entry gives:

    configs/<config>.json      sizes, precision, the distributions of inputs
    traffic/<traffic>.json     batch, steps, saves, pool, route, domain factor
    routes/<route>.py          builds the port's entry for one batch
    metrics/<metric>.py        ``read(readings) -> float | None``
    limits/<workload>.json     the limit of each number ``correct`` compares

Each is looked for in ``dirs`` in order, so a cell can be added, or tried
from a temporary folder, by new files alone.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Optional, Sequence

BENCH_DIR = Path(__file__).resolve().parent
SPEC_PATH = BENCH_DIR.parent / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    route: ModuleType
    limits: dict
    end_to_end: list  # the spec's entries this cell reports
    per_layer: list  # (spec entry, reader module)


def find(dirs: Sequence[Path], kind: str, name: str, suffix: str) -> Path:
    for d in dirs:
        path = Path(d) / kind / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {kind}/{name}{suffix} in {[str(d) for d in dirs]}")


def load_module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        "port_bench_" + re.sub(r"\W", "_", f"{path.parent.name}_{path.stem}"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reported(entry: dict, workload: str) -> bool:
    return workload in entry.get("workloads", [workload])


def load(workload: str, dirs: Optional[Sequence[Path]] = None,
         spec_path: Optional[Path] = None) -> Cell:
    dirs = list(dirs or []) + [BENCH_DIR]
    spec = json.loads(Path(spec_path or SPEC_PATH).read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in the benchmark")
    config = json.loads(find(dirs, "configs", entry["config"], ".json").read_text())
    traffic = json.loads(find(dirs, "traffic", entry["traffic"], ".json").read_text())
    route = load_module(find(dirs, "routes", traffic["route"], ".py"))
    limits = json.loads(find(dirs, "limits", workload, ".json").read_text())
    end_to_end = [m for m in spec["end_to_end"] if _reported(m, workload)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [(m, load_module(find(dirs, "metrics", m["name"], ".py")))
                 for m in spec["per_layer"]
                 if _reported(m, workload) and m["moves"] in reported]
    return Cell(workload, entry["chips"], config, traffic, route, limits, end_to_end,
                per_layer)
