"""Shared helpers: a cell made of new files in a temporary folder, at a size
the CPU holds, run by the harness with the port's plain CPU routes."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from port_bench import cells

torch.set_num_threads(1)

TINY = {"batch": 6, "steps": 4, "save_every": 2, "domain_factor": 1, "pool": 2,
        "check_requests": 2, "trace_seconds": 0.05}


def write_cell(root: Path, workload: str, config: str, traffic: dict, route: str,
               limits=None, config_file=None) -> Path:
    """A benchmark in ``root`` with one cell: its own BENCHMARK.json, traffic
    and limits files, and (``config_file``) a config file of its own."""
    spec = json.loads(cells.SPEC_PATH.read_text())
    name = workload.split(".", 1)[1]
    spec["workloads"] = [{"name": workload, "config": config, "traffic": name, "chips": 1,
                          "why": "a test cell"}]
    for m in spec["per_layer"]:
        m["workloads"] = [workload]
    (root / "traffic").mkdir(parents=True, exist_ok=True)
    (root / "limits").mkdir(exist_ok=True)
    (root / "traffic" / f"{name}.json").write_text(json.dumps(dict(traffic, route=route)))
    (root / "limits" / f"{workload}.json").write_text(
        json.dumps(limits or {"max_gap": 1e-4, "rms_gap": 1e-5}))
    if config_file is not None:
        (root / "configs").mkdir(exist_ok=True)
        shutil.copy(cells.BENCH_DIR / "configs" / f"{config_file}.json",
                    root / "configs" / f"{config}.json")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root / "BENCHMARK.json"


@pytest.fixture
def tiny_cell(tmp_path):
    def make(config="burgers8", route="fused", traffic=None, **kw):
        workload = f"{config}.tiny_{route}"
        spec = write_cell(tmp_path, workload, config, dict(TINY, **(traffic or {})), route, **kw)
        return workload, {"dirs": [tmp_path], "spec_path": spec, "device": "cpu"}
    return make
