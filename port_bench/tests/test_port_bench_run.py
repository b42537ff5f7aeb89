"""The harness end to end on the CPU, on cells made of new files alone: the
result line, the reference against the port's plain routes, the control and
the faults that the comparison has to catch."""

import json
import subprocess
import sys

import pytest
import torch

from port_bench import cells, control, run
from pde_superresolution_torch import integrate
from pde_superresolution_torch.ops import fused_kernels

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SEED = 2 ** 31 + 77


def limits_of(workload):
    return json.loads((cells.BENCH_DIR / "limits" / f"{workload}.json").read_text())


def test_a_cell_of_new_files_is_found_and_run(tiny_cell):
    workload, kw = tiny_cell(config="ks8copy", config_file="ks8")
    result = run.run(workload, SEED, 0.3, False, **kw)
    assert list(result) == CONTRACT_KEYS + ["checks"]
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"traj_steps_per_s", "request_p95_ms", "setup_s"}
    assert set(result["checks"]) == {"max_gap", "rms_gap"}
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


def test_traced_line(tiny_cell):
    workload, kw = tiny_cell(route="rhs_steps")
    result = run.run(workload, SEED, 0.3, True, **kw)
    assert list(result) == CONTRACT_KEYS + ["breakdown", "checks"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "host_ms_per_request" in result["metrics"]
    assert {"busy_s", "window_s"} <= set(result["device"])


@pytest.mark.parametrize("config,route,factor,real", [
    ("ks8", "fused", 1, "ks8.ensemble"), ("burgers8", "fused", 1, "burgers8.ensemble"),
    ("ks8", "rhs_steps", 1, "burgers8.rhs_steps"),
    ("burgers8", "rhs_steps", 1, "burgers8.rhs_steps"),
    ("ks8", "fused", 2, "ks8.ensemble"), ("burgers8", "fused", 2, "burgers8.domain10")])
def test_reference_agrees_with_the_plain_routes(tiny_cell, config, route, factor, real):
    """The reference and the port's plain CPU routes, within the limits of
    the cell on the card that runs the same route."""
    workload, kw = tiny_cell(config=config, route=route, traffic={"domain_factor": factor},
                             limits=limits_of(real))
    result = run.run(workload, SEED + factor, 0.2, False, **kw)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("config,route,real", [
    ("ks8", "fused", "ks8.ensemble"), ("burgers8", "fused", "burgers8.ensemble"),
    ("burgers8", "rhs_steps", "burgers8.rhs_steps")])
def test_control_is_not_correct(tiny_cell, config, route, real):
    """The reference one precision step lower, in the program's place, fails
    the real cell's limits even at this size."""
    workload, kw = tiny_cell(config=config, route=route, limits=limits_of(real),
                             traffic={"steps": 10, "save_every": 10})
    cell = cells.load(workload, kw["dirs"], kw["spec_path"])
    result = run.run(workload, SEED, 0.2, False, route=control.control_route(cell), **kw)
    assert not result["correct"], result["checks"]


def _unchanged(u, *a, **k):
    return u.clone()


def _half(real):
    def fault(*a, **k):
        u = a[1] if real is integrate.rk4_step else a[0]
        out = real(*a, **k)
        out[u.shape[0] // 2:] = u[u.shape[0] // 2:]
        return out
    return fault


def _altered(real):
    def fault(*a, **k):
        out = real(*a, **k)
        out[0, 0] += 0.5
        return out
    return fault


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("route,real", [("fused", "burgers8.ensemble"),
                                        ("rhs_steps", "burgers8.rhs_steps")])
def test_planted_faults_are_not_correct(tiny_cell, monkeypatch, kind, route, real):
    """A step that leaves the state as it was, half of the batch left
    unadvanced, one value altered where it is produced: in the fused
    kernel's launch, or in the per-step route's RK4 step."""
    workload, kw = tiny_cell(route=route, limits=limits_of(real))
    orig = fused_kernels.fused_learned_rk4 if route == "fused" else integrate.rk4_step
    fault = {"unchanged": _unchanged if route == "fused" else (lambda rhs, u, t, dt: u.clone()),
             "half": _half(orig), "altered": _altered(orig)}[kind]
    if route == "fused":
        monkeypatch.setattr(fused_kernels, "fused_learned_rk4", fault)
    else:
        monkeypatch.setitem(integrate.STEP_FUNCS, "rk4", fault)
    result = run.run(workload, SEED, 0.2, False, **kw)
    assert not result["correct"], result["checks"]


def test_without_a_card_it_exits_nonzero_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would go ahead")
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", "ks8.ensemble",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cells.BENCH_DIR.parent, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr
