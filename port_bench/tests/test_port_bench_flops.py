"""The yardstick's arithmetic, from the configurations' shapes alone. The
projection counts each order's own block (``S_d * F_d``), not the
block-diagonal matrix a kernel packs, so the learned kernel's bounds lie
below the pack-derived ones of the kernel table (PERF.md)."""

import json

import pytest

from port_bench import cells, flops


def config(name):
    return json.loads((cells.BENCH_DIR / "configs" / f"{name}.json").read_text())


def test_model_flops_per_trajectory_step():
    ks, burgers = config("ks8"), config("burgers8")
    # KS: 3 orders of 6 taps, 4 + 3 + 1 free dims; Burgers: 2 of 8, 6 + 5
    assert flops.projection_macs(ks) == 6 * 8 and flops.projection_macs(burgers) == 8 * 11
    assert flops.bf16_macs(ks) == 10656 and flops.fp32_macs(ks) == 48 + 18
    assert flops.bf16_macs(burgers) == 10752 and flops.fp32_macs(burgers) == 88 + 16
    assert flops.flops_per_traj_step(ks) == 2 * (10656 + 66) * 4 * 128
    assert round(flops.flops_per_traj_step(ks) / 1e6, 2) == 10.98
    assert round(flops.flops_per_traj_step(burgers) / 1e6, 2) == 11.12
    assert flops.nx(burgers, 10) == 1280


@pytest.mark.parametrize("name,steps,factor,expected", [
    ("ks8", 100, 1, 12.3), ("burgers8", 100, 1, 13.7), ("burgers8", 100, 10, 137.3)])
def test_learned_rk4_bound(name, steps, factor, expected):
    bound = flops.learned_rk4_bound_ms(config(name), 10240, steps, factor)
    assert round(bound, 1) == expected


def test_fused_rhs_bound_forced():
    assert round(1e3 * flops.rhs_bound_ms(config("burgers8"), 10240), 2) == 29.74
