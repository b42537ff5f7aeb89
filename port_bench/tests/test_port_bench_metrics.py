"""Each per-layer reader, and the trace arithmetic, on a small synthetic trace."""

import json

import pytest

from port_bench import cells, flops, run, trace

TRAFFIC = {"batch": 10240, "steps": 10, "save_every": 10, "domain_factor": 1}
DEVICE = [
    ("fused_learned_rk4_kernel", 100.0, 400.0, "kernel"),
    ("sm90_xmma_fprop_implicit_gemm", 600.0, 100.0, "kernel"),
    ("fused_rhs_kernel", 700.0, 50.0, "kernel"),
    ("fused_learned_rk4_kernel", 1100.0, 400.0, "kernel"),
    ("fused_rhs_kernel", 1600.0, 50.0, "kernel"),
    ("Memcpy DtoD", 1700.0, 100.0, "gpu_memcpy"),
]
HOST = [("port_bench.request", 0.0, 1000.0), ("port_bench.request", 1000.0, 1000.0),
        ("aten::add", 900.0, 50.0)]


@pytest.fixture
def readings():
    cfg = json.loads((cells.BENCH_DIR / "configs" / "burgers8.json").read_text())
    window = run.Window(seconds=1.0, latencies_s=[0.4, 0.5], host_s=[0.01, 0.03])
    t = trace.Trace(list(DEVICE), list(HOST), [(0.0, 1000.0), (1000.0, 2000.0)])
    return run.Readings(cfg, TRAFFIC, window, t, 2)


def reader(name):
    return cells.load_module(cells.BENCH_DIR / "metrics" / f"{name}.py")


def test_each_reader(readings):
    cfg = readings.config
    rk4 = flops.learned_rk4_bound_ms(cfg, 10240, 10)
    rhs = flops.rhs_bound_ms(cfg, 10240)
    expected = {
        "host_ms_per_request": 20.0,
        "kernels_per_request": 2.5,
        "tower_ms_per_request": 0.05,
        "roofline_pct.fused_learned_rk4": 100 * 2 * rk4 / 0.8,
        "roofline_pct.fused_rhs": 100 * 2 * rhs / 0.1,
        "device_idle_pct": 45.0,
        "mfu": 100 * flops.flops_per_traj_step(cfg) * 2 * 10240 * 10 / 989e12,
    }
    names = {m["name"] for m in json.loads(cells.SPEC_PATH.read_text())["per_layer"]}
    assert names == set(expected)
    for name, value in expected.items():
        assert reader(name).read(readings) == pytest.approx(value, rel=1e-12), name


def test_readers_return_nothing_where_nothing_is_traced(readings):
    readings.trace = trace.Trace([], HOST, [(0.0, 1000.0), (1000.0, 2000.0)])
    for name in ("kernels_per_request", "tower_ms_per_request", "device_idle_pct",
                 "roofline_pct.fused_learned_rk4", "roofline_pct.fused_rhs"):
        assert reader(name).read(readings) is None, name


def test_trace_arithmetic(readings):
    t = readings.trace
    assert trace.busy_us(t) == 1100.0
    assert readings.traced_window_s == pytest.approx(2e-3)
    b = trace.breakdown(t)
    assert b["device_ops"][0] == ["fused_learned_rk4_kernel", pytest.approx(8e-4)]
    assert b["idle_gaps"][0] == ["aten::add", pytest.approx(350e-6)]
    assert [g[1] for g in b["idle_gaps"]] == pytest.approx(
        [350e-6, 200e-6, 100e-6, 100e-6, 100e-6, 50e-6])


def test_short_names_and_parse():
    assert trace.short_name("void fused_learned_rk4_kernel<true, 1>(float const*, int)") \
        == "fused_learned_rk4_kernel"
    assert trace.short_name("void cutlass::Kernel<foo<1>, bar>(Params)") == "Kernel"
    assert trace.short_name("void fused_learned_rk4_cluster_kernel<(Eq)0, 2>(float const*)") \
        == "fused_learned_rk4_cluster_kernel"
    assert trace.short_name("void (anonymous namespace)::fused_learned_rk4_kernel<(Eq)2, "
                            "false>(float const*, Meta)") == "fused_learned_rk4_kernel"
    assert trace.short_name("Memcpy DtoD (Device -> Device)") == "DtoD"
    events = [
        {"ph": "X", "cat": "kernel", "name": "void k<2>(int)", "ts": 5, "dur": 2},
        {"ph": "X", "cat": "user_annotation", "name": trace.REQUEST_SPAN, "ts": 1, "dur": 9},
        {"ph": "X", "cat": "gpu_user_annotation", "name": trace.REQUEST_SPAN, "ts": 1, "dur": 9},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 3},
    ]
    t = trace.parse(events)
    assert t.device == [("k", 5.0, 2.0, "kernel")]
    assert t.requests == [(1.0, 10.0)]
