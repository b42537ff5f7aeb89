"""The readers of the port's own spans (``spans.py``), on a small synthetic
Chrome trace with correlation ids, nested port spans and the harness's
synchronizes outside them; on the CPU's traced run; and, on the card, the
share of a request's device time that the spans hold."""

import json

import pytest
import torch

from port_bench import cells, run, spans, trace

TRAFFIC = {"batch": 10240, "steps": 10, "save_every": 10, "domain_factor": 1}
SEED = 2 ** 31 + 91
SPAN_READERS = ("host_wait_ms_per_request", "forcing_pack_ms_per_request")
# the readers the benchmark had before the port's spans
OTHER_READERS = ("host_ms_per_request", "kernels_per_request", "tower_ms_per_request",
                 "roofline_pct.fused_learned_rk4", "roofline_pct.fused_rhs",
                 "device_idle_pct", "mfu")


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launched(name, ts, corr, at, dur, cat="kernel", call="cudaLaunchKernel",
              call_cat="cuda_runtime"):
    return [_x(call_cat, call, ts, 5, corr), _x(cat, name, at, dur, corr)]


# Two traced requests: the forced fused route's spans, then the per-step
# route's; one launch a driver call, one operation without a launch.
EVENTS = [
    _x("user_annotation", trace.REQUEST_SPAN, 0, 1000),
    _x("user_annotation", "port.integrate_fused", 10, 890),
    *_launched("Memcpy HtoD (Pageable -> Device)", 12, 1, 20, 2, "gpu_memcpy",
               "cudaMemcpyAsync"),
    _x("user_annotation", "port.fused_learned_rk4", 100, 400),
    _x("user_annotation", "port.pack_forcing", 110, 250),
    *_launched("void at::elementwise_kernel<128, 4>(int)", 120, 2, 130, 10),
    *_launched("Memcpy HtoD (Pageable -> Device)", 150, 3, 160, 1, "gpu_memcpy",
               "cudaMemcpyAsync"),
    _x("cuda_runtime", "cudaStreamSynchronize", 156, 190, 4),
    *_launched("void fused_learned_rk4_kernel<(Eq)2, 1>(float const*)", 380, 5, 390, 500),
    *_launched("void at::CatArrayBatchedCopy<float>(int)", 600, 6, 895, 5),
    _x("cuda_runtime", "cudaDeviceSynchronize", 905, 90, 7),
    _x("user_annotation", trace.REQUEST_SPAN, 1000, 1000),
    _x("user_annotation", "port.integrate", 1010, 900),
    _x("user_annotation", "port.tower", 1020, 100),
    _x("cpu_op", "aten::conv1d", 1025, 90),
    *_launched("implicit_convolve_sgemm", 1030, 8, 1040, 50),
    _x("user_annotation", "port.projection", 1130, 50),
    *_launched("sm80_xmma_gemm_f32f32", 1140, 9, 1150, 20),
    _x("user_annotation", "port.forcing", 1190, 30),
    *_launched("void at::elementwise_kernel<128, 2>(int)", 1200, 10, 1210, 8),
    _x("user_annotation", "port.fused_rhs", 1230, 40),
    *_launched("void fused_rhs_kernel<(Eq)2>(float*)", 1240, 11, 1250, 4,
               call="cuLaunchKernel", call_cat="cuda_driver"),
    *_launched("void at::vectorized_elementwise_kernel<4>(int)", 1300, 12, 1310, 6),
    _x("kernel", "void at::unrolled_elementwise_kernel<4>(int)", 1500, 7, 13),
    _x("cuda_runtime", "cudaDeviceSynchronize", 1920, 70, 14),
]
BARE = [e for e in EVENTS if not e["name"].startswith(spans.PREFIX)]  # as the parent's
SPAN_READINGS = {  # per request, of two
    "host_wait_ms_per_request": 1e-3 * (5 + 5 + 190) / 2,  # two copies, one wait
    "forcing_pack_ms_per_request": 1e-3 * 250 / 2,
}


def readings(events):
    cfg = json.loads((cells.BENCH_DIR / "configs" / "burgers8.json").read_text())
    window = run.Window(seconds=1.0, latencies_s=[0.4, 0.5], host_s=[0.01, 0.03])
    return run.Readings(cfg, TRAFFIC, window, trace.parse(events), 2)


def reader(name):
    return cells.load_module(cells.BENCH_DIR / "metrics" / f"{name}.py")


def test_the_spec_names_each_span_reader():
    names = {m["name"] for m in json.loads(cells.SPEC_PATH.read_text())["per_layer"]}
    assert set(SPAN_READERS) | set(OTHER_READERS) == names


@pytest.mark.parametrize("name", SPAN_READERS)
def test_each_span_reader(name):
    assert reader(name).read(readings(EVENTS)) == pytest.approx(SPAN_READINGS[name],
                                                                rel=1e-12)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_find_nothing_without_the_spans(name):
    assert reader(name).read(readings(BARE)) is None


def test_host_waits_need_a_card():
    r = readings(EVENTS)
    r.trace = trace.Trace([], r.trace.host, r.trace.requests)
    assert reader("host_wait_ms_per_request").read(r) is None


@pytest.mark.parametrize("name", OTHER_READERS)
def test_other_readers_read_the_same_with_the_spans(name):
    assert reader(name).read(readings(EVENTS)) == reader(name).read(readings(BARE))


def test_attribution_by_span():
    by_span = spans.device_us_by_span(spans.port_spans(trace.parse(EVENTS).host),
                                      spans.launches(EVENTS))
    assert by_span == {
        "port.integrate_fused": 7.0, "port.pack_forcing": 11.0, "port.fused_learned_rk4": 500.0,
        "port.tower": 50.0, "port.projection": 20.0, "port.forcing": 8.0, "port.fused_rhs": 4.0,
        "port.integrate": 6.0, None: 7.0}
    assert spans.device_us_by_span([], spans.launches(BARE)) == {None: 613.0}


def test_innermost_takes_the_latest_open_span():
    nested = [("a", 0, 100), ("b", 0, 40), ("c", 10, 10), ("d", 60, 20)]
    assert spans.port_spans([("x", 0, 5), ("port.a", 3, 1), ("port.b", 3, 2)]) == \
        [("port.b", 3, 2), ("port.a", 3, 1)]
    assert spans.innermost(sorted(nested, key=lambda s: (s[1], -s[2])),
                           [50, 0, 15, 20.5, 70, 101, -1]) == \
        ["a", "b", "c", "b", "d", None, None]


def test_traced_line_on_the_cpu(tiny_cell):
    """The CPU's plain versions wait on no card: no host wait is read, and
    the forced route's packs are."""
    workload, kw = tiny_cell(config="burgers8", route="fused")
    metrics = run.run(workload, SEED, 0.3, True, **kw)["metrics"]
    assert "host_wait_ms_per_request" not in metrics
    assert metrics["forcing_pack_ms_per_request"]["value"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("workload,launches", [("ks8.ensemble", 10),
                                               ("burgers8.rhs_steps", 40)])
def test_port_spans_hold_the_device_time(workload, launches, tmp_path):
    """One request of the cell under the profiler, after a warm one: at least
    99% of its device time was launched inside a ``port.*`` span, and the
    wrappers counted the route's launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from port_bench import inputs
    from port_bench.reference import model as reference
    from pde_superresolution_torch.ops import fused_kernels

    def counted():
        return sum(w.launches for w in (fused_kernels.fused_rhs,
                                        fused_kernels.fused_learned_rk4, fused_kernels.fused_rk4))

    cell = cells.load(workload)
    ref = reference.build(cell.config, cell.traffic["domain_factor"])
    dt = reference.stable_dt(cell.config, ref)
    pool = inputs.make_pool(cell.config, dict(cell.traffic, pool=1), 4000000011, "cuda")
    port = run.setup_port(cell, pool, dt, "cuda")
    with torch.no_grad():
        port.requests[0](pool[0].u0)
        run.synchronize("cuda")
        before = counted()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            port.requests[0](pool[0].u0)
            run.synchronize("cuda")
    assert counted() - before == launches
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    by_span = spans.device_us_by_span(spans.port_spans(trace.parse(events).host),
                                      spans.launches(events))
    assert by_span.get(None, 0.0) <= 0.01 * sum(by_span.values()), by_span
