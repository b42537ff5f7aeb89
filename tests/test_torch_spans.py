"""The port's layer spans (``utils.profiling.span``) on the CPU: each route
emits its spans, nested in the order of the calls and as many as the calls,
under ``torch.profiler``; with no profiler running a span never reaches the
profiler."""

import pathlib
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pde_superresolution_torch import equations as teq
from pde_superresolution_torch import integrate
from pde_superresolution_torch.grids import Grid
from pde_superresolution_torch.models import ModelConfig, StencilModel
from pde_superresolution_torch.ops import fused_kernels as fk
from pde_superresolution_torch.utils import profiling

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
NX, BATCH, DT = 32, 3, 1e-3


def _burgers():
    eq = teq.from_name("burgers", conservative=True)
    model = StencilModel(eq, Grid(NX, eq.period), ModelConfig(filters=8, stencil_size=6),
                         device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init_params(gen)
    forcing = eq.sample_forcing(gen, (BATCH,), "cpu")
    u0 = eq.initial_conditions(gen, model.grid, (BATCH,), "cpu")
    return model, params, forcing, u0


def _fused(steps, save_every):
    model, params, forcing, u0 = _burgers()
    advance = model.fused_rk4_fn(params, DT, save_every, forcing=forcing, t0=0.5)
    return lambda: integrate.integrate_fused(advance, u0, DT, steps, save_every, t0=0.5)


def _rhs_steps(steps):
    model, params, forcing, u0 = _burgers()
    rhs = model.rhs_fn(params, forcing, use_kernel=True)
    return lambda: integrate.integrate(rhs, u0, DT, steps, 1)


def _baseline():
    eq = teq.from_name("ks", conservative=True)
    grid = Grid(NX, eq.period)
    advance = fk.make_fused_rk4(eq, grid, DT, 2)
    u0 = eq.initial_conditions(torch.Generator().manual_seed(1), grid, (BATCH,), "cpu")
    return lambda: integrate.integrate_fused(lambda u, t: advance(u), u0, DT, 4, 2)


ROUTES = {"fused": lambda: _fused(6, 2), "rhs_steps": lambda: _rhs_steps(2),
          "baseline": _baseline}


def _spans(fn) -> dict:
    """``{span name: [(start, end), ...]}`` of the port's spans in a CPU
    profile of ``fn()``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = {}
    for e in prof.events():
        if e.name in profiling.SPANS:
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


def _inside(child, parents) -> bool:
    return any(a <= child[0] and child[1] <= b for a, b in parents)


def test_forced_fused_route_nests_a_pack_in_a_launch_in_the_integration():
    spans = _spans(_fused(6, 2))
    assert {k: len(v) for k, v in spans.items()} == {
        profiling.INTEGRATE_FUSED: 1, profiling.FUSED_LEARNED_RK4: 3,
        profiling.PACK_FORCING: 3}  # one launch and one pack a save interval
    for launch in spans[profiling.FUSED_LEARNED_RK4]:
        assert _inside(launch, spans[profiling.INTEGRATE_FUSED])
    for pack in spans[profiling.PACK_FORCING]:
        assert _inside(pack, spans[profiling.FUSED_LEARNED_RK4])


@pytest.mark.parametrize("steps", [1, 3])
def test_per_step_route_has_four_of_each_layer_a_step(steps):
    spans = _spans(_rhs_steps(steps))
    layers = (profiling.TOWER, profiling.PROJECTION, profiling.FORCING, profiling.FUSED_RHS)
    assert {k: len(v) for k, v in spans.items()} == {
        profiling.INTEGRATE: 1, **{name: 4 * steps for name in layers}}
    for name in layers:
        for s in spans[name]:
            assert _inside(s, spans[profiling.INTEGRATE]), name
    # the layers of one RHS follow each other: tower, projection, forcing, stencil
    starts = sorted((s[0], name) for name in layers for s in spans[name])
    assert [name for _, name in starts] == list(layers) * 4 * steps


def test_baseline_kernel_span():
    spans = _spans(_baseline())
    assert {k: len(v) for k, v in spans.items()} == {
        profiling.INTEGRATE_FUSED: 1, profiling.FUSED_RK4: 2}
    for s in spans[profiling.FUSED_RK4]:
        assert _inside(s, spans[profiling.INTEGRATE_FUSED])


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_no_profiler_no_record_function(monkeypatch, route):
    """With no profiler running, a span is the gate's check alone: the
    profiler's ``record_function`` is never called."""
    fn = ROUTES[route]()

    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    times, saves = fn()
    assert torch.isfinite(saves).all() and len(times) == len(saves)
    assert profiling.span(profiling.TOWER) is profiling.span(profiling.FORCING)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_spans_change_no_result(route):
    """The same route under the profiler and without it gives the same
    saves, bit for bit."""
    fn = ROUTES[route]()
    _, plain = fn()
    with profile(activities=[ProfilerActivity.CPU]):
        _, traced = fn()
    torch.testing.assert_close(traced, plain, rtol=0, atol=0)


def test_span_names_are_the_constants_perf_lists():
    """Nine distinct ``port.*`` names, each a module constant that one layer
    opens by name, and the very set of spans PERF.md's layer map lists."""
    consts = ("INTEGRATE", "INTEGRATE_FUSED", "FUSED_LEARNED_RK4", "PACK_FORCING",
              "FUSED_RHS", "FUSED_RK4", "TOWER", "PROJECTION", "FORCING")
    assert profiling.SPANS == tuple(getattr(profiling, c) for c in consts)
    assert len(set(profiling.SPANS)) == 9
    for name in profiling.SPANS:
        assert re.fullmatch(r"port\.[a-z0-9_]+", name), name
    listed = set(re.findall(r"\bport\.[a-z0-9_]+", (REPO / "PERF.md").read_text()))
    assert listed == set(profiling.SPANS)
    source = "".join((REPO / "pde_superresolution_torch" / p).read_text() for p in (
        "integrate.py", "ops/fused_kernels.py", "models/stencil_net.py"))
    for const in consts:
        assert source.count(f"profiling.span(profiling.{const})") == 1, const
