"""The port's utilities against the JAX package's: profiling, debugging, the
re-exports and aliases, and the API as a whole (every public name of the JAX
package has its counterpart in the port)."""

import ast
import collections
import json
import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pde_superresolution_tpu import integrate as jint
from pde_superresolution_tpu.utils import debugging as jdebugging
from pde_superresolution_torch import bench, convert, integrate, stencils
from pde_superresolution_torch.ops import fused_kernels as fk
from pde_superresolution_torch.utils import debugging, profiling

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


# --- profiling (tests/test_utils.py's TestBenchmarkFn, on the port) ----------


class TestBenchmarkFn:
    def test_times_fn(self):
        stats = profiling.benchmark_fn(lambda x: x * 2, torch.ones(16), repeats=3)
        assert stats["best_s"] > 0
        assert len(stats["runs"]) == 3
        assert stats["best_s"] <= stats["mean_s"]

    def test_warmup_calls_are_not_timed(self):
        calls = []
        stats = profiling.benchmark_fn(lambda: calls.append(1) or {"x": [torch.ones(2)]},
                                       repeats=4, warmup=2)
        assert len(calls) == 6 and len(stats["runs"]) == 4

    def test_timer(self):
        with profiling.Timer() as t:
            pass
        assert t.elapsed >= 0


def test_trace_writes_json_with_aten_events(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)):
        torch.log(torch.ones(8) * 2).sum()
    (path,) = list(logdir.iterdir())
    assert path.name.endswith(".pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"aten::log", "aten::mul", "aten::sum"} <= names
    assert bench.device_events(str(logdir)) == []  # no card: no device activity


# --- debugging: the port against JAX on the same numpy inputs ------------------

# (JAX function, port function, input): the cases of the JAX package's
# checkify and jax_debug_nans, as they behave on the CPU
CASES = {
    "log_of_minus_one": (jnp.log, torch.log, np.array([-1.0], np.float32)),
    "float_one_over_zero": (lambda x: 1.0 / x, lambda x: 1.0 / x, np.array([0.0], np.float32)),
    "int_floor_division_by_zero": (lambda x: x // 0, lambda x: x // 0, np.array([3], np.int32)),
    "divisor_array_with_a_zero": (lambda x: x / (x - 1.0), lambda x: x / (x - 1.0),
                                  np.array([1.0, 2.0], np.float32)),
    "nan_input_through_mul": (lambda x: x * 2, lambda x: x * 2,
                              np.array([np.nan, 1.0], np.float32)),
    "inf_minus_inf": (lambda x: x - x, lambda x: x - x, np.array([np.inf], np.float32)),
    "clean": (lambda x: x + 1, lambda x: x + 1, np.array([1.0, 2.0], np.float32)),
    "overflow_to_inf_is_no_nan": (jnp.exp, torch.exp, np.array([1000.0], np.float32)),
}


def _outcome(fn, *args):
    """(raised?, message, result)."""
    try:
        return False, None, np.asarray(fn(*args))
    except Exception as e:  # JAX raises JaxRuntimeError, the port FloatingPointError
        return True, str(e), None


@pytest.mark.parametrize("case", sorted(CASES))
def test_checked_matches_checkify(case):
    """``checked`` raises where checkify's float checks do, with the same
    words and the same operator name, and otherwise returns what the
    unchecked call returns."""
    jfn, tfn, x = CASES[case]
    want = _outcome(jdebugging.checked(jfn), jnp.asarray(x))
    got = _outcome(debugging.checked(tfn), torch.from_numpy(x))
    assert got[:2] == want[:2]
    if not got[0]:
        np.testing.assert_array_equal(got[2], np.asarray(tfn(torch.from_numpy(x))))
    else:
        with pytest.raises(FloatingPointError):
            debugging.checked(tfn)(torch.from_numpy(x))


@pytest.mark.parametrize("case", sorted(c for c in CASES if CASES[c][2].dtype.kind == "f"))
def test_debug_nans_matches_jax(case):
    """``debug_nans`` raises where ``jax_debug_nans`` does (NaN outputs only:
    a float division by zero gives inf and passes), in JAX's words."""
    jfn, tfn, x = CASES[case]

    def under(ctx, fn, arg):
        def run():
            with ctx():
                return fn(arg)
        return _outcome(run)

    want = under(jdebugging.debug_nans, lambda a: np.asarray(jfn(a)), jnp.asarray(x))
    got = under(debugging.debug_nans, tfn, torch.from_numpy(x))
    assert got[:2] == want[:2]


def test_debug_nans_restores_and_nests():
    bad = torch.tensor([-1.0])
    with debugging.debug_nans():
        with debugging.debug_nans(False):
            assert torch.isnan(torch.log(bad)).all()  # off in the inner block
        with pytest.raises(FloatingPointError, match="invalid value \\(nan\\) encountered in log"):
            torch.log(bad)  # on again
        with debugging.debug_nans():  # nested on: one check, still on after
            pass
        with pytest.raises(FloatingPointError):
            torch.log(bad)
    assert torch.isnan(torch.log(bad)).all()  # off after the outer block
    assert not torch._C._len_torch_dispatch_stack()


def test_debug_nans_sees_backward():
    x = torch.tensor([1.0, 2.0], requires_grad=True)
    y = torch.sin(x * 3)
    with debugging.debug_nans():
        y.backward(torch.ones(2))  # clean
        with pytest.raises(FloatingPointError, match="encountered in mul"):
            torch.sin(x * 3).backward(torch.tensor([np.nan, 1.0]))


def test_check_output_is_inert_without_a_check():
    nan = torch.tensor([np.nan])
    debugging.check_output("fused_rhs", nan)  # no check in force: no raise
    with pytest.raises(FloatingPointError, match=r"^nan generated by primitive: fused_rhs\.$"):
        debugging.checked(lambda: debugging.check_output("fused_rhs", nan))()
    with debugging.debug_nans():
        with pytest.raises(FloatingPointError,
                           match=r"^invalid value \(nan\) encountered in fused_rk4$"):
            debugging.check_output("fused_rk4", nan)
        debugging.check_output("fused_rk4", torch.ones(3))


# trees as JAX's flatten_with_path orders them (dict keys sorted), built from
# numpy for both packages
Pair = collections.namedtuple("Pair", "x y")
TREES = {
    "dict_of_lists_and_tuples": lambda a: {"b": (a([1.0]),), "a": [a([1.0, 1.0]), a([1.0, np.nan])]},
    "nested_dicts": lambda a: {"z": {"b": a([np.inf])}, "a": {"c": a([2.0])}},
    "lists_and_tuples": lambda a: [a([1.0]), (a([2.0]), a([np.nan, np.nan, 3.0]))],
    "namedtuple": lambda a: Pair(a([1.0]), a([np.nan, 1.0, np.inf])),
    "bare_leaf": lambda a: a([np.nan]),
    "all_finite": lambda a: {"a": [a([1.0]), Pair(a([2.0]), a([3.0]))]},
}


@pytest.mark.parametrize("tree", sorted(TREES))
def test_assert_all_finite_matches_jax(tree):
    jtree = TREES[tree](lambda v: jnp.asarray(np.array(v, np.float32)))
    ttree = TREES[tree](lambda v: torch.tensor(v, dtype=torch.float32))
    want = _outcome(jdebugging.assert_all_finite, jtree, "params")
    got = _outcome(debugging.assert_all_finite, ttree, "params")
    assert got[:2] == want[:2]


class TestDebugging:
    """tests/test_utils.py's TestDebugging, on the port."""

    def test_checked_passes_clean(self):
        out = debugging.checked(lambda x: x + 1)(torch.ones(4))
        np.testing.assert_allclose(out.numpy(), 2.0)

    def test_checked_catches_nan(self):
        with pytest.raises(FloatingPointError):
            debugging.checked(torch.log)(torch.tensor([-1.0]))

    def test_assert_all_finite(self):
        debugging.assert_all_finite({"a": torch.ones(3)})
        with pytest.raises(FloatingPointError):
            debugging.assert_all_finite({"a": torch.tensor([1.0, np.nan])})


@pytest.fixture(scope="module")
def ks8():
    model, params, _ = convert.load_asset("ckpt_ks8", device="cpu")
    u0 = model.equation.initial_conditions(torch.Generator().manual_seed(3), model.grid,
                                           (3,), "cpu")
    return model, params, u0


ROUTES = {
    "fused_rk4_fn": lambda model, params, dt: model.fused_rk4_fn(params, dt, 4),
    "rhs_fn": lambda model, params, dt: (
        lambda u: integrate.integrate(model.rhs_fn(params), u, dt, 4, 4)[1][-1]),
    "baseline_fused_rk4": lambda model, params, dt: fk.make_fused_rk4(
        model.equation, model.grid, dt, 4),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_checked_routes_bit_equal_and_catch_a_nan(ks8, route):
    """On the plain routes (the kernels' plain versions on the CPU) a checked
    call returns the unchecked call's result bit for bit, and a NaN planted
    in u0 raises."""
    model, params, u0 = ks8
    dt = model.equation.stable_time_step(model.grid, u_scale=3.0)
    fn = ROUTES[route](model, params, dt)
    want = fn(u0)
    got = debugging.checked(fn)(u0)
    assert torch.isfinite(want).all() and torch.equal(got, want)
    bad = u0.clone()
    bad[1, 5] = float("nan")
    with pytest.raises(FloatingPointError, match="^nan generated by primitive: "):
        debugging.checked(fn)(bad)


# --- re-exports, aliases, and the API as a whole --------------------------------


def test_metrics_logger_from_utils(tmp_path):
    from pde_superresolution_torch.utils import MetricsLogger

    logger = MetricsLogger(str(tmp_path / "m.jsonl"))
    logger.log(1, loss=0.5)
    logger.close()
    assert json.loads((tmp_path / "m.jsonl").read_text())["loss"] == 0.5


def test_polynomial_bias_alias():
    assert stencils.PolynomialBias is stencils.FixedCoefficients


def test_integrate_baseline_stencil_size_matches_jax():
    assert integrate.baseline_stencil_size is stencils.baseline_stencil_size
    for order in range(5):
        for accuracy in range(1, 5):
            for staggered in (False, True):
                assert (integrate.baseline_stencil_size(order, accuracy, staggered)
                        == jint.baseline_stencil_size(order, accuracy, staggered))


def _public_api(path: pathlib.Path, package: str) -> set:
    """Top-level public definitions of a module, and for a package's
    ``__init__`` the names it re-exports from its own package."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif (isinstance(node, ast.ImportFrom) and path.name == "__init__.py"
              and (node.module or "").startswith(package)):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


JAX_PACKAGE = REPO / "pde_superresolution_tpu"
PORT = REPO / "pde_superresolution_torch"
# what the port does without: absl's FLAGS (argparse instead), the TPU
# kernels' module (their counterparts are ops/fused_kernels.py's), and the
# conv tower's pure functions (ConvTower: __init__ + reset_parameters,
# forward)
NOT_PORTED = {
    "ops/pallas_kernels.py": {"LANE", "PHYSICAL_VMEM_BYTES", "SUBLANE", "kernel_supported",
                              "make_fused_learned_rk4", "make_fused_rhs", "make_fused_rk4"},
    "models/__init__.py": {"conv_tower_apply", "conv_tower_init"},
    "models/conv_net.py": {"conv_tower_apply", "conv_tower_init"},
}
MODULES = sorted(str(p.relative_to(JAX_PACKAGE)) for p in JAX_PACKAGE.rglob("*.py"))


@pytest.mark.parametrize("module", MODULES)
def test_every_public_name_has_a_counterpart(module):
    want = _public_api(JAX_PACKAGE / module, "pde_superresolution_tpu")
    want -= NOT_PORTED.get(module, set())
    if module.startswith("scripts/"):
        want -= {"FLAGS"}
    port = PORT / module
    if module == "ops/pallas_kernels.py":
        assert {"fused_rhs", "fused_learned_rk4", "make_fused_rk4"} <= _public_api(
            PORT / "ops/fused_kernels.py", "pde_superresolution_torch")
        return
    if module == "models/conv_net.py":
        assert "ConvTower" in _public_api(port, "pde_superresolution_torch")
    assert port.is_file(), f"no {port}"
    assert want <= _public_api(port, "pde_superresolution_torch"), sorted(
        want - _public_api(port, "pde_superresolution_torch"))
