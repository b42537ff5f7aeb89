"""The port's parallel layer against the JAX package's, on the CPU over gloo.

The mesh, the ring halo exchange and its gradient, the spatially sharded
RHS, ``fused_rk4_fn(mesh=)`` and a served artifact per rank run in real
rank processes (``torch_parallel_worker.spawn``: one spawn per world shape,
every case computed in it, each case its own test here). JAX runs in this
process on the conftest's 8 virtual CPU devices. Both get the same numpy
inputs and, through ``convert.params_from_jax``, the same weights; each
tolerance is stated in its test and none is looser than the JAX package's
own test of the same property (``tests/test_parallel.py``,
``tests/test_export.py``), but one: a served call per rank against the
unsharded call, which PyTorch's CPU convolution rounds differently by batch
size (``TestServedDP`` says how; bit for bit against the same rows).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from pde_superresolution_tpu import equations as jeq
from pde_superresolution_tpu import integrate as jintegrate
from pde_superresolution_tpu import parallel as jparallel
from pde_superresolution_tpu.grids import Grid as JGrid
from pde_superresolution_tpu.models import ModelConfig as JConfig
from pde_superresolution_tpu.models import StencilModel as JModel
from pde_superresolution_tpu.models import conv_net as jconv
from pde_superresolution_torch import convert, export, parallel, stencils
from pde_superresolution_torch import equations as teq
from pde_superresolution_torch.grids import Grid
from pde_superresolution_torch.models import ModelConfig, StencilModel, conv_net
from pde_superresolution_torch.parallel import mesh as mesh_lib

import torch_parallel_worker as worker

torch.set_num_threads(1)

BASE_CASES = [("burgers", False), ("burgers", True), ("ks", False), ("ks", True)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _forcing_t(forcing):
    return None if forcing is None else teq.ForcingParams(*(_t(leaf) for leaf in forcing))


def _perturbed(model_j, scale, seed):
    """JAX init params plus seeded normal noise, as numpy leaves."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda leaf: (np.asarray(leaf) + scale * rng.standard_normal(leaf.shape)).astype(np.float32),
        model_j.init_params(jax.random.PRNGKey(0)))


def _fused_setup(name, batch=32):
    """JAX TestFusedKernelDP._setup's model (KS-8x or Burgers-8x shapes,
    stencil 6, 3x32 tower) with perturbed params, and a batch."""
    eq = jeq.from_name(name, conservative=True)
    grid = JGrid(8 * 128, eq.period).resample(8, conservative=True)
    model = JModel(eq, grid, JConfig(stencil_size=6))
    tree = _perturbed(model, 0.05, 1)
    u0 = np.asarray(eq.initial_conditions(jax.random.PRNGKey(2), grid, (batch,)))
    forcing = eq.sample_forcing(jax.random.PRNGKey(3), (batch,))
    return eq, grid, model, tree, u0, (None if forcing is None else
                                       jax.tree.map(np.asarray, forcing))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The numpy inputs both packages get, with the JAX-side objects."""
    rng = np.random.default_rng(0)
    ins, ref = {}, {}
    ins["halo_field"] = _t(rng.standard_normal((3, 32)).astype(np.float32))
    ins["halo_weights"] = _t(rng.standard_normal((4, 3, 8 + 6)).astype(np.float32))
    for name in ("burgers", "ks"):
        eq = jeq.from_name(name)
        u = eq.initial_conditions(jax.random.PRNGKey(0), JGrid(64, eq.period), (4,))
        forcing = eq.sample_forcing(jax.random.PRNGKey(1), (4,))
        ins[f"base/{name}/u"] = _t(u)
        ins[f"base/{name}/forcing"] = _forcing_t(forcing)
        ref[f"base/{name}"] = (u, forcing)
    eq = jeq.from_name("ks")
    ins["model/u"] = _t(eq.initial_conditions(jax.random.PRNGKey(2), JGrid(64, eq.period), (4,)))
    for cons in (False, True):
        eq = jeq.from_name("ks", conservative=cons)
        model = JModel(eq, JGrid(64, eq.period), JConfig(num_layers=2, filters=8, stencil_size=7))
        tree = _perturbed(model, 0.1, 1)
        ins[f"model/{cons}/params"] = convert.params_from_jax(tree, device="cpu")
        ref[f"model/{cons}"] = (model, tree)
    eq = jeq.from_name("ks", conservative=True)
    ins["integrate/u0"] = _t(eq.initial_conditions(jax.random.PRNGKey(3), JGrid(64, eq.period)) * 0.5)
    for name in ("ks", "burgers"):
        eq_j, grid_j, model_j, tree, u0, forcing = _fused_setup(name)
        ins[f"fused/{name}/params"] = convert.params_from_jax(tree, device="cpu")
        ins[f"fused/{name}/u0"] = _t(u0)
        if forcing is not None:
            ins[f"fused/{name}/forcing"] = _forcing_t(forcing)
        ref[f"fused/{name}"] = (eq_j, grid_j, model_j, tree, u0, forcing)
    # a served artifact of a small seeded KS model (tests/test_torch_export.py's)
    eq = teq.from_name("ks", conservative=True)
    served_model = StencilModel(eq, Grid(128, eq.period),
                                ModelConfig(num_layers=2, filters=8, stencil_size=6), device="cpu")
    gen = torch.Generator().manual_seed(2)
    params = {k: 0.05 * torch.randn(v.shape, generator=gen)
              for k, v in served_model.init_params(gen).items()}
    path = str(tmp_path_factory.mktemp("served") / "ks")
    export.export_and_save(served_model, params, path, num_steps=2)
    ins["serve/path"] = path
    ins["serve/u"] = eq.initial_conditions(torch.Generator().manual_seed(1), served_model.grid,
                                           (16,), "cpu")
    bad = tmp_path_factory.mktemp("store") / "not_hdf5.h5"
    bad.write_bytes(b"not an HDF5 file")
    ins["store/bad_path"] = str(bad)
    return ins, ref


@pytest.fixture(scope="module")
def world4(inputs, tmp_path_factory):
    return worker.spawn("core", 4, inputs[0], tmp_path_factory.mktemp("world4"))


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    return worker.spawn("mesh", 8, {}, tmp_path_factory.mktemp("world8"))


# -- the tower's VALID mode and receptive radius ---------------------------------


@pytest.mark.parametrize("layers,kernel", [(3, 5), (2, 3), (1, 4)])
def test_receptive_radius_matches_jax(layers, kernel):
    config = conv_net.ConvTowerConfig(num_layers=layers, kernel_size=kernel)
    want = jconv.receptive_radius(jconv.ConvTowerConfig(num_layers=layers, kernel_size=kernel))
    assert conv_net.receptive_radius(config) == want


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_tower_valid_mode_matches_jax(dtype):
    """periodic=False on a halo-padded input: the output is 2 * radius
    shorter and equals JAX's conv_tower_apply(periodic=False), rtol 1e-5,
    atol 1e-6 in float32; in bf16 activations 1e-2 of the largest head
    output (bf16 carries 8 bits)."""
    config = jconv.ConvTowerConfig(num_layers=2, filters=8, kernel_size=5)
    tree = jconv.conv_tower_init(jax.random.PRNGKey(0), config, {"0": 3, "1": 2})
    rng = np.random.default_rng(4)
    tree = jax.tree.map(lambda leaf: (np.asarray(leaf) + 0.1 * rng.standard_normal(leaf.shape))
                        .astype(np.float32), tree)
    u = rng.standard_normal((3, 40)).astype(np.float32)
    want = jconv.conv_tower_apply(tree, jnp.asarray(u), periodic=False,
                                  dtype=None if dtype is None else jnp.bfloat16)
    tower = conv_net.ConvTower(conv_net.ConvTowerConfig(2, 8, 5), {"0": 3, "1": 2})
    tower.load_state_dict(convert.params_from_jax(tree, device="cpu"))
    with torch.no_grad():
        got = tower(torch.from_numpy(u), None if dtype is None else torch.bfloat16, periodic=False)
    for head in ("0", "1"):
        w = np.asarray(want[head])
        assert got[head].shape == w.shape == (3, 40 - 2 * 4, 3 if head == "0" else 2)
        if dtype is None:
            np.testing.assert_allclose(got[head].numpy(), w, rtol=1e-5, atol=1e-6)
        else:
            assert np.abs(got[head].numpy() - w).max() <= 1e-2 * np.abs(w).max()


# -- initialize_multihost and make_mesh ------------------------------------------


class TestInitializeMultihost:
    """The contract of JAX's initialize_multihost against a stub: kwargs pass
    through, an initialized group is kept, a real error propagates; and
    the world-size-1 store when no launcher variable is set."""

    @pytest.fixture(autouse=True)
    def _no_launcher(self, monkeypatch):
        for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
            monkeypatch.delenv(name, raising=False)
        monkeypatch.setattr(dist, "is_initialized", lambda: False)

    def test_passes_kwargs_through(self, monkeypatch):
        seen = {}
        monkeypatch.setattr(dist, "init_process_group", lambda **kw: seen.update(kw))
        parallel.initialize_multihost(device="cpu", init_method="tcp://10.0.0.1:1234",
                                      world_size=4, rank=2)
        assert seen == {"backend": "gloo", "init_method": "tcp://10.0.0.1:1234",
                        "world_size": 4, "rank": 2}

    def test_world_of_one_without_a_launcher(self, monkeypatch):
        seen = {}
        monkeypatch.setattr(dist, "init_process_group", lambda **kw: seen.update(kw))
        parallel.initialize_multihost(device="cpu")
        assert seen["backend"] == "gloo" and seen["rank"] == 0 and seen["world_size"] == 1
        assert isinstance(seen["store"], dist.HashStore)

    def test_reads_the_launcher_environment(self, monkeypatch):
        seen = {}
        monkeypatch.setattr(dist, "init_process_group", lambda **kw: seen.update(kw))
        monkeypatch.setenv("RANK", "1")
        monkeypatch.setenv("WORLD_SIZE", "2")
        parallel.initialize_multihost(device="cpu")
        assert seen == {"backend": "gloo"}  # env:// reads the rest

    def test_tolerates_already_initialized(self, monkeypatch):
        def boom(**kw):
            raise AssertionError("must not initialize twice")

        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "init_process_group", boom)
        parallel.initialize_multihost(device="cpu")  # must not raise

    def test_propagates_real_errors(self, monkeypatch):
        def boom(**kw):
            raise RuntimeError("rendezvous unreachable")

        monkeypatch.setattr(dist, "init_process_group", boom)
        with pytest.raises(RuntimeError, match="unreachable"):
            parallel.initialize_multihost(device="cpu")

    def test_a_real_group_is_kept(self, world4):
        """In the rank processes: gloo, and a second call keeps the group."""
        assert all(r["backend"] == "gloo" and r["still_world"] == 4 for r in world4)


class TestMesh:
    def test_default_all_data(self, world8):
        assert all(r["default"] == (8, 1) and r["names"] == ("data", "space") for r in world8)

    def test_2d(self, world8):
        assert all(r["space4"] == (2, 4) for r in world8)

    def test_bad_factorization(self, world8):
        assert "needs 9 ranks" in world8[0]["bad_factorization"]
        assert "not divisible" in world8[0]["not_divisible"]

    def test_mesh_must_cover_the_world(self, world8):
        assert "whole world" in world8[0]["not_covering"]


# -- the halo ---------------------------------------------------------------------


class TestHalo:
    @pytest.mark.parametrize("space", [4, 2, 1])
    def test_exchange_equals_periodic_pad(self, world4, space):
        """Each rank's padded block is the periodic pad's, element for element;
        at space 4 shard 0 reads [30, 31, 0..7, 8, 9] (JAX :37-51)."""
        u = np.arange(32.0)
        padded = np.concatenate([u[-2:], u, u[:2]])
        width = 32 // space
        for rank, result in enumerate(world4):
            s = rank % space
            np.testing.assert_array_equal(result[f"halo/{space}"].numpy(),
                                          padded[s * width:(s + 1) * width + 4])
        if space == 4:
            np.testing.assert_array_equal(world4[0]["halo/4"].numpy(),
                                          [30, 31, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9])

    def test_gradient_equals_the_periodic_pads(self, world4, inputs):
        """On a ring of 4 (a ring of 2 cannot tell a swapped exchange: both
        neighbours are one rank), the exchange's backward gives each block
        the gradient that the periodic pad gives it, rtol 1e-6."""
        field = inputs[0]["halo_field"].clone().requires_grad_()
        weights = inputs[0]["halo_weights"]
        pad = torch.cat([field[..., -3:], field, field[..., :3]], dim=-1)
        loss = sum((pad[..., 8 * q:8 * q + 14] * weights[q]).sum() for q in range(4))
        (want,) = torch.autograd.grad(loss, field)
        got = worker.blocks(world4, "halo_grad", 1, 4)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)

    def test_apply_stencil_local_matches_global(self):
        """rtol 1e-6 against stencils.apply_stencil and JAX's own."""
        rng = np.random.RandomState(0)
        u = rng.randn(24).astype(np.float32)
        c = np.asarray([1.0, -2.0, 1.0], np.float32)
        want = stencils.apply_stencil(torch.from_numpy(u), torch.from_numpy(c), [-1, 0, 1])
        u_pad = np.concatenate([u[-2:], u, u[:2]])
        got = parallel.apply_stencil_local(torch.from_numpy(u_pad), torch.from_numpy(c),
                                           [-1, 0, 1], halo=2)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
        jax_got = jparallel.apply_stencil_local(jnp.asarray(u_pad), jnp.asarray(c), [-1, 0, 1],
                                                halo=2)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_got), rtol=1e-6)

    def test_staggered_faces_with_out_start(self):
        """Faces -1 .. local-1 of a staggered 4-tap stencil on a padded
        block against JAX, rtol 1e-6."""
        rng = np.random.RandomState(1)
        u_pad = rng.randn(3, 20).astype(np.float32)
        c = rng.randn(3, 15, 4).astype(np.float32)
        offsets = [-1.5, -0.5, 0.5, 1.5]
        got = parallel.apply_stencil_local(torch.from_numpy(u_pad), torch.from_numpy(c),
                                           offsets, 3, -0.5, out_start=-1, out_size=15)
        want = jparallel.apply_stencil_local(jnp.asarray(u_pad), jnp.asarray(c), offsets, 3,
                                             -0.5, out_start=-1, out_size=15)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)

    def test_halo_too_small_raises(self):
        with pytest.raises(ValueError):
            parallel.apply_stencil_local(torch.zeros(10), torch.zeros(5),
                                         [-2, -1, 0, 1, 2], halo=1)


# -- the sharded RHS ----------------------------------------------------------------


class TestShardedRHS:
    @pytest.mark.parametrize("name,cons", BASE_CASES)
    def test_baseline_rhs_matches_jax(self, world4, inputs, name, cons):
        """(data=2, space=2) against JAX's sharded_baseline_rhs on the same
        mesh shape and against the unsharded rhs_fn: rtol/atol 2e-4 (JAX's
        bound, :113-126)."""
        u, forcing = inputs[1][f"base/{name}"]
        eq = jeq.from_name(name, conservative=cons)
        grid = JGrid(64, eq.period)
        got = worker.blocks(world4, f"base/{name}/{cons}", 2, 2).numpy()
        want = jintegrate.PolynomialDifferentiator(eq, grid).rhs_fn(forcing)(u, 0.3)
        mesh = jparallel.make_mesh(data=2, space=2)
        sharded = jparallel.sharded_baseline_rhs(eq, grid, mesh, forcing=forcing)(u, 0.3)
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, np.asarray(sharded), rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("cons", [False, True])
    @pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
    def test_model_rhs_matches_jax(self, world4, inputs, cons, shape):
        """Stencil 7, perturbed params, against JAX's unsharded rhs_fn and, at
        (data=2, space=2), its sharded_model_rhs on the same mesh shape: rtol
        2e-3, atol 2e-4 (JAX's bound, :128-147)."""
        model, tree = inputs[1][f"model/{cons}"]
        u = jnp.asarray(inputs[0]["model/u"].numpy())
        got = worker.blocks(world4, f"model/{cons}/{shape}", *shape).numpy()
        want = model.rhs_fn(tree, use_pallas=False)(u, 0.0)
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-4)
        if shape == (2, 2):
            sharded = jparallel.sharded_model_rhs(model, tree, jparallel.make_mesh(*shape))(u, 0.0)
            np.testing.assert_allclose(got, np.asarray(sharded), rtol=2e-3, atol=2e-4)

    def test_sharded_integration_matches_jax(self, world4, inputs):
        """50 RK4 steps of the sharded baseline on a ring of 4 against JAX's
        sharded integration on a ring of 4: rtol 1e-3, atol 1e-4 (:149-165)."""
        eq = jeq.from_name("ks", conservative=True)
        grid = JGrid(64, eq.period)
        u0 = jnp.asarray(inputs[0]["integrate/u0"].numpy())
        mesh = jparallel.make_mesh(data=1, space=4)
        rhs = jparallel.sharded_baseline_rhs(eq, grid, mesh)
        u0_sh = jax.device_put(u0, NamedSharding(mesh, P("space")))
        _, want = jintegrate.integrate(rhs, u0_sh, eq.stable_time_step(grid), 50)
        got = worker.blocks(world4, "integrate", 1, 4).numpy()
        np.testing.assert_allclose(got, np.asarray(want[-1]), rtol=1e-3, atol=1e-4)


# -- fused_rk4_fn(mesh=) ------------------------------------------------------------


def _port_model(name, tree):
    eq = teq.from_name(name, conservative=True)
    grid = Grid(8 * 128, eq.period).resample(8, conservative=True)
    model = StencilModel(eq, grid, ModelConfig(stencil_size=6), device="cpu")
    return model, convert.params_from_jax(tree, device="cpu"), eq.stable_time_step(grid, 3.0)


class TestFusedRK4DP:
    """Each of 4 ranks advances its 8 rows with the kernel's plain version on
    the CPU, with the params replicated and its rows of the forcing."""

    def test_matches_meshless_advance(self, world4, inputs):
        """rtol 1e-5, atol 1e-6 (:340-351)."""
        *_, tree, u0, _ = inputs[1]["fused/ks"]
        model, params, dt = _port_model("ks", tree)
        want = model.fused_rk4_fn(params, dt, 2)(torch.from_numpy(u0))
        got = worker.blocks(world4, "fused/ks", 4, 1)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)

    def test_forced_matches_meshless(self, world4, inputs):
        """Burgers from t=0.37: each rank's rows of the forcing reach its
        advance (:353-371), rtol 1e-5, atol 1e-6."""
        *_, tree, u0, forcing = inputs[1]["fused/burgers"]
        model, params, dt = _port_model("burgers", tree)
        want = model.fused_rk4_fn(params, dt, 2, forcing=_forcing_t(forcing), t0=0.37)(
            torch.from_numpy(u0))
        got = worker.blocks(world4, "fused/burgers", 4, 1)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)

    def test_integrate_fused_under_mesh_matches_jax_integrate(self, world4, inputs):
        """integrate_fused over the ranks' advances against JAX's unsharded
        integrate of the plain rhs_fn: times to rtol 1e-6, states within
        2e-3 of max|u| (:373-391; the kernel rounds its tower to bf16)."""
        eq, grid, model_j, tree, u0, _ = inputs[1]["fused/ks"]
        dt = eq.stable_time_step(grid, u_scale=3.0)
        want_times, want = jintegrate.integrate(model_j.rhs_fn(tree, use_pallas=False),
                                                jnp.asarray(u0), dt, 4, 2)
        got = torch.cat([r["fused/integrate"] for r in world4], dim=1).numpy()
        np.testing.assert_allclose(world4[0]["fused/times"].numpy(), np.asarray(want_times),
                                   rtol=1e-6)
        err = np.abs(got - np.asarray(want)).max()
        assert err < 2e-3 * np.abs(np.asarray(want)).max(), err

    def test_space_axis_rejected(self, world4):
        assert "size 1" in world4[0]["fused/space_refused"]

    def test_missing_data_axis_rejected(self, world4):
        assert "'data' axis" in world4[0]["fused/no_data_refused"]


def test_refusals_in_process():
    """The same refusals without a process group, on a stand-in mesh."""

    class Mesh:
        def __init__(self, names, sizes):
            self.mesh_dim_names, self._sizes = names, sizes

        def size(self, i):
            return self._sizes[i]

    eq = teq.from_name("ks", conservative=True)
    model = StencilModel(eq, Grid(128, eq.period), ModelConfig(num_layers=1, filters=4,
                                                                stencil_size=6), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="size 1"):
        model.fused_rk4_fn(params, 0.01, 2, mesh=Mesh(("data", "space"), (2, 2)))
    with pytest.raises(ValueError, match="data"):
        model.fused_rk4_fn(params, 0.01, 2, mesh=Mesh(("model",), (4,)))
    assert mesh_lib.axis_size(Mesh(("model",), (4,)), "data") == 1


# -- serving under data parallelism ---------------------------------------------------


class TestServedDP:
    """A frozen artifact's RHS and advance per rank, on its rows (4 of 16),
    equal the same call of one process on those rows exactly, and the
    unsharded 16-row call to the CPU's rounding.

    JAX's test (test_export.py:180, 185, 202) holds the unsharded call
    exactly. PyTorch's CPU convolution rounds a batch of 16 rows
    differently from a batch of 8 or fewer (the live model's plain route
    does too; measured 1.2e-5 of max|u_t| for the KS RHS, whose face
    difference cancels most of the sum, and 6.7e-8 of max|u| for the
    advance), so against the 16-row call the RHS is held to 2e-5 of
    max|u_t| and the advance to 1e-6 of max|u|."""

    @pytest.mark.parametrize("what", ["rhs", "advance"])
    def test_per_rank_equals_unsharded(self, world4, inputs, what):
        served = export.load_served_model(inputs[0]["serve/path"], device="cpu")
        u = inputs[0]["serve/u"]
        call = ((lambda x: served.rhs_fn()(x, 0.5)) if what == "rhs"
                else (lambda x: served.advance(x, 0.0)[0]))
        got = worker.blocks(world4, f"serve/{what}", 4, 1)
        same_rows = torch.cat([call(u[4 * r:4 * r + 4].contiguous()) for r in range(4)])
        np.testing.assert_array_equal(got.numpy(), same_rows.numpy())
        want = call(u)
        tol = 2e-5 if what == "rhs" else 1e-6
        assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def test_unopenable_store_raises_on_every_rank(world4):
    """``integrate_resumable(mesh=)`` on a store rank 0 cannot open (a file
    that is not HDF5): rank 0 raises h5py's error and every other rank
    raises too, where it used to wait at the carry's broadcast until the
    group timed out (the spawn's 180 s limit would fail this test)."""
    pytest.importorskip("h5py")
    assert world4[0]["store/error"] != "no error"
    for r in world4[1:]:
        assert "rank 0 could not open the store" in r["store/error"], r["store/error"]
