"""The port's training data and config against the JAX package's.

Snapshots, initial conditions and forcing are drawn once (by the JAX
package or numpy) and handed to both packages as the same numpy arrays.
"""

import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pde_superresolution_tpu import equations as jeq
from pde_superresolution_tpu import integrate as jint
from pde_superresolution_tpu.grids import Grid as JGrid
from pde_superresolution_tpu.training import config as jconfig
from pde_superresolution_tpu.training import data as jdata
from pde_superresolution_torch import convert
from pde_superresolution_torch import equations as teq
from pde_superresolution_torch import integrate as tint
from pde_superresolution_torch.grids import Grid as TGrid
from pde_superresolution_torch.training import config as tconfig
from pde_superresolution_torch.training import data as tdata
from pde_superresolution_torch.training import loop as tloop

torch.set_num_threads(1)


def _forcing_pair(eq_j, num):
    """The same forcing as JAX ForcingParams and as the port's."""
    forcing = eq_j.sample_forcing(jax.random.PRNGKey(3), (num,))
    if forcing is None:
        return None, None
    leaves = [np.asarray(leaf) for leaf in forcing]
    return forcing, teq.ForcingParams(*(torch.from_numpy(leaf) for leaf in leaves))


@pytest.mark.parametrize("name,warmup", [("burgers", 0.3), ("ks", 1.0)])
def test_exact_solve_sampled_matches_jax(name, warmup):
    """The sampled exact solve with a warm-up (forced Burgers, KS) from the
    same numpy state: times equal to 1e-6, trajectories within 1e-5 of
    max|u| (both ETDRK4 in complex64 with the same coefficients; FFTs in
    another order of operations)."""
    eq_j = jeq.from_name(name)
    grid_j = JGrid(128, eq_j.period)
    u0 = np.asarray(eq_j.initial_conditions(jax.random.PRNGKey(1), grid_j, (3,)))
    forcing_j, forcing_t = _forcing_pair(eq_j, 3)
    want_times, want = jint.exact_solve_sampled(
        eq_j, grid_j, jnp.asarray(u0), 0.1, 5, warmup_time=warmup, forcing=forcing_j)
    eq_t = teq.from_name(name)
    got_times, got = tint.exact_solve_sampled(
        eq_t, TGrid(128, eq_t.period), torch.from_numpy(u0), 0.1, 5, warmup_time=warmup,
        forcing=forcing_t)
    np.testing.assert_allclose(got_times.numpy(), np.asarray(want_times), rtol=1e-6)
    want = np.asarray(want)
    assert got.shape == want.shape == (5, 3, 128)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert tint.EXACT_SOLVER_VERSION == jint.EXACT_SOLVER_VERSION


def _snapshot_pair(name, cons, num_traj=2, num_times=7, fine_size=128):
    """The same fine snapshots as the JAX package's Snapshots and the port's."""
    eq_j = jeq.from_name(name, conservative=cons)
    fine_j = JGrid(fine_size, eq_j.period)
    snaps = jdata.generate_snapshots(eq_j, fine_j, jax.random.PRNGKey(0), num_traj,
                                     num_times, 0.05, ic_scale=0.5)
    u, times = np.asarray(snaps.u), np.asarray(snaps.times)
    forcing_t = None
    if snaps.forcing is not None:
        forcing_t = teq.ForcingParams(*(torch.from_numpy(np.asarray(x)) for x in snaps.forcing))
    eq_t = teq.from_name(name, conservative=cons)
    snaps_t = tdata.Snapshots(u=torch.from_numpy(u), times=torch.from_numpy(times),
                              forcing=forcing_t)
    return eq_j, fine_j, snaps, eq_t, TGrid(fine_size, eq_t.period), snaps_t


def _assert_close(got, want, tol, what):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30), what


@pytest.mark.parametrize("name,cons", [("burgers", True), ("ks", False), ("kdv", True)])
def test_build_training_data_matches_jax(name, cons):
    """Every field from the same numpy snapshots: coarse inputs, rollouts,
    times, forcing and trajectory ids equal (the same means and slices).
    The spectral labels multiply the float32 rounding of u (some 1e-7 of
    max|u| per mode, FFTs in another order) by up to k_max^d at the fine
    grid's largest wavenumber: each order-d label within 1e-6 max|u| k_max^d
    (read at most 5.1e-6 on u_xx of KS), and u_t
    within the limit of the equation's highest order."""
    eq_j, fine_j, snaps_j, eq_t, fine_t, snaps_t = _snapshot_pair(name, cons)
    want = jdata.build_training_data(eq_j, fine_j, snaps_j, 4, unroll_steps=2)
    got = tdata.build_training_data(eq_t, fine_t, snaps_t, 4, unroll_steps=2)
    assert got.num_samples == want.num_samples == 2 * 5
    _assert_close(got.inputs, want.inputs, 1e-6, "inputs")
    _assert_close(got.rollout, want.rollout, 1e-6, "rollout")
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))
    np.testing.assert_array_equal(got.traj_ids.numpy(), np.asarray(want.traj_ids))
    assert got.traj_ids.dtype == torch.int32
    assert sorted(got.deriv_labels) == sorted(want.deriv_labels)
    k_max = np.pi / fine_j.dx
    limit = lambda d: 1e-6 * float(np.abs(np.asarray(snaps_j.u)).max()) * max(k_max, 1.0) ** d
    for d in want.deriv_labels:
        err = np.abs(got.deriv_labels[d].numpy() - np.asarray(want.deriv_labels[d])).max()
        assert err <= limit(d), (d, err, limit(d))
    top = max(eq_j.derivative_orders) + (1 if cons else 0)
    err = np.abs(got.time_deriv_label.numpy() - np.asarray(want.time_deriv_label)).max()
    assert err <= limit(top), (err, limit(top))
    assert (got.forcing is None) == (want.forcing is None)
    if want.forcing is not None:
        for a, b in zip(got.forcing, want.forcing):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the rollout window of sample i is the input of sample i + k + 1
    torch.testing.assert_close(got.rollout[0, 1], got.inputs[2], rtol=0, atol=0)
    with pytest.raises(ValueError, match="snapshot times"):
        tdata.build_training_data(eq_t, fine_t, snaps_t, 4, unroll_steps=7)
    with pytest.raises(ValueError, match="synthesized"):
        tdata.build_training_data(eq_t, fine_t, snaps_t._replace(synthetic_times=True), 4, 2)


def test_sample_training_batch_matches_flat_pipeline_and_host_staging():
    """A trajectory-structured batch equals the flat pipeline's samples at
    the same (trajectory, time) pairs, bit for bit, and a host-resident
    (numpy) dataset gives the same batch as the resident one."""
    _, _, _, eq_t, fine_t, snaps_t = _snapshot_pair("burgers", True, num_traj=3, num_times=9)
    unroll, usable = 3, 6
    flat = tdata.build_training_data(eq_t, fine_t, snaps_t, 4, unroll_steps=unroll)
    series, labels, ut = tdata._coarse_fields_and_labels(eq_t, fine_t, snaps_t, 4, usable)
    structured = tdata.TrajectoryData(series, snaps_t.times, snaps_t.forcing, labels, ut, unroll)
    host = tdata.map_data(lambda a: a.numpy(), structured)
    assert host.host_resident and not structured.host_resident
    assert host.nbytes() == structured.nbytes() > 0
    assert structured.usable_times == usable and structured.num_trajectories == 3
    rng = np.random.RandomState(0)
    ti, si = rng.randint(0, 3, size=8), rng.randint(0, usable, size=8)
    batch = tdata.sample_training_batch(structured, torch.from_numpy(ti), torch.from_numpy(si))
    staged = tdata.sample_training_batch(host, ti, si)
    want = tloop._slice_batch(flat, ti * usable + si)
    for name in ("inputs", "t", "time_deriv_label", "rollout", "traj_ids"):
        np.testing.assert_array_equal(getattr(batch, name).numpy(), getattr(want, name).numpy())
        np.testing.assert_array_equal(np.asarray(getattr(staged, name)),
                                      getattr(want, name).numpy())
    for d in want.deriv_labels:
        np.testing.assert_array_equal(batch.deriv_labels[d].numpy(), want.deriv_labels[d].numpy())
        np.testing.assert_array_equal(staged.deriv_labels[d], want.deriv_labels[d].numpy())
    for a, b, c in zip(batch.forcing, staged.forcing, want.forcing):
        np.testing.assert_array_equal(a.numpy(), c.numpy())
        np.testing.assert_array_equal(b, c.numpy())


def test_build_trajectory_data_chunks_are_seeded_and_host_staging_agrees():
    """Chunk c draws from chunk_seed(seed, c), a pure function of both: two
    builds agree bit for bit, host staging keeps the values, chunk 0 of a
    build equals a one-chunk build of its trajectories, and chunks differ."""
    eq = teq.from_name("ks", conservative=True)
    fine = TGrid(128, eq.period)
    kwargs = dict(num_trajectories=5, num_times=6, time_delta=0.05, resample_factor=4,
                  unroll_steps=2, chunk_trajectories=2, device="cpu")
    a = tdata.build_trajectory_data(eq, fine, 7, **kwargs)
    b = tdata.build_trajectory_data(eq, fine, 7, host_resident=True, **kwargs)
    assert b.host_resident and a.series.shape == (5, 6, 32)
    np.testing.assert_array_equal(a.series.numpy(), b.series)
    np.testing.assert_array_equal(a.time_deriv_label.numpy(), b.time_deriv_label)
    first = tdata.build_trajectory_data(eq, fine, 7, **{**kwargs, "num_trajectories": 2})
    np.testing.assert_array_equal(first.series.numpy(), a.series[:2].numpy())
    assert not torch.equal(a.series[:2], a.series[2:4])
    assert tdata.chunk_seed(7, 1) == tdata.chunk_seed(7, 1) != tdata.chunk_seed(7, 2)
    assert tdata.chunk_seed(7, 1) != tdata.chunk_seed(8, 1)


def test_generate_snapshots_shapes_and_determinism():
    """Seeded generation on the CPU: the shapes of the JAX package's
    Snapshots, finite values, and the same generator seed gives the same
    snapshots."""
    eq = teq.from_name("burgers", conservative=True)
    fine = TGrid(64, eq.period)
    make = lambda: tdata.generate_snapshots(eq, fine, torch.Generator().manual_seed(0), 2, 4,
                                            0.05, warmup_time=0.1, device="cpu")
    snaps = make()
    assert snaps.u.shape == (2, 4, 64) and snaps.times.shape == (4,)
    assert snaps.forcing.amplitude.shape == (2, 20)
    assert torch.isfinite(snaps.u).all()
    torch.testing.assert_close(make().u, snaps.u, rtol=0, atol=0)


# -- config ---------------------------------------------------------------------------

OVERRIDES = [
    "",
    "filters=64,conservative=false,num_time_steps=8",
    "learning_rates=1e-2;1e-3,learning_stops=100;200",
    "filters=64,integrated_solution=0.5,relative_error=0.25",
    "eq.period=62.8,eq.forcing_k_min=30,eq.forcing_k_max=60,equation=burgers",
    "unroll_curriculum=2;4,curriculum_stops=10;20,num_time_steps=4,learning_stops=20",
    "tower_dtype=bfloat16,rollout_noise=0.02,coarse_time_subsample=3",
]


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_parse_hparams_and_to_json_match_jax(overrides):
    """The same overrides give the same config JSON dict in both packages,
    and from_json round-trips it; curriculum phases agree."""
    want = jconfig.parse_hparams(overrides)
    got = tconfig.parse_hparams(overrides)
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    assert tconfig.TrainingConfig.from_json(got.to_json()) == got
    assert got.curriculum_phases() == want.curriculum_phases()
    assert got.num_steps == want.num_steps


@pytest.mark.parametrize("asset", convert.asset_names())
def test_from_json_reads_committed_assets_like_jax(asset):
    """Each committed asset's JSON (the JAX package's checkpoint config)
    reads into the same config in both packages."""
    text = (convert.ASSET_DIR / f"{asset}.json").read_text()
    want = jconfig.TrainingConfig.from_json(text)
    got = tconfig.TrainingConfig.from_json(text)
    assert json.loads(got.to_json()) == json.loads(want.to_json())


@pytest.mark.parametrize("overrides,match", [
    ("warp_speed=9", "unknown hparam"),
    ("model=3", "nested"),
])
def test_parse_hparams_refusals(overrides, match):
    with pytest.raises(ValueError, match=match):
        tconfig.parse_hparams(overrides)


def test_curriculum_validation_matches_jax():
    """Each malformed curriculum is refused by both packages."""
    for overrides in ("curriculum_stops=10",
                      "unroll_curriculum=2;4,curriculum_stops=10",
                      "unroll_curriculum=4;2,curriculum_stops=10;20,learning_stops=20",
                      "unroll_curriculum=2;3,curriculum_stops=10;20,learning_stops=20"):
        for lib in (jconfig, tconfig):
            with pytest.raises(ValueError):
                lib.parse_hparams(overrides).curriculum_phases()
