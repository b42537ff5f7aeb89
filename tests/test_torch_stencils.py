"""The port's stencil setup and apply_stencil against the JAX package."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pde_superresolution_tpu import stencils as jst
from pde_superresolution_torch import stencils as tst

torch.set_num_threads(1)

METHODS = [
    (jst.Method.FINITE_DIFFERENCES, tst.Method.FINITE_DIFFERENCES),
    (jst.Method.FINITE_VOLUMES, tst.Method.FINITE_VOLUMES),
]


@pytest.mark.parametrize("size", [1, 2, 5, 6, 7, 8])
@pytest.mark.parametrize("staggered", [False, True])
def test_offsets_bit_equal(size, staggered):
    np.testing.assert_array_equal(
        tst.stencil_offsets(size, staggered), jst.stencil_offsets(size, staggered)
    )


@pytest.mark.parametrize("methods", METHODS, ids=["fd", "fv"])
@pytest.mark.parametrize("order,accuracy,size", [
    (0, 2, 4), (1, 2, 4), (1, 3, 6), (2, 2, 6), (3, 2, 6), (4, 2, 7), (2, 1, 3),
])
def test_constraints_and_coefficients_bit_equal(methods, order, accuracy, size):
    jm, tm = methods
    staggered = jm is jst.Method.FINITE_VOLUMES
    offsets = jst.stencil_offsets(size, staggered)
    a_j, b_j = jst.constraints(offsets, jm, order, accuracy)
    a_t, b_t = tst.constraints(offsets, tm, order, accuracy)
    np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_array_equal(b_t, b_j)
    for acc in (accuracy, None):
        np.testing.assert_array_equal(
            tst.coefficients(offsets, tm, order, acc, dx=0.37),
            jst.coefficients(offsets, jm, order, acc, dx=0.37),
        )


@pytest.mark.parametrize("order", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("staggered", [False, True])
@pytest.mark.parametrize("size", [None, 6, 7, 8])
def test_classic_stencil_bit_equal(order, staggered, size):
    for accuracy in (1, 2, 3):
        assert tst.baseline_stencil_size(order, accuracy, staggered) == (
            jst.baseline_stencil_size(order, accuracy, staggered)
        )
    want = jst.classic_stencil(order, staggered, 0.5, size=size)
    got = tst.classic_stencil(order, staggered, 0.5, size=size)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("methods", METHODS, ids=["fd", "fv"])
@pytest.mark.parametrize("order,size", [(0, 6), (1, 6), (3, 6), (2, 7), (4, 7)])
@pytest.mark.parametrize("biased", [False, True])
def test_polynomial_accuracy_bit_equal(methods, order, size, biased):
    jm, tm = methods
    staggered = jm is jst.Method.FINITE_VOLUMES
    offsets, classic = jst.classic_stencil(order, staggered, 0.5, size=size)
    bias = classic * 0.5**order if biased else None
    want = jst.PolynomialAccuracy.create(offsets, jm, order, 2, dx=0.5, bias=bias)
    got = tst.PolynomialAccuracy.create(offsets, tm, order, 2, dx=0.5, bias=bias)
    np.testing.assert_array_equal(got.c0, want.c0)
    np.testing.assert_array_equal(got.nullspace, want.nullspace)
    assert got.scale == want.scale
    assert got.offsets == want.offsets and got.free_dims == want.free_dims


def test_projection_matches():
    """c0 + scale * z @ N: float32 matmuls at full precision on both sides
    (HIGHEST in JAX), summed over <= 5 free dims in possibly different
    orders, so agreement is to a few float32 ulps of the largest term:
    rtol 1e-6, atol 1e-6 x max|c|."""
    offsets, classic = jst.classic_stencil(3, True, 0.5, size=6)
    layer_j = jst.PolynomialAccuracy.create(
        offsets, jst.Method.FINITE_VOLUMES, 3, 2, dx=0.5, bias=classic * 0.125
    )
    layer_t = tst.PolynomialAccuracy.create(
        offsets, tst.Method.FINITE_VOLUMES, 3, 2, dx=0.5, bias=classic * 0.125
    )
    z = np.random.default_rng(0).standard_normal((4, 16, layer_j.free_dims))
    z = z.astype(np.float32)
    want = np.asarray(layer_j(jnp.asarray(z)))
    got = layer_t(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    fixed_j = jst.FixedCoefficients(tuple(offsets), 3, classic, scale=2.0)
    fixed_t = tst.FixedCoefficients(tuple(offsets), 3, classic, scale=2.0)
    z6 = z[..., :1].repeat(6, -1)
    np.testing.assert_array_equal(
        fixed_t(torch.from_numpy(z6)).numpy(), np.asarray(fixed_j(jnp.asarray(z6)))
    )


@pytest.mark.parametrize("offsets,shift", [
    ((-2.5, -1.5, -0.5, 0.5, 1.5, 2.5), -0.5),
    ((-3, -2, -1, 0, 1, 2, 3), 0.0),
    ((-1.5, -0.5, 0.5, 1.5), -0.5),
])
def test_apply_stencil_matches(offsets, shift):
    """Per-point coefficients against rolled copies of u: the same float32
    products, summed over <= 7 taps perhaps in another order, so rtol 1e-6
    with an atol of 1e-6 x max|out| for cancelling sums."""
    rng = np.random.default_rng(1)
    u = rng.standard_normal((3, 37)).astype(np.float32)
    c = rng.standard_normal((3, 37, len(offsets))).astype(np.float32)
    want = np.asarray(jst.apply_stencil(jnp.asarray(u), jnp.asarray(c), offsets, shift))
    got = tst.apply_stencil(torch.from_numpy(u), torch.from_numpy(c), offsets, shift)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max()
    )
    # a bare [stencil] coefficient vector broadcasts as in JAX
    c1 = c[0, 0]
    want1 = np.asarray(jst.apply_stencil(jnp.asarray(u), jnp.asarray(c1), offsets, shift))
    got1 = tst.apply_stencil(torch.from_numpy(u), torch.from_numpy(c1), offsets, shift)
    np.testing.assert_allclose(got1.numpy(), want1, rtol=1e-6, atol=1e-6 * np.abs(want1).max())


def test_off_grid_offsets_raise():
    with pytest.raises(ValueError, match="grid points"):
        tst.apply_stencil(torch.zeros(8), torch.zeros(2), (-0.5, 0.5), 0.0)
    assert tst.int_taps((-2.5, -1.5, -0.5, 0.5, 1.5, 2.5), -0.5) == (-2, -1, 0, 1, 2, 3)
