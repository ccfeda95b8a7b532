"""2-D domain-decomposed stencil operator on the virtual 8-device mesh
(4x2 grid decomposition; SURVEY.md §2.3 distributed layer)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import linops_tpu as lo
from linops_tpu.parallel import (HaloStencil2DOperator, collective_counts,
                                 make_mesh2d, stencil_partition_2d)

LAPLACE = [4.0, -1.0, -1.0, -1.0, -1.0]


@pytest.fixture(scope="module")
def mesh2d():
    if jax.device_count() < 8:
        pytest.skip("needs 8 (virtual) devices")
    return make_mesh2d(4, 2)


def test_halo2d_matches_single_device_stencil(mesh2d, rng):
    ny, nx = 16, 12
    op = stencil_partition_2d(jnp.asarray(LAPLACE), ny, nx, mesh2d)
    assert op.symmetric and op.hermitian and op.shape == (ny * nx, ny * nx)
    U = rng.standard_normal((ny, nx))
    v = op.grid_to_vec(jnp.asarray(U))
    L = lo.laplacian_2d(ny, nx, dtype=jnp.float64)
    y_ref = np.asarray(L @ jnp.asarray(U.reshape(-1))).reshape(ny, nx)
    np.testing.assert_allclose(np.asarray(op.vec_to_grid(op @ v)), y_ref,
                               atol=1e-12)
    # layout roundtrip is a pure relabeling
    np.testing.assert_allclose(np.asarray(op.vec_to_grid(op.grid_to_vec(U))), U)


def test_halo2d_collective_contract(mesh2d, rng):
    """The apply moves ONLY the four edge strips: exactly 4
    collective-permutes and ZERO all-gathers (the blocked vector layout
    is what makes the gather-free schedule possible)."""
    ny, nx = 16, 12
    op = stencil_partition_2d(jnp.asarray(LAPLACE), ny, nx, mesh2d)
    v = jnp.ones((ny * nx,))
    counts = collective_counts(lambda o, x: o @ x, op, v)
    assert counts.get("collective-permute", 0) == 4
    assert counts.get("all-gather", 0) == 0
    assert counts.get("all-reduce", 0) == 0


def test_collective_counts_combined_permutes():
    """XLA:GPU merges permutes with the same peers (both strips of a
    2-wide mesh axis) into one variadic instruction; the count is of the
    arrays moved, so it matches the uncombined CPU program."""
    from linops_tpu.parallel import hlo_collective_counts

    pairs = "source_target_pairs={{0,1},{1,0}}"
    split = "\n".join(
        f"  %p.{i} = f32[1,8]{{1,0}} collective-permute(%s.{i}), {pairs}"
        for i in range(4))
    combined = "\n".join(
        f"  %cp.{i} = ((f32[1,8]{{1,0}}, f32[1,8]{{1,0}}), u32[]) "
        f"collective-permute-start(%s.{2 * i}, %s.{2 * i + 1}), {pairs}\n"
        f"  %d.{i} = (f32[1,8]{{1,0}}, f32[1,8]{{1,0}}) "
        f"collective-permute-done(%cp.{i})"
        for i in range(2))
    for text in (split, combined):
        counts = hlo_collective_counts(text)
        assert counts["collective-permute"] == 4, text
        assert counts["all-gather"] == 0


def test_halo2d_transpose_modes(mesh2d, rng):
    ny, nx = 12, 8
    cfs = jnp.asarray([4.0, -1.0, -2.0, -0.5, -1.5])  # nonsymmetric
    op = stencil_partition_2d(cfs, ny, nx, mesh2d)
    assert not op.symmetric
    D = np.asarray(lo.to_dense(op))
    v = jnp.asarray(rng.standard_normal(ny * nx))
    np.testing.assert_allclose(np.asarray(op.T @ v), D.T @ np.asarray(v),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.H @ v), D.T @ np.asarray(v),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.T.T @ v), D @ np.asarray(v),
                               atol=1e-12)


def test_halo2d_solvers_and_eigs(mesh2d, rng):
    ny, nx = 16, 12
    op = stencil_partition_2d(jnp.asarray(LAPLACE), ny, nx, mesh2d)
    b = jnp.asarray(rng.standard_normal(ny * nx))
    x, it, res = lo.cg(op, b, tol=1e-10, maxiter=500)
    assert float(res) < 1e-8
    th, X, rr, it2 = lo.lobpcg(op, k=2, largest=True, tol=1e-8, maxiter=600,
                               key=jax.random.PRNGKey(0))
    hy, hx = np.pi / (ny + 1), np.pi / (nx + 1)
    lam = np.sort([4 - 2 * np.cos(i * hy) - 2 * np.cos(j * hx)
                   for i in range(1, ny + 1) for j in range(1, nx + 1)])
    np.testing.assert_allclose(np.asarray(th), lam[-2:][::-1], rtol=1e-5)


def test_halo2d_validation(mesh2d):
    with pytest.raises(lo.LinearOperatorException):
        stencil_partition_2d(jnp.ones(4), 8, 8, mesh2d)  # not 5 coeffs
    with pytest.raises(lo.LinearOperatorException):
        stencil_partition_2d(jnp.ones(5), 9, 8, mesh2d)  # 9 % 4 != 0


def test_halo2d_rejects_matrix_apply(mesh2d, rng):
    # review finding: 2-D input used to die inside shard_map with an
    # opaque reshape error; apply_matrix is the matrix path
    op = stencil_partition_2d(jnp.asarray(LAPLACE), 16, 12, mesh2d)
    with pytest.raises(lo.LinearOperatorException):
        op.apply(jnp.ones((16 * 12, 3)), "N")
    Y = op.apply_matrix(jnp.ones((16 * 12, 3)), "N")
    assert Y.shape == (16 * 12, 3)


def test_chebyshev_is_all_reduce_free_on_halo2d(mesh2d):
    """The communication-avoiding contrast: a whole Chebyshev solve on
    the decomposed operator compiles with ZERO all-reduces (CG pays them
    for its inner products)."""
    L = stencil_partition_2d(jnp.asarray(LAPLACE), 32, 16, mesh2d)
    b = jnp.ones((32 * 16,))
    cheb_counts = collective_counts(
        lambda o, x: lo.chebyshev(o, x, 0.05, 8.0, iters=30)[0], L, b)
    assert cheb_counts["all-reduce"] == 0
    assert cheb_counts["all-gather"] == 0
    cg_counts = collective_counts(
        lambda o, x: lo.cg(o, x, tol=1e-8, maxiter=30)[0], L, b)
    assert cg_counts["all-reduce"] > 0  # the inner products
