"""Shifted L-BFGS system solver tests
(reference: test/test_solve_shifted_system.jl)."""

import numpy as np
import pytest

from linops_tpu.qn import LBFGSOperator, InverseLBFGSOperator
from linops_tpu.qn.shifted_solve import solve_shifted_system, ldiv


def setup_test_val(rng, mem=5, n=100, scaling=False, sigma=0.1):
    """reference setup (test/test_solve_shifted_system.jl:6-21)."""
    B = LBFGSOperator(n, mem=mem, scaling=scaling)
    H = InverseLBFGSOperator(n, mem=mem, scaling=False)
    for _ in range(10):
        s = rng.random(n)
        y = rng.random(n)
        B.push(s, y)
        H.push(s, y)
    x = rng.standard_normal(n)
    b = np.asarray(B * x) + sigma * x  # true answer is x
    return B, H, b, sigma, x


def test_default_setup(rng):
    B, _, b, sigma, x_true = setup_test_val(rng, n=100, mem=5)
    x_sol = np.asarray(solve_shifted_system(B, b, sigma))
    assert x_sol.shape == b.shape
    assert np.isfinite(x_sol).all()
    np.testing.assert_allclose(x_sol, x_true, atol=1e-6, rtol=1e-6)


def test_scaled_operator(rng):
    B, _, b, sigma, x_true = setup_test_val(rng, n=60, mem=5, scaling=True)
    x_sol = np.asarray(solve_shifted_system(B, b, sigma))
    np.testing.assert_allclose(x_sol, x_true, atol=1e-6, rtol=1e-6)


def test_negative_sigma_raises(rng):
    B, _, b, _, _ = setup_test_val(rng, n=100, mem=5)
    with pytest.raises(ValueError):
        solve_shifted_system(B, b, -0.1)


def test_inverse_operator_rejected(rng):
    H = InverseLBFGSOperator(10, mem=3)
    with pytest.raises(ValueError):
        solve_shifted_system(H, np.ones(10), 0.1)


def test_ldiv(rng):
    """ldiv solves Bx = b; consistent with H = B⁻¹ applied to b
    (reference test/test_solve_shifted_system.jl:50-62)."""
    B, H, b, _, x_true = setup_test_val(rng, n=100, mem=5, sigma=0.0)
    x_sol = np.asarray(ldiv(B, b))
    x_H = np.asarray(H * b)
    np.testing.assert_allclose(x_sol, x_H, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(x_sol, x_true, atol=1e-6, rtol=1e-6)


def test_partial_memory(rng):
    """Solver is correct when the ring buffer is not yet full."""
    n, mem = 30, 8
    B = LBFGSOperator(n, mem=mem, scaling=False)
    for _ in range(3):  # fewer pushes than mem
        B.push(rng.random(n), rng.random(n))
    x = rng.standard_normal(n)
    sigma = 0.25
    b = np.asarray(B * x) + sigma * x
    x_sol = np.asarray(solve_shifted_system(B, b, sigma))
    np.testing.assert_allclose(x_sol, x, atol=1e-6, rtol=1e-6)


def test_compact_equals_ejm_and_dense(rng):
    """Woodbury/compact solve == EJM recursion == dense solve across
    partial/full/wrapped rings, with and without scaling."""
    n, mem = 40, 6
    for scaling in (False, True):
        for pushes in (2, mem, mem + 4):
            B = LBFGSOperator(n, mem=mem, scaling=scaling)
            for _ in range(pushes):
                s = rng.standard_normal(n)
                y = s + 0.3 * rng.standard_normal(n)
                B.push(s, y)
            b = rng.standard_normal(n)
            for sigma in (0.0, 0.37):
                x_c = np.asarray(solve_shifted_system(B, b, sigma))
                Bd = np.asarray(B.to_dense())
                x_d = np.linalg.solve(Bd + sigma * np.eye(n), b)
                np.testing.assert_allclose(x_c, x_d, rtol=1e-9, atol=1e-9,
                    err_msg=f"compact vs dense: scaling={scaling} pushes={pushes} sigma={sigma}")
                # EJM is degenerate at sigma=0 on partially-filled rings
                # (see shifted_solve.py docstring); compare elsewhere.
                if sigma > 0 or pushes >= mem:
                    x_e = np.asarray(solve_shifted_system(B, b, sigma, method="ejm"))
                    np.testing.assert_allclose(x_e, x_d, rtol=1e-8, atol=1e-8,
                        err_msg=f"ejm vs dense: scaling={scaling} pushes={pushes} sigma={sigma}")


def test_batched_sigmas(rng):
    """vmapped multi-shift solve matches per-shift solves."""
    from linops_tpu.qn.shifted_solve import solve_shifted_systems

    n, mem = 30, 5
    B = LBFGSOperator(n, mem=mem, scaling=True)
    for _ in range(7):
        s = rng.standard_normal(n)
        B.push(s, s + 0.2 * rng.standard_normal(n))
    b = rng.standard_normal(n)
    sigmas = np.array([0.0, 0.1, 1.0, 10.0])
    X = np.asarray(solve_shifted_systems(B, b, sigmas))
    Bd = np.asarray(B.to_dense())
    for i, sg in enumerate(sigmas):
        ref = np.linalg.solve(Bd + sg * np.eye(n), b)
        np.testing.assert_allclose(X[i], ref, rtol=1e-9, atol=1e-10)
    with pytest.raises(ValueError):
        solve_shifted_systems(B, b, [-0.1, 0.2])


def test_jit_composable(rng):
    """solve_shifted_system accepts traced σ and a traced operator pytree —
    a trust-region loop can run on device end-to-end."""
    import jax
    import jax.numpy as jnp

    B, _, b, sigma, x_true = setup_test_val(rng, n=50, mem=5)

    @jax.jit
    def tr_step(op, rhs, sig):
        # data-dependent σ, as a trust-region loop would produce
        sig_eff = sig + 0.0 * jnp.sum(rhs)
        return solve_shifted_system(op, rhs, sig_eff)

    x_sol = np.asarray(tr_step(B, jnp.asarray(b), sigma))
    np.testing.assert_allclose(x_sol, x_true, atol=1e-6, rtol=1e-6)

    # second call with a different σ is a cache hit (no recompile)
    sizes0 = tr_step._cache_size()
    tr_step(B, jnp.asarray(b), sigma * 2)
    assert tr_step._cache_size() == sizes0

    # batched form under jit too
    from linops_tpu.qn.shifted_solve import solve_shifted_systems

    sols = jax.jit(lambda op, rhs, sigs: solve_shifted_systems(op, rhs, sigs))(
        B, jnp.asarray(b), jnp.asarray([sigma, 2 * sigma])
    )
    np.testing.assert_allclose(np.asarray(sols[0]), x_sol, atol=1e-8)
