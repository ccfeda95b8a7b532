"""MINRES / BiCGSTAB / LSQR driver tests (all on device, one jit each).

The reference leaves iterative solvers to its JSO clients (Krylov.jl); on
an accelerator the per-apply dispatch cost makes host loops non-viable, so
these live
in-package (SURVEY.md §6, utils/krylov.py module docstring). Oracles are
dense numpy solves / lstsq.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import linops_tpu as lo


def _relres(A, x, b):
    return np.linalg.norm(A @ np.asarray(x) - np.asarray(b)) / np.linalg.norm(b)


# ---------------------------------------------------------------- MINRES

def test_minres_spd(rng):
    n = 40
    M = rng.standard_normal((n, n))
    A = M @ M.T + n * np.eye(n)
    op = lo.LinearOperator(jnp.asarray(A), symmetric=True, hermitian=True)
    b = jnp.asarray(rng.standard_normal(n))
    x, k, phibar = lo.minres(op, b, tol=1e-12, maxiter=4 * n)
    assert _relres(A, x, b) < 1e-8
    assert int(k) <= n + 5


def test_minres_indefinite(rng):
    """The case CG cannot handle: symmetric with mixed-sign spectrum."""
    n = 50
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([rng.random(n // 2) + 1.0, -(rng.random(n - n // 2) + 1.0)])
    A = (Q * lam) @ Q.T
    op = lo.LinearOperator(jnp.asarray(A), symmetric=True, hermitian=True)
    b = jnp.asarray(rng.standard_normal(n))
    x, k, _ = lo.minres(op, b, tol=1e-12, maxiter=6 * n)
    assert _relres(A, x, b) < 1e-7


def test_minres_preconditioned(rng):
    n = 60
    d = rng.random(n) * 100.0 + 1.0
    A = np.diag(d) + rng.standard_normal((n, n)) * 0.01
    A = (A + A.T) / 2
    op = lo.LinearOperator(jnp.asarray(A), symmetric=True, hermitian=True)
    Mi = lo.opDiagonal(1.0 / jnp.asarray(d))  # SPD Jacobi preconditioner
    b = jnp.asarray(rng.standard_normal(n))
    x0, k0, _ = lo.minres(op, b, tol=1e-10, maxiter=8 * n)
    x1, k1, _ = lo.minres(op, b, tol=1e-10, maxiter=8 * n, M=Mi)
    assert _relres(A, x0, b) < 1e-7
    assert _relres(A, x1, b) < 1e-7
    assert int(k1) <= int(k0)  # preconditioning must not be worse here


def test_minres_hermitian_complex(rng):
    n = 24
    M = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A = M @ M.conj().T + n * np.eye(n)
    op = lo.LinearOperator(jnp.asarray(A), symmetric=False, hermitian=True)
    b = jnp.asarray(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x, k, _ = lo.minres(op, b, tol=1e-12, maxiter=6 * n)
    assert _relres(A, x, b) < 1e-8


def test_minres_on_lsr1_model(rng):
    """MINRES over a (possibly indefinite) L-SR1 model operator — the
    trust-region pairing this solver exists for."""
    n = 30
    B = lo.LSR1Operator(n, mem=5, dtype=jnp.float64)
    for _ in range(6):
        s = jnp.asarray(rng.standard_normal(n))
        y = jnp.asarray(rng.standard_normal(n))
        B.push(s, y)
    A = np.asarray(B.to_dense())
    b = jnp.asarray(rng.standard_normal(n))
    x, k, _ = lo.minres(B, b, tol=1e-11, maxiter=8 * n)
    assert _relres(A, x, b) < 1e-6


# -------------------------------------------------------------- BiCGSTAB

def test_bicgstab_nonsymmetric(rng):
    n = 40
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    op = lo.LinearOperator(jnp.asarray(A))
    b = jnp.asarray(rng.standard_normal(n))
    x, k, res = lo.bicgstab(op, b, tol=1e-12, maxiter=4 * n)
    assert _relres(A, x, b) < 1e-8


def test_bicgstab_preconditioned(rng):
    n = 60
    d = rng.random(n) + 1.0
    A = rng.standard_normal((n, n)) * 0.05 + np.diag(d)
    op = lo.LinearOperator(jnp.asarray(A))
    Mi = lo.opDiagonal(1.0 / jnp.asarray(d))
    b = jnp.asarray(rng.standard_normal(n))
    x, k, _ = lo.bicgstab(op, b, tol=1e-11, maxiter=4 * n, M=Mi)
    assert _relres(A, x, b) < 1e-8


def test_bicgstab_complex(rng):
    n = 20
    A = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
         + n * np.eye(n))
    op = lo.LinearOperator(jnp.asarray(A))
    b = jnp.asarray(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x, k, _ = lo.bicgstab(op, b, tol=1e-12, maxiter=4 * n)
    assert _relres(A, x, b) < 1e-8


def test_bicgstab_matches_gmres(rng):
    n = 32
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    op = lo.LinearOperator(jnp.asarray(A))
    b = jnp.asarray(rng.standard_normal(n))
    xb, *_ = lo.bicgstab(op, b, tol=1e-12, maxiter=4 * n)
    xg, *_ = lo.gmres(op, b, tol=1e-12, restart=n, maxiter=4)
    np.testing.assert_allclose(np.asarray(xb), np.asarray(xg), atol=1e-6)


# ------------------------------------------------------------------ LSQR

def test_lsqr_overdetermined(rng):
    m, n = 80, 30
    A = rng.standard_normal((m, n))
    op = lo.LinearOperator(jnp.asarray(A))
    b = jnp.asarray(rng.standard_normal(m))
    x, k, arnorm = lo.lsqr(op, b, tol=1e-12, maxiter=6 * n)
    x_ref = np.linalg.lstsq(A, np.asarray(b), rcond=None)[0]
    np.testing.assert_allclose(np.asarray(x), x_ref, atol=1e-7)


def test_lsqr_underdetermined_consistent(rng):
    """Underdetermined consistent system: LSQR converges to the min-norm
    solution (the lstsq oracle's answer)."""
    m, n = 20, 50
    A = rng.standard_normal((m, n))
    op = lo.LinearOperator(jnp.asarray(A))
    b = jnp.asarray(A @ rng.standard_normal(n))
    x, k, _ = lo.lsqr(op, b, tol=1e-13, maxiter=8 * m)
    x_ref = np.linalg.lstsq(A, np.asarray(b), rcond=None)[0]
    np.testing.assert_allclose(np.asarray(x), x_ref, atol=1e-7)


def test_lsqr_damped(rng):
    """damp > 0 solves the Tikhonov system (AᵀA + damp²I) x = Aᵀ b."""
    m, n, damp = 60, 25, 0.7
    A = rng.standard_normal((m, n))
    op = lo.LinearOperator(jnp.asarray(A))
    b = jnp.asarray(rng.standard_normal(m))
    x, k, _ = lo.lsqr(op, b, damp=damp, tol=1e-13, maxiter=10 * n)
    x_ref = np.linalg.solve(A.T @ A + damp**2 * np.eye(n), A.T @ np.asarray(b))
    np.testing.assert_allclose(np.asarray(x), x_ref, atol=1e-7)


def test_lsqr_complex(rng):
    m, n = 40, 15
    A = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    op = lo.LinearOperator(jnp.asarray(A))
    b = jnp.asarray(rng.standard_normal(m) + 1j * rng.standard_normal(m))
    x, k, _ = lo.lsqr(op, b, tol=1e-13, maxiter=8 * n)
    x_ref = np.linalg.lstsq(A, np.asarray(b), rcond=None)[0]
    np.testing.assert_allclose(np.asarray(x), x_ref, atol=1e-6)


def test_lsqr_on_restriction_product(rng):
    """Rectangular composite graph (R @ A): the class of operator the
    reference builds with opRestriction products (src/special-operators.jl)."""
    n, m = 48, 20
    A = rng.standard_normal((n, n))
    rows = np.sort(rng.choice(n, size=m, replace=False))
    op = lo.opRestriction(jnp.asarray(rows), n) @ lo.LinearOperator(jnp.asarray(A))
    b = jnp.asarray(rng.standard_normal(m))
    x, k, _ = lo.lsqr(op, b, tol=1e-12, maxiter=10 * n)
    x_ref = np.linalg.lstsq(A[rows, :], np.asarray(b), rcond=None)[0]
    np.testing.assert_allclose(np.asarray(x), x_ref, atol=1e-6)


def test_solvers_zero_rhs(rng):
    """b = 0 must return x = 0 without NaNs (guarded normalizations)."""
    n = 16
    M = rng.standard_normal((n, n))
    A = M @ M.T + n * np.eye(n)
    op = lo.LinearOperator(jnp.asarray(A), symmetric=True, hermitian=True)
    b = jnp.zeros((n,))
    for solver in (lo.minres, lo.bicgstab, lo.lsqr):
        x, k, _ = solver(op, b, maxiter=10)
        assert np.all(np.isfinite(np.asarray(x)))
        np.testing.assert_allclose(np.asarray(x), 0.0, atol=1e-12)
        assert int(k) == 0

def test_bicgstab_breakdown_no_nan(rng):
    """Skew-symmetric A makes r̂·v = 0 at step 1 (classic BiCG breakdown):
    the driver must stop with the last finite iterate and its TRUE residual
    — never NaN-poisoned x with a small-k 'converged' look."""
    A = np.array([[0.0, 1.0], [-1.0, 0.0]])
    b = jnp.asarray([1.0, 0.0])
    x, k, res = lo.bicgstab(lo.LinearOperator(jnp.asarray(A)), b,
                            tol=1e-10, maxiter=50)
    assert np.all(np.isfinite(np.asarray(x)))
    assert np.isfinite(float(res))
    # non-convergence is visible: res > tol*||b||
    assert float(res) > 1e-10


def test_solvers_mixed_precision_preconditioner(rng):
    """An f64 preconditioner with an f32 operator must not break the
    while_loop carry dtype (prec output is cast to the solver dtype)."""
    n = 24
    M = rng.standard_normal((n, n))
    A = (M @ M.T + n * np.eye(n)).astype(np.float32)
    op = lo.LinearOperator(jnp.asarray(A), symmetric=True, hermitian=True)
    b = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    Mpre = lo.opDiagonal(jnp.asarray(1.0 / np.diag(A), dtype=jnp.float64))
    for solver in (lo.cg, lo.minres, lo.bicgstab):
        x, k, res = solver(op, b, tol=1e-5, maxiter=5 * n, M=Mpre)
        assert x.dtype == jnp.float32
        assert _relres(A, x, b) < 1e-4
    x, k, res = lo.gmres(op, b, tol=1e-5, maxiter=3 * n, M=Mpre)
    assert x.dtype == jnp.float32
    assert _relres(A, x, b) < 1e-4


def test_cg_multi_rhs(rng):
    """2-D b solves all k systems in one loop over apply_matrix; each
    column matches the dense solve."""
    n, k = 48, 5
    Mx = rng.standard_normal((n, n))
    A = Mx @ Mx.T + n * np.eye(n)
    op = lo.LinearOperator(jnp.asarray(A), symmetric=True, hermitian=True)
    B = rng.standard_normal((n, k))
    X, it, res = lo.cg(op, jnp.asarray(B), tol=1e-12, maxiter=4 * n)
    assert res.shape == (k,)
    np.testing.assert_allclose(np.asarray(X), np.linalg.solve(A, B),
                               rtol=1e-7, atol=1e-8)


def test_cg_multi_rhs_preconditioned_and_freeze(rng):
    """Mixed convergence speeds: an already-solved column (b = A e_0
    scaled tiny) must freeze without poisoning the others; Jacobi
    preconditioning works columnwise."""
    n, k = 40, 3
    Mx = rng.standard_normal((n, n))
    A = Mx @ Mx.T + np.diag(np.linspace(1, 100, n))
    op = lo.LinearOperator(jnp.asarray(A), symmetric=True, hermitian=True)
    B = rng.standard_normal((n, k))
    B[:, 0] = 0.0  # zero column converges at iteration 0
    Mpre = lo.opDiagonal(jnp.asarray(1.0 / np.diag(A)))
    X, it, res = lo.cg(op, jnp.asarray(B), tol=1e-10, maxiter=6 * n, M=Mpre)
    assert np.all(np.isfinite(np.asarray(X)))
    np.testing.assert_allclose(np.asarray(X[:, 0]), 0.0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(X[:, 1:]),
                               np.linalg.solve(A, B[:, 1:]),
                               rtol=1e-6, atol=1e-7)


def test_minres_multi_rhs(rng):
    """2-D b: k independent indefinite systems in one compiled loop;
    columns match single-RHS solves and converged columns freeze."""
    n, k = 60, 5
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([np.linspace(-8, -1, n // 2),
                          np.linspace(1, 8, n - n // 2)])
    A = (Q * lam) @ Q.T
    op = lo.LinearOperator(A, symmetric=True, hermitian=True)
    B = jnp.asarray(rng.standard_normal((n, k)))
    X, it, phibar = lo.minres(op, B, tol=1e-10, maxiter=300)
    res = np.linalg.norm(A @ np.asarray(X) - np.asarray(B), axis=0)
    assert np.all(res < 1e-7)
    assert phibar.shape == (k,)
    for j in range(k):
        xj, _, _ = lo.minres(op, B[:, j], tol=1e-10, maxiter=300)
        assert np.linalg.norm(np.asarray(xj) - np.asarray(X[:, j])) < 1e-6


def test_chebyshev_converges_at_the_rate(rng):
    """Fixed-iteration Chebyshev with exact spectral bounds tracks the
    (sqrt(kappa)-1)/(sqrt(kappa)+1) rate; the loop body has NO inner
    products (communication-avoiding — see test_halo2d collective test)."""
    n = 200
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lmin, lmax = 1.0, 50.0
    lam = np.linspace(lmin, lmax, n)
    A = (Q * lam) @ Q.T
    op = lo.LinearOperator(A, symmetric=True, hermitian=True)
    b = jnp.asarray(rng.standard_normal(n))
    x_true = np.linalg.solve(A, np.asarray(b))
    kappa = lmax / lmin
    rate = (np.sqrt(kappa) - 1) / (np.sqrt(kappa) + 1)
    for iters in (20, 60):
        x, it, res = lo.chebyshev(op, b, lmin, lmax, iters=iters)
        err = np.linalg.norm(np.asarray(x) - x_true) / np.linalg.norm(x_true)
        # the classical first-step special case makes the iterate the
        # OPTIMAL Chebyshev polynomial: error sits under the bound itself
        assert err < 2 * 2 * rate ** iters, (iters, err)
    # iters=0 returns x0 unchanged (cg maxiter=0 parity)
    x0out, k0, _ = lo.chebyshev(op, b, lmin, lmax, iters=0)
    assert int(k0) == 0 and float(jnp.linalg.norm(x0out)) == 0.0
    # Jacobi-preconditioned variant (bounds bracket lam(M A))
    M = lo.opDiagonal(1.0 / jnp.asarray(np.diag(A)))
    MA = np.diag(1.0 / np.diag(A)) @ A
    ev = np.sort(np.real(np.linalg.eigvals(MA)))
    xp, _, resp = lo.chebyshev(op, b, float(ev[0]), float(ev[-1]), iters=60, M=M)
    errp = np.linalg.norm(np.asarray(xp) - x_true) / np.linalg.norm(x_true)
    assert errp < 1e-4
