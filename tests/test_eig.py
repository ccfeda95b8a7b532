"""LOBPCG block eigensolver (capability upgrade; the reference delegates
eigenvalue work to Arpack/KrylovKit clients)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import linops_tpu as lo
from helpers import simple_matrix

KEY = jax.random.PRNGKey(11)


def _spd(n, rng, lo_ev=1.0, hi_ev=100.0):
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.linspace(lo_ev, hi_ev, n)
    return (Q * lam) @ Q.T, lam


def test_lobpcg_smallest_matches_dense(rng):
    A, lam = _spd(120, rng)
    op = lo.LinearOperator(A, symmetric=True, hermitian=True)
    th, X, res, it = lo.lobpcg(op, k=3, tol=1e-9, maxiter=400, key=KEY)
    np.testing.assert_allclose(np.asarray(th), lam[:3], rtol=1e-7)
    assert it < 400
    # eigenvectors: A x ~= theta x
    for j in range(3):
        v = np.asarray(X)[:, j]
        assert np.linalg.norm(A @ v - lam[j] * v) < 1e-6
    # block is orthonormal
    G = np.asarray(X).T @ np.asarray(X)
    np.testing.assert_allclose(G, np.eye(3), atol=1e-8)


def test_lobpcg_largest(rng):
    A, lam = _spd(100, rng)
    op = lo.LinearOperator(A, symmetric=True, hermitian=True)
    th, X, res, it = lo.lobpcg(op, k=2, largest=True, tol=1e-9, maxiter=400, key=KEY)
    np.testing.assert_allclose(np.asarray(th), lam[-2:][::-1], rtol=1e-7)


def test_lobpcg_preconditioner_accelerates(rng):
    n = 150
    A, _ = _spd(n, rng)
    D = np.abs(rng.standard_normal(n)) + 0.5
    Ad = np.diag(D) + 0.01 * A
    op = lo.LinearOperator(Ad, symmetric=True, hermitian=True)
    M = lo.opDiagonal(jnp.asarray(1.0 / np.diag(Ad)))
    th_m, _, _, it_m = lo.lobpcg(op, k=2, tol=1e-8, maxiter=500, M=M, key=KEY)
    th_n, _, _, it_n = lo.lobpcg(op, k=2, tol=1e-8, maxiter=500, key=KEY)
    wtrue = np.sort(np.linalg.eigvalsh(Ad))[:2]
    np.testing.assert_allclose(np.asarray(th_m), wtrue, rtol=1e-6)
    assert it_m < it_n  # Jacobi preconditioning must help on this matrix


def test_lobpcg_complex_hermitian(rng):
    n = 60
    B = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = B + B.conj().T
    op = lo.LinearOperator(H, hermitian=True)
    th, X, res, it = lo.lobpcg(op, k=2, tol=1e-8, maxiter=400, key=KEY)
    np.testing.assert_allclose(np.asarray(th), np.sort(np.linalg.eigvalsh(H))[:2],
                               rtol=1e-6)


def test_lobpcg_on_stencil_operator():
    # 2-D Dirichlet Laplacian: lambda_ij = 4 - 2cos(i pi h) - 2cos(j pi h)
    ng = 24
    L = lo.laplacian_2d(ng, ng, dtype=jnp.float64)
    th, X, res, it = lo.lobpcg(L, k=2, largest=True, tol=1e-7, maxiter=600, key=KEY)
    h = np.pi / (ng + 1)
    lam = np.sort(
        [4 - 2 * np.cos(i * h) - 2 * np.cos(j * h)
         for i in range(1, ng + 1) for j in range(1, ng + 1)]
    )
    np.testing.assert_allclose(np.asarray(th), lam[-2:][::-1], rtol=1e-5)


def test_lobpcg_k1_and_explicit_x0(rng):
    A, lam = _spd(80, rng)
    op = lo.LinearOperator(A, symmetric=True, hermitian=True)
    X0 = rng.standard_normal((80, 1))
    th, X, res, it = lo.lobpcg(op, k=1, X0=X0, tol=1e-9, maxiter=400)
    assert abs(float(th[0]) - lam[0]) < 1e-6


def test_lobpcg_validation(rng):
    A = simple_matrix(np.float64, 10, 7, rng)
    with pytest.raises(lo.LinearOperatorException):
        lo.lobpcg(lo.LinearOperator(A))
    S = simple_matrix(np.float64, 10, 10, rng)
    with pytest.raises(lo.LinearOperatorException):
        lo.lobpcg(lo.LinearOperator(S))  # hermitian flag not set
    op = lo.LinearOperator(S + S.T, symmetric=True, hermitian=True)
    with pytest.raises(ValueError):
        lo.lobpcg(op, k=9)  # 3k basis would exceed n
    with pytest.raises(lo.LinearOperatorException):
        lo.lobpcg(op, k=2, X0=np.ones((10, 3)))


def test_lobpcg_no_recompile_across_calls(rng):
    from linops_tpu.utils.eig import _lobpcg_jit

    A, _ = _spd(40, rng)
    op = lo.LinearOperator(A, symmetric=True, hermitian=True)
    lo.lobpcg(op, k=2, tol=1e-6, maxiter=50, key=KEY)
    c0 = _lobpcg_jit._cache_size()
    for s in range(3):
        lo.lobpcg(op, k=2, tol=1e-6, maxiter=50, key=jax.random.PRNGKey(s))
    assert _lobpcg_jit._cache_size() == c0


# ---------------------------------------------------------------------------
# svds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(120, 60), (60, 120)])
def test_svds_largest_matches_dense(rng, shape):
    m, n = shape
    A = rng.standard_normal((m, n))
    op = lo.LinearOperator(A)
    U, s, V, res, it = lo.svds(op, k=3, tol=1e-10, maxiter=400, key=KEY)
    s_true = np.linalg.svd(A, compute_uv=False)[:3]
    np.testing.assert_allclose(np.asarray(s), s_true, rtol=1e-8)
    # triplet identity A v = s u holds column-wise
    err = np.linalg.norm(A @ np.asarray(V) - np.asarray(U) * np.asarray(s), axis=0)
    assert np.all(err < 1e-6)
    assert U.shape == (m, 3) and V.shape == (n, 3)


def test_svds_smallest(rng):
    A = rng.standard_normal((50, 40))
    U, s, V, res, it = lo.svds(lo.LinearOperator(A), k=2, largest=False,
                               tol=1e-10, maxiter=2000, key=KEY)
    s_true = np.linalg.svd(A, compute_uv=False)[-2:][::-1]
    np.testing.assert_allclose(np.asarray(s), s_true, rtol=1e-6)


def test_svds_complex(rng):
    C = rng.standard_normal((40, 30)) + 1j * rng.standard_normal((40, 30))
    U, s, V, res, it = lo.svds(lo.LinearOperator(C), k=2, tol=1e-9,
                               maxiter=500, key=KEY)
    np.testing.assert_allclose(np.asarray(s),
                               np.linalg.svd(C, compute_uv=False)[:2], rtol=1e-7)
    err = np.linalg.norm(C @ np.asarray(V) - np.asarray(U) * np.asarray(s), axis=0)
    assert np.all(err < 1e-6)


def test_gram_operator_is_valid_hermitian_node(rng):
    # the internal Gram node is a first-class operator: flags, to_dense,
    # adjoint-consistency all hold
    from linops_tpu.utils.eig import _GramOperator

    A = rng.standard_normal((12, 8))
    g = _GramOperator(lo.LinearOperator(A), "right")
    assert g.hermitian and g.shape == (8, 8)
    np.testing.assert_allclose(np.asarray(lo.to_dense(g)), A.T @ A, atol=1e-12)
    assert lo.check_hermitian(g)
    gl = _GramOperator(lo.LinearOperator(A), "left")
    np.testing.assert_allclose(np.asarray(lo.to_dense(gl)), A @ A.T, atol=1e-12)


def test_lobpcg_rejects_rank_deficient_x0(rng):
    # review finding: a duplicated start column used to seed X with a zero
    # direction reported as a spurious converged zero eigenvalue
    A, _ = _spd(60, rng)
    op = lo.LinearOperator(A, symmetric=True, hermitian=True)
    x = rng.standard_normal((60, 1))
    y = rng.standard_normal((60, 1))
    with pytest.raises(lo.LinearOperatorException):
        lo.lobpcg(op, k=3, X0=np.concatenate([x, x, y], axis=1))


def test_lobpcg_rejects_mismatched_preconditioner(rng):
    A, _ = _spd(40, rng)
    op = lo.LinearOperator(A, symmetric=True, hermitian=True)
    with pytest.raises(lo.LinearOperatorException):
        lo.lobpcg(op, k=2, M=lo.opDiagonal(jnp.ones(10)))


def test_lobpcg_tight_tolerance_reachable(rng):
    # the carried A-images (single k-wide apply per iteration) must not
    # drift: 1e-12 relative residuals stay reachable
    A, lam = _spd(150, rng)
    op = lo.LinearOperator(A, symmetric=True, hermitian=True)
    th, X, res, it = lo.lobpcg(op, k=3, tol=1e-12, maxiter=3000, key=KEY)
    assert it < 3000
    np.testing.assert_allclose(np.asarray(th), lam[:3], rtol=1e-10)


def test_lobpcg_f32_stays_finite_and_residuals_honest():
    """Review finding: carried A-images diverged to NaN in f32 after a few hundred iterations, and the reported
    residuals under-stated the true ||A x - theta x|| 10x. The fresh-apply
    formulation must stay finite and report residuals consistent with a
    fresh operator apply."""
    ng = 48
    L = lo.laplacian_2d(ng, ng, dtype=jnp.float32) + lo.opDiagonal(
        0.1 * jnp.ones(ng * ng, jnp.float32))
    th, X, res, it = lo.lobpcg(L, k=4, tol=1e-6, maxiter=2000, key=KEY)
    th = np.asarray(th, np.float64)
    assert np.all(np.isfinite(th)) and np.all(np.isfinite(np.asarray(X)))
    # true fresh-apply residual agrees with the reported one (same scale)
    AX = np.asarray(L.apply_matrix(X, "N"), np.float64)
    true_res = np.linalg.norm(AX - np.asarray(X, np.float64) * th, axis=0)
    rep = np.asarray(res, np.float64)
    assert np.all(true_res <= 10 * np.maximum(rep, 1e-7) + 1e-6)
    # and the eigenvalues are inside the known spectrum [0.1, 8.1]
    assert np.all(th > 0.05) and np.all(th < 8.2)


def test_lobpcg_constraints_next_k_and_nullspace(rng):
    # deflation: compute 3 smallest, then the NEXT 3 constrained to the
    # orthogonal complement — matches the dense spectrum exactly
    A, lam = _spd(150, rng)
    op = lo.LinearOperator(A, symmetric=True, hermitian=True)
    th1, X1, _, _ = lo.lobpcg(op, k=3, tol=1e-10, maxiter=600, key=KEY)
    th2, X2, _, _ = lo.lobpcg(op, k=3, tol=1e-9, maxiter=600, Y=X1, key=KEY)
    np.testing.assert_allclose(np.asarray(th2), lam[3:6], rtol=1e-6)
    assert float(np.max(np.abs(np.asarray(X1).T @ np.asarray(X2)))) < 1e-10

    # nullspace exclusion (Neumann-Laplacian pattern): project A onto the
    # complement of a known null vector; Y= that vector finds the first
    # NONZERO modes instead of the null mode
    n = 150
    e = np.ones((n, 1)) / np.sqrt(n)
    An = A - (A @ e) @ e.T - e @ (e.T @ A) + e @ (e.T @ A @ e) @ e.T
    An = (An + An.T) / 2
    opn = lo.LinearOperator(An, symmetric=True, hermitian=True)
    th3, _, _, _ = lo.lobpcg(opn, k=2, tol=1e-8, maxiter=600, Y=e, key=KEY)
    wtrue = np.sort(np.linalg.eigvalsh(An))
    np.testing.assert_allclose(np.asarray(th3), wtrue[1:3], rtol=1e-5)

    # validation: wrong length, rank-deficient, too wide
    with pytest.raises(lo.LinearOperatorException):
        lo.lobpcg(op, k=2, Y=np.ones((10, 1)))
    with pytest.raises(lo.LinearOperatorException):
        lo.lobpcg(op, k=2, Y=np.concatenate([e, e], axis=1))
    with pytest.raises(ValueError):
        lo.lobpcg(op, k=2, Y=rng.standard_normal((150, 148)))


# ---------------------------------------------------------------------------
# rsvd + Nystrom preconditioner
# ---------------------------------------------------------------------------


def test_rsvd_near_optimal_and_exact_on_low_rank(rng):
    m, n = 120, 80
    U0 = np.linalg.qr(rng.standard_normal((m, 30)))[0]
    V0 = np.linalg.qr(rng.standard_normal((n, 30)))[0]
    s0 = 3.0 ** -np.arange(30)
    A = (U0 * s0) @ V0.T
    op = lo.LinearOperator(A)
    U, s, V = lo.rsvd(op, 8, key=KEY)
    np.testing.assert_allclose(np.asarray(s), s0[:8], rtol=1e-6)
    approx = np.asarray(U) * np.asarray(s) @ np.asarray(V).T
    best = (U0[:, :8] * s0[:8]) @ V0[:, :8].T
    assert np.linalg.norm(A - approx) < 3 * np.linalg.norm(A - best) + 1e-10
    # exact once k covers the true rank
    U, s, V = lo.rsvd(op, 30, key=KEY)
    assert np.linalg.norm(A - np.asarray(U) * np.asarray(s) @ np.asarray(V).T) < 1e-10
    with pytest.raises(ValueError):
        lo.rsvd(op, 0)


def test_nystrom_preconditioner_accelerates_cg(rng):
    n = 300
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    lam = np.concatenate([100.0 * 2.0 ** -np.arange(20), 1e-2 * np.ones(n - 20)])
    A = (Q * lam) @ Q.T
    op = lo.LinearOperator(A, symmetric=True, hermitian=True)
    P = lo.nystrom_preconditioner(op, rank=25, key=KEY)
    assert P.hermitian and P.shape == (n, n)
    b = jnp.asarray(rng.standard_normal(n))
    x0, it0, _ = lo.cg(op, b, tol=1e-10, maxiter=500)
    x1, it1, _ = lo.cg(op, b, tol=1e-10, maxiter=500, M=P)
    # the sketch captures the 20 dominant modes: strict iteration win
    assert int(it1) < 0.7 * int(it0)
    assert float(jnp.linalg.norm(x1 - x0) / jnp.linalg.norm(x0)) < 1e-7
    # P^{-1} is a faithful hermitian operator node
    assert lo.check_hermitian(P)
    with pytest.raises(lo.LinearOperatorException):
        lo.nystrom_preconditioner(lo.LinearOperator(A), rank=5)  # no flag
    with pytest.raises(ValueError):
        lo.nystrom_preconditioner(op, rank=5, mu=-1.0)


def test_nystrom_rank_truncates_to_numerical_rank(rng):
    # review finding: rank > numerical rank with mu=0 divided 0/0 -> NaN
    n, r = 60, 5
    U0 = np.linalg.qr(rng.standard_normal((n, r)))[0]
    A = (U0 * np.linspace(5, 1, r)) @ U0.T  # exactly rank 5, PSD
    op = lo.LinearOperator(A, symmetric=True, hermitian=True)
    P = lo.nystrom_preconditioner(op, rank=20, key=KEY)
    assert P.lam.shape[0] <= r + 1
    v = rng.standard_normal(n)
    out = np.asarray(P @ jnp.asarray(v))
    assert np.all(np.isfinite(out))


def test_lobpcg_accepts_large_n_f32_warm_start(rng):
    # review finding: an n-linear rank threshold exceeded 1.0 for f32 at
    # n ~ 84k and rejected every (even exactly orthonormal) warm start
    n = 90_000
    op = lo.opDiagonal(jnp.ones((n,), jnp.float32))
    X0 = np.zeros((n, 2), np.float32)
    X0[0, 0] = 1.0
    X0[1, 1] = 1.0
    th, X, res, it = lo.lobpcg(op, k=2, X0=X0, tol=1e-3, maxiter=2)
    assert np.all(np.isfinite(np.asarray(th)))


def test_lobpcg_gram_vs_direct_parity(rng):
    """The coefficient-space (gram) basis maintenance must find the same
    eigenpairs as the big-array (direct) body, at comparable iteration
    counts, on a spread spectrum with clusters."""
    n = 400
    d = np.concatenate([np.array([1.0, 1.0 + 1e-4, 1.2]),
                        np.linspace(2.0, 100.0, n - 3)])
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = (Q * d) @ Q.T
    op = lo.LinearOperator(jnp.asarray(A), hermitian=True)
    out = {}
    for basis in ("gram", "direct"):
        th, X, res, it = lo.lobpcg(op, k=3, tol=1e-9, maxiter=600, key=KEY,
                                   basis=basis)
        np.testing.assert_allclose(np.asarray(th), d[:3], rtol=1e-7)
        out[basis] = it
    # no pathological convergence degradation from the gram path
    assert out["gram"] <= 3 * out["direct"] + 20, out
