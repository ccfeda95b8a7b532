"""Eye/Ones/Zeros/Diagonal/Restriction/Extension/slicing oracle tests —
reference contract from test/test_linop.jl (special operators sections,
Restriction/Extension :437-469)."""

import numpy as np
import pytest
import jax.numpy as jnp

import linops_tpu as lo
from helpers import simple_matrix, simple_vector, assert_close, RTOL

DTYPES = [np.float64, np.complex128]


def test_universal_eye():
    I = lo.opEye()
    v = jnp.arange(5.0)
    assert I @ v is v
    A = simple_matrix(np.float64, 3, 3)
    op = lo.LinearOperator(A)
    assert (I @ op) is op
    assert (op @ I) is op
    assert I.T is I and I.H is I


@pytest.mark.parametrize("dtype", DTYPES)
def test_sized_eye(dtype):
    op = lo.opEye(5, dtype=dtype)
    v = simple_vector(dtype, 5)
    assert_close(op @ v, v)
    assert op.symmetric and op.hermitian
    # rectangular: zero-fills the tail (reference: src/special-operators.jl:36-44)
    op2 = lo.opEye(6, 4, dtype=dtype)
    v4 = simple_vector(dtype, 4)
    expected = np.zeros(6, dtype)
    expected[:4] = np.asarray(v4)
    assert_close(op2 @ v4, expected)
    assert not op2.symmetric
    v6 = simple_vector(dtype, 6)
    assert_close(op2.T @ v6, np.asarray(v6)[:4])
    assert_close(lo.to_dense(op2), np.eye(6, 4))


@pytest.mark.parametrize("dtype", DTYPES)
def test_ones_zeros(dtype):
    ones = lo.opOnes(4, 3, dtype=dtype)
    v = simple_vector(dtype, 3)
    assert_close(ones @ v, np.full(4, np.asarray(v).sum()))
    u = simple_vector(dtype, 4)
    assert_close(ones.T @ u, np.full(3, np.asarray(u).sum()))
    zeros = lo.opZeros(4, 3, dtype=dtype)
    assert_close(zeros @ v, np.zeros(4))
    assert lo.opOnes(3, 3, dtype=dtype).symmetric
    assert not ones.symmetric


@pytest.mark.parametrize("dtype", DTYPES)
def test_diagonal_square(dtype, rng):
    d = np.asarray(simple_vector(dtype, 5)) * np.linspace(1, 2, 5)
    op = lo.opDiagonal(d)
    v = simple_vector(dtype, 5)
    assert_close(op @ v, d * np.asarray(v))
    assert_close(op.T @ v, d * np.asarray(v))
    assert_close(op.H @ v, d.conj() * np.asarray(v))
    assert op.symmetric
    assert op.hermitian == (dtype == np.float64)


def test_diagonal_rect():
    d = np.linspace(1.0, 2.0, 4)
    D = np.zeros((6, 4))
    np.fill_diagonal(D, d)
    op = lo.opDiagonal(6, 4, d)
    v = np.arange(1.0, 5.0)
    assert_close(op @ v, D @ v)
    u = np.arange(1.0, 7.0)
    assert_close(op.T @ u, D.T @ u)
    assert not op.symmetric
    # wide
    D2 = np.zeros((3, 5))
    np.fill_diagonal(D2, d[:3])
    op2 = lo.opDiagonal(3, 5, d)
    w = np.arange(1.0, 6.0)
    assert_close(op2 @ w, D2 @ w)
    # square rect-form truncates (reference: src/special-operators.jl:159)
    op3 = lo.opDiagonal(3, 3, d)
    assert op3.shape == (3, 3)
    assert op3.symmetric


def test_restriction_extension():
    idx = np.array([0, 2, 4])
    R = lo.opRestriction(idx, 6)
    v = np.arange(10.0, 16.0)
    assert_close(R @ v, v[idx])
    u = np.array([1.0, 2.0, 3.0])
    scattered = np.zeros(6)
    scattered[idx] = u
    assert_close(R.T @ u, scattered)
    E = lo.opExtension(idx, 6)
    assert_close(E @ u, scattered)
    assert_close(E.T @ v, v[idx])
    # int index alias
    Rk = lo.opRestriction(2, 6)
    assert Rk.shape == (1, 6)
    assert_close(Rk @ v, [v[2]])
    # bounds check
    with pytest.raises(lo.LinearOperatorException):
        lo.opRestriction(np.array([7]), 6)
    # colon
    assert lo.opRestriction(slice(None), 4).shape == (4, 4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_getindex_slicing(dtype, rng):
    A = simple_matrix(dtype, 6, 5, rng)
    op = lo.LinearOperator(A)
    sub = op[1:4, 0:3]
    assert isinstance(sub, lo.AbstractLinearOperator)
    assert sub.shape == (3, 3)
    assert_close(lo.to_dense(sub), A[1:4, 0:3], rtol=10 * RTOL)
    # integer and colon indexing still give operators
    row = op[2, :]
    assert row.shape == (1, 5)
    assert_close(lo.to_dense(row), A[2:3, :], rtol=10 * RTOL)
    col = op[:, 3]
    assert col.shape == (6, 1)
    assert_close(lo.to_dense(col), A[:, 3:4], rtol=10 * RTOL)
    fancy = op[np.array([0, 5]), np.array([1, 2, 4])]
    assert_close(lo.to_dense(fancy), A[np.ix_([0, 5], [1, 2, 4])], rtol=10 * RTOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_block_diagonal(dtype, rng):
    A = simple_matrix(dtype, 3, 3, rng)
    B = simple_matrix(dtype, 2, 4, rng)
    C = simple_matrix(dtype, 2, 2, rng, symmetric=True)
    op = lo.BlockDiagonalOperator(lo.LinearOperator(A), jnp.asarray(B), lo.LinearOperator(C))
    import scipy.linalg as sla

    D = sla.block_diag(A, B, C)
    assert op.shape == (7, 9)
    v = simple_vector(dtype, 9)
    assert_close(op @ v, D @ v, rtol=10 * RTOL)
    u = simple_vector(dtype, 7)
    assert_close(op.T @ u, D.T @ u, rtol=10 * RTOL)
    assert_close(op.H @ u, D.conj().T @ u, rtol=10 * RTOL)
    # flags AND over blocks
    S1 = lo.LinearOperator(simple_matrix(np.float64, 2, 2, rng, symmetric=True), symmetric=True, hermitian=True)
    S2 = lo.LinearOperator(simple_matrix(np.float64, 3, 3, rng, symmetric=True), symmetric=True, hermitian=True)
    assert lo.BlockDiagonalOperator(S1, S2).symmetric
    assert not op.symmetric


def test_restriction_extension_identities(rng):
    """P·Z = I on the index set; Z·P zeroes the complement
    (reference test/test_linop.jl:457-460)."""
    import jax.numpy as jnp
    n = 10
    v = rng.standard_normal(n)
    for idx in (np.array([0, 1, 3, 6]), np.arange(2, 6), np.arange(0, 7, 2)):
        P = lo.opRestriction(idx, n)
        Z = lo.opExtension(idx, n)
        w = v[idx]
        vz = np.zeros(n)
        vz[idx] = v[idx]
        np.testing.assert_allclose(np.asarray(P * v), w)
        np.testing.assert_allclose(np.asarray(P.H * w), vz)
        np.testing.assert_allclose(np.asarray(Z * w), vz)
        np.testing.assert_allclose(np.asarray(Z.H * v), w)
        np.testing.assert_allclose(np.asarray((P @ Z) * w), w)
        np.testing.assert_allclose(np.asarray((Z @ P) * v), vz)


def test_integer_operator(rng):
    """Integer-valued matrices wrap and pass the property checks
    (reference test/test_linop.jl:429-435)."""
    import jax.numpy as jnp
    A = np.round(rng.standard_normal((6, 6)) * 3).astype(np.int64)
    op = lo.LinearOperator(jnp.asarray(A))
    assert lo.check_ctranspose(op)
    assert lo.check_hermitian(op + op.H)
    assert lo.check_positive_definite(op @ op.H + 20 * lo.opEye(6))


def test_universal_eye_scalar_rejected():
    """2.0 * opEye() must not silently return the bare scalar (regression:
    A + sigma*opEye() computed A + sigma*ones)."""
    with pytest.raises(lo.LinearOperatorException):
        2.0 * lo.opEye()
    with pytest.raises(lo.LinearOperatorException):
        lo.opEye() * 2.0


def test_restriction_duplicate_indices_adjoint(rng):
    """Duplicate indices: gather's true adjoint is scatter-ADD, so the
    dot-test holds (regression: set-semantics broke <Rv,u> == <v,R'u>)."""
    import jax.numpy as jnp
    R = lo.opRestriction(np.array([1, 1, 2]), 4)
    v = rng.standard_normal(4)
    u = rng.standard_normal(3)
    lhs = np.dot(np.asarray(R * v), u)
    rhs = np.dot(v, np.asarray(R.H * u))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_timed_operator_pytree_roundtrip(rng):
    """TimedOperator survives tree_map (unflatten bypasses __init__)."""
    import jax, jax.numpy as jnp
    t = lo.TimedOperator(lo.opDiagonal(jnp.arange(1.0, 5.0)))
    t2 = jax.tree_util.tree_map(lambda x: x, t)
    v = jnp.ones(4)
    out = t2.matvec(v)
    np.testing.assert_allclose(np.asarray(out), np.arange(1.0, 5.0))
    assert "prod" in repr(t2)


def test_slicing_always_returns_operators(rng):
    """The reference's documented 'differences' semantics
    (docs/src/index.md): unlike matrices, slices NEVER reduce to a
    vector or a scalar — op[:, 1], op[i, :], and op[i, j] are all
    operators (a (1,1) operator for the scalar case)."""
    A = rng.standard_normal((5, 5))
    op = lo.LinearOperator(A)
    col = op[:, 1]
    assert isinstance(col, lo.AbstractLinearOperator) and col.shape == (5, 1)
    np.testing.assert_allclose(np.asarray(col @ jnp.asarray([3.0])),
                               A[:, 1] * 3.0, atol=1e-12)
    scalar = op[1, 1]
    assert isinstance(scalar, lo.AbstractLinearOperator)
    assert scalar.shape == (1, 1)
    np.testing.assert_allclose(
        float((scalar @ jnp.asarray([3.0]))[0]), A[1, 1] * 3.0, atol=1e-12)
    block = op[1:4, 0:2]
    assert block.shape == (3, 2)
    np.testing.assert_allclose(np.asarray(lo.to_dense(block)), A[1:4, 0:2],
                               atol=1e-12)


def test_permutation_operator(rng):
    """Permutation operator: P x = x[perm], P^T = P^-1,
    matrix RHS, and algebra participation (RCM-conjugation pattern)."""
    import numpy as np
    n = 700
    perm = rng.permutation(n)
    P = lo.opPermutation(perm)
    x = rng.standard_normal(n)
    np.testing.assert_allclose(np.asarray(P * x), x[perm], rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(P.T * (P * x)), x, atol=1e-12)
    np.testing.assert_allclose(np.asarray(P.H * x),
                               np.asarray(P.T * x), atol=0)
    M = rng.standard_normal((n, 3))
    np.testing.assert_allclose(np.asarray(P.matmat(M)), M[perm], atol=0)
    # conjugation: P A P^T applied == dense conjugation
    A = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.02)
    opA = lo.LinearOperator(A)
    chain = P @ opA @ P.T
    ref = A[perm][:, perm] @ x
    np.testing.assert_allclose(np.asarray(chain * x), ref, rtol=1e-10)
    with pytest.raises(lo.LinearOperatorException):
        lo.opPermutation(np.zeros(5, int))


def test_permutation_conj_matmat_matches_vector_path(rng):
    """Regression: mode 'C' (conjugate, NO transpose) of a real permutation
    must act like 'N' on matrix RHS too."""
    import numpy as np
    n = 256
    perm = rng.permutation(n)
    P = lo.opPermutation(perm)
    M = rng.standard_normal((n, 3))
    got = np.asarray(P.matmat(M, mode="C"))
    np.testing.assert_allclose(got, M[perm], atol=0)
    np.testing.assert_allclose(np.asarray(P.matmat(M[perm], mode="T")), M,
                               atol=0)


def test_permutation_large(rng):
    """Sizes beyond one 2^21 routing domain work (the apply is a gather)."""
    import numpy as np
    n = (1 << 21) + 3
    perm = rng.permutation(n)
    P = lo.opPermutation(perm)
    x = np.arange(n, dtype=np.float64)
    np.testing.assert_array_equal(np.asarray(P * x), x[perm])
    np.testing.assert_array_equal(np.asarray(P.T * x[perm]), x)
