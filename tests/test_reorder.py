"""opSparse(reorder="rcm"): RCM similarity sandwich Pᵀ·A_r·P.

A scrambled banded matrix must come back to a banded (BSR-able) inner
operator, and every mode/protocol of the sandwich must agree with the
scipy dense oracle (sparse/reorder.py).
"""
import numpy as np
import pytest

scipy_sparse = pytest.importorskip("scipy.sparse")

import jax.numpy as jnp

import linops_tpu as lo
from linops_tpu.sparse.reorder import ReorderedOperator


def _scrambled_banded(n, bw, seed, symmetric=False):
    rng = np.random.default_rng(seed)
    diags = [rng.standard_normal(n - abs(k)) for k in range(-bw, bw + 1)]
    A = scipy_sparse.diags(diags, range(-bw, bw + 1), format="csr")
    if symmetric:
        A = ((A + A.T) * 0.5).tocsr()
    sigma = rng.permutation(n)
    return A[sigma][:, sigma].tocsr(), A


def test_rcm_sandwich_all_modes():
    Asc, _ = _scrambled_banded(300, 4, seed=3)
    op = lo.opSparse(Asc, format="auto", reorder="rcm")
    assert isinstance(op, ReorderedOperator)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(300)
    Ad = Asc.toarray()
    np.testing.assert_allclose(np.asarray(op * v), Ad @ v, rtol=1e-11,
                               atol=1e-11)
    np.testing.assert_allclose(np.asarray(op.T * v), Ad.T @ v, rtol=1e-11,
                               atol=1e-11)
    np.testing.assert_allclose(np.asarray(op.H * v), Ad.T @ v, rtol=1e-11,
                               atol=1e-11)
    M = rng.standard_normal((300, 5))
    np.testing.assert_allclose(np.asarray(op.apply_matrix(M, "N")), Ad @ M,
                               rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(np.asarray(op.apply_matrix(M, "T")), Ad.T @ M,
                               rtol=1e-11, atol=1e-11)
    # row-panel protocol
    Mt = np.ascontiguousarray(M.T)
    np.testing.assert_allclose(np.asarray(op.apply_matrix_t(Mt, "N")),
                               (Ad @ M).T, rtol=1e-11, atol=1e-11)
    # dense oracle through the generic blockwise path
    np.testing.assert_allclose(np.asarray(lo.to_dense(op)), Ad, rtol=1e-11,
                               atol=1e-11)


def test_rcm_recovers_band_structure():
    # scrambled dense-banded f32: auto must pick BSR on the REORDERED
    # matrix (the scrambled pattern would land on CSR) — the whole point
    # of the reorder keyword: the band recovers the block path
    Asc, A = _scrambled_banded(4096, 56, seed=7)
    op = lo.opSparse(Asc, format="auto", reorder="rcm", dtype=np.float32)
    scrambled = lo.opSparse(Asc, format="auto", dtype=np.float32)
    assert type(scrambled) is lo.CSROperator
    inner = op.inner
    assert isinstance(inner, lo.BSROperator)
    # the inner block structure must be a narrow band: a width-113 band
    # fits in <=3 block-cols per block row (kmax), where the scrambled
    # pattern would need ~50 distinct block-cols (and not be BSR at all)
    d = inner.data
    assert d.block_cols.shape[1] <= 3
    # numerics survive the round trip (f32 storage)
    rng = np.random.default_rng(1)
    v = rng.standard_normal(4096).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op * v), Asc @ v, rtol=2e-4,
                               atol=2e-4 * np.abs(Asc @ v).max())


def test_rcm_symmetric_flags_and_cg():
    B = _scrambled_banded(200, 3, seed=11, symmetric=True)[0]
    S = (B @ B.T + 10 * scipy_sparse.eye(200)).tocsr()
    sigma = np.random.default_rng(2).permutation(200)
    Ssc = S[sigma][:, sigma].tocsr()
    op = lo.opSparse(Ssc, format="auto", reorder="rcm", symmetric=True,
                     hermitian=True)
    assert op.symmetric and op.hermitian
    b = np.random.default_rng(3).standard_normal(200)
    res = lo.cg(op, jnp.asarray(b), tol=1e-12, maxiter=400)
    x = res[0] if isinstance(res, tuple) else res
    np.testing.assert_allclose(Ssc @ np.asarray(x), b, atol=1e-7)


def test_rcm_rejects_rectangular_and_unknown():
    A = scipy_sparse.random(30, 20, density=0.2, format="csr", random_state=0)
    with pytest.raises(lo.LinearOperatorException):
        lo.opSparse(A, reorder="rcm")
    Asq = scipy_sparse.random(30, 30, density=0.2, format="csr", random_state=0)
    with pytest.raises(ValueError):
        lo.opSparse(Asq, reorder="amd")


def test_rcm_dense_input_and_tol():
    rng = np.random.default_rng(5)
    Ad = np.zeros((60, 60))
    for k in (-2, -1, 0, 1, 2):
        idx = np.arange(60 - abs(k))
        Ad[idx + max(0, -k), idx + max(0, k)] = rng.standard_normal(60 - abs(k))
    sigma = rng.permutation(60)
    Asc = Ad[sigma][:, sigma] + 1e-14  # noise below tol
    op = lo.opSparse(Asc, reorder="rcm", tol=1e-12)
    v = rng.standard_normal(60)
    np.testing.assert_allclose(np.asarray(op * v),
                               (Ad[sigma][:, sigma]) @ v, rtol=1e-9, atol=1e-9)


def test_rcm_panel_protocol_T_mode():
    """apply_matrix_t through the sandwich, transpose mode."""
    Asc, _ = _scrambled_banded(150, 3, seed=41)
    op = lo.opSparse(Asc, reorder="rcm")
    rng = np.random.default_rng(4)
    Ut = rng.standard_normal((3, 150))
    got = np.asarray(op.apply_matrix_t(jnp.asarray(Ut), mode="T"))
    ref = (Asc.toarray().T @ Ut.T).T
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10)
