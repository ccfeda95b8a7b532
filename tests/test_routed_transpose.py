"""Derived-transpose routed programs (sparse/routed.py::RoutedTranspose)
and the boundary-segsum combine, vs scipy/dense oracles.

The derived transpose runs the forward Clos network BACKWARDS (inverse
per-window crossbars, same wirings) — no second router run. These tests
cover every layout regime: 1/3/5-stage domains, trivial and tiled combine
layouts, multi-chunk packs, complex T/H, rectangular shapes, and float32
programs.
"""

import warnings

import numpy as np
import pytest

scipy_sparse = pytest.importorskip("scipy.sparse")

import jax
import jax.numpy as jnp

import linops_tpu as lo
from linops_tpu.sparse import ops as sops
from linops_tpu.sparse import routed as R
from linops_tpu.sparse.routed import (RoutedTranspose, pack_routed_csr,
                                      routed_matvec, routed_rmatvec)


def _random_csr(n_r, n_c, density, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = scipy_sparse.random(n_r, n_c, density=density, format="csr",
                            random_state=seed, dtype=dtype)
    A.data[:] = rng.standard_normal(A.nnz)
    return A


@pytest.mark.parametrize(
    "n_r,n_c,density,w",
    [
        (300, 500, 0.02, "auto"),     # 3-stage
        (40, 60, 0.05, "auto"),       # single-crossbar domain
        (5000, 4000, 0.005, "auto"),  # 5-stage (B > 1)
        (700, 900, 0.05, 4),          # tiled, several sub-rows per row
        (128, 64, 0.2, 16),           # wide rows, tiny cols
        (1000, 150, 0.03, "auto"),    # tall
    ],
)
def test_derived_transpose_oracle(n_r, n_c, density, w):
    A = _random_csr(n_r, n_c, density, seed=n_r + n_c)
    fwd, der = pack_routed_csr(A.data, A.indices, A.indptr, A.shape, w=w,
                               with_transpose=True)
    assert isinstance(der, RoutedTranspose)
    u = np.random.default_rng(2).standard_normal(n_r)
    yt = np.asarray(routed_rmatvec(der, u))
    ref = A.T @ u
    np.testing.assert_allclose(yt, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())
    # a float32 program agrees to float32 rounding at window scale
    yt32 = np.asarray(routed_rmatvec(
        der._replace(vals_pre=der.vals_pre.astype(jnp.float32)),
        u.astype(np.float32)))
    np.testing.assert_allclose(yt32, ref, rtol=2e-4,
                               atol=2e-4 * np.abs(ref).max())


def test_derived_transpose_trivial_layout():
    # every row 1..w nnz -> trivial combine (partials ARE rows)
    rng = np.random.default_rng(5)
    n = 600
    ks = rng.integers(1, 4, size=n)
    cols = np.concatenate(
        [np.sort(rng.choice(n, k, replace=False)) for k in ks])
    indptr = np.concatenate([[0], np.cumsum(ks)])
    vals = rng.standard_normal(indptr[-1])
    fwd, der = pack_routed_csr(vals, cols, indptr, (n, n), w=4,
                               with_transpose=True)
    assert fwd.rowid is None  # really trivial
    A = scipy_sparse.csr_matrix((vals, cols, indptr), shape=(n, n))
    u = rng.standard_normal(n)
    yt = np.asarray(routed_rmatvec(der, u))
    np.testing.assert_allclose(yt, A.T @ u, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("trivial", [False, True])
def test_derived_transpose_multichunk(monkeypatch, trivial):
    monkeypatch.setattr(R, "CLOS_MAX_SLOTS", 16384)
    rng = np.random.default_rng(7)
    n = 9000 if trivial else 6000
    ks = rng.integers(1, 4, size=n) if trivial else rng.integers(0, 12, size=n)
    cols = np.concatenate(
        [np.sort(rng.choice(n, k, replace=False)) for k in ks])
    indptr = np.concatenate([[0], np.cumsum(ks)])
    vals = rng.standard_normal(indptr[-1])
    fwd, der = pack_routed_csr(vals, cols, indptr, (n, n),
                               w=4 if trivial else "auto",
                               with_transpose=True)
    assert fwd.vals.shape[0] > 1  # really chunked
    assert (fwd.rowid is None) == trivial
    assert der is not None
    A = scipy_sparse.csr_matrix((vals, cols, indptr), shape=(n, n))
    u = rng.standard_normal(n)
    yt = np.asarray(routed_rmatvec(der, u))
    np.testing.assert_allclose(yt, A.T @ u, rtol=1e-11, atol=1e-11)


def test_derived_transpose_complex_modes():
    rng = np.random.default_rng(9)
    A = _random_csr(400, 300, 0.02, seed=11).astype(np.complex128)
    A.data[:] = rng.standard_normal(A.nnz) + 1j * rng.standard_normal(A.nnz)
    fwd, der = pack_routed_csr(A.data, A.indices, A.indptr, A.shape,
                               with_transpose=True)
    u = rng.standard_normal(400) + 1j * rng.standard_normal(400)
    yt = np.asarray(routed_rmatvec(der, u))
    np.testing.assert_allclose(yt, A.T @ u, rtol=1e-12, atol=1e-12)
    yh = np.asarray(routed_rmatvec(
        der._replace(vals_pre=jnp.conj(der.vals_pre)), u))
    np.testing.assert_allclose(yh, A.conj().T @ u, rtol=1e-12, atol=1e-12)


def test_segsum_combine_bounds_match_onehot():
    """The forward combine (one segment sum over the tiles' row ids)
    reduces arbitrary sub-row partials exactly like a per-row sum over
    ``rowid``; trash slots (rowid -1) drop out."""
    from linops_tpu.sparse.routed import _combine_segments

    A = _random_csr(700, 900, 0.05, seed=3)
    p = pack_routed_csr(A.data, A.indices, A.indptr, A.shape, w=4)
    assert p.rowid is not None
    T, K = p.rowid.shape
    q = np.random.default_rng(4).standard_normal(T * K)
    y_seg = jax.ops.segment_sum(jnp.asarray(q), _combine_segments(p),
                                num_segments=T * 128)
    rid = np.asarray(p.rowid, np.int64).reshape(-1)
    real = rid >= 0
    ref = np.zeros(T * 128)
    np.add.at(ref, np.repeat(np.arange(T), K)[real] * 128 + rid[real],
              q[real])
    np.testing.assert_allclose(np.asarray(y_seg), ref, rtol=1e-12,
                               atol=1e-12)
    x = np.random.default_rng(5).standard_normal(900)
    np.testing.assert_allclose(np.asarray(routed_matvec(p, x)), A @ x,
                               rtol=1e-12, atol=1e-12)


def test_routed_operator_transpose_eager_and_in_jit():
    """op.T works at full routed speed immediately, including when the
    first T apply happens INSIDE a jit."""
    import jax

    A = _random_csr(500, 400, 0.03, seed=21)
    op = lo.opSparse(scipy_sparse.csr_matrix(A), format="routed")
    assert isinstance(op.routed_t, RoutedTranspose)  # eager derived program

    u = np.random.default_rng(1).standard_normal(500)

    @jax.jit
    def tapply(o, v):
        return o.apply(v, mode="T")

    yt = np.asarray(tapply(op, jnp.asarray(u)))
    np.testing.assert_allclose(yt, A.T @ u, rtol=1e-11, atol=1e-11)


def test_routed_operator_defer_and_footgun_warning():
    import jax

    A = _random_csr(300, 300, 0.03, seed=23)
    op = lo.opSparse(scipy_sparse.csr_matrix(A), format="routed")
    # defer_transpose opt-out keeps the old lazy behavior
    op_d = sops.RoutedCSROperator(op.data, defer_transpose=True)
    assert op_d.routed_t is None

    @jax.jit
    def tapply(o, v):
        return o.apply(v, mode="T")

    u = np.random.default_rng(2).standard_normal(300)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        yt = np.asarray(tapply(op_d, jnp.asarray(u)))
    assert any("CSR fallback" in str(w_.message) for w_ in rec)
    np.testing.assert_allclose(yt, A.T @ u, rtol=1e-11, atol=1e-11)

    # eager host dispatch packs the full transpose for deferred operators
    yt2 = np.asarray(op_d.T @ u)
    assert op_d.routed_t is not None
    np.testing.assert_allclose(yt2, A.T @ u, rtol=1e-11, atol=1e-11)


def test_derived_transpose_skew_guard():
    """A near-dense column block must NOT get a derived program (window
    gather blowup) — it falls back to the lazy full pack."""
    rng = np.random.default_rng(31)
    n = 4000
    # every row hits column 0 (one dense column) + a random tail
    cols_l, indptr = [], [0]
    for i in range(n):
        c = np.unique(np.concatenate([[0], rng.choice(n, 2)]))
        cols_l.append(c)
        indptr.append(indptr[-1] + len(c))
    cols = np.concatenate(cols_l)
    vals = rng.standard_normal(indptr[-1])
    fwd, der = pack_routed_csr(vals, cols, np.asarray(indptr), (n, n),
                               with_transpose=True)
    A = scipy_sparse.csr_matrix((vals, cols, indptr), shape=(n, n))
    u = rng.standard_normal(n)
    if der is not None:  # if derivable anyway, it must be correct
        yt = np.asarray(routed_rmatvec(der, u))
        np.testing.assert_allclose(yt, A.T @ u, rtol=1e-11, atol=1e-11)
    y = np.asarray(routed_matvec(fwd, rng.standard_normal(n)))
    assert np.isfinite(y).all()


@pytest.mark.parametrize("regime", ["3stage", "5stage", "trivial", "chunked"])
def test_routed_spmm_shared_program(monkeypatch, regime):
    """routed_matmat/rmatmat: k RHS columns share ONE routing program —
    vs the dense oracle in float64 and float32, all layout regimes."""
    from linops_tpu.sparse.routed import routed_matmat, routed_rmatmat

    rng = np.random.default_rng(hash(regime) % 2**31)
    if regime == "chunked":
        monkeypatch.setattr(R, "CLOS_MAX_SLOTS", 16384)
        n_r = n_c = 6000
        ks = rng.integers(0, 12, size=n_r)
        w = "auto"
    elif regime == "trivial":
        n_r = n_c = 600
        ks = rng.integers(1, 4, size=n_r)
        w = 4
    elif regime == "5stage":
        n_r, n_c = 5000, 4000
        ks = rng.integers(0, 10, size=n_r)
        w = "auto"
    else:
        n_r, n_c = 700, 900
        ks = rng.integers(0, 9, size=n_r)
        w = "auto"
    cols = np.concatenate(
        [np.sort(rng.choice(n_c, k, replace=False)) for k in ks])
    indptr = np.concatenate([[0], np.cumsum(ks)])
    vals = rng.standard_normal(indptr[-1])
    A = scipy_sparse.csr_matrix((vals, cols, indptr), shape=(n_r, n_c))
    fwd, der = pack_routed_csr(vals, cols, indptr, (n_r, n_c), w=w,
                               with_transpose=True)
    if regime == "chunked":
        assert fwd.vals.shape[0] > 1
    k = 5
    X = rng.standard_normal((n_c, k))
    U = rng.standard_normal((n_r, k))
    Y = np.asarray(routed_matmat(fwd, X))
    np.testing.assert_allclose(Y, A @ X, rtol=1e-11, atol=1e-11)
    Yt = np.asarray(routed_rmatmat(der, U))
    np.testing.assert_allclose(Yt, A.T @ U, rtol=1e-11, atol=1e-11)
    # float32 programs agree to float32 rounding at window scale
    f32 = lambda a: jnp.asarray(np.asarray(a), jnp.float32)
    Yi = np.asarray(routed_matmat(fwd._replace(vals=f32(fwd.vals)), f32(X)))
    ref = A @ X
    np.testing.assert_allclose(Yi, ref, rtol=5e-4,
                               atol=2e-4 * np.abs(ref).max())
    Yti = np.asarray(routed_rmatmat(
        der._replace(vals_pre=f32(der.vals_pre)), f32(U)))
    reft = A.T @ U
    np.testing.assert_allclose(Yti, reft, rtol=5e-4,
                               atol=2e-4 * np.abs(reft).max())


def test_routed_operator_matmat_all_modes():
    """apply_matrix on the routed operator uses the shared-program SpMM
    for every mode (N/T/C/H), complex included."""
    rng = np.random.default_rng(17)
    A = _random_csr(400, 300, 0.03, seed=13).astype(np.complex128)
    A.data[:] = rng.standard_normal(A.nnz) + 1j * rng.standard_normal(A.nnz)
    op = sops.RoutedCSROperator(lo.opSparse(A, format="routed").data)
    Ad = A.toarray()
    X = rng.standard_normal((300, 4)) + 1j * rng.standard_normal((300, 4))
    U = rng.standard_normal((400, 4)) + 1j * rng.standard_normal((400, 4))
    for mode, ref in (("N", Ad @ X), ("C", Ad.conj() @ X),
                      ("T", Ad.T @ U), ("H", Ad.conj().T @ U)):
        M = X if mode in ("N", "C") else U
        got = np.asarray(op.apply_matrix(jnp.asarray(M), mode=mode))
        np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-11)


def test_routed_operator_apply_matrix_t_all_modes():
    """apply_matrix_t (row-panel protocol) on the routed operator runs the
    panel=True SpMM — the pipeline's native column-outer layout on both
    ends — and agrees with apply_matrix(Mt.T).T for every mode."""
    rng = np.random.default_rng(23)
    A = _random_csr(400, 300, 0.03, seed=29).astype(np.complex128)
    A.data[:] = rng.standard_normal(A.nnz) + 1j * rng.standard_normal(A.nnz)
    op = sops.RoutedCSROperator(lo.opSparse(A, format="routed").data)
    Ad = A.toarray()
    Xt = rng.standard_normal((4, 300)) + 1j * rng.standard_normal((4, 300))
    Ut = rng.standard_normal((4, 400)) + 1j * rng.standard_normal((4, 400))
    for mode, ref in (("N", (Ad @ Xt.T).T), ("C", (Ad.conj() @ Xt.T).T),
                      ("T", (Ad.T @ Ut.T).T), ("H", (Ad.conj().T @ Ut.T).T)):
        Mt = Xt if mode in ("N", "C") else Ut
        got = np.asarray(op.apply_matrix_t(jnp.asarray(Mt), mode=mode))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-11)
    # k=1 panel and shape validation
    y1 = np.asarray(op.apply_matrix_t(jnp.asarray(Xt[:1]), mode="N"))
    np.testing.assert_allclose(y1, (Ad @ Xt[:1].T).T, rtol=1e-11, atol=1e-11)
    with pytest.raises(lo.LinearOperatorException):
        op.apply_matrix_t(jnp.asarray(Ut), mode="N")


def test_routed_matmat_panel_matches_dense_layout():
    """routed_matmat/rmatmat panel=True equal the transposed dense-layout
    results (real f32)."""
    from linops_tpu.sparse.routed import routed_matmat, routed_rmatmat

    A = _random_csr(500, 400, 0.02, seed=31)
    p, der = pack_routed_csr(A.data, A.indices, A.indptr, A.shape, w=8,
                             with_transpose=True)
    rng = np.random.default_rng(7)
    X = rng.standard_normal((400, 5)).astype(np.float32)
    U = rng.standard_normal((500, 5)).astype(np.float32)
    Yp = np.asarray(routed_matmat(p, jnp.asarray(X.T.copy()),
                                  panel=True))
    Yd = np.asarray(routed_matmat(p, jnp.asarray(X)))
    np.testing.assert_allclose(Yp, Yd.T, rtol=1e-5, atol=1e-5)
    Tp = np.asarray(routed_rmatmat(der, jnp.asarray(U.T.copy()),
                                   panel=True))
    Td = np.asarray(routed_rmatmat(der, jnp.asarray(U)))
    np.testing.assert_allclose(Tp, Td.T, rtol=1e-5, atol=1e-5)
