"""Clos-routed unstructured SpMV: pack + device pipeline vs scipy oracle.

The pipeline is plain jnp gathers and transposes;
sparse/routing.py::clos_apply is its numpy oracle.
"""

import numpy as np
import pytest

scipy_sparse = pytest.importorskip("scipy.sparse")

from linops_tpu.sparse import routed as R
from linops_tpu.sparse.routed import pack_routed_csr, routed_matvec


def _random_csr(n_r, n_c, density, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = scipy_sparse.random(n_r, n_c, density=density, format="csr",
                            random_state=seed, dtype=dtype)
    A.data[:] = rng.standard_normal(A.nnz)
    return A


@pytest.mark.parametrize(
    "n_r,n_c,density,w",
    [
        (300, 500, 0.02, "auto"),    # small domain
        (2000, 2000, 0.004, 8),      # 3-stage
        (5000, 4000, 0.005, "auto"), # 5-stage (B > 1)
        (700, 900, 0.05, 4),
        (128, 64, 0.2, 16),          # wide rows, tiny cols
    ],
)
def test_routed_matvec_oracle(n_r, n_c, density, w):
    A = _random_csr(n_r, n_c, density, seed=n_r + n_c)
    p = pack_routed_csr(A.data, A.indices, A.indptr, A.shape, w=w)
    x = np.random.default_rng(1).standard_normal(n_c)
    y = np.asarray(routed_matvec(p, x))
    ref = A @ x
    np.testing.assert_allclose(y, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


def test_routed_matvec_chunked(monkeypatch):
    # shrink the routing domain so a modest matrix needs several chunks
    monkeypatch.setattr(R, "CLOS_MAX_SLOTS", 16384)
    A = _random_csr(3000, 2500, 0.01, seed=7)
    p = pack_routed_csr(A.data, A.indices, A.indptr, A.shape, w=8)
    assert p.vals.shape[0] > 1  # really chunked
    x = np.random.default_rng(2).standard_normal(2500)
    y = np.asarray(routed_matvec(p, x))
    # chunk contributions sum in unroll order; tolerance covers the
    # summation-order ulps of the f64 oracle comparison
    np.testing.assert_allclose(y, A @ x, rtol=1e-11)


def test_routed_handles_empty_and_heavy_rows():
    n_r, n_c = 400, 600
    rng = np.random.default_rng(3)
    A = _random_csr(n_r, n_c, 0.01, seed=3).tolil()
    A[5, :] = 0                       # empty row
    A[7, :] = rng.standard_normal(n_c)  # dense row (splits into sub-rows)
    A = A.tocsr()
    A.eliminate_zeros()
    p = pack_routed_csr(A.data, A.indices, A.indptr, A.shape, w=8)
    x = rng.standard_normal(n_c)
    y = np.asarray(routed_matvec(p, x))
    np.testing.assert_allclose(y, A @ x, rtol=1e-12)
    assert y[5] == 0.0


def test_routed_rejects_empty_and_bad_w():
    A = _random_csr(100, 100, 0.01, seed=4)
    with pytest.raises(ValueError):
        pack_routed_csr(np.zeros(0), np.zeros(0, np.int64),
                        np.zeros(101, np.int64), (100, 100))
    with pytest.raises(ValueError):
        pack_routed_csr(A.data, A.indices, A.indptr, A.shape, w=7)


# ----------------------------------------------------------------------------
# Operator integration (public API)
# ----------------------------------------------------------------------------


def test_routed_operator_all_modes():
    import linops_tpu as lo

    A = _random_csr(800, 600, 0.02, seed=11)
    op = lo.opSparse(A, format="routed")
    assert isinstance(op, lo.RoutedCSROperator)
    rng = np.random.default_rng(5)
    v = rng.standard_normal(600)
    u = rng.standard_normal(800)
    np.testing.assert_allclose(np.asarray(op * v), A @ v, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(op.T * u), A.T @ u, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(op.H * u), A.T @ u, rtol=1e-12)
    # matrix RHS goes through the inherited CSR path
    M = rng.standard_normal((600, 3))
    np.testing.assert_allclose(np.asarray(op.matmat(M)), A @ M, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(op.matmat(rng.standard_normal((800, 3)),
                                                    mode="T")).shape, (600, 3))
    # densification oracle
    np.testing.assert_allclose(
        np.asarray(lo.to_dense(op)), A.toarray(), rtol=1e-12, atol=1e-14)


def test_routed_operator_complex_and_symmetric():
    import linops_tpu as lo

    rng = np.random.default_rng(9)
    B = _random_csr(300, 300, 0.03, seed=13)
    Bc = B + B.T  # symmetric
    op = lo.opSparse(Bc.tocsr(), format="routed", symmetric=True, hermitian=True)
    v = rng.standard_normal(300)
    np.testing.assert_allclose(np.asarray(op.T * v), Bc.T @ v, rtol=1e-12)
    # complex values exercise the conj path
    C = B.tocsr().astype(np.complex128)
    C.data = C.data + 1j * rng.standard_normal(C.nnz)
    opc = lo.opSparse(C, format="routed")
    vc = rng.standard_normal(300) + 1j * rng.standard_normal(300)
    np.testing.assert_allclose(np.asarray(opc * vc), C @ vc, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(opc.H * vc), C.conj().T @ vc, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(opc.T * vc), C.T @ vc, rtol=1e-12)


def test_routed_auto_format_picks_routed_for_scattered():
    """format='auto' leaves a scattered pattern in plain CSR (measured
    faster than the routed pipeline on the GPU, forward and transpose);
    'routed' stays available by name."""
    import linops_tpu as lo

    A = _random_csr(4096, 4096, 16 / 4096, seed=17)  # scattered, small
    op = lo.opSparse(A, format="auto")
    assert type(op) is lo.CSROperator
    v = np.random.default_rng(1).standard_normal(4096)
    np.testing.assert_allclose(np.asarray(op * v), A @ v, rtol=1e-12)


def test_routed_backend_xla_matches():
    import linops_tpu as lo

    A = _random_csr(500, 400, 0.02, seed=21)
    data_op = lo.opSparse(A, format="routed")
    xla_op = lo.RoutedCSROperator(data_op.data, backend="xla")
    v = np.random.default_rng(2).standard_normal(400)
    np.testing.assert_allclose(
        np.asarray(data_op * v), np.asarray(xla_op * v), rtol=1e-12)


def test_routed_fallback_reduce_passes(monkeypatch):
    """Pathological tiles (huge K) fall back to the routed ReducePass chain."""
    monkeypatch.setattr(R, "TILED_MAX_K", 0)
    A = _random_csr(900, 700, 0.02, seed=41)
    p = pack_routed_csr(A.data, A.indices, A.indptr, A.shape, w=8)
    assert p.rowid is None and len(p.passes) >= 1
    x = np.random.default_rng(4).standard_normal(700)
    np.testing.assert_allclose(
        np.asarray(routed_matvec(p, x)), A @ x, rtol=1e-12)


def test_routed_trivial_combine():
    """Uniform 1-sub-row rows skip the combine entirely."""
    rng = np.random.default_rng(6)
    n = 600
    # exactly 4 nnz per row, w=8 -> one sub-row per row
    cols = np.sort(rng.integers(0, n, (n, 4)), axis=1).astype(np.int64)
    vals = rng.standard_normal((n, 4))
    indptr = np.arange(0, 4 * n + 1, 4, dtype=np.int64)
    p = pack_routed_csr(vals.reshape(-1), cols.reshape(-1), indptr, (n, n), w=8)
    assert p.rowid is None and p.passes == ()
    x = rng.standard_normal(n)
    ref = np.zeros(n)
    for r in range(n):
        ref[r] = vals[r] @ x[cols[r]]
    np.testing.assert_allclose(np.asarray(routed_matvec(p, x)),
                               ref, rtol=1e-12)


@pytest.mark.parametrize("seed", range(6))
def test_routed_fuzz(seed, monkeypatch):
    """Property fuzz: random shapes/densities/widths (+ shrunken domains to
    force chunking and the reduce-pass fallback) against the scipy oracle."""
    rng = np.random.default_rng(100 + seed)
    n_r = int(rng.integers(50, 3000))
    n_c = int(rng.integers(50, 3000))
    nnz_target = int(rng.integers(1, max(2, n_r * n_c // 50)))
    A = scipy_sparse.random(n_r, n_c, density=min(0.9, nnz_target / (n_r * n_c)),
                            format="csr", random_state=seed, dtype=np.float64)
    if A.nnz == 0:
        A[0, 0] = 1.0
        A = A.tocsr()
    A.data[:] = rng.standard_normal(A.nnz)
    w = int(rng.choice([4, 8, 16, 32, 64, 128]))
    if seed % 3 == 1:
        monkeypatch.setattr(R, "CLOS_MAX_SLOTS", 16384)  # force chunking
    if seed % 3 == 2:
        monkeypatch.setattr(R, "TILED_MAX_K", 0)  # force reduce passes
    p = pack_routed_csr(A.data, A.indices, A.indptr, A.shape, w=w)
    x = rng.standard_normal(n_c)
    y = np.asarray(routed_matvec(p, x))
    ref = A @ x
    np.testing.assert_allclose(y, ref, rtol=1e-11, atol=1e-11 * max(1.0, np.abs(ref).max()))


def test_routed_w_is_forwarded():
    """Regression: opSparse(..., w=) must reach the routing pack (both
    directions), not just sit in aux."""
    import linops_tpu as lo

    from linops_tpu.sparse.ops import RoutedCSROperator
    from linops_tpu.sparse.routed import RoutedTranspose

    A = _random_csr(400, 400, 0.02, seed=51)
    op = lo.opSparse(A, format="routed", w=32)
    assert op.routed.w == 32
    # the DERIVED transpose shares the forward layout (w lives there)
    assert isinstance(op.routed_t, RoutedTranspose)
    # a deferred operator's lazy FULL transpose pack forwards w too
    op_d = RoutedCSROperator(op.data, w=32, defer_transpose=True)
    op_d._ensure_transpose()
    assert op_d.routed_t.w == 32


def test_routed_matmat_tpu_branch():
    """The routed matrix-RHS apply (one shared routing program for all
    columns) matches the dense oracle in every mode, complex included."""
    import linops_tpu as lo

    rng = np.random.default_rng(61)
    A = _random_csr(300, 260, 0.03, seed=61).astype(np.complex128)
    A.data = A.data + 1j * rng.standard_normal(A.nnz)
    op = lo.opSparse(A, format="routed")
    op._ensure_transpose()
    M = rng.standard_normal((260, 3)) + 1j * rng.standard_normal((260, 3))
    U = rng.standard_normal((300, 3)) + 1j * rng.standard_normal((300, 3))
    np.testing.assert_allclose(np.asarray(op.matmat(M)), A @ M, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(op.matmat(M, mode="C")),
                               A.conj() @ M, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(op.matmat(U, mode="T")),
                               A.T @ U, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(op.matmat(U, mode="H")),
                               A.conj().T @ U, rtol=1e-12)


def test_routed_symmetric_matmat_uses_forward_program():
    """Regression: symmetric routed operators must serve T/H matrix RHS via
    the FORWARD routing program (bump never packs routed_t for them)."""
    import linops_tpu as lo

    rng = np.random.default_rng(71)
    B = _random_csr(300, 300, 0.03, seed=71)
    S = (B + B.T).tocsr()
    op = lo.opSparse(S, format="routed", symmetric=True, hermitian=True)
    assert op.routed_t is None
    M = rng.standard_normal((300, 3))
    np.testing.assert_allclose(np.asarray(op.matmat(M, mode="T")),
                               S.T @ M, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(op.matmat(M, mode="H")),
                               S.T @ M, rtol=1e-12)
    assert op.routed_t is None  # still never packed


def test_routed_pathological_patterns():
    """Degenerate shapes: one dense column (every nnz in one col block),
    a single-row matrix, and a tall single-column matrix."""
    rng = np.random.default_rng(81)
    # all nnz in ONE column block
    n = 700
    A = scipy_sparse.lil_matrix((n, n))
    A[:, 3] = rng.standard_normal(n)
    A[:, 7] = rng.standard_normal(n)
    A = A.tocsr()
    p = pack_routed_csr(A.data, A.indices, A.indptr, A.shape, w=4)
    x = rng.standard_normal(n)
    np.testing.assert_allclose(np.asarray(routed_matvec(p, x)),
                               A @ x, rtol=1e-12)
    # single dense row
    B = scipy_sparse.csr_matrix(rng.standard_normal((1, 900)))
    p = pack_routed_csr(B.data, B.indices, B.indptr, B.shape, w=8)
    xb = rng.standard_normal(900)
    np.testing.assert_allclose(np.asarray(routed_matvec(p, xb)),
                               B @ xb, rtol=1e-12)
    # tall single column
    C = scipy_sparse.csr_matrix(rng.standard_normal((900, 1)))
    p = pack_routed_csr(C.data, C.indices, C.indptr, C.shape, w=4)
    xc = rng.standard_normal(1)
    np.testing.assert_allclose(np.asarray(routed_matvec(p, xc)),
                               (C @ xc), rtol=1e-12)


def test_pack_to_device_false_roundtrip():
    """to_device=False leaves numpy leaves; one jax.device_put later gives
    a program identical in behavior to the default device pack (the bench
    uses this seam to split CPU pack cost from upload)."""
    import jax

    A = _random_csr(1200, 1100, 0.01, seed=11)
    host_prog, host_der = pack_routed_csr(
        A.data, A.indices, A.indptr, A.shape, with_transpose=True,
        to_device=False)
    # every leaf stayed on host
    assert all(isinstance(leaf, np.ndarray)
               for leaf in jax.tree_util.tree_leaves((host_prog, host_der)))
    dev_prog = jax.device_put(host_prog)
    x = np.random.default_rng(4).standard_normal(1100)
    y = np.asarray(routed_matvec(dev_prog, x))
    np.testing.assert_allclose(y, A @ x, rtol=1e-12)
    if host_der is not None:
        from linops_tpu.sparse.routed import routed_rmatvec

        dev_der = jax.device_put(host_der)
        u = np.random.default_rng(5).standard_normal(1200)
        yt = np.asarray(routed_rmatvec(dev_der, u))
        np.testing.assert_allclose(yt, A.T @ u, rtol=1e-12)
