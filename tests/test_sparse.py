"""Sparse operator tests: COO/CSR/BSR against dense oracles (reference
test strategy: test/test_linop.jl sparse-wrapper oracles, SURVEY.md §4)."""

import numpy as np
import jax.numpy as jnp
import pytest

from helpers import assert_close

import linops_tpu as lo
from linops_tpu.sparse import opSparse, csr_from_dense, bsr_from_dense


def sprand(rng, m, n, density=0.1, complex_=False):
    A = rng.standard_normal((m, n))
    if complex_:
        A = A + 1j * rng.standard_normal((m, n))
    mask = rng.random((m, n)) < density
    return A * mask


@pytest.mark.parametrize("fmt", ["coo", "csr", "bsr"])
@pytest.mark.parametrize("shape", [(40, 40), (30, 50), (50, 30)])
def test_sparse_matvec_oracle(fmt, shape, rng):
    m, n = shape
    A = sprand(rng, m, n, 0.15)
    op = opSparse(A, format=fmt, block_shape=(8, 16))
    assert op.shape == (m, n)
    v = rng.standard_normal(n)
    u = rng.standard_normal(m)
    assert_close(op * v, A @ v)
    assert_close(op.T * u, A.T @ u)
    assert_close(op.H * u, A.T @ u)
    assert_close(op.to_dense(), A, rtol=1e-12)


@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_sparse_complex(fmt, rng):
    m, n = 25, 35
    A = sprand(rng, m, n, 0.2, complex_=True)
    op = opSparse(A, format=fmt)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    u = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    assert_close(op * v, A @ v)
    assert_close(op.T * u, A.T @ u)
    assert_close(op.H * u, A.conj().T @ u)


def test_bsr_complex(rng):
    m = n = 32
    A = sprand(rng, m, n, 0.2, complex_=True)
    op = opSparse(A, format="bsr", block_shape=(8, 8))
    u = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    assert_close(op.H * u, A.conj().T @ u)


def test_sparse_matmat(rng):
    m, n, k = 30, 40, 7
    A = sprand(rng, m, n, 0.2)
    X = rng.standard_normal((n, k))
    for fmt in ("coo", "csr"):
        op = opSparse(A, format=fmt)
        assert_close(op.matmat(X), A @ X)
        assert_close(op.matmat(rng.standard_normal((m, k)) * 0 + 1.0, mode="T"), A.T @ np.ones((m, k)))


def test_sparse_in_algebra(rng):
    """Sparse operators participate in the lazy algebra graph."""
    n = 48
    A = sprand(rng, n, n, 0.1)
    B = sprand(rng, n, n, 0.1)
    opA = opSparse(A, format="csr")
    opB = opSparse(B, format="bsr", block_shape=(8, 16))
    chain = 2.0 * (opA @ opB) + opA.T - lo.opEye(n)
    dense = 2.0 * (A @ B) + A.T - np.eye(n)
    v = rng.standard_normal(n)
    assert_close(chain * v, dense @ v)


def test_sparse_symmetric_flags(rng):
    n = 20
    A = sprand(rng, n, n, 0.3)
    A = (A + A.T) / 2
    op = opSparse(A, format="csr", symmetric=True, hermitian=True)
    assert op.symmetric and op.hermitian
    assert lo.check_hermitian(op)


def test_scipy_interop(rng):
    scipy_sparse = pytest.importorskip("scipy.sparse")
    m, n = 30, 40
    A = sprand(rng, m, n, 0.2)
    S = scipy_sparse.csr_matrix(A)
    op = opSparse(S)
    v = rng.standard_normal(n)
    assert_close(op * v, A @ v)
    assert op.nnz == S.nnz


def test_bsr_padding_alignment(rng):
    """BSR pads ragged dims with zero blocks; logical shape preserved."""
    m, n = 37, 53  # deliberately unaligned
    A = sprand(rng, m, n, 0.3)
    op = opSparse(A, format="bsr", block_shape=(8, 16))
    assert op.shape == (m, n)
    v = rng.standard_normal(n)
    assert_close(op * v, A @ v)
    u = rng.standard_normal(m)
    assert_close(op.T * u, A.T @ u)


def test_sparse_no_recompile(rng):
    n = 64
    A1 = sprand(rng, n, n, 0.1)
    op = opSparse(A1, format="csr")
    v = rng.standard_normal(n)
    op.matvec(v)
    before = lo.apply_cache_sizes()
    # same structure (same nnz), new values -> cache hit
    op2 = opSparse(np.where(A1 != 0, A1 * 2.0, 0.0), format="csr")
    assert op2.nnz == op.nnz
    op2.matvec(v)
    op.matvec(v)
    assert lo.apply_cache_sizes() == before


def test_bsr_auto_block_shape(rng):
    """block_shape='auto' picks the tile minimizing stored bytes and stays
    correct; a dense-ish matrix should prefer large tiles."""
    scipy_sparse = pytest.importorskip("scipy.sparse")
    from linops_tpu.native import native_available

    if not native_available():
        pytest.skip("native counter unavailable")
    n = 512
    dense_ish = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.5)
    op = lo.opSparse(scipy_sparse.csr_matrix(dense_ish), format="bsr", block_shape="auto")
    assert op.data.block_shape in ((32, 128), (128, 128))
    v = rng.standard_normal(n)
    assert_close(op * v, dense_ish @ v)

    scattered = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.002)
    op2 = lo.opSparse(scipy_sparse.csr_matrix(scattered), format="bsr", block_shape="auto")
    v2 = rng.standard_normal(n)
    assert_close(op2 * v2, scattered @ v2)


def test_sparse_matmat_conj_mode(rng):
    """mode 'C' matmat equals conj(A) @ M (regression: triple-conjugation
    returned A @ M)."""
    m, n, k = 12, 15, 4
    A = sprand(rng, m, n, 0.3, complex_=True)
    M = rng.standard_normal((n, k)) + 1j * rng.standard_normal((n, k))
    for fmt in ("coo", "csr"):
        op = opSparse(A, format=fmt)
        got = np.asarray(op.matmat(jnp.asarray(M), mode="C"))
        np.testing.assert_allclose(got, np.conj(A) @ M, rtol=1e-10)


def test_scipy_coo_no_densify(rng):
    """scipy input with format='coo' builds directly from the COO triplets."""
    scipy_sparse = pytest.importorskip("scipy.sparse")
    S = scipy_sparse.random(50, 40, density=0.1, random_state=2).tocsr()
    op = opSparse(S, format="coo")
    assert type(op).__name__ == "COOOperator"
    v = rng.standard_normal(40)
    assert_close(op * v, S @ v)


def test_bsr_matmat_direct(rng):
    """Direct BSR SpMM path matches dense multi-RHS (and unaligned shapes)."""
    m, n, k = 37, 53, 6
    A = sprand(rng, m, n, 0.3)
    op = opSparse(A, format="bsr", block_shape=(8, 16))
    X = rng.standard_normal((n, k))
    assert_close(op.matmat(X), A @ X)


def test_native_packer_sums_duplicates(rng):
    """Non-canonical CSR with duplicate (row, col) entries is summed (scipy
    convention; regression: last-wins assignment)."""
    scipy_sparse = pytest.importorskip("scipy.sparse")
    from linops_tpu.native import bsr_pack_csr, native_available
    from linops_tpu.sparse.formats import BSR
    import jax.numpy as jnp

    if not native_available():
        pytest.skip("native packer unavailable")
    rows = np.array([0, 0, 1, 2])
    cols = np.array([1, 1, 2, 0])
    vals = np.array([2.0, 3.0, 1.0, 4.0])
    S = scipy_sparse.coo_matrix((vals, (rows, cols)), shape=(8, 8)).tocsr()
    # keep duplicates: build CSR parts manually from the COO (tocsr sums)
    indptr = np.array([0, 2, 3, 4, 4, 4, 4, 4, 4], np.int32)
    blocks, bcols = bsr_pack_csr(vals, cols, indptr, 8, 8, (4, 4))
    dense = np.zeros((8, 8))
    for i in range(blocks.shape[0]):
        for kk in range(blocks.shape[1]):
            j = bcols[i, kk]
            dense[i*4:(i+1)*4, j*4:(j+1)*4] += blocks[i, kk]
    assert dense[0, 1] == 5.0  # 2 + 3 summed


def test_opsparse_format_auto(rng):
    """format='auto' packs block-structured patterns to BSR (native packer)
    and leaves scattered patterns in CSR."""
    scipy_sparse = pytest.importorskip("scipy.sparse")
    from linops_tpu.native import native_available

    if not native_available():
        pytest.skip("native counter unavailable")
    n = 512
    # block-structured: dense 8x128 tiles
    blocky = np.zeros((n, n), np.float64)
    for bi in range(0, n, 8):
        j = ((bi // 8) * 128) % n  # aligned 8x128 tiles
        blocky[bi : bi + 8, j : j + 128] = rng.standard_normal((8, 128))
    opb = lo.opSparse(scipy_sparse.csr_matrix(blocky), format="auto")
    assert type(opb).__name__ == "BSROperator"
    v = rng.standard_normal(n)
    assert_close(opb * v, blocky @ v)

    # scattered: ~2 nnz/row uniform — no recoverable block structure, so
    # auto picks plain CSR, silently
    import warnings

    scat = rng.standard_normal((n, n)) * (rng.random((n, n)) < 2.0 / n)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        opc = lo.opSparse(scipy_sparse.csr_matrix(scat), format="auto")
    assert type(opc).__name__ == "CSROperator"
    assert_close(opc * v, scat @ v)


def test_ell_operator(rng):
    """ELL format: forward is gather+row-sum (no scatter); matches dense in
    every mode, participates in algebra, handles ragged rows via padding."""
    m, n = 37, 29
    A = sprand(rng, m, n, 0.2)
    A[3] = 0.0  # empty row
    A[5, :25] = rng.standard_normal(25)  # heavy row (kmax driver)
    for src in (A, __import__("scipy.sparse", fromlist=["csr_matrix"]).csr_matrix(A)):
        op = opSparse(src, format="ell")
        assert type(op).__name__ == "ELLOperator"
        v = rng.standard_normal(n)
        u = rng.standard_normal(m)
        assert_close(op * v, A @ v)
        assert_close(op.T * u, A.T @ u)
        assert_close(op.H * u, A.T @ u)
        assert_close(op.to_dense(), A, rtol=1e-12)
        X = rng.standard_normal((n, 3))
        assert_close(op.matmat(X), A @ X)
        assert_close(op.matmat(rng.standard_normal((m, 3)), mode="T").shape, (n, 3))


def test_ell_complex(rng):
    m = n = 24
    A = sprand(rng, m, n, 0.25, complex_=True)
    op = opSparse(A, format="ell")
    u = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    assert_close(op.H * u, A.conj().T @ u)
    M = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    assert_close(op.matmat(jnp.asarray(M), mode="C"), np.conj(A) @ M)


def test_bsr_bf16_storage(rng):
    """bf16 block storage: applies promote per element (no upcast copy of
    the block array) and stay accurate to bf16 resolution."""
    n = 256
    A = sprand(rng, n, n, 0.2).astype(np.float32)
    from linops_tpu.sparse.formats import bsr_from_dense, BSR as BSRfmt

    b = bsr_from_dense(A, (8, 32))
    op = lo.BSROperator(
        BSRfmt(blocks=b.blocks.astype(jnp.bfloat16), block_cols=b.block_cols,
               shape=b.shape)
    )
    v = rng.standard_normal(n).astype(np.float32)
    got = np.asarray(op * v, dtype=np.float32)
    np.testing.assert_allclose(got, A @ v, rtol=5e-2, atol=5e-2)


def test_sparse_apply_rejects_wrong_length(rng):
    """Sparse applies gather/pad, which would silently ACCEPT wrong-length
    vectors (JAX clamps out-of-range gather indices) — the base-class
    validation must raise instead, for every format and mode."""
    import pytest as _pytest
    n = 64
    A = (rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.3))
    A[np.arange(n), np.arange(n)] = 1.0
    for fmt in ("coo", "csr", "ell", "bsr"):
        op = lo.opSparse(A, format=fmt) if fmt != "bsr" else lo.opSparse(
            A, format="bsr", block_shape=(8, 8))
        for mode in ("N", "T", "C", "H"):
            with _pytest.raises(lo.LinearOperatorException):
                op.apply(jnp.zeros(n - 3), mode)
            with _pytest.raises(lo.LinearOperatorException):
                op.apply(jnp.zeros((n, 2)), mode)

def test_sparse_apply_matrix_rejects_wrong_shape(rng):
    """apply_matrix has the same clamping-gather hazard as apply: a
    wrong-height (or non-2D) matrix must raise, for every format/mode."""
    import pytest as _pytest
    n = 64
    A = (rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.3))
    A[np.arange(n), np.arange(n)] = 1.0
    for fmt in ("coo", "csr", "ell", "bsr"):
        op = lo.opSparse(A, format=fmt) if fmt != "bsr" else lo.opSparse(
            A, format="bsr", block_shape=(8, 8))
        for mode in ("N", "T", "C", "H"):
            with _pytest.raises(lo.LinearOperatorException):
                op.apply_matrix(jnp.zeros((n - 3, 2)), mode)
            with _pytest.raises(lo.LinearOperatorException):
                op.apply_matrix(jnp.zeros(n), mode)


def test_csr_chunked_apply(rng):
    """CSR/COO applies (one unchunked gather + segment sum) in every mode
    and with matrix RHS match the dense oracle."""
    m, n = 40, 50
    A = sprand(rng, m, n, 0.15)
    for fmt in ("csr", "coo"):
        op = opSparse(A, format=fmt)
        v = rng.standard_normal(n)
        u = rng.standard_normal(m)
        assert_close(op * v, A @ v)
        assert_close(op.T * u, A.T @ u)
        M = rng.standard_normal((n, 3))
        assert_close(op.apply_matrix(jnp.asarray(M)), A @ M)
        U = rng.standard_normal((m, 3))
        assert_close(op.apply_matrix(jnp.asarray(U), "T"), A.T @ U)


def test_bsr_auto_block_shape_bf16(rng):
    """The auto block shape minimises stored blocks alone, so bf16 storage
    picks the same tile as float32; the bf16 operator applies correctly."""
    scipy_sparse = pytest.importorskip("scipy.sparse")
    # low-density scattered pattern: distinct-block count grows sublinearly
    # with bm, so the fewest stored bytes come from 8-row blocks
    rng2 = np.random.default_rng(3)
    nn = 4096
    rows_i = np.repeat(np.arange(nn), 2)
    cols_i = rng2.integers(0, nn, size=nn * 2)
    sp32 = scipy_sparse.csr_matrix(
        (np.ones(nn * 2, np.float32), (rows_i, cols_i)), shape=(nn, nn)
    )
    A = sp32.toarray()
    n = nn
    from linops_tpu.sparse.ops import _auto_block_shape

    (bm32, _bn32) = _auto_block_shape(sp32)
    assert bm32 == 8, bm32

    op = lo.opSparse(sp32, format="bsr", block_shape="auto", dtype=jnp.bfloat16)
    assert op.data.block_shape[0] == 8
    assert op.data.blocks.dtype == jnp.bfloat16
    v = rng.standard_normal(n).astype(np.float32)
    got = np.asarray(op * jnp.asarray(v), np.float32)
    ref = A @ v
    np.testing.assert_allclose(got, ref, rtol=2e-2)

    # dtype kwarg on the other formats casts the stored values too
    for fmt in ("csr", "coo", "ell"):
        opf = lo.opSparse(sp32, format=fmt, dtype=jnp.bfloat16)
        assert opf.data.vals.dtype == jnp.bfloat16
        gotf = np.asarray(opf * jnp.asarray(v), np.float32)
        np.testing.assert_allclose(gotf, ref, rtol=2e-2)


def test_bsr_all_bf16_apply(rng):
    """All-bf16 applies (bf16 blocks AND bf16 vector), forward and
    transpose: the result keeps the promoted bf16 dtype and bf16
    accuracy."""
    from linops_tpu.sparse.formats import BSR
    from linops_tpu.sparse.ops import BSROperator

    nbrow, kmax, bm, bn = 16, 2, 8, 128
    nbcol = 4
    blocks = rng.standard_normal((nbrow, kmax, bm, bn)).astype(np.float32)
    cols = rng.integers(0, nbcol, (nbrow, kmax)).astype(np.int32)
    data = BSR(blocks=jnp.asarray(blocks).astype(jnp.bfloat16),
               block_cols=jnp.asarray(cols), shape=(nbrow * bm, nbcol * bn))
    op = BSROperator(data)
    v = rng.standard_normal(nbcol * bn).astype(np.float32)
    v16 = jnp.asarray(v).astype(jnp.bfloat16)
    y = op @ v16
    assert y.dtype == jnp.bfloat16
    dense = np.zeros((nbrow * bm, nbcol * bn), np.float32)
    b16 = np.asarray(jnp.asarray(blocks).astype(jnp.bfloat16), np.float32)
    for bi in range(nbrow):
        for kk in range(kmax):
            dense[bi * bm:(bi + 1) * bm,
                  cols[bi, kk] * bn:(cols[bi, kk] + 1) * bn] += b16[bi, kk]
    ref = dense @ np.asarray(v16, np.float32)
    np.testing.assert_allclose(np.asarray(y, np.float32), ref,
                               rtol=3e-2, atol=3e-1)
    u16 = jnp.asarray(rng.standard_normal(nbrow * bm).astype(np.float32)
                      ).astype(jnp.bfloat16)
    yt = op.T @ u16
    assert yt.dtype == jnp.bfloat16
    reft = dense.T @ np.asarray(u16, np.float32)
    np.testing.assert_allclose(np.asarray(yt, np.float32), reft,
                               rtol=3e-2, atol=3e-1)


def _bsr_pattern(kind, nbrow, nbcol):
    """Block-column lists (nbrow, 3) of the patterns the XLA path must
    handle: a sliding band, a band plus a far column cluster, and a real
    block at block-column 0 in a later slot (unsorted columns)."""
    bi = np.arange(nbrow)
    if kind == "banded":
        c0 = (bi * (nbcol - 3)) // max(nbrow - 1, 1)
        return c0[:, None] + np.arange(3)[None, :]
    if kind == "band_outlier":
        c0 = (bi * (nbcol - 4)) // max(nbrow - 1, 1)
        band = c0[:, None] + np.arange(2)[None, :]
        return np.concatenate([band, np.full((nbrow, 1), nbcol - 1)], axis=1)
    return np.tile(np.array([nbcol - 2, 0, 2]), (nbrow, 1))


@pytest.mark.parametrize("pattern", ["banded", "band_outlier", "col0_later_slot"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "complex128"])
@pytest.mark.parametrize("mode", ["N", "T", "H"])
@pytest.mark.parametrize("block", [(8, 128), (16, 128), (32, 128), (128, 128)])
def test_bsr_xla_oracle(block, mode, dtype, pattern):
    """BSROperator's XLA applies (gather+einsum forward, segment-sum
    transpose) against a dense oracle, for every block shape, mode and
    dtype the operator serves."""
    from linops_tpu.sparse.formats import BSR
    from linops_tpu.sparse.ops import BSROperator

    rng = np.random.default_rng(sum(block) + len(pattern))
    bm, bn = block
    nbrow, nbcol = 8, 6
    cols = _bsr_pattern(pattern, nbrow, nbcol).astype(np.int32)
    shp = (nbrow, cols.shape[1], bm, bn)
    blocks = rng.standard_normal(shp)
    if dtype == "complex128":
        blocks = blocks + 1j * rng.standard_normal(shp)
    blocks = blocks.astype(dtype)
    dense = np.zeros((nbrow * bm, nbcol * bn), blocks.dtype)
    for i in range(nbrow):
        for k in range(cols.shape[1]):
            c = cols[i, k]
            dense[i * bm:(i + 1) * bm, c * bn:(c + 1) * bn] += blocks[i, k]
    op = BSROperator(BSR(blocks=jnp.asarray(blocks),
                         block_cols=jnp.asarray(cols), shape=dense.shape))
    ref_op = {"N": dense, "T": dense.T, "H": dense.conj().T}[mode]
    v = rng.standard_normal(ref_op.shape[1]).astype(blocks.real.dtype)
    got = np.asarray(op.apply(jnp.asarray(v), mode))
    ref = ref_op @ v
    rtol = 1e-5 if dtype == "float32" else 1e-12
    assert got.dtype == blocks.dtype
    assert np.linalg.norm(got - ref) <= rtol * np.linalg.norm(ref)
