"""Native (C++) runtime component tests: BSR packer and RCM reordering."""

import numpy as np
import pytest

from helpers import assert_close

import linops_tpu as lo
from linops_tpu.native import bsr_pack_csr, rcm_permutation, native_available

pytestmark = pytest.mark.skipif(not native_available(), reason="no native lib")

scipy_sparse = pytest.importorskip("scipy.sparse")


def test_pack_matches_python_packer(rng):
    from linops_tpu.sparse.formats import bsr_from_dense

    n = 200
    A = scipy_sparse.random(n, n, density=0.05, random_state=1, dtype=np.float64).tocsr()
    dense = A.toarray()
    blocks, bcols = bsr_pack_csr(A.data, A.indices, A.indptr, n, n, (8, 16))
    ref = bsr_from_dense(dense, (8, 16))
    # same reconstruction (slot order may differ; compare dense reconstructions)
    nbrow, kmax, bm, bn = blocks.shape

    def reconstruct(blocks, bcols, ncols_b):
        out = np.zeros((blocks.shape[0] * bm, ncols_b * bn))
        for i in range(blocks.shape[0]):
            for k in range(blocks.shape[1]):
                out[i * bm : (i + 1) * bm, bcols[i, k] * bn : (bcols[i, k] + 1) * bn] += blocks[i, k]
        return out

    ncols_b = -(-n // bn)
    got = reconstruct(np.asarray(blocks), np.asarray(bcols), ncols_b)[:n, :n]
    np.testing.assert_allclose(got, dense, rtol=1e-14)


def test_packed_operator_matvec(rng):
    """CSR→BSR native pack → BSROperator gives correct applies."""
    from linops_tpu.sparse.formats import BSR
    import jax.numpy as jnp

    n = 300
    A = scipy_sparse.random(n, n, density=0.03, random_state=2, dtype=np.float64).tocsr()
    blocks, bcols = bsr_pack_csr(A.data, A.indices, A.indptr, n, n, (8, 32))
    op = lo.BSROperator(BSR(jnp.asarray(blocks), jnp.asarray(bcols), (n, n)))
    v = rng.standard_normal(n)
    assert_close(op * v, A @ v)
    u = rng.standard_normal(n)
    assert_close(op.T * u, A.T @ u)


def test_rcm_reduces_banded_bandwidth(rng):
    """On a shuffled banded matrix, RCM recovers a small bandwidth."""
    n = 400
    diags = [np.ones(n), np.ones(n - 1), np.ones(n - 1), np.ones(n - 3), np.ones(n - 3)]
    A = scipy_sparse.diags(diags, [0, 1, -1, 3, -3]).tocsr()
    p = rng.permutation(n)
    Ap = A[p][:, p].tocsr()

    perm = rcm_permutation(Ap.indices, Ap.indptr, n)
    assert sorted(perm.tolist()) == list(range(n))
    B = Ap[perm][:, perm].toarray()
    r, c = np.nonzero(B)
    bw = np.abs(r - c).max()
    assert bw <= 10  # original bandwidth is 3; RCM gets close
