"""Sparse linear operators over COO / CSR / BSR device storage.

The reference has no sparse kernels of its own — it wraps
``SparseMatrixCSC`` mul! in closures (reference: src/constructors.jl:25-27,
test/test_linop.jl uses sparse wrappers throughout). Here the operator owns
the format (SURVEY.md §2.3):

- COO/CSR apply = gather + ``jax.ops.segment_sum`` — a single fused XLA
  computation; ``indices_are_sorted`` is exploited for CSR (row-major
  build order).
- BSR apply = one batched dense contraction over (bm, bn) blocks with
  block-level indexing only; zero pad-blocks contribute nothing.

Adjoint/transpose products reuse the same storage with roles of
rows/cols swapped (no transposed copy is materialized); hermitian applies
conjugate values on the fly, mirroring the reference's conj-trick lattice
(reference: src/adjtrans.jl:90-137).
"""

from __future__ import annotations

from typing import Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..core.base import (LinearOperator, LinearOperatorException,
                         register_operator)
# precision follows storage (HIGHEST for f32+, DEFAULT for bf16 inputs;
# core/precision.py)
from ..core.precision import matmul_precision
from .formats import (
    BSR,
    COO,
    CSR,
    ELL,
    bsr_from_dense,
    coo_from_dense,
    csr_from_dense,
    csr_from_parts,
    ell_from_csr_parts,
    ell_from_dense,
)

__all__ = [
    "COOOperator",
    "CSROperator",
    "RoutedCSROperator",
    "BSROperator",
    "ELLOperator",
    "opSparse",
]


def _conj(x):
    return jnp.conj(x) if jnp.iscomplexobj(x) else x


# ----------------------------------------------------------------------------
# Pure apply kernels
# ----------------------------------------------------------------------------


def coo_matvec(vals, rows, cols, nrow, x, sorted_rows=False):
    """y[r] = Σ vals[k]·x[cols[k]] over k with rows[k]=r."""
    return jax.ops.segment_sum(
        vals * x[cols], rows, num_segments=nrow, indices_are_sorted=sorted_rows
    )


def coo_matmat(vals, rows, cols, nrow, X, sorted_rows=False):
    return jax.ops.segment_sum(
        vals[:, None] * X[cols], rows, num_segments=nrow,
        indices_are_sorted=sorted_rows,
    )


def bsr_matvec(blocks, block_cols, x_padded_blocks):
    """y-blocks = Σ_k blocks[r,k] @ x_blocks[block_cols[r,k]] — one batched
    contraction (nbrow·kmax small matvecs fused by XLA)."""
    xg = x_padded_blocks[block_cols]  # (nbrow, kmax, bn)
    return jnp.einsum(
        "rkmn,rkn->rm", blocks, xg,
        precision=matmul_precision(blocks.dtype, xg.dtype),
        preferred_element_type=jnp.result_type(blocks.dtype, xg.dtype),
    )


def bsr_matmat(blocks, block_cols, X_blocks):
    """Multi-RHS SpMM: Y-blocks (nbrow, bm, k) = Σ blocks[r,j] @ X[cols[r,j]]
    — one batched contraction (the multi-RHS amortizes each block read
    over k columns)."""
    Xg = X_blocks[block_cols]  # (nbrow, kmax, bn, k)
    return jnp.einsum(
        "rkmn,rknc->rmc", blocks, Xg,
        precision=matmul_precision(blocks.dtype, Xg.dtype),
        preferred_element_type=jnp.result_type(blocks.dtype, Xg.dtype),
    )


def bsr_rmatvec(blocks, block_cols, u_blocks, nbcol):
    """Transpose apply: scatter blockᵀ·u contributions to column blocks."""
    contrib = jnp.einsum(
        "rkmn,rm->rkn", blocks, u_blocks,
        precision=matmul_precision(blocks.dtype, u_blocks.dtype),
        preferred_element_type=jnp.result_type(blocks.dtype, u_blocks.dtype),
    )  # (nbrow, kmax, bn)
    kflat = contrib.reshape(-1, contrib.shape[-1])
    ids = block_cols.reshape(-1)
    return jax.ops.segment_sum(kflat, ids, num_segments=nbcol)


# ----------------------------------------------------------------------------
# Operator classes
# ----------------------------------------------------------------------------


class _SparseBase(LinearOperator):
    _fields_children = ("data",)
    _fields_aux = ("_symmetric", "_hermitian")
    _sorted_rows = False  # CSR: row ids are sorted (faster segment_sum)

    def __init__(self, data, symmetric: bool = False, hermitian: bool = False):
        super().__init__()
        self.data = data
        self._symmetric = bool(symmetric)
        self._hermitian = bool(hermitian)

    def apply(self, v, mode: str = "N"):
        # Sparse applies gather (clamping out-of-range indices) or pad to
        # block multiples, so a wrong-length vector would be ACCEPTED
        # silently — validate the true dims up front (dense operators fail
        # loudly via dot shape checks; reference contract:
        # /root/reference/src/operations.jl:9-12).
        if getattr(v, "ndim", 1) != 1 or v.shape[0] != self.in_dim(mode):
            raise LinearOperatorException("shape mismatch")
        return super().apply(v, mode)

    def _check_mat(self, M, mode: str):
        # Same clamping-gather hazard as apply, for the matrix path.
        if getattr(M, "ndim", 2) != 2 or M.shape[0] != self.in_dim(mode):
            raise LinearOperatorException("shape mismatch")

    @property
    def nrow(self):
        return self.data.shape[0]

    @property
    def ncol(self):
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.vals.dtype if hasattr(self.data, "vals") else self.data.blocks.dtype

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return self._hermitian

    @property
    def nnz(self):
        return self.data.nnz


class _IndexedSparse(_SparseBase):
    """Shared applies for COO/CSR (gather + segment_sum); subclasses differ
    only in whether row ids are sorted."""

    def _prod(self, v):
        d = self.data
        return coo_matvec(d.vals, d.rows, d.cols, d.shape[0], v,
                          sorted_rows=self._sorted_rows)

    def _tprod(self, u):
        d = self.data
        return coo_matvec(d.vals, d.cols, d.rows, d.shape[1], u)

    def _ctprod(self, w):
        d = self.data
        return coo_matvec(_conj(d.vals), d.cols, d.rows, d.shape[1], w)

    def apply_matrix(self, M, mode: str = "N"):
        self._check_mat(M, mode)
        d = self.data
        if mode == "N":
            return coo_matmat(d.vals, d.rows, d.cols, d.shape[0], M,
                              sorted_rows=self._sorted_rows)
        if mode == "C":
            # conj(A) @ M = conj(A @ conj(M)); conjugate the output, not
            # the values as well (that would cancel back to A @ M)
            out = coo_matmat(d.vals, d.rows, d.cols, d.shape[0], _conj(M),
                             sorted_rows=self._sorted_rows)
            return _conj(out)
        vals = d.vals if mode == "T" else _conj(d.vals)
        return coo_matmat(vals, d.cols, d.rows, d.shape[1], M)


class COOOperator(_IndexedSparse):
    """Sparse operator over COO storage."""

    _sorted_rows = False


class CSROperator(_IndexedSparse):
    """Sparse operator over CSR storage (sorted row ids → faster
    segment_sum on the forward apply)."""

    _sorted_rows = True


class ELLOperator(_SparseBase):
    """ELLPACK operator: forward apply is gather + per-row sum — NO scatter
    (``(vals · x[cols]).sum(1)``). Every row is padded to the longest one.
    Transpose scatters (segment_sum over the column ids)."""

    def _prod(self, v):
        d = self.data
        return jnp.sum(d.vals * v[d.cols], axis=1)

    def _tprod_vals(self, vals, u):
        d = self.data
        contrib = (vals * u[:, None]).reshape(-1)
        return jax.ops.segment_sum(
            contrib, d.cols.reshape(-1), num_segments=d.shape[1]
        )

    def _tprod(self, u):
        return self._tprod_vals(self.data.vals, u)

    def _ctprod(self, w):
        return self._tprod_vals(_conj(self.data.vals), w)

    def apply_matrix(self, M, mode: str = "N"):
        self._check_mat(M, mode)
        d = self.data
        if mode == "N":
            return jnp.sum(d.vals[:, :, None] * M[d.cols], axis=1)
        if mode == "C":
            return _conj(
                jnp.sum(d.vals[:, :, None] * _conj(M)[d.cols], axis=1)
            )
        vals = d.vals if mode == "T" else _conj(d.vals)
        contrib = (vals[:, :, None] * M[:, None, :]).reshape(-1, M.shape[1])
        return jax.ops.segment_sum(
            contrib, d.cols.reshape(-1), num_segments=d.shape[1]
        )


class RoutedCSROperator(CSROperator):
    """CSR operator whose applies run through the Clos-routed pipeline
    (sparse/routed.py: fixed sequences of gathers and transposes) instead
    of gather+segment_sum.

    Storage: the plain CSR pytree (densification reuses it) plus the packed
    forward routing program.
    The transpose program is DERIVED from the forward pack at construction
    (sparse/routed.py::RoutedTranspose — the inverse network, no second
    router run, ~0.1× the forward pack cost), so ``op.T`` works at full
    speed immediately, including inside jit (reference contract:
    src/adjtrans.jl:32-44 — wrappers always work). ``backend="xla"``
    forces the inherited gather+segment_sum applies (A/B tests).

    When the derived program is unavailable (ReducePass-fallback combine
    layouts, extreme column skew) or ``defer_transpose=True``, the
    transpose falls back to a lazy full CSC re-pack at HOST dispatch
    (``bump``); code that first reaches a T/H apply only INSIDE its own
    jit then sees the slow CSR fallback for that trace and a one-time
    warning naming the fix (``op._ensure_transpose()``).
    """

    _fields_children = ("data", "routed", "routed_t")
    _fields_aux = ("_symmetric", "_hermitian", "_backend", "_w", "_defer_t")

    def __init__(self, data, symmetric=False, hermitian=False,
                 routed=None, routed_t=None, w="auto", backend="auto",
                 defer_transpose=False, host_parts=None):
        super().__init__(data, symmetric, hermitian)
        if backend not in ("auto", "routed", "xla"):
            raise ValueError(f"unknown routed backend {backend!r}")
        self._backend = backend
        self._w = w
        self._defer_t = bool(defer_transpose)
        self.routed = routed
        self.routed_t = routed_t
        # ``host_parts`` = (vals, cols, indptr) as HOST arrays: packing
        # needs host data, and fetching the just-uploaded device copies
        # back is a pure round trip (opSparse passes the scipy arrays
        # through). Transient: dropped after construction, not part of the
        # pytree.
        self._host_parts = host_parts
        try:
            if routed is None and backend != "xla":
                want_t = (routed_t is None and not defer_transpose
                          and not (symmetric or hermitian))
                packed = self._pack(transpose=False, with_transpose=want_t)
                if want_t:
                    self.routed, derived = packed
                    if derived is not None:
                        self.routed_t = derived
                else:
                    self.routed = packed
        finally:
            self._host_parts = None

    def _host_csr(self):
        hp = getattr(self, "_host_parts", None)
        if hp is not None:
            v, c, i = hp
            return np.asarray(v), np.asarray(c), np.asarray(i)
        d = self.data
        # one batched fetch (single transfer) instead of three np.asarray
        return jax.device_get((d.vals, d.cols, d.indptr))

    def _pack(self, transpose: bool, with_transpose: bool = False):
        from .routed import pack_routed_csr

        d = self.data
        vals, cols, indptr = self._host_csr()
        if not transpose:
            return pack_routed_csr(
                vals, cols, indptr, d.shape, w=self._w,
                with_transpose=with_transpose)
        # transpose pack: re-sort by (col, row) — a stable CSC build
        # (row ids derived from indptr host-side; d.rows stays on device)
        rows = cols
        cols = np.repeat(np.arange(d.shape[0], dtype=np.int64),
                         np.diff(indptr))
        shp = (d.shape[1], d.shape[0])
        order = np.argsort(rows, kind="stable")
        indptr = np.zeros(shp[0] + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=shp[0]), out=indptr[1:])
        return pack_routed_csr(vals[order], cols[order], indptr, shp, w=self._w)

    def _use_routed(self):
        return self._backend != "xla"

    def _ensure_transpose(self):
        if self.routed_t is None and self._use_routed():
            if isinstance(self.data.vals, jax.core.Tracer):
                # tracer guard: a traced reconstruction of this operator can
                # reach bump/apply inside someone's jit — packing needs
                # concrete arrays, so that trace keeps the CSR fallback
                import warnings

                warnings.warn(
                    "RoutedCSROperator transpose apply reached inside a jit "
                    "trace before any transpose program existed — this "
                    "trace uses the gather+segment_sum CSR fallback. Construct "
                    "the operator with defer_transpose=False (default) or "
                    "call op._ensure_transpose() before jitting.",
                    stacklevel=3)
                return
            self.routed_t = self._pack(transpose=True)

    def bump(self, mode: str, n: int = 1):
        # the transpose routing program must exist BEFORE jit dispatch
        # (packing is host-side; a None->pytree swap changes the operator's
        # structure, so it cannot happen at trace time). ``bump`` is the
        # host-side pre-dispatch walk that reaches every node with its
        # effective mode (wrappers/composites cross-map, core/adjoint.py).
        if mode in ("T", "H") and not (self._symmetric or self._hermitian):
            # mode "C" is served by the FORWARD program (conj∘prod∘conj)
            self._ensure_transpose()
        super().bump(mode, n)

    def _prod(self, v):
        if not self._use_routed() or self.routed is None:
            return super()._prod(v)
        from .routed import routed_matvec

        return routed_matvec(self.routed, v)

    def _tprod_routed(self, u, conj_vals):
        if not self._use_routed() or self.routed_t is None:
            if (self._use_routed()
                    and isinstance(self.data.vals, jax.core.Tracer)
                    and not (self._symmetric or self._hermitian)):
                # in-jit T/H apply with no transpose program: this trace
                # gets the slow CSR fallback — tell the user how to fix it
                import warnings

                warnings.warn(
                    "RoutedCSROperator transpose apply traced with no "
                    "transpose program — this jit uses the "
                    "gather+segment_sum CSR fallback. Construct with defer_transpose=False "
                    "(default) or call op._ensure_transpose() before "
                    "jitting.", stacklevel=3)
            return super()._ctprod(u) if conj_vals else super()._tprod(u)
        from .routed import RoutedTranspose, routed_matvec, routed_rmatvec

        rt = self.routed_t
        if isinstance(rt, RoutedTranspose):
            if conj_vals and jnp.iscomplexobj(rt.vals_pre):
                rt = rt._replace(vals_pre=jnp.conj(rt.vals_pre))
            return routed_rmatvec(rt, u)
        if conj_vals and jnp.iscomplexobj(rt.vals):
            rt = rt._replace(vals=jnp.conj(rt.vals))
        return routed_matvec(rt, u)

    def _tprod(self, u):
        return self._tprod_routed(u, conj_vals=False)

    def _ctprod(self, w):
        return self._tprod_routed(w, conj_vals=True)

    def _matrix_prog(self, mode: str):
        """(prog, conj_vals, conj_io) for a matrix apply in ``mode`` —
        symmetric/hermitian operators serve T/H with the FORWARD program
        (bump never packs routed_t for them)."""
        return {
            "N": (self.routed, False, False),
            "C": (self.routed, False, True),
            "T": ((self.routed, False, False) if self._symmetric
                  else (self.routed_t, False, False)),
            "H": ((self.routed, False, False) if self._hermitian
                  else (self.routed_t, True, False)),
        }[mode]

    def _routed_apply_matrix(self, M, mode: str, panel: bool):
        # Shared prog/conj dispatch for apply_matrix / apply_matrix_t.
        # Returns None when no routing program exists for ``mode`` (the
        # caller falls back to the CSR base paths).
        if not self._use_routed():
            return None
        from .routed import (RoutedTranspose, routed_matmat,
                             routed_rmatmat)

        prog, conj_vals, conj_io = self._matrix_prog(mode)
        if prog is None:
            return None
        apply_fn = routed_matmat
        if isinstance(prog, RoutedTranspose):
            apply_fn = routed_rmatmat
            if conj_vals and jnp.iscomplexobj(prog.vals_pre):
                prog = prog._replace(vals_pre=jnp.conj(prog.vals_pre))
        elif conj_vals and jnp.iscomplexobj(prog.vals):
            prog = prog._replace(vals=jnp.conj(prog.vals))
        X = _conj(M) if conj_io else M
        # all k columns share ONE routing program
        Y = apply_fn(prog, X, panel=panel)
        return _conj(Y) if conj_io else Y

    def apply_matrix(self, M, mode: str = "N"):
        self._check_mat(M, mode)
        Y = self._routed_apply_matrix(M, mode, panel=False)
        return Y if Y is not None else super().apply_matrix(M, mode)

    def apply_matrix_t(self, Mt, mode: str = "N"):
        # Row-panel apply (base.py::apply_matrix_t): (k, n) in, (k, m)
        # out — the routed pipeline is column-outer on both ends, so the
        # panel layout needs no boundary relayouts.
        Mt = jnp.asarray(Mt)  # normalize first, matching matmat()
        if Mt.ndim != 2 or Mt.shape[1] != self.in_dim(mode):
            raise LinearOperatorException("shape mismatch")
        Y = self._routed_apply_matrix(Mt, mode, panel=True)
        return Y if Y is not None else super().apply_matrix_t(Mt, mode)


class BSROperator(_SparseBase):
    """Block-sparse-row operator: the forward apply gathers ``x`` by block
    column and contracts it with the blocks in one batched einsum; the
    transpose scatters blockᵀ·u with one segment sum."""

    def _pad_in(self, v, dim_blocks, bsize):
        need = dim_blocks * bsize
        if v.shape[0] < need:
            v = jnp.pad(v, (0, need - v.shape[0]))
        return v

    def _prod(self, v):
        d = self.data
        bm, bn = d.block_shape
        nbrow = d.blocks.shape[0]
        nbcol = -(-d.shape[1] // bn)
        xb = self._pad_in(v, nbcol, bn).reshape(nbcol, bn)
        y = bsr_matvec(d.blocks, d.block_cols, xb).reshape(nbrow * bm)
        return y[: d.shape[0]]

    def _tprod_impl(self, blocks, u):
        d = self.data
        bm, bn = d.block_shape
        nbrow = blocks.shape[0]
        nbcol = -(-d.shape[1] // bn)
        ub = self._pad_in(u, nbrow, bm).reshape(nbrow, bm)
        x = bsr_rmatvec(blocks, d.block_cols, ub, nbcol).reshape(nbcol * bn)
        return x[: d.shape[1]]

    def _tprod(self, u):
        return self._tprod_impl(self.data.blocks, u)

    def _ctprod(self, w):
        if not jnp.iscomplexobj(self.data.blocks):
            return self._tprod(w)
        return self._tprod_impl(jnp.conj(self.data.blocks), w)

    def apply_matrix(self, M, mode: str = "N"):
        self._check_mat(M, mode)
        if mode != "N":
            return super().apply_matrix(M, mode)
        d = self.data
        bm, bn = d.block_shape
        nbrow = d.blocks.shape[0]
        nbcol = -(-d.shape[1] // bn)
        k = M.shape[1]
        need = nbcol * bn
        if M.shape[0] < need:
            M = jnp.pad(M, ((0, need - M.shape[0]), (0, 0)))
        Xb = M.reshape(nbcol, bn, k)
        Y = bsr_matmat(d.blocks, d.block_cols, Xb).reshape(nbrow * bm, k)
        return Y[: d.shape[0]]


for _cls in (COOOperator, CSROperator, ELLOperator, BSROperator,
             RoutedCSROperator):
    register_operator(_cls)


# ----------------------------------------------------------------------------
# Factory
# ----------------------------------------------------------------------------


# largest tile first: on equal stored bytes the bigger tile streams a
# little faster (H100: 93 vs 97 µs per 256 MiB of float32 blocks, 128×128
# vs 8×128)
_BSR_AUTO_CANDIDATES = ((128, 128), (32, 128), (16, 128), (8, 128))

def _auto_block_shape(sp, return_stored: bool = False):
    """Pick the BSR block shape storing the fewest padded bytes (counted by
    the native block counter); ties go to the larger tile."""
    from ..native import _load

    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (g++ build failed)")
    cols = np.ascontiguousarray(sp.indices, np.int32)
    indptr = np.ascontiguousarray(sp.indptr, np.int32)
    nrow = sp.shape[0]
    best, best_stored = None, None
    for bm, bn in _BSR_AUTO_CANDIDATES:
        nbrow = -(-nrow // bm)
        counts = np.zeros(nbrow, np.int32)
        kmax = max(int(lib.bsr_count(cols, indptr, nrow, bm, bn, counts)), 1)
        stored = nbrow * kmax * bm * bn  # uniform-kmax padded layout
        if best_stored is None or stored < best_stored:
            best, best_stored = (bm, bn), stored
    if return_stored:
        return best, best_stored
    return best


def opSparse(
    A,
    format: str = "csr",
    block_shape: Union[Tuple[int, int], str] = (8, 128),
    symmetric: bool = False,
    hermitian: bool = False,
    tol: float = 0.0,
    dtype=None,
    w="auto",
    reorder=None,
):
    """Build a sparse operator from a dense array, a scipy sparse matrix, or
    a prebuilt COO/CSR/BSR/ELL pytree. ``format`` in {'coo', 'csr', 'bsr',
    'ell', 'routed', 'auto'}; ``block_shape="auto"`` picks the BSR tile
    minimizing stored bytes; ``format="auto"`` packs a pattern to BSR when
    its padded blocks store fewer bytes than CSR does, and to CSR
    otherwise. 'routed' is the Clos-routed pipeline (sparse/routed.py —
    ``w`` selects the row-slot width). ``dtype`` selects the stored value
    dtype (e.g. ``jnp.bfloat16`` — scipy can't carry bf16, so the cast
    happens at device upload). ``reorder="rcm"`` (square matrices) applies
    a reverse-Cuthill–McKee similarity permutation FIRST and returns
    ``Pᵀ·op(A[perm][:,perm])·P`` (sparse/reorder.py), so a scrambled but
    bandable pattern can pack to BSR.
    """
    if reorder is not None:
        if reorder != "rcm":
            raise ValueError(f"unknown reorder {reorder!r} (only 'rcm')")
        from .reorder import rcm_reordered_operator

        if not hasattr(A, "tocsr"):
            import scipy.sparse as sps

            if isinstance(A, (COO, CSR, ELL, BSR)):
                raise LinearOperatorException(
                    "reorder='rcm' takes a scipy sparse matrix or a dense "
                    "array (the permutation is computed on the host)")
            Ad = np.asarray(A)
            if tol > 0:
                Ad = np.where(np.abs(Ad) > tol, Ad, 0.0)
            A = sps.csr_matrix(Ad)
        return rcm_reordered_operator(A.tocsr(), dict(
            format=format, block_shape=block_shape, symmetric=symmetric,
            hermitian=hermitian, tol=tol, dtype=dtype, w=w))
    cast = (lambda a: jnp.asarray(a, dtype)) if dtype is not None else jnp.asarray
    if dtype is not None and isinstance(A, (COO, CSR, ELL, BSR)):
        if isinstance(A, BSR):
            A = BSR(jnp.asarray(A.blocks, dtype), A.block_cols, A.shape)
        else:
            A = A._replace(vals=jnp.asarray(A.vals, dtype))
    if isinstance(A, COO):
        return COOOperator(A, symmetric, hermitian)
    if isinstance(A, CSR):
        if format == "routed":
            return RoutedCSROperator(A, symmetric, hermitian, w=w)
        return CSROperator(A, symmetric, hermitian)
    if isinstance(A, ELL):
        return ELLOperator(A, symmetric, hermitian)
    if isinstance(A, BSR):
        return BSROperator(A, symmetric, hermitian)

    # dense input with format='auto': route through scipy when available
    if format == "auto" and not hasattr(A, "tocsr"):
        try:
            import scipy.sparse as sps

            Ad = np.asarray(A)
            if tol > 0:  # honor tol like every other dense path
                Ad = np.where(np.abs(Ad) > tol, Ad, 0.0)
            A = sps.csr_matrix(Ad)
        except ImportError:
            format = "csr"

    # scipy sparse?
    if hasattr(A, "tocsr"):
        sp = A.tocsr()
        if format == "auto":
            # BSR when its padded blocks store fewer bytes than CSR's
            # values + column and row ids; CSR otherwise
            shape_best, stored = _auto_block_shape(sp, return_stored=True)
            itemsize = jnp.dtype(dtype or sp.data.dtype).itemsize
            if stored * itemsize < sp.nnz * (itemsize + 8):
                format, block_shape = "bsr", shape_best
            else:
                format = "csr"
        if format == "csr":
            data = csr_from_parts(sp.data, sp.indices, sp.indptr, sp.shape)
            if dtype is not None:
                data = data._replace(vals=jnp.asarray(data.vals, dtype))
            return CSROperator(data, symmetric, hermitian)
        if format == "routed":
            data = csr_from_parts(sp.data, sp.indices, sp.indptr, sp.shape)
            if dtype is not None:
                data = data._replace(vals=jnp.asarray(data.vals, dtype))
            host_vals = (sp.data if dtype is None
                         else np.asarray(sp.data, dtype))
            return RoutedCSROperator(
                data, symmetric, hermitian, w=w,
                host_parts=(host_vals, sp.indices, sp.indptr))
        if format == "ell":
            data = ell_from_csr_parts(sp.data, sp.indices, sp.indptr, sp.shape)
            if dtype is not None:
                data = data._replace(vals=jnp.asarray(data.vals, dtype))
            return ELLOperator(data, symmetric, hermitian)
        if format == "coo":
            from .formats import check_int32_range

            sc = sp.tocoo()
            check_int32_range(sc.shape, sc.nnz)
            data = COO(
                vals=cast(sc.data),
                rows=jnp.asarray(sc.row, jnp.int32),
                cols=jnp.asarray(sc.col, jnp.int32),
                shape=tuple(sc.shape),
            )
            return COOOperator(data, symmetric, hermitian)
        if format == "bsr":
            if block_shape == "auto":
                block_shape = _auto_block_shape(sp)
            if sp.dtype in (np.float32, np.float64):
                # native packer (no dense copy); raises when it cannot be
                # built. Other value dtypes take the dense tiling below.
                from ..native import bsr_pack_csr

                blocks, bcols = bsr_pack_csr(
                    sp.data, sp.indices, sp.indptr, sp.shape[0], sp.shape[1],
                    block_shape)
                return BSROperator(
                    BSR(cast(blocks), jnp.asarray(bcols), tuple(sp.shape)),
                    symmetric, hermitian)
        A = sp.toarray()

    A = np.asarray(A)
    def _cast_vals(data):
        return data._replace(vals=jnp.asarray(data.vals, dtype)) if dtype is not None else data
    if format == "coo":
        return COOOperator(_cast_vals(coo_from_dense(A, tol)), symmetric, hermitian)
    if format == "csr":
        return CSROperator(_cast_vals(csr_from_dense(A, tol)), symmetric, hermitian)
    if format == "routed":
        return RoutedCSROperator(_cast_vals(csr_from_dense(A, tol)),
                                 symmetric, hermitian, w=w)
    if format == "ell":
        return ELLOperator(_cast_vals(ell_from_dense(A, tol)), symmetric, hermitian)
    if format == "bsr":
        if block_shape == "auto":
            try:
                import scipy.sparse as sps

                return opSparse(
                    sps.csr_matrix(A), format="bsr", block_shape="auto",
                    symmetric=symmetric, hermitian=hermitian, dtype=dtype,
                )
            except ImportError:
                block_shape = (8, 128)
        data = bsr_from_dense(A, block_shape, tol)
        if dtype is not None:
            data = BSR(jnp.asarray(data.blocks, dtype), data.block_cols, data.shape)
        return BSROperator(data, symmetric, hermitian)
    raise ValueError(f"unknown sparse format {format!r}")
