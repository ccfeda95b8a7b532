"""Sparse storage formats as device pytrees: COO, CSR, BSR.

New first-class component (SURVEY.md §2.3 'Sparse storage formats') — the
reference delegates sparsity entirely to ``SparseArrays.SparseMatrixCSC``
behind closures (reference: src/constructors.jl:25-27); here the library
owns the storage layout:

- **COO / CSR** carry an explicit per-nnz ``rows`` vector (CSR keeps
  ``indptr`` too), so SpMV lowers to gather + ``segment_sum`` — one fused
  XLA computation, no host loops.
- **BSR** (block sparse rows): dense ``(bm, bn)`` blocks (8×128 and up),
  so SpMV is a batched dense contraction with only block-level
  indexing. Rows of blocks are padded to a uniform count with zero blocks
  pointing at block-column 0 (padding contributes exactly 0), keeping all
  shapes static for XLA (SURVEY.md §7 hard part 4).

- **ELL** pads every row to a uniform slot count so forward SpMV is
  gather + row-sum with no scatter.

All four are registered pytrees → shardable, donatable, checkpointable.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "COO",
    "CSR",
    "BSR",
    "coo_from_dense",
    "csr_from_dense",
    "bsr_from_dense",
    "check_int32_range",
    "ELL",
    "ell_from_csr_parts",
    "ell_from_dense",
]


class COO(NamedTuple):
    """Coordinate format. ``vals[k] = A[rows[k], cols[k]]``."""

    vals: jax.Array  # (nnz,)
    rows: jax.Array  # (nnz,) int32
    cols: jax.Array  # (nnz,) int32
    shape: Tuple[int, int]  # static

    @property
    def nnz(self) -> int:
        return self.vals.shape[0]


class CSR(NamedTuple):
    """Compressed sparse rows. Keeps a materialized ``rows`` vector so the
    apply is gather/segment-sum (no data-dependent loops under jit)."""

    vals: jax.Array  # (nnz,)
    cols: jax.Array  # (nnz,) int32
    indptr: jax.Array  # (nrow+1,) int32
    rows: jax.Array  # (nnz,) int32 — expanded from indptr at build time
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.vals.shape[0]


class BSR(NamedTuple):
    """Block sparse rows with a *uniform* number of blocks per block-row
    (padded). ``blocks[i, j]`` is the dense (bm, bn) block at block-row i,
    block-column ``block_cols[i, j]``; padded entries are zero blocks."""

    blocks: jax.Array  # (nbrow, kmax, bm, bn)
    block_cols: jax.Array  # (nbrow, kmax) int32
    shape: Tuple[int, int]  # logical (possibly unpadded) shape

    @property
    def block_shape(self) -> Tuple[int, int]:
        return (self.blocks.shape[2], self.blocks.shape[3])

    @property
    def padded_shape(self) -> Tuple[int, int]:
        bn = self.blocks.shape[3]
        return (
            self.blocks.shape[0] * self.blocks.shape[2],
            -(-self.shape[1] // bn) * bn,
        )


# pytree registration: `shape` is static aux data
def _register(cls, static_fields):
    dyn = [f for f in cls._fields if f not in static_fields]

    def flatten(x):
        return tuple(getattr(x, f) for f in dyn), tuple(
            getattr(x, f) for f in static_fields
        )

    def unflatten(aux, children):
        kw = dict(zip(dyn, children))
        kw.update(dict(zip(static_fields, aux)))
        return cls(**kw)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)


_register(COO, ("shape",))
_register(CSR, ("shape",))
_register(BSR, ("shape",))


# ----------------------------------------------------------------------------
# Builders (host-side, numpy)
# ----------------------------------------------------------------------------


def coo_from_dense(A, tol: float = 0.0) -> COO:
    A = np.asarray(A)
    rows, cols = np.nonzero(np.abs(A) > tol) if tol > 0 else np.nonzero(A)
    vals = A[rows, cols]
    return COO(
        vals=jnp.asarray(vals),
        rows=jnp.asarray(rows, jnp.int32),
        cols=jnp.asarray(cols, jnp.int32),
        shape=A.shape,
    )


def csr_from_dense(A, tol: float = 0.0) -> CSR:
    A = np.asarray(A)
    nrow = A.shape[0]
    rows, cols = np.nonzero(np.abs(A) > tol) if tol > 0 else np.nonzero(A)
    vals = A[rows, cols]
    counts = np.bincount(rows, minlength=nrow)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return CSR(
        vals=jnp.asarray(vals),
        cols=jnp.asarray(cols, jnp.int32),
        indptr=jnp.asarray(indptr, jnp.int32),
        rows=jnp.asarray(rows, jnp.int32),
        shape=A.shape,
    )


_I32_MAX = np.iinfo(np.int32).max


def check_int32_range(shape, nnz: int) -> None:
    """Device index arrays are int32; dims/nnz beyond 2^31-1 would silently
    wrap and corrupt gathers (same contract as the native packer's
    ``_check_int32``)."""
    if max(int(shape[0]), int(shape[1]), int(nnz)) > _I32_MAX:
        raise OverflowError(
            f"sparse dims/nnz {tuple(shape)}/{nnz} exceed int32 range "
            "(2^31-1); int64 sparse indexing is not supported on device"
        )


def csr_from_parts(vals, cols, indptr, shape) -> CSR:
    """Build from standard CSR arrays (e.g. scipy.sparse.csr_matrix parts)."""
    indptr_np = np.asarray(indptr)
    check_int32_range(shape, len(np.asarray(vals)))
    counts = np.diff(indptr_np)
    rows = np.repeat(np.arange(len(counts)), counts)
    return CSR(
        vals=jnp.asarray(vals),
        cols=jnp.asarray(cols, jnp.int32),
        indptr=jnp.asarray(indptr_np, jnp.int32),
        rows=jnp.asarray(rows, jnp.int32),
        shape=tuple(shape),
    )


def bsr_from_dense(A, block_shape: Tuple[int, int] = (8, 128), tol: float = 0.0) -> BSR:
    """Tile A into (bm, bn) blocks, keep nonzero blocks, pad each block-row
    to the max block count. Logical shape is preserved; the padded tail is
    zero-filled."""
    A = np.asarray(A)
    nrow, ncol = A.shape
    bm, bn = block_shape
    nbrow = -(-nrow // bm)
    nbcol = -(-ncol // bn)
    Ap = np.zeros((nbrow * bm, nbcol * bn), dtype=A.dtype)
    Ap[:nrow, :ncol] = A

    tiles = Ap.reshape(nbrow, bm, nbcol, bn).transpose(0, 2, 1, 3)  # (nbrow, nbcol, bm, bn)
    nz_mask = (np.abs(tiles) > tol).any(axis=(2, 3))

    kmax = max(int(nz_mask.sum(axis=1).max()), 1)
    blocks = np.zeros((nbrow, kmax, bm, bn), dtype=A.dtype)
    block_cols = np.zeros((nbrow, kmax), dtype=np.int32)
    for i in range(nbrow):
        js = np.nonzero(nz_mask[i])[0]
        blocks[i, : len(js)] = tiles[i, js]
        block_cols[i, : len(js)] = js
    return BSR(
        blocks=jnp.asarray(blocks),
        block_cols=jnp.asarray(block_cols),
        shape=(nrow, ncol),
    )


class ELL(NamedTuple):
    """ELLPACK: every row padded to a uniform ``kmax`` slots. Forward SpMV
    is gather + row-sum with NO scatter (``(vals · x[cols]).sum(1)``).
    Padding slots carry ``col=0, val=0`` and contribute exactly zero."""

    vals: jax.Array  # (nrow, kmax)
    cols: jax.Array  # (nrow, kmax) int32
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        """Stored (padded) entry count."""
        return self.vals.size


_register(ELL, ("shape",))


def ell_from_csr_parts(vals, cols, indptr, shape) -> ELL:
    """Pack CSR arrays into ELL (pad every row to the max row degree)."""
    vals = np.asarray(vals)
    cols_np = np.asarray(cols)
    indptr_np = np.asarray(indptr)
    check_int32_range(shape, len(vals))
    counts = np.diff(indptr_np)
    nrow = len(counts)
    kmax = max(int(counts.max()) if nrow else 0, 1)
    out_v = np.zeros((nrow, kmax), vals.dtype)
    out_c = np.zeros((nrow, kmax), np.int32)
    # vectorized ragged->padded: position of each nnz within its row
    pos = np.arange(len(vals)) - np.repeat(indptr_np[:-1], counts)
    rows = np.repeat(np.arange(nrow), counts)
    out_v[rows, pos] = vals
    out_c[rows, pos] = cols_np
    return ELL(vals=jnp.asarray(out_v), cols=jnp.asarray(out_c), shape=tuple(shape))


def ell_from_dense(A, tol: float = 0.0) -> ELL:
    A = np.asarray(A)
    c = csr_from_dense(A, tol)
    return ell_from_csr_parts(
        np.asarray(c.vals), np.asarray(c.cols), np.asarray(c.indptr), A.shape
    )
