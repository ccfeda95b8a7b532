"""DIA (diagonal-offset) sparse operator — the banded format.

No reference counterpart (SparseMatrixCSC covers bands generically); here
a banded/stencil matrix is stored as its diagonals: the apply is a sum of
elementwise products against statically-shifted views of x — streaming
with ZERO gathers or indices, fully fused by XLA. This is the
single-chip analogue of the halo-partitioned operator (parallel/halo.py),
and the natural format for 5/9-point Laplacians.

Convention: for offset o, ``diags[i, r] = A[r, r+o]`` (zero where out of
range), so ``(A x)[r] = Σ_i diags[i, r] · x[r + offsets[i]]``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ..core.base import LinearOperator, LinearOperatorException, register_operator

__all__ = ["DIAOperator", "opDIA", "dia_from_dense", "laplacian_1d", "laplacian_2d"]


class DIAOperator(LinearOperator):
    """Square operator stored as (k, n) diagonals with static offsets."""

    _fields_children = ("diags",)
    _fields_aux = ("_offsets", "_symmetric", "_hermitian")

    def __init__(self, diags, offsets: Sequence[int], *, symmetric: bool = False,
                 hermitian: bool = False):
        super().__init__()
        diags = jnp.asarray(diags)
        if diags.ndim != 2 or len(offsets) != diags.shape[0]:
            raise LinearOperatorException("diags must be (k, n) with k offsets")
        self.diags = diags
        self._offsets = tuple(int(o) for o in offsets)
        self._symmetric = bool(symmetric)
        self._hermitian = bool(hermitian)

    @property
    def nrow(self):
        return self.diags.shape[1]

    @property
    def ncol(self):
        return self.diags.shape[1]

    @property
    def dtype(self):
        return self.diags.dtype

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return self._hermitian

    @property
    def offsets(self) -> Tuple[int, ...]:
        return self._offsets

    @property
    def _max_off(self) -> int:
        return max(max(self._offsets), -min(self._offsets), 0)

    def _shift(self, x, o: int):
        """x[r + o] with zero fill — static pad + slice, fused by XLA."""
        if o == 0:
            return x
        if o > 0:
            return jnp.pad(x[o:], (0, o))
        return jnp.pad(x[:o], (-o, 0))

    def _prod(self, v):
        # pad once, take static slices, one fused multiply-sum (one padded
        # buffer shared by every term)
        mo = self._max_off
        n = self.nrow
        xp = jnp.pad(v, (mo, mo))
        shifts = jnp.stack([xp[mo + o : mo + o + n] for o in self._offsets])
        return jnp.sum(self.diags * shifts, axis=0)

    def _tprod_impl(self, u, diags):
        # (Aᵀu)[c] = Σ_i shift(diags_i ⊙ u, −o_i): write every shifted term
        # into one shared padded buffer, then slice — the same
        # one-pad/stacked structure as _prod (its measured-faster form).
        mo = self._max_off
        n = self.ncol
        prods = diags * u[None, :]
        acc = jnp.zeros((n + 2 * mo,), u.dtype)
        for i, o in enumerate(self._offsets):
            acc = acc.at[mo + o : mo + o + n].add(prods[i])
        return acc[mo : mo + n]

    def _tprod(self, u):
        return self._tprod_impl(u, self.diags)

    def _ctprod(self, w):
        if not jnp.iscomplexobj(self.diags):
            return self._tprod(w)
        return self._tprod_impl(w, jnp.conj(self.diags))

    def apply_matrix(self, M, mode: str = "N"):
        if mode in ("N",):
            Y = jnp.zeros_like(M, shape=(self.nrow, M.shape[1]))
            for i, o in enumerate(self._offsets):
                if o == 0:
                    shifted = M
                elif o > 0:
                    shifted = jnp.pad(M[o:], ((0, o), (0, 0)))
                else:
                    shifted = jnp.pad(M[:o], ((-o, 0), (0, 0)))
                Y = Y + self.diags[i][:, None] * shifted
            return Y
        return super().apply_matrix(M, mode)

    def apply_matrix_t(self, Mt, mode: str = "N"):
        # native row-panel apply: shifts move along the LANE axis of the
        # dense (k, n) panel — no transposes, no padded-minor-dim traffic
        # (the shift structure is identical to _prod, vectorized over rows)
        if mode != "N":
            return super().apply_matrix_t(Mt, mode)
        mo = self._max_off
        n = self.nrow
        Xp = jnp.pad(Mt, ((0, 0), (mo, mo)))
        Y = jnp.zeros_like(Mt)
        for i, o in enumerate(self._offsets):
            Y = Y + self.diags[i][None, :] * Xp[:, mo + o: mo + o + n]
        return Y

    @property
    def nnz(self):
        return int(jnp.sum(self.diags != 0))

    def _name(self):
        return f"DIA operator ({len(self._offsets)} diagonals)"


register_operator(DIAOperator)


def opDIA(diags, offsets, **kw) -> DIAOperator:
    return DIAOperator(diags, offsets, **kw)


def dia_from_dense(A, tol: float = 0.0) -> DIAOperator:
    """Extract the nonzero diagonals of a square dense matrix."""
    A = np.asarray(A)
    n = A.shape[0]
    if A.shape[0] != A.shape[1]:
        raise LinearOperatorException("DIA requires a square matrix")
    offsets = []
    rows = []
    for o in range(-(n - 1), n):
        d = np.diagonal(A, o)
        if np.any(np.abs(d) > tol):
            offsets.append(o)
            row = np.zeros(n, A.dtype)
            if o >= 0:
                row[: n - o] = d  # diag_o[r] = A[r, r+o], valid r < n-o
            else:
                row[-o:] = d  # valid r >= -o
            rows.append(row)
    sym = bool(np.allclose(A, A.T))
    return DIAOperator(jnp.asarray(np.stack(rows) if rows else np.zeros((1, n), A.dtype)),
                       offsets or [0], symmetric=sym, hermitian=sym and np.isrealobj(A))


def laplacian_1d(n: int, dtype=jnp.float32) -> DIAOperator:
    """Tridiagonal [-1, 2, -1] operator."""
    main = jnp.full((n,), 2.0, dtype)
    off = jnp.full((n,), -1.0, dtype)
    up = off.at[n - 1].set(0.0)
    lo_ = off.at[0].set(0.0)
    return DIAOperator(jnp.stack([lo_, main, up]), (-1, 0, 1),
                       symmetric=True, hermitian=True)


def laplacian_2d(nx: int, ny: int, dtype=jnp.float32):
    """5-point Laplacian on an nx × ny grid (row-major), n = nx·ny.

    Returns a ``Stencil2DOperator`` (grid-layout shifts);
    ``laplacian_2d_dia`` keeps the DIA representation."""
    from .stencil import Stencil2DOperator

    offsets = [(-1, 0), (0, -1), (0, 0), (0, 1), (1, 0)]
    coeffs = jnp.asarray([-1.0, -1.0, 4.0, -1.0, -1.0], dtype)
    return Stencil2DOperator(nx, ny, offsets, coeffs)


def laplacian_2d_dia(nx: int, ny: int, dtype=jnp.float32) -> DIAOperator:
    """5-point Laplacian in DIA form (flattened diagonals)."""
    n = nx * ny
    main = jnp.full((n,), 4.0, dtype)
    ew = np.full(n, -1.0, dtype=np.dtype(dtype))
    ew[ny - 1 :: ny] = 0.0  # no east coupling at row ends
    east = jnp.asarray(np.concatenate([ew[: n - 1], [0.0]]).astype(np.dtype(dtype)))
    west = jnp.asarray(np.concatenate([[0.0], ew[: n - 1]]).astype(np.dtype(dtype)))
    ns = jnp.full((n,), -1.0, dtype)
    north = ns.at[n - ny :].set(0.0)
    south = ns.at[:ny].set(0.0)
    return DIAOperator(
        jnp.stack([south, west, main, east, north]),
        (-ny, -1, 0, 1, ny),
        symmetric=True,
        hermitian=True,
    )
