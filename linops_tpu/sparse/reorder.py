"""Bandwidth-reducing reordering: ``opSparse(..., reorder="rcm")``.

Many "unstructured" matrices are bandable: a reverse-Cuthill–McKee
permutation of the symmetrized pattern concentrates the nonzeros near the
diagonal, where dense-ish bands pack into BSR blocks.

``ReorderedOperator`` is the sandwich ``A = Pᵀ · A_r · P`` where
``A_r = A[perm][:, perm]`` (the RCM-reordered matrix, built as a normal
sparse operator — BSR when the band structure allows) and ``P`` is a
``PermutationOperator`` (``(P x)[i] = x[perm[i]]``). Every mode is the
same sandwich with the inner mode pushed through (P is real and
orthogonal):

    A  x = Pᵀ A_r  P x      Aᵀ u = Pᵀ A_rᵀ P u      Aᴴ w = Pᵀ A_rᴴ P w

so symmetry/hermitianness of the inner operator transfer verbatim.

The reference has no reordering layer — it wraps whatever sparse matrix
it is given (reference: src/constructors.jl:15-29); RCM there is the
user's job via AMD/CUTHILLMCKEE packages. Here it is one keyword.
"""
from __future__ import annotations

import numpy as np

from ..core.base import LinearOperator, LinearOperatorException, register_operator

__all__ = ["ReorderedOperator", "rcm_reordered_operator"]


class ReorderedOperator(LinearOperator):
    """``Pᵀ · inner · P`` with a permutation P (module docstring).

    Flags, dtype, and shape proxy the inner operator: ``Pᵀ S P`` is
    symmetric/hermitian exactly when ``S`` is.
    """

    _fields_children = ("inner", "P")
    _fields_aux = ()

    def __init__(self, inner, P):
        super().__init__()
        if inner.nrow != inner.ncol or inner.nrow != P.nrow:
            raise LinearOperatorException(
                "ReorderedOperator requires a square inner operator matching "
                f"the permutation size (got {inner.shape} vs {P.nrow})")
        self.inner = inner
        self.P = P

    @property
    def nrow(self):
        return self.inner.nrow

    ncol = nrow

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def symmetric(self):
        return self.inner.symmetric

    @property
    def hermitian(self):
        return self.inner.hermitian

    def _sandwich(self, v, mode):
        z = self.P.apply(v, "N")
        z = self.inner.apply(z, mode)
        return self.P.apply(z, "T")

    def _prod(self, v):
        return self._sandwich(v, "N")

    def _tprod(self, u):
        return self._sandwich(u, "T")

    def _ctprod(self, w):
        return self._sandwich(w, "H")

    def _check_mat(self, M, mode: str, axis: int):
        import jax.numpy as jnp

        M = jnp.asarray(M)
        if M.ndim != 2 or M.shape[axis] != self.nrow:
            raise LinearOperatorException("shape mismatch")
        return M

    def apply_matrix(self, M, mode: str = "N"):
        # P on a matrix is an XLA whole-row gather (PermutationOperator
        # .apply_matrix) — cheap for wide RHS; the inner operator runs its
        # own matrix path (BSR multi-RHS einsum etc.)
        M = self._check_mat(M, mode, axis=0)
        Z = self.P.apply_matrix(M, "N")
        Z = self.inner.apply_matrix(Z, mode)
        return self.P.apply_matrix(Z, "T")

    def apply_matrix_t(self, Mt, mode: str = "N"):
        # row-panel protocol: the permutation acts along axis 1 of the
        # (k, n) panel. A direct jnp.take(Mt, perm, axis=1) gathers
        # strided (k, 1) lane slices — the fine-grained-gather class this
        # framework avoids — so route through the axis-0 whole-row gather
        # on the transposed panel instead; the bracketing transposes are
        # packed XLA relayouts that fuse with adjacent panel matmuls.
        Mt = self._check_mat(Mt, mode, axis=1)
        Z = self.P.apply_matrix(Mt.T, "N").T
        Z = self.inner.apply_matrix_t(Z, mode)
        return self.P.apply_matrix(Z.T, "T").T

    def _bump_children(self, mode: str, n: int = 1):
        # every mode's sandwich applies P in BOTH directions (P in, Pᵀ
        # out) around the inner apply
        self.inner.bump(mode, n)
        self.P.bump("N", n)
        self.P.bump("T", n)

    def _name(self):
        return f"Reordered operator (RCM → {self.inner._name()})"


register_operator(ReorderedOperator)


def rcm_reordered_operator(sp, opsparse_kwargs: dict):
    """Build ``ReorderedOperator`` from a scipy CSR matrix: RCM on the
    symmetrized pattern → reorder → inner operator via ``opSparse`` →
    permutation sandwich. Called by ``opSparse(reorder="rcm")``.
    """
    import scipy.sparse as sps

    from ..native import rcm_permutation
    from ..ops.permutation import opPermutation
    from .ops import opSparse

    n = sp.shape[0]
    if sp.shape[0] != sp.shape[1]:
        raise LinearOperatorException(
            "reorder='rcm' requires a square matrix (similarity "
            f"permutation PᵀAP); got {sp.shape}")
    # symmetrized PATTERN (RCM walks an undirected adjacency)
    pat = sps.csr_matrix(
        (np.ones(sp.nnz, np.int8), sp.indices, sp.indptr), shape=sp.shape)
    pat = (pat + pat.T).tocsr()
    perm = rcm_permutation(pat.indices.astype(np.int32),
                           pat.indptr.astype(np.int32), n)
    A_r = sp[perm][:, perm].tocsr()
    inner = opSparse(A_r, **opsparse_kwargs)
    P = opPermutation(perm)
    # ReorderedOperator.__init__ pre-packs P's inverse routing program
    return ReorderedOperator(inner, P)
