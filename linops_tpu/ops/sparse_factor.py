"""Sparse factorization operators (host-resident solves).

Reference counterpart: the LDLFactorizations extension — ``opLDL`` on a
sparse matrix factors once with a *CPU* sparse solver and every apply is a
CPU triangular solve (reference: ext/LinearOperatorsLDLFactorizationsExt.jl:5-36).
Here the story is the same shape: sparse direct factorization is inherently
sequential pointer-chasing, so the factorization and solves stay on host
(scipy SuperLU) and enter the jitted graph through ``jax.pure_callback``.
For device-resident solves use ``opCholesky`` on a dense matrix, or iterate
with ``cg`` + a quasi-Newton/diagonal preconditioner.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.base import LinearOperator, LinearOperatorException, register_operator

__all__ = ["SparseInverseOperator", "opSparseInverse", "opSparseLDL"]


class _FactorToken:
    """Identity-hashable registry key; weak-referenceable, shared by all
    pytree clones of an operator through the aux fields."""

    __slots__ = ("__weakref__",)


class SparseInverseOperator(LinearOperator):
    """``A^{-1}`` for a scipy sparse matrix, factored once (SuperLU) at
    construction; applies are host callbacks inside the traced graph."""

    _fields_children = ()
    _fields_aux = ("_n", "_dtype_name", "_symmetric", "_hermitian", "_solve_key")

    # host-side registry: SuperLU objects aren't pytree-able, so the aux
    # field is a token into this table. The table is weak-keyed by the
    # token, which every pytree clone shares by reference — the
    # factorization is freed exactly when the last clone dies (no
    # process-lifetime leak, no dangling clones).
    import weakref as _weakref

    _registry = _weakref.WeakKeyDictionary()

    def __init__(self, A, *, symmetric: bool = False, hermitian: bool = False):
        super().__init__()
        try:
            import scipy.sparse as sps
            import scipy.sparse.linalg as spla
        except ImportError as e:  # pragma: no cover
            raise LinearOperatorException("scipy is required for sparse factorization") from e
        A = sps.csc_matrix(A)
        if A.shape[0] != A.shape[1]:
            raise LinearOperatorException("sparse inverse requires a square matrix")
        self._n = A.shape[0]
        self._dtype_name = np.dtype(A.dtype).name
        self._symmetric = bool(symmetric)
        self._hermitian = bool(hermitian)
        lu = spla.splu(A)
        token = _FactorToken()
        SparseInverseOperator._registry[token] = lu
        self._solve_key = token

    @property
    def nrow(self):
        return self._n

    @property
    def ncol(self):
        return self._n

    @property
    def dtype(self):
        return jnp.dtype(self._dtype_name)

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return self._hermitian

    def _solve(self, v, trans: str):
        lu = SparseInverseOperator._registry[self._solve_key]
        dt = self.dtype

        def cb(v_host):
            return lu.solve(np.asarray(v_host, dt), trans=trans).astype(dt)

        return jax.pure_callback(
            cb, jax.ShapeDtypeStruct((self._n,), dt), v, vmap_method="sequential"
        )

    def _prod(self, v):
        return self._solve(v, "N")

    def _tprod(self, u):
        return self._solve(u, "T")

    def _ctprod(self, w):
        return self._solve(w, "H")

    def _name(self):
        return "Sparse inverse operator (host SuperLU)"


register_operator(SparseInverseOperator)


def opSparseInverse(A, *, symm: bool = False, herm: bool = False):
    """Inverse of a scipy sparse matrix as an operator (factor once,
    host solves per apply)."""
    return SparseInverseOperator(A, symmetric=symm, hermitian=herm)


def opSparseLDL(A, check: bool = False):
    """LDL-style factorization operator for a sparse quasi-definite
    symmetric matrix: ``op * v ≈ A \\ v`` (reference opLDL ext,
    ext/LinearOperatorsLDLFactorizationsExt.jl:5-36). ``check`` verifies
    symmetry up to 1e-10."""
    import scipy.sparse as sps

    A = sps.csc_matrix(A)
    if check:
        d = abs(A - A.T)
        if d.nnz and d.max() > 1e-10:
            raise LinearOperatorException("matrix is not symmetric")
    return SparseInverseOperator(A, symmetric=True, hermitian=True)
