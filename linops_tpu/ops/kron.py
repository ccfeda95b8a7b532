"""Lazy Kronecker product operator.

Reference: src/kron.jl uses the identity (A ⊗ B) vec(X) = vec(B X Aᵀ)
(column-major) and *materializes* dense intermediates — a known-suboptimal
point (SURVEY.md #8). Here the identity is used in row-major form,

    (A ⊗ B) x  =  vec_row(A · (B · X_rowᵀ)ᵀ),   X_row = x.reshape(nA_cols, nB_cols)

with both factors applied through their (batched) matrix
applies and nothing materialized.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.base import LinearOperator, register_operator
from ..core.dense import aslinearoperator

__all__ = ["KronOperator", "kron"]


class KronOperator(LinearOperator):
    _fields_children = ("A", "B")
    _fields_aux = ()

    def __init__(self, A, B):
        super().__init__()
        self.A = aslinearoperator(A)
        self.B = aslinearoperator(B)

    @property
    def nrow(self):
        return self.A.nrow * self.B.nrow

    @property
    def ncol(self):
        return self.A.ncol * self.B.ncol

    @property
    def dtype(self):
        return jnp.result_type(self.A.dtype, self.B.dtype)

    @property
    def symmetric(self):
        return self.A.symmetric and self.B.symmetric

    @property
    def hermitian(self):
        return self.A.hermitian and self.B.hermitian

    def apply(self, v, mode: str = "N"):
        A, B = self.A, self.B
        if mode in ("T", "H"):
            a_in, b_in = A.nrow, B.nrow
        else:
            a_in, b_in = A.ncol, B.ncol
        X = v.reshape(a_in, b_in)
        # W = B_mode @ X^T : (B.out, a_in)
        W = B.apply_matrix(X.T, mode)
        # Y = A_mode @ W^T : (A.out, B.out)
        Y = A.apply_matrix(W.T, mode)
        return Y.reshape(-1)

    def apply_matrix(self, M, mode: str = "N"):
        import jax

        return jax.vmap(lambda col: self.apply(col, mode), in_axes=1, out_axes=1)(M)

    def _has_tprod(self):
        return True

    def _has_ctprod(self):
        return True

    def _bump_children(self, mode: str, n: int = 1):
        self.A.bump(mode, n)
        self.B.bump(mode, n)

    def _name(self):
        return "Kronecker product operator"


register_operator(KronOperator)


def kron(A, B):
    """Kronecker product; dense if both args are arrays
    (reference: src/kron.jl:10-49)."""
    a_is_op = isinstance(A, LinearOperator)
    b_is_op = isinstance(B, LinearOperator)
    if not a_is_op and not b_is_op:
        return jnp.kron(jnp.asarray(A), jnp.asarray(B))
    return KronOperator(A, B)
