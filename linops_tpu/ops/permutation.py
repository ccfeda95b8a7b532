"""Permutation operators.

The reference composes permutations from ``opRestriction`` (reference:
src/special-operators.jl:167-201), whose apply is ``x[I]``. Here a
permutation is its own operator with both index vectors stored, so every
mode is one gather: ``P x = x[perm]`` and ``Pᵀ u = u[perm⁻¹]``.

``opPermutation(rcm_permutation(...))`` conjugates a scattered operator
into banded form (``P A Pᵀ``, sparse/reorder.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.base import (LinearOperator, LinearOperatorException,
                         register_operator)

__all__ = ["PermutationOperator", "opPermutation"]


class PermutationOperator(LinearOperator):
    """``y = x[perm]`` (row-permutation matrix: ``P[i, perm[i]] = 1``).

    Transpose/adjoint applies gather by the inverse permutation
    (``Pᵀ = P⁻¹``: orthogonal).

    dtype contract: a permutation carries NO values of its own — applies
    preserve the input dtype exactly. The ``dtype`` property reports
    float32 as a placeholder only (there is no value array to type);
    composite dtype inference through ``jnp.result_type`` therefore treats
    a permutation like an f32 leaf, which can over-promote a pure-bf16
    chain's REPORTED dtype — the computed values are unaffected.
    """

    _fields_children = ("perm", "perm_inv")
    _fields_aux = ("_n",)

    def __init__(self, perm):
        super().__init__()
        perm = np.asarray(perm, np.int64)
        n = perm.shape[0]
        if not np.array_equal(np.sort(perm), np.arange(n)):
            raise LinearOperatorException("perm is not a permutation")
        self._n = int(n)
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        self.perm = jnp.asarray(perm, jnp.int32)
        self.perm_inv = jnp.asarray(inv, jnp.int32)

    @property
    def nrow(self):
        return self._n

    ncol = nrow

    @property
    def dtype(self):
        # placeholder only — see the class docstring's dtype contract
        # (applies preserve the input dtype; there is no value array)
        return jnp.dtype(jnp.float32)

    @property
    def symmetric(self):
        return False

    hermitian = symmetric

    def _prod(self, v):
        return v[self.perm]

    def _tprod(self, u):
        return u[self.perm_inv]

    def _ctprod(self, w):
        return self._tprod(w)

    def apply_matrix(self, M, mode: str = "N"):
        # Mode "C" (conjugate, NO transpose) of a real permutation acts
        # like "N".
        idx = self.perm if mode in ("N", "C") else self.perm_inv
        return M[idx]

    def _name(self):
        return "Permutation operator"

    @staticmethod
    def _shard_child(op, arr, axis):
        # index vectors address the whole input: replicate
        # (parallel/sharded.py honors this rule per leaf)
        from jax.sharding import PartitionSpec

        return PartitionSpec()


register_operator(PermutationOperator)


def opPermutation(perm) -> PermutationOperator:
    """Permutation operator ``(P x)[i] = x[perm[i]]``."""
    return PermutationOperator(perm)
