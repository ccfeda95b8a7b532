"""Factorization-backed operators: opInverse / opCholesky / opLDL /
opHouseholder / opHermitian.

Reference: src/linalg.jl. Cholesky/LDL factor ONCE at construction and every
apply is a (fused) triangular solve; opInverse performs a fresh solve per
apply (reference semantics, src/linalg.jl:20-32).
"""

from __future__ import annotations

import functools

import jax
from ..core.precision import pmatmul, pvdot
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from ..core.base import LinearOperator, LinearOperatorException, register_operator

__all__ = [
    "InverseOperator",
    "IterativeInverseOperator",
    "CholeskyOperator",
    "LDLOperator",
    "HouseholderOperator",
    "HermitianOperator",
    "opInverse",
    "opIterativeInverse",
    "opCholesky",
    "opLDL",
    "opHouseholder",
    "opHermitian",
]


def _isrealdtype(x) -> bool:
    return not jnp.issubdtype(jnp.result_type(x), jnp.complexfloating)


class InverseOperator(LinearOperator):
    """``M^{-1}`` as an operator; each apply solves (reference:
    src/linalg.jl:20-32 — 'each application of this operator applies \\\\')."""

    _fields_children = ("M",)
    _fields_aux = ("_symmetric", "_hermitian")

    def __init__(self, M, *, symmetric: bool = False, hermitian: bool = False):
        super().__init__()
        M = jnp.asarray(M)
        if M.ndim != 2 or M.shape[0] != M.shape[1]:
            raise LinearOperatorException("opInverse requires a square matrix")
        self.M = M
        self._symmetric = bool(symmetric)
        self._hermitian = bool(hermitian)

    @property
    def nrow(self):
        return self.M.shape[0]

    @property
    def ncol(self):
        return self.M.shape[1]

    @property
    def dtype(self):
        return self.M.dtype

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return self._hermitian

    def _prod(self, v):
        return jnp.linalg.solve(self.M, v)

    def _tprod(self, u):
        return jnp.linalg.solve(self.M.T, u)

    def _ctprod(self, w):
        return jnp.linalg.solve(jnp.conj(self.M).T, w)

    def apply_matrix(self, M, mode: str = "N"):
        if mode == "N":
            return jnp.linalg.solve(self.M, M)
        if mode == "T":
            return jnp.linalg.solve(self.M.T, M)
        if mode == "H":
            return jnp.linalg.solve(jnp.conj(self.M).T, M)
        return jnp.conj(jnp.linalg.solve(self.M, jnp.conj(M)))

    def _name(self):
        return "Inverse operator"


register_operator(InverseOperator)


class CholeskyOperator(LinearOperator):
    """Inverse of an HPD matrix via its Cholesky factor, computed once
    (reference: src/linalg.jl:34-58). Flags: symmetric=isreal(M),
    hermitian=True. The transpose apply uses the conj trick
    (reference tmulFact!, src/linalg.jl:11-17)."""

    _fields_children = ("L",)
    _fields_aux = ("_symmetric",)

    def __init__(self, M, *, check: bool = False):
        super().__init__()
        M = jnp.asarray(M)
        if M.ndim != 2 or M.shape[0] != M.shape[1]:
            raise LinearOperatorException("shape mismatch")
        if check:
            from ..utils.checks import check_hermitian, check_positive_definite

            if not check_hermitian(M):
                raise LinearOperatorException("matrix is not Hermitian")
            if not check_positive_definite(M):
                raise LinearOperatorException("matrix is not positive definite")
        L = jnp.linalg.cholesky(M)
        self.L = L
        self._symmetric = _isrealdtype(M)

    @property
    def nrow(self):
        return self.L.shape[0]

    @property
    def ncol(self):
        return self.L.shape[0]

    @property
    def dtype(self):
        return self.L.dtype

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return True

    def _solve(self, b):
        return jsl.cho_solve((self.L, True), b)

    def _prod(self, v):
        return self._solve(v)

    def _ctprod(self, w):
        # (M^{-1})^H = M^{-1} for hermitian M
        return self._solve(w)

    def _tprod(self, u):
        # transpose via conj trick: conj(M^{-1} conj(u))
        if _isrealdtype(self.L):
            return self._solve(u)
        return jnp.conj(self._solve(jnp.conj(u)))

    def apply_matrix(self, M, mode: str = "N"):
        if mode in ("N", "H"):
            return self._solve(M)
        if mode == "T":
            if _isrealdtype(self.L):
                return self._solve(M)
            return jnp.conj(self._solve(jnp.conj(M)))
        return jnp.conj(self._solve(jnp.conj(M)))

    def _name(self):
        return "Cholesky inverse operator"


register_operator(CholeskyOperator)


class LDLOperator(LinearOperator):
    """Inverse of a symmetric (possibly indefinite) matrix, factored once.

    The reference's opLDL (src/linalg.jl:60-75 + ext/
    LinearOperatorsLDLFactorizationsExt.jl) uses an LDLᵀ factorization; here
    we factor once with partial-pivoted LU (jit-friendly, on device) which
    handles the same symmetric-indefinite systems."""

    _fields_children = ("lu", "piv")
    _fields_aux = ("_symmetric",)

    def __init__(self, M, *, check: bool = False):
        super().__init__()
        M = jnp.asarray(M)
        if M.ndim != 2 or M.shape[0] != M.shape[1]:
            raise LinearOperatorException("shape mismatch")
        if check:
            from ..utils.checks import check_hermitian

            if not check_hermitian(M):
                raise LinearOperatorException("matrix is not Hermitian")
        lu, piv = jsl.lu_factor(M)
        self.lu = lu
        self.piv = piv
        self._symmetric = _isrealdtype(M)

    @property
    def nrow(self):
        return self.lu.shape[0]

    @property
    def ncol(self):
        return self.lu.shape[0]

    @property
    def dtype(self):
        return self.lu.dtype

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return True

    def _prod(self, v):
        return jsl.lu_solve((self.lu, self.piv), v)

    def _ctprod(self, w):
        return self._prod(w)

    def _tprod(self, u):
        if _isrealdtype(self.lu):
            return self._prod(u)
        return jnp.conj(self._prod(jnp.conj(u)))

    def apply_matrix(self, M, mode: str = "N"):
        if mode in ("N", "H"):
            return jsl.lu_solve((self.lu, self.piv), M)
        if _isrealdtype(self.lu):
            return jsl.lu_solve((self.lu, self.piv), M)
        return jnp.conj(jsl.lu_solve((self.lu, self.piv), jnp.conj(M)))

    def _name(self):
        return "LDL inverse operator"


register_operator(LDLOperator)


class HouseholderOperator(LinearOperator):
    """``x -> (I - 2 h h^H) x`` — self-adjoint reflector
    (reference: src/linalg.jl:77-95)."""

    _fields_children = ("h",)
    _fields_aux = ()

    def __init__(self, h):
        super().__init__()
        h = jnp.asarray(h)
        if h.ndim != 1:
            raise LinearOperatorException("opHouseholder requires a vector")
        self.h = h

    @property
    def nrow(self):
        return self.h.shape[0]

    @property
    def ncol(self):
        return self.h.shape[0]

    @property
    def dtype(self):
        return self.h.dtype

    @property
    def symmetric(self):
        return _isrealdtype(self.h)

    @property
    def hermitian(self):
        return True

    def _prod(self, v):
        h = self.h
        # dot(h, v) conjugates the first argument (Julia dot)
        return v - 2.0 * pvdot(h, v) * h

    def _ctprod(self, w):
        return self._prod(w)  # reference passes ctprod=prod (src/linalg.jl:94)

    def apply_matrix(self, M, mode: str = "N"):
        h = self.h
        if mode in ("N", "H"):
            return M - 2.0 * jnp.outer(h, pmatmul(jnp.conj(h), M))
        return super().apply_matrix(M, mode)

    def _name(self):
        return "Householder operator"


register_operator(HouseholderOperator)


class HermitianOperator(LinearOperator):
    """Hermitian operator from a diagonal ``d`` and the strict lower triangle
    of ``A``: ``y = d .* v + L v + L^H v`` (reference: src/linalg.jl:97-127)."""

    _fields_children = ("d", "L")
    _fields_aux = ("_symmetric",)

    def __init__(self, d, A=None):
        super().__init__()
        if A is None:
            A = jnp.asarray(d)
            d = jnp.diagonal(A)
        d = jnp.asarray(d)
        A = jnp.asarray(A)
        if A.ndim != 2 or A.shape[0] != A.shape[1] or A.shape[0] != d.shape[0]:
            raise LinearOperatorException("shape mismatch")
        self.d = d
        self.L = jnp.tril(A, -1)
        self._symmetric = _isrealdtype(A) and _isrealdtype(d)

    @property
    def nrow(self):
        return self.d.shape[0]

    @property
    def ncol(self):
        return self.d.shape[0]

    @property
    def dtype(self):
        return jnp.result_type(self.d.dtype, self.L.dtype)

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return True

    def _prod(self, v):
        L = self.L
        lv = pmatmul(L, v)
        # L^H v without materializing L^H: conj(conj(v) @ L)
        if jnp.iscomplexobj(L) or jnp.iscomplexobj(v):
            lhv = jnp.conj(pmatmul(jnp.conj(v), L))
        else:
            lhv = pmatmul(v, L)
        return self.d * v + lv + lhv

    def apply_matrix(self, M, mode: str = "N"):
        L = self.L
        if mode in ("N", "H"):
            return self.d[:, None] * M + pmatmul(L, M) + pmatmul(jnp.conj(L).T, M)
        Mc = jnp.conj(M)
        return jnp.conj(self.d[:, None] * Mc + pmatmul(L, Mc) + pmatmul(jnp.conj(L).T, Mc))

    def _name(self):
        return "Hermitian operator"


register_operator(HermitianOperator)


# -- reference-parity spellings ----------------------------------------------


def opInverse(M, *, symm: bool = False, herm: bool = False):
    return InverseOperator(M, symmetric=symm, hermitian=herm)


def opCholesky(M, check: bool = False):
    return CholeskyOperator(M, check=check)


def opLDL(M, check: bool = False):
    return LDLOperator(M, check=check)


def opHouseholder(h):
    return HouseholderOperator(h)


def opHermitian(d, A=None):
    return HermitianOperator(d, A)


class IterativeInverseOperator(LinearOperator):
    """``op^{-1}`` for ANY square operator: each apply runs an inner
    Krylov solve on device (the matrix-free counterpart of
    :class:`InverseOperator`, which factors a dense matrix).

    The inner solve is pure jnp (a ``lax.while_loop``), so the node
    composes everywhere operators do: inside graphs, under outer jits,
    vmapped, and as a preconditioner ``M`` for an outer solver (keep the
    inner ``tol`` modest there — an inexact inverse is a nonstationary
    preconditioner, fine for restarted/flexible outer methods).

    Reverse-mode AD uses IMPLICIT differentiation (``lax.while_loop``
    itself is not reverse-differentiable): with ``x = A^{-1} v``, the
    input cotangent is one more solve in the transposed mode, and the
    OPERATOR-DATA cotangent is the pullback of a single apply at ``x``
    against that solve's result (``Abar = -w (.) x``) — so
    ``jax.grad`` w.r.t. the wrapped operator's arrays flows correctly,
    matching the library's native flow-through contract.

    ``solver``: ``"auto"`` picks ``minres`` for flagged-hermitian
    operators (indefinite-safe; pass ``solver="cg"`` when positive
    definiteness is known) and ``gmres`` otherwise (breakdown-free;
    ``"bicgstab"`` is the cheaper opt-in for well-behaved nonsymmetric
    systems — but it can BREAK DOWN silently inside jit, e.g. on
    skew-symmetric operators, leaving a huge residual in the returned
    vector). ``maxiter`` is a TOTAL inner-iteration budget for every
    solver (for gmres it is split into restart cycles). Non-convergence
    within the budget is silent by design (an inexact inverse is a valid
    preconditioner); call :meth:`solve_info` to observe the residual.
    """

    _fields_children = ("op",)
    _fields_aux = ("_tol", "_maxiter", "_solver")

    _SOLVERS = ("auto", "cg", "minres", "bicgstab", "gmres")

    def __init__(self, op, *, tol: float = 1e-8, maxiter: int = 100,
                 solver: str = "auto"):
        super().__init__()
        if not isinstance(op, LinearOperator):
            from ..core.dense import aslinearoperator

            op = aslinearoperator(op)
        if op.nrow != op.ncol:
            raise LinearOperatorException(
                "opIterativeInverse requires a square operator"
            )
        if solver not in self._SOLVERS:
            raise ValueError(f"solver must be one of {self._SOLVERS}")
        self.op = op
        self._tol = float(tol)
        self._maxiter = int(maxiter)
        self._solver = solver

    @property
    def nrow(self):
        return self.op.nrow

    ncol = nrow

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def symmetric(self):
        return self.op.symmetric  # inverse of a symmetric op is symmetric

    @property
    def hermitian(self):
        return self.op.hermitian

    def _inner(self, mode: str):
        from ..core.adjoint import adjoint, conj, transpose

        if mode == "N":
            return self.op
        if mode == "T":
            return transpose(self.op)
        if mode == "H":
            return adjoint(self.op)
        if mode == "C":
            return conj(self.op)
        raise ValueError(f"unknown mode {mode!r}")

    def solve_info(self, v, mode: str = "N"):
        """The inner solve with its diagnostics: ``(x, iterations,
        final residual norm)`` — use this to OBSERVE convergence (apply
        itself is silent by design; see the class docstring)."""
        from ..utils import krylov

        inner = self._inner(mode)
        name = self._solver
        if name == "auto":
            name = "minres" if inner.hermitian else "gmres"
        if name == "gmres":
            restart = max(1, min(30, self._maxiter))
            return krylov.gmres(inner, v, tol=self._tol, restart=restart,
                                maxiter=max(1, self._maxiter // restart))
        return getattr(krylov, name)(inner, v, tol=self._tol,
                                     maxiter=self._maxiter)

    def _raw_solve(self, v, mode: str):
        return self.solve_info(v, mode)[0]

    def apply(self, v, mode: str = "N"):
        return _iter_solve(self, v, mode)

    def _has_tprod(self):
        return True

    def _has_ctprod(self):
        return True

    def _name(self):
        return f"IterativeInverse({self._solver}, tol={self._tol}) of"


register_operator(IterativeInverseOperator)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _iter_solve(node: IterativeInverseOperator, v, mode: str):
    return node._raw_solve(v, mode)


def _iter_fwd(node, v, mode):
    x = node._raw_solve(v, mode)
    return x, (node, x)


def _iter_bwd(mode, res, g):
    from ..core.base import compose_modes

    node, x = res
    # implicit differentiation of A_mode x = v at cotangent g:
    #   vbar = (A_{T.mode})^{-1} g               (one more inner solve)
    #   Abar = pullback of (leaves -> A_mode(leaves) @ x) at -vbar
    # (the unconjugated-transpose convention throughout; only ONE apply
    # is differentiated, never the while_loop)
    w = node._raw_solve(g, compose_modes("T", mode))
    _, pull = jax.vjp(lambda nd: nd._inner(mode).apply(x, "N"), node)
    d_node = pull(-w)[0]
    return (d_node, w)


_iter_solve.defvjp(_iter_fwd, _iter_bwd)


def opIterativeInverse(op, *, tol: float = 1e-8, maxiter: int = 100,
                       solver: str = "auto"):
    return IterativeInverseOperator(op, tol=tol, maxiter=maxiter, solver=solver)
