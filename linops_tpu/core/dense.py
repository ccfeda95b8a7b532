"""Matrix-backed and function-backed leaf operators + the user-facing factory.

Equivalent of the reference constructors (reference: src/constructors.jl):
wrap a matrix (closures over mul!/transpose/adjoint, :15-29) or wrap user
product functions (:99-111). Here the matrix lives on device as a pytree leaf
and all three modes lower to matmuls under jit.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax.numpy as jnp

from .base import LinearOperator, LinearOperatorException, register_operator
from .precision import pmatmul

__all__ = ["MatrixOperator", "FunctionOperator", "make_operator", "aslinearoperator"]


class MatrixOperator(LinearOperator):
    """Dense-matrix-backed operator. ``A @ v`` is one matmul; transpose/adjoint
    modes avoid materializing Aᵀ by contracting on the other side."""

    _fields_children = ("A",)
    _fields_aux = ("_symmetric", "_hermitian")

    def __init__(self, A, *, symmetric: Optional[bool] = None, hermitian: Optional[bool] = None):
        super().__init__()
        A = jnp.asarray(A)
        if A.ndim != 2:
            raise LinearOperatorException("MatrixOperator requires a 2-D array")
        self.A = A
        # reference defaults to false,false unless wrapped in Symmetric/
        # Hermitian types (src/constructors.jl:31-38); we take explicit kwargs.
        self._symmetric = bool(symmetric) if symmetric is not None else False
        self._hermitian = bool(hermitian) if hermitian is not None else False

    @property
    def nrow(self):
        return self.A.shape[0]

    @property
    def ncol(self):
        return self.A.shape[1]

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return self._hermitian

    def _prod(self, v):
        return pmatmul(self.A, v)

    def _tprod(self, u):
        # u @ A == Aᵀ u without a transpose copy
        return pmatmul(u, self.A)

    def _ctprod(self, w):
        if jnp.iscomplexobj(self.A) or jnp.iscomplexobj(w):
            return jnp.conj(pmatmul(jnp.conj(w), self.A))
        return pmatmul(w, self.A)

    def apply_matrix(self, M, mode: str = "N"):
        if mode == "N":
            return pmatmul(self.A, M)
        if mode == "T":
            return pmatmul(self.A.T, M)
        if mode == "H":
            return pmatmul(jnp.conj(self.A).T, M)
        return pmatmul(jnp.conj(self.A), M)

    def apply_matrix_t(self, Mt, mode: str = "N"):
        # (A Mtᵀ)ᵀ = Mt Aᵀ — contract on the other side, keeping the
        # dense (k, n) row panel as both input and output layout
        if mode == "N":
            return pmatmul(Mt, self.A.T)
        if mode == "T":
            return pmatmul(Mt, self.A)
        if mode == "H":
            return pmatmul(Mt, jnp.conj(self.A))
        return pmatmul(Mt, jnp.conj(self.A).T)

    def _name(self):
        return "Matrix operator"


register_operator(MatrixOperator)


class FunctionOperator(LinearOperator):
    """Operator backed by pure JAX product functions.

    ``prod(v) -> y`` is required; ``tprod``/``ctprod`` are optional and the
    reference inference lattice fills the gaps (or raises
    'unable to infer ...', reference: src/adjtrans.jl:120,188).

    Note: unlike the reference's in-place ``prod!(res, v, α, β)`` closures
    (src/constructors.jl:99-111), functions here are functional; α/β (5-arg
    mul!) semantics are applied by the engine with XLA fusing the axpby into
    the product (SURVEY.md §7 design stance 3).
    """

    _fields_children = ()
    _fields_aux = (
        "_nrow",
        "_ncol",
        "_symmetric",
        "_hermitian",
        "_dtype_name",
        "_prod_fn",
        "_tprod_fn",
        "_ctprod_fn",
    )

    def __init__(
        self,
        nrow: int,
        ncol: int,
        prod: Callable,
        tprod: Optional[Callable] = None,
        ctprod: Optional[Callable] = None,
        *,
        symmetric: bool = False,
        hermitian: bool = False,
        dtype=None,
    ):
        super().__init__()
        self._nrow = int(nrow)
        self._ncol = int(ncol)
        self._symmetric = bool(symmetric)
        self._hermitian = bool(hermitian)
        import jax

        if dtype is None:
            dtype = jax.dtypes.canonicalize_dtype(jnp.float64)
        else:
            dtype = jax.dtypes.canonicalize_dtype(dtype)
        self._dtype_name = jnp.dtype(dtype).name
        self._prod_fn = prod
        self._tprod_fn = tprod
        self._ctprod_fn = ctprod

    @property
    def nrow(self):
        return self._nrow

    @property
    def ncol(self):
        return self._ncol

    @property
    def dtype(self):
        return jnp.dtype(self._dtype_name)

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return self._hermitian

    def _prod(self, v):
        return self._prod_fn(v)

    def _tprod(self, u):
        if self._tprod_fn is None:
            return NotImplemented
        return self._tprod_fn(u)

    def _ctprod(self, w):
        if self._ctprod_fn is None:
            return NotImplemented
        return self._ctprod_fn(w)

    def _has_tprod(self):
        return self._tprod_fn is not None

    def _has_ctprod(self):
        return self._ctprod_fn is not None

    def _name(self):
        return "Function operator"


register_operator(FunctionOperator)


def make_operator(*args, **kwargs) -> LinearOperator:
    """User-facing polymorphic constructor, exported as ``LinearOperator``.

    Forms (mirroring reference: src/constructors.jl):
      - ``LinearOperator(M, symmetric=..., hermitian=...)`` for a 2-D array
      - ``LinearOperator(dtype, nrow, ncol, symmetric, hermitian, prod,
        tprod=None, ctprod=None)`` for function-backed operators
    """
    if len(args) >= 1 and not isinstance(args[0], type) and getattr(args[0], "ndim", None) == 2:
        M = args[0]
        if len(args) > 1:
            raise TypeError("LinearOperator(M): extra positional args not allowed")
        return MatrixOperator(M, **kwargs)
    if len(args) >= 6:
        dtype, nrow, ncol, symmetric, hermitian, prod = args[:6]
        tprod = args[6] if len(args) > 6 else kwargs.pop("tprod", None)
        ctprod = args[7] if len(args) > 7 else kwargs.pop("ctprod", None)
        return FunctionOperator(
            nrow,
            ncol,
            prod,
            tprod,
            ctprod,
            symmetric=symmetric,
            hermitian=hermitian,
            dtype=dtype,
            **kwargs,
        )
    raise TypeError(
        "LinearOperator(...) expects a 2-D array or "
        "(dtype, nrow, ncol, symmetric, hermitian, prod[, tprod, ctprod])"
    )


def aslinearoperator(obj) -> LinearOperator:
    """Coerce an array or operator to a LinearOperator."""
    if isinstance(obj, LinearOperator):
        return obj
    if hasattr(obj, "ndim") and obj.ndim == 2:
        return MatrixOperator(obj)
    raise TypeError(f"cannot interpret {type(obj)} as a linear operator")
