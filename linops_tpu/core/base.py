"""Core operator abstraction for the linear-operator framework.

Design (see SURVEY.md §7): instead of the reference's opaque closure triples
(reference: src/abstract.jl:46-59), every operator is an explicit, traceable
node in an operator graph. Each node is registered as a JAX pytree, so a whole
lazy-algebra expression (compose / sum / scale / adjoint / cat / kron / ...)
is a nested pytree whose ``apply`` traces into ONE jaxpr and compiles into a
single fused XLA computation. Laziness = graph construction; evaluation
= jit-compiled graph traversal.

Modes
-----
An apply is parameterised by a *mode* in the group {N, T, C, H} (identity,
transpose, conjugate, conjugate-transpose), which is C2 x C2 under
composition: ``H = T . C``. The reference realises these as three closures
``prod!/tprod!/ctprod!`` plus wrapper types; we realise them as a static mode
argument with the reference's adjoint-inference lattice reproduced exactly
(reference: src/adjtrans.jl:90-205):

  adjoint:   hermitian -> prod | ctprod | conj.tprod.conj | symmetric -> conj.prod.conj | error
  transpose: symmetric -> prod | tprod  | conj.ctprod.conj | hermitian -> conj.prod.conj | error

Counters
--------
Product counters (``nprod/ntprod/nctprod``, reference src/abstract.jl:147-153)
are untraceable host-side mutation; they live in a non-pytree ``Counters``
cell bumped by the public eager entry points via a host-side graph walk that
mirrors the calls the traced apply makes.
"""

from __future__ import annotations

import abc
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "LinearOperatorException",
    "LinearOperator",
    "Counters",
    "register_operator",
    "compose_modes",
    "MODES",
]

# ----------------------------------------------------------------------------
# Exceptions
# ----------------------------------------------------------------------------


class LinearOperatorException(Exception):
    """Raised on shape mismatches, uninferable transposes, bad promotions.

    Mirrors the reference's ``LinearOperatorException``
    (reference: src/abstract.jl:17-19).
    """


# ----------------------------------------------------------------------------
# Modes
# ----------------------------------------------------------------------------

MODES = ("N", "T", "C", "H")

# mode -> (transposed, conjugated)
_MODE_TC = {"N": (False, False), "T": (True, False), "C": (False, True), "H": (True, True)}
_TC_MODE = {v: k for k, v in _MODE_TC.items()}


def compose_modes(outer: str, inner: str) -> str:
    """Compose two modes: mode(outer) applied to an operator in mode(inner).

    The group is C2 x C2 (transpose and conjugation commute and are
    involutions), reproducing the reference's six-way involution rules
    (reference: src/adjtrans.jl:32-44).
    """
    t1, c1 = _MODE_TC[outer]
    t2, c2 = _MODE_TC[inner]
    return _TC_MODE[(t1 ^ t2, c1 ^ c2)]


def mode_transposed(mode: str) -> bool:
    return _MODE_TC[mode][0]


def mode_conjugated(mode: str) -> bool:
    return _MODE_TC[mode][1]


def _conj(x):
    # jnp.conj on real input is a no-op that XLA folds away.
    if jnp.iscomplexobj(x):
        return jnp.conj(x)
    return x


# ----------------------------------------------------------------------------
# Counters (host-side, non-pytree)
# ----------------------------------------------------------------------------


class Counters:
    """Host-side product counters (reference: src/abstract.jl:147-153)."""

    __slots__ = ("nprod", "ntprod", "nctprod")

    def __init__(self):
        self.nprod = 0
        self.ntprod = 0
        self.nctprod = 0

    def reset(self):
        self.nprod = 0
        self.ntprod = 0
        self.nctprod = 0


# ----------------------------------------------------------------------------
# Pytree registration
# ----------------------------------------------------------------------------


def register_operator(cls):
    """Register an operator class as a JAX pytree node.

    The class must define two class attributes:
      - ``_fields_children``: tuple of attribute names holding dynamic leaves
        (jax arrays or nested operators)
      - ``_fields_aux``: tuple of attribute names holding static metadata
        (ints, bools, dtypes, callables — must be hashable and eq-comparable,
        as they key the jit cache)
    """
    child_fields = cls._fields_children
    aux_fields = cls._fields_aux

    def flatten(op):
        children = tuple(getattr(op, f) for f in child_fields)
        aux = tuple(getattr(op, f) for f in aux_fields)
        return children, aux

    def unflatten(aux, children):
        obj = object.__new__(cls)
        for f, v in zip(child_fields, children):
            object.__setattr__(obj, f, v)
        for f, v in zip(aux_fields, aux):
            object.__setattr__(obj, f, v)
        object.__setattr__(obj, "_counters", Counters())
        return obj

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


# ----------------------------------------------------------------------------
# Base class
# ----------------------------------------------------------------------------


class LinearOperator(abc.ABC):
    """Abstract base for all linear operators.

    Subclasses declare pytree structure via ``_fields_children`` /
    ``_fields_aux`` and implement ``_prod`` (and optionally ``_tprod`` /
    ``_ctprod``) as pure JAX functions, or override ``apply`` wholesale for
    composite nodes that push modes down to children.

    Equivalent of the reference's ``AbstractLinearOperator{T}``
    (reference: src/abstract.jl:30).
    """

    # Subclasses override; registered via register_operator.
    _fields_children: Tuple[str, ...] = ()
    _fields_aux: Tuple[str, ...] = ()

    # Make numpy defer binary ops (u @ op, x * op, ...) to our reflected
    # methods instead of trying elementwise semantics.
    __array_ufunc__ = None

    # --- attributes every subclass must provide (as fields or properties) ---
    nrow: int
    ncol: int

    def __init__(self):
        self._counters = Counters()

    # ------------------------------------------------------------------
    # Static metadata
    # ------------------------------------------------------------------

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nrow, self.ncol)

    @property
    def T(self) -> "LinearOperator":
        from .adjoint import transpose

        return transpose(self)

    @property
    def H(self) -> "LinearOperator":
        from .adjoint import adjoint

        return adjoint(self)

    def adjoint(self) -> "LinearOperator":
        return self.H

    def transpose(self) -> "LinearOperator":
        return self.T

    def conj(self) -> "LinearOperator":
        from .adjoint import conj as _conj_op

        return _conj_op(self)

    @property
    def dtype(self):
        raise NotImplementedError

    @property
    def symmetric(self) -> bool:
        return False

    @property
    def hermitian(self) -> bool:
        return False

    def issymmetric(self) -> bool:
        return self.symmetric

    def ishermitian(self) -> bool:
        return self.hermitian

    def isreal(self) -> bool:
        return not jnp.issubdtype(jnp.dtype(self.dtype), jnp.complexfloating)

    def size(self, d: Optional[int] = None):
        """Reference-style size: ``size(op)`` / ``size(op, d)`` with d in {1,2}
        (reference: src/abstract.jl:203-219)."""
        if d is None:
            return self.shape
        if d == 1:
            return self.nrow
        if d == 2:
            return self.ncol
        raise LinearOperatorException("Linear operators only have 2 dimensions for now")

    def in_dim(self, mode: str = "N") -> int:
        return self.nrow if mode_transposed(mode) else self.ncol

    def out_dim(self, mode: str = "N") -> int:
        return self.ncol if mode_transposed(mode) else self.nrow

    # ------------------------------------------------------------------
    # Kernel slots (leaf operators implement these; pure JAX functions)
    # ------------------------------------------------------------------

    def _prod(self, v):
        raise NotImplementedError

    def _tprod(self, u):
        return NotImplemented

    def _ctprod(self, w):
        return NotImplemented

    def _has_tprod(self) -> bool:
        return type(self)._tprod is not LinearOperator._tprod

    def _has_ctprod(self) -> bool:
        return type(self)._ctprod is not LinearOperator._ctprod

    # ------------------------------------------------------------------
    # The apply engine: mode dispatch + adjoint-inference lattice
    # ------------------------------------------------------------------

    def apply(self, v, mode: str = "N"):
        """Apply the operator in the given mode. Pure; trace-time dispatch.

        Reproduces the reference inference lattice exactly
        (reference: src/adjtrans.jl:90-205)."""
        if mode == "N":
            return self._prod(v)
        if mode == "C":
            # conj(A) v = conj(A conj(v))  (reference: src/adjtrans.jl:226-249)
            return _conj(self._prod(_conj(v)))
        if mode == "H":
            if self.hermitian:
                return self._prod(v)
            r = self._ctprod(v)
            if r is not NotImplemented:
                return r
            rt = self._tprod(_conj(v))
            if rt is not NotImplemented:
                return _conj(rt)
            if self.symmetric:
                return _conj(self._prod(_conj(v)))
            raise LinearOperatorException("unable to infer conjugate transpose operator")
        if mode == "T":
            if self.symmetric:
                return self._prod(v)
            r = self._tprod(v)
            if r is not NotImplemented:
                return r
            rc = self._ctprod(_conj(v))
            if rc is not NotImplemented:
                return _conj(rc)
            if self.hermitian:
                return _conj(self._prod(_conj(v)))
            raise LinearOperatorException("unable to infer transpose operator")
        raise ValueError(f"unknown mode {mode!r}")

    # ------------------------------------------------------------------
    # Matrix apply (column-batched). Default: vmap the vector apply — a
    # single batched XLA computation (SURVEY.md §3.5 "blockwise").
    # ------------------------------------------------------------------

    def apply_matrix(self, M, mode: str = "N"):
        return jax.vmap(lambda col: self.apply(col, mode), in_axes=1, out_axes=1)(M)

    def apply_matrix_t(self, Mt, mode: str = "N"):
        """Row-panel apply: ``(op @ Mtᵀ)ᵀ`` for ``Mt`` of shape (k, n).

        Block methods (LOBPCG, multi-RHS solvers) carry panels TRANSPOSED
        as (k, n) rows and apply through this method.
        The default is transpose → apply_matrix → transpose (paying the
        padded layout only inside the apply); operators whose kernel is
        shift/contraction-based override it with a native row-panel form."""
        return self.apply_matrix(Mt.T, mode).T

    # ------------------------------------------------------------------
    # Counters
    # ------------------------------------------------------------------

    @property
    def counters(self) -> Counters:
        c = getattr(self, "_counters", None)
        if c is None:
            c = Counters()
            object.__setattr__(self, "_counters", c)
        return c

    @property
    def nprod(self) -> int:
        return self.counters.nprod

    @property
    def ntprod(self) -> int:
        return self.counters.ntprod

    @property
    def nctprod(self) -> int:
        return self.counters.nctprod

    def reset_counters(self) -> "LinearOperator":
        """Reference ``reset!(op)`` (reference: src/abstract.jl:191-196)."""
        self.counters.reset()
        return self

    def _slot_for(self, mode: str) -> str:
        """Which counter slot an apply in ``mode`` hits, mirroring the
        reference's mul! dispatch (reference: src/adjtrans.jl:100-136)."""
        if mode == "N" or mode == "C":
            return "nprod"
        if mode == "H":
            if self.hermitian:
                return "nprod"
            if self._has_ctprod():
                return "nctprod"
            if self._has_tprod():
                return "ntprod"
            return "nprod"  # symmetric fallback uses prod
        # mode == "T"
        if self.symmetric:
            return "nprod"
        if self._has_tprod():
            return "ntprod"
        if self._has_ctprod():
            return "nctprod"
        return "nprod"  # hermitian fallback uses prod

    def _bump(self, mode: str, n: int = 1):
        c = self.counters
        setattr(c, self._slot_for(mode), getattr(c, self._slot_for(mode)) + n)

    def _bump_children(self, mode: str, n: int = 1):
        """Composite nodes override to propagate counts to children in the
        modes their apply invokes them with."""

    def bump(self, mode: str, n: int = 1):
        self._bump(mode, n)
        self._bump_children(mode, n)

    # ------------------------------------------------------------------
    # Eager public API (jit-cached; see core/apply.py)
    # ------------------------------------------------------------------

    def matvec(self, v, mode: str = "N"):
        from .apply import matvec

        return matvec(self, v, mode=mode)

    def rmatvec(self, w):
        """Adjoint apply: ``op.H @ w``."""
        from .apply import matvec

        return matvec(self, w, mode="H")

    def matmat(self, M, mode: str = "N"):
        from .apply import matmat

        return matmat(self, M, mode=mode)

    def to_dense(self, block_size: int = 4096):
        """Materialize as a dense array, block-columnwise
        (reference ``Matrix(op)``: src/abstract.jl:282-292)."""
        from .apply import to_dense

        return to_dense(self, block_size=block_size)

    def __call__(self, v):
        return self.matvec(v)

    # ------------------------------------------------------------------
    # Operator algebra sugar
    # ------------------------------------------------------------------

    def _wrap_operand(self, other):
        """Auto-wrap bare matrices as operators (reference:
        src/operations.jl:159-160, 218-219)."""
        from .dense import MatrixOperator

        if isinstance(other, LinearOperator):
            return other
        if hasattr(other, "ndim") and getattr(other, "ndim", None) == 2:
            return MatrixOperator(other)
        return None

    def __mul__(self, other):
        from .algebra import Compose, Scale

        if getattr(other, "_is_universal_eye", False):
            return self  # op * opEye() === op (reference: src/special-operators.jl:25)
        if isinstance(other, LinearOperator):
            return Compose(self, other)
        if isinstance(other, (int, float, complex)) or (
            hasattr(other, "ndim") and getattr(other, "ndim") == 0
        ):
            return Scale(other, self)
        if hasattr(other, "ndim"):
            if other.ndim == 1:
                return self.matvec(other)
            if other.ndim == 2:
                return Compose(self, self._wrap_operand(other))
        return NotImplemented

    def __rmul__(self, other):
        from .algebra import Compose, Scale

        if isinstance(other, (int, float, complex)) or (
            hasattr(other, "ndim") and getattr(other, "ndim") == 0
        ):
            # reference: x * op == op * x (src/operations.jl:179-181)
            return Scale(other, self)
        if hasattr(other, "ndim") and other.ndim == 2:
            return Compose(self._wrap_operand(other), self)
        return NotImplemented

    def __matmul__(self, other):
        return self.__mul__(other)

    def __rmatmul__(self, other):
        # u @ op == transpose(op) * u, the reference's row-vector form
        # ``transpose(u) * op`` (reference: src/operations.jl:50-77) in
        # numpy convention (1-D arrays carry no row/column orientation).
        if hasattr(other, "ndim") and getattr(other, "ndim", None) == 1:
            return self.matvec(other, mode="T")
        return self.__rmul__(other)

    def __truediv__(self, x):
        # reference: op / x = op * (1/x)  (src/operations.jl:183)
        from .algebra import Scale

        return Scale(1.0 / x, self)

    def __pow__(self, p):
        # op ** p for integral p >= 0: a lazy Compose chain by binary
        # exponentiation (log2(p) graph depth). The reference leaves ^ to
        # Julia's generic power; here it is first-class for square ops.
        if isinstance(p, bool):
            return NotImplemented
        try:
            import operator as _operator

            p = _operator.index(p)  # accepts numpy integers too
        except TypeError:
            return NotImplemented
        if self.nrow != self.ncol:
            raise LinearOperatorException("operator power requires a square operator")
        if p < 0:
            raise ValueError("operator power requires p >= 0 (use opInverse for p < 0)")
        if p == 0:
            from ..ops.eye import Eye

            return Eye(self.nrow, dtype=self.dtype)
        if p == 1:
            # fresh node, not `self`: every other p returns a new operator,
            # and aliasing would share counters/timers with the base
            from .algebra import Scale

            return Scale(1.0, self)
        result = None
        base = self
        while p:
            if p & 1:
                result = base if result is None else result @ base
            p >>= 1
            if p:
                base = base @ base
        return result

    def __add__(self, other):
        from .algebra import Sum

        if isinstance(other, LinearOperator):
            return Sum(self, other)
        wrapped = self._wrap_operand(other)
        if wrapped is not None:
            return Sum(self, wrapped)
        if isinstance(other, (int, float, complex)) or (
            hasattr(other, "ndim") and getattr(other, "ndim") == 0
        ):
            # reference: op + x == op + x*opOnes (src/operations.jl:222)
            from ..ops.eye import Ones

            return Sum(self, other * Ones(self.nrow, self.ncol, dtype=self.dtype))
        return NotImplemented

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        if isinstance(other, LinearOperator):
            return self + (-other)
        wrapped = self._wrap_operand(other)
        if wrapped is not None:
            return self + (-wrapped)
        if isinstance(other, (int, float, complex)) or (
            hasattr(other, "ndim") and getattr(other, "ndim") == 0
        ):
            return self + (-other)
        return NotImplemented

    def __rsub__(self, other):
        return (-self).__add__(other)

    def __neg__(self):
        from .algebra import Scale

        return Scale(-1, self)

    def __pos__(self):
        return self

    def __getitem__(self, key):
        """Slicing returns an operator: ``op[rows, cols] == R @ op @ E``
        (reference: src/special-operators.jl:224-233). 0-based indices."""
        from ..ops.restriction import op_getindex

        if not (isinstance(key, tuple) and len(key) == 2):
            raise LinearOperatorException("operators are sliced with op[rows, cols]")
        return op_getindex(self, key[0], key[1])

    # ------------------------------------------------------------------
    # Symmetrizers (reference: src/abstract.jl:231-253)
    # ------------------------------------------------------------------

    def hermitianized(self):
        if self.nrow != self.ncol:
            raise LinearOperatorException("Operator is not square")
        if self.hermitian:
            return self
        return (self + self.H) / 2

    def symmetrized(self):
        if self.nrow != self.ncol:
            raise LinearOperatorException("Operator is not square")
        if self.symmetric:
            return self
        return (self + self.T) / 2

    # ------------------------------------------------------------------
    # Display (reference: src/abstract.jl:262-275)
    # ------------------------------------------------------------------

    def _name(self) -> str:
        return type(self).__name__

    def __repr__(self):
        return (
            f"{self._name()}\n"
            f"  nrow: {self.nrow}\n"
            f"  ncol: {self.ncol}\n"
            f"  dtype: {jnp.dtype(self.dtype).name}\n"
            f"  symmetric: {self.symmetric}\n"
            f"  hermitian: {self.hermitian}\n"
            f"  nprod:   {self.nprod}\n"
            f"  ntprod:  {self.ntprod}\n"
            f"  nctprod: {self.nctprod}\n"
        )
