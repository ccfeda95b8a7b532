"""The apply engine: jit-cached eager entry points and 5-arg mul! semantics.

The reference's hot path is the 5-arg ``mul!(res, op, v, α, β)``
(reference: src/operations.jl:22-40) with lazily-allocated scratch buffers to
emulate α/β for 3-arg closures. Here every apply traces the operator graph
into ONE jaxpr; α/β become a fused axpby epilogue; buffer reuse becomes XLA
donation (SURVEY.md §2.3 'Buffer donation / aliasing'). β==0 is specialized at
trace time where the value is statically known, and is NaN-safe otherwise via
``jnp.where`` (mirroring the reference's explicit β==0 branch,
reference: src/constructors.jl:66-78).

jit caching: operators are pytrees, so re-applying an operator (or a new
operator with the same graph structure) hits the compiled cache — the
analogue of the reference's zero-allocation contract
(reference: test/test_linop_allocs.jl).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .base import LinearOperator, LinearOperatorException

__all__ = ["matvec", "matmat", "mul", "to_dense", "apply_cache_sizes"]


def _checked(op: LinearOperator, v, y, batched: bool = False):
    """Trace-time eltype check + fused cast.

    Mirrors the reference behavior where an operator lying about its eltype
    raises (InexactError in Julia; reference: src/constructors.jl:46-61)."""
    expected = jnp.result_type(op.dtype, v.dtype)
    if jnp.result_type(y.dtype, expected) != expected:
        raise LinearOperatorException(
            f"operator produced dtype {y.dtype} incompatible with declared "
            f"eltype {jnp.dtype(op.dtype).name} (expected {expected})"
        )
    return y.astype(expected)


# ----------------------------------------------------------------------------
# jitted kernels (operators are pytree args; mode is static)
# ----------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("mode",))
def _apply(op, v, mode):
    return _checked(op, v, op.apply(v, mode))


@functools.partial(jax.jit, static_argnames=("mode",))
def _apply_scaled(op, v, alpha, mode):
    return alpha * _checked(op, v, op.apply(v, mode))


@functools.partial(jax.jit, static_argnames=("mode",))
def _apply_axpby(op, v, alpha, beta, res, mode):
    y = alpha * _checked(op, v, op.apply(v, mode))
    # NaN-safe β==0 handling for traced β (reference prod3! branches at
    # runtime, src/operations.jl:10-20)
    return jnp.where(beta == 0, y, y + beta * res)


@functools.partial(jax.jit, static_argnames=("mode",), donate_argnums=(4,))
def _apply_axpby_donated(op, v, alpha, beta, res, mode):
    y = alpha * _checked(op, v, op.apply(v, mode))
    return jnp.where(beta == 0, y, y + beta * res)


@functools.partial(jax.jit, static_argnames=("mode",))
def _apply_mat(op, M, mode):
    return _checked(op, M, op.apply_matrix(M, mode), batched=True)


@functools.partial(jax.jit, static_argnames=("mode",))
def _apply_mat_scaled(op, M, alpha, mode):
    return alpha * _checked(op, M, op.apply_matrix(M, mode), batched=True)


@functools.partial(jax.jit, static_argnames=("mode",))
def _apply_mat_axpby(op, M, alpha, beta, Res, mode):
    Y = alpha * _checked(op, M, op.apply_matrix(M, mode), batched=True)
    return jnp.where(beta == 0, Y, Y + beta * Res)


@functools.partial(jax.jit, static_argnames=("mode",), donate_argnums=(4,))
def _apply_mat_axpby_donated(op, M, alpha, beta, Res, mode):
    Y = alpha * _checked(op, M, op.apply_matrix(M, mode), batched=True)
    return jnp.where(beta == 0, Y, Y + beta * Res)


# ----------------------------------------------------------------------------
# public API
# ----------------------------------------------------------------------------


def _check_vec_shape(op: LinearOperator, v, mode: str):
    if v.ndim != 1 or v.shape[0] != op.in_dim(mode):
        raise LinearOperatorException("shape mismatch")


def matvec(op: LinearOperator, v, mode: str = "N"):
    """``op * v`` (mode N), ``transpose(op) * v`` (T), ``op' * v`` (H),
    ``conj(op) * v`` (C). Result dtype follows promote_type(op, v)
    (reference: src/operations.jl:43-48)."""
    v = jnp.asarray(v)
    _check_vec_shape(op, v, mode)
    op.bump(mode)
    return _apply(op, v, mode)


def matmat(op: LinearOperator, M, mode: str = "N"):
    """Apply to a matrix column-block (SpMM / multi-RHS)."""
    M = jnp.asarray(M)
    if M.ndim != 2 or M.shape[0] != op.in_dim(mode):
        raise LinearOperatorException("shape mismatch")
    op.bump(mode)
    return _apply_mat(op, M, mode)


def _static_zero(x) -> bool:
    return x is None or (isinstance(x, (int, float, complex)) and x == 0)


def _static_one(x) -> bool:
    return x is None or (isinstance(x, (int, float, complex)) and x == 1)


def mul(op: LinearOperator, v, alpha=None, beta=None, res=None, mode: str = "N", donate: bool = False):
    """Functional 5-arg ``mul!``: returns ``alpha * op(v) + beta * res``.

    ``v`` may be a vector (reference: src/operations.jl:22-32) or a matrix
    column-block — the matrix-RHS 5-arg form
    ``mul!(res::AbstractMatrix, op, m::AbstractMatrix, α, β)``
    (reference: src/operations.jl:34-40); ``res`` must match ``v``'s rank.

    - ``beta`` statically zero (None/0) -> the NaN-safe specialized path that
      never reads ``res`` (reference: src/constructors.jl:66-78).
    - ``donate=True`` donates ``res``'s buffer to XLA so the update is
      performed in place on device (the reference's preallocated-res
      semantics, reference: src/operations.jl:22-32).
    """
    v = jnp.asarray(v)
    if v.ndim == 2:
        if v.shape[0] != op.in_dim(mode):
            raise LinearOperatorException("shape mismatch")
        op.bump(mode)
        if _static_zero(beta):
            if _static_one(alpha):
                return _apply_mat(op, v, mode)
            return _apply_mat_scaled(op, v, alpha, mode)
        if res is None:
            raise LinearOperatorException("5-arg mul with nonzero beta requires res")
        if jnp.shape(res) != (op.out_dim(mode), v.shape[1]):
            raise LinearOperatorException(
                f"matrix-RHS mul: res shape {jnp.shape(res)} != "
                f"{(op.out_dim(mode), v.shape[1])}"
            )
        a = 1 if alpha is None else alpha
        fn = _apply_mat_axpby_donated if donate else _apply_mat_axpby
        return fn(op, v, a, beta, res, mode)
    _check_vec_shape(op, v, mode)
    op.bump(mode)
    if _static_zero(beta):
        if _static_one(alpha):
            return _apply(op, v, mode)
        return _apply_scaled(op, v, alpha, mode)
    if res is None:
        raise LinearOperatorException("5-arg mul with nonzero beta requires res")
    a = 1 if alpha is None else alpha
    fn = _apply_axpby_donated if donate else _apply_axpby
    return fn(op, v, a, beta, res, mode)


def to_dense(op: LinearOperator, block_size: int = 4096):
    """Materialize as dense by applying to identity column blocks
    (reference Matrix(op): src/abstract.jl:282-292, but blockwise SpMM
    per SURVEY.md §3.5)."""
    n = op.ncol
    dt = op.dtype
    if n <= block_size:
        return _apply_mat(op, jnp.eye(n, dtype=dt), "N")
    blocks = []
    for j0 in range(0, n, block_size):
        bs = min(block_size, n - j0)
        eye_blk = jnp.eye(n, bs, k=-j0, dtype=dt)
        blocks.append(_apply_mat(op, eye_blk, "N"))
    return jnp.concatenate(blocks, axis=1)


def apply_cache_sizes() -> dict:
    """Compiled-cache sizes of the engine entry points — the analogue of
    the reference's zero-allocation assertions: tests check these do NOT grow
    across repeated applies (no recompilation in the hot path)."""
    out = {}
    for name, fn in [
        ("apply", _apply),
        ("apply_scaled", _apply_scaled),
        ("apply_axpby", _apply_axpby),
        ("apply_axpby_donated", _apply_axpby_donated),
        ("apply_mat", _apply_mat),
        ("apply_mat_scaled", _apply_mat_scaled),
        ("apply_mat_axpby", _apply_mat_axpby),
        ("apply_mat_axpby_donated", _apply_mat_axpby_donated),
    ]:
        try:
            out[name] = fn._cache_size()
        except Exception:
            out[name] = -1
    return out
