"""Matmul precision policy: precision follows storage dtype.

A float32 contraction at DEFAULT precision may run on reduced-precision
matrix units: on the H100, XLA may hand it to the TF32 tensor cores (about
three decimal digits), silently breaking the f32-exact semantics users of
the reference get from BLAS (reference delegation points:
src/constructors.jl:25-27, src/operations.jl:34).

Policy (applied to every library contraction):

- any bf16 input  → ``Precision.DEFAULT`` — bf16 storage opts into the
  tensor cores; products accumulate in float32.
- otherwise       → ``Precision.HIGHEST`` — keeps float32 off TF32 (and
  float64 in float64). Matvec-shaped contractions are bound by memory, so
  this costs them nothing; compute-bound matmat shapes give up the TF32
  rate (495 vs 67 TFLOP/s published for the H100 SXM), where
  correctness-by-default wins.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["matmul_precision", "pdot", "pmatmul", "pvdot", "pcolumn_dot"]


def matmul_precision(*dtypes):
    """The library-wide precision for a contraction over ``dtypes``."""
    if any(jnp.dtype(d) == jnp.bfloat16 for d in dtypes):
        return jax.lax.Precision.DEFAULT
    return jax.lax.Precision.HIGHEST


def pdot(a, b, **kw):
    """``jnp.dot`` under the storage-follows-precision policy."""
    return jnp.dot(a, b, precision=matmul_precision(a.dtype, b.dtype), **kw)


def pmatmul(a, b, **kw):
    """``a @ b`` under the storage-follows-precision policy."""
    return jnp.matmul(a, b, precision=matmul_precision(a.dtype, b.dtype), **kw)


def pvdot(a, b, **kw):
    """``jnp.vdot`` under the storage-follows-precision policy."""
    return jnp.vdot(a, b, precision=matmul_precision(a.dtype, b.dtype), **kw)


def pcolumn_dot(U, V):
    """Per-column ``<u_j, v_j>`` of two (n, k) blocks under the policy.

    A plain ``sum(conj(U) * V, axis=0)`` can be rewritten by XLA into a
    contraction at DEFAULT precision (TF32 for float32 on the GPU), which
    the precision-sensitive multi-RHS Krylov recurrences must not absorb."""
    return jnp.einsum(
        "ij,ij->j", jnp.conj(U), V,
        precision=matmul_precision(U.dtype, V.dtype),
    )
