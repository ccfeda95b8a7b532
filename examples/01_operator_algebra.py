"""Tour of the lazy operator algebra.

Run: PYTHONPATH=.. python 01_operator_algebra.py   (CPU or GPU)
"""

import jax
import jax.numpy as jnp
import numpy as np

import linops_tpu as lo

n = 6
rng = np.random.default_rng(0)
A = jnp.asarray(rng.standard_normal((n, n)))
d = jnp.arange(1.0, n + 1)

# Leaf operators
M = lo.LinearOperator(A)  # matrix-backed
D = lo.opDiagonal(d)
F = lo.LinearOperator(jnp.float32, n, n, True, True, lambda v: v[::-1])  # function-backed

# Algebra builds a graph; nothing is computed yet
expr = 2.0 * (D @ M) + M.T - lo.opEye(n) + lo.ShiftedOperator(D, 0.5)

v = jnp.ones(n)
print("expr * v      =", expr * v)  # one fused jit-compiled apply
print("expr' * v     =", expr.H * v)  # adjoint derived symbolically
print("dense(expr)   =\n", expr.to_dense())

# Slicing returns operators, never materialized rows (reference getindex)
sub = expr[jnp.arange(3), jnp.arange(4)]
print("slice shape   =", sub.shape, type(sub).__name__)

# Block structure
blk = lo.BlockDiagonalOperator(M, D)
cat = lo.hcat(M, D)
print("blockdiag     =", blk.shape, " hcat =", cat.shape)

# Kronecker products stay lazy (vec-trick applies)
K = lo.kron(M, D)
print("kron shape    =", K.shape, "; K*ones =", (K * jnp.ones(n * n))[:4], "...")

# Counters mirror the reference's nprod/ntprod/nctprod
expr.reset_counters()
_ = expr * v
_ = expr.T * v
print(repr(expr))
