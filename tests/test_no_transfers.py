"""Analogue of the reference's zero-allocation tests (SURVEY.md §4,
reference test/test_linop_allocs.jl): after warmup, the hot paths must
perform NO implicit host<->device transfers (jax.transfer_guard) and no
recompilation (cache-size assertions live in test_lbfgs/test_linop).

Python-scalar kwargs (tol=1e-8) intentionally transfer one 8-byte scalar
per SOLVE call — that is per-solve, not per-iteration, and disappears
when the caller passes a device scalar, as these tests do.
"""

import jax
import jax.numpy as jnp
import numpy as np

import linops_tpu as lo


def test_hot_paths_no_host_transfers(rng):
    n = 64
    A = jnp.asarray(rng.standard_normal((n, n)))
    Aspd = A @ A.T + n * jnp.eye(n)
    op = lo.LinearOperator(Aspd, symmetric=True, hermitian=True)
    v = jnp.asarray(rng.standard_normal(n))
    tol = jnp.asarray(1e-8, Aspd.dtype)
    two = jnp.asarray(2.0, v.dtype)

    B = lo.LBFGSOperator(n, mem=4, dtype=Aspd.dtype)
    s = jnp.asarray(rng.standard_normal(n))
    y = s + jnp.asarray(0.1 * rng.standard_normal(n))

    # warmup: compiles (and their constant transfers) happen here
    _ = op @ v
    _ = lo.cg(op, v, tol=tol, maxiter=20)
    _ = lo.matvec_chain(op, v, 5)
    B.push(s, y)
    _ = B @ v
    res0 = jnp.zeros_like(v)
    _ = lo.mul(op, v, two, tol, res0)

    with jax.transfer_guard("disallow"):
        for _ in range(3):
            w = op @ v                       # eager apply, cached jit
        x, k, res = lo.cg(op, v, tol=tol, maxiter=20)
        _ = lo.matvec_chain(op, w, 5)
        B.push(jnp.sin(v), jnp.cos(v) * two)  # QN state swap
        _ = B @ v
        _ = lo.mul(op, v, two, tol, res0)  # 5-arg axpby
    # host fetch OUTSIDE the guard
    assert np.all(np.isfinite(np.asarray(x)))
    assert np.all(np.isfinite(np.asarray(w)))
