"""Operator norm estimation.

- ``normest``: Matlab-style power iteration on S'S, a direct functional
  analogue of the reference (src/utilities.jl:20-59) compiled as one
  ``lax.while_loop`` (SURVEY.md §3.5: 'normest becomes a jitted while_loop').
- ``estimate_opnorm``: the reference's ARPACK/TSVD extension
  (ext/LinearOperatorsOpNormExt.jl:12-136) re-built in JAX: tiny dense
  fallback, Lanczos with full reorthogonalization for hermitian operators,
  Lanczos on the Gram operator otherwise, with ncv-doubling retries and a
  ``(nan, False)`` exhaustion result.
"""

from __future__ import annotations

import functools
import warnings

import jax
import jax.numpy as jnp

from ..core.base import LinearOperator, LinearOperatorException
from .rng import fresh_key

__all__ = ["normest", "estimate_opnorm"]


def _real_eps(dtype) -> float:
    return float(jnp.finfo(jnp.real(jnp.zeros((), dtype)).dtype).eps)


@functools.partial(jax.jit, static_argnames=("maxiter",))
def _normest_jit(op, v0, reseed_noise, tol, maxiter):
    dt = v0.dtype

    x = op.apply(v0, "H")
    e0_init = jnp.linalg.norm(x)

    def cond(carry):
        x, e, e_prev, cnt = carry
        return jnp.logical_and(jnp.abs(e - e_prev) > tol * e, cnt <= maxiter)

    def body(carry):
        x, e, _, cnt = carry
        Sx = op.apply(x, "N")
        # reseed on an exactly-zero image (reference: src/utilities.jl:44-46)
        all_zero = jnp.all(Sx == 0)
        Sx = jnp.where(all_zero, reseed_noise, Sx)
        x = op.apply(Sx, "H")
        normx = jnp.linalg.norm(x)
        e_new = normx / jnp.linalg.norm(Sx)
        x = x / normx
        return (x, e_new, e, cnt + 1)

    zero = jnp.zeros((), e0_init.dtype)
    x_unit = jnp.where(e0_init == 0, x, x / jnp.where(e0_init == 0, 1.0, e0_init))
    x_fin, e_fin, _, cnt = jax.lax.while_loop(
        cond, body, (x_unit, e0_init, zero, jnp.zeros((), jnp.int32))
    )
    # e == 0 initially -> return immediately (reference: :33-35)
    e_fin = jnp.where(e0_init == 0, e0_init, e_fin)
    cnt = jnp.where(e0_init == 0, 0, cnt)
    return e_fin, cnt


def normest(op, tol: float = -1, maxiter: int = 100, key=None):
    """Estimate the 2-norm of ``op`` by power iteration on S'S.

    Returns ``(estimate, iterations)`` (reference: src/utilities.jl:20-59)."""
    if not isinstance(op, LinearOperator):
        from ..core.dense import aslinearoperator

        op = aslinearoperator(op)
    m, n = op.shape
    dt = jnp.dtype(op.dtype)
    if not jnp.issubdtype(dt, jnp.inexact):
        dt = jnp.dtype(jnp.float64)
    if tol == -1:
        tol = _real_eps(dt)
    if key is None:
        key = fresh_key()
    k1, k2 = jax.random.split(key)
    # sign-randomized all-ones start (reference: :27-28)
    signs = jnp.where(jax.random.normal(k1, (m,)) < 0, -1.0, 1.0)
    v0 = signs.astype(dt)
    reseed_noise = jax.random.normal(k2, (m,)).astype(dt)
    e, cnt = _normest_jit(op, v0, reseed_noise, jnp.asarray(tol, jnp.real(v0).dtype), maxiter)
    e, cnt = float(e), int(cnt)
    if cnt > maxiter:
        warnings.warn(f"normest did not converge (maxiter={maxiter}, tol={tol})")
    return e, cnt


# ----------------------------------------------------------------------------
# Lanczos-based opnorm estimation (ARPACK equivalent)
# ----------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("ncv", "gram"))
def _lanczos_extreme(op, v0, ncv, gram):
    """Lanczos with full reorthogonalization (two sweeps); returns
    (theta, resid) for the largest-|.|-eigenvalue Ritz pair of `op`
    (gram=False, hermitian op) or of A^H A (gram=True). Built on the
    library's one Lanczos recurrence (utils/estimate.py)."""
    from .estimate import _lanczos_tridiag


    def matvec(x):
        if gram:
            return op.apply(op.apply(x, "N"), "H")
        return op.apply(x, "N")

    v = v0 / jnp.linalg.norm(v0)
    _, alphas, betas = _lanczos_tridiag(matvec, v, ncv, reorth=True, passes=2)

    T = jnp.diag(alphas) + jnp.diag(betas[:-1], 1) + jnp.diag(betas[:-1], -1)
    evals, evecs = jnp.linalg.eigh(T)
    idx = jnp.argmax(jnp.abs(evals))
    theta = evals[idx]
    # Ritz residual: |beta_ncv * last component of Ritz vector|
    resid = jnp.abs(betas[-1] * evecs[-1, idx])
    return theta, resid


def estimate_opnorm(
    op,
    max_attempts: int = 3,
    tiny_dense_threshold: int = 5,
    ncv: int = 20,
    key=None,
    rtol: float = None,
    lobpcg_fallback: bool = True,
):
    """Estimate the operator 2-norm. Returns ``(norm, success)``.

    Dispatch mirrors the reference extension
    (ext/LinearOperatorsOpNormExt.jl): tiny -> dense LAPACK; hermitian ->
    Lanczos eigensolve (Arpack.eigs analogue); general -> Lanczos on A^H A
    (Arpack.svds analogue); retries double the Krylov dimension. When the
    retries exhaust (e.g. a clustered spectrum edge), one LOBPCG solve is
    tried before giving up (``lobpcg_fallback=False`` restores the
    reference's plain-exhaustion behavior — note the fallback compiles
    and runs up to two block eigensolves, so latency-critical callers
    that prefer a fast (NaN, False) should disable it); exhaustion
    returns (NaN, False)."""
    if not isinstance(op, LinearOperator):
        from ..core.dense import aslinearoperator

        op = aslinearoperator(op)
    m, n = op.shape
    dt = jnp.dtype(op.dtype)
    if not jnp.issubdtype(dt, jnp.inexact):
        dt = jnp.dtype(jnp.float64)
    if rtol is None:
        rtol = _real_eps(dt) ** 0.5

    if min(m, n) <= tiny_dense_threshold:
        A = op.to_dense().astype(dt)
        if op.hermitian:
            return float(jnp.max(jnp.abs(jnp.linalg.eigvalsh(A)))), True
        return float(jnp.max(jnp.linalg.svd(A, compute_uv=False))), True

    if key is None:
        key = fresh_key()

    hermitian = op.hermitian and m == n
    gram = not hermitian
    dim = m if hermitian else n

    for attempt in range(max_attempts):
        k = min(dim, ncv * (2**attempt))
        v0 = jax.random.normal(key, (dim,)).astype(dt)
        theta, resid = _lanczos_extreme(op, v0, int(k), gram)
        theta_f, resid_f = float(theta), float(resid)
        est = abs(theta_f) if hermitian else float(jnp.sqrt(max(theta_f, 0.0)))
        if resid_f <= rtol * max(abs(theta_f), 1e-30) or k >= dim:
            return est, True
        warnings.warn(
            f"estimate_opnorm: Lanczos residual {resid_f:.2e} too large with ncv={k}; retrying"
        )
        key, _ = jax.random.split(key)

    if lobpcg_fallback:
        # clustered/degenerate extremal eigenvalues stall single-vector
        # Lanczos; a small BLOCK captures the whole cluster (utils/eig.py
        # — k=1 stalls at ~1e-7 on the doubly-degenerate Laplacian edge
        # where k=4 reaches 1e-13)
        from .eig import _GramOperator, lobpcg

        kb = max(1, min(4, min(m, n) // 3))

        def converged(th, res):
            # lobpcg's own stopping contract: res <= tol * max(|theta|, 1)
            return float(res[0]) <= rtol * max(abs(float(th[0])), 1.0)

        try:
            if hermitian:
                ends = []
                for largest in (True, False):
                    th, _, res, _ = lobpcg(
                        op, k=kb, largest=largest, tol=rtol, maxiter=20 * ncv,
                        key=key,
                    )
                    if not converged(th, res):
                        break  # the other end can't rescue max(|lambda|)
                    ends.append(abs(float(th[0])))
                if len(ends) == 2:
                    return max(ends), True
            else:
                th, _, res, _ = lobpcg(
                    _GramOperator(op, "right" if n <= m else "left"),
                    k=kb, largest=True, tol=rtol, maxiter=20 * ncv, key=key,
                )
                if converged(th, res):
                    return float(jnp.sqrt(max(float(th[0]), 0.0))), True
        except (LinearOperatorException, ValueError, FloatingPointError) as e:
            # expected numerical failures keep the best-effort (NaN, False)
            # contract; device errors and programming errors (shape bugs,
            # lobpcg regressions) propagate
            warnings.warn(f"estimate_opnorm: lobpcg fallback failed: {e}")
    return float("nan"), False
