"""Jitted Krylov-style drivers: matvec chains, CG, MINRES-like iteration.

The reference's clients (JSO solvers) call ``mul!`` in hot host loops; on
an accelerator per-call dispatch would dominate, so the idiomatic
equivalent keeps the *whole iteration* on device: one jit containing a
``lax.fori_loop``/``while_loop`` whose body applies the operator graph
(SURVEY.md §6).

All drivers take the operator as a pytree argument, so new operators with
the same graph structure hit the compiled cache.
"""

from __future__ import annotations

import functools

import jax
from ..core.precision import pcolumn_dot, pmatmul, pvdot
import jax.numpy as jnp
from jax import lax

from ..core.base import LinearOperator

__all__ = ["matvec_chain", "cg", "gmres", "minres", "bicgstab", "lsqr",
           "chebyshev", "power_iteration"]


@functools.partial(jax.jit, static_argnames=("iters", "mode", "normalize"))
def matvec_chain(op: LinearOperator, v, iters: int = 100, mode: str = "N",
                 normalize: bool = True):
    """Apply ``op`` ``iters`` times in one compiled loop (optionally
    normalizing each step to keep magnitudes bounded). Returns the final
    vector. The whole chain is ONE XLA computation: zero per-apply dispatch,
    compositions fused."""

    def body(_, x):
        y = op.apply(x, mode)
        if normalize:
            y = y / jnp.linalg.norm(y)
        return y

    return lax.fori_loop(0, iters, body, v)


@functools.partial(jax.jit, static_argnames=("maxiter",))
def cg(op: LinearOperator, b, x0=None, *, tol: float = 1e-8, maxiter: int = 100,
       M: LinearOperator = None):
    """Conjugate gradients on a symmetric positive-definite operator, with an
    optional operator preconditioner M ≈ A⁻¹ (e.g. an InverseLBFGSOperator).
    Returns (x, iterations, final residual norm). Entirely on device.

    A 2-D ``b`` of shape (n, k) solves all k systems simultaneously
    (independent per-column recurrences over multi-RHS ``apply_matrix``,
    so every operator read is amortized over k columns; converged columns
    freeze). Returns (X, iterations, per-column residual norms)."""
    if getattr(b, "ndim", 1) == 2:
        return _cg_multi(op, b, x0, tol=tol, maxiter=maxiter, M=M)
    dt = jnp.result_type(b.dtype, op.dtype)
    b = b.astype(dt)
    x = jnp.zeros_like(b) if x0 is None else x0.astype(dt)
    r = b - op.apply(x, "N")
    # preconditioner output is cast to the solver dtype so the while_loop
    # carry stays type-stable even for mixed-precision M
    z = M.apply(r, "N").astype(dt) if M is not None else r
    p = z
    rz = pvdot(r, z)
    bnorm = jnp.linalg.norm(b)
    tol2 = (tol * bnorm) ** 2

    def cond(state):
        _, r, _, _, k, _ = state
        return (pvdot(r, r).real > tol2) & (k < maxiter)

    def body(state):
        x, r, p, rz, k, _ = state
        Ap = op.apply(p, "N")
        alpha = rz / pvdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M.apply(r, "N").astype(dt) if M is not None else r
        rz_new = pvdot(r, z)
        p = z + (rz_new / rz) * p
        return x, r, p, rz_new, k + 1, jnp.sqrt(pvdot(r, r).real)

    init = (x, r, p, rz, jnp.zeros((), jnp.int32), jnp.linalg.norm(r))
    x, r, _, _, k, res = lax.while_loop(cond, body, init)
    return x, k, res


def _cg_multi(op: LinearOperator, B, X0=None, *, tol: float = 1e-8,
              maxiter: int = 100, M: LinearOperator = None):
    """Multi-RHS CG: k independent per-column recurrences in ONE compiled
    loop over ``apply_matrix`` (each operator read amortized over the k
    columns — the SpMM tier). Converged or broken-down columns freeze
    (their α is forced to 0), so late columns don't NaN early ones."""
    dt = jnp.result_type(B.dtype, op.dtype)
    B = B.astype(dt)
    X = jnp.zeros_like(B) if X0 is None else X0.astype(dt)

    def prec(R):
        return M.apply_matrix(R, "N").astype(dt) if M is not None else R

    def cdot(U, V):  # per-column <u, v> (policy-precision: see pcolumn_dot)
        return pcolumn_dot(U, V)

    R = B - op.apply_matrix(X, "N")
    Z = prec(R)
    P = Z
    rz = cdot(R, Z)
    tol2 = (tol * jnp.linalg.norm(B, axis=0)) ** 2

    def active(R):
        return cdot(R, R).real > tol2

    def cond(state):
        _, R, _, _, k = state
        return jnp.any(active(R)) & (k < maxiter)

    def body(state):
        X, R, P, rz, k = state
        act = active(R)
        AP = op.apply_matrix(P, "N")
        pAp = cdot(P, AP)
        safe = jnp.where(act & (pAp != 0), pAp, 1.0)
        alpha = jnp.where(act, rz / safe, 0.0)
        X = X + P * alpha[None, :]
        R = R - AP * alpha[None, :]
        Z = prec(R)
        rz_new = cdot(R, Z)
        beta = jnp.where(act & (rz != 0), rz_new / jnp.where(rz != 0, rz, 1.0), 0.0)
        P = Z + P * beta[None, :]
        return X, R, P, rz_new, k + 1

    init = (X, R, P, rz, jnp.zeros((), jnp.int32))
    X, R, _, _, k = lax.while_loop(cond, body, init)
    return X, k, jnp.sqrt(cdot(R, R).real)


@functools.partial(jax.jit, static_argnames=("restart", "maxiter"))
def gmres(op: LinearOperator, b, x0=None, *, tol: float = 1e-8,
          restart: int = 30, maxiter: int = 10, M: LinearOperator = None):
    """Restarted GMRES(m) for general square operators, with an optional
    left-preconditioner operator M ≈ A⁻¹. Arnoldi with full
    orthogonalization runs as one fused loop per restart cycle; the whole
    solve is a single compiled computation. Returns (x, restarts used,
    final residual norm)."""
    n = b.shape[0]
    dt = jnp.result_type(b.dtype, op.dtype)
    b = b.astype(dt)
    x = jnp.zeros_like(b) if x0 is None else x0.astype(dt)
    m = min(restart, n)
    bnorm = jnp.linalg.norm(b)
    tol_abs = tol * jnp.where(bnorm == 0, 1.0, bnorm)

    def prec(v):
        return M.apply(v, "N").astype(dt) if M is not None else v

    def arnoldi_cycle(x):
        r = prec(b - op.apply(x, "N"))
        beta = jnp.linalg.norm(r)
        V = jnp.zeros((m + 1, n), dt).at[0].set(r / jnp.where(beta == 0, 1.0, beta))
        H = jnp.zeros((m + 1, m), dt)

        def arnoldi_step(j, carry):
            V, H = carry
            w = prec(op.apply(V[j], "N"))
            hcol = pmatmul(jnp.conj(V), w)  # rows > j are zero vectors -> 0 coeffs
            mask = jnp.arange(m + 1) <= j
            hcol = jnp.where(mask, hcol, 0.0)
            w = w - pmatmul(V.T, hcol)
            hj1 = jnp.linalg.norm(w)
            V = V.at[j + 1].set(w / jnp.where(hj1 == 0, 1.0, hj1))
            H = H.at[:, j].set(hcol).at[j + 1, j].set(hj1.astype(dt))
            return V, H

        V, H = lax.fori_loop(0, m, arnoldi_step, (V, H))
        # least squares min ||beta e1 - H y||
        e1 = jnp.zeros((m + 1,), dt).at[0].set(beta)
        y = jnp.linalg.lstsq(H, e1)[0]
        return x + pmatmul(V[:m].T, y)

    def cond(state):
        x, k, res = state
        return (res > tol_abs) & (k < maxiter)

    def body(state):
        x, k, _ = state
        x = arnoldi_cycle(x)
        res = jnp.linalg.norm(b - op.apply(x, "N"))
        return x, k + 1, res

    res0 = jnp.linalg.norm(b - op.apply(x, "N"))
    x, k, res = lax.while_loop(cond, body, (x, jnp.zeros((), jnp.int32), res0))
    return x, k, res


@functools.partial(jax.jit, static_argnames=("maxiter",))
def minres(op: LinearOperator, b, x0=None, *, tol: float = 1e-8,
           maxiter: int = 100, M: LinearOperator = None):
    """MINRES (Paige–Saunders) for symmetric/Hermitian — possibly
    *indefinite* — operators, the solver JSO trust-region clients pair with
    opHermitian/L-SR1 models (reference models are merely symmetric, not SPD:
    /root/reference/src/lsr1.jl). Optional SPD preconditioner ``M ≈ A⁻¹``.
    One compiled ``while_loop``; returns (x, iterations, preconditioned
    residual norm estimate ``phibar``).

    A 2-D ``b`` of shape (n, k) solves all k systems simultaneously
    (independent per-column recurrences over multi-RHS ``apply_matrix``;
    converged columns freeze). Returns (X, iterations, per-column
    phibar)."""
    if getattr(b, "ndim", 1) == 2:
        return _minres_multi(op, b, x0, tol=tol, maxiter=maxiter, M=M)
    dt = jnp.result_type(b.dtype, op.dtype)
    b = b.astype(dt)
    x = jnp.zeros_like(b) if x0 is None else x0.astype(dt)
    rdt = jnp.zeros((), dt).real.dtype
    eps = jnp.finfo(rdt).eps

    def prec(v):
        return M.apply(v, "N").astype(dt) if M is not None else v

    r1 = b - op.apply(x, "N")
    y = prec(r1)
    beta1 = jnp.sqrt(jnp.maximum(pvdot(r1, y).real, 0.0))
    tol_abs = tol * jnp.where(beta1 == 0, 1.0, beta1)

    # carry: x, y, r1, r2, w, w2, oldb, beta, dbar, epsln, phibar, cs, sn, k
    zero = jnp.zeros((), rdt)
    init = (x, y, r1, r1, jnp.zeros_like(b), jnp.zeros_like(b),
            zero, beta1, zero, zero, beta1, -jnp.ones((), rdt), zero,
            jnp.zeros((), jnp.int32))

    def cond(state):
        phibar, k = state[10], state[13]
        return (phibar > tol_abs) & (k < maxiter)

    def body(state):
        (x, y, r1, r2, w, w2, oldb, beta, dbar, epsln, phibar,
         cs, sn, k) = state
        safe_beta = jnp.where(beta == 0, 1.0, beta)
        v = y / safe_beta.astype(dt)
        y = op.apply(v, "N")
        y = jnp.where(k >= 1, y - (beta / jnp.where(oldb == 0, 1.0, oldb)
                                   ).astype(dt) * r1, y)
        alfa = pvdot(v, y).real  # real for Hermitian op
        y = y - (alfa / safe_beta).astype(dt) * r2
        r1, r2 = r2, y
        y = prec(r2)
        oldb = beta
        beta = jnp.sqrt(jnp.maximum(pvdot(r2, y).real, 0.0))

        # previous Givens rotation applied to the new Lanczos column
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        # next rotation
        gamma = jnp.maximum(jnp.sqrt(gbar * gbar + beta * beta), eps)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar

        w1 = w2
        w2 = w
        w = (v - oldeps.astype(dt) * w1 - delta.astype(dt) * w2) \
            / gamma.astype(dt)
        x = x + phi.astype(dt) * w
        return (x, y, r1, r2, w, w2, oldb, beta, dbar, epsln, phibar,
                cs, sn, k + 1)

    out = lax.while_loop(cond, body, init)
    return out[0], out[13], out[10]


def _minres_multi(op: LinearOperator, B, X0=None, *, tol: float = 1e-8,
                  maxiter: int = 100, M: LinearOperator = None):
    """Multi-RHS MINRES: k independent per-column Paige–Saunders
    recurrences in ONE compiled loop over ``apply_matrix`` (every
    operator read amortized over the k columns, like ``_cg_multi``).
    Converged columns freeze their solution update (phi forced to 0)."""
    dt = jnp.result_type(B.dtype, op.dtype)
    B = B.astype(dt)
    X = jnp.zeros_like(B) if X0 is None else X0.astype(dt)
    rdt = jnp.zeros((), dt).real.dtype
    eps = jnp.finfo(rdt).eps
    kcols = B.shape[1]

    def prec(R):
        return M.apply_matrix(R, "N").astype(dt) if M is not None else R

    def cdot(U, V):  # per-column <u, v> (policy-precision: see pcolumn_dot)
        return pcolumn_dot(U, V)

    R1 = B - op.apply_matrix(X, "N")
    Y = prec(R1)
    beta1 = jnp.sqrt(jnp.maximum(cdot(R1, Y).real, 0.0))
    tol_abs = tol * jnp.where(beta1 == 0, 1.0, beta1)

    zero = jnp.zeros((kcols,), rdt)
    init = (X, Y, R1, R1, jnp.zeros_like(B), jnp.zeros_like(B),
            zero, beta1, zero, zero, beta1, -jnp.ones((kcols,), rdt), zero,
            jnp.zeros((), jnp.int32))

    def cond(state):
        phibar, k = state[10], state[13]
        return jnp.any(phibar > tol_abs) & (k < maxiter)

    def body(state):
        (X, Y, R1, R2, W, W2, oldb, beta, dbar, epsln, phibar,
         cs, sn, k) = state
        act = phibar > tol_abs
        safe_beta = jnp.where(beta == 0, 1.0, beta)
        V = Y / safe_beta[None, :].astype(dt)
        Y = op.apply_matrix(V, "N")
        Y = jnp.where(k >= 1,
                      Y - (beta / jnp.where(oldb == 0, 1.0, oldb)
                           )[None, :].astype(dt) * R1, Y)
        alfa = cdot(V, Y).real  # real for Hermitian op
        Y = Y - (alfa / safe_beta)[None, :].astype(dt) * R2
        R1, R2 = R2, Y
        Y = prec(R2)
        oldb = beta
        beta = jnp.sqrt(jnp.maximum(cdot(R2, Y).real, 0.0))

        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = jnp.maximum(jnp.sqrt(gbar * gbar + beta * beta), eps)
        cs = gbar / gamma
        sn = beta / gamma
        phi = jnp.where(act, cs * phibar, 0.0)  # frozen columns stop moving
        phibar = jnp.where(act, sn * phibar, phibar)

        W1 = W2
        W2 = W
        W = (V - oldeps[None, :].astype(dt) * W1
             - delta[None, :].astype(dt) * W2) / gamma[None, :].astype(dt)
        X = X + phi[None, :].astype(dt) * W
        return (X, Y, R1, R2, W, W2, oldb, beta, dbar, epsln, phibar,
                cs, sn, k + 1)

    out = lax.while_loop(cond, body, init)
    return out[0], out[13], out[10]


@functools.partial(jax.jit, static_argnames=("maxiter",))
def bicgstab(op: LinearOperator, b, x0=None, *, tol: float = 1e-8,
             maxiter: int = 100, M: LinearOperator = None):
    """BiCGSTAB (van der Vorst) for general nonsymmetric square operators,
    with an optional right preconditioner ``M ≈ A⁻¹``. One compiled
    ``while_loop``; two operator applies (+ two M applies) per iteration.
    Returns (x, iterations, final residual norm). On a Lanczos breakdown
    (rho = r̂·r ≈ 0, r̂·v ≈ 0, or stabilizer omega ≈ 0 — e.g. skew-symmetric
    A) the loop stops with the last iterate and its TRUE residual norm, so
    non-convergence is visible as ``res > tol·‖b‖`` rather than silent
    NaNs (scipy signals the same condition via ``info < 0``)."""
    dt = jnp.result_type(b.dtype, op.dtype)
    b = b.astype(dt)
    x = jnp.zeros_like(b) if x0 is None else x0.astype(dt)
    rdt = jnp.zeros((), dt).real.dtype
    tiny = jnp.sqrt(jnp.finfo(rdt).tiny)  # catches exact/denormal zeros

    def prec(v):
        return M.apply(v, "N").astype(dt) if M is not None else v

    r = b - op.apply(x, "N")
    rhat = r  # shadow residual, fixed
    one = jnp.ones((), dt)
    bnorm = jnp.linalg.norm(b)
    tol_abs = tol * jnp.where(bnorm == 0, 1.0, bnorm)

    # carry: x, r, p, v, rho, alpha, omega, brk, k
    init = (x, r, jnp.zeros_like(b), jnp.zeros_like(b), one, one, one,
            jnp.zeros((), bool), jnp.zeros((), jnp.int32))

    def cond(state):
        r, brk, k = state[1], state[7], state[8]
        return (jnp.linalg.norm(r) > tol_abs) & (k < maxiter) & ~brk

    def body(state):
        x, r, p, v, rho, alpha, omega, _, k = state
        rho_new = pvdot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p_new = r + beta * (p - omega * v)
        phat = prec(p_new)
        v_new = op.apply(phat, "N")
        rhv = pvdot(rhat, v_new)
        brk = (jnp.abs(rho_new) <= tiny) | (jnp.abs(rhv) <= tiny)
        alpha_new = rho_new / jnp.where(brk, one, rhv)
        s = r - alpha_new * v_new
        shat = prec(s)
        t = op.apply(shat, "N")
        tt = pvdot(t, t)
        omega_new = pvdot(t, s) / jnp.where(tt == 0, 1.0, tt)
        brk = brk | (jnp.abs(omega_new) <= tiny)
        x_new = x + alpha_new * phat + omega_new * shat
        r_new = s - omega_new * t
        # on breakdown freeze the iterate (cond exits next check)
        keep = lambda new, old: jnp.where(brk, old, new)
        return (keep(x_new, x), keep(r_new, r), keep(p_new, p),
                keep(v_new, v), keep(rho_new, rho), keep(alpha_new, alpha),
                keep(omega_new, omega), brk, k + 1)

    x, r, *_rest = lax.while_loop(cond, body, init)
    k = _rest[-1]
    return x, k, jnp.linalg.norm(r)


@functools.partial(jax.jit, static_argnames=("maxiter",))
def lsqr(op: LinearOperator, b, *, damp: float = 0.0, tol: float = 1e-8,
         maxiter: int = 100):
    """LSQR (Paige–Saunders) — min ‖Ax − b‖² + damp²‖x‖² for general
    (rectangular) operators via Golub–Kahan bidiagonalization. This is the
    canonical least-squares client of the reference's rectangular operators
    (opRestriction/opExtension products etc.); only ``N`` and adjoint
    applies are needed. One compiled ``while_loop``; returns
    (x, iterations, ‖Aᴴr‖ estimate)."""
    dt = jnp.result_type(b.dtype, op.dtype)
    b = b.astype(dt)
    rdt = jnp.zeros((), dt).real.dtype
    n = op.shape[1]
    dampf = jnp.asarray(damp, rdt)

    def nrm(v):
        return jnp.linalg.norm(v).astype(rdt)

    beta = nrm(b)
    u = b / jnp.where(beta == 0, 1.0, beta).astype(dt)
    v = op.apply(u, "H")
    alpha = nrm(v)
    v = v / jnp.where(alpha == 0, 1.0, alpha).astype(dt)
    arnorm0 = alpha * beta  # ‖Aᴴ b‖ scale for the stopping test
    tol_abs = tol * jnp.where(arnorm0 == 0, 1.0, arnorm0)

    # carry: x, u, v, w, phibar, rhobar, alpha, arnorm, k
    init = (jnp.zeros((n,), dt), u, v, v, beta, alpha, alpha, arnorm0,
            jnp.zeros((), jnp.int32))

    def cond(state):
        arnorm, k = state[7], state[8]
        return (arnorm > tol_abs) & (k < maxiter)

    def body(state):
        x, u, v, w, phibar, rhobar, alpha, _, k = state
        # bidiagonalization step
        u = op.apply(v, "N") - alpha.astype(dt) * u
        beta = nrm(u)
        u = u / jnp.where(beta == 0, 1.0, beta).astype(dt)
        v = op.apply(u, "H") - beta.astype(dt) * v
        alpha_new = nrm(v)
        v = v / jnp.where(alpha_new == 0, 1.0, alpha_new).astype(dt)
        # eliminate the damping term (rotation into the rhobar row)
        rhobar1 = jnp.sqrt(rhobar * rhobar + dampf * dampf)
        c1 = rhobar / rhobar1
        phibar1 = c1 * phibar
        # QR rotation on the lower-bidiagonal column
        rho = jnp.sqrt(rhobar1 * rhobar1 + beta * beta)
        c = rhobar1 / rho
        s = beta / rho
        theta = s * alpha_new
        rhobar_new = -c * alpha_new
        phi = c * phibar1
        phibar_new = s * phibar1
        x = x + (phi / rho).astype(dt) * w
        w = v - (theta / rho).astype(dt) * w
        # (rhobar, phibar) are defined only up to a joint sign flip (the
        # damping rotation may negate both), so take |·| for the estimate
        arnorm = jnp.abs(phibar_new * alpha_new * c)
        return x, u, v, w, phibar_new, rhobar_new, alpha_new, arnorm, k + 1

    out = lax.while_loop(cond, body, init)
    return out[0], out[8], out[7]


@functools.partial(jax.jit, static_argnames=("iters",))
def power_iteration(op: LinearOperator, v0, iters: int = 50):
    """Largest-|eigenvalue| estimate of a square operator by power iteration
    in one compiled loop. Returns (eigenvalue estimate, eigenvector)."""

    def body(_, carry):
        v, _ = carry
        w = op.apply(v, "N")
        lam = pvdot(v, w)
        return w / jnp.linalg.norm(w), lam

    v = v0 / jnp.linalg.norm(v0)
    v, lam = lax.fori_loop(0, iters, body, (v, jnp.zeros((), v.dtype)))
    return lam, v


@functools.partial(jax.jit, static_argnames=("iters",))
def chebyshev(op: LinearOperator, b, lam_min, lam_max, x0=None, *,
              iters: int = 50, M: LinearOperator = None):
    """Chebyshev iteration for SPD operators with spectral bounds
    ``0 < lam_min <= lam(A) <= lam_max`` (estimate them once with
    :func:`linops_tpu.lobpcg` / :func:`linops_tpu.normest`).

    The COMMUNICATION-AVOIDING solver: the loop body contains NO inner
    products, so a distributed solve moves only the operator's own
    collectives (e.g. the halo permutes) — zero all-reduces per
    iteration, where CG pays two. The classic production smoother /
    preconditioner when the spectrum interval is known; convergence rate
    per iteration is ``(sqrt(kappa) - 1) / (sqrt(kappa) + 1)`` like CG,
    but without CG's adaptivity — pessimistic bounds cost iterations.

    Runs a FIXED ``iters`` (no convergence test: that would be a
    reduction); the final residual norm is computed once at the end.
    Returns ``(x, iters, final residual norm)``. ``M`` (SPD, e.g.
    Jacobi) preconditions: the bounds must then bracket ``lam(M A)``.
    """
    dt = jnp.result_type(b.dtype, op.dtype)
    b = b.astype(dt)
    x = jnp.zeros_like(b) if x0 is None else x0.astype(dt)
    rdt = jnp.zeros((), dt).real.dtype
    lam_min = jnp.asarray(lam_min, rdt)
    lam_max = jnp.asarray(lam_max, rdt)

    def prec(v):
        return M.apply(v, "N").astype(dt) if M is not None else v

    d = (lam_max + lam_min) / 2.0
    c = (lam_max - lam_min) / 2.0

    # classical Chebyshev (Saad alg. 12.1 with the first-step special
    # case beta_1 = (c alpha)^2 / 2 — the steady-state (c alpha / 2)^2 on
    # step one is a known Templates-book erratum that costs 2-7x in error;
    # both variants verified numerically against T_k((d-lam)/c)/T_k(d/c))
    if iters >= 1:
        r = prec(b - op.apply(x, "N"))
        alpha = 1.0 / d
        p = r
        x = x + alpha.astype(dt) * p
    if iters >= 2:
        r = r - alpha.astype(dt) * prec(op.apply(p, "N"))
        beta = 0.5 * (c * alpha) ** 2
        alpha = 1.0 / (d - beta / alpha)
        p = r + beta.astype(dt) * p
        x = x + alpha.astype(dt) * p

        def body(_, state):
            x, r, p, alpha = state
            r = r - alpha.astype(dt) * prec(op.apply(p, "N"))
            beta = (c * alpha / 2.0) ** 2
            alpha = 1.0 / (d - beta / alpha)
            p = r + beta.astype(dt) * p
            x = x + alpha.astype(dt) * p
            return (x, r, p, alpha)

        x, *_ = lax.fori_loop(0, iters - 2, body, (x, r, p, alpha))
    res = jnp.linalg.norm(b - op.apply(x, "N"))
    return x, jnp.asarray(max(iters, 0), jnp.int32), res
