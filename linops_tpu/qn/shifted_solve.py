"""Shifted L-BFGS system solver: (B + σI) x = b for a forward L-BFGS operator.

JAX implementation of the Erway-Jain-Marcia recursive
Sherman-Morrison-Woodbury method (reference: src/utilities.jl:151-289;
"Shifted L-BFGS Systems", Optim. Methods Softw. 29(5), 2014).

Two methods:

- ``compact`` (default): Woodbury on the forward compact (BNS)
  representation — two (2·mem, n) passes + one small dense solve, fully
  batched. Exact for every σ ≥ 0 including σ = 0 on partially-filled
  rings.
- ``ejm``: faithful EJM recursion; its 2·mem sequential rank-1 corrections
  are a loop-carried ``fori_loop`` with the inner Gram-Schmidt-like
  correction batched per step. NOTE: at σ = 0 with γ = 1 the recursion is
  degenerate when the chronologically-oldest pair is processed first
  (its ``a`` vector is unit-norm, so ``1 − x₀⟨a, p⟩ = 0``); the reference
  sidesteps this only because its processing order starts one slot past
  the insert position, which lands on the oldest pair only for
  partially-filled buffers. Prefer ``compact``.
"""

from __future__ import annotations


import jax
from ..core.precision import pdot, pmatmul
import jax.numpy as jnp
from jax import lax

from .lbfgs import LBFGSOperator, LBFGSState, _forward_compact_parts

__all__ = ["solve_shifted_system", "solve_shifted_systems", "ldiv"]


@jax.jit
def _solve_shifted(state: LBFGSState, b, sigma):
    """Pure EJM recursion (reference solve_shifted_system!,
    src/utilities.jl:207-248). 0-based index mapping:
    1-based ``k = mod(insert + j - 1, mem) + 1`` → ``k0 = (insert0+j0+1) % mem``."""
    mem, n = state.S.shape
    dt = b.dtype

    gamma_inv = 1.0 / state.gamma
    x0 = 1.0 / (gamma_inv + sigma)
    x_init = x0 * b

    two_mem = 2 * mem
    # sign of the t-th previous term in the inner correction: (-1)^t (0-based)
    t_signs = jnp.where(jnp.arange(two_mem) % 2 == 0, 1.0, -1.0).astype(dt)
    t_idx = jnp.arange(two_mem)

    def body(i, carry):
        x, P, v = carry
        j = i // 2
        k = jnp.mod(state.insert + j + 1, mem)
        sign_i = jnp.where(i % 2 == 0, 1.0, -1.0).astype(dt)
        # odd 1-based i (even 0-based) uses a[k]; even uses b[k]
        # (reference: shifted_u .= sign_i == -1 ? b[k] : a[k], :231)
        u = jnp.where(sign_i == 1, state.A[k], state.B[k])

        # p_i = x0·u + Σ_{t<i} sign_t·v[t]·⟨p_t, u⟩·p_t  — one (2mem,n) matvec
        c = jnp.where(t_idx < i, t_signs * v * pmatmul(P, u), 0.0)
        p_i = x0 * u + pmatmul(P.T, c)

        v_i = 1.0 / (1.0 - sign_i * pdot(u, p_i))
        x = x + sign_i * v_i * pdot(p_i, b) * p_i
        return x, P.at[i].set(p_i), v.at[i].set(v_i)

    x, _, _ = lax.fori_loop(
        0,
        two_mem,
        body,
        (x_init, jnp.zeros((two_mem, n), dt), jnp.zeros((two_mem,), dt)),
    )
    return x


@jax.jit
def _solve_shifted_compact(state: LBFGSState, b, sigma):
    """Woodbury solve on the forward compact (BNS) representation:

      B = θI − U K⁻¹ Uᵀ,  U = [θS  Y],  K = [[θSᵀS, L], [Lᵀ, −D]]

    (θ = 1/γ, L = strict lower triangle of SᵀY in chronological order,
    D = diag(SᵀY)), so with c = θ + σ

      (B + σI)⁻¹ b = b/c + U (cK − UᵀU)⁻¹ Uᵀb / c

    — two (2·mem, n) passes + one (2·mem)² dense solve instead of the
    EJM loop's 2·mem sequential rank-1 steps. Empty ring slots carry zero
    U columns and unit K diagonal, contributing exactly nothing."""
    theta, K, W, SS_o, SY_o, YY_o, valid = _forward_compact_parts(
        state, with_grams=True
    )
    c = theta + sigma
    UtU = jnp.block(
        [[theta**2 * SS_o, theta * SY_o], [theta * SY_o.T, YY_o]]
    )
    M = c * K - UtU
    # unit diagonal on empty coordinates keeps M nonsingular (K already has
    # unit diagonal there; re-mask after the subtraction)
    valid2 = jnp.concatenate([valid, valid])
    M = jnp.where(valid2[:, None] & valid2[None, :], M, 0.0) + jnp.diag(
        jnp.where(valid2, 0.0, 1.0)
    )
    Utb = pmatmul(W, b)
    coef = jnp.linalg.solve(M, Utb)
    return b / c + pmatmul(W.T, coef) / c


def _is_concrete(x) -> bool:
    """True when ``x`` carries a host-readable value (not a jit tracer)."""
    return not isinstance(x, jax.core.Tracer)


def solve_shifted_system(B: LBFGSOperator, b, sigma, *, method: str = "compact"):
    """Solve ``(B + σI) x = b`` where B is a *forward* L-BFGS operator and
    σ ≥ 0 (reference solve_shifted_system!, src/utilities.jl:207-248).

    ``method="compact"`` (default) uses the Woodbury/compact-form solve
    (batched); ``method="ejm"`` runs the reference's
    Erway-Jain-Marcia recursion. Returns the solution vector (functional;
    the reference writes into a preallocated ``x``).

    jit-composable: ``sigma`` (and ``B``, a pytree) may be traced, so a
    trust-region loop can run on device end-to-end. The σ ≥ 0 contract is
    validated eagerly when σ is a concrete value; under a trace it is the
    caller's responsibility (a negative traced σ gives garbage, not an
    error — the same contract as the reference's unchecked ``@assert``)."""
    if B.inverse:
        raise ValueError("solve_shifted_system requires a forward L-BFGS operator")
    if _is_concrete(sigma) and float(sigma) < 0:
        raise ValueError("σ must be nonnegative")
    b = jnp.asarray(b, B.dtype)
    sigma = jnp.asarray(sigma, B.dtype)
    if method == "compact":
        return _solve_shifted_compact(B.state, b, sigma)
    if method == "ejm":
        # EJM reads the a/b vectors; lazy pushes defer them. Under a trace
        # the materialized state is used directly (never cached as tracers).
        state = B._materialized_state()
        if (
            _is_concrete(sigma)
            and _is_concrete(state.ys)
            and float(sigma) == 0
            and bool(jnp.any(state.ys == 0))
        ):
            raise ValueError(
                "EJM is degenerate at sigma=0 on a partially-filled ring "
                "(the oldest pair's unit a-vector makes 1 - x0<a,p> = 0); "
                "use the default compact method"
            )
        return _solve_shifted(state, b, sigma)
    raise ValueError(f"unknown method {method!r}")


def solve_shifted_systems(B: LBFGSOperator, b, sigmas):
    """Solve ``(B + σᵢI) x = b`` for a whole batch of shifts at once —
    ``vmap`` of the compact solve, sharing the two (2·mem, n) passes'
    inputs across shifts. The trust-region use case (several σ per
    subproblem) the reference handles with repeated sequential solves.
    Returns an (len(sigmas), n) array. jit-composable (traced ``sigmas``
    skip the eager σ ≥ 0 validation; see ``solve_shifted_system``)."""
    if B.inverse:
        raise ValueError("solve_shifted_systems requires a forward L-BFGS operator")
    sig = jnp.atleast_1d(jnp.asarray(sigmas, B.dtype))
    if _is_concrete(sig) and bool(jnp.any(sig < 0)):
        raise ValueError("σ must be nonnegative")
    b = jnp.asarray(b, B.dtype)
    return jax.vmap(lambda s: _solve_shifted_compact(B.state, b, s))(sig)


def ldiv(B: LBFGSOperator, b):
    """Solve ``B x = b`` (σ = 0 case; reference ldiv!,
    src/utilities.jl:281-289)."""
    return solve_shifted_system(B, b, 0.0)
