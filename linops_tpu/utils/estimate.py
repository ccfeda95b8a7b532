"""Stochastic trace and diagonal estimation (matrix-free).

Capability upgrade beyond the reference: LinearOperators.jl exposes no
trace/diagonal estimators and leaves clients to roll probe loops over
``op * v``. On an accelerator the natural formulation is BATCHED — a
``(n, k)`` Rademacher probe block goes through ``apply_matrix`` as one
contraction per apply, so ``k`` probes cost roughly one streaming pass
over the operator, not ``k``.

- ``estimate_trace(op, method="hutchpp")`` — Hutch++ (Meyer, Musco,
  Musco, Woodruff 2021): a low-rank QR sketch captures the dominant
  spectrum exactly and plain Hutchinson handles only the deflated
  residual, giving O(1/k) error decay on spectra with decay vs
  Hutchinson's O(1/sqrt(k)). ``method="hutchinson"`` is the classic
  unbiased estimator.
- ``estimate_diagonal`` — the Bekas/Kokiopoulou/Saad probe estimator:
  ``diag(A) ~= mean_k(g_k * (A g_k))`` for Rademacher ``g_k``.
- ``estimate_spectral_sum`` / ``estimate_logdet`` — stochastic Lanczos
  quadrature (Ubaru, Chen, Saad 2017): ``tr(f(A))`` for hermitian ``A``
  via per-probe Gauss quadrature on the Lanczos tridiagonal; ``f = log``
  gives the log-determinant, ``f = 1/x`` the trace of the inverse. All
  probes run as one vmapped batch of Lanczos recurrences.
- ``funm_apply`` — the ACTION ``f(A) b`` by the same Lanczos machinery
  (``exp`` for exponential integrators, ``1/sqrt(x)`` for whitening,
  ``1/x`` as a direct-from-spectrum solve); exact once the Krylov space
  captures ``b``'s spectral content.

Both compile to a single XLA computation (operators ride their normal
precision-policy apply paths).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.base import LinearOperator, LinearOperatorException
from ..core.precision import pmatmul, pvdot
from .rng import fresh_key

__all__ = [
    "estimate_trace",
    "estimate_diagonal",
    "estimate_spectral_sum",
    "estimate_logdet",
    "funm_apply",
]


def _probe_dtype(op):
    dt = jnp.dtype(op.dtype)
    if not jnp.issubdtype(dt, jnp.inexact):
        dt = jnp.dtype(jnp.float64) if jax.config.jax_enable_x64 else jnp.dtype(jnp.float32)
    return dt


def _rademacher(key, shape, dtype):
    # real-valued signs even for complex operators: E[g g^T] = I is all the
    # estimators need, and real probes keep the quadratic forms unbiased
    # for complex A (g^H = g^T).
    real_dt = jnp.finfo(dtype).dtype if jnp.issubdtype(dtype, jnp.complexfloating) else dtype
    return jax.random.rademacher(key, shape, real_dt).astype(dtype)


@functools.partial(jax.jit, static_argnames=())
def _hutchinson(op, G):
    AG = op.apply_matrix(G, "N")
    # per-probe quadratic forms g^H A g (real Rademacher: g^H == g^T)
    samples = jnp.sum(jnp.conj(G) * AG, axis=0)
    k = samples.shape[0]
    est = jnp.mean(samples)
    stderr = jnp.std(samples.real) / jnp.sqrt(k) if k > 1 else jnp.zeros((), samples.real.dtype)
    return est, stderr


@functools.partial(jax.jit, static_argnames=())
def _hutchpp(op, S, G):
    AS = op.apply_matrix(S, "N")
    Q, _ = jnp.linalg.qr(AS)  # (n, m) orthonormal sketch basis
    AQ = op.apply_matrix(Q, "N")
    # exact low-rank part: tr(Q^H A Q) without forming the (m, m) product
    t_lowrank = jnp.sum(jnp.conj(Q) * AQ)
    # deflate the Hutchinson probes: g' = (I - Q Q^H) g. The residual
    # trace tr((I-P) A (I-P)) is estimated by g'^H A g' (P hermitian,
    # real g), and tr(A) = tr(Q^H A Q) + tr((I-P) A (I-P)) exactly.
    Gd = G - pmatmul(Q, pmatmul(jnp.conj(Q).T, G))
    AGd = op.apply_matrix(Gd, "N")
    samples = jnp.sum(jnp.conj(Gd) * AGd, axis=0)
    k = samples.shape[0]
    est = t_lowrank + jnp.mean(samples)
    stderr = jnp.std(samples.real) / jnp.sqrt(k) if k > 1 else jnp.zeros((), samples.real.dtype)
    return est, stderr


def estimate_trace(op, *, probes: int = 36, key=None, method: str = "hutchpp"):
    """Estimate ``tr(op)`` with ``probes`` total operator-block applies.

    Returns ``(estimate, stderr)`` where ``stderr`` is the standard error
    of the stochastic part (for ``hutchpp`` the sketched low-rank part is
    exact, so the reported stderr covers only the deflated residual — the
    total error is usually far below plain Hutchinson's at equal probes).

    ``method``: ``"hutchpp"`` (default; splits probes 1/3 sketch + QR
    apply, 1/3 residual Hutchinson) or ``"hutchinson"`` (all probes on the
    plain unbiased estimator). Pass an explicit ``key`` to pin
    determinism; by default probes draw OS entropy (see utils/rng.py).
    """
    if not isinstance(op, LinearOperator):
        from ..core.dense import aslinearoperator

        op = aslinearoperator(op)
    m, n = op.shape
    if m != n:
        raise LinearOperatorException(
            f"trace requires a square operator, got shape {(m, n)}"
        )
    if probes < 1:
        raise ValueError("probes must be >= 1")
    dt = _probe_dtype(op)
    if key is None:
        key = fresh_key()

    if method == "hutchinson":
        G = _rademacher(key, (n, probes), dt)
        est, se = _hutchinson(op, G)
    elif method == "hutchpp":
        # probe budget in operator applies: m_s (A S) + m_s (A Q) + m_g (A G)
        if probes < 3:
            raise ValueError(
                "hutchpp needs probes >= 3 (sketch + sketch-apply + residual); "
                "use method='hutchinson' for smaller budgets"
            )
        m_s = max(1, min(probes // 3, n))
        m_g = probes - 2 * m_s
        k1, k2 = jax.random.split(key)
        S = _rademacher(k1, (n, m_s), dt)
        G = _rademacher(k2, (n, m_g), dt)
        est, se = _hutchpp(op, S, G)
    else:
        raise ValueError(f"unknown method {method!r} (hutchpp | hutchinson)")

    if jnp.issubdtype(jnp.dtype(op.dtype), jnp.complexfloating):
        return complex(est), float(se)
    return float(jnp.real(est)), float(se)


@functools.partial(jax.jit, static_argnames=())
def _diag_probes(op, G):
    AG = op.apply_matrix(G, "N")
    # Bekas et al. 2007: with Rademacher probes sum_k g_k * g_k == k
    # elementwise, so the estimator is the plain probe mean.
    samples = jnp.conj(G) * AG  # (n, k) per-probe diagonal draws
    k = samples.shape[1]
    est = jnp.mean(samples, axis=1)
    if k > 1:
        stderr = jnp.std(samples.real, axis=1) / jnp.sqrt(k)
    else:
        stderr = jnp.zeros_like(est, dtype=samples.real.dtype)
    return est, stderr


def estimate_diagonal(op, *, probes: int = 64, key=None):
    """Estimate ``diag(op)`` (Bekas/Kokiopoulou/Saad probe estimator).

    Returns ``(diag, stderr)`` device arrays of length ``n``. Unbiased for
    any square operator; variance on entry ``i`` scales with the squared
    off-diagonal mass of row ``i``, so strongly diagonally-dominant
    operators converge fastest. For an EXACT diagonal of a lazy graph use
    ``op.to_dense()`` (blockwise) or a structured op's own ``diag``.
    """
    if not isinstance(op, LinearOperator):
        from ..core.dense import aslinearoperator

        op = aslinearoperator(op)
    m, n = op.shape
    if m != n:
        raise LinearOperatorException(
            f"diagonal estimation requires a square operator, got shape {(m, n)}"
        )
    if probes < 1:
        raise ValueError("probes must be >= 1")
    dt = _probe_dtype(op)
    if key is None:
        key = fresh_key()
    G = _rademacher(key, (n, probes), dt)
    return _diag_probes(op, G)


# ---------------------------------------------------------------------------
# Stochastic Lanczos quadrature (tr f(A) for hermitian A)
# ---------------------------------------------------------------------------


def _lanczos_tridiag(matvec, v0, m, reorth, passes: int = 1):
    """The library's ONE Lanczos recurrence (SLQ, funm_apply, and
    norm.estimate_opnorm all build on it). ``m`` steps of hermitian
    ``matvec`` from unit-norm ``v0``: returns ``(V, alphas, betas)``.
    ``V`` is the (m, n) basis when ``reorth`` (with ``passes`` full
    reorthogonalization sweeps per step) and a (1, n) placeholder
    otherwise (callers that need the basis must pass ``reorth=True``;
    unused outputs are DCE'd by jit). On reaching an invariant subspace
    the recurrence goes inert — ``beta == 0`` rows decouple from e1 in T,
    so their quadrature weight is exactly zero."""
    n = v0.shape[0]
    dt = v0.dtype
    rdt = jnp.real(v0).dtype
    alphas = jnp.zeros((m,), rdt)
    betas = jnp.zeros((m,), rdt)  # betas[j] couples step j to j+1
    V = jnp.zeros((m if reorth else 1, n), dt)

    def body(j, carry):
        V, alphas, betas, v, v_prev, beta_prev = carry
        if reorth:
            V = V.at[j].set(v)
        w = matvec(v) - beta_prev * v_prev
        alpha = jnp.real(pvdot(v, w))
        w = w - alpha.astype(dt) * v
        if reorth:
            for _ in range(passes):
                w = w - pmatmul(V.T, pmatmul(jnp.conj(V), w))
        beta = jnp.linalg.norm(w)
        v_next = jnp.where(beta > 0, w / jnp.where(beta > 0, beta, 1.0), 0.0)
        alphas = alphas.at[j].set(alpha)
        betas = betas.at[j].set(jnp.real(beta))
        return (V, alphas, betas, v_next, v, jnp.real(beta))

    init = (V, alphas, betas, v0, jnp.zeros_like(v0), jnp.zeros((), rdt))
    V, alphas, betas, _, _, _ = jax.lax.fori_loop(0, m, body, init)
    return V, alphas, betas


@functools.partial(jax.jit, static_argnames=("m", "reorth", "f"))
def _slq(op, V0, m, reorth, f):
    """Per-probe m-step Lanczos + Gauss quadrature; V0 is (n, k) with
    unit-norm columns. Returns the k per-probe estimates of v^H f(A) v
    (times n, folded in by the caller)."""
    rdt = jnp.real(V0).dtype

    def lanczos(v0):
        _, alphas, betas = _lanczos_tridiag(
            lambda v: op.apply(v, "N"), v0, m, reorth
        )
        return alphas, betas

    alphas, betas = jax.vmap(lanczos, in_axes=1)(V0)  # (k, m) each

    def quadrature(al, be):
        T = jnp.diag(al) + jnp.diag(be[:-1], 1) + jnp.diag(be[:-1], -1)
        theta, U = jnp.linalg.eigh(T)
        w = U[0, :] ** 2  # Gauss weights = squared e1 components
        # zero-weight nodes (decoupled trailing blocks after early
        # termination) must not evaluate f at their spurious theta
        cut = jnp.finfo(rdt).eps * m * 10
        safe_theta = jnp.where(w > cut, theta, 1.0)
        return jnp.sum(jnp.where(w > cut, w * f(safe_theta), 0.0))

    return jax.vmap(quadrature)(alphas, betas)


def estimate_spectral_sum(op, f, *, probes: int = 16, lanczos_steps: int = 30,
                          key=None, reorth: bool = None):
    """Estimate ``tr(f(op))`` for a hermitian operator by stochastic
    Lanczos quadrature (Ubaru, Chen & Saad 2017).

    ``f`` is a scalar spectral function applied elementwise to Ritz values
    (any jnp-traceable callable, e.g. ``jnp.log``, ``jnp.exp``). ``f`` keys
    the compile cache by object identity: pass a module-level function (or
    reuse one lambda object) to hit the cache across calls — a fresh
    inline lambda per call recompiles every time. Each of the ``probes``
    Rademacher vectors runs
    ``lanczos_steps`` of the Lanczos recurrence (all probes vmapped into
    one computation — ``probes`` simultaneous matvec chains); the Gauss
    quadrature on each tridiagonal integrates ``f`` against the probe's
    spectral measure. Returns ``(estimate, stderr)``.

    ``reorth`` adds full reorthogonalization (an ``(m, n)`` basis per
    probe); default: on when the bases fit a ~256 MiB budget, off
    otherwise (plain SLQ tolerates the loss per Paige's analysis, at some
    bias on tight clusters). Accuracy needs ``f`` smooth on the spectrum:
    for ``log`` / ``1/x`` the operator must be positive definite.
    """
    if not isinstance(op, LinearOperator):
        from ..core.dense import aslinearoperator

        op = aslinearoperator(op)
    m_, n = op.shape
    if m_ != n:
        raise LinearOperatorException(
            f"spectral sums require a square operator, got shape {(m_, n)}"
        )
    if not op.hermitian:
        raise LinearOperatorException(
            "estimate_spectral_sum requires a hermitian operator (set "
            "hermitian=True if the operator is known hermitian)"
        )
    if probes < 1 or lanczos_steps < 1:
        raise ValueError("probes and lanczos_steps must be >= 1")
    m = int(min(lanczos_steps, n))
    dt = _probe_dtype(op)
    if key is None:
        key = fresh_key()
    if reorth is None:
        itemsize = jnp.dtype(dt).itemsize
        reorth = probes * m * n * itemsize <= 256 * 1024 * 1024
    G = _rademacher(key, (n, probes), dt)
    V0 = G / jnp.linalg.norm(G, axis=0, keepdims=True)
    samples = n * _slq(op, V0, m, bool(reorth), f)
    est = jnp.mean(samples)
    se = jnp.std(samples) / jnp.sqrt(probes) if probes > 1 else jnp.zeros_like(est)
    return float(est), float(se)


def estimate_logdet(op, *, probes: int = 16, lanczos_steps: int = 30,
                    key=None, reorth: bool = None):
    """Estimate ``log det(op)`` of a hermitian positive-definite operator
    (``tr(log op)`` by stochastic Lanczos quadrature). Returns
    ``(estimate, stderr)``. A non-PD operator yields NaN (log of a
    negative Ritz value) rather than a wrong finite answer."""
    return estimate_spectral_sum(
        op, jnp.log, probes=probes, lanczos_steps=lanczos_steps, key=key,
        reorth=reorth,
    )


# ---------------------------------------------------------------------------
# Matrix-function ACTION: f(A) b by Lanczos (hermitian A)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("m", "f"))
def _funm_jit(op, b, m, f):
    rdt = jnp.real(b).dtype
    nrm = jnp.linalg.norm(b)
    v0 = b / jnp.where(nrm > 0, nrm, 1.0)

    # full reorthogonalization: the result lives IN the basis, so basis
    # quality directly bounds the output accuracy
    V, alphas, betas = _lanczos_tridiag(
        lambda v: op.apply(v, "N"), v0, m, reorth=True
    )

    T = jnp.diag(alphas) + jnp.diag(betas[:-1], 1) + jnp.diag(betas[:-1], -1)
    theta, U = jnp.linalg.eigh(T)  # real symmetric even for complex A
    e1w = U[0, :]
    # decoupled nodes after early termination carry |e1 weight| == 0;
    # guard them so f(0) (e.g. log) cannot poison the combination
    cut = jnp.finfo(rdt).eps * m * 10
    live = jnp.abs(e1w) > cut
    fw = jnp.where(live, f(jnp.where(live, theta, 1.0)), 0.0)
    coeffs = pmatmul(U.astype(fw.dtype), fw * e1w)  # complex f promotes
    out = pmatmul(V.T, coeffs)
    # f(A) @ 0 == 0, but with nrm == 0 the quadrature sits at theta = 0
    # where singular f (log, 1/x) yields inf — select, don't multiply
    return jnp.where(nrm > 0, nrm * out, jnp.zeros_like(out))


def funm_apply(op, f, b, *, lanczos_steps: int = 30):
    """Apply the spectral function of a hermitian operator to a vector:
    ``f(op) @ b`` by ``lanczos_steps`` of the Lanczos recurrence with full
    reorthogonalization (one operator apply per step).

    ``f`` is any jnp-traceable scalar function (``jnp.exp`` for
    exponential integrators, ``lambda x: 1/jnp.sqrt(x)`` for whitening /
    sampling, ``jnp.log``, ...); like :func:`estimate_spectral_sum`, ``f``
    keys the compile cache by object identity. Exact once the Krylov
    space captures ``b``'s spectral content (``lanczos_steps >= n`` is
    always exact); for smooth ``f`` the error decays like the best
    polynomial approximation of degree ``lanczos_steps`` on the spectrum.
    ``log``/``1/x``/``1/sqrt(x)`` require a positive-definite operator.
    """
    if not isinstance(op, LinearOperator):
        from ..core.dense import aslinearoperator

        op = aslinearoperator(op)
    m_, n = op.shape
    if m_ != n:
        raise LinearOperatorException(
            f"funm_apply requires a square operator, got shape {(m_, n)}"
        )
    if not op.hermitian:
        raise LinearOperatorException(
            "funm_apply requires a hermitian operator (set hermitian=True "
            "if the operator is known hermitian)"
        )
    if lanczos_steps < 1:
        raise ValueError("lanczos_steps must be >= 1")
    # promote rather than cast: a complex b on a real hermitian operator
    # is well-defined (f(A) is real-linear), and a silent complex->real
    # cast would drop the imaginary half
    b = jnp.asarray(b)
    b = b.astype(jnp.promote_types(_probe_dtype(op), b.dtype))
    if b.shape != (n,):
        raise LinearOperatorException(f"b must have shape ({n},), got {b.shape}")
    return _funm_jit(op, b, int(min(lanczos_steps, n)), f)
