"""Matrix-free spectral analysis of an operator graph.

Capabilities working together on a pure operator (never densified):
LOBPCG extremal eigenpairs, Hutch++ trace, Bekas diagonal probes, and a
Lanczos opnorm — all batched block applies.

Run: JAX_PLATFORMS=cpu python examples/07_spectral_analysis.py
"""

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import linops_tpu as lo

# A graph-structured hermitian operator: 2-D Laplacian + a strongly
# varying diagonal potential (a discrete Schroedinger operator)
ng = 48
n = ng * ng
key = jax.random.PRNGKey(0)
potential = 0.5 + 50.0 * jax.random.uniform(key, (n,), dtype=jnp.float64) ** 4
A = lo.laplacian_2d(ng, ng, dtype=jnp.float64) + lo.opDiagonal(potential)
assert A.hermitian

# --- extremal eigenpairs (ground states of the discrete Schroedinger op) ---
# Jacobi preconditioning (the diagonal is known analytically here)
M = lo.opDiagonal(1.0 / (4.0 + potential))
theta, X, res, iters_m = lo.lobpcg(A, k=4, tol=1e-8, maxiter=500, M=M,
                                   key=jax.random.PRNGKey(1))
print(f"lowest 4 eigenvalues: {np.asarray(theta)}  ({iters_m} iterations)")
_, _, _, iters = lo.lobpcg(A, k=4, tol=1e-8, maxiter=500,
                           key=jax.random.PRNGKey(1))
print(f"without the Jacobi preconditioner: {iters} iterations")

# --- trace: exact value is 4n + sum(potential); Hutch++ nails the
# smooth spectrum with a small probe budget -------------------------------
tr_true = 4.0 * n + float(jnp.sum(potential))
est, se = lo.estimate_trace(A, probes=96, key=jax.random.PRNGKey(2))
print(f"trace: hutch++ {est:.2f} +- {se:.2f}   (exact {tr_true:.2f})")

# --- diagonal probes (e.g. for building the Jacobi preconditioner when
# the diagonal is NOT known analytically) ---------------------------------
d_est, d_se = lo.estimate_diagonal(A, probes=256, key=jax.random.PRNGKey(3))
d_true = 4.0 + potential
err = float(jnp.max(jnp.abs(d_est - d_true)))
print(f"diagonal probes: max err {err:.3f} (off-diagonal mass bounds the rate)")

# --- opnorm: Lanczos (ARPACK-analogue). On clustered spectrum edges the
# single-vector Lanczos retries exhaust and the blocked-LOBPCG fallback
# kicks in automatically (the retry warnings below are that story). ------
import warnings

with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    nrm, ok = lo.estimate_opnorm(A)
th_top, _, _, _ = lo.lobpcg(A, k=1, largest=True, tol=1e-8, maxiter=500,
                            key=jax.random.PRNGKey(4))
print(f"opnorm: {nrm:.4f} (converged: {ok}); "
      f"direct lobpcg agrees: {float(th_top[0]):.4f}")

# --- matrix functions: the heat kernel exp(-t A) b by Lanczos ------------
b = jnp.zeros((n,), jnp.float64).at[n // 2 + ng // 2].set(1.0)  # point source
u = lo.funm_apply(A, lambda x: jnp.exp(-0.25 * x), b, lanczos_steps=40)
print(f"heat kernel: mass {float(jnp.sum(u)):.4f}, peak {float(jnp.max(u)):.4f} "
      f"(diffused from a point source, no matrix ever formed)")

# --- randomized Nystrom preconditioner accelerating CG -------------------
# a PSD operator with a decaying spectrum: low-rank spike + damped base
k1, k2 = jax.random.split(jax.random.PRNGKey(5))
Uspike = jnp.linalg.qr(jax.random.normal(k1, (n, 24), dtype=jnp.float64))[0]
spike = lo.LinearOperator(Uspike * (200.0 * 2.0 ** -jnp.arange(24))) @ \
    lo.LinearOperator(Uspike.T)
Apd = (0.05 * A + spike).hermitianized()
rhs = jax.random.normal(k2, (n,), dtype=jnp.float64)
P = lo.nystrom_preconditioner(Apd, rank=30, key=jax.random.PRNGKey(6))
_, it_plain, _ = lo.cg(Apd, rhs, tol=1e-10, maxiter=2000)
_, it_nys, _ = lo.cg(Apd, rhs, tol=1e-10, maxiter=2000, M=P)
print(f"nystrom-preconditioned cg: {int(it_nys)} iterations "
      f"(plain: {int(it_plain)})")
