"""Diagonal quasi-Newton Hessian approximations.

JAX redesign of the reference's diagonal QN family
(reference: src/DiagonalHessianApproximation.jl). Each operator is a mutable
host wrapper over a device diagonal ``d``; apply is the fused elementwise
product ``d * v`` (same kernel as opDiagonal, reference
src/special-operators.jl:125-131) and every ``push`` is one cached jit call.

Members (all real, symmetric, hermitian; satisfy the weak secant equation
where the reference's do):

- ``DiagonalPSB``      — Zhu-Nazareth-Wolkowicz weak-secant update
  (reference src/DiagonalHessianApproximation.jl:45-64)
- ``DiagonalAndrei``   — Andrei's update (reference :120-141)
- ``SpectralGradient`` — Barzilai-Borwein scalar σI (reference :186-196)
- ``DiagonalBFGS``     — diagonal BFGS-inspired update (reference :234-248)
"""

from __future__ import annotations

import jax
from ..core.precision import pdot
import jax.numpy as jnp

from ..core.base import LinearOperator, register_operator

__all__ = [
    "DiagonalQNOperator",
    "DiagonalPSB",
    "DiagonalAndrei",
    "SpectralGradient",
    "DiagonalBFGS",
]


# ----------------------------------------------------------------------------
# Pure updates (reference push! bodies)
# ----------------------------------------------------------------------------


@jax.jit
def _psb_update(d, s, y):
    """Zhu-Nazareth-Wolkowicz PSB update (reference
    src/DiagonalHessianApproximation.jl:45-64). The sᵀBs = sᵀy relation is
    norm-scaled exactly as the reference does for stability."""
    s2 = s * s
    sn2 = pdot(s, s)
    trA2 = pdot(s2, s2) / sn2**2
    sT_y = pdot(s, y) / sn2
    sT_B_s = pdot(s2, d) / sn2
    q = (sT_y - sT_B_s) / trA2
    return d + q / sn2 * s2


@jax.jit
def _andrei_update(d, s, y):
    """Andrei's diagonal update (reference
    src/DiagonalHessianApproximation.jl:120-141)."""
    s2 = s * s
    sn2 = pdot(s, s)
    trA2 = pdot(s2, s2) / sn2**2
    sT_y = pdot(s, y) / sn2
    sT_B_s = pdot(s2, d) / sn2
    q = (sT_y - sT_B_s + 1.0) / trA2  # sT_s/sn2 == 1 after scaling
    return d + q / sn2 * s2 - 1.0


@jax.jit
def _spg_update(d, s, y):
    """Barzilai-Borwein spectral coefficient σ = ⟨s,y⟩/⟨s,s⟩ (reference
    src/DiagonalHessianApproximation.jl:186-196)."""
    return jnp.full_like(d, pdot(s, y) / pdot(s, s))


@jax.jit
def _dbfgs_update(d, s, y):
    """Diagonal BFGS-inspired update: d = |y| · Σ|y| / (sᵀy/‖s‖²)
    (reference src/DiagonalHessianApproximation.jl:234-248)."""
    sn2 = pdot(s, s)
    sT_y = pdot(s, y) / sn2
    ay = jnp.abs(y)
    return ay * (jnp.sum(ay) / sT_y)


# ----------------------------------------------------------------------------
# Operator classes
# ----------------------------------------------------------------------------


class DiagonalQNOperator(LinearOperator):
    """Shared base: a diagonal operator with a quasi-Newton ``push`` rule
    (reference AbstractDiagonalQuasiNewtonOperator, src/abstract.jl:32)."""

    _fields_children = ("d",)
    _fields_aux = ("_n",)

    _update = None  # subclasses set a staticmethod

    def __init__(self, d):
        super().__init__()
        d = jnp.asarray(d)
        if d.ndim != 1:
            raise ValueError("initial diagonal must be a vector")
        if jnp.issubdtype(d.dtype, jnp.complexfloating):
            raise ValueError("diagonal quasi-Newton operators are real-only")
        self.d = d
        self._n = d.shape[0]

    @property
    def nrow(self):
        return self._n

    @property
    def ncol(self):
        return self._n

    @property
    def dtype(self):
        return self.d.dtype

    @property
    def symmetric(self):
        return True

    @property
    def hermitian(self):
        return True

    def _prod(self, v):
        return self.d * v

    def _tprod(self, u):
        return self.d * u

    def _ctprod(self, w):
        return self.d * w

    def apply_matrix(self, M, mode: str = "N"):
        return self.d[:, None] * M

    def push(self, s, y):
        """Quasi-Newton diagonal update. Raises on ``s = 0`` (reference
        errors 'Cannot update DiagonalQN operator with s=0')."""
        s = jnp.asarray(s, self.d.dtype)
        y = jnp.asarray(y, self.d.dtype)
        if not bool(jnp.any(s != 0)):
            raise ValueError("Cannot update DiagonalQN operator with s=0")
        self.d = type(self)._update(self.d, s, y)
        return self

    def diag(self):
        return self.d

    def reset(self):
        """d .= 1 and zero counters (reference reset!,
        src/DiagonalHessianApproximation.jl:71-77)."""
        self.d = jnp.ones_like(self.d)
        self.reset_counters()
        return self


class DiagonalPSB(DiagonalQNOperator):
    """Diagonal PSB approximation, Zhu-Nazareth-Wolkowicz (reference
    src/DiagonalHessianApproximation.jl:21-64). Satisfies the weak secant
    equation ⟨s, Bs⟩ = ⟨s, y⟩; not necessarily positive definite."""

    _update = staticmethod(_psb_update)


class DiagonalAndrei(DiagonalQNOperator):
    """Andrei's diagonal approximation (reference
    src/DiagonalHessianApproximation.jl:96-141). Satisfies the weak secant
    equation; not necessarily positive definite."""

    _update = staticmethod(_andrei_update)


class SpectralGradient(DiagonalQNOperator):
    """Spectral (Barzilai-Borwein) gradient approximation σ·I (reference
    src/DiagonalHessianApproximation.jl:150-196).

    ``SpectralGradient(sigma, n)`` with σ > 0.
    """

    _update = staticmethod(_spg_update)

    def __init__(self, sigma, n, dtype=None):
        sigma = float(sigma)
        if sigma <= 0:
            raise ValueError("σ must be positive")
        dt = jnp.dtype(dtype) if dtype is not None else jax.dtypes.canonicalize_dtype(jnp.float64)
        super().__init__(jnp.full((int(n),), sigma, dtype=dt))

    @property
    def sigma(self) -> float:
        return float(self.d[0])


class DiagonalBFGS(DiagonalQNOperator):
    """Diagonal BFGS-inspired approximation, Marnissi et al. (reference
    src/DiagonalHessianApproximation.jl:210-248)."""

    _update = staticmethod(_dbfgs_update)


for _cls in (DiagonalPSB, DiagonalAndrei, SpectralGradient, DiagonalBFGS):
    register_operator(_cls)
