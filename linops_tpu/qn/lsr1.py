"""Limited-memory SR1 operator with device-resident ring-buffer state.

JAX redesign of the reference L-SR1 operator (reference:
src/lsr1.jl). Two apply forms:

- **compact (BNS thm 5.1, the default hot path)**:
  ``B = I/γ + U M⁻¹ Uᵀ`` with ``U = Y − S/γ`` (chronological) and
  ``M = D + L + Lᵀ − SᵀS/γ`` built from O(mem²) Gram pieces maintained
  incrementally at push — so a push is O(mem·n) and an apply is two
  (mem, n)-ish passes + one (mem)² solve.
- **a-form (the reference recursion)**: ``B v = v/γ + Σ aᵢ(aᵢᵀv)/⟨aᵢ,sᵢ⟩``
  (reference src/lsr1.jl:89-107) with the O(mem²·n) rank-1 recompute
  (src/lsr1.jl:166-181) DEFERRED to first diag()/opnorm-bound use
  (mirroring the L-BFGS lazy_ab design) and kept as the parity oracle.

Semantics preserved: the three-part update acceptance test — well-definedness
``|⟨y−Bs, s⟩| ≥ ε(1 + ‖y−Bs‖‖s‖)``, sufficient curvature, and the scaling
condition (reference src/lsr1.jl:119-149) — plus ``diag`` (src/lsr1.jl:196-211)
and ``reset`` (src/lsr1.jl:217-240).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core.precision import pdot, pmatmul
from ..core.base import LinearOperator, LinearOperatorException, register_operator

__all__ = ["LSR1State", "LSR1Operator"]


class LSR1State(NamedTuple):
    """Device pytree holding the L-SR1 memory (reference LSR1Data,
    src/lsr1.jl:4-17). Ring indices are 0-based. ``SY``/``SS`` are the
    slot-order Gram matrices SᵀY / SᵀS maintained at push for the compact
    apply; ``A``/``as_``/``opnorm_ub`` belong to the deferred a-form."""

    S: jax.Array  # (mem, n)
    Y: jax.Array  # (mem, n)
    ys: jax.Array  # (mem,)  curvature; 0 marks an empty slot
    A: jax.Array  # (mem, n) rank-1 vectors aᵢ = yᵢ − B₍ᵢ₋₁₎sᵢ
    as_: jax.Array  # (mem,)  ⟨aᵢ, sᵢ⟩
    SY: jax.Array  # (mem, mem) Gram SᵀY (slot order)
    SS: jax.Array  # (mem, mem) Gram SᵀS
    gamma: jax.Array  # () scaling factor
    insert: jax.Array  # () int32, 0-based
    opnorm_ub: jax.Array  # () upper bound on ‖B‖₂ (a-form; lazy)
    Minv: jax.Array  # (mem, mem) inverse of the compact middle M (chrono
    # coords), maintained at push so the hot apply runs ZERO
    # factorizations (same reason as the L-BFGS G matrix: a mem-sized
    # LU at apply time is pure sequential latency)


def _init_state(n: int, mem: int, dtype) -> LSR1State:
    return LSR1State(
        S=jnp.zeros((mem, n), dtype),
        Y=jnp.zeros((mem, n), dtype),
        ys=jnp.zeros((mem,), dtype),
        A=jnp.zeros((mem, n), dtype),
        as_=jnp.zeros((mem,), dtype),
        SY=jnp.zeros((mem, mem), dtype),
        SS=jnp.zeros((mem, mem), dtype),
        gamma=jnp.ones((), dtype),
        insert=jnp.zeros((), jnp.int32),
        opnorm_ub=jnp.ones((), dtype),
        Minv=jnp.eye(mem, dtype=dtype),
    )


def _safe_div(num, den):
    return jnp.where(den != 0, num / jnp.where(den != 0, den, 1.0), 0.0)


def lsr1_apply(state: LSR1State, x):
    """B v = v/γ + Aᵀ((A v)/as) with empty/degenerate slots masked out
    (reference src/lsr1.jl:89-107)."""
    coef = jnp.where(state.ys != 0, _safe_div(pmatmul(state.A, x), state.as_), 0.0)
    return x / state.gamma + pmatmul(state.A.T, coef)


def lsr1_apply_matrix(state: LSR1State, X):
    coef = jnp.where((state.ys != 0)[:, None], _safe_div(pmatmul(state.A, X), state.as_[:, None]), 0.0)
    return X / state.gamma + pmatmul(state.A.T, coef)


def _compact_M(state: LSR1State):
    """The small chrono middle matrix M = D + L + Lᵀ − SᵀS/γ
    (Byrd-Nocedal-Schnabel 1994, thm 5.1) with unit diagonal on empty
    slots, plus (order, valid)."""
    mem = state.S.shape[0]
    order = jnp.mod(state.insert + jnp.arange(mem), mem)  # oldest → newest
    valid = state.ys[order] != 0
    vmask2 = valid[:, None] & valid[None, :]
    SY_o = jnp.where(vmask2, state.SY[order][:, order], 0.0)
    SS_o = jnp.where(vmask2, state.SS[order][:, order], 0.0)
    L = jnp.tril(SY_o, k=-1)
    M = jnp.diag(jnp.diag(SY_o)) + L + L.T - SS_o / state.gamma
    M = jnp.where(vmask2, M, 0.0) + jnp.diag(jnp.where(valid, 0.0, 1.0))
    return M, order, valid


def _compact_minv(state: LSR1State):
    """Push-time inverse of the compact middle (empty slots zeroed): the
    hot apply then runs matmul-only, and the per-apply U build stays a
    dynamic-index gather with a traced-scalar term — the form XLA does
    not hoist out of chains and fuses across iterations (see the L-BFGS
    ``_compact_middle`` note)."""
    M, order, valid = _compact_M(state)
    vmask2 = valid[:, None] & valid[None, :]
    return jnp.where(vmask2, jnp.linalg.inv(M), 0.0)


def _compact_parts(state: LSR1State):
    """Chronologically-ordered compact pieces (U, M): U = Y − S/γ with
    empty slots zeroed."""
    M, order, valid = _compact_M(state)
    U = jnp.where(
        valid[:, None], state.Y[order] - state.S[order] / state.gamma, 0.0
    )  # (mem, n)
    return U, M


def lsr1_apply_compact(state: LSR1State, x):
    """Compact SR1 product: B v = v/γ + Uᵀ M⁻¹ (U v) — numerically equal to
    the a-form recursion on accepted pairs, but needs NO a-vectors, so
    pushes stay O(mem·n). M⁻¹ is push-maintained (``state.Minv``)."""
    U, _ = _compact_parts(state)
    coef = pmatmul(state.Minv, pmatmul(U, x))
    return x / state.gamma + pmatmul(U.T, coef)


def lsr1_apply_matrix_compact(state: LSR1State, X):
    U, _ = _compact_parts(state)
    coef = pmatmul(state.Minv, pmatmul(U, X))
    return X / state.gamma + pmatmul(U.T, coef)


def lsr1_diag(state: LSR1State):
    """diag(B) = 1/γ + Σ aᵢ²/⟨aᵢ,sᵢ⟩ (reference src/lsr1.jl:196-211)."""
    coef = jnp.where(state.ys != 0, _safe_div(jnp.ones_like(state.as_), state.as_), 0.0)
    return 1.0 / state.gamma + pmatmul(coef, state.A**2)


@functools.partial(jax.jit, static_argnames=("scaling", "with_a"))
def _push(state: LSR1State, s, y, *, scaling: bool, with_a: bool = True) -> LSR1State:
    """Guarded SR1 push (reference push!, src/lsr1.jl:119-184).

    ``with_a=False`` (the operator's lazy default) maintains only S/Y/Grams
    — O(mem·n) — and defers the O(mem²·n) a-vector recompute to
    ``_recompute_all_a`` on first diag()/opnorm-bound use; the compact
    apply never needs it. Acceptance uses the compact Bs.

    Note on lazy/eager parity: the compact Bs comes from a solve of the
    small M matrix while the eager path uses the masked a-form recursion —
    algebraically identical, but when M is ill-conditioned the two Bs
    values can differ enough to flip the well-definedness test on
    BORDERLINE pairs (|⟨y−Bs, s⟩| within a few ulps of its threshold), so
    a lazy and an eager operator fed the same stream may diverge there.
    Both decisions are individually sound SR1 updates (the threshold is
    itself a heuristic guard, reference src/lsr1.jl:131-149); callers
    needing bit-identical accept/reject across modes should use
    ``lazy_a=False``."""
    mem, _ = state.S.shape
    eps = jnp.finfo(state.S.dtype).eps

    Bs = lsr1_apply(state, s) if with_a else lsr1_apply_compact(state, s)
    ymBs = y - Bs
    ys = pdot(y, s)
    s_norm = jnp.linalg.norm(s)
    yy = pdot(y, y)

    well_defined = jnp.abs(pdot(ymBs, s)) >= eps + eps * jnp.linalg.norm(ymBs) * s_norm
    if scaling:
        y_norm = jnp.sqrt(yy)
        sufficient_curvature = jnp.abs(ys) >= eps * y_norm * s_norm
        gamma_new = _safe_div(ys, yy)
        resid = jnp.linalg.norm(y - _safe_div(s, gamma_new))
        scaling_condition = resid >= eps * y_norm * s_norm
        accept = well_defined & sufficient_curvature & scaling_condition
    else:
        gamma_new = state.gamma
        accept = well_defined

    ins = state.insert
    # rejection gate fused into the ROW writes (a rejected push rewrites
    # the slot's existing values) instead of a post-hoc whole-state select,
    # which would cost an extra full pass over every (mem, n) leaf.
    s = jnp.where(accept, s, state.S[ins])
    y = jnp.where(accept, y, state.Y[ins])
    ysv_val = jnp.where(accept, ys, state.ys[ins])
    S = state.S.at[ins].set(s)
    Y = state.Y.at[ins].set(y)
    ysv = state.ys.at[ins].set(ysv_val)
    gamma = jnp.where(accept, gamma_new, state.gamma) if scaling else state.gamma
    insert_new = jnp.where(accept, jnp.mod(ins + 1, mem), ins).astype(jnp.int32)

    # Gram maintenance for the compact form: one row+column each of SᵀY
    # and SᵀS — three (mem, n) matvecs (idempotent rewrites when rejected).
    SY = state.SY.at[ins, :].set(pmatmul(Y, s)).at[:, ins].set(pmatmul(S, y))
    ss_vec = pmatmul(S, s)
    SS = state.SS.at[ins, :].set(ss_vec).at[:, ins].set(ss_vec)

    new = LSR1State(S=S, Y=Y, ys=ysv, A=state.A, as_=state.as_, SY=SY, SS=SS,
                    gamma=gamma, insert=insert_new,
                    opnorm_ub=state.opnorm_ub, Minv=state.Minv)
    new = new._replace(Minv=_compact_minv(new))
    if with_a:
        new = _recompute_all_a(new)
    return new


def _recompute_all_a(state: LSR1State) -> LSR1State:
    """Recompute every rank-1 a-vector and the opnorm bound from
    (S, Y, ys, γ) alone, in chronological order (oldest → newest; reference
    src/lsr1.jl:166-181). Inner corrections batched as mat-vecs."""
    mem = state.S.shape[0]
    order = jnp.mod(state.insert + jnp.arange(mem), mem)
    S_ord = state.S[order]
    Y_ord = state.Y[order]
    valid = state.ys[order] != 0
    gamma = state.gamma
    idx = jnp.arange(mem)

    def body(i, carry):
        A_ord, as_ord = carry
        s_i = S_ord[i]
        a = Y_ord[i] - s_i / gamma
        mask = (idx < i) & valid
        coef = jnp.where(mask, _safe_div(pmatmul(A_ord, s_i), as_ord), 0.0)
        a = a - pmatmul(A_ord.T, coef)
        a = jnp.where(valid[i], a, jnp.zeros_like(a))
        return A_ord.at[i].set(a), as_ord.at[i].set(pdot(a, s_i))

    A_ord, as_ord = lax.fori_loop(
        0, mem, body, (jnp.zeros_like(S_ord), jnp.zeros_like(state.ys))
    )
    A_new = jnp.zeros_like(A_ord).at[order].set(A_ord)
    as_new = jnp.zeros_like(as_ord).at[order].set(as_ord)

    # opnorm bound rebuilt from the a-form (reference src/lsr1.jl:156-179)
    ub = jnp.where(gamma != 0, 1.0 / jnp.abs(jnp.where(gamma != 0, gamma, 1.0)), 1.0)
    contrib = jnp.where(
        valid & (as_ord != 0),
        _safe_div(jnp.sum(A_ord**2, axis=1), jnp.abs(as_ord)),
        0.0,
    )
    ub = ub + jnp.sum(contrib)
    return state._replace(A=A_new, as_=as_new, opnorm_ub=ub)


_recompute_all_a_jit = jax.jit(_recompute_all_a)


class LSR1Operator(LinearOperator):
    """Limited-memory SR1 approximation, forward form only (reference
    src/lsr1.jl:39-113). Symmetric but generally indefinite; no transpose
    products needed (symmetry infers them)."""

    _fields_children = ("state",)
    _fields_aux = ("_n", "_mem", "_scaling", "_dtype_name", "_lazy_a")

    def __init__(self, *args, mem: int = 5, scaling: bool = False, dtype=None,
                 lazy_a: bool = True):
        super().__init__()
        if len(args) == 2:
            dt, n = args
            dt = jax.dtypes.canonicalize_dtype(dt)
        elif len(args) == 1:
            dt, n = (dtype if dtype is not None else jnp.float64), args[0]
            dt = jax.dtypes.canonicalize_dtype(dt)
        else:
            raise TypeError("LSR1Operator(n) or LSR1Operator(dtype, n)")
        if jnp.issubdtype(jnp.dtype(dt), jnp.complexfloating):
            raise LinearOperatorException(
                "complex L-SR1 is not supported: the acceptance tests assume "
                "real inner products"
            )
        self._n = int(n)
        self._mem = max(int(mem), 1)
        self._scaling = bool(scaling)
        self._dtype_name = jnp.dtype(dt).name
        # lazy a-vector maintenance: pushes skip the O(mem²·n) recompute;
        # diag/opnorm-bound trigger it on demand (compact apply never does)
        self._lazy_a = bool(lazy_a)
        self.state = _init_state(self._n, self._mem, jnp.dtype(dt))
        object.__setattr__(self, "_a_fresh", True)  # empty memory is fresh

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if name == "state":
            object.__setattr__(self, "_a_fresh", False)

    def _materialized_state(self) -> LSR1State:
        """State with the a-form guaranteed fresh; under an outer trace the
        result is returned without caching (see LBFGSOperator). Honored for
        eager operators too (an external state swap clears the flag)."""
        if getattr(self, "_a_fresh", False):
            return self.state
        new = _recompute_all_a_jit(self.state)
        if not any(
            isinstance(x, jax.core.Tracer) for x in jax.tree_util.tree_leaves(new)
        ):
            self.state = new
            object.__setattr__(self, "_a_fresh", True)
        return new

    def ensure_a(self) -> "LSR1Operator":
        """Materialize the a-form (rank-1 vectors + opnorm bound) if lazy
        pushes deferred it."""
        self._materialized_state()
        return self

    def _before_save(self):
        self.ensure_a()

    @property
    def nrow(self):
        return self._n

    @property
    def ncol(self):
        return self._n

    @property
    def dtype(self):
        return jnp.dtype(self._dtype_name)

    @property
    def symmetric(self):
        return True

    @property
    def hermitian(self):
        return True

    @property
    def mem(self):
        return self._mem

    @property
    def scaling(self):
        return self._scaling

    @property
    def insert(self) -> int:
        return int(self.state.insert)

    @property
    def scaling_factor(self) -> float:
        return float(self.state.gamma)

    @property
    def opnorm_upper_bound(self) -> float:
        return float(self._materialized_state().opnorm_ub)

    def _prod(self, v):
        # compact (BNS) form: O(mem·n) without the a-vectors
        return lsr1_apply_compact(self.state, v)

    def apply_matrix(self, M, mode: str = "N"):
        return lsr1_apply_matrix_compact(self.state, M)

    def push(self, s, y):
        """Guarded SR1 insert (reference push!, src/lsr1.jl:115-184).
        Silently rejects updates failing the well-definedness / curvature /
        scaling conditions."""
        dt = self.dtype
        # the EAGER push's acceptance test reads the a-form (lsr1_apply),
        # so materialize first if the current state came from elsewhere
        base = self.state if self._lazy_a else self._materialized_state()
        self.state = _push(base, jnp.asarray(s, dt), jnp.asarray(y, dt),
                           scaling=self._scaling, with_a=not self._lazy_a)
        if not self._lazy_a:
            object.__setattr__(self, "_a_fresh", True)
        return self

    def diag(self):
        return lsr1_diag(self._materialized_state())

    def reset(self):
        """reference reset! (src/lsr1.jl:213-240)."""
        self.state = _init_state(self._n, self._mem, self.dtype)
        object.__setattr__(self, "_a_fresh", True)
        self.reset_counters()
        return self

    def _name(self):
        return "LSR1 operator"


register_operator(LSR1Operator)
