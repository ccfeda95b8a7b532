"""Limited-memory BFGS operators with device-resident ring-buffer state.

JAX redesign of the reference L-BFGS operators
(reference: src/lbfgs.jl). Differences, on purpose (SURVEY.md §7 design
stance 2):

- The {s, y} memory is NOT a Vector-of-Vectors (reference src/lbfgs.jl:12-13)
  but stacked device arrays of shape ``(mem, n)`` living in an immutable
  pytree ``LBFGSState``. The ring-buffer insert position is a traced int32
  scalar, so ``push`` compiles ONCE and every subsequent push is a cached
  jit call (the analogue of the reference's zero-allocation push,
  reference test/test_lbfgs.jl:208-217).
- The forward product ``B v = v/γ + Σ bᵢ(bᵢᵀv) − aᵢ(aᵢᵀv)``
  (Nocedal & Wright Procedure 7.6; reference src/lbfgs.jl:173-202) is two
  ``(mem, n)`` mat-vecs — fully parallel, no sequential loop.
- The inverse two-loop recursion (Procedure 7.4; reference
  src/lbfgs.jl:117-154) has an inherent loop-carried scalar dependence; it is
  a ``lax.fori_loop`` over ``mem`` steps of one dot + one axpy each, which
  XLA fuses into a single compiled loop kernel (no per-step dispatch).
- The O(mem²·n) recomputation of the forward-form ``a`` vectors on push
  (reference src/lbfgs.jl:236-250) is expressed as ``mem`` steps of batched
  ``(mem, n)`` mat-vecs over the chronologically-gathered memory.
- Empty ring slots are handled by masking (ρ = 0 ⇒ the slot contributes
  nothing), mirroring the reference's ``ys[k] != 0`` guards
  (src/lbfgs.jl:132, 191) without dynamic shapes.

Semantics preserved exactly: curvature rejection ``ys ≤ eps``
(src/lbfgs.jl:281-284), Powell damping with σ₂/σ₃ thresholds for both forms
(src/lbfgs.jl:289-357), scaling γ = ys/yᵀy (src/lbfgs.jl:223-227), the
incrementally-tracked operator-norm upper bound (src/lbfgs.jl:11,224-234),
forward-only ``diag`` (src/lbfgs.jl:374-395), and ``reset``
(src/lbfgs.jl:401-427).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core.precision import pdot, pmatmul
from ..core.base import LinearOperator, LinearOperatorException, register_operator

__all__ = ["LBFGSState", "LBFGSOperator", "InverseLBFGSOperator"]


class LBFGSState(NamedTuple):
    """Device pytree holding the L-BFGS memory (reference LBFGSData,
    src/lbfgs.jl:4-24). All ring indices are 0-based.

    ``SY``/``YY`` are the Gram matrices SᵀY and YᵀY (slot order),
    maintained incrementally on push for the compact-form inverse apply."""

    S: jax.Array  # (mem, n) step history
    Y: jax.Array  # (mem, n) gradient-difference history
    ys: jax.Array  # (mem,)  curvatures <y, s>; 0 marks an empty slot
    A: jax.Array  # (mem, n) forward-form 'a' vectors ((0, n) for inverse)
    B: jax.Array  # (mem, n) forward-form 'b' vectors ((0, n) for inverse)
    norm_b2: jax.Array  # (mem,) ‖bᵢ‖² for the opnorm bound ((0,) for inverse)
    SY: jax.Array  # (mem, mem) Gram SᵀY: SY[i, j] = <sᵢ, yⱼ>
    YY: jax.Array  # (mem, mem) Gram YᵀY
    SS: jax.Array  # (mem, mem) Gram SᵀS (forward compact / shifted solves)
    gamma: jax.Array  # () scaling factor γ (1 when scaling disabled)
    insert: jax.Array  # () int32 next ring slot, 0-based
    opnorm_ub: jax.Array  # () upper bound on ‖B‖₂ (forward form)
    G: jax.Array  # (2, 2mem, 2mem) compact-apply middle matrices for
    # BOTH forms ([0]=forward, [1]=inverse), maintained at push by
    # _compact_middle so the hot applies run zero factorizations AND any
    # state works with either apply form (a state pushed by a forward
    # operator can be restored into an inverse one and vice versa) —
    # see forward/inverse_apply_compact


def _init_state(n: int, mem: int, dtype, inverse: bool) -> LBFGSState:
    rdt = jnp.finfo(dtype).dtype if jnp.issubdtype(dtype, jnp.complexfloating) else dtype
    fmem = 0 if inverse else mem
    return LBFGSState(
        S=jnp.zeros((mem, n), dtype),
        Y=jnp.zeros((mem, n), dtype),
        ys=jnp.zeros((mem,), dtype),
        A=jnp.zeros((fmem, n), dtype),
        B=jnp.zeros((fmem, n), dtype),
        norm_b2=jnp.zeros((fmem,), rdt),
        SY=jnp.zeros((mem, mem), dtype),
        YY=jnp.zeros((mem, mem), dtype),
        SS=jnp.zeros((mem, mem), dtype),
        gamma=jnp.ones((), dtype),
        insert=jnp.zeros((), jnp.int32),
        opnorm_ub=jnp.ones((), rdt),
        G=jnp.zeros((2, 2 * mem, 2 * mem), dtype),
    )


# ----------------------------------------------------------------------------
# Pure applies
# ----------------------------------------------------------------------------


def _safe_inv(x):
    return jnp.where(x != 0, 1.0 / jnp.where(x != 0, x, 1.0), 0.0)


def inverse_apply(state: LBFGSState, x):
    """Two-loop recursion, H v (Nocedal & Wright Procedure 7.4; reference
    src/lbfgs.jl:117-154). Empty slots have ρ = 0 and drop out."""
    mem = state.S.shape[0]
    rho = _safe_inv(state.ys)
    q0 = x.astype(jnp.result_type(x.dtype, state.S.dtype))

    def loop1(i, carry):
        q, alph = carry
        k = jnp.mod(state.insert - i - 1, mem)
        ak = rho[k] * pdot(state.S[k], q)
        q = q - ak * state.Y[k]
        return q, alph.at[k].set(ak)

    q, alph = lax.fori_loop(0, mem, loop1, (q0, jnp.zeros((mem,), q0.dtype)))
    q = q * state.gamma

    def loop2(i, q):
        k = jnp.mod(state.insert + i, mem)
        beta = alph[k] - rho[k] * pdot(state.Y[k], q)
        return q + beta * state.S[k]

    return lax.fori_loop(0, mem, loop2, q)


def _compact_middle(state: LBFGSState, inverse: bool):
    """The (2mem, 2mem) middle matrix G of the compact-form apply, in SLOT
    coordinates:

      forward:  B v = θ v + [Sᵀ Yᵀ] G [S; Y] v,   θ = 1/γ
      inverse:  H v = γ v + [Sᵀ Yᵀ] G [S; Y] v

    G depends only on the SMALL state pieces (Grams, γ, ys, insert), so it
    is maintained at PUSH time and the hot applies run ZERO factorizations:
    a mem-sized Cholesky / triangular-solve chain at apply time is pure
    sequential latency — precomputing G turns both applies into two
    (mem, n) passes + one (2mem)² mat-vec.

    The conventions match the BNS U factors the apply materializes
    (``_compact_apply``): forward W = [θS; Y], inverse W = [S; γY],
    both in CHRONO row order.

    Forward middle (BNS 1994 thm 2.3, Schur-eliminating the diagonal −D
    block): with L = strict lower of chrono SᵀY, D = its diagonal,
    M = θSᵀS + L D⁻¹ Lᵀ (SPD exactly when K is invertible),

      G = −[[M⁻¹,        M⁻¹ L D⁻¹         ],
            [D⁻¹Lᵀ M⁻¹,  D⁻¹Lᵀ M⁻¹ L D⁻¹ − D⁻¹]]

    Inverse middle (BNS 1994 eq. 2.6, chrono R = upper of SᵀY):

      G = [[R⁻ᵀ(D+γYᵀY)R⁻¹,  −R⁻ᵀ], [−R⁻¹, 0]]

    Empty slots carry unit R/M diagonal; their G rows/cols are exactly
    zero because the masked Grams are zero there.

    The apply builds W per call as a dynamic-index gather with a
    traced-scalar multiply on one half (exactly the form above)."""
    from jax.scipy.linalg import cho_solve, solve_triangular

    mem = state.S.shape[0]
    # state.insert is the NEXT slot to write, so the oldest surviving pair
    # lives at `insert` itself (unlike push-time recompute, where insert
    # is the slot just written).
    order = jnp.mod(state.insert + jnp.arange(mem), mem)  # oldest → newest
    valid = state.ys[order] != 0
    vmask2 = valid[:, None] & valid[None, :]
    gamma = state.gamma
    SY_o = jnp.where(vmask2, state.SY[order][:, order], 0.0)
    eye = jnp.eye(mem, dtype=SY_o.dtype)
    fix = jnp.diag(jnp.where(valid, 0.0, 1.0))
    if inverse:
        YY_o = jnp.where(vmask2, state.YY[order][:, order], 0.0)
        tri = jnp.triu(jnp.ones((mem, mem), dtype=bool))
        R = jnp.where(tri, SY_o, 0.0) + fix
        D = jnp.where(valid, jnp.diag(SY_o), 0.0)
        Rinv = solve_triangular(R, eye, lower=False)
        # zero the unit-diagonal fix rows so empty slots contribute nothing
        Rinv = jnp.where(vmask2, Rinv, 0.0)
        B11 = pmatmul(Rinv.T, D[:, None] * Rinv + gamma * pmatmul(YY_o, Rinv))
        Gc = jnp.block([
            [B11, -Rinv.T],
            [-Rinv, jnp.zeros((mem, mem), SY_o.dtype)],
        ])
    else:
        SS_o = jnp.where(vmask2, state.SS[order][:, order], 0.0)
        theta = 1.0 / gamma
        L = jnp.tril(SY_o, k=-1)
        d_inv = _safe_inv(jnp.diag(SY_o))  # 0 on empty slots
        Ldi = L * d_inv[None, :]
        M = theta * SS_o + pmatmul(Ldi, L.T) + fix
        C = jnp.linalg.cholesky(M)
        Minv = cho_solve((C, True), eye)
        Minv = jnp.where(vmask2, Minv, 0.0)
        MLdi = pmatmul(Minv, Ldi)
        G22 = -pmatmul(Ldi.T, MLdi) + jnp.diag(d_inv)
        Gc = jnp.block([[-Minv, -MLdi], [-MLdi.T, G22]])
    return Gc


def _compact_apply(state: LBFGSState, x, inverse: bool):
    """Shared compact-form apply: one (2mem, n) chrono-gathered W pass,
    one (2mem)² mat-vec with the push-maintained middle ``state.G``,
    one output pass over Wᵀ:

      forward:  B v = θv + Wᵀ G (W v),  W = [θS; Y]   (chrono rows)
      inverse:  H v = γv + Wᵀ G (W v),  W = [S; γY]

    The W build (dynamic gather + traced-scalar multiply on one half) is
    the PERFORMANCE-CRITICAL shape — see ``_compact_middle``."""
    mem = state.S.shape[0]
    order = jnp.mod(state.insert + jnp.arange(mem), mem)
    if inverse:
        scale = state.gamma
        W = jnp.concatenate(
            [state.S[order], scale * state.Y[order]], axis=0)
    else:
        scale = 1.0 / state.gamma
        W = jnp.concatenate(
            [scale * state.S[order], state.Y[order]], axis=0)
    coef = pmatmul(state.G[1 if inverse else 0], pmatmul(W, x))
    return scale * x + pmatmul(W.T, coef)


def inverse_apply_compact(state: LBFGSState, x):
    """Compact-representation inverse apply (Byrd-Nocedal-Schnabel 1994):
    numerically identical to the two-loop recursion but expressed as TWO
    (2·mem, n) passes plus one small mat-vec — no sequential loop over
    memory, so it runs at the 2-pass memory roofline (the compact form of
    reference src/lbfgs.jl:117-154; SURVEY.md §7 hard part 1). The middle
    matrix is push-maintained (``_compact_middle``)."""
    return _compact_apply(state, x, inverse=True)


def _forward_compact_K(state: LBFGSState, order, *, with_grams: bool = False):
    """The small middle-matrix pieces of the forward compact form
    B = θI − U K⁻¹ Uᵀ with U = [θS Y], K = [[θSᵀS, L], [Lᵀ, −D]]
    (Byrd-Nocedal-Schnabel 1994, thm 2.3), chronologically ordered. Empty
    slots get unit K diagonal (their U columns are zeroed by the callers'
    valid masks / zero rows). With ``with_grams`` also returns the masked,
    reordered (SS, SY, YY, valid) pieces for Woodbury shifted solves."""
    valid = state.ys[order] != 0
    vmask2 = valid[:, None] & valid[None, :]

    theta = 1.0 / state.gamma
    SY_o = jnp.where(vmask2, state.SY[order][:, order], 0.0)
    SS_o = jnp.where(vmask2, state.SS[order][:, order], 0.0)
    L = jnp.tril(SY_o, k=-1)
    D = jnp.diag(jnp.diag(SY_o))
    K = jnp.block([[theta * SS_o, L], [L.T, -D]])
    valid2 = jnp.concatenate([valid, valid])
    K = jnp.where(valid2[:, None] & valid2[None, :], K, 0.0) + jnp.diag(
        jnp.where(valid2, 0.0, 1.0)
    )
    if with_grams:
        YY_o = jnp.where(vmask2, state.YY[order][:, order], 0.0)
        return theta, K, SS_o, SY_o, YY_o, valid
    return theta, K


def _forward_compact_parts(state: LBFGSState, *, with_grams: bool = False):
    """``_forward_compact_K`` plus the materialized chrono W = [θS; Y] —
    for consumers that genuinely need W as an array (EJM shifted solves).
    The hot applies use the no-gather slot-order passes instead."""
    mem = state.S.shape[0]
    order = jnp.mod(state.insert + jnp.arange(mem), mem)  # oldest → newest
    parts = _forward_compact_K(state, order, with_grams=with_grams)
    theta = parts[0]
    W = jnp.concatenate([theta * state.S[order], state.Y[order]], axis=0)
    if with_grams:
        _, K, SS_o, SY_o, YY_o, valid = parts
        return theta, K, W, SS_o, SY_o, YY_o, valid
    return theta, parts[1], W


def forward_apply_compact(state: LBFGSState, x):
    """Forward product via the compact representation (BNS 1994 thm 2.3):
    TWO (2·mem, n) passes + one small mat-vec with the push-maintained
    middle matrix — the same roofline shape as the compact inverse apply;
    numerically identical to the a/b form (reference
    src/lbfgs.jl:173-202). See ``_compact_middle`` for the middle-matrix
    algebra and why it is precomputed at push."""
    return _compact_apply(state, x, inverse=False)


def forward_apply(state: LBFGSState, x):
    """B v = v/γ + Bᵀ(B v) − Aᵀ(A v) as batched (mem, n) mat-vecs over the
    reference's a/b vectors (reference src/lbfgs.jl:173-202; empty slots
    hold zero rows). Kept as the parity/reference path; the operator's hot
    apply uses ``forward_apply_compact``."""
    q = x / state.gamma
    bx = pmatmul(state.B, x)
    ax = pmatmul(state.A, x)
    return q + pmatmul(state.B.T, bx) - pmatmul(state.A.T, ax)


def forward_diag(state: LBFGSState):
    """diag(B) = 1/γ + Σ bᵢ² − aᵢ² (reference src/lbfgs.jl:379-395)."""
    return 1.0 / state.gamma + jnp.sum(state.B**2 - state.A**2, axis=0)


# ----------------------------------------------------------------------------
# Pure push
# ----------------------------------------------------------------------------


def _chrono_order(insert, mem: int):
    """Slot indices oldest → newest given that the newest pair was just
    written at ``insert`` (reference iteration k = mod(insert+i-1, mem)+1,
    src/lbfgs.jl:236-237)."""
    return jnp.mod(insert + 1 + jnp.arange(mem), mem)


def _recompute_ab(S, ys, b_insert_row, B_old, insert, gamma, mem: int):
    """Recompute the forward-form a-vectors for every occupied slot in
    chronological order (reference src/lbfgs.jl:229-251). Each step is two
    batched (mem, n) mat-vecs instead of the reference's double scalar loop."""
    B_new = B_old.at[insert].set(b_insert_row)
    order = _chrono_order(insert, mem)
    A_new = _a_recursion(S[order], B_new[order], ys[order] != 0, gamma, order)
    return A_new, B_new


def _a_recursion(S_ord, B_ord, valid, gamma, order):
    """The forward-form a-vector recursion over chronologically-ordered
    slots (shared by the eager push recompute and the deferred
    ``_recompute_all_a``): each step is two batched (mem, n) mat-vecs
    instead of the reference's double scalar loop
    (reference src/lbfgs.jl:229-251)."""
    mem = S_ord.shape[0]
    idx = jnp.arange(mem)

    def body(i, A_ord):
        s_i = S_ord[i]
        mask = (idx < i) & valid
        bs = jnp.where(mask, pmatmul(B_ord, s_i), 0.0)
        as_ = jnp.where(mask, pmatmul(A_ord, s_i), 0.0)
        a = s_i / gamma + pmatmul(B_ord.T, bs) - pmatmul(A_ord.T, as_)
        denom = jnp.sqrt(pdot(s_i, a))
        a = a / jnp.where(denom != 0, denom, 1.0)
        return A_ord.at[i].set(jnp.where(valid[i], a, jnp.zeros_like(a)))

    A_ord = lax.fori_loop(0, mem, body, jnp.zeros_like(B_ord))
    return jnp.zeros_like(A_ord).at[order].set(A_ord)


def _recompute_all_a(state: LBFGSState) -> LBFGSState:
    """Recompute every forward-form a-vector from (S, Y, ys, B, γ) alone —
    the deferred half of the push when ``lazy_ab`` is on. Chronological
    order at this point: the oldest surviving pair sits at ``state.insert``
    (the next write slot)."""
    mem = state.S.shape[0]
    order = jnp.mod(state.insert + jnp.arange(mem), mem)  # oldest → newest
    A_new = _a_recursion(
        state.S[order], state.B[order], state.ys[order] != 0, state.gamma, order
    )
    return state._replace(A=A_new)


_recompute_all_a_jit = jax.jit(_recompute_all_a)


def _push_common(state: LBFGSState, s, y, ys, *, scaling: bool, inverse: bool,
                 with_ab: bool = True, accept=None) -> LBFGSState:
    """Insert an accepted pair (reference push_common!, src/lbfgs.jl:210-255).

    ``with_ab=False`` (the operator's ``lazy_ab`` mode) maintains the cheap
    pieces only — b row, ‖b‖², opnorm bound, Grams — and defers the
    O(mem²·n) a-vector recompute to ``_recompute_all_a`` on first use
    (diag / EJM / a-b-form apply). The hot compact-form applies never read
    the a-vectors, so production pushes drop from O(mem²·n) to O(mem·n).

    ``accept`` (traced bool or None=always): the rejection gate is fused
    into the ROW writes — a rejected push rewrites the slot's existing
    values — instead of a post-hoc whole-state select (which costs an
    extra full pass over every (mem, n) leaf)."""
    mem = state.S.shape[0]
    ins = state.insert
    if accept is not None:
        # gated row values: a rejected push re-writes the old slot contents
        s = jnp.where(accept, s, state.S[ins])
        y = jnp.where(accept, y, state.Y[ins])
        ys = jnp.where(accept, ys, state.ys[ins])
    S = state.S.at[ins].set(s)
    Y = state.Y.at[ins].set(y)
    ysv = state.ys.at[ins].set(ys)

    # Gram maintenance for the compact inverse form: one row+column each of
    # SᵀY and YᵀY — three (mem, n) matvecs (O(mem·n), same order as the
    # vector writes above). With gated rows a rejected push recomputes the
    # Gram rows it already holds (idempotent by induction).
    SY = state.SY.at[ins, :].set(pmatmul(Y, s)).at[:, ins].set(pmatmul(S, y))
    yy_vec = pmatmul(Y, y)
    YY = state.YY.at[ins, :].set(yy_vec).at[:, ins].set(yy_vec)
    ss_vec = pmatmul(S, s)
    SS = state.SS.at[ins, :].set(ss_vec).at[:, ins].set(ss_vec)

    gamma = state.gamma
    ub = state.opnorm_ub
    if scaling:
        yy = pdot(y, y)
        gamma_new = ys / jnp.where(yy != 0, yy, 1.0)
        ub_new = ub - _safe_inv(gamma).real + _safe_inv(gamma_new).real
        if accept is None:
            gamma, ub = gamma_new, ub_new
        else:
            gamma = jnp.where(accept, gamma_new, gamma)
            ub = jnp.where(accept, ub_new, ub)

    if inverse:
        A, B, nb2 = state.A, state.B, state.norm_b2
    else:
        # guard: with a gated-away (empty-slot) rewrite ys may be 0
        b_row = y / jnp.sqrt(jnp.where(ys != 0, ys, 1.0))
        nb2_new = jnp.real(pdot(b_row, b_row))
        ub = ub - state.norm_b2[ins] + nb2_new
        nb2 = state.norm_b2.at[ins].set(nb2_new)
        if with_ab:
            A, B = _recompute_ab(S, ysv, b_row, state.B, ins, gamma, mem)
        else:
            A, B = state.A, state.B.at[ins].set(b_row)

    ins_new = jnp.mod(ins + 1, mem).astype(jnp.int32)
    if accept is not None:
        ins_new = jnp.where(accept, ins_new, ins).astype(jnp.int32)
    new = LBFGSState(
        S=S,
        Y=Y,
        ys=ysv,
        A=A,
        B=B,
        norm_b2=nb2,
        SY=SY,
        YY=YY,
        SS=SS,
        gamma=gamma,
        insert=ins_new,
        opnorm_ub=ub,
        G=state.G,
    )
    # refresh BOTH compact middle matrices from the final small pieces —
    # O(mem³) device work, so the hot applies run zero factorizations and
    # the state stays form-agnostic (either operator form can apply it)
    return new._replace(G=jnp.stack([
        _compact_middle(new, False), _compact_middle(new, True)]))


def _push_plain_impl(state, s, y, *, scaling, inverse, with_ab=True):
    """Undamped push with curvature rejection ys ≤ eps
    (reference src/lbfgs.jl:269-287)."""
    ys = pdot(y, s)
    eps = jnp.finfo(state.S.dtype).eps
    return _push_common(state, s, y, ys, scaling=scaling, inverse=inverse,
                        with_ab=with_ab, accept=ys > eps)


_push_plain = jax.jit(
    _push_plain_impl, static_argnames=("scaling", "inverse", "with_ab")
)
# donated variant (opt-in via LBFGSOperator(donate_push=True)): XLA updates
# the ring buffers IN PLACE — the reference's push! semantics — so a push
# costs only the Gram matvecs + O(n) row writes. Any alias of the previous
# state pytree becomes invalid.
_push_plain_donated = jax.jit(
    _push_plain_impl,
    static_argnames=("scaling", "inverse", "with_ab"),
    donate_argnums=(0,),
)


def _powell_blend(s, y, ys, Bs, sigma2, sigma3):
    """Powell's damped update strategy (reference src/lbfgs.jl:304-318)."""
    sBs = pdot(s, Bs)
    lo = ys < (1 - sigma2) * sBs
    hi = ys > (1 + sigma3) * sBs
    theta = jnp.where(
        lo,
        sigma2 * sBs / jnp.where(sBs - ys != 0, sBs - ys, 1.0),
        jnp.where(hi, sigma3 * sBs / jnp.where(ys - sBs != 0, ys - sBs, 1.0), 1.0),
    )
    damp = lo | hi
    y_d = jnp.where(damp, theta * y + (1 - theta) * Bs, y)
    ys_d = jnp.where(damp, theta * ys + (1 - theta) * sBs, ys)
    return y_d, ys_d


@functools.partial(jax.jit, static_argnames=("scaling", "with_ab"))
def _push_damped_forward(state, s, y, sigma2, sigma3, *, scaling, with_ab=True):
    """Damped forward push: Bs = B s, Powell blend, always insert
    (reference src/lbfgs.jl:289-321). Bs comes from the compact form so the
    push never needs the (possibly deferred) a-vectors."""
    Bs = forward_apply_compact(state, s)
    y_d, ys_d = _powell_blend(s, y, pdot(y, s), Bs, sigma2, sigma3)
    return _push_common(state, s, y_d, ys_d, scaling=scaling, inverse=False,
                        with_ab=with_ab)


@functools.partial(jax.jit, static_argnames=("scaling",))
def _push_damped_inverse(state, s, y, alpha, g, sigma2, sigma3, *, scaling):
    """Damped inverse push: Bs = −α g, Powell blend, always insert
    (reference src/lbfgs.jl:323-357)."""
    Bs = -alpha * g
    y_d, ys_d = _powell_blend(s, y, pdot(y, s), Bs, sigma2, sigma3)
    return _push_common(state, s, y_d, ys_d, scaling=scaling, inverse=True)


# ----------------------------------------------------------------------------
# Operator classes
# ----------------------------------------------------------------------------


class LBFGSOperator(LinearOperator):
    """Limited-memory BFGS approximation (forward form by default; reference
    src/lbfgs.jl:62-104,168-206).

    ``LBFGSOperator(n, mem=5, scaling=True, damped=False)`` or
    ``LBFGSOperator(dtype, n, ...)``. Symmetric and positive definite by
    construction. Mutable host wrapper over an immutable device pytree: every
    ``push``/``reset`` swaps ``self.state`` for a new pytree produced by one
    cached jit call.
    """

    _fields_children = ("state",)
    _fields_aux = ("_n", "_mem", "_scaling", "_damped", "_inverse", "_dtype_name", "_sigma2", "_sigma3", "_lazy_ab", "_donate_push")

    _is_inverse_ctor = False

    def __init__(self, *args, mem: int = 5, scaling: bool = True, damped: bool = False,
                 sigma2: float = 0.99, sigma3: float = 10.0, dtype=None,
                 lazy_ab: bool = True, donate_push: bool = False):
        super().__init__()
        # reference-style (T, n) or (n,) positional forms (src/lbfgs.jl:112,168)
        if len(args) == 2:
            dt, n = args
            dt = jax.dtypes.canonicalize_dtype(dt)
        elif len(args) == 1:
            dt, n = (dtype if dtype is not None else jnp.float64), args[0]
            dt = jax.dtypes.canonicalize_dtype(dt)
        else:
            raise TypeError("LBFGSOperator(n) or LBFGSOperator(dtype, n)")
        if jnp.issubdtype(jnp.dtype(dt), jnp.complexfloating):
            raise LinearOperatorException(
                "complex L-BFGS is not supported: the curvature tests and "
                "Gram updates assume real inner products"
            )
        self._n = int(n)
        self._mem = max(int(mem), 1)
        self._scaling = bool(scaling)
        self._damped = bool(damped)
        self._inverse = bool(type(self)._is_inverse_ctor)
        self._dtype_name = jnp.dtype(dt).name
        self._sigma2 = float(sigma2)
        self._sigma3 = float(sigma3)
        # lazy a-vector maintenance (forward form only): pushes skip the
        # O(mem²·n) recompute; diag/EJM/a-b oracles trigger it on demand
        self._lazy_ab = bool(lazy_ab) and not self._inverse
        # donate_push=True: XLA updates the ring buffers in place (the
        # reference's push! semantics) — any alias of a previous state
        # pytree (e.g. a kept `op.state`) becomes invalid after a push.
        self._donate_push = bool(donate_push)
        self.state = _init_state(self._n, self._mem, jnp.dtype(dt), self._inverse)
        object.__setattr__(self, "_ab_fresh", True)  # empty memory is trivially fresh

    # --- metadata ---
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
    def inverse(self):
        return self._inverse

    @property
    def damped(self):
        return self._damped

    @property
    def scaling(self):
        return self._scaling

    @property
    def insert(self) -> int:
        """0-based ring-buffer insert position (reference data.insert is
        1-based; src/lbfgs.jl:19)."""
        return int(self.state.insert)

    @property
    def scaling_factor(self) -> float:
        return float(self.state.gamma.real)

    @property
    def opnorm_upper_bound(self) -> float:
        """Incrementally-tracked upper bound for ‖Bₖ‖₂ (reference
        src/lbfgs.jl:11)."""
        return float(self.state.opnorm_ub)

    # --- apply ---
    def _prod(self, v):
        # compact (BNS) forms: two (2mem, n) passes, no sequential loop
        if self._inverse:
            return inverse_apply_compact(self.state, v)
        return forward_apply_compact(self.state, v)

    def apply_matrix(self, M, mode: str = "N"):
        # symmetric & real: all four modes coincide; the compact forward
        # apply works unchanged for (n, k) right-hand sides
        if not self._inverse:
            return forward_apply_compact(self.state, M)
        return super().apply_matrix(M, mode)

    # --- state updates ---
    def push(self, s, y, *args):
        """Insert a {s, y} pair (reference push!, src/lbfgs.jl:257-367).

        Forms: ``push(s, y)``; damped forward also accepts ``push(s, y, Bs)``
        (Bs recomputed on device — kept for call-form parity); damped inverse
        requires ``push(s, y, alpha, g[, Bs])``.
        """
        dt = self.dtype
        s = jnp.asarray(s, dt)
        y = jnp.asarray(y, dt)
        with_ab = not self._lazy_ab
        if len(args) == 0:
            if self._damped:
                if self._inverse:
                    raise ValueError(
                        "damped inverse L-BFGS requires push(s, y, alpha, g)"
                    )
                self.state = _push_damped_forward(
                    self.state, s, y, dt.type(self._sigma2), dt.type(self._sigma3),
                    scaling=self._scaling, with_ab=with_ab,
                )
            else:
                push_fn = _push_plain_donated if self._donate_push else _push_plain
                self.state = push_fn(
                    self.state, s, y, scaling=self._scaling, inverse=self._inverse,
                    with_ab=with_ab,
                )
        elif len(args) == 1:
            # push(s, y, Bs): damped forward form (reference src/lbfgs.jl:289-299)
            if not self._damped:
                raise ValueError("push(s, y, Bs) requires a damped operator")
            if self._inverse:
                raise ValueError("push(s, y, Bs) is for forward operators; use push(s, y, alpha, g)")
            self.state = _push_damped_forward(
                self.state, s, y, dt.type(self._sigma2), dt.type(self._sigma3),
                scaling=self._scaling, with_ab=with_ab,
            )
        elif len(args) in (2, 3):
            # push(s, y, alpha, g[, Bs]): damped inverse (reference src/lbfgs.jl:323-367)
            if not self._damped:
                raise ValueError("push(s, y, alpha, g) requires a damped operator")
            if not self._inverse:
                raise ValueError("push(s, y, alpha, g) is for inverse operators; use push(s, y, Bs)")
            alpha = jnp.asarray(args[0], dt)
            g = jnp.asarray(args[1], dt)
            self.state = _push_damped_inverse(
                self.state, s, y, alpha, g, dt.type(self._sigma2), dt.type(self._sigma3),
                scaling=self._scaling,
            )
        else:
            raise TypeError("push(s, y[, Bs] | [, alpha, g[, Bs]])")
        # the state assignment invalidated _ab_fresh; an eager (or inverse)
        # push maintains the a/b form in-line, so re-mark it fresh
        if not self._lazy_ab:
            object.__setattr__(self, "_ab_fresh", True)
        return self

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if name == "state":
            # ANY state swap (push, checkpoint restore, user assignment)
            # invalidates the deferred a-vectors; internal paths re-mark
            # freshness AFTER assigning.
            object.__setattr__(self, "_ab_fresh", False)

    def _materialized_state(self) -> LBFGSState:
        """State with the a-vectors guaranteed fresh. Host calls cache the
        recompute on the operator; under an outer jit trace (where the
        recompute yields tracers) the result is returned WITHOUT caching —
        storing tracers on the persistent host object would corrupt it.

        The freshness flag is honored for EAGER operators too: an external
        ``op.state = ...`` swap (e.g. a state produced by a lazy operator)
        clears it, so consumers recompute instead of trusting foreign
        a-vectors."""
        if self._inverse or getattr(self, "_ab_fresh", False):
            return self.state
        new = _recompute_all_a_jit(self.state)
        if not any(
            isinstance(x, jax.core.Tracer) for x in jax.tree_util.tree_leaves(new)
        ):
            self.state = new
            object.__setattr__(self, "_ab_fresh", True)
        return new

    def ensure_ab(self) -> "LBFGSOperator":
        """Materialize the forward a/b vectors if a lazy push deferred them
        (no-op for eager/inverse operators). Needed before reading
        ``state.A`` directly (diag, EJM shifted solves, a-b-form oracles);
        the compact-form hot applies never require it."""
        self._materialized_state()
        return self

    def _before_save(self):
        """Checkpoint hook: persist fresh a-vectors so a restored state is
        correct regardless of the restoring operator's laziness mode."""
        self.ensure_ab()

    def diag(self):
        """Diagonal of a forward L-BFGS approximation (reference
        src/lbfgs.jl:369-395)."""
        if self._inverse:
            raise LinearOperatorException(
                "only the diagonal of a forward L-BFGS approximation is available"
            )
        return forward_diag(self._materialized_state())

    def reset(self):
        """Zero the memory and counters (reference reset!, src/lbfgs.jl:397-427)."""
        self.state = _init_state(self._n, self._mem, self.dtype, self._inverse)
        object.__setattr__(self, "_ab_fresh", True)
        self.reset_counters()
        return self

    def _name(self):
        return ("Inverse " if self._inverse else "") + "LBFGS operator"


register_operator(LBFGSOperator)


class InverseLBFGSOperator(LBFGSOperator):
    """Inverse-form limited-memory BFGS (two-loop recursion; reference
    src/lbfgs.jl:106-160)."""

    _is_inverse_ctor = True


register_operator(InverseLBFGSOperator)
