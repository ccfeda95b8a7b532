"""LOBPCG block eigensolver for hermitian operators.

Capability upgrade beyond the reference (LinearOperators.jl delegates
eigenvalue work to Arpack/KrylovKit clients). LOBPCG (Knyazev 2001) is
a natural fit for an accelerator: the entire iteration is block
operations — one
fresh ``(n, 3k)`` operator apply per iteration (recomputing the image
keeps f32 stable: deriving it through the basis transforms was measured
to diverge — see ``_lobpcg_jit``), a tiny ``(3k, 3k)`` Rayleigh–Ritz
eigenproblem, and dense matmul basis updates — compiled into a
single ``lax.while_loop`` with static shapes.

Robustness inside jit comes from BLOCKWISE orthonormalization: ``X`` is
kept orthonormal by construction, ``W`` and ``P`` are orthogonalized
against the earlier blocks (two Gram–Schmidt passes) and then SVQB'd
(Stathopoulos & Wu 2002) individually. Block identity must be preserved
— a joint whitening of ``[X, W, P]`` mixes the blocks, which breaks the
implicit-P extraction (zeroing the X rows of the Ritz coordinates) and
degrades the method to steepest descent (measured 2000 vs 158 iterations
on a spectrum-1..100 test). Rank-deficient directions (e.g. the zero
``P`` block on the first iteration) are zeroed and PENALIZED past the
Gershgorin edge in the Rayleigh–Ritz selection so they are never picked
— no dynamic basis shrinking, no recompiles.

"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.base import (
    LinearOperator,
    LinearOperatorException,
    register_operator,
)
from ..core.precision import pmatmul
from .estimate import _probe_dtype
from .rng import fresh_key

__all__ = ["lobpcg", "svds", "rsvd", "nystrom_preconditioner",
           "NystromPreconditioner"]


def _svqb_transform(S):
    """The SVQB orthonormalizing transform for the columns of ``S``
    (n, m): returns ``(T, clipped)`` with ``S @ T`` orthonormal — callers
    tracking an image ``A S`` update it as ``(A S) @ T`` without
    re-applying the operator (stacked ``[S; A S]`` arrays apply ``T``
    once).

    ``clipped[j]`` marks directions with negligible Gram weight — their
    columns of ``S @ T`` are ~zero and must be masked out of
    Rayleigh–Ritz selection by the caller (SVQB with soft dropping)."""
    return _svqb_transform_g(pmatmul(jnp.conj(S).T, S))


def _svqb_transform_g(G):
    """:func:`_svqb_transform` from a precomputed column Gram matrix."""
    m = G.shape[0]
    rdt = jnp.real(G).dtype
    eps = jnp.finfo(rdt).eps
    # floors must stay in NORMAL float range: XLA flushes subnormals to
    # zero, and a flushed-to-zero threshold lets 1/sqrt(0) through as inf
    tiny = jnp.asarray(jnp.finfo(rdt).tiny * 100, rdt)
    d = jnp.real(jnp.diag(G))
    dmax = jnp.max(d)
    # scale-INVARIANT column keep: small-norm residual columns are exactly
    # the refinement directions near convergence; only hard zeros drop here
    # (dependence is judged on the normalized Gram spectrum below)
    keep = d > jnp.maximum(dmax * jnp.asarray(1e-28, rdt), tiny)
    Dinv = jnp.where(keep, 1.0 / jnp.sqrt(jnp.where(keep, d, 1.0)), 0.0)
    Gn = Dinv[:, None] * G * Dinv[None, :]
    w, V = jnp.linalg.eigh(Gn)
    clipped = w < jnp.maximum(jnp.max(w) * (m * 10) * eps, tiny)
    winv = jnp.where(clipped, 0.0, 1.0 / jnp.sqrt(jnp.where(clipped, 1.0, w)))
    T = ((Dinv[:, None] * V) * winv[None, :]).astype(G.dtype)
    return T, clipped


def _svqb(S):
    """Orthonormalize the columns of ``S``; returns ``(Q, T, clipped)``
    with ``Q = S @ T`` (see :func:`_svqb_transform`)."""
    T, clipped = _svqb_transform(S)
    return pmatmul(S, T), T, clipped


def _svqb_t(St):
    """Transposed-panel SVQB: orthonormalize the ROWS of ``St`` (k, n).
    Returns ``(Qt, clipped)`` with ``Qt = Tᵀ St``."""
    T, clipped = _svqb_transform_g(pmatmul(jnp.conj(St), St.T))
    return pmatmul(T.T, St), clipped


@functools.partial(jax.jit, static_argnames=("k", "maxiter", "largest",
                                             "has_M", "has_Y", "k_conv"))
def _lobpcg_gram_jit(op, Mop, X0, Yc, tol, k, maxiter, largest, has_M,
                     has_Y, k_conv=None):
    """LOBPCG iteration with SMALL-SPACE basis maintenance.

    The ``direct`` body orthonormalizes the [X | W | P] blocks with
    big-array Gram-Schmidt + SVQB passes. Here the SAME blockwise
    orthonormalization
    (2-pass GS against earlier blocks, then SVQB, block identity
    preserved) runs in COEFFICIENT space on one fresh (6k, 6k) joint
    Gram of B = [S_raw; A·S_raw]: per iteration the big-array work is
    ONE fresh operator image, ONE joint-Gram matmul, and ONE fused
    update matmul — everything else is (6k)² arithmetic.

    Stability: the operator image is still recomputed FRESH from the raw
    basis (never derived through transforms — the measured f32 blow-up
    mode, see `_lobpcg_jit`), and the joint Gram is measured fresh from
    the MATERIALIZED raw basis each iteration, so coefficient-space
    orthonormalization errors do not compound across iterations: they
    are corrected by the next iteration's Gram. Precedent for Gram-based
    (CholeskyQR/SVQB-style) basis handling: Duersch, Shao, Yang & Gu,
    "A robust and efficient implementation of LOBPCG" (2018).
    """
    rdt = jnp.real(X0).dtype

    def rr_from_H(H, clipped):
        H = 0.5 * (H + jnp.conj(H).T)
        big = 2.0 * jnp.max(jnp.sum(jnp.abs(H), axis=1)) + 1.0
        sign = -1.0 if largest else 1.0
        H = H + jnp.diag(jnp.where(clipped, sign * big, 0.0)).astype(H.dtype)
        w, C = jnp.linalg.eigh(H)
        if largest:
            idx = jnp.arange(w.shape[0] - 1, w.shape[0] - 1 - k, -1)
        else:
            idx = jnp.arange(k)
        return jnp.real(w)[idx], C[:, idx]

    def gs_t(Yt, Zt, passes=2):
        for _ in range(passes):
            Yt = Yt - pmatmul(pmatmul(Yt, jnp.conj(Zt).T), Zt)
        return Yt

    Yct = Yc.T if has_Y else None

    def deflate(Bt):
        return gs_t(Bt, Yct) if has_Y else Bt

    # initial RR identical to the direct body
    Xt, clip0 = _svqb_t(deflate(X0.T))
    AXt = op.apply_matrix_t(Xt, "N")
    theta, C = rr_from_H(pmatmul(jnp.conj(Xt), AXt.T), clip0)
    Xt = pmatmul(C.T, Xt)
    AXt = pmatmul(C.T, AXt)
    Pt = jnp.zeros_like(Xt)

    inf = jnp.full((k,), jnp.inf, rdt)
    kc = k if k_conv is None else k_conv
    eyek = jnp.eye(k, dtype=X0.dtype)
    zk = jnp.zeros((k, k), X0.dtype)

    def small_gs(E, G, Zc, passes=2):
        # coefficient-space GS: rows of (E @ S_raw) against rows of
        # (Zc @ S_raw), using the measured standard Gram G of S_raw
        # (G[i,j] = <s_i, s_j>, conjugate-linear in the first argument);
        # mirrors gs_t: y' = y − Σ (y·conj(z)) z  ⇒  coefficient form
        # E' = E − (E Ḡ Zᴴ) Z with Ḡ = conj(G)
        Gb = jnp.conj(G)
        for _ in range(passes):
            E = E - pmatmul(pmatmul(pmatmul(E, Gb), jnp.conj(Zc).T), Zc)
        return E

    def cond(carry):
        Xt, AXt, Pt, theta, res, it = carry
        return jnp.logical_and(
            it < maxiter,
            jnp.max(res[:kc] / jnp.maximum(jnp.abs(theta[:kc]), 1.0)) > tol,
        )

    def body(carry):
        Xt, AXt, Pt, theta, _, it = carry
        Rt = AXt - theta[:, None].astype(Xt.dtype) * Xt
        Wt = Mop.apply_matrix_t(Rt, "N") if has_M else Rt
        Wt = deflate(Wt)
        St = jnp.concatenate([Xt, Wt, Pt], axis=0)  # RAW basis (3k, n)
        ASt = op.apply_matrix_t(St, "N")  # fresh image: see docstring
        B = jnp.concatenate([St, ASt], axis=0)  # (6k, n)
        # ONE joint Gram, standard convention (conjugate-linear first
        # argument, matching the direct body's H = conj(St) @ ASt.T)
        G6 = pmatmul(jnp.conj(B), B.T)
        G = G6[: 3 * k, : 3 * k]
        H = G6[: 3 * k, 3 * k:]

        # blockwise orthonormalization in coefficient space (same
        # structure as the direct body: X svqb'd, W GS'd against X then
        # svqb'd, P GS'd against [X W] then svqb'd). Row-panel SVQB
        # works on the COLUMN Gram <w_i, w_j> = conj(E1) G E1ᵀ.
        Ex0 = jnp.concatenate([eyek, zk, zk], axis=1)
        Tx, cX = _svqb_transform_g(G[:k, :k])
        Ex = pmatmul(Tx.T, Ex0)
        Ew0 = jnp.concatenate([zk, eyek, zk], axis=1)
        Ew1 = small_gs(Ew0, G, Ex)
        Tw, cW = _svqb_transform_g(pmatmul(pmatmul(jnp.conj(Ew1), G), Ew1.T))
        Ew = pmatmul(Tw.T, Ew1)
        Exw = jnp.concatenate([Ex, Ew], axis=0)
        Ep0 = jnp.concatenate([zk, zk, eyek], axis=1)
        Ep1 = small_gs(Ep0, G, Exw)
        Tp, cP = _svqb_transform_g(pmatmul(pmatmul(jnp.conj(Ep1), G), Ep1.T))
        Ep = pmatmul(Tp.T, Ep1)
        E = jnp.concatenate([Ex, Ew, Ep], axis=0)  # (3k, 3k)
        clipped = jnp.concatenate([cX, cW, cP])

        # projected matrix Hh[i,j] = <ê_i S, A ê_j S> = conj(E) H Eᵀ
        Hh = pmatmul(pmatmul(jnp.conj(E), H), E.T)
        theta_new, C = rr_from_H(Hh, clipped)
        CE = pmatmul(C.T, E)  # (k, 3k): Xn rows in raw coords
        CpE = pmatmul(C.at[:k, :].set(0).T, E)  # implicit-P rows

        # ONE fused update matmul: [Xn; Pn; AXn] = M_small @ [St; ASt]
        z3 = jnp.zeros_like(CE)
        M_small = jnp.concatenate([
            jnp.concatenate([CE, z3], axis=1),
            jnp.concatenate([CpE, z3], axis=1),
            jnp.concatenate([z3, CE], axis=1),
        ], axis=0)  # (3k, 6k)
        OUT = pmatmul(M_small, B)
        Xn, Pn, AXn = OUT[:k], OUT[k: 2 * k], OUT[2 * k:]
        # residuals from the MATERIALIZED Ritz pieces (one cheap
        # elementwise pass) — the small-space Gram formula cancels
        # catastrophically in f32 once r ≲ sqrt(eps)·θ and reports 0
        Rn = AXn - theta_new[:, None].astype(Xn.dtype) * Xn
        res = jnp.linalg.norm(Rn, axis=1)
        return (Xn, AXn, Pn, theta_new, res.astype(rdt), it + 1)

    Xt, AXt, Pt, theta, res, it = jax.lax.while_loop(
        cond, body, (Xt, AXt, Pt, theta, inf, jnp.zeros((), jnp.int32))
    )
    return theta, Xt.T, res, it


@functools.partial(jax.jit, static_argnames=("k", "maxiter", "largest", "has_M", "has_Y", "k_conv"))
def _lobpcg_jit(op, Mop, X0, Yc, tol, k, maxiter, largest, has_M, has_Y,
                k_conv=None):
    # The operator image A S is recomputed FRESH from the orthonormalized
    # (n, 3k) basis every iteration. Carrying A-images across iterations
    # and deriving them through the basis transforms was measured and
    # REJECTED: SVQB's 1/sqrt(w) rescaling amplifies the image drift
    # exponentially in f32 (NaN blow-up at iters 331-1071 on a 48² shifted
    # Laplacian) and under-reports residuals 10x even before blow-up —
    # while saving only the 3k-vs-k apply width.
    #
    # All panels are carried TRANSPOSED as (k, n) row panels. Operator
    # applies go through ``apply_matrix_t`` (native row-panel forms where
    # available, transpose-wrapped otherwise).
    n = X0.shape[0]
    rdt = jnp.real(X0).dtype

    def rr_from_H(H, clipped):
        """Rayleigh–Ritz selection given the projected matrix ``H``."""
        H = 0.5 * (H + jnp.conj(H).T)
        # push clipped directions just past the Gershgorin edge so the
        # k-selection below never picks them — a huge (1e6-scale) penalty
        # would inflate ||H|| and with it eigh's backward error
        big = 2.0 * jnp.max(jnp.sum(jnp.abs(H), axis=1)) + 1.0
        sign = -1.0 if largest else 1.0
        H = H + jnp.diag(jnp.where(clipped, sign * big, 0.0)).astype(H.dtype)
        w, C = jnp.linalg.eigh(H)
        if largest:
            idx = jnp.arange(w.shape[0] - 1, w.shape[0] - 1 - k, -1)
        else:
            idx = jnp.arange(k)
        return jnp.real(w)[idx], C[:, idx]

    def gs_t(Yt, Zt, passes=2):
        # Gram–Schmidt against row-orthonormal Zt ("twice is enough"):
        # Yt -= (Yt · conj(Zt)ᵀ) · Zt, all in dense (rows, n) layout
        for _ in range(passes):
            Yt = Yt - pmatmul(pmatmul(Yt, jnp.conj(Zt).T), Zt)
        return Yt

    Yct = Yc.T if has_Y else None

    def deflate(Bt):
        # constraint block: keep the search orthogonal to span(Yc) — the
        # new directions (W, and the start block) are projected out every
        # iteration; X/P inherit the property through the Ritz updates
        return gs_t(Bt, Yct) if has_Y else Bt

    # initial Rayleigh–Ritz on the orthonormalized start block (the host
    # wrapper rejects rank-deficient explicit X0, so clip0 only guards the
    # measure-zero random-start collision)
    Xt, clip0 = _svqb_t(deflate(X0.T))
    AXt = op.apply_matrix_t(Xt, "N")
    theta, C = rr_from_H(pmatmul(jnp.conj(Xt), AXt.T), clip0)
    Xt = pmatmul(C.T, Xt)
    AXt = pmatmul(C.T, AXt)
    Pt = jnp.zeros_like(Xt)

    inf = jnp.full((k,), jnp.inf, rdt)

    kc = k if k_conv is None else k_conv  # converge on the REQUESTED
    # pairs only: a padded internal block (block_size > k) must not wait
    # for its discarded extras

    def cond(carry):
        Xt, AXt, Pt, theta, res, it = carry
        return jnp.logical_and(
            it < maxiter,
            jnp.max(res[:kc] / jnp.maximum(jnp.abs(theta[:kc]), 1.0)) > tol,
        )

    def body(carry):
        Xt, AXt, Pt, theta, _, it = carry
        Rt = AXt - theta[:, None].astype(Xt.dtype) * Xt
        res = jnp.linalg.norm(Rt, axis=1)
        Wt = Mop.apply_matrix_t(Rt, "N") if has_M else Rt
        # blockwise orthonormal basis [X | W | P]: block identity is what
        # makes the implicit-P row-zeroing below meaningful
        Wt = gs_t(deflate(Wt), Xt)
        Wt, cW = _svqb_t(Wt)
        # X and W are now mutually orthonormal, so projecting P against
        # the joint [X | W] block equals the sequential projections but
        # runs as ONE wider matmul pair per pass
        XWt = jnp.concatenate([Xt, Wt], axis=0)  # (2k, n)
        Pbt = gs_t(Pt, XWt)
        Pbt, cP = _svqb_t(Pbt)
        St = jnp.concatenate([XWt, Pbt], axis=0)  # (3k, n)
        clipped = jnp.concatenate([jnp.zeros((k,), bool), cW, cP])
        ASt = op.apply_matrix_t(St, "N")  # fresh image: see module note
        H = pmatmul(jnp.conj(St), ASt.T)
        theta_new, C = rr_from_H(H, clipped)
        # implicit P: the W+P contribution to the new X (zero the X rows)
        Cp = C.at[:k, :].set(0)
        OUT = pmatmul(jnp.concatenate([C, Cp], axis=1).T, St)  # (2k, n)
        Xn, Pn = OUT[:k], OUT[k:]
        AXn = pmatmul(C.T, ASt)
        Rn = AXn - theta_new[:, None].astype(Xn.dtype) * Xn
        return (Xn, AXn, Pn, theta_new, jnp.linalg.norm(Rn, axis=1), it + 1)

    Xt, AXt, Pt, theta, res, it = jax.lax.while_loop(
        cond, body, (Xt, AXt, Pt, theta, inf, jnp.zeros((), jnp.int32))
    )
    return theta, Xt.T, res, it


def lobpcg(op, k: int = 1, X0=None, *, largest: bool = False, tol: float = 1e-6,
           maxiter: int = 200, M=None, Y=None, key=None, block_size=None,
           basis: str = "gram"):
    """Extremal eigenpairs of a hermitian operator by LOBPCG.

    ``block_size`` (int ≥ k) runs the iteration on a WIDER internal block
    and discards the extra Ritz pairs (convergence is tested on the
    requested ``k`` only). The per-ITERATION cost grows with the width, so
    padding pays only when the wider block also cuts the iteration count
    (clustered spectra) or the extra pairs are wanted anyway — hence the
    default is None (no padding) and there is deliberately no "auto".

    Returns ``(theta, X, resnorms, iters)``: ``k`` eigenvalues (smallest
    by default, ``largest=True`` for the other end), the ``(n, k)``
    eigenvector block, final residual norms ``|A x - theta x|``, and the
    iteration count. Converged when every ``resnorm <= tol * max(|theta|,
    1)``. ``M`` is an (operator) preconditioner approximating ``A^{-1}``
    — e.g. ``opDiagonal(1/diag)`` or an :class:`InverseLBFGSOperator`.
    ``X0`` seeds the block (``(n, k)``); by default it is drawn from OS
    entropy (pass ``key`` to pin determinism).

    ``Y`` (``(n, j)``) constrains the search to the orthogonal complement
    of its span — pass already-converged eigenvectors to compute the NEXT
    ``k`` eigenpairs incrementally, or a known nullspace (e.g. the
    constant vector of a Neumann Laplacian) to exclude it.

    ``basis`` selects the basis-maintenance strategy: ``"gram"``
    (default) runs the blockwise orthonormalization in COEFFICIENT space
    on one fresh joint Gram per iteration (the big-array work drops to
    one operator image + two matmuls). ``"direct"`` runs big-array
    Gram-Schmidt/SVQB passes — keep it when
    the basis is so ill-conditioned that coefficient-space
    orthonormalization (squared-condition Gram) loses too much in f32.
    Both recompute the operator image fresh each iteration.

    The operator must be hermitian (flag-checked); results on a
    non-hermitian operator are meaningless.
    """
    if basis not in ("gram", "direct"):
        raise ValueError(f"unknown basis {basis!r} (use 'gram' or 'direct')")
    if not isinstance(op, LinearOperator):
        from ..core.dense import aslinearoperator

        op = aslinearoperator(op)
    m, n = op.shape
    if m != n:
        raise LinearOperatorException(f"lobpcg requires a square operator, got {(m, n)}")
    if not op.hermitian:
        raise LinearOperatorException(
            "lobpcg requires a hermitian operator (set hermitian=True if the "
            "operator is known hermitian)"
        )
    if not 1 <= 3 * k <= n:
        raise ValueError(f"k={k} out of range for n={n} (the [X|W|P] basis needs 3k <= n)")
    if M is not None:
        if not isinstance(M, LinearOperator):
            from ..core.dense import aslinearoperator

            M = aslinearoperator(M)
        if M.shape != (n, n):
            raise LinearOperatorException(
                f"preconditioner must have shape {(n, n)}, got {M.shape}"
            )

    k_int = k
    if block_size is not None:
        k_int = int(block_size)
        if k_int < k:
            raise ValueError(f"block_size={k_int} must be >= k={k}")
        if 3 * k_int > n:
            raise ValueError(
                f"block_size={k_int} out of range for n={n} (needs 3*block_size <= n)")

    dt = _probe_dtype(op)
    if X0 is None:
        if key is None:
            key = fresh_key()
        X0 = jax.random.normal(key, (n, k)).astype(dt)
    else:
        X0 = jnp.asarray(X0, dt)
        if X0.shape != (n, k):
            raise LinearOperatorException(f"X0 must have shape {(n, k)}, got {X0.shape}")
        # a rank-deficient start block would seed X with a zero direction
        # the loop can report as a spurious converged eigenpair; reject it
        # here while X0 is still concrete (k-by-k Gram spectrum: O(n k^2),
        # far cheaper than an SVD for warm-start callers)
        # Gram eigenvalues are squared singular values: an eps-relative
        # threshold on the Gram ratio detects sigma ratios down to
        # ~sqrt(eps), and exact/near duplicates land at eigvalsh's own
        # noise floor well below it
        # the noise floor of the Gram eigenvalues is set by the k-dim
        # eigensolve plus the sqrt(n)-term contraction rounding — a
        # threshold LINEAR in n exceeds 1.0 for f32 at n ~ 84k and would
        # reject every warm start
        gev = jnp.linalg.eigvalsh(pmatmul(jnp.conj(X0).T, X0))
        thresh = (100 * k + 10 * n ** 0.5) * jnp.finfo(jnp.real(X0).dtype).eps
        if float(gev[0]) <= float(gev[-1]) * thresh:
            raise LinearOperatorException(
                "X0 is numerically rank-deficient; provide k linearly "
                "independent start vectors (or pass X0=None for a random block)"
            )

    if Y is not None:
        Y = jnp.asarray(Y, dt)
        if Y.ndim == 1:
            Y = Y[:, None]
        if Y.ndim != 2 or Y.shape[0] != n:
            raise LinearOperatorException(
                f"Y must have shape (n, j) = ({n}, j), got {Y.shape}"
            )
        if 3 * k + Y.shape[1] > n:
            raise ValueError(
                f"constraint block too wide: 3k + j = {3 * k + Y.shape[1]} > n = {n}"
            )
        Yq, _, clipY = _svqb(Y)
        if bool(jnp.any(clipY)):
            raise LinearOperatorException(
                "constraint block Y is numerically rank-deficient"
            )
        Y = Yq

    if k_int > k:  # pad the internal block with random extra columns
        pad_key = fresh_key() if key is None else jax.random.fold_in(key, 1)
        X0 = jnp.concatenate(
            [X0, jax.random.normal(pad_key, (n, k_int - k)).astype(dt)],
            axis=1)

    rdt = jnp.finfo(dt).dtype if not jnp.issubdtype(dt, jnp.complexfloating) else jnp.real(jnp.zeros((), dt)).dtype
    Mop = M if M is not None else op  # unused when has_M=False (static)
    Yc = Y if Y is not None else X0  # unused when has_Y=False (static)
    impl = _lobpcg_gram_jit if basis == "gram" else _lobpcg_jit
    theta, X, res, it = impl(
        op, Mop, X0, Yc, jnp.asarray(tol, rdt), k_int, maxiter, bool(largest),
        M is not None, Y is not None, k_conv=k,
    )
    return theta[:k], X[:, :k], res[:k], int(it)


# ---------------------------------------------------------------------------
# Singular triplets via LOBPCG on the Gram operator
# ---------------------------------------------------------------------------


class _GramOperator(LinearOperator):
    """``A^H A`` (side="right") or ``A A^H`` (side="left") as a first-class
    hermitian-PSD operator node. ``Compose`` deliberately drops flags
    (reference src/operations.jl:131-156), so ``op.H @ op`` would not be
    accepted by hermitian-gated consumers (lobpcg, SLQ) — this node
    carries the flag the structure guarantees."""

    _fields_children = ("base",)
    _fields_aux = ("side",)

    def __init__(self, base: LinearOperator, side: str = "right"):
        super().__init__()
        if side not in ("right", "left"):
            raise ValueError("side must be 'right' or 'left'")
        self.base = base
        self.side = side

    @property
    def nrow(self):
        return self.base.ncol if self.side == "right" else self.base.nrow

    ncol = nrow

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def hermitian(self):
        return True

    @property
    def symmetric(self):
        return not jnp.issubdtype(jnp.dtype(self.dtype), jnp.complexfloating)

    def _gram(self, v, batched: bool):
        ap = self.base.apply_matrix if batched else self.base.apply
        if self.side == "right":
            return ap(ap(v, "N"), "H")
        return ap(ap(v, "H"), "N")

    def apply(self, v, mode: str = "N"):
        if mode in ("N", "H"):
            return self._gram(v, False)
        return jnp.conj(self._gram(jnp.conj(v), False))  # T/C on hermitian

    def apply_matrix(self, M, mode: str = "N"):
        if mode in ("N", "H"):
            return self._gram(M, True)
        return jnp.conj(self._gram(jnp.conj(M), True))

    def _name(self):
        return f"Gram({self.side}) of"


register_operator(_GramOperator)


def svds(op, k: int = 1, *, largest: bool = True, tol: float = 1e-6,
         maxiter: int = 200, key=None):
    """Extremal singular triplets of a (possibly rectangular) operator.

    Returns ``(U, s, V, resnorms, iters)`` with ``op @ V ~= U * s`` and
    ``s`` sorted extremal-first. Runs :func:`lobpcg` on the smaller Gram
    operator (``A^H A`` or ``A A^H`` — the ARPACK ``svds`` strategy the
    reference's opnorm extension delegates to) and recovers the other
    factor by one block apply. ``resnorms`` are the Gram residuals mapped
    to singular-triplet scale (``|A^H u - s v|``). ``largest=False`` finds
    the smallest triplets — note the Gram squaring makes tiny singular
    values ill-conditioned; prefer a shifted solve for near-null-space
    work."""
    if not isinstance(op, LinearOperator):
        from ..core.dense import aslinearoperator

        op = aslinearoperator(op)
    m, n = op.shape
    side = "right" if n <= m else "left"
    gram = _GramOperator(op, side)
    theta, X, gres, it = lobpcg(gram, k=k, largest=largest, tol=tol,
                                maxiter=maxiter, key=key)
    s = jnp.sqrt(jnp.maximum(theta, 0.0))
    safe = jnp.maximum(s, jnp.finfo(s.dtype).tiny * 1e3).astype(X.dtype)
    if side == "right":
        V = X
        U = op.apply_matrix(V, "N") / safe[None, :]
    else:
        U = X
        V = op.apply_matrix(U, "H") / safe[None, :]
    res = gres / jnp.real(safe)
    return U, s, V, res, it


# ---------------------------------------------------------------------------
# Randomized range finding: low-rank SVD and the Nystrom preconditioner
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("power_iters",))
def _rsvd_jit(op, G, power_iters):
    Y = op.apply_matrix(G, "N")  # (m, l)
    # subspace iteration with QR re-orthonormalization between passes
    # (Halko-Martinsson-Tropp 2011, Alg 4.4): sharpens the sketch on
    # slowly decaying spectra
    for _ in range(power_iters):
        Q, _ = jnp.linalg.qr(Y)
        Z = op.apply_matrix(Q, "H")
        Qz, _ = jnp.linalg.qr(Z)
        Y = op.apply_matrix(Qz, "N")
    Q, _ = jnp.linalg.qr(Y)  # (m, l) orthonormal range basis
    B = op.apply_matrix(Q, "H")  # (n, l): B^H = Q^H A
    Us, s, Vh = jnp.linalg.svd(jnp.conj(B).T, full_matrices=False)
    U = pmatmul(Q, Us)
    V = jnp.conj(Vh).T
    return U, s, V


def rsvd(op, k: int, *, oversample: int = 10, power_iters: int = 2, key=None):
    """Randomized top-``k`` SVD (Halko, Martinsson & Tropp 2011).

    Returns ``(U, s, V)`` with ``op ~= U @ diag(s) @ V^H`` — the near-
    optimal rank-``k`` approximation for spectra with decay, from
    ``2*power_iters + 2`` block applies of width ``k + oversample``
    (everything else is tall QR/SVD — dense matrix work). One-shot and much
    cheaper than :func:`svds` when the goal is the leading SUBSPACE of a
    numerically low-rank operator rather than tight extremal triplets;
    exact (to roundoff) when the operator's rank is at most ``k``.
    ``power_iters`` sharpens slowly-decaying spectra (2 is the standard
    robust choice; 0 is fastest)."""
    if not isinstance(op, LinearOperator):
        from ..core.dense import aslinearoperator

        op = aslinearoperator(op)
    m, n = op.shape
    if not 1 <= k <= min(m, n):
        raise ValueError(f"k={k} out of range for shape {(m, n)}")
    if oversample < 0 or power_iters < 0:
        raise ValueError("oversample and power_iters must be >= 0")
    l = int(min(k + oversample, min(m, n)))
    dt = _probe_dtype(op)
    if key is None:
        key = fresh_key()
    G = jax.random.normal(key, (n, l)).astype(dt)
    U, s, V = _rsvd_jit(op, G, int(power_iters))
    return U[:, :k], s[:k], V[:, :k]


class NystromPreconditioner(LinearOperator):
    """The randomized Nystrom preconditioner for hermitian-PSD systems
    (Frangella, Tropp & Udell 2023): from a rank-``l`` sketch
    ``A ~= U diag(lam) U^H``,

        ``P^{-1} v = (lam_r + mu) * U ((lam + mu)^{-1}) U^H v + (v - U U^H v)``

    where ``lam_r`` is the smallest retained eigenvalue and ``mu`` the
    shift of the system being solved. Apply cost: two (n, l) matmuls.
    Pass it as ``M`` to :func:`linops_tpu.cg` when solving
    ``(A + mu I) x = b`` — effective when A's spectrum decays fast.
    Built by :func:`nystrom_preconditioner`."""

    _fields_children = ("U", "lam")
    _fields_aux = ("_mu",)

    def __init__(self, U, lam, mu: float = 0.0):
        super().__init__()
        self.U = U
        self.lam = lam
        self._mu = float(mu)

    @property
    def nrow(self):
        return self.U.shape[0]

    ncol = nrow

    @property
    def dtype(self):
        return self.U.dtype

    @property
    def hermitian(self):
        return True

    @property
    def symmetric(self):
        return not jnp.issubdtype(jnp.dtype(self.dtype), jnp.complexfloating)

    def _pinv_apply(self, v, batched: bool):
        lam = self.lam
        mu = jnp.asarray(self._mu, lam.dtype)
        # defensive floor: the constructor truncates to the numerical
        # rank, but a floored denominator keeps a hand-built operator
        # with lam -> 0 and mu == 0 finite instead of NaN
        den = jnp.maximum(lam + mu, jnp.finfo(lam.dtype).tiny * 100)
        scale = (lam[-1] + mu) / den  # lam sorted descending
        Uv = pmatmul(jnp.conj(self.U).T, v)
        if batched:
            core = pmatmul(self.U, scale[:, None].astype(v.dtype) * Uv)
        else:
            core = pmatmul(self.U, scale.astype(v.dtype) * Uv)
        return core + (v - pmatmul(self.U, Uv))

    def apply(self, v, mode: str = "N"):
        if mode in ("N", "H"):
            return self._pinv_apply(v, False)
        return jnp.conj(self._pinv_apply(jnp.conj(v), False))

    def apply_matrix(self, M, mode: str = "N"):
        if mode in ("N", "H"):
            return self._pinv_apply(M, True)
        return jnp.conj(self._pinv_apply(jnp.conj(M), True))

    def _name(self):
        return f"NystromPreconditioner(rank={self.lam.shape[0]}, mu={self._mu})"


register_operator(NystromPreconditioner)


@functools.partial(jax.jit, static_argnames=())
def _nystrom_sketch(op, Om):
    Y = op.apply_matrix(Om, "N")  # (n, l)
    # stability shift (FTU23 Alg 2.1): nu ~ sqrt(n) eps ||Y||
    rdt = jnp.real(Y).dtype
    nu = jnp.sqrt(jnp.asarray(Y.shape[0], rdt)) * jnp.finfo(rdt).eps * jnp.linalg.norm(Y)
    Ynu = Y + nu.astype(Y.dtype) * Om
    G = pmatmul(jnp.conj(Om).T, Ynu)
    G = 0.5 * (G + jnp.conj(G).T)
    C = jnp.linalg.cholesky(G)
    B = jax.scipy.linalg.solve_triangular(C, jnp.conj(Ynu).T, lower=True)
    Us, s, _ = jnp.linalg.svd(jnp.conj(B).T, full_matrices=False)
    lam = jnp.maximum(s * s - nu, 0.0)
    return Us, lam


def nystrom_preconditioner(op, rank: int, *, mu: float = 0.0,
                           oversample: int = 10, key=None):
    """Build a :class:`NystromPreconditioner` for a hermitian-PSD
    operator from one ``(n, rank + oversample)`` sketch apply plus a tall
    QR-sized factorization (Frangella, Tropp & Udell 2023).

    ``mu`` is the shift of the system the preconditioner will be used on
    (``(A + mu I) x = b``; ``mu=0`` for plain ``A x = b``). Returns an
    operator suitable as ``M`` in :func:`linops_tpu.cg` — effective when
    ``A``'s spectrum decays fast (the preconditioned condition number is
    roughly ``(lam_rank + mu)^{-1} (lam_1 ... )`` clipped at the sketch).
    A non-PSD operator surfaces as NaNs from the Cholesky of the sketch
    Gram."""
    if not isinstance(op, LinearOperator):
        from ..core.dense import aslinearoperator

        op = aslinearoperator(op)
    m, n = op.shape
    if m != n:
        raise LinearOperatorException(
            f"nystrom_preconditioner requires a square operator, got {(m, n)}"
        )
    if not op.hermitian:
        raise LinearOperatorException(
            "nystrom_preconditioner requires a hermitian (PSD) operator"
        )
    if not 1 <= rank <= n:
        raise ValueError(f"rank={rank} out of range for n={n}")
    if mu < 0:
        raise ValueError("mu must be >= 0")
    l = int(min(rank + oversample, n))
    dt = _probe_dtype(op)
    if key is None:
        key = fresh_key()
    Om = jax.random.normal(key, (n, l)).astype(dt)
    Us, lam = _nystrom_sketch(op, Om)
    # truncate to the sketch's NUMERICAL rank: requesting rank past it
    # would put exact zeros in the retained spectrum and (at mu == 0)
    # divide 0/0 in the apply
    lam_np = jnp.asarray(lam)
    eps = float(jnp.finfo(jnp.real(lam_np).dtype).eps)
    r_eff = int(jnp.sum(lam_np > float(lam_np[0]) * n * eps)) if float(lam_np[0]) > 0 else 0
    if r_eff == 0:
        raise LinearOperatorException(
            "nystrom_preconditioner: the sketch found numerical rank 0 "
            "(operator is ~zero or not PSD)"
        )
    rank = min(rank, r_eff)
    return NystromPreconditioner(Us[:, :rank], lam[:rank], mu)
