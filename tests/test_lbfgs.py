"""L-BFGS operator tests, mirroring the reference contract
(reference: test/test_lbfgs.jl)."""

import numpy as np
import jax.numpy as jnp
import pytest

from helpers import RTOL, simple_vector, assert_close

import linops_tpu as lo
from linops_tpu.qn import LBFGSOperator, InverseLBFGSOperator


def dense_bfgs(B, s, y, damped=False):
    """Dense BFGS update oracle (reference test/test_lbfgs.jl:78-88)."""
    ys = np.dot(y, s)
    Bs = B @ s
    tol = 0.2 * np.dot(s, Bs) if damped else 1.0e-20
    if ys > tol:
        B = B - np.outer(Bs, Bs) / np.dot(s, Bs) + np.outer(y, y) / ys
    return B


def test_lbfgs_identity_and_insert():
    n, mem = 10, 5
    B = LBFGSOperator(n, mem=mem, scaling=False)
    H = InverseLBFGSOperator(n, mem=mem, scaling=False)

    for _ in range(2):  # run again after reset (reference :14)
        assert np.linalg.norm(B.diag() - np.diag(B.to_dense())) <= RTOL
        assert B.insert == 0
        assert H.insert == 0
        assert np.linalg.norm(B.to_dense() - np.eye(n)) <= np.finfo(np.float64).eps
        assert np.linalg.norm(H.to_dense() - np.eye(n)) <= np.finfo(np.float64).eps

        # Nonpositive curvature can't be added (reference :22-33).
        s = simple_vector(np.float64, n)
        z = np.zeros(n)
        B.push(s, -s)
        assert B.insert == 0
        B.push(s, z)
        assert B.insert == 0
        H.push(s, -s)
        assert H.insert == 0
        H.push(s, z)
        assert H.insert == 0

        # Insert a few {s, y} pairs (reference :36-46).
        inserted = 0
        for i in range(1, mem + 3):
            s = np.ones(n) * i
            y = np.concatenate([[i], np.ones(n - 1)])
            if np.dot(s, y) > 1.0e-20:
                inserted += 1
                B.push(s, y)
                H.push(s, y)

        assert B.insert == inserted % mem
        assert H.insert == inserted % mem

        assert lo.check_positive_definite(B)
        assert lo.check_positive_definite(H)
        assert lo.check_hermitian(B)
        assert lo.check_hermitian(H)

        assert np.linalg.norm(B.diag() - np.diag(B.to_dense())) <= RTOL

        # H * B ≈ I (reference :56)
        HB = (H * B).to_dense()
        assert np.linalg.norm(HB - np.eye(n)) <= RTOL

        # reset (reference :58-67)
        v = simple_vector(np.float64, n)
        assert np.linalg.norm(B * v - v) > RTOL
        assert np.linalg.norm(H * v - v) > RTOL
        B.reset()
        H.reset()
        assert B.scaling_factor == 1.0
        assert H.scaling_factor == 1.0
        assert np.linalg.norm(B * v - v) < RTOL
        assert np.linalg.norm(H * v - v) < RTOL

        # opnorm upper bound (reference :69-70)
        assert np.linalg.norm(B.to_dense(), 2) <= B.opnorm_upper_bound + RTOL


def test_lbfgs_vs_dense_bfgs(rng):
    """Full-memory L-BFGS tracks the dense BFGS recursion
    (reference test/test_lbfgs.jl:73-99)."""
    n = 10
    mem = n
    LB = LBFGSOperator(n, mem=mem, scaling=False)
    B = np.eye(n)

    assert np.linalg.norm(LB.to_dense() - B) < RTOL * np.linalg.norm(B)

    for _ in range(mem):
        s = rng.standard_normal(n)
        y = rng.standard_normal(n)
        if np.dot(s, y) <= 1e-20:
            continue
        B = dense_bfgs(B, s, y)
        LB.push(s, y)
        assert np.linalg.norm(LB.to_dense() - B) < RTOL * np.linalg.norm(B)
        assert np.linalg.norm(LB.diag() - np.diag(B)) < RTOL * np.linalg.norm(np.diag(B))

    assert np.linalg.norm(B, 2) <= LB.opnorm_upper_bound + RTOL


def test_inverse_lbfgs_vs_dense(rng):
    """Inverse L-BFGS (two-loop) equals inverse of dense BFGS matrix."""
    n = 8
    H = InverseLBFGSOperator(n, mem=n, scaling=False)
    B = np.eye(n)
    for _ in range(n):
        s = rng.standard_normal(n)
        y = rng.standard_normal(n)
        if np.dot(s, y) <= 1e-20:
            continue
        B = dense_bfgs(B, s, y)
        H.push(s, y)
    assert_close(H.to_dense(), np.linalg.inv(B), rtol=1e-8)


def test_lbfgs_damped(rng):
    """Damped forward/inverse L-BFGS (reference test/test_lbfgs.jl:102-136)."""
    n = 10
    mem = n
    B = LBFGSOperator(n, mem=mem, damped=True, scaling=False, sigma2=0.8, sigma3=np.inf)
    H = InverseLBFGSOperator(n, mem=mem, damped=True, scaling=False, sigma2=0.8, sigma3=np.inf)

    ins_B = ins_H = 0
    for i in range(1, mem + 3):
        s = simple_vector(np.float64, n)
        y = rng.standard_normal(n)
        ys = np.dot(y, s)
        g = rng.standard_normal(n)
        d = -(H * g)
        alpha = i / mem
        s = alpha * d
        if ys > 0.2 * np.dot(s, B * s):
            ins_B += 1
            ins_H += 1
            B.push(s, np.asarray(y))
            H.push(s, np.asarray(y), alpha, g)

    assert B.insert == ins_B % mem
    assert H.insert == ins_H % mem

    assert lo.check_positive_definite(B)
    assert lo.check_hermitian(B)
    assert lo.check_hermitian(H)
    assert np.linalg.norm(B.diag() - np.diag(B.to_dense())) <= RTOL
    assert np.linalg.norm(np.asarray((H * B).to_dense()) - np.eye(n)) <= 1e3 * RTOL
    assert np.linalg.norm(B.to_dense(), 2) <= B.opnorm_upper_bound + RTOL


def dense_powell_damped_bfgs(B, s, y, sigma2=0.99, sigma3=10.0):
    """Dense oracle for the reference's Powell-damped push: blend y toward
    Bs outside the [(1-σ₂)sBs, (1+σ₃)sBs] curvature window, then always
    apply the plain BFGS update (reference src/lbfgs.jl:304-318)."""
    Bs = B @ s
    sBs = np.dot(s, Bs)
    ys = np.dot(y, s)
    if ys < (1 - sigma2) * sBs:
        theta = sigma2 * sBs / (sBs - ys)
    elif ys > (1 + sigma3) * sBs:
        theta = sigma3 * sBs / (ys - sBs)
    else:
        theta = 1.0
    y = theta * y + (1 - theta) * Bs
    ys = np.dot(y, s)
    return B - np.outer(Bs, Bs) / sBs + np.outer(y, y) / ys


def test_lbfgs_damped_vs_dense():
    """Damped L-BFGS vs dense damped-BFGS oracle, compared per push
    (reference test/test_lbfgs.jl:141-155; there s = y = simple_vector, so
    the Powell window never trips and the oracle is the plain update)."""
    n = 10
    LB = LBFGSOperator(n, mem=n, damped=True, scaling=False)
    B = np.eye(n)
    assert_close(LB.to_dense(), B, rtol=RTOL)
    for _ in range(n):
        s = simple_vector(np.float64, n)
        y = simple_vector(np.float64, n)
        B = dense_bfgs(B, s, y, damped=True)
        LB.push(s, y)
        assert_close(LB.to_dense(), B, rtol=RTOL)
        assert_close(LB.diag(), np.diag(B), rtol=RTOL)
    assert np.linalg.norm(B, 2) <= LB.opnorm_upper_bound + RTOL


def test_lbfgs_damped_powell_blend_vs_dense(rng):
    """Pairs engineered to trip Powell's damping (ys outside the curvature
    window) — the damped push must match the dense blend-then-update oracle
    exactly (reference src/lbfgs.jl:304-318)."""
    n, mem = 8, 8
    LB = LBFGSOperator(n, mem=mem, damped=True, scaling=False)
    B = np.eye(n)
    for i in range(mem):
        s = rng.standard_normal(n)
        if i % 2 == 0:
            # ys < (1-σ₂)·sBs: near-zero/negative curvature -> lower blend
            y = -0.3 * s + 1e-3 * rng.standard_normal(n)
        else:
            # ys > (1+σ₃)·sBs: inflated curvature -> upper blend
            y = 50.0 * (B @ s) + rng.standard_normal(n)
        B = dense_powell_damped_bfgs(B, s, y)
        LB.push(s, y)
        assert_close(LB.to_dense(), B, rtol=1e4 * RTOL)
    assert lo.check_positive_definite(LB)


def test_lbfgs_scaling(rng):
    """With scaling, B₀ = I/γ with γ = ys/y'y (reference src/lbfgs.jl:223-227)."""
    n = 6
    B = LBFGSOperator(n, mem=n, scaling=True)
    H = InverseLBFGSOperator(n, mem=n, scaling=True)
    s = rng.standard_normal(n)
    y = rng.standard_normal(n)
    if np.dot(s, y) < 0:
        y = -y
    B.push(s, y)
    H.push(s, y)
    gamma = np.dot(y, s) / np.dot(y, y)
    assert abs(B.scaling_factor - gamma) < 1e-12
    # dense oracle with scaled B0
    Bd = dense_bfgs(np.eye(n) / gamma, s, y)
    assert_close(B.to_dense(), Bd, rtol=1e-10)
    assert_close(np.asarray(H.to_dense()), np.linalg.inv(Bd), rtol=1e-8)


def test_lbfgs_dtypes():
    """Different precisions (reference test/test_lbfgs.jl:162-179)."""
    n, mem = 10, 5
    for dt in (jnp.float32, jnp.float64):
        B = LBFGSOperator(dt, n, mem=mem)
        H = InverseLBFGSOperator(dt, n, mem=mem)
        s = np.ones(n)
        y = np.ones(n)
        B.push(s, y)
        H.push(s, y)
        assert B.dtype == jnp.dtype(dt)
        assert H.dtype == jnp.dtype(dt)
        v = simple_vector(np.float64, n).astype(np.dtype(dt))
        assert (B * v).dtype == jnp.dtype(dt)
        assert (H * v).dtype == jnp.dtype(dt)


def test_lbfgs_push_errors():
    """Wrong push call forms raise (reference test/test_lbfgs.jl:221-241)."""
    n, mem = 12, 4
    B = LBFGSOperator(n, mem=mem)
    H = InverseLBFGSOperator(n, mem=mem)
    BD = LBFGSOperator(n, mem=mem, damped=True)
    HD = InverseLBFGSOperator(n, mem=mem, damped=True)
    s = np.ones(n)
    y = np.ones(n)
    g = np.ones(n)
    Bs = np.zeros(n)
    with pytest.raises(ValueError):
        B.push(s, y, Bs)
    with pytest.raises(ValueError):
        H.push(s, y, Bs)
    with pytest.raises(ValueError):
        HD.push(s, y, Bs)
    with pytest.raises(ValueError):
        B.push(s, y, 1.0, g)
    with pytest.raises(ValueError):
        BD.push(s, y, 1.0, g)
    with pytest.raises(ValueError):
        H.push(s, y, 1.0, g)
    with pytest.raises(ValueError):
        HD.push(s, y)  # damped inverse needs (s, y, alpha, g)


def test_lbfgs_positive_eigenvalues(rng):
    """All eigenvalues positive after updates (reference :244-259)."""
    n, mem = 30, 10
    B = LBFGSOperator(n, mem=mem)
    H = InverseLBFGSOperator(n, mem=mem)
    for _ in range(0, n, 2):
        s = rng.random(n)
        y = rng.random(n)
        B.push(s, y)
        H.push(s, y)
    lam_B = np.linalg.eigvalsh(np.asarray(B.to_dense()))
    lam_H = np.linalg.eigvalsh(np.asarray(H.to_dense()))
    assert lam_B.min() > 0
    assert lam_H.min() > 0


def test_lbfgs_no_recompile(rng):
    """Analogue of the reference zero-allocation contract
    (test/test_lbfgs.jl:180-218): pushes and applies after the first hit the
    jit cache — no recompilation."""
    n, mem = 50, 8
    B = LBFGSOperator(n, mem=mem)
    H = InverseLBFGSOperator(n, mem=mem)
    from linops_tpu.qn.lbfgs import _push_plain

    for i in range(6):
        s = rng.random(n)
        y = rng.random(n)
        B.push(s, y)
        H.push(s, y)
        if i == 0:
            misses = _push_plain._cache_size()
    assert _push_plain._cache_size() == misses  # 2 entries: fwd + inv

    x = rng.random(n)
    B.matvec(x)
    H.matvec(x)
    from linops_tpu.core.apply import apply_cache_sizes

    before = apply_cache_sizes()
    for _ in range(5):
        B.matvec(x)
        H.matvec(x)
    assert apply_cache_sizes() == before


def test_lbfgs_operator_algebra(rng):
    """L-BFGS participates in the lazy algebra like any operator."""
    n = 8
    B = LBFGSOperator(n, mem=4, scaling=False)
    for _ in range(4):
        s, y = rng.standard_normal(n), rng.standard_normal(n)
        B.push(s, y)
    D = lo.opDiagonal(jnp.arange(1.0, n + 1))
    chain = 2.0 * (D @ B) + B.T
    dense = 2.0 * (np.diag(np.arange(1.0, n + 1)) @ np.asarray(B.to_dense())) + np.asarray(
        B.to_dense()
    ).T
    v = rng.standard_normal(n)
    assert_close(chain * v, dense @ v)


def test_compact_inverse_equals_two_loop(rng):
    """The compact (BNS) inverse apply is numerically identical to the
    two-loop recursion — partial, full, and wrapped ring buffers."""
    from linops_tpu.qn.lbfgs import inverse_apply, inverse_apply_compact

    n, mem = 30, 6
    for scaling in (False, True):
        for pushes in (0, 2, mem, mem + 3):
            H = InverseLBFGSOperator(n, mem=mem, scaling=scaling)
            for _ in range(pushes):
                s = rng.standard_normal(n)
                y = s + 0.2 * rng.standard_normal(n)
                H.push(s, y)
            v = rng.standard_normal(n)
            two_loop = np.asarray(inverse_apply(H.state, jnp.asarray(v)))
            compact = np.asarray(inverse_apply_compact(H.state, jnp.asarray(v)))
            np.testing.assert_allclose(
                compact, two_loop, rtol=1e-11, atol=1e-11,
                err_msg=f"scaling={scaling} pushes={pushes}",
            )


def test_compact_forward_equals_ab_form(rng):
    """The compact forward apply equals the reference a/b form across
    partial/full/wrapped rings, scaling on/off, and damped pushes."""
    from linops_tpu.qn.lbfgs import forward_apply, forward_apply_compact

    n, mem = 25, 6
    for scaling in (False, True):
        for damped in (False, True):
            for pushes in (0, 2, mem, mem + 3):
                B = LBFGSOperator(n, mem=mem, scaling=scaling, damped=damped)
                for _ in range(pushes):
                    s = rng.standard_normal(n)
                    y = s + 0.2 * rng.standard_normal(n)
                    B.push(s, y)
                v = rng.standard_normal(n)
                B.ensure_ab()  # lazy pushes defer the a-vectors
                ab = np.asarray(forward_apply(B.state, jnp.asarray(v)))
                compact = np.asarray(forward_apply_compact(B.state, jnp.asarray(v)))
                np.testing.assert_allclose(
                    compact, ab, rtol=1e-10, atol=1e-10,
                    err_msg=f"scaling={scaling} damped={damped} pushes={pushes}",
                )


def test_compact_forward_identical_pairs():
    """Repeated identical pairs keep K invertible (BNS invertibility only
    needs ys > 0) and the product consistent with the a/b form."""
    from linops_tpu.qn.lbfgs import forward_apply, forward_apply_compact

    n, mem = 10, 4
    B = LBFGSOperator(n, mem=mem, scaling=False)
    s = np.ones(n)
    y = np.concatenate([[2.0], np.ones(n - 1)])
    for _ in range(3):
        B.push(s, y)
    v = np.linspace(-1, 1, n)
    B.ensure_ab()
    ab = np.asarray(forward_apply(B.state, jnp.asarray(v)))
    compact = np.asarray(forward_apply_compact(B.state, jnp.asarray(v)))
    np.testing.assert_allclose(compact, ab, rtol=1e-9, atol=1e-9)


def test_lazy_ab_deferred_and_recomputed(rng):
    """lazy_ab (the default) skips the O(mem²·n) a-vector loop on push but
    reproduces the eager state exactly on demand; eager mode still works."""
    from linops_tpu.qn.lbfgs import forward_apply

    n, mem = 20, 5
    lazy = LBFGSOperator(n, mem=mem)
    eager = LBFGSOperator(n, mem=mem, lazy_ab=False)
    for _ in range(mem + 2):
        s = rng.standard_normal(n)
        y = s + 0.2 * rng.standard_normal(n)
        lazy.push(s, y)
        eager.push(s, y)
    # hot compact applies agree WITHOUT materializing a/b
    v = rng.standard_normal(n)
    np.testing.assert_allclose(np.asarray(lazy * v), np.asarray(eager * v), rtol=1e-12)
    # deferred A differs pre-ensure, matches exactly post-ensure
    lazy.ensure_ab()
    np.testing.assert_allclose(np.asarray(lazy.state.A), np.asarray(eager.state.A), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(lazy.diag()), np.asarray(eager.diag()), rtol=1e-10)
    # push after ensure re-defers and still converges to the same state
    s = rng.standard_normal(n); y = s + 0.1 * rng.standard_normal(n)
    lazy.push(s, y); eager.push(s, y)
    np.testing.assert_allclose(np.asarray(lazy.diag()), np.asarray(eager.diag()), rtol=1e-10)


def test_lbfgs_complex_rejected():
    """Complex L-BFGS is a deliberate deviation from the reference: the
    reference is generic over T (src/lbfgs.jl:4-57) but never tests complex,
    and its update y·yᴴ/(yᴴs) is non-Hermitian for complex yᴴs — so we
    reject at construction with an explanatory error (COVERAGE.md #16a)."""
    for ctor in (LBFGSOperator, InverseLBFGSOperator):
        with pytest.raises(lo.LinearOperatorException, match="complex"):
            ctor(jnp.complex128, 8, mem=4)


def test_lazy_ab_checkpoint_roundtrip(rng, tmp_path):
    """Checkpoint restore must not leave a lazy operator believing its
    deferred a-vectors are fresh (code-review round 2 finding #1): saving
    materializes them, and ANY state swap invalidates the freshness flag."""
    n, mem = 16, 4
    B = LBFGSOperator(n, mem=mem)  # lazy default
    for _ in range(mem):
        s = rng.standard_normal(n)
        B.push(s, s + 0.2 * rng.standard_normal(n))
    path = str(tmp_path / "b.npz")
    lo.save_operator(path, B)
    B2 = LBFGSOperator(n, mem=mem)
    lo.load_operator_state(path, B2)
    np.testing.assert_allclose(np.asarray(B2.diag()), np.asarray(B.diag()), rtol=1e-12)
    # direct external state swap also invalidates
    B3 = LBFGSOperator(n, mem=mem)
    B3.state = B.state
    np.testing.assert_allclose(np.asarray(B3.diag()), np.asarray(B.diag()), rtol=1e-12)


def test_lazy_ab_closure_jit_does_not_corrupt(rng):
    """Calling an a/b consumer under an outer jit with the operator in a
    CLOSURE must not cache tracers on the host operator (code-review round 2
    finding #2)."""
    import jax
    from linops_tpu.qn.shifted_solve import solve_shifted_system

    n, mem = 12, 3
    B = LBFGSOperator(n, mem=mem)
    for _ in range(mem):
        s = rng.standard_normal(n)
        B.push(s, s + 0.2 * rng.standard_normal(n))
    b = jnp.asarray(rng.standard_normal(n))

    @jax.jit
    def f(rhs):
        return solve_shifted_system(B, rhs, 0.1, method="ejm")  # B in closure

    x1 = np.asarray(f(b))
    # host operator still usable afterwards (would raise UnexpectedTracerError
    # if tracers were cached)
    d = np.asarray(B.diag())
    assert np.isfinite(d).all()
    x2 = np.asarray(solve_shifted_system(B, b, 0.1, method="ejm"))
    np.testing.assert_allclose(x1, x2, rtol=1e-9)


def test_donate_push(rng):
    """donate_push=True produces the same states (in-place ring-buffer
    updates, the reference's push! semantics); a previously-captured state
    alias is invalid afterwards."""
    n, mem = 16, 4
    B = LBFGSOperator(n, mem=mem)
    Bd = LBFGSOperator(n, mem=mem, donate_push=True)
    for _ in range(mem + 2):
        s = rng.standard_normal(n)
        y = s + 0.2 * rng.standard_normal(n)
        B.push(s, y)
        Bd.push(s, y)
    v = rng.standard_normal(n)
    np.testing.assert_allclose(np.asarray(B * v), np.asarray(Bd * v), rtol=1e-12)
    # rejected pushes still behave (gated rewrite path)
    Bd.push(np.ones(n), -np.ones(n))
    assert Bd.insert == B.insert


def test_eager_op_rejects_foreign_stale_state(rng):
    """An EAGER operator receiving a state produced by a lazy operator must
    not trust its stale a-vectors (code-review round 2b finding #1)."""
    n, mem = 12, 3
    lazy = LBFGSOperator(n, mem=mem)
    for _ in range(mem + 1):
        s = rng.standard_normal(n)
        lazy.push(s, s + 0.2 * rng.standard_normal(n))
    eager = LBFGSOperator(n, mem=mem, lazy_ab=False)
    eager.state = lazy.state  # foreign (deferred) state
    ref = LBFGSOperator(n, mem=mem, lazy_ab=False)
    ref.state = lazy.state
    lazy.ensure_ab()
    np.testing.assert_allclose(
        np.asarray(eager.diag()), np.asarray(lazy.diag()), rtol=1e-10
    )
    # nested-graph checkpoint materializes the inner operator's a-vectors
    import tempfile, os
    lazy2 = LBFGSOperator(n, mem=mem)
    for _ in range(mem):
        s = rng.standard_normal(n)
        lazy2.push(s, s + 0.2 * rng.standard_normal(n))
    graph = 2.0 * lazy2
    p = os.path.join(tempfile.mkdtemp(), "g.npz")
    lo.save_operator(p, graph)
    assert getattr(lazy2, "_ab_fresh", False)  # hook recursed into the graph


def test_compact_state_is_form_agnostic(rng):
    """Regression (r5 review): the push-maintained middle matrix must
    serve BOTH compact forms — a state pushed through a forward operator
    applies exactly through the inverse compact path (checkpoint restore
    across forms, direct module-function calls)."""
    from linops_tpu.qn.lbfgs import (forward_apply, inverse_apply,
                                     forward_apply_compact,
                                     inverse_apply_compact)

    n = 48
    B = lo.LBFGSOperator(jnp.float64, n, mem=5)
    H = lo.InverseLBFGSOperator(jnp.float64, n, mem=5)
    for _ in range(7):  # > mem: ring wraparound
        s = rng.standard_normal(n)
        y = s + 0.25 * rng.standard_normal(n)
        B.push(s, y)
        H.push(s, y)
    v = rng.standard_normal(n)
    # forward-pushed state through the INVERSE compact apply
    got = np.asarray(inverse_apply_compact(B.state, jnp.asarray(v)))
    ref = np.asarray(inverse_apply(B.state, jnp.asarray(v)))
    np.testing.assert_allclose(got, ref, rtol=1e-11)
    # inverse-pushed state through the FORWARD compact apply
    got2 = np.asarray(forward_apply_compact(H.state, jnp.asarray(v)))
    ref2 = np.asarray(forward_apply(B._materialized_state(), jnp.asarray(v)))
    np.testing.assert_allclose(got2, ref2, rtol=1e-11)
    # operator-level cross-form state swap
    H2 = lo.InverseLBFGSOperator(jnp.float64, n, mem=5)
    H2.state = B.state
    np.testing.assert_allclose(np.asarray(H2 @ v), ref, rtol=1e-11)
