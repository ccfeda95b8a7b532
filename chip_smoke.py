"""Smoke test of linops_tpu on one GPU, through the library's entry points.

    python3 chip_smoke.py               # phases A-F on one card
    python3 chip_smoke.py --multichip   # the sharded step on four cards

Each phase prints one line: its name, shape, dtype, wall seconds, the
steady-state seconds per apply (after a warm-up, ended by
``jax.block_until_ready``) and the largest error against its reference with
the tolerance beside it. A phase whose error exceeds its tolerance stops
the script with a non-zero exit. The last line of standard output is one
JSON object naming the device.

Tolerances (relative error in the 2-norm unless stated):

- float64: 1e-12, from rounding alone;
- float32: 1e-5 — the GPU sums in another order than the CPU, and
  ``segment_sum`` uses atomics; a float32 product that slipped onto TF32
  would show about 1e-3, so this bound also catches TF32;
- bf16 storage: 1e-2.

The script refuses to run anywhere but on a GPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import jax

TOL = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 1e-2}


def device_info():
    """Phase A: the device as JAX reports it; exits when it is no GPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX found {devs[0].platform!r})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}, card.strip().splitlines()[0]


def rel_err(got, ref):
    import numpy as np

    got = np.asarray(got, np.float64 if not np.iscomplexobj(got)
                     else np.complex128)
    ref = np.asarray(ref)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-300))


def steady(fn, *args, reps=5):
    """Median seconds of ``fn(*args)`` after one warm-up call."""
    import numpy as np

    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts))


def report(name, shape, dtype, wall, per_apply, err, tol):
    ok = err <= tol
    apply = "not-measured" if per_apply is None else f"{per_apply:.6e}s"
    print(f"{name}: shape={tuple(shape)} dtype={dtype} wall={wall:.2f}s "
          f"apply={apply} err={err:.3e} tol={tol:.0e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke: {name} error {err:.3e} > {tol:.0e}")


# --------------------------------------------------------------------------
# References (NumPy, float64)
# --------------------------------------------------------------------------


def two_loop(S, Y, v):
    """H v by the L-BFGS two-loop recursion; pairs oldest first, scaling
    γ = yᵀs / yᵀy of the newest pair."""
    import numpy as np

    q = np.array(v, np.float64)
    rho = [1.0 / float(y @ s) for s, y in zip(S, Y)]
    alpha = []
    for s, y, r in reversed(list(zip(S, Y, rho))):
        a = r * float(s @ q)
        q -= a * y
        alpha.append(a)
    q *= float(Y[-1] @ S[-1]) / float(Y[-1] @ Y[-1])
    for (s, y, r), a in zip(zip(S, Y, rho), reversed(alpha)):
        q += (a - r * float(y @ q)) * s
    return q


def bfgs_forward(S, Y, v):
    """B v for the L-BFGS matrix of the same pairs: B₀ = (yᵀy / yᵀs) I of
    the newest pair, then one rank-two BFGS update per pair, oldest first
    (B v = θ v + Σ (bᵢ·v) bᵢ − (aᵢ·v) aᵢ)."""
    import numpy as np

    theta = float(Y[-1] @ Y[-1]) / float(Y[-1] @ S[-1])
    A, B = [], []

    def apply(x):
        out = theta * x
        for a, b in zip(A, B):
            out += float(b @ x) * b - float(a @ x) * a
        return out

    for s, y in zip(S, Y):
        Bs = apply(s)
        A.append(Bs / np.sqrt(float(s @ Bs)))
        B.append(y / np.sqrt(float(y @ s)))
    return apply(np.asarray(v, np.float64))


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------


def phase_algebra(n=50_000_000):
    """B: __graft_entry__.entry's step — 2·D1(I + D2) with an inverse
    L-BFGS preconditioner step — at n = 5·10⁷ in float32."""
    import jax.numpy as jnp
    import numpy as np

    import __graft_entry__ as ge

    t0 = time.perf_counter()
    fn, args = ge.entry(n)
    out, per = steady(jax.jit(fn), *args)
    pairs = list(ge.lbfgs_pairs(n, ge.ENTRY_MEM))
    S = [s.astype(np.float64) for s, _ in pairs]
    Y = [y.astype(np.float64) for _, y in pairs]
    del pairs
    d1 = np.linspace(1.0, 2.0, n)
    d2 = np.linspace(0.5, 1.5, n)
    r = np.ones(n)  # b - A·0
    z = two_loop(S, Y, r)
    alpha = (r @ z) / (z @ (2.0 * d1 * (1.0 + d2) * z))
    report("B algebra entry step", (n,), jnp.dtype(out.dtype).name,
           time.perf_counter() - t0, per, rel_err(out, alpha * z),
           TOL["float32"])


def _random_bsr(rng, nrow, bm, bn, k, dtype):
    """scipy BSR matrix: ``k`` distinct block columns per block row, at a
    random offset and evenly spread."""
    import numpy as np
    import scipy.sparse as sps

    nbrow, nbcol = nrow // bm, nrow // bn
    base = rng.integers(0, nbcol, nbrow)
    cols = (base[:, None] + np.arange(k)[None, :] * (nbcol // k)) % nbcol
    cols.sort(axis=1)
    data = rng.standard_normal((nbrow * k, bm, bn), dtype=np.float32)
    indptr = np.arange(0, nbrow * k + 1, k)
    return sps.bsr_matrix((data.astype(dtype), cols.ravel(), indptr),
                          shape=(nrow, nrow))


def phase_bsr(rng, min_bytes=256 << 20, shrink=1):
    """C: BSR SpMV through opSparse(format="bsr"), N and T, at least
    ``min_bytes`` (256 MiB, five times the 50 MB L2) of stored blocks per
    operator and at least two blocks per block row. ``shrink`` divides the
    sizes for a rehearsal on the CPU."""
    import jax.numpy as jnp
    import numpy as np

    import linops_tpu as lo

    cases = [  # (block, nrow, dtype of the stored values)
        ((8, 128), 1 << 18, "float32"),
        ((8, 128), 1 << 18, "float64"),
        ((128, 128), 1 << 16, "float32"),
        ((128, 128), 1 << 16, "float64"),
        ((16, 128), 1 << 18, "bfloat16"),
    ]
    for (bm, bn), nrow, dt in cases:
        t0 = time.perf_counter()
        nrow //= shrink
        itemsize = jnp.dtype(dt).itemsize
        k = max(2, -(-(min_bytes // shrink) // (nrow * bn * itemsize)))
        host_dt = np.float64 if dt == "float64" else np.float32
        A = _random_bsr(rng, nrow, bm, bn, k, host_dt)
        op = lo.opSparse(A, format="bsr", block_shape=(bm, bn),
                         dtype=None if dt != "bfloat16" else jnp.bfloat16)
        stored = op.data.blocks.size * itemsize
        assert stored >= min_bytes // shrink, stored
        x = rng.standard_normal(nrow).astype(host_dt)
        xd = jnp.asarray(x, jnp.bfloat16 if dt == "bfloat16" else host_dt)
        A64 = A.astype(np.float64)
        if dt == "bfloat16":  # the reference sees the stored (rounded) values
            A64.data = np.asarray(
                jnp.asarray(A.data, jnp.bfloat16).astype(jnp.float32),
                np.float64)
        for mode in ("N", "T"):
            f = jax.jit(lambda o, v, m=mode: o.apply(v, m))
            y, per = steady(f, op, xd)
            ref = (A64 if mode == "N" else A64.T) @ np.asarray(
                xd.astype(jnp.float32) if dt == "bfloat16" else xd,
                np.float64)
            report(f"C bsr {bm}x{bn} {dt} {mode} ({stored >> 20} MiB)",
                   A.shape, jnp.dtype(y.dtype).name,
                   time.perf_counter() - t0, per, rel_err(y, ref), TOL[dt])
        del op, A, A64


def _poisson_csr(rng, n, mean):
    """Uniform-random n×n pattern with Poisson(mean) entries per row."""
    import numpy as np
    import scipy.sparse as sps

    counts = rng.poisson(mean, n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    cols = rng.integers(0, n, int(indptr[-1]))
    rows = np.repeat(np.arange(n), counts)
    order = np.lexsort((cols, rows))
    vals = rng.standard_normal(cols.size, dtype=np.float32)
    A = sps.csr_matrix((vals, cols[order].astype(np.int32), indptr),
                       shape=(n, n))
    A.sum_duplicates()
    return A


def phase_unstructured(rng, n=1 << 19):
    """D: a 2¹⁹ × 2¹⁹ uniform-random pattern with Poisson(16) nnz per row,
    through format="auto", "csr" and "routed", N and T, float32."""
    import warnings

    import jax.numpy as jnp
    import numpy as np

    import linops_tpu as lo

    A = _poisson_csr(rng, n, 16)
    A64 = A.astype(np.float64)
    x = rng.standard_normal(n).astype(np.float32)
    for fmt in ("auto", "csr", "routed"):
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            op = lo.opSparse(A, format=fmt)
        for mode in ("N", "T"):
            f = jax.jit(lambda o, v, m=mode: o.apply(v, m))
            y, per = steady(f, op, jnp.asarray(x))
            ref = (A64 if mode == "N" else A64.T) @ x.astype(np.float64)
            report(f"D unstructured {fmt}->{type(op).__name__} {mode} "
                   f"(nnz {A.nnz})", A.shape, jnp.dtype(y.dtype).name,
                   time.perf_counter() - t0, per, rel_err(y, ref),
                   TOL["float32"])
        del op


def _laplacian_scipy(ng):
    import scipy.sparse as sps

    T = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(ng, ng))
    eye = sps.identity(ng)
    return (sps.kron(T, eye) + sps.kron(eye, T)).tocsr()


def phase_solvers(ng=4096):
    """E: cg on the 4096² 5-point Laplacian in float64 (300 iterations),
    and lobpcg k=8 for 20 iterations in float32."""
    import jax.numpy as jnp
    import numpy as np

    import linops_tpu as lo

    n = ng * ng
    t0 = time.perf_counter()
    L64 = lo.laplacian_2d(ng, ng, dtype=jnp.float64)
    b = jnp.asarray(np.random.default_rng(1).standard_normal(n))
    iters = 300
    (x, k, res), per = steady(
        lambda o, v: lo.cg(o, v, tol=0.0, maxiter=iters), L64, b, reps=2)
    A = _laplacian_scipy(ng)
    bn, xn = np.asarray(b), np.asarray(x)
    bnorm = float(np.linalg.norm(bn))
    true_res = float(np.linalg.norm(bn - A @ xn))
    assert int(k) == iters and true_res < bnorm
    # the recurrence residual drifts from the true one by rounding only:
    # at most iters·ε·(‖A‖‖x‖ + ‖b‖), with ‖A‖ ≤ 8 for this stencil
    eps = float(np.finfo(np.float64).eps)
    tol = iters * eps * (8.0 * float(np.linalg.norm(xn)) + bnorm) / bnorm
    report(f"E cg {iters} it (true res {true_res / bnorm:.3e} of |b|)",
           (n, n), "float64", time.perf_counter() - t0, per / iters,
           abs(float(res) - true_res) / bnorm, tol)

    t0 = time.perf_counter()
    L32 = lo.laplacian_2d(ng, ng, dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    th1, _, r1, _ = lo.lobpcg(L32, k=8, largest=True, tol=0.0, maxiter=1,
                              key=key)
    (th, X, r20, it), per = steady(
        lambda o: lo.lobpcg(o, k=8, largest=True, tol=0.0, maxiter=20,
                            key=key), L32, reps=1)
    th, X = np.asarray(th, np.float64), np.asarray(X, np.float64)
    # Ritz residuals recomputed with scipy in float64
    R = A @ X - X * th[None, :]
    rres = np.linalg.norm(R, axis=0)
    assert np.all((th > 0) & (th < 8.0)), th
    assert float(np.max(np.asarray(r20))) < float(np.max(np.asarray(r1))), \
        (r1, r20)
    # the reported residuals against scipy's, relative to max(|θ|, 1)
    err = float(np.max(np.abs(rres - np.asarray(r20, np.float64))
                       / np.maximum(np.abs(th), 1.0)))
    report(f"E lobpcg k=8 20 it (max resid {np.max(rres):.3e} from "
           f"{float(np.max(np.asarray(r1))):.3e})", (n, 8), "float32",
           time.perf_counter() - t0, per / 20, err, TOL["float32"])


def phase_qn(n=10_000_000, mem=16):
    """F: LBFGSOperator / InverseLBFGSOperator at n = 10⁷, mem = 16
    (1.28 GB of float32 state): 16 pushes, then forward and inverse."""
    import jax.numpy as jnp
    import numpy as np

    import linops_tpu as lo

    t0 = time.perf_counter()
    rng = np.random.default_rng(2)
    B = lo.LBFGSOperator(jnp.float32, n, mem=mem)
    H = lo.InverseLBFGSOperator(jnp.float32, n, mem=mem)
    S, Y = [], []
    for _ in range(mem):
        s = rng.standard_normal(n, dtype=np.float32)
        y = s + np.float32(0.1) * rng.standard_normal(n, dtype=np.float32)
        B.push(jnp.asarray(s), jnp.asarray(y))
        H.push(jnp.asarray(s), jnp.asarray(y))
        S.append(s.astype(np.float64))
        Y.append(y.astype(np.float64))
    v = rng.standard_normal(n, dtype=np.float32)
    vd = jnp.asarray(v)
    f = jax.jit(lambda o, x: o.apply(x, "N"))
    yB, perB = steady(f, B, vd)
    yH, perH = steady(f, H, vd)
    wall = time.perf_counter() - t0
    report("F lbfgs forward", (n, n), "float32", wall, perB,
           rel_err(yB, bfgs_forward(S, Y, v)), TOL["float32"])
    report("F lbfgs inverse", (n, n), "float32", wall, perH,
           rel_err(yH, two_loop(S, Y, v)), TOL["float32"])


def phase_multichip(n=16384):
    """The sharded step of __graft_entry__.dryrun_multichip on four cards
    (a dense n×n float32 operator: n = 16384 puts 268 MB on each card),
    compared there with the same step on one card."""
    import __graft_entry__ as ge

    t0 = time.perf_counter()
    out = ge.dryrun_multichip(4, n=n)
    report("multichip dryrun_multichip(4)", (n, n), "float32",
           time.perf_counter() - t0, None,
           out["step_rel_err_vs_one_device"], TOL["float32"])
    print("multichip collectives: " + json.dumps(out), flush=True)


def main(argv):
    dev, card = device_info()
    multichip = "--multichip" in argv
    if multichip and dev["count"] < 4:
        sys.exit(f"chip_smoke --multichip needs 4 GPUs, found {dev['count']}")
    jax.config.update("jax_enable_x64", True)
    from linops_tpu.utils.compile_cache import enable_compile_cache

    import numpy as np

    enable_compile_cache()
    print(f"A device: platform={dev['platform']} kind={dev['kind']} "
          f"count={dev['count']}", flush=True)
    if multichip:
        phase_multichip()
    else:
        rng = np.random.default_rng(0)
        phase_algebra()
        phase_bsr(rng)
        phase_unstructured(rng)
        phase_solvers()
        phase_qn()
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
