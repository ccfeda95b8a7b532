"""Headline benchmark for linops_tpu on one GPU.

Prints ONE COMPACT JSON line: {"metric": ..., "value": N, "unit": ...,
"vs_baseline": N, "detail": {<headline keys>}} and writes the FULL detail
dict to bench_out.json next to this file.

Measures compiled chains (whole Krylov loop in one jit) using MARGINAL
timing — each chain is run at two iteration counts and the difference
divided, which cancels the per-call dispatch cost. Every run ends in
``jax.block_until_ready``.

The headline (BSR SpMV) runs FIRST; remaining sections are individually
fault-tolerant and skipped once the time budget is spent.

value = achieved SpMV bandwidth; vs_baseline = fraction of the card's
published memory bandwidth (``_PEAK_GBPS``, keyed by ``device_kind``).
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

import linops_tpu as lo

# keys promoted from the full detail dict into the compact printed line;
# everything else goes to bench_out.json only
_HEADLINE_KEYS = (
    "platform", "roofline_gbs", "spmv_gnnz_per_s", "spmv_us_per_apply",
    "lbfgs_fwd_us", "lbfgs_inv_us", "lsr1_fwd_us", "lbfgs_roofline_us_1to2pass",
    "routed_unstructured_gnnz_per_s", "routed_unstructured_T_gnnz_per_s",
    "routed_spmm_k8_us", "routed_spmm_k8_x_matvec",
    "routed_spmm_k8_panel_us", "routed_spmm_k8_panel_x_matvec",
    "routed_pack_cpu_s", "routed_pack_t_cpu_s", "routed_upload_s",
    "routed_multichunk_gnnz_per_s", "routed_multichunk_T_gnnz_per_s",
    "routed_multichunk_pack_cpu_s", "routed_multichunk_upload_s",
    "spmv_8x128_bf16_gbs", "spmv_16x128_bf16_gbs",
    "reorder_rcm_gbs", "auto_8m_format", "auto_8m_gnnz_per_s",
    "lobpcg_us_per_iter_k2",
)


def _emit(headline, detail):
    """Write the full detail to bench_out.json; print the compact line."""
    line = dict(headline)
    line["detail"] = {k: detail[k] for k in _HEADLINE_KEYS if k in detail}
    line["detail"]["detail_file"] = "bench_out.json"
    try:
        out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "bench_out.json")
        with open(out, "w") as f:
            json.dump({**line, "detail": detail}, f, indent=1)
    except Exception as e:  # the compact line must still go out
        line["detail"]["detail_file"] = f"unwritable: {e}"
    print(json.dumps(line), flush=True)


# Published memory bandwidth per device_kind (NVIDIA H100 data sheet, SXM
# part: 3.35 TB/s). A device missing here is an error, not a default.
_PEAK_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}
I_SHORT, I_LONG = 50, 1050  # delta must dwarf per-call jitter
TIME_BUDGET_S = 2300.0  # skip optional sections beyond this

_t_start = time.time()


def _budget_left() -> bool:
    return time.time() - _t_start < TIME_BUDGET_S


from linops_tpu.utils.timing import marginal_chain_time


def _marginal_apply_time(op, v, reps: int = 3, mode: str = "N"):
    """Seconds per apply: median of repeated (long - short) chain deltas,
    which cancels per-call dispatch overhead."""

    def f(o, x, iters):
        return lo.matvec_chain(o, x, iters, mode=mode)

    return marginal_chain_time(
        f, op, v, iters_short=I_SHORT, iters_long=I_LONG, reps=reps
    )


def main():
    from linops_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    platform = dev.platform
    if platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {platform!r}")
    if dev.device_kind not in _PEAK_GBPS:
        raise SystemExit(f"no published peak for {dev.device_kind!r}")
    roofline = _PEAK_GBPS[dev.device_kind]
    headline = {"metric": "spmv_chain_bandwidth", "value": 0.0,
                "unit": "GB/s", "vs_baseline": 0.0}
    dtype = jnp.float32
    bpe = jnp.dtype(dtype).itemsize
    rng = np.random.default_rng(0)
    detail = {
        "platform": platform,
        "device_kind": dev.device_kind,
        "device_count": jax.device_count(),
        "roofline_gbs": roofline,
        "timing": f"marginal ({I_LONG}-{I_SHORT} chain iterations, median of 3)",
    }

    # --- (2) BSR SpMV chain — THE HEADLINE, measured first -----------------
    # 128x128 blocks, 1/16 density ≈ 67M nnz.
    # Traffic model: stored block values only (a lower bound on real HBM
    # traffic — excludes gathered x blocks, y, and block_cols; at this
    # block size those add < 2%).
    from linops_tpu.sparse.formats import BSR

    ns = 65536
    blocks = jnp.asarray(
        rng.standard_normal((ns // 128, 4, 128, 128)).astype(np.float32)
    )
    cols = jnp.asarray(rng.integers(0, ns // 128, size=(ns // 128, 4)).astype(np.int32))
    opB = lo.BSROperator(BSR(blocks=blocks, block_cols=cols, shape=(ns, ns)))
    vs = jnp.ones((ns,), dtype)
    t0 = time.time()
    t_spmv = _marginal_apply_time(opB, vs, reps=3)
    detail["headline_measure_s"] = round(time.time() - t0, 1)  # incl. compiles
    nnz = int(blocks.size)
    spmv_gbs = nnz * bpe / t_spmv / 1e9
    headline["value"] = round(spmv_gbs, 2)
    headline["vs_baseline"] = round(spmv_gbs / roofline, 4)
    detail["spmv_traffic_model"] = "stored block values only (lower bound)"
    detail["spmv_precision"] = "f32 (HIGHEST)"
    detail["spmv_gnnz_per_s"] = round(nnz / t_spmv / 1e9, 3)
    detail["spmv_us_per_apply"] = round(t_spmv * 1e6, 1)

    # --- optional sections (fault-tolerant, budget-guarded) ----------------
    def section(name, fn):
        if not _budget_left():
            detail[name] = "skipped (time budget)"
            return
        try:
            fn()
        except Exception as e:  # record, don't die
            detail[name] = f"error: {type(e).__name__}: {str(e)[:200]}"

    def sec_spmv_bf16():
        # bf16 storage tier on the headline 128x128 shape
        opB16 = lo.BSROperator(
            BSR(blocks=blocks.astype(jnp.bfloat16), block_cols=cols,
                shape=(ns, ns)))
        t16 = _marginal_apply_time(opB16, vs.astype(jnp.bfloat16), reps=2)
        detail["spmv_bf16_gnnz_per_s"] = round(nnz / t16 / 1e9, 3)
        detail["spmv_bf16_us_per_apply"] = round(t16 * 1e6, 1)

    def sec_spmv8():
        # fine-block case (8x128), forward and transpose
        blocks8 = jnp.asarray(
            rng.standard_normal((ns // 8, 8, 8, 128)).astype(np.float32)
        )
        cols8 = jnp.asarray(
            rng.integers(0, ns // 128, size=(ns // 8, 8)).astype(np.int32)
        )
        data8 = BSR(blocks=blocks8, block_cols=cols8, shape=(ns, ns))
        opB8 = lo.BSROperator(data8)
        t8 = _marginal_apply_time(opB8, vs, reps=2)
        detail["spmv_8x128_gbs"] = round(blocks8.size * bpe / t8 / 1e9, 2)
        if _budget_left():
            t8t = _marginal_apply_time(opB8, vs, reps=2, mode="T")
            detail["spmv_8x128_T_gbs"] = round(blocks8.size * bpe / t8t / 1e9, 2)
        if _budget_left():
            data8h = BSR(
                blocks=blocks8.astype(jnp.bfloat16),
                block_cols=cols8,
                shape=(ns, ns),
            )
            opB8h = lo.BSROperator(data8h)
            t8h = _marginal_apply_time(opB8h, vs, reps=2)
            detail["spmv_8x128_bf16_gbs"] = round(blocks8.size * 2 / t8h / 1e9, 2)
            detail["spmv_8x128_bf16_gnnz_per_s"] = round(blocks8.size / t8h / 1e9, 2)
        if _budget_left():
            # 16x128 bf16 storage
            blocks16 = jnp.asarray(
                rng.standard_normal((ns // 16, 8, 16, 128)).astype(np.float32)
            ).astype(jnp.bfloat16)
            cols16 = jnp.asarray(
                rng.integers(0, ns // 128, size=(ns // 16, 8)).astype(np.int32)
            )
            op16h = lo.BSROperator(BSR(blocks=blocks16, block_cols=cols16, shape=(ns, ns)))
            t16h = _marginal_apply_time(op16h, vs, reps=2)
            detail["spmv_16x128_bf16_gbs"] = round(blocks16.size * 2 / t16h / 1e9, 2)
            detail["spmv_16x128_bf16_gnnz_per_s"] = round(blocks16.size / t16h / 1e9, 2)

    def sec_csr():
        # CSR ingestion path:
        # a block-structured 67M-nnz matrix ingested FROM CSR arrays.
        # (a) auto-routed through the native CSR->BSR packer (the default
        #     recommendation for block-structured patterns),
        # (b) the raw gather+segment_sum CSR path on a truly unstructured
        #     16-nnz/row matrix (its nnz/s is gather-bound — recorded
        #     honestly as such).
        # Roofline for the CSR *format* itself is 8 B/nnz (vals+cols):
        # nnz/s_max = roofline_gbs/8.
        import scipy.sparse as sps

        # block-structured: reuse the headline pattern as CSR input
        indptr = np.arange(0, (ns // 128) * 4 + 1, 4, dtype=np.int64)
        # expand block pattern to scipy BSR then CSR without densifying
        sp_bsr = sps.bsr_matrix(
            (
                np.asarray(blocks).reshape(-1, 128, 128),
                np.asarray(cols).ravel(),
                indptr,
            ),
            shape=(ns, ns),
        )
        sp_csr = sp_bsr.tocsr()
        t0 = time.time()
        opA = lo.opSparse(sp_csr, format="bsr", block_shape="auto")
        detail["csr_pack_s"] = round(time.time() - t0, 1)
        detail["csr_auto_block_shape"] = list(opA.data.block_shape)
        tA = _marginal_apply_time(opA, vs, reps=2)
        csr_nnz = sp_csr.nnz
        detail["csr_routed_gnnz_per_s"] = round(csr_nnz / tA / 1e9, 3)
        detail["csr_format_roofline_gnnz_per_s"] = round(roofline / 8, 1)
        detail["csr_routed_vs_csr_roofline"] = round(
            (csr_nnz / tA / 1e9) / (roofline / 8), 3
        )



    def sec_stencil():
        ngrid = 2048
        L = lo.laplacian_2d(ngrid, ngrid, dtype=dtype)  # n ≈ 4.2M
        vl = jnp.ones((ngrid * ngrid,), dtype)
        t = _marginal_apply_time(L, vl, reps=2)
        # nominal traffic / time
        detail["stencil_dia_apparent_gbs"] = round(7 * ngrid * ngrid * bpe / t / 1e9, 2)
        detail["stencil_dia_gnnz_per_s"] = round(5 * ngrid * ngrid / t / 1e9, 3)
        detail["stencil_us_per_apply"] = round(t * 1e6, 1)

    def sec_chain():
        n = 1_000_000
        d1 = jnp.linspace(1.0, 2.0, n, dtype=dtype)
        d2 = jnp.linspace(0.5, 1.5, n, dtype=dtype)
        chain = 3.0 * (
            lo.opDiagonal(d1) @ (lo.opEye(n, dtype=dtype) + lo.opDiagonal(d2))
        )
        t = _marginal_apply_time(chain, jnp.ones((n,), dtype), reps=2)
        detail["chain_us_per_apply"] = round(t * 1e6, 1)
        # nominal traffic / time
        detail["chain_apparent_gbs"] = round(4 * n * bpe / t / 1e9, 2)

    def sec_lbfgs():
        n = 1_000_000
        mem = 16
        B = lo.LBFGSOperator(dtype, n, mem=mem)
        H = lo.InverseLBFGSOperator(dtype, n, mem=mem)
        for _ in range(mem):
            s = rng.standard_normal(n).astype(np.float32)
            y = s + 0.1 * rng.standard_normal(n).astype(np.float32)
            B.push(s, y)
            H.push(s, y)
        v = jnp.ones((n,), dtype)
        t_fwd = _marginal_apply_time(B, v, reps=3)
        t_inv = _marginal_apply_time(H, v, reps=3)
        # Traffic model: MINIMUM one pass over the (2mem, n) memory plus
        # x and y; the roofline-µs window states the 1- and 2-pass bounds.
        min_bytes = ((2 * mem) * n + 2 * n) * bpe
        detail["lbfgs_traffic_model"] = "1-pass (2mem+2)·n·4B lower bound"
        detail["lbfgs_fwd_gbs_min1pass"] = round(min_bytes / t_fwd / 1e9, 2)
        detail["lbfgs_inv_gbs_min1pass"] = round(min_bytes / t_inv / 1e9, 2)
        detail["lbfgs_fwd_us"] = round(t_fwd * 1e6, 1)
        detail["lbfgs_inv_us"] = round(t_inv * 1e6, 1)
        # roofline-µs window at the published peak: [1-pass, 2-pass]
        ceil = roofline
        detail["lbfgs_roofline_us_1to2pass"] = [
            round(min_bytes / (ceil * 1e9) * 1e6, 1),
            round((2 * (2 * mem) * n + 2 * n) * bpe / (ceil * 1e9) * 1e6, 1),
        ]

        # L-SR1 compact apply (U is (mem, n): ~half the L-BFGS traffic;
        # push-maintained M-inverse keeps the hot apply matmul-only)
        R1 = lo.LSR1Operator(jnp.float32, n, mem=mem)
        for _ in range(mem):
            s = rng.standard_normal(n).astype(np.float32)
            y = 2.0 * s + 0.5 * rng.standard_normal(n).astype(np.float32)
            R1.push(s, y)
        t_sr1 = _marginal_apply_time(R1, v, reps=2)
        detail["lsr1_fwd_us"] = round(t_sr1 * 1e6, 1)

        # push throughput: lazy a/b (production default, O(mem·n)) vs the
        # eager reference recompute (O(mem²·n))
        from jax import lax as _lax
        from linops_tpu.qn.lbfgs import _push_plain

        s0 = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        y0 = s0 + 0.1 * jnp.asarray(rng.standard_normal(n).astype(np.float32))

        def make_push_chain(with_ab):
            @jax.jit
            def chain(state, s, y, iters):
                def body(i, st):
                    f = 1.0 + 0.001 * i.astype(jnp.float32)
                    return _push_plain(
                        st, s * f, y * f, scaling=True, inverse=False,
                        with_ab=with_ab,
                    )

                return _lax.fori_loop(0, iters, body, state)

            return chain

        Bp = lo.LBFGSOperator(jnp.float32, n, mem=mem)
        for name_, with_ab in (("lbfgs_push_lazy_us", False), ("lbfgs_push_eager_us", True)):
            chain = make_push_chain(with_ab)
            jax.block_until_ready(chain(Bp.state, s0, y0, 5))
            jax.block_until_ready(chain(Bp.state, s0, y0, 55))
            t0 = time.perf_counter(); jax.block_until_ready(chain(Bp.state, s0, y0, 5)); a = time.perf_counter() - t0
            t0 = time.perf_counter(); jax.block_until_ready(chain(Bp.state, s0, y0, 55)); b = time.perf_counter() - t0
            detail[name_] = round(max(b - a, 1e-9) / 50 * 1e6, 1)

    def sec_stress():
        from jax import lax as _lax

        na = 8192
        Ad = jnp.asarray(rng.standard_normal((na, na)).astype(np.float32))
        stress = (
            2.0
            * lo.hcat(
                lo.LinearOperator(Ad), lo.opDiagonal(jnp.abs(jnp.diag(Ad)) + 1.0)
            )[jnp.arange(na), jnp.arange(na)]
            + lo.BlockDiagonalOperator(
                lo.LinearOperator(Ad[: na // 2, : na // 2]),
                lo.LinearOperator(Ad[na // 2 :, na // 2 :]),
            )
        )
        X = jnp.ones((na, 8), dtype)

        @jax.jit
        def _stress_chain(op, X, iters):
            def body(_, M):
                M2 = op.apply_matrix(M, "N")
                return M2 / jnp.linalg.norm(M2)

            return _lax.fori_loop(0, iters, body, X)

        jax.block_until_ready(_stress_chain(stress, X, 50))
        jax.block_until_ready(_stress_chain(stress, X, 450))
        t0 = time.perf_counter()
        jax.block_until_ready(_stress_chain(stress, X, 50))
        ts1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(_stress_chain(stress, X, 450))
        ts2 = time.perf_counter() - t0
        # time only: XLA legitimately folds the zero-extension branch, so a
        # bytes/s figure would over-credit.
        detail["algebra_stress_spmm_us"] = round(max(ts2 - ts1, 1e-9) / 400 * 1e6, 1)


    def sec_routed_unstructured():
        # Clos-routed SpMV (sparse/routed.py) on the unstructured
        # 16-nnz/row matrix. Forward and transpose applies plus the host
        # pack cost.
        nu = 1 << 16
        nnz_row = 16
        counts = rng.poisson(nnz_row, nu)
        nnzu = int(counts.sum())
        indptr_u = np.zeros(nu + 1, np.int64)
        np.cumsum(counts, out=indptr_u[1:])
        cols_r = rng.integers(0, nu, nnzu)
        order = np.lexsort((cols_r, np.repeat(np.arange(nu), counts)))
        cols_u = cols_r[order]
        vals_u = rng.standard_normal(nnzu).astype(np.float32)
        from linops_tpu.sparse.formats import csr_from_parts

        hp = (vals_u, cols_u.astype(np.int32), indptr_u.astype(np.int32))
        data_u = csr_from_parts(*hp, (nu, nu))
        # untimed warmup pack: absorb the ONE-TIME process costs (lazy
        # g++ build of native/clos_route.cpp on a fresh checkout, first
        # jax dispatch) so the pack keys measure the pack itself
        _tiny = np.zeros(3, np.float32), np.arange(3, dtype=np.int32), \
            np.array([0, 1, 2, 3], np.int32)
        lo.RoutedCSROperator(csr_from_parts(*_tiny, (3, 3)),
                             host_parts=_tiny)
        # CPU pack cost measured with to_device=False (no upload in the
        # timed region)
        from linops_tpu.sparse.routed import pack_routed_csr

        # full-size untimed warmup: the first large pack pays allocator /
        # page-fault costs
        pack_routed_csr(*hp, (nu, nu), to_device=False)

        def _pack_time(**kw):
            best = None
            for _ in range(2):
                t0 = time.perf_counter()
                out = pack_routed_csr(*hp, (nu, nu), to_device=False, **kw)
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
            return best, out

        t_cpu_f, _ = _pack_time()
        t_cpu_ft, packed = _pack_time(with_transpose=True)
        fwd_np, der_np = packed
        detail["routed_pack_cpu_s"] = round(t_cpu_f, 2)
        detail["routed_pack_ft_cpu_s"] = round(t_cpu_ft, 2)
        detail["routed_pack_t_cpu_s"] = round(max(t_cpu_ft - t_cpu_f, 0.0), 2)
        detail["routed_pack_t_x_fwd"] = round(
            max(t_cpu_ft - t_cpu_f, 0.0) / max(t_cpu_f, 1e-9), 2)
        # upload, timed separately (one device_put of the whole program)
        t0 = time.perf_counter()
        fwd_dev = jax.device_put(fwd_np)
        der_dev = jax.device_put(der_np) if der_np is not None else None
        jax.block_until_ready(fwd_dev.vals)
        detail["routed_upload_s"] = round(time.perf_counter() - t0, 2)
        prog_bytes = sum(
            leaf.nbytes
            for leaf in jax.tree_util.tree_leaves((fwd_np, der_np)))
        detail["routed_prog_mb"] = round(prog_bytes / 1e6, 1)
        opR = lo.RoutedCSROperator(data_u, routed=fwd_dev, routed_t=der_dev,
                                   host_parts=hp)
        vu = jnp.ones((nu,), dtype)
        tR = _marginal_apply_time(opR, vu, reps=3)
        detail["routed_unstructured_n"] = nu
        detail["routed_unstructured_nnz"] = nnzu
        detail["routed_unstructured_gnnz_per_s"] = round(nnzu / tR / 1e9, 3)
        detail["routed_unstructured_us_per_apply"] = round(tR * 1e6, 1)
        tRT = _marginal_apply_time(opR, vu, reps=2, mode="T")
        detail["routed_unstructured_T_gnnz_per_s"] = round(nnzu / tRT / 1e9, 3)
        detail["routed_unstructured_T_us_per_apply"] = round(tRT * 1e6, 1)

        # multi-RHS through ONE shared routing program
        k_rhs = 8
        Xm = jnp.ones((nu, k_rhs), dtype)

        def spmm_chain(o, Xc, iters):
            def body(_, M):
                return o.apply_matrix(M, mode="N") * (1.0 / k_rhs)

            return jax.lax.fori_loop(0, iters, body, Xc)

        def spmm_time(chain_fn, X):
            return marginal_chain_time(chain_fn, opR, X, iters_short=20,
                                       iters_long=320, reps=3)

        t_k = spmm_time(spmm_chain, Xm)
        detail["routed_spmm_k8_us"] = round(t_k * 1e6, 1)
        detail["routed_spmm_k8_x_matvec"] = round(t_k / tR, 2)
        detail["routed_spmm_k8_gnnz_per_s"] = round(
            k_rhs * nnzu / t_k / 1e9, 2)

        # row-panel protocol (apply_matrix_t): the pipeline's native
        # column-outer layout on both ends — no boundary relayouts
        Xp = jnp.ones((k_rhs, nu), dtype)

        def spmm_panel_chain(o, Mt, iters):
            def body(_, M):
                return o.apply_matrix_t(M, mode="N") * (1.0 / k_rhs)

            return jax.lax.fori_loop(0, iters, body, Mt)

        t_kp = spmm_time(spmm_panel_chain, Xp)
        detail["routed_spmm_k8_panel_us"] = round(t_kp * 1e6, 1)
        detail["routed_spmm_k8_panel_x_matvec"] = round(t_kp / tR, 2)
        detail["routed_spmm_k8_panel_gnnz_per_s"] = round(
            k_rhs * nnzu / t_kp / 1e9, 2)

    def sec_routed_multichunk():
        # 262144² (16 nnz/row, ~4.2M nnz, 3 chunks): the batched-chunk
        # pipeline
        nm = 1 << 18
        counts = rng.poisson(16, nm)
        nnzm = int(counts.sum())
        indptr_m = np.zeros(nm + 1, np.int64)
        np.cumsum(counts, out=indptr_m[1:])
        cols_m = rng.integers(0, nm, nnzm)
        order_m = np.lexsort((cols_m, np.repeat(np.arange(nm), counts)))
        from linops_tpu.sparse.formats import csr_from_parts

        hpm = (rng.standard_normal(nnzm).astype(np.float32),
               cols_m[order_m].astype(np.int32), indptr_m.astype(np.int32))
        from linops_tpu.sparse.routed import pack_routed_csr

        t0 = time.perf_counter()
        fwd_np, der_np = pack_routed_csr(*hpm, (nm, nm), with_transpose=True,
                                         to_device=False)
        t_cpu = time.perf_counter() - t0
        detail["routed_multichunk_pack_cpu_s"] = round(t_cpu, 2)
        detail["routed_multichunk_pack_cpu_s_per_mnnz"] = round(
            t_cpu / (nnzm / 1e6), 2)
        t0 = time.perf_counter()
        fwd_dev = jax.device_put(fwd_np)
        der_dev = jax.device_put(der_np) if der_np is not None else None
        jax.block_until_ready(fwd_dev.vals)
        detail["routed_multichunk_upload_s"] = round(
            time.perf_counter() - t0, 2)
        opM = lo.RoutedCSROperator(csr_from_parts(*hpm, (nm, nm)),
                                   routed=fwd_dev, routed_t=der_dev,
                                   host_parts=hpm)
        detail["routed_multichunk_chunks"] = int(opM.routed.vals.shape[0])
        vm = jnp.ones((nm,), dtype)
        tM = _marginal_apply_time(opM, vm, reps=2)
        detail["routed_multichunk_gnnz_per_s"] = round(nnzm / tM / 1e9, 3)
        tMT = _marginal_apply_time(opM, vm, reps=2, mode="T")
        detail["routed_multichunk_T_gnnz_per_s"] = round(nnzm / tMT / 1e9, 3)

    def sec_permutation():
        # permutation operator (ops/permutation.py) at n = 1M
        np_perm = rng.permutation(1 << 20)
        t0 = time.perf_counter()
        Pop = lo.opPermutation(np_perm)
        detail["perm_pack_s"] = round(time.perf_counter() - t0, 2)
        vp = jnp.asarray(rng.standard_normal(1 << 20).astype(np.float32))
        tP = _marginal_apply_time(Pop, vp, reps=2)
        detail["perm_us_per_apply"] = round(tP * 1e6, 1)
        detail["perm_gelems_per_s"] = round((1 << 20) / tP / 1e9, 2)

    def sec_csr_unstructured():
        # raw gather CSR and ELL on an unstructured matrix (16 nnz/row)
        errs = []
        for nu in (1 << 16,):
            try:
                nnz_row = 16
                rows_u = np.repeat(np.arange(nu, dtype=np.int32), nnz_row)
                cols_u = rng.integers(0, nu, nu * nnz_row).astype(np.int32)
                vals_u = rng.standard_normal(nu * nnz_row).astype(np.float32)
                indptr_u = np.arange(0, nu * nnz_row + 1, nnz_row, dtype=np.int32)
                from linops_tpu.sparse.formats import CSR as CSRfmt

                opU = lo.CSROperator(
                    CSRfmt(
                        vals=jnp.asarray(vals_u),
                        cols=jnp.asarray(cols_u),
                        indptr=jnp.asarray(indptr_u),
                        rows=jnp.asarray(rows_u),
                        shape=(nu, nu),
                    )
                )
                vu = jnp.ones((nu,), dtype)
                tU = _marginal_apply_time(opU, vu, reps=2)
                detail["csr_unstructured_n"] = nu
                detail["csr_unstructured_gnnz_per_s"] = round(nu * nnz_row / tU / 1e9, 3)
                detail["csr_unstructured_us_per_apply"] = round(tU * 1e6, 1)
                # ELL (gather + row-sum, no scatter) on the same matrix
                from linops_tpu.sparse.formats import ell_from_csr_parts

                opE = lo.ELLOperator(
                    ell_from_csr_parts(vals_u, cols_u, indptr_u, (nu, nu))
                )
                tE = _marginal_apply_time(opE, vu, reps=2)
                detail["ell_unstructured_gnnz_per_s"] = round(nu * nnz_row / tE / 1e9, 3)
                return
            except Exception as e:
                errs.append(f"{nu}: {type(e).__name__}: {str(e)[:120]}")
                detail["csr_unstructured_n_failed"] = errs

    def sec_multirhs():
        # matrix-RHS 5-arg mul with donation (reference mul!(res, op, M, a, b))
        # on the headline BSR operator: 8 RHS amortize each block read.
        k = 8
        M = jnp.ones((ns, k), dtype)
        Res = jnp.zeros((ns, k), dtype)

        @jax.jit
        def chain(op, M, Res, iters):
            from jax import lax as _lax

            def body(_, carry):
                M, Res = carry
                out = 1.0 * op.apply_matrix(M, "N") + 0.5 * Res
                nrm = jnp.linalg.norm(out)
                return out / nrm, M
            return _lax.fori_loop(0, iters, body, (M, Res))

        def run(op):
            jax.block_until_ready(chain(op, M, Res, I_SHORT))
            jax.block_until_ready(chain(op, M, Res, I_LONG))
            t0 = time.perf_counter(); jax.block_until_ready(chain(op, M, Res, I_SHORT)); a = time.perf_counter() - t0
            t0 = time.perf_counter(); jax.block_until_ready(chain(op, M, Res, I_LONG)); b = time.perf_counter() - t0
            return max(b - a, 1e-9) / (I_LONG - I_SHORT)

        # f32 storage = f32-exact math (HIGHEST; see sparse/ops._bsr_precision)
        t = run(opB)
        detail["spmm_multirhs_us_per_apply"] = round(t * 1e6, 1)
        # compute rate (2·nnz·k flops), no bytes model
        detail["spmm_multirhs_tflops"] = round(2 * nnz * k / t / 1e12, 2)
        if _budget_left():
            # bf16 storage
            opB16 = lo.BSROperator(
                BSR(blocks=opB.data.blocks.astype(jnp.bfloat16),
                    block_cols=opB.data.block_cols, shape=opB.data.shape))
            t16 = run(opB16)
            detail["spmm_multirhs_bf16_us_per_apply"] = round(t16 * 1e6, 1)
            detail["spmm_multirhs_bf16_tflops"] = round(2 * nnz * k / t16 / 1e12, 2)

    def sec_solvers():
        # on-device Krylov drivers on a 2048² 5-pt Laplacian (n=4.19M):
        # marginal per-iteration cost (tol=0 forces full maxiter; two
        # maxiter values, difference cancels compile/dispatch).
        ng = 2048
        Astencil = lo.laplacian_2d(ng, ng, dtype=dtype)
        bsol = jnp.ones((ng * ng,), dtype)

        def per_iter(fn, lo_it, hi_it, **kw):
            # a 500-iteration span keeps the delta well above per-call
            # jitter
            ds = []
            for _ in range(3):
                t0 = time.perf_counter()
                jax.block_until_ready(fn(Astencil, bsol, tol=0.0, maxiter=lo_it, **kw)[0])
                a = time.perf_counter() - t0
                t0 = time.perf_counter()
                jax.block_until_ready(fn(Astencil, bsol, tol=0.0, maxiter=hi_it, **kw)[0])
                b = time.perf_counter() - t0
                ds.append(max(b - a, 1e-9) / (hi_it - lo_it))
            return sorted(ds)[1]

        detail["cg_us_per_iter"] = round(per_iter(lo.cg, 10, 510) * 1e6, 1)
        if _budget_left():
            detail["minres_us_per_iter"] = round(
                per_iter(lo.minres, 10, 510) * 1e6, 1)

    def sec_lobpcg():
        # spectral-suite cost: lobpcg marginal per-iteration on the 2048²
        # Laplacian stencil (k=2). tol=0 forces full maxiter; maxiter is a
        # static jit arg, so the two points are two compiles.
        if time.time() - _t_start > TIME_BUDGET_S - 1400:
            detail["lobpcg"] = "skipped (reserved budget)"
            return
        ng = 2048
        Ast = lo.laplacian_2d(ng, ng, dtype=dtype)

        def run(mi):
            t0 = time.perf_counter()
            jax.block_until_ready(lo.lobpcg(Ast, k=2, largest=True, tol=0.0, maxiter=mi,
                            key=jax.random.PRNGKey(0))[0])
            return time.perf_counter() - t0

        # warm BOTH compiles first: a rep that includes a compile has
        # meaningless deltas
        run(10); run(310)
        ds = []
        for _ in range(3):
            a = run(10)
            b = run(310)
            ds.append(max(b - a, 1e-9) / 300)
        detail["lobpcg_us_per_iter_k2"] = round(sorted(ds)[1] * 1e6, 1)
        detail["lobpcg_basis"] = "gram"

    def sec_scaling():
        # multi-device scaling harness on the virtual 8-device CPU mesh
        # (parallel/scaling_bench.py): the compiled-HLO collective audit
        # (halo = exactly 2 collective-permutes, zero all-gathers). It runs
        # in a CPU-only child, so the card stays with this process.
        import json as _json
        import os
        import subprocess
        import sys

        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
        ).strip()
        out = subprocess.run(
            [sys.executable, "-m", "linops_tpu.parallel.scaling_bench"],
            capture_output=True,
            text=True,
            timeout=900,
            env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        detail["scaling"] = _json.loads(out.stdout.strip().splitlines()[-1])

    section("spmv_bf16", sec_spmv_bf16)
    section("spmv_8x128_gbs", sec_spmv8)
    section("csr", sec_csr)
    section("stencil", sec_stencil)
    section("chain", sec_chain)
    section("lbfgs", sec_lbfgs)
    section("stress", sec_stress)
    section("multirhs", sec_multirhs)
    section("solvers", sec_solvers)
    section("scaling", sec_scaling)
    section("lobpcg", sec_lobpcg)
    def sec_reorder():
        # opSparse(reorder="rcm"): a scrambled banded matrix recovers the
        # banded BSR path through the RCM similarity sandwich
        # (sparse/reorder.py)
        import scipy.sparse as sps

        nrc, bwrc = 1 << 16, 56
        diags = [rng.standard_normal(nrc - abs(k)).astype(np.float32)
                 for k in range(-bwrc, bwrc + 1)]
        Arc = sps.diags(diags, range(-bwrc, bwrc + 1), format="csr")
        sig = rng.permutation(nrc)
        Asc = Arc[sig][:, sig].tocsr()
        t0 = time.perf_counter()
        op_re = lo.opSparse(Asc, format="auto", reorder="rcm",
                            dtype=jnp.float32)
        detail["reorder_rcm_pack_s"] = round(time.perf_counter() - t0, 2)
        detail["reorder_rcm_inner"] = type(op_re.inner).__name__
        t_re = _marginal_apply_time(op_re, jnp.ones((nrc,), jnp.float32),
                                    reps=2)
        detail["reorder_rcm_us_per_apply"] = round(t_re * 1e6, 1)
        detail["reorder_rcm_gnnz_per_s"] = round(Asc.nnz / t_re / 1e9, 2)
        blk = getattr(op_re.inner.data, "blocks", None)
        if blk is not None:
            detail["reorder_rcm_gbs"] = round(
                blk.size * blk.dtype.itemsize / t_re / 1e9, 1)

    def sec_auto_8m():
        # 8.4M-nnz unstructured matrix through format="auto"
        import warnings

        import scipy.sparse as sps

        na = 1 << 19
        counts = rng.poisson(16, na)
        nnza = int(counts.sum())
        indptr_a = np.zeros(na + 1, np.int64)
        np.cumsum(counts, out=indptr_a[1:])
        cols_a = rng.integers(0, na, nnza)
        order_a = np.lexsort((cols_a, np.repeat(np.arange(na), counts)))
        spA = sps.csr_matrix(
            (rng.standard_normal(nnza).astype(np.float32),
             cols_a[order_a].astype(np.int32), indptr_a.astype(np.int64)),
            shape=(na, na))
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as wlist:
            warnings.simplefilter("always")
            opA8 = lo.opSparse(spA, format="auto")
        detail["auto_8m_nnz"] = nnza
        detail["auto_8m_format"] = type(opA8).__name__
        detail["auto_8m_pack_s"] = round(time.perf_counter() - t0, 2)
        detail["auto_8m_warned"] = any(
            "pack" in str(w.message) for w in wlist)
        va = jnp.ones((na,), dtype)
        tA8 = _marginal_apply_time(opA8, va, reps=2)
        detail["auto_8m_gnnz_per_s"] = round(nnza / tA8 / 1e9, 3)

    section("routed_unstructured", sec_routed_unstructured)
    section("routed_multichunk", sec_routed_multichunk)
    section("auto_8m", sec_auto_8m)
    section("permutation", sec_permutation)
    section("reorder", sec_reorder)
    section("csr_unstructured", sec_csr_unstructured)

    _emit(headline, detail)


if __name__ == "__main__":
    main()
