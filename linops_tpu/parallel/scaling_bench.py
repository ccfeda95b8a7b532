"""Multi-device scaling harness.

Runs the distributed matvec-chain paths at 1 vs N devices on whatever
mesh is available (a virtual CPU mesh in the tests, the cards of one host
on a GPU machine):

- **halo**: explicit shard_map + ppermute banded partition
  (``parallel/halo.py``), WEAK scaling — the per-device slab size m stays
  fixed while n = m·P grows, matching the operator's (m², m·h) per-device
  work model. Asserts the compiled program contains EXACTLY 2
  ``collective-permute``s per apply and ZERO ``all-gather``s.
- **gspmd**: row-partitioned dense operator via ``shard_operator``, STRONG
  scaling at fixed n (per-device work = 2n²/P). The collective audit
  records what GSPMD inserts for the re-gather of the sharded iterate.

Efficiency is FLOPs-normalized per-device throughput vs the 1-device run
(ideal = 1.0), so the representation's work model can't over- or
under-credit the timing. Prints one JSON line. Usage (virtual mesh):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python -m linops_tpu.parallel.scaling_bench
"""

from __future__ import annotations

import json

import numpy as np


from ..utils.timing import marginal_chain_time as _chain_time  # noqa: E402


def _banded(n, band, rng, dtype):
    A = np.zeros((n, n), dtype)
    for kd in range(-band, band + 1):
        A += np.diag(rng.standard_normal(n - abs(kd)).astype(dtype), kd)
    return A


def scaling_report(n_devices: int = None, m_per_dev: int = 2048, band: int = 3) -> dict:
    """Measure both distributed paths, audit the collectives; returns the
    report dict (see module docstring for the scaling models)."""
    import jax
    import jax.numpy as jnp

    import linops_tpu as lo
    from ..utils.krylov import matvec_chain
    from .halo import banded_partition
    from .introspect import collective_counts
    from .mesh import make_mesh
    from .sharded import shard_operator

    if n_devices is None:
        n_devices = jax.device_count()
    rng = np.random.default_rng(0)
    dtype = np.float32
    report = {"n_devices": n_devices, "m_per_dev": m_per_dev, "band": band}

    def run_chain(op, v, iters):
        return matvec_chain(op, v, iters)

    run = jax.jit(run_chain, static_argnums=())

    # --- halo path: WEAK scaling (m fixed per device) ----------------------
    halo_t = {}
    halo_flops_per_dev = {}
    for n_dev_case, tag in ((1, "1dev"), (n_devices, "ndev")):
        n = m_per_dev * n_dev_case
        A = _banded(n, band, rng, dtype)
        mesh = make_mesh(n_dev_case)
        op = banded_partition(A, mesh)
        v = jnp.asarray(rng.standard_normal(n).astype(dtype))
        t = _chain_time(run, op, v)
        halo_t[tag] = t
        h = op.halo
        # per-device slab work: interior (m², always) + 2 neighbor couplings
        halo_flops_per_dev[tag] = 2 * (
            m_per_dev * m_per_dev + (2 * m_per_dev * h if n_dev_case > 1 else 0)
        )
        report[f"halo_us_per_apply_{tag}"] = round(t * 1e6, 1)
        if tag == "ndev":
            counts = collective_counts(lambda o, x: o.apply(x, "N"), op, v)
            report["halo_collectives_per_apply"] = counts
            if n_devices > 1:  # single-device programs elide collectives
                assert counts["collective-permute"] == 2, counts
                assert counts["all-gather"] == 0, counts
            report["halo_collectives_chain_body"] = collective_counts(
                lambda o, x: matvec_chain(o, x, 10), op, v
            )
    report["halo_weak_scaling_efficiency"] = round(
        (halo_flops_per_dev["ndev"] / halo_t["ndev"])
        / (halo_flops_per_dev["1dev"] / halo_t["1dev"]),
        3,
    )

    # --- halo2d grid decomposition: WEAK scaling (tile fixed) --------------
    from .halo2d import make_mesh2d, stencil_partition_2d

    py = next(d for d in range(int(n_devices ** 0.5), 0, -1) if n_devices % d == 0)
    px = n_devices // py
    by = bx = 512  # fixed per-device tile side (big enough that the tile
    # arithmetic is not dwarfed by the EMULATED collectives on the
    # virtual CPU mesh)
    h2_t = {}
    for (py_c, px_c), tag in (((1, 1), "1dev"), ((py, px), "ndev")):
        mesh2 = make_mesh2d(py_c, px_c)
        ny, nx = by * py_c, bx * px_c
        L2 = stencil_partition_2d(
            jnp.asarray([4.0, -1.0, -1.0, -1.0, -1.0], dtype), ny, nx, mesh2
        )
        v = jnp.asarray(rng.standard_normal(ny * nx).astype(dtype))
        t = _chain_time(run, L2, v)
        h2_t[tag] = t
        report[f"halo2d_us_per_apply_{tag}"] = round(t * 1e6, 1)
        if tag == "ndev":
            counts = collective_counts(lambda o, x: o.apply(x, "N"), L2, v)
            report["halo2d_mesh"] = [py, px]
            report["halo2d_collectives_per_apply"] = counts
            expected = 2 * int(py > 1) + 2 * int(px > 1)
            if expected:  # degenerate axes elide their permutes
                assert counts["collective-permute"] == expected, counts
                assert counts["all-gather"] == 0, counts
    # per-device work is constant (5 by bx): weak efficiency = t1 / tP
    report["halo2d_weak_scaling_efficiency"] = round(
        h2_t["1dev"] / h2_t["ndev"], 3
    )

    # --- GSPMD row partition: STRONG scaling (n fixed) ---------------------
    n = m_per_dev * n_devices
    A = _banded(n, band, rng, dtype)
    gs_t = {}
    for n_dev_case, tag in ((1, "1dev"), (n_devices, "ndev")):
        mesh = make_mesh(n_dev_case)
        op = shard_operator(lo.MatrixOperator(jnp.asarray(A)), mesh)
        v = jnp.asarray(rng.standard_normal(n).astype(dtype))
        t = _chain_time(run, op, v)
        gs_t[tag] = t
        report[f"gspmd_us_per_apply_{tag}"] = round(t * 1e6, 1)
        if tag == "ndev":
            report["gspmd_collectives_per_apply"] = collective_counts(
                lambda o, x: o.apply(x, "N"), op, v
            )
    # per-device work is 2n²/P: efficiency = t1 / (P · tP)
    report["gspmd_strong_scaling_efficiency"] = round(
        gs_t["1dev"] / (n_devices * gs_t["ndev"]), 3
    )
    return report


def main():
    import jax

    report = scaling_report()
    report["platform"] = jax.devices()[0].platform
    if report["platform"] == "cpu":
        report["virtual_mesh_note"] = (
            "all virtual devices share ONE physical CPU and collectives are "
            "emulated, so efficiency numbers here are structural lower "
            "bounds; the collective COUNTS are the portable contract"
        )
    print(json.dumps(report))


if __name__ == "__main__":
    main()
