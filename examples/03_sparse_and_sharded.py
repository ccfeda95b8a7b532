"""Sparse operators and multi-chip sharding.

Run (virtual 8-device mesh on CPU):
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      PYTHONPATH=.. python 03_sparse_and_sharded.py
"""

import jax
import jax.numpy as jnp
import numpy as np

import linops_tpu as lo
from linops_tpu.parallel import make_mesh, shard_operator
from linops_tpu.parallel.halo import banded_partition

rng = np.random.default_rng(2)
n = 1024

# --- sparse formats ---------------------------------------------------------
A = (rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.02)).astype(np.float32)
S_csr = lo.opSparse(A, format="csr")
S_bsr = lo.opSparse(A, format="bsr")  # 8x128 blocks
v = jnp.asarray(rng.standard_normal(n).astype(np.float32))
print("csr nnz:", S_csr.nnz, " rel err csr vs bsr:",
      float(jnp.linalg.norm(S_csr * v - S_bsr * v) / jnp.linalg.norm(S_csr * v)))

# spectral norm of the sparse operator, all on device
lam, _ = lo.power_iteration(S_bsr.T @ S_bsr, v, iters=100)
print("||A||_2 ~", float(jnp.sqrt(lam.real)), " vs dense:", float(np.linalg.norm(A, 2)))

# --- sharding over a device mesh -------------------------------------------
if jax.device_count() >= 2:
    mesh = make_mesh(min(jax.device_count(), 8))
    # any operator graph row-partitions generically
    chain = 2.0 * (lo.LinearOperator(jnp.asarray(A)) @ lo.opDiagonal(jnp.abs(v) + 1))
    chain_sh = shard_operator(chain, mesh)
    out = lo.matvec_chain(chain_sh, v, 50)
    print("sharded chain finite:", bool(jnp.isfinite(out).all()))

    # banded operators use explicit halo exchange (ppermute)
    band = np.zeros((n, n), np.float32)
    for k in range(-3, 4):
        band += np.diag(rng.standard_normal(n - abs(k)).astype(np.float32), k)
    op = banded_partition(band, mesh)
    print("halo matvec rel err:",
          float(np.linalg.norm(np.asarray(op * v) - band @ np.asarray(v))
                / np.linalg.norm(band @ np.asarray(v))))
else:
    print("single device: skip sharding section")
