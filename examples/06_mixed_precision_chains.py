"""Precision tiers: f32-exact by default, bf16 storage for speed.

The library's contraction policy (core/precision.py) keeps f32 operators
f32-exact (a float32 matmul at default precision may run in TF32 on a
GPU). Users opt into the fast tier by STORING bf16 data, which halves the
bytes every apply streams.

Run: PYTHONPATH=.. python 06_mixed_precision_chains.py
"""

import jax
import numpy as np
import jax.numpy as jnp

import linops_tpu as lo
from linops_tpu.sparse.formats import BSR

rng = np.random.default_rng(0)
n = 8192
nbr = n // 128
blocks = jnp.asarray(rng.standard_normal((nbr, 4, 128, 128)).astype(np.float32))
cols = jnp.asarray(rng.integers(0, nbr, size=(nbr, 4)).astype(np.int32))

# f32 tier: exact applies (HIGHEST precision, free when bandwidth-bound)
op32 = lo.BSROperator(BSR(blocks=blocks, block_cols=cols, shape=(n, n)))

# bf16 tier: half the stored bytes, products accumulated in f32
op16 = lo.BSROperator(
    BSR(blocks=blocks.astype(jnp.bfloat16), block_cols=cols, shape=(n, n))
)

v = jnp.asarray(rng.standard_normal(n).astype(np.float32))

y32 = np.asarray(op32 @ v, dtype=np.float64)
y16 = np.asarray(op16 @ (v.astype(jnp.bfloat16)), dtype=np.float64)
rel = np.linalg.norm(y16 - y32) / np.linalg.norm(y32)
print(f"bf16 tier deviation from f32-exact: {rel:.2e} (~bf16 resolution)")

# Whole chains stay on device either way:
w32 = lo.matvec_chain(op32, v, 100)
w16 = lo.matvec_chain(op16, v.astype(jnp.bfloat16), 100)
print("chain outputs finite:", bool(jnp.all(jnp.isfinite(w32))),
      bool(jnp.all(jnp.isfinite(w16))))

# Power iteration on both tiers (the bf16 estimate carries compounded
# bf16 rounding — a few percent; use the f32 tier when the value matters)
lam32, _ = lo.power_iteration(op32, v, iters=60)
lam16, _ = lo.power_iteration(op16, v.astype(jnp.bfloat16), iters=60)
print(f"dominant |eigenvalue|: f32 {float(jnp.abs(lam32)):.4f}  "
      f"bf16 {float(jnp.abs(lam16)):.4f}")
