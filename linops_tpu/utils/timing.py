"""Chain timing shared by bench.py and the scaling bench.

A chain is timed at two iteration counts and the difference divided out
(the marginal method), which cancels per-call dispatch overhead.
"""

from __future__ import annotations

import time

import jax
import numpy as np

__all__ = ["marginal_chain_time"]


def marginal_chain_time(run, *args, iters_short=5, iters_long=55, reps=3):
    """Marginal seconds/iteration of ``run(*args, iters)``: median of
    repeated (long − short) deltas, each run ended by
    ``jax.block_until_ready``."""
    jax.block_until_ready(run(*args, iters_short))
    jax.block_until_ready(run(*args, iters_long))
    deltas = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(*args, iters_short))
        a = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(run(*args, iters_long))
        b = time.perf_counter() - t0
        deltas.append(b - a)
    return max(float(np.median(deltas)), 1e-9) / (iters_long - iters_short)
