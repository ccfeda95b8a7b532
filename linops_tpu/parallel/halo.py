"""Halo-exchange row-partitioned operators (banded / block-banded SpMV).

SURVEY.md §2.3 'Distributed operator layer' / §5 'long-context analogue':
the operator's rows are partitioned across the mesh; each device owns a
row slab and needs only its own x segment plus ``halo`` entries from each
neighbor. The apply is an explicit ``shard_map`` program:

  1. kick off ``ppermute`` of the boundary segments to both neighbors
     (over NVLink between GPUs),
  2. compute the interior contribution with the local x segment while the
     exchange is in flight (XLA schedules the collective asynchronously),
  3. add the halo contributions once the segments arrive.

This is the structured-sparsity fast path; unstructured sparse matrices
with general coupling use ``shard_operator`` (GSPMD all-gather) instead.
Non-periodic boundaries are handled by zero halo slabs at the ends.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
from ..core.precision import pmatmul
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from ..core.base import LinearOperator, LinearOperatorException, register_operator

__all__ = ["HaloPartitionedOperator", "banded_partition"]


def _halo_matvec(A_int, A_left, A_right, x_local, axis: str):
    """One device's slab apply with neighbor exchange.

    A_int: (m_local, m_local) coupling to own x segment
    A_left/A_right: (m_local, h) coupling to the last/first h entries of the
    left/right neighbor's segment (zero rows at the chain ends).
    """
    p = lax.axis_index(axis)
    n_dev = lax.axis_size(axis)
    h = A_left.shape[1]

    # boundary segments travel while the interior matvec computes
    from_left = lax.ppermute(
        x_local[-h:], axis, [(i, (i + 1) % n_dev) for i in range(n_dev)]
    )
    from_right = lax.ppermute(
        x_local[:h], axis, [(i, (i - 1) % n_dev) for i in range(n_dev)]
    )

    y = pmatmul(A_int, x_local)  # overlap: no dependence on the permutes

    # mask the wrapped-around ends (non-periodic boundary)
    from_left = jnp.where(p == 0, 0.0, from_left)
    from_right = jnp.where(p == n_dev - 1, 0.0, from_right)
    return y + pmatmul(A_left, from_left) + pmatmul(A_right, from_right)


def _halo_transpose_body(A_int, A_left, A_right, u_local, *, axis: str):
    p = lax.axis_index(axis)
    n_dev = lax.axis_size(axis)
    h = A_left.shape[1]
    y = pmatmul(A_int.T, u_local)
    # contribution of u_local through A_left lands on the LEFT neighbor's
    # tail; through A_right on the right neighbor's head.
    to_left = pmatmul(A_left.T, u_local)  # (h,)
    to_right = pmatmul(A_right.T, u_local)
    to_left = jnp.where(p == 0, 0.0, to_left)
    to_right = jnp.where(p == n_dev - 1, 0.0, to_right)
    recv_r = lax.ppermute(  # from right neighbor's to_left
        to_left, axis, [(i, (i - 1) % n_dev) for i in range(n_dev)]
    )
    recv_l = lax.ppermute(  # from left neighbor's to_right
        to_right, axis, [(i, (i + 1) % n_dev) for i in range(n_dev)]
    )
    y = y.at[-h:].add(recv_r)
    y = y.at[:h].add(recv_l)
    return y


@functools.lru_cache(maxsize=64)
def _halo_fwd_fn(mesh: Mesh, axis: str):
    """shard_map wrapper cached per (mesh, axis) — rebuilt closures on every
    eager apply would add per-call construction overhead."""
    return shard_map(
        functools.partial(_halo_matvec, axis=axis),
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None), P(axis)),
        out_specs=P(axis),
    )


@functools.lru_cache(maxsize=64)
def _halo_transpose_fn(mesh: Mesh, axis: str):
    return shard_map(
        functools.partial(_halo_transpose_body, axis=axis),
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None), P(axis)),
        out_specs=P(axis),
    )


class HaloPartitionedOperator(LinearOperator):
    """Square operator with rows partitioned over a 1-D mesh and coupling
    bounded by ``halo`` entries into each neighbor segment.

    ``A_int`` is (n_dev·m, m) stacked per-device interior slabs,
    ``A_left``/``A_right`` are (n_dev·m, h) neighbor-coupling slabs; all are
    sharded on dim 0. Symmetric iff declared (flags are the caller's
    contract, as in the reference constructors)."""

    _fields_children = ("A_int", "A_left", "A_right")
    _fields_aux = ("_n", "_halo", "_mesh", "_axis", "_symmetric", "_hermitian")

    def __init__(self, A_int, A_left, A_right, mesh: Mesh, *, axis: Optional[str] = None,
                 symmetric: bool = False, hermitian: bool = False):
        super().__init__()
        axis = axis or mesh.axis_names[0]
        n_dev = mesh.shape[axis]
        n = A_int.shape[0]
        if n % n_dev != 0:
            raise LinearOperatorException("rows must divide the mesh axis")
        if A_int.shape[1] != n // n_dev:
            raise LinearOperatorException(
                f"interior slab must be (n, n/n_dev); got {A_int.shape}"
            )
        if A_left.shape[0] != n or A_right.shape[0] != n:
            raise LinearOperatorException(
                "neighbor-coupling slabs must have the same row count as A_int"
            )
        if A_left.shape[1] != A_right.shape[1]:
            raise LinearOperatorException(
                f"left/right halo widths differ: {A_left.shape[1]} vs "
                f"{A_right.shape[1]}"
            )
        sh = NamedSharding(mesh, P(axis, None))
        self.A_int = jax.device_put(jnp.asarray(A_int), sh)
        self.A_left = jax.device_put(jnp.asarray(A_left), sh)
        self.A_right = jax.device_put(jnp.asarray(A_right), sh)
        self._n = n
        self._halo = A_left.shape[1]
        self._mesh = mesh
        self._axis = axis
        self._symmetric = bool(symmetric)
        self._hermitian = bool(hermitian)

    @property
    def nrow(self):
        return self._n

    @property
    def ncol(self):
        return self._n

    @property
    def dtype(self):
        return self.A_int.dtype

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return self._hermitian

    @property
    def halo(self):
        return self._halo

    @property
    def mesh(self):
        return self._mesh

    def _prod(self, v):
        fn = _halo_fwd_fn(self._mesh, self._axis)
        return fn(self.A_int, self.A_left, self.A_right, v)

    def _tprod(self, u):
        """Transpose apply: the halo pattern transposes — own-interior
        transposed, plus this device's boundary rows feed the neighbors'
        couplings (SURVEY.md §7 hard part 5)."""
        fn = _halo_transpose_fn(self._mesh, self._axis)
        return fn(self.A_int, self.A_left, self.A_right, u)

    def _ctprod(self, w):
        if not jnp.iscomplexobj(self.A_int):
            return self._tprod(w)
        # Aᴴw = conj(Aᵀ conj(w)) — two fused elementwise conjs instead of
        # rebuilding a conjugated operator clone per apply; reuses the
        # cached transpose shard_map program.
        fn = _halo_transpose_fn(self._mesh, self._axis)
        return jnp.conj(fn(self.A_int, self.A_left, self.A_right, jnp.conj(w)))

    def _name(self):
        return f"Halo-partitioned operator (halo={self._halo})"


register_operator(HaloPartitionedOperator)


def banded_partition(A, mesh: Mesh, halo: Optional[int] = None, *, axis=None,
                     symmetric: bool = False, hermitian: bool = False):
    """Partition a banded (dense or numpy) square matrix into a
    HaloPartitionedOperator. ``halo`` defaults to the bandwidth; it must be
    ≤ n / n_devices. Raises if couplings extend beyond one neighbor."""
    A = np.asarray(A)
    n = A.shape[0]
    if A.shape[0] != A.shape[1]:
        raise LinearOperatorException("banded_partition requires a square matrix")
    axis = axis or mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    if n % n_dev != 0:
        raise LinearOperatorException("n must be divisible by the mesh size")
    m = n // n_dev

    if halo is None:
        r, c = np.nonzero(A)
        halo = int(np.abs(r - c).max()) if len(r) else 1
        halo = max(min(halo, m), 1)
    if halo > m:
        raise LinearOperatorException("halo exceeds the local segment size")

    A_int = np.zeros((n, m), A.dtype)
    A_left = np.zeros((n, halo), A.dtype)
    A_right = np.zeros((n, halo), A.dtype)
    for p in range(n_dev):
        rows = slice(p * m, (p + 1) * m)
        A_int[rows] = A[rows, p * m : (p + 1) * m]
        if p > 0:
            A_left[rows] = A[rows, p * m - halo : p * m]
        if p < n_dev - 1:
            A_right[rows] = A[rows, (p + 1) * m : (p + 1) * m + halo]
        # verify nothing couples beyond one neighbor
        mask = np.ones(n, bool)
        mask[max(p * m - halo, 0) : min((p + 1) * m + halo, n)] = False
        if np.any(A[rows][:, mask] != 0):
            raise LinearOperatorException(
                "matrix couples beyond one neighbor halo; increase halo or "
                "use shard_operator"
            )
    return HaloPartitionedOperator(
        A_int, A_left, A_right, mesh, axis=axis, symmetric=symmetric, hermitian=hermitian
    )
