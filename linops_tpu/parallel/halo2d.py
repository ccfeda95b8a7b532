"""2-D domain-decomposed 5-point stencil operator (grid halo exchange).

The 2-D extension of the banded 1-D halo (halo.py): the (ny, nx) grid is
tiled over a 2-D device mesh ``(gy, gx)``; each device owns an
``(ny/py, nx/px)`` tile, and one apply exchanges ONE-cell edge strips
with its four neighbors via ``ppermute`` (no corners needed for a
5-point stencil; Dirichlet zero at the global boundary), overlapping the
interior arithmetic while the strips are in flight. Exactly FOUR
collective-permutes per apply, zero all-gathers — the communication/
computation ratio is O((by + bx) / (by·bx)), so weak scaling is flat
until tiles stop covering the exchange latency.

The stencil is the constant-coefficient 5-point form

    y[i,j] = c·u[i,j] + n·u[i-1,j] + s·u[i+1,j] + w·u[i,j-1] + e·u[i,j+1]

(the single-device counterpart is ``ops/stencil.py``'s grid-layout
shifts; reference scope note: the reference has no distribution story at
all — SURVEY.md §2.3 'Distributed operator layer').
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from ..core.base import LinearOperator, LinearOperatorException, register_operator

__all__ = ["HaloStencil2DOperator", "stencil_partition_2d", "make_mesh2d"]


def make_mesh2d(py: int, px: int, axes=("gy", "gx"), devices: Optional[Sequence] = None) -> Mesh:
    """A (py, px) 2-D device mesh for grid domain decomposition."""
    if devices is None:
        devices = jax.devices()
    if py * px > len(devices):
        raise ValueError(f"requested {py}x{px} devices but only {len(devices)} available")
    return Mesh(np.array(devices[: py * px]).reshape(py, px), tuple(axes))


def _stencil_tile_apply(coeffs, u_flat, *, ay: str, ax: str, by: int, bx: int):
    """One device's (by, bx) tile apply with 4-neighbor edge exchange.
    The local segment arrives flat (the BLOCKED vector layout, see the
    class docstring) and reshapes to the tile for free."""
    u = u_flat.reshape(by, bx)
    pyi = lax.axis_index(ay)
    pxi = lax.axis_index(ax)
    ny_dev = lax.axis_size(ay)
    nx_dev = lax.axis_size(ax)
    c, cn, cs, cw, ce = (coeffs[k] for k in range(5))

    # kick off the four edge exchanges first; the interior term computes
    # while the strips are in flight
    from_north = lax.ppermute(
        u[-1:, :], ay, [(i, (i + 1) % ny_dev) for i in range(ny_dev)]
    )
    from_south = lax.ppermute(
        u[:1, :], ay, [(i, (i - 1) % ny_dev) for i in range(ny_dev)]
    )
    from_west = lax.ppermute(
        u[:, -1:], ax, [(i, (i + 1) % nx_dev) for i in range(nx_dev)]
    )
    from_east = lax.ppermute(
        u[:, :1], ax, [(i, (i - 1) % nx_dev) for i in range(nx_dev)]
    )

    y = c * u  # overlap: no dependence on the permutes

    # Dirichlet boundary: mask the wrapped-around strips at the grid edge
    from_north = jnp.where(pyi == 0, 0.0, from_north)
    from_south = jnp.where(pyi == ny_dev - 1, 0.0, from_south)
    from_west = jnp.where(pxi == 0, 0.0, from_west)
    from_east = jnp.where(pxi == nx_dev - 1, 0.0, from_east)

    y = y + cn * jnp.concatenate([from_north, u[:-1, :]], axis=0)
    y = y + cs * jnp.concatenate([u[1:, :], from_south], axis=0)
    y = y + cw * jnp.concatenate([from_west, u[:, :-1]], axis=1)
    y = y + ce * jnp.concatenate([u[:, 1:], from_east], axis=1)
    return y.reshape(-1)


@functools.lru_cache(maxsize=64)
def _halo2d_fn(mesh: Mesh, ay: str, ax: str, by: int, bx: int):
    return shard_map(
        functools.partial(_stencil_tile_apply, ay=ay, ax=ax, by=by, bx=bx),
        mesh=mesh,
        in_specs=(P(), P((ay, ax))),
        out_specs=P((ay, ax)),
    )


class HaloStencil2DOperator(LinearOperator):
    """Constant-coefficient 5-point stencil on an (ny, nx) grid, tiled
    over a 2-D mesh. ``coeffs`` is the length-5 array ``[c, n, s, w, e]``
    — a pytree leaf, so coefficient VALUES may be updated without
    recompiles; the symmetry flags are fixed at construction, so an
    update must preserve the symmetry PATTERN (n==s, w==e or not) —
    build a fresh operator via :func:`stencil_partition_2d` to change it.

    Vectors use the BLOCKED (device-major) grid flattening — tile (p, q)
    of the grid occupies one contiguous segment — so the flat vector
    shards exactly over the joint mesh axes and an apply moves ONLY the
    four edge strips (a row-major flattening of a 2-D-tiled grid would
    force a full all-gather per apply to re-interleave). Convert with
    :meth:`grid_to_vec` / :meth:`vec_to_grid`; the layout is a host-side
    relabeling, never data movement at apply time.

    The transpose stencil swaps n<->s and w<->e, so every mode reuses the
    ONE cached shard_map program with permuted (and conjugated)
    coefficients — no second collective pattern needed."""

    _fields_children = ("coeffs",)
    _fields_aux = ("_ny", "_nx", "_mesh", "_ay", "_ax", "_symmetric", "_hermitian")

    def __init__(self, coeffs, ny: int, nx: int, mesh: Mesh, *, axes=None):
        super().__init__()
        coeffs = jnp.asarray(coeffs)
        if coeffs.shape != (5,):
            raise LinearOperatorException("coeffs must be the 5-vector [c, n, s, w, e]")
        axes = tuple(axes) if axes is not None else tuple(mesh.axis_names[:2])
        if len(axes) != 2:
            raise LinearOperatorException("need a 2-D mesh (two axis names)")
        py, px = mesh.shape[axes[0]], mesh.shape[axes[1]]
        if ny % py != 0 or nx % px != 0:
            raise LinearOperatorException(
                f"grid ({ny}, {nx}) must tile the mesh ({py}, {px}) evenly"
            )
        self.coeffs = coeffs
        self._ny = int(ny)
        self._nx = int(nx)
        self._mesh = mesh
        self._ay, self._ax = axes
        # flags from the concrete coefficients at construction (stored as
        # aux so they survive pytree rebuilds, like algebra.Sum)
        try:
            n_, s_, w_, e_ = (coeffs[k] for k in (1, 2, 3, 4))
            sym = bool(jnp.all(n_ == s_) and jnp.all(w_ == e_))
            real = not jnp.issubdtype(coeffs.dtype, jnp.complexfloating)
            herm = sym and (real or bool(jnp.all(jnp.isreal(coeffs))))
        except jax.errors.TracerBoolConversionError:
            sym = herm = False  # traced construction: flags are unknowable
        self._symmetric = sym
        self._hermitian = herm

    @property
    def nrow(self):
        return self._ny * self._nx

    ncol = nrow

    @property
    def dtype(self):
        return self.coeffs.dtype

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return self._hermitian

    @property
    def mesh(self):
        return self._mesh

    def _coeffs_for(self, mode: str):
        cf = self.coeffs
        if mode in ("T", "H"):
            cf = cf[jnp.asarray([0, 2, 1, 4, 3])]  # n<->s, w<->e
        if mode in ("H", "C") and jnp.issubdtype(cf.dtype, jnp.complexfloating):
            cf = jnp.conj(cf)
        return cf

    @property
    def _tiles(self):
        py, px = self._mesh.shape[self._ay], self._mesh.shape[self._ax]
        return py, px, self._ny // py, self._nx // px

    def grid_to_vec(self, U):
        """(ny, nx) grid -> blocked flat vector (the operator's layout)."""
        py, px, by, bx = self._tiles
        return jnp.asarray(U).reshape(py, by, px, bx).transpose(0, 2, 1, 3).reshape(-1)

    def vec_to_grid(self, v):
        """Blocked flat vector -> (ny, nx) grid."""
        py, px, by, bx = self._tiles
        return jnp.asarray(v).reshape(py, px, by, bx).transpose(0, 2, 1, 3).reshape(
            self._ny, self._nx)

    def apply(self, v, mode: str = "N"):
        if v.ndim != 1 or v.shape[0] != self.nrow:
            raise LinearOperatorException(
                f"shape mismatch: expected ({self.nrow},), got {v.shape} "
                "(matrices go through apply_matrix)"
            )
        py, px, by, bx = self._tiles
        fn = _halo2d_fn(self._mesh, self._ay, self._ax, by, bx)
        return fn(self._coeffs_for(mode), v)

    def _has_tprod(self):
        return True

    def _has_ctprod(self):
        return True

    def _name(self):
        return f"HaloStencil2D({self._ny}x{self._nx} over {dict(self._mesh.shape)})"


register_operator(HaloStencil2DOperator)


def stencil_partition_2d(coeffs, ny: int, nx: int, mesh: Mesh, *, axes=None):
    """Build a :class:`HaloStencil2DOperator` (e.g. the 2-D Dirichlet
    Laplacian: ``coeffs = [4, -1, -1, -1, -1]``)."""
    return HaloStencil2DOperator(coeffs, ny, nx, mesh, axes=axes)
