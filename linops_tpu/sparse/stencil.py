"""N-D grid stencil operator — shifts in grid layout, not vector layout.

For operators on a d-dimensional grid, shifts of the FLATTENED vector
need per-row boundary masks; reshaping to the grid and shifting along the
axes lets XLA fuse everything into one pass over x and y. The operator
interface stays 1-D (vectors of length prod(grid), row-major);
reshapes are free under jit.

Coefficients per offset are either scalars (constant stencil — minimal HBM
traffic: read x, write y) or full grid arrays (spatially varying).
Boundary semantics: zero beyond the grid edge (Dirichlet-style coupling
matrix), matching ``laplacian_2d``.

Distribution: shard the vector over leading grid rows (GSPMD) — XLA
inserts the halo collectives for the axis-0 shifts automatically
(tests/test_parallel.py::test_sharded_stencil).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.base import LinearOperator, LinearOperatorException, register_operator

__all__ = ["StencilOperator", "Stencil2DOperator", "opStencil2D", "opStencil"]


def _shift_nd(x, offset: Tuple[int, ...]):
    """x[i + offset] with zero fill; static pads/slices per axis, fused."""
    for ax, o in enumerate(offset):
        if o == 0:
            continue
        pads = [(0, 0)] * x.ndim
        idx = [slice(None)] * x.ndim
        if o > 0:
            idx[ax] = slice(o, None)
            pads[ax] = (0, o)
        else:
            idx[ax] = slice(None, o)
            pads[ax] = (-o, 0)
        x = jnp.pad(x[tuple(idx)], pads)
    return x


class StencilOperator(LinearOperator):
    """Square operator on a d-dimensional grid defined by offset/coefficient
    pairs: ``(A x)[i] = Σ_k c_k[i] · x[i + off_k]`` (zero beyond edges)."""

    _fields_children = ("coeffs",)
    _fields_aux = ("_grid", "_offsets", "_scalar_coeffs", "_is_sym")

    def __init__(self, grid_shape: Sequence[int], offsets, coeffs):
        super().__init__()
        self._grid = tuple(int(g) for g in grid_shape)
        d = len(self._grid)
        offs = []
        for off in offsets:
            off = tuple(int(o) for o in (off if isinstance(off, (tuple, list)) else (off,)))
            if len(off) != d:
                raise LinearOperatorException(
                    f"offset {off} does not match grid rank {d}"
                )
            offs.append(off)
        self._offsets = tuple(offs)
        coeffs = jnp.asarray(coeffs)
        if coeffs.ndim == 1:
            if coeffs.shape[0] != len(self._offsets):
                raise LinearOperatorException("need one coefficient per offset")
            self._scalar_coeffs = True
        elif coeffs.shape == (len(self._offsets),) + self._grid:
            self._scalar_coeffs = False
        else:
            raise LinearOperatorException(
                "coeffs must be (k,) scalars or (k, *grid) arrays"
            )
        self.coeffs = coeffs
        self._is_sym = self._compute_sym()

    @property
    def nrow(self):
        return math.prod(self._grid)

    @property
    def ncol(self):
        return math.prod(self._grid)

    @property
    def grid_shape(self):
        return self._grid

    @property
    def dtype(self):
        return self.coeffs.dtype

    def _compute_sym(self) -> bool:
        """Static symmetry check at construction: every offset's mirror must
        carry the same scalar coefficient. Varying coefficients or traced
        construction default to False (flags key the jit cache)."""
        if not self._scalar_coeffs:
            return False
        try:
            vals = np.asarray(self.coeffs)
        except Exception:
            return False
        table = {o: i for i, o in enumerate(self._offsets)}
        for off, i in table.items():
            j = table.get(tuple(-o for o in off))
            if j is None or vals[i] != vals[j]:
                return False
        return True

    @property
    def symmetric(self):
        return self._is_sym

    @property
    def hermitian(self):
        return self._is_sym and not jnp.iscomplexobj(self.coeffs)

    def _prod(self, v):
        x = v.reshape(self._grid)
        y = jnp.zeros_like(x)
        for i, off in enumerate(self._offsets):
            y = y + self.coeffs[i] * _shift_nd(x, off)
        return y.reshape(-1)

    def _tprod(self, u):
        x = u.reshape(self._grid)
        y = jnp.zeros_like(x)
        for i, off in enumerate(self._offsets):
            y = y + _shift_nd(self.coeffs[i] * x, tuple(-o for o in off))
        return y.reshape(-1)

    def _ctprod(self, w):
        if not jnp.iscomplexobj(self.coeffs):
            return self._tprod(w)
        x = w.reshape(self._grid)
        y = jnp.zeros_like(x)
        for i, off in enumerate(self._offsets):
            y = y + _shift_nd(jnp.conj(self.coeffs[i]) * x, tuple(-o for o in off))
        return y.reshape(-1)

    def apply_matrix(self, M, mode: str = "N"):
        return jax.vmap(lambda col: self.apply(col, mode), in_axes=1, out_axes=1)(M)

    def _name(self):
        return (
            f"Stencil operator ({len(self._offsets)} points, "
            f"{'x'.join(map(str, self._grid))})"
        )


register_operator(StencilOperator)


class Stencil2DOperator(StencilOperator):
    """2-D convenience wrapper: ``Stencil2DOperator(nx, ny, offsets, coeffs)``."""

    def __init__(self, nx: int, ny: int, offsets, coeffs):
        super().__init__((nx, ny), offsets, coeffs)


register_operator(Stencil2DOperator)


def opStencil2D(nx, ny, offsets, coeffs) -> Stencil2DOperator:
    return Stencil2DOperator(nx, ny, offsets, coeffs)


def opStencil(grid_shape, offsets, coeffs) -> StencilOperator:
    return StencilOperator(grid_shape, offsets, coeffs)
