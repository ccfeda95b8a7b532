"""Device-mesh helpers for distributed operators.

The reference has no distribution story (SURVEY.md §2.1: no DP/TP/PP, no
NCCL/MPI); this layer is the new first-class component (SURVEY.md §2.3
'Distributed operator layer'): operators partitioned over a
``jax.sharding.Mesh``, with XLA inserting collectives from sharding
annotations (the scaling-book recipe: pick a mesh, annotate shardings, let
XLA do the rest).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "replicated", "row_sharding", "P", "NamedSharding", "Mesh"]


def make_mesh(
    n_devices: Optional[int] = None,
    axis: str = "shard",
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a 1-D device mesh over ``n_devices`` (default: all devices).

    The single axis (default name ``"shard"``) is the operator-partition
    axis: operator rows / vector segments are split along it.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices but only {len(devices)} available"
            )
        devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.array(devices), (axis,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharding(mesh: Mesh, axis: Optional[str] = None) -> NamedSharding:
    """Sharding that splits dim 0 across the mesh axis."""
    if axis is None:
        axis = mesh.axis_names[0]
    return NamedSharding(mesh, P(axis))
