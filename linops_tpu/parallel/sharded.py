"""Sharded operators: partition any operator's arrays over a device mesh.

Design (SURVEY.md §2.3 'Distributed operator layer'): operators are pytrees,
so distribution = placing their array leaves with ``NamedSharding`` and
letting GSPMD partition every jitted apply, inserting collectives
(psum for contracted-over-sharded dims, all_gathers where layouts change).
This generalizes the reference's ``S`` storage-type kwarg — its single
device-placement axis (reference: src/constructors.jl:15) — to
(mesh, partition-spec) on every operator.

Default partition rules (overridable per class via ``_shard_child``):
  - 2-D leaves: rows split across the mesh axis (row-partitioned operator;
    forward apply needs no collective, adjoint apply psums)
  - 1-D leaves of operator dimension: split (diagonal operators)
  - scalars / small vectors: replicated
  - quasi-Newton memory ``(mem, n)``: split along n (each device holds its
    slice of every {s, y} pair; dots psum, axpys stay local)
"""

from __future__ import annotations

import warnings
from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.base import LinearOperator, Counters

__all__ = ["shard_operator", "operator_sharding_rule"]


def _default_spec(arr, axis: str):
    nd = getattr(arr, "ndim", None)
    if nd == 2:
        return P(axis, None)
    if nd == 1 and arr.shape[0] >= 2:
        return P(axis)
    return P()


def _qn_states():
    from ..qn.lbfgs import LBFGSState
    from ..qn.lsr1 import LSR1State

    return (LBFGSState, LSR1State)


def _sparse_formats():
    from ..sparse.formats import BSR, COO, CSR, ELL

    return COO, CSR, BSR, ELL


def _routing_programs():
    from ..sparse.routed import ReducePass, RoutedSpMV, RoutedTranspose

    return (RoutedSpMV, ReducePass, RoutedTranspose)


def _place(value, mesh: Mesh, axis: str, spec_fn):
    """Recursively place arrays inside operators / states / containers."""
    if isinstance(value, LinearOperator):
        return shard_operator(value, mesh, axis)
    if isinstance(value, _routing_programs()):
        # Clos routing programs are interdependent index structures — a
        # row split of their stage arrays is meaningless. Replicate whole.
        return jax.device_put(value, NamedSharding(mesh, P()))
    if isinstance(value, _qn_states()):  # QN ring-buffer state
        placed = [
            _place_leaf(getattr(value, f), mesh, axis, spec_fn, qn=True)
            for f in value._fields
        ]
        return type(value)(*placed)
    if isinstance(value, _sparse_formats()):
        return _place_sparse(value, mesh, axis)
    if hasattr(value, "_fields"):  # other NamedTuple containers: recurse
        placed = [_place(getattr(value, f), mesh, axis, spec_fn) for f in value._fields]
        return type(value)(*placed)
    if isinstance(value, (tuple, list)):
        seq = [_place(v, mesh, axis, spec_fn) for v in value]
        return type(value)(seq)
    return _place_leaf(value, mesh, axis, spec_fn)


def _place_sparse(data, mesh: Mesh, axis: str):
    """Partition rules for the sparse storage pytrees.

    - BSR: block-rows split across the mesh (row partition — forward apply
      gathers x blocks, adjoint psums), block_cols alongside.
    - ELL: rows split across the mesh (vals/cols together).
    - COO/CSR: the nnz axis is split (vals/rows/cols together); segment_sum
      over sharded segment ids psums partial row sums. ``indptr`` is
      replicated (it indexes full rows, not nnz shards).
    """
    COO, CSR, BSR, ELL = _sparse_formats()
    n_dev = mesh.shape[axis]

    def put(arr, spec):
        return jax.device_put(arr, NamedSharding(mesh, spec))

    if isinstance(data, ELL):
        nrow = data.vals.shape[0]
        if nrow % n_dev:
            warnings.warn(
                f"shard_operator: ELL row count {nrow} is not divisible by "
                f"the {n_dev}-device mesh axis; storage stays replicated"
            )
            spec = P()
        else:
            spec = P(axis, None)
        return ELL(vals=put(data.vals, spec), cols=put(data.cols, spec), shape=data.shape)

    if isinstance(data, BSR):
        nbrow = data.blocks.shape[0]
        if nbrow % n_dev:
            warnings.warn(
                f"shard_operator: BSR block-row count {nbrow} is not divisible "
                f"by the {n_dev}-device mesh axis; storage stays replicated "
                "(pad the block rows for a true row partition)"
            )
            spec_b, spec_c = P(), P()
        else:
            spec_b, spec_c = P(axis, None, None, None), P(axis, None)
        return BSR(
            blocks=put(data.blocks, spec_b),
            block_cols=put(data.block_cols, spec_c),
            shape=data.shape,
        )
    nnz_spec = P(axis) if data.nnz % n_dev == 0 else P()
    if data.nnz % n_dev:
        warnings.warn(
            f"shard_operator: nnz={data.nnz} not divisible by the {n_dev}-device "
            "mesh axis; sparse storage stays replicated"
        )
    if isinstance(data, CSR):
        return CSR(
            vals=put(data.vals, nnz_spec),
            cols=put(data.cols, nnz_spec),
            indptr=put(data.indptr, P()),
            rows=put(data.rows, nnz_spec),
            shape=data.shape,
        )
    return COO(
        vals=put(data.vals, nnz_spec),
        rows=put(data.rows, nnz_spec),
        cols=put(data.cols, nnz_spec),
        shape=data.shape,
    )


def _place_leaf(arr, mesh, axis, spec_fn, qn: bool = False):
    if arr is None or not hasattr(arr, "ndim"):
        return arr
    if qn:
        # (mem, n) memories: split the operator dimension n; replicate the
        # small per-pair scalars and the (mem, mem) Gram matrices.
        n_dev = mesh.shape[axis]
        is_memory = arr.ndim == 2 and arr.shape[1] != arr.shape[0]
        shard_it = is_memory and arr.shape[1] % n_dev == 0
        if is_memory and not shard_it:
            warnings.warn(
                f"shard_operator: QN memory dimension n={arr.shape[1]} is not "
                f"divisible by the {n_dev}-device mesh axis; the ring buffers "
                "stay REPLICATED (a silent perf cliff at scale — pad n to a "
                "multiple of the mesh size)"
            )
        spec = P(None, axis) if shard_it else P()
    else:
        spec = spec_fn(arr, axis)
    return jax.device_put(arr, NamedSharding(mesh, spec))


def operator_sharding_rule(op: LinearOperator):
    """The spec function used for ``op``'s own array leaves. Classes may
    override ``_shard_child(field, arr, axis) -> PartitionSpec``."""
    custom = getattr(type(op), "_shard_child", None)

    def spec_fn(arr, axis, _custom=custom, _op=op):
        if _custom is not None:
            return _custom(_op, arr, axis)
        return _default_spec(arr, axis)

    return spec_fn


def shard_operator(op: LinearOperator, mesh: Mesh, axis: Optional[str] = None):
    """Return a copy of ``op`` whose arrays are placed on ``mesh`` with
    row-partitioned shardings (recursing through composite graphs).

    Every subsequent jitted apply compiles to an SPMD program over the mesh.
    """
    if axis is None:
        axis = mesh.axis_names[0]
    spec_fn = operator_sharding_rule(op)
    cls = type(op)
    new = object.__new__(cls)
    for f in cls._fields_children:
        object.__setattr__(new, f, _place(getattr(op, f), mesh, axis, spec_fn))
    for f in cls._fields_aux:
        object.__setattr__(new, f, getattr(op, f))
    object.__setattr__(new, "_counters", Counters())
    return new
