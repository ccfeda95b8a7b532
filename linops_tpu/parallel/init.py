"""Multi-host runtime initialization (SURVEY.md §5 'Distributed
communication backend': the NCCL/MPI-equivalent is the JAX distributed
runtime + NCCL collectives).

On several hosts each process runs the same program;
``initialize_distributed()`` wires them into one JAX runtime so
``jax.devices()`` spans every host and every mesh built by
``make_mesh`` / ``shard_operator`` / ``banded_partition`` addresses all
devices.
"""

from __future__ import annotations

from typing import Optional

import jax

__all__ = ["initialize_distributed", "runtime_info"]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the JAX distributed runtime (idempotent).

    With no arguments, relies on the cluster environment's auto-detection
    (JAX finds none on a bare GPU machine: pass ``coordinator_address``,
    ``num_processes`` and ``process_id`` there).
    Call once per host before building meshes.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        # jax has used both messages across versions ("already
        # initialized" / "should only be called once") — caught by the
        # 2-process integration test (tests/test_distributed_init.py)
        msg = str(e).lower()
        if "already initialized" in msg or "called once" in msg:
            return
        raise


def runtime_info() -> dict:
    """Topology summary for logging/diagnostics."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
        "platform": jax.devices()[0].platform,
    }
