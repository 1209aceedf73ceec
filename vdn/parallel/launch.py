"""Multi-host initialization (reference metric_depth/util/dist_helper.py:8-41
and dist_train.sh).

The reference wires NCCL ranks from SLURM/torchrun env vars; here the
equivalent is ``jax.distributed.initialize`` — afterwards ``jax.devices()``
spans every card of every host and the same mesh/psum code runs unchanged.

Usage on each host (nothing is autodetected without a cluster manager, so
give the coordinator, the process count and this process's id, or the
MASTER_ADDR/WORLD_SIZE/RANK env vars):

    from vdn.parallel.launch import initialize_distributed
    initialize_distributed("localhost:8476", num_processes=1, process_id=0)
    mesh = make_mesh(data=jax.device_count())
"""

from __future__ import annotations

import os
from typing import Optional

import jax

__all__ = ["initialize_distributed", "is_primary"]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Initialize multi-host JAX.  Arguments not given are read from
    SLURM-style env vars (MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK — the
    reference's wiring, dist_helper.py:14-29)."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '8476')}")
        num_processes = num_processes or int(
            os.environ.get("WORLD_SIZE", "1"))
        process_id = process_id or int(os.environ.get("RANK", "0"))
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def is_primary() -> bool:
    """rank-0 check (replaces the reference's `rank == 0` guards)."""
    return jax.process_index() == 0
