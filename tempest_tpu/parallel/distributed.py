"""Multi-host initialisation and mesh construction.

The reference is strictly single-process (SURVEY.md §2: ``Distributed`` is
declared but unused).  Here multi-host runs use JAX's standard bootstrap:
every host calls :func:`initialize` (coordinator address + process count from
arguments or the environment), then builds the same global mesh over all
devices; the sharded pipelines in ``parallel.sharded`` work unchanged because
they only speak in terms of the mesh axis.

Topology: the GPUs of one host are joined all to all by NVLink, so any
device order serves the ``"blocks"`` (time) axis equally — the mesh follows
the algorithm alone.  Across hosts the network is much slower than NVLink:
put *independent capture streams* (different antennas/frequencies) on the
cross-host dimension, so no halo crosses it.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["initialize", "global_mesh", "is_distributed"]

_initialized = False


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Bring up jax.distributed for a multi-host run.  Arguments default to
    the standard env vars (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID) or the cluster auto-detection built into JAX."""
    global _initialized
    if _initialized:
        return
    kwargs = {}
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr:
        kwargs["coordinator_address"] = addr
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    _initialized = True


def is_distributed() -> bool:
    return jax.process_count() > 1


def global_mesh(axis_name: str = "blocks") -> Mesh:
    """1-D mesh over *all* devices of *all* processes, in JAX's default
    device order."""
    return Mesh(np.array(jax.devices()), (axis_name,))
