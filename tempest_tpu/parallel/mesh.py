"""Device-mesh helpers for the sharded pipelines.

The reference is a single-process, three-thread application (SURVEY.md §2
"parallelism strategies"); its multi-device generalisation distributes work over
a ``jax.sharding.Mesh``:

* axis ``"blocks"`` — time-block data parallelism: successive IQ blocks (or the
  frames inside one block) are sharded across chips, with overlap-save halo
  exchange so filter/frame state stays contiguous (the sequence-parallel
  analogue of ring attention's neighbour exchange).
* axis ``"modes"`` — hypothesis parallelism: candidate video modes are
  evaluated on different chips.

Multi-host entry is ``jax.distributed.initialize`` + the same mesh over all
processes' devices; tests exercise the identical code path on a virtual
8-device CPU mesh (``tests/conftest.py``).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["P", "NamedSharding", "make_mesh", "block_sharding", "replicated"]


def make_mesh(
    n_devices: int | None = None, axis_name: str = "blocks"
) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def block_sharding(mesh: Mesh, axis_name: str = "blocks") -> NamedSharding:
    """Shard the leading (time-block / frame / candidate) axis."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
