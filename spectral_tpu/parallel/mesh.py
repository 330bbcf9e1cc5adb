"""Device-mesh helpers.

The reference is strictly single-process (SURVEY.md §2: no multiprocessing /
threading / IPC anywhere); scale-out here is jax.sharding over the local
devices: batch ('data') and frame-block ('time') axes, with XLA inserting
collectives as needed. A virtual CPU mesh
(``--xla_force_host_platform_device_count=N``) stands in for multi-chip
hardware in tests and dry runs.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",)) -> Mesh:
    """Build a mesh over the available devices.

    Default: all devices on one 'data' axis. shape=(d, t) with
    axis_names=('data', 'time') splits them 2-D.
    """
    devs = jax.devices()
    if shape is None:
        shape = (len(devs),)
    n = int(np.prod(shape))
    if n > len(devs):
        raise ValueError(f"mesh shape {shape} needs {n} devices, "
                         f"have {len(devs)}")
    # plain device order: the cards of one host are joined all to all, so
    # no placement puts an axis on faster links than another
    return Mesh(np.array(devs[:n]).reshape(shape), tuple(axis_names))


def batch_sharding(mesh: Mesh, ndim: int, batch_axis: str = "data"
                   ) -> NamedSharding:
    """Shard the leading dimension over `batch_axis`, replicate the rest."""
    return NamedSharding(mesh, P(batch_axis, *([None] * (ndim - 1))))
