"""Device-mesh construction and multi-host initialization.

The reference has no distributed layer at all (one Streamlit process, SURVEY.md §5
"Distributed communication backend: absent"); this module is the JAX-native
equivalent mandated by BASELINE.json:5 — paths shard across devices through XLA
collectives, not a message-passing port.

Axes:
- ``paths`` — the embarrassingly-parallel Monte-Carlo axis (data parallel).
- ``cand`` — candidate-portfolio axis for the weight search (optional 2nd axis).

Variance then shrinks linearly with the device count: each device owns an independent
counter-addressed slice of the path space, and only O(bins + A^2) reduction
traffic crosses the interconnect per call.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mcport.config import MeshConfig

__all__ = ["make_mesh", "make_mesh_2d", "maybe_initialize_distributed", "P", "Mesh", "NamedSharding"]


def make_mesh(devices=None, config: MeshConfig = MeshConfig()) -> Mesh:
    """1-D mesh over all (or given) devices with the paths axis."""
    devices = jax.devices() if devices is None else list(devices)
    return Mesh(np.array(devices), (config.paths_axis,))


def make_mesh_2d(
    n_paths_axis: int | None = None, devices=None, config: MeshConfig = MeshConfig()
) -> Mesh:
    """(paths, cand) mesh. ``n_paths_axis`` defaults to all devices on paths
    (cand axis size 1); pass a divisor of the device count to split."""
    devices = jax.devices() if devices is None else list(devices)
    n = len(devices)
    p = n if n_paths_axis is None else n_paths_axis
    if n % p:
        raise ValueError(f"paths axis {p} does not divide device count {n}")
    arr = np.array(devices).reshape(p, n // p)
    return Mesh(arr, (config.paths_axis, config.cand_axis))


def maybe_initialize_distributed(**kwargs) -> bool:
    """Initialize JAX multi-host coordination when running under a multi-process
    launcher (several hosts). No-op (returns False) in single-process runs.

    The reference's analogue is nothing; this is the jax.distributed bootstrap
    required before any multi-host mesh is built.
    """
    import os

    if jax.process_count() > 1:
        return True  # already initialized by the launcher
    env = os.environ
    if "COORDINATOR_ADDRESS" in env or "JAX_COORDINATOR_ADDRESS" in env or kwargs:
        jax.distributed.initialize(**kwargs)
        return True
    return False
