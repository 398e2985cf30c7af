"""Multi-host setup (SURVEY.md §5 distributed-communication row).

The reference has no networking at all.  Here:
`jax.distributed.initialize()` for process bootstrap, then the SAME
shard_map code as single-host — the global mesh spans all processes, and
XLA routes the collectives between them.

The coordinator address, process count and process id are given
explicitly (or through COORDINATOR_ADDRESS); single-process runs skip
initialization and behave identically.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import jax
from jax.sharding import Mesh


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Initialize multi-host JAX if a cluster environment is present.

    Returns True when running multi-process.  Safe to call repeatedly and in
    single-process runs (no-op).

    NOTE: must run before anything touches the XLA backend (jax.devices,
    device_put, any computation) — including by THIS function: querying
    ``jax.process_count()`` up front would itself initialize the backend and
    make ``jax.distributed.initialize`` permanently impossible (found by
    tests/test_multihost.py; the round-1 version had exactly that bug).
    """
    env_says_cluster = "COORDINATOR_ADDRESS" in os.environ
    if not (coordinator or num_processes or env_says_cluster):
        return jax.process_count() > 1
    kw = {}
    if coordinator:
        kw["coordinator_address"] = coordinator
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    try:
        jax.distributed.initialize(**kw)
    except RuntimeError as e:     # already initialized: repeat call is a no-op
        print(f"jax.distributed.initialize skipped: {e}")
    return jax.process_count() > 1


def global_mesh(axis_names: Tuple[str, ...] = ("dp",),
                shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """Mesh over ALL devices of ALL processes (each process sees the global
    mesh; shard_map handles the per-process addressable subset)."""
    devs = np.array(jax.devices())
    if shape is not None:
        devs = devs.reshape(shape)
    elif len(axis_names) == 1:
        pass
    else:
        raise ValueError("multi-axis mesh needs an explicit shape")
    return Mesh(devs, axis_names)


def host_local_rows(height: int) -> Tuple[int, int]:
    """Contiguous image-row span owned by this process (for host-side frame
    assembly when each host writes its own tile of the output)."""
    p, n = jax.process_index(), jax.process_count()
    rows = height // n
    start = p * rows
    end = height if p == n - 1 else start + rows
    return start, end
