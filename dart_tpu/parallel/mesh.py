"""Mesh construction and multi-host initialisation.

Single-host: `make_mesh()` (re-exported from `dart_tpu.parallel.sweep`) lays
a 1-D `scenario` axis over local devices; everything in the framework shards
along named mesh axes, so multi-host is the SAME code over a bigger mesh:

    from dart_tpu.parallel.mesh import init_distributed, global_mesh
    init_distributed()            # once per process, before device use
    mesh = global_mesh()          # all devices across all hosts

Collectives (`psum` sweep aggregates, `pmean` PPO gradients) then ride the
device interconnect within a host and the network across hosts — the
multi-node story the reference
does not have (SURVEY.md section 2.6: "no multi-node anything").
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh

from dart_tpu.parallel.sweep import make_mesh  # noqa: F401  (re-export)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialise jax.distributed from args or the standard env variables
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID). Returns
    True when running multi-process, False for the single-host fallback."""
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr is None and num_processes is None:
        return False
    jax.distributed.initialize(
        coordinator_address=addr,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_count() > 1


def global_mesh(axis: str = "scenario") -> Mesh:
    """1-D mesh over every device of every participating host."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def local_batch_slice(global_size: int) -> slice:
    """The shard of a globally-sized batch this process should materialise
    (for host-sharded data feeding under multi-host execution)."""
    per = global_size // jax.process_count()
    start = per * jax.process_index()
    return slice(start, start + per)
