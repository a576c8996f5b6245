"""Device mesh utilities.

The reference has no distributed backend at all (SURVEY.md §2.6 — grep finds
no MPI/NCCL/UCX); its inter-memory movement is OpenMP map clauses and CUDA
memcpy. Here the comm layer is `jax.sharding.Mesh` + `shard_map` with XLA
collectives (NCCL between GPUs: NVLink within a host, the network
between hosts).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def data_mesh(n_devices: Optional[int] = None, platform: Optional[str] = None,
              axis: str = "data") -> Mesh:
    """1-D mesh over available devices for batch data parallelism."""
    devs = jax.devices(platform) if platform else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def pipeline_mesh(n_devices: Optional[int] = None,
                  platform: Optional[str] = None, axis: str = "seq") -> Mesh:
    """1-D mesh for sequence-parallel column-stripe pipelining."""
    return data_mesh(n_devices, platform, axis=axis)


def grid_mesh(data: int, seq: int, platform: Optional[str] = None) -> Mesh:
    """2-D mesh: batch shards x sequence stripes (dp x sp)."""
    devs = jax.devices(platform) if platform else jax.devices()
    need = data * seq
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    return Mesh(np.array(devs[:need]).reshape(data, seq), ("data", "seq"))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         **kwargs) -> None:
    """Multi-host entry point (jax.distributed.initialize passthrough).

    On a multi-host cluster each host calls this before building meshes
    (after it, ``jax.devices()`` spans every host and the mesh helpers
    above build global meshes). Single-host runs skip it. Where JAX can
    detect the cluster from its environment (e.g. a Slurm allocation) the
    three arguments may be omitted; elsewhere give them explicitly::

        # every host, before any jax computation:
        from swtpu.dist.mesh import initialize_multihost, pipeline_mesh
        initialize_multihost()                  # cluster auto-detected
        # or, explicitly (e.g. plain GPU hosts):
        initialize_multihost(coordinator_address="host0:8476",
                             num_processes=4, process_id=RANK)
        mesh = pipeline_mesh()                  # now spans all hosts

    The reference has no analog — it never runs distributed.
    """
    explicit = {k: v for k, v in (("coordinator_address",
                                   coordinator_address),
                                  ("num_processes", num_processes),
                                  ("process_id", process_id))
                if v is not None}
    jax.distributed.initialize(**explicit, **kwargs)
