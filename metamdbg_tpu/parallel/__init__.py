"""Multi-chip (mesh) production helpers.

The reference has no distributed runtime (OpenMP + disk partitions only,
SURVEY §2.11); here scale-out is a JAX device mesh: data-parallel read
batches and hash-routed sharded count tables (count_table.py).
`production_mesh()` is the single gate the pipeline uses to decide
whether a stage runs its mesh path.
"""

import logging
import os

log = logging.getLogger("metamdbg_tpu")

_DIST_INITIALIZED = False


def ensure_distributed():
    """Initialize jax.distributed when METAMDBG_TPU_DISTRIBUTED is set.

    MUST run before anything touches the XLA backend (jax.devices,
    device_put, ...). devwarm.init_backend() calls this first, so a
    pipeline run is ordered correctly; idempotent and a no-op without the
    env var."""
    global _DIST_INITIALIZED
    if not os.environ.get("METAMDBG_TPU_DISTRIBUTED") or _DIST_INITIALIZED:
        return
    import jax

    coord = os.environ.get("METAMDBG_TPU_COORDINATOR")
    if coord:  # explicit rendezvous (host:port); else JAX auto-detect
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(os.environ["METAMDBG_TPU_NUM_PROCESSES"]),
            process_id=int(os.environ["METAMDBG_TPU_PROCESS_ID"]))
    else:
        jax.distributed.initialize()
    _DIST_INITIALIZED = True
    log.info("jax.distributed initialized: process %d/%d",
             jax.process_index(), jax.process_count())


def production_mesh(axis: str = "data"):
    """The mesh production stages should shard over, or None.

    Returns a 1-axis mesh over all visible devices when >=2 are available
    (virtual CPU devices under xla_force_host_platform_device_count count
    too — that is the multi-chip test rig). Multi-host runs initialize
    `jax.distributed` first when METAMDBG_TPU_DISTRIBUTED is set (the
    coordinator address comes from the standard JAX env vars).
    """
    from ..utils import devwarm
    if devwarm.init_backend() is None:
        return None
    import jax
    import numpy as np
    from jax.sharding import Mesh

    devices = jax.devices()
    if len(devices) < 2:
        return None
    return Mesh(np.array(devices), (axis,))
