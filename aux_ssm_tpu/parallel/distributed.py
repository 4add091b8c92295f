"""Multi-host runtime initialisation (SURVEY §2.4: `jax.distributed` is the
first-class component the reference lacks).

On a multi-host cluster, call `initialize()` once per host process before
any device use; afterwards `jax.devices()` spans every host and every mesh built
by `parallel.mesh.make_mesh` is global. Chain/particle sharding, collective
resampling, and adaptation reductions then work unchanged — all
communication is expressed through NamedSharding/shard_map collectives, so
there is no separate multi-host code path.
"""
from typing import Optional

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None):
    """Initialise the distributed JAX runtime. The arguments are forwarded
    to `jax.distributed.initialize`; where no cluster manager describes the
    job, give all three (e.g. `coordinator_address="localhost:<port>"`)."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def is_multihost():
    return jax.process_count() > 1
