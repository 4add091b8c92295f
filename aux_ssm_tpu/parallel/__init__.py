"""Multi-chip execution layer — the genuinely new component relative to the
reference (which is single-XLA-client only; SURVEY §2.4).

Mesh axes and their roles:

  chains    — independent MCMC chains (primary scaling axis; embarrassingly
              parallel, delta adaptation stays chip-local, acceptance
              statistics aggregated with psum when requested)
  particles — cSMC particle populations sharded inside one chain
              (collective conditional resampling)
  batch     — independent LGSSM components (spatial-style models)

Everything builds on `jax.sharding.Mesh` + NamedSharding/shard_map with XLA
collectives; `jax.distributed.initialize` for multi-host.
"""

from .mesh import make_mesh, local_mesh
from .chains import shard_chains, run_sharded_chains
from .batch import (shard_batched_lgssm, shard_time_major,
                    batch_sharded_kernel)

__all__ = ["make_mesh", "local_mesh", "shard_chains", "run_sharded_chains",
           "shard_batched_lgssm", "shard_time_major", "batch_sharded_kernel"]
