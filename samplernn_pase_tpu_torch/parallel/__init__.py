"""Parallelism: the device mesh and its sharding rules
(``parallel.mesh``), as ``samplernn_pase_tpu.parallel``, and the spawning
of ranks (``parallel.launch``), the port's counterpart of the reference's
virtual CPU devices."""

from samplernn_pase_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    replicated,
    shard_params,
)
