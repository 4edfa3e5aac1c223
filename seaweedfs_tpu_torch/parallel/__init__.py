"""Multi-device parallelism: device meshes and sharded EC encode/rebuild,
the port of seaweedfs_tpu/parallel.

Erasure-coding striping across nodes becomes sharding across the devices
of a (shard, stripe) mesh; the JAX package's collectives become
device-to-device copies between per-position CUDA streams of one process
(parallel/mesh.py).
"""

from seaweedfs_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from seaweedfs_tpu_torch.parallel import distributed_ec  # noqa: F401, E402
