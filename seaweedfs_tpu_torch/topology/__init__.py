"""Master-side cluster model of the port: DC -> rack -> node tree, volume
layouts and the EC shard map (the counterpart of seaweedfs_tpu/topology)."""

from seaweedfs_tpu_torch.topology.topology import DataNode, Topology  # noqa: F401
