"""Servers of the port (the counterpart of seaweedfs_tpu/server): the master,
the volume server (its EC gRPC service, normal-volume admin, shard copies
and heartbeats) and the EC shard locator it reads through."""
