"""Servers of the port (the counterpart of seaweedfs_tpu/server): the volume
server's EC gRPC service and the EC shard locator it reads through."""
