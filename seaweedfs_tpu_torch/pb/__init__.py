"""Protocol contracts of the port's gRPC surfaces.

``volume_server_pb2.py`` is a byte-for-byte copy of the JAX package's
generated module (seaweedfs_tpu/pb/volume_server_pb2.py, from its
volume_server.proto): the same serialized descriptor under the same file
and package names, so the two load side by side in one process and hand
back the same message classes.  Do not regenerate or edit it here: a
changed descriptor under the same file name would clash in protobuf's
default pool.  Service stubs and handlers are reflected at run time by
``seaweedfs_tpu_torch.rpc``.
"""
