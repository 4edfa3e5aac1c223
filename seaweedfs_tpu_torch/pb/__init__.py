"""Protocol contracts of the port's gRPC surfaces.

``volume_server_pb2.py``, ``master_pb2.py`` and ``filer_pb2.py`` are
byte-for-byte copies of the JAX package's generated modules
(seaweedfs_tpu/pb/, from its volume_server.proto, master.proto and
filer.proto): the same serialized descriptor under the same file
and package names, so the two load side by side in one process and hand
back the same message classes.  Do not regenerate or edit it here: a
changed descriptor under the same file name would clash in protobuf's
default pool.  Service stubs and handlers are reflected at run time by
``seaweedfs_tpu_torch.rpc``.
"""
