"""S3-compatible gateway over the filer (reference weed/s3api/, 42k LoC:
bucket/object CRUD, ListObjects, multipart, SigV4 auth — the surface
subset clients like boto3/mc/warp actually exercise).

The port's copy of seaweedfs_tpu/s3/__init__.py.
"""

from seaweedfs_tpu_torch.s3.s3_server import S3ApiServer

__all__ = ["S3ApiServer"]
