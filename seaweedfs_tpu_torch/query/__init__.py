"""S3-Select-style queries over stored objects (reference weed/query/).

`execute_select` runs the reference's JSON-lines subset: projection and a
single WHERE predicate over `SELECT ... FROM S3Object[...] WHERE ...`,
wired into the S3 gateway's `POST /bucket/key?select&select-type=2`.

The port's copy of seaweedfs_tpu/query.
"""

from seaweedfs_tpu_torch.query.select import SelectError, execute_select, parse_select

__all__ = ["SelectError", "execute_select", "parse_select"]
