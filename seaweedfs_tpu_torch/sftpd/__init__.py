"""SFTP gateway over the filer.

Counterpart of the reference's weed/sftpd/: the file
operations ride the same WeedFS object the FUSE mount uses, and the SSH
transport binding (paramiko) is an optional adapter gated on import —
the same degradation pattern as mount.fuse_adapter, since paramiko is
an optional dependency.

The port's copy of seaweedfs_tpu/sftpd/__init__.py.
"""

from seaweedfs_tpu_torch.sftpd.sftp_adapter import paramiko_available, serve_sftp

__all__ = ["paramiko_available", "serve_sftp"]
