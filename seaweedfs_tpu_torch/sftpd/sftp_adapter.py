"""paramiko binding for the SFTP gateway.

Counterpart of the reference's weed/sftpd/sftp_server.go (the SFTP
subsystem handlers mapping onto filer operations).  All filesystem
semantics live in :class:`~seaweedfs_tpu_torch.mount.weedfs.WeedFS`; this
module only translates paramiko's SFTPServerInterface calls, and imports
lazily so the rest of the package never needs an SSH stack.

The port's copy of seaweedfs_tpu/sftpd/sftp_adapter.py:
``paramiko_available`` and the refusal of :func:`serve_sftp` without
paramiko, with the JAX package's text naming the port's import path.
The SFTPServerInterface translation (the JAX package's
``_build_interface``) waits for a machine that has paramiko to test it
on (ROADMAP Queue A item 4).
"""

from __future__ import annotations

from seaweedfs_tpu_torch.mount.weedfs import WeedFS


def paramiko_available() -> bool:
    try:
        import paramiko  # noqa: F401

        return True
    except ImportError:
        return False


def serve_sftp(
    fs: WeedFS,
    host_key_path: str,
    *,
    ip: str = "127.0.0.1",
    port: int = 2022,
    users: dict[str, str] | None = None,
):
    """Accept SFTP sessions until interrupted.  Raises RuntimeError when
    paramiko is unavailable (the CLI surfaces this cleanly)."""
    try:
        import paramiko  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "SFTP needs the paramiko package (not shipped in this image); "
            "the filesystem layer itself is available via "
            "seaweedfs_tpu_torch.mount.WeedFS"
        ) from e
    raise NotImplementedError(
        "the SFTP subsystem's paramiko interface is not ported to "
        "seaweedfs_tpu_torch yet (ROADMAP Queue A item 4)")
