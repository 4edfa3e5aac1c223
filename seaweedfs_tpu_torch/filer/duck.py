"""Duck-typing seam over 'a filer-like thing'.

Several subsystems (credential store, remote-storage mounts) work
against either an in-process :class:`~seaweedfs_tpu_torch.filer.Filer`
(find_entry/create_entry/master_client) or a
:class:`~seaweedfs_tpu_torch.mount.filer_client.FilerClient`
(lookup/create/master).  These three helpers are the one place that
mapping lives.

The port's copy of seaweedfs_tpu/filer/duck.py.
"""

from __future__ import annotations


def find_entry(filer, path: str):
    if hasattr(filer, "find_entry"):
        return filer.find_entry(path)
    return filer.lookup(path)


def put_entry(filer, entry) -> None:
    if hasattr(filer, "create_entry"):
        filer.create_entry(entry)
    else:
        filer.create(entry)


def master_of(filer):
    return getattr(filer, "master_client", None) or getattr(filer, "master")


def list_all(filer, dir_path: str, page: int = 1000):
    """Paginate a directory fully — a single list call silently truncates
    at the store's default limit."""
    last = ""
    while True:
        if hasattr(filer, "list_entries"):
            batch = filer.list_entries(
                dir_path, start_file_name=last, limit=page
            )
        else:
            batch = filer.list(dir_path, limit=page, start_from=last)
        yield from batch
        if len(batch) < page:
            return
        last = batch[-1].name
