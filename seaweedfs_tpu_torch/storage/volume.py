"""Volume file naming and the not-found error (the port's copies of
seaweedfs_tpu/storage/volume.py's ``volume_file_name`` and
``NotFoundError``; the volume object itself is not ported)."""

from __future__ import annotations

import os
from pathlib import Path


class NotFoundError(KeyError):
    pass


def volume_file_name(directory: str | os.PathLike, collection: str, vid: int) -> str:
    base = f"{collection}_{vid}" if collection else str(vid)
    return str(Path(directory) / base)
