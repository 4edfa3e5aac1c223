"""Replication: meta-event-driven mirroring of a filer tree.

The port's counterpart of the reference's weed/replication/ +
weed/command/filer_sync.go / filer_backup.go: a subscriber tails a source
filer's metadata event stream and applies each mutation to a
ReplicationSink — another filer cluster (filer.sync), a local directory
(filer.backup), or a notification bus fan-out.

The port's copy of seaweedfs_tpu/replication/__init__.py.
"""

from seaweedfs_tpu_torch.replication.replicator import Replicator
from seaweedfs_tpu_torch.replication.sink import (
    AzureSink,
    B2Sink,
    FilerSink,
    GcsSink,
    LocalSink,
    ReplicationSink,
    S3Sink,
    make_sink,
)
from seaweedfs_tpu_torch.replication.sync import FilerSyncer

__all__ = [
    "AzureSink",
    "B2Sink",
    "FilerSink",
    "GcsSink",
    "S3Sink",
    "make_sink",
    "FilerSyncer",
    "LocalSink",
    "ReplicationSink",
    "Replicator",
]
