"""Maintenance plane: automatic EC-encode, EC rebuild, vacuum and TTL
expiry; the port's copy of seaweedfs_tpu/admin.

Counterpart of the reference's admin server + worker fleet
(weed/admin/maintenance/maintenance_scanner.go:34, weed/worker/): a
scanner watches the cluster topology for volumes that should be
erasure-coded (≥N% full and write-quiet), rebuilt (shards missing on two
scans), vacuumed (garbage ratio over threshold) or expired (a TTL volume
older than its TTL), queues typed tasks, and workers claim and execute
them through the same gRPC surface the shell commands use — so EC encode
and vacuum happen with no human in the loop.

Three small pieces — TaskQueue (tasks.py), MaintenanceScanner
(scanner.py), Worker (worker.py) — glued by an HTTP/JSON claim-report API
(admin_server.py); workers drive the existing volume-server RPCs, so the
encode and the rebuild launch K1 in the volume servers, on their card.
The admin and the workers themselves never touch CUDA.
"""

from seaweedfs_tpu_torch.admin.admin_server import AdminServer
from seaweedfs_tpu_torch.admin.scanner import MaintenancePolicy, MaintenanceScanner
from seaweedfs_tpu_torch.admin.tasks import Task, TaskQueue, TaskState
from seaweedfs_tpu_torch.admin.worker import Worker

__all__ = [
    "AdminServer",
    "MaintenancePolicy",
    "MaintenanceScanner",
    "Task",
    "TaskQueue",
    "TaskState",
    "Worker",
]
