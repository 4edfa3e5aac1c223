"""Cluster membership: master HA (Raft or lease election) + node registry.

The port's copy of seaweedfs_tpu/cluster (reference
weed/server/raft_server.go, raft_hashicorp.go, weed/cluster/): masters
elect a leader and every other component follows it via the ``leader``
field of HeartbeatResponse; filers, brokers and other node types register
in a generic typed registry on the leader.

Two HA modes, as in the JAX package:
  * ``raft`` (cluster/raft.py): elections with terms, a replicated log
    carrying sequence watermarks and membership, snapshots, and partition
    tolerance (minority leaders cannot commit).
  * ``lease`` (cluster/election.py): lease-style liveness probing; the
    lowest-addressed live master leads.

Not ported: the telemetry collector and its server (``telemetry.py``,
``telemetry_server.py``).
"""

from seaweedfs_tpu_torch.cluster.election import LeaderElection
from seaweedfs_tpu_torch.cluster.raft import HttpRaftTransport, RaftNode
from seaweedfs_tpu_torch.cluster.registry import ClusterNode, ClusterRegistry

__all__ = [
    "ClusterNode",
    "ClusterRegistry",
    "HttpRaftTransport",
    "LeaderElection",
    "RaftNode",
]
