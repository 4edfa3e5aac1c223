"""Message queue: partitioned topics over append-only offset logs.

Counterpart of the reference's weed/mq/ (broker/,
pub_balancer/, logstore/): topics split into partitions; each partition
is an append-only offset log owned by exactly one broker; ownership is
derived by rendezvous hashing over the live broker set registered with
the master (no assignment state to replicate — the reference's
pub_balancer keeps explicit maps instead); sealed log segments tier into
columnar numpy archives (the Parquet analogue,
mq/logstore/log_to_parquet.go).

The port's copy of seaweedfs_tpu/mq/__init__.py.
"""

from seaweedfs_tpu_torch.mq.agent import GroupConsumer, MqClient
from seaweedfs_tpu_torch.mq.balancer import (
    group_coordinator,
    partition_owner,
    rendezvous_score,
)
from seaweedfs_tpu_torch.mq.broker import MqBroker
from seaweedfs_tpu_torch.mq.log_store import PartitionLog

__all__ = [
    "GroupConsumer",
    "MqBroker",
    "MqClient",
    "PartitionLog",
    "group_coordinator",
    "partition_owner",
    "rendezvous_score",
]
