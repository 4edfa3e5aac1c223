"""Partition→broker assignment by rendezvous (highest-random-weight)
hashing.

The reference keeps explicit partition assignment maps in its
pub_balancer (weed/mq/pub_balancer/) and rebalances with RPCs; here
ownership is a pure function of (topic, partition, live broker set) —
every broker computes the same answer from the master's registry, no
assignment state exists to replicate, and a broker joining or leaving
moves only the partitions that hash to it.

The port's copy of seaweedfs_tpu/mq/balancer.py.
"""

from __future__ import annotations

import hashlib


def rendezvous_score(broker: str, topic_key: str, partition: int) -> int:
    h = hashlib.blake2b(
        f"{broker}|{topic_key}|{partition}".encode(), digest_size=8
    )
    return int.from_bytes(h.digest(), "big")


def partition_owner(
    brokers: list[str], namespace: str, name: str, partition: int
) -> str | None:
    """The live broker owning this partition; None with no brokers."""
    if not brokers:
        return None
    topic_key = f"{namespace}/{name}"
    return max(
        sorted(brokers),  # sort first: ties break identically everywhere
        key=lambda b: rendezvous_score(b, topic_key, partition),
    )


def partition_replicas(
    brokers: list[str], namespace: str, name: str, partition: int, n: int = 2
) -> list[str]:
    """The top-``n`` brokers in rendezvous order: [owner, successor, ...].

    The successor list IS the takeover order — when the owner dies the
    highest surviving scorer becomes the new owner — so replicating the
    log to the successors puts the bytes exactly where ownership lands
    next (the durability contract of the reference's filer-backed logs,
    weed/mq/logstore/, achieved broker-to-broker)."""
    topic_key = f"{namespace}/{name}"
    ranked = sorted(
        sorted(brokers),  # tie-break identically everywhere
        key=lambda b: rendezvous_score(b, topic_key, partition),
        reverse=True,
    )
    return ranked[: max(1, n)]


def group_coordinator(
    brokers: list[str], namespace: str, name: str, group: str
) -> str | None:
    """The live broker coordinating this consumer group — same
    rendezvous design as partition ownership (the reference elects a
    sub_coordinator on its balancer-lock holder; here coordination is a
    pure function of the live broker set)."""
    if not brokers:
        return None
    key = f"{namespace}/{name}/group/{group}"
    return max(sorted(brokers), key=lambda b: rendezvous_score(b, key, 0))


def hash_key_to_partition(key: bytes, partition_count: int) -> int:
    if partition_count <= 1:
        return 0
    h = hashlib.blake2b(key, digest_size=4)
    return int.from_bytes(h.digest(), "big") % partition_count
