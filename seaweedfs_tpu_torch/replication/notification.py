"""Notification buses: fan metadata events out to external systems.

Counterpart of the reference's weed/notification/ (MessageQueue interface
in configuration.go + kafka/sqs/gcp/webhook backends).  In this framework
the bus interface is a single ``send(event_dict)``; shipped backends are
the ones that work with zero egress: a JSONL log file and a loopback
HTTP webhook.  Events are queued and delivered by a background worker so
filer mutations never block on a slow bus.  The port's copy of
seaweedfs_tpu/replication/notification.py; the ``mq://`` bus publishes
through the port's ``mq.MqClient``.
"""

from __future__ import annotations

import http.client
import json
import logging
import queue
import threading
from abc import ABC, abstractmethod
from urllib.parse import urlparse

from seaweedfs_tpu_torch.util import wlog


class NotificationBus(ABC):
    name = "abstract"

    @abstractmethod
    def send(self, event: dict) -> None: ...

    def close(self) -> None:
        pass


class LogFileBus(NotificationBus):
    """Append events as JSON lines (the debugging/audit bus)."""

    name = "log"

    def __init__(self, path: str):
        self._fh = open(path, "a")
        self._lock = threading.Lock()

    def send(self, event: dict) -> None:
        with self._lock:
            self._fh.write(json.dumps(event, separators=(",", ":")) + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            self._fh.close()


class WebhookBus(NotificationBus):
    """POST each event as JSON (reference notification/webhook/)."""

    name = "webhook"

    def __init__(self, url: str, timeout: float = 5.0):
        self.url = urlparse(url)
        self.timeout = timeout

    def send(self, event: dict) -> None:
        from seaweedfs_tpu_torch.util.http_pool import shared_pool

        # retries=False: the bus owns delivery retries; a transport-level
        # replay would hand receivers silent duplicates
        status, _body = shared_pool().request(
            f"{self.url.hostname}:{self.url.port or 80}",
            "POST",
            self.url.path or "/",
            body=json.dumps(event).encode(),
            headers={"Content-Type": "application/json"},
            timeout=self.timeout,
            retries=False,
        )
        if status >= 300:
            # a rejecting receiver must count as an error, not delivery
            raise IOError(f"webhook {self.url.geturl()}: HTTP {status}")


class MqBus(NotificationBus):
    """Publish events into the cluster's own message queue — the
    native bus (the reference's notification interface is literally its
    MessageQueue type; here the cluster's partitioned MQ is a first-class
    target, keyed by directory so one path's events stay ordered)."""

    name = "mq"

    def __init__(self, broker_address: str, topic: str = "filer-events"):
        from seaweedfs_tpu_torch.mq import MqClient

        self.client = MqClient(broker_address)
        self.topic = topic
        self._configured = False

    def send(self, event: dict) -> None:
        if not self._configured:
            # only a SUCCESSFUL configure sticks: a transient broker
            # outage here must not condemn every later publish to
            # "unknown topic" until the filer restarts
            self.client.configure_topic(self.topic, partitions=4)
            self._configured = True
        self.client.publish(
            self.topic,
            (event.get("directory") or "/").encode(),
            json.dumps(event, separators=(",", ":")).encode(),
        )


class KafkaBus(NotificationBus):
    """Kafka bus (reference notification/kafka/) — gated on a driver."""

    name = "kafka"

    def __init__(self, dsn: str, topic: str = "seaweedfs-filer"):
        try:
            import confluent_kafka  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "kafka notification bus needs the 'confluent_kafka' driver "
                "(not baked into this image): pip install confluent-kafka"
            ) from e
        import confluent_kafka

        host = urlparse(dsn).netloc or dsn
        self.topic = topic
        self.producer = confluent_kafka.Producer({"bootstrap.servers": host})

    def send(self, event: dict) -> None:
        self.producer.produce(
            self.topic,
            json.dumps(event).encode(),
            key=(event.get("directory") or "/").encode(),
        )
        self.producer.poll(0)

    def close(self) -> None:
        self.producer.flush(5)


class SqsBus(NotificationBus):
    """AWS SQS bus (reference notification/aws_sqs/) — gated on boto3."""

    name = "sqs"

    def __init__(self, queue_url: str):
        try:
            import boto3  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "sqs notification bus needs 'boto3' "
                "(not baked into this image): pip install boto3"
            ) from e
        import boto3

        self.queue_url = queue_url
        self.client = boto3.client("sqs")

    def send(self, event: dict) -> None:
        self.client.send_message(
            QueueUrl=self.queue_url, MessageBody=json.dumps(event)
        )


class GcpPubSubBus(NotificationBus):
    """GCP Pub/Sub bus (reference notification/google_pub_sub/) — gated
    on google-cloud-pubsub AND usable application credentials.  Spec:
    ``pubsub:projects/<project>/topics/<topic>``."""

    name = "pubsub"

    def __init__(self, topic_path: str):
        try:
            from google.cloud import pubsub_v1  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "pubsub notification bus needs the google-cloud-pubsub "
                "package (pip install google-cloud-pubsub)"
            ) from e
        try:
            self.publisher = pubsub_v1.PublisherClient()
        except Exception as e:  # noqa: BLE001 — DefaultCredentialsError
            raise RuntimeError(
                f"pubsub bus: no usable Google credentials ({e})"
            ) from e
        self.topic_path = topic_path
        self._lock = threading.Lock()
        self._pending: set = set()

    def send(self, event: dict) -> None:
        # publish() is async (returns a future): track it so close() can
        # flush in-flight messages, and surface failures through a done
        # callback — fire-and-forget silently dropped rejected publishes
        future = self.publisher.publish(
            self.topic_path,
            json.dumps(event).encode(),
            directory=event.get("directory") or "/",
        )
        with self._lock:
            self._pending.add(future)

        def _done(f):
            with self._lock:
                self._pending.discard(f)
            try:
                f.result()
            except Exception as e:  # noqa: BLE001 — broker/auth rejection
                logging.getLogger(__name__).warning(
                    "pubsub publish to %s failed: %s", self.topic_path, e
                )

        future.add_done_callback(_done)

    def close(self) -> None:
        """Flush: wait (bounded) for every in-flight publish before the
        filer drops the bus — a close() that returns with messages still
        queued client-side loses them on process exit.  One shared 10s
        deadline across ALL futures: a dead broker with N pending
        publishes must not stall shutdown for 10s x N."""
        import time as _time

        with self._lock:
            pending = list(self._pending)
        deadline = _time.monotonic() + 10.0
        for f in pending:
            try:
                f.result(timeout=max(0.0, deadline - _time.monotonic()))
            except Exception:  # noqa: BLE001  # weedlint: disable=W001 — publish failure already logged by the future's done-callback
                pass


def make_bus(spec: str) -> NotificationBus:
    """Bus factory for the filer's ``-notify`` flag / notification.toml:

    - ``log:/path/events.jsonl``
    - ``webhook:http://host/hook``
    - ``mq://broker:grpc_port/topic`` (this cluster's own MQ)
    - ``kafka://bootstrap:9092/topic`` (needs confluent_kafka)
    - ``sqs:https://sqs...`` (needs boto3)
    - ``pubsub:projects/p/topics/t`` (needs google-cloud-pubsub)
    """
    scheme, _, rest = spec.partition(":")
    if scheme == "log":
        return LogFileBus(rest)
    if scheme == "webhook":
        return WebhookBus(rest)
    if scheme == "mq":
        u = urlparse(spec)
        topic = (u.path or "/").lstrip("/") or "filer-events"
        return MqBus(u.netloc, topic)
    if scheme == "kafka":
        u = urlparse(spec)
        return KafkaBus(u.netloc, (u.path or "/").lstrip("/") or "seaweedfs-filer")
    if scheme == "sqs":
        return SqsBus(rest)
    if scheme == "pubsub":
        return GcpPubSubBus(rest)
    raise ValueError(f"unknown notification bus spec {spec!r}")


class Notifier:
    """Async pump: filer meta events → bus, dropped-never, ordered.

    Attach to a Filer via ``filer.notifier = Notifier(bus)``; the filer
    calls :meth:`notify` inline and the worker thread does delivery."""

    def __init__(self, bus: NotificationBus, queue_size: int = 4096):
        self.bus = bus
        self._q: queue.Queue = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self.dropped = 0
        self.delivered = 0
        self.errors = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def notify(self, ev) -> None:
        """Accepts a filer MetaEvent; serializes a compact JSON shape."""
        event = {
            "ts_ns": ev.ts_ns,
            "directory": ev.directory,
            "old_path": ev.old_entry.full_path if ev.old_entry else None,
            "new_path": ev.new_entry.full_path if ev.new_entry else None,
            "is_directory": bool(
                (ev.new_entry or ev.old_entry) and (ev.new_entry or ev.old_entry).is_directory
            ),
            "size": (ev.new_entry.size if ev.new_entry else 0),
        }
        try:
            self._q.put_nowait(event)
        except queue.Full:
            self.dropped += 1  # bounded queue: a dead bus can't OOM the filer

    def _run(self) -> None:
        while not self._stop.is_set() or not self._q.empty():
            try:
                event = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self.bus.send(event)
                self.delivered += 1
            except Exception as e:  # noqa: BLE001 — bus outage must not kill the pump
                if wlog.V(1):
                    wlog.info("notify: bus send failed (%d errors): %s", self.errors + 1, e)
                self.errors += 1

    def close(self) -> None:
        self._stop.set()
        self._worker.join(timeout=5)
        self.bus.close()
