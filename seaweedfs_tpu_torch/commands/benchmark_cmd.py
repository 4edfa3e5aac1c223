"""``benchmark``: the built-in cluster load generator, the port of
seaweedfs_tpu/commands/benchmark_cmd.py (its report keys are the JAX
package's).

Counterpart of the reference's `weed benchmark`
(weed/command/benchmark.go:76-88): concurrent writers
assign fids from the master and POST needle payloads straight to volume
servers over pooled keep-alive connections, then concurrent readers
fetch them back; reports throughput and latency percentiles for each
phase.  It uses no device.
"""

from __future__ import annotations

import json
import random
import threading
import time

from seaweedfs_tpu_torch.commands import command
from seaweedfs_tpu_torch.util import wlog


class _Stats:
    def __init__(self):
        self.lock = threading.Lock()
        self.latencies: list[float] = []
        self.bytes = 0
        self.errors = 0
        self.error_samples: list[str] = []

    def ok(self, dt: float, n: int) -> None:
        with self.lock:
            self.latencies.append(dt)
            self.bytes += n

    def fail(self, why: str = "") -> None:
        with self.lock:
            self.errors += 1
            if why and len(self.error_samples) < 5:
                self.error_samples.append(why)

    def report(self, name: str, wall: float) -> dict:
        lat = sorted(self.latencies)

        def pct(p: float) -> float:
            return lat[min(len(lat) - 1, int(p * len(lat)))] if lat else 0.0

        return {
            "phase": name,
            "requests": len(lat),
            "errors": self.errors,
            **({"error_samples": self.error_samples} if self.error_samples else {}),
            "seconds": round(wall, 3),
            "req_per_sec": round(len(lat) / wall, 1) if wall > 0 else 0.0,
            "mb_per_sec": round(self.bytes / wall / 1e6, 2) if wall > 0 else 0.0,
            "p50_ms": round(pct(0.50) * 1000, 2),
            "p90_ms": round(pct(0.90) * 1000, 2),
            "p99_ms": round(pct(0.99) * 1000, 2),
        }


def run_benchmark(
    master_grpc: str,
    *,
    count: int = 1000,
    size: int = 1024,
    concurrency: int = 16,
    collection: str = "benchmark",
    replication: str = "000",
    do_read: bool = True,
    assign_batch: int = 16,
) -> list[dict]:
    """Programmatic entry (tests use this); returns phase reports."""
    from seaweedfs_tpu_torch.util.http_pool import HttpConnectionPool
    from seaweedfs_tpu_torch.wdclient import MasterClient

    mc = MasterClient(master_grpc)
    pool = HttpConnectionPool(timeout=30.0)
    payload = random.randbytes(size)
    written: list[tuple[str, str]] = []  # (fid, url)
    wlock = threading.Lock()

    write_stats = _Stats()

    def writer(n: int) -> None:
        remaining = n
        while remaining > 0:
            batch = min(assign_batch, remaining)
            remaining -= batch
            try:
                a = mc.assign(
                    count=batch, collection=collection, replication=replication
                )
            except Exception as e:  # noqa: BLE001
                for _ in range(batch):
                    write_stats.fail(f"assign: {e}")
                continue
            # fid_N convention: one assign covers the whole batch
            fids = [a.fid] + [f"{a.fid}_{i}" for i in range(1, batch)]
            headers = (
                {"Authorization": f"Bearer {a.auth}"} if a.auth else {}
            )
            for fid in fids:
                try:
                    t0 = time.perf_counter()
                    status, _ = pool.request(
                        a.location.url, "POST", f"/{fid}", body=payload,
                        headers=headers,
                    )
                    dt = time.perf_counter() - t0
                    if status == 201:
                        write_stats.ok(dt, size)
                        with wlock:
                            written.append((fid, a.location.url))
                    else:
                        write_stats.fail(f"POST {fid}: HTTP {status}")
                except Exception as e:  # noqa: BLE001
                    write_stats.fail(f"POST {fid}: {e}")

    per = count // concurrency
    extra = count - per * concurrency
    threads = [
        threading.Thread(target=writer, args=(per + (1 if i < extra else 0),))
        for i in range(concurrency)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    reports = [write_stats.report("write", time.perf_counter() - t0)]

    if do_read and written:
        read_stats = _Stats()
        items = list(written)
        random.shuffle(items)

        def reader(chunk: list[tuple[str, str]]) -> None:
            for fid, url in chunk:
                try:
                    t0 = time.perf_counter()
                    status, body = pool.request(url, "GET", f"/{fid}")
                    dt = time.perf_counter() - t0
                    if status == 200 and len(body) == size:
                        read_stats.ok(dt, len(body))
                    else:
                        read_stats.fail()
                except Exception as e:  # noqa: BLE001
                    if wlog.V(2):
                        wlog.info("bench: read %s failed: %s", fid, e)
                    read_stats.fail()

        chunks = [items[i::concurrency] for i in range(concurrency)]
        threads = [
            threading.Thread(target=reader, args=(c,)) for c in chunks if c
        ]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        reports.append(read_stats.report("read", time.perf_counter() - t0))
    pool.close()
    return reports


@command("benchmark", "load-test write/read throughput against a cluster")
def run_benchmark_cmd(args) -> int:
    reports = run_benchmark(
        args.master,
        count=args.n,
        size=args.size,
        concurrency=args.c,
        collection=args.collection,
        replication=args.replication,
        do_read=not args.writeOnly,
        assign_batch=args.assignBatch,
    )
    for r in reports:
        print(json.dumps(r))
    return 0


def _flags(p):
    p.add_argument("-master", default="127.0.0.1:19333", help="master gRPC address")
    p.add_argument("-n", type=int, default=1000, help="number of files")
    p.add_argument("-size", type=int, default=1024, help="file size in bytes")
    p.add_argument("-c", type=int, default=16, help="concurrent clients")
    p.add_argument("-collection", default="benchmark")
    p.add_argument("-replication", default="000")
    p.add_argument("-writeOnly", action="store_true")
    p.add_argument("-assignBatch", type=int, default=16,
                   help="fids reserved per assign RPC (fid_N convention)")


run_benchmark_cmd.configure = _flags
